"""The port's configuration: dataclasses holding the values of

- configs/ocr/slate.yaml (``OCRConfig``; ``slotattention.yaml`` is the same
  with ``use_bcdec=True``),
- configs/pooling/{_base,transformer}.yaml (``PoolingConfig``),
- configs/sb3_acnet/{_base,mlp}.yaml (``ACNetConfig``),
- the image size of the synthetic envs (``EnvConfig``),
- configs/get_ari_mse.yaml with the seed of configs/_base.yaml
  (``GetAriMseConfig``).

No YAML is read at run time. One value differs from the YAML on purpose:
``slotattr.fused`` is ``"auto"``, so the routing sweep takes the CUDA kernel
whenever it is eligible. The YAML's ``never`` rests on a measurement on a
TPU, which says nothing about this card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class EnvConfig:
    obs_size: int = 64
    obs_channels: int = 3
    num_stacked_obss: int = 1


@dataclass(frozen=True)
class DVAEConfig:
    vocab_size: int = 4096
    d_model: int = 192


@dataclass(frozen=True)
class CNNConfig:
    hidden_size: int = 64


@dataclass(frozen=True)
class SlotAttrConfig:
    num_iterations: int = 3
    num_slots: int = 5
    num_slot_heads: int = 1
    slot_size: int = 192
    mlp_hidden_size: int = 192
    pos_channels: int = 4
    fused: str = "auto"        # never | auto | always


@dataclass(frozen=True)
class TFDecConfig:
    num_dec_blocks: int = 4
    num_dec_heads: int = 4


@dataclass(frozen=True)
class OCRLearningConfig:
    lr_half_life: int = 250000
    lr_dvae: float = 3e-4
    lr_enc: float = 1e-4
    lr_dec: float = 3e-4
    lr_warmup_steps: int = 30000
    dropout: float = 0.1
    clip: float = 0.05


@dataclass(frozen=True)
class OCRConfig:
    name: str = "SLATE"
    tau_start: float = 1.0
    tau_final: float = 0.1
    tau_steps: int = 30000
    hard: bool = False
    use_cnn_feat: bool = False
    use_bcdec: bool = False
    dvae: DVAEConfig = field(default_factory=DVAEConfig)
    cnn: CNNConfig = field(default_factory=CNNConfig)
    slotattr: SlotAttrConfig = field(default_factory=SlotAttrConfig)
    tfdec: TFDecConfig = field(default_factory=TFDecConfig)
    learning: OCRLearningConfig = field(default_factory=OCRLearningConfig)


@dataclass(frozen=True)
class OCRCheckpointConfig:
    entity: str = ""
    project: str = ""
    run_id: str = ""
    file: str = ""
    local_file: str = ""
    finetuning: bool = False


@dataclass(frozen=True)
class PoolingLearningConfig:
    lr: float = 1e-4


@dataclass(frozen=True)
class PoolingConfig:
    name: str = "Transformer"
    learn_aux_loss: bool = False
    learn_downstream_loss: bool = False
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)
    rep_dim: int = 128
    d_model: int = 128
    nhead: int = 8
    num_layers: int = 1
    pos_emb: str = "None"      # the YAML's literal string: no position table
    norm_first: bool = False
    use_mlp1: bool = False
    use_mlp2: bool = False
    cw_embedding: bool = False
    push_embedding: bool = False
    learning: PoolingLearningConfig = field(default_factory=PoolingLearningConfig)


@dataclass(frozen=True)
class NetConfig:
    dims: tuple[int, ...] = ()
    acts: tuple[str, ...] = ()


@dataclass(frozen=True)
class ACNetConfig:
    name: str = "MLP"
    ortho_init: bool = False
    shared_net: NetConfig = NetConfig((64, 64), ("relu", "relu"))
    policy_net: NetConfig = NetConfig((64,), ("tanh",))
    value_net: NetConfig = NetConfig((64,), ("tanh",))


@dataclass(frozen=True)
class PolicyConfig:
    """``train_sb3 ocr=slate pooling=transformer sb3_acnet=mlp``: the
    ``slate-transformer`` rows of for_running.json. With ``ocr.use_bcdec``
    set it is the ``slotattention-transformer`` rows, whose serving path is
    the same."""

    ocr: OCRConfig = field(default_factory=OCRConfig)
    pooling: PoolingConfig = field(default_factory=PoolingConfig)
    sb3_acnet: ACNetConfig = field(default_factory=ACNetConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    num_actions: int = 4


@dataclass(frozen=True)
class GetAriMseConfig:
    """``get_ari_mse ocr=slate`` (``slotattention``: ``ocr.use_bcdec``).
    ``bg_mask_idx`` names the masks' background channel, which the
    foreground ARI takes as the last one."""

    ocr: OCRConfig = field(default_factory=OCRConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)
    batch_size: int = 32
    bg_mask_idx: int = -1
    with_gen_mse: bool = True
    seed: int = 0


def replace(cfg, path: str, value):
    """A copy of the frozen dataclass ``cfg`` with the dotted ``path`` set,
    e.g. ``replace(cfg, "ocr.use_bcdec", True)``."""
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(cfg, **{head: value})
    return dataclasses.replace(cfg, **{head: replace(getattr(cfg, head), rest, value)})
