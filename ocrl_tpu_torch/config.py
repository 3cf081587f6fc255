"""The port's configuration: dataclasses holding the values of

- configs/ocr/slate.yaml (``OCRConfig``; ``slotattention.yaml`` is the same
  with ``use_bcdec=True``), configs/ocr/gt.yaml (``GTConfig``),
  naturecnn.yaml, multiple_cnn.yaml, vae.yaml, mae.yaml and
  iodine_large.yaml (``NatureCNNConfig`` ... ``IodineConfig``),
- configs/pooling/_base.yaml with transformer.yaml (``PoolingConfig``),
  rn.yaml, mlp.yaml, cnn_linear.yaml, cnn_transformer.yaml and identity.yaml
  (``RNConfig`` ... ``IdentityPoolingConfig``), each with the YAML's keys,
- configs/sb3_acnet/_base.yaml with mlp.yaml, mlp_orthoinit.yaml,
  identity.yaml and identity_orthoinit.yaml (``ACNetConfig``),
- configs/sb3/{ppo,a2c,sac}.yaml (``SB3Config`` over ``PPOConfig`` /
  ``A2CConfig`` / ``SACConfig``, whose defaults are
  ocrl_tpu/rl/ppo.py:24-62 and ocrl_tpu/rl/sac.py:31-49),
- the image size of the envs (``EnvConfig``), a whole synthetic env
  (``SyntheticEnvConfig``, every field of
  configs/env/_synthetic_env_base.yaml) and a whole CausalWorld env
  (``CwEnvConfig``, configs/env/_cw_env_base.yaml),
- configs/get_ari_mse.yaml over configs/_base.yaml (``GetAriMseConfig``),
- configs/{train_sb3,test_sb3}.yaml over configs/_base.yaml
  (``TrainSB3Config``, ``TestSB3Config``), configs/train_ocr.yaml over it
  (``TrainOCRConfig``), configs/train_property_predictor.yaml and
  configs/train_classifier.yaml over it (``TrainPropertyPredictorConfig``,
  ``TrainClassifierConfig``) and
  configs/collect_dataset_from_synthetic_envs.yaml (``CollectConfig``),
- a dataset file of configs/dataset (``DatasetConfig``).

Only the env and dataset files are read at run time (``read_env_config``,
``read_dataset_config``), by a small reader of the YAML subset the config
files use (``parse_yaml``): block mappings and sequences, flow lists and
mappings (nested, and continued on more indented lines), quoted and plain
scalars with YAML 1.1's nulls, booleans, ints and floats (``3e-2``
included, as OmegaConf reads it), and ``defaults:`` chaining within the
directory. ``compose`` applies the
``key=value`` overrides of the entry points.

One value differs from the YAML on purpose: ``slotattr.fused`` is
``"auto"``, so the routing sweep takes the CUDA kernel whenever it is
eligible. The YAML's ``never`` rests on a measurement on a TPU, which says
nothing about this card.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


@dataclass(frozen=True)
class EnvConfig:
    obs_size: int = 64
    obs_channels: int = 3
    num_stacked_obss: int = 1


@dataclass(frozen=True)
class BackgroundConfig:
    img_paths: tuple[str, ...] = ("../dtd/images/braided", "../dtd/images/stratified")
    use_bg: bool = False


@dataclass(frozen=True)
class SyntheticEnvConfig(EnvConfig):
    """One synthetic env: configs/env/_synthetic_env_base.yaml's fields and
    their values, plus the ``env`` class, its ``name`` and ``target``, which
    the task files set. Lists are tuples."""

    AGENT: tuple = ("red", "circle", 0.15)
    COLORS: tuple[str, ...] = ("blue", "green", "yellow")
    SCALES: tuple[float, ...] = (0.15,)
    SHAPES: tuple[str, ...] = ("square", "triangle")
    agent_pos: Optional[tuple[float, ...]] = (0.5, 0.5)
    background: BackgroundConfig = field(default_factory=BackgroundConfig)
    distance_to_agent: float = 0.08
    distance_to_objs: float = 0.08
    distance_to_wall: float = 0.08
    max_steps: int = 100
    mode: str = "hard"
    moving_step_size: float = 0.05
    num_objects_range: tuple[int, int] = (4, 4)
    obj_comp: bool = False
    occlusion: bool = False
    render_mode: str = "image"
    rew_type: str = "sparse"
    skewed: bool = False
    state_size: int = 5
    tags: str = ""
    unseen_combi: tuple[str, ...] = ()
    unseen_combi_mode: Optional[str] = None
    wo_agent: bool = False
    env: str = ""
    name: str = ""
    target: tuple = ()


@dataclass(frozen=True)
class CwEnvConfig(EnvConfig):
    """One CausalWorld reach env: configs/env/_cw_env_base.yaml's fields and
    their values, plus the ``env`` class and ``name`` that the ``cw-*``
    files set. Lists are tuples. The wrappers render 64x64 whatever
    ``obs_size`` says (ocrl_tpu/envs/cw.py:189,264)."""

    COLORS: tuple[str, ...] = ("blue", "green", "yellow", "red")
    mode: str = "easy"
    num_objects_range: tuple[int, int] = (4, 4)
    render_mode: str = "image"
    rew_type: str = "sparse"
    state_size: int = 40
    tags: str = ""
    target: tuple[str, ...] = ("blue",)
    task: str = "target"
    use_fake_sim: bool = False
    env: str = ""
    name: str = ""


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
    # the conv stacks' compute dtype: "bf16", or fp32 for anything else
    # (JAX reads ``ocr.amp`` the same way, ocrl_tpu/models/slate.py:56-57)
    amp: Optional[str] = None
    dvae: DVAEConfig = field(default_factory=DVAEConfig)
    cnn: CNNConfig = field(default_factory=CNNConfig)
    slotattr: SlotAttrConfig = field(default_factory=SlotAttrConfig)
    tfdec: TFDecConfig = field(default_factory=TFDecConfig)
    learning: OCRLearningConfig = field(default_factory=OCRLearningConfig)


@dataclass(frozen=True)
class GTConfig:
    """configs/ocr/gt.yaml: the ground-truth state, through an MLP when
    ``dims`` is not empty."""

    name: str = "GT"
    dims: tuple[int, ...] = ()
    acts: tuple[str, ...] = ()


@dataclass(frozen=True)
class LRConfig:
    lr: float = 1e-4


@dataclass(frozen=True)
class NatureCNNConfig:
    """configs/ocr/naturecnn.yaml: the Nature DQN CNN, a 512-wide vector or
    (``use_cnn_feat``) its 4x4 or 2x2 feature map as pseudo-slots."""

    name: str = "NatureCNN"
    rep_dim: int = 512
    use_cnn_feat: bool = False
    cnn_feat_size: int = 4
    learning: LRConfig = field(default_factory=LRConfig)


@dataclass(frozen=True)
class MultipleCNNConfig:
    """configs/ocr/multiple_cnn.yaml: ``num_modules`` NatureCNNs as slots."""

    name: str = "MultipleCNN"
    num_modules: int = 5
    rep_dim: int = 512
    learning: LRConfig = field(default_factory=LRConfig)


@dataclass(frozen=True)
class VAELearningConfig:
    lr: float = 1e-4
    kld_weight: float = 0.0001


@dataclass(frozen=True)
class VAEConfig:
    """configs/ocr/vae.yaml."""

    name: str = "VAE"
    latent_dim: int = 256
    use_cnn_feat: bool = False
    cnn_feat_size: int = 4
    learning: VAELearningConfig = field(default_factory=VAELearningConfig)


@dataclass(frozen=True)
class MAELearningConfig:
    lr: float = 1e-3
    weight_decay: float = 0.05


@dataclass(frozen=True)
class MAEConfig:
    """configs/ocr/mae.yaml (``vit_size``: base, large or tiny)."""

    name: str = "MAE"
    vit_size: str = "base"
    patch_size: int = 8
    return_cls: bool = False
    masking_ratio: float = 0.75
    learning: MAELearningConfig = field(default_factory=MAELearningConfig)


@dataclass(frozen=True)
class IodineLearningConfig:
    lr: float = 3e-4
    clip: float = 5.0
    clip_norm_type: float = 2.0


@dataclass(frozen=True)
class IodineConfig:
    """configs/ocr/iodine_large.yaml."""

    name: str = "Iodine"
    slot_size: int = 64
    num_iterations: int = 5
    num_slots: int = 6
    img_channels: int = 3
    sigma: float = 0.35
    beta: float = 1.0
    layer_norm: bool = True
    ref_cnn_hidden_size: int = 64
    ref_mlp_hidden_size: int = 256
    ref_cnn_layers: int = 4
    ref_cnn_kernel_size: int = 3
    ref_cnn_stride_size: int = 2
    dec_cnn_hidden_size: int = 64
    dec_cnn_layers: int = 4
    dec_cnn_kernel_size: int = 3
    learning: IodineLearningConfig = field(default_factory=IodineLearningConfig)


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
class RNConfig:
    """configs/pooling/rn.yaml: a relation network over ordered slot pairs."""

    name: str = "RN"
    learn_aux_loss: bool = False
    learn_downstream_loss: bool = False
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)
    g_dims: tuple[int, ...] = (256, 256, 256, 256)
    f_dims: tuple[int, ...] = (256, 128, 64, 64)
    rep_dim: int = 64
    learning: PoolingLearningConfig = field(default_factory=PoolingLearningConfig)


@dataclass(frozen=True)
class MLPPoolingConfig:
    """configs/pooling/mlp.yaml: the slots flattened, through an MLP."""

    name: str = "MLP"
    learn_aux_loss: bool = False
    learn_downstream_loss: bool = False
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)
    dims: tuple[int, ...] = (128, 128)
    acts: tuple[str, ...] = ("relu", "relu")
    rep_dim: int = 128
    learning: PoolingLearningConfig = field(default_factory=PoolingLearningConfig)


@dataclass(frozen=True)
class CNNLinearConfig:
    """configs/pooling/cnn_linear.yaml: the slots as an image, through the
    Nature CNN to a vector."""

    name: str = "CNN_Linear"
    learn_aux_loss: bool = False
    learn_downstream_loss: bool = False
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)
    rep_dim: int = 512
    learning: PoolingLearningConfig = field(default_factory=PoolingLearningConfig)


@dataclass(frozen=True)
class CNNTransformerConfig:
    """configs/pooling/cnn_transformer.yaml: the slots as an image, the
    Nature CNN's feature map as tokens of a CLS transformer."""

    name: str = "CNN_Transformer"
    learn_aux_loss: bool = False
    learn_downstream_loss: bool = False
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)
    d_model: int = 128
    rep_dim: int = 128
    nhead: int = 8
    num_layers: int = 1
    pos_emb: str = "ape"
    learning: PoolingLearningConfig = field(default_factory=PoolingLearningConfig)


@dataclass(frozen=True)
class IdentityPoolingConfig:
    """configs/pooling/identity.yaml: the slots flattened."""

    name: str = "Identity"
    learn_aux_loss: bool = False
    learn_downstream_loss: bool = False
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)


OCRConfigs = (OCRConfig | GTConfig | NatureCNNConfig | MultipleCNNConfig | VAEConfig
              | MAEConfig | IodineConfig)
PoolingConfigs = (PoolingConfig | RNConfig | MLPPoolingConfig | CNNLinearConfig
                  | CNNTransformerConfig | IdentityPoolingConfig)


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
    the same. With a ``GTConfig`` and a ``SyntheticEnvConfig`` in
    ``render_mode`` state, it is the ``gt-*`` rows."""

    ocr: OCRConfigs = field(default_factory=OCRConfig)
    pooling: PoolingConfigs = field(default_factory=PoolingConfig)
    sb3_acnet: ACNetConfig = field(default_factory=ACNetConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    num_actions: int = 4


@dataclass(frozen=True)
class PPOConfig:
    """ocrl_tpu/rl/ppo.py:24-42; configs/sb3/ppo.yaml sets these values."""

    n_steps: int = 2048            # total steps a rollout, split over the envs
    batch_size: int = 32
    learning_rate: float = 3e-4
    n_epochs: int = 10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    target_kl: Optional[float] = None
    normalize_advantage: bool = True


@dataclass(frozen=True)
class A2CConfig:
    """ocrl_tpu/rl/ppo.py:48-56; configs/sb3/a2c.yaml sets n_steps 5 and the
    learning rate 7e-4."""

    n_steps: int = 5
    learning_rate: float = 7e-4
    gamma: float = 0.99
    gae_lambda: float = 1.0
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    rms_eps: float = 1e-5


@dataclass(frozen=True)
class SACConfig:
    """ocrl_tpu/rl/sac.py:31-49; configs/sb3/sac.yaml sets these values.
    ``ent_coef``: a float, or "auto" / "auto_<initial value>" (tuned, from
    1.0 or the given value)."""

    learning_rate: float = 1e-4
    buffer_size: int = 1_000_000
    learning_starts: int = 1000
    batch_size: int = 256
    tau: float = 0.001
    gamma: float = 0.95
    train_freq: int = 1
    gradient_steps: int = 1
    ent_coef: float | str = 1e-3


@dataclass(frozen=True)
class SB3Config:
    name: str = "PPO"
    algo_kwargs: PPOConfig | A2CConfig | SACConfig = field(default_factory=PPOConfig)


@dataclass(frozen=True)
class EvalConfig:
    freq: int = 1000               # vector steps between evaluations
    n_episodes: int = 100
    num_envs: int = 20


@dataclass(frozen=True)
class VideoConfig:
    interval: int = 5000           # timesteps from the end of one GIF to the next
    length: int = 1000             # frames a GIF (one a vector step)


@dataclass(frozen=True)
class TrainSB3Config:
    """configs/train_sb3.yaml over configs/_base.yaml. ``run_dir`` empty:
    outputs/train_sb3/<ocr>-<pooling>-<algo>-<env>/<time>. ``vec_env``:
    auto | dummy | subproc. ``seeds`` ("1234,2345,3456", or one int): every
    seed trained as one vmapped PPO (``rl.multi_seed``); ``resume``: an
    agent file to continue from; ``pipeline_rollout`` and
    ``cache_frozen_reps``: the multi-seed rollout and update options.
    configs/train_sb3.yaml's ``viz_interval``, which JAX's train_sb3 never
    reads, is not a field: an override of it raises."""

    ocr: OCRConfigs = field(default_factory=OCRConfig)
    pooling: PoolingConfigs = field(default_factory=PoolingConfig)
    sb3: SB3Config = field(default_factory=SB3Config)
    sb3_acnet: ACNetConfig = field(default_factory=ACNetConfig)
    env: SyntheticEnvConfig | CwEnvConfig = field(default_factory=SyntheticEnvConfig)
    seed: int = 0
    num_envs: int = 4
    max_steps: float = 2e6
    eval: EvalConfig = field(default_factory=EvalConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    seeds: Optional[str] = None
    resume: Optional[str] = None
    pipeline_rollout: bool = False
    cache_frozen_reps: bool = False
    vec_env: str = "auto"
    tags: str = ""
    run_dir: str = ""

    def policy_config(self) -> PolicyConfig:
        return PolicyConfig(self.ocr, self.pooling, self.sb3_acnet, self.env)


def seed_list(seeds) -> list[int] | None:
    """``seeds=`` as JAX reads it: "1234,2345,3456" (or one int) -> the
    list; None or "" -> None."""
    if seeds in (None, "", "null"):
        return None
    return [int(s) for s in str(seeds).split(",")]


@dataclass(frozen=True)
class AgentCheckpointConfig:
    """configs/test_sb3.yaml's ``agent_checkpoint``: the file is
    ``run_id/file`` (``.ckpt`` added when missing). Of a file stacked over
    seeds, the slice of ``seed`` (a value of the file's ``seeds``) when set,
    else the one at position ``index``."""

    entity: str = ""
    project: str = ""
    run_id: str = ""
    file: str = "models/best_model"
    seed: Optional[int] = None
    index: int = 0


@dataclass(frozen=True)
class TestSB3Config:
    """configs/test_sb3.yaml over configs/_base.yaml."""

    __test__ = False               # a config, not a test class

    ocr: OCRConfigs = field(default_factory=OCRConfig)
    pooling: PoolingConfigs = field(default_factory=PoolingConfig)
    sb3: SB3Config = field(default_factory=SB3Config)
    sb3_acnet: ACNetConfig = field(default_factory=ACNetConfig)
    env: SyntheticEnvConfig = field(default_factory=SyntheticEnvConfig)
    seed: int = 0
    seeds: Optional[str] = None
    n_eval_episodes: int = 100
    agent_checkpoint: AgentCheckpointConfig = field(default_factory=AgentCheckpointConfig)
    tags: str = ""
    run_dir: str = ""

    def policy_config(self) -> PolicyConfig:
        return PolicyConfig(self.ocr, self.pooling, self.sb3_acnet, self.env)


@dataclass(frozen=True)
class DatasetCheckpointConfig:
    entity: str = ""
    file: str = ""
    project: str = ""
    run_id: str = ""


def _synthetic_properties() -> dict:
    return {"color": {"num_candidates": 7}, "scale": {"num_candidates": 2},
            "shape": {"num_candidates": 4}, "xy": {"dims": 2}}


@dataclass(frozen=True)
class DatasetConfig(EnvConfig):
    """configs/dataset/<stem>.yaml chained to its _synthetic_env_base and
    _base: the image size the OCR is built for, where the file is
    (``datadir``, else ``<dataset_dir>/<dataset_checkpoint.file>``), and
    what the property probe reads of an object's state row: ``properties``
    (name -> {"num_candidates": classes} or {"dims": width}, as the YAML
    has it) in the order ``property_order_in_state``. Keys that name no
    field (the CausalWorld files' ``num_objs``) are dropped."""

    datadir: Optional[str] = None
    dataset_checkpoint: DatasetCheckpointConfig = field(
        default_factory=DatasetCheckpointConfig)
    dataset_dir: str = "datasets"
    num_labels: int = 4
    num_objects_range: tuple[int, int] = (4, 4)
    state_size: int = 5
    properties: dict = field(default_factory=_synthetic_properties)
    property_order_in_state: tuple[str, ...] = ("color", "shape", "scale", "xy")
    name: str = ""
    tags: str = ""


@dataclass(frozen=True)
class GetAriMseConfig:
    """configs/get_ari_mse.yaml over configs/_base.yaml: ``get_ari_mse
    ocr=slate dataset=<stem>`` (``slotattention``: ``ocr.use_bcdec``;
    ``ocr=iodine_large``: an ``IodineConfig``), with ``with_gen_mse``, the
    key JAX's entry reads beyond them (get_ari_mse.py:44). ``bg_mask_idx``
    names the masks' background channel, which the foreground ARI takes as
    the last one. ``run_dir`` empty:
    outputs/get_ari/<ocr>-<dataset>/<time>. ``num_workers`` is read and
    unused, as in JAX."""

    ocr: OCRConfigs = field(default_factory=OCRConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)
    batch_size: int = 32
    bg_mask_idx: int = -1
    with_gen_mse: bool = True
    seed: int = 0
    num_workers: int = 1
    run_dir: str = ""


@dataclass(frozen=True)
class LoadConfig:
    resume_run_path: Optional[str] = None
    resume_checkpoint: Optional[str] = None


@dataclass(frozen=True)
class TrainOCRConfig:
    """configs/train_ocr.yaml over configs/_base.yaml, with the keys the
    JAX entry point reads beyond them and its defaults (train_ocr.py:44,52,
    71,77): ``log_interval``, ``superbatch``, ``max_steps`` (None: train by
    epochs only) and ``profile_dir`` (None: no trace). ``run_dir`` empty:
    outputs/train_ocr/<ocr>-<dataset>/<time>. ``num_workers`` is read and
    unused, as in JAX."""

    ocr: OCRConfigs = field(default_factory=OCRConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    eval_interval: int = 1000
    run_dir: str = ""
    batch_size: int = 24
    num_visualization: int = 5
    tags: str = ""
    seed: int = 0
    num_workers: int = 1
    load: LoadConfig = field(default_factory=LoadConfig)
    max_epochs: int = 1000
    log_interval: int = 50
    superbatch: int = 16
    max_steps: Optional[float] = None
    profile_dir: Optional[str] = None


@dataclass(frozen=True)
class PropertyPredictorConfig:
    """configs/train_property_predictor.yaml's ``property_predictor``:
    the head (``linear`` or ``mlp3``), the VAE's pseudo-slots and Adam's
    learning rate. ``matching_mode`` is read by neither package."""

    matching_mode: str = "loss"
    model_type: str = "mlp3"
    num_slots_for_dist_rep: int = 6
    learning: LRConfig = field(default_factory=LRConfig)


@dataclass(frozen=True)
class TrainPropertyPredictorConfig:
    """configs/train_property_predictor.yaml over configs/_base.yaml.
    ``run_dir`` empty: outputs/train_property_predictor/<ocr>-<dataset>/<time>.
    ``load`` and ``num_visualization`` are read by neither package."""

    ocr: OCRConfigs = field(default_factory=OCRConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    ocr_checkpoint: OCRCheckpointConfig = field(default_factory=OCRCheckpointConfig)
    property_predictor: PropertyPredictorConfig = field(
        default_factory=PropertyPredictorConfig)
    run_dir: str = ""
    batch_size: int = 24
    num_visualization: int = 5
    tags: str = ""
    seed: int = 0
    num_workers: int = 1
    load: LoadConfig = field(default_factory=LoadConfig)
    max_epochs: int = 1000


@dataclass(frozen=True)
class ClassifierConfig:
    """configs/train_classifier.yaml's ``classifier``: the head's width and
    Adam's learning rate."""

    d_model: int = 64
    learning: LRConfig = field(default_factory=LRConfig)


@dataclass(frozen=True)
class TrainClassifierConfig:
    """configs/train_classifier.yaml over configs/_base.yaml. ``run_dir``
    empty: outputs/train_classifier/<ocr>-<pooling>-<dataset>/<time>.
    ``load`` and ``num_visualization`` are read by neither package."""

    ocr: OCRConfigs = field(default_factory=OCRConfig)
    pooling: PoolingConfigs = field(default_factory=PoolingConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    classifier: ClassifierConfig = field(default_factory=ClassifierConfig)
    run_dir: str = ""
    batch_size: int = 128
    num_visualization: int = 5
    tags: str = ""
    seed: int = 0
    num_workers: int = 1
    load: LoadConfig = field(default_factory=LoadConfig)
    max_epochs: int = 1000


@dataclass(frozen=True)
class CollectionConfig:
    """configs/collect_dataset_from_synthetic_envs.yaml's ``collection``,
    plus ``out_file`` (None: ``<out_dir>/<canonical file name>``)."""

    num_tr: int = 1000000
    num_val: int = 10000
    num_proc: int = 10
    only_initial: bool = True
    seed: int = 0
    chunk_size: int = 100000
    with_masks: bool = False
    with_labels: bool = False
    with_states: bool = False
    out_dir: str = "datasets"
    out_file: Optional[str] = None


@dataclass(frozen=True)
class CollectConfig:
    """configs/collect_dataset_from_synthetic_envs.yaml. ``run_dir`` empty:
    outputs/dataset_collection/<env name>/<time>."""

    env: SyntheticEnvConfig = field(default_factory=SyntheticEnvConfig)
    collection: CollectionConfig = field(default_factory=CollectionConfig)
    run_dir: str = ""


def _coerce(old, value):
    """``value`` in the type of the field's current value where YAML gives
    another: a list as a tuple, an int as a float."""
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, float) and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    return value


def replace(cfg, path: str, value):
    """A copy of the frozen dataclass ``cfg`` with the dotted ``path`` set,
    e.g. ``replace(cfg, "ocr.use_bcdec", True)``. A name the dataclass lacks
    raises."""
    head, _, rest = path.partition(".")
    if not dataclasses.is_dataclass(cfg) or \
            head not in {f.name for f in dataclasses.fields(cfg)}:
        raise KeyError(f"no config key '{head}' in {type(cfg).__name__}")
    if not rest:
        return dataclasses.replace(cfg, **{head: _coerce(getattr(cfg, head), value)})
    return dataclasses.replace(cfg, **{head: replace(getattr(cfg, head), rest, value)})


# -- the YAML subset of the config files ---------------------------------------

_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |[-+]?\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"),
                          True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                          False)}
_QUOTES = ("'", '"')


def parse_scalar(text: str):
    """One plain or quoted YAML scalar, or a flow list or mapping, as
    PyYAML's SafeLoader with OmegaConf's float rule reads it."""
    text = text.strip()
    if text[:1] in ("[", "{"):
        value, i = _flow(text, 0)
        if text[i:].strip():
            raise ValueError(f"text after a flow collection: {text[i:]!r}")
        return value
    if len(text) >= 2 and text[0] == text[-1] and text[0] in _QUOTES:
        body = text[1:-1]
        return body.replace(text[0] * 2, text[0]) if text[0] == _QUOTES[0] else body
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", "").lower().replace(".inf", "inf")
                     .replace(".nan", "nan"))
    if text[0] in "&*!|>}]":
        raise ValueError(f"YAML outside the subset the config files use: {text!r}")
    return text


def _skip_space(text: str, i: int) -> int:
    while i < len(text) and text[i].isspace():
        i += 1
    return i


def _flow_item(text: str, i: int):
    """The flow collection, quoted or plain scalar at ``text[i]`` inside a
    flow collection: (its value, the index after it). A plain scalar ends
    at ``,``, ``]``, ``}`` or a ``:`` before a space or one of those."""
    i = _skip_space(text, i)
    if i < len(text) and text[i] in "[{":
        return _flow(text, i)
    if i < len(text) and text[i] in _QUOTES:
        quote, j = text[i], i + 1
        while j < len(text):
            if text[j] == quote:
                if quote == "'" and text[j + 1:j + 2] == "'":
                    j += 2
                    continue
                return parse_scalar(text[i:j + 1]), j + 1
            j += 1
        raise ValueError(f"unterminated quoted scalar: {text!r}")
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
            text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " ,]}")):
        j += 1
    return parse_scalar(text[i:j]), j


def _flow(text: str, i: int):
    """The flow list or mapping that opens at ``text[i]``: (its value, the
    index after its closing bracket)."""
    close = "]" if text[i] == "[" else "}"
    out: list | dict = [] if close == "]" else {}
    i += 1
    while True:
        i = _skip_space(text, i)
        if i == len(text):
            raise ValueError(f"unterminated flow collection: {text!r}")
        if text[i] == close:
            return out, i + 1
        if text[i] == ",":
            raise ValueError(f"an empty entry in a flow collection: {text!r}")
        value, i = _flow_item(text, i)
        if isinstance(out, dict):
            i = _skip_space(text, i)
            key = value
            value = None
            if i < len(text) and text[i] == ":":
                value, i = _flow_item(text, i + 1)
            if key in out:
                raise ValueError(f"a duplicate key {key!r}: {text!r}")
            out[key] = value
        else:
            out.append(value)
        i = _skip_space(text, i)
        if i < len(text) and text[i] == ",":
            i += 1
        elif i == len(text) or text[i] != close:
            raise ValueError(f"expected ',' or {close!r} in a flow collection: {text!r}")


def _flow_depth(line: str) -> int:
    """How many flow brackets the line leaves open."""
    depth, quote = 0, None
    for c in line:
        if quote:
            quote = None if c == quote else quote
        elif c in _QUOTES:
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in _QUOTES:
            quote = c
        elif c == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _block(lines: list[str], i: int, indent: int):
    """The block mapping or sequence starting at ``lines[i]``, whose lines
    stand at ``indent``: (its value, the index of the line after it)."""
    if lines[i].lstrip().startswith("-"):
        out = []
        while i < len(lines) and _indent(lines[i]) == indent \
                and lines[i].lstrip().startswith("-"):
            item = lines[i].strip()[1:].strip()
            key, sep, rest = item.partition(": ")
            if sep and item[0] not in "['\"":
                out.append({parse_scalar(key): parse_scalar(rest)})
            else:
                out.append(parse_scalar(item))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and _indent(lines[i]) == indent:
        line = lines[i].strip()
        key, sep, rest = line.partition(":")
        if not sep or line.startswith("-") or (rest and not rest[0].isspace()):
            raise ValueError(f"not a 'key: value' line: {line!r}")
        key = parse_scalar(key)
        i += 1
        if rest.strip():
            out[key] = parse_scalar(rest)
        elif i < len(lines) and _indent(lines[i]) > indent:
            out[key], i = _block(lines, i, _indent(lines[i]))
        else:
            out[key] = None
    if i < len(lines) and _indent(lines[i]) > indent:
        raise ValueError(f"unexpected indentation at {lines[i]!r}")
    return out, i


def parse_yaml(text: str) -> dict:
    """A config file's mapping (the subset in the module docstring)."""
    lines = [_strip_comment(line).rstrip() for line in text.splitlines()]
    lines = [line for line in lines if line.strip() and line.strip() != "---"]
    joined: list[str] = []
    for line in lines:           # a flow collection continued on the next lines
        if joined and _flow_depth(joined[-1]) > 0:
            if _indent(line) <= _indent(joined[-1]):
                raise ValueError(f"a flow collection's next line is not indented: {line!r}")
            joined[-1] += " " + line.strip()
        else:
            joined.append(line)
    lines = joined
    if not lines:
        return {}
    if any("\t" in line[:_indent(line) + 1] for line in lines):
        raise ValueError("a tab in the indentation")
    value, i = _block(lines, 0, _indent(lines[0]))
    if i != len(lines) or not isinstance(value, dict):
        raise ValueError("a config file is one block mapping")
    return value


def _merge(into: dict, other: dict) -> None:
    for key, value in other.items():
        if isinstance(value, dict) and isinstance(into.get(key), dict):
            _merge(into[key], value)
        else:
            into[key] = value


def compose_file(path: Path) -> dict:
    """A file's mapping with its ``defaults:`` list applied: each named file
    of the same directory merged in order, and ``_self_`` (the file's own
    keys) where it stands, else last. Mappings merge key by key."""
    own = parse_yaml(Path(path).read_text())
    defaults = own.pop("defaults", None)
    if defaults is None:
        return own
    out: dict = {}
    for entry in defaults:
        if entry == "_self_":
            _merge(out, own)
        elif isinstance(entry, str):
            _merge(out, compose_file(Path(path).parent / f"{entry}.yaml"))
        else:
            raise ValueError(f"defaults entry {entry!r}: the reader chains the files "
                             "of one directory only")
    if "_self_" not in defaults:
        _merge(out, own)
    return out


def _dataclass_from(cls, values: dict):
    """``cls`` from the values of its fields, lists as tuples; keys that name
    no field are dropped (push-N1C1S1S1.yaml misspells one)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        value = values[f.name]
        default = f.default if f.default_factory is dataclasses.MISSING \
            else f.default_factory()
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            value = _dataclass_from(type(default), value)
        elif isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
        else:
            value = _coerce(default, value)
        kwargs[f.name] = value
    return cls(**kwargs)


def read_env_config(name: str) -> SyntheticEnvConfig | CwEnvConfig:
    """configs/env/<name>.yaml, chained to its base: a ``CwEnvConfig`` for
    the CausalWorld files (``env: CwTargetEnv``), else a
    ``SyntheticEnvConfig``."""
    path = CONFIG_DIR / "env" / f"{name}.yaml"
    if not path.exists():
        raise FileNotFoundError(f"no env config {path}")
    values = compose_file(path)
    cls = CwEnvConfig if values.get("env", "").startswith("Cw") else SyntheticEnvConfig
    return _dataclass_from(cls, values)


def read_dataset_config(name: str) -> DatasetConfig:
    """configs/dataset/<name>.yaml, chained to its bases, as a
    ``DatasetConfig``."""
    path = CONFIG_DIR / "dataset" / f"{name}.yaml"
    if not path.exists():
        raise FileNotFoundError(f"no dataset config {path}")
    return _dataclass_from(DatasetConfig, compose_file(path))


# -- the entry points' overrides ------------------------------------------------

GROUPS = {
    "ocr": {"slate": OCRConfig(), "slotattention": OCRConfig(use_bcdec=True),
            "gt": GTConfig(), "naturecnn": NatureCNNConfig(),
            "multiple_cnn": MultipleCNNConfig(), "vae": VAEConfig(), "mae": MAEConfig(),
            "iodine_large": IodineConfig()},
    "pooling": {"transformer": PoolingConfig(), "rn": RNConfig(), "mlp": MLPPoolingConfig(),
                "cnn_linear": CNNLinearConfig(), "cnn_transformer": CNNTransformerConfig(),
                "identity": IdentityPoolingConfig()},
    "sb3": {"ppo": SB3Config("PPO", PPOConfig()), "a2c": SB3Config("A2C", A2CConfig()),
            "sac": SB3Config("SAC", SACConfig())},
    "sb3_acnet": {"mlp": ACNetConfig(),
                  "mlp_orthoinit": ACNetConfig("MLPOrthoInit", True),
                  "identity": ACNetConfig("Identity", False, NetConfig(), NetConfig(),
                                          NetConfig()),
                  "identity_orthoinit": ACNetConfig("IdentityOrthoInit", True, NetConfig(),
                                                    NetConfig(), NetConfig())},
}
# the override groups read from a directory of configs/ at run time
FILE_GROUPS = {"env": read_env_config, "dataset": read_dataset_config}


def compose(cfg, argv):
    """``cfg`` (a ``TrainSB3Config``, ``TestSB3Config``, ``TrainOCRConfig``,
    ``TrainPropertyPredictorConfig``, ``TrainClassifierConfig`` or
    ``CollectConfig``) with the ``key=value`` overrides of ``argv``:
    first the groups ``ocr=``, ``pooling=``, ``sb3=``, ``sb3_acnet=``,
    ``env=<file stem>`` and ``dataset=<file stem>``, then every other key,
    dotted or plain, in order (values read as YAML scalars; a leading ``+``
    is dropped). A group or key the config lacks raises ``KeyError``."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    pairs = []
    for arg in argv:
        key, sep, raw = arg.partition("=")
        if not sep:
            raise ValueError(f"override '{arg}' must look like key=value")
        pairs.append((key.lstrip("+"), raw))
    groups = [(key, raw) for key, raw in pairs if key in GROUPS or key in FILE_GROUPS]
    for key, raw in groups:
        if key not in fields:
            raise KeyError(f"no config group '{key}' in {type(cfg).__name__}")
        if key in FILE_GROUPS:
            cfg = dataclasses.replace(cfg, **{key: FILE_GROUPS[key](raw)})
            continue
        if raw not in GROUPS[key]:
            raise FileNotFoundError(f"no config '{key}={raw}' (available: "
                                    f"{', '.join(GROUPS[key])})")
        cfg = dataclasses.replace(cfg, **{key: GROUPS[key][raw]})
    for key, raw in pairs:
        if (key, raw) not in groups:
            cfg = replace(cfg, key, parse_scalar(raw))
    return cfg
