"""Actor-critic heads and the whole policy (counterpart of
ocrl_tpu/rl/ac_nets.py): obs -> OCR -> pooling -> shared / policy / value
MLPs -> categorical logits and a value."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import ACNetConfig, NetConfig
from ..models.common import lecun_normal_

_ACTS = {"relu": torch.relu, "tanh": torch.tanh}


def _dense(in_features: int, out_features: int, ortho_gain: float | None) -> nn.Linear:
    """flax nn.Dense: lecun-normal kernel, or orthogonal with a gain; zero bias."""
    m = nn.Linear(in_features, out_features)
    if ortho_gain is None:
        lecun_normal_(m.weight)
    else:
        nn.init.orthogonal_(m.weight, ortho_gain)
    nn.init.zeros_(m.bias)
    return m


class CustomNetwork(nn.Module):
    """Config-driven shared / policy / value MLPs
    (ocrl_tpu/rl/ac_nets.py:21-51)."""

    def __init__(self, acnet_config: ACNetConfig, features_dim: int):
        super().__init__()
        gain = math.sqrt(2) if acnet_config.ortho_init else None

        def mlp(net: NetConfig, in_dim: int):
            for act in net.acts:
                if act not in _ACTS:
                    raise ValueError(f"activation '{act}' is not implemented")
            dims = (in_dim,) + tuple(net.dims)
            layers = nn.ModuleList(_dense(a, b, gain) for a, b in zip(dims, dims[1:]))
            return layers, tuple(net.acts), dims[-1]

        self.shared, self._shared_acts, shared_dim = mlp(acnet_config.shared_net,
                                                         features_dim)
        self.policy, self._policy_acts, self.latent_dim_pi = mlp(
            acnet_config.policy_net, shared_dim)
        self.value, self._value_acts, self.latent_dim_vf = mlp(
            acnet_config.value_net, shared_dim)

    @staticmethod
    def _run(layers: nn.ModuleList, acts: tuple[str, ...], x: torch.Tensor) -> torch.Tensor:
        for layer, act in zip(layers, acts):
            x = _ACTS[act](layer(x))
        return x

    def forward(self, features: torch.Tensor):
        shared = self._run(self.shared, self._shared_acts, features)
        return (self._run(self.policy, self._policy_acts, shared),
                self._run(self.value, self._value_acts, shared))


class ActorCriticPolicy(nn.Module):
    """OCR + pooling + AC heads -> (logits, value)
    (ocrl_tpu/rl/ac_nets.py:54-96)."""

    def __init__(self, ocr_module: nn.Module, pooling_module: nn.Module,
                 acnet_config: ACNetConfig, features_dim: int, num_actions: int,
                 freeze_ocr: bool = True):
        super().__init__()
        self.ocr_module = ocr_module
        self.pooling_module = pooling_module
        self.freeze_ocr = freeze_ocr
        self.acnet = CustomNetwork(acnet_config, features_dim)
        ortho = acnet_config.ortho_init
        self.action_net = _dense(self.acnet.latent_dim_pi, num_actions,
                                 0.01 if ortho else None)
        self.value_net_out = _dense(self.acnet.latent_dim_vf, 1,
                                    1.0 if ortho else None)

    def ocr_rep(self, obs: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """The OCR representation alone. Frozen, the OCR runs without
        autograd (JAX's stop_gradient): it builds no graph and saves
        nothing, so no backward kernel runs for it."""
        if not self.freeze_ocr:
            return self.ocr_module(obs, noise=noise, generator=generator)
        with torch.no_grad():
            return self.ocr_module(obs, noise=noise, generator=generator)

    def heads_from_rep(self, rep: torch.Tensor):
        """Pooling + AC heads from an OCR representation -> (logits, value)."""
        latent_pi, latent_vf = self.acnet(self.pooling_module(rep))
        return self.action_net(latent_pi), self.value_net_out(latent_vf)[..., 0]

    def forward(self, obs: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None, from_rep: bool = False):
        """obs [B, H, W, C] in [0, 1] -> (logits [B, A], value [B]); with
        ``from_rep``, ``obs`` is an OCR representation and only the heads
        run (so that ``torch.func.functional_call``, which calls
        ``forward``, reaches ``heads_from_rep``)."""
        if from_rep:
            return self.heads_from_rep(obs)
        return self.heads_from_rep(self.ocr_rep(obs, noise, generator))
