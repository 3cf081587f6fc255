"""Weights made by the benchmark from the seed: one uniform draw of every
parameter's values from a generator on the device, shaped and scaled leaf
by leaf by the reference's parameter list (``param_spec``)."""

from __future__ import annotations

import math

import torch


def _bound(shape: tuple, init: str) -> tuple[float, float]:
    """(centre, half-width) of a leaf's uniform values."""
    if init == "one":
        return 1.0, 0.0
    if init == "zero":
        return 0.0, 0.0
    if init == "unit":
        return 0.0, math.sqrt(3.0)
    if init == "embed":
        return 0.0, math.sqrt(3.0 / shape[-1])
    if init == "slot":
        return 0.0, math.sqrt(6.0 / (1 + shape[-1]))
    if init == "fan":
        receptive = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
        return 0.0, math.sqrt(6.0 / (fan_in + fan_out))
    raise ValueError(f"unknown init '{init}'")


def make(spec: list[tuple[str, tuple, str]], seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} of the spec's leaves."""
    device = torch.device(device)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        centre, half = _bound(shape, init)
        out[name] = flat[at:at + n].view(shape).mul(half).add_(centre)
        at += n
    return out
