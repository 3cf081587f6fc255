"""Hand-written CUDA kernels for Hopper and their plain torch versions."""

from ._build import LAUNCHES, build, reset_launches
from .gumbel import (gumbel_argmax_ids, gumbel_argmax_ids_reference,
                     gumbel_softmax_sample, gumbel_softmax_sample_reference)
from .slot_routing import pick_chunk, route_sweep, route_sweep_reference

__all__ = ["LAUNCHES", "build", "reset_launches", "gumbel_argmax_ids",
           "gumbel_argmax_ids_reference", "gumbel_softmax_sample",
           "gumbel_softmax_sample_reference", "pick_chunk", "route_sweep",
           "route_sweep_reference"]
