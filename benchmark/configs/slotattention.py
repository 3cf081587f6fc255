"""The ``slotattention`` configuration: SLATE's encoder and slot attention
trained through the spatial broadcast decoder (``use_bcdec``). The program
is told as for ``slate``; the FLOPs are the encoder's and the broadcast
decoder's, its first convolution taken as the program restructures it (the
slot term on a 5 x 5 grid, the position term once)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

from benchcore.counts import conv_flops, train_flops as _train
from benchref.ocr import Trainer, param_spec  # noqa: F401

_spec = importlib.util.spec_from_file_location("benchcfg_slate_shared",
                                               Path(__file__).with_name("slate.py"))
_slate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_slate)
overrides = _slate.overrides


def train_flops(m: dict, B: int) -> int:
    """Model FLOPs of one training step at batch B, forward and backward."""
    size, C, hid, S, D = (m["obs_size"], m["obs_channels"], m["cnn_hidden_size"],
                          m["num_slots"], m["slot_size"])
    images = B * S
    decoder = [(conv_flops(images, 5, 5, D, hid, 5), True),
               (conv_flops(1, size, size, D, hid, 5), True),
               (conv_flops(1, size, size, 4, D, 1), False),
               (conv_flops(images, size, size, hid, hid, 5), True),
               (conv_flops(images, size, size, hid, hid, 5), True),
               (conv_flops(images, size, size, hid, C + 1, 3), True)]
    return _train(_slate.encoder_forward(m, B) + decoder)
