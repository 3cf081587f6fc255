"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """CUDA unless the caller asks for another device; with no card and no
    explicit request this raises rather than carry on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        # The JAX model computes in fp32, and with ``ocr.amp=bf16`` SLATE's
        # conv stacks in bf16 (ocrl_tpu/models/slate.py:51-57) and all else
        # in fp32. cuDNN runs fp32 convolutions in TF32 by default, which
        # keeps about three decimal digits and would move the CNN features
        # away from the reference; matmuls are pinned too, whatever the
        # process set before. Neither setting touches a bf16 convolution.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device
