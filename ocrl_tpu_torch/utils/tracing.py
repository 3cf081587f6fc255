"""Named ranges of the program's phases on a torch.profiler trace.

``span(name)`` marks one phase as the range ``ocrl.<name>`` while a
torch.profiler session records (``train_ocr``'s ``profile_dir``, or an
operator's own ``torch.profiler.profile`` around any call), and costs one
flag check otherwise: no clock read, no allocation. A range lies on the
trace's clock beside the kernels, so each kernel falls under the range open
at its launch (the backward's kernels, launched by autograd's thread, under
``ocrl.backward`` on the calling thread). Ranges opened in other Python
threads are not recorded by the profiler.

The spans and where they sit:

- ``ocrl.step``: one OCR optimizer step (``OCR._step``), the root of
  ``ocrl.forward`` (the loss), ``ocrl.backward`` and ``ocrl.optimizer``
  (the clip and Adam);
- ``ocrl.update``: one SAC gradient step (``SAC.update``), the root of its
  ``ocrl.optimizer`` (both Adam steps, Polyak and the entropy coefficient's
  step);
- ``ocrl.sample`` and ``ocrl.upload``: SAC's gather of a batch from its
  replay buffer and the batch's copy to the device;
- ``ocrl.env_wait``: a vector env's step, from the first action sent to the
  last reply.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

PREFIX = "ocrl."
_OFF = nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager: ``record_function("ocrl.<name>")`` while a
    profiler records, else a shared one that does nothing."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
