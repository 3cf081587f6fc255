"""conv_share.pretrain (model): % of the traced window's kernel time spent in
cuDNN's convolutions, found by name (``kernels.is_conv``: implicit GEMMs,
Winograd and FFT transforms and their complex GEMMs, layout transforms)."""

from benchcore.kernels import is_conv


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    kernels = trace.kernels
    total = sum(op.end - op.start for op in kernels)
    conv = sum(op.end - op.start for op in kernels if is_conv(op.name))
    return 100.0 * conv / total if total > 0 and conv > 0 else None
