"""step_device_ms.pretrain (step): device time of the kernels that started in
the traced window, summed, per optimizer step."""


def read(run):
    trace, steps = run.get("trace"), run.get("trace_steps")
    if trace is None or not steps:
        return None
    total_us = sum(op.end - op.start for op in trace.kernels)
    return total_us / 1e3 / steps if total_us > 0 else None
