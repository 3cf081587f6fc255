"""device_idle_share.rl (device): % of the timed window in which no device
operation ran, estimated as 1 - (the device's busy seconds a vector step in
the traced window, the union of the intervals of its operations, times the
timed window's vector steps) / the timed window's wall seconds (see
device_idle_share.pretrain)."""


def read(run):
    trace, steps = run.get("trace"), run.get("trace_steps")
    if trace is None or not steps or trace.busy_s() <= 0:
        return None
    busy = trace.busy_s() / steps * run["vector_steps"]
    return 100.0 * (1.0 - busy / run["window_s"])
