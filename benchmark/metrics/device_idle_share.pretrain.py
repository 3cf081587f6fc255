"""device_idle_share.pretrain (device): % of the timed window in which no
device operation ran, estimated as 1 - (the device's busy seconds a step in
the traced window, the union of the intervals of its operations, times the
timed window's steps) / the timed window's wall seconds. The traced window
itself runs the host slower (the profiler records every host operation),
so its own idle share, which ``device`` reports, is higher."""


def read(run):
    trace, steps = run.get("trace"), run.get("trace_steps")
    if trace is None or not steps or trace.busy_s() <= 0:
        return None
    busy = trace.busy_s() / steps * run["window_steps"]
    return 100.0 * (1.0 - busy / run["window_s"])
