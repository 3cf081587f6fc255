"""step_mfu.pretrain (whole step): % of the card's fp32 peak that a step's
model FLOPs (the configuration's count: forward and backward from the
shapes, no recompute) reach at the timed window's time a step."""


def read(run):
    if "peak_flops" not in run or not run.get("window_steps"):
        return None
    seconds_a_step = run["window_s"] / run["window_steps"]
    return 100.0 * run["step_flops"] / seconds_a_step / run["peak_flops"]
