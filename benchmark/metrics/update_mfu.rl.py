"""update_mfu.rl (whole step): % of the card's fp32 peak that one SAC
update's model FLOPs (the configuration's count) reach at the timed
window's time an update (``sac_update_ms.rl``)."""


def read(run):
    if "peak_flops" not in run or not run.get("update_ms"):
        return None
    return 100.0 * run["update_flops"] / (run["update_ms"] / 1e3) / run["peak_flops"]
