"""sac_update_ms.rl (RL loop): ms an update takes over the timed window,
sampling, upload, update and the metrics to the host: ``SAC.totals``'
``update_s / updates``."""


def read(run):
    return run.get("update_ms")
