"""env_step_ms.rl (envs): ms a vector step spends acting, stepping the envs
and adding to the buffer over the timed window: ``SAC.totals``'
``policy_s / policy_steps``, host clocks that end in a host copy."""


def read(run):
    return run.get("env_step_ms")
