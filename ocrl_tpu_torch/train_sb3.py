"""RL training entry point of the port (counterpart of the repo-root
train_sb3.py), PPO and A2C on the synthetic envs:

    python -m ocrl_tpu_torch.train_sb3 ocr=slate pooling=transformer sb3=ppo \\
        sb3_acnet=mlp env=target-N4C4S3S1 sb3.algo_kwargs.ent_coef=0.01

Overrides as ``config.compose`` reads them: ``ocr=slate|slotattention|gt``,
``sb3=ppo|a2c``, ``env=<file stem of configs/env>``, ``seed``,
``num_envs``, ``max_steps``, ``sb3.algo_kwargs.*``, ``eval.*`` and any other
field of ``TrainSB3Config``. GT trains on the state observations. Every
``eval.freq`` vector steps the policy plays ``eval.n_episodes`` episodes on
``min(eval.n_episodes, eval.num_envs)`` envs seeded ``seed + num_envs``
(stochastic actions, as the JAX callback). Metrics go to
``<run_dir>/metrics.jsonl``: ``train/*`` after every iteration with
``rollout/success_rate`` and the iteration's seconds (``time/*``), and
``eval/*``. No checkpoint file is written yet (that comes with a later
slice): ``train`` returns the algorithm, whose ``save()`` holds the state.
Multi-seed runs (``seeds=``), SAC and videos raise ``NotImplementedError``.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .config import TrainSB3Config, compose, replace
from .device import resolve_device
from .envs import make_env
from .rl import A2C, PPO, build_policy, evaluate_policy, make_vec_env
from .utils.logger import Run, log_prefix

ALGOS = {"PPO": PPO, "A2C": A2C}


def train(config: TrainSB3Config, device=None) -> dict:
    """Train as ``config`` says on ``device`` (CUDA unless asked otherwise).
    Returns ``algo``, the last iteration's ``metrics``, the last ``eval``
    metrics (None before the first evaluation) and ``run_dir``."""
    if config.sb3.name not in ALGOS:
        raise NotImplementedError(f"sb3 '{config.sb3.name}' comes with a later slice")
    if config.ocr.name == "GT":             # GT trains on the state observations
        config = replace(config, "env.render_mode", "state")
    device = resolve_device(device)
    name = (f"{log_prefix(config)}-{config.sb3.name}-{config.sb3_acnet.name}-"
            f"{config.env.name}{config.env.mode}mode{config.env.rew_type}rewardtype-"
            f"Seed{config.seed}")
    run_dir = config.run_dir or (
        f"outputs/train_sb3/{config.ocr.name}-{config.pooling.name}-{config.sb3.name}-"
        f"{config.env.name}/{time.strftime('%Y-%m-%d_%H-%M-%S')}")
    run = Run(run_dir, "TrainSB3-" + name, config,
              config.tags.split(",") + config.env.tags.split(",") + [f"RandomSeed{config.seed}"])

    # The vec envs come before the policy, so that their workers fork from a
    # process that has not put this run's policy on the card yet; what makes
    # the fork safe even after CUDA is up is in rl/vec_env.py.
    vec_env = make_vec_env(make_env, config.env, config.num_envs, seed=config.seed,
                           mode=config.vec_env)
    n_eval_envs = min(int(config.eval.n_episodes), int(config.eval.num_envs))
    eval_env = make_vec_env(make_env, config.env, n_eval_envs,
                            seed=config.seed + config.num_envs, mode=config.vec_env)
    state = {"vec_steps": 0, "eval": None, "metrics": {}}
    try:
        policy = build_policy(config.policy_config(), seed=config.seed, device=device)
        algo = ALGOS[config.sb3.name](
            policy, vec_env.observation_space.shape, config.env.render_mode != "state",
            config.num_envs, config.sb3.algo_kwargs, seed=config.seed,
            freeze_ocr=policy.freeze_ocr, device=device)

        def step_callback(algo):
            state["vec_steps"] += 1
            if state["vec_steps"] % config.eval.freq == 0:
                metrics = evaluate_policy(algo, eval_env, n_episodes=config.eval.n_episodes)
                run.log({f"eval/{k}": v for k, v in metrics.items()}, step=algo.num_timesteps)
                print(f"[{algo.num_timesteps} steps] eval success "
                      f"{metrics['success_rate']:.3f} reward {metrics['mean_reward']:.3f}",
                      flush=True)
                state["eval"] = metrics

        def iteration_callback(algo, metrics, ep_infos):
            payload = {f"train/{k}": v for k, v in metrics.items()}
            if ep_infos:
                payload["rollout/success_rate"] = float(
                    np.mean([i["is_success"] for i in ep_infos]))
            payload.update({f"time/{k}": v for k, v in algo.last_iteration.items()})
            run.log(payload, step=algo.num_timesteps)
            state["metrics"] = metrics

        algo.learn(vec_env, int(float(config.max_steps)),
                   iteration_callback=iteration_callback, step_callback=step_callback)
    finally:
        vec_env.close()
        eval_env.close()
    return {"algo": algo, "metrics": state["metrics"], "eval": state["eval"],
            "run_dir": run.dir}


def main(argv=None, device=None) -> dict:
    result = train(compose(TrainSB3Config(), sys.argv[1:] if argv is None else argv),
                   device)
    print({"metrics": result["metrics"], "eval": result["eval"],
           "num_timesteps": result["algo"].num_timesteps, "run_dir": str(result["run_dir"])})
    return result


if __name__ == "__main__":
    main()
