"""Trained-agent evaluation entry point of the port (counterpart of the
repo-root test_sb3.py):

    python -m ocrl_tpu_torch.test_sb3 ocr=gt pooling=transformer \\
        pooling.num_layers=3 sb3=ppo sb3_acnet=mlp env=odd-one-out-N4C2S2S1 \\
        agent_checkpoint.file=artifacts/rl/GT-Transformer-PPO-OddOneOutN4C2S2S1Env-final \\
        agent_checkpoint.index=0

The agent file is one the JAX package wrote (``OCRLTPU1``, read by
``utils.checkpoint.load_checkpoint``); its ``policy_params`` go through
``utils.convert.from_flax``. A file stacked over seeds (a ``seeds`` key, a
leading axis on every leaf, as the committed ``artifacts/rl`` files) gives
the slice of ``agent_checkpoint.seed`` or, without one, of
``agent_checkpoint.index``. The agent plays ``n_eval_episodes`` episodes,
stochastic, on ``min(n_eval_episodes, 20)`` envs seeded from ``seed``.
Evaluating every seed of a file in one batched call comes with the
multi-seed slice.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from .config import AgentCheckpointConfig, TestSB3Config, compose, replace
from .device import resolve_device
from .envs import make_env
from .rl import A2C, PPO, build_policy, evaluate_policy, make_vec_env
from .utils.checkpoint import load_checkpoint
from .utils.convert import from_flax
from .utils.logger import Run, log_prefix


def agent_params(cpt: AgentCheckpointConfig) -> tuple[dict, dict]:
    """(the JAX policy's parameter tree of one agent, the file's metadata
    with the seed taken, ``seed``, when the file is stacked)."""
    path = Path(cpt.run_id) / cpt.file if cpt.run_id else Path(cpt.file)
    if not str(path).endswith(".ckpt"):
        path = Path(f"{path}.ckpt")
    tree, meta = load_checkpoint(path)
    params = tree["policy_params"]
    if "seeds" in tree:
        seeds = [int(tree["seeds"][k]) for k in sorted(tree["seeds"], key=int)]
        if cpt.seed is not None:
            if cpt.seed not in seeds:
                raise ValueError(f"seed {cpt.seed} is not in the file's seeds {seeds}")
            index = seeds.index(cpt.seed)
        else:
            index = cpt.index
        if not 0 <= index < len(seeds):
            raise IndexError(f"index {index}: the file holds {len(seeds)} seeds")
        params = _slice(params, index)
        meta = dict(meta, seed=seeds[index])
    return params, meta


def _slice(tree: dict, index: int) -> dict:
    return {k: _slice(v, index) if isinstance(v, dict) else np.asarray(v)[index]
            for k, v in tree.items()}


def load_agent(config: TestSB3Config, obs_shape, device=None):
    """The PPO or A2C of ``config`` with the agent file's policy, for
    observations of ``obs_shape``; (algo, metadata)."""
    if config.sb3.name not in ("PPO", "A2C"):
        raise NotImplementedError(f"sb3 '{config.sb3.name}' comes with a later slice")
    device = resolve_device(device)
    params, meta = agent_params(config.agent_checkpoint)
    policy = build_policy(config.policy_config(), seed=config.seed, device=device)
    policy.load_state_dict({k: v.to(device) for k, v in from_flax(params).items()})
    algo_cls = A2C if config.sb3.name == "A2C" else PPO
    algo = algo_cls(policy, obs_shape, config.env.render_mode != "state", 1,
                    config.sb3.algo_kwargs, seed=config.seed, device=device)
    return algo, meta


def evaluate_agent(config: TestSB3Config, device=None) -> dict:
    """Load the agent and play ``n_eval_episodes``; the metrics."""
    if config.ocr.name == "GT":             # GT plays on the state observations
        config = replace(config, "env.render_mode", "state")
    eval_env = make_vec_env(make_env, config.env, min(int(config.n_eval_episodes), 20),
                            seed=config.seed, mode="dummy")
    try:
        algo, meta = load_agent(config, eval_env.observation_space.shape, device)
        metrics = evaluate_policy(algo, eval_env, n_episodes=config.n_eval_episodes)
    finally:
        eval_env.close()
    if config.run_dir:
        run = Run(config.run_dir, "TestSB3-" + log_prefix(config), config)
        run.log({f"test/{k}": v for k, v in metrics.items()}, step=0)
    return dict(metrics, num_timesteps=meta.get("num_timesteps"), seed=meta.get("seed"))


def main(argv=None, device=None) -> dict:
    metrics = evaluate_agent(compose(TestSB3Config(), sys.argv[1:] if argv is None else argv),
                             device)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
