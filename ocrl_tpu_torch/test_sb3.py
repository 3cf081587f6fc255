"""Trained-agent evaluation entry point of the port (counterpart of the
repo-root test_sb3.py):

    python -m ocrl_tpu_torch.test_sb3 ocr=gt pooling=transformer \\
        pooling.num_layers=3 sb3=ppo sb3_acnet=mlp env=odd-one-out-N4C2S2S1 \\
        agent_checkpoint.file=artifacts/rl/GT-Transformer-PPO-OddOneOutN4C2S2S1Env-final \\
        agent_checkpoint.index=0
    python -m ocrl_tpu_torch.test_sb3 ... seeds=1234,2345,3456 \\
        agent_checkpoint.file=<run_dir>/models/latest_model

The agent file is JAX's (``OCRLTPU1``, JAX's or the port's train_sb3 wrote
it; ``utils.checkpoint``). Without ``seeds``: its ``policy_params`` go
through ``utils.convert.from_flax``; of a file stacked over seeds (a
``seeds`` key, a leading axis on every leaf, as the committed
``artifacts/rl`` files) the slice of ``agent_checkpoint.seed`` or, without
one, of ``agent_checkpoint.index``; the agent plays ``n_eval_episodes``
episodes, stochastic, on ``min(n_eval_episodes, 20)`` envs seeded from
``seed``. With ``seeds`` (test_sb3.py:39-83): every seed of the file, which
must have been trained with those seeds, in a ``MultiSeedPPO`` (the file
read with ``allow_partial``, so a params-only file loads), each seed on
``min(n_eval_episodes, 32)`` envs seeded ``s + 200000 + rank`` in this
process, all seeds in the same batched policy calls (``evaluate_all``);
the result is ``{"per_seed": {"seed<s>": metrics}, "summary": {metric:
{"mean", "std"}}}``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from .config import AgentCheckpointConfig, TestSB3Config, compose, replace, seed_list
from .device import resolve_device
from .envs import make_env
from .rl import (A2C, PPO, MultiSeedPPO, build_policy, evaluate_policy,
                 make_multi_seed_vec_env, make_vec_env)
from .utils.checkpoint import load_algo, load_checkpoint, resolve_ocr_checkpoint_path
from .utils.convert import from_flax
from .utils.logger import Run, log_prefix


def agent_path(cpt: AgentCheckpointConfig) -> Path:
    """``run_id/file``, ``.ckpt`` added when missing."""
    path = Path(cpt.run_id) / cpt.file if cpt.run_id else Path(cpt.file)
    return path if str(path).endswith(".ckpt") else Path(f"{path}.ckpt")


def agent_params(cpt: AgentCheckpointConfig) -> tuple[dict, dict]:
    """(the JAX policy's parameter tree of one agent, the file's metadata
    with the seed taken, ``seed``, when the file is stacked)."""
    tree, meta = load_checkpoint(agent_path(cpt))
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
        raise ValueError(f"test_sb3 scores PPO and A2C agents, as JAX's test_sb3 "
                         f"(test_sb3.py:86-93); not sb3 '{config.sb3.name}'")
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


def evaluate_seeds(config: TestSB3Config, device=None, deterministic: bool = False) -> dict:
    """Every seed of ``config.seeds`` of a multi-seed agent file, in one
    batched evaluation; {"per_seed", "summary"} (see the module docstring).
    ``deterministic`` plays the argmax actions instead of JAX's sampled
    ones."""
    seeds = seed_list(config.seeds)
    if config.ocr.name == "GT":             # GT plays on the state observations
        config = replace(config, "env.render_mode", "state")
    device = resolve_device(device)
    n_env = min(int(config.n_eval_episodes), 32)
    eval_env = make_multi_seed_vec_env(make_env, config.env, n_env,
                                       [s + 200000 for s in seeds], mode="dummy")
    try:
        cpt = config.pooling.ocr_checkpoint
        freeze = resolve_ocr_checkpoint_path(cpt) is not None and not cpt.finetuning
        fresh = replace(replace(config.policy_config(), "pooling.ocr_checkpoint.local_file",
                                ""), "pooling.ocr_checkpoint.run_id", "")
        algo = MultiSeedPPO([build_policy(fresh, seed=s, device=device) for s in seeds],
                            eval_env.observation_space.shape, config.env.render_mode != "state",
                            n_env, config.sb3.algo_kwargs, seeds, freeze_ocr=freeze,
                            device=device)
        meta = load_algo(agent_path(config.agent_checkpoint), algo, allow_partial=True)
        per_seed = algo.evaluate_all(eval_env, n_episodes=config.n_eval_episodes,
                                     deterministic=deterministic)
    finally:
        eval_env.close()
    results = {f"seed{s}": m for s, m in zip(seeds, per_seed)}
    summary = {k: {"mean": float(np.mean([m[k] for m in per_seed])),
                   "std": float(np.std([m[k] for m in per_seed]))} for k in per_seed[0]}
    if config.run_dir:
        run = Run(config.run_dir, "TestSB3-" + log_prefix(config), config)
        for s, m in zip(seeds, per_seed):
            run.log({f"test/seed{s}/{k}": v for k, v in m.items()}, step=0)
        run.log({f"test/{k}_mean": v["mean"] for k, v in summary.items()}, step=0)
    return {"per_seed": results, "summary": summary,
            "num_timesteps": meta.get("num_timesteps")}


def main(argv=None, device=None) -> dict:
    config = compose(TestSB3Config(), sys.argv[1:] if argv is None else argv)
    if seed_list(config.seeds):
        result = evaluate_seeds(config, device)
        print({"per_seed": result["per_seed"], "summary": result["summary"]})
        return result
    metrics = evaluate_agent(config, device)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
