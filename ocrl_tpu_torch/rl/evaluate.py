"""Policy evaluation (counterpart of ocrl_tpu/rl/evaluate.py): SB3's
evaluate_policy semantics, batched over a vec env or serial over one env.
``algo`` is anything with ``predict(obs, deterministic)``."""

from __future__ import annotations

import numpy as np

from .vec_env import coerce_action


def evaluate_policy(algo, env, n_episodes: int = 100,
                    deterministic: bool = False) -> dict:
    """Run n episodes; success rate + mean return/length.

    Accepts a single env (serial episodes) or a VecEnv — with a VecEnv the
    episodes run batched: ONE policy call steps every env, so an eval of 100
    episodes costs ~max-episode-length policy round-trips instead of
    ~n_episodes x episode-length (SB3's vectorised evaluate_policy semantics:
    per-env episode targets n_episodes // E (+1 for the first n % E))."""
    if not hasattr(env, "num_envs"):
        return _evaluate_serial(algo, env, n_episodes, deterministic)
    E = env.num_envs
    targets = np.array([n_episodes // E + (1 if i < n_episodes % E else 0)
                        for i in range(E)])
    counts = np.zeros(E, np.int64)
    ep_return = np.zeros(E, np.float64)
    ep_len = np.zeros(E, np.int64)
    successes, returns, lengths = [], [], []
    obs = env.reset()
    while (counts < targets).any():
        actions = algo.predict(obs, deterministic=deterministic)
        obs, rewards, dones, infos = env.step(actions)
        ep_return += rewards
        ep_len += 1
        for i in np.nonzero(dones)[0]:
            if counts[i] < targets[i]:
                counts[i] += 1
                returns.append(ep_return[i])
                lengths.append(ep_len[i])
                successes.append(float(infos[i].get("is_success", False)))
            ep_return[i] = 0.0
            ep_len[i] = 0
    return {
        "success_rate": float(np.mean(successes)),
        "mean_reward": float(np.mean(returns)),
        "mean_ep_length": float(np.mean(lengths)),
    }


def _evaluate_serial(algo, env, n_episodes: int, deterministic: bool) -> dict:
    successes, returns, lengths = [], [], []
    for _ in range(n_episodes):
        obs = env.reset()
        done = False
        total, steps = 0.0, 0
        info = {}
        while not done:
            action = algo.predict(obs, deterministic=deterministic)
            obs, reward, done, info = env.step(
                coerce_action(env.action_space, action))
            total += reward
            steps += 1
        returns.append(total)
        lengths.append(steps)
        successes.append(float(info.get("is_success", False)))
    return {
        "success_rate": float(np.mean(successes)),
        "mean_reward": float(np.mean(returns)),
        "mean_ep_length": float(np.mean(lengths)),
    }
