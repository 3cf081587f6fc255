"""RL training entry point of the port (counterpart of the repo-root
train_sb3.py:28-207): PPO and A2C on the synthetic envs, SAC on the
CausalWorld reach envs (the fake TriFinger backend):

    python -m ocrl_tpu_torch.train_sb3 ocr=slate pooling=transformer sb3=ppo \\
        sb3_acnet=mlp env=target-N4C4S3S1 sb3.algo_kwargs.ent_coef=0.01
    python -m ocrl_tpu_torch.train_sb3 ocr=slate pooling=transformer sb3=sac \\
        sb3_acnet=mlp env=cw-target-N4C4S1S1 env.use_fake_sim=true
    python -m ocrl_tpu_torch.train_sb3 ... seeds=1234,2345,3456 \\
        pipeline_rollout=True cache_frozen_reps=True
    python -m ocrl_tpu_torch.train_sb3 ... resume=<run_dir>/models/latest_model.ckpt

Overrides as ``config.compose`` reads them: ``ocr=``, ``pooling=``,
``sb3=ppo|a2c|sac``, ``env=<file stem of configs/env>``, ``seed``, ``seeds``,
``num_envs`` (a seed), ``max_steps`` (a seed), ``sb3.algo_kwargs.*``,
``eval.*``, ``video.*``, ``resume`` and any other field of
``TrainSB3Config``. GT trains on the state observations.

``seeds=`` trains every seed as one vmapped PPO (``rl.multi_seed``, PPO
only, as JAX): envs ``[i*num_envs, (i+1)*num_envs)`` seeded ``seeds[i] +
rank``, the evaluation envs seeded ``seeds[i] + 100000 + rank``; with
``pipeline_rollout`` the rollout dispatches its env buckets' calls ahead,
with ``cache_frozen_reps`` a frozen OCR encodes each rollout once. Every
``eval.freq`` vector steps the policy plays ``eval.n_episodes`` episodes
(stochastic actions, as the JAX callback): one seed on ``min(eval.n_episodes,
eval.num_envs)`` envs seeded ``seed + num_envs``, several seeds all at once
on ``num_envs`` envs each.

The run directory holds ``metrics.jsonl`` (``train/*`` after every
iteration with ``rollout/success_rate`` and the iteration's seconds
``time/*``, ``eval/*``; with seeds also ``train/seed{s}/*``,
``rollout/seed{s}/success_rate`` and ``eval/seed{s}/*``, the last at
``num_timesteps // S``), ``models/best_model.ckpt`` (written at each
evaluation whose success is at least the best so far),
``models/latest_model.ckpt`` (after an iteration once 120 s have passed
since the last write, so the first iteration writes, and at the end) and
``videos/rollout_step{t}.gif`` (``video.length`` frames of env 0 every
``video.interval`` timesteps, ``rl.video``). The agent files are JAX's
(``utils.checkpoint.save_algo``): JAX's ``test_sb3`` and ``+resume=`` read
them, and ``resume=`` reads JAX's (SAC's with its target parameters and
``log_alpha``; a resumed run starts a fresh replay buffer and, at or past
``learning_starts``, acts and updates from its first step, as JAX's). SAC
needs a Box action space; with a pretrained, frozen OCR it freezes the
pooling too and keeps the target's OCR at its random init, as JAX
(``rl.sac``).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

from .config import TrainSB3Config, compose, replace, seed_list
from .device import resolve_device
from .envs import make_env
from .rl import (A2C, PPO, SAC, MultiSeedPPO, VideoRecorder, build_policy, build_sac_policy,
                 evaluate_policy, inject_pretrained_ocr, make_multi_seed_vec_env, make_vec_env)
from .utils.checkpoint import get_ocr, load_algo, resolve_ocr_checkpoint_path, save_algo
from .utils.logger import Run, log_prefix

ALGOS = {"PPO": PPO, "A2C": A2C, "SAC": SAC}
LATEST_EVERY = 120.0               # seconds between latest_model writes


def build_algo(config: TrainSB3Config, obs_shape, device, seeds=None, action_space=None):
    """The PPO, A2C, SAC (for ``action_space``, a Box) or (``seeds``)
    MultiSeedPPO of ``config`` on ``device``."""
    is_image = config.env.render_mode != "state"
    if config.sb3.name == "SAC":
        if hasattr(action_space, "n"):
            raise ValueError(f"SAC needs a continuous (Box) action space; env "
                             f"'{config.env.env}' is discrete: use sb3=ppo or sb3=a2c")
        policy, ocr = build_sac_policy(config, action_space, config.seed, device)
        algo = SAC(policy, obs_shape, is_image, config.num_envs, config.sb3.algo_kwargs,
                   seed=config.seed, action_low=action_space.low,
                   action_high=action_space.high, device=device)
        if ocr is not None:
            inject_pretrained_ocr(algo, ocr)
        return algo
    if not seeds:
        policy = build_policy(config.policy_config(), seed=config.seed, device=device)
        return ALGOS[config.sb3.name](
            policy, obs_shape, is_image, config.num_envs, config.sb3.algo_kwargs,
            seed=config.seed, freeze_ocr=policy.freeze_ocr, device=device)
    # JAX's order: each seed's fresh policy, then the pretrained OCR in all
    cpt = config.pooling.ocr_checkpoint
    pretrained = resolve_ocr_checkpoint_path(cpt) is not None
    fresh = config.policy_config()
    fresh = replace(replace(fresh, "pooling.ocr_checkpoint.local_file", ""),
                    "pooling.ocr_checkpoint.run_id", "")
    algo = MultiSeedPPO([build_policy(fresh, seed=s, device=device) for s in seeds],
                        obs_shape, is_image, config.num_envs, config.sb3.algo_kwargs, seeds,
                        freeze_ocr=pretrained and not cpt.finetuning,
                        pipeline=config.pipeline_rollout,
                        cache_frozen_reps=config.cache_frozen_reps, device=device)
    if pretrained:
        ocr, _ = get_ocr(config.ocr, config.env, cpt, config.seed, device)
        inject_pretrained_ocr(algo, ocr)
    return algo


def train(config: TrainSB3Config, device=None) -> dict:
    """Train as ``config`` says on ``device`` (CUDA unless asked otherwise).
    Returns ``algo``, the last iteration's ``metrics``, the last ``eval``
    metrics (None before the first evaluation), ``run_dir`` and the GIFs
    written (``videos``)."""
    if config.sb3.name not in ALGOS:
        raise ValueError(f"unknown algo '{config.sb3.name}' (available: {', '.join(ALGOS)})")
    seeds = seed_list(config.seeds)
    if seeds and config.sb3.name != "PPO":
        raise ValueError("seeds= (vmapped multi-seed) is PPO-only")
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
    models = run.dir / "models"
    models.mkdir(parents=True, exist_ok=True)

    # The vec envs come before the policy, so that their workers fork from a
    # process that has not put this run's policy on the card yet; what makes
    # the fork safe even after CUDA is up is in rl/vec_env.py.
    if seeds:
        vec_env = make_multi_seed_vec_env(make_env, config.env, config.num_envs, seeds,
                                          mode=config.vec_env)
        eval_env = make_multi_seed_vec_env(make_env, config.env, config.num_envs,
                                           [s + 100000 for s in seeds], mode=config.vec_env)
    else:
        vec_env = make_vec_env(make_env, config.env, config.num_envs, seed=config.seed,
                               mode=config.vec_env)
        n_eval_envs = min(int(config.eval.n_episodes), int(config.eval.num_envs))
        eval_env = make_vec_env(make_env, config.env, n_eval_envs,
                                seed=config.seed + config.num_envs, mode=config.vec_env)
    state = {"vec_steps": 0, "eval": None, "metrics": {}, "best_success": -1.0,
             "last_latest": 0.0}
    video = VideoRecorder(run.dir / "videos", config.video.interval, config.video.length)
    try:
        algo = build_algo(config, vec_env.observation_space.shape, device, seeds,
                          vec_env.action_space)
        if config.resume not in (None, ""):
            meta = load_algo(Path(str(config.resume)), algo)
            print(f"resumed from {config.resume} at {algo.num_timesteps} timesteps "
                  f"(saved at {meta.get('num_timesteps')})", flush=True)

        def run_eval(algo) -> dict:
            if not seeds:
                return evaluate_policy(algo, eval_env, n_episodes=config.eval.n_episodes)
            per_seed = algo.evaluate_all(eval_env, n_episodes=config.eval.n_episodes)
            # per-seed curves on a per-seed step axis, as one-seed runs count
            for s, m in zip(seeds, per_seed):
                run.log({f"eval/seed{s}/{k}": v for k, v in m.items()},
                        step=algo.num_timesteps // len(seeds))
            return {k: float(np.mean([m[k] for m in per_seed])) for k in per_seed[0]}

        def step_callback(algo):
            state["vec_steps"] += 1
            video.maybe_record(vec_env, algo.num_timesteps)
            if state["vec_steps"] % config.eval.freq == 0:
                metrics = run_eval(algo)
                run.log({f"eval/{k}": v for k, v in metrics.items()}, step=algo.num_timesteps)
                print(f"[{algo.num_timesteps} steps] eval success "
                      f"{metrics['success_rate']:.3f} reward {metrics['mean_reward']:.3f}",
                      flush=True)
                state["eval"] = metrics
                if metrics["success_rate"] >= state["best_success"]:
                    state["best_success"] = metrics["success_rate"]
                    save_algo(models / "best_model.ckpt", algo,
                              {"num_timesteps": algo.num_timesteps,
                               "success_rate": metrics["success_rate"]})

        def iteration_callback(algo, metrics, ep_infos):
            payload = {}
            for k, v in metrics.items():
                arr = np.asarray(v, np.float64).reshape(-1)
                payload[f"train/{k}"] = float(arr.mean())
                if seeds and arr.size == len(seeds):
                    payload.update({f"train/seed{s}/{k}": float(x) for s, x in zip(seeds, arr)})
            if seeds:
                for s, infos in zip(seeds, ep_infos):
                    if infos:
                        payload[f"rollout/seed{s}/success_rate"] = float(
                            np.mean([i["is_success"] for i in infos]))
                ep_infos = [i for infos in ep_infos for i in infos]
            if ep_infos:
                payload["rollout/success_rate"] = float(
                    np.mean([i["is_success"] for i in ep_infos]))
            payload.update({f"time/{k}": v for k, v in algo.last_iteration.items()})
            run.log(payload, step=algo.num_timesteps)
            state["metrics"] = {k[len("train/"):]: v for k, v in payload.items()
                                if k.startswith("train/") and "/seed" not in k}
            now = time.time()
            if now - state["last_latest"] >= LATEST_EVERY:
                state["last_latest"] = now
                save_latest(algo)

        def save_latest(algo):
            save_algo(models / "latest_model.ckpt", algo, {"num_timesteps": algo.num_timesteps})
            state["latest_at"] = algo.num_timesteps

        algo.learn(vec_env, int(float(config.max_steps)),
                   iteration_callback=iteration_callback, step_callback=step_callback)
        if state.get("latest_at") != algo.num_timesteps:   # else the file holds this state
            save_latest(algo)
        video.close()
    finally:
        vec_env.close()
        eval_env.close()
    return {"algo": algo, "metrics": state["metrics"], "eval": state["eval"],
            "run_dir": run.dir, "videos": list(video.written)}


def main(argv=None, device=None) -> dict:
    result = train(compose(TrainSB3Config(), sys.argv[1:] if argv is None else argv),
                   device)
    print({"metrics": result["metrics"], "eval": result["eval"],
           "num_timesteps": result["algo"].num_timesteps, "run_dir": str(result["run_dir"])})
    return result


if __name__ == "__main__":
    main()
