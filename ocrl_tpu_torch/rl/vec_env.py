"""Host-side vectorised envs (counterpart of ocrl_tpu/rl/vec_env.py):
``VecEnv`` steps its envs in turn in this process, ``SubprocVecEnv`` runs one
forked process per env; both auto-reset on done with SB3's semantics (the
observation returned after a done is the next episode's first, the last one
goes into ``info["terminal_observation"]``). ``step_indices`` steps only
some of the envs (the pipelined rollouts step one bucket while another's
policy call is in flight) and ``render_frame`` returns the first env's RGB
frame (the video recorder). ``make_multi_seed_vec_env`` lays out S seeds'
env groups in one vec env (ocrl_tpu/rl/vec_env.py:175-185). A step's wait
on its envs is the span ``ocrl.env_wait`` on a profiler's trace
(``utils.tracing``).

Fork safety: the port forks its workers after CUDA is up (``chip_smoke.py``
has used the card before it builds an env, and ``train_sb3`` builds its vec
envs before the policy, but a caller may hold a CUDA context already). A
worker runs only this module's loop, the env (numpy: the sprite envs and
the CausalWorld envs, each built inside its worker) and the rasterizer
(ctypes); none of that imports or calls torch, so no worker touches CUDA or
torch's device state. torch's own fork handler marks CUDA unusable in the
child, so a worker that did would raise rather than share the parent's
context. The rasterizer is built in the parent before the fork
(``native.build``), not by each worker.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import Callable, Sequence

import numpy as np

from .. import native
from ..utils import tracing


def coerce_action(action_space, act):
    """Discrete envs take ints; continuous (Box) envs take float vectors."""
    if hasattr(action_space, "n"):
        return int(act)
    return np.asarray(act, np.float32)


def _step(env, action_space, act):
    o, r, d, info = env.step(coerce_action(action_space, act))
    if d:
        info = dict(info)
        info["terminal_observation"] = o
        o = env.reset()
    return o, r, d, info


def _stacked(results):
    obs, rewards, dones, infos = zip(*results)
    return (np.stack(obs), np.asarray(rewards, np.float32), np.asarray(dones, bool),
            list(infos))


class VecEnv:
    def __init__(self, env_fns: Sequence[Callable]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space

    def reset(self) -> np.ndarray:
        return np.stack([env.reset() for env in self.envs])

    def step(self, actions):
        """-> (obs [E, ...], rewards [E] float32, dones [E] bool, infos)."""
        with tracing.span("env_wait"):
            results = [_step(env, self.action_space, act)
                       for env, act in zip(self.envs, actions)]
        return _stacked(results)

    def step_indices(self, indices, actions):
        """``step`` of the envs at ``indices`` alone, in that order."""
        with tracing.span("env_wait"):
            results = [_step(self.envs[i], self.action_space, act)
                       for i, act in zip(indices, actions)]
        return _stacked(results)

    def render_frame(self) -> np.ndarray:
        """The first env's RGB frame."""
        return self.envs[0].render("rgb_array")

    def close(self) -> None:
        for env in self.envs:
            env.close()


def make_vec_env(env_ctor, env_config, num_envs: int, seed: int = 0,
                 mode: str = "auto") -> "VecEnv | SubprocVecEnv":
    """Envs ``env_ctor(env_config, seed + rank)``. mode: "dummy" (in this
    process), "subproc" (one forked process per env), or "auto" (subproc
    when there is more than one env and the host has more than two cores,
    ocrl_tpu/rl/vec_env.py:84-86)."""
    fns = [(lambda rank: (lambda: env_ctor(env_config, seed + rank)))(i)
           for i in range(num_envs)]
    return _vec_env(fns, mode)


def make_multi_seed_vec_env(env_ctor, env_config, num_envs: int, seeds,
                            mode: str = "auto") -> "VecEnv | SubprocVecEnv":
    """One vec env of ``len(seeds)`` env groups of ``num_envs``: envs
    ``[i*num_envs, (i+1)*num_envs)`` belong to seed i and are seeded
    ``seeds[i] + rank``, the layout ``MultiSeedPPO`` expects. ``mode`` as
    ``make_vec_env``, counting all the envs."""
    fns = [(lambda s: (lambda: env_ctor(env_config, s)))(int(seed) + rank)
           for seed in seeds for rank in range(num_envs)]
    return _vec_env(fns, mode)


def _vec_env(fns, mode: str) -> "VecEnv | SubprocVecEnv":
    if mode not in ("auto", "dummy", "subproc"):
        raise ValueError(f"vec env mode must be auto, dummy or subproc, not '{mode}'")
    if mode == "subproc" or (
            mode == "auto" and len(fns) > 1 and (os.cpu_count() or 1) > 2):
        return SubprocVecEnv(fns)
    return VecEnv(fns)


def _subproc_worker(remote, parent_remote, env_fn) -> None:
    parent_remote.close()
    env = env_fn()
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                remote.send(_step(env, env.action_space, data))
            elif cmd == "reset":
                remote.send(env.reset())
            elif cmd == "render":
                remote.send(env.render("rgb_array"))
            elif cmd == "spaces":
                remote.send((env.observation_space, env.action_space))
            elif cmd == "close":
                remote.close()
                break
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        env.close()


class SubprocVecEnv:
    """One forked process per env, driven over pipes; the interface of
    ``VecEnv``. The env steps of one vector step run at once."""

    def __init__(self, env_fns: Sequence[Callable]):
        native.build()
        ctx = mp.get_context("fork")
        self.num_envs = len(env_fns)
        self.remotes, work_remotes = zip(*[ctx.Pipe() for _ in env_fns])
        self.procs = []
        for remote, work_remote, fn in zip(self.remotes, work_remotes, env_fns):
            p = ctx.Process(target=_subproc_worker, args=(work_remote, remote, fn),
                            daemon=True)
            p.start()
            work_remote.close()
            self.procs.append(p)
        self.remotes[0].send(("spaces", None))
        self.observation_space, self.action_space = self.remotes[0].recv()

    def reset(self) -> np.ndarray:
        for r in self.remotes:
            r.send(("reset", None))
        return np.stack([r.recv() for r in self.remotes])

    def step(self, actions):
        with tracing.span("env_wait"):
            for r, act in zip(self.remotes, actions):
                r.send(("step", act))
            results = [r.recv() for r in self.remotes]
        return _stacked(results)

    def step_indices(self, indices, actions):
        """``step`` of the envs at ``indices`` alone; they step at once."""
        with tracing.span("env_wait"):
            for i, act in zip(indices, actions):
                self.remotes[i].send(("step", act))
            results = [self.remotes[i].recv() for i in indices]
        return _stacked(results)

    def render_frame(self) -> np.ndarray:
        self.remotes[0].send(("render", None))
        return self.remotes[0].recv()

    def close(self) -> None:
        for r in self.remotes:
            try:
                r.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
