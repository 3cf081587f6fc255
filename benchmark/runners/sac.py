"""SAC traffic: the port's SAC trained end to end on a CausalWorld task.

Set-up builds the vector env (``rl.make_vec_env``: forked workers of the
port's fake simulator) and the SAC (``train_sb3.build_algo``) of the
configuration, puts the benchmark's weights into its policy and its target,
and starts ``SAC.learn``: ``learning_starts`` env steps of uniform random
actions, then after every vector step one update of ``batch_size``. The
harness's callbacks count the first ``warmup_updates`` updates as set-up,
then time the window: each vector step (act, env step, buffer add, sample,
upload, update, metrics to the host) from one ``iteration_callback`` to
the next, until ``--seconds`` have passed; the callback then ends ``learn``.
A traced run goes on for ``trace_steps`` vector steps under the profiler.

``correct``: the reference (``benchref.sac``) takes the first three
updates from the same weights, on the batches the program sampled from its
own buffer (the reference cannot step the env), with the program's draws
made again from the seed; the rows of those batches whose actions were the
uniform random ones are checked against the benchmark's own replay of the
sampler and of those actions.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch
from benchcore import gaps
from benchcore import trace as tracing
from benchcore import weights as made
from benchcore.counts import card_rates
from benchcore.main import Outcome
from benchcore.spans import Spans


class StopLearning(Exception):
    """Raised by the harness's callback to end ``SAC.learn``."""


class Recorder:
    """The first updates' batches, their losses, the first gradients Adam
    took (from its first moments) and each leaf's change after them."""

    def __init__(self, algo, start: dict, updates: int):
        self.algo, self.start, self.updates = algo, start, updates
        self.batches: list[dict] = []
        self.losses: list[list[float]] = []
        self.grad: dict[str, float] | None = None
        self.change: dict[str, float] | None = None

    def uploaded(self, batch: dict) -> None:
        if len(self.batches) < self.updates:
            self.batches.append({k: np.array(v, copy=True) for k, v in batch.items()})

    def updated(self, metrics: dict) -> None:
        n = len(self.losses)
        if n >= self.updates:
            return
        self.losses.append([metrics["critic_loss"], metrics["actor_loss"]])
        algo = self.algo
        if n == 0:
            grads = {}
            for group, opt in algo.optimizers.items():
                for name, mu in zip(algo.param_names[group], opt.mu):
                    grads[name] = mu / (1.0 - opt.b1)
            self.grad = gaps.norms(grads)
        if n + 1 == self.updates:
            self.change = gaps.norms({k: p.detach() - self.start[k]
                                      for k, p in algo.policy.named_parameters()})


def wrap(obj, name: str, spans: Spans, span: str, after=None):
    """Open ``span`` around every call of ``obj.name``; ``after`` sees the
    call's first argument."""
    inner = getattr(obj, name)

    def call(*args, **kwargs):
        with spans.span(span):
            out = inner(*args, **kwargs)
        if after is not None:
            after(args[0])
        return out
    setattr(obj, name, call)


def sampled_rows(seed: int, envs: int, action_dim: int, starts: int, batch: int,
                 updates: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """The sampler replayed: (the uniform actions of the random vector
    steps, rows in buffer order; each update's sampled rows), from
    ``default_rng(seed)`` as SAC draws them."""
    rng = np.random.default_rng(seed)
    steps = -(-starts // envs)
    actions = np.concatenate([rng.uniform(-1, 1, size=(envs, action_dim)).astype(np.float32)
                              for _ in range(steps)])
    rows = [rng.integers(0, steps * envs + u * envs, size=batch) for u in range(updates)]
    return actions, rows


def check(ctx, start: dict, rec: Recorder, errors: list, *, tf32: bool = False,
          rows: int | None = None) -> dict[str, float] | None:
    """The reference's first updates against the program's numbers."""
    t, m = ctx.traffic, ctx.m
    if len(rec.batches) < t["check_updates"] or rec.change is None:
        errors.append("fewer updates than the check needs were recorded in set-up")
        return None
    random_actions, picked = sampled_rows(ctx.seed, t["num_envs"], m["action_dim"],
                                          t["learning_starts"], t["batch_size"],
                                          t["check_updates"])
    for batch, idx in zip(rec.batches, picked):
        early = idx < len(random_actions)
        if not np.array_equal(batch["actions"][early], random_actions[idx[early]]):
            errors.append("a sampled batch's random actions are not the sampler's rows")
            return None
    reference = reference_updates(ctx, start, rec.batches)
    program = (reference_updates(ctx, start, rec.batches, tf32=tf32, rows=rows)
               if tf32 or rows else (sum(rec.losses, []), rec.grad, rec.change))
    ref_losses, ref_grad, ref_change = reference
    losses, grad, change = program
    leaves = gaps.counted(ref_grad)
    unmoved = [k for k in ref_change if k not in ref_grad]
    return {"loss_gap": gaps.loss_gap(losses, ref_losses),
            "grad_gap": gaps.leaf_gap(grad, ref_grad, leaves),
            "change_gap": gaps.change_gap(change, ref_change, leaves, unmoved)}


def reference_updates(ctx, start: dict, batches: list[dict], *, tf32: bool = False,
                      rows: int | None = None):
    """(losses, first gradient norms, change norms) of the reference's
    updates on ``batches``, its draws interleaved with the policy calls'."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        trainer = ctx.cfgmod.SacTrainer(ctx.m, start, ctx.seed, ctx.device)
        losses, grad = [], None
        for i, batch in enumerate(batches):
            if i:
                trainer.skip_act(ctx.traffic["num_envs"])
            values, grads = trainer.step(batch, rows)
            losses += values
            if i == 0:
                grad = gaps.norms(grads)
        change = gaps.norms({k: trainer.p[k].detach() - start[k] for k in start})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return losses, grad, change


class Window:
    """The callbacks: set-up until ``warmup_updates``, then the timed
    window, then (traced) the traced steps; then ``learn`` is ended."""

    def __init__(self, ctx, algo, rec: Recorder, spans: Spans):
        self.ctx, self.algo, self.rec, self.spans = ctx, algo, rec, spans
        self.updates, self.stage = 0, "setup"
        self.durations: list[float] = []
        self.setup_s = self.wall = 0.0
        self.trace = None
        self.traced_steps = 0
        self.nonfinite = 0
        self.phases: dict = {}
        self.clock = time.perf_counter()

    def phase(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name], self.clock = now - self.clock, now

    def iteration(self, algo, metrics: dict, ep_infos) -> None:
        now = time.perf_counter()
        self.rec.updated(metrics)
        self.updates += 1
        if self.stage == "setup":
            if self.updates == 1:
                self.phase("random_steps_and_first_update")
            if self.updates >= self.ctx.traffic["warmup_updates"]:
                self.phase("warmup_updates")
                self.setup_s = time.time() - self.ctx.t_start
                self.spans.reset()
                self.totals0 = dict(algo.totals)
                self.t0 = self.last = now
                self.stage = "window"
            return
        if self.stage == "window":
            self.nonfinite += int(not all(np.isfinite(v) for v in metrics.values()))
            self.durations.append(now - self.last)
            self.last = now
            if now - self.t0 < self.ctx.seconds or len(self.durations) < 2:
                return          # a tail wants two steps at the least
            self.wall = now - self.t0
            self.totals1 = dict(algo.totals)
            if not self.ctx.trace:
                raise StopLearning
            self.stage = "trace"
            self._start_trace()
            return
        self.traced_steps += 1
        if self.traced_steps >= self.ctx.traffic["trace_steps"]:
            self._stop_trace()
            raise StopLearning

    def _start_trace(self) -> None:
        self.profiler = tracing.start(self.ctx.device)
        self.span = torch.profiler.record_function("bench.window")
        self.span.__enter__()

    def _stop_trace(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        self.span.__exit__(None, None, None)
        self.profiler.stop()
        self.trace = tracing.from_profiler(self.profiler, self.ctx.workdir)


def learn(ctx):
    """Set-up, the window and (traced) the traced steps: (the Window, the
    Recorder, the benchmark's weights)."""
    from ocrl_tpu_torch.config import TrainSB3Config, compose
    from ocrl_tpu_torch.envs import make_env
    from ocrl_tpu_torch.rl import make_vec_env
    from ocrl_tpu_torch.train_sb3 import build_algo

    t, m, device = ctx.traffic, ctx.m, ctx.device
    ctx.workdir.mkdir(parents=True, exist_ok=True)
    cfg = compose(TrainSB3Config(), ctx.cfgmod.sac_overrides(m) + [
        f"env={t['env']}", f"env.use_fake_sim={str(t['use_fake_sim']).lower()}",
        f"num_envs={t['num_envs']}", f"vec_env={t['vec_env']}", f"seed={ctx.seed}",
        f"sb3.algo_kwargs.batch_size={t['batch_size']}",
        f"sb3.algo_kwargs.train_freq={t['train_freq']}",
        f"sb3.algo_kwargs.gradient_steps={t['gradient_steps']}",
        f"sb3.algo_kwargs.buffer_size={t['buffer_size']}",
        f"sb3.algo_kwargs.learning_starts={t['learning_starts']}"])
    phases, clock = {"imports": time.time() - ctx.t_start}, time.perf_counter()
    vec_env = make_vec_env(make_env, cfg.env, cfg.num_envs, seed=cfg.seed, mode=cfg.vec_env)
    phases["envs"] = time.perf_counter() - clock
    spans = Spans()
    try:
        clock = time.perf_counter()
        algo = build_algo(cfg, vec_env.observation_space.shape, device, None,
                          vec_env.action_space)
        phases["build_algo"] = time.perf_counter() - clock
        clock = time.perf_counter()
        start = made.make(ctx.cfgmod.sac_param_spec(m), ctx.seed, device)
        algo.policy.load_state_dict(start, strict=True)
        algo.target.load_state_dict(start, strict=True)
        phases["weights"] = time.perf_counter() - clock
        rec = Recorder(algo, start, t["check_updates"])
        window = Window(ctx, algo, rec, spans)
        window.phases = phases
        wrap(algo, "act", spans, "act")
        wrap(algo, "upload", spans, "upload", rec.uploaded)
        wrap(algo, "update", spans, "update")
        wrap(vec_env, "step", spans, "env_step")
        try:
            algo.learn(vec_env, 10 ** 12, iteration_callback=window.iteration)
        except StopLearning:
            pass
    finally:
        vec_env.close()
    window.peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec.algo = window.algo = None
    del algo
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return window, rec, start


def run(ctx) -> Outcome:
    t, m, device = ctx.traffic, ctx.m, ctx.device
    window, rec, start = learn(ctx)
    steps = len(window.durations)
    d_totals = {k: window.totals1[k] - window.totals0[k] for k in window.totals0}
    record = {"m": m, "traffic": t, "window_s": window.wall, "vector_steps": steps,
              "env_step_ms": 1e3 * d_totals["policy_s"] / max(d_totals["policy_steps"], 1),
              "update_ms": 1e3 * d_totals["update_s"] / max(d_totals["updates"], 1),
              "update_flops": ctx.cfgmod.update_flops(m, t["batch_size"]),
              "trace": window.trace, "trace_steps": window.traced_steps}
    if device.type == "cuda":
        record["card"], record["bw"], record["peak_flops"] = card_rates(
            torch.cuda.get_device_name(device))
    p95 = statistics.quantiles([1e3 * d for d in window.durations], n=100,
                               method="inclusive")[94] if steps >= 2 else float("nan")
    errors: list = []
    got = check(ctx, start, rec, errors)
    checks = [] if got is None else [(k, v, ctx.limits[k]) for k, v in got.items()]
    return Outcome(end_to_end={"rl_env_steps_per_s": steps * t["num_envs"] / window.wall,
                               "rl_step_ms_p95": p95, "setup_s": window.setup_s},
                   record=record, checks=checks, attempted=steps, failed=window.nonfinite,
                   memory_peak_bytes=window.peak, trace=window.trace, errors=errors,
                   setup_phases=window.phases)


def readings(ctx, faults: bool) -> dict[str, dict[str, float]]:
    """The numbers of one seed, for setting the limits (as the pretraining
    runner's): the program, and with ``faults`` the control (the reference
    in TF32) and half of each batch left out, in the program's place."""
    ctx.seconds, ctx.trace = 0.0, False
    _, rec, start = learn(ctx)
    errors: list = []
    out = {"program": check(ctx, start, rec, errors)}
    if faults:
        out["control"] = check(ctx, start, rec, errors, tf32=True)
        out["half_batch"] = check(ctx, start, rec, errors,
                                  rows=ctx.traffic["batch_size"] // 2)
    if errors:
        raise RuntimeError("; ".join(errors))
    return out
