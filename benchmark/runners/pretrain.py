"""Pretraining traffic: an OCR trained on scenes by the port's entry point,
``train_ocr.train``.

Set-up paints the traffic's scenes from the seed and writes them as an OCRL
HDF5 file (the frozen writer) into the run's work directory; then
``train_ocr.train`` runs as its config says: the loader
(``data.get_dataloaders``), ``create_ocr``, superbatches of ``superbatch``
batches staged by ``data.prefetch_to_device`` and taken by
``OCR.update_many``, the metrics kept on the card until a ``log_interval``
crossing (or a step below 3, or an epoch's end) brings them over in one copy
(``_to_host``) to the run's log; ``eval_interval`` lies past any window.

The harness hooks into ``train`` at three names of its module and changes
none of its loop: ``create_ocr`` (the benchmark's weights go into the model,
and the model's ``update`` / ``update_many`` and optimizer step are
recorded), ``prefetch_to_device`` (each request for the next superbatch is
a step boundary, timed as the loader's wait) and ``_to_host`` (timed).
At the boundaries set-up ends after ``warmup_superbatches``, the first of
which records the checked steps, the window after ``--seconds``, and, traced,
the traced window after ``trace_superbatches``, each in a synchronise; then
``WindowClosed`` ends ``train``.

``correct``: the reference (the configuration's module) takes the same
first three steps from the same weights, on the benchmark's own copies of
the scenes the loader served (each row found among the painted scenes) and
with the program's draws made again from the seed; ``gaps`` compares.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import shutil
import sys
import time

import numpy as np
import torch
from benchcore import gaps, h5writer, painter
from benchcore import trace as tracing
from benchcore import weights as made
from benchcore.counts import card_rates
from benchcore.main import Outcome
from benchcore.spans import Spans

# the hooked names of ocrl_tpu_torch.train_ocr
HOOKED = ("create_ocr", "prefetch_to_device", "_to_host")


class FirstSteps:
    """Records, inside the window's own call, the first gradient each leaf
    gave Adam (from its first moment after one update) and each leaf's
    change after ``steps`` updates, as norms; then steps aside."""

    def __init__(self, ocr, start: dict[str, torch.Tensor], steps: int):
        self.opt, self.steps, self.start = ocr.optimizer, steps, start
        self.named = dict(ocr.module.named_parameters())
        self.b1 = self.opt.adam.defaults["betas"][0]
        self.grad: dict[str, float] | None = None
        self.change: dict[str, float] | None = None
        self._step = self.opt.step
        self.opt.step = self.step

    def step(self) -> None:
        self._step()
        count = self.opt.count
        if count == 1:
            state = self.opt.adam.state
            self.grad = gaps.norms({k: state[p]["exp_avg"] / (1.0 - self.b1)
                                    for k, p in self.named.items() if p in state})
        if count == self.steps:
            self.change = gaps.norms({k: p.detach() - self.start[k]
                                      for k, p in self.named.items()})
            del self.opt.step


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scene_index(scenes: np.ndarray) -> dict[bytes, int]:
    return {hashlib.blake2b(s.tobytes(), digest_size=16).digest(): i
            for i, s in enumerate(scenes)}


def find_rows(rows: np.ndarray, scenes: np.ndarray, index: dict) -> list[int] | None:
    """Each row's index among the scenes, or None where one is not there."""
    out = []
    for row in rows:
        i = index.get(hashlib.blake2b(row.tobytes(), digest_size=16).digest())
        if i is None or not np.array_equal(scenes[i], row):
            return None
        out.append(i)
    return out


def reference_steps(ctx, start: dict, batches: list[np.ndarray], *, tf32: bool = False,
                    rows: int | None = None) -> tuple[list[float], dict, dict]:
    """The reference's first steps from ``start`` on ``batches``: (losses,
    first gradient norms, change norms). ``tf32`` computes it in TF32 (the
    control); ``rows`` keeps only a batch's first rows in its means (a
    planted fault)."""
    device = ctx.device
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        trainer = ctx.cfgmod.Trainer(ctx.m, start, ctx.seed, device)
        losses, grad = [], None
        for i, batch in enumerate(batches):
            value, grads = trainer.step(torch.from_numpy(batch).to(device), i, rows)
            losses.append(value)
            if i == 0:
                grad = gaps.norms(grads)
        change = gaps.norms({k: trainer.p[k].detach() - start[k] for k in start})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return losses, grad, change


def compare(program: tuple, reference: tuple) -> dict[str, float]:
    """The numbers of (losses, first gradient norms, change norms) of a side
    against the reference's: the worst leaf's and the median leaf's."""
    losses, grad, change = program
    ref_losses, ref_grad, ref_change = reference
    leaves = gaps.counted(ref_grad)
    unmoved = [k for k in ref_change if k not in ref_grad]
    return {"loss_gap": gaps.loss_gap(losses, ref_losses),
            "grad_gap": gaps.leaf_gap(grad, ref_grad, leaves),
            "change_gap": gaps.change_gap(change, ref_change, leaves, unmoved),
            "grad_gap_median": gaps.leaf_gap(grad, ref_grad, leaves, gaps.median),
            "change_gap_median": gaps.change_gap(change, ref_change, leaves, unmoved,
                                                 gaps.median)}


def checked_batches(ctx, state, errors: list) -> list[np.ndarray] | None:
    """The benchmark's own copies of the scenes of the first steps' batches."""
    B = ctx.traffic["batch_size"]
    found = find_rows(state.rows, state.scenes, scene_index(state.scenes))
    if found is None:
        errors.append("a row the first steps trained on is not one of the benchmark's scenes")
        return None
    if state.first.grad is None or state.first.change is None:
        errors.append("the optimizer took fewer than the checked steps in set-up")
        return None
    return [state.scenes[found[i * B:(i + 1) * B]] for i in range(len(found) // B)]


def check(ctx, state, errors: list) -> list:
    """The reference's first steps against the program's: (name, value,
    limit) of each number."""
    batches = checked_batches(ctx, state, errors)
    if batches is None:
        return []
    got = compare((state.losses, state.first.grad, state.first.change),
                  reference_steps(ctx, state.start, batches))
    return [(name, value, ctx.limits[name]) for name, value in got.items()
            if name in ctx.limits]


class WindowClosed(Exception):
    """Ends ``train_ocr.train`` once the window (and the traced window) has
    closed."""


class Window:
    """The hooks into ``train_ocr.train`` and what they record: the phases
    of set-up, the checked steps, the window's steps, wall time and losses,
    and the traced window's steps and trace."""

    def __init__(self, ctx, scenes: np.ndarray, phases: dict, clock: float,
                 first_only: bool):
        self.ctx, self.scenes, self.phases, self.clock = ctx, scenes, phases, clock
        self.first_only = first_only
        self.B, self.steps = ctx.traffic["batch_size"], ctx.traffic["check_steps"]
        self.spans = Spans()
        self.stage, self.handed = "setup", 0
        self.ocr = self.first = self.start = self.rows = self.trace = None
        self.losses: list = []
        self.window_losses: list = []
        self.window_steps = self.trace_steps = 0
        self.setup_s = self.wall = 0.0
        self.loader_wait_ms = None

    def phase(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name], self.clock = now - self.clock, now

    def create_ocr(self, real):
        def hooked(*args, **kwargs):
            ocr = real(*args, **kwargs)
            self.phase("loader_and_create_ocr")
            ctx = self.ctx
            self.start = made.make(ctx.cfgmod.param_spec(ctx.m), ctx.seed, ctx.device)
            ocr.module.load_state_dict(self.start, strict=True)
            self.phase("weights")
            self.first = FirstSteps(ocr, self.start, self.steps)
            for name in ("update", "update_many"):
                setattr(ocr, name, self.stepped(getattr(ocr, name)))
            self.ocr = ocr
            return ocr
        return hooked

    def stepped(self, real):
        def call(obs, *args, **kwargs):
            with self.spans.span("update_many"):
                metrics = real(obs, *args, **kwargs)
            k = obs.shape[0] // self.B
            if self.rows is None:
                self.rows = obs[:self.steps * self.B].cpu().numpy()
                self.losses = [float(v) for v in metrics["loss"].reshape(-1)[:self.steps]]
            elif self.stage == "window":
                self.window_steps += k
                self.window_losses.append(metrics["loss"])
            elif self.stage == "trace":
                self.trace_steps += k
            return metrics
        return call

    def prefetch_to_device(self, real):
        def hooked(*args, **kwargs):
            inner = real(*args, **kwargs)
            try:
                while True:
                    self.boundary()
                    with self.spans.span("loader_wait"):
                        try:
                            batch = next(inner)
                        except StopIteration:
                            return
                    self.handed += 1
                    yield batch
            finally:
                inner.close()
        return hooked

    def to_host(self, real):
        def hooked(values):
            with self.spans.span("to_host"):
                return real(values)
        return hooked

    def boundary(self) -> None:
        """A request for the next superbatch: the step boundary at which
        set-up, the window and the traced window end."""
        ctx, n = self.ctx, self.handed
        if self.stage == "setup":
            if n == 1:
                self.phase("first_superbatch")
                if self.first_only:
                    self.close()
            if n == ctx.traffic["warmup_superbatches"]:
                synchronize(ctx.device)
                self.phase("warmup")
                self.setup_s = time.time() - ctx.t_start
                self.spans.reset()
                self.stage, self.t0 = "window", time.perf_counter()
        elif self.stage == "window":
            if time.perf_counter() - self.t0 < ctx.seconds:
                return
            synchronize(ctx.device)
            self.wall = time.perf_counter() - self.t0
            self.loader_wait_ms = self.spans.mean_ms("loader_wait")
            if not ctx.trace:
                self.close()
            self.stage, self.traced_from = "trace", n
            self.profiler = tracing.start(ctx.device)
            self.span = torch.profiler.record_function(tracing.SPAN_PREFIX + tracing.WINDOW_SPAN)
            self.span.__enter__()
        elif n - self.traced_from >= ctx.traffic["trace_superbatches"]:
            synchronize(ctx.device)
            self.span.__exit__(None, None, None)
            self.profiler.stop()
            self.trace = tracing.from_profiler(self.profiler, ctx.workdir)
            self.close()

    def close(self):
        self.stage = "closed"
        raise WindowClosed

    def release(self) -> None:
        """Drop every reference to the program's model and optimizer."""
        self.ocr = None
        self.first.opt = self.first.named = self.first._step = None


def drive(ctx, first_only: bool = False) -> Window:
    """Set-up and the window (traced: and the traced window), or with
    ``first_only`` set-up to its first superbatch: ``train_ocr.train`` on
    the traffic's scenes, ended by WindowClosed."""
    import ocrl_tpu_torch.train_ocr as entry
    from ocrl_tpu_torch.config import TrainOCRConfig, compose

    t, m = ctx.traffic, ctx.m
    phases, clock = {"imports": time.time() - ctx.t_start}, time.perf_counter()
    work = ctx.workdir
    work.mkdir(parents=True, exist_ok=True)
    n = t["train_scenes"]
    scenes = painter.painted(n + t["val_scenes"], m["obs_size"], t["objects"], ctx.seed)
    path = work / "scenes.hdf5"
    counts = np.full(len(scenes), t["objects"], np.int64)
    h5writer.write(path, {"TrainingSet": {"obss": scenes[:n], "num_objs": counts[:n]},
                          "ValidationSet": {"obss": scenes[n:], "num_objs": counts[n:]}})
    run_dir = work / "run"
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = compose(TrainOCRConfig(), ctx.cfgmod.overrides(m) + [
        f"{key}={t[key]}" for key in ("batch_size", "superbatch", "log_interval",
                                      "num_workers", "eval_interval")])
    cfg = dataclasses.replace(cfg, seed=ctx.seed, run_dir=str(run_dir),
                              dataset=dataclasses.replace(
                                  cfg.dataset, datadir=str(path), obs_size=m["obs_size"],
                                  obs_channels=m["obs_channels"]))
    window = Window(ctx, scenes[:n], phases, clock, first_only)
    window.phase("scenes")
    saved = {name: getattr(entry, name) for name in HOOKED}
    try:
        for name in HOOKED:
            setattr(entry, name, getattr(window, name.strip("_"))(saved[name]))
        with contextlib.redirect_stdout(sys.stderr):
            entry.train(cfg, ctx.device)
    except WindowClosed:
        pass
    finally:
        for name, value in saved.items():
            setattr(entry, name, value)
    if window.stage != "closed":
        raise RuntimeError("train_ocr.train ended before the window closed")
    return window


def run(ctx) -> Outcome:
    t, m, device = ctx.traffic, ctx.m, ctx.device
    w = drive(ctx)
    record = {"m": m, "traffic": t, "window_s": w.wall, "window_steps": w.window_steps,
              "loader_wait_ms": w.loader_wait_ms,
              "step_flops": ctx.cfgmod.train_flops(m, t["batch_size"]),
              "trace": w.trace, "trace_steps": w.trace_steps}
    if device.type == "cuda":
        record["card"], record["bw"], record["peak_flops"] = card_rates(
            torch.cuda.get_device_name(device))
    losses = torch.cat([v.reshape(-1).float() for v in w.window_losses])
    failed = int((~torch.isfinite(losses)).sum())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    w.window_losses.clear()
    w.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    errors: list = []
    checks = check(ctx, w, errors)
    return Outcome(end_to_end={"pretrain_images_per_s": w.window_steps * t["batch_size"] / w.wall,
                               "setup_s": w.setup_s},
                   record=record, checks=checks, attempted=w.window_steps, failed=failed,
                   memory_peak_bytes=peak, trace=w.trace, errors=errors,
                   setup_phases=w.phases)


def readings(ctx, faults: bool) -> dict[str, dict[str, float]]:
    """The numbers of one seed, for setting the limits: the program's set-up
    against the reference (``program``); with ``faults``, the control (the
    reference in TF32) and the reference with half of each batch left out
    (``half_batch``), each put in the program's place. The state left
    unchanged reads 1 on ``change_gap`` by its definition and is not run."""
    w = drive(ctx, first_only=True)
    w.release()
    gc.collect()
    errors: list = []
    batches = checked_batches(ctx, w, errors)
    if batches is None:
        raise RuntimeError("; ".join(errors))
    reference = reference_steps(ctx, w.start, batches)
    out = {"program": compare((w.losses, w.first.grad, w.first.change), reference)}
    if faults:
        out["control"] = compare(reference_steps(ctx, w.start, batches, tf32=True), reference)
        half = ctx.traffic["batch_size"] // 2
        out["half_batch"] = compare(reference_steps(ctx, w.start, batches, rows=half),
                                    reference)
    return out


