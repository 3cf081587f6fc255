#!/usr/bin/env python3
"""Measure how fp32 rounding moves the property head's leaky-ReLU inputs
against their kinks, on one NVIDIA GPU and its host's CPU, and what the
probes check's float64 rule makes of it.

    python3 scripts/probe_kinks.py [CHECKPOINTS]        # default 7

``chip_smoke.check_property_step`` holds one property update of a fresh
head, card against CPU, on the train-ocr phase's SLATE checkpoint, which
differs from run to run (the card's training is not bitwise repeatable).
This script trains CHECKPOINTS such checkpoints with
``chip_smoke.train_ocr_phase`` and, on each, runs the check's update on the
card and on the CPU (same batch, slot noise and head). For each of the
head's three leaky-ReLU layers it prints, over all inputs, against the
float64 input computed from the CPU's encoder output (the scale of an input
is sum |w x| + |b| in float64):

- the largest error of the CPU's fp32 input and of the card's (the card's
  encoder output and its fp32 product), over its scale;
- the smallest distance of an input from its kink, over its scale, and the
  count within ``chip_smoke.KINK_TOL``.

Then the float64 rule (``chip_smoke.sure_entries``) on the CPU's step:
the entries it moves out of the fp32 rule's sure ones without the kinks'
sides and with them, the entries the kinks' sides take out; and, for each
kink in turn, the same counts as if the fp32 step had taken that kink's
other side (``chip_smoke.moved_line``'s verdict beside each). The last line
is one JSON object of all of it. It needs a card.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ocrl_tpu_torch.config import read_env_config  # noqa: E402
from ocrl_tpu_torch.data import DataLoader, H5Dataset  # noqa: E402
from ocrl_tpu_torch.data.collect import collect_dataset  # noqa: E402
from ocrl_tpu_torch.utils.checkpoint import get_ocr  # noqa: E402
from ocrl_tpu_torch.utils.property_predictor import PropertyPredictor  # noqa: E402


def layer_inputs(head, rep: torch.Tensor, dtype) -> list[torch.Tensor]:
    """The head's leaky-ReLU inputs, layer by layer, in ``dtype``."""
    x, out = rep.reshape(-1, rep.shape[-1]).to(dtype), []
    with torch.no_grad():
        for layer in head.dense[:-1]:
            pre = x @ layer.weight.to(dtype).T + layer.bias.to(dtype)
            out.append(pre)
            x = torch.nn.functional.leaky_relu(pre, cs.HEAD_LEAK)
    return out


def one_checkpoint(encoder, batch: dict, card_device: str = "cuda") -> dict:
    """The measurements of one checkpoint (see the module docstring)."""
    cfg = cs.probe_configs(encoder)["property"]
    noise = cs.slot_noise(cfg, len(batch["obss"]), 16)
    reps, heads = {}, {}
    for side, device in (("card", card_device), ("cpu", "cpu")):
        ocr, _ = get_ocr(cfg.ocr, cfg.dataset, cfg.ocr_checkpoint, seed=0, device=device)
        probe = PropertyPredictor(ocr, cfg.property_predictor, cfg.dataset, seed=0)
        init = {n: p.detach().cpu().numpy().copy() for n, p in probe.head.named_parameters()}
        heads[side] = copy.deepcopy(probe.head)
        obs, _ = probe._batch(batch)
        with torch.no_grad():
            reps[side] = ocr.rep(obs, noise={"rep": torch.from_numpy(noise).to(device)})
        matched = []
        probe.update(batch, 0, noise={"rep": torch.from_numpy(noise).to(device)},
                     matched=matched)
    adam = cs.adam_side(list(probe.head.named_parameters()), probe.optimizer)
    grads = {n: m / (1 - 0.9) for n, m in adam["mu"].items()}
    kinks = []
    grads64 = cs.property_grads64(probe, init, batch, noise, matched[0], kinks)
    ref = layer_inputs(heads["cpu"], reps["cpu"], torch.float64)
    cpu32 = layer_inputs(heads["cpu"], reps["cpu"], torch.float32)
    card32 = [t.cpu() for t in layer_inputs(heads["card"], reps["card"], torch.float32)]
    layers = []
    x = reps["cpu"].reshape(-1, reps["cpu"].shape[-1]).double()
    for i, layer in enumerate(heads["cpu"].dense[:-1]):
        w, b = layer.weight.detach().double(), layer.bias.detach().double()
        scale = x.abs() @ w.abs().T + b.abs()
        margin = ref[i].abs() / scale
        layers.append(dict(
            cpu_err=float(((cpu32[i].double() - ref[i]).abs() / scale).max()),
            card_err=float(((card32[i].double() - ref[i]).abs() / scale).max()),
            min_margin=float(margin.min()),
            within_tol=int((margin <= cs.KINK_TOL).sum())))
        x = torch.nn.functional.leaky_relu(ref[i], cs.HEAD_LEAK)
    sizes = {n: v.size for n, v in init.items()}
    fp32 = cs.sure_entries(grads)[0]
    kept, moved = cs.sure_entries(grads, grads64, kinks)
    _, moved_plain = cs.sure_entries(grads, grads64)
    flipped = []
    for variant in kinks:
        as_fp32 = {n: v.astype(np.float32) for n, v in variant.items()}
        without = cs.sure_entries(as_fp32, grads64)[1]
        with_sides = cs.sure_entries(as_fp32, grads64, kinks)[1]
        flipped.append(dict(without=sum(without.values()),
                            without_ok=cs.moved_line(without, sizes)[1],
                            with_sides=sum(with_sides.values()),
                            with_ok=cs.moved_line(with_sides, sizes)[1]))
    return dict(layers=layers, kinks=len(kinks),
                moved_without_sides=sum(moved_plain.values()), moved=sum(moved.values()),
                at_kinks=sum(int((fp32[n] & ~kept[n]).sum()) for n in grads) -
                sum(moved.values()),
                sure=sum(int(kept[n].sum()) for n in grads),
                entries=sum(sizes.values()), flipped=flipped)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    count = int(sys.argv[1]) if len(sys.argv) > 1 else 7
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        data = work / "probes.hdf5"
        collect_dataset(read_env_config(cs.PROBE_ENV), cs.PROBE_TRAIN, cs.PROBE_VAL,
                        num_proc=cs.OCR_WORKERS, with_labels=True, with_states=True, out_file=data)
        # the check's batch, as chip_smoke.probes_phase draws it
        batch = next(iter(DataLoader(H5Dataset(data, "TrainingSet"), 128, shuffle=True, seed=4)))
        batch = {k: v[:24] for k, v in batch.items()}
        results = []
        for r in range(count):
            wd = work / f"checkpoint{r}"
            wd.mkdir()
            encoder = cs.train_ocr_phase(card, wd)["encoder"]
            found = one_checkpoint(encoder, batch)
            results.append(found)
            sides = [(f["without"], f["without_ok"], f["with_sides"], f["with_ok"])
                     for f in found["flipped"]]
            print(f"checkpoint {r}: " + "; ".join(
                f"layer {i}: fp32 error CPU {d['cpu_err']:.3e}, card {d['card_err']:.3e}, nearest "
                f"kink {d['min_margin']:.3e}, {d['within_tol']} within {cs.KINK_TOL}"
                for i, d in enumerate(found["layers"])) +
                f"; moved {found['moved_without_sides']} without the kinks' sides, "
                f"{found['moved']} with them, {found['at_kinks']} out at {found['kinks']} kinks, "
                f"{found['sure']} of {found['entries']} sure; fp32 on a kink's other side, moved "
                f"without (ok), with the sides (ok): {sides}", flush=True)
    print(json.dumps({"card": card, "kink_tol": cs.KINK_TOL, "checkpoints": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
