"""Data parallelism over ranks (counterpart of ocrl_tpu/parallel/mesh.py).

JAX puts one program on a mesh of devices: the parameters and the optimizer
state replicated, each batch sharded on its leading axis, the gradient
all-reduce inserted by XLA. Here each rank is a process of a
``torch.distributed`` group. ``shard_ocr`` makes every rank start from rank
0's state and gives the OCR its shard (rank, world size); from then on
each rank passes its own rows of every batch (``local_rows``), and the OCR
(models/base.py) keeps the ranks in step:

- a training step all-reduces (SUM) every gradient and every metric of the
  loss in one flat buffer and divides by the world size, before the clip,
  so the clip, the ``norm`` metric and the optimizer run on the same
  gradients on every rank and the ranks stay bitwise equal;
- every draw with a batch axis (the slot noise, MAE's masking order, the
  VAE's and IODINE's eps, the dropout masks, the Gumbel fields) is the
  rank's rows of the draw one process makes for the whole batch: the
  shard rides on the OCR's generator (``models.common.shard_draws``), so
  this holds for a caller of ``ocr.module`` that passes ``ocr.generator``
  too (the Gumbel kernels through their ``row0``);
- ``get_loss`` reports the global batch's metrics, ``rep`` the rank's rows,
  ``get_samples`` the grid of the whole batch (the ranks' arrays gathered).

Plain collectives, not ``DistributedDataParallel``: ``OCR._step`` calls
``module.loss``, which DDP's forward hooks never see, and IODINE's loss
takes an inner ``autograd.grad`` with ``create_graph``, which DDP's reducer
does not support.

Checkpoints: the parameters and the optimizer state are replicated, so
rank 0 writes the port's ``OCRLTPU1`` file (``utils.checkpoint.save``) and
every rank can load it; JAX's orbax files of sharded arrays
(ocrl_tpu/utils/sharded_checkpoint.py) have nothing to hold here.

The backend is the caller's choice, always: ``nccl`` where each rank has a
card of its own, ``gloo`` on the CPU or for several ranks on one card
(NCCL refuses two ranks on one device). ``gloo`` sums a card's tensors
through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def make_group(backend: str, rank: int, world_size: int, init_method: str):
    """Join the process group of ``world_size`` ranks as ``rank`` through
    ``init_method`` (``tcp://host:port`` or ``file://path``) and return it.
    ``backend`` is ``nccl`` or ``gloo`` (see the module docstring); nothing
    is picked for the caller. NCCL's communicator is made here, on the
    current card, so that a failed NCCL init raises at once."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device_id = None
    if backend == "nccl":
        device_id = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, device_id=device_id)
    return dist.group.WORLD


def local_rows(x, shard: tuple[int, int], batches: int = 1):
    """The rows of ``shard`` (rank r of W) in ``x``, ``batches`` batches of
    B rows one after the other: rows [r B / W, (r + 1) B / W) of each batch,
    stacked (what ``OCR.update_many`` takes for k batches). numpy arrays
    and tensors alike. Raises ValueError where W does not divide B, as
    JAX's device_put of a batch-sharded array does."""
    rank, world = shard
    rows = x.shape[0]
    if rows % batches:
        raise ValueError(f"{rows} rows are not {batches} batches")
    B = rows // batches
    if B % world:
        raise ValueError(f"a batch of {B} rows does not split over {world} ranks")
    n = B // world
    if batches == 1:
        return x[rank * n:(rank + 1) * n]
    x = x.reshape((batches, B) + tuple(x.shape[1:]))[:, rank * n:(rank + 1) * n]
    return x.reshape((batches * n,) + tuple(x.shape[2:]))


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def mean_over_ranks(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor's mean over the ranks of ``group``: one all-reduce (SUM)
    of all of them packed into one flat buffer, then a division by the
    world size. Every rank gets the same bits back."""
    if not tensors:
        return []
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return _unflat(flat, tensors)


def gather_rows(tensors, group) -> list[torch.Tensor]:
    """Each rank's tensor [n, ...] stacked in rank order, [W n, ...], on
    every rank: one all-reduce (SUM) of a zero buffer holding each rank's
    rows in its place (x + 0 is x, so nothing is rounded)."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    full = []
    for t in tensors:
        buf = torch.zeros((world * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        buf[rank * t.shape[0]:(rank + 1) * t.shape[0]] = t
        full.append(buf)
    flat = _flat(full)
    dist.all_reduce(flat, group=group)
    return _unflat(flat, full)


def _broadcast(tensors: list[torch.Tensor], group, device) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place: one broadcast
    a dtype, packed on ``device``."""
    src = dist.get_global_rank(group, 0)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in same])
        dist.broadcast(flat, src, group=group)
        for t, v in zip(same, _unflat(flat, same)):
            t.copy_(v)


def shard_ocr(ocr, group) -> None:
    """Give ``ocr`` data parallelism over ``group``: rank 0's parameters,
    buffers, optimizer state (its moments, step counts and count) and
    generator state on every rank (JAX's ``device_put(..., repl)``), then
    the shard (rank, world size) that the OCR's calls run under. Every rank
    must hold an optimizer state of the same structure (all fresh, or all
    loaded from one file)."""
    from ..models.common import shard_draws      # models/base.py imports this module
    if ocr.device.type == "cuda" and ocr.device.index is not None:
        torch.cuda.set_device(ocr.device)     # NCCL's collectives run on the current card
    tensors = list(ocr.module.state_dict().values())
    counts = [ocr._last_step]
    if ocr.optimizer is not None:
        state = ocr.optimizer.adam.state
        params = [p for g in ocr.optimizer.adam.param_groups for p in g["params"]]
        held = [p for p in params if p in state]
        sizes = torch.tensor([len(held), -len(held)], device=ocr.device)
        dist.all_reduce(sizes, op=dist.ReduceOp.MAX, group=group)
        if int(sizes[0]) != -int(sizes[1]):
            raise ValueError("the ranks' optimizer states differ in structure")
        tensors += [state[p][k] for p in held for k in sorted(state[p])
                    if isinstance(state[p][k], torch.Tensor)]
        counts.append(ocr.optimizer.count)
    count_t = torch.tensor(counts, dtype=torch.int64)
    generator = ocr.generator.get_state()
    _broadcast(tensors + [count_t, generator], group, ocr.device)
    ocr._last_step = int(count_t[0])
    if ocr.optimizer is not None:
        ocr.optimizer.count = int(count_t[1])
    ocr.generator.set_state(generator)
    ocr.shard = (dist.get_rank(group), dist.get_world_size(group))
    ocr.group = group
    shard_draws(ocr.generator, ocr.shard)
