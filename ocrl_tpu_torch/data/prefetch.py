"""Host-to-card prefetch (counterpart of ocrl_tpu/data/prefetch.py): a
producer thread stages the next batches on the device while the current
step runs.

On CUDA a batch is gathered into pinned host memory and copied with
``non_blocking=True`` on a copy stream of its own; the consumer's stream
waits for that copy
before it gets the batch, and the tensors are recorded on it for the
caching allocator. On the CPU the batches are torch tensors sharing the
numpy arrays' memory. The ``sharding`` argument of the JAX function (data
parallelism) comes with the DDP slice.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_POLL_S = 0.1


def _stack(group: list[dict]) -> dict[str, np.ndarray]:
    if len(group) == 1:
        return group[0]
    return {k: np.concatenate([g[k] for g in group]) for k in group[0]}


def prefetch_to_device(iterable: Iterable, device: str | torch.device, size: int = 2,
                       superbatch: int = 1, yield_whole: bool = False) -> Iterator:
    """Yield the dicts of numpy arrays of ``iterable`` as dicts of tensors on
    ``device``, ``size`` items ahead.

    ``superbatch > 1`` stacks that many consecutive batches on the host and
    copies them in one transfer; a change of keys or shapes closes a group
    and a trailing partial group goes as it is. Each group is yielded back as
    its batches (slices of the copy) or, with ``yield_whole``, as one dict
    of k x B rows (what ``OCR.update_many`` takes). An exception in the
    producer is raised in the consumer. Closing the generator early (a
    ``break``) stops the producer.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    sentinel = object()
    err: list[BaseException] = []

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def to_device(batch: dict[str, np.ndarray]):
        if not cuda:       # memmap views are read-only: those are copied
            return {k: torch.from_numpy(v if v.flags.writeable else v.copy())
                    for k, v in batch.items()}, None
        with torch.cuda.stream(copy_stream):
            out = {}
            for k, v in batch.items():
                host = torch.empty(v.shape, pin_memory=True,
                                   dtype=torch.from_numpy(np.empty(0, v.dtype)).dtype)
                host.numpy()[...] = v
                out[k] = host.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        return out, event

    def put_group(group: list) -> None:
        staged, event = to_device(_stack(group))
        if yield_whole or len(group) == 1:
            put((staged, event))
            return
        n = len(group)
        for i in range(n):
            put(({k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                  for k, v in staged.items()}, event))

    def producer() -> None:
        try:
            if cuda and device.index is not None:
                torch.cuda.set_device(device)
            group: list = []
            for item in iterable:
                if stop.is_set():
                    return
                if superbatch <= 1:
                    put_group([item])
                    continue
                if group and (item.keys() != group[0].keys()
                              or any(item[k].shape != group[0][k].shape for k in group[0])):
                    put_group(group)
                    group = []
                group.append(item)
                if len(group) == superbatch:
                    put_group(group)
                    group = []
            if group:
                put_group(group)
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for v in batch.values():
                    v.record_stream(stream)
            yield batch
    finally:
        stop.set()
        thread.join()
