"""Data parallelism over torch.distributed ranks (counterpart of
ocrl_tpu/parallel)."""

from .mesh import gather_rows, local_rows, make_group, mean_over_ranks, shard_ocr

__all__ = ["gather_rows", "local_rows", "make_group", "mean_over_ranks", "shard_ocr"]
