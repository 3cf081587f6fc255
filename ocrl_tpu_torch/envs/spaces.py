"""The two action / observation spaces the envs declare, with the
attributes the envs, the vec envs and the algorithms read (stand-ins for
gymnasium's ``spaces.Discrete`` and ``spaces.Box``); a dict of spaces
stands in for ``spaces.Dict``."""

from __future__ import annotations

import numpy as np


class Discrete:
    """Actions 0 .. n-1."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def sample(self, rng: np.random.Generator) -> int:
        """A uniform action drawn from ``rng`` (gymnasium's space draws from
        its own unseeded generator)."""
        return int(rng.integers(self.n))

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class Box:
    """Arrays of ``shape`` and ``dtype`` with entries in [low, high]."""

    def __init__(self, low, high, shape: tuple[int, ...], dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        """A uniform draw in [low, high] from ``rng``, in ``dtype`` (gymnasium's
        bounded ``Box.sample``, which draws from the space's own unseeded
        generator)."""
        return rng.uniform(self.low, self.high, self.shape).astype(self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"
