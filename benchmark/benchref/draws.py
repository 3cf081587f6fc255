"""The random draws of a training step, made again from the seed.

The trained model draws everything from one ``torch.Generator`` on its
device, in a fixed order per step: the Gumbel field of the soft sample, the
Gumbel field of the token ids, the initial slots' normals, then the dropout
masks in the order the decoder applies them. On a CUDA device each Gumbel
field is drawn by a kernel from a counter-based Philox4x32-10 keyed by an
int64 seed that is itself drawn from the generator; on the CPU it is
-log(E + tiny) with E exponential, drawn from the generator. ``Draws``
repeats that sequence with its own generator and computes the Philox field
itself (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC'11), so the reference sees the noise the program saw without taking
anything from it.
"""

from __future__ import annotations

import torch

TINY = torch.finfo(torch.float32).tiny
SOFT_STREAM, IDS_STREAM = 0, 0x5E3779B9
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
_LOW32 = 0xFFFFFFFF
_ROWS_A_BLOCK = 2048


def _mul_hi_lo(a: torch.Tensor, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * b for uint32 values held in int64,
    from 16-bit halves so that no partial product leaves int64."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    t0 = a0 * b0
    mid = a1 * b0 + a0 * b1 + (t0 >> 16)
    low = ((mid & 0xFFFF) << 16) | (t0 & 0xFFFF)
    high = a1 * b1 + (mid >> 16)
    return high, low


def philox_words(rows: torch.Tensor, V: int, seed: int, stream: int) -> torch.Tensor:
    """uint32 words (int64) [len(rows), V]: Philox4x32-10 keyed by (low word
    of ``seed``, high word + ``stream``), counter (column // 4, row, 0, 0),
    word i of a counter is column 4 (column // 4) + i."""
    s = int(seed) % 2 ** 64
    k0, k1 = s & _LOW32, ((s >> 32) + stream) & _LOW32
    device = rows.device
    col4 = torch.arange(V // 4, device=device, dtype=torch.int64)[None, :]
    c0 = col4.expand(len(rows), -1)
    c1 = rows.to(torch.int64)[:, None].expand(-1, V // 4)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W[0]) & _LOW32, (k1 + _W[1]) & _LOW32
        hi0, lo0 = _mul_hi_lo(c0, _M[0])
        hi1, lo1 = _mul_hi_lo(c2, _M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1).reshape(len(rows), V)


def gumbel_of_words(words: torch.Tensor) -> torch.Tensor:
    """g = -log(-log(u) + tiny), u = (2 m + 1) 2^-24 from the top 23 bits m
    of each word, in float64, returned as float32."""
    m = (words >> 9).to(torch.float64)
    u = (2.0 * m + 1.0) * 2.0 ** -24
    return (-torch.log(-torch.log(u) + TINY)).to(torch.float32)


def philox_gumbel(seed: int, stream: int, R: int, V: int, device) -> torch.Tensor:
    """The Gumbel field [R, V] that a Philox seed gives, in row blocks."""
    out = torch.empty((R, V), dtype=torch.float32, device=device)
    for r0 in range(0, R, _ROWS_A_BLOCK):
        rows = torch.arange(r0, min(R, r0 + _ROWS_A_BLOCK), device=device)
        out[r0:r0 + len(rows)] = gumbel_of_words(philox_words(rows, V, seed, stream))
    return out


class Draws:
    """One generator, seeded as the program's is, drawn in the program's
    order."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def gumbel(self, R: int, V: int, stream: int) -> torch.Tensor:
        if self.device.type == "cuda":
            seed = torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                                 device=self.device, dtype=torch.int64)
            return philox_gumbel(int(seed.item()), stream, R, V, self.device)
        return self.exponential_gumbel((R, V))

    def exponential_gumbel(self, shape) -> torch.Tensor:
        e = torch.empty(shape, dtype=torch.float32, device=self.device)
        return -torch.log(e.exponential_(generator=self.generator) + TINY)

    def randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32)

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)
