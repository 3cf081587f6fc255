"""Card-only tests of the port's kernels: each kernel against its plain
version on the GPU. They import no JAX, so they also run on a machine with
the card and without JAX:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a GPU they skip. Sums are reordered between kernel and plain
version, so each sweep output is held to 1e-5 of its largest entry; the
soft Gumbel sample (values in [0, 1]) to 1e-5 absolute; token ids exactly,
since both sides add the same fp32 logits and field."""

import math

import numpy as np
import pytest
import torch

from ocrl_tpu_torch.ops import LAUNCHES, gumbel, reset_launches
from ocrl_tpu_torch.ops import slot_routing as tsr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 4096, 5, 192), (2, 4096, 6, 192),
                                   (3, 333, 5, 192), (2, 100, 16, 64)])
def test_sweep_kernel_matches_plain_on_the_card(cuda, shape):
    B, N, S, D = shape
    rng = np.random.default_rng(1)
    k = torch.from_numpy((rng.standard_normal((B, N, D)) * D ** -0.5)
                         .astype(np.float32)).cuda()
    v = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32)).cuda()
    reset_launches()
    got = tsr.route_sweep(k, v, q)
    want = tsr.route_sweep_reference(k, v, q)
    torch.cuda.synchronize()
    assert LAUNCHES == {tsr.KERNEL: 1}
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 4096, 5, 192), (3, 333, 5, 192),
                                   (2, 100, 16, 64)])
def test_sweep_gradient_goes_through_the_backward_kernel(cuda, shape):
    """Autograd through route_sweep on the card launches B4 once and gives
    the gradients of the plain sweep for the same cotangents."""
    B, N, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(2)
    k, v, q = (torch.randn(s, device="cuda", generator=gen)
               for s in ((B, N, D), (B, N, D), (B, S, D)))
    k = k * D ** -0.5
    cot = [torch.randn(s, device="cuda", generator=gen)
           for s in ((B, S), (B, S, D), (B, N, S))]
    leaves = [x.clone().requires_grad_() for x in (k, v, q)]
    reset_launches()
    got = torch.autograd.grad(tsr.route_sweep(*leaves), leaves, cot)
    assert LAUNCHES == {tsr.KERNEL: 1, tsr.BWD_KERNEL: 1}
    plain = [x.clone().requires_grad_() for x in (k, v, q)]
    want = torch.autograd.grad(tsr.route_sweep_reference(*plain), plain, cot)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6144, 4096), (1000, 512), (7, 32)])
def test_gumbel_kernels_match_plain_on_the_card(cuda, shape):
    """B1 and B2 against their plain versions fed the field each kernel
    drew (g_out); the noise entry reproduces the sample from that field."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn(shape, device="cuda", generator=gen) * 3
    g, g2 = torch.empty_like(logits), torch.empty_like(logits)
    reset_launches()
    y = gumbel.gumbel_softmax_sample(logits, 0.7, generator=gen, g_out=g)
    ids = gumbel.gumbel_argmax_ids(logits, generator=gen, g_out=g2)
    assert LAUNCHES == {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1}
    want = gumbel.gumbel_softmax_sample_reference(logits, g, 0.7)
    assert (y - want).abs().max() <= 1e-5
    assert torch.equal(ids, gumbel.gumbel_argmax_ids_reference(logits, g2))
    assert torch.equal(y, gumbel.gumbel_softmax_sample(logits, 0.7, noise=g))
    assert not torch.equal(g, g2)            # two streams


@pytest.mark.cuda
def test_gumbel_field_distribution_on_the_card(cuda):
    """The in-kernel Philox field over 6144 x 4096 draws: mean Euler's
    gamma and variance pi^2 / 6 within 8 standard errors; the ids'
    frequencies on a repeated row follow the softmax."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    logits = torch.zeros(6144, 4096, device="cuda")
    g = torch.empty_like(logits)
    gumbel.gumbel_softmax_sample(logits, 1.0, generator=gen, g_out=g)
    n = g.numel()
    g = g.double()
    assert abs(g.mean().item() - 0.5772156649015329) <= 8 * 1.2825 / math.sqrt(n)
    assert abs(g.var().item() - math.pi ** 2 / 6) <= 8 * 3.45 / math.sqrt(n)
    row = torch.full((1, 128), -1e9, device="cuda")
    row[0, :4] = torch.tensor([2.0, 1.0, 0.0, -1.0], device="cuda")
    ids = gumbel.gumbel_argmax_ids(row.repeat(65536, 1), generator=gen)
    freq = torch.bincount(ids, minlength=4)[:4].double().cpu() / 65536
    want = torch.softmax(torch.tensor([2.0, 1.0, 0.0, -1.0], dtype=torch.float64), 0)
    assert (freq - want).abs().max() <= 0.01
