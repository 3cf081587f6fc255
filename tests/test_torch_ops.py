"""The port's routing sweep against the JAX sweep (interpret mode) and its
plain version. Tolerance 1e-5: both sides are fp32 and differ only in the
order of the sums over D and over the tokens."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.ops import slot_routing as jsr
from ocrl_tpu_torch.ops import LAUNCHES, reset_launches
from ocrl_tpu_torch.ops import slot_routing as tsr

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, N, S, D, seed):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B, N, D)) * D ** -0.5).astype(np.float32)
    v = rng.standard_normal((B, N, D)).astype(np.float32)
    q = rng.standard_normal((B, S, D)).astype(np.float32)
    return k, v, q


@pytest.mark.parametrize("S", [3, 5, 6])
def test_sweep_matches_jax(S):
    B, N, D = 2, 64, 32
    k, v, q = _inputs(B, N, S, D, seed=S)
    reset_launches()
    got = tsr.route_sweep(*map(torch.from_numpy, (k, v, q)))
    assert LAUNCHES == {}          # a CPU tensor never launches the kernel
    chunk = jsr.pick_chunk(N, target=16)    # 4 chunks in the JAX kernel
    with jax.default_matmul_precision("highest"):
        kernel = jsr.route_sweep(chunk, *map(jnp.asarray, (k, v, q)))
        plain = jsr.route_sweep_reference(*map(jnp.asarray, (k, v, q)))
    for name, g, kj, pj in zip(("S_a", "A_v", "a"), got, kernel, plain):
        assert tuple(g.shape) == kj.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(kj), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(pj), err_msg=name, **TOL)


def test_sweep_ragged_n_matches_jax_reference():
    # JAX's kernel needs a chunk dividing N; 50 tokens leave a ragged chunk
    k, v, q = _inputs(2, 50, 5, 64, seed=7)
    got = tsr.route_sweep(*map(torch.from_numpy, (k, v, q)))
    with jax.default_matmul_precision("highest"):
        want = jsr.route_sweep_reference(*map(jnp.asarray, (k, v, q)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("bad", ["dtype", "rank", "v_shape", "q_width",
                                 "slots", "width", "layout"])
def test_sweep_rejects_what_the_kernel_does_not_take(bad):
    k, v, q = (torch.from_numpy(x) for x in _inputs(2, 40, 5, 32, seed=0))
    if bad == "dtype":
        k, exc = k.double(), TypeError
    elif bad == "rank":
        k, exc = k[0], ValueError
    elif bad == "v_shape":
        v, exc = v[:, :30].contiguous(), ValueError
    elif bad == "q_width":
        q, exc = torch.zeros(2, 5, 64), ValueError
    elif bad == "slots":
        q, exc = torch.zeros(2, 17, 32), ValueError
    elif bad == "width":
        k, v, q, exc = k[..., :24].contiguous(), v[..., :24].contiguous(), \
            q[..., :24].contiguous(), ValueError
    else:
        k, exc = k.transpose(0, 1).contiguous().transpose(0, 1), ValueError
    with pytest.raises(exc):
        tsr.route_sweep(k, v, q)


def test_pick_chunk_covers_any_n():
    assert tsr.pick_chunk(4096) == tsr.CHUNK
    assert tsr.pick_chunk(50) == 50
    assert tsr.pick_chunk(4099) == tsr.CHUNK   # ragged last chunk is masked
    assert tsr.sweep_supports(5, 192) and tsr.sweep_supports(16, 32)
    assert not tsr.sweep_supports(17, 192) and not tsr.sweep_supports(5, 48)


@pytest.mark.parametrize("S", [3, 5])
def test_sweep_gradient_matches_jax(S):
    """The port's sweep gradient off the card (autograd of the plain sweep,
    B4's plain version) against jax.grad of the JAX sweep, whose custom VJP
    runs the Pallas backward kernel in interpret mode over 4 chunks. All
    three outputs carry a cotangent, as tests/test_ops.py:99-127 does."""
    B, N, D = 2, 64, 32
    k, v, q = _inputs(B, N, S, D, seed=10 + S)
    rng = np.random.default_rng(20 + S)
    t_sa = rng.standard_normal((B, S)).astype(np.float32)
    t_av = rng.standard_normal((B, S, D)).astype(np.float32)
    t_a = rng.standard_normal((B, N, S)).astype(np.float32)

    def jloss(k, v, q):
        sa, av, a = jsr.route_sweep(jsr.pick_chunk(N, target=16), k, v, q)
        return (jnp.sum(sa * t_sa) + jnp.sum(jnp.tanh(av) * t_av)
                + jnp.sum(jnp.tanh(a) * t_a))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (k, v, q)))
    tk, tv, tq = (torch.from_numpy(x).requires_grad_() for x in (k, v, q))
    sa, av, a = tsr.route_sweep(tk, tv, tq)
    loss = ((sa * torch.from_numpy(t_sa)).sum()
            + (torch.tanh(av) * torch.from_numpy(t_av)).sum()
            + (torch.tanh(a) * torch.from_numpy(t_a)).sum())
    got = torch.autograd.grad(loss, (tk, tv, tq))
    for name, g, w in zip(("gk", "gv", "gq"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   rtol=1e-5, atol=1e-5)
