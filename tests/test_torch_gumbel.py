"""The port's Gumbel sampling (kernels B1 and B2 off the card: their plain
versions) against ocrl_tpu/ops/gumbel.py's CPU path, fed the same
exponential draws.

Tolerances: the soft sample and its backward are one softmax of fp32 values
in both frameworks, held to 1e-6 (a few ulps of values in [0, 1]; the field
-log(E + tiny) is taken once in numpy and once in XLA, which may differ by an
ulp). Token ids are held exactly. Distribution checks use 2 ** 18 draws:
the standard error of the mean of a Gumbel field is 1.28 / 512 = 0.0025 and
of its variance about 0.01, so the bounds 0.01 and 0.05 sit at 4-5 standard
errors.

The numpy replay of the kernels' Philox field (``gumbel.replay_field``, the
plain reference of their noise) is held here to Random123's known answers,
to the constants of csrc/gumbel.cu, and to the range and moments of a Gumbel
field; on the card, tests/test_torch_cuda.py holds each kernel's field to
it."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.ops import gumbel as jgumbel
from ocrl_tpu_torch.ops import LAUNCHES, gumbel, reset_launches

TOL = dict(rtol=1e-6, atol=1e-6)
TINY = np.finfo(np.float32).tiny
EULER_GAMMA = 0.5772156649015329
GUMBEL_CU = Path(gumbel.__file__).parent / "csrc" / "gumbel.cu"
# Random123's known answers for Philox4x32-10: counter, key, output.
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
# g at u = 2^-24 and at u = 1 - 2^-24, the ends of the kernels' uniform
FIELD_LOW, FIELD_HIGH = -2.81155, 16.63554


def _draws(R, V, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((R, V)) * 2).astype(np.float32)
    e = rng.exponential(size=(R, V)).astype(np.float32)
    return logits, e


def _jax_with(monkeypatch, e):
    monkeypatch.setattr(jax.random, "exponential",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(e))


@pytest.mark.parametrize("tau", [1.0, 0.55, 0.1])
def test_soft_sample_matches_jax(monkeypatch, tau):
    logits, e = _draws(24, 64, seed=1)
    _jax_with(monkeypatch, e)
    want = jgumbel.gumbel_softmax_sample(jnp.asarray(logits), jax.random.PRNGKey(0), tau)
    g = torch.from_numpy(-np.log(e + TINY))
    reset_launches()
    got = gumbel.gumbel_softmax_sample(torch.from_numpy(logits), tau, noise=g)
    assert LAUNCHES == {}          # a CPU tensor never launches the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = gumbel.gumbel_softmax_sample_reference(torch.from_numpy(logits), g, tau)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("tau", [1.0, 0.3])
def test_soft_sample_backward_matches_jax(monkeypatch, tau):
    """The port's backward against JAX's custom VJP (_soft_bwd)."""
    logits, e = _draws(16, 32, seed=2)
    w = np.random.default_rng(3).standard_normal((16, 32)).astype(np.float32)
    _jax_with(monkeypatch, e)
    want = jax.grad(lambda x: jnp.sum(
        jgumbel.gumbel_softmax_sample(x, jax.random.PRNGKey(0), tau) * w))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    g = torch.from_numpy(-np.log(e + TINY))
    (gumbel.gumbel_softmax_sample(x, tau, noise=g) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)
    # and against autograd of the plain version
    x2 = torch.from_numpy(logits).requires_grad_()
    (gumbel.gumbel_softmax_sample_reference(x2, g, tau)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), **TOL)


@pytest.mark.parametrize("shape", [(24, 64), (37, 512)])
def test_argmax_ids_match_jax(monkeypatch, shape):
    logits, e = _draws(*shape, seed=4)
    _jax_with(monkeypatch, e)
    want = jgumbel.gumbel_argmax_ids(jnp.asarray(logits), jax.random.PRNGKey(0))
    g = torch.from_numpy(-np.log(e + TINY))
    got = gumbel.gumbel_argmax_ids(torch.from_numpy(logits), noise=g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_argmax_ids_take_the_first_nan_as_jax_does():
    """Rows with some NaN, rows of NaN only and a row of -inf: the plain id
    version (B2's reference on the card) gives jnp.argmax's ids, the first
    NaN's index where there is one; exact, every id below V."""
    logits, _ = _draws(8, 64, seed=9)
    logits[0, [5, 17]] = np.nan
    logits[1, 63] = np.nan
    logits[2, 0] = np.nan
    logits[3:6] = np.nan
    logits[6] = -np.inf
    want = jnp.argmax(jnp.asarray(logits), axis=-1)
    t = torch.from_numpy(logits)
    got = gumbel.gumbel_argmax_ids_reference(t, torch.zeros_like(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:7].tolist() == [5, 63, 0, 0, 0, 0, 0] and int(got.max()) < 64
    np.testing.assert_array_equal(
        gumbel.gumbel_argmax_ids(t, noise=torch.zeros_like(t)).numpy(), np.asarray(want))


def test_argmax_ids_distribution():
    """One row repeated: id frequencies ~ softmax(row), as tests/test_ops.py
    holds the JAX version (atol 0.05 at 4096 draws there, 0.02 here at 16384)."""
    row = torch.full((1, 128), -1e9)
    row[0, :4] = torch.tensor([2.0, 1.0, 0.0, -1.0])
    gen = torch.Generator().manual_seed(0)
    ids = gumbel.gumbel_argmax_ids(row.repeat(16384, 1), generator=gen)
    freq = torch.bincount(ids, minlength=4)[:4].double() / 16384
    want = torch.softmax(torch.tensor([2.0, 1.0, 0.0, -1.0], dtype=torch.float64), 0)
    np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=0.02)


def test_drawn_field_is_gumbel_and_recorded():
    """Without ``noise`` the CPU path draws -log(E + tiny) from the
    generator; ``g_out`` receives it, and feeding it back reproduces the
    sample. The field has the Gumbel mean (Euler's gamma) and variance
    (pi^2 / 6)."""
    logits = torch.randn(512, 512, generator=torch.Generator().manual_seed(5))
    g = torch.empty_like(logits)
    y = gumbel.gumbel_softmax_sample(logits, 0.5,
                                     generator=torch.Generator().manual_seed(6), g_out=g)
    np.testing.assert_array_equal(
        y.numpy(), gumbel.gumbel_softmax_sample(logits, 0.5, noise=g).numpy())
    assert abs(g.double().mean().item() - EULER_GAMMA) < 0.01
    assert abs(g.double().var().item() - math.pi ** 2 / 6) < 0.05
    g2 = torch.empty_like(logits)
    ids = gumbel.gumbel_argmax_ids(logits, generator=torch.Generator().manual_seed(7),
                                   g_out=g2)
    np.testing.assert_array_equal(ids.numpy(),
                                  gumbel.gumbel_argmax_ids(logits, noise=g2).numpy())


def test_argmax_ids_take_no_gradient():
    x = torch.randn(4, 8, requires_grad=True)
    ids = gumbel.gumbel_argmax_ids(x, generator=torch.Generator().manual_seed(0))
    assert ids.dtype == torch.int64 and not ids.requires_grad


@pytest.mark.parametrize("bad", ["dtype", "rank", "noise_shape", "g_out_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, noise, g_out = torch.zeros(4, 8), None, None
    if bad == "dtype":
        x = x.double()
    elif bad == "rank":
        x = x[None]
    elif bad == "noise_shape":
        noise = torch.zeros(4, 4)
    else:
        g_out = torch.zeros(4, 8, dtype=torch.float64)
    with pytest.raises(ValueError):
        gumbel.gumbel_softmax_sample(x, 1.0, noise=noise, g_out=g_out)
    with pytest.raises(ValueError):
        gumbel.gumbel_argmax_ids(x, noise=noise, g_out=g_out)


@pytest.mark.parametrize("counter, key, want", KNOWN_ANSWERS)
def test_philox_known_answers(counter, key, want):
    """The replay's Philox4x32-10 gives Random123's published answers."""
    got = gumbel.philox4x32_10(np.array(counter, np.uint32), np.array(key, np.uint32))
    assert got.tolist() == list(want)


def test_replay_has_the_constants_of_the_kernels():
    """The multipliers, key increments and id stream of csrc/gumbel.cu are
    the replay's."""
    src = GUMBEL_CU.read_text()
    found = {name: int(value, 16) for name, value in
             re.findall(r"\b(kM0|kM1|kW0|kW1|kIdsStream) = (0x[0-9A-Fa-f]+)u", src)}
    assert found == {"kM0": int(gumbel._PHILOX_M[0]), "kM1": int(gumbel._PHILOX_M[1]),
                     "kW0": int(gumbel._PHILOX_W[0]), "kW1": int(gumbel._PHILOX_W[1]),
                     "kIdsStream": gumbel.IDS_STREAM}


@pytest.mark.parametrize("stream", [gumbel.SOFT_STREAM, gumbel.IDS_STREAM])
def test_replayed_field_lies_between_the_ends_of_u(stream):
    """The lowest and highest words give g at u = 2^-24 and 1 - 2^-24; a
    replayed field of 2^18 values lies between them, and depends on the seed
    and the position only (a part of a wider field is the same)."""
    ends = gumbel.gumbel_of_bits(np.array([0, 0xFFFFFFFF], np.uint32))
    np.testing.assert_allclose(ends, [FIELD_LOW, FIELD_HIGH], atol=1e-5)
    g = gumbel.replay_field(2 ** 40 + 17, stream, 64, 4096)
    assert g.dtype == np.float64 and g.shape == (64, 4096)
    assert ends[0] <= g.min() and g.max() <= ends[1]
    np.testing.assert_array_equal(gumbel.replay_field(2 ** 40 + 17, stream, 5, 96),
                                  g[:5, :96])


def test_replayed_seed_is_the_one_the_wrapper_draws():
    """A generator's state before a draw gives back the seed drawn."""
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    seed = int(gumbel.draw_seed(gen, torch.device("cpu")).item())
    assert gumbel.replayed_seed(state, "cpu") == seed
    assert 0 <= seed < 2 ** 62


@pytest.mark.parametrize("stream", [gumbel.SOFT_STREAM, gumbel.IDS_STREAM])
def test_replayed_field_is_gumbel(stream):
    """2^18 replayed values have the Gumbel mean and variance, within the
    bounds of test_drawn_field_is_gumbel_and_recorded; the two streams of one
    seed are other fields."""
    g = gumbel.replay_field(123456789, stream, 64, 4096)
    assert abs(g.mean() - EULER_GAMMA) < 0.01
    assert abs(g.var() - math.pi ** 2 / 6) < 0.05
    other = gumbel.IDS_STREAM if stream == gumbel.SOFT_STREAM else gumbel.SOFT_STREAM
    assert abs(np.corrcoef(g.ravel(), gumbel.replay_field(123456789, other, 64,
                                                          4096).ravel())[0, 1]) < 0.01


@pytest.mark.parametrize("stream", [gumbel.SOFT_STREAM, gumbel.IDS_STREAM])
def test_replay_at_row0_is_a_row_slice_of_the_longer_replay(stream):
    """The kernels count the Philox row word from row0, so a rank drawing
    rows row0 .. row0 + R - 1 draws exactly those rows of the global field."""
    whole = gumbel.replay_field(987654321, stream, 10, 16)
    np.testing.assert_array_equal(gumbel.replay_field(987654321, stream, 4, 16, row0=6),
                                  whole[6:])
    np.testing.assert_array_equal(gumbel.replay_field(987654321, stream, 3, 16, row0=2),
                                  whole[2:5])


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "ids"])
def test_plain_row0_keeps_the_last_rows_of_the_longer_draw(soft):
    """The plain twin of row0: the field drawn at row0 + R rows, its last R
    kept, on a generator in the same state as one drawing the longer field."""
    logits = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    g = torch.empty_like(logits)
    gen = torch.Generator().manual_seed(7)
    if soft:
        y = gumbel.gumbel_softmax_sample(logits, 0.5, generator=gen, g_out=g, row0=5)
        torch.testing.assert_close(y, gumbel.gumbel_softmax_sample_reference(logits, g, 0.5),
                                   rtol=0, atol=0)
    else:
        ids = gumbel.gumbel_argmax_ids(logits, generator=gen, g_out=g, row0=5)
        assert torch.equal(ids, gumbel.gumbel_argmax_ids_reference(logits, g))
    whole = gumbel.gumbel_field((8, 8), torch.Generator().manual_seed(7))
    assert torch.equal(g, whole[5:])


def test_row0_outside_the_counter_is_refused():
    logits = torch.zeros(4, 8)
    for row0 in (-1, 2 ** 31 - 4):
        with pytest.raises(ValueError, match="row0"):
            gumbel.gumbel_argmax_ids(logits, row0=row0)
