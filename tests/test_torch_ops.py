"""The port's routing sweep against the JAX sweep (interpret mode) and its
plain version. Tolerance 1e-5: both sides are fp32 and differ only in the
order of the sums over D and over the tokens."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.ops import slot_routing as jsr
from ocrl_tpu_torch.ops import LAUNCHES, reset_launches
from ocrl_tpu_torch.ops import gumbel as tgumbel
from ocrl_tpu_torch.ops import slot_routing as tsr
from ocrl_tpu_torch.ops import _build
from ocrl_tpu_torch.ops._build import ptxas_usage

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
                                 "slots", "width", "too_wide", "layout", "smem"])
def test_sweep_rejects_what_the_kernel_does_not_take(bad):
    """route_sweep refuses, before any launch, what no kernel takes: more
    than 32 slots, a head count that does not divide D, a shape whose ring
    of one token does not fit a block's shared memory (D = 8192, or 32 slots
    of 2048), and malformed inputs."""
    k, v, q = (torch.from_numpy(x) for x in _inputs(2, 40, 5, 32, seed=0))
    heads = 1
    if bad == "dtype":
        k, exc = k.double(), TypeError
    elif bad == "rank":
        k, exc = k[0], ValueError
    elif bad == "v_shape":
        v, exc = v[:, :30].contiguous(), ValueError
    elif bad == "q_width":
        q, exc = torch.zeros(2, 5, 64), ValueError
    elif bad == "slots":
        q, exc = torch.zeros(2, 33, 32), ValueError
    elif bad == "width":        # 3 heads do not divide 32 columns
        heads, exc = 3, ValueError
    elif bad == "too_wide":     # k and v tiles and q over 227 KB
        k, v, q, exc = torch.zeros(2, 40, 8192), torch.zeros(2, 40, 8192), \
            torch.zeros(2, 5, 8192), ValueError
    elif bad == "smem":         # 32 slots of 2048: q and g_av alone 512 KB
        k, v, q, heads, exc = torch.zeros(2, 40, 2048), torch.zeros(2, 40, 2048), \
            torch.zeros(2, 32, 2048), 8, ValueError
    else:
        k, exc = k.transpose(0, 1).contiguous().transpose(0, 1), ValueError
    with pytest.raises(exc):
        tsr.route_sweep(k, v, q, heads)


def block_range(g: int, G: int, BN: int) -> tuple[int, int]:
    """Block g's range [start, end) of the B * N token stream, as
    csrc/slot_routing.cu's block_tiles cuts it."""
    return g * BN // G, (g + 1) * BN // G


def row_blocks(b: int, N: int, G: int, BN: int) -> range:
    """The blocks whose ranges meet batch row b, as csrc/slot_routing.cu's
    reduce_rows finds them (the block holding token t is ((t + 1) G - 1) //
    BN) and in the order it sums their scratch slots g + b."""
    def holding(t):
        return ((t + 1) * G - 1) // BN
    return range(holding(b * N), holding(b * N + N - 1) + 1)


# the tiles the C entries may choose (csrc/slot_routing.cu kFwdTiles,
# kBwdTiles, kHeadsTiles)
_TILES = tsr.HEADS_TILES


@pytest.mark.parametrize("B,N,num_sms", [(24, 4096, 132), (16, 4096, 132),
                                         (64, 4096, 132), (3, 333, 132),
                                         (2, 100, 132), (1, 5, 132), (7, 50, 4)])
def test_plan_covers_any_n(B, N, num_sms):
    """The kernels' grid: one block per SM, or one per tile of a small
    input, whatever tile the C entry chooses; the block ranges cut the
    B * N tokens into contiguous pieces that differ by at most one token;
    row_blocks(b) lists exactly the blocks whose ranges meet row b, in order,
    so each row's partials are summed in one order; and every slot g + b
    they write lies in the scratch the wrapper allocates."""
    BN = B * N
    rows = tsr.scratch_rows(B, N, num_sms)
    for T in _TILES:
        G = min(num_sms, -(-BN // T))
        ranges = [block_range(g, G, BN) for g in range(G)]
        assert ranges[0][0] == 0 and ranges[-1][1] == BN
        assert all(e == s for (_, e), (s, _) in zip(ranges, ranges[1:]))
        sizes = [e - s for s, e in ranges]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        for b in range(B):
            meet = [g for g, (s, e) in enumerate(ranges) if s < (b + 1) * N and e > b * N]
            assert list(row_blocks(b, N, G, BN)) == meet
            assert all(0 <= g + b < rows for g in meet)


def heads_plan(S: int, D: int, H: int):
    """The tile of the heads forward and (tile, stages) of the heads
    backward that the C entries choose (csrc/slot_routing.cu heads_fwd_plan,
    heads_bwd_plan): the largest tile whose ring fits, the backward with 3
    stages where they fit."""
    fits = [(T, n) for T in tsr.HEADS_TILES for n in tsr.HEADS_BWD_STAGES
            if tsr.heads_bwd_bytes(S, D, H, T, n) <= tsr.SMEM_LIMIT]
    return next(T for T in tsr.HEADS_TILES
                if tsr.heads_fwd_bytes(S, D, H, T) <= tsr.SMEM_LIMIT), fits[0]


def test_sweep_supports_and_tiles():
    """The single-head kernels take 1 <= S <= 16 and D a multiple of 32 up
    to 256 (fast_path); the heads kernels take the rest of 1 <= S <= 32 with
    H dividing D where their smallest ring fits a Hopper block's shared
    memory: everywhere with H <= 8 and D <= 512 (each C entry then chooses
    a tile that fits: the card-only tests launch every S at the narrowest
    and widest D, and H up to 8 at D = 21, 100 and 512); route_sweep rejects
    the rest before any launch, naming the bytes a shape needs."""
    for S in range(0, 35):
        for H in (1, 2, 3, 4, 8, 16):
            for D in range(1, 600, 1 if S in (1, 17, 32) else 7):
                fast = H == 1 and 1 <= S <= 16 and D % 32 == 0 and D <= 256
                heads = 1 <= S <= 32 and D % H == 0
                assert tsr.fast_path(S, D, H) == fast, (S, D, H)
                assert tsr.sweep_supports(S, D, H) == (fast or heads), (S, D, H)
    for S, D, H, fits in [(32, 512, 8, True), (32, 768, 8, True), (32, 1024, 8, False),
                          (16, 1024, 8, True), (5, 4096, 1, True), (5, 8192, 1, False),
                          (1, 4096, 64, True)]:
        assert tsr.sweep_supports(S, D, H) == fits, (S, D, H)
        assert (tsr.needed_bytes(S, D, H) <= tsr.SMEM_LIMIT) == fits, (S, D, H)
    # the tiles the C entries choose where they have room, and at the corner
    assert heads_plan(5, 192, 4) == (64, (48, 2))
    assert heads_plan(24, 256, 1) == (48, (32, 2))
    assert heads_plan(32, 512, 8) == (16, (4, 3))
    with pytest.raises(ValueError, match="needs 565632 bytes"):
        tsr.route_sweep(torch.zeros(1, 3, 2048), torch.zeros(1, 3, 2048),
                        torch.zeros(1, 32, 2048), 8)
    k, v, q = torch.zeros(1, 3, 512), torch.zeros(1, 3, 512), torch.zeros(1, 32, 512)
    sa, av, a = tsr.route_sweep(k, v, q, 8)    # the corner of the range, on the CPU
    assert sa.shape == (1, 256) and av.shape == (1, 32, 512) and a.shape == (1, 3, 256)
    torch.testing.assert_close(sa, torch.full((1, 256), 3 / 256))


_CTYPE_OF = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def _c_signatures(source: str) -> dict[str, list[str]]:
    """extern "C" functions of a .cu source: name -> kind of each parameter
    (ptr, int or float)."""
    text = (Path(tsr.__file__).parent / "csrc" / source).read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for p in params.split(","):
            p = p.strip()
            kinds.append("ptr" if "*" in p else "float" if p.startswith("float") else "int")
        out[name] = kinds
    return out


@pytest.mark.parametrize("module,source,name", [
    (tsr, "slot_routing.cu", tsr.KERNEL), (tsr, "slot_routing.cu", tsr.BWD_KERNEL),
    (tgumbel, "gumbel.cu", tgumbel.SOFT_KERNEL), (tgumbel, "gumbel.cu", tgumbel.IDS_KERNEL)])
def test_ctypes_argtypes_match_the_c_signatures(module, source, name):
    """A wrong ctypes argtype shows only on the card (a pointer cut to 32
    bits, an int read as a pointer): hold each wrapper's _ARGTYPES against
    the extern "C" signature in its source, in count and kind."""
    kinds = _c_signatures(source)[name]
    assert module._ARGTYPES[name] == [_CTYPE_OF[k] for k in kinds]


def test_ptxas_usage_reads_registers_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116sweep_bwd_kernelILi11EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116sweep_bwd_kernelILi11EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiii
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111reduce_rowsEPKfPfS2_iiixi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111reduce_rowsEPKfPfS2_iiixi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, 400 bytes cmem[0]
"""
    assert ptxas_usage(log) == {
        "sweep_bwd_kernel<11>": {"registers": 255, "spill_stores": 8, "spill_loads": 12},
        "reduce_rows": {"registers": 18, "spill_stores": 0, "spill_loads": 0}}


@pytest.mark.parametrize("name", ["slot_routing", "gumbel"])
def test_ptxas_report_is_kept_beside_the_library(name, tmp_path, monkeypatch):
    """The spill check reads each library's ptxas report from beside it, so
    a library built by an earlier run is checked too; a library without its
    report counts as not built, and build_log raises without one."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lib, log = _build.library_path(name), _build.log_path(name)
    assert log.parent == lib.parent == tmp_path and log.name.startswith(lib.stem)
    with pytest.raises(RuntimeError):
        _build.build_log(name)
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("would compile")))
    with pytest.raises(RuntimeError, match="would compile"):
        _build.build([name])                # the library alone is not enough
    log.write_text("ptxas info    : Used 8 registers")
    assert _build.build([name]) == {}       # both there: nothing to compile
    assert _build.build_log(name) == "ptxas info    : Used 8 registers"
    assert name in _build.sources()


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
