"""The yardstick's counts against hand counts at the cells' shapes, and the
reference's Philox field against the port's own replay of its kernels'
noise."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchcore import counts, kernels, painter, trace as tracing
from benchcore.main import ROOT, load_module
from benchref import draws

H100 = counts.CARD_RATES["H100"]


def test_card_rates_pick_the_most_specific_name():
    assert counts.card_rates("NVIDIA H100 80GB HBM3") == ("H100", 3.35e12, 67e12)
    assert counts.card_rates("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    with pytest.raises(ValueError):
        counts.card_rates("cpu")


@pytest.mark.parametrize("B", [64, 256])
def test_sweep_bytes_by_hand(B):
    N, S, D = 4096, 5, 192
    k_v, q, a, s_a, a_v = 2 * B * N * D, B * S * D, B * N * S, B * S, B * S * D
    assert counts.sweep_bytes(B, N, S, D) == 4 * (k_v + q + a + s_a + a_v)
    # k, v, a, g_a, q, g_av read; gk, gv, gq written
    assert counts.sweep_bwd_bytes(B, N, S, D) == 4 * (
        2 * B * N * D + 2 * B * N * S + 2 * B * S * D + 2 * B * N * D + B * S * D)
    # fp32 at the cell's shape is bound by bytes both ways
    bw, fl = H100
    assert counts.sweep_bound_ms(B, N, S, D, bw, fl) == pytest.approx(
        1e3 * counts.sweep_bytes(B, N, S, D) / bw)
    assert counts.sweep_bwd_bound_ms(B, N, S, D, bw, fl) == pytest.approx(
        1e3 * counts.sweep_bwd_bytes(B, N, S, D) / bw)


def test_gumbel_bytes_by_hand():
    R, V = 64 * 16 * 16, 4096
    assert counts.gumbel_bytes(R, V, True) == 4 * R * V * 2 + 8
    assert counts.gumbel_bytes(R, V, False) == 4 * R * V + 8 + 8 * R
    bw, fl = H100
    assert counts.gumbel_bound_ms(R, V, True, bw, fl) == pytest.approx(
        1e3 * (8 * R * V + 8) / bw)


def _config(name):
    m = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    return m, load_module(ROOT / "benchmark" / "configs" / f"{name}.py", f"cfg_test_{name}")


def test_slate_flops_by_hand():
    m, mod = _config("slate")
    B, P, T, d, V = 64, 64 * 64, 256, 192, 4096
    enc = 2 * B * P * 64 * (3 * 25 * 2 + 64 * 25 * 3 * 3)      # first conv 2x, three 3x
    enc += 2 * 4096 * 4 * 64 * 2                                  # positions, once
    enc += 3 * 2 * B * P * (64 * 64 * 2 + 64 * 192 * 2)            # token MLP, k, v
    it = 3 * 2 * B * 5 * (192 * 192 + 2 * 3 * 192 * 192 + 2 * 192 * 192) + 3 * 2 * (
        2 * B * P * 5 * 192)
    dvae = 2 * 2 * B * 256 * 48 * 64 + 3 * 2 * B * 256 * (6 * 64 * 64 + 64 * V)
    dec = 3 * 2 * (B * 256 * (V * 64 + 576 * 64 + 2 * 64 * 64 + 64 * 256)
                   + B * 1024 * (576 * 64 + 2 * 64 * 64 + 64 * 256) + B * 4096 * 64 * 3)
    block = 3 * 2 * (B * T * d * d * 6 + B * T * T * d * 2 + B * 5 * d * d * 2
                     + B * T * 5 * d * 2 + B * T * d * 4 * d * 2)
    tf = 3 * 2 * B * 5 * 192 * d + 4 * block + 3 * 2 * B * T * d * V
    assert mod.train_flops(m, B) == enc + 3 * it + dvae + dec + tf


def test_slotattention_flops_by_hand():
    m, mod = _config("slotattention")
    _, slate = _config("slate")
    B, P, images = 64, 64 * 64, 64 * 5
    decoder = 3 * 2 * (images * 25 * 192 * 64 * 25 + P * 192 * 64 * 25)
    decoder += 2 * 2 * P * 4 * 192
    decoder += 3 * 2 * images * P * (2 * 64 * 64 * 25 + 64 * 4 * 9)
    encoder = counts.train_flops(slate.encoder_forward(m, B))
    assert mod.train_flops(m, B) == encoder + decoder


def test_sac_update_flops_by_hand():
    m, mod = _config("slate")
    B, P, S, D, d, A = 256, 64 * 64, 5, 192, 128, 3
    L = S + 1
    enc = 2 * B * P * 64 * 3 * 25 + 3 * 2 * B * P * 64 * 64 * 25 + 2 * P * 4 * 64
    enc += 2 * B * P * (2 * 64 * 64 + 2 * 64 * D)
    it = 2 * B * S * (D * D + 2 * 3 * D * D + 2 * D * D) + 2 * 2 * B * P * S * D
    pool = 2 * B * S * D * d + 2 * B * L * (4 * d * d + 2 * d * 2048) + 2 * 2 * B * L * L * d
    extract = enc + 3 * it + pool
    critic = 2 * 2 * B * ((d + A) * 256 + 256 * 256 + 256)
    actor = 2 * B * (d * 256 + 256 * 256 + 256 * 2 * A)
    no_grad = 2 * extract + actor + critic
    # the first conv and the positions need no input gradient
    critic_pass = 3 * (extract + critic) - 2 * B * P * 64 * 3 * 25 - 2 * P * 4 * 64
    actor_pass = 3 * actor - 2 * B * d * 256 + 2 * critic
    assert mod.update_flops(m, B) == no_grad + critic_pass + actor_pass


def test_a_loss_near_zero_is_measured_against_the_losses_scale():
    from benchcore import gaps

    assert gaps.loss_gap([2.0, 1.01], [2.0, 1.0]) == pytest.approx(0.01 / 1.5)
    assert gaps.loss_gap([1.0, 0.0101, 2.0], [1.0, 0.01, 2.0]) == pytest.approx(1e-4)
    assert gaps.loss_gap([-3.0, -0.5], [-3.0, -0.4]) == pytest.approx(0.1 / 1.7)


def _ops(*names_ms):
    out, at = [], 0.0
    for name, ms in names_ms:
        out.append(tracing.Op(f"void {name}<5>(float const*)", at, at + 1e3 * ms, "kernel"))
        at += 1e3 * ms + 10
    return out


def test_routing_roofline_counts_calls_of_every_plan():
    bw, fl = H100
    shape = (64, 4096, 5, 192, 1)
    fwd = counts.sweep_bound_ms(64, 4096, 5, 192, bw, fl)
    bwd = counts.sweep_bwd_bound_ms(64, 4096, 5, 192, bw, fl)
    fast = _ops(("sweep_fwd_kernel", 0.2), ("reduce_rows", 0.01), ("sweep_bwd_kernel", 0.4),
                ("reduce_rows", 0.01), ("at::native::other", 5.0))
    assert kernels.routing_calls(fast) == (1, 1)
    assert kernels.routing_roofline(fast, shape, bw, fl) == pytest.approx(
        100 * (fwd + bwd) / 0.62)
    wide = _ops(("wide_pairs_kernel", 0.1), ("wide_sums_kernel", 0.1), ("reduce_segments", 0.1),
                ("wide_pairs_kernel", 0.1), ("wide_tokens_kernel", 0.1),
                ("wide_sums_kernel", 0.1), ("reduce_segments", 0.1))
    assert kernels.routing_calls(wide) == (1, 1)
    assert kernels.routing_roofline(_ops(("at::native::other", 1.0)), shape, bw, fl) is None


@pytest.mark.parametrize("name,conv", [
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_stage3", True),
    ("sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8", True),
    ("void wgrad_alg0_engine_NHWC<float, 128, 5, 5, 3, 3, 3, false, 512>(int, int, int)", True),
    ("void cudnn::winograd_nonfused::winogradForwardData9x9_5x5<float, float>(cudnn::wi", True),
    ("void fft2d_c2r_32x32<float, false, false, 0u, false, false>(float*, float2 const*)", True),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize64x64x8_stage3_warpsize2x2x1", True),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<float, float, float, true, false>", True),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma", False),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nt_align1>(cutlass_80_simt)", False),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::fu", False),
    ("void (anonymous namespace)::sweep_fwd_kernel<5>(float const*, float const*)", False),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>", False)])
def test_convolution_kernels_by_name(name, conv):
    assert kernels.is_conv(name) is conv


def test_idle_gaps_and_busy_time():
    ops = [tracing.Op("a", 10, 20, "kernel"), tracing.Op("b", 15, 30, "gpu_memcpy"),
           tracing.Op("c", 50, 60, "kernel")]
    t = tracing.Trace(ops, [("window", 0, 100), ("to_host", 30, 55), ("update_many", 0, 30)],
                      (0, 100))
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.idle_gaps() == [("none", pytest.approx(40e-6)), ("to_host", pytest.approx(20e-6)),
                             ("update_many", pytest.approx(10e-6))]
    assert [name for name, _ in t.top_ops()] == ["b", "a", "c"]


def test_a_gap_is_named_by_the_span_that_covers_most_of_it():
    # the device idles from the end of the policy call's kernels, between
    # the harness's spans, through the env step
    t = tracing.Trace([tracing.Op("act", 10, 20, "kernel")],
                      [("window", 0, 100), ("act", 0, 12), ("env_step", 24, 90)], (0, 100))
    assert t.idle_gaps() == [("env_step", pytest.approx(80e-6)), ("act", pytest.approx(10e-6))]


def test_philox_field_is_the_kernels():
    from ocrl_tpu_torch.ops import gumbel

    seed = 0x7FFF_FFFF_1234_5678
    for stream in (draws.SOFT_STREAM, draws.IDS_STREAM):
        want = gumbel.replay_field(seed, stream, 5, 16)
        got = draws.philox_gumbel(seed, stream, 5, 16, "cpu").numpy()
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=0, atol=0)


def test_painted_scenes_are_the_seeds():
    a, b = painter.painted(16, 64, 5, 2 ** 31 + 5), painter.painted(16, 64, 5, 2 ** 31 + 5)
    assert a.dtype == np.uint8 and a.shape == (16, 64, 64, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, painter.painted(16, 64, 5, 2 ** 31 + 6))
    # five squares over a background: at least two colours in each scene
    assert all(len(np.unique(s.reshape(-1, 3), axis=0)) >= 2 for s in a)


def test_written_file_reads_back_through_the_ports_loader(tmp_path):
    from ocrl_tpu_torch.data.hdf5 import H5Dataset

    from benchcore import h5writer

    obs = painter.painted(20, 16, 5, 3)
    path = tmp_path / "s.hdf5"
    h5writer.write(path, {"TrainingSet": {"obss": obs, "num_objs": np.full(20, 5)},
                          "ValidationSet": {"obss": obs[:4], "num_objs": np.full(4, 5)}})
    got = H5Dataset(path, "TrainingSet").read_slice(0, 20)
    assert set(got) == {"obss"} and np.array_equal(got["obss"], obs)
