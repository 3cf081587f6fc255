"""Every pooling of the port against its JAX module on the same inputs and,
through utils.convert.from_flax, the same weights, at the shapes of
tests/test_poolings.py: 3 sets of 5 slots of 16 for Transformer, RN, MLP
and Identity (and MLP and Identity on a one-slot OCR's [B, D]), a 64x64 grid
of 8-wide slots for CNN_Linear and CNN_Transformer; the Transformer with
each embedding option (push_embedding, cw_embedding, use_mlp1, use_mlp2),
the position table (ape) and stacked frames. Also ``sinusoid_lookup``
against JAX's ``_sinusoid_lookup`` at the push embedding's 10^7 rows and
against the table at 997 rows,
``pooled_dim``, the identity acnets, the orthogonal initial gains of
``mlp_orthoinit``, and each pooling and acnet config against its YAML
(the port's reader and the JAX compose).

Tolerance: 1e-5 of max(|want|, 1e-2) for every pooling (a few fp32
layers summed in other orders). The sinusoid rows 1e-5 absolute, where
both sides' frequencies are the same float32 values (see the test).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocrl_tpu.config import compose
from ocrl_tpu.config.node import StaticConfig
from ocrl_tpu.poolings import create_pooling_module as jcreate
from ocrl_tpu.poolings import pooled_dim as jpooled_dim
from ocrl_tpu.poolings.modules import _sinusoid_lookup
from ocrl_tpu.rl.ac_nets import ActorCriticPolicy as JPolicy

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.poolings import create_pooling_module, pooled_dim
from ocrl_tpu_torch.poolings.modules import sinusoid_div, sinusoid_lookup, sinusoid_table
from ocrl_tpu_torch.rl import build_policy
from ocrl_tpu_torch.utils.convert import from_flax

TOL, FLOOR = 1e-5, 1e-2
REP = np.random.default_rng(0).random((3, 5, 16)).astype(np.float32)
GRID = np.random.default_rng(1).random((2, 64 * 64, 8)).astype(np.float32)
POOLINGS = ["transformer", "rn", "mlp", "cnn_linear", "cnn_transformer", "identity"]
ACNETS = ["mlp", "mlp_orthoinit", "identity", "identity_orthoinit"]


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def configs(name, *over):
    argv = [f"pooling={name}", "ocr=gt", "sb3=ppo", "sb3_acnet=mlp", "env=target-N4C4S3S1",
            *over]
    return (compose("train_sb3", argv).pooling,
            tcfg.compose(tcfg.TrainSB3Config(), argv).pooling)


def close(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), FLOOR)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{err:.3e} > {TOL} x {scale:.3e}"


def check_pooling(name, state, rep_dim, num_slots, *over, stacked=1, seed=0, tweak=None):
    """The JAX pooling and the port's on the same weights and ``state``."""
    jcfg, cfg = configs(name, *over)
    jm = jcreate(jcfg.name, rep_dim, num_slots, jcfg, stacked)
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.PRNGKey(seed), state).get("params", {}))
    if tweak is not None:
        tweak(params)
    want = jm.apply({"params": params}, state)
    tm = create_pooling_module(cfg.name, rep_dim, num_slots, cfg, stacked)
    state_dict = {k[len("pooling_module."):]: v
                  for k, v in from_flax({"pooling_module": params}).items()}
    tm.load_state_dict(state_dict)
    close(tm.eval()(torch.from_numpy(state)), want)
    dim = pooled_dim(cfg.name, cfg, rep_dim, num_slots, stacked)
    assert dim == jpooled_dim(jcfg.name, jcfg, rep_dim, num_slots, stacked) == want.shape[-1]


def _cls_not_zero(params):
    core = params["CoreTransformer_0"]
    core["cls_token"] = np.random.default_rng(2).standard_normal(core["cls_token"].shape) \
        .astype(np.float32)


@pytest.mark.parametrize("name", ["transformer", "rn", "mlp", "identity"])
def test_pooling_on_slots_matches_jax(name):
    check_pooling(name, REP, 16, 5, tweak=_cls_not_zero if name == "transformer" else None)


@pytest.mark.parametrize("name", ["mlp", "identity"])
def test_pooling_on_one_vector_matches_jax(name):
    """A one-slot OCR (VAE's mean, NatureCNN's vector, MAE's CLS) gives [B, D]."""
    check_pooling(name, REP[:, 0], 16, 1)


@pytest.mark.parametrize("name", ["cnn_linear", "cnn_transformer"])
def test_cnn_pooling_on_a_feature_grid_matches_jax(name):
    check_pooling(name, GRID, 8, 64 * 64,
                  tweak=_cls_not_zero if name == "cnn_transformer" else None)


def test_rn_pairs_are_ordered_and_row_major():
    _, cfg = configs("rn")
    tm = create_pooling_module("RN", 16, 4, cfg)
    want = [(i, j) for i in range(4) for j in range(4) if i != j]
    assert [tuple(p) for p in tm.pairs.tolist()] == want


def push_state():
    """Push states: colour and shape ids, two other columns, and (x, y)
    within 2e-5 of -1, so that their rows of the 10^7-row sinusoid table
    are below 100 and one ulp of a frequency moves no angle by more than
    6e-6 rad (``test_sinusoid_lookup_matches_jax`` covers the whole range)."""
    B, K = 2, 5
    state = np.zeros((B, K, 6), np.float32)
    state[:, :, 0] = np.arange(K) % 4
    state[:, :, 1] = np.arange(K) % 3
    state[:, :, 2:4] = np.random.default_rng(4).standard_normal((B, K, 2))
    state[:, :, -2:] = -1 + np.random.default_rng(3).uniform(0, 2e-5, (B, K, 2))
    return state


OPTIONS = {
    "push_embedding": (push_state(), ["pooling.push_embedding=True"]),
    "cw_embedding": (np.random.default_rng(5).uniform(-1, 1, (2, 5, 38)).astype(np.float32),
                     ["pooling.cw_embedding=True"]),
    "use_mlp1": (REP, ["pooling.use_mlp1=True"]),
    "use_mlp2": (REP, ["pooling.use_mlp2=True"]),
    "push+mlp1": (push_state(), ["pooling.push_embedding=True", "pooling.use_mlp1=True"]),
    "ape": (REP, ["pooling.pos_emb=ape"]),
}


@pytest.mark.parametrize("option", OPTIONS)
def test_transformer_options_match_jax(option):
    state, over = OPTIONS[option]
    check_pooling("transformer", state, state.shape[-1], state.shape[1], *over,
                  tweak=_cls_not_zero)


def test_transformer_on_stacked_frames_matches_jax():
    stacked = np.random.default_rng(6).random((3, 10, 16)).astype(np.float32)
    check_pooling("transformer", stacked, 16, 5, stacked=2, tweak=_cls_not_zero)


def test_sinusoid_lookup_matches_jax():
    """The push embedding's rows: 10^7 of them, angles up to 10^7 rad, where
    an ulp of a frequency moves an angle by up to 0.6 rad. The port's
    frequencies are exp correctly rounded to float32, each within an ulp of
    JAX's; the features whose frequency both sides round alike agree."""
    x = np.concatenate([np.linspace(-1.2, 1.2, 241),
                        np.random.default_rng(7).uniform(-1, 1, 2000)]).astype(np.float32)
    div = sinusoid_div(128)
    jdiv = np.asarray(jnp.exp(jnp.arange(0, 128, 2, dtype=jnp.float32)
                              * (-math.log(10000.0) / 128)))
    np.testing.assert_array_max_ulp(div, jdiv, maxulp=1)
    same = np.repeat(div == jdiv, 2)
    assert same.mean() > 0.75
    want = np.asarray(_sinusoid_lookup(jnp.asarray(x), 128, 10_000_000))
    got = sinusoid_lookup(torch.from_numpy(x), torch.from_numpy(div), 10_000_000).numpy()
    assert got.shape == want.shape == (x.size, 128)
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=0, atol=1e-5)


def test_sinusoid_lookup_matches_the_table():
    """JAX's own golden check (tests/test_poolings.py): at 997 rows every
    feature equals the materialised table's row, clipped coordinates too."""
    max_len, d_model = 997, 32
    table = sinusoid_table(max_len + 1, d_model)
    x = np.linspace(-1.2, 1.2, 41).astype(np.float32)
    got = sinusoid_lookup(torch.from_numpy(x), torch.from_numpy(sinusoid_div(d_model)),
                          max_len).numpy()
    idx = np.clip(np.floor(np.clip((x + 1) / 2, 0, 1) * max_len).astype(int), 0, max_len)
    np.testing.assert_allclose(got, table[idx], rtol=1e-5, atol=1e-5)


def test_unknown_pooling_raises():
    _, cfg = configs("identity")
    with pytest.raises(ValueError, match="Unknown pooling"):
        create_pooling_module("Sum", 16, 5, cfg)
    with pytest.raises(ValueError, match="Unknown pooling"):
        pooled_dim("Sum", cfg, 16, 5)


@pytest.mark.parametrize("acnet", ["identity", "identity_orthoinit"])
def test_identity_acnets_match_jax(acnet):
    """No shared, policy or value layers: the pooled features go straight
    to the heads, initialised orthogonal with gains 0.01 and 1.0 under
    ortho_init (as the JAX heads), lecun-normal without."""
    argv = ["ocr=gt", "pooling=identity", "sb3=ppo", f"sb3_acnet={acnet}",
            "env=push-N3C4S1S1", "env.render_mode=state"]
    jcfg = compose("train_sb3", argv)
    cfg = tcfg.compose(tcfg.TrainSB3Config(), argv).policy_config()
    from ocrl_tpu.models import build_spec

    spec = build_spec(jcfg.ocr, jcfg.env)
    jm = JPolicy(ocr_module=spec.module,
                 pooling_module=jcreate("Identity", spec.rep_dim, spec.num_slots,
                                        jcfg.pooling),
                 acnet_config=StaticConfig(jcfg.sb3_acnet), num_actions=4,
                 freeze_ocr=False)
    obs = np.random.default_rng(8).random((4, 5, 5)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), obs)["params"])
    assert set(params) == {"action_net", "value_net_out"}
    want_logits, want_values = jm.apply({"params": params}, obs)
    policy = build_policy(cfg, seed=0, device="cpu")
    assert len(policy.acnet.shared) == len(policy.acnet.policy) == len(policy.acnet.value) == 0
    fresh = policy.action_net.weight.detach().double()
    if cfg.sb3_acnet.ortho_init:   # rows orthonormal times the gain
        gram = fresh @ fresh.T
        torch.testing.assert_close(gram, 1e-4 * torch.eye(4, dtype=torch.float64))
        w = policy.value_net_out.weight.detach().double()
        torch.testing.assert_close(w.norm(), torch.ones((), dtype=torch.float64))
    policy.load_state_dict(from_flax(params))
    logits, values = policy(torch.from_numpy(obs))
    close(logits, want_logits)
    close(values, want_values)


def _singular_values(kernel) -> np.ndarray:
    return np.linalg.svd(np.asarray(kernel, np.float64), compute_uv=False)


def test_mlp_orthoinit_gains_match_jax():
    """``sb3_acnet=mlp_orthoinit``: the shared, policy and value layers start
    orthogonal with gain sqrt(2), the action head with 0.01 and the value
    head with 1.0 (ocrl_tpu/rl/ac_nets.py:28,66-70): every singular value
    of each kernel is its gain, on both sides, to 1e-5 relative; the
    biases are zero. The draws differ (two generators), so the gains are
    what is compared."""
    argv = ["ocr=gt", "pooling=identity", "sb3=ppo", "sb3_acnet=mlp_orthoinit",
            "env=push-N3C4S1S1", "env.render_mode=state"]
    jcfg = compose("train_sb3", argv)
    cfg = tcfg.compose(tcfg.TrainSB3Config(), argv).policy_config()
    from ocrl_tpu.models import build_spec

    spec = build_spec(jcfg.ocr, jcfg.env)
    jm = JPolicy(ocr_module=spec.module,
                 pooling_module=jcreate("Identity", spec.rep_dim, spec.num_slots,
                                        jcfg.pooling),
                 acnet_config=StaticConfig(jcfg.sb3_acnet), num_actions=4,
                 freeze_ocr=False)
    obs = np.zeros((1, 5, 5), np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), obs)["params"])
    state = {k: v.numpy() for k, v in build_policy(cfg, seed=0, device="cpu").state_dict().items()}
    gains = {"acnet.shared.0": math.sqrt(2), "acnet.shared.1": math.sqrt(2),
             "acnet.policy.0": math.sqrt(2), "acnet.value.0": math.sqrt(2),
             "action_net": 0.01, "value_net_out": 1.0}
    assert set(from_flax(params)) == set(state) == {f"{k}.{w}" for k in gains
                                                    for w in ("weight", "bias")}
    for layer, gain in gains.items():
        for side in (state, {k: v.numpy() for k, v in from_flax(params).items()}):
            np.testing.assert_allclose(_singular_values(side[f"{layer}.weight"]), gain,
                                       rtol=1e-5, err_msg=layer)
            assert not side[f"{layer}.bias"].any()


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("name", POOLINGS)
def test_pooling_config_matches_the_yaml(name):
    """Each pooling group's dataclass holds its YAML with _base.yaml, read
    by the port's own reader and by the JAX compose."""
    port = _plain(dataclasses.asdict(tcfg.GROUPS["pooling"][name]))
    assert port == _plain(tcfg.compose_file(tcfg.CONFIG_DIR / "pooling" / f"{name}.yaml"))
    assert port == _plain(configs(name)[0].to_dict())


@pytest.mark.parametrize("name", ACNETS)
def test_acnet_config_matches_the_yaml(name):
    port = _plain(dataclasses.asdict(tcfg.GROUPS["sb3_acnet"][name]))
    assert port == _plain(tcfg.compose_file(tcfg.CONFIG_DIR / "sb3_acnet" / f"{name}.yaml"))
    argv = ["ocr=gt", "pooling=transformer", "sb3=ppo", f"sb3_acnet={name}",
            "env=target-N4C4S3S1"]
    assert port == _plain(compose("train_sb3", argv).sb3_acnet.to_dict())
