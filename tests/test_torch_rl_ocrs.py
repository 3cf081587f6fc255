"""The RL path of the other OCRs and poolings: PPO updates against JAX, and
the entry points on the CPU.

- One PPO minibatch update of 4, then a second, end to end and with the OCR
  frozen, at small widths, against the JAX ``_update`` on the same weights,
  minibatches and (for IODINE) noise, held by ``test_torch_rl.Pair.check``:
  loss metrics to 1e-5 of max(|value|, 1), parameters to 1e-5 of max(the
  leaf's largest entry, 1e-2), Adam's moments to 1e-5 of the model's
  largest. Setups: NatureCNN + Identity + identity_orthoinit, MultipleCNN
  (K = 3) + Transformer (ape), VAE + MLP, MAE tiny + Transformer, IODINE
  narrow + Transformer. One exception, stated with its cause: in the
  MultipleCNN setup one entry of the pooling's projection bias has a
  gradient of 9e-5 before the global-norm clip, about Adam's eps 1e-5
  after it, where Adam's first step g / (|g| + eps) has a slope of 2.8e4:
  fp32 rounding of 3.5e-8 in that entry (sums of terms of 0.6) moves the
  parameter by 3e-7, three times the 1e-5 x 1e-2 the floor allows. Its
  parameters are held with a floor of 5e-2 (so 5e-7), its metrics and
  moments by the common rule;
- a VAE-row and an IODINE-row agent of for_running.json through ``save`` /
  ``load`` and ``evaluate_policy`` (``train_sb3.main`` on each row, and A2C
  on the VAE row, are in tests/test_torch_rl_ocr_rows.py).
"""

import numpy as np
import pytest
import torch

from ocrl_tpu_torch import config as tcfg
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.rl import PPO, build_policy, evaluate_policy, make_vec_env

from test_torch_rl import PARAM_FLOOR, Pair, rollout
from test_torch_rl_ocr_rows import row_argv

ADAM_EDGE_FLOOR = 5e-2       # see the module docstring
# OCR parameters without gradient on the policy's path: MAE's mask token and
# the VAE's log-variance head feed only their losses; with 2 iterations
# IODINE's one refinement step sees the LSTM's zero initial h
UNREAD = {"ocr_module.mask_token", "ocr_module.var.weight", "ocr_module.var.bias",
          "ocr_module.refine.lstm.hh.weight"}
POOL_SMALL = ["pooling.d_model=32", "pooling.nhead=4"]
SETUPS = {   # JAX overrides (the port composes the same), obs shape
    "naturecnn-identity": (["ocr=naturecnn", "ocr.rep_dim=32", "pooling=identity",
                            "sb3_acnet=identity_orthoinit"], 64),
    "multiple_cnn-transformer": (["ocr=multiple_cnn", "ocr.num_modules=3", "ocr.rep_dim=32",
                                  "pooling=transformer", "pooling.pos_emb=ape",
                                  "sb3_acnet=mlp"] + POOL_SMALL, 64),
    "vae-mlp": (["ocr=vae", "ocr.latent_dim=32", "pooling=mlp", "pooling.dims=[32,32]",
                 "sb3_acnet=mlp"], 16),
    "mae-transformer": (["ocr=mae", "ocr.vit_size=tiny", "ocr.patch_size=4",
                         "pooling=transformer", "sb3_acnet=mlp"] + POOL_SMALL, 16),
    "iodine-transformer": (["ocr=iodine_large", "ocr.slot_size=8", "ocr.num_iterations=2",
                            "ocr.ref_cnn_hidden_size=16", "ocr.ref_mlp_hidden_size=32",
                            "ocr.dec_cnn_hidden_size=16", "pooling=transformer",
                            "sb3_acnet=mlp"] + POOL_SMALL, 16),
}


def setup_tuple(name):
    argv, size = SETUPS[name]
    argv = argv + ["sb3=ppo", "env=target-N4C4S3S1", f"env.obs_size={size}"]
    port = lambda: tcfg.compose(tcfg.TrainSB3Config(), argv).policy_config()  # noqa: E731
    return argv, port, (size, size, 3), True


def iodine_noise(n):
    return np.random.default_rng(4).standard_normal((2, n, 6, 8)).astype(np.float32)


@pytest.mark.parametrize("freeze", [False, True], ids=["e2e", "frozen"])
@pytest.mark.parametrize("name", SETUPS)
def test_ppo_minibatch_updates_match_jax(name, freeze):
    noise = iodine_noise(4) if name.startswith("iodine") else None
    pair = Pair(setup_tuple(name), freeze=freeze, noise=noise, batch_size=4)
    data = rollout(8, pair.obs_shape, pair.is_image, seed=1)
    idx = np.random.default_rng(2).permutation(8).reshape(2, 4)
    floor = ADAM_EDGE_FLOOR if name.startswith("multiple_cnn") else PARAM_FLOOR
    for i in range(2):
        pair.check(pair.port_update(data, idx[i]), pair.jax_update(data, idx[i]), floor)
    after = pair.t.policy.state_dict()
    moved = {k for k in after if not torch.equal(after[k], pair.start[k])}
    ocr = {k for k in after if k.startswith("ocr_module.")}
    if freeze:
        assert not moved & ocr and moved      # the OCR bitwise unchanged
    else:   # every OCR parameter whose gradient is not zero by construction moved
        assert ocr - UNREAD <= moved


@pytest.mark.parametrize("name", ["vae-mlp-0.01ent_coef", "iodine-transformer-0.01ent_coef"])
def test_frozen_agents_save_load_and_evaluate(name):
    """An agent of the row (the committed encoder, frozen; full width) takes
    an update, is saved in memory, takes another and is loaded back; then
    evaluate_policy plays it (episodes cut to 3 steps)."""
    cfg = tcfg.compose(tcfg.TrainSB3Config(), row_argv(name) + ["env.max_steps=3"])
    algo = PPO(build_policy(cfg.policy_config(), seed=0, device="cpu"), (64, 64, 3), True, 2,
               tcfg.PPOConfig(batch_size=2), device="cpu")
    batch = rollout(4, (64, 64, 3), True, seed=3)
    batch["obs"] = np.stack([make_env(cfg.env, i).reset() for i in range(4)])
    data = algo.upload(batch)
    algo.update_minibatch(data, torch.arange(2))
    saved = algo.save()
    algo.update_minibatch(data, torch.arange(2, 4))
    algo.load(saved)
    for k, v in algo.policy.state_dict().items():
        assert torch.equal(v, saved["policy_params"][k]), k
    assert algo.optimizer.count == 1
    env = make_vec_env(make_env, cfg.env, 2, seed=5, mode="dummy")
    try:
        metrics = evaluate_policy(algo, env, n_episodes=2)
    finally:
        env.close()
    assert 0 <= metrics["success_rate"] <= 1 and 0 < metrics["mean_ep_length"] <= 3
