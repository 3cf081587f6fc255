#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py             # from the root of a checkout
    python3 chip_smoke.py --profile   # also print a device-time breakdown

Phases, each printing its own line with its seconds:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source of the port, with nvcc, in parallel; each
   kernel's registers and spill bytes from ptxas -v (a spill fails the run);
3. kernels: each kernel against its plain torch version on the card, at the
   shapes of the serving and the training paths plus other supported ones,
   with its device time (torch.profiler; CUDA events where a profiler
   session twice records no kernel), the plain version's and the card's
   bound for the same work; B3 and B4 launched twice on the same inputs
   must give bitwise-equal outputs; the Gumbel kernels' drawn fields against
   their exact numpy replay (ops.gumbel.replay_field, from the seed the
   wrapper drew) and the Gumbel distribution, B2's id frequencies against
   the softmax, and B2 on rows with NaN against its plain version (the
   first NaN's index); B1 and B2 are also timed beside one PyTorch call
   each that computes the same function with its own noise
   (F.gumbel_softmax, Categorical(logits).sample()); B1 and B2 with a row
   offset (row0, a data-parallel rank's rows): the field drawn equals rows
   [row0, row0 + R) of the replay at row0 + R rows; the heads kernels
   (B3 and B4 for more heads, more than 16 slots or other widths:
   slot_routing_heads_fwd / _bwd) at HEADS_SHAPES, each against its plain
   version with its bound and a second launch bitwise equal, after the plan
   each C entry chooses there (tile, stages, lanes, chunk, column items and
   token groups or the scratch variant; slot_routing_heads_plan), which
   must equal the wrapper's mirror;
4. serving: the full-width slate-transformer policy (seed 0) answers
   PPO.predict requests at 16 and at 64 observations; the launch counts are
   reset just before and read just after, and two requests are checked
   against the same policy with every kernel replaced by its plain version;
5. training: the full-width SLATE OCR (seed 0) takes pretraining steps on
   uint8 batches of 24 through OCR.update_many, timed, with the launch
   counts reset just before and read just after; one step is checked
   against the same model with every kernel replaced by its plain version,
   fed the Gumbel fields the kernels drew; and the loss on one fixed batch
   falls;
6. amp: train_ocr ocr=slate ocr.amp=bf16 (slate.yaml, the conv stacks in
   bf16 with fp32 parameters and loss) at the same width and batch: one
   step of SLATE and one of Slot-Attention at batch 4 against the CPU's bf16
   and fp32 steps on the same weights and draws (check_amp_step: each
   metric and gradient no farther from fp32 than twice the CPU bf16 run's,
   conv blocks bf16 on both bf16 sides, Adam's first step replayed); then 4 warm-up
   steps, during which every conv block must output bf16, and 20 timed
   steps of update_many (k = 4), ms a step beside the training phase's fp32
   reading, the loss on the fixed batch lower; one Slot-Attention update and
   one get_loss with masks; each with the launch counts reset just before
   and read just after and held exactly. --profile adds the convolutions'
   device time a step, fp32 and bf16;
7. evaluation: the full-width SLATE OCR (seed 0, get_ocr without a
   checkpoint) scores batches of 32 painted scenes with their masks through
   get_ari_mse.evaluate (foreground ARI of the loss, then the greedy KV-cached
   gen_imgs MSE): one warm-up batch, then timed batches with the launch
   counts reset just before and read just after; one batch is checked
   against the same model with every kernel replaced by its plain version
   (loss metrics, the ARI's label maps, the greedy tokens); then the
   Slot-Attention OCR (use_bcdec) scores one batch, with its launch counts,
   against its plain version;
8. rl-training: train_sb3.train of the slate-transformer-0.01ent_coef row
   (ocr=slate pooling=transformer sb3=ppo sb3_acnet=mlp env=target-N4C4S3S1
   sb3.algo_kwargs.ent_coef=0.01, no OCR checkpoint: end to end; full
   widths, random weights from seed 0) for one PPO iteration at the
   config's own num_envs 4, n_steps 2048, batch_size 32, n_epochs 10: 512
   rollout steps, the bootstrap value, then 640 minibatch updates, with
   the launch counts reset just before and read just after (B3 exactly
   3 x 1153, B4 exactly 3 x 640); the iteration's seconds, env steps/s,
   ms per policy call at E = 4 and per minibatch update; one minibatch
   update against the same policy on the plain sweep, fed the same
   minibatch and slot noise; then 10 updates with the OCR frozen (no B4,
   the OCR bitwise unchanged); then evaluate_policy on 20 envs for 20
   episodes (B3 three times a policy call);
9. agent-evaluation: test_sb3 on the committed GT-Transformer agent
   artifacts/rl/GT-Transformer-PPO-OddOneOutN4C2S2S1Env-final (the slice of
   seed 1234) for 100 episodes on 20 envs, its success rate beside the
   manifest's value for that seed (a sanity band, not a condition); the
   condition: its logits and values on 64 env states agree between the
   card and the CPU;
10. other-ocrs: train_sb3.train of each of the seven rows of
   for_running.json with the other OCRs (e2e cnn, e2e cnnfeat-transformer,
   multiple cnn-transformer, vae-mlp, mae-patch-transformer, mae-cls-mlp,
   iodine-transformer; target-N4C4S3S1, full widths, random weights from
   seed 0; the VAE and IODINE rows load artifacts/encoders and are frozen,
   the others run end to end) for one PPO iteration at num_envs 4 and
   batch 32, its depth cut to n_steps 256 and 2 epochs: its seconds, env
   steps/s, ms a policy call at E = 4 and an update, finite metrics, no
   kernel launched; each policy's logits and values on 8 env frames, card
   against CPU (IODINE on the same numpy noise), with each side's distance
   from a float64 run on the CPU; RN, MLP, Identity, CNN_Linear and
   CNN_Transformer (on a 64x64 grid of 8-wide slots) and the Transformer's
   push embedding, card against CPU; one end-to-end IODINE update of 32;
11. pretraining: VAE (vae.yaml), MAE-base (mae.yaml, its lr x 24 / 256 by
   train_ocr's rule) and IODINE-large (iodine_large.yaml, 2-norm clip 5.0),
   full width, seed 0, through create_ocr and OCR.update_many (k = 4) on
   uint8 batches of 24 painted scenes: one step card against CPU at batch 4
   on the same weights and numpy noise (loss, metrics, norm, gradients,
   every parameter), 12 steps of warm-up after which the loss on the batch
   with fixed noise is lower than before, then windows of 20 timed steps,
   3 s in all (ms a step as the median window and its spread, images/s,
   finite metrics); then get_ari_mse.evaluate of IODINE-large
   on 2 batches of 32 painted scenes with masks (ari, mse, ms a batch), one
   batch card against CPU; no kernel launched in the phase;
12. train-ocr: the port's collector on env=random-N5C4S4S2 (64x64x3, 5
   objects, masks on): 1536 training and 64 validation images on up to 8
   forked workers, images/s, the file read back through the port's HDF5
   reader bitwise equal to what the workers return; then train_ocr.main
   ocr=slate at full width (seed 0) on that file, batch 24, superbatch 4,
   log_interval 8, eval_interval 32, max_steps 64 (one epoch), with the
   launch counts reset just before and read just after: train/* finite once
   for every step, val/* at 32 and twice at 64, model_32 / model_64 /
   model_latest / model_best, every sample PNG decoded (CRC and zlib
   checked), B1-B4 launched exactly as the steps, the validation batches
   and the sample passes predict; the loop's images/s over steps 16-64
   without the evaluations, beside update_many alone on the same
   superbatches; then the run resumed to max_steps 96 from its
   model_latest: it starts at step 64 with parameters and Adam moments
   bitwise those saved, and ends at 96; its model_latest.ckpt is kept for
   the next phase;
13. multi-seed: the README's benchmark protocol (README.md:39-41) at full
   SLATE width: train_sb3 ocr=slate pooling=transformer sb3=ppo
   sb3_acnet=mlp env=target-N4C4S3S1 sb3.algo_kwargs.ent_coef=0.01
   seeds=1234,2345,3456 pipeline_rollout=True cache_frozen_reps=True on the
   train-ocr phase's SLATE checkpoint (frozen), cut to num_envs 16 a seed,
   n_steps 1024 a seed, 2 epochs, one iteration (each cut printed), one GIF
   of 32 frames and one evaluation; then resumed from its
   latest_model.ckpt for one more iteration (the state loaded bitwise the
   file's and the first run's), then test_sb3 seeds= with 16 episodes a
   seed: files, per-seed metric names, finite values, three seeds, the GIF's
   blocks walked; B3 launched num_iterations times per vmapped policy,
   value and encode call whatever S, B4 never (frozen). Before that, B3
   and B4 under the vmap rule (one launch for three seeds) against the
   plain sweep, B3 at B = 6 (a rollout bucket: 2 envs a seed), 48 and 384,
   B4 at 96, bitwise repeatable, timed beside their bounds; after it, the
   vmapped call at S x E = 48 and at a bucket timed, and one end-to-end
   vmapped update of the three seeds against three single-seed PPO updates
   (B3 and B4 launched num_iterations times in all; the tolerances in
   check_vmapped_update);
14. sac: train_sb3 ocr=slate pooling=transformer sb3=sac sb3_acnet=mlp
   env=cw-target-N4C4S1S1 env.use_fake_sim=true at full width (seed 0,
   end to end) with configs/sb3/sac.yaml as it is (4 forked envs, batch
   256, learning_starts 1000, a 1e6-row buffer), cut to max_steps 1256
   (250 random vector steps, then 64 policy calls and 65 updates), one
   evaluation of 20 episodes on 20 envs and a GIF of 32 frames: launches
   exactly B3 3 x (policy and evaluation calls) + 9 x updates, B4 3 x
   updates; env steps/s of the random and the learning parts, ms an update,
   the buffer's resident bytes, the files; the run resumed from its
   latest_model bitwise; ms a policy call at E = 4; one update at 256
   against the plain sweep (check_sac_update); a frozen run on the
   train-ocr phase's SLATE file (1040 steps, seed 1: no B4, the online OCR and
   the pooling bitwise unchanged, the target OCR bitwise its random init
   moved by the run's Polyak steps); B3 and B4 at B = 256 against the plain
   sweep, bitwise repeatable, timed beside their bounds; the CausalWorld
   collector (--fake-sim, 256 + 64 images) read back bitwise;
15. probes: the port's collector on env=target-N4C4S3S1 with labels and
   states (1024 + 256 images); train_property_predictor.main ocr=slate
   (mlp3 head, batch 24, one epoch: 42 steps and 11 validation batches) and
   train_classifier.main ocr=slate pooling=transformer (batch 128, one
   epoch: 8 steps and 2 validation batches), both at full SLATE width on
   the train-ocr phase's checkpoint, with the launch counts reset just
   before and read just after each (B3 exactly 3 a step and a validation
   batch, nothing else): ms a step and images/s from step 5 on, the host
   matching's ms a step, the validation metrics, the property probe's file
   reloaded bitwise; then card against CPU on the same weights, batch and
   noise: one property update at 24 (matched columns equal; metrics, head
   and Adam moments), one classifier step at 128 (the parameters held to
   PROBE_TOL where a float64 replay of the CPU step makes an entry sure, the
   rest to Adam's bound; at most MOVED_SHARE of a leaf may leave the fp32
   rule's sure entries: sure_entries), and one aux-loss Pooling
   call at 24 (dropout 0; B1's and B2's fields replayed from their seeds by
   ops.gumbel.replay_field for the CPU); B3 at B = 128 against the plain
   sweep, bitwise repeatable, timed beside its bound. --profile adds the
   tables of 5 property updates at 24 and 3 classifier steps at 128;
16. ddp: data parallelism (ocrl_tpu_torch.parallel), two ranks on the one
   card with the gloo backend (NCCL refuses two ranks on one device),
   spawned with a file:// store in a temporary directory: each makes the
   full-width SLATE OCR from its own seed, shard_ocr gives both rank 0's
   state, and each takes 12 rows of a global batch of 24 painted scenes:
   two updates (the second with masks), update_many of k = 4, get_loss with
   masks, get_samples, a save on rank 0 loaded by both, one more update,
   then one Slot-Attention (use_bcdec) update, with the launch counts reset
   just before and read just after (B1 1, B2 1, B3 3, B4 3 a step); against
   the same calls in one process at 24 from the same state with no
   injected noise (each rank draws its rows of one process's draws: the
   kernels through row0), cuDNN deterministic on both sides for the
   comparison (not for the times): every metric to STEP_LOSS_RTOL; the
   first step's gradients by compare_grads and the parameters after it by
   first_step_gap's rule (the Slot-Attention update's too); then the one
   process loads the file rank 0 saved (its state, Adam's moments too, must
   be bitwise the ranks'), and the last update starts from that one state:
   its gradients by compare_grads, each side's parameters after it against
   Adam replayed in float64 from that side's state and gradients, to
   float32's rounding (adam_replay_gap; at a later step Adam is no longer
   sign-like, so first_step_gap's rule does not hold there); the sample
   grid within 1 of one process's, over 99 % of it equal; the ranks'
   parameters bitwise equal after every step; ms an update of two ranks and
   of one process at 24; then one NCCL rank (world 1) whose update is
   bitwise one process's;
17. hdf5-eval: HDF5 files that h5py wrote (tests/data/hdf5, committed with
   their manifest; the card's machine has no h5py): every dataset of every
   fixture read by the port, its SHA-256 the manifest's; eval-gzip.h5
   (random-N5C4S4S2 rendered by the collector with masks, 240 + 256
   images, gzip and shuffle at h5py's chunks) and its contiguous twin,
   written here by the port's writer from the decoded arrays; read_slice
   images/s in batches of 32 from a fresh reader (gzip, the twin's memmap,
   LZF with fletcher32), and the chunked decode alone; then
   python -m ocrl_tpu_torch.get_ari_mse's main (ocr=slate and
   ocr=slotattention at full width, weights from seed 0 saved as the
   checkpoint it loads, batch 32: 8 batches) on the gzip file and on the
   twin, after one warm-up run on lzf-fletcher32.h5: launches exactly B1 8,
   B2 8, B3 48 (Slot-Attention B3 24), eval/ari and eval/mse logged at step
   0, ms a batch, images/s, the loader's read_slice seconds and the loop's
   waits for a batch against the wall; gzip against the twin to
   EVAL_RTOL, and every batch the CLI's loader read (obss with its masks)
   bitwise the twin's; then the chunked TrainingSet's shuffled batches bitwise the
   twin's, and train_ocr.main ocr=slate on eval-gzip.h5 for 8 steps at 24
   with its final evaluation, launches exactly as the train-ocr phase counts
   them;
18. slot-shapes: train_ocr ocr=slate past the single-head kernels' range,
   at full width on eval-gzip.h5 (N = 4096), batch 24, superbatch 4, 8 steps
   with the final evaluation, in two configurations (SLOT_SHAPES):
   slate-heads4 (ocr.slotattr.num_slot_heads=4: 5 slots in 4 heads of 48)
   and slate-slots24 (24 slots of 256, mlp_hidden_size 256); for each one
   update against the same update through the plain versions (check_step),
   ms a step and images/s over the last superbatch, launches exactly B1 and
   B2 once a step and a validation batch (B1 a sample pass too), the heads
   forward 3 and backward 3 a step and the forward 3 a validation batch and
   a sample pass; for slate-heads4 also get_ari_mse's command line on its
   checkpoint over one batch of 32 (B1 1, B2 1, heads forward 6) and one
   slot-attention forward at 24 through fused=never (JAX's einsum route, no
   launch) against the kernel route, within NEVER_TOL, each route's device
   ms beside the other's.

Then one JSON line of the kernels and, last, the contract line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
ocrl_tpu_torch package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ocrl_tpu_torch import (get_ari_mse, test_sb3, train_classifier, train_ocr,
                            train_property_predictor, train_sb3)
from ocrl_tpu_torch.config import (GROUPS, EnvConfig, IodineConfig, OCRCheckpointConfig,
                                   OCRConfig, PolicyConfig, TestSB3Config,
                                   TrainClassifierConfig, TrainOCRConfig,
                                   TrainPropertyPredictorConfig, TrainSB3Config, compose)
from ocrl_tpu_torch.config import read_dataset_config, read_env_config
from ocrl_tpu_torch.config import replace as config_replace
from ocrl_tpu_torch.data import DataLoader, H5Dataset
from ocrl_tpu_torch.data.collect import collect_chunks, collect_dataset
from ocrl_tpu_torch.data.hdf5 import ChunkRows, read_array
from ocrl_tpu_torch.data.hdf5_format import create, read_layout
from ocrl_tpu_torch.envs import make_env
from ocrl_tpu_torch.get_ari_mse import batches_of, evaluate
from ocrl_tpu_torch.models import create_ocr
from ocrl_tpu_torch.models.base import OCR, normalize_obs
from ocrl_tpu_torch.models.common import Conv2dBlock
from ocrl_tpu_torch.models.slate import GROUP_OF
from ocrl_tpu_torch.ops import LAUNCHES, build, gumbel, reset_launches, slot_routing
from ocrl_tpu_torch.ops._build import build_log, ptxas_usage, sources
from ocrl_tpu_torch.poolings import create_pooling_module
from ocrl_tpu_torch.rl import PPO, build_policy, evaluate_policy, make_vec_env
from ocrl_tpu_torch.rl.multi_seed import bucket_envs
from ocrl_tpu_torch.train_ocr import pretraining_config
from ocrl_tpu_torch.utils import checkpoint as ckpt
from ocrl_tpu_torch.utils import png
from ocrl_tpu_torch.utils.checkpoint import get_ocr
from ocrl_tpu_torch.utils.metrics import mask_labels

# kernel vs plain, per output: max |kernel - plain| <= SWEEP_TOL * max |plain|.
# Both are fp32; the sums over D and over the tokens run in another order,
# so the error scales with the magnitude of what is summed, not of each entry.
SWEEP_TOL = 1e-5
POLICY_TOL = dict(rtol=1e-4, atol=1e-4)  # whole policy: the recurrence carries them on
# B1: y in [0, 1] from expf and a reordered row sum against torch's exp and
# sum, a few ulps. B2: the same fp32 sums logits + g on both sides, so the
# ids agree exactly.
SOFT_TOL = 1e-5
# A kernel's field against its numpy replay in float64, every value: g runs
# up to 16.64, where an fp32 ulp is 1.9e-6, so about five ulps there; a log
# taken naively near u = 1 errs by O(1) exactly at the largest g.
FIELD_TOL = 1e-5
# A drawn Gumbel field of n values: its mean (Euler's gamma) and variance
# (pi^2 / 6) within 8 standard errors, 1.2825 / sqrt(n) for the mean and
# 3.45 / sqrt(n) for the variance (excess kurtosis 2.4): at the training
# shape's 25.2 M draws, 2.0e-3 and 5.5e-3.
GUMBEL_MEAN, GUMBEL_VAR = 0.5772156649015329, float(np.pi ** 2 / 6)
GUMBEL_SIGMAS = 8.0
FREQ_TOL = 0.01      # id frequencies over 65536 draws, 4-5 standard errors
# One training step, kernels against plain versions fed the same fields and
# dropout masks: the loss to 1e-5 relative; each gradient to 1e-3 of its
# own largest entry plus 1e-6 of the model's largest (fp32 sums reordered
# through the 3-iteration recurrence and cuDNN's backward algorithms); the
# parameters' change over the group's lr to 1e-2 where the plain gradient
# exceeds 1e-6, i.e. 100 x Adam's eps (below that, Adam's first step
# g / (|g| + eps) turns rounding of the gradient into any value in [-1, 1]).
STEP_LOSS_RTOL, STEP_GRAD_TOL, STEP_GRAD_FLOOR, STEP_MOVE_TOL = 1e-5, 1e-3, 1e-6, 1e-2
# One evaluation batch, kernels against plain versions fed the same draws:
# the loss metrics to 1e-5 relative (as the training step); the ARI's label
# maps equal except at pixels where an attention lies within 1e-6 of 1.0
# (there attention * foreground may tie the foreground's 1.0, and rounding
# picks the side); greedy tokens equal in each row up to the first position
# where the plain side's two largest logits lie within 1e-4 (there rounding
# may pick either token, and every later token follows from it).
EVAL_RTOL, ARI_SATURATION, GEN_GAP = 1e-5, 1e-6, 1e-4
# One PPO minibatch update, kernels against the plain sweep fed the same
# minibatch and slot noise: loss metrics to 1e-5 of max(|value|, 1) (means of
# O(1) terms that cancel); parameters to 1e-5 of max(the leaf's largest
# entry, 1e-2): zero-initialised biases hold only their Adam step of about
# lr, and Adam turns rounding of a gradient entry near its eps 1e-5 into a
# few 1e-5 of a step (as tests/test_torch_rl.py holds the port to JAX).
# The GT agent, card against CPU: 1e-5 of max(|value|, 1).
RL_TOL, RL_METRIC_FLOOR, RL_PARAM_FLOOR = 1e-5, 1.0, 1e-2
# The vmapped update against single-seed updates on the card: the folded
# launches (B3 and B4 at S x 32 rows) and cuDNN's grouped convolutions sum in
# other orders than the single-seed calls, and Adam's first step g / (|g| +
# eps) is linear in g below its eps: there a gradient entry's rounding moves
# the parameter by lr x (its error) / eps, up to 2.4 x RL_TOL of the leaf
# (an H100, entries with |g| of 1e-7 to 2e-6). Parameters are held to RL_TOL
# where the gradient reaches Adam's eps, and every entry to 2 lr (no step of
# either side exceeds lr); the moments, which carry the gradients, to RL_TOL
# of their largest entry.
ADAM_EPS = 1e-5
RL_ARGV = ["ocr=slate", "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
           "env=target-N4C4S3S1", "sb3.algo_kwargs.ent_coef=0.01", "max_steps=2048",
           "run_dir=outputs/chip_smoke/train_sb3"]
RL_FROZEN_UPDATES, RL_EVAL_ENVS, RL_EVAL_EPISODES, RL_ACT_CALLS = 10, 20, 20, 50
AGENT = "artifacts/rl/GT-Transformer-PPO-OddOneOutN4C2S2S1Env-final"
AGENT_ARGV = ["ocr=gt", "pooling=transformer", "pooling.num_layers=3", "sb3=ppo",
              "sb3_acnet=mlp", "env=odd-one-out-N4C2S2S1", f"agent_checkpoint.file={AGENT}",
              "agent_checkpoint.index=0", "n_eval_episodes=100"]
AGENT_CELL, AGENT_STATES = "GT-PropertyComparison", 64    # round5_rl_evals.json
# The other OCRs' rows of for_running.json, at full width, random weights
# from seed 0, one PPO iteration each at the config's num_envs 4 and batch 32,
# its depth cut to n_steps 256 (64 vector steps) and 2 epochs (16 updates).
# The VAE and IODINE rows load the committed encoders (frozen); the repo holds
# no MAE or NatureCNN checkpoint, so those rows run end to end.
OTHER_ROWS = ["e2e cnn 0.01ent_coef", "e2e cnnfeat-transformer 0.01ent_coef",
              "multiple cnn-transformer 0.01ent_coef", "vae-mlp-0.01ent_coef",
              "mae-patch-transformer-0.01ent_coef", "mae-cls-mlp-0.01ent_coef",
              "iodine-transformer-0.01ent_coef"]
OTHER_ENV, OTHER_CHECKPOINTS = "env=target-N4C4S3S1", ("vae.ckpt", "iodine.ckpt")
OTHER_DEPTH = ["sb3.algo_kwargs.n_steps=256", "sb3.algo_kwargs.n_epochs=2", "max_steps=256"]
OTHER_CHECK = 8
# Card against CPU, the same weights and inputs: 1e-5 of max(|value|, 1) for
# the rows without IODINE and for the poolings (fp32 sums of cuDNN/cuBLAS
# against the CPU's, as for the GT agent); IODINE 1e-4: on the CPU each fp32
# side lies up to 1.2e-4 of the masks' scale from a float64 run
# (tests/test_torch_ocrs.py), and the run prints each side's distance from
# float64 here as well.
OTHER_TOL, IODINE_CARD_TOL = 1e-5, 1e-4
# The pretraining phase: VAE (vae.yaml), MAE-base (mae.yaml, its lr scaled by
# train_ocr's rule at batch 24) and IODINE-large (iodine_large.yaml), full
# width, seed 0, on uint8 batches of TRAIN_BATCH painted scenes through
# update_many at k = TRAIN_K, all on one batch: PRETRAIN_FALL steps (the
# warm-up), after which its loss on fixed noise must be lower; then windows
# of TRAIN_STEPS timed steps, at least PRETRAIN_WINDOWS of them and
# PRETRAIN_SECONDS in all, reported as the median window and its spread.
PRETRAIN_OCRS = ("vae", "mae", "iodine_large")
PRETRAIN_FALL, PRETRAIN_WINDOWS, PRETRAIN_SECONDS, PRETRAIN_CHECK = 12, 3, 3.0, 4
# One pretraining step card against CPU at batch PRETRAIN_CHECK, the same
# weights and numpy noise: the loss, each metric and norm to 1e-5 of
# max(|value|, 1) (IODINE to IODINE_CARD_TOL: on the CPU a float32 step lies
# 1.2e-6 from float64 in its norm, and its forward is ill-conditioned at full
# width, tests/test_torch_ocrs.py); each gradient as STEP_GRAD_TOL /
# STEP_GRAD_FLOOR; every parameter after the step to 1e-5 of max(|leaf|,
# 1e-2) where the CPU's gradient exceeds PRETRAIN_SURE of its leaf's largest
# and STEP_GRAD_FLOOR of the model's. Adam's first step g / (|g| + eps) moves
# by at most a quarter of the gradient's relative error, so it is as sure as
# the gradient; an entry far below those scales keeps mostly rounding (MAE's
# attention key biases, zero in exact arithmetic, lie near 1e-9 of the
# model's largest), and there each side's change is held to Adam's bound,
# lr x (1 + weight_decay x |p|). On the CPU a float32 step lies at most
# 3.7e-7 of max(|leaf|, 1e-2) from float64 on the sure entries of the three
# models, at batch 4 with these seeds.
PRETRAIN_TOL, PRETRAIN_SURE = 1e-5, 1e-4
# The train-ocr phase: the port's collector on OCR_ENV with masks, OCR_TRAIN
# training and OCR_VAL validation images (one epoch of 64 steps of 24, three
# validation batches), then train_ocr.main at full width on that file to
# OCR_STEPS and, resumed, to OCR_RESUMED; the loop's images/s over the steps
# OCR_TIMED, evaluations left out.
OCR_ENV, OCR_TRAIN, OCR_VAL, OCR_WORKERS = "random-N5C4S4S2", 1536, 64, 8
OCR_ARGV = ["ocr=slate", f"dataset={OCR_ENV}", "batch_size=24", "superbatch=4",
            "log_interval=8", "eval_interval=32"]
OCR_STEPS, OCR_RESUMED, OCR_TIMED = 64, 96, (16, 64)
# The multi-seed phase: the README's protocol (README.md:39-41) at full SLATE
# width on the train-ocr phase's SLATE checkpoint, frozen, cut as MS_CUTS
# says (num_envs 64 -> 16 a seed, n_steps 2048 -> 1024 a seed, n_epochs
# 10 -> 2, one iteration, then one more resumed); one GIF of MS_VIDEO_FRAMES
# frames, one evaluation at the end of the rollout; then test_sb3 seeds= with
# MS_TEST_EPISODES episodes a seed. The vmapped sweeps at the phase's shapes:
# S x 2 (a rollout bucket's policy call: 16 envs a seed in 8 buckets), S x E
# (values and evaluation), S x 128 (an encode chunk), S x 32 (an update).
MS_SEEDS = [1234, 2345, 3456]
MS_STEPS, MS_ENVS, MS_CHUNK, MS_BATCH, MS_VIDEO_FRAMES, MS_TEST_EPISODES = \
    1024, 16, 128, 32, 32, 16
MS_SHAPE = (None, 4096, 5, 192)
MS_ARGV = ["ocr=slate", "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
           "env=target-N4C4S3S1", "sb3.algo_kwargs.ent_coef=0.01",
           f"seeds={','.join(map(str, MS_SEEDS))}", "pipeline_rollout=True",
           "cache_frozen_reps=True"]
MS_CUTS = [f"num_envs={MS_ENVS}", f"sb3.algo_kwargs.n_steps={MS_STEPS}",
           "sb3.algo_kwargs.n_epochs=2", f"max_steps={MS_STEPS}",
           f"video.length={MS_VIDEO_FRAMES}", "video.interval=100000000",
           f"eval.freq={MS_STEPS // MS_ENVS}", f"eval.n_episodes={MS_ENVS}"]
MS_TEST_ARGV = ["ocr=slate", "pooling=transformer", "sb3=ppo", "sb3_acnet=mlp",
                "env=target-N4C4S3S1", f"seeds={','.join(map(str, MS_SEEDS))}",
                f"n_eval_episodes={MS_TEST_EPISODES}"]
# SAC on the CausalWorld reach task (fake TriFinger backend), SLATE at full
# width end to end: configs/sb3/sac.yaml as it is (4 envs, batch 256,
# learning_starts 1000, buffer 1e6, tau, gamma, ent_coef); cut: max_steps to
# 1256 (250 random vector steps, then 64 policy calls and 65 updates), one
# evaluation of 20 episodes on 20 envs (at vector step 300), a GIF of 32
# frames. The frozen run: the train-ocr phase's SLATE file, 1040 steps (10
# policy calls, 11 updates), no evaluation, seed 1: that file's OCR began at
# seed 0's init and moved little in 96 steps, so the target's random OCR is
# drawn from another seed to lie far from the online one.
SAC_ARGV = ["ocr=slate", "pooling=transformer", "sb3=sac", "sb3_acnet=mlp",
            "env=cw-target-N4C4S1S1", "env.use_fake_sim=true"]
SAC_STEPS, SAC_GIF_FRAMES = 1256, 32
SAC_CUTS = [f"max_steps={SAC_STEPS}", "eval.freq=300", "eval.n_episodes=20",
            f"video.length={SAC_GIF_FRAMES}"]
SAC_FROZEN_CUTS = ["max_steps=1040", "eval.freq=100000", "video.length=8", "seed=1"]
SAC_CALLS, SAC_UPDATES, SAC_FROZEN_UPDATES, SAC_ACT_CALLS = 64, 65, 11, 50
SAC_COLLECT = ("cw-notarget-N4C11S1S1-hard", 256, 64)     # env, training, validation images
# The probes: the port's collector on PROBE_ENV with labels and states
# (PROBE_TRAIN + PROBE_VAL images: one epoch of 42 property steps at 24 and 8
# classifier steps at 128), then both entry points at full SLATE width on
# the train-ocr phase's checkpoint, one epoch each; the loops' ms a step from
# step PROBE_TIMED on. Card against CPU on the same weights, batch and
# noise: metrics, head and pooling leaves and Adam moments to PROBE_TOL of
# max(|x|, 1) (one fp32 forward of the encoder in another summation order,
# then one Adam step of lr 1e-4), matched columns exactly; the aux-loss
# Pooling call's pooled output and metrics the same.
PROBE_ENV, PROBE_TRAIN, PROBE_VAL, PROBE_TIMED, PROBE_TOL = \
    "target-N4C4S3S1", 1024, 256, 5, 1e-5
# The probes' first Adam steps: the float64 rule of sure entries may move at
# most this share of a leaf's entries out of the fp32 rule's sure ones.
MOVED_SHARE = 0.01
PROBE_PP_ARGV = ["ocr=slate", f"dataset={PROBE_ENV}", "batch_size=24", "max_epochs=1"]
PROBE_CL_ARGV = ["ocr=slate", "pooling=transformer", f"dataset={PROBE_ENV}",
                 "batch_size=128", "max_epochs=1"]
REQUESTS = 20
BATCHES = (16, 64)
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS, TRAIN_K = 24, 4, 20, 4
# The amp phase: slate.yaml with ocr.amp=bf16 (the conv stacks in bf16, fp32
# parameters, optimizer state and loss), timed as the training phase. One
# step of SLATE and one of Slot-Attention card against CPU at batch AMP_CHECK
# on the same weights and draws, dropout 0 (the card's and the CPU's
# generators draw other masks), by tests/test_torch_amp.py's gradient rule
# with the CPU's bf16 run where that file has JAX's, and the CPU's fp32 run
# of the same weights and draws as the reference r: each gradient leaf,
# unclipped, their inf-norm and each loss metric no farther from r than
# AMP_GRAD_C times the CPU bf16 run's distance, plus half a bf16 ulp of a
# gradient leaf's largest (a bf16 gradient is rounded once more) and 1e-7 of
# the model's largest, or 1e-5 of a metric's max(|r|, 1). That file holds
# JAX's and the port's loss metrics far tighter (within 0.05 of the bf16
# effect), since on the CPU both round the same sums alike; cuDNN's bf16
# convolutions round a share of their outputs the other way, and at full
# width that moves the loss as far as bf16 itself does (Slot-Attention at 4:
# card 45026.87, CPU bf16 45004.39, fp32 45044.91). That the card's step is
# bf16 at all is held by its conv blocks' output dtype, the CPU's bf16 and
# fp32 runs' too. The card may lie nearer r than the CPU: its index backward
# sums the broadcast decoder's (64 - 4)^2 duplicates of one tile entry in
# fp32, the CPU's in bf16. The card's parameters after the step are Adam's
# first step of its own clipped gradients (adam_replay_gap).
AMP_ARGV = ["ocr=slate", "ocr.amp=bf16"]
AMP_CHECK, AMP_GRAD_C, HALF_BF16_ULP = 4, 2.0, 2.0 ** -8
# The convolutions' device time: what runs under cuDNN's forward and
# backward ops, whatever algorithm cuDNN picks (implicit GEMM, Winograd, FFT,
# layout transforms); of it, the kernels that name bf16, among those whose
# names mark a convolution (forward, data and weight gradients)
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")
CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "implicit")
EVAL_BATCH, EVAL_BATCHES, EVAL_OBJECTS = 32, 4, 4   # configs/get_ari_mse.yaml: batch 32
# The hdf5-eval phase: the committed fixtures (tests/data/hdf5, written by
# h5py; make_fixtures.py), eval-gzip.h5's ValidationSet of HDF5_VAL images
# (8 batches of EVAL_BATCH) and TrainingSet of 240, the small files'
# ValidationSet of HDF5_SMALL_VAL; decode rates the median of
# HDF5_RATE_REPS passes; HDF5_TRAIN_STEPS train_ocr steps at 24.
HDF5_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "hdf5"
HDF5_VAL, HDF5_SMALL_VAL, HDF5_RATE_REPS, HDF5_TRAIN_STEPS = 256, 32, 5, 8
# The slot-shapes phase: train_ocr ocr=slate past the single-head kernels'
# range, each configuration with its PERF.md name, on eval-gzip.h5 (N = 4096)
# at batch 24 for SLOT_STEPS steps (superbatch 4); the kernels phase's heads
# shapes [B, N, S, H, D]; the fused=never slot-attention forward within
# NEVER_TOL of the kernel route's largest entry (fp32, the sums taken in
# another order through three GRU iterations: POLICY_TOL's 1e-4).
SLOT_SHAPES = {"slate-heads4": ["ocr.slotattr.num_slot_heads=4"],
               "slate-slots24": ["ocr.slotattr.num_slots=24", "ocr.slotattr.slot_size=256",
                                 "ocr.slotattr.mlp_hidden_size=256"]}
SLOT_STEPS, NEVER_TOL = 8, 1e-4
HEADS_SHAPES = [(24, 4096, 5, 4, 192), (24, 4096, 24, 1, 256), (24, 4096, 7, 1, 100),
                (2, 333, 32, 8, 512), (3, 37, 5, 3, 21)]

# Published rates (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s and fp32 FLOP/s outside the tensor cores.
CARD_RATES = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
              "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def card_rates(name: str) -> tuple[str, float, float]:
    for key, (bw, flops) in CARD_RATES.items():   # most specific names first
        if all(word in name for word in key.split()):
            return key, bw, flops
    raise SystemExit(f"no published rates for '{name}' in CARD_RATES")


def wall_ms(fn, reps: int = 50) -> float:
    """Time per call between CUDA events around many calls: device time,
    or the host's when it cannot keep the device fed."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, reps: int):
    """(wall seconds, torch.profiler key averages) over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof.key_averages()


def device_ms(averages, name_part: str = "") -> float | None:
    """Summed device time (ms) of the CUDA kernels whose name holds
    ``name_part``, or None where the profiler recorded none of them."""
    from torch.autograd import DeviceType

    us = sum(e.self_device_time_total for e in averages
             if e.device_type == DeviceType.CUDA and name_part in e.key
             and not getattr(e, "is_user_annotation", False))  # e.g. Optimizer.step
    return us / 1e3 if us > 0 else None


def per_call_ms(fn, *name_parts: str, reps: int = 20) -> tuple[float, ...]:
    """Device ms per call of ``fn``, summed over the CUDA kernels whose name
    holds each of ``name_parts`` ("" for all of them), by torch.profiler.
    CUPTI now and then hands a profiler session no kernel records at all;
    then the session is taken once more, and if that misses too, each
    number is the span between CUDA events around ``reps`` calls, which
    holds every kernel of the call and the gaps between them."""
    name_parts = name_parts or ("",)
    for _ in range(2):
        _, averages = profiled(fn, reps)
        got = [device_ms(averages, part) for part in name_parts]
        if all(ms is not None for ms in got):
            return tuple(ms / reps for ms in got)
    print(f"    (the profiler saw no device time for {name_parts} twice: "
          f"CUDA events instead)", flush=True)
    return (wall_ms(fn, reps),) * len(name_parts)


def sweep_bytes(B: int, N: int, S: int, D: int, H: int = 1) -> int:
    """Bytes route_sweep must move: read k, v, q once, write a [B, N, H S],
    S_a [B, H S] and A_v once."""
    return 4 * (2 * B * N * D + B * S * D + B * N * H * S + B * H * S + B * S * D)


def sweep_bound_ms(B: int, N: int, S: int, D: int, bw: float, flops: float, H: int = 1):
    """Least time for route_sweep: its bytes; two [N, S, D] products (H S
    dot products of D / H a token, and A_v) and the softmax over H S per
    token."""
    ops = 4 * B * N * S * D + 4 * B * N * H * S
    t_bytes, t_ops = sweep_bytes(B, N, S, D, H) / bw, ops / flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_profile(fn, kernel_name: str, counter: str, reps: int = 20):
    """(device ms per call of all of ``fn``'s kernels, of those whose name
    holds ``kernel_name``, the records of that kernel in the profile, the
    launches its wrapper counted under ``counter`` while the profile ran),
    by torch.profiler. A profile whose records fall short of the launches
    has lost some (11 of 20 for B3 at B = 256 after the earlier phases);
    its device times are then too low."""
    from torch.autograd import DeviceType

    first = LAUNCHES.get(counter, 0) + 1        # profiled() calls fn once before its profile
    _, averages = profiled(fn, reps)
    launched = LAUNCHES.get(counter, 0) - first
    records = sum(e.count for e in averages
                  if e.device_type == DeviceType.CUDA and kernel_name in e.key)
    ms, alone_ms = ((device_ms(averages, part) or 0.0) / reps for part in ("", kernel_name))
    return ms, alone_ms, records, launched


def sweep_times(kernel_fn, plain_fn, kernel_name: str, counter: str):
    """(device ms per call of a sweep wrapper, of its kernel alone, of the
    plain version; the wrapper's wall ms per call between CUDA events).
    The device times come from torch.profiler where the wrapper's profile
    holds a record of every launch its counter saw (a profile is taken twice
    at most). Else all come from CUDA events, which hold every kernel of a
    call and the gaps between them, and the kernel alone is not measured."""
    call_ms = wall_ms(kernel_fn)
    for _ in range(2):
        ms, alone_ms, records, launched = kernel_profile(kernel_fn, kernel_name, counter)
        print(f"    the profile holds {records} kernel records for {launched} launches: "
              f"{'complete' if records == launched else 'INCOMPLETE'}", flush=True)
        if records == launched:
            plain_ms, = per_call_ms(plain_fn)
            return ms, alone_ms, plain_ms, call_ms
    print("    (device ms of the wrapper and of the plain version from CUDA events)",
          flush=True)
    return call_ms, None, wall_ms(plain_fn), call_ms


def alone(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def check_repeatable(name: str, fn, first) -> None:
    """A second launch on the same inputs gives bitwise the same outputs."""
    again = fn()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, again))
    print(f"    {name}: second launch bitwise equal: {'yes' if same else 'NO'}", flush=True)
    if not same:
        raise SystemExit(f"{name} is not deterministic")


def sweep_shape(shape) -> tuple[int, int, int, int, int, str]:
    """(B, N, S, H, D, printed) of a sweep shape [B, N, S, D] (one head) or
    [B, N, S, H, D]."""
    B, N, S, H, D = shape if len(shape) == 5 else (*shape[:3], 1, shape[3])
    return B, N, S, H, D, f"B={B} N={N} S={S} D={D}" + (f" H={H}" if len(shape) == 5 else "")


def sweep_kernels(S: int, D: int, H: int) -> tuple[str, str, str, str]:
    """(B3's counter, its kernel's name, B4's counter, its kernel's name) of
    the C entry pair that takes the shape."""
    if slot_routing.fast_path(S, D, H):
        return slot_routing.KERNEL, "sweep_fwd_kernel", slot_routing.BWD_KERNEL, \
            "sweep_bwd_kernel"
    return slot_routing.HEADS_KERNEL, "heads_fwd_kernel", slot_routing.HEADS_BWD_KERNEL, \
        "heads_bwd_kernel"


def plan_text(p) -> str:
    return (f"tile {p.T}, {p.stages} stages, {p.lanes} lanes a logits job, {p.V} floats a "
            f"chunk, {p.items} column items, "
            + (f"{p.groups} token groups (registers)" if p.groups else "scratch variant"))


def check_heads_plans() -> None:
    """The plans the heads C entries choose on this card at HEADS_SHAPES,
    printed; each must equal the wrapper's mirror (slot_routing.heads_plan)."""
    for _, _, S, H, D in HEADS_SHAPES:
        fwd, bwd, fwd_bytes, bwd_bytes = slot_routing.card_plans(S, D, H)
        ok = (fwd, bwd) == (slot_routing.heads_plan(S, D, H, True),
                            slot_routing.heads_plan(S, D, H, False))
        print(f"  heads plan S={S} D={D} H={H}: forward {plan_text(fwd)}, {fwd_bytes} bytes "
              f"of shared memory; backward {plan_text(bwd)}, {bwd_bytes} bytes; "
              f"{'as the wrapper mirrors it' if ok else 'NOT AS THE WRAPPER MIRRORS IT'}",
              flush=True)
        if not ok:
            raise SystemExit(f"the heads plan at S={S} D={D} H={H} differs from its mirror")


def check_sweep(shape, bw, flops, gen):
    B, N, S, H, D, named = sweep_shape(shape)
    counter, kernel_name = sweep_kernels(S, D, H)[:2]
    k = torch.randn(B, N, D, device="cuda", generator=gen) * (D // H) ** -0.5
    v = torch.randn(B, N, D, device="cuda", generator=gen)
    q = torch.randn(B, S, D, device="cuda", generator=gen)
    got = slot_routing.route_sweep(k, v, q, H)
    want = slot_routing.route_sweep_reference(k, v, q, H)
    torch.cuda.synchronize()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    scales = [w.abs().max().item() for w in want]
    ok = all(e <= SWEEP_TOL * s for e, s in zip(errs, scales))
    rel = ", ".join(f"{name} {e:.2e}/{s:.2e}" for name, e, s
                    in zip(("S_a", "A_v", "a"), errs, scales))
    print(f"  route_sweep {named}: max_abs_err/max_abs ({rel}), "
          f"tolerance {SWEEP_TOL} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit(f"route_sweep disagrees with its plain version at {shape}")
    check_repeatable("route_sweep", lambda: slot_routing.route_sweep(k, v, q, H), got)
    ms, kernel_alone_ms, plain_ms, call_ms = sweep_times(   # with its row sums, and alone
        lambda: slot_routing.route_sweep(k, v, q, H),
        lambda: slot_routing.route_sweep_reference(k, v, q, H), kernel_name, counter)
    bound_ms, bound_by = sweep_bound_ms(B, N, S, D, bw, flops, H)
    print(f"    device ms: route_sweep {ms:.4f} ({kernel_name} alone "
          f"{alone(kernel_alone_ms)}), plain {plain_ms:.4f}, bound {bound_ms:.4f} "
          f"({bound_by}), {100 * bound_ms / ms:.1f} % of it, "
          f"{sweep_bytes(B, N, S, D, H) / ms / 1e9:.3f} TB/s; wall per call {call_ms:.4f} ms",
          flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def gumbel_bytes(R: int, V: int, soft: bool) -> int:
    """Bytes one Gumbel kernel must move: read the logits and the seed once,
    write y [R, V] fp32 (soft) or the ids [R] int64."""
    return 4 * R * V + 8 + (4 * R * V if soft else 8 * R)


def gumbel_bound_ms(R: int, V: int, soft: bool, bw: float, flops: float):
    """Least time for one Gumbel kernel: its bytes; per value about 10 fp32
    operations (the uniform, two logs, the add and for the soft sample the
    divide, max, exp, sum and normalise), the Philox integer work aside."""
    ops = (10 if soft else 5) * R * V
    t_bytes, t_ops = gumbel_bytes(R, V, soft) / bw, ops / flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweep_bwd_bytes(B: int, N: int, S: int, D: int, H: int = 1) -> int:
    """Bytes the sweep's backward must move: read k, v, a, g_a (a and g_a
    [B, N, H S]), q, g_av once, write gk, gv, gq once."""
    return 4 * (4 * B * N * D + 2 * B * N * H * S + 3 * B * S * D)


def sweep_bwd_bound_ms(B: int, N: int, S: int, D: int, bw: float, flops: float,
                       H: int = 1):
    """Least time for the sweep's backward: its bytes; per token 8 S D
    operations (v . g_av, dl q, a g_av and the dl^T k partial) and 6 H S
    (da, dl)."""
    ops = 8 * B * N * S * D + 6 * B * N * H * S
    t_bytes, t_ops = sweep_bwd_bytes(B, N, S, D, H) / bw, ops / flops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed(kernel_fn, plain_fn, kernel_name: str = ""):
    """Device ms per call of the kernel's wrapper, of the kernel alone (the
    kernels whose name holds ``kernel_name``) and of the plain version, and
    the wrapper's wall ms per call (CUDA events)."""
    ms, kernel_alone_ms = per_call_ms(kernel_fn, "", kernel_name)
    plain_ms, = per_call_ms(plain_fn)
    return ms, kernel_alone_ms, plain_ms, wall_ms(kernel_fn)


def check_gumbel(R, V, bw, flops, gen, time_it=True):
    """B1 and B2 at [R, V] against their plain versions fed the fields the
    kernels drew (g_out); the fields against their exact replay and the
    Gumbel distribution."""
    mean_tol = GUMBEL_SIGMAS * 1.2825 / np.sqrt(R * V)
    var_tol = GUMBEL_SIGMAS * 3.45 / np.sqrt(R * V)
    logits = torch.randn(R, V, device="cuda", generator=gen) * 3
    tau = 0.55
    results = {}
    for soft in (True, False):
        g = torch.empty_like(logits)
        state = gen.get_state()
        if soft:
            got = gumbel.gumbel_softmax_sample(logits, tau, generator=gen, g_out=g)
            want = gumbel.gumbel_softmax_sample_reference(logits, g, tau)
            err = (got - want).abs().max().item()
            ok = err <= SOFT_TOL
        else:
            got = gumbel.gumbel_argmax_ids(logits, generator=gen, g_out=g)
            want = gumbel.gumbel_argmax_ids_reference(logits, g)
            err = float((got != want).sum().item())
            ok = err == 0
        g64 = g.double()
        mean, var = g64.mean().item(), g64.var().item()
        dist_ok = abs(mean - GUMBEL_MEAN) <= mean_tol and abs(var - GUMBEL_VAR) <= var_tol
        exact = gumbel.replay_field(gumbel.replayed_seed(state, "cuda"),
                                    gumbel.SOFT_STREAM if soft else gumbel.IDS_STREAM, R, V)
        field_err = (g64.cpu() - torch.from_numpy(exact)).abs().max().item()
        field_ok = field_err <= FIELD_TOL
        name = gumbel.SOFT_KERNEL if soft else gumbel.IDS_KERNEL
        what = f"max_abs_err {err:.3e} (tolerance {SOFT_TOL})" if soft else \
            f"{int(err)} ids differ (tolerance 0)"
        print(f"  {name} R={R} V={V}: {what} {'ok' if ok else 'MISMATCH'}; field against "
              f"its replay max |g - g_exact| {field_err:.3e} (tolerance {FIELD_TOL}), "
              f"largest g {g.max().item():.6f} {'ok' if field_ok else 'OFF'}; mean "
              f"{mean:.5f} (gamma {GUMBEL_MEAN:.5f} +- {mean_tol:.1e}), var {var:.5f} "
              f"(pi^2/6 {GUMBEL_VAR:.5f} +- {var_tol:.1e}) {'ok' if dist_ok else 'OFF'}",
              flush=True)
        if not (ok and field_ok and dist_ok):
            raise SystemExit(f"{name} disagrees with its plain version, its exact field "
                             f"or the Gumbel distribution at {(R, V)}")
        if not time_it:
            continue
        # library_fn: one PyTorch call computing the same function with its
        # own noise, a yardstick only (the port never calls it)
        if soft:
            kernel_fn = lambda: gumbel.gumbel_softmax_sample(logits, tau, generator=gen)
            plain_fn = lambda: gumbel.gumbel_softmax_sample_reference(
                logits, gumbel.gumbel_field(logits.shape, gen, logits.device), tau)
            library, library_fn = "F.gumbel_softmax", lambda: torch.nn.functional.gumbel_softmax(
                logits, tau=tau, hard=False)
        else:
            kernel_fn = lambda: gumbel.gumbel_argmax_ids(logits, generator=gen)
            plain_fn = lambda: gumbel.gumbel_argmax_ids_reference(
                logits, gumbel.gumbel_field(logits.shape, gen, logits.device))
            library, library_fn = "Categorical(logits).sample()", lambda: \
                torch.distributions.Categorical(logits=logits, validate_args=False).sample()
        ms, kernel_alone_ms, plain_ms, call_ms = timed(kernel_fn, plain_fn, name)
        library_ms, = per_call_ms(library_fn)
        bound_ms, bound_by = gumbel_bound_ms(R, V, soft, bw, flops)
        print(f"    device ms: {name} {ms:.4f} (kernel alone {kernel_alone_ms:.4f}), plain "
              f"(torch field + {'softmax' if soft else 'argmax'}) {plain_ms:.4f}, {library} "
              f"{library_ms:.4f}, bound {bound_ms:.4f} ({bound_by}), {100 * bound_ms / ms:.1f} "
              f"% of it, {gumbel_bytes(R, V, soft) / ms / 1e9:.3f} TB/s; wall per call "
              f"{call_ms:.4f} ms",
              flush=True)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
    return results


def check_gumbel_row0(R: int, V: int, row0: int, gen) -> float:
    """B1 and B2 drawing rows row0 .. row0 + R - 1 of a longer field (a
    data-parallel rank's rows): the field they drew against rows [row0,
    row0 + R) of its numpy replay at row0 + R rows, within FIELD_TOL, and
    their outputs against the plain versions fed it. Returns the worst field
    error."""
    logits = torch.randn(R, V, device="cuda", generator=gen) * 3
    worst = 0.0
    for soft in (True, False):
        g = torch.empty_like(logits)
        state = gen.get_state()
        if soft:
            got = gumbel.gumbel_softmax_sample(logits, 0.55, generator=gen, g_out=g, row0=row0)
            ok = (got - gumbel.gumbel_softmax_sample_reference(logits, g, 0.55)).abs().max() \
                <= SOFT_TOL
        else:
            got = gumbel.gumbel_argmax_ids(logits, generator=gen, g_out=g, row0=row0)
            ok = torch.equal(got, gumbel.gumbel_argmax_ids_reference(logits, g))
        stream = gumbel.SOFT_STREAM if soft else gumbel.IDS_STREAM
        exact = gumbel.replay_field(gumbel.replayed_seed(state, "cuda"), stream, row0 + R, V)
        err = (g.cpu().double() - torch.from_numpy(exact[row0:])).abs().max().item()
        worst = max(worst, err)
        name = gumbel.SOFT_KERNEL if soft else gumbel.IDS_KERNEL
        print(f"  {name} R={R} V={V} row0={row0}: field against rows [{row0}, {row0 + R}) of "
              f"its replay at {row0 + R} rows max |g - g_exact| {err:.3e} (tolerance "
              f"{FIELD_TOL}); output against its plain version {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not (ok and err <= FIELD_TOL):
            raise SystemExit(f"{name} with row0={row0} disagrees with its exact field or its "
                             f"plain version at {(R, V)}")
    return worst


def check_id_frequencies(gen):
    """One row repeated: B2's id frequencies ~ softmax(row) (as
    tests/test_ops.py holds the JAX version)."""
    row = torch.full((1, 128), -1e9, device="cuda")
    row[0, :4] = torch.tensor([2.0, 1.0, 0.0, -1.0], device="cuda")
    ids = gumbel.gumbel_argmax_ids(row.repeat(65536, 1), generator=gen)
    freq = (torch.bincount(ids, minlength=4)[:4].double() / 65536).cpu()
    want = torch.softmax(torch.tensor([2.0, 1.0, 0.0, -1.0], dtype=torch.float64), 0)
    err = (freq - want).abs().max().item()
    print(f"  gumbel_ids frequencies {[round(f, 4) for f in freq.tolist()]} vs softmax "
          f"{[round(f, 4) for f in want.tolist()]}: max diff {err:.4f} (tolerance "
          f"{FREQ_TOL}) {'ok' if err <= FREQ_TOL else 'OFF'}", flush=True)
    if err > FREQ_TOL:
        raise SystemExit("gumbel_ids frequencies disagree with the softmax")


def check_ids_nan(R: int, V: int, gen) -> None:
    """B2 on rows that hold NaN, given a zero field: the plain version's ids
    (the first NaN's index, as jnp.argmax), every id below V."""
    logits = torch.randn(R, V, device="cuda", generator=gen)
    cols = torch.randint(0, V, (R // 2, 3), device="cuda", generator=gen)
    logits[torch.arange(R // 2, device="cuda")[:, None], cols] = float("nan")
    logits[R // 2:R // 2 + 4] = float("nan")     # whole rows of NaN
    logits[R - 1] = -float("inf")                # a row of -inf: id 0
    zeros = torch.zeros_like(logits)
    got = gumbel.gumbel_argmax_ids(logits, noise=zeros)
    want = gumbel.gumbel_argmax_ids_reference(logits, zeros)
    differ = int((got != want).sum().item())
    top = int(got.max().item())
    ok = differ == 0 and top < V
    print(f"  gumbel_ids R={R} V={V} with NaN rows: {differ} ids differ from the plain "
          f"version (tolerance 0), largest id {top} (< {V}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        raise SystemExit("gumbel_ids mishandles NaN")


def report_ptxas(names: list[str]) -> None:
    """Registers and spill bytes of every kernel of the named sources, from
    the ptxas report kept beside each library (built now or earlier); a
    spill anywhere, or a library without its report, fails the run."""
    spilled = []
    for name in names:
        families: dict[str, list[str]] = {}
        for kernel, use in ptxas_usage(build_log(name)).items():
            family, _, arg = kernel.partition("<")
            families.setdefault(family, []).append(
                f"{arg.rstrip('>') or '-'}:{use['registers']}r/"
                f"{use['spill_stores'] + use['spill_loads']}B")
            if use["spill_stores"] or use["spill_loads"]:
                spilled.append(kernel)
        if not families:
            raise SystemExit(f"the ptxas report of {name}.cu names no kernel")
        for family, entries in families.items():
            print(f"  ptxas {name}.cu {family} (template argument: registers/spill "
                  f"bytes): {' '.join(entries)}", flush=True)
    if spilled:
        raise SystemExit(f"register spills in {spilled}")


def check_sweep_bwd(shape, bw, flops, gen):
    """B4 against autograd of the plain sweep, given the same cotangents."""
    B, N, S, H, D, named = sweep_shape(shape)
    counter, kernel_name = sweep_kernels(S, D, H)[2:]
    k = torch.randn(B, N, D, device="cuda", generator=gen) * (D // H) ** -0.5
    v = torch.randn(B, N, D, device="cuda", generator=gen)
    q = torch.randn(B, S, D, device="cuda", generator=gen)
    g_sa = torch.randn(B, H * S, device="cuda", generator=gen)
    g_av = torch.randn(B, S, D, device="cuda", generator=gen)
    g_a = torch.randn(B, N, H * S, device="cuda", generator=gen)
    _, _, a = slot_routing.route_sweep(k, v, q, H)
    kernel_fn = lambda: slot_routing._sweep_bwd(  # noqa: E731 - the Function's backward
        k, v, q, a, g_av, (g_a + g_sa[:, None, :]).contiguous(), H)
    got = kernel_fn()
    leaves = [x.clone().requires_grad_() for x in (k, v, q)]
    outs = slot_routing.route_sweep_reference(*leaves, H)
    plain_fn = lambda: torch.autograd.grad(outs, leaves, (g_sa, g_av, g_a),  # noqa: E731
                                           retain_graph=True)
    want = plain_fn()
    torch.cuda.synchronize()
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    scales = [w.abs().max().item() for w in want]
    ok = all(e <= SWEEP_TOL * s for e, s in zip(errs, scales))
    rel = ", ".join(f"{name} {e:.2e}/{s:.2e}" for name, e, s
                    in zip(("gk", "gv", "gq"), errs, scales))
    print(f"  route_sweep backward {named}: max_abs_err/max_abs ({rel}), "
          f"tolerance {SWEEP_TOL} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit(f"the sweep's backward disagrees with its plain version at {shape}")
    check_repeatable("route_sweep backward", kernel_fn, got)
    ms, kernel_alone_ms, plain_ms, call_ms = sweep_times(kernel_fn, plain_fn, kernel_name,
                                                         counter)
    bound_ms, bound_by = sweep_bwd_bound_ms(B, N, S, D, bw, flops, H)
    print(f"    device ms: backward {ms:.4f} ({kernel_name} alone {alone(kernel_alone_ms)}), "
          f"plain (autograd) {plain_ms:.4f}, bound {bound_ms:.4f} ({bound_by}), "
          f"{100 * bound_ms / ms:.1f} % of it, "
          f"{sweep_bwd_bytes(B, N, S, D, H) / ms / 1e9:.3f} TB/s; wall per call "
          f"{call_ms:.4f} ms", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


@contextmanager
def plain_sweep():
    """The policy with the routing kernel replaced by its plain version."""
    kernel = slot_routing.route_sweep
    slot_routing.route_sweep = slot_routing.route_sweep_reference
    try:
        yield
    finally:
        slot_routing.route_sweep = kernel


def check_request(algo: PPO, obs: np.ndarray, num_slots: int, slot_size: int):
    gen = torch.Generator(device="cuda").manual_seed(obs.shape[0])
    noise = torch.randn(obs.shape[0], num_slots, slot_size, device="cuda",
                        generator=gen)
    actions, logits, values = algo.act_deterministic(obs, noise=noise)
    with plain_sweep():
        want_actions, want_logits, want_values = algo.act_deterministic(obs, noise=noise)
    torch.cuda.synchronize()
    E = obs.shape[0]
    if logits.shape != (E, 4) or values.shape != (E,):
        raise SystemExit(f"policy outputs {tuple(logits.shape)}, {tuple(values.shape)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(values).all()):
        raise SystemExit("policy outputs are not finite")
    err = max((logits - want_logits).abs().max().item(),
              (values - want_values).abs().max().item())
    same = bool((actions == want_actions).all())
    ok = same and torch.allclose(logits, want_logits, **POLICY_TOL) \
        and torch.allclose(values, want_values, **POLICY_TOL)
    print(f"  check E={E}: actions {'equal' if same else 'DIFFER'}, logits/values "
          f"max_abs_err {err:.3e} (rtol {POLICY_TOL['rtol']}, atol "
          f"{POLICY_TOL['atol']}) against the plain sweep", flush=True)
    if not ok:
        raise SystemExit(f"serving path disagrees with its plain version at E={E}")


def serve(algo: PPO, requests: list[np.ndarray]) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for obs in requests:
        actions = algo.predict(obs)      # returns numpy: waits for the card
        if actions.shape != (obs.shape[0],) or not np.isin(actions, range(4)).all():
            raise SystemExit(f"bad actions {actions!r}")
    return time.perf_counter() - t0


def profile(label: str, fn, reps: int, rows: int) -> None:
    """Device time by kernel and the device's busy share over ``reps`` calls."""
    wall, averages = profiled(fn, reps)
    busy = device_ms(averages)
    print(averages.table(sort_by="self_device_time_total", row_limit=rows), flush=True)
    share = "not measured (the profiler saw no device time)" if busy is None else \
        f"{busy:.3f} ms ({100 * busy / (1e3 * wall):.1f} %)"
    print(f"  {label} in {1e3 * wall:.3f} ms under the profiler; device busy {share}",
          flush=True)


@contextmanager
def plain_kernels(fields: dict):
    """The OCR with every kernel replaced by its plain version: the routing
    sweep by autograd of the plain sweep, the Gumbel kernels by their plain
    versions fed ``fields`` (those the kernels drew). Each still draws the
    seed its kernel would, so that the generator, and with it the slot noise
    and the dropout masks, stays in step with the kernel run."""
    saved = (slot_routing.route_sweep, gumbel.gumbel_softmax_sample,
             gumbel.gumbel_argmax_ids)

    def soft(logits, tau, *, generator=None, noise=None, g_out=None, row0=0):
        gumbel.draw_seed(generator, logits.device)
        return gumbel.gumbel_softmax_sample_reference(logits, fields["soft"], tau)

    def ids(logits, *, generator=None, noise=None, g_out=None, row0=0):
        gumbel.draw_seed(generator, logits.device)
        return gumbel.gumbel_argmax_ids_reference(logits.detach(), fields["ids"])

    slot_routing.route_sweep = slot_routing.route_sweep_reference
    gumbel.gumbel_softmax_sample, gumbel.gumbel_argmax_ids = soft, ids
    try:
        yield
    finally:
        (slot_routing.route_sweep, gumbel.gumbel_softmax_sample,
         gumbel.gumbel_argmax_ids) = saved


def compare_grads(got: dict, want: dict) -> tuple[float, bool, float]:
    """Each gradient of ``got`` against ``want`` (name -> tensor) to
    STEP_GRAD_TOL of its leaf's largest entry plus STEP_GRAD_FLOOR of the
    model's: (the worst share of its tolerance, all within, the model's
    largest entry)."""
    top = max(g.abs().max().item() for g in want.values())
    worst, ok = 0.0, True
    for name, g in want.items():
        err = (got[name] - g).abs().max().item()
        limit = STEP_GRAD_TOL * g.abs().max().item() + STEP_GRAD_FLOOR * top
        worst = max(worst, err / max(limit, 1e-30))
        ok &= err <= limit
    return worst, ok, top


def check_step(ocr_cfg, env_cfg, obs: np.ndarray):
    """One update of a fresh model through the kernels against the same
    update through the plain versions, from identical params and generator
    state, the plain side fed the Gumbel fields the kernels drew."""
    kernel_ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
    plain_ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
    start = {k: v.clone() for k, v in kernel_ocr.module.state_dict().items()}
    drawn = {}
    got = kernel_ocr.update(obs, None, 0, noise=drawn)
    fields = {k: drawn[k] for k in ("soft", "ids")}
    plain_drawn = dict(fields)
    with plain_kernels(fields):
        want = plain_ocr.update(obs, None, 0, noise=plain_drawn)
    torch.cuda.synchronize()
    if not torch.equal(plain_drawn["slots"], drawn["slots"]):
        raise SystemExit("the plain run drew other slot noise: generators out of step")
    loss, want_loss = got["loss"].item(), want["loss"].item()
    loss_ok = abs(loss - want_loss) <= STEP_LOSS_RTOL * abs(want_loss) and np.isfinite(loss)
    plain_grads = dict(plain_ocr.module.named_parameters())
    worst_grad, grad_ok, top = compare_grads(
        {n: p.grad for n, p in kernel_ocr.module.named_parameters()},
        {n: p.grad for n, p in plain_grads.items()})
    lrs = {g["group"]: g["lr"] for g in plain_ocr.optimizer.adam.param_groups}
    after, plain_after = kernel_ocr.module.state_dict(), plain_ocr.module.state_dict()
    worst_move, compared, total = 0.0, 0, 0
    for name, p in plain_grads.items():
        lr = lrs[GROUP_OF[name.split(".")[0]]]
        sure = p.grad.abs() > 1e-6
        moved = ((after[name] - start[name]) - (plain_after[name] - start[name])) / lr
        if sure.any():
            worst_move = max(worst_move, moved[sure].abs().max().item())
        compared += int(sure.sum())
        total += p.numel()
    move_ok = worst_move <= STEP_MOVE_TOL
    print(f"  step check against the plain versions: loss {loss:.6f} vs {want_loss:.6f} "
          f"(rtol {STEP_LOSS_RTOL}); gradients worst {worst_grad:.3f} of their tolerance "
          f"({STEP_GRAD_TOL} of each leaf's max + {STEP_GRAD_FLOOR} of the model's "
          f"{top:.3e}); parameter change over lr worst {worst_move:.3e} (tolerance "
          f"{STEP_MOVE_TOL}) on {compared} of {total} entries with |g| > 1e-6",
          flush=True)
    if not (loss_ok and grad_ok and move_ok):
        raise SystemExit("the training step disagrees with its plain version")


def train_steps(ocr, batches: list[np.ndarray], step0: int) -> tuple[float, dict]:
    """update_many in superbatches of TRAIN_K; (seconds, stacked metrics)."""
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(batches), TRAIN_K):
        metrics.append(ocr.update_many(np.concatenate(batches[i:i + TRAIN_K]), None,
                                       step0 + i, TRAIN_K))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, {k: torch.cat([m[k].cpu() for m in metrics]) for k in metrics[0]}


def conv_block_dtypes(fn) -> set:
    """The dtypes that every Conv2dBlock outputs while ``fn`` runs (a
    forward hook on all modules, taken off after)."""
    dtypes = set()

    def hook(module, args, out):
        if isinstance(module, Conv2dBlock):
            dtypes.add(out.dtype)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        fn()
    finally:
        handle.remove()
    return dtypes


def amp_side(ocr_cfg, env_cfg, obs: np.ndarray, device: str, noise: dict) -> dict:
    """One update of a fresh OCR (seed 0) on ``device``: its metrics, raw
    (unclipped) and clipped gradients, lrs, its parameters before and
    after, on the host, and the dtypes its conv blocks output; ``noise``
    gives or receives the draws."""
    ocr = create_ocr(ocr_cfg, env_cfg, seed=0, device=device)
    start = {k: v.cpu().numpy().copy() for k, v in ocr.module.state_dict().items()}
    metrics = {}
    dtypes = conv_block_dtypes(lambda: metrics.update(
        {k: float(v) for k, v in ocr.update(obs, None, 0, noise=noise).items()}))
    scale = min(1.0, ocr.clip / (metrics["norm"] + 1e-6))
    named = dict(ocr.module.named_parameters())
    clipped = {n: p.grad.cpu().numpy() for n, p in named.items() if p.grad is not None}
    lrs = {n: g["lr"] for g in ocr.optimizer.adam.param_groups for n, p in named.items()
           if any(p is q for q in g["params"])}
    return dict(metrics=metrics, clipped=clipped, dtypes=dtypes,
                grads={n: g / scale for n, g in clipped.items()}, start=start,
                params={k: v.cpu().numpy() for k, v in ocr.module.state_dict().items()},
                groups={n: (lrs[n], 0.0) for n in clipped},
                moments={n: (np.zeros_like(g), np.zeros_like(g)) for n, g in clipped.items()},
                t=1)


def check_amp_step(ocr_cfg, env_cfg, obs: np.ndarray) -> dict:
    """One bf16 update on the card against the same update on the CPU in
    bf16 and in fp32 (the reference), from seed 0's weights on the draws the
    card's kernels made, under the rule stated at AMP_CHECK. Returns the
    worst shares of each tolerance."""
    ocr_cfg = config_replace(ocr_cfg, "learning.dropout", 0.0)
    drawn = {}
    card = amp_side(ocr_cfg, env_cfg, obs, "cuda", drawn)
    noise = {k: v.cpu() for k, v in drawn.items()}
    cpu = amp_side(ocr_cfg, env_cfg, obs, "cpu", dict(noise))
    ref = amp_side(config_replace(ocr_cfg, "amp", None), env_cfg, obs, "cpu", dict(noise))
    got, amp, r = card["metrics"], cpu["metrics"], ref["metrics"]
    metric = max(abs(got[k] - r[k]) / (AMP_GRAD_C * abs(amp[k] - r[k])
                                       + PRETRAIN_TOL * max(abs(r[k]), 1.0))
                 for k in r if k != "norm")
    top = max(float(np.abs(g).max()) for g in ref["grads"].values())
    grad, where = 0.0, ""
    for name, g in ref["grads"].items():
        limit = (AMP_GRAD_C * float(np.abs(cpu["grads"][name] - g).max())
                 + HALF_BF16_ULP * float(np.abs(g).max()) + 1e-7 * top)
        share = float(np.abs(card["grads"][name] - g).max()) / limit
        if share > grad:
            grad, where = share, name
    norm = abs(got["norm"] - r["norm"]) / (AMP_GRAD_C * abs(amp["norm"] - r["norm"])
                                           + HALF_BF16_ULP * r["norm"])
    adam, adam_where = adam_replay_gap({**card, "grads": card["clipped"]})
    amp_gap = abs(amp["loss"] - r["loss"]) / max(abs(r["loss"]), 1.0)
    bf16 = card["dtypes"] == cpu["dtypes"] == {torch.bfloat16} and \
        ref["dtypes"] == {torch.float32}
    ok = (set(got) == set(r) and metric <= 1 and grad <= 1 and norm <= 1 and adam <= 1
          and all(np.isfinite(v) for v in got.values()) and bf16)
    print(f"  {'Slot-Attention' if ocr_cfg.use_bcdec else 'SLATE'} bf16 step at batch "
          f"{obs.shape[0]}, card against CPU (r: the CPU's fp32 step): loss {got['loss']!r} "
          f"card, {amp['loss']!r} CPU bf16, {r['loss']!r} r (bf16 moves it {amp_gap:.3e} "
          f"relative); metrics worst {metric:.3f} of their tolerance; gradients worst "
          f"{grad:.3f} ({where}); norm {got['norm']} card, {amp['norm']} CPU, "
          f"{r['norm']:.4f} r: {norm:.3f}; parameters {adam:.3f} of Adam's replay "
          f"({adam_where}); conv blocks {'bf16' if bf16 else 'NOT bf16'}: "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit("the bf16 step disagrees between card and CPU")
    return dict(metric=metric, grad=grad, norm=norm, adam=adam)


def conv_device_ms(averages) -> tuple[float, float, list[str]]:
    """(device ms under CONV_OPS, of the convolution kernels that name bf16,
    the names of the three longest convolution kernels) in torch.profiler's
    averages."""
    from torch.autograd import DeviceType

    total = sum(e.device_time_total for e in averages if e.key in CONV_OPS) / 1e3
    convs = sorted(((e.self_device_time_total, e.key) for e in averages
                    if e.device_type == DeviceType.CUDA and "convert" not in e.key.lower()
                    and any(part in e.key.lower() for part in CONV_KERNELS)), reverse=True)
    bf16 = sum(us for us, key in convs if "bf16" in key.lower()) / 1e3
    return total, bf16, [key[:90] for _, key in convs[:3]]


def amp_phase(card: str, fp32_ms: float, batch: np.ndarray, sa) -> dict:
    """``train_ocr ocr=slate ocr.amp=bf16``'s step at full width (see
    AMP_ARGV): the conv blocks' outputs bf16 (forward hooks over the warm-up),
    steps card against CPU (check_amp_step), then TRAIN_WARMUP and
    TRAIN_STEPS timed steps of update_many beside the training phase's fp32
    ``fp32_ms`` of this process, one Slot-Attention update and one get_loss
    with masks, each with the launch counts reset just before and read just
    after. Returns the launch counts and the OCR, for the profile."""
    ocr_cfg, env_cfg = compose(TrainOCRConfig(), AMP_ARGV).ocr, EnvConfig()
    sa_cfg = compose(TrainOCRConfig(), ["ocr=slotattention", "ocr.amp=bf16"]).ocr
    for cfg in (ocr_cfg, sa_cfg):
        check_amp_step(cfg, env_cfg, batch[:AMP_CHECK])
    ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
    warm = {}
    dtypes = conv_block_dtypes(
        lambda: warm.update(train_steps(ocr, [batch] * TRAIN_WARMUP, 0)[1]))
    reset_launches()
    seconds, timed = train_steps(ocr, [batch] * TRAIN_STEPS, TRAIN_WARMUP)
    launches = dict(LAUNCHES)
    per_step = {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1,
                slot_routing.KERNEL: sa.num_iterations, slot_routing.BWD_KERNEL: sa.num_iterations}
    expected = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    ms = 1e3 * seconds / TRAIN_STEPS
    losses = torch.cat([warm["loss"], timed["loss"]])
    print(f"  {card}: {TRAIN_STEPS} bf16 steps at batch {TRAIN_BATCH} (update_many "
          f"k={TRAIN_K}), {ms:.3f} ms/step, {TRAIN_BATCH / ms * 1e3:.1f} images/s, beside "
          f"fp32 {fp32_ms:.3f} ms/step in this process ({fp32_ms / ms:.3f} x); conv blocks "
          f"output {sorted(map(str, dtypes))}; loss on one fixed batch {losses[0].item():.4f} "
          f"-> {losses[-1].item():.4f}; launches {launches}, expected {expected}", flush=True)
    if dtypes != {torch.bfloat16}:
        raise SystemExit(f"ocr.amp=bf16 ran its conv blocks in {dtypes}, not bf16 alone")
    if launches != expected:
        raise SystemExit("the bf16 training path did not launch each kernel as expected")
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit("bf16 training did not lower the loss")
    runs = [launches]

    sa_ocr = create_ocr(sa_cfg, env_cfg, seed=0)
    obs, masks = painted(TRAIN_BATCH, env_cfg.obs_size, EVAL_OBJECTS, seed=12)
    sa_ocr.update(obs, None, 0)                                      # warm-up
    ocr_eval = create_ocr(ocr_cfg, env_cfg, seed=0)
    ocr_eval.get_loss(obs, masks)                                    # warm-up
    for label, fn, want in (
            ("Slot-Attention update", lambda: sa_ocr.update(obs, None, 1),
             {slot_routing.KERNEL: sa.num_iterations, slot_routing.BWD_KERNEL: sa.num_iterations}),
            ("SLATE get_loss with masks", lambda: ocr_eval.get_loss(obs, masks),
             {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1, slot_routing.KERNEL: sa.num_iterations})):
        reset_launches()
        metrics = {}
        found = conv_block_dtypes(lambda: metrics.update(fn()))
        torch.cuda.synchronize()
        runs.append(dict(LAUNCHES))
        finite = all(np.isfinite(float(v)) for v in metrics.values())
        print(f"  bf16 {label} at {TRAIN_BATCH}: "
              f"{ {k: round(float(v), 6) for k, v in metrics.items()} }; conv blocks output "
              f"{sorted(map(str, found))}; launches {runs[-1]}, expected {want}", flush=True)
        if runs[-1] != want or found != {torch.bfloat16} or not finite:
            raise SystemExit(f"the bf16 {label} did not run as expected")
    return dict(launches=runs, ocr=ocr, superbatch=np.concatenate([batch] * TRAIN_K))


def painted(B: int, size: int, objects: int, seed: int):
    """uint8 scenes [B, size, size, 3] of ``objects`` axis-aligned squares of
    random colours over a random background, and their masks
    [B, objects + 1, size, size, 1] with the background last (a later
    square covers an earlier one), from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    K = objects + 1
    obs = np.empty((B, size, size, 3), np.uint8)
    masks = np.zeros((B, K, size, size, 1), np.uint8)
    for b in range(B):
        label = np.full((size, size), K - 1)
        obs[b] = rng.integers(0, 256, 3)
        for k in range(objects):
            h, w = rng.integers(size // 4, size // 2 + 1, 2)
            y, x = rng.integers(0, size - h + 1), rng.integers(0, size - w + 1)
            label[y:y + h, x:x + w] = k
            obs[b, y:y + h, x:x + w] = rng.integers(0, 256, 3)
        masks[b, ..., 0] = label[None] == np.arange(K)[:, None, None]
    return obs, masks


def first_near_ties(logits: torch.Tensor, gap: float) -> torch.Tensor:
    """Each row's first position whose two largest logits [B, T, V] lie
    within ``gap``, or T when there is none."""
    top2 = logits.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < gap
    T = logits.shape[1]
    return torch.where(near.any(-1), near.int().argmax(-1), torch.full_like(near[:, 0], T,
                                                                            dtype=torch.long))


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def check_eval(ocr, batch: dict) -> dict:
    """One evaluation batch through the kernels against the same OCR with
    every kernel replaced by its plain version, fed the draws the kernels'
    run made: the loss metrics, the ARI's label maps and the greedy tokens,
    under the rules stated at EVAL_RTOL. Returns what it found."""
    module, device = ocr.module, ocr.device
    obs = normalize_obs(torch.from_numpy(batch["obss"]).to(device))
    masks = torch.from_numpy(batch["masks"]).to(device).float()
    gen = torch.Generator(device=device).manual_seed(1)
    gen_noise = torch.randn((obs.shape[0], module.slotattn.num_slots,
                             module.slotattn.slot_size), generator=gen, device=device)
    drawn = {}
    sides = {}
    for side in ("kernel", "plain"):
        noise = drawn if side == "kernel" else dict(drawn)
        fields = {k: drawn.get(k) for k in ("soft", "ids")}
        with plain_kernels(fields) if side == "plain" else nullcontext(), torch.no_grad():
            metrics = ocr.get_loss(batch["obss"], batch["masks"], noise=noise)
            _, attns = module.get_slots(obs, noise["slots"])
            slots, _ = module.get_slots(obs, gen_noise)
            tokens = module.gen_tokens(slots) if not module.use_bcdec else None
            logits = None if tokens is None else module.teacher_forced_logits(slots, tokens)
        sides[side] = dict(metrics=metrics, attns=attns, tokens=tokens, logits=logits)
    torch.cuda.synchronize()
    k, p = sides["kernel"], sides["plain"]
    labels = [mask_labels(module.ari_pred_masks(s["attns"], masks)) for s in (k, p)]
    saturated = ((k["attns"].max(-1).values >= 1 - ARI_SATURATION)
                 | (p["attns"].max(-1).values >= 1 - ARI_SATURATION))   # [B, H*W]
    differ = labels[0] != labels[1]
    labels_ok = not bool((differ & ~saturated).any())
    # the ARI is a function of the label maps: held to them, and to 1e-5
    # where they are equal
    errs = {key: rel_err(float(k["metrics"][key]), float(p["metrics"][key]))
            for key in p["metrics"] if key != "ari" or not differ.any()}
    worst_key = max(errs, key=errs.get)
    loss_ok = errs[worst_key] <= EVAL_RTOL and all(
        np.isfinite(float(v)) for v in k["metrics"].values())
    print(f"  evaluation check against the plain versions: loss metrics worst "
          f"{worst_key} {errs[worst_key]:.3e} relative (tolerance {EVAL_RTOL}); ari "
          f"{float(k['metrics']['ari']):.6f} vs {float(p['metrics']['ari']):.6f}; ARI label "
          f"maps differ at {int(differ.sum())} of {differ.numel()} pixels, "
          f"{int(saturated.sum())} pixels have an attention within {ARI_SATURATION} of 1.0 "
          f"{'ok' if labels_ok else 'MISMATCH'}", flush=True)
    found = dict(loss_ok=loss_ok, labels_ok=labels_ok, tokens_ok=True)
    if k["tokens"] is not None:
        upto = first_near_ties(p["logits"], GEN_GAP)
        T = k["tokens"].shape[1]
        pos = torch.arange(T, device=device)[None]
        agree = ((k["tokens"] == p["tokens"]) | (pos >= upto[:, None])).all()
        cut = [(b, int(t)) for b, t in enumerate(upto.tolist()) if t < T]
        rows_differ = int((k["tokens"] != p["tokens"]).any(-1).sum())
        found["tokens_ok"] = bool(agree)
        print(f"  greedy tokens: {rows_differ} of {k['tokens'].shape[0]} rows differ "
              f"somewhere; {len(cut)} rows have a near-tie (plain top-two gap < {GEN_GAP}), "
              f"compared up to it (row, position): {cut[:8]}{' ...' if len(cut) > 8 else ''}; "
              f"equal before every near-tie {'ok' if agree else 'MISMATCH'}", flush=True)
    if not (found["loss_ok"] and found["labels_ok"] and found["tokens_ok"]):
        raise SystemExit("the evaluation batch disagrees with its plain version")
    return found


def evaluation_phase(ocr_cfg, env_cfg, card: str, sa) -> tuple[dict, dict, dict]:
    """Warm-up, timed batches with launch counts, the plain check, then the
    Slot-Attention OCR's warm-up and counted batch and its plain check.
    Returns (SLATE's counts, Slot-Attention's counts, the SLATE OCR and a
    batch for the profile)."""
    size = env_cfg.obs_size
    obs, masks = painted(EVAL_BATCH * (1 + EVAL_BATCHES), size, EVAL_OBJECTS, 0)
    batches = list(batches_of({"obss": obs, "masks": masks}, EVAL_BATCH))
    ocr, _ = get_ocr(ocr_cfg, env_cfg, OCRCheckpointConfig(), seed=0)
    evaluate(ocr, batches[:1], seed=0)                      # warm-up, outside the count
    reset_launches()
    results = evaluate(ocr, batches[1:], seed=1)
    launches = dict(LAUNCHES)
    per_batch = {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1,
                 slot_routing.KERNEL: 2 * sa.num_iterations}
    expected = {k: n * EVAL_BATCHES for k, n in per_batch.items()}
    loss_ms = 1e3 * np.array([b["loss_s"] for b in results["batches"]])
    gen_ms = 1e3 * np.array([b["gen_s"] for b in results["batches"]])
    seconds = (loss_ms.sum() + gen_ms.sum()) / 1e3
    print(f"  {card}: {EVAL_BATCHES} batches of {EVAL_BATCH}: "
          f"{(loss_ms + gen_ms).mean():.3f} ms/batch ({EVAL_BATCH * EVAL_BATCHES / seconds:.1f} "
          f"images/s): loss part {loss_ms.mean():.3f} ms (per batch "
          f"{' '.join(f'{x:.3f}' for x in loss_ms)}), gen_imgs part {gen_ms.mean():.3f} ms "
          f"({' '.join(f'{x:.3f}' for x in gen_ms)}); ari {results['ari']:.6f}, gen mse "
          f"{results['mse']:.4f}", flush=True)
    print(f"  launches {launches}, expected {expected}", flush=True)
    if launches != expected:
        raise SystemExit("the evaluation path did not launch each kernel as expected")
    if not (np.isfinite([results["ari"], results["mse"]]).all()
            and -1.0 <= results["ari"] <= 1.0 and results["mse"] > 0):
        raise SystemExit(f"evaluation results out of range: {results}")
    check_eval(ocr, batches[1])

    sa_ocr, _ = get_ocr(config_replace(ocr_cfg, "use_bcdec", True), env_cfg,
                        OCRCheckpointConfig(), seed=0)
    evaluate(sa_ocr, batches[:1], seed=0)                   # warm-up, outside the count
    reset_launches()
    sa_results = evaluate(sa_ocr, batches[1:2], seed=1)
    sa_launches = dict(LAUNCHES)
    sa_expected = {slot_routing.KERNEL: sa.num_iterations}
    print(f"  slotattention (use_bcdec), one batch of {EVAL_BATCH}: "
          f"{1e3 * sa_results['batches'][0]['loss_s']:.3f} ms; ari {sa_results['ari']:.6f}, "
          f"mse {sa_results['mse']:.4f}; launches {sa_launches}, expected {sa_expected}",
          flush=True)
    if sa_launches != sa_expected or not np.isfinite(sa_results["mse"]):
        raise SystemExit("the Slot-Attention evaluation did not launch each kernel as expected")
    check_eval(sa_ocr, batches[1])
    return launches, sa_launches, dict(ocr=ocr, batch=batches[1])


def _close_leaves(got: dict, want: dict, floor: float) -> float:
    """The worst |got - want| over RL_TOL x max(the leaf's largest |want|,
    floor), over the leaves of two state dicts."""
    worst = 0.0
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        worst = max(worst, err / (RL_TOL * max(w.abs().max().item(), floor)))
    return worst


def check_update(cfg, data: dict, idx: torch.Tensor) -> None:
    """One minibatch update of a fresh policy (seed 0) through the kernels
    against the same update on the plain sweep, fed the same minibatch and
    slot noise."""
    sa = cfg.ocr.slotattr
    noise = torch.randn((idx.numel(), sa.num_slots, sa.slot_size), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
    algos = [PPO(build_policy(cfg.policy_config(), seed=0), data["obs"].shape[1:], True,
                 cfg.num_envs, cfg.sb3.algo_kwargs, seed=0) for _ in range(2)]
    got = algos[0].update_minibatch(data, idx, noise)
    with plain_sweep():
        want = algos[1].update_minibatch(data, idx, noise)
    torch.cuda.synchronize()
    errs = {k: abs(got[k].item() - want[k].item()) / (RL_TOL * max(abs(want[k].item()),
                                                                    RL_METRIC_FLOOR))
            for k in want}
    worst_key = max(errs, key=errs.get)
    params = _close_leaves(algos[0].policy.state_dict(), algos[1].policy.state_dict(),
                           RL_PARAM_FLOOR)
    finite = all(torch.isfinite(v) for v in got.values())
    ok = errs[worst_key] <= 1 and params <= 1 and finite
    print(f"  update check against the plain sweep (minibatch of {idx.numel()}): loss "
          f"{got['loss'].item():.6f} vs {want['loss'].item():.6f}; metrics worst {worst_key} "
          f"at {errs[worst_key]:.3f} of its tolerance ({RL_TOL} of max(|value|, "
          f"{RL_METRIC_FLOOR})); parameters worst {params:.3f} of theirs ({RL_TOL} of "
          f"max(leaf max, {RL_PARAM_FLOOR})) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit("the PPO update disagrees with its plain version")


def rl_training_phase(card: str) -> dict:
    """One full PPO iteration through train_sb3.train, the update check,
    frozen updates and an evaluation. Returns the launch counts of its runs
    and what the profile needs."""
    cfg = compose(TrainSB3Config(), RL_ARGV)
    algo_cfg = cfg.sb3.algo_kwargs
    n_steps = algo_cfg.n_steps // cfg.num_envs
    updates = algo_cfg.n_epochs * -(-algo_cfg.n_steps // algo_cfg.batch_size)
    calls = n_steps + 1                       # the rollout's and the bootstrap value's
    sa = cfg.ocr.slotattr
    reset_launches()
    result = train_sb3.train(cfg)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    algo, it = result["algo"], result["algo"].last_iteration
    expected = {slot_routing.KERNEL: sa.num_iterations * (calls + updates),
                slot_routing.BWD_KERNEL: sa.num_iterations * updates}
    seconds = it["rollout_s"] + it["update_s"]
    print(f"  {card}: one PPO iteration (E2E slate-transformer, {RL_ARGV[4]}, "
          f"num_envs {cfg.num_envs}, n_steps {algo_cfg.n_steps}, batch {algo_cfg.batch_size}, "
          f"{algo_cfg.n_epochs} epochs) in {seconds:.3f} s: rollout {it['rollout_s']:.3f} s "
          f"({it['env_steps']} env steps, {it['env_steps'] / it['rollout_s']:.1f} env steps/s, "
          f"{1e3 * it['rollout_s'] / n_steps:.3f} ms a vector step), {it['updates']} updates "
          f"in {it['update_s']:.3f} s ({1e3 * it['update_s'] / it['updates']:.3f} ms an "
          f"update); metrics {result['metrics']}", flush=True)
    print(f"  launches {launches}, expected {expected} (B3 {sa.num_iterations} x ({calls} "
          f"policy calls + {updates} updates), B4 {sa.num_iterations} x {updates})", flush=True)
    if launches != expected or it["updates"] != updates or algo.num_timesteps != algo_cfg.n_steps:
        raise SystemExit("the PPO iteration did not launch each kernel as expected")
    if not all(np.isfinite(v) for v in result["metrics"].values()):
        raise SystemExit(f"PPO metrics are not finite: {result['metrics']}")

    # the policy call of the rollout alone, at E = num_envs
    env_cfg = cfg.env
    obs = np.stack([make_env(env_cfg, 1000 + i).reset() for i in range(cfg.num_envs)])
    act_ms = 1e3 * _timed_calls(lambda: torch.stack([t.float() for t in algo.act(obs)]).cpu(),
                                RL_ACT_CALLS)
    train_envs = make_vec_env(make_env, env_cfg, cfg.num_envs, seed=3000, mode=cfg.vec_env)
    try:
        train_envs.reset()
        actions = np.random.default_rng(1).integers(0, 4, (RL_ACT_CALLS + 3, cfg.num_envs))
        steps = iter(actions)
        step_ms = 1e3 * _timed_calls(lambda: train_envs.step(next(steps)), RL_ACT_CALLS)
    finally:
        train_envs.close()
    print(f"  policy call at E = {cfg.num_envs} (act, results to the host): {act_ms:.3f} ms; "
          f"the env step alone ({type(train_envs).__name__}, E = {cfg.num_envs}): "
          f"{step_ms:.3f} ms; each over {RL_ACT_CALLS} calls", flush=True)

    rng = np.random.default_rng(0)
    batch = {"obs": np.stack([make_env(env_cfg, 2000 + i).reset() for i in range(64)]),
             "actions": rng.integers(0, 4, 64).astype(np.int32),
             "logprobs": np.full(64, np.log(0.25), np.float32),
             "values": rng.standard_normal(64).astype(np.float32),
             "advantages": rng.standard_normal(64).astype(np.float32),
             "returns": rng.standard_normal(64).astype(np.float32)}
    data = algo.upload(batch)
    idx = torch.arange(algo_cfg.batch_size, device="cuda")
    check_update(cfg, data, idx)

    frozen = PPO(build_policy(cfg.policy_config(), seed=0), obs.shape[1:], True, cfg.num_envs,
                 algo_cfg, seed=0, freeze_ocr=True)
    ocr_start = {k: v.clone() for k, v in frozen.policy.ocr_module.state_dict().items()}
    perm = torch.randperm(64, device="cuda", generator=torch.Generator(device="cuda")
                          .manual_seed(3))
    reset_launches()
    t0 = time.perf_counter()
    for i in range(RL_FROZEN_UPDATES):
        m = frozen.update_minibatch(data, perm[(i % 2) * 32:(i % 2) * 32 + 32])
    torch.cuda.synchronize()
    frozen_ms = 1e3 * (time.perf_counter() - t0) / RL_FROZEN_UPDATES
    frozen_launches = dict(LAUNCHES)
    frozen_expected = {slot_routing.KERNEL: sa.num_iterations * RL_FROZEN_UPDATES}
    unchanged = all(torch.equal(v, ocr_start[k])
                    for k, v in frozen.policy.ocr_module.state_dict().items())
    print(f"  frozen OCR: {RL_FROZEN_UPDATES} updates, {frozen_ms:.3f} ms an update, launches "
          f"{frozen_launches}, expected {frozen_expected}; OCR parameters bitwise unchanged: "
          f"{'yes' if unchanged else 'NO'}; last loss {m['loss'].item():.6f}", flush=True)
    if frozen_launches != frozen_expected or not unchanged:
        raise SystemExit("the frozen-OCR update launched B4 or moved the OCR")

    eval_env = make_vec_env(make_env, env_cfg, RL_EVAL_ENVS, seed=cfg.seed + cfg.num_envs)
    counted = _CountedPredict(algo)
    try:
        reset_launches()
        t0 = time.perf_counter()
        metrics = evaluate_policy(counted, eval_env, n_episodes=RL_EVAL_EPISODES)
        eval_s = time.perf_counter() - t0
        eval_launches = dict(LAUNCHES)
    finally:
        eval_env.close()
    eval_expected = {slot_routing.KERNEL: sa.num_iterations * counted.calls}
    print(f"  evaluate_policy on {RL_EVAL_ENVS} envs, {RL_EVAL_EPISODES} episodes: {metrics}; "
          f"{counted.calls} policy calls in {eval_s:.3f} s ({1e3 * eval_s / counted.calls:.3f} "
          f"ms a vector step); launches {eval_launches}, expected {eval_expected}", flush=True)
    if eval_launches != eval_expected or not 0 <= metrics["success_rate"] <= 1:
        raise SystemExit("the evaluation did not launch B3 three times a policy call")
    return dict(launches=(launches, frozen_launches, eval_launches), algo=algo, frozen=frozen,
                data=data, idx=idx, obs=obs)


class _CountedPredict:
    """``algo``'s predict, counting its calls."""

    def __init__(self, algo):
        self.algo, self.calls, self.obs_shape = algo, 0, algo.obs_shape

    def predict(self, obs, deterministic: bool = False):
        self.calls += 1
        return self.algo.predict(obs, deterministic)


def _timed_calls(fn, reps: int) -> float:
    """Seconds per call of ``fn`` (which ends on the host), after 3 warm-up
    calls."""
    for _ in range(3):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def agent_evaluation_phase(card: str) -> None:
    """test_sb3 on the committed GT agent, beside the manifest's value for
    its seed; then its logits and values, card against CPU."""
    cell = json.loads(open("artifacts/manifests/round5_rl_evals.json").read())["cells"][AGENT_CELL]
    cfg = compose(TestSB3Config(), AGENT_ARGV)
    t0 = time.perf_counter()
    metrics = test_sb3.main(AGENT_ARGV)
    seconds = time.perf_counter() - t0
    index = cfg.agent_checkpoint.index
    print(f"  {card}: test_sb3 {AGENT} (seed {metrics['seed']}, slice {index}), "
          f"{cfg.n_eval_episodes} episodes on {min(cfg.n_eval_episodes, 20)} envs in "
          f"{seconds:.3f} s: success {metrics['success_rate']:.3f}, mean reward "
          f"{metrics['mean_reward']:.3f}, mean length {metrics['mean_ep_length']:.2f}; the "
          f"manifest's {AGENT_CELL} final for this seed {cell['final'][index]} (seeds spread "
          f"{min(cell['final'])}-{max(cell['final'])}; a sanity band, not a condition)",
          flush=True)
    if not 0 <= metrics["success_rate"] <= 1:
        raise SystemExit(f"test_sb3 gave {metrics}")
    env_cfg = config_replace(cfg.env, "render_mode", "state")
    env, states = make_env(env_cfg, 7), []
    obs, rng = env.reset(), np.random.default_rng(7)
    while len(states) < AGENT_STATES:
        states.append(obs)
        obs, _, done, _ = env.step(int(rng.integers(4)))
        if done:
            obs = env.reset()
    states = np.stack(states).astype(np.float32)
    cfg = config_replace(cfg, "env.render_mode", "state")
    outs = {}
    for device in ("cuda", "cpu"):
        algo, _ = test_sb3.load_agent(cfg, states.shape[1:], device)
        _, logits, values = algo.act_deterministic(states)
        outs[device] = (logits.cpu(), values.cpu())
        if device == "cpu":
            with torch.no_grad():
                outs["cpu64"] = algo.policy.double()(torch.from_numpy(states).double())
    errs = [(g - w).abs().max().item() / max(w.abs().max().item(), 1.0)
            for g, w in zip(outs["cuda"], outs["cpu"])]
    to64 = {d: max((a.double() - b).abs().max().item() for a, b in zip(outs[d], outs["cpu64"]))
            for d in ("cuda", "cpu")}
    ok = all(e <= RL_TOL for e in errs) and all(torch.isfinite(t).all() for t in outs["cuda"])
    print(f"  logits / values on {AGENT_STATES} env states, card against CPU: "
          f"{errs[0]:.3e} / {errs[1]:.3e} of max(|value|, 1) (tolerance {RL_TOL}) "
          f"{'ok' if ok else 'MISMATCH'}; from the float64 evaluation: card {to64['cuda']:.3e}, "
          f"CPU {to64['cpu']:.3e}", flush=True)
    if not ok:
        raise SystemExit("the GT agent's card and CPU outputs disagree")


def row_argv(name: str) -> list[str]:
    """A for_running.json row's overrides on OTHER_ENV, its OCR checkpoint
    the committed artifacts/encoders file of the same name where there is
    one, none otherwise (then the OCR trains end to end)."""
    row = dict(json.loads(open("for_running.json").read())["ocrs"][name])
    row.pop("tags")
    checkpoint = row.pop("pooling.ocr_checkpoint.local_file", "").split("/")[-1]
    argv = [f"{k}={v}" for k, v in row.items()] + [OTHER_ENV]
    if checkpoint in OTHER_CHECKPOINTS:
        argv.append(f"pooling.ocr_checkpoint.local_file=artifacts/encoders/{checkpoint}")
    return argv


def _outputs(policy, obs: torch.Tensor, noise):
    with torch.no_grad():
        logits, values = policy(obs, noise=noise)
    return logits.cpu().double(), values.cpu().double()


def card_against_cpu(label: str, cfg, policy, obs: np.ndarray, noise: np.ndarray | None,
                     tol: float) -> dict:
    """Logits and values of ``policy`` (on the card) and of the same weights
    on the CPU, in fp32 and in float64, on ``obs`` (uint8) with ``noise``:
    card against CPU within ``tol`` of max(|value|, 1); each side's distance
    from the float64 run printed beside it."""
    cpu = build_policy(cfg.policy_config(), seed=0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in policy.state_dict().items()})
    cpu.freeze_ocr = policy.freeze_ocr
    x = torch.from_numpy(obs).float() / 255.0
    t_noise = None if noise is None else torch.from_numpy(noise)
    outs = {"card": _outputs(policy, x.cuda(), None if t_noise is None else t_noise.cuda()),
            "cpu": _outputs(cpu, x, t_noise),
            "cpu64": _outputs(cpu.double(), x.double(),
                              None if t_noise is None else t_noise.double())}
    scale = [max(w.abs().max().item(), 1.0) for w in outs["cpu"]]
    err = max((g - w).abs().max().item() / s
              for g, w, s in zip(outs["card"], outs["cpu"], scale))
    to64 = {d: max((a - b).abs().max().item() / s
                   for a, b, s in zip(outs[d], outs["cpu64"], scale))
            for d in ("card", "cpu")}
    finite = all(torch.isfinite(t).all() for t in outs["card"])
    ok = err <= tol and finite
    print(f"  {label}: logits / values on {obs.shape[0]} observations, card against CPU "
          f"{err:.3e} of max(|value|, 1) (tolerance {tol}) {'ok' if ok else 'MISMATCH'}; "
          f"from the float64 run: card {to64['card']:.3e}, CPU {to64['cpu']:.3e}", flush=True)
    if not ok:
        raise SystemExit(f"{label}: the card and the CPU disagree")
    return dict(err=err, **to64)


def pooling_against_cpu(name: str, state: np.ndarray, rep_dim: int, num_slots: int,
                        *over: str) -> None:
    """One pooling (seed 0) on the card and on the CPU on ``state``: within
    OTHER_TOL of max(|value|, 1e-2)."""
    argv = [f"pooling={name}", "ocr=gt", OTHER_ENV, *over]
    cfg = compose(TrainSB3Config(), argv).pooling
    torch.manual_seed(0)
    module = create_pooling_module(cfg.name, rep_dim, num_slots, cfg).eval()
    with torch.no_grad():
        want = module(torch.from_numpy(state))
        got = module.cuda()(torch.from_numpy(state).cuda()).cpu()
    scale = max(want.abs().max().item(), 1e-2)
    err = (got - want).abs().max().item() / scale
    ok = err <= OTHER_TOL and torch.isfinite(got).all() and got.shape == want.shape
    print(f"  pooling {cfg.name}{' ' + ' '.join(over) if over else ''} on "
          f"{tuple(state.shape)}: card against CPU {err:.3e} of max(|value|, 1e-2) "
          f"(tolerance {OTHER_TOL}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit(f"the {cfg.name} pooling's card and CPU outputs disagree")


def other_ocrs_phase(card: str) -> dict:
    """Each OTHER_ROWS row through train_sb3.train for one PPO iteration at
    the cut depth, timed, its metrics finite and no kernel launched; its
    policy card against CPU; the five other poolings card against CPU; one
    end-to-end IODINE update. Returns the launch counts (none expected) and
    what the profile needs."""
    launches, keep = {}, {}
    rng = np.random.default_rng(0)
    for name in OTHER_ROWS:
        cfg = compose(TrainSB3Config(), row_argv(name) + OTHER_DEPTH + [
            f"run_dir=outputs/chip_smoke/other_ocrs/{name.split()[0]}-{len(keep)}"])
        algo_cfg = cfg.sb3.algo_kwargs
        n_steps = algo_cfg.n_steps // cfg.num_envs
        reset_launches()
        result = train_sb3.train(cfg)
        torch.cuda.synchronize()
        for k, v in LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        algo, it = result["algo"], result["algo"].last_iteration
        obs = np.stack([make_env(cfg.env, 1000 + i).reset() for i in range(cfg.num_envs)])
        act_ms = 1e3 * _timed_calls(
            lambda: torch.stack([t.float() for t in algo.act(obs)]).cpu(), RL_ACT_CALLS)
        seconds = it["rollout_s"] + it["update_s"]
        print(f"  {card}: {name} ({cfg.ocr.name} + {cfg.pooling.name} + "
              f"{cfg.sb3_acnet.name}, OCR {'frozen' if algo.policy.freeze_ocr else 'end to end'}"
              f"): one PPO iteration (num_envs {cfg.num_envs}, n_steps {algo_cfg.n_steps}, "
              f"batch {algo_cfg.batch_size}, {algo_cfg.n_epochs} epochs) in {seconds:.3f} s: "
              f"rollout {it['rollout_s']:.3f} s ({it['env_steps'] / it['rollout_s']:.1f} env "
              f"steps/s), {it['updates']} updates, {1e3 * it['update_s'] / it['updates']:.3f} "
              f"ms an update; policy call at E = {cfg.num_envs}: {act_ms:.3f} ms; metrics "
              f"{result['metrics']}", flush=True)
        if it["updates"] != algo_cfg.n_epochs * -(-algo_cfg.n_steps // algo_cfg.batch_size) \
                or algo.num_timesteps != n_steps * cfg.num_envs:
            raise SystemExit(f"{name}: the iteration did not run as configured")
        if not all(np.isfinite(v) for v in result["metrics"].values()):
            raise SystemExit(f"{name}: PPO metrics are not finite: {result['metrics']}")
        check_obs = np.stack([make_env(cfg.env, 3000 + i).reset() for i in range(OTHER_CHECK)])
        noise, tol = None, OTHER_TOL
        if cfg.ocr.name == "Iodine":
            o = cfg.ocr
            noise = rng.standard_normal((o.num_iterations, OTHER_CHECK, o.num_slots,
                                         o.slot_size)).astype(np.float32)
            tol = IODINE_CARD_TOL
        card_against_cpu(name, cfg, algo.policy, check_obs, noise, tol)
        keep[name] = dict(algo=algo, obs=obs, cfg=cfg)
    if launches:
        raise SystemExit(f"the other OCRs launched kernels of the SLATE path: {launches}")

    rep = np.random.default_rng(0).random((3, 5, 16)).astype(np.float32)
    grid = np.random.default_rng(1).random((2, 64 * 64, 8)).astype(np.float32)
    push = np.zeros((3, 5, 6), np.float32)
    push[:, :, 0], push[:, :, 1] = np.arange(5) % 4, np.arange(5) % 3
    push[:, :, -2:] = np.random.default_rng(2).uniform(-1, 1, (3, 5, 2))
    for name in ("rn", "mlp", "identity"):
        pooling_against_cpu(name, rep, 16, 5)
    for name in ("cnn_linear", "cnn_transformer"):
        pooling_against_cpu(name, grid, 8, 64 * 64)
    pooling_against_cpu("transformer", push, 6, 5, "pooling.push_embedding=True")

    # IODINE trained end to end (no checkpoint): one minibatch update of 32
    cfg = compose(TrainSB3Config(), [a for a in row_argv("iodine-transformer-0.01ent_coef")
                                     if "ocr_checkpoint" not in a])
    e2e = PPO(build_policy(cfg.policy_config(), seed=0), (64, 64, 3), True, cfg.num_envs,
              cfg.sb3.algo_kwargs, seed=0)
    batch = {"obs": np.stack([make_env(cfg.env, 2000 + i).reset() for i in range(32)]),
             "actions": rng.integers(0, 4, 32).astype(np.int32),
             "logprobs": np.full(32, np.log(0.25), np.float32),
             "values": rng.standard_normal(32).astype(np.float32),
             "advantages": rng.standard_normal(32).astype(np.float32),
             "returns": rng.standard_normal(32).astype(np.float32)}
    data, idx = e2e.upload(batch), torch.arange(32, device="cuda")
    before = {k: v.clone() for k, v in e2e.policy.ocr_module.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = e2e.update_minibatch(data, idx)
    torch.cuda.synchronize()
    update_ms = 1e3 * (time.perf_counter() - t0)
    moved = sum(not torch.equal(v, before[k])
                for k, v in e2e.policy.ocr_module.state_dict().items())
    finite = all(torch.isfinite(v) for v in m.values())
    print(f"  IODINE end to end: one update of 32 in {update_ms:.3f} ms (first call), loss "
          f"{m['loss'].item():.6f}, {moved} of {len(before)} OCR tensors moved; metrics "
          f"finite: {'yes' if finite else 'NO'}", flush=True)
    if not finite or moved == 0:
        raise SystemExit("the end-to-end IODINE update is not finite or moved no OCR weight")
    keep["iodine-e2e"] = dict(algo=e2e, data=data, idx=idx)
    return dict(launches=launches, keep=keep)


def pretraining_noise(ocr_cfg, env_cfg, B: int, rng) -> dict:
    """One step's draws as numpy, under the loss's noise key: the VAE's eps
    [B, latent], MAE's masking order [B, N], IODINE's eps [N, B, K, L]."""
    if ocr_cfg.name == "VAE":
        return {"eps": rng.standard_normal((B, ocr_cfg.latent_dim)).astype(np.float32)}
    if ocr_cfg.name == "MAE":
        N = (env_cfg.obs_size // ocr_cfg.patch_size) ** 2
        return {"masking": rng.random((B, N), dtype=np.float32)}
    return {"eps": rng.standard_normal((ocr_cfg.num_iterations, B, ocr_cfg.num_slots,
                                        ocr_cfg.slot_size)).astype(np.float32)}


def sure_entries(grads: dict, grads64: dict | None = None) -> tuple[dict, dict]:
    """Which entries of a first step's gradient (numpy by name) are sure, by
    name: where the gradient exceeds PRETRAIN_SURE of its leaf's largest and
    STEP_GRAD_FLOOR of the model's. With ``grads64``, the same step's
    gradient from a float64 run, an entry is sure only where the float64
    gradient clears both and the fp32 one lies within half of it: only then
    do the data, and not rounding, set its sign and size. Returns (the
    masks, the count of entries of each leaf that the float64 rule moved out
    of the fp32 rule's sure ones)."""
    def rule(gs: dict) -> dict:
        top = max(float(np.abs(g).max(initial=0.0)) for g in gs.values())
        return {n: (np.abs(g) > PRETRAIN_SURE * np.abs(g).max(initial=0.0))
                & (np.abs(g) > STEP_GRAD_FLOOR * top) for n, g in gs.items()}
    sure = rule(grads)
    if grads64 is None:
        return sure, {}
    sure64 = rule(grads64)
    kept = {n: sure64[n] & (np.abs(grads[n] - grads64[n]) <= 0.5 * np.abs(grads64[n]))
            for n in grads}
    return kept, {n: int((sure[n] & ~kept[n]).sum()) for n in grads}


def first_step_gap(grads: dict, start: dict, card: dict, cpu: dict, groups: dict,
                   floor: float, sure: dict | None = None) -> tuple[float, str, int, bool]:
    """Two sides' parameters after one first optimizer step from the same
    ``start`` (numpy by name), under the rule stated at PRETRAIN_TOL: an
    entry is sure where the CPU's gradient exceeds PRETRAIN_SURE of its
    leaf's largest and STEP_GRAD_FLOOR of the model's (``sure_entries``;
    ``sure``, its masks, where the caller has them). Returns (the worst
    deviation over max(|leaf|, ``floor``) on sure entries, its leaf, the
    count of the other entries, whether each of those moved on both sides
    within Adam's bound lr (1 + weight decay |p|) of ``groups``' name ->
    (lr, weight decay), plus one ulp of the parameter). Below those scales a gradient entry is mostly
    rounding (an attention's key bias has none in exact arithmetic), and
    Adam's first step g / (|g| + eps) turns it into any move up to lr."""
    if sure is None:
        sure = sure_entries(grads)[0]
    worst, where, noisy, bound_ok = 0.0, "", 0, True
    for name in grads:
        mask, want = sure[name], cpu[name]
        if mask.any():
            err = (float(np.abs(card[name] - want)[mask].max())
                   / max(float(np.abs(want).max()), floor))
            if err > worst:
                worst, where = err, name
        lr, decay = groups[name]
        # plus one ulp of the parameter: a step below it (SLATE's warm-up
        # starts its lr at 3.3e-9) moves the stored fp32 value by 0 or 1 ulp
        p0 = np.abs(start[name][~mask])
        bound = lr * (1 + decay * p0) * (1 + 1e-3) + np.spacing(p0.astype(np.float32))
        for side in (card, cpu):
            bound_ok &= bool((np.abs(side[name] - start[name])[~mask] <= bound).all())
        noisy += int((~mask).sum())
    return worst, where, noisy, bound_ok


def check_pretraining_step(ocr_cfg, env_cfg, obs: np.ndarray, noise: dict,
                           tol: float = PRETRAIN_TOL) -> dict:
    """One update of a fresh OCR (seed 0) on the card against the same
    update on the CPU, on ``obs`` (uint8) with ``noise`` (numpy) on both
    sides, under the rules stated at PRETRAIN_TOL. Returns what it found."""
    sides = {}
    for device in ("cuda", "cpu"):
        ocr = create_ocr(ocr_cfg, env_cfg, seed=0, device=device)
        start = {k: v.clone() for k, v in ocr.module.state_dict().items()}
        metrics = ocr.update(obs, None, 0, noise={k: torch.from_numpy(v).to(device)
                                                   for k, v in noise.items()})
        groups = {id(p): (g["lr"], g["weight_decay"]) for g in ocr.optimizer.adam.param_groups
                  for p in g["params"]}
        sides[device] = dict(
            metrics={k: float(v) for k, v in metrics.items()}, start=start,
            grads={n: p.grad.cpu() for n, p in ocr.module.named_parameters()},
            groups={n: groups[id(p)] for n, p in ocr.module.named_parameters()},
            after={k: v.cpu() for k, v in ocr.module.state_dict().items()})
    torch.cuda.synchronize()
    card, cpu = sides["cuda"], sides["cpu"]
    errs = {k: abs(card["metrics"][k] - v) / max(abs(v), 1.0) for k, v in cpu["metrics"].items()}
    worst_metric = max(errs, key=errs.get)
    metrics_ok = (set(card["metrics"]) == set(cpu["metrics"]) and errs[worst_metric] <= tol
                  and all(np.isfinite(v) for v in card["metrics"].values()))
    worst_grad, grad_ok, _ = compare_grads(card["grads"], cpu["grads"])
    def host(side: dict, key: str) -> dict:
        return {n: t.cpu().numpy() for n, t in side[key].items()}

    worst_param, _, noisy, bound_ok = first_step_gap(
        host(cpu, "grads"), host(cpu, "start"), host(card, "after"), host(cpu, "after"),
        cpu["groups"], 1e-2)
    param_ok = worst_param <= tol and bound_ok
    print(f"  {ocr_cfg.name}: one step at batch {obs.shape[0]}, card against CPU: metrics "
          f"worst {worst_metric} {errs[worst_metric]:.3e} of max(|value|, 1) (tolerance {tol}); "
          f"gradients worst {worst_grad:.3f} of their tolerance; parameters worst "
          f"{worst_param:.3e} of max(|leaf|, 1e-2) where |g| > {PRETRAIN_SURE} of its leaf's "
          f"largest and {STEP_GRAD_FLOOR} of the model's (tolerance {tol}), "
          f"{noisy} entries below within Adam's bound: "
          f"{'ok' if metrics_ok and grad_ok and param_ok else 'MISMATCH'}", flush=True)
    if not (metrics_ok and grad_ok and param_ok):
        raise SystemExit(f"{ocr_cfg.name}'s pretraining step disagrees between card and CPU")
    return dict(metric_err=errs[worst_metric], grad=worst_grad, param=worst_param)


def pretraining_phase(card: str) -> dict:
    """VAE, MAE-base and IODINE-large pretraining steps at full width (see
    PRETRAIN_OCRS), timed, each checked card against CPU, with a falling
    loss and no kernel launched; then get_ari_mse.evaluate of IODINE-large
    on two batches of EVAL_BATCH painted scenes, one of them card against
    CPU. Returns the launch counts (none expected) and the OCRs and their
    superbatches, for the profile."""
    env_cfg = EnvConfig()
    obs, _ = painted(TRAIN_BATCH, env_cfg.obs_size, EVAL_OBJECTS, seed=10)
    superbatch = np.concatenate([obs] * TRAIN_K)
    reset_launches()
    keep = {}
    for name in PRETRAIN_OCRS:
        ocr_cfg = pretraining_config(GROUPS["ocr"][name], TRAIN_BATCH)
        rng = np.random.default_rng(0)
        check_pretraining_step(ocr_cfg, env_cfg, obs[:PRETRAIN_CHECK],
                               pretraining_noise(ocr_cfg, env_cfg, PRETRAIN_CHECK, rng),
                               IODINE_CARD_TOL if ocr_cfg.name == "Iodine" else PRETRAIN_TOL)
        fixed = {k: torch.from_numpy(v).cuda()
                 for k, v in pretraining_noise(ocr_cfg, env_cfg, TRAIN_BATCH, rng).items()}
        ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
        before = ocr.get_loss(obs, noise=dict(fixed))["loss"].item()
        _, first = train_steps(ocr, [obs] * PRETRAIN_FALL, 0)      # and warm-up
        after = ocr.get_loss(obs, noise=dict(fixed))["loss"].item()
        windows, step = [], PRETRAIN_FALL
        while len(windows) < PRETRAIN_WINDOWS or sum(windows) < PRETRAIN_SECONDS:
            seconds, metrics = train_steps(ocr, [obs] * TRAIN_STEPS, step)
            windows.append(seconds)
            step += TRAIN_STEPS
        ms = sorted(1e3 * w / TRAIN_STEPS for w in windows)
        median = ms[len(ms) // 2]
        finite = all(torch.isfinite(v).all() for m in (first, metrics) for v in m.values())
        print(f"  {card}: {ocr_cfg.name} ({name}.yaml, lr {ocr_cfg.learning.lr:g}): "
              f"{len(windows)} windows of {TRAIN_STEPS} steps at batch {TRAIN_BATCH} "
              f"(update_many k={TRAIN_K}), {sum(windows):.3f} s: {median:.3f} ms/step "
              f"median ({ms[0]:.3f}-{ms[-1]:.3f}), {1e3 * TRAIN_BATCH / median:.1f} "
              f"images/s; last step { {k: round(v[-1].item(), 6) for k, v in metrics.items()} }; "
              f"loss on the fixed batch and noise {before:.6f} before, {after:.6f} after "
              f"{PRETRAIN_FALL} steps; metrics finite: {'yes' if finite else 'NO'}", flush=True)
        if not (finite and np.isfinite(after) and after < before):
            raise SystemExit(f"{ocr_cfg.name}: pretraining metrics not finite or the loss "
                             f"did not fall")
        keep[name] = dict(ocr=ocr, superbatch=superbatch)

    iodine = create_ocr(IodineConfig(), env_cfg, seed=0)
    eobs, emasks = painted(2 * EVAL_BATCH, env_cfg.obs_size, EVAL_OBJECTS, seed=11)
    batches = list(batches_of({"obss": eobs, "masks": emasks}, EVAL_BATCH))
    evaluate(iodine, batches[:1], seed=0)                            # warm-up
    drawn = [{}, {}]
    result = evaluate(iodine, batches, seed=0, noise=drawn)
    cpu = create_ocr(IodineConfig(), env_cfg, seed=0, device="cpu")
    want = evaluate(cpu, batches[:1], seed=0, noise=[{"eps": drawn[0]["eps"].cpu()}])
    got = result["batches"][0]
    ari_err, mse_err = abs(got["ari"] - want["ari"]), rel_err(got["mse"], want["mse"])
    ok = ari_err <= 1e-6 and mse_err <= IODINE_CARD_TOL and np.isfinite(
        [result["ari"], result["mse"]]).all()
    batch_ms = ", ".join(f"{1e3 * b['loss_s']:.3f}" for b in result["batches"])
    print(f"  {card}: get_ari_mse of IODINE-large on {len(batches)} batches of {EVAL_BATCH} "
          f"painted scenes: ari {result['ari']:.6f}, mse {result['mse']:.4f}, "
          f"{batch_ms} ms a batch; "
          f"batch 0 card against CPU: ari {got['ari']:.6f} vs {want['ari']:.6f}, mse "
          f"{got['mse']!r} vs {want['mse']!r}, {mse_err:.3e} relative (tolerance "
          f"{IODINE_CARD_TOL}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise SystemExit("IODINE's get_ari_mse disagrees between card and CPU")
    launches = dict(LAUNCHES)
    if launches:
        raise SystemExit(f"the pretraining phase launched kernels: {launches}")
    return dict(launches=launches, keep=keep)


def same_tree(a, b) -> bool:
    """Equal nested dicts of arrays, bitwise and in dtype."""
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys() and \
            all(same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def collect_phase(card: str, path) -> None:
    """The port's collector on OCR_ENV with masks into ``path``; the file
    read back through the port's reader against what the workers return."""
    import os

    env_cfg = read_env_config(OCR_ENV)
    workers = min(OCR_WORKERS, os.cpu_count() or 1)
    t0 = time.perf_counter()
    collect_dataset(env_cfg, OCR_TRAIN, OCR_VAL, num_proc=workers, with_masks=True,
                    out_file=path)
    seconds = time.perf_counter() - t0
    layout = read_layout(path)
    splits = (("TrainingSet", OCR_TRAIN, 0), ("ValidationSet", OCR_VAL, 10_000))
    for split, written, n, arrays in collect_chunks(env_cfg, splits, workers, 100000,
                                                    (True, True, False, False)):
        for key, arr in arrays.items():
            offset, shape, dtype = layout[split][key]
            stored = np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape)
            if dtype != arr.dtype or stored[written:written + n].tobytes() != arr.tobytes():
                raise SystemExit(f"{split}/{key} does not read back as the workers wrote it")
    sizes = {k: f"{np.dtype(d).name} {list(s)}" for k, (_, s, d) in layout["TrainingSet"].items()}
    print(f"  {card}: collected {OCR_TRAIN} + {OCR_VAL} images of env={OCR_ENV} "
          f"(masks) on {workers} workers in {seconds:.3f} s, "
          f"{(OCR_TRAIN + OCR_VAL) / seconds:.1f} images/s; {path.stat().st_size} bytes, "
          f"TrainingSet {sizes}; read back bitwise equal to the workers' arrays", flush=True)


def train_ocr_phase(card: str, workdir) -> dict:
    """The collector, then train_ocr.main of SLATE at full width on its
    file, then the run resumed (see the module docstring), in a temporary
    directory of ``workdir``. Returns the launch counts of the two runs and
    the path of the resumed run's model_latest.ckpt, copied into
    ``workdir`` (the multi-seed phase's frozen encoder)."""
    import shutil
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        path = Path(tmp) / f"{OCR_ENV}.hdf5"
        collect_phase(card, path)
        run_dir = Path(tmp) / "run"
        argv = OCR_ARGV + [f"dataset.datadir={path}", f"run_dir={run_dir}"]
        marks, evals, loads = {}, [], []
        update_many, eval_and_save, load = OCR.update_many, train_ocr.eval_and_save, \
            train_ocr.load

        def timed_update_many(self, obs, masks, step, k, **kwargs):
            if step == OCR_TIMED[0]:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            out = update_many(self, obs, masks, step, k, **kwargs)
            if step + k == OCR_TIMED[1]:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return out

        def timed_eval_and_save(model, val_dl, epoch, step, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eval_and_save(model, val_dl, epoch, step, *args)
            torch.cuda.synchronize()
            evals.append((step, time.perf_counter() - t0))
            return out

        def checked_load(ocr, **kwargs):
            saved = run_dir / "checkpoints" / "model_latest.ckpt"
            file_tree = ckpt.load_checkpoint(saved)[0] if saved.exists() else None
            out = load(ocr, **kwargs)
            loads.append((out, file_tree, ckpt.checkpoint_tree(ocr)))
            return out

        OCR.update_many, train_ocr.eval_and_save, train_ocr.load = \
            timed_update_many, timed_eval_and_save, checked_load
        try:
            reset_launches()
            first = train_ocr.main(argv + [f"max_steps={OCR_STEPS}"])
            first_launches = dict(LAUNCHES)
            first_evals = len(evals)
            records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
            first_samples = sum("samples" in r for r in records)
            saved_state = ckpt.checkpoint_tree(first["model"])
            reset_launches()
            second = train_ocr.main(argv + [f"max_steps={OCR_RESUMED}"])
            second_launches = dict(LAUNCHES)
        finally:
            OCR.update_many, train_ocr.eval_and_save, train_ocr.load = \
                update_many, eval_and_save, load

        records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
        train_steps_logged = sorted(r["_step"] for r in records if "train/loss" in r)
        finite = all(np.isfinite(v) for r in records for k, v in r.items()
                     if k.startswith(("train/", "val/")))
        val_steps = [r["_step"] for r in records if "val/loss" in r]
        keys = sorted(k for k in records[0] if k.startswith("train/"))
        files = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
        samples = [p for r in records for p in r.get("samples", [])]
        images = [png.decode((run_dir / p).read_bytes()) for p in samples]
        val_batches = -(-OCR_VAL // 24)
        iters = GROUPS["ocr"]["slate"].slotattr.num_iterations

        def expected(steps, n_evals, n_samples):
            return {gumbel.SOFT_KERNEL: steps + val_batches * n_evals + n_samples,
                    gumbel.IDS_KERNEL: steps + val_batches * n_evals,
                    slot_routing.KERNEL: iters * (steps + val_batches * n_evals + n_samples),
                    slot_routing.BWD_KERNEL: iters * steps}

        want_first = expected(OCR_STEPS, first_evals, first_samples)
        want_second = expected(OCR_RESUMED - OCR_STEPS, len(evals) - first_evals,
                               sum("samples" in r for r in records) - first_samples)
        (start, epoch, best), file_tree, loaded_tree = loads[1]
        bitwise = same_tree(loaded_tree, file_tree) and same_tree(file_tree, saved_state)
        loop_s = marks["t1"] - marks["t0"] - sum(
            s for step, s in evals[:first_evals] if OCR_TIMED[0] < step < OCR_TIMED[1])
        loop_images = (OCR_TIMED[1] - OCR_TIMED[0]) * 24

        # update_many alone on the same superbatches (epoch 0's order), in this process
        loader = DataLoader(H5Dataset(path, "TrainingSet"), 24, shuffle=True, seed=0)
        batches = list(loader)[OCR_TIMED[0]:OCR_TIMED[1]]
        staged = [{k: torch.from_numpy(np.concatenate([b[k] for b in batches[i:i + 4]])).cuda()
                   for k in batches[0]} for i in range(0, len(batches), 4)]
        model = second["model"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, sb in enumerate(staged):
            model.update_many(sb["obss"], sb["masks"], OCR_RESUMED + 4 * i, 4)
        torch.cuda.synchronize()
        alone_s = time.perf_counter() - t0
        encoder = Path(workdir) / "slate_encoder.ckpt"
        shutil.copy(run_dir / "checkpoints" / "model_latest.ckpt", encoder)

    print(f"  {card}: train_ocr.main ocr=slate to step {first['step']} (epoch "
          f"{first['epoch']}), then resumed to {second['step']}: {len(train_steps_logged)} "
          f"train records ({keys}), val/* at {val_steps}, all finite: "
          f"{'yes' if finite else 'NO'}; checkpoints {files}; {len(images)} sample PNGs of "
          f"{sorted({i.shape for i in images})} decoded", flush=True)
    print(f"  {card}: evaluations (step, s): "
          f"{[(s, round(t, 3)) for s, t in evals]}", flush=True)
    print(f"  {card}: the first run started from {loads[0][0]} (no file); the second "
          f"resumed at step {start}, epoch {epoch}, best {best:.6f}, its parameters and Adam "
          f"moments bitwise those of model_latest.ckpt and of the first run's final state: "
          f"{'yes' if bitwise else 'NO'}", flush=True)
    print(f"  {card}: the loop over steps {OCR_TIMED[0]}-{OCR_TIMED[1]} without its "
          f"evaluation: {loop_s:.3f} s, {loop_images / loop_s:.1f} images/s, "
          f"{1e3 * loop_s / (OCR_TIMED[1] - OCR_TIMED[0]):.3f} ms/step; update_many alone on "
          f"the same {len(staged)} superbatches: {alone_s:.3f} s, {loop_images / alone_s:.1f} "
          f"images/s, {1e3 * alone_s / (OCR_TIMED[1] - OCR_TIMED[0]):.3f} ms/step", flush=True)
    print(f"  launches: first run {first_launches}, expected {want_first} ({first_evals} "
          f"evaluations of {val_batches} batches, {first_samples} sample passes); resumed run "
          f"{second_launches}, expected {want_second}", flush=True)
    ok = (train_steps_logged == list(range(OCR_RESUMED)) and finite
          and val_steps == [32, 64, 64, 96, 96]
          and {"model_32.ckpt", "model_64.ckpt", "model_96.ckpt", "model_latest.ckpt",
               "model_best.ckpt"} <= set(files)
          and images and all(i.ndim == 3 and i.shape[-1] == 3 for i in images)
          and first_launches == want_first and second_launches == want_second
          and (first["step"], second["step"]) == (OCR_STEPS, OCR_RESUMED)
          and loads[0][0] == (0, 0, 1e10) and start == OCR_STEPS and bitwise)
    if not ok:
        raise SystemExit("the train-ocr phase failed a check")
    return dict(launches=(first_launches, second_launches), encoder=encoder)


def fixture_arrays(path) -> dict:
    """{group: {dataset: array}} of an HDF5 file, read by the port."""
    return {group: {key: read_array(path, spec) for key, spec in datasets.items()}
            for group, datasets in read_layout(path).items()}


def contiguous_twin(path, arrays: dict) -> None:
    """The arrays written by the port's own writer: contiguous, no filter."""
    offsets = create(path, {g: {k: (a.shape, a.dtype) for k, a in ds.items()}
                            for g, ds in arrays.items()})
    with open(path, "r+b") as f:
        for group, datasets in arrays.items():
            for key, array in datasets.items():
                f.seek(offsets[group][key])
                f.write(np.ascontiguousarray(array).tobytes())


def read_rate(path, split: str, reps: int = HDF5_RATE_REPS) -> tuple[float, float]:
    """(images/s, ms a batch) of read_slice over a split in batches of
    EVAL_BATCH, as the validation loader reads it, each pass from a fresh
    H5Dataset (no decoded chunk kept; the file in the page cache): the
    median of ``reps`` passes."""
    seconds = []
    for _ in range(reps):
        dataset = H5Dataset(path, split)
        n = len(dataset)
        t0 = time.perf_counter()
        for start in range(0, n, EVAL_BATCH):
            dataset.read_slice(start, min(start + EVAL_BATCH, n))
        seconds.append(time.perf_counter() - t0)
    s = float(np.median(seconds))
    return n / s, 1e3 * s / -(-n // EVAL_BATCH)


def key_rate(path, split: str, key: str, reps: int = HDF5_RATE_REPS) -> float:
    """images/s of one chunked dataset's decode and assembly alone
    (ChunkRows.read in reads of EVAL_BATCH rows, a fresh reader a pass)."""
    import os

    spec = read_layout(path)[split][key]
    seconds = []
    for _ in range(reps):
        fd = os.open(path, os.O_RDONLY)
        try:
            rows = ChunkRows(fd, spec)
            t0 = time.perf_counter()
            for start in range(0, spec.shape[0], EVAL_BATCH):
                rows.read(start, start + EVAL_BATCH)
            seconds.append(time.perf_counter() - t0)
        finally:
            os.close(fd)
    return spec.shape[0] / float(np.median(seconds))


@contextmanager
def loader_clock(module):
    """Times every H5Dataset.read_slice (the loader's host work, on the
    prefetch thread) and every wait of ``module``'s consumer for its next
    prefetched batch, while the block runs; keeps what each read returned
    (``batches``)."""
    read_slice, prefetch = H5Dataset.read_slice, module.prefetch_to_device
    clock = {"read_s": 0.0, "wait_s": 0.0, "reads": 0, "batches": []}

    def timed_read(self, start, stop):
        t0 = time.perf_counter()
        out = read_slice(self, start, stop)
        clock["read_s"] += time.perf_counter() - t0
        clock["reads"] += 1
        clock["batches"].append(out)
        return out

    def timed_prefetch(*args, **kwargs):
        items = prefetch(*args, **kwargs)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(items)
                except StopIteration:
                    return
                clock["wait_s"] += time.perf_counter() - t0
                yield item
        finally:
            items.close()

    H5Dataset.read_slice, module.prefetch_to_device = timed_read, timed_prefetch
    try:
        yield clock
    finally:
        H5Dataset.read_slice, module.prefetch_to_device = read_slice, prefetch


def hdf5_eval_cli(card: str, label: str, argv: list[str], expected: dict, images: int) -> dict:
    """One counted run of get_ari_mse.main over ``images`` images: its
    results, launches (held to ``expected``), wall seconds and loader clock,
    printed."""
    reset_launches()
    with loader_clock(get_ari_mse) as clock:
        t0 = time.perf_counter()
        results = get_ari_mse.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    per_batch = 1e3 * np.array([b["loss_s"] + b["gen_s"] for b in results["batches"]])
    records = [json.loads(line) for line in open(Path(results["run_dir"]) / "metrics.jsonl")]
    logged = records[-1]
    print(f"  {card}: get_ari_mse {label}: {len(per_batch)} batches, {per_batch.mean():.3f} "
          f"ms/batch ({' '.join(f'{x:.1f}' for x in per_batch)}), {images / wall:.1f} "
          f"images/s over the run's {wall:.3f} s wall; loader: read_slice {clock['read_s']:.3f} "
          f"s in {clock['reads']} reads on the prefetch thread "
          f"({100 * clock['read_s'] / wall:.2f} % of the wall), the loop's waits for a batch "
          f"{clock['wait_s']:.3f} s ({100 * clock['wait_s'] / wall:.2f} %); ari "
          f"{results['ari']:.6f}, mse {results['mse']:.4f}; logged at step "
          f"{logged['_step']}: {sorted(k for k in logged if k.startswith('eval/'))}; launches "
          f"{launches}, expected {expected}", flush=True)
    if launches != expected:
        raise SystemExit(f"get_ari_mse {label} did not launch each kernel as expected")
    if not (logged["_step"] == 0 and logged["eval/ari"] == results["ari"]
            and logged["eval/mse"] == results["mse"]
            and np.isfinite([results["ari"], results["mse"]]).all()):
        raise SystemExit(f"get_ari_mse {label} logged {logged}, returned {results}")
    return dict(results=results, launches=launches, wall=wall, clock=clock)


def hdf5_eval_phase(card: str, workdir) -> dict:
    """The hdf5-eval phase (see the module docstring): the committed
    fixtures' hashes, the decode rates, get_ari_mse's command line on the
    gzip file and its contiguous twin, and train_ocr on the chunked
    TrainingSet. Returns the launch counts of its main-path runs."""
    import hashlib
    import tempfile

    manifest = json.loads((HDF5_FIXTURES / "manifest.json").read_text())
    indexes, checked = set(), 0
    for name, groups in manifest["files"].items():
        path = HDF5_FIXTURES / name
        for group, datasets in read_layout(path).items():
            for key, spec in datasets.items():
                want = groups[group][key]
                got = read_array(path, spec)
                indexes.add(getattr(spec, "index", "contiguous"))
                if ([list(got.shape), got.dtype.str] != [want["shape"], want["dtype"]]
                        or hashlib.sha256(got.tobytes()).hexdigest() != want["sha256"]):
                    raise SystemExit(f"{name}: {group}/{key} does not read as h5py read it")
                checked += 1
    print(f"  {card}: {checked} datasets of {len(manifest['files'])} fixture files read "
          f"bitwise as h5py read them (SHA-256 of the manifest); chunk indexes "
          f"{sorted(indexes)}", flush=True)

    gzip_file, lzf_file = HDF5_FIXTURES / "eval-gzip.h5", HDF5_FIXTURES / "lzf-fletcher32.h5"
    dataset_cfg = read_dataset_config(OCR_ENV)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tmp = Path(tmp)
        twin = tmp / "eval-twin.h5"
        arrays = fixture_arrays(gzip_file)
        contiguous_twin(twin, arrays)
        if not same_tree(fixture_arrays(twin), arrays):
            raise SystemExit("the contiguous twin does not read back as the gzip file")
        rates = {f"{label} {split}": read_rate(path, split)
                 for label, path in (("gzip", gzip_file), ("twin", twin), ("lzf", lzf_file))
                 for split in ("TrainingSet", "ValidationSet")}
        keys = {f"gzip {key}": key_rate(gzip_file, "ValidationSet", key)
                for key in ("obss", "masks")}
        keys["lzf+fletcher32 masks"] = key_rate(lzf_file, "ValidationSet", "masks")
        print(f"  {card}: read_slice in batches of {EVAL_BATCH}, a fresh reader a pass, "
              f"median of {HDF5_RATE_REPS} (page cache warm): " + "; ".join(
                  f"{k} {v[0]:.1f} images/s ({v[1]:.3f} ms a batch)" for k, v in rates.items())
              + "; chunked decode and assembly alone: " + "; ".join(
                  f"{k} {v:.1f} images/s" for k, v in keys.items()), flush=True)

        # the command line, on weights from seed 0 saved as the files it loads
        iters = GROUPS["ocr"]["slate"].slotattr.num_iterations
        slate_dir, sa_dir = tmp / "slate", tmp / "slotattention"
        ckpt.save(create_ocr(OCRConfig(), dataset_cfg, seed=0), slate_dir, step=0)
        ckpt.save(create_ocr(OCRConfig(use_bcdec=True), dataset_cfg, seed=0), sa_dir, step=0)
        batches = -(-HDF5_VAL // EVAL_BATCH)

        def argv(ocr: str, path, run: str) -> list[str]:
            weights = (slate_dir if ocr == "slate" else sa_dir) / "checkpoints"
            return [f"ocr={ocr}", f"dataset={OCR_ENV}", f"dataset.datadir={path}",
                    f"ocr_checkpoint.local_file={weights / 'model_latest.ckpt'}",
                    f"batch_size={EVAL_BATCH}", f"run_dir={tmp / run}"]

        def slate_launches(n: int) -> dict:
            return {gumbel.SOFT_KERNEL: n, gumbel.IDS_KERNEL: n, slot_routing.KERNEL: 2 * iters * n}

        runs = [hdf5_eval_cli(card, "slate on lzf-fletcher32 (warm-up)",
                              argv("slate", lzf_file, "warm"), slate_launches(1), HDF5_SMALL_VAL)]
        runs += [hdf5_eval_cli(card, f"slate on {label}", argv("slate", path, label),
                               slate_launches(batches), HDF5_VAL)
                 for label, path in (("eval-gzip", gzip_file), ("the twin", twin))]
        runs += [hdf5_eval_cli(card, f"slotattention on {label}",
                               argv("slotattention", path, f"sa-{label}"),
                               {slot_routing.KERNEL: iters * batches}, HDF5_VAL)
                 for label, path in (("eval-gzip", gzip_file), ("the twin", twin))]
        for a, b in ((runs[1], runs[2]), (runs[3], runs[4])):
            ra, rb = a["results"], b["results"]
            errs = {k: rel_err(ra[k], rb[k]) for k in ("ari", "mse")}
            # the CLI's own loader: every batch (obss with its masks) bitwise
            # the twin's, since the ARI of random weights need not see masks
            fed = [r["clock"]["batches"] for r in (a, b)]
            same = len(fed[0]) == len(fed[1]) == batches and all(
                same_tree(x, y) for x, y in zip(*fed))
            print(f"  {card}: gzip against the twin: ari {ra['ari']:.6f} vs {rb['ari']:.6f}, "
                  f"mse {ra['mse']:.6f} vs {rb['mse']:.6f}; relative {errs} (tolerance "
                  f"{EVAL_RTOL}); the CLI loader's {len(fed[0])} batches of "
                  f"{sorted(fed[0][0]) if fed[0] else []} bitwise the twin's: "
                  f"{'yes' if same else 'NO'}", flush=True)
            if max(errs.values()) > EVAL_RTOL or not same:
                raise SystemExit("get_ari_mse on the gzip file disagrees with its twin")

        # train_ocr on the chunked TrainingSet: the loader's batches first
        loaders = [DataLoader(H5Dataset(path, "TrainingSet"), 24, shuffle=True, seed=0)
                   for path in (gzip_file, twin)]
        for epoch in range(2):
            chunked, contiguous = (list(loader) for loader in loaders)
            if len(chunked) != len(contiguous) or not all(
                    same_tree(a, b) for a, b in zip(chunked, contiguous)):
                raise SystemExit("the chunked TrainingSet's batches differ from the twin's")
        run_dir = tmp / "train"
        reset_launches()
        with loader_clock(train_ocr) as clock:
            t0 = time.perf_counter()
            trained = train_ocr.main(["ocr=slate", f"dataset={OCR_ENV}",
                                      f"dataset.datadir={gzip_file}", "batch_size=24",
                                      "superbatch=4", "log_interval=8", "eval_interval=1000",
                                      f"max_steps={HDF5_TRAIN_STEPS}", f"run_dir={run_dir}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        train_launches = dict(LAUNCHES)
        records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
        samples = sum("samples" in r for r in records)
        val_batches = -(-HDF5_VAL // 24)
        want = {gumbel.SOFT_KERNEL: HDF5_TRAIN_STEPS + val_batches + samples,
                gumbel.IDS_KERNEL: HDF5_TRAIN_STEPS + val_batches,
                slot_routing.KERNEL: iters * (HDF5_TRAIN_STEPS + val_batches + samples),
                slot_routing.BWD_KERNEL: iters * HDF5_TRAIN_STEPS}
        steps = sorted(r["_step"] for r in records if "train/loss" in r)
        finite = all(np.isfinite(v) for r in records for k, v in r.items()
                     if k.startswith(("train/", "val/")))
    print(f"  {card}: the chunked TrainingSet's batches at 24, two shuffled epochs, bitwise "
          f"the twin's; train_ocr.main ocr=slate on eval-gzip.h5 to step {trained['step']}: "
          f"train records {steps}, one evaluation of {val_batches} batches, {samples} sample "
          f"pass(es), finite: {'yes' if finite else 'NO'}; {wall:.3f} s wall with the "
          f"evaluation and the save; loader: read_slice {clock['read_s']:.3f} s in "
          f"{clock['reads']} reads ({100 * clock['read_s'] / wall:.2f} % of the wall); "
          f"launches {train_launches}, expected {want}", flush=True)
    if not (train_launches == want and steps == list(range(HDF5_TRAIN_STEPS)) and finite
            and trained["step"] == HDF5_TRAIN_STEPS):
        raise SystemExit("train_ocr on the chunked file failed a check")
    return dict(launches=tuple(r["launches"] for r in runs) + (train_launches,))


def slot_routes(card: str, ocr, B: int) -> None:
    """One slot-attention forward of ``ocr``'s encoder at batch B on random
    features, through the kernels (``auto``) and through JAX's einsum route
    (``fused=never``, no launch): slots and attention within NEVER_TOL of the
    kernel route's largest entry, and each route's device ms."""
    enc = ocr.module.slotattn
    sa = enc.slot_attention
    gen = torch.Generator(device="cuda").manual_seed(B)
    x = torch.randn(B, 64 * 64, enc.layer_norm.normalized_shape[0], device="cuda",
                    generator=gen)
    noise = torch.randn(B, sa.num_slots, sa.slot_size, device="cuda", generator=gen)
    out, launches, ms = {}, {}, {}
    with torch.no_grad():
        for fused in ("auto", "never"):
            sa.fused = fused
            reset_launches()
            out[fused] = enc(x, noise=noise)
            torch.cuda.synchronize()
            launches[fused] = dict(LAUNCHES)
            ms[fused], = per_call_ms(lambda: enc(x, noise=noise))
    sa.fused = "auto"
    errs = [((n - k).abs().max() / k.abs().max()).item()
            for n, k in zip(out["never"], out["auto"])]
    ok = max(errs) <= NEVER_TOL and launches["never"] == {} and \
        launches["auto"] == {slot_routing.HEADS_KERNEL: sa.num_iterations}
    print(f"  {card}: slot attention at {B} x 4096 tokens, {sa.num_slots} slots of "
          f"{sa.slot_size} in {sa.num_heads} heads: fused=never against the kernel route: "
          f"slots {errs[0]:.2e}, attention {errs[1]:.2e} of their largest entry (tolerance "
          f"{NEVER_TOL}); device ms a forward: kernels {ms['auto']:.4f}, never (einsum) "
          f"{ms['never']:.4f} ({ms['never'] / ms['auto']:.3f} x); launches {launches}",
          flush=True)
    if not ok:
        raise SystemExit("fused=never disagrees with the kernel route, or launched a kernel")


def slot_shapes_phase(card: str, workdir) -> dict:
    """The slot-shapes phase (see the module docstring). Returns the launch
    counts of its main-path runs."""
    import tempfile

    gzip_file, lzf_file = HDF5_FIXTURES / "eval-gzip.h5", HDF5_FIXTURES / "lzf-fletcher32.h5"
    iters = GROUPS["ocr"]["slate"].slotattr.num_iterations
    val_batches = -(-HDF5_VAL // TRAIN_BATCH)
    batch = np.random.default_rng(0).integers(
        0, 256, (TRAIN_BATCH, 64, 64, 3), dtype=np.uint8)
    runs = []
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        for name, over in SLOT_SHAPES.items():
            run_dir = Path(tmp) / name
            argv = ["ocr=slate", *over, f"dataset={OCR_ENV}", f"dataset.datadir={gzip_file}",
                    f"batch_size={TRAIN_BATCH}", "superbatch=4", "log_interval=8",
                    "eval_interval=1000", f"max_steps={SLOT_STEPS}", f"run_dir={run_dir}"]
            cfg = compose(TrainOCRConfig(), argv)
            sa = cfg.ocr.slotattr
            print(f"  {card}: {name}: {sa.num_slots} slots of {sa.slot_size} in "
                  f"{sa.num_slot_heads} heads (train_ocr {' '.join(argv[:len(over) + 1])})",
                  flush=True)
            check_step(cfg.ocr, EnvConfig(), batch)
            calls, update_many = [], OCR.update_many

            def timed_update_many(self, obs, masks, step, k, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = update_many(self, obs, masks, step, k, **kwargs)
                torch.cuda.synchronize()
                calls.append((k, time.perf_counter() - t0))
                return out

            OCR.update_many = timed_update_many
            try:
                reset_launches()
                trained = train_ocr.main(argv)
                launches = dict(LAUNCHES)
            finally:
                OCR.update_many = update_many
            runs.append(launches)
            records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
            samples = sum("samples" in r for r in records)
            steps = sorted(r["_step"] for r in records if "train/loss" in r)
            finite = all(np.isfinite(v) for r in records for k, v in r.items()
                         if k.startswith(("train/", "val/")))
            want = {gumbel.SOFT_KERNEL: SLOT_STEPS + val_batches + samples,
                    gumbel.IDS_KERNEL: SLOT_STEPS + val_batches,
                    slot_routing.HEADS_KERNEL: iters * (SLOT_STEPS + val_batches + samples),
                    slot_routing.HEADS_BWD_KERNEL: iters * SLOT_STEPS}
            k, seconds = calls[-1]           # the last superbatch: past the warm-up
            print(f"  {card}: {name}: train_ocr.main to step {trained['step']} at batch "
                  f"{TRAIN_BATCH}: {1e3 * seconds / k:.3f} ms/step, "
                  f"{TRAIN_BATCH * k / seconds:.1f} images/s over its last {k} steps (the "
                  f"first {calls[0][0]}, with the warm-up: {1e3 * calls[0][1] / calls[0][0]:.3f} "
                  f"ms/step); train records {steps}, one evaluation of {val_batches} batches, "
                  f"{samples} sample pass(es), finite: {'yes' if finite else 'NO'}; launches "
                  f"{launches}, expected {want}", flush=True)
            if not (launches == want and steps == list(range(SLOT_STEPS)) and finite
                    and trained["step"] == SLOT_STEPS):
                raise SystemExit(f"train_ocr {name} failed a check")
            if name == "slate-heads4":
                weights = run_dir / "checkpoints" / "model_latest.ckpt"
                runs.append(hdf5_eval_cli(
                    card, f"{name} on lzf-fletcher32", [
                        "ocr=slate", *over, f"dataset={OCR_ENV}", f"dataset.datadir={lzf_file}",
                        f"ocr_checkpoint.local_file={weights}", f"batch_size={EVAL_BATCH}",
                        f"run_dir={Path(tmp) / 'eval'}"],
                    {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1,
                     slot_routing.HEADS_KERNEL: 2 * iters}, HDF5_SMALL_VAL)["launches"])
                slot_routes(card, trained["model"], TRAIN_BATCH)
    return dict(launches=tuple(runs))


def read_gif_blocks(data: bytes) -> tuple[int, int, int]:
    """(width, height, frames) of a GIF89a file, found by walking its blocks
    (header, screen, global palette, extensions, images, trailer)."""
    import struct

    if data[:6] != b"GIF89a":
        raise SystemExit("the video is not a GIF89a file")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    at = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames = 0
    while data[at] != 0x3b:
        if data[at] == 0x21:
            at += 2
        elif data[at] == 0x2c:
            frames += 1
            local = data[at + 9]
            at += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0) + 1
        else:
            raise SystemExit(f"a GIF block 0x{data[at]:02x} at byte {at}")
        while data[at]:
            at += data[at] + 1
        at += 1
    if at != len(data) - 1:
        raise SystemExit("bytes after the GIF trailer")
    return width, height, frames


def check_vmapped_sweeps(bw: float, flops: float, gen) -> dict:
    """B3 and B4 through the vmap rule (three seeds folded into the batch)
    against the plain sweep on the card at the multi-seed shapes (B3 at S
    times a rollout bucket's envs, by the deep rollout's own rule, at S x E
    and at S x an encode chunk; B4 at S x a minibatch), one launch
    each, bitwise repeatable; the rule's launch timed back to back between
    CUDA events beside its bound, and the vmapped call as a whole.
    torch.profiler is not used here: on vmapped calls it read below the
    bytes bound (0.073 ms at B = 48 against 0.091), so it misses kernel
    records there."""
    from torch.func import vjp, vmap

    S, (_, N, K, D) = len(MS_SEEDS), MS_SHAPE
    results = {}
    # a rollout bucket's policy call, a whole-env call (values, evaluation)
    # and the encode chunk
    for rows in (bucket_envs(MS_ENVS), MS_ENVS, MS_CHUNK):
        k = torch.randn(S, rows, N, D, device="cuda", generator=gen) * D ** -0.5
        v = torch.randn(S, rows, N, D, device="cuda", generator=gen)
        q = torch.randn(S, rows, K, D, device="cuda", generator=gen)
        fn = vmap(slot_routing.route_sweep)
        reset_launches()
        with torch.no_grad():
            got = fn(k, v, q)
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        want = slot_routing.route_sweep_reference(*(x.reshape((-1,) + x.shape[2:])
                                                    for x in (k, v, q)))
        errs = [(g.reshape(w.shape) - w).abs().max().item() / w.abs().max().item()
                for g, w in zip(got, want)]
        folded = [x.reshape((-1,) + x.shape[2:]) for x in (k, v, q)]
        with torch.no_grad():
            check_repeatable(f"vmapped route_sweep B={S * rows}", lambda: fn(k, v, q), got)
            ms = wall_ms(lambda: slot_routing._sweep_fwd(*folded))
            call_ms = wall_ms(lambda: fn(k, v, q))
        bound, by = sweep_bound_ms(S * rows, N, K, D, bw, flops)
        ok = launched == {slot_routing.KERNEL: 1} and max(errs) <= SWEEP_TOL
        print(f"  vmapped route_sweep, {S} seeds x {rows} rows = B {S * rows}: launches "
              f"{launched}; error/max against the plain sweep {max(errs):.2e} (tolerance "
              f"{SWEEP_TOL}) {'ok' if ok else 'MISMATCH'}; B3 at B {S * rows} (the rule's "
              f"launch, back to back between CUDA events) {ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}), {100 * bound / ms:.1f} % of it; the vmapped call {call_ms:.4f} ms",
              flush=True)
        if not ok:
            raise SystemExit("B3 under the vmap rule failed")
        results[S * rows] = dict(ms=ms, bound_ms=bound)
    rows = MS_BATCH
    k, v = (torch.randn(S, rows, N, D, device="cuda", generator=gen) for _ in range(2))
    q = torch.randn(S, rows, K, D, device="cuda", generator=gen)
    cot = (torch.randn(S, rows, K, device="cuda", generator=gen),
           torch.randn(S, rows, K, D, device="cuda", generator=gen),
           torch.randn(S, rows, N, K, device="cuda", generator=gen))

    def bwd():
        return vmap(lambda k, v, q, *c: vjp(slot_routing.route_sweep, k, v, q)[1](c))(
            k, v, q, *cot)

    reset_launches()
    got = bwd()
    torch.cuda.synchronize()
    launched = dict(LAUNCHES)
    leaves = [x.reshape((-1,) + x.shape[2:]).clone().requires_grad_() for x in (k, v, q)]
    want = torch.autograd.grad(slot_routing.route_sweep_reference(*leaves), leaves,
                               [c.reshape((-1,) + c.shape[2:]) for c in cot])
    errs = [(g.reshape(w.shape) - w).abs().max().item() / w.abs().max().item()
            for g, w in zip(got, want)]
    check_repeatable(f"vmapped route_sweep backward B={S * rows}", bwd, got)
    with torch.no_grad():                 # B4 as the rule launches it, [S * 32, ...]
        fold = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        _, _, a = slot_routing._sweep_fwd(*(fold(x) for x in (k, v, q)))
        g_a = (fold(cot[2]) + fold(cot[0])[:, None, :]).contiguous()
        ms = wall_ms(lambda: slot_routing._sweep_bwd(fold(k), fold(v), fold(q), a,
                                                     fold(cot[1]), g_a))
    call_ms = wall_ms(bwd)
    bound, by = sweep_bwd_bound_ms(S * rows, N, K, D, bw, flops)
    want_launches = {slot_routing.KERNEL: 1, slot_routing.BWD_KERNEL: 1}
    ok = launched == want_launches and max(errs) <= SWEEP_TOL
    print(f"  vmapped vjp of route_sweep, {S} seeds x {rows} rows = B {S * rows}: launches "
          f"{launched}, expected {want_launches}; error/max against autograd of the plain "
          f"sweep {max(errs):.2e} (tolerance {SWEEP_TOL}) {'ok' if ok else 'MISMATCH'}; B4 at "
          f"B {S * rows} (the rule's launch, back to back between CUDA events) {ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}), {100 * bound / ms:.1f} % of it; the vmapped vjp "
          f"(B3 and B4) {call_ms:.4f} ms", flush=True)
    if not ok:
        raise SystemExit("B4 under the vmap rule failed")
    results[S * rows] = dict(ms=ms, bound_ms=bound)
    return results


def adam_step_gap(mu1, nu1, mu2, nu2, count: int, b1: float, b2: float, eps: float):
    """|u1 - u2| elementwise for Adam's direction u = m_hat / (sqrt(v_hat) +
    eps) from two (mu, nu) after ``count`` steps: the parameter gap that the
    two moments explain, per unit of learning rate. Exact algebra, u1 - u2 =
    (m1 - m2) / (s2 + eps) + m1 (s2 - s1) / ((s1 + eps)(s2 + eps)), bounded
    by the triangle inequality. Below eps it amplifies a gradient gap by up
    to 1 / eps."""
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    m1, m2 = mu1 / c1, mu2 / c1
    s1, s2 = (nu1 / c2).sqrt(), (nu2 / c2).sqrt()
    return ((m1 - m2).abs() / (s2 + eps)
            + m1.abs() * (s1 - s2).abs() / ((s1 + eps) * (s2 + eps)))


def check_vmapped_update(cfg) -> None:
    """One end-to-end (finetuning) vmapped update of the three seeds, one
    minibatch each, against three single-seed PPO updates of the same
    seeds, minibatches and slot noise on the card; B4 launches once a slot
    iteration for all seeds. Metrics within RL_TOL of max(|value|,
    RL_METRIC_FLOOR); each Adam moment within RL_TOL of that moment's
    largest entry over the model (test_torch_rl.Pair.check's floor); each
    parameter within RL_TOL of max(its leaf's largest, RL_PARAM_FLOOR) where
    its gradient reaches Adam's eps, and below it within that plus lr x the
    gap that Adam's formula makes of the two moments there
    (``adam_step_gap``): the kernels sum in another order at S x 32 rows
    than at 32, and Adam's first step divides a gradient below eps by eps.
    Printed beside the checks, not held: the parameters against RL_TOL
    alone everywhere, and the moments against RL_TOL of each leaf's own
    scale (max(its largest, RL_PARAM_FLOOR x the moment's largest)), next
    to how far the same single-seed updates on the plain sweep lie from
    the kernels' at that scale (the conditioning of those gradients)."""
    from ocrl_tpu_torch.rl import MultiSeedPPO

    S, sa = len(MS_SEEDS), cfg.ocr.slotattr
    fresh = config_replace(cfg.policy_config(), "pooling.ocr_checkpoint.local_file", "")
    policies = [build_policy(fresh, seed=s) for s in MS_SEEDS]
    singles, plains = ([PPO(build_policy(fresh, seed=s), (64, 64, 3), True, cfg.num_envs,
                            cfg.sb3.algo_kwargs, seed=s) for s in MS_SEEDS] for _ in range(2))
    multi = MultiSeedPPO(policies, (64, 64, 3), True, cfg.num_envs, cfg.sb3.algo_kwargs,
                         MS_SEEDS)
    rng = np.random.default_rng(11)
    n = 2 * MS_BATCH
    batch = {"obs": np.stack([np.stack([make_env(cfg.env, 5000 + 100 * i + j).reset()
                                        for j in range(n)]) for i in range(S)]),
             "actions": rng.integers(0, 4, (S, n)).astype(np.int32),
             "logprobs": np.full((S, n), np.log(0.25), np.float32),
             **{key: rng.standard_normal((S, n)).astype(np.float32)
                for key in ("values", "advantages", "returns")}}
    idx = np.stack([rng.permutation(n)[:MS_BATCH] for _ in range(S)])
    noise = torch.randn((S, MS_BATCH, sa.num_slots, sa.slot_size), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(12))
    reset_launches()
    got = multi.update_minibatch(multi.upload(batch), idx, noise)
    torch.cuda.synchronize()
    launched = dict(LAUNCHES)
    worst = {"metrics": 0.0, "parameters": 0.0, "parameters below eps": 0.0, "mu": 0.0,
             "nu": 0.0}
    literal, unsure, per_leaf, plain_leaf = 0.0, 0, 0.0, 0.0
    for i, (single, plain) in enumerate(zip(singles, plains)):
        opt = single.optimizer
        data = single.upload({k: v[i] for k, v in batch.items()})
        want = single.update_minibatch(data, torch.as_tensor(idx[i], device="cuda"), noise[i])
        with plain_sweep():
            plain.update_minibatch(data, torch.as_tensor(idx[i], device="cuda"), noise[i])
        for k, w in want.items():
            worst["metrics"] = max(worst["metrics"], abs(got[k][i].item() - w.item()) / (
                RL_TOL * max(abs(w.item()), RL_METRIC_FLOOR)))
        moments = {key: ({n: t[i] for n, t in zip(multi.param_names,
                                                   getattr(multi.optimizer, key))},
                         dict(zip(single.param_names, getattr(opt, key))))
                   for key in ("mu", "nu")}
        for k, p in single.policy.named_parameters():
            diff = (multi.params[k][i] - p).abs()
            tol = RL_TOL * max(p.abs().max().item(), RL_PARAM_FLOOR)
            literal = max(literal, diff.max().item() / tol)
            (mu1, mu2), (nu1, nu2) = ((moments[key][0][k], moments[key][1][k])
                                      for key in ("mu", "nu"))
            sure = mu2.abs() >= (1 - opt.b1) * ADAM_EPS      # mu = (1 - b1) g after a step
            unsure += int((~sure).sum())
            if sure.any():
                worst["parameters"] = max(worst["parameters"], diff[sure].max().item() / tol)
            if not sure.all():
                gap = opt.lr * adam_step_gap(mu1, nu1, mu2, nu2, opt.count, opt.b1, opt.b2,
                                             opt.eps)
                worst["parameters below eps"] = max(worst["parameters below eps"], (
                    diff[~sure] / (tol + gap[~sure])).max().item())
        for key, (mine, theirs) in moments.items():
            top = max(t.abs().max().item() for t in theirs.values())
            on_plain = dict(zip(plain.param_names, getattr(plain.optimizer, key)))
            for k, w in theirs.items():
                err = (mine[k] - w).abs().max().item()
                worst[key] = max(worst[key], err / (RL_TOL * top))
                leaf = RL_TOL * max(w.abs().max().item(), RL_PARAM_FLOOR * top)
                per_leaf = max(per_leaf, err / leaf)
                plain_leaf = max(plain_leaf, (on_plain[k] - w).abs().max().item() / leaf)
    expected = {slot_routing.KERNEL: sa.num_iterations, slot_routing.BWD_KERNEL: sa.num_iterations}
    ok = launched == expected and all(v <= 1 for v in worst.values())
    print(f"  one vmapped end-to-end update of {S} seeds (minibatch {MS_BATCH} each) against "
          f"{S} single-seed PPO updates: worst of each tolerance ({RL_TOL} of max(|value|, "
          f"{RL_METRIC_FLOOR}) for metrics; for mu / nu {RL_TOL} of the moment's largest; "
          f"for parameters {RL_TOL} of max(leaf max, {RL_PARAM_FLOOR}) where the gradient "
          f"reaches Adam's eps {ADAM_EPS}, plus lr x Adam's step gap of the two moments on "
          f"the {unsure} entries below it): "
          f"{', '.join(f'{k} {v:.3f}' for k, v in worst.items())}; launches {launched}, "
          f"expected {expected} {'ok' if ok else 'MISMATCH'}. Not held: the parameters "
          f"against {RL_TOL} alone everywhere {literal:.3f} "
          f"({'met' if literal <= 1 else 'not met'}); mu / nu against {RL_TOL} of max(leaf "
          f"max, {RL_PARAM_FLOOR} x the moment's largest) {per_leaf:.3f} "
          f"({'met' if per_leaf <= 1 else 'not met'}), where the single-seed updates on the "
          f"plain sweep lie {plain_leaf:.3f} from the kernels'", flush=True)
    if not ok:
        raise SystemExit("the vmapped update disagrees with the single-seed updates")


def multi_seed_phase(card: str, encoder, bw: float, flops: float) -> dict:
    """train_sb3 with seeds= at full SLATE width on the frozen encoder
    ``encoder``, resumed for one more iteration, then test_sb3 with seeds=
    on its latest_model; the vmapped sweeps and the vmapped update checks.
    Returns the launch counts of the runs and the kernels' numbers."""
    import tempfile
    from pathlib import Path

    from ocrl_tpu_torch.rl import MultiSeedPPO
    from ocrl_tpu_torch.utils.checkpoint import agent_tree

    print(f"  cuts of the README protocol: {', '.join(MS_CUTS)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(13)
    sweeps = check_vmapped_sweeps(bw, flops, gen)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = Path(tmp) / "run"
        argv = MS_ARGV + MS_CUTS + [f"pooling.ocr_checkpoint.local_file={encoder}",
                                    f"run_dir={run_dir}"]
        cfg = compose(TrainSB3Config(), argv)
        iters = cfg.ocr.slotattr.num_iterations
        calls, loads = [0], []
        vmapped, learn, load_algo = MultiSeedPPO._vmapped, MultiSeedPPO.learn, \
            train_sb3.load_algo

        def counted(self, *args):
            calls[0] += 1
            return vmapped(self, *args)

        timing = {}

        def timed_learn(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = learn(self, *args, **kwargs)
            torch.cuda.synchronize()
            timing.setdefault("learn", []).append(time.perf_counter() - t0)
            return out

        def checked_load(path, algo, *args, **kwargs):
            file_tree = ckpt.load_checkpoint(path)[0]
            out = load_algo(path, algo, *args, **kwargs)
            loads.append((file_tree, agent_tree(algo)))
            return out

        MultiSeedPPO._vmapped, MultiSeedPPO.learn, train_sb3.load_algo = \
            counted, timed_learn, checked_load
        try:
            reset_launches()
            first = train_sb3.train(cfg)
            torch.cuda.synchronize()
            first_launches, first_calls = dict(LAUNCHES), calls[0]
            saved = agent_tree(first["algo"])
            calls[0] = 0
            reset_launches()
            second = train_sb3.train(compose(TrainSB3Config(), argv + [
                f"max_steps={2 * MS_STEPS}", f"resume={run_dir}/models/latest_model.ckpt"]))
            torch.cuda.synchronize()
            second_launches, second_calls = dict(LAUNCHES), calls[0]
            calls[0] = 0
            reset_launches()
            t0 = time.perf_counter()
            tested = test_sb3.main(MS_TEST_ARGV + [
                f"pooling.ocr_checkpoint.local_file={encoder}",
                f"agent_checkpoint.file={run_dir}/models/latest_model"])
            test_s = time.perf_counter() - t0
            test_launches, test_calls = dict(LAUNCHES), calls[0]
        finally:
            MultiSeedPPO._vmapped, MultiSeedPPO.learn, train_sb3.load_algo = \
                vmapped, learn, load_algo
        records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
        models = sorted(p.name for p in (run_dir / "models").iterdir())
        gifs = sorted((run_dir / "videos").glob("*.gif"))
        gif_blocks = [read_gif_blocks(p.read_bytes()) for p in gifs]
    algo, it = second["algo"], first["algo"].last_iteration
    S = len(algo.seeds)
    per_seed_keys = [k for r in records for k in r if "/seed" in k]
    finite = all(np.isfinite(v) for r in records for k, v in r.items()
                 if k.startswith(("train/", "eval/", "rollout/")))
    bitwise = same_tree(loads[0][0], loads[0][1]) and same_tree(loads[0][0], saved)

    def expected(n_calls):
        return {slot_routing.KERNEL: iters * n_calls}

    print(f"  {card}: train_sb3 seeds={cfg.seeds} (frozen SLATE encoder from train-ocr, "
          f"pipeline_rollout, cache_frozen_reps), {S} x {cfg.num_envs} envs, one iteration: "
          f"{timing['learn'][0]:.3f} s (rollout {it['rollout_s']:.3f} s, "
          f"{it['env_steps'] / it['rollout_s']:.1f} env steps/s; {it['updates']} vmapped "
          f"updates in {it['update_s']:.3f} s, {1e3 * it['update_s'] / it['updates']:.3f} ms an "
          f"update, the encode included); resumed to {algo.num_timesteps} timesteps in "
          f"{timing['learn'][1]:.3f} s", flush=True)
    print(f"  models {models}; GIFs {[p.name for p in gifs]} (width, height, frames) "
          f"{gif_blocks}; {len(set(per_seed_keys))} per-seed metric names, all finite: "
          f"{'yes' if finite else 'NO'}; the resumed state bitwise the file's and the first "
          f"run's final state: {'yes' if bitwise else 'NO'}", flush=True)
    print(f"  test_sb3 seeds= on latest_model, {MS_TEST_EPISODES} episodes a seed, in "
          f"{test_s:.3f} s: {tested['per_seed']}; summary {tested['summary']}", flush=True)
    print(f"  launches: first run {first_launches}, expected {expected(first_calls)} "
          f"({first_calls} vmapped policy, value and encode calls, B4 none: frozen); resumed "
          f"{second_launches}, expected {expected(second_calls)}; test_sb3 {test_launches}, "
          f"expected {expected(test_calls)}", flush=True)
    ok = (models == ["best_model.ckpt", "latest_model.ckpt"]      # one GIF a run
          and gif_blocks == [(64, 64, MS_VIDEO_FRAMES)] * 2
          and finite and bitwise and len(loads) == 1
          and {f"eval/seed{s}/success_rate" for s in algo.seeds} <= set(per_seed_keys)
          and first_launches == expected(first_calls)
          and second_launches == expected(second_calls)
          and test_launches == expected(test_calls)
          and sorted(tested["per_seed"]) == sorted(f"seed{s}" for s in algo.seeds)
          and all(np.isfinite(v) for m in tested["per_seed"].values() for v in m.values())
          and algo.num_timesteps == 2 * MS_STEPS * S)
    if not ok:
        raise SystemExit("the multi-seed phase failed a check")

    obs = np.stack([make_env(cfg.env, 9000 + i).reset() for i in range(S * cfg.num_envs)])
    grouped = obs.reshape((S, cfg.num_envs) + obs.shape[1:])
    act_ms = 1e3 * _timed_calls(lambda: algo.act_device(grouped).cpu(), RL_ACT_CALLS)
    bucket = np.ascontiguousarray(grouped[:, :bucket_envs(cfg.num_envs)])
    bucket_ms = 1e3 * _timed_calls(lambda: algo.act_device(bucket).cpu(), RL_ACT_CALLS)
    singles = [PPO(build_policy(cfg.policy_config(), seed=s), obs.shape[1:], True,
                   cfg.num_envs, cfg.sb3.algo_kwargs, seed=s) for s in MS_SEEDS]
    reset_launches()
    singles_ms = 1e3 * _timed_calls(
        lambda: [torch.stack([t.float() for t in p.act(grouped[i])]).cpu()
                 for i, p in enumerate(singles)], RL_ACT_CALLS)
    single_launches = LAUNCHES.get(slot_routing.KERNEL, 0) // (RL_ACT_CALLS + 3)
    print(f"  vmapped policy call at S x E = {S * cfg.num_envs} (act, results to the host): "
          f"{act_ms:.3f} ms; {S} single-seed PPO.act calls at E = {cfg.num_envs}, one after "
          f"the other: {singles_ms:.3f} ms in all ({single_launches} B3 launches, against "
          f"{iters} for the vmapped call); each over {RL_ACT_CALLS} calls; the rollout's "
          f"vmapped call at S x {bucket.shape[1]} = {S * bucket.shape[1]} (a bucket of the "
          f"deep rollout): {bucket_ms:.3f} ms", flush=True)
    check_vmapped_update(config_replace(cfg, "pooling.ocr_checkpoint.finetuning", True))
    return dict(launches=(first_launches, second_launches, test_launches), sweeps=sweeps)



def mapping_rss(arr: np.ndarray) -> int:
    """Resident bytes of the memory mapping that holds ``arr``'s data
    (/proc/self/smaps): what a lazily touched np.empty buffer costs."""
    address = arr.ctypes.data
    inside = False
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split()[0]
            if "-" in head and ":" not in head:
                lo, hi = (int(x, 16) for x in head.split("-"))
                inside = lo <= address < hi
            elif inside and head == "Rss:":
                return 1024 * int(line.split()[1])
    raise SystemExit("no mapping holds the replay buffer")


@contextmanager
def counted_predict(cls):
    """``cls.predict`` counting its calls (the evaluation's policy calls)."""
    calls, original = [0], cls.predict

    def predict(self, *args, **kwargs):
        calls[0] += 1
        return original(self, *args, **kwargs)

    cls.predict = predict
    try:
        yield calls
    finally:
        cls.predict = original


def sac_pair(cfg, space):
    """Two fresh SACs of ``cfg`` (seed 0: the same weights)."""
    from ocrl_tpu_torch.rl import SAC, build_sac_policy

    algos = []
    for _ in range(2):
        policy, _ = build_sac_policy(cfg, space, seed=0)
        algos.append(SAC(policy, (64, 64, 3), True, cfg.num_envs, cfg.sb3.algo_kwargs, seed=0,
                         action_low=space.low, action_high=space.high))
    return algos


def check_sac_update(cfg, space, batch: dict) -> None:
    """One end-to-end SAC update at the batch's size (256) through the
    kernels against the same update on the plain sweep, fed the same batch
    and draws: the losses, alpha and the entropy within RL_TOL of
    max(|value|, RL_METRIC_FLOOR); the target parameters and both Adams'
    moments within RL_TOL of max(the leaf's largest, RL_PARAM_FLOOR); each
    parameter so where its gradient reaches Adam's eps, and below it within
    that plus lr x the gap that Adam's formula makes of the two moments
    (``adam_step_gap``, check_vmapped_update's rule). Printed, not held: the
    parameters against RL_TOL alone everywhere."""
    sa = cfg.ocr.slotattr
    B = batch["obs"].shape[0]
    kernels, plain = sac_pair(cfg, space)
    gen = torch.Generator(device="cuda").manual_seed(21)
    noise = {k: torch.randn((B, sa.num_slots, sa.slot_size), device="cuda", generator=gen)
             for k in ("slots", "slots_next")}
    noise.update({k: torch.randn((B, space.shape[0]), device="cuda", generator=gen)
                  for k in ("eps_next", "eps_pi")})
    reset_launches()
    got = kernels.update(kernels.upload(batch), noise)
    torch.cuda.synchronize()
    launched = dict(LAUNCHES)
    with plain_sweep():
        want = plain.update(plain.upload(batch), noise)
    worst = {"metrics": max(abs(got[k].item() - w.item()) / (
        RL_TOL * max(abs(w.item()), RL_METRIC_FLOOR)) for k, w in want.items()),
        "targets": _close_leaves(kernels.target.state_dict(), plain.target.state_dict(),
                                 RL_PARAM_FLOOR),
        "mu": 0.0, "nu": 0.0, "parameters": 0.0, "parameters below eps": 0.0}
    literal, unsure = 0.0, 0
    params = dict(kernels.policy.named_parameters())
    theirs = dict(plain.policy.named_parameters())
    for group, opt in kernels.optimizers.items():
        popt = plain.optimizers[group]
        for i, name in enumerate(kernels.param_names[group]):
            for key in ("mu", "nu"):
                w = getattr(popt, key)[i]
                worst[key] = max(worst[key], (getattr(opt, key)[i] - w).abs().max().item() / (
                    RL_TOL * max(w.abs().max().item(), RL_PARAM_FLOOR)))
            diff = (params[name] - theirs[name]).abs()
            tol = RL_TOL * max(theirs[name].abs().max().item(), RL_PARAM_FLOOR)
            literal = max(literal, diff.max().item() / tol)
            sure = popt.mu[i].abs() >= (1 - popt.b1) * ADAM_EPS   # mu = (1 - b1) g
            unsure += int((~sure).sum())
            if sure.any():
                worst["parameters"] = max(worst["parameters"], diff[sure].max().item() / tol)
            if not sure.all():
                gap = opt.lr * adam_step_gap(opt.mu[i], opt.nu[i], popt.mu[i], popt.nu[i],
                                             opt.count, opt.b1, opt.b2, opt.eps)
                worst["parameters below eps"] = max(worst["parameters below eps"], (
                    diff[~sure] / (tol + gap[~sure])).max().item())
    expected = {slot_routing.KERNEL: 3 * sa.num_iterations,
                slot_routing.BWD_KERNEL: sa.num_iterations}
    finite = all(torch.isfinite(v).item() for v in got.values())
    ok = launched == expected and finite and all(v <= 1 for v in worst.values())
    print(f"  one end-to-end SAC update at batch {B} against the plain sweep (same batch and "
          f"draws): critic loss {got['critic_loss'].item():.6f} vs "
          f"{want['critic_loss'].item():.6f}, actor loss {got['actor_loss'].item():.6f} vs "
          f"{want['actor_loss'].item():.6f}, entropy {got['entropy'].item():.6f} vs "
          f"{want['entropy'].item():.6f}; worst of each tolerance ({RL_TOL} of max(|value|, "
          f"{RL_METRIC_FLOOR}) for metrics, of max(leaf max, {RL_PARAM_FLOOR}) for the rest; "
          f"parameters below Adam's eps {ADAM_EPS} ({unsure} entries) plus lr x Adam's step "
          f"gap): {', '.join(f'{k} {v:.3f}' for k, v in worst.items())}; launches "
          f"{launched}, expected {expected} {'ok' if ok else 'MISMATCH'}. Not held: the "
          f"parameters against {RL_TOL} alone everywhere {literal:.3f} "
          f"({'met' if literal <= 1 else 'not met'})", flush=True)
    if not ok:
        raise SystemExit("the SAC update disagrees with its plain version")


def check_cw_collector(card: str, path) -> None:
    """The CausalWorld collector (fake backend) into ``path``, read back
    against the workers' arrays made again in this process."""
    import os

    from ocrl_tpu_torch import collect_dataset_from_cw_envs as cw_collect

    name, num_tr, num_val = SAC_COLLECT
    env_cfg = config_replace(read_env_config(name), "use_fake_sim", True)
    workers = min(OCR_WORKERS, os.cpu_count() or 1)
    t0 = time.perf_counter()
    cw_collect.collect(env_cfg, num_tr, num_val, workers, path)
    seconds = time.perf_counter() - t0
    layout = read_layout(path)
    for split, total in (("TrainingSet", num_tr), ("ValidationSet", num_val)):
        per = [total // workers + (1 if r < total % workers else 0) for r in range(workers)]
        parts = [cw_collect._worker((env_cfg, 1000 * i, c)) for i, c in enumerate(per) if c]
        for key in parts[0]:
            arr = np.concatenate([p[key] for p in parts])
            offset, shape, dtype = layout[split][key]
            stored = np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape)
            if dtype != arr.dtype or stored.tobytes() != arr.tobytes():
                raise SystemExit(f"{split}/{key} does not read back as the workers wrote it")
    obss = layout["TrainingSet"]["obss"][1]
    print(f"  {card}: collect_dataset_from_cw_envs --env {name} --fake-sim: {num_tr} + "
          f"{num_val} images {list(obss[1:])} on {workers} workers in {seconds:.3f} s, "
          f"{(num_tr + num_val) / seconds:.1f} images/s; read back bitwise equal to the "
          f"workers' arrays", flush=True)


def sac_phase(card: str, encoder, workdir, bw: float, flops: float) -> dict:
    """SAC on cw-target-N4C4S1S1 through train_sb3 (see the module
    docstring): the end-to-end run, its resume, one update against the plain
    sweep, the frozen run on ``encoder``, B3 and B4 at the batch of 256, the
    collector. Returns the launch counts of the two runs, the kernels'
    numbers at 256 and what the profile needs."""
    import tempfile
    from pathlib import Path

    from ocrl_tpu_torch.envs.spaces import Box
    from ocrl_tpu_torch.rl import SAC, build_sac_policy
    from ocrl_tpu_torch.utils.checkpoint import agent_tree

    print(f"  cuts of configs/sb3/sac.yaml's run: {', '.join(SAC_CUTS)}", flush=True)
    iters = GROUPS["ocr"]["slate"].slotattr.num_iterations
    space = Box(-1.0, 1.0, (3,), np.float32)
    tmp = Path(tempfile.mkdtemp(dir=workdir))
    run = tmp / "run"
    cfg = compose(TrainSB3Config(), SAC_ARGV + SAC_CUTS + [f"run_dir={run}"])
    with counted_predict(SAC) as eval_calls:
        reset_launches()
        t0 = time.perf_counter()
        result = train_sb3.train(cfg)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    algo, totals = result["algo"], result["algo"].totals
    calls, updates = totals["policy_steps"], totals["updates"]
    expected = {slot_routing.KERNEL: iters * (calls + eval_calls[0]) + 3 * iters * updates,
                slot_routing.BWD_KERNEL: iters * updates}
    rss = sum(mapping_rss(getattr(algo.buffer, k)) for k in ("obs", "next_obs"))
    reserved = algo.buffer.obs.nbytes + algo.buffer.next_obs.nbytes
    E = cfg.num_envs
    print(f"  {card}: train_sb3 {' '.join(SAC_ARGV)} (end to end, seed 0) in {run_s:.3f} s: "
          f"{totals['random_steps']} random vector steps in {totals['random_s']:.3f} s "
          f"({E * totals['random_steps'] / totals['random_s']:.1f} env steps/s), {calls} "
          f"policy steps in {totals['policy_s']:.3f} s ({E * calls / totals['policy_s']:.1f} "
          f"env steps/s, the policy call included), {updates} updates at batch "
          f"{cfg.sb3.algo_kwargs.batch_size} in {totals['update_s']:.3f} s "
          f"({1e3 * totals['update_s'] / updates:.3f} ms an update, wall: sample, upload, "
          f"update, metrics to the host); {eval_calls[0]} evaluation calls at E = "
          f"{cfg.eval.num_envs}; eval {result['eval']}; metrics {result['metrics']}",
          flush=True)
    print(f"  replay buffer: {len(algo.buffer)} of {algo.buffer.capacity} rows, "
          f"{reserved / 2 ** 30:.2f} GiB of address space for obs and next_obs, "
          f"{rss / 2 ** 20:.1f} MiB resident", flush=True)
    print(f"  launches {launches}, expected {expected} (B3 {iters} x ({calls} policy calls + "
          f"{eval_calls[0]} evaluation calls) + {3 * iters} x {updates} updates, B4 {iters} x "
          f"{updates})", flush=True)
    gif = sorted((run / "videos").glob("*.gif"))
    gif_shape = read_gif_blocks(gif[0].read_bytes()) if gif else None
    files = sorted(p.name for p in (run / "models").iterdir())
    records = [json.loads(line) for line in open(run / "metrics.jsonl")]
    finite = all(np.isfinite(v) for r in records for k, v in r.items()
                 if k.startswith(("train/", "eval/")))
    train_records = sum("train/critic_loss" in r for r in records)
    print(f"  files: models {files}, GIFs {[p.name for p in gif]} ({gif_shape} as (width, "
          f"height, frames)), {train_records} train records, all metrics finite: "
          f"{'yes' if finite else 'NO'}", flush=True)
    if (launches != expected or (calls, updates) != (SAC_CALLS, SAC_UPDATES)
            or algo.num_timesteps != SAC_STEPS or eval_calls[0] == 0 or not finite
            or train_records != SAC_UPDATES or gif_shape != (256, 256, SAC_GIF_FRAMES)
            or files != ["best_model.ckpt", "latest_model.ckpt"] or rss >= 2 ** 30):
        raise SystemExit("the SAC run failed a check")

    latest = run / "models" / "latest_model.ckpt"
    resumed = train_sb3.train(compose(TrainSB3Config(), SAC_ARGV + SAC_CUTS + [
        f"run_dir={tmp / 'resumed'}", f"resume={latest}"]))
    bitwise = same_tree(agent_tree(resumed["algo"]), ckpt.load_checkpoint(latest)[0])
    print(f"  resumed from latest_model.ckpt at {resumed['algo'].num_timesteps} timesteps: "
          f"both networks, both Adams, log_alpha and num_timesteps bitwise the file's: "
          f"{'yes' if bitwise else 'NO'}", flush=True)
    if not bitwise:
        raise SystemExit("the resumed SAC state differs from its file")

    obs = np.stack([make_env(cfg.env, 4000 + i).reset() for i in range(E)])
    act_ms = 1e3 * _timed_calls(lambda: algo.act(obs).cpu(), SAC_ACT_CALLS)
    batch = algo.buffer.sample(cfg.sb3.algo_kwargs.batch_size, np.random.default_rng(3))
    data = algo.upload(batch)
    update_ms = 1e3 * _timed_calls(lambda: {k: v.item() for k, v in algo.update(data).items()},
                                   5)
    print(f"  policy call at E = {E} (act, actions to the host): {act_ms:.3f} ms over "
          f"{SAC_ACT_CALLS} calls; an update at batch {len(batch['obs'])} on an uploaded batch, "
          f"metrics to the host: {update_ms:.3f} ms over 5", flush=True)
    check_sac_update(cfg, space, batch)

    frozen_cfg = compose(TrainSB3Config(), SAC_ARGV + SAC_FROZEN_CUTS + [
        f"pooling.ocr_checkpoint.local_file={encoder}", f"run_dir={tmp / 'frozen'}"])
    fresh, pretrained = build_sac_policy(frozen_cfg, space, seed=frozen_cfg.seed)
    reset_launches()
    frozen = train_sb3.train(frozen_cfg)["algo"]
    torch.cuda.synchronize()
    frozen_launches = dict(LAUNCHES)
    f_calls, f_updates = frozen.totals["policy_steps"], frozen.totals["updates"]
    frozen_expected = {slot_routing.KERNEL: iters * f_calls + 3 * iters * f_updates}
    ocr_state = pretrained.module.state_dict()
    online = {k: torch.equal(v, ocr_state[k])
              for k, v in frozen.policy.ocr_module.state_dict().items()}
    pooling = {k: torch.equal(v, fresh.pooling_module.state_dict()[k])
               for k, v in frozen.policy.pooling_module.state_dict().items()}
    replay = [p.detach().clone() for p in fresh.ocr_module.parameters()]
    source = [p.detach() for p in frozen.policy.ocr_module.parameters()]
    for _ in range(f_updates):                   # SAC.polyak's arithmetic on the OCR alone
        torch._foreach_mul_(replay, 1 - frozen.cfg.tau)
        torch._foreach_add_(replay, torch._foreach_mul(source, frozen.cfg.tau))
    target = [p.detach() for p in frozen.target.ocr_module.parameters()]
    target_bitwise = all(torch.equal(t, r) for t, r in zip(target, replay))
    drift = max((t - p.detach()).abs().max().item()
                for t, p in zip(target, fresh.ocr_module.parameters()))
    to_online = max((t - s).abs().max().item() for t, s in zip(target, source))
    print(f"  frozen run on the train-ocr phase's SLATE file ({', '.join(SAC_FROZEN_CUTS)}): "
          f"{f_calls} policy calls, {f_updates} updates, launches {frozen_launches}, expected "
          f"{frozen_expected}; the online OCR bitwise the file's: "
          f"{'yes' if all(online.values()) else 'NO'}; the pooling bitwise its init (frozen "
          f"with the OCR, as JAX): {'yes' if all(pooling.values()) else 'NO'}; the target "
          f"OCR bitwise its random init after {f_updates} Polyak steps toward the online "
          f"one: {'yes' if target_bitwise else 'NO'} (max |target - init| {drift:.3e}, "
          f"|target - online| {to_online:.3e})", flush=True)
    if (frozen_launches != frozen_expected or f_updates != SAC_FROZEN_UPDATES
            or not all(online.values()) or not all(pooling.values()) or not target_bitwise):
        raise SystemExit("the frozen SAC run failed a check")

    gen = torch.Generator(device="cuda").manual_seed(256)
    shape = (cfg.sb3.algo_kwargs.batch_size, 64 * 64, 5, 192)
    sweep = check_sweep(shape, bw, flops, gen)
    sweep_bwd = check_sweep_bwd(shape, bw, flops, gen)
    check_cw_collector(card, tmp / "cw.hdf5")
    return dict(launches=(launches, frozen_launches), algo=algo, data=data, obs=obs,
                frozen=frozen, sweep=sweep, sweep_bwd=sweep_bwd)


def timed_calls(cls, name: str, log: list):
    """Replace ``cls.name`` by a wrapper that appends (start, end, B3
    launches) of each call to ``log``; returns the original. Each wrapped
    call brings its results to the host, so its end is the card's too."""
    original = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        before = LAUNCHES.get(slot_routing.KERNEL, 0)
        t0 = time.perf_counter()
        out = original(self, *args, **kwargs)
        log.append((t0, time.perf_counter(), LAUNCHES.get(slot_routing.KERNEL, 0) - before))
        return out

    setattr(cls, name, wrapper)
    return original


def loop_rate(log: list, batch: int) -> tuple[float, float]:
    """(ms a step, images/s) of the loop from step PROBE_TIMED to its last
    step: from that step's start to the last one's end."""
    steps = log[PROBE_TIMED:]
    seconds = steps[-1][1] - steps[0][0]
    return 1e3 * seconds / len(steps), batch * len(steps) / seconds


def worst_leaf(got: dict, want: dict) -> float:
    """The worst |got - want| over max(|want|, 1), leaf by leaf, of two
    nested dicts of arrays (JAX's trees) of the same keys."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return float("inf")
        return max([worst_leaf(got[k], want[k]) for k in want], default=0.0)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def worst_value(got: dict, want: dict) -> float:
    """The worst |got - want| over max(|want|, 1) of two dicts of numbers."""
    if got.keys() != want.keys():
        return float("inf")
    return max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1.0)
               for k in want)


def probe_configs(encoder) -> dict:
    """The probes' configs on ``encoder``: the property probe's, the
    classifier's and, for the aux-loss check, the classifier's pooling with
    ``learn_aux_loss`` and SLATE's dropout 0 (the card's and the CPU's
    generators draw different masks)."""
    pp = compose(TrainPropertyPredictorConfig(), PROBE_PP_ARGV + [
        f"ocr_checkpoint.local_file={encoder}"])
    cl = compose(TrainClassifierConfig(), PROBE_CL_ARGV + [
        f"pooling.ocr_checkpoint.local_file={encoder}"])
    aux = compose(TrainClassifierConfig(), PROBE_CL_ARGV + [
        f"pooling.ocr_checkpoint.local_file={encoder}", "pooling.learn_aux_loss=True",
        "ocr.learning.dropout=0"])
    return {"property": pp, "classifier": cl, "aux": aux}


def slot_noise(cfg, B: int, seed: int) -> np.ndarray:
    sa = cfg.ocr.slotattr
    return np.random.default_rng(seed).standard_normal(
        (B, sa.num_slots, sa.slot_size)).astype(np.float32)


def adam_side(named, optimizer) -> dict:
    """A probe's parameters and first Adam moments after its step, as numpy
    by name: {"params", "mu", "nu"}."""
    names = [n for n, _ in named]
    return {"params": {n: p.detach().cpu().numpy() for n, p in named},
            **{key: {n: t.cpu().numpy() for n, t in zip(names, values)}
               for key, values in (("mu", optimizer.mu), ("nu", optimizer.nu))}}


def first_adam_step_gap(card: dict, cpu: dict, init: dict, lr: float, grads64: dict,
                        b1: float = 0.9) -> tuple[float, int, bool, str, dict]:
    """Two sides' first Adam step (``adam_side``) from the same ``init``:
    (the worst deviation over max(|x|, 1) of the moments, and of the
    parameters under ``first_step_gap``'s rule, the CPU's gradient being
    its mu / (1 - b1) and the sure entries decided with ``grads64``, the
    step's float64 gradient (``sure_entries``); the count of the entries
    held to Adam's bound lr; whether all are; the worst leaf; by leaf, the
    entries the float64 rule moved out of the sure ones)."""
    worst, worst_name = 0.0, ""
    for key in ("mu", "nu"):
        for name, want in cpu[key].items():
            err = worst_leaf(card[key][name], want)
            if err > worst:
                worst, worst_name = err, f"{key} of {name}"
    grads = {n: m / (1 - b1) for n, m in cpu["mu"].items()}
    sure, moved = sure_entries(grads, grads64)
    param, where, noisy, bound_ok = first_step_gap(grads, init, card["params"], cpu["params"],
                                                   {n: (lr, 0.0) for n in grads}, 1.0, sure)
    if param > worst:
        worst, worst_name = param, where
    return worst, noisy, bound_ok, worst_name, moved


def moved_line(moved: dict, sizes: dict) -> tuple[str, bool]:
    """What the float64 rule moved out of the sure entries, and whether
    every leaf kept within MOVED_SHARE of its entries."""
    total = sum(moved.values())
    worst = max(moved, key=lambda n: moved[n] / sizes[n])
    share = moved[worst] / sizes[worst]
    return (f"the float64 rule moved {total} entries out of the sure ones (most: "
            f"{moved[worst]} of {sizes[worst]} in {worst})"), share <= MOVED_SHARE


def property_grads64(probe, start: dict, batch: dict, noise: np.ndarray,
                     matched: np.ndarray) -> dict:
    """A property update's gradient of every head parameter in float64 on
    the CPU: the same batch, slot noise and encoder features (the OCR in
    fp32, as the update runs it) and the same matched columns, the head
    (its parameters ``start``) and the loss in float64."""
    head = copy.deepcopy(probe.head).double()
    obs, target = probe._batch(batch)
    with torch.no_grad():
        for n, p in head.named_parameters():
            p.copy_(torch.from_numpy(start[n]))
        rep = probe._ocr.rep(obs, noise={"rep": torch.from_numpy(noise)}).double()
    B, S = rep.shape[:2]
    if probe._num_pseudo is None:
        output = head(rep.reshape(B * S, -1)).reshape(B, S, probe._per_slot_size)
    else:
        output = head(rep).reshape(B, probe._num_pseudo, probe._per_slot_size)
    cost = probe._pairwise_cost(output, target.double())
    loss = cost.gather(2, torch.from_numpy(matched)[..., None])[..., 0].sum()
    names = [n for n, _ in head.named_parameters()]
    grads = torch.autograd.grad(loss, list(head.parameters()))
    return {n: g.numpy() for n, g in zip(names, grads)}


def classifier_grads64(classifier, start: dict, batch: dict, noise: np.ndarray) -> dict:
    """A classifier step's gradient of every pooling and head parameter in
    float64 on the CPU: the same batch, slot noise and encoder features (the
    OCR in fp32, as the step runs it), the pooling and the head (their
    parameters ``start``, by ``check_classifier_step``'s names) and the loss
    in float64."""
    pooling, head = copy.deepcopy(classifier.pooling), copy.deepcopy(classifier.head)
    named = list(pooling.double().named_parameters()) + \
        [(f"head.{n}", p) for n, p in head.double().named_parameters()]
    with torch.no_grad():
        for n, p in named:
            p.copy_(torch.from_numpy(start[n]))
        rep = classifier.ocr.rep(batch["obss"], noise={"rep": torch.from_numpy(noise)})
    labels = torch.as_tensor(batch["labels"])[:, 0].to(torch.int64)
    ce = F.cross_entropy(head(pooling(rep.double())), labels)
    grads = torch.autograd.grad(ce, [p for _, p in named])
    return {n: g.numpy() for (n, _), g in zip(named, grads)}


def check_property_step(encoder, batch: dict) -> float:
    """One property update of a fresh probe (head from seed 0) on
    ``encoder``, card against CPU, on the same batch and slot noise:
    matched columns exactly; metrics, the head's Adam moments and its
    parameters to PROBE_TOL (``first_adam_step_gap``). Returns the worst
    deviation over its tolerance's scale."""
    from ocrl_tpu_torch.utils.property_predictor import PropertyPredictor

    cfg = probe_configs(encoder)["property"]
    noise = slot_noise(cfg, len(batch["obss"]), 16)
    sides = {}
    for device in ("cuda", "cpu"):
        ocr, _ = get_ocr(cfg.ocr, cfg.dataset, cfg.ocr_checkpoint, seed=0, device=device)
        probe = PropertyPredictor(ocr, cfg.property_predictor, cfg.dataset, seed=0)
        init = {n: p.detach().cpu().numpy().copy() for n, p in probe.head.named_parameters()}
        matched = []
        metrics = probe.update(batch, 0, noise={"rep": torch.from_numpy(noise).to(device)},
                               matched=matched)
        sides[device] = (metrics, matched[0],
                         adam_side(list(probe.head.named_parameters()), probe.optimizer))
        if device == "cpu":
            grads64 = property_grads64(probe, init, batch, noise, matched[0])
    (card, card_cols, card_adam), (cpu, cpu_cols, cpu_adam) = sides["cuda"], sides["cpu"]
    gap, noisy, bound_ok, where, moved = first_adam_step_gap(
        card_adam, cpu_adam, init, cfg.property_predictor.learning.lr, grads64)
    moved_text, moved_ok = moved_line(moved, {n: v.size for n, v in init.items()})
    worst = max(worst_value(card, cpu), gap)
    same_cols = np.array_equal(card_cols, cpu_cols)
    finite = all(np.isfinite(v) for v in card.values())
    print(f"  property update at {len(batch['obss'])}, card against CPU: matched columns "
          f"{'equal' if same_cols else 'DIFFER'}; metrics {worst_value(card, cpu):.3e}, head "
          f"and Adam moments {gap:.3e} ({where}) of max(|x|, 1) (tolerance {PROBE_TOL}), "
          f"{noisy} entries under Adam's bound: {'ok' if bound_ok else 'OUT'}; {moved_text} "
          f"(at most {MOVED_SHARE:.0%} of a leaf) {'ok' if moved_ok else 'TOO MANY'}; the "
          f"card's metrics {card}", flush=True)
    if not (same_cols and finite and worst <= PROBE_TOL and bound_ok and moved_ok):
        raise SystemExit("the property update disagrees between card and CPU")
    return worst


def check_classifier_step(encoder, batch: dict) -> float:
    """One classifier step (pooling from seed 1, head from seed 0) on
    ``encoder``, card against CPU, on the same batch and slot noise: loss,
    accuracy, the pooling's and the head's Adam moments and parameters to
    PROBE_TOL (``first_adam_step_gap``). Returns the worst deviation over
    its tolerance's scale."""
    from ocrl_tpu_torch.poolings import Pooling

    cfg = probe_configs(encoder)["classifier"]
    noise = slot_noise(cfg, len(batch["obss"]), 17)
    sides = {}
    for device in ("cuda", "cpu"):
        ocr, _ = get_ocr(cfg.ocr, cfg.dataset, cfg.pooling.ocr_checkpoint, seed=0,
                         device=device)
        classifier = train_classifier.Classifier(
            Pooling(ocr, cfg.pooling, seed=0), ocr, cfg.classifier.d_model,
            cfg.dataset.num_labels, cfg.classifier.learning.lr, seed=0)
        named = list(classifier.pooling.named_parameters()) + \
            [(f"head.{n}", p) for n, p in classifier.head.named_parameters()]
        init = {n: p.detach().cpu().numpy().copy() for n, p in named}
        loss = classifier.step(batch, noise={"rep": torch.from_numpy(noise).to(device)})
        sides[device] = (dict(zip(("loss", "acc"), loss)), adam_side(named, classifier.optimizer))
        if device == "cpu":
            grads64 = classifier_grads64(classifier, init, batch, noise)
    (card, card_adam), (cpu, cpu_adam) = sides["cuda"], sides["cpu"]
    gap, noisy, bound_ok, where, moved = first_adam_step_gap(
        card_adam, cpu_adam, init, cfg.classifier.learning.lr, grads64)
    moved_text, moved_ok = moved_line(moved, {n: v.size for n, v in init.items()})
    worst = max(worst_value(card, cpu), gap)
    print(f"  classifier step at {len(batch['obss'])}, card against CPU: loss and accuracy "
          f"{worst_value(card, cpu):.3e}, pooling, head and Adam moments {gap:.3e} ({where}) "
          f"of max(|x|, 1) (tolerance {PROBE_TOL}), {noisy} entries under Adam's bound: "
          f"{'ok' if bound_ok else 'OUT'}; {moved_text} (at most {MOVED_SHARE:.0%} of a "
          f"leaf) {'ok' if moved_ok else 'TOO MANY'}; the card's {card}", flush=True)
    if not (np.isfinite(card["loss"]) and worst <= PROBE_TOL and bound_ok and moved_ok):
        raise SystemExit("the classifier step disagrees between card and CPU")
    return worst


def check_aux_pooling(encoder, obs: np.ndarray) -> float:
    """One aux-loss Pooling call (pooling from seed 1) on ``encoder``, card
    against CPU, without autograd: the card draws B1's and B2's fields, the
    CPU takes their replay from the seeds the wrappers drew
    (ops.gumbel.replay_field, which must agree with the drawn fields to
    FIELD_TOL); slot noise of the loss and of the representation from
    numpy. The pooled output and every metric to PROBE_TOL; the call's
    launches B1 1, B2 1, B3 2 x 3. Returns the worst deviation over its
    tolerance's scale."""
    from ocrl_tpu_torch.poolings import Pooling

    cfg = probe_configs(encoder)["aux"]
    given = {"slots": slot_noise(cfg, len(obs), 18), "rep": slot_noise(cfg, len(obs), 19)}
    sides, fields = {}, {}
    for device in ("cuda", "cpu"):
        ocr, _ = get_ocr(cfg.ocr, cfg.dataset, cfg.pooling.ocr_checkpoint, seed=0,
                         device=device)
        pooling = Pooling(ocr, cfg.pooling, seed=0)
        noise = {k: torch.from_numpy(v).to(device) for k, v in {**given, **fields}.items()}
        if device == "cuda":
            state = ocr.generator.get_state()
            reset_launches()          # a check's launches, outside the main path's counts
        with torch.no_grad():
            pooled, metrics = pooling(obs, with_loss=True, noise=noise)
        if device == "cuda":
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            gen = torch.Generator(device="cuda")
            gen.set_state(state)
            seeds = [int(gumbel.draw_seed(gen, torch.device("cuda")).item()) for _ in range(2)]
            R, V = noise["soft"].shape
            replay = {key: gumbel.replay_field(seed, stream, R, V) for key, seed, stream in
                      (("soft", seeds[0], gumbel.SOFT_STREAM),
                       ("ids", seeds[1], gumbel.IDS_STREAM))}
            field_err = max((noise[k].double().cpu() - torch.from_numpy(v)).abs().max().item()
                            for k, v in replay.items())
            fields = {k: v.astype(np.float32) for k, v in replay.items()}
        sides[device] = (pooled.cpu().numpy(), {k: float(v) for k, v in metrics.items()})
    (card_pooled, card), (cpu_pooled, cpu) = sides["cuda"], sides["cpu"]
    worst = max(worst_leaf(card_pooled, cpu_pooled), worst_value(card, cpu))
    iters = cfg.ocr.slotattr.num_iterations
    expected = {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1, slot_routing.KERNEL: 2 * iters}
    print(f"  aux-loss Pooling call at {len(obs)} (dropout 0), card against CPU: pooled and "
          f"metrics worst {worst:.3e} of max(|x|, 1) (tolerance {PROBE_TOL}); the Gumbel "
          f"fields against their replay {field_err:.3e} (tolerance {FIELD_TOL}); launches "
          f"{launches}, expected {expected}; the card's metrics {card}", flush=True)
    if not (worst <= PROBE_TOL and field_err <= FIELD_TOL and launches == expected
            and "aux_loss" in card and np.isfinite(card["aux_loss"])):
        raise SystemExit("the aux-loss Pooling call disagrees between card and CPU")
    return worst


def probes_phase(card: str, encoder, workdir, bw: float, flops: float) -> dict:
    """The collector with labels and states, train_property_predictor.main
    and train_classifier.main at full SLATE width on ``encoder``, one epoch
    each, the card against the CPU, and B3 at the classifier's batch (see
    the module docstring). Returns the launch counts of the two runs and
    B3's numbers at 128."""
    import os
    import tempfile
    from pathlib import Path

    from ocrl_tpu_torch.utils import property_predictor as tpp

    iters = GROUPS["ocr"]["slate"].slotattr.num_iterations
    tmp = Path(tempfile.mkdtemp(dir=workdir))
    data = tmp / f"{PROBE_ENV}.hdf5"
    workers = min(OCR_WORKERS, os.cpu_count() or 1)
    t0 = time.perf_counter()
    collect_dataset(read_env_config(PROBE_ENV), PROBE_TRAIN, PROBE_VAL, num_proc=workers,
                    with_labels=True, with_states=True, out_file=data)
    seconds = time.perf_counter() - t0
    layout = read_layout(data)["TrainingSet"]
    sizes = {k: f"{np.dtype(d).name} {list(sh)}" for k, (_, sh, d) in layout.items()}
    print(f"  {card}: collected {PROBE_TRAIN} + {PROBE_VAL} images of env={PROBE_ENV} "
          f"(labels, states) on {workers} workers in {seconds:.3f} s, "
          f"{(PROBE_TRAIN + PROBE_VAL) / seconds:.1f} images/s; TrainingSet {sizes}", flush=True)
    if list(layout["objs"][1]) != [PROBE_TRAIN, 4, 5] or "labels" not in layout:
        raise SystemExit("the probes' file lacks its objects' states or labels")

    runs = {}
    for name, entry, argv, cls, method, batch in (
            ("property", train_property_predictor,
             PROBE_PP_ARGV + [f"ocr_checkpoint.local_file={encoder}"],
             tpp.PropertyPredictor, "update", 24),
            ("classifier", train_classifier,
             PROBE_CL_ARGV + [f"pooling.ocr_checkpoint.local_file={encoder}"],
             train_classifier.Classifier, "step", 128)):
        steps, matching = [], []
        evals = "get_loss" if name == "property" else "evaluate"
        val_calls = []
        saved = [(cls, method, timed_calls(cls, method, steps)),
                 (cls, evals, timed_calls(cls, evals, val_calls))]
        if name == "property":
            align = tpp.PropertyPredictor._align

            def timed_align(cost, align=align):
                t0 = time.perf_counter()
                out = align(cost)
                matching.append(time.perf_counter() - t0)
                return out

            tpp.PropertyPredictor._align = staticmethod(timed_align)
        try:
            reset_launches()
            t0 = time.perf_counter()
            result = entry.main(argv + [f"dataset.datadir={data}", f"run_dir={tmp / name}"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = dict(LAUNCHES)
        finally:
            for owner, attr, original in saved:
                setattr(owner, attr, original)
            if name == "property":
                tpp.PropertyPredictor._align = staticmethod(align)
        records = [json.loads(line) for line in open(tmp / name / "metrics.jsonl")]
        n_steps, n_val = len(steps), len(val_calls)
        expected = {slot_routing.KERNEL: iters * (n_steps + n_val)}
        per_call = {n for _, _, n in steps + val_calls}
        ms, rate = loop_rate(steps, batch)
        finite = all(np.isfinite(v) for r in records for k, v in r.items()
                     if k.startswith(("train/", "val/")))
        val = {k: round(v, 6) for r in records for k, v in r.items() if k.startswith("val/")}
        host = f", the host matching {1e3 * np.mean(matching[:n_steps]):.3f} ms a step" \
            if matching else ""
        print(f"  {card}: {name} probe ({' '.join(argv[:-1])}, the train-ocr phase's "
              f"checkpoint) in {run_s:.3f} s: {n_steps} "
              f"steps at batch {batch} and {n_val} validation batches; from step "
              f"{PROBE_TIMED}: {ms:.3f} ms a step, {rate:.1f} images/s{host}; B3 launches a "
              f"step or batch {sorted(per_call)}; launches {launches}, expected {expected}; "
              f"validation {val}; all records finite: {'yes' if finite else 'NO'}", flush=True)
        want_steps = PROBE_TRAIN // batch
        if (launches != expected or per_call != {iters} or n_steps != want_steps
                or n_val != -(-PROBE_VAL // batch) or not finite
                or sum("train/loss" in r for r in records) != want_steps):
            raise SystemExit(f"the {name} probe failed a check")
        runs[name] = dict(result=result, launches=launches)

    probe = runs["property"]["result"]["probe"]
    path = tmp / "property" / "checkpoints" / "model_best.ckpt"
    tree, metadata = ckpt.load_checkpoint(path)
    cfg = compose(TrainPropertyPredictorConfig(), PROBE_PP_ARGV)
    reloaded = tpp.PropertyPredictor(create_ocr(cfg.ocr, cfg.dataset, seed=1),
                                     cfg.property_predictor, cfg.dataset, seed=1)
    reloaded.load(tree)
    bitwise = same_tree(reloaded.save(), tree) and same_tree(probe.save(), tree)
    print(f"  the property probe's model_best.ckpt ({metadata}) reloaded by the port's "
          f"reader into a fresh probe: head, Adam and OCR bitwise the file's and the run's: "
          f"{'yes' if bitwise else 'NO'}", flush=True)
    if not bitwise:
        raise SystemExit("the property probe's file does not reload bitwise")

    batch = next(iter(DataLoader(H5Dataset(data, "TrainingSet"), 128, shuffle=True, seed=4)))
    worst = {"property": check_property_step(encoder, {k: v[:24] for k, v in batch.items()}),
             "classifier": check_classifier_step(encoder, batch),
             "aux": check_aux_pooling(encoder, batch["obss"][:24])}
    gen = torch.Generator(device="cuda").manual_seed(128)
    sweep = check_sweep((128, 64 * 64, 5, 192), bw, flops, gen)
    keep = dict(probe=probe, classifier=runs["classifier"]["result"]["classifier"],
                property_batch={k: v[:24] for k, v in batch.items()}, classifier_batch=batch)
    return dict(launches=(runs["property"]["launches"], runs["classifier"]["launches"]),
                sweep=sweep, worst=worst, keep=keep)


# -- ddp: data parallelism over torch.distributed ranks -----------------------

DDP_WORLD, DDP_BATCH, DDP_K, DDP_TIMED, DDP_WARMUP = 2, 24, 4, 10, 3
DDP_SECONDS = 300       # the ranks' deadline: a rank that hangs fails the run


@contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block: the ddp phase's
    comparisons then see the split of the batch and the collectives, not
    run-to-run rounding of cuDNN's atomic sums, which Adam's steps on
    near-zero gradients would turn into moves of up to lr."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def ddp_data(env_cfg) -> dict:
    """The global batches of the ddp phase (painted scenes of 4 objects and
    their masks), numpy, from fixed seeds."""
    size = env_cfg.obs_size
    obs, masks = zip(*(painted(DDP_BATCH, size, 4, seed=700 + i) for i in range(4)))
    many, _ = painted(DDP_K * DDP_BATCH, size, 4, seed=710)
    return {"obs": obs, "masks": masks, "many": many}


def host_metrics(metrics: dict) -> dict:
    return {k: torch.as_tensor(v).double().cpu().numpy() for k, v in metrics.items()}


def host_state(module) -> dict:
    """The module's state as numpy copies (a CPU tensor's .numpy() is a view)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def ranks_equal(ocr) -> bool:
    """Whether every rank holds bitwise the same parameters: the
    elementwise largest and smallest of their bits over the ranks agree."""
    import torch.distributed as dist

    bits = torch.cat([p.detach().reshape(-1).view(torch.int32)
                      for p in ocr.module.parameters()])
    top, low = bits.clone(), bits.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=ocr.group)
    dist.all_reduce(low, op=dist.ReduceOp.MIN, group=ocr.group)
    return bool(torch.equal(top, low))


def adam_groups(ocr) -> dict:
    """Each parameter's (lr of the last step, weight decay), by name."""
    groups = {id(p): (g["lr"], g["weight_decay"]) for g in ocr.optimizer.adam.param_groups
              for p in g["params"]}
    return {n: groups[id(p)] for n, p in ocr.module.named_parameters()}


def adam_moments(ocr) -> dict:
    """Adam's moments (m, v) of each parameter that has them, numpy, by name."""
    state = ocr.optimizer.adam.state
    return {n: (state[p]["exp_avg"].cpu().numpy().copy(),
                state[p]["exp_avg_sq"].cpu().numpy().copy())
            for n, p in ocr.module.named_parameters() if p in state}


def first_step(ocr, obs: np.ndarray, step: int = 0) -> dict:
    """One update at ``step`` from the OCR's state: its metrics, the state
    (and Adam's moments) before it and the parameters after it, the
    (clipped) gradients (zero where the loss reaches no parameter:
    Slot-Attention's dVAE and decoder), each parameter's (lr, weight decay)
    and Adam's step number t (1 at the first), numpy, for first_step_gap."""
    start, moments, t = host_state(ocr.module), adam_moments(ocr), ocr.optimizer.count + 1
    metrics = host_metrics(ocr.update(obs, None, step))
    return dict(metrics=metrics, start=start, moments=moments, t=t,
                params=host_state(ocr.module),
                grads={n: np.zeros(tuple(p.shape), np.float32) if p.grad is None
                       else p.grad.detach().cpu().numpy().copy()
                       for n, p in ocr.module.named_parameters()},
                groups=adam_groups(ocr))


def ddp_drive(ocr, data: dict, take, run_dir, load_dir=None) -> dict:
    """The ddp phase's calls on ``ocr`` (sharded or not): two updates (the
    second with masks), update_many of DDP_K, get_loss with masks,
    get_samples, a save to ``run_dir`` and a load from ``load_dir`` (else
    ``run_dir``), one more update; ``take(x, batches)`` gives the rows this
    process holds. Returns the metrics of each call, the first and the last
    update (``first_step``: the last one starts from the loaded file), the
    sample grid, the launches and, sharded, whether the ranks held bitwise
    equal parameters after each step's call."""
    sharded = ocr.shard is not None
    out = {"equal": []}
    reset_launches()

    def call(fn) -> dict:
        result = fn()
        if sharded:
            out["equal"].append(ranks_equal(ocr))
        return result

    out["first"] = call(lambda: first_step(ocr, take(data["obs"][0])))
    out["metrics"] = [out["first"]["metrics"]]
    out["metrics"].append(host_metrics(call(lambda: ocr.update(
        take(data["obs"][1]), take(data["masks"][1]), 1))))
    out["metrics"].append(host_metrics(call(lambda: ocr.update_many(
        take(data["many"], DDP_K), None, 2, DDP_K))))
    out["metrics"].append(host_metrics(ocr.get_loss(take(data["obs"][2]),
                                                    take(data["masks"][2]))))
    out["samples"] = ocr.get_samples(take(data["obs"][2]))["samples"]
    ckpt.save(ocr, run_dir, step=2 + DDP_K)
    ckpt.load(ocr, run_dir if load_dir is None else load_dir)
    out["last"] = call(lambda: first_step(ocr, take(data["obs"][3]), 2 + DDP_K))
    out["metrics"].append(out["last"]["metrics"])
    torch.cuda.synchronize()
    out["launches"] = dict(LAUNCHES)
    out["steps"] = 3 + DDP_K
    return out


def ddp_timed_ms(ocr, obs: np.ndarray) -> float:
    """ms an update of ``obs`` (this process's rows), DDP_TIMED steps after
    DDP_WARMUP, the ranks started together (a barrier) where sharded."""
    import torch.distributed as dist

    for i in range(DDP_WARMUP):
        ocr.update(obs, None, 100 + i)
    torch.cuda.synchronize()
    if ocr.shard is not None:
        dist.barrier(group=ocr.group)
    t0 = time.perf_counter()
    for i in range(DDP_TIMED):
        ocr.update(obs, None, 200 + i)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / DDP_TIMED


def ddp_bcdec(ocr, obs: np.ndarray, take) -> dict:
    """One Slot-Attention update (``first_step``) and its launches."""
    reset_launches()
    out = first_step(ocr, take(obs))
    torch.cuda.synchronize()
    out["launches"] = dict(LAUNCHES)
    return out


def _ddp_rank(rank: int, init: str, workdir: str, data: dict) -> None:
    """One of DDP_WORLD ranks on the card (gloo): the SLATE OCR made from
    its own seed, then shard_ocr (rank 0's state on every rank), the
    calls of ddp_drive on its rows, the timed steps, one Slot-Attention
    update; its results to ``workdir``."""
    import os

    import torch.distributed as dist

    from ocrl_tpu_torch.parallel import local_rows, make_group, shard_ocr

    torch.cuda.set_device(0)
    group = make_group("gloo", rank, DDP_WORLD, init)
    take = lambda x, batches=1: local_rows(x, (rank, DDP_WORLD), batches)  # noqa: E731
    ocr_cfg, env_cfg = OCRConfig(), EnvConfig()
    ocr = create_ocr(ocr_cfg, env_cfg, seed=rank)
    shard_ocr(ocr, group)
    with deterministic_cudnn():
        out = ddp_drive(ocr, data, take, os.path.join(workdir, "run"))
    out["ms"] = ddp_timed_ms(ocr, take(data["obs"][0]))
    bcdec = create_ocr(config_replace(ocr_cfg, "use_bcdec", True), env_cfg, seed=rank)
    shard_ocr(bcdec, group)
    with deterministic_cudnn():
        out["bcdec"] = ddp_bcdec(bcdec, data["obs"][3], take)
    out["equal"].append(ranks_equal(bcdec))
    if rank:   # rank 0's arrays stand for both; every rank's flags and counts
        out = {k: out[k] for k in ("metrics", "equal", "launches", "ms")} | {
            "bcdec": {k: out["bcdec"][k] for k in ("metrics", "launches")}}
    torch.save(out, os.path.join(workdir, f"ddp-{rank}.pt"))
    dist.destroy_process_group()


def spawn_ranks(fn, args: tuple, nprocs: int, seconds: float) -> None:
    """``fn(rank, *args)`` in ``nprocs`` fresh processes; a rank that raises
    fails the run, and so do ranks that outlive ``seconds`` (killed)."""
    context = torch.multiprocessing.start_processes(fn, args, nprocs=nprocs, join=False,
                                                    start_method="spawn")
    deadline = time.monotonic() + seconds
    while not context.join(timeout=5):
        if time.monotonic() > deadline:
            for p in context.processes:
                p.kill()
            raise SystemExit(f"the ranks did not finish in {seconds} s")


def adam_replay_gap(side: dict, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> tuple[float, str]:
    """One side's step (``first_step``'s record) against Adam replayed in
    float64 from its own state, moments and (clipped) gradients: torch's
    AdamW, p (1 - lr wd) - lr / (1 - b1^t) m / (sqrt(v / (1 - b2^t)) + eps).
    Each entry to the float32 rounding of that update (8 ulps of m's terms
    and 32 of the ratio, through lr / (1 - b1^t)) plus one ulp of the
    parameter, before or after (the step may cross a power of two). Returns
    (the worst share of that tolerance, its leaf)."""
    t, unit = side["t"], np.finfo(np.float32).eps
    worst, where = 0.0, ""
    for name, (lr, decay) in side["groups"].items():
        g = side["grads"][name].astype(np.float64)
        p0 = side["start"][name].astype(np.float64)
        m0, v0 = (x.astype(np.float64) for x in side["moments"].get(name, (0.0, 0.0)))
        m = m0 + (1 - b1) * (g - m0)
        den = np.sqrt((b2 * v0 + (1 - b2) * g * g) / (1 - b2 ** t)) + eps
        step = lr / (1 - b1 ** t)
        want = p0 * (1 - lr * decay) - step * m / den
        tol = (step * (8 * unit * (np.abs(m0) + np.abs(g)) + 32 * unit * np.abs(m)) / den
               + np.spacing(np.maximum(np.abs(side["start"][name]),
                                       np.abs(side["params"][name]))))
        share = float((np.abs(side["params"][name] - want) / tol).max())
        if share > worst:
            worst, where = share, name
    return worst, where


def check_nccl_rank(ocr_cfg, env_cfg, obs: np.ndarray, init: str) -> None:
    """One update of a full OCR (seed 0) as the only rank of an NCCL group
    against the same update in one process: bitwise equal metrics and
    parameters (the all-reduce of one rank and the division by 1 are exact).
    cuDNN runs deterministic algorithms on both sides for the check, so that
    the comparison sees the collective, not cuDNN's run-to-run rounding."""
    import torch.distributed as dist

    from ocrl_tpu_torch.parallel import make_group, shard_ocr

    with deterministic_cudnn():
        single = create_ocr(ocr_cfg, env_cfg, seed=0)
        want = host_metrics(single.update(obs, None, 0))
        group = make_group("nccl", 0, 1, init)
        try:
            ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
            shard_ocr(ocr, group)
            got = host_metrics(ocr.update(obs, None, 0))
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    same_metrics = set(got) == set(want) and all(
        np.array_equal(got[k], want[k]) for k in want)
    a, b = host_state(ocr.module), host_state(single.module)
    same_params = all(np.array_equal(a[k], b[k]) for k in b)
    print(f"  one NCCL rank (world 1) against one process, update at batch "
          f"{obs.shape[0]}: metrics bitwise {'yes' if same_metrics else 'NO'}, parameters "
          f"bitwise {'yes' if same_params else 'NO'}", flush=True)
    if not (same_metrics and same_params):
        raise SystemExit("the NCCL rank's step differs from one process's")


def ddp_phase(card: str, workdir) -> dict:
    """Two gloo ranks on the one card against one process (see the module
    docstring). Returns the ranks' launch counts and the step times."""
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp(dir=workdir))
    ocr_cfg, env_cfg = OCRConfig(), EnvConfig()
    iters = ocr_cfg.slotattr.num_iterations
    data = ddp_data(env_cfg)
    t0 = time.perf_counter()
    spawn_ranks(_ddp_rank, (f"file://{tmp}/init", str(tmp), data), DDP_WORLD, DDP_SECONDS)
    ranks = [torch.load(tmp / f"ddp-{r}.pt", weights_only=False) for r in range(DDP_WORLD)]
    spawn_s = time.perf_counter() - t0
    single = create_ocr(ocr_cfg, env_cfg, seed=0)
    take = lambda x, batches=1: x  # noqa: E731
    with deterministic_cudnn():
        want = ddp_drive(single, data, take, tmp / "single", tmp / "run")
    single_ms = ddp_timed_ms(single, data["obs"][0])
    bcdec = create_ocr(config_replace(ocr_cfg, "use_bcdec", True), env_cfg, seed=0)
    with deterministic_cudnn():
        want_bcdec = ddp_bcdec(bcdec, data["obs"][3], take)

    got = ranks[0]
    per_call = [max(worst_leaf(r["metrics"][i], w) for r in ranks)
                for i, w in enumerate(want["metrics"])]
    per_call.append(max(worst_leaf(r["bcdec"]["metrics"], want_bcdec["metrics"])
                        for r in ranks))
    worst = max(per_call)
    ranks_metrics = all(np.array_equal(a[k], b[k]) for a, b in
                        zip(ranks[0]["metrics"], ranks[1]["metrics"]) for k in a)
    equal = [all(flags) for flags in zip(*(r["equal"] for r in ranks))]

    def grads_gap(g: dict, w: dict) -> tuple[float, bool]:
        worst, ok, _ = compare_grads({k: torch.from_numpy(v) for k, v in g["grads"].items()},
                                     {k: torch.from_numpy(v) for k, v in w["grads"].items()})
        return worst, ok

    def first_gaps(g: dict, w: dict) -> tuple:
        """A first step of both sides from one state: the gradients by
        compare_grads, the parameters after it by first_step_gap."""
        return grads_gap(g, w) + first_step_gap(w["grads"], w["start"], g["params"],
                                                w["params"], w["groups"], 1e-2)

    def first_ok(gaps: tuple) -> bool:
        _, grad_ok, param, _, _, bound_ok = gaps
        return grad_ok and param <= PRETRAIN_TOL and bound_ok

    def first_line(gaps: tuple) -> str:
        grad, _, param, where, noisy, bound_ok = gaps
        return (f"gradients worst {grad:.3f} of their tolerance, parameters worst {param:.3e} "
                f"of max(|leaf|, 1e-2) ({where}; tolerance {PRETRAIN_TOL}), {noisy} entries "
                f"within Adam's bound: {'yes' if bound_ok else 'NO'}")

    first, bcdec = first_gaps(got["first"], want["first"]), first_gaps(got["bcdec"], want_bcdec)
    g_last, w_last = got["last"], want["last"]
    same_start = (all(np.array_equal(g_last["start"][k], v) for k, v in w_last["start"].items())
                  and all(np.array_equal(g_last["moments"][k][i], v[i])
                          for k, v in w_last["moments"].items() for i in (0, 1)))
    last_grad, last_grad_ok = grads_gap(g_last, w_last)
    (replay_got, replay_got_where), (replay_want, replay_want_where) = (
        adam_replay_gap(g_last), adam_replay_gap(w_last))

    sample_diff = np.abs(got["samples"].astype(int) - want["samples"].astype(int))
    samples_ok = (got["samples"].shape == want["samples"].shape and sample_diff.max() <= 1
                  and (sample_diff == 0).mean() > 0.99)
    per_step = {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1, slot_routing.KERNEL: iters,
                slot_routing.BWD_KERNEL: iters}
    n = want["steps"]
    expected = {gumbel.SOFT_KERNEL: n + 2, gumbel.IDS_KERNEL: n + 1,
                slot_routing.KERNEL: iters * (n + 2), slot_routing.BWD_KERNEL: iters * n}
    expected_bcdec = {slot_routing.KERNEL: iters, slot_routing.BWD_KERNEL: iters}
    launches_ok = all(r["launches"] == expected and r["bcdec"]["launches"] == expected_bcdec
                      for r in ranks) and want["launches"] == expected
    ok = (worst <= STEP_LOSS_RTOL and ranks_metrics and all(equal) and first_ok(first)
          and same_start and last_grad_ok and max(replay_got, replay_want) <= 1
          and first_ok(bcdec) and launches_ok and samples_ok)
    ddp_ms = [r["ms"] for r in ranks]
    print(f"  {DDP_WORLD} gloo ranks on the card, {DDP_BATCH // DDP_WORLD} rows each of a "
          f"global batch of {DDP_BATCH} (spawned, ran and joined in {spawn_s:.1f} s): "
          f"launches a rank {ranks[0]['launches']} and Slot-Attention "
          f"{ranks[0]['bcdec']['launches']} (per step {per_step}; expected {expected} and "
          f"{expected_bcdec}): {'ok' if launches_ok else 'MISMATCH'}", flush=True)
    print(f"  against one process at {DDP_BATCH}, no injected noise: metrics of "
          f"{len(per_call)} calls worst {worst:.3e} of max(|value|, 1) (tolerance "
          f"{STEP_LOSS_RTOL}; by call {', '.join(f'{e:.1e}' for e in per_call)}); the first "
          f"step: {first_line(first)}; one process loaded rank 0's file after {n - 1} steps: "
          f"its state bitwise the ranks' {'yes' if same_start else 'NO'}; the last step from "
          f"it: gradients worst {last_grad:.3f} of their tolerance, each side's parameters "
          f"against Adam replayed from its gradients worst {replay_got:.3f} (ranks, "
          f"{replay_got_where}) and {replay_want:.3f} (one process, {replay_want_where}) of "
          f"float32's rounding (tolerance 1); the Slot-Attention update: {first_line(bcdec)}; "
          f"sample grid {got['samples'].shape}, "
          f"{100 * (sample_diff == 0).mean():.2f} % of its values equal, largest difference "
          f"{sample_diff.max()} (tolerance 1, over 99 % equal)", flush=True)
    print(f"  the ranks bitwise equal after every call: {equal} (metrics "
          f"{'equal' if ranks_metrics else 'DIFFER'})", flush=True)
    print(f"  {card}: ms an update at {DDP_BATCH}: {DDP_WORLD} gloo ranks on one card "
          f"{', '.join(f'{ms:.3f}' for ms in ddp_ms)} (each step all-reduces "
          f"{4 * sum(p.numel() for p in single.module.parameters()) / 1e6:.1f} MB of "
          f"gradients through the host: gloo's number on this card, not NCCL's), one "
          f"process {single_ms:.3f}", flush=True)
    if not ok:
        raise SystemExit("the data-parallel ranks disagree with one process or each other")
    check_nccl_rank(ocr_cfg, env_cfg, data["obs"][0], f"file://{tmp}/nccl")
    launches = tuple(r["launches"] for r in ranks) + tuple(r["bcdec"]["launches"]
                                                           for r in ranks)
    return dict(launches=launches, ms=ddp_ms, single_ms=single_ms)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()

    with phase("device"):
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
        kind = torch.cuda.get_device_name(0)
        rates_key, bw, flops = card_rates(kind)
        print(f"  {kind}, {torch.cuda.device_count()} device(s); torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}; rates of "
              f"{rates_key}: {bw / 1e12} TB/s, {flops / 1e12} TFLOP/s fp32",
              flush=True)

    with phase("build"):
        for name, seconds in build().items():
            print(f"  nvcc {name}.cu: {seconds:.2f} s", flush=True)
        report_ptxas(sources())

    cfg = PolicyConfig()
    sa = cfg.ocr.slotattr
    serving_shape = (BATCHES[0], cfg.env.obs_size ** 2, sa.num_slots, sa.slot_size)
    ocr_cfg, env_cfg = OCRConfig(), EnvConfig()
    train_shape = (TRAIN_BATCH,) + serving_shape[1:]
    tokens = TRAIN_BATCH * (env_cfg.obs_size // 4) ** 2
    with phase("kernels"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        sweep = check_sweep(serving_shape, bw, flops, gen)
        # the RL shapes: the rollout's policy call at E = 4, the evaluation's
        # at E = 20 and the minibatch update's at 32 (also the evaluation
        # batch's)
        for shape in [train_shape, (EVAL_BATCH,) + serving_shape[1:],
                      (BATCHES[1],) + serving_shape[1:], (4,) + serving_shape[1:],
                      (20,) + serving_shape[1:], (2, 4096, 6, 192),
                      (3, 333, 5, 192), (2, 100, 16, 64)]:
            check_sweep(shape, bw, flops, gen)
        sweep_bwd = check_sweep_bwd(train_shape, bw, flops, gen)
        for shape in [serving_shape, (BATCHES[1],) + serving_shape[1:],
                      (EVAL_BATCH,) + serving_shape[1:], (2, 4096, 6, 192),
                      (3, 333, 5, 192), (2, 100, 16, 64)]:
            check_sweep_bwd(shape, bw, flops, gen)
        # the heads kernels: the slot-shapes phase's two configurations
        # (slate-heads4 first: its numbers go to the kernels line), then
        # other widths and the corner of their range
        check_heads_plans()
        heads = [(check_sweep(shape, bw, flops, gen), check_sweep_bwd(shape, bw, flops, gen))
                 for shape in HEADS_SHAPES]
        soft_ids = check_gumbel(tokens, ocr_cfg.dvae.vocab_size, bw, flops, gen)
        check_gumbel(EVAL_BATCH * (env_cfg.obs_size // 4) ** 2, ocr_cfg.dvae.vocab_size,
                     bw, flops, gen)
        check_gumbel(1000, 512, bw, flops, gen)
        check_gumbel(7, 32, bw, flops, gen, time_it=False)
        # a data-parallel rank's rows: rank 1 of 2 at the ddp phase's batch
        tokens_rank = (DDP_BATCH // DDP_WORLD) * (env_cfg.obs_size // 4) ** 2
        check_gumbel_row0(tokens_rank, ocr_cfg.dvae.vocab_size, tokens_rank, gen)
        check_gumbel_row0(7, 32, 5, gen)
        check_id_frequencies(gen)
        check_ids_nan(tokens, ocr_cfg.dvae.vocab_size, gen)
        check_ids_nan(1000, 512, gen)

    with phase("serving"):
        policy = build_policy(cfg, seed=0)
        algo = PPO(policy, (cfg.env.obs_size, cfg.env.obs_size, 3), seed=0)
        rng = np.random.default_rng(0)
        shape = (cfg.env.obs_size, cfg.env.obs_size, cfg.env.obs_channels)
        requests = {E: [rng.integers(0, 256, (E,) + shape, dtype=np.uint8)
                        for _ in range(REQUESTS)] for E in BATCHES}
        for E in BATCHES:                     # warm-up, outside the count
            serve(algo, requests[E][:2])
        reset_launches()
        seconds = {E: serve(algo, requests[E]) for E in BATCHES}
        launches = dict(LAUNCHES)
        expected = sa.num_iterations * REQUESTS * len(BATCHES)
        for E in BATCHES:
            print(f"  E={E}: {1e3 * seconds[E] / REQUESTS:.3f} ms/request, "
                  f"{E * REQUESTS / seconds[E]:.1f} obs/s", flush=True)
        print(f"  launches {launches}, expected {slot_routing.KERNEL}: {expected}",
              flush=True)
        if launches != {slot_routing.KERNEL: expected}:
            raise SystemExit("the serving path did not launch each kernel as expected")
        for E in BATCHES:
            check_request(algo, requests[E][0], sa.num_slots, sa.slot_size)

    with phase("training"):
        rng = np.random.default_rng(0)
        shape = (TRAIN_BATCH, env_cfg.obs_size, env_cfg.obs_size, env_cfg.obs_channels)
        batch = rng.integers(0, 256, shape, dtype=np.uint8)
        check_step(ocr_cfg, env_cfg, batch)
        ocr = create_ocr(ocr_cfg, env_cfg, seed=0)
        start = {k: v.clone() for k, v in ocr.module.state_dict().items()}
        _, warm = train_steps(ocr, [batch] * TRAIN_WARMUP, 0)   # outside the count
        reset_launches()
        train_seconds, timed_metrics = train_steps(ocr, [batch] * TRAIN_STEPS, TRAIN_WARMUP)
        train_launches = dict(LAUNCHES)
        per_step = {gumbel.SOFT_KERNEL: 1, gumbel.IDS_KERNEL: 1,
                    slot_routing.KERNEL: sa.num_iterations,
                    slot_routing.BWD_KERNEL: sa.num_iterations}
        train_expected = {k: n * TRAIN_STEPS for k, n in per_step.items()}
        ms_step = 1e3 * train_seconds / TRAIN_STEPS
        print(f"  {card}: {TRAIN_STEPS} steps at batch "
              f"{TRAIN_BATCH} (update_many k={TRAIN_K}), {ms_step:.3f} ms/step, "
              f"{TRAIN_BATCH * TRAIN_STEPS / train_seconds:.1f} images/s", flush=True)
        print(f"  launches {train_launches}, expected {train_expected}", flush=True)
        if train_launches != train_expected:
            raise SystemExit("the training path did not launch each kernel as expected")
        losses = torch.cat([warm["loss"], timed_metrics["loss"]])
        after = ocr.module.state_dict()
        moved = {GROUP_OF[k.split(".")[0]] for k in after
                 if not torch.equal(after[k], start[k])}
        print(f"  loss on one fixed batch: step 0 {losses[0].item():.4f}, step "
              f"{len(losses) - 1} {losses[-1].item():.4f}; groups moved {sorted(moved)}; "
              f"norm {timed_metrics['norm'][-1].item():.4f}, tau "
              f"{timed_metrics['tau'][-1].item():.6f}", flush=True)
        if not (torch.isfinite(losses).all() and losses[-1] < losses[0]
                and moved == set(GROUP_OF.values())):
            raise SystemExit("training did not lower the loss or move every group")

    with phase("amp"):
        amp = amp_phase(card, ms_step, batch, sa)

    with phase("evaluation"):
        eval_launches, sa_launches, profiled_eval = evaluation_phase(ocr_cfg, env_cfg, card, sa)

    with phase("rl-training"):
        rl = rl_training_phase(card)

    with phase("agent-evaluation"):
        agent_evaluation_phase(card)

    with phase("other-ocrs"):
        other = other_ocrs_phase(card)

    with phase("pretraining"):
        pretrain = pretraining_phase(card)

    import tempfile
    workdir = tempfile.TemporaryDirectory()
    with phase("train-ocr"):
        ocr_train = train_ocr_phase(card, workdir.name)

    with phase("multi-seed"):
        multi = multi_seed_phase(card, ocr_train["encoder"], bw, flops)

    with phase("sac"):
        sac = sac_phase(card, ocr_train["encoder"], workdir.name, bw, flops)

    with phase("probes"):
        probes = probes_phase(card, ocr_train["encoder"], workdir.name, bw, flops)

    with phase("ddp"):
        ddp = ddp_phase(card, workdir.name)

    with phase("hdf5-eval"):
        hdf5_eval = hdf5_eval_phase(card, workdir.name)

    with phase("slot-shapes"):
        slot_shapes = slot_shapes_phase(card, workdir.name)
    workdir.cleanup()

    if args.profile:
        with phase("profile"):
            for E in BATCHES:
                obs = requests[E][0]
                profile(f"E={E}: 5 requests", lambda: algo.predict(obs), 5, 15)
            superbatch = np.concatenate([batch] * TRAIN_K)
            profile(f"training: {2 * TRAIN_K} steps",
                    lambda: ocr.update_many(superbatch, None, 0, TRAIN_K), 2, 25)
            profile(f"amp training: {2 * TRAIN_K} bf16 steps",
                    lambda: amp["ocr"].update_many(amp["superbatch"], None, 0, TRAIN_K), 2, 25)
            for label, model, sb in (("fp32", ocr, superbatch),
                                     ("bf16", amp["ocr"], amp["superbatch"])):
                steps = 2 * TRAIN_K
                _, averages = profiled(lambda: model.update_many(sb, None, 0, TRAIN_K), 2)
                conv, bf16, top = conv_device_ms(averages)
                busy = device_ms(averages)
                print(f"  {label} steps at {TRAIN_BATCH}: convolutions {conv / steps:.3f} ms of "
                      f"device time a step ({bf16 / steps:.3f} ms in kernels that name bf16) of "
                      f"{(busy or 0.0) / steps:.3f} ms; the longest: {top}", flush=True)
            eval_batch = [profiled_eval["batch"]]
            profile(f"evaluation: 1 batch of {EVAL_BATCH}",
                    lambda: evaluate(profiled_eval["ocr"], eval_batch, seed=1), 1, 30)
            rl_obs = rl["obs"]
            profile(f"rl: 20 policy calls at E = {rl_obs.shape[0]}",
                    lambda: rl["algo"].act(rl_obs)[0].cpu(), 20, 15)
            profile("rl: 10 minibatch updates (end to end)",
                    lambda: rl["algo"].update_minibatch(rl["data"], rl["idx"]), 10, 25)
            profile("rl: 10 minibatch updates (OCR frozen)",
                    lambda: rl["frozen"].update_minibatch(rl["data"], rl["idx"]), 10, 20)
            for name, label in (("mae-patch-transformer-0.01ent_coef", "MAE-base e2e"),
                                ("iodine-transformer-0.01ent_coef", "IODINE frozen")):
                kept = other["keep"][name]
                kobs, kalgo = kept["obs"], kept["algo"]
                profile(f"{label}: 10 policy calls at E = {kobs.shape[0]}",
                        lambda: kalgo.act(kobs)[0].cpu(), 10, 15)
                kdata = kalgo.upload({"obs": np.concatenate([kobs] * 8),
                                      "actions": np.zeros(32, np.int32),
                                      "logprobs": np.full(32, np.log(0.25), np.float32),
                                      **{k: np.ones(32, np.float32) for k in
                                         ("values", "advantages", "returns")}})
                kidx = torch.arange(32, device="cuda")
                profile(f"{label}: 5 minibatch updates of 32",
                        lambda: kalgo.update_minibatch(kdata, kidx), 5, 20)
            e2e = other["keep"]["iodine-e2e"]
            profile("IODINE e2e: 3 minibatch updates of 32",
                    lambda: e2e["algo"].update_minibatch(e2e["data"], e2e["idx"]), 3, 20)
            for name, kept in pretrain["keep"].items():
                profile(f"pretraining {name}: {TRAIN_K} steps at batch {TRAIN_BATCH}",
                        lambda: kept["ocr"].update_many(kept["superbatch"], None, 0, TRAIN_K),
                        1, 20)
            sac_obs = sac["obs"]
            profile(f"sac: 20 policy calls at E = {sac_obs.shape[0]}",
                    lambda: sac["algo"].act(sac_obs).cpu(), 20, 15)
            profile("sac: 3 updates at batch 256 (end to end)",
                    lambda: sac["algo"].update(sac["data"]), 3, 25)
            profile("sac: 3 updates at batch 256 (OCR and pooling frozen)",
                    lambda: sac["frozen"].update(sac["data"]), 3, 20)
            kept = probes["keep"]
            profile("probes: 5 property updates at 24",
                    lambda: kept["probe"].update(kept["property_batch"]), 5, 20)
            profile("probes: 3 classifier steps at 128",
                    lambda: kept["classifier"].step(kept["classifier_batch"]), 3, 20)

    def row(name, source, replaces, result):
        # launches: summed over the main-path runs: serving, training, the
        # bf16 steps, update and get_loss, evaluation of SLATE and of Slot-Attention, the PPO iteration, the
        # frozen updates, the RL evaluation, the other OCRs' iterations, the
        # pretraining phase, train_ocr's two runs, the multi-seed runs, the
        # two SAC runs, the two probes, the ddp phase's ranks, the
        # hdf5-eval phase's command lines and train_ocr run, and the
        # slot-shapes phase's train_ocr runs and command line
        runs = (launches, train_launches, *amp["launches"], eval_launches,
                sa_launches) + rl["launches"] + (
            other["launches"], pretrain["launches"]) + ocr_train["launches"] + \
            multi["launches"] + sac["launches"] + probes["launches"] + ddp["launches"] + \
            hdf5_eval["launches"] + slot_shapes["launches"]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=sum(run.get(name, 0) for run in runs),
                    max_abs_err=result["max_abs_err"], ms=result["ms"],
                    plain_ms=result["plain_ms"], bound_ms=result["bound_ms"],
                    bound_by=result["bound_by"], library_ms=result.get("library_ms"))

    routing, gumbel_cu = ("ocrl_tpu_torch/ops/csrc/slot_routing.cu",
                          "ocrl_tpu_torch/ops/csrc/gumbel.cu")
    kernels = [
        row(gumbel.SOFT_KERNEL, gumbel_cu, "ocrl_tpu/ops/gumbel.py:50",
            soft_ids[gumbel.SOFT_KERNEL]),
        row(gumbel.IDS_KERNEL, gumbel_cu, "ocrl_tpu/ops/gumbel.py:112",
            soft_ids[gumbel.IDS_KERNEL]),
        row(slot_routing.KERNEL, routing, "ocrl_tpu/ops/slot_routing.py:79", sweep),
        row(slot_routing.BWD_KERNEL, routing, "ocrl_tpu/ops/slot_routing.py:86", sweep_bwd),
        row(slot_routing.HEADS_KERNEL, routing, "ocrl_tpu/ops/slot_routing.py:79", heads[0][0]),
        row(slot_routing.HEADS_BWD_KERNEL, routing, "ocrl_tpu/ops/slot_routing.py:86",
            heads[0][1]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
