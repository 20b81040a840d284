#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (NVIDIA H100).

    python3 chip_smoke.py

Drives the port's main paths once, at full width and depth (random weights
from a seed), in phases, each printing its result:

  1. environment: versions, nvcc, optional modules, card name and power
     limit, g++'s path, whether jpeglib.h is there, native_build.status();
  2. build: kernels B1 (csrc/ar_decode.cu), B2 and B3 (csrc/attention.cu),
     B4 (csrc/flash_bwd.cu), B5 (csrc/encoder_blocks.cu) and the eval-mode
     batch-norm pass (csrc/bn_act.cu) with nvcc for
     sm_90a, and the native host helpers (utils/editdist.cpp,
     data/native/lmdb_reader.cpp and jpeg_decode.cpp) with g++ where the
     toolchain is, all compiles started together;
  3. kernel vs plain: B1 (fused AR decode) against its plain PyTorch
     version on its shared card check (ops/ar_kernel.py: check_run,
     teacher-forced on the kernel's picks; |kernel - plain| relative to
     max|plain| within CHECK_LIMITS in max and mean), at PARSeq-S's M = 128
     and at patch16-224's M = 196, at B = 1, 7, 256 (PARSeq-S also at the
     serving rungs of phase 10, B = 2, 4, 8, 16, 32), and on check_model's
     weights at B = 9 with each rows per block R = 1, 2, 4, 8 forced, at M =
     1, 128, 196 and for a D = 64, 2-head decoder; B2 (fused no-split
     attention) at (h, D) = (6, 384) and L = 1, 5, 16, 17, 128, 129, 196
     (patch16-224), 197 (ViTSTR), 256, 416, and at ABINet's (256, 8, 512),
     and B3 (head-split attention) at (BH, L, dh) = (6B, L, 64) for the same
     L, all at B = 1, 7, 256 (B2 also at 48, ViTSTR training's microbatch,
     and 384, the validation batch), in bf16 and f32, on the shared card check
     (ops/attention.py: check_operands, scores spread by ~2.75; |kernel -
     plain| relative to max|plain| within CHECK_LIMITS in max and mean),
     strided and contiguous operands bit-identical; B4 (attention backward)
     at L = 8, 16, 120, 128, 136, 256, dh = 64 and 32, B = 1, 7, 48 and
     PARSeq-S training's whole batch (384, 6, 128, 64), in bf16 and f32, on
     its shared card check (ops/flash_bwd.py: check_operands, scores spread
     by ~2.75; |kernel - plain| of each of dq, dk, dv relative to its
     max|plain| within CHECK_LIMITS in max and mean), bf16 strided and
     contiguous operands bit-identical; B3's gradients at L = 128 and 197
     through its autograd Function against autograd of its plain version (a
     wiring check: both backwards are that autograd); B2's gradients
     likewise under autograd at ViTSTR's (197, 6, 384), B = 7 and 48, its
     forward there within CHECK_LIMITS; B5 (all
     encoder blocks) at PARSeq-S's full geometry, depth 12, B = 1, 7, 256
     (and depth 1, and L = 64 and 65 at B = 7: one or both warpgroups of a
     block hold rows), on weights where attention decides the output, its
     difference held relative to what the blocks add to their input, its
     launch count set to 0 before and risen after, and against the port's
     eager blocks as information; the batch-norm pass (ops/cnn.py:bn_act)
     at ABINet's maps (512, 32, 32, 128) and (512, 512, 8, 32), bf16,
     channels-last and NCHW, random statistics, in its four forms (batch
     norm alone, + ReLU, + identity shortcut, + normalised shortcut): one
     launch a call, bit for bit the same call inside kernels.plain();
  4. main paths (inference): hub.parseq(), hub.vitstr(),
     hub.parseq_patch16_224() and hub.abinet() on cuda in bf16 read batches
     of 1, 7 and 256 NHWC images; each model's kernel launch counts are set
     to 0 just before its reads and must have risen just after (PARSeq-S's
     B5 too, whose encoder takes it; the others must not launch B5), and
     the `kernels` line's B5 launches are those reads' (the encoder bench's
     apart, as launches_bench); bf16 kernel
     path vs the f32 plain path; then hub.vitstr(dtype=torch.float32) reads
     B = 1 and 7 through B2 in f32 (its count risen), its logits against the
     f32 plain path; the batch-norm pass's count, set to 0 with the
     others, must rise by 53 a forward in ABINet's reads (45 in ResNet45, 8
     in the U-Net) and stay 0 in the others'; then the CNN families:
     hub.crnn(), hub.trba() and create_model('trbc') read B = 1, 7 and 256
     in bf16 (they run no TPU kernel: convolutions and products are library
     calls, the LSTMs step loops; their batch norms launch the batch-norm
     pass, whose count must rise); before those reads (and the bias raise they need), each one's
     B = 7 bf16 logits against its f32 path (TRBA teacher-forced on its f32
     greedy picks), max |difference| and the agreeing margin relative to
     max|f32 logits| within the model's own limits (CNN_LIMITS), a planted
     fault (the last BiLSTM's reverse direction zeroed) failing them, and
     the f32 path held against the same weights' f32 path on the CPU;
  5. main path (training): parseq_tpu_torch.cli.train trains PARSeq-S
     (+experiment=parseq: batch 384, trainer.microbatches 8, bf16) for 12
     steps on a synthetic LMDB of PIL-rendered words, validating at steps 6
     and 12; B4's launch count is set to 0 just before and must reach
     12 layers x microbatches x steps; metrics, checkpoints, a reload and a
     read from the best checkpoint; one step's gradients with B4 against
     plain autograd (kernels.plain()); step time both ways, peak memory,
     one profiled step (device busy time, B4's share, the top kernels), and
     the step at 1, 2 and 4 microbatches;
  6. main paths of this slice: the encoder-kernel bench
     (experiments/torch_encoder_kernel_bench.py, B = 256, depth 12, bf16:
     eager blocks, nn.TransformerEncoder and B5, timed) with B5's launch
     count set to 0 just before and read just after; B3's differentiable op
     forward and backward at (1536, 128, 64) with its count set to 0 and
     read likewise;
  7. times (CUDA events, median of 20 after warm-up; B2, B3 and B4 per call
     of 10 back-to-back calls queued behind a GPU spin, i.e. device time;
     B1 at B = 1, 7, 256 (M = 128) and 256 (M = 196), with prepare() alone):
     each kernel vs its plain version and one
     PyTorch library call computing the same function where there is one,
     beside the kernel's bound (B2 at L = 128, 196, 197, 256 and B = 256,
     at L = 197 and B = 1, and in f32 at L = 197; B3 at L = 128, 197; the
     batch-norm pass with ReLU and with the identity shortcut at
     BN_SHAPES, the `kernels` line's entry `bn_act`); each
     model's forward in images/s, the CNN families' too;
  8. main paths of evaluation and benchmarking: a synthetic LMDB of
     PIL-rendered words (PNG), one database per benchmark set at its
     published size (10,340 words in all), under build/ (read through the
     native LMDB reader where it built); parseq_tpu_torch.cli.test
     evaluates PARSeq-S (B1's launch count set to 0 just before and risen
     to at least a launch a batch after) and CRNN on it at batch 512, prints
     both tables, the images read per second and the time of it spent
     waiting on the loader, with the model's load timed apart; PARSeq-S
     again with the Python LMDB reader in the native one's place, its
     tables equal to the first run's;
     parseq_tpu_torch.cli.bench benches PARSeq-S at B = 1 and 256 (B1's
     count likewise) and CRNN and TRBA at B = 1, each printing the card's
     name and power limit and its JSON line; then every model's MACs per
     image (utils/flops.py);
  9. main paths of training the other families: parseq_tpu_torch.cli.train
     trains ViTSTR, CRNN, TRBC, TRBA, ABINet (staged: pretraining, then
     joint after the alignment redraw) and ABINet's language model alone
     (tune_abinet-lm) at their experiments' full width, batch 384,
     microbatches 8, bf16, for 4 steps each on a synthetic LMDB, validating
     at steps 2 and 4; metrics, checkpoints (last, train_state, swa), a
     reload on cuda and a read of 7 images; B2's launch count set to 0 just
     before each run and read just after (ViTSTR's training >= 12 x 8 a
     step; ABINet's validations > 0, its steps with dropout none, checked
     on a timed step); each family's step (ABINet in its pretraining and
     its joint stage) on the card against the same step on the CPU (same
     state_dict, a numpy batch of 8, dropout 0), in f32 with TF32 off and
     in float64 (float64_mode), within CARD_CPU_LIMITS and CARD_CPU_TRUNK,
     which a planted fault (batch norms left in eval mode on the card) must
     fail; each family's step time (median of 4 after a warm-up), img/s,
     peak memory, device-busy share and kernel launches a step;
 10. main paths of serving and tuning: serve.InferenceServer (max_batch 32,
     max_wait 2 ms, warmed up) serves PARSeq-S with phase 4's weights, bf16,
     its classifier's weight scaled and its bias raised on EOS and a few
     letters so that the direct reads are varied and decide every step
     (both required):
     1,024 distinct PIL-rendered words as uint8 32x128 crops from 8 client
     threads (4 requests in flight each), 16 of them as PNG bytes through
     cli.serve.make_handler on a live 127.0.0.1 HTTP server, and 64 from one
     client; every served (text, confidence) is held against a read of the
     same crop alone (serve.server: direct_reads, check_served,
     CHECK_LIMITS), which a planted fault (a drain that swaps the results of
     two requests of a batch) must fail; B1's launch count, set to 0 before
     the warm-up, must equal the batches served plus the warm-up rungs;
     served img/s, request latency p50 / p99, batches, mean fill and padded
     share, at 8 clients and at 1; preprocess_torch on the card against the
     CPU on uint8 crops of 20x50 and 100x300; then cli.tune (+experiment=
     parseq, full width and depth, batch 384, 2 trials of 4 steps, one
     rung) on phase 5's synthetic LMDB, written again: results.json with two
     trials of distinct LR, a finite best LR, B4 launches in the trials'
     steps and B1 launches in their validations, each trial's wall time;
 11. main paths of several ranks and of the model-loading tools: (a) two
     processes of parseq_tpu_torch.cli.train +experiment=parseq
     trainer.multihost=true with torchrun's environment on 127.0.0.1 share
     the card (so the process group is gloo, printed) and train PARSeq-S at
     the global batch of 384 (192 rows a rank, 8 microbatches of 24, bf16)
     for 4 steps on a synthetic LMDB, validating at steps 2 and 4: each
     rank's B4 count (set to 0 in the rank before it trains) reaches 12 x 8
     x 4 and its B1 count rises in its validations, the parameters after
     the run hash alike on both ranks, rank 0 alone writes (rank 1 has a
     --work_dir of its own, which must not exist after), the best
     checkpoint reloads on cuda and reads 7 images; each rank's step time
     and peak memory (two ranks on one card: not a scaling figure); (b)
     one train step of PARSeq-S and of CRNN (dropout 0, a numpy batch of
     16, 2 microbatches) on 2 ranks sharing the card against 1 rank, in
     float64 (float64_mode) and f32 with TF32 off, within RANK_LIMITS, which
     two planted faults (the gradient all-reduce skipped; batch norms on
     the rank's own rows) must fail; (c) tools.certify_pretrained on phase
     4's PARSeq-S weights as phase 10 leaves them, saved as a released
     .pt in a temporary checksum cache, reads six PIL-rendered images named
     as DEMO_EXPECTED's files on cuda (B1's count risen), exits 1, and each
     prediction equals bundle.read of the same image; tools.abinet_lm_acc
     on phase 4's ABINet weights over a synthetic LMDB of 300 words gives
     the same count on cuda as on the CPU, and the language model's
     probabilities (tools.abinet_lm_acc.batch_probs) on both within
     LM_LIMIT of the largest;
 12. the native host helpers, the JAX checkpoint format and the int8
     encoder: (a) on the card's host, every LMDB lookup of phase 8's
     benchmark sets through the native reader equal to the Python
     reader's, NATIVE_JPEGS seeded words rendered as JPEGs through the
     native decode+resize bit-equal to PIL's and NATIVE_FULL_DECODES of
     them through the full-resolution decode equal to PIL's
     convert('RGB'), and NATIVE_PAIRS seeded string pairs' native edit
     distances equal to the Python DP's, each with its time per item (a
     helper that did not build, for want of g++ or jpeglib.h, is reported
     so; the libjpeg versions of Pillow and of the build are printed); (b)
     phase 4's PARSeq-S weights (as phase 10 leaves them) written as a JAX
     package checkpoint by experiments/torch_jax_ckpt.py and as a .pt,
     both loaded on cuda: equal weights, equal B = 7 reads (B1 once each);
     (c) int8 PARSeq-S and ViTSTR (ops/quant.py, rows spread by
     CHECK_SPREAD, random weights as they are): logits that depend on the
     encoder alone against bf16 within CHECK_LIMITS with greedy picks
     equal where the bf16 margin exceeds the error, 4 x depth int8
     products (aten._int_mm) a forward, two planted faults failing (codes
     made with per-input-channel scales; the last block's fc2 left
     unquantized, one product short), a read of INT8_IMAGES images
     launching B1 once (PARSeq-S) or B2 12 times (ViTSTR) whose logits
     pass quant.check_reads against the bf16 read's (picks equal where
     each image's margin exceeds its error; an image so decided through
     its EOS reads as bf16 does), and the encoder at B = 256 in bf16 and
     int8 timed; (d) int8_linear on cuda
     against the CPU at PARSeq-S's qkv and fc2 shapes (weight and
     activation codes and scales and the int32 sums equal, outputs within
     1e-6 of the largest) and _int_mm's time with either weight layout;
     (e) cli.bench --int8 of PARSeq-S at B = 1 and 256, its MACs equal to
     the bf16 model's.

Any failure raises and exits non-zero. Without a CUDA device, or without
the repository beside it, it fails and prints no result. The last lines
are the kernel table, the card line of nvidia-smi, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import shutil
import statistics
import string
import sys
import tempfile
import time
import threading
import urllib.request
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCHES = (1, 7, 256)
# B2 also at its training paths' batches: ViTSTR's microbatch (384 / 8) and
# the validation batch.
B2_BATCHES = BATCHES + (48, 384)
TIMED_BATCH = 256
BACK_TO_BACK = 10  # calls per event pair when timing B2, B3 and B4
# B1 vs plain: the shared card check of ops/ar_kernel.py (check_model: every
# decoder parameter drawn with numpy; check_run: teacher-forced on the
# kernel's picks; |kernel - plain| relative to max|plain| within
# CHECK_LIMITS in max and mean, greedy picks equal where the margin is
# clear), on the main path's models and on check_model's at every rows per
# block forced, a ragged B, M = 1, 128 and 196, and a D = 64, 2-head model.
B1_ROWS = (1, 2, 4, 8)
B1_RAGGED_BATCH = 9
B1_MEMORY_ROWS = (1, 128, 196)
B1_TIMED_BATCHES = (1, 7, TIMED_BATCH)
# csrc/bn_act.cu, checked and timed at ABINet's largest batch-norm maps at B =
# 512: ResNet45's stem and first layer, and its last two layers
BN_SHAPES = ((512, 32, 32, 128), (512, 512, 8, 32))
BN_FORMS = ('plain', 'relu', 'identity', 'normed')
ABINET_BN_LAUNCHES = 53  # a read forward: 45 in ResNet45, 8 in the U-Net
# B1 also at every batch phase 10 serves PARSeq-S in: the rung ladder of
# serve.server up to SERVE_MAX_BATCH, those not in BATCHES already.
# B2 and B3 vs plain: the shared card check of ops/attention.py (inputs
# from check_operands, limits CHECK_LIMITS), at every length class of the
# kernel: one row, ragged single tiles, PARSeq-S's 128, the L >= 192 users
# (196 patch16-224, 197 ViTSTR, 256 ABINet) and the longest it takes.
CHECK_LENGTHS = (1, 5, 16, 17, 128, 129, 196, 197, 256, 416)
CHECK_SHAPES = tuple((L, 6, 384) for L in CHECK_LENGTHS) + ((256, 8, 512),)
ATTENTION_SHAPES = ((197, 6, 384), (196, 6, 384), (256, 8, 512))  # ViTSTR, p16-224, ABINet
GATE_SHAPE = (128, 6, 384)  # PARSeq-S's encoder, below the gate: timed only
# f32 ViTSTR on the kernel path vs the f32 plain path: both f32, only the
# attention's sums differ in order (<= 1e-5 of its largest output per
# layer, CHECK_LIMITS), through 12 layers; greedy picks must agree wherever
# the margin exceeds that.
F32_MAIN_ATOL = 1e-3
F32_MAIN_MARGIN = 1e-3
# Random weights give near-uniform logits (p ~ 1/95 per class), so greedy
# text rarely ends with EOS inside max_label_length and its confidence
# product underflows float32. The smoke raises the final classifier's EOS
# bias so every read ends inside the limit with a representable confidence
# (with +2.0 on the seed-0 weights every PARSeq row decodes to '' at conf
# ~0.04 on the H100).
EOS_BIAS = 2.0
# CTC reads (CRNN, TRBC) keep every one of their W/4 + 1 = 33 positions in
# the confidence product, so the blank's bias is raised further: with +6.0
# the blank takes ~0.8 of each position and the product stays ~1e-3.
BLANK_BIAS = 6.0
# Phase 4, bf16 vs f32 of the CNN families on the weights as drawn (the
# reads' bias raise comes after: the bf16 rounding of a logit near 6 would
# be all the check saw), TRBA teacher-forced on its f32 greedy picks so both
# paths decode the same ids: (max |bf16 - f32|, the f32 top-2 margin above
# which greedy picks must agree), each relative to max|f32 logits|, set at
# about twice the H100's readings on these inputs (CHANGES.md). On uniform
# noise images a bf16 TPS grid's sub-pixel error moves TRBA's and TRBC's
# logits most, so they are also held with the TPS in f32, more tightly.
# A planted fault, the last BiLSTM's reverse direction zeroed (about 0.6 of
# max|f32 logits|), must fail every limit.
CNN_LIMITS = {
    'crnn': {'bf16': (0.02, 0.04)},
    'trba': {'bf16': (0.12, 0.05), 'bf16, TPS in f32': (0.03, 0.06)},
    'trbc': {'bf16': (0.3, 0.2), 'bf16, TPS in f32': (0.06, 0.12)},
}
# Phase 8: the benchmark sets at their published sizes (the reference
# README's table, BASELINE.md; IC13_857 and IC15_1811 by their names).
EVAL_SETS = {'CUTE80': 288, 'IC13_1015': 1015, 'IC13_857': 857, 'IC15_1811': 1811,
             'IC15_2077': 2077, 'IIIT5k': 3000, 'SVT': 647, 'SVTP': 645}
EVAL_BATCH = 512
BENCH_RUNS = (('parseq', 1), ('parseq', 256), ('crnn', 1), ('trba', 1))
# bf16 main path vs the f32 plain path: the bf16 encoder moves logits by
# ~1e-2; greedy picks must agree where the f32 top-2 margin exceeds 0.1.
MAIN_ATOL = 5e-2
MAIN_MARGIN = 0.1
# B4 vs plain: the shared card check of ops/flash_bwd.py (inputs from
# check_operands, limits CHECK_LIMITS on each of dq, dk, dv), at every length
# class of the kernel (one key tile, ragged tiles, PARSeq-S's 128, one past
# it, a ragged last tile of a 4-block cluster, the longest), both head
# widths, B = 1, 7, 48, head counts other than 6 and the whole batch.
B4_SHAPES = ((48, 6, 128, 64), (384, 6, 128, 64))  # one microbatch, the whole batch
B4_CHECK_SHAPES = (tuple((B, 6, L, 64) for L in (8, 16, 120, 128, 136, 200, 256)
                         for B in (1, 7, 48))
                   + tuple((7, 6, L, 32) for L in (8, 120, 136, 200, 256))
                   + ((3, 2, 24, 32), (2, 3, 200, 64), (5, 1, 200, 32), B4_SHAPES[1]))
# B3 at PARSeq-S's and ViTSTR's encoder lengths, 6 heads of 64 per image.
B3_LENGTHS = (128, 197)
# B3 and B2 gradients, a wiring check: the backward is autograd of the plain
# version in both routes, from the same q, k, v, so this shows that the
# autograd Function carries the gradients through, not that they are right
# (tests/test_torch_fused_attention.py holds them against JAX's custom VJPs
# on the CPU); relative to the largest reference value.
GRAD_EQUAL_RTOL = 2.0 ** -6
B5_HEADS, B5_DEPTH = 6, 12
# One training step's gradients with B4 vs plain autograd, per parameter,
# relative to its largest plain gradient: both run the bf16 model; plain
# autograd rounds dP and the products with P to bf16 where B4 keeps f32, and
# that difference passes back through 12 encoder layers.
GRAD_RTOL = 5e-2
TRAIN_STEPS = 12
TRAIN_WORDS = 4 * 384
VAL_WORDS = 384
STEP_TIMED = 6
# Phase 9: the other families' training through cli.train (ABINet's
# language model alone as tune_abinet-lm), and their step on the card
# against the CPU, both devices fed the same host-normalised images. In
# float64 (float64_mode) each parameter's gradient within
# CARD_CPU_LIMITS[float64]['grad'] of its largest (or of 'floor' of the
# model's largest gradient, if more) and the batch-norm statistics within
# 'stats': rounding there is far below any ReLU or max-pool decision (the
# H100 read <= 8.1e-13). In f32, TF32 off, the same with the f32 limits,
# except where a trunk of ReLU gates behind train-mode batch norms
# (CARD_CPU_TRUNK: the CNNs, ABINet's ResNet, vision transformer and
# position attention, and its language model's ReLU MLPs) sums a gradient:
# the two devices' rounding, grown over tens of layers, puts a few gates on
# the other side and moves such a gradient by a percent or more (ABINet's
# language model alone read 1.46e-2 of its largest; the JAX package's f32
# step is as far from a float64 one as the port's,
# experiments/torch_train_f64_witness.py). A trunk parameter that misses the
# limit is held by its relative L2 difference within its family's bound,
# about 3x the worst reading on the H100 (PERF.md; CNN trunks 1.59e-2,
# ABINet's language model alone 1.5e-3). TRBA and TRBC read smooth images:
# on per-pixel noise the TPS sampling turns the grid's last-bit rounding
# into whole-pixel changes. ABINet is compared in both stages; in the joint
# stage the card's language model is fed the CPU's inputs (probabilities
# and lengths, which the step detaches), as a length read from an argmax of
# random logits may flip between devices. The planted fault moves
# gradients by more than their largest.
FAMILY_RUNS = ('vitstr', 'crnn', 'trbc', 'trba', 'abinet', 'tune_abinet-lm')
FAMILY_STEPS = 4
FAMILY_TIMED = 4
CARD_CPU_BATCH = 8
CARD_CPU_LIMITS = {torch.float32: {'grad': 1e-3, 'floor': 1e-2, 'stats': 1e-4},
                   torch.float64: {'grad': 1e-8, 'floor': 1e-2, 'stats': 1e-10}}
# model name -> (trunk prefixes, bound on a trunk gradient's relative L2), f32
_LM_TRUNK = ('language.model.', 'language.proj.')
CARD_CPU_TRUNK = {'crnn': (('cnn.',), 5e-2),
                  'trba': (('Transformation.', 'FeatureExtraction.'), 5e-2),
                  'trbc': (('Transformation.', 'FeatureExtraction.'), 5e-2),
                  'abinet': (('vision.backbone.', 'vision.attention.', *_LM_TRUNK), 5e-2),
                  'abinet-lm': (_LM_TRUNK, 5e-3)}
BATCH_NORM_FAMILIES = ('crnn', 'trba', 'trbc', 'abinet')  # the planted fault's
# Phase 10: serving. 8 clients keep 4 requests in flight each, 32 in all (the
# largest rung); the 1-client run gives B = 1 latency through the server.
SERVE_WORDS = 1024
SERVE_CLIENTS = 8
SERVE_WINDOW = 4
SERVE_HTTP = 16
SERVE_SINGLE = 64
SERVE_MAX_BATCH = 32
SERVE_WAIT_MS = 2.0
# Phase 4's weights read '' from every crop (EOS_BIAS): a check of served
# against direct reads would see only the first decode step. Before serving,
# the classifier's bias of EOS and of SERVE_LETTERS is set SERVE_BIAS above
# the largest of the others, and its weight scaled by SERVE_HEAD_SCALE, so
# that what the crop gives the decoder moves the greedy picks: varied reads
# that decide every step. On an H100 this gives 209 distinct strings of
# 1,024, every one 26 characters long (EOS never wins), so the check holds
# all 26 steps of each read. At least SERVE_MIN_DISTINCT of the direct reads
# must differ, and their mean length be at least SERVE_MIN_LENGTH.
SERVE_LETTERS = 'abcd'
SERVE_BIAS = 3.0
SERVE_HEAD_SCALE = 16.0
SERVE_MIN_DISTINCT = 64
SERVE_MIN_LENGTH = 8.0
# preprocess_torch on the card against the CPU: f32 both, the same
# arithmetic in another order.
PREPROCESS_CROPS = ((20, 50), (100, 300))
PREPROCESS_ATOL = 1e-5
# Phase 10: tuning. Two PARSeq-S trials of 4 steps in one rung; the batch
# keeps its 384.
TUNE_TRIALS = 2
TUNE_STEPS = 4
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, bf16 tensor
# cores, f32 outside the tensor cores.
# Phase 11: several ranks. 11a trains PARSeq-S (its experiment: batch 384,
# 8 microbatches, bf16) on RANKS processes sharing the card for RANK_STEPS
# steps; 11b holds one step of each RANK_MATH_FAULTS model (dropout 0) on a
# numpy batch of RANK_MATH_BATCH in RANK_MATH_MICRO microbatches, on RANKS
# ranks, to the same step on one: |difference| of each gradient relative
# to its parameter's largest within RANK_LIMITS['grad'], the loss's, the
# grad norm's and the batch-norm statistics' relative differences within
# RANK_LIMITS['other'] (float64: float64_mode; f32 with TF32 off), which
# each planted fault must fail; 11c runs the tools (LM_WORDS words for the
# language model, whose f32 probabilities on cuda, TF32 off, and on the CPU
# differ by at most LM_LIMIT of the CPU's largest).
RANKS = 2
RANK_STEPS = 4
RANK_TIMEOUT_S = 480
RANK_MATH_BATCH = 16
RANK_MATH_MICRO = 2
RANK_MATH_FAULTS = {'parseq': ('no_allreduce',), 'crnn': ('no_allreduce', 'local_batchnorm')}
RANK_LIMITS = {torch.float64: {'grad': 1e-10, 'other': 1e-10},
               torch.float32: {'grad': 1e-4, 'other': 1e-4}}
LM_WORDS = 300
LM_LIMIT = 1e-4
# Phase 12: the native helpers' JPEGs (seeded words rendered at quality
# 95), full-resolution decodes of them and string pairs; int8_linear on cuda against the CPU at PARSeq-S's qkv and fc2 over
# the tokens of 7 images.
NATIVE_JPEGS = 4000
NATIVE_FULL_DECODES = 2000
NATIVE_PAIRS = 20000
INT8_LINEAR_SHAPES = ((7 * 128, 384, 1152), (7 * 128, 1536, 384))
INT8_IMAGES = 32
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


START = time.perf_counter()


def phase(name):
    print(f'== {name} (at {time.perf_counter() - START:.1f} s)', flush=True)


def importable(name):
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def compare(got, want, atol, margin, what):
    """Max abs difference; raises unless within `atol` and the greedy picks
    agree wherever the reference's top-2 margin exceeds `margin`."""
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    confident = (top2[..., 0] - top2[..., 1]) > margin
    agree = bool((got.argmax(-1) == want.argmax(-1))[confident].all())
    if not (got.shape == want.shape and torch.isfinite(got).all() and err <= atol and agree):
        raise AssertionError(f'{what} disagrees with its plain version: max_abs_err={err} '
                             f'(limit {atol}), argmax equal where the margin > {margin}: {agree}')
    return err, int(confident.sum())


def b1_check(what, model, memory, rows=None):
    """B1 through the shared card check (ops/ar_kernel.py); raises unless it
    passes. Returns the max abs difference."""
    from parseq_tpu_torch.ops import ar_kernel

    got, want, rel_max, rel_mean, passes = ar_kernel.check_run(model, memory, rows)
    torch.cuda.synchronize()
    if got.shape != (memory.shape[0], model.cfg.num_steps, model.cfg.num_classes) or not passes:
        raise AssertionError(f'{what}: B1 disagrees with its plain version: relative max '
                             f'{rel_max:.3e}, mean {rel_mean:.3e} (limits '
                             f'{ar_kernel.CHECK_LIMITS}), greedy picks (agree, positions) '
                             f'{ar_kernel.check_greedy(got, want)}')
    err = float((got - want).abs().max())
    print(f'{what}: relative max {rel_max:.3e} mean {rel_mean:.3e}, max_abs_err={err:.3e} ok')
    return err


def packed_qkv(B, L, D, gen, dtype=torch.bfloat16):
    """Seeded N(0, 1) q, k, v as column views of one (B, L, 3D) tensor."""
    qkv = torch.randn(B, L, 3 * D, generator=gen, device='cuda').to(dtype)
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


def heads(x, h):
    """(B, L, h*dh) view -> (B, h, L, dh) view."""
    B, L, D = x.shape
    return x.view(B, L, h, D // h).transpose(1, 2)


def bound(bytes_moved, bf16_flops=0.0, f32_flops=0.0):
    """Least time (ms) on the card: the larger of the bytes over HBM rate and
    the operations over the peak rate of their type; and which one binds."""
    t_bytes = bytes_moved / HBM_BPS
    t_ops = bf16_flops / BF16_FLOPS + f32_flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def b1_bound(B, M, cfg):
    """B1 wrapper from memory (B, M, D) bf16 to logits (B, n, C) f32: reads
    memory and the bf16 decoder weights once, writes the logits. bf16-input
    products: the cross-attention K/V of memory, then per step and row the
    self k|v, self out, cross q, cross out, MLP and head matvecs; f32: the
    f32 queries against the bf16 memory keys and the self-attention cache."""
    D, n, C = cfg.embed_dim, cfg.num_steps, cfg.num_classes
    F_ = int(D * cfg.dec_mlp_ratio)
    weights = 2 * (2 * D * D + 3 * D * D + 2 * D * F_ + C * D + cfg.num_tokens * D)
    bytes_moved = B * M * D * 2 + weights + B * n * C * 4
    bf16 = 2 * B * M * D * 2 * D + B * n * 2 * (2 * D * D + 3 * D * D + 2 * D * F_ + D * C)
    f32 = B * n * (2 * 2 * M * D + 2 * 2 * (n + 1) / 2 * D)
    return bound(bytes_moved, bf16, f32)


def b2_bound(B, L, h, D, elt=2):
    """q, k, v read once, o written once; QK^T and PV on inputs of the
    operands' type (bf16: tensor cores; f32: the f32 cores)."""
    flops = 4 * B * h * L * L * (D // h)
    return bound(4 * B * L * D * elt, **({'bf16_flops': flops} if elt == 2
                                          else {'f32_flops': flops}))


def bn_bound(B, C, H, W, shortcut=False):
    """y read and out written once, and the shortcut read where there is
    one, in bf16."""
    return bound(B * C * H * W * 2 * (2 + shortcut))


def bn_operands(shape, gen, dev):
    """y and a shortcut r of `shape` in bf16, channels-last (the layout
    cuDNN returns for NHWC images), and two eval-mode batch norms with
    random, non-identity statistics: csrc/bn_act.cu's check and timing."""
    y, r = (torch.randn(shape, generator=gen, device=dev).mul_(a).to(torch.bfloat16)
            .contiguous(memory_format=torch.channels_last) for a in (1, 2))
    bns = []
    for _ in range(2):
        bn = torch.nn.BatchNorm2d(shape[1]).to(dev).eval()
        C = shape[1]
        with torch.no_grad():
            bn.running_mean.copy_(torch.randn(C, generator=gen, device=dev) * 0.5)
            bn.running_var.copy_(torch.rand(C, generator=gen, device=dev) * 1.5 + 0.5)
            bn.weight.copy_(1 + torch.randn(C, generator=gen, device=dev) * 0.3)
            bn.bias.copy_(torch.randn(C, generator=gen, device=dev) * 0.5)
        bns.append(bn)
    return y, r, *bns


def bn_form(form, r, bn_r):
    """(relu, residual, residual_bn) of cnn.bn_act's forms: the batch norm
    alone (CRNN's, TRBA's), with the ReLU, with the identity shortcut, with
    a normalised shortcut (a downsampling block)."""
    return {'plain': (False, None, None), 'relu': (True, None, None),
            'identity': (True, r, None), 'normed': (True, r, bn_r)}[form]


def b4_bound(B, h, L, dh, elt=2):
    """q, k, v, dO read once, dq, dk, dv written once; QK^T, dO V^T, P^T dO,
    dS K, dS^T Q on inputs of the operands' type."""
    flops = 10 * B * h * L * L * dh
    return bound(7 * B * h * L * dh * elt, **({'bf16_flops': flops} if elt == 2
                                             else {'f32_flops': flops}))


def b3_bound(BH, L, dh):
    """B2's bound with one head of dh per batch row."""
    return b2_bound(BH, L, 1, dh)


def b5_bound(B, L, D, F, depth):
    """x read once and out written once (bf16), every layer's weights (bf16)
    and LayerNorm parameters (f32) read once; per layer the four products
    and the attention's QK^T and PV in bf16."""
    weights = 2 * (3 * D * D + D * D + 2 * D * F + 3 * D + D + F + D) + 4 * 4 * D
    bf16 = 2 * B * L * D * (3 * D + D + 2 * F) + 4 * B * L * L * D
    return bound(2 * B * L * D * 2 + depth * weights, bf16_flops=depth * bf16)


def grad_check(what, got, want, leaves, grad):
    """Wiring check of a kernel's autograd Function: gradients of `got`
    (through the Function) and of `want` (its plain version) for the same
    cotangent; both are autograd of the plain version, so this raises when
    the Function drops or misroutes a gradient (more than GRAD_EQUAL_RTOL of
    the plain gradient's largest value). Returns the max abs differences."""
    errs = []
    for a, b in zip(torch.autograd.grad(got, leaves, grad),
                    torch.autograd.grad(want, leaves, grad)):
        err = float((a.float() - b.float()).abs().max())
        limit = GRAD_EQUAL_RTOL * float(b.float().abs().max())
        if not (torch.isfinite(a.float()).all() and err <= limit):
            raise AssertionError(f'{what} gradients disagree with plain autograd: '
                                 f'max_abs_err={err} (limit {limit})')
        errs.append(err)
    return errs


def render_word(text, fmt='PNG'):
    """`text` in PIL's default font, black on a light background, encoded as
    `fmt` (PNG, or JPEG at quality 95)."""
    from PIL import Image, ImageDraw

    img = Image.new('RGB', (8 * len(text) + 8, 24), (235, 235, 225))
    ImageDraw.Draw(img).text((4, 6), text, fill=(10, 10, 10))
    buf = io.BytesIO()
    img.save(buf, fmt, **({'quality': 95} if fmt == 'JPEG' else {}))
    return buf.getvalue()


def write_lmdb(path, words, fmt='PNG'):
    from parseq_tpu_torch.data.lmdb import LmdbWriter

    with LmdbWriter(path) as w:
        w.put(b'num-samples', str(len(words)).encode())
        for i, word in enumerate(words, start=1):
            w.put(f'image-{i:09d}'.encode(), render_word(word, fmt))
            w.put(f'label-{i:09d}'.encode(), word.encode())


def write_train_lmdb(data_root, rng, charset):
    """The synthetic LMDB of phases 5 and 10: TRAIN_WORDS train and VAL_WORDS
    val words of 3-10 digits and letters drawn from `rng`, PIL-rendered.
    Returns the words."""
    letters = np.array(list(charset[:62]))  # digits and letters
    words = [''.join(rng.choice(letters, rng.integers(3, 11)))
             for _ in range(TRAIN_WORDS + VAL_WORDS)]
    write_lmdb(data_root / 'train' / 'real' / 'synthetic', words[:TRAIN_WORDS])
    write_lmdb(data_root / 'val' / 'synthetic', words[TRAIN_WORDS:])
    return words


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    from parseq_tpu_torch import hub, kernels
    from parseq_tpu_torch.data import native
    from parseq_tpu_torch.kernels.build import find_nvcc
    from parseq_tpu_torch.models.abinet import ABINet
    from parseq_tpu_torch.models.parseq import PARSeq, PARSeqConfig
    from parseq_tpu_torch.ops import ar_kernel, attention, cnn, encoder_kernel, flash_bwd
    from parseq_tpu_torch.serve.server import _rungs
    from parseq_tpu_torch.utils import metrics, native_build
    from parseq_tpu_torch.utils.registry import create_model

    from experiments import torch_encoder_kernel_bench as enc_bench
    from experiments.torch_encoder_kernel_bench import card_line, cuda_median_ms

    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase('1 environment')
    card = card_line()
    print(f'python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}')
    print(f'nvcc {find_nvcc()}; nvidia-smi {shutil.which("nvidia-smi")}')
    print('importable: ' + ', '.join(f'{m}={importable(m)}' for m in ('triton', 'yaml', 'PIL')))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f'card: {card}; devices {torch.cuda.device_count()}; SMs {sms}')
    toolchain = native_build.status()
    print(f'g++ {toolchain["g++"]}; jpeglib.h present: {toolchain["jpeglib.h"]}; '
          f'native_build.status() {json.dumps(toolchain)}')

    phase('2 build (B1, B2 and B3, B4, B5, the batch-norm pass with nvcc; the native host '
          'helpers with g++; in parallel)')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        libs = list(pool.map(lambda build: build(), (ar_kernel.library, attention.library,
                                                     flash_bwd.library, encoder_kernel.library,
                                                     cnn.library, metrics.load, native.load,
                                                     native.load_jpeg)))
    print(f'built {", ".join(lib._name for lib in libs if lib is not None)} in '
          f'{time.perf_counter() - t0:.1f} s; native helpers '
          f'{json.dumps(native_build.status()["helpers"])}')

    phase('3 kernel vs plain')
    rng = np.random.default_rng(SEED)
    serve_rng = np.random.default_rng(SEED + 6)
    b1_err = b2_err = b3_err = b4_err = b5_err = 0.0
    memories = {}
    b1_models = {}
    with torch.inference_mode():
        for name, cfg in (('PARSeq-S', PARSeqConfig()),
                          ('PARSeq-S patch16-224', PARSeqConfig(img_size=(224, 224),
                                                                patch_size=(16, 16)))):
            model = PARSeq(cfg)
            model.init_weights(torch.Generator().manual_seed(SEED))
            model = model.to(dev).eval()
            b1_models[name] = model
            serving = [B for B in _rungs(SERVE_MAX_BATCH) if B not in BATCHES]
            for B, gen in (*((B, rng) for B in BATCHES),
                           *((B, serve_rng) for B in serving if name == 'PARSeq-S')):
                images = torch.from_numpy(
                    gen.uniform(-1, 1, (B, *cfg.img_size, 3)).astype(np.float32)).to(dev)
                memory = model.encode(images.to(torch.bfloat16)).contiguous()
                memories[name, B] = memory
                b1_err = max(b1_err, b1_check(f'B1 {name} B={B} M={memory.shape[1]}', model,
                                              memory))
        # check_model's decoder at every rows per block, ragged B, M = 1, 128, 196.
        small = PARSeqConfig(num_tokens=13, max_label_length=7, img_size=(32, 64),
                             embed_dim=64, enc_num_heads=2, enc_depth=1, dec_num_heads=2)
        for cfg, memory_rows in ((PARSeqConfig(), B1_MEMORY_ROWS), (small, (64,))):
            model = ar_kernel.check_model(cfg, SEED).to(dev)
            for M in memory_rows:
                memory = ar_kernel.check_memory(B1_RAGGED_BATCH, M, cfg.embed_dim, SEED + 1, dev)
                for R in B1_ROWS:
                    b1_err = max(b1_err, b1_check(
                        f'B1 check_model D={cfg.embed_dim} B={B1_RAGGED_BATCH} M={M} R={R}',
                        model, memory, R))
        del model

        gen = torch.Generator(device=dev).manual_seed(SEED)
        for dtype in (torch.bfloat16, torch.float32):
            limits = attention.CHECK_LIMITS[dtype]
            worst = {'B2': (0.0, 0.0), 'B3': (0.0, 0.0)}
            for (L, h, D), B in ((shape, B) for shape in CHECK_SHAPES for B in B2_BATCHES):
                for kernel in ('B2', 'B3') if h == 6 and B in BATCHES else ('B2',):
                    if kernel == 'B2':
                        q, k, v = attention.check_operands(B, L, D, 64, 0.125, gen, dtype)
                        fn = lambda *t: attention.fused_attention_nosplit(*t, h, 0.125)
                        plain = attention.fused_attention_nosplit_reference(q, k, v, h, 0.125)
                    else:
                        q, k, v = attention.check_operands(6 * B, L, 64, 64, 0.125, gen, dtype)
                        fn = lambda *t: attention.fused_attention(*t, 0.125)
                        plain = attention.fused_attention_reference(q, k, v, 0.125)
                    got = fn(q, k, v)
                    torch.cuda.synchronize()
                    errs = attention.check_errors(got, plain)
                    if not attention.check_passes(got, plain):
                        raise AssertionError(
                            f'{kernel} (L={L}, h={h}, D={D}, B={B}) {dtype} disagrees with its '
                            f'plain version: |diff| / max|plain| max {errs[0]}, mean {errs[1]} '
                            f'(limits {limits})')
                    if not torch.equal(got, fn(q.contiguous(), k.contiguous(), v.contiguous())):
                        raise AssertionError(f'{kernel} (L={L}, h={h}, D={D}, B={B}) {dtype} '
                                             f'gives another result on contiguous operands')
                    worst[kernel] = tuple(map(max, worst[kernel], errs))
                    if dtype == torch.bfloat16:
                        err = float((got.float() - plain.float()).abs().max())
                        if kernel == 'B2':
                            b2_err = max(b2_err, err)
                        else:
                            b3_err = max(b3_err, err)
            print(f'B2 and B3 {str(dtype)[6:]}, L in {CHECK_LENGTHS} (and ABINet\'s (256, 8, 512) '
                  f'for B2), B in {BATCHES} (B2 also {B2_BATCHES[len(BATCHES):]}): q, k, v strided '
                  f'views of one packed projection and '
                  f'contiguous (equal); worst |diff| / max|plain| B2 max {worst["B2"][0]:.3e} '
                  f'mean {worst["B2"][1]:.3e}, B3 max {worst["B3"][0]:.3e} mean '
                  f'{worst["B3"][1]:.3e} (limits {limits[0]:.3g}, {limits[1]:.3g}) ok')

        for dtype in (torch.bfloat16, torch.float32):
            limits = flash_bwd.CHECK_LIMITS[dtype]
            worst = (0.0, 0.0)
            for B, h, L, dh in B4_CHECK_SHAPES:
                q, k, v, do, dq, dk, dv, scale = flash_bwd.check_operands(B, h, L, dh, gen, dtype)
                flash_bwd.attention_flashbwd_backward(q, k, v, do, scale, dq, dk, dv)
                torch.cuda.synchronize()
                got = (dq, dk, dv)
                want = flash_bwd.attention_flashbwd_backward_reference(q, k, v, do, scale)
                errs = flash_bwd.check_errors(got, want)
                if not flash_bwd.check_passes(got, want):
                    raise AssertionError(f'B4 (B, h, L, dh) = {(B, h, L, dh)} {dtype} disagrees '
                                         f'with its plain version: |diff| / max|plain| (max, '
                                         f'mean) of dq, dk, dv {errs} (limits {limits})')
                if dtype == torch.bfloat16:
                    same = [torch.empty_like(dq) for _ in range(3)]
                    flash_bwd.attention_flashbwd_backward(q.contiguous(), k.contiguous(),
                                                          v.contiguous(), do, scale, *same)
                    if not all(torch.equal(a, b) for a, b in zip(got, same)):
                        raise AssertionError(f'B4 (B, h, L, dh) = {(B, h, L, dh)} gives another '
                                             f'result on contiguous operands')
                    b4_err = max(b4_err, *(float((a.float() - b.float()).abs().max())
                                           for a, b in zip(got, want)))
                worst = tuple(max(w, *(e[i] for e in errs)) for i, w in enumerate(worst))
            print(f'B4 {str(dtype)[6:]}, (B, h, L, dh) in {B4_CHECK_SHAPES}: q, k, v, dq, dk, dv '
                  f'strided in packed (B, L, 3D)' + (' and contiguous (equal)'
                                                       if dtype == torch.bfloat16 else '')
                  + f'; worst |diff| / max|plain| over dq, dk, dv: max {worst[0]:.3e}, mean '
                  f'{worst[1]:.3e} (limits {limits[0]:.3g}, {limits[1]:.3g}) ok')

    for L in B3_LENGTHS:
        for B in BATCHES:
            q, k, v = (t.contiguous().requires_grad_()
                       for t in attention.check_operands(6 * B, L, 64, 64, 0.125, gen))
            g = torch.randn(6 * B, L, 64, generator=gen, device=dev).to(torch.bfloat16)
            got = attention.fused_attention(q, k, v, 0.125)
            want = attention.fused_attention_reference(q, k, v, 0.125)
            grad_errs = grad_check(f'B3 (BH, L, dh)={(6 * B, L, 64)}', got, want, (q, k, v), g)
            print(f'B3 (BH, L, dh)={(6 * B, L, 64)}: gradients through the autograd Function, '
                  f'dq/dk/dv max_abs_err {"/".join(f"{e:.3e}" for e in grad_errs)} ok')
    for B in (7, 48):  # and ViTSTR training's microbatch
        qkv = torch.randn(B, 197, 3 * 384, generator=gen, device=dev).to(torch.bfloat16)
        qkv.requires_grad_()
        g = torch.randn(B, 197, 384, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv[..., :384], qkv[..., 384:768], qkv[..., 768:]
        before = attention.launches
        got = attention.fused_attention_nosplit(q, k, v, 6, 0.125)
        if attention.launches != before + 1:
            raise AssertionError('B2 under autograd did not launch its kernel')
        want = attention.fused_attention_nosplit_reference(q, k, v, 6, 0.125)
        if not attention.check_passes(got, want):
            raise AssertionError(f'B2 under autograd (B={B}) disagrees with its plain version: '
                                 f'|diff| / max|plain| {attention.check_errors(got, want)}')
        (err,) = grad_check(f'B2 (B, L, h, D)=({B}, 197, 6, 384)', got, want, (qkv,), g)
        print(f'B2 under autograd (B, L, h, D)=({B}, 197, 6, 384), q, k, v views of a packed '
              f'leaf: kernel forward within CHECK_LIMITS, gradient max_abs_err {err:.3e} ok')

    blocks = enc_bench.make_blocks(B5_DEPTH, SEED).to(dev)
    b5_ops = {depth: encoder_kernel.stack_block_params(blocks[:depth]) for depth in (1, B5_DEPTH)}
    with torch.inference_mode():
        for depth, B, L in ((1, 7, enc_bench.L), *((B5_DEPTH, B, enc_bench.L) for B in BATCHES),
                            (B5_DEPTH, 7, 64), (B5_DEPTH, 7, 65)):
            x = torch.randn(B, L, enc_bench.D, generator=gen, device=dev).to(torch.bfloat16)
            encoder_kernel.launches = 0
            got = encoder_kernel.fused_encoder_blocks(b5_ops[depth], x, num_heads=B5_HEADS)
            torch.cuda.synchronize()
            if encoder_kernel.launches != 1:
                raise AssertionError(f'B5 launched {encoder_kernel.launches} times, expected 1')
            want = encoder_kernel.fused_encoder_blocks_reference(b5_ops[depth], x, B5_HEADS)
            err = float((got.float() - want.float()).abs().max())
            rel_max, rel_mean = enc_bench.contribution_errors(got, want, x)
            limit_max, limit_mean = enc_bench.B5_LIMITS[depth]
            if not (got.shape == x.shape and torch.isfinite(got.float()).all()
                    and rel_max <= limit_max and rel_mean <= limit_mean):
                raise AssertionError(f'B5 depth {depth} B={B} L={L} disagrees with its plain version: '
                                     f'|diff| relative to what the blocks add: max {rel_max} '
                                     f'(limit {limit_max}), mean {rel_mean} (limit {limit_mean})')
            if depth == B5_DEPTH:
                b5_err = max(b5_err, err)
            msg = (f'B5 (L, D, heads, MLP)=({L}, 384, 6, 1536) depth {depth} B={B}: launches 1, '
                   f'max_abs_err={err:.3e}; |diff| relative to what the blocks add (max '
                   f'{float((want.float() - x.float()).abs().max()):.3g}): max {rel_max:.3e} '
                   f'(limit {limit_max:.3g}), mean {rel_mean:.3e} (limit {limit_mean:.3g})')
            if (depth, B, L) == (B5_DEPTH, 7, enc_bench.L):  # information: eager blocks
                # use the tanh GELU
                eager = enc_bench.eager(blocks, x).float()
                msg += f'; vs the eager blocks {float((got.float() - eager).abs().max()):.3e}'
            print(msg + ' ok')

    bn_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.inference_mode():
        for shape in BN_SHAPES:
            y, r, bn, bn_r = bn_operands(shape, bn_gen, dev)
            for layout in (torch.channels_last, torch.contiguous_format):
                y, r = y.contiguous(memory_format=layout), r.contiguous(memory_format=layout)
                for form in BN_FORMS:
                    relu, residual, residual_bn = bn_form(form, r, bn_r)
                    if not cnn.takes_kernel(y, bn, residual, residual_bn):
                        raise AssertionError(f'bn_act {shape} {form}: the kernel\'s gate says no')
                    before = cnn.launches
                    got = cnn.bn_act(y, bn, relu, residual, residual_bn)
                    with kernels.plain():
                        want = cnn.bn_act(y, bn, relu, residual, residual_bn)
                    torch.cuda.synchronize()
                    if cnn.launches != before + 1 or not (
                            got.stride() == want.stride()
                            and torch.equal(got.view(torch.int16), want.view(torch.int16))):
                        err = float((got.float() - want.float()).abs().max())
                        raise AssertionError(
                            f'bn_act {shape} {form} {layout}: launches {cnn.launches - before}, '
                            f'max |kernel - plain| {err} (bit for bit expected)')
            del y, r, got, want
    print(f'bn_act (csrc/bn_act.cu) at {BN_SHAPES} bf16, channels-last and NCHW, forms '
          f'{BN_FORMS}, random statistics: one launch a call, bit for bit the separate calls '
          f'inside kernels.plain() ok')

    phase('4 main paths on cuda, bf16 (inference)')
    bundles = {
        'parseq': hub.parseq(seed=SEED),
        'vitstr': hub.vitstr(seed=SEED),
        'parseq-patch16-224': hub.parseq_patch16_224(seed=SEED),
        'abinet': hub.abinet(seed=SEED),
    }
    main_launches = {'B1': 0, 'B2': 0, 'B3': 0, 'B4': 0, 'B5': 0, 'BN': 0}
    images = {}
    for name, bundle in bundles.items():
        module = bundle.module
        classifier = module.alignment.cls if isinstance(module, ABINet) else module.head
        with torch.no_grad():
            classifier.bias[bundle.tokenizer.eos_id] += EOS_BIAS
        charset = set(bundle.tokenizer.charset)
        max_len = bundle.cfg.max_label_length
        batches = {B: rng.uniform(-1, 1, (B, *bundle.img_size, 3)).astype(np.float32)
                   for B in BATCHES}
        images[name] = batches
        ar_kernel.launches = 0
        attention.launches = 0
        encoder_kernel.launches = 0
        cnn.launches = 0
        results = {B: bundle.read(x) for B, x in batches.items()}
        launches = {'B1': ar_kernel.launches, 'B2': attention.launches,
                    'B5': encoder_kernel.launches, 'BN': cnn.launches}
        # B5 takes PARSeq-S's L = 128 encoder; ViTSTR's 197 and patch16-224's
        # 196 tokens keep the eager blocks
        needs = {'parseq': ('B1', 'B5'), 'vitstr': ('B2',), 'parseq-patch16-224': ('B1', 'B2'),
                 'abinet': ('B2',)}[name]
        for kernel in needs:
            if launches[kernel] < 1:
                raise AssertionError(f'{name}: the main path did not launch kernel {kernel}')
            main_launches[kernel] += launches[kernel]
        if 'B5' not in needs and launches['B5']:
            raise AssertionError(f'{name}: launched kernel B5 {launches["B5"]} times, '
                                 f'outside the shapes it takes')
        # ABINet's batch norms, shortcuts and ReLUs: csrc/bn_act.cu at each
        # site of each read forward; the transformers have no batch norm
        want_bn = ABINET_BN_LAUNCHES * len(batches) if isinstance(module, ABINet) else 0
        if launches['BN'] != want_bn:
            raise AssertionError(f'{name}: launched the batch-norm pass {launches["BN"]} times '
                                 f'in {len(batches)} reads, expected {want_bn}')
        main_launches['BN'] += launches['BN']
        for B, (labels, confs) in results.items():
            if not len(labels) == len(confs) == B:
                raise AssertionError(f'{name}: read returned {len(labels)} labels for {B} images')
            for text, conf in zip(labels, confs):
                if not (isinstance(text, str) and len(text) <= max_len
                        and set(text) <= charset and 0.0 < conf <= 1.0):
                    raise AssertionError(f'{name}: bad read at B={B}: {text!r} conf={conf}')
            print(f'{name} B={B}: {labels[:3]} conf {[f"{c:.3g}" for c in confs[:3]]}')
        print(f'{name}: launches during its reads {launches}')

        # The same B=7 images through the f32 plain path on the card.
        with torch.inference_mode():
            x = torch.from_numpy(batches[7]).to(dev)
            if isinstance(module, ABINet):
                # Vision logits only: the iterative LM feeds argmax lengths
                # back, so near-ties on random weights fork the full output.
                main = module.vision_forward(x.to(torch.bfloat16))['logits']
                with kernels.plain():
                    ref = module.vision_forward(x)['logits']
                what = 'vision logits'
            else:
                main = module(x, dtype=torch.bfloat16)
                with kernels.plain():
                    ref = module(x, dtype=torch.float32)
                what = 'logits'
        diff, n_confident = compare(main, ref, MAIN_ATOL, MAIN_MARGIN, f'{name} bf16 main path')
        print(f'{name} B=7 bf16 kernel path vs f32 plain path ({what}): max_abs_diff={diff:.3e}, '
              f'argmax equal where the f32 margin > {MAIN_MARGIN} ({n_confident} positions)')

    # ViTSTR in f32: B2 takes f32 operands on the card.
    bundle = hub.vitstr(seed=SEED, dtype=torch.float32)
    module = bundle.module
    with torch.no_grad():
        module.head.bias[bundle.tokenizer.eos_id] += EOS_BIAS
    attention.launches = 0
    results = {B: bundle.read(images['vitstr'][B]) for B in (1, 7)}
    f32_launches = attention.launches
    if f32_launches < 1:
        raise AssertionError('vitstr f32: the main path did not launch kernel B2')
    main_launches['B2'] += f32_launches
    for B, (labels, confs) in results.items():
        if not (len(labels) == len(confs) == B and all(
                set(t) <= set(bundle.tokenizer.charset) and 0.0 < c <= 1.0
                for t, c in zip(labels, confs))):
            raise AssertionError(f'vitstr f32: bad read at B={B}: {labels} {confs}')
        print(f'vitstr f32 B={B}: {labels[:3]} conf {[f"{c:.3g}" for c in confs[:3]]}')
    with torch.inference_mode():
        x = torch.from_numpy(images['vitstr'][7]).to(dev)
        main = module(x, dtype=torch.float32)
        with kernels.plain():
            ref = module(x, dtype=torch.float32)
    diff, n_confident = compare(main, ref, F32_MAIN_ATOL, F32_MAIN_MARGIN, 'vitstr f32 kernel path')
    print(f'vitstr f32: B2 launches during its reads {f32_launches}; B=7 f32 kernel path vs f32 '
          f'plain path (logits): max_abs_diff={diff:.3e} (limit {F32_MAIN_ATOL}), argmax equal '
          f'where the margin > {F32_MAIN_MARGIN} ({n_confident} positions)')
    del bundle, module

    cnn_bundles = {'crnn': hub.crnn(seed=SEED), 'trba': hub.trba(seed=SEED),
                   'trbc': create_model('trbc', seed=SEED)}
    for name, bundle in cnn_bundles.items():
        main_launches['BN'] += read_cnn_family(name, bundle, rng)

    phase(f'5 main path on cuda: PARSeq-S training through cli.train [{card}]')
    train_info = train_phase(dev, card, main_launches)

    phase(f'6 main paths on cuda: the encoder-kernel bench (B5) and B3\'s op [{card}]')
    encoder_kernel.launches = 0
    bench = enc_bench.main(['--batch', str(TIMED_BATCH), '--depth', str(B5_DEPTH)])
    b5_bench = encoder_kernel.launches
    if b5_bench < 1:
        raise AssertionError('the encoder-kernel bench did not launch kernel B5')
    print(f'encoder-kernel bench: B5 launches {b5_bench}')
    q, k, v, g = (torch.randn(6 * TIMED_BATCH, 128, 64, generator=gen, device=dev)
                  .to(torch.bfloat16).requires_grad_() for _ in range(4))
    attention.split_launches = 0
    o = attention.fused_attention(q, k, v, 0.125)
    grads = torch.autograd.grad(o, (q, k, v), g)
    torch.cuda.synchronize()
    main_launches['B3'] = attention.split_launches
    if main_launches['B3'] < 1 or not all(torch.isfinite(t.float()).all() for t in (o, *grads)):
        raise AssertionError(f'B3 op: launches {main_launches["B3"]}, finite outputs and '
                             f'gradients required')
    print(f'B3 fused_attention (BH, L, dh)=(1536, 128, 64) forward and backward: launches '
          f'{main_launches["B3"]}, outputs and gradients finite')
    del q, k, v, g, o, grads

    phase(f'7 times [{card}]')
    timed = {}
    with torch.inference_mode():
        # B1 as the main path calls it (prepare() and the kernel), and prepare() alone.
        for name, B in (*(('PARSeq-S', B) for B in B1_TIMED_BATCHES),
                        ('PARSeq-S patch16-224', TIMED_BATCH)):
            model, memory = b1_models[name], memories[name, B]
            timed['B1', name, B] = (
                cuda_median_ms(lambda: ar_kernel.ar_decode_fused(model, memory)),
                cuda_median_ms(lambda: ar_kernel.ar_decode_fused_reference(model, memory)),
                cuda_median_ms(lambda: ar_kernel.prepare(model, memory)))
            ms, plain_ms, prep_ms = timed['B1', name, B]
            print(f'B1 ar_decode_fused {name} (M={memory.shape[1]}) B={B} rows per block '
                  f'{ar_kernel.rows_per_block(B, sms)} [{card}]: kernel {ms:.4f} ms (of which '
                  f'prepare() alone {prep_ms:.4f} ms), plain {plain_ms:.4f} ms, bound '
                  f'{b1_bound(B, memory.shape[1], model.cfg)[0]:.4f} ms')
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        for L, h, D in (*ATTENTION_SHAPES, GATE_SHAPE):
            q, k, v = packed_qkv(TIMED_BATCH, L, D, gen)
            qh, kh, vh = heads(q, h), heads(k, h), heads(v, h)
            timed['B2', L] = tuple(cuda_median_ms(fn, calls=BACK_TO_BACK) for fn in (
                lambda: attention.fused_attention_nosplit(q, k, v, h, 0.125),
                lambda: attention.fused_attention_nosplit_reference(q, k, v, h, 0.125),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)))
            print(f'B2 fused_attention_nosplit L={L} h={h} D={D} B={TIMED_BATCH} [{card}]: '
                  f'kernel {timed["B2", L][0]:.4f} ms, plain {timed["B2", L][1]:.4f} ms, '
                  f'library (scaled_dot_product_attention) {timed["B2", L][2]:.4f} ms, '
                  f'bound {b2_bound(TIMED_BATCH, L, h, D)[0]:.4f} ms')
        # B2 at B = 1 (6 heads: query rows split over blocks) and in f32.
        for B, dtype in ((1, torch.bfloat16), (TIMED_BATCH, torch.float32)):
            L, h, D = ATTENTION_SHAPES[0]
            q, k, v = packed_qkv(B, L, D, gen, dtype)
            qh, kh, vh = heads(q, h), heads(k, h), heads(v, h)
            timed['B2', L, B, dtype] = tuple(cuda_median_ms(fn, calls=BACK_TO_BACK) for fn in (
                lambda: attention.fused_attention_nosplit(q, k, v, h, 0.125),
                lambda: attention.fused_attention_nosplit_reference(q, k, v, h, 0.125),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)))
            ms = timed['B2', L, B, dtype]
            print(f'B2 fused_attention_nosplit L={L} h={h} D={D} B={B} {str(dtype)[6:]} [{card}]: '
                  f'kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, library '
                  f'(scaled_dot_product_attention) {ms[2]:.4f} ms, bound '
                  f'{b2_bound(B, L, h, D, q.element_size())[0]:.4f} ms')
        for L in B3_LENGTHS:
            q, k, v = (torch.randn(6 * TIMED_BATCH, L, 64, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            q4, k4, v4 = q[:, None], k[:, None], v[:, None]
            timed['B3', L] = tuple(cuda_median_ms(fn, calls=BACK_TO_BACK) for fn in (
                lambda: attention.fused_attention(q, k, v, 0.125),
                lambda: attention.fused_attention_reference(q, k, v, 0.125),
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=0.125)))
            print(f'B3 fused_attention (BH, L, dh)={(6 * TIMED_BATCH, L, 64)} [{card}]: '
                  f'kernel {timed["B3", L][0]:.4f} ms, plain {timed["B3", L][1]:.4f} ms, '
                  f'library (scaled_dot_product_attention on (BH, 1, L, dh)) '
                  f'{timed["B3", L][2]:.4f} ms, bound {b3_bound(6 * TIMED_BATCH, L, 64)[0]:.4f} ms')
        x = torch.randn(TIMED_BATCH, enc_bench.L, enc_bench.D, generator=gen, device=dev).to(
            torch.bfloat16)
        op = b5_ops[B5_DEPTH]
        b5_plain_ms = cuda_median_ms(
            lambda: encoder_kernel.fused_encoder_blocks_reference(op, x, B5_HEADS))
        b5_ms = b5_bound(TIMED_BATCH, enc_bench.L, enc_bench.D, enc_bench.MLP, B5_DEPTH)
        print(f'B5 fused_encoder_blocks B={TIMED_BATCH} depth {B5_DEPTH} [{card}]: kernel '
              f'{bench["b5_ms"]:.4f} ms, plain {b5_plain_ms:.4f} ms, library '
              f'(nn.TransformerEncoder) {bench["library_ms"]:.4f} ms, eager blocks '
              f'{bench["eager_ms"]:.4f} ms, bound {b5_ms[0]:.4f} ms ({b5_ms[1]})')

        def plain_bn_act(*args):
            with kernels.plain():
                return cnn.bn_act(*args)

        for shape in BN_SHAPES:
            y, r, bn, bn_r = bn_operands(shape, bn_gen, dev)
            for form in ('relu', 'identity'):
                args = (y, bn, *bn_form(form, r, bn_r))
                ms = timed['BN', shape, form] = tuple(
                    cuda_median_ms(fn, calls=BACK_TO_BACK)
                    for fn in (lambda: cnn.bn_act(*args), lambda: plain_bn_act(*args)))
                print(f'bn_act {shape} bf16 channels-last, {form} [{card}]: kernel {ms[0]:.4f} '
                      f'ms, plain (the separate calls) {ms[1]:.4f} ms, bound '
                      f'{bn_bound(*shape, form == "identity")[0]:.4f} ms')
            del y, r
    for B, h, L, dh in B4_SHAPES:
        *parts, do, dq, dk, dv, scale = flash_bwd.check_operands(B, h, L, dh, gen)
        with torch.inference_mode():
            kernel_ms = cuda_median_ms(
                lambda: flash_bwd.attention_flashbwd_backward(*parts, do, scale, dq, dk, dv),
                calls=BACK_TO_BACK)
            plain_ms = cuda_median_ms(
                lambda: flash_bwd.attention_flashbwd_backward_reference(*parts, do, scale),
                calls=BACK_TO_BACK)
        # The library's backward alone: its forward graph is built once,
        # outside the timed window, and differentiated again on every call.
        leaves = [t.detach().requires_grad_() for t in parts]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        library_ms = cuda_median_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), calls=BACK_TO_BACK)
        del out, leaves
        timed['B4', B] = (kernel_ms, plain_ms, library_ms)
        print(f'B4 attention_flashbwd_backward (B, h, L, dh)={(B, h, L, dh)} bf16 [{card}]: '
              f'kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library '
              f'(scaled_dot_product_attention backward) {library_ms:.4f} ms, '
              f'bound {b4_bound(B, h, L, dh)[0]:.4f} ms')
    for name, bundle in {**bundles, **cnn_bundles}.items():
        x = (torch.from_numpy(images[name][TIMED_BATCH]).to(dev) if name in images else
             torch.rand(TIMED_BATCH, *bundle.img_size, 3, generator=gen, device=dev) * 2 - 1)
        fwd_ms = cuda_median_ms(lambda: bundle(x))
        print(f'forward {name} B={TIMED_BATCH} [{card}]: {fwd_ms:.4f} ms = '
              f'{TIMED_BATCH / fwd_ms * 1e3:.1f} img/s')
    print(f'training PARSeq-S B=384 [{card}]: ' + json.dumps(train_info))

    phase(f'8 main paths on cuda: cli.test (PARSeq-S, CRNN) and cli.bench [{card}]')
    build_dir = Path(__file__).resolve().parent / 'build'
    build_dir.mkdir(exist_ok=True)
    eval_data = Path(tempfile.mkdtemp(prefix='smoke-evaldata-', dir=build_dir))
    eval_b1, eval_times = eval_phase(bundles['parseq'], cnn_bundles['crnn'], eval_data)
    main_launches['B1'] += eval_b1
    print(f'cli.test [{card}]: ' + json.dumps(eval_times))
    from parseq_tpu_torch.cli.bench import per_image_flops

    for name, bundle in {**bundles, **cnn_bundles}.items():
        x = torch.rand(1, *bundle.img_size, 3, generator=gen, device=dev)
        print(f'MACs per image {name} (utils/flops.py through the plain paths): '
              f'{per_image_flops(bundle, x) / 1e9:.4f} G')
    serve_bundle = bundles['parseq']  # phase 10 serves these weights
    abinet_sd = {k: v.detach().cpu().clone()  # phase 11's language-model tool reads these
                 for k, v in bundles['abinet'].module.state_dict().items()}
    del bundles, cnn_bundles, b1_models, memories, b5_ops
    torch.cuda.empty_cache()

    phase(f'9 main paths on cuda: ViTSTR, CRNN, TRBC, TRBA, ABINet and its language model '
          f'train through cli.train [{card}]')
    family_info = train_families_phase(card, main_launches)

    phase(f'10 main paths on cuda: serving and tuning PARSeq-S [{card}]')
    t0 = time.perf_counter()
    serve_info = serve_phase(serve_bundle, card)
    # phase 4's weights as phase 10 leaves them (its reads vary): phase 11's certify reads
    certify_sd = {k: v.detach().cpu().clone()
                  for k, v in serve_bundle.module.state_dict().items()}
    del serve_bundle
    tune_info = tune_phase(card)
    main_launches['B1'] += serve_info['b1'] + tune_info['b1']
    main_launches['B4'] += tune_info['b4']
    print(f'phase 10 wall {time.perf_counter() - t0:.1f} s')

    phase(f'11 main paths on cuda: PARSeq-S on two ranks through cli.train, the step on 2 '
          f'ranks vs 1, the certify and language-model tools [{card}]')
    t0 = time.perf_counter()
    rank_info = multirank_phase(card, certify_sd, abinet_sd)
    main_launches['B1'] += rank_info['b1']
    main_launches['B4'] += rank_info['b4']
    print(f'phase 11 wall {time.perf_counter() - t0:.1f} s')

    phase(f'12 the native host helpers, a JAX package checkpoint and the int8 encoder on cuda '
          f'[{card}]')
    t0 = time.perf_counter()
    host_info = native_phase(eval_data)
    shutil.rmtree(eval_data, ignore_errors=True)
    int8_info = int8_phase(card, certify_sd)
    main_launches['B1'] += int8_info['b1']
    main_launches['B2'] += int8_info['b2']
    print(f'phase 12 wall {time.perf_counter() - t0:.1f} s: ' + json.dumps(
        {'native': host_info, 'int8': int8_info}))

    b1_ms, b2_ms, b4_ms = b1_bound(TIMED_BATCH, 128, PARSeqConfig()), b2_bound(
        TIMED_BATCH, 197, 6, 384), b4_bound(*B4_SHAPES[0])
    b3_ms = b3_bound(6 * TIMED_BATCH, 128, 64)
    print(json.dumps({'kernels': [
        {'name': 'ar_decode_fused', 'route': 'cuda',
         'source': 'parseq_tpu_torch/csrc/ar_decode.cu',
         'replaces': 'parseq_tpu/ops/ar_kernel.py:158',
         'launches': main_launches['B1'], 'max_abs_err': b1_err,
         'ms': timed['B1', 'PARSeq-S', TIMED_BATCH][0],
         'plain_ms': timed['B1', 'PARSeq-S', TIMED_BATCH][1],
         'bound_ms': b1_ms[0], 'bound_us': b1_ms[0] * 1e3, 'bound_by': b1_ms[1],
         'library_ms': None, 'at': f'B={TIMED_BATCH} M=128 (PARSeq-S)',
         'launches_serving': serve_info['b1'], 'launches_tuning_validation': tune_info['b1'],
         'launches_two_ranks_and_tools': rank_info['b1'],
         'launches_int8_and_jax_checkpoint_reads': int8_info['b1'],
         'prep_ms': timed['B1', 'PARSeq-S', TIMED_BATCH][2],
         **{f'ms_b{B}': timed['B1', 'PARSeq-S', B][0] for B in B1_TIMED_BATCHES[:-1]}},
        {'name': 'fused_attention_nosplit', 'route': 'cuda',
         'source': 'parseq_tpu_torch/csrc/attention.cu',
         'replaces': 'parseq_tpu/ops/attention.py:146',
         'launches': main_launches['B2'], 'max_abs_err': b2_err,
         'launches_vitstr_training': family_info['b2_vitstr_cli'],
         'launches_abinet_validation': family_info['b2_abinet_cli'],
         'launches_int8_vitstr_reads': int8_info['b2'],
         'ms': timed['B2', 197][0], 'plain_ms': timed['B2', 197][1],
         'bound_ms': b2_ms[0], 'bound_us': b2_ms[0] * 1e3, 'bound_by': b2_ms[1],
         'library_ms': timed['B2', 197][2], 'at': f'B={TIMED_BATCH} L=197 h=6 D=384 (ViTSTR)'},
        {'name': 'attention_flashbwd_backward', 'route': 'cuda',
         'source': 'parseq_tpu_torch/csrc/flash_bwd.cu',
         'replaces': 'parseq_tpu/ops/flash_bwd.py:64',
         'launches': main_launches['B4'], 'max_abs_err': b4_err,
         'launches_tuning': tune_info['b4'], 'launches_two_ranks': rank_info['b4'],
         'ms': timed['B4', 48][0], 'plain_ms': timed['B4', 48][1],
         'bound_ms': b4_ms[0], 'bound_us': b4_ms[0] * 1e3, 'bound_by': b4_ms[1],
         'library_ms': timed['B4', 48][2],
         'at': '(B, h, L, dh)=(48, 6, 128, 64) bf16 (PARSeq-S training microbatch)',
         'whole_batch': {'at': '(384, 6, 128, 64)', 'ms': timed['B4', 384][0],
                         'plain_ms': timed['B4', 384][1], 'library_ms': timed['B4', 384][2],
                         'bound_ms': b4_bound(*B4_SHAPES[1])[0]}},
        {'name': 'fused_attention', 'route': 'cuda',
         'source': 'parseq_tpu_torch/csrc/attention.cu',
         'replaces': 'parseq_tpu/ops/attention.py:82',
         'launches': main_launches['B3'], 'max_abs_err': b3_err,
         'ms': timed['B3', 128][0], 'plain_ms': timed['B3', 128][1],
         'bound_ms': b3_ms[0], 'bound_us': b3_ms[0] * 1e3, 'bound_by': b3_ms[1],
         'library_ms': timed['B3', 128][2], 'at': f'(BH, L, dh)=({6 * TIMED_BATCH}, 128, 64) bf16'},
        {'name': 'fused_encoder_blocks', 'route': 'cuda',
         'source': 'parseq_tpu_torch/csrc/encoder_blocks.cu',
         'replaces': 'parseq_tpu/ops/encoder_kernel.py:170',
         'launches': main_launches['B5'], 'launches_bench': b5_bench, 'max_abs_err': b5_err,
         'ms': bench['b5_ms'], 'plain_ms': b5_plain_ms,
         'bound_ms': b5_ms[0], 'bound_us': b5_ms[0] * 1e3, 'bound_by': b5_ms[1],
         'library_ms': bench['library_ms'],
         'at': f'B={TIMED_BATCH} (L, D, heads, MLP)=(128, 384, 6, 1536) depth {B5_DEPTH} bf16 '
               f'(PARSeq-S encoder)'},
        {'name': 'bn_act', 'route': 'cuda', 'source': 'parseq_tpu_torch/csrc/bn_act.cu',
         'replaces': None, 'launches': main_launches['BN'], 'max_abs_err': 0.0,
         'ms': timed['BN', BN_SHAPES[0], 'relu'][0],
         'plain_ms': timed['BN', BN_SHAPES[0], 'relu'][1],
         'bound_ms': bn_bound(*BN_SHAPES[0])[0], 'bound_us': bn_bound(*BN_SHAPES[0])[0] * 1e3,
         'bound_by': bn_bound(*BN_SHAPES[0])[1], 'library_ms': None,
         'at': f'{BN_SHAPES[0]} bf16 channels-last, batch norm + ReLU (ABINet\'s ResNet45 stem)',
         'other_shapes': [{'at': f'{shape} {form}', 'ms': timed['BN', shape, form][0],
                           'plain_ms': timed['BN', shape, form][1],
                           'bound_ms': bn_bound(*shape, form == 'identity')[0]}
                          for shape in BN_SHAPES for form in ('relu', 'identity')
                          if (shape, form) != (BN_SHAPES[0], 'relu')]},
    ]}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


@contextlib.contextmanager
def tps_in_f32(module):
    """TRBA's or TRBC's TPS rectification (localization, grid, sampling) in
    f32, its result cast back to the compute dtype."""
    module.tps = lambda images: type(module).tps(module, images.float()).to(images.dtype)
    try:
        yield
    finally:
        del module.tps


def cnn_paths(name, module, x):
    """A CNN family's logits on the card for images `x`: f32 ('ref'), bf16
    ('bf16'), for TRBA and TRBC bf16 with the TPS in f32, bf16 with the last
    BiLSTM's reverse direction zeroed (a planted fault; TPS in f32 where
    there is one) and f32 on the CPU ('host'). TRBA runs teacher-forced on
    the f32 path's greedy picks; its greedy f32 logits ('greedy') must equal
    the forced ones."""
    kw, out = {}, {}
    tps = name != 'crnn'
    faulty = copy.deepcopy(module)
    with torch.no_grad():
        last = (faulty.rnn if name == 'crnn' else faulty.SequenceModeling)[-1].rnn
        for pname, p in last.named_parameters():
            if pname.endswith('_reverse'):
                p.zero_()
    host = copy.deepcopy(module).cpu()
    with torch.inference_mode():
        out['ref'] = module(x, dtype=torch.float32)
        if name == 'trba':
            picks = out['ref'].argmax(-1)
            bos = torch.full_like(picks[:, :1], module.cfg.bos_id)
            kw['text'] = torch.cat([bos, picks[:, :-1]], dim=1)
            out['greedy'], out['ref'] = out['ref'], module(x, dtype=torch.float32, **kw)
        out['bf16'] = module(x, dtype=torch.bfloat16, **kw)
        if tps:
            with tps_in_f32(module):
                out['bf16, TPS in f32'] = module(x, dtype=torch.bfloat16, **kw)
        with tps_in_f32(faulty) if tps else contextlib.nullcontext():
            out['fault'] = faulty(x, dtype=torch.bfloat16, **kw)
        out['host'] = host(x.cpu(), dtype=torch.float32, **{k: v.cpu() for k, v in kw.items()})
    return out


def read_cnn_family(name, bundle, rng):
    """A CNN family's B = 7 bf16 logits against its f32 path within its own
    limits, which a planted fault must fail, and its f32 path on the card
    against the CPU's; then it reads B = 1, 7 and 256 in bf16 on the card,
    launching no TPU kernel and, at its batch norms, csrc/bn_act.cu: returns
    that kernel's launches in the reads."""
    from parseq_tpu_torch.ops import ar_kernel, attention, cnn

    module, tok = bundle.module, bundle.tokenizer
    ctc = name != 'trba'
    batches = {B: rng.uniform(-1, 1, (B, *bundle.img_size, 3)).astype(np.float32)
               for B in BATCHES}
    out = cnn_paths(name, module, torch.from_numpy(batches[7]).cuda())
    ref = out['ref']
    scale = float(ref.abs().max())
    # f32 against f32 (F32_MAIN_ATOL, F32_MAIN_MARGIN) relative to it as well
    f32_atol, f32_margin = F32_MAIN_ATOL * scale, F32_MAIN_MARGIN * scale
    if 'greedy' in out:
        compare(out['greedy'], ref, f32_atol, f32_margin,
                f'{name} f32 teacher-forced on its greedy picks')
    fault_diff = float((out['fault'] - ref).abs().max())
    readings = []
    for path, (atol, margin) in CNN_LIMITS[name].items():
        diff, n_confident = compare(out[path], ref, atol * scale, margin * scale,
                                    f'{name} {path} path')
        try:
            compare(out['fault'], ref, atol * scale, margin * scale,
                    f'{name} {path} path, planted fault')
        except AssertionError:
            pass
        else:
            raise AssertionError(f'{name}: the {path} check passes the last BiLSTM with its '
                                 f'reverse direction zeroed ({fault_diff / scale:.3e} of max|f32 '
                                 f'logits|)')
        readings.append(f'{path}: {diff / scale:.3e} (limit {atol}), argmax equal where the f32 '
                        f'margin > {margin} of it ({n_confident} of {ref[..., 0].numel()} '
                        f'positions)')
    host_diff, n_host = compare(ref.cpu(), out['host'], f32_atol, f32_margin,
                                f'{name} f32 path on the card')
    print(f'{name}: B=7 vs the f32 path (logits{"" if ctc else ", teacher-forced"}), max|f32 '
          f'logits| {scale:.4g}, max_abs_diff relative to it: ' + '; '.join(readings) +
          f'; planted fault (last BiLSTM\'s reverse direction zeroed) {fault_diff / scale:.3e}, '
          f'fails every limit; f32 on the card vs on the CPU {host_diff / scale:.3e} (limit '
          f'{F32_MAIN_ATOL}, argmax equal where the margin > {F32_MAIN_MARGIN} of it: {n_host} '
          f'positions)')

    head = (module.rnn[1].linear if name == 'crnn'
            else module.Prediction if ctc else module.Prediction.generator)
    with torch.no_grad():
        head.bias[tok.blank_id if ctc else tok.eos_id] += BLANK_BIAS if ctc else EOS_BIAS
    ar_kernel.launches = attention.launches = attention.split_launches = cnn.launches = 0
    positions = bundle.img_size[1] // 4 + 1 if ctc else bundle.cfg.num_steps
    charset = set(tok.charset)
    for B, x in batches.items():
        labels, confs = bundle.read(x)
        if not len(labels) == len(confs) == B:
            raise AssertionError(f'{name}: read returned {len(labels)} labels for {B} images')
        for text, conf in zip(labels, confs):
            if not (isinstance(text, str) and len(text) <= positions and set(text) <= charset
                    and 0.0 < conf <= 1.0):
                raise AssertionError(f'{name}: bad read at B={B}: {text!r} conf={conf}')
        print(f'{name} B={B}: {labels[:3]} conf {[f"{c:.3g}" for c in confs[:3]]}')
    launched = ar_kernel.launches + attention.launches + attention.split_launches
    if launched:
        raise AssertionError(f'{name}: its reads launched {launched} attention or AR kernels')
    if cnn.launches < len(batches):
        raise AssertionError(f'{name}: its {len(batches)} reads launched the batch-norm pass '
                             f'{cnn.launches} times')
    print(f'{name}: launches no TPU kernel; the batch-norm pass {cnn.launches} times')
    return cnn.launches


def eval_phase(parseq_bundle, crnn_bundle, data_root):
    """cli.test evaluates PARSeq-S and CRNN (their phase-4 weights, saved as
    reference state_dicts) on a synthetic LMDB of the benchmark sets at their
    published sizes, written under `data_root` (phase 12 reads it again; the
    caller removes it), and PARSeq-S once more with the Python LMDB reader in
    place of the native one; cli.bench benches BENCH_RUNS, as a user calls
    them. Returns B1's launches in these runs and each run's evaluation
    times."""
    from unittest import mock

    from parseq_tpu_torch.cli import bench as bench_cli
    from parseq_tpu_torch.cli import test as test_cli
    from parseq_tpu_torch.data import dataset
    from parseq_tpu_torch.data.lmdb import LmdbReader
    from parseq_tpu_torch.data.module import TEST_BENCHMARK, TEST_BENCHMARK_SUB
    from parseq_tpu_torch.ops import ar_kernel

    rng = np.random.default_rng(SEED + 2)
    letters = np.array(list(string.digits + string.ascii_lowercase))
    sets = sorted(set(TEST_BENCHMARK_SUB + TEST_BENCHMARK))
    if sorted(EVAL_SETS) != sets:
        raise AssertionError(f'EVAL_SETS {sorted(EVAL_SETS)} are not the benchmark sets {sets}')
    batches = sum(-(-n // EVAL_BATCH) for n in EVAL_SETS.values())
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix='smoke-eval-', dir=root))
    b1, timings, tables = 0, {}, {}
    try:
        t0 = time.perf_counter()
        for name in sets:
            write_lmdb(data_root / 'test' / name,
                       [''.join(rng.choice(letters, rng.integers(3, 11)))
                        for _ in range(EVAL_SETS[name])])
        print(f'synthetic LMDB: {len(sets)} benchmark sets, {sum(EVAL_SETS.values())} '
              f'PIL-rendered words ({EVAL_SETS}) in {time.perf_counter() - t0:.1f} s')
        for run, family, bundle in (('parseq', 'parseq', parseq_bundle),
                                    ('crnn', 'crnn', crnn_bundle),
                                    ('parseq_python_reader', 'parseq', parseq_bundle)):
            ckpt = tmp / f'{family}-smoke.pt'
            torch.save({k: v.cpu() for k, v in bundle.module.state_dict().items()}, ckpt)
            ar_kernel.launches = 0
            t0 = time.perf_counter()
            # the loader's workers are forked: they open the patched reader
            with (mock.patch.object(dataset, 'open_reader', LmdbReader)
                  if run.endswith('python_reader') else contextlib.nullcontext()):
                results, timing = test_cli.main([str(ckpt), '--data_root', str(data_root),
                                                 '--device', 'cuda',
                                                 '--batch_size', str(EVAL_BATCH)])
            wall = time.perf_counter() - t0
            launches = ar_kernel.launches
            if family == 'parseq':
                if launches < batches:
                    raise AssertionError(f'cli.test PARSeq-S launched B1 {launches} times, '
                                         f'expected >= {batches} (one a batch)')
                b1 += launches
            if sorted(results) != sets or not all(
                    r.num_samples == EVAL_SETS[name] and 0.0 <= r.accuracy <= 100.0
                    and 0.0 <= r.ned <= 100.0 and 0.0 < r.confidence <= 100.0
                    and 0.0 <= r.label_length <= 33 for name, r in results.items()):
                raise AssertionError(f'cli.test {family}: {results}')
            if '| Combined' not in Path(str(ckpt) + '.log.txt').read_text():
                raise AssertionError(f'cli.test {family}: no results table in its log file')
            tables[run] = results
            if run == 'parseq_python_reader' and tables[run] != tables['parseq']:
                raise AssertionError(f'cli.test PARSeq-S reads otherwise with the Python LMDB '
                                     f'reader: {tables[run]} vs {tables["parseq"]}')
            img_s = timing['images'] / timing['eval_s']
            timings[run] = dict(timing, batches=batches, img_per_s=img_s, wall_s=wall)
            print(f'cli.test {run}: {timing["images"]} images in {batches} batches of <= '
                  f'{EVAL_BATCH}, read in {timing["eval_s"]:.3f} s = {img_s:.1f} img/s, '
                  f'{timing["loader_s"]:.3f} s of it waiting on the loader '
                  f'({timing["first_batch_s"]:.3f} s for the first batch of each set); model '
                  f'load {timing["load_s"]:.3f} s; wall {wall:.3f} s; B1 launches {launches}')
        keys = ['model', 'params_M', 'flops_per_img_G', 'batch_size', 'latency_ms_median',
                'latency_ms_iqr', 'throughput_img_s']
        for model, B in BENCH_RUNS:
            ar_kernel.launches = 0
            (r,) = bench_cli.main(['--model', model, '--batch_size', str(B)])
            launches = ar_kernel.launches
            if model == 'parseq':
                if launches < 1:
                    raise AssertionError(f'cli.bench PARSeq-S B={B} did not launch B1')
                b1 += launches
            if not (list(r) == keys and r['batch_size'] == B and r['flops_per_img_G']
                    and all(math.isfinite(r[k]) and r[k] > 0 for k in keys[1:])):
                raise AssertionError(f'cli.bench {model} B={B}: {r}')
            print(f'cli.bench {model} B={B}: B1 launches {launches}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return b1, timings


def train_phase(dev, card, main_launches):
    """PARSeq-S trains through cli.train on a synthetic LMDB; checks, reload,
    the B4-vs-plain gradient comparison and the step times. Returns the
    numbers it measured."""
    from parseq_tpu_torch import kernels
    from parseq_tpu_torch.cli import train as train_cli
    from parseq_tpu_torch.data.tokenizer import Tokenizer
    from parseq_tpu_torch.ops import ar_kernel, flash_bwd
    from parseq_tpu_torch.train.families import get_family
    from parseq_tpu_torch.train.optim import OptimConfig
    from parseq_tpu_torch.train.steps import init_state, make_train_step
    from parseq_tpu_torch.utils.config import compose
    from parseq_tpu_torch.utils.registry import create_model, load_from_checkpoint

    config = compose('parseq')
    charset = config['model']['charset_train']
    batch_size = config['model']['batch_size']
    mb = config['trainer']['microbatches']
    depth = config['model']['enc_depth']
    rng = np.random.default_rng(SEED)
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix='smoke-train-', dir=root))
    try:
        t0 = time.perf_counter()
        words = write_train_lmdb(tmp / 'data', rng, charset)
        print(f'synthetic LMDB: {TRAIN_WORDS} train / {VAL_WORDS} val PIL-rendered words in '
              f'{time.perf_counter() - t0:.1f} s')

        flash_bwd.launches = 0
        ar_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, best = train_cli.main([
            '+experiment=parseq', f'data.root_dir={tmp / "data"}',
            f'trainer.max_steps={TRAIN_STEPS}', f'trainer.val_check_interval={TRAIN_STEPS // 2}',
            f'--work_dir={tmp / "run"}', f'--seed={SEED}', '--device', 'cuda'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_bwd.launches
        peak_run = torch.cuda.max_memory_allocated() / 2 ** 30
        need = depth * mb * TRAIN_STEPS
        if launches < need:
            raise AssertionError(f'training launched B4 {launches} times, expected >= {need}')
        main_launches['B4'] = launches
        print(f'cli.train: {TRAIN_STEPS} steps at batch {batch_size}, microbatches {mb}, '
              f'{wall:.1f} s wall incl. data and 2 validations; B4 launches {launches} '
              f'(>= {need}); B1 launches in validation '
              f'{ar_kernel.launches}; '
              f'peak memory {peak_run:.2f} GiB')

        metrics = [json.loads(line) for line in open(tmp / 'run' / 'metrics.jsonl')]
        losses = [(m['step'], m['loss'], m['grad_norm']) for m in metrics if 'loss' in m]
        vals = [m for m in metrics if 'val_accuracy' in m]
        if not losses or not all(np.isfinite(x) for _, l, g in losses for x in (l, g)):
            raise AssertionError(f'training metrics not finite: {losses}')
        if [v['step'] for v in vals] != [TRAIN_STEPS // 2, TRAIN_STEPS] or not all(
                np.isfinite(v['val_loss']) for v in vals):
            raise AssertionError(f'validations: {vals}')
        ckpts = tmp / 'run' / 'checkpoints'
        for name in ('last.ckpt', 'train_state.ckpt', 'swa.ckpt'):
            if not (ckpts / name).exists():
                raise AssertionError(f'{name} missing after training')
        if state['step'] != TRAIN_STEPS or best is None or not best.exists():
            raise AssertionError(f'step {state["step"]}, best checkpoint {best}')
        val_rows = [(v['step'], round(v['val_loss'], 4), v['val_accuracy']) for v in vals]
        print(f'loss/grad_norm {losses}; validation {val_rows}; '
              f'checkpoints {sorted(p.name for p in ckpts.iterdir())}')

        bundle = load_from_checkpoint(str(best), device='cuda')
        x = rng.uniform(-1, 1, (7, 32, 128, 3)).astype(np.float32)
        logits = bundle(x)
        labels, confs = bundle.read(x)
        # 12 steps from random weights: the reads are not words yet, and a
        # confidence (a product of 26 probabilities) may underflow to 0.
        if not (logits.shape == (7, 26, 95) and torch.isfinite(logits).all()
                and len(labels) == 7 and all(set(t) <= set(charset) for t in labels)
                and all(0.0 <= c <= 1.0 for c in confs)):
            raise AssertionError(f'read from the checkpoint: {labels} {confs}')
        print(f'reloaded {best.name} on cuda: read 7 images -> {labels[:3]} ...')
        del state, bundle
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # One fixed batch, the same weights and dropout bits: one step's gradients
    # with B4 and under kernels.plain().
    tok = Tokenizer(charset)
    fixed = {'images': torch.from_numpy(rng.integers(0, 256, (batch_size, 32, 128, 3),
                                                     dtype=np.uint8)).to(dev),
             'tgt': torch.from_numpy(tok.encode(words[:batch_size], 25)).to(dev)}
    family = get_family('parseq')
    grads = {}
    for route in ('b4', 'plain'):
        bundle = create_model('parseq', seed=SEED, device='cuda')
        model = bundle.module.train()
        fixed['perms'] = torch.from_numpy(family.prepare(tok, words[:1], bundle.cfg,
                                                         np.random.default_rng(1))['perms']).to(dev)
        step = make_train_step(family, bundle.cfg, torch.bfloat16, microbatches=mb)
        state = init_state(model, OptimConfig(total_steps=100, batch_size=batch_size))
        gen = torch.Generator(device=dev).manual_seed(7)
        with (kernels.plain() if route == 'plain' else contextlib.nullcontext()):
            before = flash_bwd.launches
            # lr 0 keeps the weights: only the gradients are compared
            state['opt_state'].sched = lambda _: 0.0
            step(state, dict(fixed), gen)
            if (flash_bwd.launches > before) != (route == 'b4'):
                raise AssertionError(f'route {route}: B4 launches {flash_bwd.launches - before}')
        grads[route] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        del bundle, model, state
    worst = (0.0, '')
    for n, g in grads['plain'].items():
        rel = float((grads['b4'][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
        worst = max(worst, (rel, n))
    if worst[0] > GRAD_RTOL:
        raise AssertionError(f'gradients with B4 vs plain autograd: {worst[1]} differs by '
                             f'{worst[0]:.3e} of its largest value (limit {GRAD_RTOL})')
    print(f'one step, B4 vs plain backward: worst per-parameter max|diff| / max|grad| '
          f'{worst[0]:.3e} ({worst[1]}), limit {GRAD_RTOL}')
    del grads

    # Step times on the fixed batch, in turns: B4, plain, plain, B4.
    bundle = create_model('parseq', seed=SEED, device='cuda')
    model = bundle.module.train()
    step = make_train_step(family, bundle.cfg, torch.bfloat16, microbatches=mb)
    state = init_state(model, OptimConfig(total_steps=100, batch_size=batch_size))
    times = {'b4': [], 'plain': []}
    torch.cuda.reset_peak_memory_stats()
    for route in ('b4', 'plain', 'plain', 'b4'):
        with (kernels.plain() if route == 'plain' else contextlib.nullcontext()):
            for i in range(STEP_TIMED + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(state, dict(fixed), torch.Generator(device=dev).manual_seed(i))
                torch.cuda.synchronize()
                if i:  # the first step of each turn is a warm-up
                    times[route].append((time.perf_counter() - t0) * 1e3)
                if not (math.isfinite(float(m['loss'])) and math.isfinite(float(m['grad_norm']))):
                    raise AssertionError(f'train step {route}: loss {m["loss"]}, '
                                         f'grad_norm {m["grad_norm"]}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    b4_ms, plain_ms = statistics.median(times['b4']), statistics.median(times['plain'])

    # Where one step's device time goes (kernel self times; the profiler
    # slows the host, so shares are taken against the unprofiled step time).
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, dict(fixed), torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == 'CUDA']
    dev_ms = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    busy = sum(dev_ms.values())
    b4_dev = sum(t for k, t in dev_ms.items() if 'bwd_kernel' in k)
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    print(f'profiled step [{card}]: device busy {busy:.2f} ms = {busy / b4_ms:.1%} of the '
          f'{b4_ms:.2f} ms step; B4 {b4_dev:.2f} ms ({b4_dev / b4_ms:.1%}); '
          f'{sum(e.count for e in kernels)} kernel launches; top kernels (ms): '
          + '; '.join(f'{k[:60]} {t:.2f}' for k, t in top))
    # The same step at fewer, larger microbatches (the configured 8 was set
    # on a TPU): time and peak memory, for the port's own choice later.
    sweep = {}
    for m in (1, 2, 4):
        step_m = make_train_step(family, bundle.cfg, torch.bfloat16, microbatches=m)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_m(state, dict(fixed), torch.Generator(device=dev).manual_seed(i))
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        sweep[m] = (statistics.median(ms), torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f'train step B={batch_size} by microbatches [{card}]: '
          + '; '.join(f'{m}: {t:.2f} ms, peak {g:.2f} GiB' for m, (t, g) in sweep.items())
          + f'; {mb}: {b4_ms:.2f} ms, peak {peak:.2f} GiB')
    info = {'step_ms_b4': b4_ms, 'step_ms_plain': plain_ms,
            'step_ms_by_microbatches': {m: t for m, (t, _) in sweep.items()},
            'peak_gib_by_microbatches': {m: g for m, (_, g) in sweep.items()},
            'img_per_s_b4': batch_size / b4_ms * 1e3, 'peak_memory_gib': peak,
            'peak_memory_gib_cli_run': peak_run, 'microbatches': mb,
            'b4_launches_per_step': depth * mb, 'grad_rel_diff': worst[0],
            'device_busy_ms': busy, 'b4_device_ms': b4_dev}
    print(f'train step B={batch_size} (microbatches {mb}) [{card}]: B4 {b4_ms:.2f} ms '
          f'({batch_size / b4_ms * 1e3:.1f} img/s), plain backward {plain_ms:.2f} ms; '
          f'peak memory {peak:.2f} GiB; all steps B4 {[round(t, 2) for t in times["b4"]]}, '
          f'plain {[round(t, 2) for t in times["plain"]]}')
    return info



def _bn_buffers(model):
    return {n: b.detach().double().cpu() for n, b in model.named_buffers()
            if n.endswith(('running_mean', 'running_var'))}


@contextlib.contextmanager
def float64_mode():
    """While open, `.float()` leaves a float64 tensor as it is (the port's
    layers take statistics, softmaxes and logits in float32 by `.float()`),
    and every model takes its plain path (kernels.plain(): the kernels are
    bf16 and f32): a float64 model computes in float64 throughout."""
    from parseq_tpu_torch import kernels

    to_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (self if self.dtype == torch.float64
                                                else to_float(self, *a, **k))
    try:
        with kernels.plain():
            yield
    finally:
        torch.Tensor.float = to_float


def smooth_images(rng, n, h, w, cell=8):
    """uint8 images that vary over `cell` pixels, as text crops do: noise at
    1/cell of the resolution, upsampled bilinearly."""
    lo = rng.uniform(0, 255, (n, h // cell + 2, w // cell + 2, 3))
    y, x = np.linspace(0, h // cell + 1, h), np.linspace(0, w // cell + 1, w)
    y0, x0 = np.minimum(y.astype(int), h // cell), np.minimum(x.astype(int), w // cell)
    wy, wx = (y - y0)[None, :, None, None], (x - x0)[None, None, :, None]
    rows = lo[:, y0] * (1 - wy) + lo[:, y0 + 1] * wy
    return np.rint(rows[:, :, x0] * (1 - wx) + rows[:, :, x0 + 1] * wx).astype(np.uint8)


def card_vs_cpu(experiment, fault=False, joint=False, dtype=torch.float32):
    """One train step of `experiment` (dropout 0, lr 0) in `dtype` (float32,
    TF32 off, or float64: float64_mode) on the CPU and on cuda from the
    same state_dict and numpy batch of CARD_CPU_BATCH
    (smooth images for the TPS families, see the comment above
    FAMILY_RUNS); ABINet in its pretraining stage, or with `joint` in its
    joint stage, where the card's language model is fed the CPU's inputs;
    `fault`
    leaves the card side's batch norms in eval mode. Returns {'grad': (worst
    share, name) over the parameters held per parameter, 'trunk': (worst
    relative L2, name) over the trunk parameters that miss that limit,
    'stats': the worst batch-norm statistic difference, 'loss': (CPU,
    card), 'fed': how far the language model's inputs differed}."""
    from parseq_tpu_torch.train.families import get_family
    from parseq_tpu_torch.train.optim import OptimConfig
    from parseq_tpu_torch.train.steps import init_state, make_train_step
    from parseq_tpu_torch.utils.config import compose
    from parseq_tpu_torch.utils.registry import build_model

    mcfg = compose(experiment)['model']
    if 'dropout' in mcfg or 'abinet' in mcfg['name']:
        mcfg['dropout'] = 0.0
    name = mcfg['name']
    static = ({'lm_only': True} if mcfg.get('lm_only') else
              {'pretraining': not joint} if 'abinet' in name else {})
    family = get_family(name)
    rng = np.random.default_rng(SEED)
    sd, out, fed = None, {}, {'lm_inputs': [], 'tokens': 0.0, 'lengths': 0}
    replay = iter(fed['lm_inputs'])  # the CPU's, in order, on the card
    for device in ('cpu', 'cuda'):
        bundle = build_model(name, mcfg, seed=SEED, dtype=torch.float32, device=device)
        model = bundle.module
        if sd is None:
            sd = {k: v.clone() for k, v in model.state_dict().items()}
            h, w = bundle.img_size
            letters = np.array(list(mcfg['charset_train'][:62]))
            words = [''.join(rng.choice(letters, rng.integers(3, 11)))
                     for _ in range(CARD_CPU_BATCH)]
            images = (smooth_images(rng, CARD_CPU_BATCH, h, w) if name in ('trba', 'trbc') else
                      rng.integers(0, 256, (CARD_CPU_BATCH, h, w, 3), dtype=np.uint8))
            # normalised here, so that both devices read the same values (a
            # division by 255 on the card may round the last bit otherwise)
            images = ((images / 255.0 - 0.5) / 0.5).astype(np.float32 if dtype == torch.float32
                                                           else np.float64)
            batch_np = {'images': images,
                        **family.prepare(bundle.tokenizer, words, bundle.cfg, None)}
        model.load_state_dict(sd)
        model.to(dtype).train()
        if joint:
            assert model.cfg.l_detach  # the inputs carry no gradient
            language_forward = model.language_forward

            def fed_forward(tokens, lengths, rng=None, device=device):
                if device == 'cpu':
                    fed['lm_inputs'].append((tokens.detach().clone(), lengths.clone()))
                else:
                    want_t, want_l = next(replay)
                    fed['tokens'] = max(fed['tokens'],
                                        float((tokens.detach().cpu() - want_t).abs().max()))
                    fed['lengths'] += int((lengths.cpu() != want_l).sum())
                    tokens, lengths = want_t.to(device), want_l.to(device)
                return language_forward(tokens, lengths, rng)

            model.language_forward = fed_forward
        if fault and device == 'cuda':
            for m in model.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.eval()
        state = init_state(model, OptimConfig(total_steps=100, batch_size=CARD_CPU_BATCH))
        state['opt_state'].sched = lambda _: 0.0  # the weights stay; gradients are compared
        step = make_train_step(family, bundle.cfg, dtype, **static)
        with float64_mode() if dtype == torch.float64 else contextlib.nullcontext():
            m = step(state, {k: torch.from_numpy(np.asarray(v)).to(device)
                             for k, v in batch_np.items()}, None)
        out[device] = (float(m['loss']),
                       {n: (torch.zeros_like(p) if p.grad is None else p.grad).double().cpu()
                        for n, p in model.named_parameters()}, _bn_buffers(model))
        del bundle, model, state
    (loss_cpu, g_cpu, s_cpu), (loss_gpu, g_gpu, s_gpu) = out['cpu'], out['cuda']
    top = max(float(g.abs().max()) for g in g_cpu.values())
    limits = CARD_CPU_LIMITS[dtype]
    trunk = CARD_CPU_TRUNK.get(name, ((), 0.0))[0] if dtype == torch.float32 else ()
    worst, worst_trunk = (0.0, ''), (0.0, '')
    for n, g in g_cpu.items():
        err = float((g_gpu[n] - g).abs().max()) / max(float(g.abs().max()),
                                                      limits['floor'] * top, 1e-300)
        if n.startswith(trunk) and err > limits['grad']:
            rel = float((g_gpu[n] - g).norm() / g.norm().clamp(min=1e-30))
            worst_trunk = max(worst_trunk, (rel, n))
        else:
            worst = max(worst, (err, n))
    stats = max([float((s_gpu[n] - v).abs().max()) for n, v in s_cpu.items()] or [0.0])
    return {'grad': worst, 'trunk': worst_trunk, 'stats': stats, 'loss': (loss_cpu, loss_gpu),
            'fed': {k: fed[k] for k in ('tokens', 'lengths')}}


def card_vs_cpu_passes(name, r, dtype=torch.float32):
    limits = CARD_CPU_LIMITS[dtype]
    return (r['grad'][0] <= limits['grad'] and r['stats'] <= limits['stats']
            and r['trunk'][0] <= CARD_CPU_TRUNK.get(name, ((), 0.0))[1])


def train_families_phase(card, main_launches):
    """ViTSTR, CRNN, TRBC, TRBA, ABINet and ABINet's language model train
    through cli.train at their experiments' full width (batch 384,
    microbatches 8, bf16) for FAMILY_STEPS steps on a synthetic LMDB,
    validating every 2 steps; checks, reload and read; B2's launches on
    these paths; each family's f32 step on the card against the CPU (and a
    planted fault failing it); the step times. Returns the numbers."""
    from parseq_tpu_torch.cli import train as train_cli
    from parseq_tpu_torch.ops import attention
    from parseq_tpu_torch.train.families import get_family
    from parseq_tpu_torch.train.optim import OptimConfig, make_abinet_optimizer
    from parseq_tpu_torch.train.steps import init_state, make_train_step
    from parseq_tpu_torch.utils.config import compose
    from parseq_tpu_torch.utils.registry import build_model, load_from_checkpoint

    rng = np.random.default_rng(SEED + 9)
    charset = compose('vitstr')['model']['charset_train']
    letters = np.array(list(charset[:62]))
    words = [''.join(rng.choice(letters, rng.integers(3, 11)))
             for _ in range(TRAIN_WORDS + VAL_WORDS)]
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix='smoke-families-', dir=root))
    info = {'card': card}
    try:
        write_lmdb(tmp / 'data' / 'train' / 'real' / 'synthetic', words[:TRAIN_WORDS])
        write_lmdb(tmp / 'data' / 'val' / 'synthetic', words[TRAIN_WORDS:])
        for experiment in FAMILY_RUNS:
            attention.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, best = train_cli.main([
                f'+experiment={experiment}', f'data.root_dir={tmp / "data"}',
                f'trainer.max_steps={FAMILY_STEPS}', 'trainer.val_check_interval=2',
                f'--work_dir={tmp / experiment}', f'--seed={SEED}', '--device', 'cuda'])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b2 = attention.launches
            config = json.load(open(tmp / experiment / 'config.json'))
            mcfg, tcfg = config['model'], config['trainer']
            if (mcfg['batch_size'], tcfg['microbatches']) != (384, 8):
                raise AssertionError(f'{experiment}: batch {mcfg["batch_size"]}, microbatches '
                                     f'{tcfg["microbatches"]}')
            metrics = [json.loads(line) for line in open(tmp / experiment / 'metrics.jsonl')]
            losses = [(m['step'], m['loss'], m['grad_norm']) for m in metrics if 'loss' in m]
            vals = [m for m in metrics if 'val_accuracy' in m]
            if not losses or not all(np.isfinite(x) for _, l, g in losses for x in (l, g)):
                raise AssertionError(f'{experiment}: training metrics not finite: {losses}')
            if [v['step'] for v in vals] != [2, 4] or not all(np.isfinite(v['val_loss'])
                                                             for v in vals):
                raise AssertionError(f'{experiment}: validations {vals}')
            ckpts = tmp / experiment / 'checkpoints'
            for ckpt in ('last.ckpt', 'train_state.ckpt', 'swa.ckpt'):
                if not (ckpts / ckpt).exists():
                    raise AssertionError(f'{experiment}: {ckpt} missing after training')
            if state['step'] != FAMILY_STEPS or best is None or not best.exists():
                raise AssertionError(f'{experiment}: step {state["step"]}, best {best}')
            del state
            bundle = load_from_checkpoint(str(best), device='cuda')
            x = rng.uniform(-1, 1, (7, *bundle.img_size, 3)).astype(np.float32)
            logits = bundle(x)
            labels, confs = bundle.read(x)
            if not (torch.isfinite(logits).all() and len(labels) == 7
                    and all(0.0 <= c <= 1.0 for c in confs)):
                raise AssertionError(f'{experiment}: read from the checkpoint: {labels} {confs}')
            del bundle
            if experiment == 'vitstr':
                need = 12 * 8 * FAMILY_STEPS
                if b2 < need:
                    raise AssertionError(f'ViTSTR training launched B2 {b2} times, expected '
                                         f'>= {need}')
                info['b2_vitstr_cli'] = b2
                main_launches['B2'] += b2
            if experiment == 'abinet':
                if b2 < 1:
                    raise AssertionError('ABINet\'s validations launched no B2')
                info['b2_abinet_cli'] = b2
                main_launches['B2'] += b2
            print(f'cli.train {experiment} [{card}]: {FAMILY_STEPS} steps at batch 384, '
                  f'microbatches 8, bf16, {wall:.1f} s wall incl. data, 2 validations and the '
                  f'SWA batch-norm pass; B2 launches {b2}; loss/grad_norm {losses}; '
                  f'validation {[(v["step"], round(v["val_loss"], 4)) for v in vals]}; peak '
                  f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; read 7 images from '
                  f'{best.name} -> {labels[:2]} ...')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # Card vs CPU, one step each in f32 and in float64 (ABINet in both its
    # stages), and the planted fault (batch norms left in eval mode on the
    # card) failing the same limits; every reading is printed before a
    # failure raises.
    info['card_vs_cpu'] = {}
    failed = []
    f32, f64 = CARD_CPU_LIMITS[torch.float32], CARD_CPU_LIMITS[torch.float64]
    for experiment, joint in [(e, False) for e in FAMILY_RUNS] + [('abinet', True)]:
        name = compose(experiment)['model']['name']
        label = experiment + (' joint' if joint else ' pretraining' if name == 'abinet' else '')
        r = card_vs_cpu(experiment, joint=joint)
        d = card_vs_cpu(experiment, joint=joint, dtype=torch.float64)
        ok = card_vs_cpu_passes(name, r) and card_vs_cpu_passes(name, d, torch.float64)
        trunk_limit = CARD_CPU_TRUNK.get(name, ((), 0.0))[1]
        line = (f'{label} step, card vs CPU (batch {CARD_CPU_BATCH}): f32 (TF32 off) loss '
                f'{r["loss"][1]:.6f} / {r["loss"][0]:.6f}; worst gradient {r["grad"][0]:.3e} of '
                f'its largest ({r["grad"][1]}; limit {f32["grad"]}); trunk relative L2 '
                f'{r["trunk"][0]:.3e} ({r["trunk"][1] or "none missed the limit"}; limit '
                f'{trunk_limit}); batch-norm statistics {r["stats"]:.3e} (limit {f32["stats"]}); '
                f'float64: worst gradient {d["grad"][0]:.3e} ({d["grad"][1]}; limit '
                f'{f64["grad"]}), statistics {d["stats"]:.3e} (limit {f64["stats"]})')
        if joint:
            line += (f'; its language model fed the CPU\'s inputs, which differed by '
                     f'{r["fed"]["tokens"]:.3e} (tokens) and in {r["fed"]["lengths"]} lengths '
                     f'(f32), {d["fed"]["tokens"]:.3e} and {d["fed"]["lengths"]} (float64)')
        if not ok:
            failed.append(label)
        if name in BATCH_NORM_FAMILIES and not joint:
            f = card_vs_cpu(experiment, fault=True)
            g = card_vs_cpu(experiment, fault=True, dtype=torch.float64)
            if card_vs_cpu_passes(name, f) or card_vs_cpu_passes(name, g, torch.float64):
                failed.append(f'{label}: the planted fault passed')
            line += (f'; planted fault (batch norms in eval mode on the card): f32 gradient '
                     f'{f["grad"][0]:.3e} ({f["grad"][1]}), trunk {f["trunk"][0]:.3e} '
                     f'({f["trunk"][1]}), statistics {f["stats"]:.3e}; float64 gradient '
                     f'{g["grad"][0]:.3e}, statistics {g["stats"]:.3e}')
        print(line + (' ok' if ok else ' FAILED'), flush=True)
        info['card_vs_cpu'][label] = {'grad': r['grad'][0], 'trunk_l2': r['trunk'][0],
                                      'stats': r['stats'], 'grad_f64': d['grad'][0],
                                      'stats_f64': d['stats']}
    if failed:
        raise AssertionError(f'f32 step on the card vs the CPU failed: {failed}')

    # Step times on a fixed batch: median of FAMILY_TIMED after a warm-up,
    # peak memory, one profiled step's device-busy share; B2 per step.
    from torch.profiler import ProfilerActivity, profile

    info['steps'] = {}
    for experiment in FAMILY_RUNS:
        mcfg = compose(experiment)['model']
        name = mcfg['name']
        bundle = build_model(name, mcfg, seed=SEED, device='cuda')
        model = bundle.module.train()
        family = get_family(name)
        h, w = bundle.img_size
        batch = {'images': torch.from_numpy(rng.integers(0, 256, (384, h, w, 3), dtype=np.uint8)),
                 **{k: torch.from_numpy(np.asarray(v)) for k, v in family.prepare(
                     bundle.tokenizer, words[:384], bundle.cfg, np.random.default_rng(1)).items()}}
        batch = {k: v.to('cuda') for k, v in batch.items()}
        lm_only = bool(mcfg.get('lm_only'))
        static = ({'lm_only': True} if lm_only else {'pretraining': False} if 'abinet' in name
                  else {})
        ocfg = OptimConfig(total_steps=100, batch_size=384)
        state = init_state(model, ocfg)
        if 'abinet' in name:
            state['opt_state'] = make_abinet_optimizer(model.named_parameters(), ocfg, 3e-4, 44)
        step = make_train_step(family, bundle.cfg, torch.bfloat16, microbatches=8, **static)
        torch.cuda.reset_peak_memory_stats()
        times, b2 = [], []
        for i in range(FAMILY_TIMED + 1):
            gen = torch.Generator(device='cuda').manual_seed(i)
            before = attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, dict(batch), gen)
            torch.cuda.synchronize()
            b2.append(attention.launches - before)
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            if not (math.isfinite(float(m['loss'])) and math.isfinite(float(m['grad_norm']))):
                raise AssertionError(f'{experiment} step: loss {m["loss"]}, grad_norm '
                                     f'{m["grad_norm"]}')
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, dict(batch), torch.Generator(device='cuda').manual_seed(0))
            torch.cuda.synchronize()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total for e in events if e.device_type.name == 'CUDA') / 1e3
        launches = sum(e.count for e in events
                       if e.key in ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel'))
        if experiment == 'vitstr' and min(b2) < 12 * 8:
            raise AssertionError(f'a ViTSTR train step launched B2 {b2} times, expected >= 96')
        if 'abinet' in name and max(b2) != 0:
            raise AssertionError(f'an ABINet step with dropout launched B2: {b2}')
        info['steps'][experiment] = {'step_ms': ms, 'img_per_s': 384 / ms * 1e3,
                                     'peak_gib': peak, 'device_busy_ms': busy,
                                     'device_busy_share': busy / ms, 'b2_per_step': b2[-1],
                                     'launches_per_step': launches}
        print(f'train step {experiment} B=384 microbatches 8 bf16 [{card}]: {ms:.2f} ms '
              f'(median of {FAMILY_TIMED}; {[round(t, 2) for t in times]}), '
              f'{384 / ms * 1e3:.1f} img/s, peak {peak:.2f} GiB, device busy {busy:.2f} ms = '
              f'{busy / ms:.1%} of the step, {launches} kernel launches (one profiled step); B2 '
              f'per step {b2[-1]}')
        del bundle, model, state, step, batch
        torch.cuda.empty_cache()
    print(f'training families [{card}]: ' + json.dumps(info['steps']))
    return info


def drive(server, images, clients, window):
    """`clients` threads submit `images` (client c takes images c, c +
    clients, ...), each keeping up to `window` requests in flight. Returns
    the results in image order and the run's numbers: img/s over its wall
    time, request latency (submit to result) p50 / p99, and the batches it
    made, their mean fill and padded share."""
    results, latency = [None] * len(images), [0.0] * len(images)
    before = dict(server.stats)

    def timed_submit(i):
        t0 = time.perf_counter()
        future = server.submit(images[i])

        def done(_):
            latency[i] = (time.perf_counter() - t0) * 1e3

        future.add_done_callback(done)
        return future

    def client(c):
        pending = deque()
        for i in range(c, len(images), clients):
            pending.append((i, timed_submit(i)))
            if len(pending) == window:
                j, f = pending.popleft()
                results[j] = f.result(timeout=120)
        for j, f in pending:
            results[j] = f.result(timeout=120)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(client, range(clients)))
    wall = time.perf_counter() - t0
    n = {k: server.stats[k] - before[k] for k in before}
    q = statistics.quantiles(latency, n=100, method='inclusive')
    return results, {'images': len(images), 'wall_s': wall, 'img_per_s': len(images) / wall,
                     'latency_ms_p50': statistics.median(latency), 'latency_ms_p99': q[98],
                     'batches': n['batches'], 'mean_fill': n['requests'] / n['batches'],
                     'padded_share': n['padded'] / (n['requests'] + n['padded'])}


def serve_crops(img_size):
    """SERVE_WORDS distinct words of 3-10 letters and digits, rendered:
    (PNG bytes, uint8 crops of img_size)."""
    from PIL import Image

    from parseq_tpu_torch.data.transforms import preprocess_pil_u8

    rng = np.random.default_rng(SEED + 4)
    letters = np.array(list(string.digits + string.ascii_letters))
    words = list(dict.fromkeys(''.join(rng.choice(letters, rng.integers(3, 11)))
                               for _ in range(2 * SERVE_WORDS)))[:SERVE_WORDS]
    pngs = [render_word(w) for w in words]
    crops = []
    for png in pngs:
        with Image.open(io.BytesIO(png)) as img:
            crops.append(preprocess_pil_u8(img, img_size))
    return pngs, crops


def serve_phase(bundle, card):
    """PARSeq-S (phase 4's weights, bf16) served through serve.InferenceServer
    and cli.serve's HTTP handler; every served read held against a read of
    the same crop alone, a planted swap failing that check, B1's launches
    counted, preprocess_torch on the card against the CPU. Returns B1's
    launches while serving and the numbers measured."""
    from http.server import ThreadingHTTPServer

    from parseq_tpu_torch.cli.serve import make_handler
    from parseq_tpu_torch.data.transforms import preprocess_torch
    from parseq_tpu_torch.ops import ar_kernel
    from parseq_tpu_torch.serve import InferenceServer
    from parseq_tpu_torch.serve.server import CHECK_LIMITS, check_served, direct_reads

    head, ids = bundle.module.head, [bundle.tokenizer.eos_id,
                                     *bundle.tokenizer._tok2ids(SERVE_LETTERS)]
    with torch.no_grad():
        head.weight *= SERVE_HEAD_SCALE
        others = head.bias[[i for i in range(head.bias.numel()) if i not in ids]]
        head.bias[ids] = others.max() + SERVE_BIAS
    pngs, crops = serve_crops(bundle.img_size)
    t0 = time.perf_counter()
    direct = direct_reads(bundle, crops)
    texts, confs, gaps = direct
    # what a swap of two neighbours would show: texts or confidences apart
    apart = sum(not check_served([(texts[i + 1], confs[i + 1])],
                                 ([texts[i]], [confs[i]], [gaps[i]]))[0]
                for i in range(len(texts) - 1))
    print(f'direct reads of {len(crops)} distinct rendered words, one at a time: '
          f'{time.perf_counter() - t0:.1f} s; {len(set(texts))} distinct strings '
          f'(most common {Counter(texts).most_common(1)[0]}); '
          f'confidence {min(confs):.4g} ... {max(confs):.4g}; smallest top-1 - top-2 gap '
          f'{min(gaps):.4g} ... {max(gaps):.4g}, above {CHECK_LIMITS["gap"]} in '
          f'{sum(g > CHECK_LIMITS["gap"] for g in gaps)}; mean length '
          f'{statistics.mean(map(len, texts)):.2f}; neighbouring reads the check tells '
          f'apart {apart} of {len(texts) - 1}')
    if len(set(texts)) < SERVE_MIN_DISTINCT or statistics.mean(map(len, texts)) < SERVE_MIN_LENGTH:
        raise AssertionError(f'the direct reads are too alike for the check to see the decode '
                             f'steps: {len(set(texts))} distinct strings (at least '
                             f'{SERVE_MIN_DISTINCT}), mean length '
                             f'{statistics.mean(map(len, texts)):.2f} (at least {SERVE_MIN_LENGTH})')

    server = InferenceServer(bundle, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS)
    server.start()
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), make_handler(server, bundle))
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost only
    url = f'http://127.0.0.1:{httpd.server_address[1]}'

    def post(png):
        req = urllib.request.Request(f'{url}/v1/read', data=png, method='POST')
        with opener.open(req, timeout=60) as r:
            out = json.load(r)
        return out['text'], out['confidence']

    try:
        ar_kernel.launches = 0
        t0 = time.perf_counter()
        server.warmup()
        warmup_s = time.perf_counter() - t0
        runs = {}
        served, runs['8 clients'] = drive(server, crops, SERVE_CLIENTS, SERVE_WINDOW)
        http_thread.start()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            http_served = list(pool.map(post, pngs[:SERVE_HTTP]))
        with opener.open(f'{url}/healthz', timeout=60) as r:
            health = json.load(r)
        single, runs['1 client'] = drive(server, crops[:SERVE_SINGLE], 1, 1)
        launches, stats = ar_kernel.launches, dict(server.stats)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    if not health['ok'] or health['stats']['requests'] != SERVE_WORDS + SERVE_HTTP:
        raise AssertionError(f'/healthz: {health}')
    if launches != stats['batches'] + len(server.rungs):
        raise AssertionError(f'serving launched B1 {launches} times for {stats["batches"]} '
                             f'batches and {len(server.rungs)} warm-up rungs')
    for what, got in (('8 clients', served), ('HTTP', http_served), ('1 client', single)):
        n = len(got)
        ok, wrong, worst = check_served(got, (texts[:n], confs[:n], gaps[:n]))
        if not ok:
            raise AssertionError(f'served reads ({what}) disagree with the direct reads: '
                                 f'{wrong} texts differ where the gap > {CHECK_LIMITS["gap"]}, '
                                 f'worst relative confidence difference {worst:.3e} (limit '
                                 f'{CHECK_LIMITS["confidence"]})')
        print(f'served ({what}): {n} reads agree with the direct reads: texts equal where the gap '
              f'> {CHECK_LIMITS["gap"]}, {sum(t == w for (t, _), w in zip(got, texts))} of {n} '
              f'equal in all; worst relative confidence difference {worst:.3e} (limit '
              f'{CHECK_LIMITS["confidence"]})')
    print(f'B1 launches while serving {launches} = {stats["batches"]} batches + '
          f'{len(server.rungs)} warm-up rungs {server.rungs} (warm-up {warmup_s:.2f} s)')
    for what, r in runs.items():
        print(f'serving {bundle.name} {str(bundle.dtype)[6:]}, {what} [{card}]: '
              f'{r["img_per_s"]:.1f} img/s over '
              f'{r["images"]} requests in {r["wall_s"]:.3f} s; latency p50 '
              f'{r["latency_ms_p50"]:.3f} ms, p99 {r["latency_ms_p99"]:.3f} ms; '
              f'{r["batches"]} batches, mean fill {r["mean_fill"]:.2f}, padded share '
              f'{r["padded_share"]:.3f}')

    class SwappingServer(InferenceServer):
        """The planted fault: a drain that hands the first two requests of
        a batch each other's results."""

        def _resolve(self, reqs, ids, conf):
            super()._resolve([reqs[1], reqs[0], *reqs[2:]] if len(reqs) > 1 else reqs, ids, conf)

    fault = SwappingServer(bundle, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS).start()
    try:
        swapped, fault_run = drive(fault, crops, SERVE_CLIENTS, SERVE_WINDOW)
    finally:
        fault.stop()
    ok, wrong, worst = check_served(swapped, direct)
    if ok:
        raise AssertionError(f'the planted swap passed the check ({fault_run["batches"]} '
                             f'batches): wrong texts {wrong}, worst confidence {worst:.3e}')
    bad = sum(not check_served([s], ([t], [c], [g]))[0]
              for s, t, c, g in zip(swapped, texts, confs, gaps))
    print(f'planted fault (two results of a batch swapped, {fault_run["batches"]} batches): '
          f'fails the check, {bad} of {len(swapped)} reads out of limits ({wrong} texts where '
          f'the gap is clear), worst relative confidence difference {worst:.3e}')

    gen = np.random.default_rng(SEED + 5)
    for h, w in PREPROCESS_CROPS:
        x = gen.integers(0, 256, (8, h, w, 3), dtype=np.uint8)
        got = preprocess_torch(x, bundle.img_size, device='cuda')
        want = preprocess_torch(x, bundle.img_size)
        err = float((got.cpu() - want).abs().max())
        if not (got.device.type == 'cuda' and got.shape == want.shape and err <= PREPROCESS_ATOL):
            raise AssertionError(f'preprocess_torch {h}x{w}: card vs CPU {err} '
                                 f'(limit {PREPROCESS_ATOL})')
        print(f'preprocess_torch uint8 {h}x{w} -> {tuple(bundle.img_size)}: card vs CPU '
              f'max_abs_err={err:.3e} (limit {PREPROCESS_ATOL})')
    return {'b1': launches, 'runs': runs}


def tune_phase(card):
    """cli.tune searches PARSeq-S's LR (+experiment=parseq, TUNE_TRIALS
    trials of TUNE_STEPS steps, one rung) on phase 5's synthetic LMDB,
    written again. Returns B1's and B4's launches in it."""
    from parseq_tpu_torch.cli import tune as tune_cli
    from parseq_tpu_torch.ops import ar_kernel, flash_bwd
    from parseq_tpu_torch.utils.config import compose

    config = compose('parseq')
    need_b4 = (config['model']['enc_depth'] * config['trainer']['microbatches'] * TUNE_STEPS
               * TUNE_TRIALS)
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix='smoke-tune-', dir=root))
    try:
        write_train_lmdb(tmp / 'data', np.random.default_rng(SEED),
                         config['model']['charset_train'])
        flash_bwd.launches = 0
        ar_kernel.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            tune_cli.main(['+experiment=parseq', f'data.root_dir={tmp / "data"}',
                           '--num_samples', str(TUNE_TRIALS), '--rung_steps', str(TUNE_STEPS),
                           '--rungs', '1', '--work_dir', str(tmp / 'tune'), '--device', 'cuda'])
        wall = time.perf_counter() - t0
        b4, b1 = flash_bwd.launches, ar_kernel.launches
        last = json.loads(out.getvalue().strip().splitlines()[-1])
        results = json.loads((tmp / 'tune' / 'results.json').read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lrs = {r['lr'] for r in results}
    if not (len(results) == TUNE_TRIALS and len(lrs) == TUNE_TRIALS
            and math.isfinite(last['best_lr']) and last['best_lr'] in lrs
            and all(math.isfinite(r['val_loss']) for r in results)):
        raise AssertionError(f'cli.tune: {last} {results}')
    if b4 < need_b4 or b1 < TUNE_TRIALS:
        raise AssertionError(f'cli.tune launched B4 {b4} times (expected >= {need_b4}) and B1 '
                             f'{b1} times (expected >= {TUNE_TRIALS}, one a validation)')
    print(f'cli.tune +experiment=parseq [{card}]: {json.dumps(last)}; {wall:.1f} s wall; '
          f'trials (lr, val_NED, val_loss, wall s): '
          + '; '.join(f'{r["lr"]:.3e}, {r["val_NED"]:.3f}, {r["val_loss"]:.4f}, {r["wall_s"]:.1f}'
                      for r in results)
          + f'; B4 launches {b4} (>= {need_b4}), B1 launches {b1}')
    return {'b1': b1, 'b4': b4}


def _rank_train(argv):
    """One rank of phase 11a in a process of its own: cli.train with
    torchrun's environment, its steps timed; prints RANK_RESULT and a JSON
    object (launches, step times, peak memory, a checksum of the
    parameters, the best checkpoint)."""
    import hashlib

    from parseq_tpu_torch.cli import train as train_cli
    from parseq_tpu_torch.ops import ar_kernel, flash_bwd
    from parseq_tpu_torch.train import loop

    times = []
    make_step = loop.make_train_step

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(state, batch, rng):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch, rng)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return metrics

        return timed

    loop.make_train_step = timed_make_step
    torch.cuda.reset_peak_memory_stats()
    flash_bwd.launches = ar_kernel.launches = 0
    state, best = train_cli.main(argv)
    digest = hashlib.sha256()
    for p in state['model'].parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    print('RANK_RESULT ' + json.dumps({
        'b4': flash_bwd.launches, 'b1': ar_kernel.launches, 'step_ms': times,
        'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
        'checksum': digest.hexdigest(), 'best': str(best) if best else None}), flush=True)
    return 0


def _card_rank_steps(device, jobs):
    """parallel.dryrun.rank_step of each job (or of the jobs in the file
    named `jobs`, which this program wrote) on `device` with TF32 off, each
    float64 job in float64_mode."""
    from parseq_tpu_torch.parallel import dryrun

    if isinstance(jobs, str):
        jobs = torch.load(jobs, weights_only=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for job in jobs:
        with float64_mode() if job['dtype'] == torch.float64 else contextlib.nullcontext():
            out.append(dryrun.rank_step(device, **job))
    return out


def multirank_phase(card, certify_sd, abinet_sd):
    """11a: PARSeq-S trains on two ranks sharing the card through cli.train
    with torchrun's environment; 11b: one step of PARSeq-S and of CRNN on 2
    ranks against 1 in float64 and f32, two planted faults failing the
    limits; 11c: tools.certify_pretrained and tools.abinet_lm_acc on the
    card. Returns B4's and B1's launches and the numbers measured."""
    from parseq_tpu_torch.utils.config import compose

    rng = np.random.default_rng(SEED + 11)
    root = Path(__file__).resolve().parent / 'build'
    root.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix='smoke-ranks-', dir=root))
    try:
        write_train_lmdb(tmp / 'data', rng, compose('parseq')['model']['charset_train'])
        info = ranks_train(card, RANKS, tmp / 'data', tmp / 'train', rng, '11a',
                           ', two ranks on one card: not a scaling figure')
        info['math'] = ranks_math(RANKS, tmp / 'math', rng, '11b')
        info['b1'] += tools_on_card(certify_sd, abinet_sd, tmp / 'tools', rng)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return info


def ranks_train(card, ranks, data, tmp, rng, label, note=''):
    """PARSeq-S (+experiment=parseq) trains through cli.train for RANK_STEPS
    steps on `ranks` processes with torchrun's environment (a card a rank
    when there are as many, else all on cuda:0 over gloo) on the LMDB at
    `data`; checks the launches, the parameters, who wrote and a read of the
    best checkpoint. Returns the launches, step times and peak memory."""
    import os
    import subprocess

    from parseq_tpu_torch.parallel import dist
    from parseq_tpu_torch.utils.config import compose
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    config = compose('parseq')
    mcfg, tcfg = config['model'], config['trainer']
    depth, mb, charset = mcfg['enc_depth'], tcfg['microbatches'], mcfg['charset_train']
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    env = dict(os.environ, MASTER_ADDR='127.0.0.1', MASTER_PORT=str(dist.free_port()),
               WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks))
    logs, procs = [], []
    for r in range(ranks):
        args = ['+experiment=parseq', f'data.root_dir={data}',
                f'trainer.max_steps={RANK_STEPS}',
                f'trainer.val_check_interval={RANK_STEPS // 2}', 'trainer.multihost=true',
                f'--work_dir={tmp / f"run{r}"}', f'--seed={SEED}', '--device', 'cuda']
        logs.append(open(tmp / f'rank{r}.log', 'w+'))
        procs.append(subprocess.Popen(
            [sys.executable, '-c',
             'import sys, chip_smoke; sys.exit(chip_smoke._rank_train(sys.argv[1:]))', *args],
            cwd=Path(__file__).resolve().parent, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for r, (code, out) in enumerate(zip(codes, outs)):
        if code != 0 or 'RANK_RESULT ' not in out:
            raise AssertionError(f'rank {r} of cli.train exited {code}:\n{out[-4000:]}')
    results = [json.loads(out.split('RANK_RESULT ', 1)[1].splitlines()[0]) for out in outs]
    backends = [line.split('backend ', 1)[1] for out in outs for line in out.splitlines()
                if 'backend ' in line and f'of {ranks}:' in line]
    want = 'gloo' if ranks > torch.cuda.device_count() else 'nccl'  # NCCL: a card a rank
    print(f'{label}: {ranks} ranks of cli.train on {torch.cuda.device_count()} cards, process '
          f'group: {backends}')
    if len(backends) != ranks or not all(b.startswith(want) for b in backends):
        raise AssertionError(f'{ranks} ranks on {torch.cuda.device_count()} cards need {want}: '
                             f'{backends}')
    need = depth * mb * RANK_STEPS
    for r, res in enumerate(results):
        if res['b4'] < need or res['b1'] < 1:
            raise AssertionError(f'rank {r}: B4 launches {res["b4"]} (>= {need}), B1 '
                                 f'{res["b1"]} in its validations (>= 1)')
    if len({res['checksum'] for res in results}) != 1:
        raise AssertionError(f'parameters differ between the ranks after training: '
                             f'{[res["checksum"] for res in results]}')
    run = tmp / 'run0'
    for r in range(1, ranks):
        if (tmp / f'run{r}').exists():
            raise AssertionError(f'rank {r} wrote {sorted((tmp / f"run{r}").rglob("*"))}')
    wrote = sorted(p.name for p in run.iterdir())
    ckpts = sorted(p.name for p in (run / 'checkpoints').iterdir())
    if not ({'config.json', 'metrics.jsonl', 'tb', 'checkpoints'} <= set(wrote)
            and {'last.ckpt', 'train_state.ckpt'} <= set(ckpts)):
        raise AssertionError(f'rank 0 wrote {wrote}, checkpoints {ckpts}')
    metrics = [json.loads(line) for line in open(run / 'metrics.jsonl')]
    losses = [(m['step'], m['loss'], m['grad_norm']) for m in metrics if 'loss' in m]
    vals = [(m['step'], round(m['val_loss'], 4), m['val_accuracy'])
            for m in metrics if 'val_accuracy' in m]
    if ([v[0] for v in vals] != [RANK_STEPS // 2, RANK_STEPS]
            or not all(np.isfinite(x) for _, l, g in losses for x in (l, g))):
        raise AssertionError(f'metrics of the {ranks}-rank run: {losses} {vals}')
    best = Path(results[0]['best'])
    bundle = load_from_checkpoint(str(best), device='cuda')
    labels, confs = bundle.read(rng.uniform(-1, 1, (7, 32, 128, 3)).astype(np.float32))
    if not (len(labels) == 7 and all(set(t) <= set(charset) for t in labels)
            and all(0.0 <= c <= 1.0 for c in confs)):
        raise AssertionError(f'read from the {ranks}-rank checkpoint: {labels} {confs}')
    del bundle
    info = {'b4': sum(res['b4'] for res in results), 'b1': sum(res['b1'] for res in results),
            'ranks': [{k: res[k] for k in ('b4', 'b1', 'peak_gib')} for res in results],
            'rank_step_ms': [statistics.median(res['step_ms'][1:]) for res in results],
            'wall_s': wall}
    print(f'{label}: {RANK_STEPS} steps at the global batch {mcfg["batch_size"]} '
          f'({mcfg["batch_size"] // ranks} rows a rank, {mb} microbatches), bf16, '
          f'{wall:.1f} s wall incl. process start, data and 2 validations; launches '
          f'B4 {[res["b4"] for res in results]} (>= {need} each), B1 '
          f'{[res["b1"] for res in results]}; parameters equal on every rank (sha256 '
          f'{results[0]["checksum"][:16]}); loss/grad_norm {losses}; validation {vals}; '
          f'rank 0 wrote {wrote}, checkpoints {ckpts}; no other rank wrote; reloaded '
          f'{best.name} on cuda: read 7 images -> {labels[:2]} ...')
    print(f'{label} [{card}]{note}: step ms a rank '
          + '; '.join(f'rank {r}: median {statistics.median(res["step_ms"][1:]):.2f} of '
                      f'{[round(t, 2) for t in res["step_ms"]]}, peak '
                      f'{res["peak_gib"]:.2f} GiB' for r, res in enumerate(results)))
    return info


def ranks_math(ranks, tmp, rng, tag):
    """One step of each RANK_MATH_FAULTS model (dropout 0, a numpy batch of
    RANK_MATH_BATCH, RANK_MATH_MICRO microbatches) on `ranks` ranks against
    the same step on one, in float64 and f32, each planted fault failing
    RANK_LIMITS. Returns the distances."""
    from parseq_tpu_torch.parallel import dryrun
    from parseq_tpu_torch.train.families import get_family
    from parseq_tpu_torch.utils.config import compose
    from parseq_tpu_torch.utils.registry import build_model

    charset = compose('parseq')['model']['charset_train']
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    jobs = []
    for name, faults in RANK_MATH_FAULTS.items():
        mc = compose(name)['model']
        if 'dropout' in mc:
            mc['dropout'] = 0.0
        bundle = build_model(mc['name'], mc, seed=SEED, dtype=torch.float32, device='cpu')
        h, w = bundle.img_size
        words = [''.join(rng.choice(np.array(list(charset[:62])), rng.integers(3, 11)))
                 for _ in range(RANK_MATH_BATCH)]
        images = rng.integers(0, 256, (RANK_MATH_BATCH, h, w, 3)) / 255.0
        prepared = get_family(mc['name']).prepare(bundle.tokenizer, words, bundle.cfg,
                                                  np.random.default_rng(SEED))
        for dtype in RANK_LIMITS:
            batch = {'images': ((images - 0.5) / 0.5).astype(
                np.float32 if dtype == torch.float32 else np.float64), **prepared}
            for fault in (None, *faults):
                jobs.append(dict(family=mc['name'], model=bundle.module, batch=batch,
                                 microbatches=RANK_MATH_MICRO, dtype=dtype, fault=fault))
        del bundle
    torch.save(jobs, tmp / 'jobs.pt')  # read by each rank: no model in shared memory
    many = dryrun.run_ranks(ranks, _card_rank_steps, (str(tmp / 'jobs.pt'),), 'cuda')
    clean = [job for job in jobs if job['fault'] is None]
    one = dict(zip([(j['family'], j['dtype']) for j in clean],
                   _card_rank_steps(torch.device('cuda'), clean)))
    info = {}
    for i, job in enumerate(jobs):
        key = (job['family'], job['dtype'])
        d = dryrun.compare_steps(many[0][i], one[key])
        limits = RANK_LIMITS[job['dtype']]
        ok = (d['grad'][0] <= limits['grad'] and max(d['loss'], d['grad_norm'], d['stats'])
              <= limits['other'])
        same = all(torch.equal(g, other[i]['grads'][n]) for other in many[1:]
                   for n, g in many[0][i]['grads'].items())
        label = f'{job["family"]} {str(job["dtype"])[6:]} {job["fault"] or "clean"}'
        info[label] = {'grad': d['grad'][0], 'loss': d['loss'], 'grad_norm': d['grad_norm'],
                       'stats': d['stats']}
        print(f'{tag} {label}: {ranks} ranks vs 1: loss {d["loss"]:.3e}, grad_norm '
              f'{d["grad_norm"]:.3e}, worst gradient {d["grad"][0]:.3e} of its largest '
              f'({d["grad"][1]}), statistics {d["stats"]:.3e}; limits {limits}; ranks '
              f'bit-equal {same}')
        if ok != (job['fault'] is None) or (job['fault'] is None and not same):
            raise AssertionError(f'{tag} {label}: within the limits {ok}, ranks equal {same}')
    print(f'{tag}: {len(jobs)} steps on {ranks} ranks and {len(clean)} on 1 in '
          f'{time.perf_counter() - t0:.1f} s')
    return info


def tools_on_card(certify_sd, abinet_sd, tmp, rng):
    """tools.certify_pretrained on the PARSeq-S state_dict `certify_sd`, a
    released .pt in a temporary checksum cache, and tools.abinet_lm_acc on
    `abinet_sd`, both on cuda. Returns B1's launches in certify's reads."""
    import hashlib
    import os

    from parseq_tpu_torch.data.transforms import batch_images
    from parseq_tpu_torch.ops import ar_kernel
    from parseq_tpu_torch.tools import abinet_lm_acc, certify_pretrained
    from parseq_tpu_torch.utils import pretrained
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    raw = tmp / 'raw.pt'
    torch.save(certify_sd, raw)
    cache = tmp / 'cache'
    cache.mkdir()
    cached = cache / f'parseq-{hashlib.sha256(raw.read_bytes()).hexdigest()[:8]}.pt'
    raw.rename(cached)
    demo = tmp / 'demo'
    demo.mkdir()
    for name, text in certify_pretrained.DEMO_EXPECTED.items():
        with open(demo / name, 'wb') as f:
            f.write(render_word(text.lower()))
    url, cache_env = pretrained.WEIGHTS_URL['parseq'], os.environ.get('PARSEQ_TPU_CACHE')
    pretrained.WEIGHTS_URL['parseq'] = cached.as_uri()  # found in the cache; never fetched
    os.environ['PARSEQ_TPU_CACHE'] = str(cache)
    try:
        ar_kernel.launches = 0
        rc = certify_pretrained.main(['parseq', '--demo_dir', str(demo),
                                      '--out', str(tmp / 'certify.json'), '--device', 'cuda'])
        certify_b1 = ar_kernel.launches
    finally:
        pretrained.WEIGHTS_URL['parseq'] = url
        if cache_env is None:
            os.environ.pop('PARSEQ_TPU_CACHE')
        else:
            os.environ['PARSEQ_TPU_CACHE'] = cache_env
    verdict = json.loads((tmp / 'certify.json').read_text())
    paths = sorted(demo.iterdir())
    bundle = load_from_checkpoint(str(cached), dtype=torch.float32, device='cuda')
    want, want_conf = bundle.read(batch_images([str(p) for p in paths], bundle.img_size))
    got = [verdict['demo'][p.name]['pred'] for p in paths]
    got_conf = [verdict['demo'][p.name]['conf'] for p in paths]
    if not (rc == 1 and len(verdict['demo']) == 6 and got == want and certify_b1 >= 1
            and np.allclose(got_conf, want_conf, atol=1e-4)):
        raise AssertionError(f'certify_pretrained: rc {rc}, predictions {got} '
                             f'(bundle.read {want}), B1 launches {certify_b1}')
    print(f'11c certify_pretrained on cuda: exit {rc}, 6 predictions equal to bundle.read '
          f'({got[:2]} ...), B1 launches {certify_b1}')
    del bundle
    torch.save(abinet_sd, tmp / 'abinet-smoke.pt')
    letters = np.array(list(string.ascii_lowercase))
    lm_words = [''.join(rng.choice(letters, rng.integers(3, 11))) for _ in range(LM_WORDS)]
    write_lmdb(tmp / 'lm' / 'test' / 'IIIT5k', lm_words)
    lm = {}
    for device in ('cuda', 'cpu'):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            lm[device] = abinet_lm_acc.main([str(tmp / 'abinet-smoke.pt'), '--data_root',
                                             str(tmp / 'lm'), '--splits', 'test/IIIT5k',
                                             '--device', device])
        lm[device] = (*lm[device], buf.getvalue().strip().splitlines()[-1])
    # what the count sums, compared: the language model's probabilities
    # on both devices (random weights read few words right)
    probs = [np.concatenate([pr for _, pr in abinet_lm_acc.batch_probs(load_from_checkpoint(
        str(tmp / 'abinet-smoke.pt'), dtype=torch.float32, device=device), lm_words)])
        for device in ('cuda', 'cpu')]
    lm_err = float(np.abs(probs[0] - probs[1]).max() / probs[1].max())
    if lm['cuda'][:2] != lm['cpu'][:2] or lm['cuda'][1] != LM_WORDS or lm_err > LM_LIMIT:
        raise AssertionError(f'abinet_lm_acc: cuda {lm["cuda"]}, cpu {lm["cpu"]}; the '
                             f'language model\'s probabilities {lm_err:.3e} of the largest '
                             f'apart (limit {LM_LIMIT})')
    print(f'11c abinet_lm_acc on {LM_WORDS} words: cuda "{lm["cuda"][2]}", cpu '
          f'"{lm["cpu"][2]}"; the language model\'s probabilities on cuda and on the CPU '
          f'{lm_err:.3e} of the largest ({float(probs[1].max()):.4f}) apart at most (limit '
          f'{LM_LIMIT}); '
          f'{time.perf_counter() - t0:.1f} s')
    return certify_b1


def _rate(fn, n):
    """(result, seconds per item) of one call of `fn` over `n` items."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) / n


def native_phase(data_root):
    """12a. The native host helpers against their plain versions on the
    card's host: every LMDB lookup of phase 8's synthetic benchmark sets
    (native reader vs the Python reader), NATIVE_JPEGS seeded words
    rendered as JPEGs (native decode+resize vs PIL's, bit-equal; the
    full-resolution decode vs PIL's convert('RGB') on NATIVE_FULL_DECODES
    of them), NATIVE_PAIRS seeded string pairs (editdist batch vs the
    Python DP), each with its time per item. A helper that did not build
    (no toolchain) is reported as such. Returns the rates."""
    from PIL import Image, features

    from parseq_tpu_torch.data import native
    from parseq_tpu_torch.data.lmdb import LmdbReader
    from parseq_tpu_torch.data.transforms import preprocess_pil_u8
    from parseq_tpu_torch.utils import metrics, native_build

    for load in (native.load, native.load_jpeg, metrics.load):
        load()
    print(f'native helpers: {json.dumps(native_build.status())}')
    print(f'libjpeg: Pillow\'s {features.version("jpg")} (libjpeg-turbo '
          f'{features.version("libjpeg_turbo")}); the native build\'s (JPEG_LIB_VERSION, '
          f'LIBJPEG_TURBO_VERSION) {native.jpeg_lib_version() or "not built"}')
    info = {}
    dbs = sorted((data_root / 'test').iterdir())
    keys = {db: [k for i in range(1, EVAL_SETS[db.name] + 1)
                 for k in (f'image-{i:09d}'.encode(), f'label-{i:09d}'.encode())] for db in dbs}
    n_keys = sum(len(v) for v in keys.values())

    def lookups(reader_cls):
        out = []
        for db in dbs:
            with reader_cls(db) as r:
                out.extend(r.get(k) for k in keys[db])
        return out

    values, py_s = _rate(lambda: lookups(LmdbReader), n_keys)
    if native.load() is None:
        print(f'LMDB lookups: native reader not built; Python reader {py_s * 1e6:.3f} us each')
    else:
        got, nat_s = _rate(lambda: lookups(native.NativeLmdbReader), n_keys)
        if got != values:
            raise AssertionError('the native LMDB reader disagrees with the Python reader')
        info['lmdb_us'] = {'native': nat_s * 1e6, 'python': py_s * 1e6}
        print(f'LMDB lookups ({n_keys} keys of {len(dbs)} databases, values equal): native '
              f'{nat_s * 1e6:.3f} us, Python {py_s * 1e6:.3f} us each ({py_s / nat_s:.2f}x)')

    rng = np.random.default_rng(SEED + 12)
    letters = np.array(list(string.digits + string.ascii_lowercase))
    images = [render_word(''.join(rng.choice(letters, rng.integers(3, 11))), 'JPEG')
              for _ in range(NATIVE_JPEGS)]
    pil, pil_s = _rate(lambda: [preprocess_pil_u8(Image.open(io.BytesIO(v))) for v in images],
                       len(images))
    if native.load_jpeg() is None:
        print(f'JPEG decode+resize: native decoder not built; PIL {pil_s * 1e6:.2f} us each')
    else:
        got, nat_s = _rate(lambda: [native.jpeg_decode_resize(v) for v in images], len(images))
        if not all(g is not None and np.array_equal(g, w) for g, w in zip(got, pil)):
            raise AssertionError('the native JPEG decode+resize differs from PIL\'s pixels')
        full = images[:NATIVE_FULL_DECODES]
        want, pil_full_s = _rate(lambda: [np.asarray(Image.open(io.BytesIO(v)).convert('RGB'))
                                          for v in full], len(full))
        got, nat_full_s = _rate(lambda: [native.jpeg_decode(v) for v in full], len(full))
        if not all(g is not None and np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError('the native full-resolution JPEG decode differs from PIL\'s')
        info['jpeg_us'] = {'native': nat_s * 1e6, 'pil': pil_s * 1e6,
                           'full_native': nat_full_s * 1e6, 'full_pil': pil_full_s * 1e6}
        print(f'JPEG decode+resize to 32x128 ({len(images)} images, pixels equal): native '
              f'{nat_s * 1e6:.2f} us, PIL {pil_s * 1e6:.2f} us each ({pil_s / nat_s:.2f}x); '
              f'full-resolution decode ({len(full)}, equal): native {nat_full_s * 1e6:.2f} us, '
              f'PIL {pil_full_s * 1e6:.2f} us each ({pil_full_s / nat_full_s:.2f}x)')

    words = [''.join(rng.choice(letters, rng.integers(0, 26))) for _ in range(2 * NATIVE_PAIRS)]
    preds, gts = words[:NATIVE_PAIRS], words[NATIVE_PAIRS:]
    want, dp_s = _rate(lambda: [metrics.edit_distance(a, b) for a, b in zip(preds, gts)],
                       NATIVE_PAIRS)
    if metrics.load() is None:
        print(f'edit distance: native batch core not built; Python DP {dp_s * 1e6:.2f} us a pair')
    else:
        got, nat_s = _rate(lambda: metrics.edit_distance_batch(preds, gts), NATIVE_PAIRS)
        if got.tolist() != want:
            raise AssertionError('the native edit distance differs from the Python DP')
        info['editdist_us'] = {'native': nat_s * 1e6, 'python': dp_s * 1e6}
        print(f'edit distance ({NATIVE_PAIRS} pairs of 0-25 characters, equal): native batch '
              f'{nat_s * 1e6:.3f} us, Python DP {dp_s * 1e6:.2f} us a pair ({dp_s / nat_s:.1f}x)')
    return info


def int8_phase(card, parseq_sd):
    """12b-e on cuda: a JAX package checkpoint of `parseq_sd` (phase 4's
    PARSeq-S weights as phase 10 leaves them), written by
    experiments/torch_jax_ckpt.py, read like the .pt of the same weights;
    int8 PARSeq-S and ViTSTR (ops/quant.py's card check, its two planted
    faults, the int8 product count a forward, B1 and B2 in the reads);
    int8_linear on cuda against the CPU; the encoder times; cli.bench
    --int8. Returns B1's and B2's launches."""
    from experiments.torch_encoder_kernel_bench import cuda_median_ms
    from experiments.torch_jax_ckpt import save_parseq_as_jax
    from parseq_tpu_torch import hub
    from parseq_tpu_torch.cli import bench as bench_cli
    from parseq_tpu_torch.ops import ar_kernel, quant
    from parseq_tpu_torch.utils.config import compose
    from parseq_tpu_torch.utils.registry import load_from_checkpoint

    info = {'b1': 0, 'b2': 0}
    rng = np.random.default_rng(SEED + 13)
    tmp = Path(tempfile.mkdtemp(prefix='smoke-jaxckpt-',
                                dir=Path(__file__).resolve().parent / 'build'))
    try:
        torch.save(parseq_sd, tmp / 'parseq-smoke.pt')
        save_parseq_as_jax(tmp / 'parseq-smoke-jax.ckpt', parseq_sd, compose('parseq')['model'])
        pt = load_from_checkpoint(str(tmp / 'parseq-smoke.pt'), device='cuda')
        jx = load_from_checkpoint(str(tmp / 'parseq-smoke-jax.ckpt'), device='cuda')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    jx_sd = jx.module.state_dict()
    if any(not torch.equal(v, jx_sd[k]) for k, v in pt.module.state_dict().items()):
        raise AssertionError('the JAX checkpoint loads other weights than the .pt of the same')
    x = rng.uniform(-1, 1, (7, *pt.img_size, 3)).astype(np.float32)
    ar_kernel.launches = 0
    reads = pt.read(x), jx.read(x)
    if ar_kernel.launches != 2 or reads[0] != reads[1]:
        raise AssertionError(f'JAX checkpoint reads {reads[1]} vs .pt reads {reads[0]}, '
                             f'B1 launches {ar_kernel.launches} (2 expected)')
    info['b1'] += ar_kernel.launches
    print(f'JAX package checkpoint (experiments/torch_jax_ckpt.py) of PARSeq-S on cuda: weights '
          f'equal to the .pt\'s, B=7 reads and confidences equal {reads[1][0][:3]}; B1 launches '
          f'{ar_kernel.launches}')
    del pt, jx

    for name in ('parseq', 'vitstr'):
        int8_model_check(name, card, rng, info)

    for M, K, N in INT8_LINEAR_SHAPES:
        g = torch.Generator().manual_seed(SEED + M)
        w = torch.randn(N, K, generator=g) * torch.exp(
            torch.empty(N, 1).uniform_(-2, 2, generator=g))
        lin = quant.quantize_linear(torch.nn.Linear(K, N))
        lin.w_q, lin.w_scale = quant.quantize_weight(w)
        lin.bias = torch.randn(N, generator=g)
        x = torch.randn(M, K, generator=g) * torch.exp(
            torch.empty(M, 1).uniform_(-3, 3, generator=g))
        want_codes = quant.quantize_activations(x)
        want_acc = quant.int8_accumulate(want_codes[0], lin.w_q)
        want = quant.int8_linear(x, lin.weight, lin.bias)
        lin_c, x_c = copy.deepcopy(lin).cuda(), x.cuda()
        codes = quant.quantize_activations(x_c)
        acc = quant.int8_accumulate(codes[0], lin_c.w_q)
        got = quant.int8_linear(x_c, lin_c.weight, lin_c.bias).cpu()
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        err = float((got - want).abs().max() / want.abs().max())
        equal = {'weight codes': torch.equal(lin_c.w_q.cpu(), lin.w_q),
                 'activation codes': torch.equal(codes[0].cpu(), want_codes[0]),
                 'activation scales': torch.equal(codes[1].cpu(), want_codes[1]),
                 'int32 sums': torch.equal(acc.cpu(), want_acc)}
        w_cuda = quant.quantize_weight(w.cuda())
        equal['weights quantized on cuda'] = (torch.equal(w_cuda[0].cpu(), lin.w_q)
                                              and torch.equal(w_cuda[1].cpu(), lin.w_scale))
        if not (all(equal.values()) and err <= 1e-6):
            raise AssertionError(f'int8_linear ({M}, {K}) x ({K}, {N}) on cuda vs the CPU: '
                                 f'equal {equal}, outputs within 1e-6 of max|out|: {err:.3e}')
        print(f'int8_linear ({M}, {K}) x ({K}, {N}) cuda vs CPU: weight codes and scales '
              f'(also quantized on cuda), activation codes and scales, int32 sums equal; max '
              f'|difference| {err:.3e} of max|out| (largest elementwise relative {rel:.3e})')
    # the weight layout _int_mm takes: (N, K) row-major passed transposed, vs (K, N) row-major
    M, K, N = TIMED_BATCH * 128, 384, 1152
    xq = torch.randint(-127, 128, (M, K), dtype=torch.int8, device='cuda')
    wq = torch.randint(-127, 128, (N, K), dtype=torch.int8, device='cuda')
    wkn = wq.t().contiguous()
    xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
    layout_ms = {}
    for layout, fn in (('(N,K) row-major as .t()', lambda: torch._int_mm(xq, wq.t())),
                       ('(K,N) row-major', lambda: torch._int_mm(xq, wkn)),
                       ('bf16 x @ w.t()', lambda: xb @ wb.t())):
        try:
            layout_ms[layout] = cuda_median_ms(fn)
        except RuntimeError as e:  # a layout _int_mm refuses is a finding, not a failure
            layout_ms[layout] = f'raises: {str(e).splitlines()[0]}'
    if not isinstance(layout_ms['(N,K) row-major as .t()'], float):
        raise AssertionError(f'_int_mm refuses the stored weight layout: {layout_ms}')
    info['int_mm_layout_ms'] = layout_ms
    print(f'_int_mm ({M}, {K}) x ({K}, {N}) [{card}]: ' + ', '.join(
        f'{k} {v if isinstance(v, str) else f"{v:.4f} ms"}' for k, v in layout_ms.items()))

    for B in (1, TIMED_BATCH):
        ar_kernel.launches = 0
        (r,) = bench_cli.main(['--model', 'parseq', '--batch_size', str(B), '--int8'])
        macs = bench_cli.per_image_flops(hub.parseq(seed=SEED), torch.rand(
            1, 32, 128, 3, device='cuda'))
        if ar_kernel.launches < 1 or r['flops_per_img_G'] != round(macs / 1e9, 3):
            raise AssertionError(f'cli.bench --int8 B={B}: {r}, B1 launches {ar_kernel.launches}, '
                                 f'bf16 MACs {macs / 1e9:.4f} G')
        info['b1'] += ar_kernel.launches
        info[f'bench_int8_b{B}'] = r
        print(f'cli.bench --int8 B={B}: MACs equal the bf16 model\'s; B1 launches '
              f'{ar_kernel.launches}')
    return info


def int8_model_check(name, card, rng, info):
    """12c for one family (parseq or vitstr), random weights of `hub`'s seed
    SEED with rows spread: the int8 model against bf16 (quant.check_errors
    on the encoder-only logits, quant.check_reads on a read's), its two
    planted faults, its int8 products and kernel launches a read, and the
    encoder times at B = TIMED_BATCH. Adds to `info`."""
    from experiments.torch_encoder_kernel_bench import cuda_median_ms
    from parseq_tpu_torch import hub
    from parseq_tpu_torch.models.vit import VisionTransformer
    from parseq_tpu_torch.ops import ar_kernel, attention, quant

    bundle = getattr(hub, name)(seed=SEED)
    module = bundle.module
    depth = len((module.encoder if name == 'parseq' else module).blocks)
    quant.spread_rows(module, SEED)
    images = torch.from_numpy(rng.uniform(-1, 1, (INT8_IMAGES, *bundle.img_size, 3)).astype(
        np.float32)).cuda()
    ref = quant.check_logits(module, images, torch.bfloat16)
    qb = quant.quantize_bundle(bundle)
    with quant.count_int_mm() as count:
        got = quant.check_logits(qb.module, images, torch.bfloat16)
    limit = quant.CHECK_LIMITS[name]
    rel, n_conf, agree, passes = quant.check_errors(got, ref, limit)
    if not passes or n_conf == 0 or count.calls != 4 * depth:
        raise AssertionError(f'int8 {name}: relative error {rel:.4e} (limit {limit}), '
                             f'greedy picks equal at the {n_conf} positions whose margin '
                             f'exceeds it: {agree}; '
                             f'int8 products a forward {count.calls} (4 x {depth} expected)')
    faulty = quant.planted_fault(module, name, 'input_channel_scales')
    rel_f, *_, passes_f = quant.check_errors(
        quant.check_logits(faulty, images, torch.bfloat16), ref, limit)
    partial = quant.planted_fault(module, name, 'fc2_unquantized')
    with quant.count_int_mm() as partial_count:
        quant.check_logits(partial, images, torch.bfloat16)
    if passes_f or partial_count.calls == 4 * depth:
        raise AssertionError(f'int8 {name}: a planted fault passes: per-input-channel codes '
                             f'{rel_f:.4e} (passes {passes_f}); last fc2 unquantized: '
                             f'{partial_count.calls} int8 products')
    del faulty, partial
    ar_kernel.launches = attention.launches = 0
    x = images.cpu().numpy()
    with quant.count_int_mm() as count:
        labels, confs = qb.read(x)
    launches = {'B1': ar_kernel.launches, 'B2': attention.launches}
    want = {'B1': 1, 'B2': 0} if name == 'parseq' else {'B1': 0, 'B2': depth}
    charset = set(bundle.tokenizer.charset)
    if launches != want or count.calls != 4 * depth or not all(
            set(t) <= charset and 0.0 < c <= 1.0 for t, c in zip(labels, confs)):
        raise AssertionError(f'int8 {name} read: launches {launches} ({want} expected), '
                             f'int8 products {count.calls}, {labels} {confs}')
    info['b1'] += launches['B1']
    info['b2'] += launches['B2']
    bf16_labels = bundle.read(x)[0]
    read_conf, read_agree, decided = quant.check_reads(qb(x), bundle(x),
                                                       bundle.tokenizer.eos_id)
    wrong = [(a, b) for a, b, d in zip(labels, bf16_labels, decided.tolist())
             if d and a != b]
    if not read_agree or read_conf == 0 or wrong:
        raise AssertionError(f'int8 {name} reads vs bf16: picks equal at the {read_conf} '
                             f'positions whose margin exceeds their image\'s error: '
                             f'{read_agree}; decided reads that '
                             f'differ: {wrong}')
    xt = torch.from_numpy(rng.uniform(-1, 1, (TIMED_BATCH, *bundle.img_size, 3)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    with torch.inference_mode():
        enc = (lambda m: m.encode(xt)) if name == 'parseq' else (
            lambda m: VisionTransformer.forward(m, xt))
        enc_ms = {k: cuda_median_ms(lambda: enc(m)) for k, m in
                  (('bf16', module), ('int8', qb.module))}
    info[name] = {'rel_err': rel, 'fault_rel_err': rel_f, 'int_mm_a_forward': count.calls,
                  'encoder_ms_b256': enc_ms, 'read_positions_decided': read_conf,
                  'reads_decided': int(decided.sum()), 'reads_equal_bf16': sum(
                      a == b for a, b in zip(labels, bf16_labels)),
                  'distinct_reads': len(set(bf16_labels))}
    print(f'int8 {name} on cuda (rows spread by <= {quant.CHECK_SPREAD}x): '
          f'{"NAR " if name == "parseq" else ""}logits vs bf16 '
          f'{rel:.4e} of max|bf16| (limit {limit}), greedy picks equal at the {n_conf} '
          f'of {ref.shape[0] * ref.shape[1]} positions whose margin exceeds it; planted '
          f'faults fail (per-input-channel codes {rel_f:.4e}; the last fc2 unquantized: '
          f'{partial_count.calls} int8 products, not {4 * depth}); read of {len(labels)} '
          f'images: {launches}, {count.calls} int8 products, {labels[:3]} '
          f'({info[name]["distinct_reads"]} distinct bf16 reads); its logits: picks equal at '
          f'the {read_conf} positions whose margin exceeds their image\'s error, '
          f'{info[name]["reads_decided"]} reads decided through EOS and equal to bf16\'s, '
          f'{info[name]["reads_equal_bf16"]} of {len(labels)} equal in all; encoder '
          f'B={TIMED_BATCH} [{card}]: bf16 {enc_ms["bf16"]:.4f} ms, int8 '
          f'{enc_ms["int8"]:.4f} ms')
    del bundle, qb, module


if __name__ == '__main__':
    sys.exit(main())
