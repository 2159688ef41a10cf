#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py      # from the root of a checkout, on a machine with a CUDA card

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port from the package's
   ``csrc/`` (one nvcc per source, all started together).
3. Holds each kernel against its plain PyTorch version at the serving
   and training paths' shapes, with the tolerances stated below, and times the kernel,
   the plain version and one PyTorch library call with CUDA events.
4. Exports a synthetic artifact directory at the full width of the
   reference model (two 2-layer bidirectional GRU towers, H=256, bf16
   compute, a 400,000 x 100 word table, 70,000 passages) through the port's
   doc tower, and checks the embeddings against the plain version on the
   CPU.
5. Serves ``/search`` over HTTP through the port's server (the entry point
   behind ``ttr-torch-serve``), checks the responses' contract and their
   results against the port's engine on the CPU (plain PyTorch), and checks
   that the serving kernels, and not the backward, were launched while
   serving.
6. Trains the reference model at full width (the same towers, dropout
   0.2, B=64, doc-length buckets 32/64/128, the frozen 400,000 x 100
   table written to disk and read back) for one epoch of 2,112 in-memory
   triplets through the port's training driver (the function behind
   ``ttr-torch-train`` after its parquet reading), and checks: the first
   step on the card against the CPU (plain versions) within a stated
   envelope, a finite loss at every step, exactly 4 backward launches and 2
   clip-and-Adam launches per step, a bit-exact checkpoint round trip on the card, and that the
   exported directory serves. Prints the steady steps/s and examples/s.
   Then the same configuration at HIDDEN_DIM 150, a width off the kernels'
   multiples: its first step against the CPU and an export of a small
   corpus searched on the card, all through the recurrent kernels.

7. Trains the transformer tower of config 5 (``configs/transformer_tp.json``:
   6 blocks, H=256, 8 heads of width 32, FFN 1024, dropout 0.1, the in_batch
   loss at B=512, a trainable table) at full width with the fused attention
   kernels for one epoch of 8,192 triplets, holds its first step against
   the CPU and against the torch attention route, checks 12 attention
   backward launches per step and the checkpoint, and serves its export
   over HTTP (6 attention forward and 1 segmax launches per dense search).
   Before the epoch, the same tower at COMPUTE_DTYPE float32 (the split
   route of the attention kernels: six products of three bf16 pieces): its
   first step against the CPU on 64 rows and, at B=512, against the torch
   attention route, 12 forward and 12 backward launches on the split route.
8. Trains data parallel (``phase_data_parallel``): ``configs/msmarco_inbatch.json``
   at full width (the reference towers, the in_batch loss over
   cross-device negatives, TRIPLET_METRICS false, B=1024) as two ranks of
   512 rows, each a process started from this script (``--dp-rank``), both
   on the one card: NCCL refuses two ranks on one device, so the pair runs
   over gloo with CUDA tensors on cuda:0, and every collective's bytes
   cross the host. The first step at dropout 0 is held against one
   process's over the same 1,024 rows on the card: the loss within 1e-5
   relative, each gradient leaf's difference within 2e-2 of its norm (the
   first-step check's envelope). After 8 steps at dropout 0.2 both ranks'
   parameters and Adam moments are held bit for bit equal (a checksum of
   every leaf, gathered), both ranks must have launched 4 ``rnn_bwd`` a
   step and ``rnn_fwd``, and neither may have called a plain version. The
   pair's steps/s and examples/s are printed beside one process's at
   B=1024, with each step's gradient all-reduce time: two processes share
   one card, so they show correctness, not scaling. Then
   ``ttr-torch-train`` runs as torchrun starts a one-rank world (RANK 0,
   WORLD_SIZE 1, NCCL on the card, MESH_DATA -1, so the single-device
   path) for one epoch over parquet splits of the corpus. The ranks and the
   run write their logs to files, are waited on for at most 300 s and
   killed when one fails.
9. Trains on the model axis (``phase_model_axis``): config 5 as written
   (``configs/transformer_tp.json``: MESH_MODEL 2 and SHARD_EMBEDDING_TABLE
   true, so a 1x2 mesh; heads, FFN columns and each tower's 400,000 x 100
   table split in two) with FUSED_ATTENTION true, as two ranks on the one
   card over gloo (``--tp-rank``, as the data-parallel pair). The first
   step at dropout 0 over 512 rows, gradients gathered whole, is held
   against one process holding the whole model: the loss within 1e-3
   relative, each leaf within 2e-2 of its norm. Then 4 steps at dropout
   0.1 through the training driver (``train_on_datasets``, evaluation and
   export included), each step timed with its model-group all-reduces
   (count, bytes, ms) and its launches: 12 ``attention_fwd`` and 12
   ``attention_bwd`` a rank, at R = 512 x 4 local heads, and no
   plain-version call. Both ranks' replicated leaves must be bit for bit
   equal, each rank's shards its slice of the gathered tree; the pair's
   ``model.npz`` must equal the gathered params, and one dense search over
   it by the single-device engine launches 6 ``attention_fwd`` and 1
   ``segmax``. Last, the GRU towers (``configs/msmarco_inbatch.json``,
   B=1024) over a sharded, trained table: the first step against one
   process's, ``rnn_fwd`` and ``rnn_bwd`` 4 each in each rank.

10. Searches a corpus split over shards (``phase_sharded_serve``), D = 2
   and 4 shards of the one card (a device list that repeats cuda:0):
   BASELINE config 4's 1,048,576 x 256 rows in f32, bf16 and int8 through
   ``RetrievalIndex(mesh=...)`` and per-row int8 through
   ``distributed_topk_int8``, at B=1 and 16, each against one device's
   search over the same rows (ids equal, s8 scores bit for bit, the others
   within 1e-5 relative) with one scan launch a shard and nothing else;
   ``segmax`` (bf16 rows, and f32 rows at B=16 and 1: its f32 route of
   three bf16 pieces a value), ``segmax_s8`` and ``topk_stream_int8`` at each shard's shape
   against their plain versions; the search's times at D = 1, 2, 4 split
   into the scans, phase 2 and the merge; shards holding only padding; the
   IVF index of step 3 over two shards against ``ivf_search``; and the
   export served over two shards in bf16 and int8, each ``/search`` the
   single-device engine's ranked docs.
11. Runs the rest of the JAX package's paths: the C++ batch tokenizer
   (``native/``) must build with g++ here, and its ids and lengths over
   the 70,000 passages and the JAX package's unicode rows equal the Python
   path's (both timed); ``SimpleHybridRetriever`` fits the export of step 4
   over every passage on the card (an f32 index: ``segmax``'s f32 route,
   then phase 2 at k = N), its five searches launch one ``segmax``
   each, its dense k = N search is held against ``topk_oracle`` and the
   kernel at the index's shape against its plain version; card and CPU
   fits of 1,024 passages give the same top-10 within EMBED_ATOL; and
   ``tools/e2e_demo.py --scale smoke`` runs as a child process (training,
   the recall assertion, the inflation, ``ttr-torch-serve --storage-dtype
   int8`` and the load test), its E2E_DEMO_RESULT line read with the
   launches of each of its stages.

Step 3 holds the forward kernel at four shapes (the query encode, the
export, the training query and doc towers), each timed beside cuDNN's GRU,
its layout, route and waves logged and two calls held bit-identical, the
large batches timed (B=1024: the in-batch query tower, both towers'
backward, and GRU H=1024 T=128, a wide layer's export; the in-batch
query tower's large-batch layout must give the cluster route's bits),
and both recurrent
kernels at the training shapes with the history in f32 (TTMR_RNN_HISTORY=f32,
whose first train step step 6 also holds card against CPU). Step 3 covers the
backward kernel too (``csrc/rnn_bwd.cu``, both modes, each timed at the
training shapes beside cuDNN's GRU backward, and at H=1024, where it keeps
one dhp row block, with the layout it launches logged and two calls held
bit-identical), the widths the JAX package keeps on its Pallas kernels that
need clusters of 16 (GRU H=1792 and LSTM H=1536 backward, RNN H=3072 both
passes, at B=16: each with its cluster size, the card's count of such
clusters and cuDNN's time beside it), and the
int8 and running top-k kernels (``csrc/segmax_s8.cu``, the per-row int8
path of ``csrc/segmax.cu``, ``csrc/topk_stream.cu``) over 1,048,576 rows,
each driven once through its public function with the counts at 0; the
five scans on the tensor cores (``segmax``, ``segmax_int8``, ``segmax_s8``,
``topk_stream``, ``topk_stream_int8``) also at B=1 and B=32 over the same
1,048,576 rows and at B=16 over the served 73,728 rows, each with its
layout logged (``ops/topk.py`` scan_plan, s8_plan), two calls held
bit-identical and timed beside its library call (``segmax_s8`` also with
its score cache, against that variant's own bound); ``segmax`` and
``topk_stream`` over the f32 copy of the 1,048,576 rows at B=1, 16 and 32
(the f32 route: each value split into three bf16 pieces, six products on
the tensor cores) alike; an int8 index at
H=1536, past the 1040 columns below which the integer scores stay under
2^24, searched through ``segmax_s8`` bit for bit as the plain versions; and
the fused attention kernels (``csrc/attention.cu``) at the transformer's
training and serving shapes and at T=512 (hd=32 and 64), each with its
tiles logged, two calls held bit-identical and timed beside
``torch.nn.functional.scaled_dot_product_attention`` as a yardstick, and
at f32 compute (the split route) at the same training and serving shapes,
at hd=64 T=512 and with bf16 inputs, each beside SDPA on the same inputs
(TF32 off), the bf16 route at its shape and its bound; and the clip and
Adam (``csrc/adam.cu``, ``check_adam``) at the GRU towers' trainable leaves
(``configs/msmarco_inbatch.json``, the table frozen) and config 5's (both
400,000 x 100 tables trainable), 3 updates through the kernel against 3
through the plain loop on the card from the same state and gradients:
every bit of the params and moments equal below the clip, within
ADAM_RTOL / ADAM_ATOL above it, 2 launches an update, timed beside the
loop against its bytes bound. Step 5
serves a second time as ``ttr-torch-serve --storage-dtype int8`` starts
it: the s8 scan kernel on every dense search, the results against the
port's int8 engine on the CPU and, bit for bit, against the two-phase path
on the card; then a boot with ``--autotune-retrieval`` persists its choice
and a second boot applies it without timing.

Step 3 also holds the repair of the bf16 and f32 scans' widths: 32 query
rows at the widest tower widths the port trains (bf16 H=3360: ``segmax``,
``segmax_int8`` and the running top-k at k=50 over bf16 and per-row int8
rows; f32 H=3200: ``segmax`` and the running top-k) over 262,144 rows, each
in one launch whose query fragments ride the ring (``ops/topk.py``
scan_plan), against its plain version, three queries bit for bit their own
one-row launches (at bf16 and int8 the resident route), and past the widest
width a launch takes a ``ValueError`` before any launch;
and one engine search of 32 coalesced queries over an index of width 3360
(a one-layer RNN tower, 73,728 rows). The IVF index (``ops/ivf.py``, plain
PyTorch on the card) is built over 1,048,576 x 256 clustered rows in bf16
and int8 (timed), its nprobe picked at recall@50 >= 0.99 (int8: its
quantization's floor), searched at B=1 and 16 beside the exact
``fused_topk_segmax`` and, fully probed, held against the exact top-50.
After step 5, ``ttr-torch-build-index --target-recall 0.99`` indexes the
export and ``ttr-torch-serve --index-type ivf`` answers the five requests
(their dense top-50 against the exact engine's). Last, after every timed
phase (a profiling session slows every later launch from the host), three
traces through the entry points' switches: GRU training with
``profile_dir`` (a window that fills), config 5 over 24 steps (the run ends
inside its window: the finalize path) and the server with ``profile_dir``
and ``profile_requests`` 5; each trace must hold its kernels' device
events, and the ten device operations with the most time, the device's
busy share of the window and the three longest idle gaps are printed.

The second-last line is the ``kernels`` record (JSON), the last line
``{"ok": true, "device": {...}}``. A failed check exits non-zero and prints
neither, as does a run without a CUDA device or outside a checkout of the
repository.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARTIFACTS = ROOT / "_smoke_artifacts"  # listed in .gitignore; removed at the end

# Published peaks of one H100 SXM: HBM3 bandwidth, the dense bf16 and int8
# tensor-core rates. The scans over an f32 corpus take an f32-precision
# product as six bf16 products on the tensor cores: a sixth of the bf16
# rate. Attention at f32 compute counts its split products by operand
# (attention_bound) and takes the bf16 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_SPLIT_FLOPS = PEAK_BF16_FLOPS / 6

# The reference model (configs/msmarco_reference.json, Config defaults).
H = 256
QUERY_LEN, DOC_LEN = 32, 128
SERVE_ROWS = 16  # the engine encodes micro-batches of >= 16 rows
TRAIN_ROWS = 64  # BATCH_SIZE: the query tower's rows; the doc tower runs pos ++ neg
EXPORT_ROWS = 1024  # TextEncoder's corpus batch
FANOUT = 50
VOCAB, EMBED = 400_000, 100  # the shape of GloVe 6B 100d
PASSAGES = 70_000  # not a multiple of the 8192-row index tile: padding is live
SCAN_ROWS = 1 << 20  # 1,048,576 x 256 bf16 = 512 MiB for the scan alone
SCAN_VALID = SCAN_ROWS - 3001
SCAN_BATCHES = (1, 32)  # the scans' other batch sizes: /search may carry one query

# Tolerances, kernel against plain version on the same inputs.
# rnn_fwd, bf16 compute: both round h to bf16 before each step's product and
# sum the 256 products in f32, in another order. A last-bit difference in a
# sum can move a value across a bf16 rounding boundary, changing the next
# step's operand by one bf16 ulp (<= 2^-8 for |h| < 1), and the contracting
# recurrence carries it on. A CPU run of the plain version against itself
# with float64 products found 1.5e-4 in h_final and one bf16 ulp (3.9e-3) in
# the bf16 history at B=256, T=128.
RNN_FINAL_ATOL = 2e-3
RNN_HIST_ATOL = 1e-2
# segmax: f32 sums of 256 products of unit-norm rows in two orders differ
# by at most about 2 * 256 * 2^-24 < 3e-5.
SEGMAX_ATOL = 3e-5
# Embeddings and /search scores, card against CPU: the rnn differences
# above pass through the projection and the L2 normalization.
EMBED_ATOL = 2e-2
# The per-row int8 scan (segmax_int8) and the running top-k over int8 rows:
# exact products (int8 times bf16) summed in f32 in two orders, then times
# the row scale. sum |q_i v_i| * scale is at most about |q| |d| = 1 for
# unit rows, so the sums differ by at most about 2 * 256 * 2^-24 < 4e-5.
INT8_ATOL = 4e-5
# int8 /search, card against the CPU engine: the query embeddings differ by
# up to EMBED_ATOL, which moves a dense score as in bf16, and may flip the
# int8 rounding of query elements; each flip moves a score by one
# quantization step, q_scale * |d_i| <= max|q| * max|d| / 127, in either
# direction. The tolerance allows EMBED_ATOL once more for the flips.
INT8_SERVE_TOL = 2 * EMBED_ATOL
S8_SEGS = (128, 64)  # the index's segment width, and a narrower one
# rnn_bwd, bf16 compute and bf16 history: a CPU run of the plain version
# against itself with float64 products (GRU D=2 B=128 T=128 H=256, and
# LSTM/RNN at B=16 T=32) differed by at most 6.3e-4 of the dxp scale
# (max |dxp|) and by 2.4e-4 norm-relative in dW and db. The kernel sums in
# yet another order, so the bounds are about 10x that: one bf16 ulp of the
# scale on dxp, 2e-3 norm-relative on dW and db.
BWD_DXP_REL = 2 ** -7
BWD_W_REL = 2e-3
# Both recurrent kernels at f32 compute (COMPUTE_DTYPE float32): f32-precision
# products, on the card as split bf16 products (csrc/recur_chain.cuh: within
# 2^-23 (1 + 2^-7) sum |a_k b_k| of the exact product, an f32 sum's own
# rounding), summed in another order than the plain version's f32 products;
# tests/test_torch_cuda.py's f32 tolerances: atol 1e-4 on the forward's
# history and h_final over up to 128 steps; dxp within 1e-4 + 1e-4 |plain|,
# dW and db within 1e-3 + 1e-4 |plain| (sums over T*B outer products).
RNN_F32_ATOL = 1e-4
BWD_F32_RTOL, BWD_F32_DXP_ATOL, BWD_F32_W_ATOL = 1e-4, 1e-4, 1e-3
# The first train step, card against CPU (plain versions), from the same
# state and batch with dropout off: the same CPU experiment on a whole
# bf16 step (H=256, B=64, doc width 64) moved the loss by 6e-7 and each
# per-leaf gradient norm by at most 1.0e-3 relative (a bias vector, whose
# norm is small). Envelope: 1e-3 on the loss, 2e-2 relative per leaf.
STEP_LOSS_ATOL = 1e-3
STEP_GRAD_REL = 2e-2
# The same at COMPUTE_DTYPE float32 (both recurrent kernels' split products):
# python3 -m twotowermlretrieval_tpu_torch.tools.f32_step_envelope ran the
# f32 step on the CPU (64 rows, doc width 128, a 20,000-row table) with
# every torch.matmul summed in float64: the loss moved by 0 and each
# per-leaf gradient norm by at most 6.7e-7 relative (a bias vector; the
# recurrent products as split products, 5.9e-7). The bf16 control against
# the f32 step moved the loss by 4.6e-5 and the worst leaf by 2.6e-3 (the
# median leaf 3.2e-4). Envelope between the two, as for config 5 at f32:
# 5e-6 on the loss, 1e-4 relative per leaf; the control runs on the card
# and must fall outside it.
GRU_F32_STEP_LOSS_ATOL = 5e-6
GRU_F32_STEP_GRAD_REL = 1e-4
# The clip and Adam kernel against the plain loop on the card (check_adam):
# ADAM_STEPS updates from one state with the same gradients, scaled to a
# global norm below the clip (1.0 in both configs) and above it. Below it
# the scale is exactly 1 and the kernel's elementwise arithmetic is the
# loop's, rounding for rounding: every bit equal. Above it the norm's sums
# run in another order, so the scale may differ in its last bit: the
# tolerances test_clip_and_adam_match_optax holds the loop to against optax.
ADAM_STEPS = 3
ADAM_NORMS = {"below_clip": 0.5, "above_clip": 5.0}
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7
# The training phase: the reference configuration at full width, on
# in-memory triplets cut from the export corpus.
TRAIN_TRIPLETS, VAL_TRIPLETS, TEST_TRIPLETS = 2112, 320, 48
TRAIN_DIR = ROOT / "_smoke_train"  # word table, checkpoints, artifacts; listed in .gitignore
# A GRU model at a width off the kernels' multiples (the model pads each
# layer once to 152, and the index pads its columns): the reference
# configuration with HIDDEN_DIM 150, its first step and an export of the
# documents of ODD_TRIPLETS training triplets served on the card.
ODD_H = 150
ODD_TRIPLETS = 1000
WIDE_H = 1024  # a wide GRU layer: the backward keeps one dhp row block
# An int8 index past the 1040 columns below which 127 * 127 * H < 2^24 (a
# tower of HIDDEN_DIM 1536 emits such embeddings), over a few thousand rows.
WIDE_S8_H, WIDE_S8_ROWS = 1536, 6000

# Fused attention, kernel against plain version on the same inputs, as a
# share of the plain result's largest magnitude. A CPU run of the plain
# version against itself with float64 sums (hd=32; R=512 at T=128 and 32,
# R=64 at T=512) differed by at most 6.1e-4 of it at bf16 compute, where a
# last-bit change of an f32 sum can move p or ds across a bf16 rounding
# boundary. Tolerance: one bf16 ulp, 2^-8.
ATTN_REL = 2 ** -8
# f32 compute: f32-precision products (on the card, six products of three
# bf16 pieces) in another summation order. The same CPU experiment at f32
# compute differed by at most 5e-7 of the largest magnitude; the card tests
# hold 1e-5.
ATTN_F32_REL = 1e-5
# The transformer tower of config 5, as configs/transformer_tp.json gives
# it; its phase trains on the triplets after those the GRU phase takes.
TF_CONFIG = ROOT / "configs" / "transformer_tp.json"
TF_HEADS, TF_HD = 8, 32  # H=256 over 8 heads
TF_ROWS = 512  # BATCH_SIZE; TRIPLET_METRICS false, so the doc tower runs [B] rows too
TF_TRAIN, TF_VAL, TF_TEST = 8192, 512, 64
TF_CPU_ROWS = 64  # the first step's cut of the first batch, card and CPU alike
TF_DIR = TRAIN_DIR / "transformer"
# The transformer's first step, card against CPU (plain versions) on the
# same 64-row cut, dropout off: a CPU run of the same step at full width
# (64 rows, a 20,000-row table) with every product summed in float64 moved
# the loss by 8.7e-5 and each per-leaf gradient norm by at most 6.1e-4
# relative (a layer-norm shift). Envelope: 1e-3 on the loss, 2e-2 relative
# per leaf, as for the GRU towers.
TF_STEP_LOSS_ATOL = 1e-3
TF_STEP_GRAD_REL = 2e-2
# The same at COMPUTE_DTYPE float32: the CPU run of that step (64 rows, a
# 20,000-row table) with every product summed in float64 moved the loss by
# 9.5e-7 and each per-leaf gradient norm by at most 6.2e-7 relative. The
# lower-precision control, the same step at bf16 compute against it, moved
# the loss by 3.6e-5 and the worst leaf by 7.2e-3 (the median leaf 1.8e-3).
# Envelope between the two: 5e-6 on the loss, 1e-4 relative per leaf; the
# control runs on the card too and must fall outside it. The B=512 step's
# two routes at f32 compute are held to the same loss envelope.
TF_F32_STEP_LOSS_ATOL = 5e-6
TF_F32_STEP_GRAD_REL = 1e-4
# Transformer /search scores, card against CPU engine: the attention
# kernels and the plain versions differ in a sum's last bit, which can flip
# a bf16 rounding that six blocks carry on into the query embedding.
TF_SERVE_ATOL = EMBED_ATOL

# 32 query rows at the widest tower widths the port trains (RNN towers:
# H=3360 at bf16, 3200 at f32): one launch at every storage, the query
# fragments riding the ring.
WIDE_BF16_H, WIDE_F32_H = 3360, 3200
WIDE_SCAN_ROWS = 262_144  # beside the served 73,728 rows of the wide engine search
# f32 sums of about 3360 products of unit-norm rows in two orders differ by
# at most about 2 * 3360 * 2^-24 < 4.5e-4 (SEGMAX_ATOL's argument at H=3360;
# per-row int8 rows times bf16 queries alike).
WIDE_ATOL = 4.5e-4
# The IVF index over the scan phase's row count and width: a clustered
# corpus (IVF_CENTRES Gaussian centres, noise of IVF_NOISE a column, unit
# rows), built on the card with the default clusters and IVF_ITERS Lloyd
# iterations, probed at the smallest nprobe reaching IVF_RECALL recall@50.
IVF_CENTRES, IVF_NOISE, IVF_ITERS, IVF_RECALL = 1024, 0.05, 10, 0.99
# int8 blocks can miss IVF_RECALL against the f32 oracle even at a full
# probe (their per-slot quantization moves near-ties across the 50th
# place; this corpus's full probe recalls about 0.984). Their floor:
IVF_INT8_RECALL = 0.98
# Sharded search (phase_sharded_serve): the corpus split over D shards of
# the one card, each search one scan launch a shard and a merge of the
# [B, 50] lists. A CPU rehearsal of the phase (2 and 4 shards, the plain
# versions) gave the single-device index's ids and its scores to the bit;
# on the card every shard sums each score as one device does, so bf16 and
# f32 scores are held within 1e-5 relative, and s8 bit for bit.
SHARDS = (2, 4)
SHARD_REL = 1e-5
# The traced config 5 run: the window opens at the first group of
# STEPS_PER_DISPATCH (8) steps that starts at step 10 or later, so one of
# 16 steps (two groups) never opens it; 24 steps open it at step 16 and end
# inside it (the finalize path).
TF_TRACED_TRAIN = 24 * TF_ROWS
# Data parallel: configs/msmarco_inbatch.json at full width (two 2-layer
# bidirectional GRU towers, H=256, bf16, the in_batch loss over
# cross-device negatives, B=1024) over two ranks of 512 rows, both on the
# one card, over gloo (NCCL refuses two ranks on one device: "Duplicate
# GPU detected"), on triplets after those the other phases take.
DP_CONFIG = ROOT / "configs" / "msmarco_inbatch.json"
DP_RANKS, DP_STEPS = 2, 8
DP_DIR = TRAIN_DIR / "dp"
DP_TRIPLETS = slice(15_000, 15_000 + (DP_STEPS + 1) * 1024)
# The first step, two ranks against one process over the same 1024 rows
# on the card, dropout off: the same kernels on the same rows, the sums
# over the batch split in two and added by the all-reduce. The loss within
# 1e-5 relative; each gradient leaf within STEP_GRAD_REL of its norm as
# the norm of its difference (the card-vs-CPU check compares the norms
# themselves, a weaker test, at the same 2e-2).
DP_LOSS_REL = 1e-5
DP_GRAD_REL = STEP_GRAD_REL
DP_WAIT_S = 300
# ttr-torch-train as torchrun starts a world of one (NCCL on the card):
# one epoch of 8,192 triplets (one dispatch group of 8 steps a bucket
# width), 1,024 validation and 64 test triplets, written as parquet.
DP_NCCL_SPLITS = {"train": slice(25_000, 33_192), "validation": slice(33_192, 34_216),
                  "test": slice(34_216, 34_280)}
# The model axis: config 5 as written (configs/transformer_tp.json: MESH_DATA
# -1, MESH_MODEL 2, SHARD_EMBEDDING_TABLE true, so a 1x2 mesh: heads, FFN
# columns and each tower's 400,000 x 100 table split in two) plus
# FUSED_ATTENTION true, over two ranks on the one card over gloo (as the
# data-parallel pair), on the triplets the transformer phase trains on:
# TP_STEPS steps of B=512 through the training driver, 512 validation
# triplets, no test split.
TP_RANKS, TP_STEPS = 2, 4
TP_DIR = TRAIN_DIR / "tp"
# The first step, the pair against one process holding the whole model
# over the same 512 rows on the card, dropout off. The pair splits the
# out-projections' contractions in two and adds the halves in the
# all-reduce: f32 sums in another order, whose last-bit changes can flip
# the bf16 rounding of the next block's operands. A CPU rehearsal of this
# comparison (plain versions, 6 blocks of H=64, 8 heads, FFN 1024, B=64,
# a 3,000-row table) moved the loss by 4.1e-5 relative and the worst
# gradient leaf by 4.4e-3 of its norm; the card, 4.26e-6 and 4.51e-3.
# Envelope: 2e-4 relative on the loss (5x the rehearsal) and
# STEP_GRAD_REL of each leaf's norm (4.4x).
TP_LOSS_REL = 2e-4
TP_GRAD_REL = STEP_GRAD_REL
# The GRU towers with a sharded, trained table: configs/msmarco_inbatch.json
# (B=1024) with FREEZE_EMBEDDINGS false, MESH_MODEL 2 and
# SHARD_EMBEDDING_TABLE true; its first step against one process's. The
# lookup is exact and the towers are replicated, so only the order of a
# few f32 sums in the table's gradient differs: the rehearsal read 0 on
# the loss and 4.5e-7 of the worst leaf's norm, the card 0 and 8.5e-7 to
# 9.5e-7 (doc/embedding). Envelope: 1e-6 relative on the loss and 1e-5 of
# each leaf's norm; a row the lookup sends to the wrong shard moves the
# table's gradient by far more.
GRU_ROWS = 1024
TP_GRU_TRIPLETS = slice(15_000, 15_000 + 2 * GRU_ROWS)
TP_GRU_LOSS_REL, TP_GRU_GRAD_REL = 1e-6, 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` single calls, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms_device(fn, reps: int = 20) -> float:
    """The card's own time for one call: the device time of every kernel
    that ``reps`` calls ran, as torch.profiler traces them, over ``reps``.
    time_ms's single calls also count the host's time to launch (tens of
    us), during which the card waits; at small shapes that is most of it.
    A profiling run leaves the card's tracing attached, which slows
    every later launch from the host, so these run after every other
    phase (``later_on_card``, ``phase_device_times``)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            break
        # now and then a session hands back no device records (seen once
        # in about ten runs on the H100): trace the same calls again
        log(f"torch.profiler traced no device time in session {attempt + 1} of 3")
    check(us > 0, "torch.profiler traced no device time")
    return us / 1e3 / reps


_ON_CARD_LATER = []  # (record, key, fn): time_ms_device(fn) goes to record[key] at the end


def later_on_card(rec: dict, key: str, fn) -> None:
    _ON_CARD_LATER.append((rec, key, fn))


def phase_device_times() -> None:
    """The device times queued by later_on_card, once every other phase
    has run (the tensors they need stay alive until then); each record is
    logged with them."""
    for rec, key, fn in _ON_CARD_LATER:
        rec[key] = time_ms_device(fn)
    for rec in {id(r): r for r, _, _ in _ON_CARD_LATER}.values():
        log(f"on the card (torch.profiler's device time), {rec['shape']}: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in rec.items() if k.endswith("device_ms")))
    _ON_CARD_LATER.clear()


def bound(nbytes: int, flops: int, peak: float = PEAK_BF16_FLOPS):
    """Least time on the card: the larger of bytes over the memory rate and
    operations over the tensor-core rate of their type (bf16 by default).
    Returns (ms, "bytes" | "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from twotowermlretrieval_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():  # ptxas -v: each kernel's spills, then its registers
        kernel, spill = "?", ""
        for line in text.splitlines():
            if "Function properties for" in line:
                kernel = line.split("Function properties for")[1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line:
                log(f"{name}: {kernel}: {spill}; {line.split(':', 1)[-1].strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

_GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}


def _rnn_inputs(cell, B, T, seed, dev, H=H, compute="bfloat16"):
    """Per-direction xp (in the compute dtype, as the kernel reads it),
    ragged lengths with 0, 1 and T among them, W_hh and b_hh at
    torch.nn.GRU's init scale."""
    G = _GATES[cell]
    dt = getattr(torch, compute)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lim = 1.0 / math.sqrt(H)
    xps = [(torch.randn((T, B, G * H), generator=gen, device=dev) * 0.5).to(dt)
           for _ in range(2)]
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
    lengths[:3] = torch.tensor([0, 1, T], device=dev)
    mask = (torch.arange(T, device=dev)[:, None] < lengths[None, :]).float()
    w_hh = ((torch.rand((2, H, G * H), generator=gen, device=dev) * 2 - 1) * lim).to(dt)
    b_hh = (torch.rand((2, G * H), generator=gen, device=dev) * 2 - 1) * lim
    return xps, mask, w_hh, b_hh


def _cudnn_layer(cell: str, H: int, dev, dtype=torch.float16):
    """One bidirectional cuDNN layer of the cell (input width 2H, the second
    layer's), fp16 by default: cuDNN's RNN takes fp16 on every version;
    bytes and tensor-core rate are bf16's. At f32 compute the f32 layer
    (TF32 off: resolve_device turned it off) computes the kernels' function."""
    make = {"GRU": torch.nn.GRU, "LSTM": torch.nn.LSTM, "RNN": torch.nn.RNN}[cell]
    return make(2 * H, H, num_layers=1, bidirectional=True).to(dev, dtype)


def check_rnn(cell: str, B: int, T: int, seed: int, dev, timed: bool, H=H,
              compact: bool = True, compute: str = "bfloat16") -> dict:
    """The forward kernel against its plain version at bf16 compute, the
    history in bf16 (``compact``) or f32 (TTMR_RNN_HISTORY=f32), or at f32
    compute (an f32 history; the split products, RNN_F32_ATOL), timed
    there beside cuDNN's f32 layer."""
    from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
        rnn_fwd_bound,
        rnn_layer_fwd,
        rnn_layer_fwd_reference,
    )

    f32 = compute == "float32"
    args = _rnn_inputs(cell, B, T, seed, dev, H, compute)
    kw = dict(compute_dtype=compute, history_in_cdt=compact)
    outs, c_hist, fin = rnn_layer_fwd(cell, *args, **kw)
    r_outs, r_c, r_fin = rnn_layer_fwd_reference(cell, *args, **kw)
    # no atomics, a fixed summation order: a second call gives the same bits
    a_outs, a_c, a_fin = rnn_layer_fwd(cell, *args, **kw)
    bitwise = all(torch.equal(x, y) for x, y in zip((*outs, *c_hist, fin), (*a_outs, *a_c, a_fin)))
    torch.cuda.synchronize()
    err_final = (fin - r_fin).abs().max().item()
    err_hist = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, r_outs))
    # the LSTM cell state may exceed 1: one bf16 ulp relative (f32: atol)
    c_tol = (RNN_F32_ATOL, 0.0) if f32 else (RNN_HIST_ATOL, 2 ** -7)
    c_ok = all(
        ((a.float() - b.float()).abs() <= c_tol[0] + c_tol[1] * b.float().abs()).all().item()
        for a, b in zip(c_hist, r_c)
    )
    finite = bool(torch.isfinite(fin).all()) and all(bool(torch.isfinite(o.float()).all()) for o in outs)
    zero_row = bool((fin[:, 0] == 0).all()) and all(bool((o[:, 0] == 0).all()) for o in outs)
    hist = torch.bfloat16 if compact and not f32 else torch.float32
    shape = (f"{cell} D=2 B={B} T={T} H={H} " + ("f32 compute" if f32 else "bf16")
             + ("" if compact or f32 else ", f32 history"))
    check(all(o.dtype == hist for o in outs), f"rnn_fwd {shape}: history dtype {outs[0].dtype}")
    log(f"rnn_fwd {shape}: |h_final diff| {err_final:.3g}, |history diff| {err_hist:.3g}")
    check(finite, f"rnn_fwd {shape}: non-finite output")
    check(zero_row, f"rnn_fwd {shape}: a zero-length row is not exactly zero")
    check(err_final <= (RNN_F32_ATOL if f32 else RNN_FINAL_ATOL),
          f"rnn_fwd {shape}: h_final off by {err_final}")
    check(err_hist <= (RNN_F32_ATOL if f32 else RNN_HIST_ATOL),
          f"rnn_fwd {shape}: history off by {err_hist}")
    check(c_ok, f"rnn_fwd {shape}: LSTM cell history off")
    check(bitwise, f"rnn_fwd {shape}: two calls differ")
    log(f"rnn_fwd {shape}: two calls bit-identical in the history and h_final")
    rec = {"shape": shape, "max_abs_err": max(err_final, err_hist), "bitwise_repeatable": bitwise,
           "design": _fwd_design(cell, B, T, dev, H, compact, compute)}
    if timed:
        rec["ms"] = time_ms(lambda: rnn_layer_fwd(cell, *args, **kw))
        rec["plain_ms"] = time_ms(lambda: rnn_layer_fwd_reference(cell, *args, **kw),
                                  reps=5, warmup=1)
        # One cuDNN call over the same layer, which also computes the input
        # projection: fp16, or f32 with TF32 off at f32 compute
        ldt = torch.float32 if f32 else torch.float16
        layer = _cudnn_layer(cell, H, dev, ldt)
        x = torch.randn((T, B, 2 * H), device=dev, dtype=ldt)
        rec["library_ms"] = time_ms(lambda: layer(x))
        cb = 4 if f32 else 2
        nbytes, flops = rnn_fwd_bound(T, B, H, 2, _GATES[cell], cb, hist.itemsize)
        # f32 compute: each product as the six bf16 products of its split
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops,
                                                 PEAK_SPLIT_FLOPS if f32 else PEAK_BF16_FLOPS)
        rec["step_us"] = rec["ms"] / T * 1e3
        log(f"rnn_fwd {shape}: kernel {rec['ms']:.4f} ms ({rec['step_us']:.2f} us a step), "
            f"plain {rec['plain_ms']:.4f} ms, cuDNN {cell} {str(ldt)[6:]} "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return rec


def _fwd_design(cell: str, B: int, T: int, dev, H=H, compact: bool = True,
                compute: str = "bfloat16") -> dict:
    """The layout the forward kernel launches at this shape (bf16 compute
    with a bf16 or, not ``compact``, an f32 history, or f32 compute; both
    directions), logged with its route (the cluster route, or the
    large-batch layout: 6 units a warp, W resident, the h row block as one
    region a CTA exchanged by bulk copies), the
    number of clusters of its size the card holds at once (read from the
    card), by which the plan chose its rows, and its waves (each a whole
    time loop)."""
    from twotowermlretrieval_tpu_torch.ops.rnn_scan import cluster_slots, fwd_plan, fwd_waves

    hist = torch.bfloat16 if compact and compute == "bfloat16" else torch.float32
    slots = cluster_slots("fwd", cell, compute, hist, dev)
    plan = fwd_plan(cell, T, B, H, 2, compute, hist, slots)
    w = ("resident" if plan["resident"]
         else f"streamed every step through a ring of {plan['wstages']} stages of "
              f"{plan['kc']} rows") + (" as its bf16 pieces" if plan.get("wsplit") else "")
    route, waves = "large-batch" if plan["wide"] else "cluster", fwd_waves(plan, 2)
    block = (f"the h row block as {plan['regions']} regions of {plan['xld']} columns, one bulk "
             f"copy a peer a step" if plan["wide"] else f"{plan['blocks']} h row block(s)")
    log(f"rnn_fwd design, {cell} B={B} T={T} H={H} {compute}: route {route}, {waves} wave(s); "
        f"clusters of {plan['nc']} CTAs x "
        f"{plan['hc']} hidden columns, {plan['rows']} batch rows a cluster, "
        f"{plan['clusters']} clusters a direction ({2 * plan['clusters']} in all; the card "
        f"holds {plan['slots']} clusters of {plan['nc']} at once), W columns {w}, "
        f"{block}, {plan['smem']} bytes of shared memory a CTA")
    return dict(plan, route=route, waves=waves)


def _unit_rows(gen, n, dev, chunk=1 << 18):
    """[n, H] bf16 rows of unit norm, made in chunks to bound the f32
    temporaries."""
    out = torch.empty((n, H), dtype=torch.bfloat16, device=dev)
    for i in range(0, n, chunk):
        x = torch.randn((min(chunk, n - i), H), generator=gen, device=dev)
        out[i : i + chunk] = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    return out


def check_segmax(npad: int, n_valid: int, B: int, seed: int, dev, timed: bool) -> dict:
    from twotowermlretrieval_tpu_torch.ops.topk import (
        NEG_INF,
        fused_topk_segmax,
        segmax,
        segmax_bound,
        segmax_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    docs = _unit_rows(gen, npad, dev)
    q = _unit_rows(gen, B, dev)
    shape = f"B={B} Npad={npad} n_valid={n_valid} H={H} bf16"
    err = 0.0
    for with_cache in (False, True):
        seg, cache = segmax(q, docs, n_valid, with_cache=with_cache)
        r_seg, r_cache = segmax_reference(q, docs, n_valid, with_cache=with_cache)
        torch.cuda.synchronize()
        err = max(err, (seg - r_seg).abs().max().item())
        check(bool((seg[(n_valid + 127) // 128 :] == NEG_INF).all()),
              f"segmax {shape}: a padding segment is not NEG_INF")
        if with_cache:
            err = max(err, (cache - r_cache).abs().max().item())
            check(bool((cache[n_valid:] == NEG_INF).all()), f"segmax {shape}: padding rows")
        del seg, cache, r_seg, r_cache
    log(f"segmax {shape}: |diff| {err:.3g}")
    check(err <= SEGMAX_ATOL, f"segmax {shape}: off by {err}")
    scan_layout("segmax", B, torch.bfloat16)
    # no atomics: a second call gives the same bits, the cache too
    bitwise = all(torch.equal(a, b) for a, b in zip(segmax(q, docs, n_valid, with_cache=True),
                                                    segmax(q, docs, n_valid, with_cache=True)))
    check(bitwise, f"segmax {shape}: two calls differ")

    # The whole search against a full f32 product and torch.topk: values
    # equal within the tolerance, and every id is a real row whose score is
    # within the tolerance of the k-th best (ties may order differently).
    full = torch.matmul(q.float(), docs[:n_valid].float().T)
    r_vals, _ = torch.topk(full, FANOUT)
    for phase2 in ("rescore", "gather"):
        vals, ids = fused_topk_segmax(q, docs, k=FANOUT, n_valid=n_valid, phase2=phase2)
        check(bool(((ids >= 0) & (ids < n_valid)).all()), f"top-k {shape}: an id out of range")
        picked = full.gather(1, ids.long())
        top_err = max((vals - r_vals).abs().max().item(), (picked - vals).abs().max().item())
        check(top_err <= SEGMAX_ATOL, f"top-{FANOUT} {shape} ({phase2}): off by {top_err}")
        check(bool((picked >= r_vals[:, -1:] - SEGMAX_ATOL).all()),
              f"top-{FANOUT} {shape} ({phase2}): an id outside the true top-{FANOUT}")
        err = max(err, top_err)
    log(f"top-{FANOUT} {shape}: matches torch.topk over the full f32 scores")
    del full
    rec = {"shape": shape, "max_abs_err": err, "bitwise_repeatable": bitwise}
    if timed:
        rec["ms"] = time_ms(lambda: segmax(q, docs, n_valid))
        rec["plain_ms"] = time_ms(lambda: segmax_reference(q, docs, n_valid), reps=5, warmup=1)
        # one library product over the corpus (bf16 in, bf16 out, f32
        # accumulation in cuBLAS) plus the segment max
        rec["library_ms"] = time_ms(
            lambda: torch.matmul(docs, q.T).view(-1, 128, B).amax(dim=1)
        )
        rec["search_ms"] = time_ms(lambda: fused_topk_segmax(q, docs, k=FANOUT, n_valid=n_valid))
        rec["library_topk_ms"] = time_ms(
            lambda: torch.topk(torch.matmul(q, docs[:n_valid].T).float(), FANOUT)
        )
        nbytes, flops = segmax_bound(B, H, npad, 2)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
        log(f"segmax {shape}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"matmul+amax {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']}); whole top-{FANOUT} {rec['search_ms']:.4f} ms, "
            f"matmul+topk {rec['library_topk_ms']:.4f} ms")
    del docs
    torch.cuda.empty_cache()
    return rec


def phase_kernels(dev) -> dict:
    with torch.inference_mode():
        rnn = [
            check_rnn("GRU", SERVE_ROWS, QUERY_LEN, 1, dev, timed=True),  # every /search
            check_rnn("GRU", EXPORT_ROWS, DOC_LEN, 2, dev, timed=True),  # every export batch
            check_rnn("GRU", TRAIN_ROWS, QUERY_LEN, 7, dev, timed=True),  # train: query tower
            check_rnn("GRU", 2 * TRAIN_ROWS, DOC_LEN, 8, dev, timed=True),  # train: doc tower
            check_rnn("LSTM", SERVE_ROWS, QUERY_LEN, 3, dev, timed=False),
            check_rnn("RNN", SERVE_ROWS, QUERY_LEN, 4, dev, timed=False),
            # the model axis's GRU step (phase_model_axis): its query tower
            # at B=1024 (its doc tower's shape is the export's, above)
            check_rnn("GRU", GRU_ROWS, QUERY_LEN, 9, dev, timed=True),
            # the training towers with the history in f32 (TTMR_RNN_HISTORY=f32)
            check_rnn("GRU", TRAIN_ROWS, QUERY_LEN, 31, dev, timed=True, compact=False),
            check_rnn("GRU", 2 * TRAIN_ROWS, DOC_LEN, 32, dev, timed=True, compact=False),
        ]
        npad_serve = -(-PASSAGES // 8192) * 8192
        seg = [
            check_segmax(SCAN_ROWS, SCAN_VALID, SERVE_ROWS, 5, dev, timed=True),
            check_segmax(npad_serve, PASSAGES, SERVE_ROWS, 6, dev, timed=True),
        ]
    return {"rnn_fwd": rnn, "segmax": seg}


# Every kernel of the port: its launch counter (the wrapper's attribute),
# its source and the TPU kernel it replaces.
def kernel_table():
    from twotowermlretrieval_tpu_torch.ops import adam, attention, rnn_scan, topk

    return {
        "rnn_fwd": (rnn_scan.rnn_layer_fwd, "twotowermlretrieval_tpu_torch/csrc/rnn_fwd.cu",
                    "twotowermlretrieval_tpu/ops/rnn_scan.py:212"),
        "segmax": (topk.segmax, "twotowermlretrieval_tpu_torch/csrc/segmax.cu",
                   "twotowermlretrieval_tpu/ops/topk.py:334"),
        "rnn_bwd": (rnn_scan.rnn_layer_bwd, "twotowermlretrieval_tpu_torch/csrc/rnn_bwd.cu",
                    "twotowermlretrieval_tpu/ops/rnn_scan.py:397"),
        "segmax_s8": (topk.segmax_s8, "twotowermlretrieval_tpu_torch/csrc/segmax_s8.cu",
                      "twotowermlretrieval_tpu/ops/topk.py:684"),
        "segmax_int8": (topk.segmax_int8, "twotowermlretrieval_tpu_torch/csrc/segmax.cu",
                        "twotowermlretrieval_tpu/ops/topk.py:548"),
        "topk_stream": (topk.topk_stream, "twotowermlretrieval_tpu_torch/csrc/topk_stream.cu",
                        "twotowermlretrieval_tpu/ops/topk.py:183"),
        "topk_stream_int8": (topk.topk_stream_int8,
                             "twotowermlretrieval_tpu_torch/csrc/topk_stream.cu",
                             "twotowermlretrieval_tpu/ops/topk.py:1009"),
        "attention_fwd": (attention.attention_fwd,
                          "twotowermlretrieval_tpu_torch/csrc/attention.cu",
                          "twotowermlretrieval_tpu/ops/attention.py:73"),
        "attention_bwd": (attention.attention_bwd,
                          "twotowermlretrieval_tpu_torch/csrc/attention.cu",
                          "twotowermlretrieval_tpu/ops/attention.py:80"),
        # replaces no TPU kernel: XLA fuses the JAX package's optax update
        "adam": (adam.clip_and_adam, "twotowermlretrieval_tpu_torch/csrc/adam.cu", None),
    }


def zero_counts() -> None:
    from twotowermlretrieval_tpu_torch.ops import attention

    for fn, _, _ in kernel_table().values():
        fn.launches = 0
    for fn in (attention.attention_fwd, attention.attention_bwd):
        fn.by_route = dict.fromkeys(fn.by_route, 0)


def read_counts() -> dict:
    """Every kernel's launch count."""
    from twotowermlretrieval_tpu_torch.ops import launch_counts

    return launch_counts()


def _unit_rows_f32(gen, n, dev, chunk=1 << 18, width=H):
    out = torch.empty((n, width), dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        x = torch.randn((min(chunk, n - i), width), generator=gen, device=dev)
        out[i : i + chunk] = x / x.norm(dim=1, keepdim=True)
    return out


def _check_topk(what, vals, ids, full, n_valid, atol):
    """vals/ids against torch.topk of the full f32 scores: values within
    atol, every id a valid row whose score is its value within atol and no
    worse than the k-th best minus atol (near-ties may order differently)."""
    r_vals, _ = torch.topk(full[:, :n_valid], vals.shape[1])
    check(bool(((ids >= 0) & (ids < n_valid)).all()), f"{what}: an id out of range")
    picked = full.gather(1, ids.long())
    err = max((vals - r_vals).abs().max().item(), (picked - vals).abs().max().item())
    check(err <= atol, f"{what}: off by {err}")
    check(bool((picked >= r_vals[:, -1:] - atol).all()), f"{what}: an id outside the true top-k")
    return err


def scan_layout(name: str, B: int, storage, k=None) -> dict:
    """Log the layout the scan kernel ``name`` launches at B query rows
    (``ops/topk.py`` scan_plan) and return it."""
    from twotowermlretrieval_tpu_torch.ops.topk import scan_plan

    plan = scan_plan(B, H, storage, k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    what = f"{name} layout, B={B} H={H} {str(storage).split('.')[-1]}" + (
        "" if k is None else f" k={k}")
    if plan["query_frags"] == "ring":
        split = (" f32 split into three bf16 pieces (six products),"
                 if storage == torch.float32 else "")
        log(f"{what}: tensor cores,{split} {plan['stages']} cp.async stages of "
            f"{plan['stage_bytes']} bytes (16 KiB of rows, then the stage's query fragments, "
            f"{plan['nt']} n8 tiles, from {plan['query_frag_bytes']} bytes written once a "
            f"call), {plan['blocks_per_sm']} blocks a SM ({plan['blocks_per_sm'] * sms} "
            f"persistent), {plan['k_tail']} zero columns past H, {plan['smem']} bytes a block")
    else:
        log(f"{what}: tensor cores, {plan['stages']} cp.async stages of 16 KiB, "
            f"{plan['blocks_per_sm']} blocks a SM ({plan['blocks_per_sm'] * sms} persistent), "
            f"query fragments in shared memory ({plan['nt']} n8 tiles), {plan['k_tail']} zero "
            f"columns past H, {plan['smem']} bytes a block")
    return plan


def check_scans_at(B: int, docs, values, scales, n_valid: int, dev, seed: int,
                   docs_f32=None) -> list:
    """The four redesigned scans (segmax over bf16 rows, segmax_int8, the
    running top-k over bf16 and over per-row int8 rows; ``docs`` None: none
    of them) and, given ``docs_f32``, segmax and the running top-k over
    those f32 rows (the f32 route: three bf16 pieces a value, six products)
    at B query rows: each against its plain version
    (SEGMAX_ATOL / INT8_ATOL; the top-k's ids against the full f32 scores),
    two calls bit-identical, its layout logged, timed beside its library
    call and its bound. Returns (kernel name, record) pairs."""
    from twotowermlretrieval_tpu_torch.ops.topk import (
        NEG_INF,
        segmax,
        segmax_bound,
        segmax_int8,
        segmax_int8_bound,
        segmax_int8_reference,
        segmax_reference,
        topk_stream,
        topk_stream_bound,
        topk_stream_int8,
        topk_stream_reference,
    )

    npad = (docs_f32 if docs is None else docs).shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    qb = _unit_rows(gen, B, dev)
    cases = []  # name, kernel, plain version, tolerance, library call, (bytes, flops, peak),
    #             (layout's storage, k), full scores
    if docs is not None:
        f_bf16 = torch.matmul(qb.float(), docs.float().T)
        f_int8 = torch.matmul(qb.float(), values.float().T) * scales
        v16 = values[:n_valid].to(torch.bfloat16)
        cases += [
            ("segmax", lambda: segmax(qb, docs, n_valid)[0],
             lambda: segmax_reference(qb, docs, n_valid)[0], SEGMAX_ATOL,
             lambda: torch.matmul(docs, qb.T).view(-1, 128, B).amax(dim=1),
             segmax_bound(B, H, npad, 2) + (PEAK_BF16_FLOPS,), (torch.bfloat16, None), None),
            ("segmax_int8", lambda: segmax_int8(qb, values, scales, n_valid),
             lambda: segmax_int8_reference(qb, values, scales, n_valid), INT8_ATOL,
             lambda: (torch.matmul(values.to(torch.bfloat16), qb.T).float()
                      * scales[:, None]).view(-1, 128, B).amax(dim=1),
             segmax_int8_bound(B, H, npad) + (PEAK_BF16_FLOPS,), (torch.int8, None), None),
            ("topk_stream", lambda: topk_stream(qb, docs, FANOUT, n_valid),
             lambda: topk_stream_reference(qb, docs, FANOUT, n_valid), SEGMAX_ATOL,
             lambda: torch.topk(torch.matmul(qb, docs[:n_valid].T).float(), FANOUT),
             topk_stream_bound(B, H, npad, FANOUT, 2) + (PEAK_BF16_FLOPS,),
             (torch.bfloat16, FANOUT), f_bf16),
            ("topk_stream_int8", lambda: topk_stream_int8(qb, values, scales, FANOUT, n_valid),
             lambda: topk_stream_reference(qb, values, FANOUT, n_valid, scales), INT8_ATOL,
             lambda: torch.topk(torch.matmul(qb, v16.T).float() * scales[:n_valid], FANOUT),
             topk_stream_bound(B, H, npad, FANOUT, 1, scaled=True) + (PEAK_BF16_FLOPS,),
             (torch.int8, FANOUT), f_int8),
        ]
    if docs_f32 is not None:
        qf = _unit_rows_f32(gen, B, dev, width=docs_f32.shape[1])
        f_f32 = torch.matmul(qf, docs_f32.T)
        cases += [
            ("segmax", lambda: segmax(qf, docs_f32, n_valid)[0],
             lambda: segmax_reference(qf, docs_f32, n_valid)[0], SEGMAX_ATOL,
             lambda: torch.matmul(docs_f32, qf.T).view(-1, 128, B).amax(dim=1),
             segmax_bound(B, H, npad, 4) + (PEAK_SPLIT_FLOPS,), (torch.float32, None), None),
            ("topk_stream", lambda: topk_stream(qf, docs_f32, FANOUT, n_valid),
             lambda: topk_stream_reference(qf, docs_f32, FANOUT, n_valid), SEGMAX_ATOL,
             lambda: torch.topk(torch.matmul(qf, docs_f32[:n_valid].T), FANOUT),
             topk_stream_bound(B, H, npad, FANOUT, 4) + (PEAK_SPLIT_FLOPS,),
             (torch.float32, FANOUT), f_f32),
        ]
    kinds = {torch.bfloat16: "bf16", torch.int8: "int8 per row", torch.float32: "f32"}
    recs = []
    for name, kernel, plain, tol, lib, (nbytes, ops, peak), (storage, k), full in cases:
        shape = f"B={B} Npad={npad} n_valid={n_valid} H={H} {kinds[storage]}" + (
            "" if k is None else f" k={k}")
        plan = scan_layout(name, B, storage, k)
        got, again, want = kernel(), kernel(), plain()
        got, again, want = ((t,) if torch.is_tensor(t) else t for t in (got, again, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        check(bitwise, f"{name} {shape}: two calls differ")
        err = (got[0] - want[0]).abs().max().item()
        check(err <= tol, f"{name} {shape}: off its plain version by {err}")
        if full is not None:
            err = max(err, _check_topk(f"{name} {shape}", got[0], got[1], full, n_valid, tol))
        else:
            check(bool((got[0][(n_valid + 127) // 128:] == NEG_INF).all()),
                  f"{name} {shape}: a padding segment is not NEG_INF")
        rec = {"shape": shape, "max_abs_err": err, "bitwise_repeatable": bitwise,
               "layout": plan, "ms": time_ms(kernel), "library_ms": time_ms(lib)}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, peak)
        log(f"{name} {shape}: |diff| {err:.3g}, two calls bit-identical; kernel {rec['ms']:.4f} "
            f"ms, library {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']})")
        recs.append((name, rec))
    del cases
    torch.cuda.empty_cache()
    return recs


def s8_layout(B: int, H: int) -> dict:
    """Log the layout segmax_s8 launches at B query rows of width H
    (``ops/topk.py`` s8_plan) and return it."""
    from twotowermlretrieval_tpu_torch.ops.topk import s8_plan

    plan = s8_plan(B, H)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"segmax_s8 layout, B={B} H={H} int8: s8 tensor cores, {plan['stages']} cp.async "
        f"stages of 16 KiB, {plan['blocks_per_sm']} blocks a SM "
        f"({plan['blocks_per_sm'] * sms} persistent), {plan['in_flight'] // 1024} KiB in flight "
        f"a SM, query fragments in shared memory ({plan['nt']} n8 tiles), {plan['k_tail']} zero "
        f"columns past H, {plan['smem']} bytes a block")
    return plan


def _int_mm_amax(values, q_i8, seg: int):
    """The library yardstick of segmax_s8: cuBLASLt's int8 product (int32
    out) and the segment max. _int_mm takes a multiple of 8 query columns,
    so fewer rows are zero-padded to 8."""
    B = q_i8.shape[0]
    qt = torch.nn.functional.pad(q_i8, (0, 0, 0, (-B) % 8)).t()  # column-major [H, B8]
    return lambda: torch._int_mm(values, qt).view(-1, seg, qt.shape[1]).amax(dim=1)


def _check_s8_bitwise(q_i8, values, seg: int, what: str) -> None:
    """segmax_s8's maxima, without and with the score cache, equal to the
    plain version's in every bit, and two calls bit-identical."""
    from twotowermlretrieval_tpu_torch.ops.topk import segmax_s8, segmax_s8_reference

    for with_cache in (False, True):
        got, cache = segmax_s8(q_i8, values, seg, with_cache=with_cache)
        want, r_cache = segmax_s8_reference(q_i8, values, seg, with_cache=with_cache)
        again = segmax_s8(q_i8, values, seg, with_cache=with_cache)
        check(torch.equal(got, want) and (not with_cache or torch.equal(cache, r_cache)),
              f"segmax_s8 {what} seg {seg} cache {with_cache}: not bitwise equal")
        check(torch.equal(got, again[0]) and (not with_cache or torch.equal(cache, again[1])),
              f"segmax_s8 {what} seg {seg} cache {with_cache}: two calls differ")


def _time_s8(rec: dict, q_i8, values, seg: int) -> None:
    """segmax_s8's times into rec: single calls (time_ms) now and the
    card's own (time_ms_device) at the end of the run, without and with
    the score cache, and _int_mm+amax's alike."""
    from twotowermlretrieval_tpu_torch.ops.topk import segmax_s8

    for key, fn in (("", lambda: segmax_s8(q_i8, values, seg)),
                    ("cache_", lambda: segmax_s8(q_i8, values, seg, with_cache=True)),
                    ("library_", _int_mm_amax(values, q_i8, seg))):
        rec[f"{key}ms"] = time_ms(fn)
        later_on_card(rec, f"{key}device_ms", fn)


def _s8_times(rec: dict) -> str:
    return (f"kernel {rec['ms']:.4f} ms (bound {rec['bound_ms']:.6f} {rec['bound_by']}), with "
            f"the cache {rec['cache_ms']:.4f} (bound {rec['cache_bound_ms']:.6f}), _int_mm+amax "
            f"{rec['library_ms']:.4f}")


def check_s8_at(B: int, values, seed: int, dev) -> dict:
    """segmax_s8 at B int8 query rows over ``values`` (a per-segment int8
    index, seg 128): maxima and cache bitwise equal to the plain version,
    two calls bit-identical, its layout logged, timed beside _int_mm+amax
    and its bounds (without and with the cache)."""
    from twotowermlretrieval_tpu_torch.ops.topk import quantize_query_rows, segmax_s8_bound

    npad, width = values.shape
    q_i8, _ = quantize_query_rows(_unit_rows_f32(torch.Generator(device=dev).manual_seed(seed),
                                                 B, dev, width=width))
    shape = f"B={B} Npad={npad} H={width} int8 seg 128"
    plan = s8_layout(B, width)
    _check_s8_bitwise(q_i8, values, 128, shape)
    rec = {"shape": shape, "max_abs_err": 0.0, "bitwise_repeatable": True, "layout": plan}
    _time_s8(rec, q_i8, values, 128)
    rec["bound_ms"], rec["bound_by"] = bound(*segmax_s8_bound(B, width, npad, 128), PEAK_INT8_OPS)
    rec["cache_bound_ms"], _ = bound(*segmax_s8_bound(B, width, npad, 128, with_cache=True),
                                     PEAK_INT8_OPS)
    log(f"segmax_s8 {shape}: bitwise equal to the plain version, two calls bit-identical; "
        + _s8_times(rec))
    torch.cuda.empty_cache()
    return rec


def check_segmax_s8(docs_f32, n_valid: int, q, dev, timed: bool, batches=()) -> list:
    """Kernel 5 over the rows of ``docs_f32`` (rows >= n_valid zero, as the
    index pads), quantized per segment on the host with the index's own
    quantize_segments: segment maxima and cache bitwise equal to the plain
    version at seg 128 and 64; the whole search with the kernel bitwise
    equal to the same search with the plain phase 1 and to the two-phase
    path; top-50 recall against exact f32 search; then, over the seg-128
    index, the kernel at each of ``batches`` query rows (check_s8_at).
    Returns the records, the B=16 one first."""
    from twotowermlretrieval_tpu_torch.ops.topk import (
        fused_topk_segmax_s8,
        quantize_query_rows,
        quantize_segments,
        s8_phase2,
        segmax_s8,
        segmax_s8_bound,
        segmax_s8_reference,
        topk_segmented_s8,
    )

    npad, B = docs_f32.shape[0], q.shape[0]
    host = docs_f32.cpu().numpy()
    q_i8, q_scale = quantize_query_rows(q)
    shape = f"B={B} Npad={npad} n_valid={n_valid} H={H} int8"
    full = torch.matmul(q, docs_f32[:n_valid].T)
    _, exact_ids = torch.topk(full, FANOUT)
    rec = {"shape": shape, "max_abs_err": 0.0}
    recs = [rec]

    def err(a, b) -> float:
        return (a - b).abs().max().item() if a.numel() else 0.0
    for seg in S8_SEGS:
        values_np, scales_np = quantize_segments(host, seg=seg)
        values = torch.from_numpy(values_np).to(dev)
        scales = torch.from_numpy(scales_np).to(dev)
        del values_np
        for with_cache in (False, True):
            got, cache = segmax_s8(q_i8, values, seg, with_cache=with_cache)
            want, r_cache = segmax_s8_reference(q_i8, values, seg, with_cache=with_cache)
            same = torch.equal(got, want) and (not with_cache or torch.equal(cache, r_cache))
            check(same, f"segmax_s8 {shape} seg {seg} cache {with_cache}: not bitwise equal")
            rec["max_abs_err"] = max(rec["max_abs_err"], err(got, want),
                                     err(cache, r_cache) if with_cache else 0.0)
            del got, cache, want, r_cache
        for phase2 in ("rescore", "gather"):
            vals, ids = fused_topk_segmax_s8(q, values, scales, k=FANOUT, n_valid=n_valid,
                                             seg=seg, phase2=phase2)
            maxima, cache = segmax_s8_reference(q_i8, values, seg, with_cache=phase2 == "gather")
            r_vals, r_ids = s8_phase2(maxima, cache, q_i8, q_scale, values, scales, FANOUT,
                                      n_valid, seg)
            check(torch.equal(vals, r_vals) and torch.equal(ids, r_ids),
                  f"top-{FANOUT} {shape} seg {seg} ({phase2}): differs from the plain phase 1")
            rec["max_abs_err"] = max(rec["max_abs_err"], err(vals, r_vals))
            del maxima, cache
        t_vals, t_ids = topk_segmented_s8(q, values, scales, k=FANOUT, n_valid=n_valid, seg=seg)
        check(torch.equal(vals, t_vals) and torch.equal(ids, t_ids),
              f"top-{FANOUT} {shape} seg {seg}: differs from the two-phase path")
        check(bool(((ids >= 0) & (ids < n_valid)).all()), f"s8 {shape}: an id out of range")
        recall = float(np.mean([len(set(a) & set(b)) / FANOUT for a, b in
                                zip(ids.tolist(), exact_ids.tolist())]))
        rec[f"recall_at_{FANOUT}_seg{seg}"] = recall
        log(f"segmax_s8 {shape} seg {seg}: bitwise equal to the plain version (maxima, cache, "
            f"top-{FANOUT} rescore/gather, two-phase path); top-{FANOUT} recall against exact "
            f"f32 {recall:.4f}")
        check(recall >= 0.5, f"s8 {shape} seg {seg}: recall {recall}")
        if timed and seg == 128:
            rec["layout"] = s8_layout(B, H)
            _check_s8_bitwise(q_i8, values, seg, shape)
            rec["bitwise_repeatable"] = True
            _time_s8(rec, q_i8, values, seg)
            rec["plain_ms"] = time_ms(lambda: segmax_s8_reference(q_i8, values, seg),
                                      reps=5, warmup=1)
            # what the card reads at best: one int64 max over the same bytes
            words = values.view(torch.int64)
            later_on_card(rec, "read_device_ms", lambda: words.amax())
            rec["search_ms"] = time_ms(lambda: fused_topk_segmax_s8(
                q, values, scales, k=FANOUT, n_valid=n_valid, seg=seg))
            nbytes, ops = segmax_s8_bound(B, H, npad, seg)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, PEAK_INT8_OPS)
            rec["cache_bound_ms"], _ = bound(*segmax_s8_bound(B, H, npad, seg, with_cache=True),
                                             PEAK_INT8_OPS)
            log(f"segmax_s8 {shape}: two calls bit-identical; {_s8_times(rec)}; plain "
                f"{rec['plain_ms']:.4f} ms; whole top-{FANOUT} {rec['search_ms']:.4f} ms")
            for i, b in enumerate(batches):  # the other batch sizes over the same index
                recs.append(check_s8_at(b, values, 50 + i, dev))
        del values, scales
    torch.cuda.empty_cache()
    return recs


def check_int8_rows(docs_f32, n_valid: int, q, dev) -> dict:
    """Kernels 6, 7 and 8 over the rows of ``docs_f32``: segmax_int8 (the
    per-row int8 corpus, quantize_rows) and the running top-k over bf16 and
    per-row int8 storage, each against its plain version and torch.topk of
    the full f32 scores, two calls bit-identical, each driven once through
    its public function with the counts at 0, and timed; then the four
    redesigned scans at the other batch sizes (SCAN_BATCHES). Returns the
    records by kernel, the B=16 one first."""
    from twotowermlretrieval_tpu_torch.ops.topk import (
        NEG_INF,
        fused_topk,
        fused_topk_int8,
        fused_topk_segmax_int8,
        quantize_rows,
        segmax_int8,
        segmax_int8_bound,
        segmax_int8_reference,
        topk_stream,
        topk_stream_bound,
        topk_stream_int8,
        topk_stream_reference,
    )

    npad, B = docs_f32.shape[0], q.shape[0]
    values_np, scales_np = quantize_rows(docs_f32.cpu().numpy())
    values, scales = torch.from_numpy(values_np).to(dev), torch.from_numpy(scales_np).to(dev)
    del values_np
    qb = q.bfloat16()
    docs = docs_f32.bfloat16()
    recs = {}

    # kernel 6: the per-row int8 segment max
    shape = f"B={B} Npad={npad} n_valid={n_valid} H={H} int8 per row"
    scan_layout("segmax_int8", B, torch.int8)
    got = segmax_int8(qb, values, scales, n_valid)
    want = segmax_int8_reference(qb, values, scales, n_valid)
    check(torch.equal(got, segmax_int8(qb, values, scales, n_valid)),
          f"segmax_int8 {shape}: two calls differ")
    err = (got - want).abs().max().item()
    check(err <= INT8_ATOL, f"segmax_int8 {shape}: off by {err}")
    check(bool((got[(n_valid + 127) // 128 :] == NEG_INF).all()), "segmax_int8: padding")
    full = torch.matmul(qb.float(), values.float().T) * scales
    zero_counts()
    vals, ids = fused_topk_segmax_int8(qb, values, scales, k=FANOUT, n_valid=n_valid)
    launches = read_counts()["segmax_int8"]
    err = max(err, _check_topk(f"segmax_int8 top-{FANOUT}", vals, ids, full, n_valid, INT8_ATOL))
    rec = {"shape": shape, "max_abs_err": err, "launches": launches}
    rec["ms"] = time_ms(lambda: segmax_int8(qb, values, scales, n_valid))
    rec["plain_ms"] = time_ms(lambda: segmax_int8_reference(qb, values, scales, n_valid),
                              reps=5, warmup=1)
    rec["library_ms"] = time_ms(lambda: (torch.matmul(values.to(torch.bfloat16), qb.T).float()
                                         * scales[:, None]).view(-1, 128, B).amax(dim=1))
    rec["bound_ms"], rec["bound_by"] = bound(*segmax_int8_bound(B, H, npad))
    recs["segmax_int8"] = rec

    # kernels 7 and 8: the running top-k over bf16 and over per-row int8
    f_bf16 = torch.matmul(q.bfloat16().float(), docs.float().T)
    for name, args, public, plain, tol, lib, nbytes_ops, f in (
        ("topk_stream", (qb, docs), lambda: fused_topk(qb, docs, k=FANOUT, n_valid=n_valid),
         lambda: topk_stream_reference(qb, docs, FANOUT, n_valid), SEGMAX_ATOL,
         lambda: torch.topk(torch.matmul(qb, docs[:n_valid].T).float(), FANOUT),
         topk_stream_bound(B, H, npad, FANOUT, 2), f_bf16),
        ("topk_stream_int8", (qb, values, scales),
         lambda: fused_topk_int8(qb, values, scales, k=FANOUT, n_valid=n_valid),
         lambda: topk_stream_reference(qb, values, FANOUT, n_valid, scales), INT8_ATOL,
         lambda: torch.topk(torch.matmul(qb, values[:n_valid].to(torch.bfloat16).T).float()
                            * scales[:n_valid], FANOUT),
         topk_stream_bound(B, H, npad, FANOUT, 1, scaled=True), full),
    ):
        kernel = topk_stream if name == "topk_stream" else topk_stream_int8
        scan_layout(name, B, torch.bfloat16 if name == "topk_stream" else torch.int8, FANOUT)
        k_vals, k_ids = kernel(*args, FANOUT, n_valid)
        # the blocks race on the shared thresholds; the result must not move
        again = kernel(*args, FANOUT, n_valid)
        check(torch.equal(k_vals, again[0]) and torch.equal(k_ids, again[1]),
              f"{name}: two calls differ")
        r_vals, r_ids = plain()
        err = (k_vals - r_vals).abs().max().item()
        check(err <= tol, f"{name}: off its plain version by {err}")
        err = max(err, _check_topk(f"{name} (kernel)", k_vals, k_ids, f, n_valid, tol))
        zero_counts()
        vals, ids = public()
        launches = read_counts()[name]
        err = max(err, _check_topk(f"{name} top-{FANOUT}", vals, ids, f, n_valid, tol))
        same_ids = float((k_ids == r_ids).float().mean().item())
        rec = {"shape": f"B={B} Npad={npad} n_valid={n_valid} H={H} k={FANOUT} "
                        f"{'bf16' if name == 'topk_stream' else 'int8 per row'}",
               "max_abs_err": err, "launches": launches, "ids_equal_plain": same_ids}
        rec["ms"] = time_ms(lambda: kernel(*args, FANOUT, n_valid))
        rec["plain_ms"] = time_ms(plain, reps=5, warmup=1)
        rec["library_ms"] = time_ms(lib)
        rec["bound_ms"], rec["bound_by"] = bound(*nbytes_ops)
        recs[name] = rec
    for name, rec in recs.items():
        log(f"{name} {rec['shape']}: |diff| {rec['max_abs_err']:.3g}, {rec['launches']} launch "
            f"from its public function, two calls bit-identical; kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    del full, f_bf16
    torch.cuda.empty_cache()
    out = {name: [rec] for name, rec in recs.items()}
    out["segmax"] = []  # its B=16 record is check_segmax's
    for i, b in enumerate(SCAN_BATCHES):  # the other batch sizes over the same rows
        for name, rec in check_scans_at(b, docs, values, scales, n_valid, dev, 40 + i,
                                        docs_f32=docs_f32):
            out[name].append(rec)
    # the f32 route at the served batch over the same rows
    for name, rec in check_scans_at(SERVE_ROWS, None, None, None, n_valid, dev, 43,
                                    docs_f32=docs_f32):
        out[name].append(rec)
    del values, scales, docs
    torch.cuda.empty_cache()
    return out


def phase_int8_kernels(dev) -> dict:
    from twotowermlretrieval_tpu_torch.ops.topk import quantize_rows

    npad_serve = -(-PASSAGES // 8192) * 8192
    out = {"segmax_s8": []}
    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(20)
        q = _unit_rows_f32(gen, SERVE_ROWS, dev)
        for npad, n_valid, timed in ((SCAN_ROWS, SCAN_VALID, True),
                                     (npad_serve, PASSAGES, True)):
            docs = _unit_rows_f32(gen, npad, dev)
            docs[n_valid:] = 0.0
            out["segmax_s8"] += check_segmax_s8(docs, n_valid, q, dev, timed,
                                                SCAN_BATCHES if npad == SCAN_ROWS else ())
            if npad == SCAN_ROWS:
                for name, recs in check_int8_rows(docs, n_valid, q, dev).items():
                    out.setdefault(name, []).extend(recs)
            else:  # the four redesigned scans at the served rows
                values, scales = (torch.from_numpy(a).to(dev)
                                  for a in quantize_rows(docs.cpu().numpy()))
                for name, rec in check_scans_at(SERVE_ROWS, docs.bfloat16(), values, scales,
                                                n_valid, dev, 45):
                    out.setdefault(name, []).append(rec)
                del values, scales
            del docs
            torch.cuda.empty_cache()
    return out


def _bwd_inputs(cell, B, T, seed, dev, H=H, compact: bool = True, compute="bfloat16"):
    """The forward's inputs, its history (from the forward kernel; bf16, or
    f32 where not ``compact`` or at f32 compute) and random cotangents: in
    the history's dtype, f32 for h_final."""
    from twotowermlretrieval_tpu_torch.ops.rnn_scan import rnn_layer_fwd

    xps, mask, w_hh, b_hh = _rnn_inputs(cell, B, T, seed, dev, H, compute)
    with torch.no_grad():
        outs, c_hist, _ = rnn_layer_fwd(cell, xps, mask, w_hh, b_hh, compute, compact)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    douts = [torch.randn((T, B, H), generator=gen, device=dev).to(outs[0].dtype)
             for _ in range(2)]
    d_hfinal = torch.randn((2, B, H), generator=gen, device=dev)
    return xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _cudnn_backward_ms(B, T, dev, H=H, cell="GRU", dtype=torch.float16) -> float:
    """cuDNN's backward of one bidirectional layer of the cell (input width
    2H, fp16, or f32 with TF32 off): forward+backward minus forward, each
    timed alone."""
    layer = _cudnn_layer(cell, H, dev, dtype)
    x = torch.randn((T, B, 2 * H), device=dev, dtype=dtype, requires_grad=True)
    g = torch.randn((T, B, 2 * H), device=dev, dtype=dtype)
    with torch.enable_grad():
        fwd = time_ms(lambda: layer(x))
        both = time_ms(lambda: torch.autograd.backward(layer(x)[0], g))
    return both - fwd


def _bwd_design(cell: str, B: int, T: int, dev, H=H, compact: bool = True,
                compute: str = "bfloat16") -> dict:
    """The layout the backward kernel launches at this shape (bf16 compute
    with a bf16 or, not ``compact``, an f32 history, or f32 compute; both
    directions), logged with its route (the cluster route, or the
    large-batch layout: W resident, one dhp row block, nothing staged), the
    card's count of clusters of its size and its waves (each a whole time
    loop)."""
    from twotowermlretrieval_tpu_torch.ops.rnn_scan import bwd_plan, bwd_waves, cluster_slots

    hist = torch.bfloat16 if compact and compute == "bfloat16" else torch.float32
    slots = cluster_slots("bwd", cell, compute, hist, dev)
    plan = bwd_plan(cell, T, B, H, 2, compute, hist, slots)
    route, waves = "large-batch" if plan["wide"] else "cluster", bwd_waves(plan, 2)
    w = ("resident" if plan["resident"]
         else f"streamed every step in chunks of {plan['kc']} columns, through a ring of "
              f"{plan['wstages']} stages of {plan['kw']} columns")
    kp = -(-_GATES[cell] * plan["H"] // 16) * 16
    x = ("whole" if plan["xc"] >= kp
         else f"exchanged in chunks of {plan['xc']} columns, a cluster barrier each")
    log(f"rnn_bwd design, {cell} B={B} T={T} H={H} {compute}: route {route}, {waves} wave(s); "
        f"clusters of {plan['nc']} CTAs x "
        f"{plan['hc']} hidden columns (the card holds {plan['slots']} at once), "
        f"{plan['rows']} batch rows a cluster, {plan['clusters']} clusters a direction, W rows "
        f"{w}, {plan['stages']} staging buffers, {plan['blocks']} dhp row block(s) {x}, "
        f"{plan['smem']} bytes of shared memory a CTA; weight gradient in "
        f"{plan['nsplit']} slices of T*B")
    return dict(plan, route=route, waves=waves)


def _over(a, b, atol: float, rtol: float) -> float:
    """The largest excess of |a - b| over atol + rtol |b| (<= 0: within)."""
    return ((a.float() - b.float()).abs() - atol - rtol * b.float().abs()).max().item()


def check_rnn_bwd(cell: str, B: int, T: int, seed: int, dev, timed: bool, H=H,
                  compact: bool = True, compute: str = "bfloat16") -> dict:
    """The backward kernel against its plain version at bf16 compute, the
    history in bf16 (``compact``) or f32 (TTMR_RNN_HISTORY=f32), or at f32
    compute (the split products; BWD_F32_* tolerances), timed there beside
    cuDNN's f32 backward."""
    from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
        rnn_bwd_bound,
        rnn_layer_bwd,
        rnn_layer_bwd_reference,
    )

    f32 = compute == "float32"
    args = _bwd_inputs(cell, B, T, seed, dev, H, compact, compute)
    kw = dict(compute_dtype=compute)
    dxps, dw, db = rnn_layer_bwd(cell, *args, **kw)
    r_dxps, r_dw, r_db = rnn_layer_bwd_reference(cell, *args, **kw)
    # no atomics: a second call gives the same bits (resume relies on it)
    a_dxps, a_dw, a_db = rnn_layer_bwd(cell, *args, **kw)
    bitwise = all(torch.equal(x, y) for x, y in zip((*dxps, dw, db), (*a_dxps, a_dw, a_db)))
    torch.cuda.synchronize()
    dxp_err = max((a - b).abs().max().item() for a, b in zip(dxps, r_dxps))
    dxp_scale = max(b.abs().max().item() for b in r_dxps)
    w_rel, b_rel = _rel(dw, r_dw), _rel(db, r_db)
    finite = all(bool(torch.isfinite(t).all()) for t in (*dxps, dw, db))
    zero_row = all(bool((d[:, 0] == 0).all()) for d in dxps)  # row 0 has length 0
    hist = "f32" if f32 or not compact else "bf16"
    shape = f"{cell} D=2 B={B} T={T} H={H} " + (
        "f32 compute" if f32 else f"bf16, {hist} history")
    log(f"rnn_bwd {shape}: |dxp diff| {dxp_err:.3g} (scale {dxp_scale:.3g}), "
        f"dW {w_rel:.3g}, db {b_rel:.3g} norm-relative")
    check(finite, f"rnn_bwd {shape}: non-finite output")
    check(zero_row, f"rnn_bwd {shape}: a zero-length row has a gate cotangent")
    if f32:
        over = max(max(_over(a, b, BWD_F32_DXP_ATOL, BWD_F32_RTOL) for a, b in zip(dxps, r_dxps)),
                   _over(dw, r_dw, BWD_F32_W_ATOL, BWD_F32_RTOL),
                   _over(db, r_db, BWD_F32_W_ATOL, BWD_F32_RTOL))
        check(over <= 0, f"rnn_bwd {shape}: dxp/dW/db beyond atol + rtol |plain| by {over}")
    else:
        check(dxp_err <= BWD_DXP_REL * dxp_scale, f"rnn_bwd {shape}: dxp off by {dxp_err}")
        check(w_rel <= BWD_W_REL and b_rel <= BWD_W_REL, f"rnn_bwd {shape}: dW/db off")
    check(bitwise, f"rnn_bwd {shape}: two calls differ")
    log(f"rnn_bwd {shape}: two calls bit-identical in dxp, dW and db")
    max_abs = max(dxp_err, (dw - r_dw).abs().max().item(), (db - r_db).abs().max().item())
    rec = {"shape": shape, "max_abs_err": max_abs, "dxp_err_of_scale": dxp_err / dxp_scale,
           "dw_rel": w_rel, "db_rel": b_rel, "bitwise_repeatable": bitwise}
    if timed:
        rec["design"] = _bwd_design(cell, B, T, dev, H, compact, compute)
        rec["ms"] = time_ms(lambda: rnn_layer_bwd(cell, *args, **kw))
        rec["plain_ms"] = time_ms(lambda: rnn_layer_bwd_reference(cell, *args, **kw),
                                  reps=3, warmup=1)
        ldt = torch.float32 if f32 else torch.float16
        rec["library_ms"] = _cudnn_backward_ms(B, T, dev, H, cell, ldt)
        nbytes, flops = rnn_bwd_bound(T, B, H, 2, _GATES[cell], 4 if f32 else 2,
                                      2 if compact and not f32 else 4)
        # f32 compute: each product as the six bf16 products of its split
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops,
                                                 PEAK_SPLIT_FLOPS if f32 else PEAK_BF16_FLOPS)
        rec["step_us"] = rec["ms"] / T * 1e3
        log(f"rnn_bwd {shape}: kernel {rec['ms']:.4f} ms ({rec['step_us']:.2f} us a step, the "
            f"two products included), plain {rec['plain_ms']:.4f} ms, cuDNN {cell} backward "
            f"(fwd+bwd - fwd, {str(ldt)[6:]}) {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return rec


def check_rnn_bwd_split(B: int, T: int, seed: int, dev) -> dict:
    """Split mode (dxp and dhp out, both directions in one launch) against
    its plain version, and the hoisted weight gradient against the
    combined kernel's own accumulation; timed: the split-mode launch, the
    whole hoisted route (``TTMR_RNN_BWD_PLAN=hoisted``: the launch plus one
    weight-gradient product per direction), the plain split version and
    cuDNN's GRU backward."""
    from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
        _bwd_hoisted_call,
        _bwd_reference,
        rnn_bwd_bound,
        rnn_layer_bwd,
        rnn_layer_bwd_hoisted,
    )

    args = _bwd_inputs("GRU", B, T, seed, dev)
    dxps, dhps = _bwd_hoisted_call("GRU", *args, compute_dtype="bfloat16")
    r_dxps, r_dhps, _, _ = _bwd_reference("GRU", *args, "bfloat16", split=True)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(dxps + dhps, r_dxps + r_dhps))
    scale = max(b.float().abs().max().item() for b in r_dxps + r_dhps)
    _, h_dw, h_db = rnn_layer_bwd_hoisted("GRU", *args, compute_dtype="bfloat16")
    _, c_dw, c_db = rnn_layer_bwd("GRU", *args, compute_dtype="bfloat16")
    w_rel, b_rel = _rel(h_dw, c_dw), _rel(h_db, c_db)
    shape = f"GRU D=2 B={B} T={T} H={H} bf16, split mode"
    log(f"rnn_bwd {shape}: |dxp, dhp diff| {err:.3g} (scale {scale:.3g}); hoisted dW "
        f"against the kernel's {w_rel:.3g}, db {b_rel:.3g} norm-relative")
    check(err <= BWD_DXP_REL * scale, f"rnn_bwd {shape}: dxp/dhp off by {err}")
    # db differs by design: the hoisted sum reads the bf16-rounded dhp
    check(w_rel <= BWD_W_REL and b_rel <= 2 * BWD_DXP_REL, f"rnn_bwd {shape}: hoisted dW/db")
    rec = {"shape": shape, "max_abs_err": err, "hoisted_dw_rel": w_rel, "hoisted_db_rel": b_rel}
    kw = dict(compute_dtype="bfloat16")
    rec["ms"] = time_ms(lambda: _bwd_hoisted_call("GRU", *args, **kw))
    rec["route_ms"] = time_ms(lambda: rnn_layer_bwd_hoisted("GRU", *args, **kw))
    rec["plain_ms"] = time_ms(lambda: _bwd_reference("GRU", *args, "bfloat16", split=True),
                              reps=3, warmup=1)
    rec["library_ms"] = _cudnn_backward_ms(B, T, dev)
    nbytes, flops = rnn_bwd_bound(T, B, H, 2, 3, 2, 2, split=True)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
    log(f"rnn_bwd {shape}: kernel {rec['ms']:.4f} ms, hoisted route {rec['route_ms']:.4f} ms, "
        f"plain {rec['plain_ms']:.4f} ms, cuDNN GRU backward {rec['library_ms']:.4f} ms, "
        f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return rec


def phase_bwd_kernels(dev) -> list:
    return [
        check_rnn_bwd("GRU", TRAIN_ROWS, QUERY_LEN, 11, dev, timed=True),  # query tower
        check_rnn_bwd("GRU", 2 * TRAIN_ROWS, DOC_LEN, 12, dev, timed=True),  # doc tower
        check_rnn_bwd("LSTM", SERVE_ROWS, QUERY_LEN, 13, dev, timed=False),
        check_rnn_bwd("RNN", SERVE_ROWS, QUERY_LEN, 14, dev, timed=False),
        check_rnn_bwd_split(TRAIN_ROWS, QUERY_LEN, 15, dev),  # query tower, split mode
        check_rnn_bwd_split(2 * TRAIN_ROWS, DOC_LEN, 16, dev),  # doc tower, split mode
        # the width the JAX package's split plan keeps on its kernel: one dhp row block
        check_rnn_bwd("GRU", TRAIN_ROWS, QUERY_LEN, 17, dev, timed=True, H=WIDE_H),
        # the model axis's GRU step (phase_model_axis): both towers at B=1024
        check_rnn_bwd("GRU", GRU_ROWS, QUERY_LEN, 18, dev, timed=True),
        check_rnn_bwd("GRU", GRU_ROWS, DOC_LEN, 19, dev, timed=True),
        # the training towers with the history in f32 (TTMR_RNN_HISTORY=f32)
        check_rnn_bwd("GRU", TRAIN_ROWS, QUERY_LEN, 33, dev, timed=True, compact=False),
        check_rnn_bwd("GRU", 2 * TRAIN_ROWS, DOC_LEN, 34, dev, timed=True, compact=False),
    ]


def phase_f32_kernels(dev) -> tuple:
    """Both recurrent kernels at f32 compute (COMPUTE_DTYPE float32: every
    product a split bf16 product on the tensor cores) at the reference
    towers' training shapes (GRU H=256, B=64 T=32 and B=128 T=128, W
    resident) and at GRU H=1024 B=64 T=32 (W streamed), each against its
    plain version, twice bit-identical, timed beside cuDNN's f32 layer with
    TF32 off and the split-priced bound. Returns the (forward, backward)
    records and the phase's launch counts."""
    shapes = [(TRAIN_ROWS, QUERY_LEN, H, 41), (2 * TRAIN_ROWS, DOC_LEN, H, 42),
              (TRAIN_ROWS, QUERY_LEN, WIDE_H, 43)]
    zero_counts()
    with torch.inference_mode():
        fwd = [check_rnn("GRU", B, T, seed, dev, timed=True, H=h, compute="float32")
               for B, T, h, seed in shapes]
    bwd = [check_rnn_bwd("GRU", B, T, seed + 10, dev, timed=True, H=h, compute="float32")
           for B, T, h, seed in shapes]
    return fwd, bwd, read_counts()


def phase_wide_kernels(dev) -> tuple:
    """The widths the JAX package keeps on its Pallas kernels that clusters
    of 8 do not hold, at the query encode's B=16, T=32 (bf16, bf16
    history), each against its plain version and twice bit-identical, with
    its layout (the cluster size and the card's count of such clusters, the
    W ring's stages and the row blocks) and timed beside cuDNN: GRU H=1792
    and LSTM H=1536 backward (the dhp row block exchanged in chunks), RNN
    H=3072 both passes (W streamed through the ring). Then the widths a
    user reaches by widening the reference towers (HIDDEN_DIM 512 or 1024),
    where W streams or sits in clusters of 16: GRU H=512 and H=1024
    forward at the training query tower's B=64, H=1024 at the query
    encode's B=16, and the H=512 backward at B=64. Returns the (forward,
    backward) records and the phase's launch counts."""
    zero_counts()
    with torch.inference_mode():
        fwd = [check_rnn("RNN", SERVE_ROWS, QUERY_LEN, 21, dev, timed=True, H=3072),
               check_rnn("GRU", TRAIN_ROWS, QUERY_LEN, 25, dev, timed=True, H=512),
               check_rnn("GRU", TRAIN_ROWS, QUERY_LEN, 26, dev, timed=True, H=1024),
               check_rnn("GRU", SERVE_ROWS, QUERY_LEN, 27, dev, timed=True, H=1024)]
    bwd = [check_rnn_bwd("GRU", SERVE_ROWS, QUERY_LEN, 22, dev, timed=True, H=1792),
           check_rnn_bwd("LSTM", SERVE_ROWS, QUERY_LEN, 23, dev, timed=True, H=1536),
           check_rnn_bwd("RNN", SERVE_ROWS, QUERY_LEN, 24, dev, timed=True, H=3072),
           check_rnn_bwd("GRU", TRAIN_ROWS, QUERY_LEN, 28, dev, timed=True, H=512)]
    return fwd, bwd, read_counts()


def phase_large_batch(dev) -> tuple:
    """The forward at the export batch of a wide GRU (H=1024, B=1024,
    T=128; W streams, the cluster route) against its plain version, twice
    bit-identical and timed beside cuDNN; and the in-batch query tower
    (GRU H=256, B=1024, T=32) and RNN and LSTM at its shape, whose
    large-batch layout (160 rows a cluster, one wave; 8 regions exchanged
    by bulk copies) must give the bits of the cluster route forced to the
    plan it had before (128 rows, two waves; RNN and LSTM also against
    their plain versions, twice bit-identical). Then the backward of both
    in-batch towers (GRU H=256 B=1024, T=32 and T=128: the large-batch
    layout, 96 rows a cluster, two waves) against its plain version, twice
    bit-identical, and in both modes bit for bit the cluster route forced
    to the plan it had before (32 rows, five waves); and split mode at
    T=128 against its plain version, timed. Returns the forward's record,
    the backward's records (the unsplit ones timed in phase_bwd_kernels)
    and the phase's launch counts (the comparisons' launches included)."""
    from twotowermlretrieval_tpu_torch.ops import rnn_scan

    zero_counts()
    with torch.inference_mode():
        rec = check_rnn("GRU", GRU_ROWS, DOC_LEN, 29, dev, timed=True, H=WIDE_H)
        same = {cell: _large_batch_fwd(cell, seed, dev)
                for cell, seed in (("GRU", 9), ("RNN", 38), ("LSTM", 39))}
    rec["query_tower_same_bits_as_cluster_route"] = same["GRU"]
    rec["rnn_lstm_same_bits_as_cluster_route"] = same["RNN"] and same["LSTM"]
    bwd = [_large_batch_bwd(T, seed, dev) for T, seed in ((QUERY_LEN, 35), (DOC_LEN, 36))]
    # split mode (row 4) in the same layout at the in-batch doc tower's shape, timed
    bwd.append(check_rnn_bwd_split(GRU_ROWS, DOC_LEN, 37, dev))
    return rec, bwd, read_counts()


def _large_batch_fwd(cell: str, seed: int, dev) -> bool:
    """The forward at H=256 B=GRU_ROWS T=QUERY_LEN (the in-batch query
    tower's shape) in its large-batch layout (RNN and LSTM also against
    their plain versions, ``check_rnn``), all its outputs against the
    cluster route forced to the plan it had before; each call's route,
    rows, waves and regions logged."""
    from twotowermlretrieval_tpu_torch.ops import rnn_scan

    shape = f"{cell} B={GRU_ROWS} T={QUERY_LEN} H={H}"
    design = _fwd_design(cell, GRU_ROWS, QUERY_LEN, dev)
    check(design["route"] == "large-batch", f"rnn_fwd {shape}: not the large-batch layout")
    if cell != "GRU":  # the GRU query tower's shape is held against its plain version in phase_kernels
        check_rnn(cell, GRU_ROWS, QUERY_LEN, seed, dev, timed=False)
    args = _rnn_inputs(cell, GRU_ROWS, QUERY_LEN, seed, dev, H, "bfloat16")
    kw = dict(compute_dtype="bfloat16", history_in_cdt=True)
    got = rnn_scan.rnn_layer_fwd(cell, *args, **kw)
    plan_fn = rnn_scan.fwd_plan
    rnn_scan.fwd_plan = lambda c, T, B, Hk, D, cdt, hist, slots: rnn_scan._cluster_plan(
        c, B, rnn_scan.kernel_width(Hk), D, 2, slots)
    try:
        cluster = _fwd_design(cell, GRU_ROWS, QUERY_LEN, dev)
        parent = rnn_scan.rnn_layer_fwd(cell, *args, **kw)
    finally:
        rnn_scan.fwd_plan = plan_fn
    same = all(torch.equal(a, b) for a, b in zip((*got[0], *got[1], got[2]),
                                                 (*parent[0], *parent[1], parent[2])))
    check(same, f"rnn_fwd {shape}: the large-batch layout's bits differ from the cluster route's")
    log(f"rnn_fwd {shape}: the large-batch layout ({design['rows']} rows, {design['waves']} "
        f"wave(s), {design['regions']} regions) gives the bits of the cluster route "
        f"({cluster['rows']} rows, {cluster['waves']} waves) in the history"
        + (", the cell history" if cell == "LSTM" else "") + " and h_final")
    return same


def _large_batch_bwd(T: int, seed: int, dev) -> dict:
    """The backward at GRU H=256 B=GRU_ROWS (``check_rnn_bwd``: against its
    plain version, twice bit-identical) in its large-batch layout, and its
    outputs in both modes (dxp, dW and db; dxp and dhp) against the cluster
    route forced to the plan it had before (``_bwd_wide_plan`` finding
    none); each call's route, rows and waves logged."""
    from twotowermlretrieval_tpu_torch.ops import rnn_scan

    design = _bwd_design("GRU", GRU_ROWS, T, dev)
    shape = f"GRU B={GRU_ROWS} T={T} H={H}"
    check(design["route"] == "large-batch", f"rnn_bwd {shape}: not the large-batch layout")
    rec = check_rnn_bwd("GRU", GRU_ROWS, T, seed, dev, timed=False)
    args = _bwd_inputs("GRU", GRU_ROWS, T, seed, dev)
    kw = dict(compute_dtype="bfloat16")

    def both_modes():
        dxps, dw, db = rnn_scan.rnn_layer_bwd("GRU", *args, **kw)
        s_dxps, s_dhps = rnn_scan._bwd_hoisted_call("GRU", *args, **kw)
        return [*dxps, dw, db, *s_dxps, *s_dhps]

    got = both_modes()
    wide_fn = rnn_scan._bwd_wide_plan
    rnn_scan._bwd_wide_plan = lambda *a, **k: None
    try:
        cluster = _bwd_design("GRU", GRU_ROWS, T, dev)
        parent = both_modes()
    finally:
        rnn_scan._bwd_wide_plan = wide_fn
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, parent))
    check(same, f"rnn_bwd {shape}: the large-batch layout's bits differ from the cluster route's")
    log(f"rnn_bwd {shape}: the large-batch layout ({design['rows']} rows, {design['waves']} "
        f"waves) gives the bits of the cluster route ({cluster['rows']} rows, "
        f"{cluster['waves']} waves) in dxp, dW, db and split mode's dxp and dhp")
    return dict(rec, route=design["route"], rows=design["rows"], waves=design["waves"],
                cluster_route_waves=cluster["waves"], same_bits_as_cluster_route=same)


def phase_wide_s8(dev) -> dict:
    """An int8 index at H=WIDE_S8_H (the port's RetrievalIndex, as
    ``ttr-torch-serve --storage-dtype int8`` builds it) over WIDE_S8_ROWS
    rows: unit rows, and a block of 512 built to pass 2^24 (rows of a sign
    pattern p times 0.01 but column 1, 0.01 r / 127, searched by a query of
    p but column 1, 1 / 127: the integer scores 127 * 127 * 1535 + r round
    to even in f32, so neighbouring r tie; the block's own segment scale
    keeps it out of the other queries' results). A dense search of 32 queries launches segmax_s8
    once and nothing else and equals the two-phase path (use_kernel=False)
    bit for bit; the kernel's maxima and cache equal the plain version's at
    B=16 and 32, two calls bit-identical; the fused search with either phase
    2 equals the same search with the plain phase 1. Returns a record."""
    from twotowermlretrieval_tpu_torch.ops.topk import (
        fused_topk_segmax_s8,
        quantize_query_rows,
        s8_phase2,
        segmax_s8,
        segmax_s8_bound,
        segmax_s8_reference,
    )
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    rng = np.random.default_rng(60)
    docs = rng.standard_normal((WIDE_S8_ROWS, WIDE_S8_H)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    pattern = np.where(rng.random(WIDE_S8_H) < 0.5, -1.0, 1.0).astype(np.float32)
    pattern[1] = 1.0
    docs[:512] = 0.01 * pattern
    docs[:512, 1] = 0.01 * rng.integers(0, 128, 512) / np.float32(127.0)
    q = docs[1000:1032] + 0.02 * rng.standard_normal((32, WIDE_S8_H)).astype(np.float32)
    q[0] = pattern
    q[0, 1] = 1.0 / np.float32(127.0)
    index = RetrievalIndex(docs, device=dev, storage_dtype="int8")
    two_phase = RetrievalIndex(docs, device=dev, storage_dtype="int8", use_kernel=False)
    shape = f"B=32 Npad={index._docs.shape[0]} n_valid={WIDE_S8_ROWS} H={WIDE_S8_H} int8 index"
    zero_counts()
    vals, ids = index.search(q, FANOUT)
    launches = read_counts()
    check(launches["segmax_s8"] == 1 and sum(launches.values()) == 1,
          f"wide int8 search {shape} launched {launches}, expected segmax_s8 once")
    r_vals, r_ids = two_phase.search(q, FANOUT)
    check(np.array_equal(ids, r_ids) and np.array_equal(vals, r_vals),
          f"wide int8 search {shape}: the kernel path differs from the two-phase path")
    check(bool((ids[0] < 512).all()) and bool((ids[1:, 0] == np.arange(1001, 1032)).all()),
          f"wide int8 search {shape}: the top ids are not the expected rows")
    values, scales = index._docs, index._scales
    with torch.inference_mode():
        qt = torch.from_numpy(q).to(dev)
        q_i8, q_scale = quantize_query_rows(qt)
        for B in (16, 32):
            _check_s8_bitwise(q_i8[:B], values, 128, f"{shape} B={B}")
        top = float(segmax_s8(q_i8, values, 128)[0].max().item())
        check(top > 2 ** 24, f"segmax_s8 {shape}: the largest score {top} does not pass 2^24")
        for phase2 in ("rescore", "gather"):
            f_vals, f_ids = fused_topk_segmax_s8(qt, values, scales, k=FANOUT,
                                                 n_valid=WIDE_S8_ROWS, phase2=phase2)
            maxima, cache = segmax_s8_reference(q_i8, values, 128, with_cache=phase2 == "gather")
            p_vals, p_ids = s8_phase2(maxima, cache, q_i8, q_scale, values, scales, FANOUT,
                                      WIDE_S8_ROWS, 128)
            check(torch.equal(f_vals, p_vals) and torch.equal(f_ids, p_ids),
                  f"wide int8 top-{FANOUT} {shape} ({phase2}): differs from the plain phase 1")
        plan = s8_layout(32, WIDE_S8_H)
        rec = {"shape": shape, "max_abs_err": 0.0, "bitwise_repeatable": True, "layout": plan,
               "launches": launches, "largest_score": top,
               "ms": time_ms(lambda: segmax_s8(q_i8, values, 128)),
               "library_ms": time_ms(_int_mm_amax(values, q_i8, 128))}
        rec["bound_ms"], rec["bound_by"] = bound(
            *segmax_s8_bound(32, WIDE_S8_H, values.shape[0], 128), PEAK_INT8_OPS)
    log(f"wide int8 index {shape}: one segmax_s8 launch a search, results equal the two-phase "
        f"path bit for bit; kernel bitwise equal to the plain version at B=16 and 32 with and "
        f"without the cache (largest score {top:.0f}, past 2^24); kernel {rec['ms']:.4f} ms, "
        f"_int_mm+amax {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms")
    torch.cuda.empty_cache()
    return rec


def check_attention(B: int, T: int, in_dtype, seed: int, dev, hd: int = TF_HD,
                    heads: int = TF_HEADS) -> tuple:
    """Both attention kernels at B rows of ``heads`` heads (R = B x heads), head width hd,
    bf16 compute, against their plain versions; rows of batch element 0 have
    length 0 (fully masked), 1 has length 1, 2 all of T. Timed beside SDPA
    with the same additive mask (forward, and forward+backward minus
    forward); the kernels' tiles logged. Returns the (forward, backward)
    records."""
    import torch.nn.functional as F

    from twotowermlretrieval_tpu_torch.ops.attention import (
        attention_bound,
        attention_bwd,
        attention_bwd_reference,
        attention_fwd,
        attention_fwd_reference,
        attention_plan,
    )

    R = B * heads
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((R, T, hd), generator=gen, device=dev) for _ in range(4))
    q, k, v = (t.to(in_dtype) for t in (q, k, v))
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
    lengths[:3] = torch.tensor([0, 1, T], device=dev)
    bias = torch.where(torch.arange(T, device=dev)[None, :] < lengths[:, None], 0.0, -1e9)
    bias = bias.repeat_interleave(heads, dim=0)  # [R, T], row b * heads + h
    scale = float(1.0 / np.sqrt(hd))
    args = (q, k, v, bias)
    out = attention_fwd(*args, scale, "bfloat16")
    grads = attention_bwd(*args, do, scale, "bfloat16")
    r_out = attention_fwd_reference(*args, scale, "bfloat16")
    r_grads = attention_bwd_reference(*args, do, scale, "bfloat16")
    torch.cuda.synchronize()
    shape = (f"R={R} (B={B} x {heads} heads) T={T} hd={hd} "
             f"{'bf16' if in_dtype == torch.bfloat16 else 'f32'} in, bf16 compute")
    plan = attention_plan(T, hd, "bfloat16")
    def tile(t):
        return (f"{t['rows']} query rows a block in {t['rows'] // 16 * t['ks']} warps"
                f"{', V staged over K' if t['kv_shared'] else ''}, {t['smem']} bytes")

    log(f"attention tiles, T={T} hd={hd}: forward {tile(plan['fwd'])}; backward "
        f"{tile(plan['dq'])}, then {plan['dkv']['rows']} keys a block "
        f"({plan['dkv']['smem']} bytes)")
    fwd_err = (out - r_out).abs().max().item()
    bwd_err = max((a - b).abs().max().item() for a, b in zip(grads, r_grads))
    fwd_rel = fwd_err / r_out.abs().max().item()
    bwd_rel = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(grads, r_grads))
    # the fully masked rows attend uniformly: each output row is v's mean
    uniform = v[:heads].to(torch.bfloat16).float().mean(dim=1, keepdim=True)
    masked_err = (out[:heads] - uniform).abs().max().item()
    log(f"attention {shape}: |fwd diff| {fwd_err:.3g} ({fwd_rel:.3g} of the scale), "
        f"|bwd diff| {bwd_err:.3g} ({bwd_rel:.3g}), fully masked rows off uniform by "
        f"{masked_err:.3g}")
    check(all(bool(torch.isfinite(t).all()) for t in (out, *grads)),
          f"attention {shape}: non-finite output")
    check(fwd_rel <= ATTN_REL and bwd_rel <= ATTN_REL, f"attention {shape}: off its plain version")
    check(masked_err <= 4 * ATTN_REL * v[:heads].float().abs().max().item(),
          f"attention {shape}: a fully masked row is not uniform")
    # no atomics, a fixed summation order: a second call gives the same bits
    bitwise = (torch.equal(out, attention_fwd(*args, scale, "bfloat16"))
               and all(torch.equal(a, b)
                       for a, b in zip(grads, attention_bwd(*args, do, scale, "bfloat16"))))
    check(bitwise, f"attention {shape}: two calls differ")
    fwd = {"shape": shape, "max_abs_err": fwd_err, "rel_err": fwd_rel, "tiles": plan["fwd"],
           "bitwise_repeatable": bitwise}
    bwd = {"shape": shape, "max_abs_err": bwd_err, "rel_err": bwd_rel,
           "tiles": {"dq": plan["dq"], "dkv": plan["dkv"]}, "bitwise_repeatable": bitwise}
    in_bytes = 2 if in_dtype == torch.bfloat16 else 4
    fwd["ms"] = time_ms(lambda: attention_fwd(*args, scale, "bfloat16"))
    bwd["ms"] = time_ms(lambda: attention_bwd(*args, do, scale, "bfloat16"))
    fwd["plain_ms"] = time_ms(lambda: attention_fwd_reference(*args, scale, "bfloat16"),
                              reps=5, warmup=1)
    bwd["plain_ms"] = time_ms(lambda: attention_bwd_reference(*args, do, scale, "bfloat16"),
                              reps=5, warmup=1)
    # the yardstick: one library call on the same inputs and additive mask
    mask = bias[:, None, :].to(in_dtype)
    with torch.enable_grad():
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)

        fwd["library_ms"] = time_ms(sdpa)
        both = time_ms(lambda: torch.autograd.grad(sdpa(), (ql, kl, vl), do.to(in_dtype)))
    bwd["library_ms"] = both - fwd["library_ms"]
    bwd["library_fwd_bwd_ms"] = both
    for rec, backward in ((fwd, False), (bwd, True)):
        rec["bound_ms"], rec["bound_by"] = bound(*attention_bound(R, T, hd, in_bytes, backward))
    log(f"attention {shape}: forward {fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}, SDPA "
        f"{fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.6f} {fwd['bound_by']}); backward "
        f"{bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, SDPA fwd+bwd - fwd "
        f"{bwd['library_ms']:.4f}, bound {bwd['bound_ms']:.6f} {bwd['bound_by']})")
    del out, grads, r_out, r_grads
    torch.cuda.empty_cache()
    return fwd, bwd


def check_attention_f32(R: int, T: int, hd: int, in_dtype, seed: int, dev) -> tuple:
    """Both attention kernels at f32 compute (the split route: every product
    six mma.sync products of three bf16 pieces) at R rows of T keys and head
    width hd: against their plain versions within ATTN_F32_REL of the
    largest magnitude, a fully masked row uniform, two calls bit-identical;
    timed beside their plain versions, the bf16 route on the same inputs,
    SDPA on the same inputs and additive mask with TF32 off (forward, and
    forward+backward minus forward) and their bound (each product as the bf16
    products its split takes, by its operands' dtypes, at the bf16 rate).
    Returns the (forward, backward) records."""
    import torch.nn.functional as F

    from twotowermlretrieval_tpu_torch.ops.attention import (
        attention_bound,
        attention_bwd,
        attention_bwd_reference,
        attention_fwd,
        attention_fwd_reference,
        attention_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((R, T, hd), generator=gen, device=dev) for _ in range(4))
    q, k, v = (t.to(in_dtype) for t in (q, k, v))
    lengths = torch.randint(1, T + 1, (R,), generator=gen, device=dev)
    lengths[:3] = torch.tensor([0, 1, T], device=dev)
    bias = torch.where(torch.arange(T, device=dev)[None, :] < lengths[:, None], 0.0, -1e9)
    args, scale = (q, k, v, bias), float(1.0 / np.sqrt(hd))
    before = attention_fwd.by_route["split"], attention_bwd.by_route["split"]
    out = attention_fwd(*args, scale, "float32")
    grads = attention_bwd(*args, do, scale, "float32")
    split = (attention_fwd.by_route["split"] - before[0],
             attention_bwd.by_route["split"] - before[1])
    r_out = attention_fwd_reference(*args, scale, "float32")
    r_grads = attention_bwd_reference(*args, do, scale, "float32")
    fwd_err = (out - r_out).abs().max().item()
    bwd_err = max((a - b).abs().max().item() for a, b in zip(grads, r_grads))
    fwd_rel = fwd_err / r_out.abs().max().item()
    bwd_rel = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(grads, r_grads))
    # row 0 has every key masked: it attends uniformly, each output row v's mean
    masked_err = (out[0] - v[0].float().mean(dim=0, keepdim=True)).abs().max().item()
    bitwise = (torch.equal(out, attention_fwd(*args, scale, "float32"))
               and all(torch.equal(a, b)
                       for a, b in zip(grads, attention_bwd(*args, do, scale, "float32"))))
    shape = f"R={R} T={T} hd={hd} {'bf16' if in_dtype == torch.bfloat16 else 'f32'} in, f32 compute"
    plan = attention_plan(T, hd, "float32")
    log(f"attention {shape}: split route, {plan['fwd']['rows']} query rows a block, keys in "
        f"chunks of {plan['fwd']['kc']} ({plan['fwd']['smem']} bytes), then "
        f"{plan['dkv']['rows']} keys a block ({plan['dkv']['smem']} bytes); |fwd diff| "
        f"{fwd_rel:.3g} of the scale, |bwd diff| {bwd_rel:.3g}, the fully masked row off "
        f"uniform by {masked_err:.3g}")
    check(split == (1, 1),
          f"attention {shape}: {split} launches on the split route, expected 1 and 1")
    check(all(bool(torch.isfinite(t).all()) for t in (out, *grads)),
          f"attention {shape}: non-finite output")
    check(fwd_rel <= ATTN_F32_REL and bwd_rel <= ATTN_F32_REL,
          f"attention {shape}: off its plain version")
    check(masked_err <= 4 * ATTN_F32_REL * v[0].float().abs().max().item(),
          f"attention {shape}: a fully masked row is not uniform")
    check(bitwise, f"attention {shape}: two calls differ")
    del out, grads, r_out, r_grads
    recs = []
    in_bytes = 2 if in_dtype == torch.bfloat16 else 4
    for backward, err, rel, kernel, plain, bf16_route in (
            (False, fwd_err, fwd_rel, lambda: attention_fwd(*args, scale, "float32"),
             lambda: attention_fwd_reference(*args, scale, "float32"),
             lambda: attention_fwd(*args, scale, "bfloat16")),
            (True, bwd_err, bwd_rel, lambda: attention_bwd(*args, do, scale, "float32"),
             lambda: attention_bwd_reference(*args, do, scale, "float32"),
             lambda: attention_bwd(*args, do, scale, "bfloat16"))):
        rec = {"shape": shape, "max_abs_err": err, "rel_err": rel, "bitwise_repeatable": bitwise,
               "tiles": {"dq": plan["dq"], "dkv": plan["dkv"]} if backward else plan["fwd"],
               "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=5, warmup=1),
               "bf16_route_ms": time_ms(bf16_route)}
        rec["bound_ms"], rec["bound_by"] = bound(
            *attention_bound(R, T, hd, in_bytes, backward, "float32"))
        recs.append(rec)
    # the yardstick: one library call on the same inputs and additive mask
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the f32 yardstick")
    mask = bias[:, None, :].to(in_dtype)
    with torch.enable_grad():
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)

        recs[0]["library_ms"] = time_ms(sdpa)
        both = time_ms(lambda: torch.autograd.grad(sdpa(), (ql, kl, vl), do.to(in_dtype)))
    recs[1]["library_ms"] = both - recs[0]["library_ms"]
    recs[1]["library_fwd_bwd_ms"] = both
    f, b = recs
    log(f"attention {shape}: forward {f['ms']:.4f} ms (plain {f['plain_ms']:.4f}, bf16 route "
        f"{f['bf16_route_ms']:.4f}, SDPA {f['library_ms']:.4f}, bound {f['bound_ms']:.6f} "
        f"{f['bound_by']}); backward {b['ms']:.4f} ms (plain {b['plain_ms']:.4f}, bf16 route "
        f"{b['bf16_route_ms']:.4f}, SDPA fwd+bwd - fwd {b['library_ms']:.4f}, bound "
        f"{b['bound_ms']:.6f} {b['bound_by']}); bounds count each product's split bf16 "
        f"products at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s")
    torch.cuda.empty_cache()
    return f, b


def phase_attention_kernels(dev) -> dict:
    """The transformer's shapes: the doc tower in training (B=512, T=128,
    the main row), its query tower (T=32), one serving batch (16 rows,
    T=32) and two T=512 cases (hd=32, and hd=64 with V staged over K); each
    with f32 inputs (the f32 residual stream) and with bf16 inputs
    (RESIDUAL_DTYPE bfloat16); then the model axis's (phase_model_axis:
    each rank's TF_HEADS / TP_RANKS local heads of B=512 rows at T=128 and
    T=32, f32 inputs); then f32 compute (the split route) at the doc
    tower's, the query tower's and a serving batch's shapes, at hd=64
    T=512, and at the doc tower's with bf16 inputs."""
    fwd, bwd = [], []
    with torch.no_grad():
        for in_dtype in (torch.float32, torch.bfloat16):
            for i, (B, T, hd) in enumerate(((TF_ROWS, DOC_LEN, TF_HD), (TF_ROWS, QUERY_LEN, TF_HD),
                                            (SERVE_ROWS, QUERY_LEN, TF_HD), (32, 512, TF_HD),
                                            (32, 512, 64))):
                f, b = check_attention(B, T, in_dtype, 30 + i, dev, hd)
                fwd.append(f)
                bwd.append(b)
        for i, T in enumerate((DOC_LEN, QUERY_LEN)):
            f, b = check_attention(TF_ROWS, T, torch.float32, 40 + i, dev, TF_HD,
                                   heads=TF_HEADS // TP_RANKS)
            fwd.append(f)
            bwd.append(b)
        for i, (R, T, hd, in_dtype) in enumerate((
                (TF_ROWS * TF_HEADS, DOC_LEN, TF_HD, torch.float32),
                (TF_ROWS * TF_HEADS, QUERY_LEN, TF_HD, torch.float32),
                (SERVE_ROWS * TF_HEADS, QUERY_LEN, TF_HD, torch.float32),
                (4 * TF_HEADS, 512, 64, torch.float32),
                (TF_ROWS * TF_HEADS, DOC_LEN, TF_HD, torch.bfloat16))):
            f, b = check_attention_f32(R, T, hd, in_dtype, 50 + i, dev)
            fwd.append(f)
            bwd.append(b)
    return {"attention_fwd": fwd, "attention_bwd": bwd}


def check_adam(name: str, dev) -> dict:
    """``csrc/adam.cu`` at a training leaf set of ``tools/bench_adam.py``
    ("gru" or "config5"): for each of ADAM_NORMS, ADAM_STEPS updates through
    the kernel and through the plain loop on the card (``adam.table_for``
    forced to None) from one state with the same gradients; 2 launches an
    update. Then a call of each timed on the state above the clip, and the
    kernel's device time queued for the end."""
    from twotowermlretrieval_tpu_torch.ops import adam
    from twotowermlretrieval_tpu_torch.tools.bench_adam import BYTES_PER_ELEMENT, leaf_params
    from twotowermlretrieval_tpu_torch.train.train_step import (
        apply_clip_and_adam,
        create_train_state,
    )
    from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

    params, cfg = leaf_params(name, dev)
    check(cfg.grad_clip_norm == 1.0, f"adam {name}: the config clips at {cfg.grad_clip_norm}")
    real = adam.table_for

    def loop_update(state, grads):
        adam.table_for = lambda *a, **k: None
        try:
            return apply_clip_and_adam(state, grads, cfg)
        finally:
            adam.table_for = real

    def leaves(state):
        return [(f"{tree} {n}", x.detach())
                for tree, t in (("param", state.trainable), ("mu", state.opt_state["mu"]),
                                ("nu", state.opt_state["nu"]))
                for n, x in named_leaves(t)]

    gen = torch.Generator(device=dev).manual_seed(17)
    worst = 0.0
    for regime, norm in ADAM_NORMS.items():
        kernel = create_train_state(torch.Generator(device=dev), params, cfg)
        loop = create_train_state(torch.Generator(device=dev), params, cfg)
        zero_counts()
        for _ in range(ADAM_STEPS):
            grads = [torch.randn(p.shape, generator=gen, device=dev)
                     for _, p in named_leaves(kernel.trainable)]
            total = torch.sqrt(sum((g * g).sum() for g in grads))
            grads = [g * (norm / total) for g in grads]
            got = float(apply_clip_and_adam(kernel, grads, cfg))
            want = float(loop_update(loop, grads))
            check(abs(got - want) <= ADAM_RTOL * want,
                  f"adam {name} {regime}: the norm {got} against the loop's {want}")
        launches = read_counts()["adam"]
        check(launches == 2 * ADAM_STEPS and int(kernel.opt_state["count"]) == ADAM_STEPS,
              f"adam {name} {regime}: {launches} launches for {ADAM_STEPS} updates, count "
              f"{int(kernel.opt_state['count'])}")
        for (what, x), (_, y) in zip(leaves(kernel), leaves(loop)):
            if regime == "below_clip":
                check(torch.equal(x, y), f"adam {name} below the clip: {what} differs from the "
                      f"card loop's")
            else:
                diff = (x - y).abs()
                check(bool((diff <= ADAM_ATOL + ADAM_RTOL * y.abs()).all()),
                      f"adam {name} above the clip: {what} off the card loop's by "
                      f"{float(diff.max()):.3g}")
                worst = max(worst, float(diff.max()))
    elements = sum(p.numel() for _, p in named_leaves(kernel.trainable))
    shape = f"{name}: {len(named_leaves(kernel.trainable))} leaves, {elements} elements"
    rec = {"shape": shape, "max_abs_err": worst, "launches": launches,
           "ms": time_ms(lambda: apply_clip_and_adam(kernel, grads, cfg)),
           "plain_ms": time_ms(lambda: loop_update(loop, grads)),
           "library_ms": None}  # no library call clips by the global norm then runs optax's Adam
    rec["bound_ms"], rec["bound_by"] = bound(BYTES_PER_ELEMENT * elements, 0)
    later_on_card(rec, "device_ms", lambda: apply_clip_and_adam(kernel, grads, cfg))
    log(f"adam {shape}: below the clip bit for bit the card loop, above it within "
        f"{worst:.3g}; {launches} launches for {ADAM_STEPS} updates; {rec['ms']:.4f} ms a call, "
        f"the loop {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms (bytes)")
    return rec


def phase_adam(dev) -> list:
    """The clip and Adam at both training leaf sets (``check_adam``)."""
    return [check_adam("gru", dev), check_adam("config5", dev)]


# ---------------------------------------------------------------------------
# phase 4: a synthetic artifact directory at full width
# ---------------------------------------------------------------------------


def make_corpus(seed: int):
    """(vocabulary, word table, passages, triplets): PASSAGES passages of
    24-159 words (some beyond the 128-token cut) drawn Zipf-like from the
    vocabulary, and one query per (positive, negative) pair made from the
    positive's first words."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(VOCAB - 1)] + ["<UNK>"])
    table = (rng.standard_normal((VOCAB, EMBED), dtype=np.float32) * 0.4)
    lengths = rng.integers(24, 160, PASSAGES)
    ids = (rng.zipf(1.2, int(lengths.sum())) - 1) % (VOCAB - 1)
    ends = np.cumsum(lengths)
    passages = [" ".join(words[ids[e - n : e]]) for e, n in zip(ends, lengths)]
    triplets = [
        (" ".join(passages[2 * i].split()[:6]), passages[2 * i], passages[2 * i + 1])
        for i in range(PASSAGES // 2)
    ]
    return {w: i for i, w in enumerate(words.tolist())}, table, passages, triplets


def phase_export(dev):
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.encoder import TextEncoder
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer
    from twotowermlretrieval_tpu_torch.train.artifacts import save_inference_artifacts

    t0 = time.perf_counter()
    word_to_idx, table, passages, triplets = make_corpus(0)
    tok = Tokenizer(word_to_idx)
    check(tok.vocab_size() == VOCAB, "the vocabulary holds the <UNK> row")
    # hidden_dim is the default; every other field is the reference's too
    cfg = Config(vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=H)
    spec = TwoTowerSpec.from_config(cfg)
    params = init_two_tower(torch.Generator().manual_seed(0), spec, pretrained_embeddings=table)
    log(f"corpus: {len(passages)} passages, {len(triplets)} triplets, "
        f"{time.perf_counter() - t0:.1f} s")

    if ARTIFACTS.exists():
        shutil.rmtree(ARTIFACTS)
    zero_counts()
    t0 = time.perf_counter()
    save_inference_artifacts(ARTIFACTS, params, cfg, tok, {"train": triplets}, device=dev)
    export_s = time.perf_counter() - t0
    export_launches = read_counts()
    batches = -(-PASSAGES // EXPORT_ROWS)
    log(f"export: {export_s:.1f} s, launches {export_launches} "
        f"({batches} doc batches of {EXPORT_ROWS} x {DOC_LEN}, 2 layers)")
    check(export_launches["rnn_fwd"] == 2 * batches, "export: one rnn launch per layer and batch")

    emb = np.load(ARTIFACTS / "document_embeddings.npy")
    check(emb.shape == (PASSAGES, H) and emb.dtype == np.float32, f"embeddings {emb.shape}")
    check(bool(np.isfinite(emb).all()), "embeddings: non-finite values")
    check(np.abs(np.linalg.norm(emb, axis=1) - 1).max() < 1e-3, "embeddings are not unit rows")
    # the doc tower on the CPU (plain versions of the kernels) on the first
    # passages gives the same embeddings
    ref = TextEncoder(params, spec, tok, max_doc_len=DOC_LEN, device="cpu")
    cpu = ref.encode_documents(passages[:128])
    err = float(np.abs(cpu - emb[:128]).max())
    log(f"export: doc embeddings vs the CPU doc tower: |diff| {err:.3g}")
    check(err <= EMBED_ATOL, f"doc embeddings off by {err}")
    return {"export_s": export_s, "launches": export_launches, "embed_err": err}, (
        word_to_idx, table, triplets)


# ---------------------------------------------------------------------------
# phase 5: serve /search over HTTP
# ---------------------------------------------------------------------------

_RESULT_KEYS = {"rank", "id", "doc", "score", "dense_score", "tfidf_score"}


def _post(url: str, payload: dict):
    req = urllib.request.Request(
        url + "/search", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = json.loads(resp.read())
        return resp.status, body, (time.perf_counter() - t0) * 1e3


def _get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _same_results(got, want, tol: float) -> bool:
    """Same documents in the same order up to near-ties within ``tol``."""
    if len(got) != len(want):
        return False
    gs = np.array([r["score"] for r in got])
    ws = np.array([r["score"] for r in want])
    if len(gs) and np.abs(gs - ws).max() > tol:
        return False
    by_doc = {r["doc"]: r for r in want}
    for r in got:
        twin = by_doc.get(r["doc"])
        if twin is None:  # cut off at the boundary by a near-tie
            if r["score"] > ws[-1] + tol:
                return False
            continue
        if any(abs(r[k] - twin[k]) > tol for k in ("score", "dense_score", "tfidf_score")):
            return False
    return True


def _requests(triplets):
    return [
        {"query": triplets[0][0], "alpha": 0.5},
        {"query": triplets[1][0], "alpha": 0.0},
        {"query": triplets[2][0], "alpha": 1.0},
        {"query": triplets[3][0] + " w1 w2", "alpha": 0.5},
        {"query": "nothing in the vocabulary here", "alpha": 0.7},
    ]


def _drive_server(requests, path=None, num_docs=None, **serve_kwargs):
    """The main path: the server as ``ttr-torch-serve --artifacts path``
    starts it (device cuda), driven over HTTP with every launch count at 0
    and read just after. Returns (result record, the server's engine).
    By default it serves the export of phase 4."""
    from twotowermlretrieval_tpu_torch.serve.app import serve

    path, num_docs = path or ARTIFACTS, num_docs or PASSAGES
    zero_counts()
    t0 = time.perf_counter()
    server = serve(str(path), port=0, host="127.0.0.1", **serve_kwargs)
    startup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, health = _get(url, "/health")
        responses = [_post(url, r) for r in requests]
        m_status, metrics = _get(url, "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = read_counts()
    what = (f"serve {Path(path).name} {serve_kwargs.get('storage_dtype', 'bfloat16')}"
            f" {serve_kwargs.get('index_type', 'exact')}")
    log(f"{what}: startup {startup_s:.1f} s, request ms "
        f"{[round(ms, 3) for _, _, ms in responses]}, launches {launches}")
    check(status == 200 and json.loads(health) == {"status": "ok", "num_docs": num_docs},
          f"/health: {status} {health}")
    check(m_status == 200 and f"ttr_searches_total {len(requests)}" in metrics,
          "/metrics does not count the searches")
    rec = {"startup_s": startup_s, "request_ms": [ms for _, _, ms in responses],
           "launches": launches, "responses": responses}
    return rec, server.RequestHandlerClass.engine


def _check_responses(requests, responses, reference, tol: float) -> None:
    """The HTTP contract of every response, and its results against the
    same request through ``reference`` (an engine on the CPU)."""
    for req, (code, body, _) in zip(requests, responses):
        q = req["query"][:40]
        check(code == 200, f"/search {q!r}: HTTP {code}")
        check(body["query"] == req["query"] and body["alpha"] == req["alpha"], "echo")
        results = body["results"]
        check(0 < len(results) <= 10 or req["alpha"] == 0.0, f"{q!r}: {len(results)} results")
        for i, r in enumerate(results):
            check(set(r) == _RESULT_KEYS, f"{q!r}: result keys {sorted(r)}")
            check(r["rank"] == i + 1 and r["id"] == f"result-{i + 1}", f"{q!r}: rank {i}")
            check(all(math.isfinite(r[k]) for k in ("score", "dense_score", "tfidf_score")),
                  f"{q!r}: a non-finite score")
        scores = [r["score"] for r in results]
        check(scores == sorted(scores, reverse=True), f"{q!r}: scores not descending")
        if req["alpha"] == 0.0:
            check(all(r["dense_score"] == 0.0 for r in results), "keyword branch: dense score")
        if req["alpha"] == 1.0:
            check(all(r["score"] == r["dense_score"] for r in results), "alpha 1: pure dense")
        want = reference.search(req["query"], alpha=req["alpha"])["results"]
        check(_same_results(results, want, 0.0 if req["alpha"] == 0.0 else tol),
              f"{q!r} alpha {req['alpha']}: results differ from the CPU engine's")


def phase_serve(dev, triplets) -> dict:
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine

    requests = _requests(triplets)
    rec, _ = _drive_server(requests)  # bf16 corpus, the default
    launches = rec["launches"]
    dense = sum(1 for r in requests if r["alpha"] != 0.0)
    check(launches["rnn_fwd"] == 2 * dense and launches["segmax"] == dense,
          f"serving launched {launches}, expected 2 rnn and 1 segmax per dense search")
    check(launches["rnn_bwd"] == 0 and launches["segmax_s8"] == 0,
          "bf16 serving launched the backward or the int8 scan")
    # the same requests through the port's engine on the CPU (plain versions)
    _check_responses(requests, rec.pop("responses"), SearchEngine(ARTIFACTS, device="cpu"),
                     EMBED_ATOL)
    log(f"serve: {len(requests)} /search responses match the CPU engine")
    return rec


def phase_serve_int8(dev, triplets) -> dict:
    """``ttr-torch-serve --storage-dtype int8``: 2 rnn_fwd and 1 segmax_s8
    launch per dense search and nothing else; results against the port's
    int8 engine on the CPU and, bit for bit, against the same engine on the
    card with use_kernel=False (the two-phase path); then a boot with
    autotune_retrieval persists its choice and a second boot applies it
    without timing."""
    from twotowermlretrieval_tpu_torch.serve import index as index_mod
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine

    requests = _requests(triplets)
    rec, engine = _drive_server(requests, storage_dtype="int8")
    launches = rec["launches"]
    dense = sum(1 for r in requests if r["alpha"] != 0.0)
    check(launches["rnn_fwd"] == 2 * dense and launches["segmax_s8"] == dense,
          f"int8 serving launched {launches}, expected 2 rnn_fwd and 1 segmax_s8 per dense "
          f"search")
    check(all(n == 0 for name, n in launches.items() if name not in ("rnn_fwd", "segmax_s8")),
          f"int8 serving launched another kernel: {launches}")
    _check_responses(requests, rec.pop("responses"),
                     SearchEngine(ARTIFACTS, device="cpu", storage_dtype="int8"), INT8_SERVE_TOL)
    log(f"serve int8: {len(requests)} /search responses match the CPU int8 engine "
        f"(within {INT8_SERVE_TOL})")

    dense_reqs = [{"query": r["query"], "fanout": FANOUT} for r in requests]
    two_phase = SearchEngine(ARTIFACTS, device=dev, storage_dtype="int8", use_kernel=False)
    for (a_s, a_i), (b_s, b_i) in zip(engine._dense_batch(dense_reqs),
                                      two_phase._dense_batch(dense_reqs)):
        check(np.array_equal(a_i, b_i) and np.array_equal(a_s, b_s),
              "int8 dense results: the kernel path differs from the two-phase path")
    log("serve int8: dense results equal the two-phase path's (use_kernel=False) bit for bit")

    tuning = ARTIFACTS / index_mod.RETRIEVAL_TUNING_FILE
    tuning.unlink(missing_ok=True)
    t0 = time.perf_counter()
    tuned = SearchEngine(ARTIFACTS, device=dev, storage_dtype="int8", autotune_retrieval=True)
    rec["autotune_boot_s"] = time.perf_counter() - t0
    saved = json.loads(tuning.read_text())
    check(saved["decision"] == tuned.index.decision()
          and saved["decision_signature"] == tuned.index.tuning_signature()
          and len(saved["timings_ms"]) == 4 and "two_phase" not in saved["timings_ms"]
          and saved["decision"]["use_pallas"] is not False,
          f"autotune record {saved}: a card index times the four fused variants only")
    rec["autotune_ms"] = saved["timings_ms"]

    def no_timing(*a, **k):
        raise SmokeFailure("a boot with a persisted decision ran a timing")

    timer = index_mod.RetrievalIndex._time_variant
    index_mod.RetrievalIndex._time_variant = no_timing
    try:
        again = SearchEngine(ARTIFACTS, device=dev, storage_dtype="int8")
    finally:
        index_mod.RetrievalIndex._time_variant = timer
    check(again.index.decision() == saved["decision"], "the persisted decision was not applied")
    # a record of the two-phase path winning (written by a CPU index) does
    # not take a card index off its kernel
    tuning.write_text(json.dumps({**saved, "decision": {**saved["decision"],
                                                        "use_pallas": False}}))
    off = SearchEngine(ARTIFACTS, device=dev, storage_dtype="int8")
    check(off.index.kernel_on(), "a persisted use_pallas=false took the card index off the kernel")
    for eng in (again, off):
        zero_counts()
        out = eng.search(requests[0]["query"], alpha=0.5)["results"]
        counts = read_counts()
        check(0 < len(out) <= 10, "the tuned engine does not serve")
        check(counts["segmax_s8"] == 1 and counts["rnn_fwd"] == 2
              and sum(counts.values()) == 3,
              f"a dense search after a persisted decision launched {counts}, expected 2 "
              f"rnn_fwd and 1 segmax_s8")
    tuning.unlink()
    log(f"serve int8: autotune boot {rec['autotune_boot_s']:.1f} s chose "
        f"{saved['decision']}; the next boot applied it without timing, and each dense "
        f"search after it launched segmax_s8 once")
    return rec


# ---------------------------------------------------------------------------
# phase 6: train the reference model through the port's training driver
# ---------------------------------------------------------------------------


def _train_config(word_to_idx, table):
    """The reference configuration (Config defaults: two 2-layer
    bidirectional GRU towers, H=256, dropout 0.2, B=64, bf16, a frozen
    table) with the doc-length buckets of configs/msmarco_reference.json,
    reading its word table from TRAIN_DIR; returns it after the driver's
    ``setup`` (the table and vocabulary read back from disk)."""
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.glove import save_embedding_artifacts
    from twotowermlretrieval_tpu_torch.train.loop import setup

    save_embedding_artifacts(TRAIN_DIR, table, word_to_idx)
    cfg = Config(
        embeddings_path=str(TRAIN_DIR / "embeddings.npy"),
        word_to_idx_path=str(TRAIN_DIR / "word_to_idx.pkl"),
        hidden_dim=H, length_buckets=[32, 64, 128], epochs=1,
    )
    check(cfg.batch_size == TRAIN_ROWS and cfg.compute_dtype == "bfloat16"
          and cfg.dropout == 0.2 and cfg.freeze_embeddings, "the reference configuration")
    return setup(cfg)


def _first_batch(cfg, tok, train_triplets) -> np.ndarray:
    """The epoch's first packed batch, as the training loop draws it."""
    from twotowermlretrieval_tpu_torch.data.batching import TripletBatcher, pack_batch

    batcher = TripletBatcher(train_triplets, tok, cfg.batch_size, cfg.max_query_len,
                             cfg.max_doc_len, length_buckets=cfg.length_buckets)
    return pack_batch(next(batcher.batches(seed=cfg.seed + 1000)))


def _step_diff(got: dict, want: dict) -> tuple:
    """|loss diff|, and the per-leaf gradient norm farthest from ``want``'s
    with its relative difference."""
    rels = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            for k in want if k.startswith("grad_norm")}
    worst = max(rels, key=rels.get)
    return abs(got["loss"] - want["loss"]), worst, rels[worst], len(rels)


def _first_step_card_vs_cpu(dev, cfg, params, packed, loss_atol: float, grad_rel: float,
                            what: str, control: str | None = None) -> dict:
    """One train step on the card and one on the CPU (plain versions) from
    the same initial state and packed batch, dropout off: the loss and
    every per-leaf gradient norm within the stated envelope. ``control``, a
    lower compute dtype, runs the same step on the card at that dtype too,
    which must fall outside the envelope against the CPU step."""
    from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, to_device
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state, make_train_step

    cfg = cfg.replace(dropout=0.0, log_param_stats=True)
    runs = [("card", dev, cfg), ("cpu", torch.device("cpu"), cfg)]
    if control is not None:
        runs.append(("control", dev, cfg.replace(compute_dtype=control)))
    out = {}
    for label, where, rcfg in runs:
        step = make_train_step(TwoTowerSpec.from_config(rcfg), rcfg)
        state = create_train_state(torch.Generator(device=where).manual_seed(1),
                                   to_device(params, where), rcfg)
        t0 = time.perf_counter()
        _, m = step(state, unpack_batch(torch.from_numpy(packed).to(where), rcfg.max_query_len))
        out[label] = {k: float(v) for k, v in m.items()}
        log(f"{what} first step on the {'cpu' if label == 'cpu' else 'card'} "
            f"({'the control, ' if label == 'control' else ''}{rcfg.compute_dtype} compute): "
            f"loss {out[label]['loss']:.6f}, {time.perf_counter() - t0:.1f} s")
        del state, step
    card, cpu = out["card"], out["cpu"]
    loss_err, worst, worst_rel, leaves = _step_diff(card, cpu)
    log(f"{what} first step, card against CPU: |loss diff| {loss_err:.3g}; gradient norms "
        f"{leaves}, worst {worst} {worst_rel:.3g} relative ({packed.shape[0]} rows, doc "
        f"width {(packed.shape[1] - cfg.max_query_len - 4) // 2})")
    check(all(math.isfinite(v) for v in card.values()), f"{what} first step: a non-finite metric")
    check(loss_err <= loss_atol, f"{what} first step: loss off by {loss_err}")
    check(worst_rel <= grad_rel, f"{what} first step: {worst} off by {worst_rel}")
    res = {"loss_err": loss_err, "worst_grad_norm_rel": worst_rel, "worst_leaf": worst}
    if control is not None:
        c_loss, c_worst, c_rel, _ = _step_diff(out["control"], cpu)
        log(f"{what} first step, the {control} control on the card against the CPU: |loss diff| "
            f"{c_loss:.3g}, worst {c_worst} {c_rel:.3g} relative (envelope {loss_atol:.3g} and "
            f"{grad_rel:.3g})")
        check(c_loss > loss_atol or c_rel > grad_rel,
              f"{what} first step: the envelope does not tell a {control} step from the CPU's")
        res["control"] = {"compute_dtype": control, "loss_err": c_loss,
                          "worst_grad_norm_rel": c_rel, "worst_leaf": c_worst}
    return res


def phase_first_step(dev, cfg, tok, table, train_triplets, what: str = "train") -> dict:
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower

    params = init_two_tower(torch.Generator().manual_seed(cfg.seed),
                            TwoTowerSpec.from_config(cfg), pretrained_embeddings=table)
    return _first_step_card_vs_cpu(dev, cfg, params, _first_batch(cfg, tok, train_triplets),
                                   STEP_LOSS_ATOL, STEP_GRAD_REL, what)


def phase_first_step_f32_history(dev, cfg, tok, table, train_triplets) -> dict:
    """The first step again with TTMR_RNN_HISTORY=f32 (the saved history
    in f32 under bf16 compute: both recurrent kernels' f32-history
    instantiations), card against CPU in the same envelope; 4 rnn_fwd and
    4 rnn_bwd launches (two layers of each tower). The variable is read at
    every call and restored after."""
    from twotowermlretrieval_tpu_torch.models.rnn import history_in_cdt

    old = os.environ.get("TTMR_RNN_HISTORY")
    os.environ["TTMR_RNN_HISTORY"] = "f32"
    try:
        check(not history_in_cdt(cfg.compute_dtype), "TTMR_RNN_HISTORY=f32 keeps a bf16 history")
        zero_counts()
        first = phase_first_step(dev, cfg, tok, table, train_triplets, "train, f32 history")
        launches = read_counts()
    finally:
        if old is None:
            os.environ.pop("TTMR_RNN_HISTORY", None)
        else:
            os.environ["TTMR_RNN_HISTORY"] = old
    check(launches["rnn_fwd"] == 4 and launches["rnn_bwd"] == 4,
          f"train, f32 history: first step launched {launches}")
    first["launches"] = launches
    return first


def phase_first_step_f32(dev, cfg, tok, table, train_triplets) -> dict:
    """The reference GRU model's first step at COMPUTE_DTYPE float32 (both
    recurrent kernels' split-product route), card against CPU in the f32
    envelope (GRU_F32_STEP_*), with the bf16 step on the card as the control
    that must fall outside it; 4 rnn_fwd and 4 rnn_bwd launches at each
    compute dtype (two layers of each tower)."""
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower

    f32cfg = cfg.replace(compute_dtype="float32")
    params = init_two_tower(torch.Generator().manual_seed(cfg.seed),
                            TwoTowerSpec.from_config(f32cfg), pretrained_embeddings=table)
    zero_counts()
    first = _first_step_card_vs_cpu(dev, f32cfg, params, _first_batch(f32cfg, tok, train_triplets),
                                    GRU_F32_STEP_LOSS_ATOL, GRU_F32_STEP_GRAD_REL, "train f32",
                                    control="bfloat16")
    launches = read_counts()
    check(launches["rnn_fwd"] == 8 and launches["rnn_bwd"] == 8,
          f"train f32: first step and its control launched {launches}")
    first["launches"] = launches
    return first


def _check_checkpoint(ckpt_dir, cfg, table, res, dev, what: str) -> None:
    """The epoch-end checkpoint restores bit for bit on the card."""
    from twotowermlretrieval_tpu_torch.models.two_tower import (
        TwoTowerSpec,
        init_two_tower,
        to_device,
    )
    from twotowermlretrieval_tpu_torch.train.checkpoint import CheckpointManager
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state
    from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

    manager = CheckpointManager(ckpt_dir)
    spec = TwoTowerSpec.from_config(cfg)
    template = create_train_state(
        torch.Generator(device=dev).manual_seed(7),
        to_device(init_two_tower(torch.Generator().manual_seed(99), spec,
                                 pretrained_embeddings=table), dev), cfg)
    restored, position = manager.restore(template)
    state = res["state"]
    trees = [(state.trainable, restored.trainable), (state.frozen, restored.frozen),
             (state.opt_state["mu"], restored.opt_state["mu"]),
             (state.opt_state["nu"], restored.opt_state["nu"])]
    same = all(torch.equal(x, y) for t1, t2 in trees
               for (_, x), (_, y) in zip(named_leaves(t1), named_leaves(t2)))
    same = same and torch.equal(state.opt_state["count"], restored.opt_state["count"])
    same = same and restored.step == state.step == res["steps"]
    same = same and torch.equal(state.generator.get_state(), restored.generator.get_state())
    log(f"{what}: checkpoint step {restored.step}, position {position}: restores bit for bit: "
        f"{same}")
    check(same, f"{what}: the checkpoint does not round-trip")


def _train_main_path(cfg, tok, table, datasets, out_dir, dev, what: str):
    """The training loop behind `ttr-torch-train`, with the counts at 0 just
    before it and read just after: (results, launches, seconds)."""
    from twotowermlretrieval_tpu_torch.train.loop import train_on_datasets

    zero_counts()
    t0 = time.perf_counter()
    res = train_on_datasets(cfg, tok, table, datasets, output_root=out_dir / "artifacts",
                            checkpoint_dir=out_dir / "ckpt", device=dev)
    train_s = time.perf_counter() - t0
    launches = read_counts()
    steps, losses = res["steps"], res["step_losses"]
    log(f"{what}: {steps} steps in one epoch, {train_s:.1f} s with evaluation and export; "
        f"launches {launches}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    log(f"{what}: steady {res['steady_steps_per_sec']:.2f} steps/s, "
        f"{res['steady_examples_per_sec']:.1f} examples/s (after a first group of "
        f"{res['compile_seconds']:.2f} s); epoch {json.dumps(res['epochs'][-1])}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{what}: a non-finite loss")
    _check_checkpoint(out_dir / "ckpt", cfg, table, res, dev, what)
    return res, launches, train_s


def phase_train(dev, corpus) -> dict:
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine

    word_to_idx, table, triplets = corpus
    if TRAIN_DIR.exists():
        shutil.rmtree(TRAIN_DIR)
    cfg, tok, table = _train_config(word_to_idx, table)
    a, b = TRAIN_TRIPLETS, TRAIN_TRIPLETS + VAL_TRIPLETS
    datasets = {"train": triplets[:a], "validation": triplets[a:b],
                "test": triplets[b : b + TEST_TRIPLETS]}
    first = phase_first_step(dev, cfg, tok, table, datasets["train"])
    first_f32 = phase_first_step_f32_history(dev, cfg, tok, table, datasets["train"])
    first_f32c = phase_first_step_f32(dev, cfg, tok, table, datasets["train"])

    res, launches, train_s = _train_main_path(cfg, tok, table, datasets, TRAIN_DIR, dev, "train")
    steps, losses = res["steps"], res["step_losses"]
    check(steps >= 32, f"train: only {steps} steps")
    check(launches["rnn_bwd"] == 4 * steps, f"train: {launches['rnn_bwd']} rnn_bwd launches "
          f"for {steps} steps, expected 4 per step")
    check(launches["adam"] == 2 * steps, f"train: {launches['adam']} clip-and-Adam launches "
          f"for {steps} steps, expected 2 per step")

    # the exported directory serves through the port's engine on the card
    engine = SearchEngine(res["artifacts_dir"], device=dev)
    try:
        out = engine.search(datasets["test"][0][0], alpha=0.5)["results"]
    finally:
        engine.close()
    check(0 < len(out) <= 10 and all(math.isfinite(r["score"]) for r in out),
          "train: the exported directory does not serve")
    log(f"train: the exported directory serves ({len(out)} results)")
    return {"steps": steps, "launches": launches, "train_s": train_s, "first_step": first,
            "first_step_f32_history": first_f32, "first_step_f32": first_f32c,
            "steady_steps_per_sec": res["steady_steps_per_sec"],
            "steady_examples_per_sec": res["steady_examples_per_sec"],
            "loss_first_last": [losses[0], losses[-1]]}, (cfg, tok, table, datasets)


def phase_odd_width(dev, setup) -> dict:
    """The reference model at HIDDEN_DIM = ODD_H: the first train step on
    the card against the CPU (4 forward and 4 backward launches), then an
    export of a small corpus and dense searches on the card against the
    CPU engine."""
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.train.artifacts import save_inference_artifacts

    cfg, tok, table, datasets = setup
    cfg = cfg.replace(hidden_dim=ODD_H)
    what = f"odd width H={ODD_H}"
    params = init_two_tower(torch.Generator().manual_seed(cfg.seed),
                            TwoTowerSpec.from_config(cfg), pretrained_embeddings=table)
    zero_counts()
    first = _first_step_card_vs_cpu(dev, cfg, params, _first_batch(cfg, tok, datasets["train"]),
                                    STEP_LOSS_ATOL, STEP_GRAD_REL, what)
    step = read_counts()
    check(step["rnn_fwd"] == 4 and step["rnn_bwd"] == 4,
          f"{what}: the first step launched {step}, expected 4 rnn_fwd and 4 rnn_bwd")

    out_dir = TRAIN_DIR / "odd_width"
    zero_counts()
    save_inference_artifacts(out_dir, params, cfg, tok, {"train": datasets["train"][:ODD_TRIPLETS]},
                             device=dev)
    export = read_counts()
    docs = np.load(out_dir / "document_embeddings.npy")
    batches = -(-docs.shape[0] // EXPORT_ROWS)
    check(docs.shape[1] == ODD_H and bool(np.isfinite(docs).all()), f"{what}: embeddings")
    check(export["rnn_fwd"] == 2 * batches, f"{what}: the export launched {export}")

    requests = _requests(datasets["train"])
    dense = [r for r in requests if r["alpha"] != 0.0]
    engine = SearchEngine(out_dir, device=dev)
    cpu = SearchEngine(out_dir, device="cpu")
    try:
        zero_counts()
        got = [engine.search(r["query"], alpha=r["alpha"])["results"] for r in dense]
        served = read_counts()
    finally:
        engine.close()
    check(served["rnn_fwd"] == 2 * len(dense) and served["segmax"] == len(dense),
          f"{what}: {len(dense)} dense searches launched {served}")
    for r, results in zip(dense, got):
        want = cpu.search(r["query"], alpha=r["alpha"])["results"]
        check(0 < len(results) <= 10 and _same_results(results, want, EMBED_ATOL),
              f"{what}: /search {r['query'][:40]!r} differs from the CPU engine's")
    log(f"{what}: first step card-vs-CPU {json.dumps(first)}, launches {step}; export of "
        f"{docs.shape[0]} passages launched {export['rnn_fwd']} rnn_fwd; {len(dense)} dense "
        f"searches match the CPU engine, launches {served}")
    return {"first_step": first, "launches": served, "step_launches": step,
            "export_launches": export, "padding": _odd_width_padding_cost(dev)}


def _odd_width_padding_cost(dev) -> dict:
    """What the zero padding costs at ODD_H at the training doc tower's
    shape (GRU D=2 B=128 T=128, bf16): the model pads a layer's weights
    (``pad_layer``, ``pad_units``: W_hh, b_hh and the second layer's W_ih
    and b_ih per direction), so its input projection yields the padded xp
    and no activation is copied; and the forward call at the kernel width
    on that xp."""
    from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
        kernel_width,
        pad_layer,
        pad_units,
        rnn_layer_fwd,
    )

    B, T, G = 2 * TRAIN_ROWS, DOC_LEN, _GATES["GRU"]
    gen = torch.Generator(device=dev).manual_seed(21)
    Hk = kernel_width(ODD_H)
    w_ih = [torch.randn((2 * ODD_H, G * ODD_H), generator=gen, device=dev) for _ in range(2)]
    b_ih = [torch.zeros(G * ODD_H, device=dev) for _ in range(2)]
    w_hh = torch.randn((2, ODD_H, G * ODD_H), generator=gen, device=dev) / math.sqrt(ODD_H)
    b_hh = torch.zeros((2, G * ODD_H), device=dev)

    def pad():
        return (pad_layer("GRU", Hk, w_hh, b_hh),
                [pad_units(x, G, ODD_H, Hk) for x in (*w_ih, *b_ih)])

    (w, b, _), _ = pad()
    xps = [torch.randn((T, B, G * Hk), generator=gen, device=dev) * 0.5 for _ in range(2)]
    mask = torch.ones((T, B), device=dev)
    rec = {
        "shape": f"GRU D=2 B={B} T={T} H={ODD_H} bf16 (kernel width {Hk})",
        "call_ms": time_ms(lambda: rnn_layer_fwd("GRU", xps, mask, w, b, "bfloat16", True)),
        "pad_ms": time_ms(pad),
    }
    log(f"odd width: {rec['shape']}: forward call at the kernel width {rec['call_ms']:.4f} ms; "
        f"padding the layer's weights {rec['pad_ms']:.4f} ms (no activation is padded)")
    return rec


# ---------------------------------------------------------------------------
# phase 7: the transformer tower of config 5, trained and served
# ---------------------------------------------------------------------------


def _transformer_config(word_to_idx, table):
    """configs/transformer_tp.json (6 blocks, H=256, 8 heads, FFN 1024,
    dropout 0.1, in_batch at temperature 0.05, LR 1e-4, B=512, max query
    32, max doc 128, TRIPLET_METRICS false, FREEZE_EMBEDDINGS false, bf16
    compute) on the smoke's word table, with its cuts: MESH_MODEL 1 and
    SHARD_EMBEDDING_TABLE false (one card; the tensor-parallel mesh is not
    ported), CROSS_DEVICE_NEGATIVES moot on one device, FUSED_ATTENTION
    true (the JAX package's own switch, without which it never reaches its
    attention kernel) and one epoch."""
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.glove import save_embedding_artifacts
    from twotowermlretrieval_tpu_torch.train.loop import setup

    save_embedding_artifacts(TF_DIR, table, word_to_idx)
    cfg = Config.from_json(TF_CONFIG).replace(
        embeddings_path=str(TF_DIR / "embeddings.npy"),
        word_to_idx_path=str(TF_DIR / "word_to_idx.pkl"),
        mesh_model=1, shard_embedding_table=False, fused_attention=True, epochs=1,
    )
    check(cfg.tower_type == "transformer" and cfg.hidden_dim == H and cfg.num_layers == 6
          and cfg.num_heads == TF_HEADS and cfg.ffn_dim == 1024 and cfg.dropout == 0.1
          and cfg.loss_type == "in_batch" and cfg.temperature == 0.05 and cfg.lr == 1e-4
          and cfg.batch_size == TF_ROWS and cfg.max_query_len == QUERY_LEN
          and cfg.max_doc_len == DOC_LEN and not cfg.triplet_metrics
          and not cfg.freeze_embeddings and cfg.compute_dtype == "bfloat16",
          "config 5 (configs/transformer_tp.json)")
    return setup(cfg)


def _routes_step(dev, cfg, params, packed, route: str = "mma") -> dict:
    """One full-batch train step from the same state through the attention
    kernels (FUSED_ATTENTION true) and through the torch route
    (FUSED_ATTENTION null), dropout off: the loss difference, and each
    route's step time (a second step, host clock around a synchronized
    step). The kernel route launches 12 forward and 12 backward
    attention kernels per step, all on the kernels' ``route`` ("mma" at
    bf16 compute, "split" at f32)."""
    from twotowermlretrieval_tpu_torch.ops import attention
    from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, to_device
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state, make_train_step

    batch = unpack_batch(torch.from_numpy(packed).to(dev), cfg.max_query_len)
    out = {}
    for name, fused in (("kernels", True), ("torch", None)):
        rcfg = cfg.replace(dropout=0.0, fused_attention=fused)
        step = make_train_step(TwoTowerSpec.from_config(rcfg), rcfg)
        state = create_train_state(torch.Generator(device=dev).manual_seed(1),
                                   to_device(params, dev), rcfg)
        zero_counts()
        _, m = step(state, batch)
        loss = float(m["loss"])
        counts = read_counts()
        by_route = {"attention_fwd": dict(attention.attention_fwd.by_route),
                    "attention_bwd": dict(attention.attention_bwd.by_route)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        out[name] = {"loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
                     "launches": counts, "by_route": by_route}
        del state, step
        torch.cuda.empty_cache()
    k, t = out["kernels"], out["torch"]
    out["loss_diff"] = abs(k["loss"] - t["loss"])
    log(f"transformer ({cfg.compute_dtype} compute) first step at B={packed.shape[0]}: loss "
        f"{k['loss']:.6f} through the kernels, {t['loss']:.6f} through the torch route (|diff| "
        f"{out['loss_diff']:.3g}); second step {k['step_ms']:.1f} ms against "
        f"{t['step_ms']:.1f} ms")
    check(k["launches"]["attention_fwd"] == 12 and k["launches"]["attention_bwd"] == 12,
          f"the kernel route's step launched {k['launches']}, expected 12 attention forward "
          f"and 12 backward")
    check(all(k["by_route"][n][route] == 12 for n in ("attention_fwd", "attention_bwd")),
          f"the kernel route's launches by route {k['by_route']}, expected 12 and 12 on {route}")
    check(t["launches"]["attention_fwd"] == 0 and t["launches"]["attention_bwd"] == 0,
          "the torch route launched an attention kernel")
    check(math.isfinite(k["loss"]) and math.isfinite(t["loss"]), "a non-finite first loss")
    return out


def phase_transformer(dev, corpus) -> dict:
    """Config 5 on one card: the first step against the CPU and the torch
    route, one epoch of TF_TRAIN triplets through the training loop (12 attention
    backward launches per step, no rnn kernel, the checkpoint), then its
    export served over HTTP (6 attention forward + 1 segmax per dense
    search) and checked against the port's CPU engine."""
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.train.artifacts import collect_unique_documents

    word_to_idx, table, triplets = corpus
    cfg, tok, table = _transformer_config(word_to_idx, table)
    a = TRAIN_TRIPLETS + VAL_TRIPLETS + TEST_TRIPLETS  # after the GRU phase's
    b, c = a + TF_TRAIN, a + TF_TRAIN + TF_VAL
    datasets = {"train": triplets[a:b], "validation": triplets[b:c],
                "test": triplets[c : c + TF_TEST]}
    params = init_two_tower(torch.Generator().manual_seed(cfg.seed),
                            TwoTowerSpec.from_config(cfg), pretrained_embeddings=table)
    packed = _first_batch(cfg, tok, datasets["train"])
    first = _first_step_card_vs_cpu(dev, cfg, params, packed[:TF_CPU_ROWS], TF_STEP_LOSS_ATOL,
                                    TF_STEP_GRAD_REL, "transformer")
    routes = _routes_step(dev, cfg, params, packed)
    # the same tower at f32 compute: the attention kernels' split route
    f32cfg = cfg.replace(compute_dtype="float32")
    first_f32 = _first_step_card_vs_cpu(dev, f32cfg, params, packed[:TF_CPU_ROWS],
                                        TF_F32_STEP_LOSS_ATOL, TF_F32_STEP_GRAD_REL,
                                        "transformer f32", control="bfloat16")
    routes_f32 = _routes_step(dev, f32cfg, params, packed, route="split")
    # at B=512 the bf16 kernel route is the control: its loss against the f32 torch route's
    routes_f32["control_loss_diff"] = abs(routes["kernels"]["loss"] - routes_f32["torch"]["loss"])
    log(f"transformer at B={packed.shape[0]}: the split route's loss {routes_f32['loss_diff']:.3g} "
        f"off the f32 torch route's (envelope {TF_F32_STEP_LOSS_ATOL:.3g}); the bf16 kernel "
        f"route's {routes_f32['control_loss_diff']:.3g}")
    check(routes_f32["loss_diff"] <= TF_F32_STEP_LOSS_ATOL,
          f"transformer at f32 compute: the split route's loss off by {routes_f32['loss_diff']}")
    del params

    res, launches, train_s = _train_main_path(cfg, tok, table, datasets, TF_DIR, dev,
                                              "transformer train")
    steps = res["steps"]
    check(steps == TF_TRAIN // TF_ROWS, f"transformer train: {steps} steps")
    check(launches["attention_bwd"] == 12 * steps,
          f"transformer train: {launches['attention_bwd']} attention_bwd launches for {steps} "
          f"steps, expected 6 per step per tower")
    check(launches["attention_fwd"] >= 12 * steps and launches["attention_fwd"] % 6 == 0,
          f"transformer train: {launches['attention_fwd']} attention_fwd launches")
    check(launches["rnn_fwd"] == 0 and launches["rnn_bwd"] == 0,
          "transformer train: a recurrent kernel was launched")
    check(launches["adam"] == 2 * steps, f"transformer train: {launches['adam']} clip-and-Adam "
          f"launches for {steps} steps, expected 2 per step")

    requests = _requests(datasets["train"])
    served, _ = _drive_server(requests, path=res["artifacts_dir"],
                              num_docs=len(collect_unique_documents(datasets)))
    counts = served["launches"]
    dense = sum(1 for r in requests if r["alpha"] != 0.0)
    check(counts["attention_fwd"] == 6 * dense and counts["segmax"] == dense
          and sum(counts.values()) == 7 * dense,
          f"transformer serving launched {counts}, expected 6 attention_fwd and 1 segmax per "
          f"dense search")
    _check_responses(requests, served.pop("responses"),
                     SearchEngine(res["artifacts_dir"], device="cpu"), TF_SERVE_ATOL)
    log(f"serve transformer: {len(requests)} /search responses match the CPU engine")
    return {"steps": steps, "launches": launches, "train_s": train_s, "first_step": first,
            "routes": routes, "first_step_f32": first_f32, "routes_f32": routes_f32,
            "serve": served, "setup": (cfg, tok, table, datasets),
            "steady_steps_per_sec": res["steady_steps_per_sec"],
            "steady_examples_per_sec": res["steady_examples_per_sec"],
            "loss_first_last": [res["step_losses"][0], res["step_losses"][-1]]}


# ---------------------------------------------------------------------------
# data parallel: two ranks on the one card, and a one-rank NCCL world
# ---------------------------------------------------------------------------


def _dp_config(word_to_idx, table):
    """configs/msmarco_inbatch.json with its paths pointed at DP_DIR, after
    the driver's ``setup``; checks the values the phase stands for."""
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.glove import save_embedding_artifacts
    from twotowermlretrieval_tpu_torch.train.loop import setup

    save_embedding_artifacts(DP_DIR, table, word_to_idx)
    splits = {f"{key}_dataset_path": str(DP_DIR / f"ms_marco_{split}.parquet")
              for key, split in (("train", "train"), ("val", "validation"), ("test", "test"))}
    cfg = Config.from_json(DP_CONFIG).replace(
        **splits, embeddings_path=str(DP_DIR / "embeddings.npy"),
        word_to_idx_path=str(DP_DIR / "word_to_idx.pkl"), epochs=1)
    check(cfg.hidden_dim == H and cfg.rnn_type == "GRU" and cfg.num_layers == 2
          and cfg.bidirectional and cfg.compute_dtype == "bfloat16"
          and cfg.loss_type == "in_batch" and not cfg.triplet_metrics
          and cfg.cross_device_negatives and cfg.batch_size == DP_RANKS * 512
          and cfg.mesh_data == -1 and cfg.mesh_model == 1 and cfg.dropout == 0.2,
          "data parallel: configs/msmarco_inbatch.json")
    return setup(cfg)


def _dp_state(cfg, table, dev):
    from twotowermlretrieval_tpu_torch.models.two_tower import (
        TwoTowerSpec,
        init_two_tower,
        to_device,
    )
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state

    params = init_two_tower(torch.Generator().manual_seed(cfg.seed),
                            TwoTowerSpec.from_config(cfg), pretrained_embeddings=table)
    return create_train_state(torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                              to_device(params, dev), cfg)


def _dp_timed_steps(step, state, batches, mesh, dev) -> dict:
    """DP_STEPS train steps over ``batches`` (this rank's rows of each),
    timed together from a synchronized card to a synchronized card."""
    from twotowermlretrieval_tpu_torch.parallel.mesh import put_global

    rows = [put_global(b, mesh, dev) for b in batches]
    real = sum(int(b[:, -1].sum()) for b in batches)  # global real rows
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    losses = []
    for packed in rows:
        state, m = step(state, packed)
        losses.append(m["loss"])
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), "data parallel: a non-finite loss")
    return {"steps_per_sec": len(batches) / seconds, "examples_per_sec": real / seconds,
            "losses": losses}


def dp_rank_main(rank: int, port: int, out: Path) -> int:
    """One rank of phase_data_parallel's pair (``chip_smoke.py --dp-rank``):
    gloo with CUDA tensors on cuda:0, the first step at dropout 0 (rank 0
    saves its gradients), then DP_STEPS steps at the config's dropout with
    the launch counts at 0 just before and read just after, each step's
    gradient all-reduce timed, and every leaf's checksum held against the
    other rank's."""
    import datetime

    import torch.distributed as dist

    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
    from twotowermlretrieval_tpu_torch.ops import rnn_scan
    from twotowermlretrieval_tpu_torch.parallel.distributed import (
        make_sharded_packed_train_step,
        replicas_agree,
        replicate_state,
    )
    from twotowermlretrieval_tpu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
        put_global,
    )
    from twotowermlretrieval_tpu_torch.train.loop import setup
    from twotowermlretrieval_tpu_torch.train.train_step import make_grad_step
    from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device
    from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

    dev = resolve_device("cuda:0")  # raises without a card: a rank never runs on the CPU
    initialize_multihost(f"127.0.0.1:{port}", num_processes=DP_RANKS, process_id=rank,
                         device=dev, backend="gloo", timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(DP_RANKS, 1)
        cfg, _, table = setup(Config.from_json(out / "config.json"))
        spec = TwoTowerSpec.from_config(cfg)
        batches = np.load(out / "batches.npz")
        batches = [batches[f"b{i}"] for i in range(DP_STEPS + 1)]
        state = replicate_state(_dp_state(cfg, table, dev), mesh)

        # the plain versions count their calls: a card wrapper never runs them
        plain = {"rnn_fwd": 0, "rnn_bwd": 0}
        for name, attr in (("rnn_fwd", "rnn_layer_fwd_reference"), ("rnn_bwd", "_bwd_reference")):
            def counted(*a, _fn=getattr(rnn_scan, attr), _name=name, **k):
                plain[_name] += 1
                return _fn(*a, **k)
            setattr(rnn_scan, attr, counted)
        # each step's gradient all-reduce: the largest of its all-reduces
        # (the others: the gather's backward over [B, H], a few scalars)
        reduce_ms = []
        all_reduce = dist.all_reduce
        grad_numel = sum(p.numel() for _, p in named_leaves(state.trainable))

        def timed_all_reduce(t, *a, **k):
            if t.numel() < grad_numel:
                return all_reduce(t, *a, **k)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            work = all_reduce(t, *a, **k)
            torch.cuda.synchronize(dev)
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
            return work

        dist.all_reduce = timed_all_reduce

        cfg0 = cfg.replace(dropout=0.0)
        zero_counts()
        grads, m = make_grad_step(TwoTowerSpec.from_config(cfg0), cfg0, mesh.data_group)(
            state, unpack_batch(put_global(batches[0], mesh, dev), cfg.max_query_len))
        if rank == 0:
            torch.save({"loss": float(m["loss"]), "grads": [g.cpu() for g in grads]},
                       out / "first_step.pt")
        del grads
        reduce_ms.clear()
        step = make_sharded_packed_train_step(spec, cfg, mesh, cfg.max_query_len)
        run = _dp_timed_steps(step, state, batches[1:], mesh, dev)
        launches = read_counts()
        same = replicas_agree({"trainable": state.trainable, "frozen": state.frozen,
                               "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]},
                              mesh)
        result = {"rank": rank, "first_loss": float(m["loss"]), **run,
                  "all_reduce_ms": reduce_ms, "launches": launches, "plain_calls": plain,
                  "replicas_agree": same, "step": state.step,
                  "backend": dist.get_backend(), "device": str(dev)}
    finally:
        dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_logged(cmds, logs, env, what: str) -> None:
    """Start every command at once, each writing to its own log file (not
    a pipe: a rank blocked on a full pipe would stall the other's
    collectives), wait until all have ended, one has failed (the other
    rank would wait in a collective) or DP_WAIT_S has passed, kill what is
    left, and fail on any exit code but 0."""
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                                              cwd=ROOT))
        deadline = time.monotonic() + DP_WAIT_S
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c for c in codes if c is not None):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for p, path in zip(procs, logs):
        if p.returncode != 0:
            for line in Path(path).read_text().splitlines()[-40:]:
                log(f"{what} ({Path(path).name}): {line}")
        check(p.returncode == 0, f"{what}: {Path(path).name} exited {p.returncode}")


def _dp_nccl_train(triplets) -> dict:
    """``ttr-torch-train`` (train/loop.py:main) as torchrun starts one rank:
    RANK 0, WORLD_SIZE 1, NCCL on the card, MESH_DATA -1 (a 1x1 mesh: the
    single-device path) with the phase's config (``DP_DIR/config.json``)
    over parquet splits of the corpus."""
    import pandas as pd

    for split, cut in DP_NCCL_SPLITS.items():  # one passage a query: one triplet a row
        rows = [{"query": q, "passages.passage_text": [p], "passages.is_selected": [1]}
                for q, p, _ in triplets[cut]]
        pd.DataFrame(rows).to_parquet(DP_DIR / f"ms_marco_{split}.parquet")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    log_path = DP_DIR / "nccl_train.log"
    t0 = time.perf_counter()
    _run_logged([[sys.executable, "-m", "twotowermlretrieval_tpu_torch.train.loop",
                  "--config", str(DP_DIR / "config.json"),
                  "--output", str(DP_DIR / "nccl_artifacts")]], [log_path], env,
                "ttr-torch-train under torchrun's variables")
    seconds = time.perf_counter() - t0
    text = log_path.read_text()
    check("torch.distributed: backend nccl, rank 0 of 1" in text,
          "ttr-torch-train: the NCCL world did not start")
    finished = [line for line in text.splitlines() if line.startswith("training finished:")]
    check(bool(finished), "ttr-torch-train: no 'training finished' line")
    rate = float(finished[-1].split()[2])
    check(rate > 0 and "artifacts:" in text, f"ttr-torch-train: {finished[-1]}")
    log(f"ttr-torch-train, one NCCL rank (MESH_DATA -1, a 1x1 mesh): {finished[-1]}, "
        f"{seconds:.1f} s with start, evaluation and export")
    return {"examples_per_sec": rate, "seconds": seconds}


def phase_data_parallel(dev, corpus) -> dict:
    """configs/msmarco_inbatch.json over two ranks of 512 rows on the one
    card (gloo with CUDA tensors; NCCL refuses two ranks on one device):
    the first step against one process's over the same 1024 rows, both
    ranks' parameters bit for bit equal after DP_STEPS steps at dropout
    0.2, both ranks launching rnn_fwd and rnn_bwd and never the plain
    versions; then ttr-torch-train in a one-rank NCCL world. The pair's
    steps/s stand beside one process's at B=1024: two processes share one
    card, so they measure correctness, not scaling."""
    from twotowermlretrieval_tpu_torch.data.batching import TripletBatcher, pack_batch, unpack_batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
    from twotowermlretrieval_tpu_torch.train.train_step import make_grad_step, make_train_step
    from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

    word_to_idx, table, triplets = corpus
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    cfg, tok, table = _dp_config(word_to_idx, table)
    cfg.to_json(DP_DIR / "config.json")
    batcher = TripletBatcher(triplets[DP_TRIPLETS], tok, cfg.batch_size, cfg.max_query_len,
                             cfg.max_doc_len, length_buckets=cfg.length_buckets)
    it = batcher.batches(seed=cfg.seed + 1000)
    batches = [pack_batch(next(it)) for _ in range(DP_STEPS + 1)]
    np.savez(DP_DIR / "batches.npz", **{f"b{i}": b for i, b in enumerate(batches)})

    # one process over the same global batches
    spec = TwoTowerSpec.from_config(cfg)
    state = _dp_state(cfg, table, dev)
    names = [n for n, _ in named_leaves(state.trainable)]
    cfg0 = cfg.replace(dropout=0.0)
    grads, m = make_grad_step(TwoTowerSpec.from_config(cfg0), cfg0)(
        state, unpack_batch(torch.from_numpy(batches[0]).to(dev), cfg.max_query_len))
    one_loss, one_grads = float(m["loss"]), [g.float().cpu() for g in grads]
    del grads
    raw = make_train_step(spec, cfg)
    single = _dp_timed_steps(lambda st, p: raw(st, unpack_batch(p, cfg.max_query_len)), state,
                             batches[1:], None, dev)
    del state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    port = _free_port()
    _run_logged([[sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", str(r),
                  "--dp-port", str(port), "--dp-dir", str(DP_DIR)] for r in range(DP_RANKS)],
                [DP_DIR / f"rank{r}.log" for r in range(DP_RANKS)], dict(os.environ),
                "data parallel")
    pair_s = time.perf_counter() - t0
    ranks = [json.loads((DP_DIR / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
    first = torch.load(DP_DIR / "first_step.pt", weights_only=True)
    loss_rel = abs(first["loss"] - one_loss) / abs(one_loss)
    rels = {n: float(torch.linalg.vector_norm(g.float() - g1)
                     / torch.linalg.vector_norm(g1).clamp_min(1e-30))
            for n, g, g1 in zip(names, first["grads"], one_grads)}
    worst = max(rels, key=rels.get)
    log(f"data parallel first step, 2 ranks x 512 rows against 1 process x 1024 (dropout 0): "
        f"loss {first['loss']:.7f} against {one_loss:.7f} ({loss_rel:.3g} relative); "
        f"{len(rels)} gradient leaves, worst {worst} {rels[worst]:.3g} of its norm")
    check(loss_rel <= DP_LOSS_REL, f"data parallel first step: loss off by {loss_rel:.3g}")
    check(rels[worst] <= DP_GRAD_REL, f"data parallel first step: {worst} off by {rels[worst]}")
    for r in ranks:
        check(r["device"] == "cuda:0" and r["backend"] == "gloo" and r["step"] == DP_STEPS,
              f"data parallel rank {r['rank']}: {r['device']} {r['backend']} step {r['step']}")
        check(r["replicas_agree"], f"data parallel rank {r['rank']}: the replicas differ after "
              f"{DP_STEPS} steps at dropout {cfg.dropout}")
        launches = r["launches"]
        check(launches["rnn_fwd"] > 0 and launches["rnn_bwd"] == 4 * (DP_STEPS + 1),
              f"data parallel rank {r['rank']}: launches {launches}, expected 4 rnn_bwd a step")
        check(r["plain_calls"] == {"rnn_fwd": 0, "rnn_bwd": 0},
              f"data parallel rank {r['rank']}: the plain versions ran {r['plain_calls']}")
    check(ranks[0]["losses"] == ranks[1]["losses"], "data parallel: the ranks' losses differ")
    nccl = _dp_nccl_train(triplets)
    return {"single": single, "pair": {k: ranks[0][k] for k in
                                       ("steps_per_sec", "examples_per_sec")},
            "all_reduce_ms": ranks[0]["all_reduce_ms"], "loss_rel": loss_rel,
            "worst_grad_rel": rels[worst], "worst_leaf": worst, "pair_s": pair_s,
            "launches": [r["launches"] for r in ranks], "nccl": nccl}


# ---------------------------------------------------------------------------
# the model axis: config 5 as written over two ranks on the one card
# ---------------------------------------------------------------------------


def _full_batch(cfg, tok, triplets) -> np.ndarray:
    """The first packed batch of the epoch's order whose rows are all real
    (a bucket's last batch is repeat-padded)."""
    from twotowermlretrieval_tpu_torch.data.batching import TripletBatcher, pack_batch

    batcher = TripletBatcher(triplets, tok, cfg.batch_size, cfg.max_query_len,
                             cfg.max_doc_len, length_buckets=cfg.length_buckets)
    for batch in batcher.batches(seed=cfg.seed + 1000):
        packed = pack_batch(batch)
        if packed[:, -1].all():
            return packed
    raise SmokeFailure(f"no full batch of {cfg.batch_size} rows")


def _tp_configs(word_to_idx, table):
    """(config 5 as written with FUSED_ATTENTION true and its paths at
    TP_DIR, the GRU towers' sharded-table config, tokenizer, table), after
    the driver's ``setup``; checks the values the phase stands for."""
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.glove import save_embedding_artifacts
    from twotowermlretrieval_tpu_torch.train.loop import setup

    save_embedding_artifacts(TP_DIR, table, word_to_idx)
    paths = dict(embeddings_path=str(TP_DIR / "embeddings.npy"),
                 word_to_idx_path=str(TP_DIR / "word_to_idx.pkl"), epochs=1)
    cfg, tok, table = setup(Config.from_json(TF_CONFIG).replace(fused_attention=True, **paths))
    check(cfg.tower_type == "transformer" and cfg.hidden_dim == H and cfg.num_layers == 6
          and cfg.num_heads == TF_HEADS and cfg.ffn_dim == 1024 and cfg.dropout == 0.1
          and cfg.loss_type == "in_batch" and cfg.batch_size == TF_ROWS
          and not cfg.freeze_embeddings and cfg.compute_dtype == "bfloat16"
          and cfg.mesh_data == -1 and cfg.mesh_model == TP_RANKS and cfg.shard_embedding_table
          and cfg.vocab_size == VOCAB and cfg.embed_dim == EMBED,
          "model axis: config 5 (configs/transformer_tp.json) as written")
    gru, _, _ = setup(Config.from_json(DP_CONFIG).replace(
        freeze_embeddings=False, mesh_model=TP_RANKS, shard_embedding_table=True, **paths))
    check(gru.tower_type == "rnn" and gru.hidden_dim == H and gru.batch_size == GRU_ROWS,
          "model axis: configs/msmarco_inbatch.json")
    return cfg, gru, tok, table


def _whole_state(cfg, table, dev):
    """The full deterministic init every rank builds (and the one process
    holds): params from config.seed, the dropout stream from seed + 1."""
    from twotowermlretrieval_tpu_torch.models.two_tower import (
        TwoTowerSpec,
        init_two_tower,
        to_device,
    )
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state

    params = init_two_tower(torch.Generator().manual_seed(cfg.seed),
                            TwoTowerSpec.from_config(cfg), pretrained_embeddings=table)
    return create_train_state(torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                              to_device(params, dev), cfg)


def _one_process_first_step(cfg, table, packed, dev) -> dict:
    """One process holding the whole model: the first step's loss and
    gradients (by leaf path, on the host) over ``packed``, dropout off."""
    from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
    from twotowermlretrieval_tpu_torch.train.train_step import make_grad_step
    from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

    cfg = cfg.replace(dropout=0.0, mesh_model=1, shard_embedding_table=False)
    state = _whole_state(cfg, table, dev)
    grads, m = make_grad_step(TwoTowerSpec.from_config(cfg), cfg)(
        state, unpack_batch(torch.from_numpy(packed).to(dev), cfg.max_query_len))
    paths = [p for p, _ in named_leaves(state.trainable)]
    out = {"loss": float(m["loss"]), "grads": {p: g.float().cpu() for p, g in zip(paths, grads)}}
    del state, grads
    torch.cuda.empty_cache()
    return out


def _tp_first_step(cfg, table, packed, mesh, dev) -> dict:
    """The pair's first step over ``packed`` (both ranks take every row:
    the data axis holds one rank), dropout off: the loss, the gradients
    gathered whole (by leaf path, on the host) and the launches."""
    from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
    from twotowermlretrieval_tpu_torch.parallel.distributed import (
        gather_params,
        replicate_state,
        rules_for,
    )
    from twotowermlretrieval_tpu_torch.parallel.mesh import put_global
    from twotowermlretrieval_tpu_torch.train.train_step import make_grad_step
    from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

    cfg = cfg.replace(dropout=0.0)
    rules = rules_for(cfg, mesh)
    state = replicate_state(_whole_state(cfg, table, dev), mesh, rules)
    zero_counts()
    grads, m = make_grad_step(TwoTowerSpec.from_config(cfg), cfg, mesh.data_group,
                              mesh.model_group)(
        state, unpack_batch(put_global(packed, mesh, dev), cfg.max_query_len))
    torch.cuda.synchronize(dev)
    launches = read_counts()
    paths = [p for p, _ in named_leaves(state.trainable)]
    whole = gather_params(dict(zip(paths, grads)), rules, mesh.model_group)
    out = {"loss": float(m["loss"]), "grads": {p: g.float().cpu() for p, g in whole.items()},
           "launches": launches}
    del state, grads, whole
    torch.cuda.empty_cache()
    return out


def tp_rank_main(rank: int, port: int, out: Path) -> int:
    """One rank of phase_model_axis's pair (``chip_smoke.py --tp-rank``):
    gloo with CUDA tensors on cuda:0, a 1x2 mesh. Config 5's first step at
    dropout 0 (rank 0 saves the gathered gradients), then TP_STEPS steps
    through the training driver (``train_on_datasets``), each step timed
    with its launches and its model-group all-reduces (count, bytes, ms);
    the replicated leaves' checksums against the other rank's, the sharded
    leaves against this rank's slice of the gathered tree, the gathered
    params saved for the export's check; last, the GRU towers' first step
    over their sharded table."""
    import datetime

    import torch.distributed as dist

    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.ops import attention, rnn_scan
    from twotowermlretrieval_tpu_torch.parallel import distributed as parallel_distributed
    from twotowermlretrieval_tpu_torch.parallel.distributed import (
        gather_params,
        rules_for,
        shard_params,
        state_agrees,
    )
    from twotowermlretrieval_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from twotowermlretrieval_tpu_torch.train.loop import setup, train_on_datasets
    from twotowermlretrieval_tpu_torch.train.train_step import merge_params
    from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device
    from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

    dev = resolve_device("cuda:0")  # raises without a card: a rank never runs on the CPU
    initialize_multihost(f"127.0.0.1:{port}", num_processes=TP_RANKS, process_id=rank,
                         device=dev, backend="gloo", timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(-1, TP_RANKS)
        cfg, tok, table = setup(Config.from_json(out / "config.json"))
        first = np.load(out / "first.npz")

        # the plain versions count their calls: a card wrapper never runs them
        plain = {"attention_fwd": 0, "attention_bwd": 0, "rnn_fwd": 0, "rnn_bwd": 0}
        for module, name, attr in ((attention, "attention_fwd", "attention_fwd_reference"),
                                   (attention, "attention_bwd", "attention_bwd_reference"),
                                   (rnn_scan, "rnn_fwd", "rnn_layer_fwd_reference"),
                                   (rnn_scan, "rnn_bwd", "_bwd_reference")):
            def counted(*a, _fn=getattr(module, attr), _name=name, **k):
                plain[_name] += 1
                return _fn(*a, **k)
            setattr(module, attr, counted)
        # the model group's all-reduces while a step runs: bytes and ms
        reduces, timing = [], [False]
        all_reduce = dist.all_reduce

        def timed_all_reduce(t, *a, **k):
            # the driver builds its own mesh: on 1x2 the model group is the
            # one group of two ranks a step reduces over
            group = k.get("group")
            if not timing[0] or group is None or dist.get_world_size(group) < TP_RANKS:
                return all_reduce(t, *a, **k)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            work = all_reduce(t, *a, **k)
            torch.cuda.synchronize(dev)
            reduces.append((t.numel() * t.element_size(), 1e3 * (time.perf_counter() - t0)))
            return work

        dist.all_reduce = timed_all_reduce

        first_tf = _tp_first_step(cfg, table, first["tf"], mesh, dev)
        if rank == 0:
            torch.save({k: first_tf[k] for k in ("loss", "grads")}, out / "tf_first.pt")
        first_tf.pop("grads")

        # the driver's steps, each timed with its launches and all-reduces
        steps = []
        make_step = parallel_distributed.make_sharded_packed_train_step

        def timed_step_factory(*a, **k):
            step = make_step(*a, **k)

            def timed(state, packed):
                torch.cuda.synchronize(dev)
                before = read_counts()
                reduces.clear()
                timing[0] = True
                t0 = time.perf_counter()
                result = step(state, packed)
                torch.cuda.synchronize(dev)
                ms = 1e3 * (time.perf_counter() - t0)
                timing[0] = False
                after = read_counts()
                steps.append({"ms": ms, "all_reduces": len(reduces),
                              "all_reduce_bytes": sum(b for b, _ in reduces),
                              "all_reduce_ms": sum(t for _, t in reduces),
                              "launches": {n: after[n] - before[n] for n in after}})
                return result

            return timed

        parallel_distributed.make_sharded_packed_train_step = timed_step_factory
        datasets = json.loads((out / "datasets.json").read_text())
        t0 = time.perf_counter()
        res = train_on_datasets(cfg, tok, table, datasets, output_root=out / "artifacts",
                                device=dev)
        driver_s = time.perf_counter() - t0
        parallel_distributed.make_sharded_packed_train_step = make_step
        state = res["state"]
        rules = rules_for(cfg, mesh)
        replicated_agree = state_agrees(state, mesh, rules)
        trees = {"trainable": state.trainable, "mu": state.opt_state["mu"],
                 "nu": state.opt_state["nu"]}
        split = sum(rules(p, t) is not None for tree in trees.values()
                    for p, t in named_leaves(tree))
        shards_match = True
        for name, tree in trees.items():
            gathered = gather_params(tree, rules, mesh.model_group)
            cut = shard_params(gathered, rules, mesh.model_index, mesh.model)
            shards_match &= all(torch.equal(a, b) for (_, a), (_, b)
                                in zip(named_leaves(cut), named_leaves(tree)))
            if name == "trainable":
                params = gather_params(merge_params(state.trainable, state.frozen), rules,
                                       mesh.model_group)
                if rank == 0:
                    torch.save({p: t.cpu() for p, t in named_leaves(params)},
                               out / "tp_params.pt")
                del params
        del state, res["state"]
        torch.cuda.empty_cache()

        gru, _, _ = setup(Config.from_json(out / "gru_config.json"))
        first_gru = _tp_first_step(gru, table, first["gru"], mesh, dev)
        if rank == 0:
            torch.save({k: first_gru[k] for k in ("loss", "grads")}, out / "gru_first.pt")
        first_gru.pop("grads")
        result = {"rank": rank, "first": first_tf, "gru_first": first_gru, "steps": steps,
                  "step_losses": res["step_losses"], "driver_s": driver_s,
                  "artifacts_dir": res.get("artifacts_dir"),
                  "replicated_agree": replicated_agree, "shards_match": shards_match,
                  "split_leaves": split,
                  "replicated_leaves": sum(len(named_leaves(t)) for t in trees.values()) - split,
                  "plain_calls": plain,
                  "backend": dist.get_backend(), "device": str(dev)}
    finally:
        dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    return 0


def _rank_cmds(flag: str, out: Path, ranks: int):
    port = _free_port()
    return [[sys.executable, str(ROOT / "chip_smoke.py"), f"--{flag}-rank", str(r),
             f"--{flag}-port", str(port), f"--{flag}-dir", str(out)] for r in range(ranks)]


def _first_step_against_one(what: str, pair: dict, one: dict, loss_rel: float,
                            grad_rel: float) -> dict:
    """The pair's first step against one process's: the loss relative, and
    each gathered gradient leaf's difference as a share of its norm."""
    rel_loss = abs(pair["loss"] - one["loss"]) / abs(one["loss"])
    check(sorted(pair["grads"]) == sorted(one["grads"]), f"{what}: the gradient leaves differ")
    rels = {n: float(torch.linalg.vector_norm(pair["grads"][n] - g)
                     / torch.linalg.vector_norm(g).clamp_min(1e-30))
            for n, g in one["grads"].items()}
    worst = max(rels, key=rels.get)
    log(f"{what}: loss {pair['loss']:.7f} against one process's {one['loss']:.7f} "
        f"({rel_loss:.3g} relative); {len(rels)} gradient leaves, worst {worst} "
        f"{rels[worst]:.3g} of its norm")
    check(rel_loss <= loss_rel, f"{what}: loss off by {rel_loss:.3g}")
    check(rels[worst] <= grad_rel, f"{what}: {worst} off by {rels[worst]}")
    return {"loss_rel": rel_loss, "worst_grad_rel": rels[worst], "worst_leaf": worst}


def phase_model_axis(dev, corpus) -> dict:
    """Config 5 as written (MESH_MODEL 2, SHARD_EMBEDDING_TABLE true) over
    two ranks on the one card, gloo with CUDA tensors: the first step
    against one process holding the whole model; TP_STEPS steps through the
    training driver at dropout 0.1, each with 12 attention_fwd and 12
    attention_bwd launches a rank at R = B x 4 local heads, its
    model-group all-reduces timed; both ranks' replicated leaves bit for
    bit equal, each rank's shards its slice of the gathered tree; the
    pair's export equal to the gathered params and searched once by the
    single-device engine; then the GRU towers' first step over a sharded
    table against one process's, rnn_fwd and rnn_bwd launched in each
    rank. Two processes share one card: every all-reduce crosses the host,
    so this measures correctness, not scaling."""
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.utils.pytree import flatten_params, load_params_npz

    word_to_idx, table, triplets = corpus
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    cfg, gru, tok, table = _tp_configs(word_to_idx, table)
    cfg.to_json(TP_DIR / "config.json")
    gru.to_json(TP_DIR / "gru_config.json")
    a = TRAIN_TRIPLETS + VAL_TRIPLETS + TEST_TRIPLETS  # the transformer phase's triplets
    b = a + TP_STEPS * TF_ROWS
    datasets = {"train": triplets[a:b], "validation": triplets[b : b + TF_ROWS], "test": []}
    (TP_DIR / "datasets.json").write_text(json.dumps(datasets))
    packed = {"tf": _full_batch(cfg, tok, datasets["train"]),
              "gru": _full_batch(gru, tok, triplets[TP_GRU_TRIPLETS])}
    np.savez(TP_DIR / "first.npz", **packed)
    one_tf = _one_process_first_step(cfg, table, packed["tf"], dev)
    one_gru = _one_process_first_step(gru, table, packed["gru"], dev)

    t0 = time.perf_counter()
    _run_logged(_rank_cmds("tp", TP_DIR, TP_RANKS),
                [TP_DIR / f"rank{r}.log" for r in range(TP_RANKS)], dict(os.environ),
                "model axis")
    pair_s = time.perf_counter() - t0
    ranks = [json.loads((TP_DIR / f"rank{r}.json").read_text()) for r in range(TP_RANKS)]
    first = _first_step_against_one(
        "model axis first step, config 5 over 2 ranks against 1 process (B=512, dropout 0)",
        torch.load(TP_DIR / "tf_first.pt", weights_only=True), one_tf, TP_LOSS_REL,
        TP_GRAD_REL)
    first_gru = _first_step_against_one(
        "model axis first step, GRU towers over a sharded table against 1 process (B=1024)",
        torch.load(TP_DIR / "gru_first.pt", weights_only=True), one_gru, TP_GRU_LOSS_REL,
        TP_GRU_GRAD_REL)
    for r in ranks:
        who = f"model axis rank {r['rank']}"
        check(r["device"] == "cuda:0" and r["backend"] == "gloo",
              f"{who}: {r['device']} {r['backend']}")
        check(len(r["steps"]) == TP_STEPS, f"{who}: {len(r['steps'])} steps")
        for i, st in enumerate(r["steps"]):
            n = st["launches"]
            check(n["attention_fwd"] == 12 and n["attention_bwd"] == 12,
                  f"{who}: step {i} launched {n}, expected 12 attention_fwd and 12 "
                  "attention_bwd")
        n = r["first"]["launches"]
        check(n["attention_fwd"] == 12 and n["attention_bwd"] == 12,
              f"{who}: the first step launched {n}")
        n = r["gru_first"]["launches"]
        check(n["rnn_fwd"] == 4 and n["rnn_bwd"] == 4,
              f"{who}: the GRU first step launched {n}, expected 4 rnn_fwd and 4 rnn_bwd")
        check(r["plain_calls"] == {k: 0 for k in r["plain_calls"]},
              f"{who}: the plain versions ran {r['plain_calls']}")
        check(r["replicated_agree"], f"{who}: the replicated leaves differ after {TP_STEPS} "
              f"steps at dropout {cfg.dropout}")
        check(r["shards_match"], f"{who}: a shard is not its slice of the gathered tree")
        check(all(math.isfinite(x) for x in r["step_losses"]), f"{who}: a non-finite loss")
    check(ranks[0]["step_losses"] == ranks[1]["step_losses"],
          "model axis: the ranks' losses differ")
    steps = ranks[0]["steps"]
    for i, st in enumerate(steps):
        log(f"model axis step {i}: {st['ms']:.1f} ms, {st['all_reduces']} model-group "
            f"all-reduces of {st['all_reduce_bytes'] / 2 ** 30:.3f} GiB in "
            f"{st['all_reduce_ms']:.1f} ms ({100 * st['all_reduce_ms'] / st['ms']:.1f}% of "
            f"the step); rank 1 {ranks[1]['steps'][i]['ms']:.1f} ms")

    # the pair's export: the gathered params, served by one process
    export = Path(ranks[0]["artifacts_dir"])
    check(ranks[1]["artifacts_dir"] is None, "model axis: rank 1 exported")
    saved = torch.load(TP_DIR / "tp_params.pt", weights_only=True)
    exported = flatten_params(load_params_npz(export / "model.npz"))
    check(sorted(exported) == sorted(saved)
          and all(np.array_equal(exported[k], saved[k].numpy()) for k in saved),
          "model axis: model.npz is not the gathered params")
    engine = SearchEngine(export, device=dev)
    zero_counts()
    hit = engine.search(" ".join(datasets["train"][0][0].split()[:4]), alpha=0.5)
    served = read_counts()
    check(served["attention_fwd"] == 6 and served["segmax"] == 1
          and sum(served.values()) == 7,
          f"model axis export: one dense search launched {served}, expected 6 "
          "attention_fwd and 1 segmax")
    check(bool(hit["results"]) and all(math.isfinite(x["score"]) for x in hit["results"]),
          "model axis export: no finite result")
    log(f"model axis: the pair took {pair_s:.1f} s (start, first steps, the driver's "
        f"{TP_STEPS} steps with evaluation and export in {ranks[0]['driver_s']:.1f} s, the GRU "
        f"step); losses {[round(x, 5) for x in ranks[0]['step_losses']]}; "
        f"{ranks[0]['split_leaves']} sharded and {ranks[0]['replicated_leaves']} replicated "
        f"leaves; the export ({len(exported)} leaves) searched: {served}")
    del engine
    torch.cuda.empty_cache()
    return {"first": first, "gru_first": first_gru, "pair_s": pair_s,
            "steps": [r["steps"] for r in ranks],
            "launches": [{k: sum(st["launches"][k] for st in r["steps"])
                          for k in r["steps"][0]["launches"]} for r in ranks],
            "gru_launches": [r["gru_first"]["launches"] for r in ranks],
            "export_search": served}


# ---------------------------------------------------------------------------
# 32 queries at the widest tower widths; the IVF index
# ---------------------------------------------------------------------------


def _int8_rows_on_card(docs):
    """Per-row int8 quantization (``quantize_rows``'s arithmetic) on the card."""
    scales = docs.abs().amax(dim=1) / 127.0
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    values = torch.clamp(torch.round(docs / scales[:, None]), -127, 127).to(torch.int8)
    return values, scales


def _wide_case(name, kernel, plain, lib, nbytes_ops, storage, k, width, q, full, n_valid):
    """One scan at B=32 and the widest tower's width: one launch a call
    (``query_blocks``), its query fragments riding the ring, the result
    against the plain version (WIDE_ATOL; the top-k's ids against the full
    f32 scores), three queries each bit for bit their own one-row launch
    (at bf16 and int8 a launch whose fragments stay resident in shared
    memory: the two routes held against each other), and its times."""
    from twotowermlretrieval_tpu_torch.ops import topk

    counter = getattr(topk, name)
    blocks = topk.query_blocks(name, 32, width, storage, k)
    kind = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8 per row"}[storage]
    shape = (f"B=32 Npad={WIDE_SCAN_ROWS} n_valid={n_valid} H={width} {kind}"
             + ("" if k is None else f" k={k}"))
    before = counter.launches
    got = kernel(q)
    launches = counter.launches - before
    check(launches == len(blocks) == 1 and blocks[0][2]["query_frags"] == "ring",
          f"{name} {shape}: {launches} launches, expected 1 riding the ring; blocks "
          f"{[(b, p['query_frags']) for _, b, p in blocks]}")
    one_route = topk.scan_plan(1, width, storage, k)["query_frags"]
    check(one_route == ("ring" if storage == torch.float32 else "shared memory"),
          f"{name} {shape}: a one-row launch takes the {one_route} route")
    got = (got,) if torch.is_tensor(got) else got
    want = plain()
    want = (want,) if torch.is_tensor(want) else want
    err = (got[0] - want[0]).abs().max().item()
    check(err <= WIDE_ATOL, f"{name} {shape}: off its plain version by {err}")
    if k is not None:
        err = max(err, _check_topk(f"{name} {shape}", got[0], got[1], full, n_valid, WIDE_ATOL))
    for i in (0, 17, 31):
        one = kernel(q[i : i + 1])
        one = (one,) if torch.is_tensor(one) else one
        same = (torch.equal(got[0][:, i], one[0][:, 0]) if k is None else
                torch.equal(got[0][i], one[0][0]) and torch.equal(got[1][i], one[1][0]))
        check(same, f"{name} {shape}: query {i} differs from its own one-row launch")
    rec = {"shape": shape, "max_abs_err": err, "blocks": [b for _, b, _ in blocks],
           "layout": blocks[0][2], "launches": launches, "ms": time_ms(lambda: kernel(q)),
           "plain_ms": time_ms(plain, reps=5, warmup=1), "library_ms": time_ms(lib)}
    rec["bound_ms"], rec["bound_by"] = bound(
        *nbytes_ops, PEAK_SPLIT_FLOPS if storage == torch.float32 else PEAK_BF16_FLOPS)
    plan = blocks[0][2]
    log(f"{name} {shape}: {launches} launch a call ({plan['stages']} stages of "
        f"{plan['stage_bytes']} bytes, {plan['blocks_per_sm']} blocks a SM), |diff| "
        f"{err:.3g}, queries 0, 17, 31 bit for bit their one-row launches ({one_route}); "
        f"kernel {rec['ms']:.4f} ms, plain "
        f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return rec


def phase_wide_batches(dev) -> dict:
    """segmax, segmax_int8 and the running top-k (k=50, over bf16 and
    per-row int8 rows) at B=32 over WIDE_SCAN_ROWS rows at bf16
    H=WIDE_BF16_H (all four) and f32 H=WIDE_F32_H (segmax, top-k): each in
    one launch a call, its query fragments riding the ring, against its
    plain version; past the widest width a launch takes, each wrapper raises
    before any launch. Returns records by kernel name."""
    from twotowermlretrieval_tpu_torch.ops import topk

    recs = {"segmax": [], "segmax_int8": [], "topk_stream": [], "topk_stream_int8": []}
    n_valid = WIDE_SCAN_ROWS - 1001
    with torch.inference_mode():
        for storage, width in ((torch.bfloat16, WIDE_BF16_H), (torch.float32, WIDE_F32_H)):
            gen = torch.Generator(device=dev).manual_seed(width)
            docs32 = _unit_rows_f32(gen, WIDE_SCAN_ROWS, dev, width=width)
            q = _unit_rows_f32(gen, 32, dev, width=width).to(storage)
            docs = docs32.to(storage)
            full = torch.matmul(q.float(), docs.float().T)
            nb = docs.element_size()
            recs["segmax"].append(_wide_case(
                "segmax", lambda qq: topk.segmax(qq, docs, n_valid)[0],
                lambda: topk.segmax_reference(q, docs, n_valid)[0],
                lambda: torch.matmul(docs, q.T).view(-1, 128, 32).amax(dim=1),
                topk.segmax_bound(32, width, WIDE_SCAN_ROWS, nb), storage, None, width, q, None,
                n_valid))
            recs["topk_stream"].append(_wide_case(
                "topk_stream", lambda qq: topk.topk_stream(qq, docs, FANOUT, n_valid),
                lambda: topk.topk_stream_reference(q, docs, FANOUT, n_valid),
                lambda: torch.topk(torch.matmul(q, docs[:n_valid].T).float(), FANOUT),
                topk.topk_stream_bound(32, width, WIDE_SCAN_ROWS, FANOUT, nb), storage, FANOUT,
                width, q, full, n_valid))
            if storage == torch.bfloat16:
                values, scales = _int8_rows_on_card(docs32)
                recs["segmax_int8"].append(_wide_case(
                    "segmax_int8", lambda qq: topk.segmax_int8(qq, values, scales, n_valid),
                    lambda: topk.segmax_int8_reference(q, values, scales, n_valid),
                    lambda: (torch.matmul(values.to(torch.bfloat16), q.T).float()
                             * scales[:, None]).view(-1, 128, 32).amax(dim=1),
                    topk.segmax_int8_bound(32, width, WIDE_SCAN_ROWS), torch.int8, None, width,
                    q, None, n_valid))
                full8 = torch.matmul(q.float(), values.float().T) * scales
                recs["topk_stream_int8"].append(_wide_case(
                    "topk_stream_int8",
                    lambda qq: topk.topk_stream_int8(qq, values, scales, FANOUT, n_valid),
                    lambda: topk.topk_stream_reference(q, values, FANOUT, n_valid, scales),
                    lambda: torch.topk(torch.matmul(q, values[:n_valid].to(torch.bfloat16).T)
                                       .float() * scales[:n_valid], FANOUT),
                    topk.topk_stream_bound(32, width, WIDE_SCAN_ROWS, FANOUT, 1, scaled=True),
                    torch.int8, FANOUT, width, q, full8, n_valid))
                del values, scales, full8
            del docs32, docs, full
            torch.cuda.empty_cache()

        # past the widest width a launch takes: a ValueError naming it, no launch
        counts = read_counts()
        for name, storage, k in (("segmax", torch.bfloat16, None), ("segmax", torch.float32, None),
                                 ("segmax_int8", torch.int8, None),
                                 ("topk_stream", torch.bfloat16, FANOUT),
                                 ("topk_stream_int8", torch.int8, FANOUT)):
            widest = topk.scan_max_h(storage, k)
            width = widest + 16 // torch.tensor([], dtype=storage).element_size()
            d = torch.zeros((256, width), dtype=storage, device=dev)
            qq = torch.zeros((1, width), dtype=torch.bfloat16 if storage == torch.int8 else storage,
                             device=dev)
            call = {"segmax": lambda: topk.segmax(qq, d, 256),
                    "segmax_int8": lambda: topk.segmax_int8(
                        qq, d, torch.ones(256, device=dev), 256),
                    "topk_stream": lambda: topk.topk_stream(qq, d, FANOUT, 256),
                    "topk_stream_int8": lambda: topk.topk_stream_int8(
                        qq, d, torch.ones(256, device=dev), FANOUT, 256)}[name]
            try:
                call()
                raised = ""
            except ValueError as e:
                raised = str(e)
            check(f"up to {widest}" in raised,
                  f"{name} at H={width} {storage}: expected a ValueError naming {widest}, got "
                  f"{raised!r}")
        check(read_counts() == counts, "a wrapper launched past its widest width")
        log("wide batches: past the widest width a launch takes (bf16 "
            f"{topk.scan_max_h(torch.bfloat16)}, f32 {topk.scan_max_h(torch.float32)}, "
            f"int8 rows {topk.scan_max_h(torch.int8)}, bf16 top-{FANOUT} "
            f"{topk.scan_max_h(torch.bfloat16, FANOUT)}, int8 rows top-{FANOUT} "
            f"{topk.scan_max_h(torch.int8, FANOUT)}) each wrapper raises before any launch")
    return recs


def phase_wide_engine(dev, corpus) -> dict:
    """One engine search of 32 coalesced queries (the batch the engine's
    micro-batcher hands ``_dense_batch``) over an index of width
    WIDE_BF16_H: an artifact directory with a one-layer RNN tower of
    HIDDEN_DIM 3360 (random weights from a seed) and PASSAGES random unit
    embeddings beside phase 4's documents, served in bf16. The batch
    launches rnn_fwd once and segmax once (its query fragments riding the
    ring); its results against the two-phase path on the same embeddings
    (one [B, N] product in torch)."""
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.models.two_tower import (
        TwoTowerSpec,
        encode_query,
        init_two_tower,
    )
    from twotowermlretrieval_tpu_torch.ops.topk import query_blocks, topk_segmented
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.utils.pytree import save_params_npz

    word_to_idx, table, triplets = corpus
    art = ARTIFACTS / "wide_rnn"
    art.mkdir(parents=True, exist_ok=True)
    cfg = Config(vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=WIDE_BF16_H, rnn_type="RNN",
                 num_layers=1, bidirectional=False)
    cfg.to_json(art / "config.json")
    save_params_npz(art / "model.npz", init_two_tower(
        torch.Generator().manual_seed(3), TwoTowerSpec.from_config(cfg),
        pretrained_embeddings=table))
    for name in ("word_to_idx.pkl", "documents.pkl", "tfidf_artifacts.pkl"):
        shutil.copy(ARTIFACTS / name, art / name)
    rng = np.random.default_rng(61)
    emb = rng.standard_normal((PASSAGES, WIDE_BF16_H), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    np.save(art / "document_embeddings.npy", emb)
    del emb
    engine = SearchEngine(art, device=dev)
    requests = [{"query": t[0], "fanout": FANOUT} for t in triplets[:32]]
    zero_counts()
    out = engine._dense_batch(requests)
    launches = read_counts()
    blocks = len(query_blocks("segmax", 32, WIDE_BF16_H, torch.bfloat16))
    check(launches["rnn_fwd"] == 1 and launches["segmax"] == blocks == 1
          and sum(launches.values()) == 2,
          f"the wide engine batch launched {launches}, expected 1 rnn_fwd and {blocks} segmax")
    enc = engine.inferencer.encoder
    tokens, lengths = engine.inferencer.tokenizer.encode_batch(
        [r["query"] for r in requests], enc.max_query_len)
    with torch.inference_mode():
        q = encode_query(enc.params, *enc.tensors(tokens, lengths), engine.inferencer.spec)
        docs = engine.index._docs
        qb = q.to(torch.bfloat16)
        full = torch.matmul(qb.float(), docs.float().T)
        r_vals, r_ids = topk_segmented(qb, docs, k=FANOUT, n_valid=PASSAGES)
        vals = torch.from_numpy(np.stack([v for v, _ in out])).to(dev)
        ids = torch.from_numpy(np.stack([i for _, i in out])).to(dev)
        err = max((vals - r_vals).abs().max().item(),
                  _check_topk("wide engine search", vals, ids, full, PASSAGES, WIDE_ATOL))
    check(err <= WIDE_ATOL, f"wide engine search: off the two-phase path by {err}")
    log(f"wide engine search: 32 coalesced queries over {docs.shape[0]} x {docs.shape[1]} bf16 "
        f"rows, launches {launches}, |diff| against the two-phase path {err:.3g}")
    engine.close()
    del engine, docs, full
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err}


def _clustered_corpus(seed: int, n: int, width: int) -> np.ndarray:
    """[n, width] f32 unit rows: IVF_CENTRES Gaussian centres (unit) plus
    IVF_NOISE Gaussian noise a column, made in chunks from ``seed``."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((IVF_CENTRES, width), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    out = np.empty((n, width), np.float32)
    for i in range(0, n, 1 << 18):
        m = min(1 << 18, n - i)
        x = centres[rng.integers(0, IVF_CENTRES, m)]
        x += IVF_NOISE * rng.standard_normal((m, width), dtype=np.float32)
        out[i : i + m] = x / np.linalg.norm(x, axis=1, keepdims=True)
    return out


def phase_ivf(dev) -> dict:
    """The IVF index over SCAN_ROWS x H clustered rows, on the card:
    ``build_ivf`` in bf16 and int8 (default clusters, IVF_ITERS
    iterations, timed), ``pick_nprobe`` at recall@50 >= IVF_RECALL,
    ``ivf_search`` at B=1 and 16 at that nprobe timed with CUDA events
    beside the exact ``fused_topk_segmax`` over the same rows, and the full
    probe of the bf16 index equal to the exact top-50 (the ids' scores
    within SEGMAX_ATOL of the full f32 product's and in its top 50).
    Returns the record and (the bf16 index, the 16 queries, its nprobe)."""
    from twotowermlretrieval_tpu_torch.ops import ivf
    from twotowermlretrieval_tpu_torch.ops.topk import fused_topk_segmax

    t0 = time.perf_counter()
    docs = _clustered_corpus(70, SCAN_ROWS, H)
    log(f"ivf corpus: {SCAN_ROWS} x {H} rows around {IVF_CENTRES} centres, "
        f"{time.perf_counter() - t0:.1f} s on the host")
    docs_bf16 = torch.from_numpy(docs).to(dev).to(torch.bfloat16)
    rng = np.random.default_rng(71)
    q_np = docs[rng.choice(SCAN_ROWS, 16, replace=False)] \
        + IVF_NOISE * rng.standard_normal((16, H), dtype=np.float32)
    q_np /= np.linalg.norm(q_np, axis=1, keepdims=True)
    q = torch.from_numpy(q_np).to(dev)
    rec = {"rows": SCAN_ROWS, "H": H}
    for storage in ("bfloat16", "int8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = ivf.build_ivf(docs, iters=IVF_ITERS, storage_dtype=storage, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(index.docs.is_cuda and index.centroids.is_cuda, "the IVF index left the card")
        ids = index.ids
        real = ids[ids >= 0]
        check(real.numel() == SCAN_ROWS and torch.unique(real).numel() == SCAN_ROWS,
              f"ivf {storage}: the blocks do not partition the corpus")
        t0 = time.perf_counter()
        nprobe, recall = ivf.pick_nprobe(index, docs, k=FANOUT, target_recall=IVF_RECALL)
        pick_s = time.perf_counter() - t0
        C = int(index.centroids.shape[0])
        floor = IVF_RECALL if storage == "bfloat16" else IVF_INT8_RECALL
        check(recall >= floor,
              f"ivf {storage}: recall@{FANOUT} {recall} at nprobe {nprobe} of {C} is below "
              f"{floor}")
        r = {"build_s": build_s, "blocks": C, "cap": index.cap, "nprobe": nprobe,
             "recall": recall, "pick_nprobe_s": pick_s}
        for B in (1, 16):
            r[f"search_ms_b{B}"] = time_ms(lambda: ivf.ivf_search(q[:B], index, FANOUT, nprobe))
            r[f"exact_ms_b{B}"] = time_ms(
                lambda: fused_topk_segmax(q[:B].to(torch.bfloat16), docs_bf16, k=FANOUT))
        log(f"ivf {storage}: build {build_s:.2f} s ({C} blocks x cap {index.cap}, "
            f"{IVF_ITERS} iterations), pick_nprobe {pick_s:.2f} s -> nprobe {nprobe} at "
            f"recall@{FANOUT} {recall:.4f}; ivf_search {r['search_ms_b1']:.4f} ms (B=1), "
            f"{r['search_ms_b16']:.4f} ms (B=16) against exact fused_topk_segmax "
            f"{r['exact_ms_b1']:.4f} / {r['exact_ms_b16']:.4f} ms")
        if storage == "bfloat16":
            vals, got = ivf.ivf_search(q, index, FANOUT, C)
            check(got.is_cuda, "ivf_search left the card")
            full = torch.matmul(q.to(torch.bfloat16).float(), docs_bf16.float().T)
            err = _check_topk("ivf full probe (bf16)", vals, got, full, SCAN_ROWS, SEGMAX_ATOL)
            r["full_probe_err"] = err
            log(f"ivf bf16 full probe (nprobe {C}): the exact top-{FANOUT}, |diff| {err:.3g}")
            del full
        rec[storage] = r
        if storage == "bfloat16":  # phase_sharded_serve splits it over two shards
            kept = (index, q, nprobe)
        del index
        torch.cuda.empty_cache()
    del docs_bf16
    torch.cuda.empty_cache()
    return rec, kept


def phase_serve_ivf(dev, triplets) -> dict:
    """``ttr-torch-build-index --target-recall 0.99`` on phase 4's export,
    then ``ttr-torch-serve --index-type ivf`` (the persisted nprobe) answers
    the five requests: no segmax launch (the IVF route bypasses the scan
    kernels), 2 rnn_fwd per dense search, and each dense top-50 against the
    exact engine's on the same query embedding."""
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.serve.index import load_retrieval_tuning
    from twotowermlretrieval_tpu_torch.tools.build_index import main as build_index

    t0 = time.perf_counter()
    build_index([str(ARTIFACTS), "--target-recall", str(IVF_RECALL)])
    build_s = time.perf_counter() - t0
    tuning = load_retrieval_tuning(ARTIFACTS)
    nprobe, measured = tuning["nprobe"], tuning["nprobe_recall"]["measured"]
    check(tuning["nprobe_signature"]["backend"] == "cuda", "the index was not built on the card")
    requests = _requests(triplets)
    rec, engine = _drive_server(requests, index_type="ivf")
    launches = rec["launches"]
    dense = sum(1 for r in requests if r["alpha"] != 0.0)
    check(engine.index.ivf is not None and engine.index.nprobe == nprobe
          and engine.index.ivf.docs.is_cuda, "the IVF engine did not take the persisted nprobe")
    check(launches["rnn_fwd"] == 2 * dense and sum(launches.values()) == 2 * dense,
          f"ivf serving launched {launches}, expected 2 rnn_fwd per dense search only")
    for code, body, _ in rec.pop("responses"):
        check(code == 200 and all(math.isfinite(r["score"]) for r in body["results"]),
              "ivf /search: a failed response")
    exact = SearchEngine(ARTIFACTS, device=dev)
    recalls = []
    for r in requests:
        if r["alpha"] == 0.0:
            continue
        e = exact.inferencer.get_query_embedding(r["query"])
        _, got = engine.index.search(e, FANOUT)
        _, want = exact.index.search(e, FANOUT)
        recalls.append(len(set(got[0].tolist()) & set(want[0].tolist())) / FANOUT)
    recall = float(np.mean(recalls))
    log(f"serve ivf: ttr-torch-build-index {build_s:.1f} s -> nprobe {nprobe} (measured "
        f"recall@{FANOUT} {measured:.4f}); request ms {[round(ms, 3) for ms in rec['request_ms']]}; "
        f"dense top-{FANOUT} against the exact engine: recall {recalls}, mean {recall:.4f}")
    check(recall >= measured, f"ivf serving recall {recall} below the measured {measured}")
    exact.close()
    engine.close()
    rec.update({"nprobe": nprobe, "measured_recall": measured, "serving_recall": recalls,
                "build_index_s": build_s})
    return rec


# ---------------------------------------------------------------------------
# sharded search: the corpus split over D shards of the one card
# ---------------------------------------------------------------------------


def _score_rel(got, want) -> float:
    """Largest |got - want| / |want| of two score arrays (equal padding
    entries count 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    return float((diff / np.maximum(np.abs(want), 1e-30)).max()) if diff.size else 0.0


def _check_same_search(what, got, want, exact: bool) -> float:
    """(vals, ids) pairs: ids equal, values bit for bit (``exact``) or
    within SHARD_REL relative. Returns the relative difference."""
    g_vals, g_ids = (np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in got)
    w_vals, w_ids = (np.asarray(t.cpu() if torch.is_tensor(t) else t) for t in want)
    check(np.array_equal(g_ids, w_ids), f"{what}: ids differ from one device's")
    rel = _score_rel(g_vals, w_vals)
    check(np.array_equal(g_vals, w_vals) if exact else rel <= SHARD_REL,
          f"{what}: scores off one device's by {rel} relative")
    return rel


def _shard_kernels(docs, f32, s8, values, scales, dev, seed: int) -> dict:
    """The three kernels of the sharded path at one shard's shape (shard
    0's tensors, SERVE_ROWS query rows; segmax over the f32 shard at B =
    SERVE_ROWS and 1 too, whose f32 queries take its f32 route),
    each against its plain version (segmax within SEGMAX_ATOL, segmax_s8
    bit for bit, topk_stream_int8 within INT8_ATOL with its ids against
    the full f32 scores) and timed beside it, its library call and its
    bound."""
    from twotowermlretrieval_tpu_torch.ops.topk import (
        quantize_query_rows,
        segmax,
        segmax_bound,
        segmax_reference,
        segmax_s8,
        segmax_s8_bound,
        segmax_s8_reference,
        topk_stream_bound,
        topk_stream_int8,
        topk_stream_reference,
    )

    q = _unit_rows_f32(torch.Generator(device=dev).manual_seed(seed), SERVE_ROWS, dev)
    qb, (q_i8, _) = q.bfloat16(), quantize_query_rows(q)
    B, rows = SERVE_ROWS, docs.shape[0]

    def f32_case(b):
        qf = q[:b]
        return ("segmax", lambda: segmax(qf, f32, rows)[0],
                lambda: segmax_reference(qf, f32, rows)[0], SEGMAX_ATOL,
                lambda: torch.matmul(f32, qf.T).view(-1, 128, b).amax(dim=1),
                segmax_bound(b, H, rows, 4) + (PEAK_SPLIT_FLOPS,), f"B={b} f32")

    cases = [  # name, kernel, plain version, tolerance, library call, (bytes, ops, peak), what
        ("segmax", lambda: segmax(qb, docs, rows)[0], lambda: segmax_reference(qb, docs, rows)[0],
         SEGMAX_ATOL, lambda: torch.matmul(docs, qb.T).view(-1, 128, B).amax(dim=1),
         segmax_bound(B, H, rows, 2) + (PEAK_BF16_FLOPS,), f"B={B} bf16"),
        f32_case(B),
        f32_case(1),
        ("segmax_s8", lambda: segmax_s8(q_i8, s8)[0], lambda: segmax_s8_reference(q_i8, s8)[0],
         0.0, _int_mm_amax(s8, q_i8, 128),
         segmax_s8_bound(B, H, rows, 128) + (PEAK_INT8_OPS,), f"B={B} int8 seg 128"),
        ("topk_stream_int8", lambda: topk_stream_int8(qb, values, scales, FANOUT, rows),
         lambda: topk_stream_reference(qb, values, FANOUT, rows, scales), INT8_ATOL,
         lambda: torch.topk(torch.matmul(qb, values.to(torch.bfloat16).T).float() * scales,
                            FANOUT),
         topk_stream_bound(B, H, rows, FANOUT, 1, scaled=True) + (PEAK_BF16_FLOPS,),
         f"B={B} int8 per row k={FANOUT}"),
    ]
    recs = {}
    for name, kernel, plain, tol, lib, (nbytes, ops, peak), what in cases:
        shape = f"one shard: Npad={rows} H={H} {what}"
        got, want = kernel(), plain()
        got, want = ((t,) if torch.is_tensor(t) else t for t in (got, want))
        err = (got[0] - want[0]).abs().max().item()
        check(err <= tol, f"{name} {shape}: off its plain version by {err}")
        if name == "topk_stream_int8":
            full = torch.matmul(qb.float(), values.float().T) * scales
            err = max(err, _check_topk(f"{name} {shape}", got[0], got[1], full, rows, tol))
            del full
        rec = {"shape": shape, "max_abs_err": err, "ms": time_ms(kernel),
               "plain_ms": time_ms(plain, reps=5, warmup=1), "library_ms": time_ms(lib)}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, peak)
        log(f"{name} {shape}: |diff| {err:.3g}; kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")
        recs.setdefault(name, []).append(rec)
    return recs


def _padding_only_shards(host, q, dev) -> None:
    """Corpora over 4 shards whose tail shards hold only padding (20 rows
    of bf16 and per-row int8, 8 a shard: the fourth is padding; 1,000 s8
    rows, 1,024 a shard: three are): each search gives one device's ids
    and scores, and a padding-only shard's own search on the kernel route
    returns NEG_INF and id -1."""
    from twotowermlretrieval_tpu_torch.ops.topk import (
        NEG_INF,
        fused_topk_int8,
        fused_topk_segmax,
        fused_topk_segmax_s8,
        quantize_rows,
    )
    from twotowermlretrieval_tpu_torch.parallel.mesh import make_device_mesh
    from twotowermlretrieval_tpu_torch.parallel.topk import (
        distributed_topk_int8,
        shard_corpus_int8,
    )
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    mesh = make_device_mesh(4, 1, [dev] * 4)
    q_np = q.cpu().numpy()
    empty = []
    for storage, rows in (("bfloat16", 20), ("int8", 1000)):
        sharded = RetrievalIndex(host[:rows], storage, mesh=mesh)
        k = min(FANOUT, rows)
        _check_same_search(f"{rows} {storage} rows over 4 shards", sharded.search(q_np, k),
                           RetrievalIndex(host[:rows], storage, device=dev).search(q_np, k),
                           exact=storage == "int8")
        last = sharded._docs[-1]
        if storage == "int8":
            empty.append(fused_topk_segmax_s8(q, last, sharded._scales[-1], k=k, n_valid=0))
        else:
            empty.append(fused_topk_segmax(q.bfloat16(), last, k=min(k, last.shape[0]),
                                           n_valid=0))
    values, scales, n = shard_corpus_int8(host[:20], mesh)
    whole = [torch.from_numpy(a).to(dev) for a in quantize_rows(host[:20])]
    _check_same_search("20 per-row int8 rows over 4 shards",
                       distributed_topk_int8(q, values, scales, 20, mesh, n_valid=n),
                       fused_topk_int8(q, *whole, k=20), exact=False)
    empty.append(fused_topk_int8(q, values[-1], scales[-1], k=8, n_valid=0))
    for vals, ids in empty:
        check(bool((vals == NEG_INF).all() and (ids == -1).all()),
              "a padding-only shard returned a candidate")
    log("sharded search: shards of padding only (20 bf16 / per-row int8 rows, 1,000 s8 rows "
        "over 4 shards) return NEG_INF and -1 on the kernel route; the searches equal one "
        "device's")


def phase_sharded_serve(dev, triplets, ivf_kept) -> dict:
    """The corpus split over D in SHARDS shards of the one card (a device
    list repeating cuda:0), BASELINE config 4's 1,048,576 x 256 unit rows:
    ``RetrievalIndex(mesh=...)`` in f32, bf16 and int8 (``distributed_topk``,
    ``distributed_topk_s8``) and ``distributed_topk_int8`` over per-row int8
    rows, at B=1 and 16, each against one device's search over the same
    rows (ids equal; s8 scores bit for bit, the others within SHARD_REL)
    with the counts at 0: one scan launch a shard (``topk_stream_int8`` one
    a block of query rows a shard) and nothing else. The three kernels at
    each shard shape against their plain versions (``segmax`` over the
    bf16 and the f32 shard); the search times at D
    = 1, 2 and 4 (``tools/bench_sharded_search.py``: the scans, one shard's
    search, the merge); shards of padding only; the phase-IVF index over
    two shards against ``ivf_search``; then the export served over two
    shards in bf16 and int8 (``serve(mesh=...)``), each response the
    single-device engine's ranked docs."""
    from twotowermlretrieval_tpu_torch.ops.ivf import ivf_search
    from twotowermlretrieval_tpu_torch.ops.topk import fused_topk_int8, query_blocks, quantize_rows
    from twotowermlretrieval_tpu_torch.parallel.ivf import distributed_ivf_search, shard_ivf
    from twotowermlretrieval_tpu_torch.parallel.mesh import make_device_mesh
    from twotowermlretrieval_tpu_torch.parallel.topk import (
        distributed_topk_int8,
        shard_corpus_int8,
    )
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex
    from twotowermlretrieval_tpu_torch.tools.bench_sharded_search import search_breakdown

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(80)
    host = _unit_rows_f32(gen, SCAN_ROWS, dev).cpu().numpy()
    q = _unit_rows_f32(gen, SERVE_ROWS, dev)
    q_np = q.cpu().numpy()
    scans = {"float32": "segmax", "bfloat16": "segmax", "int8": "segmax_s8"}
    out = {"rows": SCAN_ROWS, "H": H, "searches": [], "times": [], "kernels": {}}
    with torch.inference_mode():
        whole_int8 = [torch.from_numpy(a).to(dev) for a in quantize_rows(host)]
        one = {st: RetrievalIndex(host, st, device=dev) for st in scans}
        for st in ("bfloat16", "int8"):
            for B in (1, SERVE_ROWS):
                out["times"].append({"storage": st, "shards": 1, "B": B,
                                     **search_breakdown(one[st], q[:B])})
        for D in SHARDS:
            mesh = make_device_mesh(D, 1, [dev] * D)
            sharded = {}
            for st, name in scans.items():
                sharded[st] = index = RetrievalIndex(host, st, mesh=mesh)
                check(len(index._docs) == D and index.kernel_on()
                      and all(t.is_cuda for t in index._docs), f"{st} over {D} shards: placed")
                for B in (1, SERVE_ROWS):
                    zero_counts()
                    got = index.search(q_np[:B], FANOUT)
                    counts = read_counts()
                    check(counts[name] == D and sum(counts.values()) == D,
                          f"{st} over {D} shards at B={B} launched {counts}, expected {D} {name}")
                    rel = _check_same_search(f"{st} over {D} shards at B={B}", got,
                                             one[st].search(q_np[:B], FANOUT), st == "int8")
                    out["searches"].append({"storage": st, "shards": D, "B": B, "rel": rel,
                                            "launches": counts[name]})
                    if st != "float32":
                        out["times"].append({"storage": st, "shards": D, "B": B,
                                             **search_breakdown(index, q[:B])})
            values, scales, n = shard_corpus_int8(host, mesh)
            for B in (1, SERVE_ROWS):
                zero_counts()
                got = distributed_topk_int8(q[:B], values, scales, FANOUT, mesh, n_valid=n)
                counts = read_counts()
                want = D * len(query_blocks("topk_stream_int8", B, H, torch.int8, FANOUT))
                check(counts["topk_stream_int8"] == want and sum(counts.values()) == want,
                      f"per-row int8 over {D} shards at B={B} launched {counts}")
                rel = _check_same_search(f"per-row int8 over {D} shards at B={B}", got,
                                         fused_topk_int8(q[:B], *whole_int8, k=FANOUT), False)
                out["searches"].append({"storage": "int8 per row", "shards": D, "B": B,
                                        "rel": rel, "launches": counts["topk_stream_int8"]})
                out["int8_rows_launches"] = counts  # the last: D=4, B=16
            for name, recs in _shard_kernels(sharded["bfloat16"]._docs[0],
                                             sharded["float32"]._docs[0], sharded["int8"]._docs[0],
                                             values[0], scales[0], dev, 81 + D).items():
                out["kernels"].setdefault(name, []).extend(recs)
            del sharded, index, values, scales
            torch.cuda.empty_cache()
        for r in out["searches"]:
            log(f"sharded {r['storage']} over {r['shards']} shards, B={r['B']}: {r['launches']} "
                f"scan launches, ids equal one device's, scores off by {r['rel']:.3g} relative")
        for t in out["times"]:
            log(f"sharded {t['storage']} D={t['shards']} B={t['B']}: search "
                f"{t['search_ms']:.4f} ms = scans {t['scan_ms']:.4f} + phase 2 "
                f"{t['phase2_ms']:.4f} + merge {t['merge_ms']:.4f} (copies {t['copy_ms']:.4f}); "
                f"one shard's search {t['shard_search_ms']:.4f} ms")
        del one, whole_int8
        torch.cuda.empty_cache()
        _padding_only_shards(host, q, dev)

        index, q_ivf, nprobe = ivf_kept
        mesh = make_device_mesh(2, 1, [dev, dev])
        sharded_ivf = shard_ivf(index, mesh)
        rel = _check_same_search("the phase-IVF index over 2 shards",
                                 distributed_ivf_search(q_ivf, sharded_ivf, FANOUT, nprobe, mesh),
                                 ivf_search(q_ivf, index, FANOUT, nprobe), exact=False)
        out["ivf"] = {"nprobe": nprobe, "rel": rel, "blocks": sharded_ivf.n_blocks,
                      "ms": time_ms(lambda: distributed_ivf_search(q_ivf, sharded_ivf, FANOUT,
                                                                   nprobe, mesh)),
                      "one_device_ms": time_ms(lambda: ivf_search(q_ivf, index, FANOUT, nprobe))}
        log(f"sharded IVF ({sharded_ivf.n_blocks} blocks over 2 shards, nprobe {nprobe}, B=16): "
            f"ivf_search's ids, scores off by {rel:.3g} relative; {out['ivf']['ms']:.4f} ms "
            f"against {out['ivf']['one_device_ms']:.4f} ms on one device")
        del index, sharded_ivf
    del host
    torch.cuda.empty_cache()

    requests = _requests(triplets)
    dense = sum(1 for r in requests if r["alpha"] != 0.0)
    for st, name in (("bfloat16", "segmax"), ("int8", "segmax_s8")):
        rec, engine = _drive_server(requests, storage_dtype=st,
                                    mesh=make_device_mesh(2, 1, [dev, dev]))
        launches = rec["launches"]
        check(len(engine.index._docs) == 2, "the server's index is not split over 2 shards")
        check(launches["rnn_fwd"] == 2 * dense and launches[name] == 2 * dense
              and sum(launches.values()) == 4 * dense,
              f"{st} serving over 2 shards launched {launches}, expected 2 rnn_fwd and 2 {name} "
              f"per dense search")
        single = SearchEngine(ARTIFACTS, device=dev, storage_dtype=st)
        for req, (code, body, _) in zip(requests, rec.pop("responses")):
            want = single.search(req["query"], alpha=req["alpha"])["results"]
            check(code == 200 and [r["doc"] for r in body["results"]] == [r["doc"] for r in want],
                  f"{st} /search over 2 shards {req['query'][:30]!r}: not one device's docs")
            _check_same_search(f"{st} /search over 2 shards",
                               ([r["score"] for r in body["results"]], []),
                               ([r["score"] for r in want], []), exact=st == "int8")
        log(f"serve {st} over 2 shards: {len(requests)} /search responses return the "
            f"single-device engine's ranked docs; request ms "
            f"{[round(ms, 3) for ms in rec['request_ms']]}")
        engine.close()
        single.close()
        out[f"serve_{st}"] = rec
    out["phase_s"] = time.perf_counter() - t0
    log(f"sharded search phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the rest of the JAX package: the native tokenizer, SimpleHybridRetriever,
# the end-to-end demo
# ---------------------------------------------------------------------------

# The JAX package's native-tokenizer cases (tests/test_native.py): unicode
# rows take the Python path inside encode_batch, truncation, punctuation.
NATIVE_TEXTS = [
    "The CAT, sat! on word1 word999 unknownzzz.",
    "",
    "c_d 42 ... ,,, ;;; ???",
    "word1 " * 500,
    "punctuation-only: !?.,;",
    "naïve café résumé",
    "mixed ascii and ünïcode words",
    "word2\tword3\nword4\r\nword5",
]


def phase_native_tokenizer(corpus, card: str) -> dict:
    """The C++ batch tokenizer (``native/``) builds with g++ on this machine
    and gives the Python path's ids and lengths, to the bit, over the
    export's 70,000 passages and the unicode rows at the doc tower's 128
    tokens; both paths timed (host only)."""
    from twotowermlretrieval_tpu_torch.native import library_path, native_available, native_error
    from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer

    word_to_idx, _, triplets = corpus
    t0 = time.perf_counter()
    check(native_available(), f"native tokenizer unavailable: {native_error()}")
    tok = Tokenizer(word_to_idx)
    check(tok._get_native_vocab() is not None, "no native vocabulary")
    build_s = time.perf_counter() - t0
    texts = [p for t in triplets for p in t[1:]] + NATIVE_TEXTS
    out, secs = {}, {}
    for native in (True, False):
        t0 = time.perf_counter()
        out[native] = tok.encode_batch(texts, DOC_LEN, native=native)
        secs[native] = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))
    check(same, "native tokenizer: ids or lengths differ from the Python path's")
    rec = {"texts": len(texts), "build_and_vocab_s": build_s,
           "native_per_s": len(texts) / secs[True], "python_per_s": len(texts) / secs[False]}
    log(f"native tokenizer ({library_path().name}, built and vocabulary of {len(word_to_idx)} "
        f"words in {build_s:.2f} s): {len(texts)} texts at {DOC_LEN} tokens equal the Python "
        f"path's; native {rec['native_per_s']:.0f} passages/s, Python "
        f"{rec['python_per_s']:.0f} passages/s (host; {card})")
    return rec


# SimpleHybridRetriever, card against CPU: both fit the first HYBRID_CPU_DOCS
# passages (one corpus batch of the doc tower; the CPU runs the plain
# versions). The card alone fits all PASSAGES for the k = N search.
HYBRID_CPU_DOCS = 1024


def _same_pairs(got, want, tol: float) -> bool:
    """(document, score) lists: scores within ``tol`` rank by rank, and a
    document in another place only where a near-tie within ``tol`` can
    have moved it."""
    if len(got) != len(want):
        return False
    gs, ws = np.array([s for _, s in got]), np.array([s for _, s in want])
    if len(gs) and np.abs(gs - ws).max() > tol:
        return False
    by_doc = dict(want)
    for doc, score in got:
        if doc in by_doc:
            if abs(score - by_doc[doc]) > tol:
                return False
        elif score > ws[-1] + tol:  # only a near-tie at the boundary may cut it off
            return False
    return True


def _check_full_ranking(vals, ids, q, docs, n: int, what: str) -> dict:
    """A k = N search (one query row) against topk_oracle on the same f32
    rows: every valid id exactly once, the values within SEGMAX_ATOL of
    the oracle's rank by rank and of their own rows' scores, and an id
    off the oracle's only where the two scores tie within 2 x
    SEGMAX_ATOL."""
    from twotowermlretrieval_tpu_torch.ops.topk import topk_oracle

    o_vals, o_ids = topk_oracle(q, docs, n)
    o_vals, o_ids = o_vals[0].cpu().numpy(), o_ids[0].cpu().numpy()
    full = torch.matmul(docs, q[0]).cpu().numpy()
    check(np.array_equal(np.sort(ids), np.arange(n)), f"{what}: the ids are not every row once")
    err = max(float(np.abs(vals - o_vals).max()), float(np.abs(full[ids] - vals).max()))
    off = ids != o_ids
    gap = float(np.abs(full[ids[off]] - o_vals[off]).max()) if off.any() else 0.0
    log(f"{what}: against topk_oracle over {n} rows: |value diff| {err:.3g}, "
        f"{int(off.sum())} of {n} ranks hold another id (score gap {gap:.3g})")
    check(err <= SEGMAX_ATOL, f"{what}: values off the oracle by {err}")
    check(gap <= 2 * SEGMAX_ATOL, f"{what}: an id off the oracle's by {gap}")
    return {"max_abs_err": err, "ids_off_oracle": int(off.sum())}


def phase_simple_hybrid(dev, triplets) -> dict:
    """``SimpleHybridRetriever`` (serve/simple_hybrid.py) over the export of
    phase 4: fit on every passage on the card (an f32 index: ``segmax``'s
    f32 route), five queries with the counts at 0 (one ``segmax`` and
    two ``rnn_fwd`` a search), the dense k = N search against
    ``topk_oracle``, the kernel at the index's shape against its plain
    version and timed; then card against CPU on HYBRID_CPU_DOCS passages:
    the top-10 (document, score) of each query within EMBED_ATOL."""
    from twotowermlretrieval_tpu_torch.ops.topk import segmax, segmax_bound, segmax_reference
    from twotowermlretrieval_tpu_torch.serve.simple_hybrid import SimpleHybridRetriever

    passages = [p for t in triplets for p in t[1:]]
    queries = [r["query"] for r in _requests(triplets)]
    t0 = time.perf_counter()
    card = SimpleHybridRetriever(ARTIFACTS, device=dev)
    card.fit(passages)
    fit_s = time.perf_counter() - t0
    index = card.index
    check(index.kernel_on() and index._docs.dtype == torch.float32 and index.num_docs == PASSAGES,
          "SimpleHybridRetriever: not an f32 index on the card's fused path")
    zero_counts()
    t0 = time.perf_counter()
    results = [card.search(q) for q in queries]
    search_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"simple hybrid: fit {PASSAGES} passages on the card in {fit_s:.1f} s; "
        f"{len(queries)} searches (k = N dense) in {search_s:.2f} s, launches {launches}")
    check(launches["segmax"] == len(queries) and launches["rnn_fwd"] == 2 * len(queries),
          f"simple hybrid: launched {launches}, expected 1 segmax and 2 rnn_fwd a search")
    check(all(len(r) == 10 and all(math.isfinite(s) for _, s in r) for r in results),
          "simple hybrid: a result list is not 10 finite scores")

    # the dense k = N search against the oracle, and segmax at its shape
    q_np = card.dense_retriever.get_query_embedding(queries[0])
    n = index.num_docs
    vals, ids = index.search(q_np[None], k=n)
    q = torch.from_numpy(q_np)[None].to(dev)
    rec = _check_full_ranking(vals[0], ids[0], q, index._docs[:n], n,
                              f"simple hybrid dense k={n}")
    qp = torch.nn.functional.pad(q, (0, 0, 0, 7))  # the index's 8 query rows
    npad = index._docs.shape[0]
    got, want = segmax(qp, index._docs, n)[0], segmax_reference(qp, index._docs, n)[0]
    err = (got - want).abs().max().item()
    check(err <= SEGMAX_ATOL, f"segmax at the hybrid index's shape: off by {err}")
    rec.update(shape=f"B=8 (1 query) Npad={npad} n_valid={n} H={H} f32, "
                     f"SimpleHybridRetriever k=N", launches=launches,
               max_abs_err=max(rec["max_abs_err"], err))
    rec["ms"] = time_ms(lambda: segmax(qp, index._docs, n))
    rec["plain_ms"] = time_ms(lambda: segmax_reference(qp, index._docs, n), reps=5, warmup=1)
    rec["library_ms"] = time_ms(
        lambda: torch.matmul(index._docs, qp.T).view(-1, 128, 8).amax(dim=1))
    rec["search_ms"] = time_ms(lambda: index.search(q_np[None], k=n), reps=5, warmup=1)
    rec["bound_ms"], rec["bound_by"] = bound(*segmax_bound(8, H, npad, 4), PEAK_SPLIT_FLOPS)
    log(f"segmax {rec['shape']}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
        f"matmul+amax {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms "
        f"({rec['bound_by']}); the whole k=N search with its host fetch "
        f"{rec['search_ms']:.3f} ms")
    del card, index, got, want
    torch.cuda.empty_cache()

    # card against CPU on the same documents
    docs = passages[:HYBRID_CPU_DOCS]
    pair = {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        r = SimpleHybridRetriever(ARTIFACTS, device=where)
        r.fit(docs)
        pair[label] = [r.search(q) for q in queries]
        log(f"simple hybrid on the {label}: fit {len(docs)} passages and {len(queries)} "
            f"searches in {time.perf_counter() - t0:.1f} s")
    worst = max(abs(a[1] - b[1]) for g, w in zip(pair["card"], pair["cpu"])
                for a, b in zip(g, w))
    log(f"simple hybrid, card against CPU over {len(docs)} passages: top-10 scores within "
        f"{worst:.3g}")
    for q, g, w in zip(queries, pair["card"], pair["cpu"]):
        check(_same_pairs(g, w, EMBED_ATOL), f"simple hybrid {q[:30]!r}: card and CPU differ")
    rec["card_vs_cpu"] = worst
    return rec


E2E_DIR = TRAIN_DIR / "e2e"  # removed with TRAIN_DIR at the end
E2E_TIMEOUT_S = 600


def phase_e2e_demo(dev, card: str) -> dict:
    """``python -m twotowermlretrieval_tpu_torch.tools.e2e_demo --scale
    smoke`` as a child process on this device (its server a child of it):
    exit 0 within E2E_TIMEOUT_S, the recall assertion held, and its
    E2E_DEMO_RESULT line read: p50/p99 at c=1 and c=8, examples/s, and
    the kernel launches of its training, its inflation and its int8
    server (segmax_s8 on every dense search). The demo's whole process
    group is killed if it runs over."""
    import signal

    if E2E_DIR.exists():
        shutil.rmtree(E2E_DIR)
    E2E_DIR.mkdir(parents=True)
    out_log = E2E_DIR.parent / "e2e_demo.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "twotowermlretrieval_tpu_torch.tools.e2e_demo",
           "--scale", "smoke", "--device", dev.type, "--out", str(E2E_DIR)]
    t0 = time.perf_counter()
    with open(out_log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=E2E_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    secs = time.perf_counter() - t0
    text = out_log.read_text()
    if rc != 0:
        print(text[-6000:], flush=True)
    check(rc == 0, f"e2e demo: exit {rc} after {secs:.1f} s")
    lines = [ln for ln in text.splitlines() if ln.startswith("E2E_DEMO_RESULT ")]
    check(len(lines) == 1, "e2e demo: no E2E_DEMO_RESULT line")
    res = json.loads(lines[0][len("E2E_DEMO_RESULT "):])
    for ln in text.splitlines():
        if ln.startswith("["):
            log(f"e2e demo {ln}")
    check(res["recall10_trained"] > res["recall10_random"] + 0.1,
          f"e2e demo: recall {res['recall10_trained']} vs random {res['recall10_random']}")
    launches = res["launches"]
    check(launches["train"]["rnn_bwd"] > 0 and launches["train"]["rnn_fwd"] > 0
          and launches["inflate"]["rnn_fwd"] > 0 and launches["serve"]["segmax_s8"] > 0
          and launches["serve"]["rnn_fwd"] > 0,
          f"e2e demo: a stage did not launch its kernels: {launches}")
    res["child_seconds"] = secs
    log(f"e2e demo (smoke scale, child process) in {secs:.1f} s: c=1 p50 {res['p50_ms_c1']} ms, "
        f"p99 {res['p99_ms_c1']} ms; c=8 p50 {res['p50_ms_c8']} ms, p99 {res['p99_ms_c8']} ms, "
        f"{res['req_per_s_c8']} req/s; {res['examples_per_sec']} examples/s; recall@10 "
        f"{res['recall10_random']} -> {res['recall10_trained']}; launches {json.dumps(launches)} "
        f"({card})")
    return res


# ---------------------------------------------------------------------------
# traced runs (after every timed phase: a profiling session slows every
# later host launch)
# ---------------------------------------------------------------------------


def _read_trace(log_dir, kernels, what: str) -> dict:
    """The one trace under ``log_dir``: it exists and holds device events
    of each of ``kernels`` (name substrings); logs the ten device
    operations with the most total time, the device's busy share of the
    window and the three longest idle gaps, and returns them."""
    from twotowermlretrieval_tpu_torch.utils.profiling import trace_files, trace_summary

    files = trace_files(log_dir)
    check(len(files) == 1, f"{what}: {len(files)} trace files under {log_dir}")
    s = trace_summary(files[0])
    check(s["device_events"] > 0, f"{what}: the trace holds no device events")
    names = [o["name"] for o in trace_summary(files[0], top=10_000)["device_ops"]]
    for k in kernels:
        check(any(k in n for n in names), f"{what}: no {k} device event in the trace")
    log(f"{what} trace ({files[0].stat().st_size} bytes): span {s['span_ms']:.3f} ms, device "
        f"busy {s['busy_ms']:.3f} ms = {100 * s['busy_share']:.2f}% of it, "
        f"{s['device_events']} device events; longest idle gaps "
        f"{[round(g, 3) for g in s['idle_gaps_ms']]} ms")
    for o in s["device_ops"]:
        log(f"{what}   {o['total_ms']:9.3f} ms {o['calls']:6d} x  {o['name'][:110]}")
    return s


def phase_traced(dev, setup, tf_setup, triplets) -> dict:
    """Three traces through the entry points' own switches, each read back:
    the GRU training driver with ``profile_dir`` (the window opens at the
    first group starting at step 10 or later and fills before the run
    ends: rnn_fwd and rnn_bwd device events), config 5 for one epoch of
    TF_TRACED_TRAIN triplets (the window opens and the run ends inside it:
    the finalize path; attention_fwd and attention_bwd), and the server
    with ``profile_dir`` and ``profile_requests`` 5 over phase 4's export
    (the window fills with the five requests: rnn_fwd and segmax)."""
    from twotowermlretrieval_tpu_torch.train.loop import train_on_datasets

    traces = TRAIN_DIR / "traces"
    out = {}
    cfg, tok, table, datasets = setup
    zero_counts()
    res = train_on_datasets(cfg, tok, table, datasets, output_root=traces / "gru_out",
                            profile_dir=traces / "gru", device=dev)
    window = res.get("profile_window", {})
    check(window.get("filled") is True, f"traced GRU training: the window {window} did not fill")
    out["gru_train"] = _read_trace(traces / "gru", ("rnn_fwd", "rnn_bwd"),
                                   f"traced GRU training (steps {window.get('start_step')}-"
                                   f"{window.get('stop_step')})")
    out["gru_train"].update(launches=read_counts(), window=window)
    cfg, tok, table, datasets = tf_setup
    a = TRAIN_TRIPLETS + VAL_TRIPLETS + TEST_TRIPLETS  # the transformer phase's cut
    datasets = {**datasets, "train": triplets[a : a + TF_TRACED_TRAIN]}
    zero_counts()
    res = train_on_datasets(cfg, tok, table, datasets, output_root=traces / "tf_out",
                            profile_dir=traces / "tf", device=dev)
    window = res.get("profile_window", {})
    check(res["steps"] == TF_TRACED_TRAIN // TF_ROWS and window.get("filled") is False,
          f"traced config 5: {res['steps']} steps, window {window}: expected the run to end "
          f"inside it")
    out["tf_train"] = _read_trace(traces / "tf", ("attention_fwd", "attention_bwd"),
                                  f"traced config 5 (steps {window.get('start_step')}-"
                                  f"{window.get('stop_step')} and the epoch's evaluation)")
    out["tf_train"].update(launches=read_counts(), window=window)
    requests = _requests(triplets)
    rec, _ = _drive_server(requests, profile_dir=str(traces / "serve"), profile_requests=5)
    out["serve"] = _read_trace(traces / "serve", ("rnn_fwd", "segmax"),
                               "traced /search (5 requests)")
    out["serve"]["launches"] = rec["launches"]
    out["serve"]["request_ms"] = rec["request_ms"]
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--dp-rank"]:  # one rank of phase_data_parallel's pair
        args = dict(zip(argv[::2], argv[1::2]))
        return dp_rank_main(int(args["--dp-rank"]), int(args["--dp-port"]),
                            Path(args["--dp-dir"]))
    if argv[:1] == ["--tp-rank"]:  # one rank of phase_model_axis's pair
        args = dict(zip(argv[::2], argv[1::2]))
        return tp_rank_main(int(args["--tp-rank"]), int(args["--tp-port"]),
                            Path(args["--tp-dir"]))
    try:
        import twotowermlretrieval_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        print(f"chip_smoke: the package must come from this checkout, not {pkg.__file__}",
              file=sys.stderr)
        return 1
    from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device("cuda")  # also turns TF32 off
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    try:
        phase_build()
        kern = phase_kernels(dev)
        for name, recs in phase_int8_kernels(dev).items():
            kern.setdefault(name, []).extend(recs)
        kern["rnn_bwd"] = phase_bwd_kernels(dev)
        wide_fwd, wide_bwd, wide_launches = phase_wide_kernels(dev)
        kern["rnn_fwd"] += wide_fwd
        kern["rnn_bwd"] += wide_bwd
        large_fwd, large_bwd, large_launches = phase_large_batch(dev)
        kern["rnn_fwd"].append(large_fwd)
        kern["rnn_bwd"] += large_bwd
        f32_fwd, f32_bwd, f32_launches = phase_f32_kernels(dev)
        kern["rnn_fwd"] += f32_fwd
        kern["rnn_bwd"] += f32_bwd
        wide_s8 = phase_wide_s8(dev)
        kern["segmax_s8"].append(wide_s8)
        for name, recs in phase_wide_batches(dev).items():
            kern[name].extend(recs)
        ivf, ivf_kept = phase_ivf(dev)
        kern.update(phase_attention_kernels(dev))
        kern["adam"] = phase_adam(dev)
        export, corpus = phase_export(dev)
        native = phase_native_tokenizer(corpus, card)
        served = phase_serve(dev, corpus[2])
        served_int8 = phase_serve_int8(dev, corpus[2])
        wide_engine = phase_wide_engine(dev, corpus)
        served_ivf = phase_serve_ivf(dev, corpus[2])
        hybrid = phase_simple_hybrid(dev, corpus[2])
        kern["segmax"].append(hybrid)
        sharded = phase_sharded_serve(dev, corpus[2], ivf_kept)
        del ivf_kept
        for name, recs in sharded.pop("kernels").items():
            kern[name].extend(recs)
        trained, setup = phase_train(dev, corpus)
        odd = phase_odd_width(dev, setup)
        tf = phase_transformer(dev, corpus)
        dp = phase_data_parallel(dev, corpus)
        tp = phase_model_axis(dev, corpus)
        e2e = phase_e2e_demo(dev, card)
        phase_device_times()
        traced = phase_traced(dev, setup, tf.pop("setup"), corpus[2])
        del setup
    finally:
        shutil.rmtree(ARTIFACTS, ignore_errors=True)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # each kernel's path, its counts read just after it ran: bf16 serving
    # for rnn_fwd and segmax, training for rnn_bwd, int8 serving for
    # segmax_s8, transformer serving for attention_fwd and transformer
    # training for attention_bwd, the sharded per-row int8 search for
    # topk_stream_int8, and for the kernels no serving or training path
    # reaches, one call of their public function (fused_topk_segmax_int8,
    # fused_topk)
    phases = {"export": export["launches"], "serve": served["launches"],
              "serve_int8": served_int8["launches"], "train": trained["launches"],
              "odd_width_serve": odd["launches"], "wide_int8_index": wide_s8["launches"],
              "wide_kernels": wide_launches, "large_batch": large_launches,
              "f32_kernels": f32_launches,
              "transformer_train": tf["launches"], "transformer_serve": tf["serve"]["launches"],
              "wide_engine_search": wide_engine["launches"], "serve_ivf": served_ivf["launches"],
              "traced_train": traced["gru_train"]["launches"],
              "traced_transformer_train": traced["tf_train"]["launches"],
              "traced_serve": traced["serve"]["launches"],
              **{f"data_parallel_rank{r}": c for r, c in enumerate(dp["launches"])},
              **{f"model_axis_rank{r}": c for r, c in enumerate(tp["launches"])},
              **{f"model_axis_gru_rank{r}": c for r, c in enumerate(tp["gru_launches"])},
              "model_axis_export_search": tp["export_search"],
              "sharded_serve": sharded["serve_bfloat16"]["launches"],
              "sharded_serve_int8": sharded["serve_int8"]["launches"],
              "sharded_topk_int8": sharded["int8_rows_launches"],
              "train_f32_history_first_step": trained["first_step_f32_history"]["launches"],
              "train_f32_first_step": trained["first_step_f32"]["launches"],
              "simple_hybrid": hybrid["launches"],
              **{f"e2e_demo_{stage}": c for stage, c in e2e["launches"].items()}}
    main_launches = {"rnn_fwd": served["launches"]["rnn_fwd"],
                     "segmax": served["launches"]["segmax"],
                     "rnn_bwd": trained["launches"]["rnn_bwd"],
                     "segmax_s8": served_int8["launches"]["segmax_s8"],
                     "topk_stream_int8": sharded["int8_rows_launches"]["topk_stream_int8"],
                     "attention_fwd": tf["serve"]["launches"]["attention_fwd"],
                     "attention_bwd": tf["launches"]["attention_bwd"],
                     "adam": trained["launches"]["adam"]}
    kernels = []
    for name, (_, source, replaces) in kernel_table().items():
        recs = kern[name]
        main_rec = recs[0]  # the shape of the kernel's main path (PERF.md's first row)
        launches = main_launches.get(name, main_rec.get("launches", 0))
        check(launches > 0, f"{name} was not launched on its path")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": main_rec["library_ms"],
            "shape": main_rec["shape"],
            "launches_by_phase": {phase: counts[name] for phase, counts in phases.items()},
            "other_shapes": recs[1:],
        })
    log(f"serve int8: request ms {[round(ms, 3) for ms in served_int8['request_ms']]}, "
        f"autotune {json.dumps(served_int8['autotune_ms'])} ({card})")
    log(f"native tokenizer: {native['native_per_s']:.0f} passages/s against the Python path's "
        f"{native['python_per_s']:.0f} ({card})")
    log(f"simple hybrid: k=N dense search {hybrid['search_ms']:.3f} ms, segmax f32 "
        f"{hybrid['ms']:.4f} ms; card against CPU top-10 within {hybrid['card_vs_cpu']:.3g} "
        f"({card})")
    log(f"e2e demo (smoke): {json.dumps({k: v for k, v in e2e.items() if k != 'launches'})}")
    log(f"train: first step card-vs-CPU {json.dumps(trained['first_step'])}; with an f32 "
        f"history {json.dumps(trained['first_step_f32_history'])}; at f32 compute "
        f"{json.dumps(trained['first_step_f32'])}; "
        f"steady {trained['steady_steps_per_sec']:.3f} steps/s, "
        f"{trained['steady_examples_per_sec']:.1f} examples/s ({card})")
    routes = tf["routes"]
    log(f"transformer: first step card-vs-CPU {json.dumps(tf['first_step'])}; kernel route "
        f"against torch route: |loss diff| {routes['loss_diff']:.3g}, step "
        f"{routes['kernels']['step_ms']:.1f} ms against {routes['torch']['step_ms']:.1f} ms; "
        f"steady {tf['steady_steps_per_sec']:.3f} steps/s, "
        f"{tf['steady_examples_per_sec']:.1f} examples/s; request ms "
        f"{[round(ms, 3) for ms in tf['serve']['request_ms']]} ({card})")
    routes = tf["routes_f32"]
    log(f"transformer at f32 compute: first step card-vs-CPU {json.dumps(tf['first_step_f32'])}; "
        f"split kernel route against torch route: |loss diff| {routes['loss_diff']:.3g}, step "
        f"{routes['kernels']['step_ms']:.1f} ms against {routes['torch']['step_ms']:.1f} ms "
        f"({card})")
    log(f"data parallel, configs/msmarco_inbatch.json, {DP_RANKS} ranks x 512 rows on one card "
        f"over gloo: {dp['pair']['steps_per_sec']:.3f} steps/s, "
        f"{dp['pair']['examples_per_sec']:.1f} examples/s; one process at B=1024: "
        f"{dp['single']['steps_per_sec']:.3f} steps/s, {dp['single']['examples_per_sec']:.1f} "
        f"examples/s; gradient all-reduce ms a step "
        f"{[round(ms, 3) for ms in dp['all_reduce_ms']]}; first step against one process: "
        f"loss {dp['loss_rel']:.3g} relative, worst leaf {dp['worst_leaf']} "
        f"{dp['worst_grad_rel']:.3g}; one-rank NCCL ttr-torch-train "
        f"{dp['nccl']['examples_per_sec']:.1f} examples/s ({card})")
    log(f"model axis, config 5 as written over {TP_RANKS} ranks on one card over gloo: first "
        f"step against one process {json.dumps(tp['first'])}; GRU sharded table "
        f"{json.dumps(tp['gru_first'])}; step ms "
        f"{[round(st['ms'], 1) for st in tp['steps'][0]]}, model-group all-reduce ms a step "
        f"{[round(st['all_reduce_ms'], 1) for st in tp['steps'][0]]} "
        f"({tp['steps'][0][0]['all_reduces']} a step) ({card})")
    log(f"ivf over {ivf['rows']} x {ivf['H']}: {json.dumps(ivf)} ({card})")
    log(f"sharded search over {sharded['rows']} x {sharded['H']} on one card: "
        + "; ".join(f"{t['storage']} D={t['shards']} B={t['B']} {t['search_ms']:.4f} ms (scans "
                    f"{t['scan_ms']:.4f}, merge {t['merge_ms']:.4f})" for t in sharded["times"])
        + f"; IVF over 2 shards {sharded['ivf']['ms']:.4f} ms ({card})")
    log(f"serve ivf: nprobe {served_ivf['nprobe']}, measured recall "
        f"{served_ivf['measured_recall']:.4f}, request ms "
        f"{[round(ms, 3) for ms in served_ivf['request_ms']]} ({card})")
    for what, t in traced.items():
        log(f"traced {what}: device busy {100 * t['busy_share']:.2f}% of "
            f"{t['span_ms']:.1f} ms; top device operations "
            + ", ".join(f"{o['name'][:40]} {o['total_ms']:.3f} ms" for o in t["device_ops"][:3])
            + f" ({card})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
