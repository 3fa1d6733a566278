#!/usr/bin/env python3
"""chip_smoke.py — drive the PyTorch/CUDA port (hydragnn_tpu_torch) on
one NVIDIA card and hold its kernels against their plain versions.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases, each printing ``[phase] key=value ...`` lines (a failing phase
raises; nothing is caught):
  1. device      — the card's name, count and power limit (nvidia-smi).
  2. build       — one nvcc per kernel source, all started together;
                   ptxas registers / spills / shared memory.
  3. check       — pna_aggregate_fwd (B5) against its plain version at
                   the shapes of a full flagship serving batch, at H = 1,
                   3, 31, 32 and 128, f32 and bf16, with the receivers'
                   shared row pointers and without them (the wrapper's own
                   pass): bit-equal on the host; the pass (row_pointers)
                   equal to the host's searchsorted.
  4. check-train — gather_stats (B1), its backward kernel
                   gather_stats_bwd, segment_sum (B2), gather_rows (B3)
                   and segment_sum_local (B4) against their plain versions
                   at the flagship training batch's shapes (batch 1024,
                   conv_0 H=1 and conv_1..5 H=128, f32 and bf16), with
                   ties, all-masked K-groups, empty rows and a window plan
                   of overlapping blocks (B1, its backward kernel and B4
                   bit-equal to their plain versions on the host, also on
                   normal values); the backward of every autograd op
                   against the same op on the CPU; two launches bitwise
                   equal.
  4b. check-pna-bwd — pna_bwd_count (B6) and pna_bwd_grad (B7) against
                   their plain versions at the flagship's unaligned
                   training shapes (H=1 and H=128, f32 and bf16), B5
                   there too (bit-equal on the host), with
                   ties, masked edges, empty and all-masked rows and the
                   padding node; two launches bitwise equal; the autograd
                   pna_aggregate backward on the card against the CPU.
                   B5, B6 and B7 again on the unaligned batch of 128
                   graphs (its masked tail one row past the edge
                   occupancy) and on a hub of 60,000 slots among 4,096
                   rows of 24, each with the occupancy bound and without
                   it, against the plain versions.
  5. serve-timing — graphs against the eager forward in one run (default
                   algorithms, before 5a sets CUBLAS_WORKSPACE_CONFIG): the
                   largest bucket's forward, the burst's p50, p99 and
                   requests/s, the serial p50.
 5a. serve       — the flagship at full width (hidden 128, 6 PNA layers,
                   4 heads) served on the card from one CUDA graph per
                   bucket and weight slot, under deterministic algorithms:
                   the wrappers run at start only (per bucket and slot a
                   warm-up forward and the capture, each 6 pna_aggregate,
                   6 sender gathers (B3), 1 row-pointer pass); the
                   128-request burst makes 0 wrapper calls and 0 captures,
                   one replay a batch; every batch bit-equal to the eager
                   forward of the same padded batch, every answer equal to
                   the CPU forward within SERVE_TOL.
 5b. serve-resilience — the same model and data: reloads with the same
                   and other weights (0 captures; bit-equal, and equal to
                   the new weights' eager forward), a torn reload refused
                   with the live outputs unchanged, a killed dispatch
                   thread restarted with every future resolved, a wedge
                   seen and cleared by health(), tools/serve_probe.py on
                   the Prometheus textfile (0 ready, 1 after stop), the
                   flight record valid.
  6. train       — run_training on the flagship at full width, batch 1024,
                   1,280 samples (one train step per epoch), 3 epochs:
                   finite, falling loss; kernel launches equal to the
                   documented counts; then one train step at 64 graphs on
                   the card against the same step on the CPU.
  7. predict     — run_prediction from the run's checkpoint equals the
                   in-memory model's test pass.
 7b. train-loop  — the training loop on the flagship at full width, batch
                   128 (8 steps an epoch): streaming with prefetch 0 and 2
                   (bit-equal) and the fixed-membership epoch, with their
                   data wait, epoch wall and step times and launch counts;
                   4 epochs straight against 2 then continue for 2
                   (bit-equal history, parameters, statistics, optimizer
                   state), keep_last pruning and the torn-file fallback; a
                   NaN batch skipped with the state bit-unchanged, the
                   guarded step's synchronisations (torch.cuda sync debug
                   mode) equal to the plain step's, a rollback, exhaustion;
                   the guarded, plain and mixed-precision step times; the
                   eight optimizers, freeze_conv and grad_accum, 3 steps
                   each on the card against the CPU; mixed precision for 3
                   epochs (finite, falling, each of B1-B4 launched on bf16 inputs).
                   On the flagship's first batch at 128 (a masked tail
                   past its edge occupancy, which bounds B2 and B4) and
                   on the same graphs' unaligned batch (whose tail, one
                   row at the padding node, bounds B5, B6 and B7): the
                   guarded step synchronises 0 times; one forward and
                   backward bit-equal with the bound and without it; the
                   step's profile with B2's and B4's (unaligned: B5's,
                   B6's, B7's and B2's) device ms and calls and the
                   card's busy share.
  8. check-conv  — fused_conv (B8) against its plain version at the
                   flagship training shapes: identity at H=1, 3, 31, 32
                   and 128 (with the shared row pointers and without),
                   the SchNet scale at F=126, the CGCNN gate at width 1
                   and a gate at width 128 with receiver tables and edge
                   terms; f32 and bf16; run-aligned fillers, empty rows,
                   +inf edge terms on masked slots, the occupancy bound
                   below E and at E; an unaligned dense-map batch of the
                   molecular data; the identity and scale walks bit-equal
                   to the plain version on the host, also on normal
                   values; two launches bitwise equal; the
                   autograd backward on the card against the CPU.
  9. train-stacks — run_training on GIN at full width (batch 1024, 6
                   layers, 3 epochs), run_prediction from its checkpoint;
                   SAGE, MFC, SchNet and CGCNN through train_with_loaders
                   for 2 epochs each; finite, falling losses and the
                   documented launch counts (one row-pointer pass a
                   forward); each stack's train step at 64
                   graphs on the card against the CPU.
 9b. train-pna-layouts — the flagship at full width through
                   train_with_loaders on its two other layouts and with
                   edge features: the unaligned CSR layout (B5 forward,
                   B6/B7 backward) for 2 epochs, then its train step at 64
                   graphs on the card against the CPU; the flagship with
                   edge lengths on its AUTO layout (run-aligned) for 2
                   epochs; the dense slot map (46 slots) for 2 epochs.
                   Finite, falling losses and the documented launch counts.
 9c. accuracy    — run_training -> run_prediction on the PNA config of
                   tests/test_train_e2e.py (300 samples, 40 epochs, the
                   dense map), single-head and multi-head: RMSE and MAE
                   below the reference bar of 0.20 on every head; GIN,
                   SAGE, MFC, SchNet and CGCNN on that test's config to
                   its THRESHOLDS (GIN printed beside the JAX package's
                   result on the same seed, not gated).
 8b. stack       — fused_conv_stack (B9) at full width (hidden 128, 6
                   layers, sigmoid edge activation, relu between layers) on
                   the flagship batch's unaligned and run-aligned layouts:
                   the op forward and backward (its main path, counted),
                   then B9 against its plain version on the card and
                   against the loop of B8 launches it replaces, the
                   gradients for x, W and b against the plain version's,
                   two launches bitwise equal; times eager and in a CUDA
                   graph for the forward, the B8 loop and the backward;
                   the node products' and the walks' device time a layer
                   (torch.profiler) beside their bounds; the library
                   yardsticks (torch.addmm and the edge activation,
                   torch.sparse.mm on the masked adjacency, and their
                   per-layer composition for the whole stack).
 9d. train-gat   — GAT at hidden 128 x 6 heads, 6 layers, on the flagship
                   data through run_training -> run_prediction (finite,
                   falling loss; prediction equal to the in-memory test
                   pass; peak memory); the e2e GAT config to its bar (0.60
                   / 0.70, single-head).
 9e. knobs       — fused_conv: false for GIN and SchNet (the composed
                   gather and sorted sum: B3, B2) at 64 graphs, card
                   against CPU; conv_bf16 for GIN and CGCNN against f32
                   on the card within the JAX package's bound; SchNet with
                   radius_graph_in_forward on the e2e molecular config
                   against precomputed edges.
 9f. data-path   — the flagship at full width trained from files: the
                   [train] phase's 1,280 graphs written as LSMS text and
                   as an HGC container; HAVE_NATIVE (the host core built
                   from native/*.cpp, required); read times (LSMS, HGC
                   mmap/preload/shm and the native bulk gather), the
                   radius graph native and numpy (the set, and a cloud of
                   8,192 atoms where the cell grid runs), prepare_dataset;
                   run_training from Dataset.path (HGC, then LSMS as
                   unit_test), 2 epochs at batch 1024 under deterministic
                   algorithms: the HGC history bit-equal to samples= on
                   the samples as stored, the LSMS run's prepared
                   features within rtol 1e-6 and losses within 1e-5 of the
                   in-memory set in the files' lexical order, B1-B4
                   launched; run_prediction from the container,
                   denormalized, its per-head MAE.
 9g. data-eam    — examples/eam/NiNb_EAM_bulk_multitask.json read from
                   disk at its published width (PNA, hidden 50, 10
                   layers, edge lengths, PBC, rotation, 3 heads, batch
                   16), only Dataset.path (1,280 synthetic NiNb BCC CFG
                   files) and num_epoch (2) changed: finite, falling loss;
                   the first batch's forward and backward against the CPU
                   within the train step's tiers; the step on CUDA
                   events, the card's busy share, launches a step, the
                   kernels launched; run_prediction's per-head MAE.
 9h. examples    — the seven example drivers (hydragnn_tpu_torch/examples:
                   Ising, LSMS, EAM, CSCE, OGB, QM9, MD17) through
                   main([...]) in a temporary directory on the card,
                   --preonly where the driver has it, then training, each
                   on its published config unedited at its published
                   width, data counts only through the driver's own
                   arguments: the layout AUTO picked, the launches held to
                   the layout's per-step and per-forward counts, the step
                   on CUDA events and the card's busy share, the epoch
                   wall, the first and last loss (finite, falling).
 9i. records     — the flagship at full width in the training loop, batch
                   128, 2 epochs (1,800 graphs: 12 steps an epoch), with
                   Profile {enable: 1, target_epoch: 1}, under
                   deterministic algorithms: metrics.jsonl equal to the
                   history, the printed peak memory equal to
                   torch.cuda.max_memory_allocated, one Chrome trace that
                   names the port's kernels, the history and parameters
                   bit-equal to the same per-step run without Profile;
                   the tensorboard writer's kind, matplotlib's presence
                   (and the plots where it is present).
 9j. train-obs   — the training loop's telemetry on the flagship at full
                   width, batch 128 on [records]' 1,800 graphs, 3 epochs,
                   deterministic algorithms: (a) per-step with telemetry,
                   diagnostics, SLO triggers, an injected train_loss_spike
                   and train.prom; (b) the same with HGTORCH_TELEMETRY=0;
                   (c) the fixed-membership epoch with telemetry. (a)'s
                   history and parameters bit-equal to (b)'s; each flight
                   record complete and valid; per-head grad norms finite,
                   cosine diagonals 1, MAE/RMSE equal to the test pass's;
                   achieved TFLOP/s and MFU in range, FLOPs a step equal to
                   the CPU's count, the watermark equal to
                   max_memory_allocated; the step spans' modes and sampled
                   steps; one incident whose bundle validates and whose
                   profile names a port kernel; train.prom's loss; (a)'s
                   launches = (b)'s + 3 diagnostics samples + the ledger's
                   step; one diagnostics sample on the card against the
                   CPU. Prints the telemetry's cost on the epoch wall.
 9l. train-resilience — the flagship at full width, batch 128 on the
                   [train-loop] data (8 steps an epoch), 3 epochs,
                   checkpoint_every 1, per-step dispatch, deterministic
                   algorithms: (a) SIGTERM at epoch 2 in process, then the
                   auto-resume, bit-equal to the uninterrupted run, with
                   the signal-to-raise seconds and the hard-exit timer
                   cancelled; in children that load this process's
                   kernels: (b) SIGTERM at step 11 (75), then the resume
                   (0); (c) the second checkpoint torn (-9), then the
                   resume that rejects it (0); (d) a stalled loader under
                   a 3 s watchdog (79, MainThread in the loader's wait);
                   (e) the supervise CLI through a preemption (0, one
                   restart, bit-equal to the uninterrupted run); then (f)
                   the NaN injection bit-equal to a poisoning loader and
                   (g) the handler's and the watchdog's cost on the epoch
                   wall. The uninterrupted run's and (a)'s launches are
                   held to launch_plan.
 9m. lock-witness — the [serve] burst with the lock-order witness off and
                   on: 0 violations, p50 and requests/s of both, and
                   under the device lock, a plain lock and none, in
                   turns; an
                   injected order inversion on two of the server's locks
                   gives one valid lock_order event, the server answering.
 9n. pilot       — the retrain pilot on the flagship at full width served
                   from CUDA graphs off a run on disk: (a) a drift shift
                   opens one incident and the real supervised fine-tune
                   child on the card, the canary and the reload complete
                   a cycle (answers bit-equal to the candidate's eager
                   forward, the serving checkpoint unchanged, 0 captures
                   after start; the same fine-tune in process bit-equal
                   to the child's, its launches as launch_plan); (b) an
                   injected child crash, one restart; (c) an injected
                   canary regression and (d) a torn candidate, neither
                   reloaded, the old weights answering bit-equal.
 9o. fleet       — a Fleet of flagship replicas on one card, each with its
                   own weights and graphs: the burst at N = 1 and 2; the
                   probes; rolling reloads of the same and other weights
                   (r1 on the old ones until its turn); a quiet
                   scale-down, a kill under traffic and its replacement, a
                   scale-up under load, a kill mid-roll; every spawn's
                   launches held to launch_plan, the bursts none.
 10. timing      — each kernel at the main path's shapes: ms eager, ms in
                   a CUDA graph, plain ms, library ms (eager and in a
                   graph), beside its bound; B1's backward kernel beside
                   the chain it replaced (B3's regather and the
                   elementwise block) and the op's whole backward with B4;
                   the shared row-pointer pass alone, B8's identity and
                   scale walks' gather rate, and torch.sparse.mm in a CUDA graph
                   beside them; B5's library calls at the unaligned
                   training shape; B8 and B4 on the molecular dense-map
                   batch (its edge list and its dense slots);
                   the sender gather's backward pairs (permuted, masked
                   on the dense map, and the JAX package's windowed one)
                   on each PNA layout; B2 and B4 at the training loop's
                   batch-128 shapes and B2 at batch 1024, with the
                   occupancy bound and without it (f32 and bf16 held
                   bit-equal to their plain versions, eager and on a CUDA
                   graph's replay), and B2 on a row of 60,000 real slots;
                   B5, B6 and B7 on the unaligned batches of 128 and
                   1,024 graphs with the bound and without it and on the
                   60,000-slot hub, each beside its bound; the PNA (every layout), GIN and
                   SchNet train steps (and GAT's)
                   broken into their stages, and the PNA and GIN steps'
                   device time by kernel (torch.profiler).
 10b. parallel   — two ranks on the one card over gloo (four cards over
                   NCCL with ``--parallel-only 4``): data-parallel, FSDP
                   and ZeRO-1 training against one process, the giant
                   graph on the edge axis; riding on its group, the pod
                   planes: (a)'s per-host flight shards merged (a
                   host_epoch a host an epoch, host 0's podview verdicts,
                   overhead_frac under 0.01, a Chrome track a host), each
                   layout's pod generations (a slice written once), (b)'s
                   newest restored onto this one process bit-equal to its
                   gathered state, and the sample store's cross-rank
                   fetches bit-equal.
 10c. pod        — the flagship at full width, batch 128, 3 epochs,
                   through ``supervise --pod 2`` in two legs side by side,
                   host 1 SIGKILLed mid-save of generation 2: ``fixed``
                   restarts at 2 hosts, ``elastic`` at 1; a straggler pair
                   (host 1, then host 0) opens one step_skew incident
                   naming host 1. Every epoch's losses bit-equal to the
                   uninterrupted run in this process; each host's launches
                   as launch_plan, its kernels against their plain
                   versions. ``--pod-only`` runs 10b and 10c alone.
 11. summary     — the kernels line, the card line, then the result line.

Children (the ranks, the supervised runs, the fine-tune child) read and
write their bytecode under ``hydragnn_tpu_torch/ops/build_pycache/``
(``PYTHONPYCACHEPREFIX``), warmed while the kernels build.

B5 and B8 are timed as the chassis calls them: with the receivers' row
pointers that edge_context builds once per forward; the pass itself is
its own entry (row_pointers).

Every training run goes through the loop with its telemetry on (the
default), and each phase's launch counts include what the telemetry adds
(``telemetry_launches``): a diagnostics sample an epoch (one forward and
H + 1 backward pulls) and the hardware ledger's one forward and backward.

Without a card (torch.cuda.is_available() false), or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

import contextlib
import copy
import dataclasses
import gc
import glob
import importlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
SUM_TOL = dict(rtol=1e-6, atol=1e-6)  # f32 sums; gathers and maxima must be bit-equal
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)  # card vs CPU forward of the whole model
# card vs CPU train step at 64 graphs. The loss within rtol 1e-5, the
# BatchNorm running statistics within rtol 1e-4, atol 1e-6. Gradients,
# per tensor, by the relative L2 norm of the difference:
#   - heads and graph trunk: 1e-4 (f32 sums in another order);
#   - conv and BatchNorm parameters: 2e-2. Their gradients come back
#     through the segment maxima, which send each gradient to the tied or
#     nearly tied maximum. In a BCC lattice many neighbours are
#     equivalent, so 1e-7 rounding differences (cuBLAS against the CPU's
#     GEMM) pick another of two near-equal neighbours and move the
#     gradient by a whole share, not by a rounding. The kernels
#     themselves match their plain versions bit for bit (check-train).
#   - the conv post-layer biases, which feed a BatchNorm: their gradient
#     is 0 up to rounding, so each is held to 1e-4 x the largest
#     gradient of its layer's post-layer weight, on both sides.
STEP_LOSS_RTOL, STEP_BN_TOL = 1e-5, dict(rtol=1e-4, atol=1e-6)
STEP_HEAD_TOL, STEP_CONV_TOL, STEP_ZERO_TOL = 1e-4, 2e-2, 1e-4
# prediction vs the in-memory test pass: the pooling's index_add_ uses
# atomics on the card, so two passes may round differently
PREDICT_TOL = dict(rtol=1e-5, atol=1e-6)
# B8's branch variants against their plain version: each edge's
# pre-activation is a dot product taken in another order than the host's
# matrix product, and expf/log1pf on the card round differently
GATE_TOL = dict(rtol=1e-5, atol=1e-5)
# B8's autograd backward, card against CPU, per gradient by relative L2
# (cuBLAS against the host's BLAS in the recomputed pre-activations and
# the weight gradients)
CONV_BWD_TOL = 1e-5
# the five stacks' train step, card against CPU: the loss rtol 1e-5,
# BatchNorm statistics as STEP_BN_TOL. Each gradient by relative L2,
# within the larger of 1e-3 and 10 x its rounding spread: the largest
# difference between the CPU's f32 step and the same step on the same
# graphs batched in another order (reversed, and two seeded shuffles),
# which changes nothing but the order of the f32 sums. No segment maxima
# here, but two things make some gradients move by more than a rounding:
#   - some are determined by f32 only to a few percent. GIN's eps = 100
#     makes its eps gradient and conv_0's weight gradients nearly 0 by
#     the BatchNorm's invariance (conv_0's input has width 1, so its
#     BatchNorm sees an almost affine function of one scalar), and what
#     is left is a cancellation. The spread measures that;
#   - a rounding-level change can move a ReLU pre-activation across 0,
#     which moves its gradient by that unit's share (about 1e-4 of a
#     node head's gradient). The 1e-3 floor covers it.
# A gradient that is 0 up to rounding (at most 1e-6 of the model's
# largest entry on the CPU: a conv bias that feeds a BatchNorm) is held,
# on both sides, to 1e-4 of that largest entry.
STACK_GRAD_TOL, STACK_SPREAD_FACTOR, STACK_ZERO_TOL = 1e-3, 10.0, 1e-4
# the flagship's unaligned train step at 64 graphs, card against CPU:
# the run-aligned step's tiers for the conv and BatchNorm gradients
# (STEP_CONV_TOL) and the BatchNorm-fed biases (STEP_ZERO_TOL); the heads
# and graph trunk as the stacks' gradients above, within the larger of
# 1e-3 and 10 x their rounding spread on the CPU (the same graphs in three
# other orders). On this layout a rounding-level change flips the sign of
# a node head's ReLU pre-activations near 0, moving that head's gradient
# by a unit's share, more than the run-aligned step's head tier of 1e-4
# allows (measured on the card: 6.2e-4 in heads.2.layers.0.weight).
N_SAMPLES, UNIT_CELLS, SEED = 64, (2, 4), 0  # the serving phase's data
SERVE_THREADS, SERVE_TIMING_ITERS = 4, 20  # the burst's client threads; forwards timed a mode
TRAIN_SAMPLES, TRAIN_BATCH, TRAIN_EPOCHS, STEP_GRAPHS = 1280, 1024, 3, 64
TRAIN_UNIT_CELLS = (2, 4)  # 2 or 3 unit cells per axis, as the bench's flagship
K = 8  # the loader's run alignment
# the training loop's phase: the flagship's 1,024 train graphs at batch 128
# (8 steps an epoch), 2 epochs a run where the phase does not say otherwise
LOOP_BATCH, LOOP_EPOCHS = 128, 2
# an optimizer's step on the card against the CPU's, on the same gradients
# and state: float32 operations in the same order, but the card's rsqrt
# and the order of its norms' sums round differently
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
STACKS = ("GIN", "SAGE", "MFC", "SchNet", "CGCNN")
STACK_EPOCHS = 2  # SAGE, MFC, SchNet and CGCNN
MOLECULE_SAMPLES, MOLECULE_BATCH = 300, 64  # tests/test_train_e2e.py's data
LAYOUT_EPOCHS = 2  # the flagship on its unaligned and dense layouts, and with edge lengths
# B7 in bf16: the plain version combines in bf16 op by op (the JAX
# package's unfused backward), the kernel in f32 rounding once (its
# Pallas K2); f32 must be bit-equal
PNA_BWD_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# the reference accuracy bar per head (tests/test_train_e2e.py:26-34): the
# test error run_prediction returns, which that test calls RMSE, and the MAE
E2E_THRESHOLDS, E2E_SAMPLES, E2E_EPOCHS = (0.20, 0.20), 300, 40
GAT_THRESHOLDS = (0.60, 0.70)  # tests/test_train_e2e.py THRESHOLDS["GAT"]
# the five stacks' reference bars (tests/test_train_e2e.py THRESHOLDS);
# GIN's is printed, not gated (its bar is unsteady in the JAX package
# itself), beside the JAX package's GIN result on the same seed and config:
# tests/test_train_e2e.py::pytest_train_model_singlehead[GIN] with
# HYDRAGNN_MATRIX_REPORT set, on the CPU
STACK_E2E_THRESHOLDS = {"GIN": (0.25, 0.20), "SAGE": (0.20, 0.20), "MFC": (0.20, 0.20), "SchNet": (0.20, 0.20),
                        "CGCNN": (0.50, 0.40)}
JAX_GIN_E2E_CPU = (0.0637061670422554, 0.1718156784772873)
# B9 against its plain version on the card: the largest difference at most
# 1e-5 of the output's largest magnitude (each of the 6 layers' products
# sums in another order than cuBLAS, and its rounding feeds the next
# layer); B9's autograd gradients (recomputed through B8) against autograd
# through the plain version: relative L2 within 1e-4 per tensor
STACK_TOL_REL, STACK_GRAD_TOL = 1e-5, 1e-4
# conv_bf16 against f32 on the card: the JAX package's own bound
# (tests/test_conv_traffic.py): loss within 5e-2 relative (of max(|loss|,
# 1)), every gradient within 8e-2 of the largest
BF16_LOSS_TOL, BF16_GRAD_TOL = 5e-2, 8e-2
# SchNet on the in-forward radius graph against the host-built one: the
# same edges in another slot order; every output, the loss and every
# gradient within a relative L2 of 1e-4
INFORWARD_TOL = 1e-4


def e2e_config(multihead, model_type="PNA"):
    """``tests/test_train_e2e.py:make_config(model_type, multihead)``, the
    reference's unit-test config: hidden 8, 2 conv layers, batch 16,
    40 epochs, AdamW at lr 0.01; CGCNN at its input width 1, SchNet at 50
    Gaussians and 126 filters."""
    if multihead:
        voi = {"input_node_features": [0], "output_names": ["sum_x_x2_x3", "x", "x2", "x3"],
               "output_index": [0, 0, 1, 2], "type": ["graph", "node", "node", "node"]}
        weights = [4.0, 2.0, 2.0, 2.0]
    else:
        voi = {"input_node_features": [0], "output_names": ["sum_x_x2_x3"], "output_index": [0],
               "type": ["graph"]}
        weights = [1.0]
    extra = {"CGCNN": {"hidden_dim": 1}, "SchNet": {"num_gaussians": 50, "num_filters": 126}}.get(model_type, {})
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "unit_test", "format": "unit_test", "compositional_stratified_splitting": True,
            "rotational_invariance": False,
            "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1], "column_index": [0, 6, 7]},
            "graph_features": {"name": ["sum_x_x2_x3"], "dim": [1], "column_index": [0]},
        },
        "NeuralNetwork": {
            "Architecture": {
                "model_type": model_type, "radius": 2.0, "max_neighbours": 100,
                "periodic_boundary_conditions": False, "hidden_dim": 8, "num_conv_layers": 2,
                "output_heads": {
                    "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 5, "num_headlayers": 2,
                              "dim_headlayers": [50, 25]},
                    "node": {"num_headlayers": 2, "dim_headlayers": [50, 25], "type": "mlp"},
                },
                "task_weights": weights,
                **extra,
            },
            "Variables_of_interest": voi,
            "Training": {"num_epoch": E2E_EPOCHS, "perc_train": 0.7, "loss_function_type": "mse",
                         "batch_size": 16, "EarlyStopping": False,
                         "Optimizer": {"type": "AdamW", "learning_rate": 0.01}},
        },
        "Visualization": {"create_plots": False},
    }


def stack_launches(model_type, n_layers):
    """Kernel launches of one train step of a conv stack (its forward
    builds the receivers' row pointers once and launches fused_conv once
    per layer on them; an eval forward only that):
    the backward gathers the cotangent (B3) and scatters grad_x (B4) in
    every layer whose input needs a gradient — all but conv_0 where the
    input is the batch's nodes; SchNet also regathers x for the filter's
    gradient (B3), and its conv_0 input is a linear layer's output; the
    CGCNN gate regathers x and both receiver tables (B3) and sums the
    tables' gradients (B2 x 2)."""
    lyr = n_layers
    per = {
        "GIN": {"fused_conv": lyr, "gather_rows": lyr - 1, "segment_sum_local": lyr - 1, "row_pointers": 1},
        "SchNet": {"fused_conv": lyr, "gather_rows": 2 * lyr, "segment_sum_local": lyr, "row_pointers": 1},
        "CGCNN": {"fused_conv": lyr, "gather_rows": 4 * lyr, "segment_sum": 2 * lyr,
                  "segment_sum_local": lyr - 1, "row_pointers": 1},
    }
    per["SAGE"] = per["MFC"] = per["GIN"]
    return per[model_type]


def composed_launches(model_type, n_layers):
    """Kernel launches of one train step of a conv stack on the composed
    path (``fused_conv: false``) on a batch with sender permutations: per
    layer the forward gathers the senders (B3) and sums the K-group
    pre-reduced messages by receiver (B2); the backward gathers that
    sum's cotangent (B3) and, where the gathered input needs a gradient,
    runs the permuted pair (B3, then B2): in every layer for SchNet (its
    input is a linear layer's output), in all but conv_0 for GIN."""
    grad_layers = n_layers if model_type == "SchNet" else n_layers - 1
    return {"gather_rows": n_layers + 2 * grad_layers, "segment_sum": n_layers + grad_layers}


def line(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean milliseconds per call of ``fn`` over ``iters`` warm calls,
    between CUDA events on the current stream."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters):
    """Milliseconds per call with the host's launch cost removed: ``iters``
    calls captured into one CUDA graph, replayed between events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes, ops):
    """Least time (ms) for the work: bytes over the HBM rate or float32
    operations over the card's rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def compare(out, ref, label, exact=False, tol=SUM_TOL):
    """Max abs error of ``out`` against ``ref`` (both on any device);
    raises beyond ``tol``, or unless bit-equal when ``exact``."""
    out, ref = out.detach().cpu(), ref.detach().cpu()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{label}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    if exact:
        if not torch.equal(bits(out), bits(ref)):
            raise AssertionError(f"{label}: not bit-equal")
        return 0.0
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), err_msg=label, **tol)
    return float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / max(float(b.float().norm()), 1e-30))


def normal_values(shape, seed):
    """Standard normal f32 values (only sums in the same order agree)."""
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def quarter_grid(shape, seed, scale=4.0):
    """Values on a 1/4 grid (many ties; every sum of a few of them exact
    in f32, whatever the order), no -0.0."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((np.round(rng.normal(size=shape) * scale) / 4.0 + 0.0).astype(np.float32))


class NanSteps:
    """A train loader that poisons (NaN node features) the run's train
    steps ``start .. start + count - 1`` and offers no resident batches,
    so the loop streams it step by step."""

    def __init__(self, loader, start, count):
        self.loader, self.start, self.count, self.step = loader, start, count, 0
        self.shuffle = loader.shuffle

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def set_device(self, device):
        self.loader.set_device(device)

    def __iter__(self):
        for b in self.loader:
            bad = self.start <= self.step < self.start + self.count
            self.step += 1
            yield dataclasses.replace(b, nodes=torch.full_like(b.nodes, float("nan"))) if bad else b


def train_loop_phase(dev, card, samples, counts, launches_per, step_batch):
    """The training loop on the flagship at full width, batch
    LOOP_BATCH (several steps an epoch): streaming with prefetch 0 and 2
    (bit-equal) and the fixed-membership epoch, their data wait, epoch
    wall and step times; 4 epochs straight against 2 then ``continue``
    for 2 (bit-equal), keep_last pruning and the torn-file fallback; the
    guard (a NaN batch skipped bit for bit, a rollback, exhaustion) and
    its synchronisations; the eight optimizers, freeze_conv and
    grad_accum, 3 steps each on the card against the CPU; mixed
    precision for 3 epochs. ``counts`` = (reset, read) of the kernels'
    launch counters, ``launches_per(epochs, loaders, bn_recal)`` the
    launches a run should make, ``step_batch`` a host batch of
    STEP_GRAPHS graphs. Also: the guarded step on the flagship's first
    batch at LOOP_BATCH (its masked tail past the edge occupancy, which
    bounds B2 and B4) synchronises 0 times; one forward and backward on
    it is bit-equal with the bound and without it; its profile gives
    B2's and B4's device time and calls. Returns the launch counts of
    each path and that batch. The bit-equality runs (prefetch 0 against
    2, the resume, the bound) run under
    ``torch.use_deterministic_algorithms``, the timed runs without it."""
    import contextlib
    import warnings

    # bit-equal runs on the card need PyTorch's deterministic algorithms:
    # the pooling's index_add_ adds with atomics otherwise (B1-B4 are
    # deterministic on their own); an op without a deterministic
    # implementation would only warn, and the warnings are printed
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    @contextlib.contextmanager
    def deterministic(label):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield
        finally:
            torch.use_deterministic_algorithms(False)
        nondet = sorted({str(w.message)[:160] for w in caught if "deterministic" in str(w.message)})
        line("train-loop", part="determinism", runs=label, deterministic_algorithms=True,
             nondeterministic_op_warnings=len(nondet), first=json.dumps(nondet[:3]))

    reset_counts, read_counts = counts

    from hydragnn_tpu_torch.api import create_dataloaders, prepare_config_and_samples, train_with_loaders
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.models.base import model_loss
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.resilience import NonFiniteRollbackExhausted
    from hydragnn_tpu_torch.train.loop import EPOCH_KEYS
    from hydragnn_tpu_torch.train.optimizer import OPTIMIZERS, select_optimizer
    from hydragnn_tpu_torch.train.state import make_train_step
    from hydragnn_tpu_torch.utils import checkpoint as ckpt
    from hydragnn_tpu_torch.utils.config import get_log_name_config

    reset_counts, read_counts = counts
    tr, va, te, done = prepare_config_and_samples(flagship_config(batch_size=LOOP_BATCH), samples())
    paths = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_loop_")

    def config(epochs, **training):
        cfg = copy.deepcopy(done)
        cfg["NeuralNetwork"]["Training"].update(num_epoch=epochs, **training)
        return cfg

    def run(label, cfg, prefetch=2, train_loader=None, check_launches=True):
        os.environ["HGTORCH_NUM_PREFETCH"] = str(prefetch)
        loaders = list(create_dataloaders(tr, va, te, cfg))
        if train_loader is not None:
            loaders[0] = train_loader(loaders[0])
        reset_counts()
        t0 = time.perf_counter()
        model, optimizer, hist = train_with_loaders(cfg, *loaders, log_dir=os.path.join(root, label), device=dev,
                                                    seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paths[f"train_loop_{label}"] = got = read_counts()
        training = cfg["NeuralNetwork"]["Training"]
        epochs = len(hist["train_wall_s"])
        want = launches_per(epochs, loaders, training.get("bn_recalibration", True))
        if check_launches and got != want:
            raise AssertionError(f"train-loop {label}: launches {got}, want {want}")
        steps = epochs * len(loaders[0])
        line("train-loop", run=label, dispatch=hist["dispatch_mode"]["mode"], epochs=epochs, steps=steps,
             batch=LOOP_BATCH, prefetch=prefetch, train_loss=json.dumps(hist["train_loss"]),
             data_wait_s=json.dumps([round(x, 4) for x in hist["data_wait_s"]]),
             epoch_wall_s=json.dumps([round(x, 4) for x in hist["train_wall_s"]]),
             step_ms_host=round(sum(hist["train_wall_s"][1:]) / max(steps - len(loaders[0]), 1) * 1e3, 3),
             run_wall_s=round(wall, 3), kernel_launches=json.dumps(got, separators=(",", ":")), card=repr(card))
        return model, optimizer, hist, get_log_name_config(cfg)

    def state(model, optimizer):
        return ([t.detach().clone() for t in model.state_dict().values()]
                + [t.clone() for t in optimizer.state_tensors()] + [optimizer.steps.clone()])

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    # streaming with and without the prefetch thread (bit-equal), and the
    # fixed epoch; then the same three timed without deterministic mode
    runs = {}
    with deterministic("streaming_prefetch0_vs_2"):
        for label, prefetch in (("bitequal_prefetch0", 0), ("bitequal_prefetch2", 2)):
            runs[label] = run(label, config(LOOP_EPOCHS, scan_epoch=False), prefetch=prefetch)
    (m0, o0, h0, _), (m2, o2, h2, _) = runs["bitequal_prefetch0"], runs["bitequal_prefetch2"]
    if any(h0[k] != h2[k] for k in EPOCH_KEYS) or not same(state(m0, o0), state(m2, o2)):
        raise AssertionError("train-loop: prefetch 0 and 2 trained differently")
    for label, prefetch, training in (("streaming_prefetch0", 0, {"scan_epoch": False}),
                                      ("streaming_prefetch2", 2, {"scan_epoch": False}),
                                      ("fixed_epoch", 2, {})):
        runs[label] = run(label, config(LOOP_EPOCHS, **training), prefetch=prefetch)
        hist = runs[label][2]
        if not (np.isfinite(hist["train_loss"]).all() and hist["train_loss"][-1] < hist["train_loss"][0]):
            raise AssertionError(f"train-loop {label}: the loss is not finite and falling: {hist['train_loss']}")
    t0_, t2_, tf_ = (runs[k][2] for k in ("streaming_prefetch0", "streaming_prefetch2", "fixed_epoch"))
    line("train-loop", part="prefetch", bit_equal=True, data_wait_s_prefetch0=json.dumps(t0_["data_wait_s"]),
         data_wait_s_prefetch2=json.dumps(t2_["data_wait_s"]),
         epoch_wall_s_streaming_prefetch0=json.dumps(t0_["train_wall_s"]),
         epoch_wall_s_streaming_prefetch2=json.dumps(t2_["train_wall_s"]),
         epoch_wall_s_fixed=json.dumps(tf_["train_wall_s"]), card=repr(card))

    # exact resume, keep_last pruning, the torn-file fallback
    resume = {"checkpoint_every": 1, "checkpoint_keep_last": 2, "bn_recalibration": False}
    with deterministic("resume"):
        m_a, o_a, h_a, _ = run("resume_straight", config(4, **resume))
        _, _, _, name_b = run("resume_first2", config(2, **resume))
        cont = config(4, **resume, startfrom=name_b)
        cont["NeuralNetwork"]["Training"]["continue"] = 1
        os.makedirs(os.path.join(root, "resume_continue"), exist_ok=True)
        for f in os.listdir(os.path.join(root, "resume_first2")):
            shutil.copytree(os.path.join(root, "resume_first2", f), os.path.join(root, "resume_continue", f))
        m_c, o_c, h_c, name_c = run("resume_continue", cont)
    if any(h_a[k] != h_c[k] for k in EPOCH_KEYS) or not same(state(m_a, o_a), state(m_c, o_c)):
        raise AssertionError("train-loop: the resumed run differs from the straight one")
    log_c = os.path.join(root, "resume_continue")
    versions = [s for s, _ in ckpt.list_versioned_checkpoints(name_c, log_c)]
    steps_per_epoch = len(create_dataloaders(tr, va, te, done)[0])
    if versions != [4 * steps_per_epoch, 3 * steps_per_epoch]:
        raise AssertionError(f"train-loop: keep_last 2 kept {versions}")
    latest = ckpt.checkpoint_path(name_c, log_c)
    data = open(latest, "rb").read()
    with open(latest, "wb") as f:
        f.write(data[: len(data) // 2])
    fresh = create_model_config(done["NeuralNetwork"], seed=SEED + 7, device=dev)
    fresh_opt = select_optimizer(fresh, done["NeuralNetwork"]["Training"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ckpt.load_existing_model(fresh, name_c, log_c, optimizer=fresh_opt)
    if not any(issubclass(w.category, RuntimeWarning) and "rejected" in str(w.message) for w in caught):
        raise AssertionError("train-loop: the torn latest file was not rejected")
    if not same(state(fresh, fresh_opt), state(m_c, o_c)):
        raise AssertionError("train-loop: the fallback did not restore the newest version")
    line("train-loop", part="resume", bit_equal=True, epochs="4 = 2 + continue 2",
         versions_kept=json.dumps(versions), torn_latest_fallback=True, card=repr(card))

    # the guard: a NaN batch, its synchronisations, a rollback, exhaustion
    model = create_model_config(done["NeuralNetwork"], seed=SEED, device=dev)
    optimizer = select_optimizer(model, done["NeuralNetwork"]["Training"])
    batch = step_batch.to(dev)
    nan_batch = dataclasses.replace(batch, nodes=torch.full_like(batch.nodes, float("nan")))
    guarded, plain = (make_train_step(model, optimizer, guard_nonfinite=g) for g in (True, False))
    consec = torch.zeros((), dtype=torch.int32, device=dev)
    # the flagship's first fixed-membership batch at LOOP_BATCH: its masked
    # tail runs past its edge occupancy, which bounds B2 and B4
    resident = create_dataloaders(tr, va, te, done)[0]
    resident.set_device(dev)
    big = resident.device_batches(0)[0]
    # the same graphs' first streaming batch on the unaligned layout: its
    # masked tail is one receiver row at the padding node, which B5, B6
    # and B7 walk, and the occupancy bounds them
    ubig = next(iter(GraphLoader(tr, LOOP_BATCH, dense_slots=False, run_align=False))).to(dev)
    before = state(model, optimizer)
    loss, _, consec, bad = guarded(nan_batch, consec)
    if not (float(bad) == 1.0 and int(consec) == 1 and float(loss) == 0.0 and same(before, state(model, optimizer))):
        raise AssertionError("train-loop: the NaN batch changed the state")
    syncs = {}
    # the control reads a loss on the host, which must count as a sync
    for label, fn in (("guarded", lambda: guarded(batch, consec)), ("plain", lambda: plain(batch)),
                      ("guarded_batch128", lambda: guarded(big, consec)),
                      ("guarded_unaligned_batch128", lambda: guarded(ubig, consec)),
                      ("control_item", lambda: float(plain(batch)[0]))):
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[label] = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    if (syncs["guarded"] != syncs["plain"] or syncs["guarded_batch128"] or syncs["guarded_unaligned_batch128"]
            or not syncs["control_item"]):
        raise AssertionError(f"train-loop: the guard synchronises, or the count sees nothing: {syncs}")
    # the bound changes nothing: one forward and backward at LOOP_BATCH
    # with the batch's occupancy and without it, bit-equal (deterministic
    # algorithms: the pooling's index_add_ adds with atomics otherwise)
    for layout, bb in (("run_aligned", big), ("unaligned", ubig)):
        sides = {}
        with deterministic(f"bound_vs_none_{layout}"):
            for label, b in (("bound", bb), ("none", dataclasses.replace(bb, edge_occupancy=None))):
                m = create_model_config(done["NeuralNetwork"], seed=SEED + 2, device=dev)
                loss, _ = model_loss(m.cfg, m(b, train=True), b)
                loss.backward()
                sides[label] = [loss.detach()] + [p.grad.detach() for p in m.parameters()]
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(sides["bound"], sides["none"])):
            raise AssertionError(f"train-loop: the occupancy bound changed the {layout} batch-128 loss or a gradient")
        occ = int(bb.edge_occupancy)
        line("train-loop", part="bound_vs_none", layout=layout, batch=LOOP_BATCH, edge_slots=bb.num_edges,
             edge_occupancy=occ, masked_tail=bb.num_edges - occ, loss=float(sides["bound"][0]),
             loss_and_grads_bit_equal=True, tensors=len(sides["bound"]), card=repr(card))
    # in turns (plain, guarded, guarded, plain; f32, bf16, bf16, f32): the
    # steps are host-bound at this size and the host's pace drifts
    mixed = make_train_step(model, optimizer, compute_dtype=torch.bfloat16)
    step_fns = {"plain": lambda: plain(batch), "guarded": lambda: guarded(batch, consec),
                "mixed": lambda: mixed(batch)}
    turns = {k: [] for k in step_fns}
    for order in (("plain", "guarded", "mixed"), ("mixed", "guarded", "plain")):
        for k in order:
            turns[k].append(round(cuda_ms(step_fns[k], 10), 4))
    guarded_ms, plain_ms, mixed_ms = (float(np.median(turns[k])) for k in ("guarded", "plain", "mixed"))
    # where a guarded step at LOOP_BATCH spends its time: the card's busy
    # time (torch.profiler) against the step's wall time
    from torch.profiler import ProfilerActivity, profile

    def profile_guarded(layout, b, kernels):
        """One guarded step on ``b`` under torch.profiler: its wall ms, the
        card's busy ms and share, and the device ms and calls of each of
        ``kernels`` (name -> substrings of its kernels' names)."""
        guarded(b, consec)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            guarded(b, consec)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]
        busy_ms = sum(ev.self_device_time_total for ev in evs) / 1e3
        by_kernel = {name: [(ev.self_device_time_total / 1e3, ev.count) for ev in evs if any(k in ev.key for k in keys)]
                     for name, keys in kernels.items()}
        line("train-loop", part="profile", layout=layout, batch=LOOP_BATCH, edge_slots=b.num_edges,
             edge_occupancy=int(b.edge_occupancy), guarded_step_wall_ms=round(wall_ms, 3),
             device_busy_ms=round(busy_ms, 3) if evs else "not measured",
             device_busy_share=round(busy_ms / wall_ms, 4) if evs else "not measured",
             kernel_launches=sum(ev.count for ev in evs),
             **{f"{name}_{what}": (round(sum(r[i] for r in v), 4) if evs else "not measured")
                for name, v in by_kernel.items() for i, what in ((0, "device_ms"), (1, "calls"))},
             card=repr(card))
        for ev in sorted(evs, key=lambda ev: -ev.self_device_time_total)[:10]:
            print(f"  profile[train-loop {layout}]: {ev.self_device_time_total / 1e3:9.3f} ms {ev.count:5d} calls  "
                  f"{ev.key[:110]}")

    # B2's own row-pointer pass is csr_row_ptr_kernel, counted among the
    # rest; B5's kernels are pna_aggregate_{warp,h1}_kernel, B6's
    # pna_bwd_count_{kernel,h1_kernel,long_kernel} (two a call)
    profile_guarded("run_aligned", big, {"b2": ("segment_sum_kernel",), "b4": ("segment_sum_local_kernel",)})
    profile_guarded("unaligned", ubig, {"b5": ("pna_aggregate_warp_kernel", "pna_aggregate_h1_kernel"),
                                        "b6": ("pna_bwd_count_kernel", "pna_bwd_count_h1_kernel",
                                               "pna_bwd_count_long_kernel"),
                                        "b7": ("pna_bwd_grad_kernel",), "b2": ("segment_sum_kernel",)})
    line("train-loop", part="guard", nan_batch_state_bit_unchanged=True, syncs_guarded=syncs["guarded"],
         syncs_plain=syncs["plain"], syncs_guarded_batch128=syncs["guarded_batch128"],
         syncs_guarded_unaligned_batch128=syncs["guarded_unaligned_batch128"],
         syncs_control_item=syncs["control_item"], step_graphs=STEP_GRAPHS,
         guarded_step_ms=round(guarded_ms, 4), plain_step_ms=round(plain_ms, 4),
         mixed_precision_step_ms=round(mixed_ms, 4), turns_ms=json.dumps(turns), card=repr(card))
    nan_cfg = dict(checkpoint_every=1, nonfinite_patience=2, scan_epoch=False)
    tail = 2 * steps_per_epoch - 2  # the last two steps of epoch 1
    _, _, h_rb, _ = run("rollback", config(4, **nan_cfg), train_loader=lambda ld: NanSteps(ld, tail, 2),
                        check_launches=False)
    if h_rb["rollbacks"] != [1] or len(h_rb["train_loss"]) != 3 or not h_rb["lr"][-1] == h_rb["lr"][0] * 0.5:
        raise AssertionError(f"train-loop: no rollback at epoch 1: {h_rb['rollbacks']} {h_rb['lr']}")
    try:
        run("exhaustion", config(6, nonfinite_max_rollbacks=1, **nan_cfg),
            train_loader=lambda ld: NanSteps(ld, tail, 10 ** 6), check_launches=False)
    except NonFiniteRollbackExhausted as exc:
        line("train-loop", part="sentry", rollback_epochs=json.dumps(h_rb["rollbacks"]),
             skipped=json.dumps(h_rb["nonfinite_skipped"]), exhausted=repr(str(exc)[:80]), card=repr(card))
    else:
        raise AssertionError("train-loop: the rollback budget did not run out")

    # the optimizers: 3 steps each, the card against the CPU, every step
    # from the same state (the card's model and optimizer take the CPU's
    # before it). Each step's loss within STEP_LOSS_RTOL and BatchNorm
    # statistics within STEP_BN_TOL; the first step's gradients (at the
    # seeded init, the train-step phase's state) within that phase's
    # tiers: conv and BatchNorm parameters STEP_CONV_TOL, heads
    # STEP_HEAD_TOL, BatchNorm-fed conv biases STEP_ZERO_TOL (later
    # steps' gradients depend on the parameters, not on the optimizer,
    # and are printed). Then both optimizers step on the CPU's gradients:
    # the parameters and every optimizer tensor within OPT_TOL (the same
    # float32 operations; the card's rsqrt and its norms' summation order
    # round differently)
    cases = [(kind, {}, False) for kind in OPTIMIZERS]
    cases += [("AdamW", {}, True), ("AdamW", {"grad_accum_steps": 2}, False)]
    failed = []
    for kind, extra, freeze in cases:
        training = {"Optimizer": {"type": kind, "learning_rate": 1e-3}, **extra}
        sides = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            m = create_model_config(done["NeuralNetwork"], seed=SEED + 1, device=d)
            sides[where] = (m, select_optimizer(m, training, freeze_conv=freeze), step_batch.to(d))
        (mc, oc, bc), (mg, og, bg) = sides["cpu"], sides["card"]
        worst = {"loss": 0.0, "head": 0.0, "conv": 0.0, "zero": 0.0, "opt": 0.0, "bn": 0.0}
        first = {}
        ok = True
        for step_i in range(3):
            mg.load_state_dict(mc.state_dict())
            og.load_state_dict(copy.deepcopy(oc.state_dict()))
            out = {}
            for where, (m, o, b) in sides.items():
                o.zero_grad(set_to_none=True)
                loss, _ = model_loss(m.cfg, m(b, train=True), b)
                loss.backward()
                out[where] = (float(loss), {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
                              {k: v.detach().cpu() for k, v in m.state_dict().items() if "running" in k})
            (lc, gc, sc), (lg, gg, sg) = out["cpu"], out["card"]
            worst["loss"] = max(worst["loss"], abs(lg - lc) / abs(lc))
            ok &= abs(lg - lc) <= STEP_LOSS_RTOL * abs(lc)
            bn_ratio = max(float(((sg[k] - v).abs() / (STEP_BN_TOL["atol"] + STEP_BN_TOL["rtol"] * v.abs())).max())
                           for k, v in sc.items())
            worst["bn"] = max(worst["bn"], bn_ratio)
            ok &= bn_ratio <= 1.0
            for k, g in gc.items():
                if k.startswith("convs.") and k.endswith("post.bias"):
                    tier = "zero"
                    r = max(float(g.abs().max()), float(gg[k].abs().max())) / max(
                        float(gc[k[:-4] + "weight"].abs().max()), 1e-30)
                else:
                    tier = "conv" if k.startswith(("convs.", "norms.")) else "head"
                    r = rel_l2(gg[k], g)
                worst[tier] = max(worst[tier], r)
                if step_i == 0:
                    first[tier] = max(first.get(tier, 0.0), r)
            for p_card, (name, p_cpu) in zip(mg.parameters(), mc.named_parameters()):
                p_card.grad = p_cpu.grad.to(dev)
            og.step()
            oc.step()
            for a, b in zip([*mg.parameters(), *og.state_tensors()], [*mc.parameters(), *oc.state_tensors()]):
                a, b = a.detach().cpu(), b.detach()
                if a.is_floating_point():
                    err = float(((a - b).abs() - OPT_TOL["atol"] - OPT_TOL["rtol"] * b.abs()).max())
                    worst["opt"] = max(worst["opt"], err + OPT_TOL["atol"])
                    ok &= err <= 0.0
                else:
                    ok &= torch.equal(a, b)
        ok &= (first["head"] <= STEP_HEAD_TOL and first["conv"] <= STEP_CONV_TOL
               and first["zero"] <= STEP_ZERO_TOL)
        frozen_ok = not freeze or all(torch.equal(p.detach().cpu(), q.detach().cpu()) for (k, p), q in zip(
            mg.named_parameters(), create_model_config(done["NeuralNetwork"], seed=SEED + 1, device="cpu").parameters())
            if k.startswith("convs."))
        line("train-loop", part="optimizer", kind=kind, freeze_conv=freeze, grad_accum=extra.get("grad_accum_steps", 1),
             steps=3, worst_loss_rel=worst["loss"], worst_bn_stats_over_tol=worst["bn"],
             first_step_grad_rel_l2=json.dumps(first), later_steps_worst_grad_rel_l2=json.dumps(
                 {k: worst[k] for k in ("head", "conv", "zero")}),
             optimizer_worst_abs_err=worst["opt"], frozen_convs_still=frozen_ok, within_tiers=bool(ok))
        if not (ok and frozen_ok):
            failed.append((kind, extra, freeze))
    if failed:
        raise AssertionError(f"train-loop: card and CPU differ beyond the step's tiers for {failed}")

    # mixed precision: 3 epochs, finite and falling, B1-B4 launched on
    # bf16 inputs (each wrapper counts its launches by the input's type)
    from hydragnn_tpu_torch.ops import gather_rows, gather_stats, segment_sum, segment_sum_local

    _, _, h_mp, _ = run("mixed_precision", config(3, mixed_precision=True))
    if not (np.isfinite(h_mp["train_loss"]).all() and h_mp["train_loss"][-1] < h_mp["train_loss"][0]):
        raise AssertionError(f"train-loop: mixed precision did not train: {h_mp['train_loss']}")
    by_dtype = {name: {str(d).replace("torch.", ""): n for d, n in c.by_dtype.items()} for name, c in (
        ("gather_stats", gather_stats.launches), ("gather_stats_bwd", gather_stats.bwd_launches),
        ("segment_sum", segment_sum.launches), ("gather_rows", gather_rows.launches),
        ("segment_sum_local", segment_sum_local.launches))}
    line("train-loop", part="mixed_precision_launches", by_dtype=json.dumps(by_dtype, separators=(",", ":")))
    if not all(c.get("bfloat16", 0) for c in by_dtype.values()):
        raise AssertionError(f"train-loop: mixed precision ran a kernel on no bf16 input: {by_dtype}")
    os.environ.pop("HGTORCH_NUM_PREFETCH", None)
    shutil.rmtree(root, ignore_errors=True)
    return paths, big


def bound_timing(dev, card, b128, b1024, hidden, b1, b2, b4):
    """Part of phase 10: B2 (``segment_sum``) and B4 (``segment_sum_local``)
    at the training loop's batch-128 shapes (``b128``: the flagship's first
    batch at LOOP_BATCH, whose masked tail runs past its edge occupancy)
    and B2 at the batch-1024 shape (``b1024``), each with the occupancy
    bound and without it, on the data of the main path (B1's K-group
    statistics and the tie mask of their segment max for B2, B1's
    backward kernel's grad_v for B4), f32 and bf16: bit-equal to the
    plain version with the same bound, and so to the unbounded result
    where the tail's data are zero, and bit-equal again on the replay of
    a CUDA graph's capture. Then B2 on a row of 60,000 real slots (a hub,
    streamed through the CTA's ring). Times in f32: ms eager and in a
    graph, with and without the bound; plain ms; the library call's ms
    (``torch.segment_reduce``, ``index_add_``); the bound of the bounded
    work. Returns the timing entries by name; raises on any mismatch."""
    def replayed(fn):
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn()
        g.replay()
        torch.cuda.synchronize()
        return out

    def held(label, fn, ref):
        compare(fn(), ref, label, exact=True)
        compare(replayed(fn), ref, label + " graph", exact=True)

    out = {}
    for shape, bd in (("batch128", b128), ("batch1024", b1024)):
        n, e, k = bd.num_nodes, bd.num_edges, bd.run_align
        send, mask, win, occ = bd.senders, bd.edge_mask, bd.sender_win, bd.edge_occupancy
        recv8 = bd.receivers[::k].contiguous()
        gocc = torch.div(occ + (k - 1), k, rounding_mode="floor")
        rows, real_e, nb = int(gocc), int(occ), int(win.shape[1])
        gen = torch.Generator(device=dev).manual_seed(11)
        cpu = {name: t.cpu() for name, t in (("send", send), ("recv8", recv8), ("gocc", gocc), ("occ", occ))}
        data = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype)[6:]
            table = torch.randn(n, hidden, device=dev, generator=gen).to(dtype)
            stats, both = b1.gather_stats(table, send, mask, k)
            # the tie mask of the sorted segment max's backward, against
            # its raw maximum: the tail's all-masked groups tie the
            # padding node's fill value, so the bound changes that row
            idx = recv8.long()[:, None].expand(-1, both.shape[1])
            raw = torch.full((n, both.shape[1]), float("-inf"), dtype=dtype, device=dev).scatter_reduce(
                0, idx, both, "amax", include_self=True)
            ties = (both == raw.index_select(0, recv8.long())).to(dtype)
            g_stats = torch.randn(e // k, 2 * hidden, device=dev, generator=gen)
            grad_v = b1.gather_presum_bwd(table, send, mask, both, g_stats, g_stats.to(dtype), k)
            for label, d in (("stats", stats), ("ties", ties)):
                dh = d.cpu()
                ref_bound = b2.segment_sum_plain(dh, cpu["recv8"], n, real_rows=cpu["gocc"])
                ref_none = b2.segment_sum_plain(dh, cpu["recv8"], n)
                if label == "stats":  # a zero tail: the bound changes nothing
                    compare(ref_bound, ref_none, f"segment_sum {shape} plain bound", exact=True)
                held(f"segment_sum {shape} {label} {tag} bound", lambda: b2.segment_sum(d, recv8, n, real_rows=gocc),
                     ref_bound)
                held(f"segment_sum {shape} {label} {tag}", lambda: b2.segment_sum(d, recv8, n), ref_none)
            ref = b4.segment_sum_local_plain(grad_v.cpu(), cpu["send"], n)
            compare(b4.segment_sum_local_plain(grad_v.cpu(), cpu["send"], n, cpu["occ"]), ref,
                    f"segment_sum_local {shape} plain bound", exact=True)
            held(f"segment_sum_local {shape} {tag} bound",
                 lambda: b4.segment_sum_local(grad_v, send, win, n, real_edges=occ), ref)
            held(f"segment_sum_local {shape} {tag}", lambda: b4.segment_sum_local(grad_v, send, win, n), ref)
            line("check-train", kernel="segment_sum,segment_sum_local", case=f"{shape}_{tag}_bound_and_none", E=e,
                 rows=e // k, real_rows=rows, real_edges=real_e, N=n, bit_equal=True, graph_replay=True)
            if dtype == torch.float32:
                data = dict(stats=stats, grad_v=grad_v)
        stats, grad_v = data["stats"], data["grad_v"]
        w = stats.shape[1]
        lengths = torch.bincount(recv8.long(), minlength=n)
        b2_bytes = lambda r: r * w * 4 + r * 4 + n * w * 4  # noqa: E731
        b4_bytes = lambda r: r * hidden * 4 + r * 4 + 2 * nb * 4 + n * hidden * 4  # noqa: E731
        specs = {
            "segment_sum": (lambda: b2.segment_sum(stats, recv8, n, real_rows=gocc),
                            lambda: b2.segment_sum(stats, recv8, n),
                            lambda: b2.segment_sum_plain(stats, recv8, n, real_rows=gocc),
                            lambda: torch.segment_reduce(stats, "sum", lengths=lengths, axis=0),
                            b2_bytes(rows), rows * w, b2_bytes(e // k), dict(rows=e // k, real_rows=rows, N=n, W=w)),
            "segment_sum_local": (lambda: b4.segment_sum_local(grad_v, send, win, n, real_edges=occ),
                                  lambda: b4.segment_sum_local(grad_v, send, win, n),
                                  lambda: b4.segment_sum_local_plain(grad_v, send, n, occ),
                                  lambda: torch.zeros(n, hidden, device=dev).index_add_(0, send, grad_v),
                                  b4_bytes(real_e), real_e * hidden, b4_bytes(e),
                                  dict(E=e, real_edges=real_e, N=n, H=hidden, blocks=nb)),
        }
        for name, (kern, unbounded, plain, library, nbytes, ops, nbytes_all, dims) in specs.items():
            if shape == "batch1024" and name == "segment_sum_local":
                continue  # the main timing table's entry
            t = {"kernel": [], "unbounded": [], "plain": [], "library": []}
            for which, fn in (("kernel", kern), ("unbounded", unbounded), ("plain", plain), ("library", library),
                              ("unbounded", unbounded), ("kernel", kern)):
                t[which].append(cuda_ms(fn, 20 if which in ("kernel", "library") else 5))
            bms, by = bound(nbytes, ops)
            entry = {"ms": float(np.mean(t["kernel"])), "graph_ms": graph_ms(kern, 20),
                     "ms_without_bound": float(np.mean(t["unbounded"])), "graph_ms_without_bound": graph_ms(unbounded, 5),
                     "plain_ms": float(np.mean(t["plain"])), "library_ms": float(np.mean(t["library"])),
                     "bound_ms": bms, "bound_by": by, "bound_ms_whole_pad": bound(nbytes_all, ops)[0], **dims}
            out[f"{name}_{shape}"] = entry
            line("timing", kernel=name, shape=f"{shape}_bound_vs_none", card=repr(card),
                 **{kk: (round(x, 5) if isinstance(x, float) else x) for kk, x in entry.items()})

    # a row of 60,000 real slots among 4,096 rows of 24 (B2's CTA ring)
    counts = torch.full((4096,), 24, dtype=torch.long)
    counts[100] = 60_000
    ids = torch.repeat_interleave(torch.arange(4096, dtype=torch.int32), counts)
    vals = normal_values((ids.shape[0], 256), 12)
    ref = b2.segment_sum_plain(vals, ids, 4096)
    ids_d, vals_d = ids.to(dev), vals.to(dev)
    held("segment_sum long_row", lambda: b2.segment_sum(vals_d, ids_d, 4096), ref)
    lengths = counts.to(dev)
    nbytes = ids.shape[0] * 256 * 4 + ids.shape[0] * 4 + 4096 * 256 * 4
    bms, by = bound(nbytes, ids.shape[0] * 256)
    out["segment_sum_long_row"] = entry = {
        "ms": cuda_ms(lambda: b2.segment_sum(vals_d, ids_d, 4096), 10),
        "graph_ms": graph_ms(lambda: b2.segment_sum(vals_d, ids_d, 4096), 5),
        "plain_ms": cuda_ms(lambda: b2.segment_sum_plain(vals_d, ids_d, 4096), 5),
        "library_ms": cuda_ms(lambda: torch.segment_reduce(vals_d, "sum", lengths=lengths, axis=0), 10),
        "bound_ms": bms, "bound_by": by, "rows": ids.shape[0], "long_row": 60_000, "N": 4096, "W": 256}
    line("timing", kernel="segment_sum", shape="long_row_60000", card=repr(card), bit_equal=True,
         **{kk: (round(x, 5) if isinstance(x, float) else x) for kk, x in entry.items()})
    return out


def pna_hub_case():
    """A hub of 60,000 slots (row 100) among 4,096 rows of 24: sorted
    int32 receivers, a mask with about a quarter of the slots masked,
    and the row count."""
    counts = torch.full((4096,), 24, dtype=torch.long)
    counts[100] = 60_000
    recv = torch.repeat_interleave(torch.arange(4096, dtype=torch.int32), counts)
    mask = torch.from_numpy(np.random.default_rng(SEED + 12).random(recv.shape[0]) > 0.25)
    return recv, mask, 4096


def pna_bound_timing(dev, card, batches, hidden, agg, bwd, rp):
    """Part of phase 10: B5 (``pna_aggregate``), B6 (``pna_bwd_count``)
    and B7 (``pna_bwd_grad``) at H = ``hidden``, f32, on random normal v
    and cotangents over ``batches`` (label -> host receivers, mask, row
    count and occupancy): the flagship's unaligned batches of LOOP_BATCH
    and TRAIN_BATCH graphs, and a hub (its occupancy the whole array).
    Each kernel with the occupancy bound, as the main path calls it, and
    without it: held bit-equal to each other, then timed: ms eager and
    in a CUDA graph with and without the bound, plain ms, the library's
    ms (B5: the two ``torch.segment_reduce`` calls that give its sums and
    maxima, eager, they cannot be captured; none for B6 and B7), and the
    bound of the bounded work and of the whole pad (every input byte
    read once and every output byte written once: v only on the
    unmasked edges below the bound, the mask and B7's receivers up to
    it, B7's whole [E, H] gradient). Returns the entries by
    f"{kernel}_{label}"; raises on a mismatch."""
    out = {}
    for label, (recv_h, mask_h, n, occ_h) in batches.items():
        e = recv_h.shape[0]
        gen = torch.Generator(device=dev).manual_seed(13)
        recv, mask, occ = recv_h.to(dev), mask_h.to(dev), occ_h.to(dev)
        ptr = rp.row_pointers(recv, n)
        v = torch.randn(e, hidden, device=dev, generator=gen)
        g_sum, g_sumsq = (torch.randn(n, hidden, device=dev, generator=gen) for _ in range(2))
        g_both = torch.randn(n, 2 * hidden, device=dev, generator=gen)
        both = agg.pna_aggregate(v, recv, n, mask, ptr, occ)[3]
        cnt = bwd.pna_bwd_count(v, recv, mask, both, n, ptr, occ)
        lengths = torch.bincount(recv.long(), minlength=n)
        vm = torch.where(mask[:, None], v, 0.0)
        pair_sum = torch.cat([vm, vm * vm], dim=1)
        pair_max = torch.where(mask[:, None], torch.cat([v, -v], dim=1), float("-inf"))
        calls = {
            "pna_aggregate_fwd": (lambda b: agg.pna_aggregate(v, recv, n, mask, ptr, b),
                                  lambda: agg.pna_aggregate_plain(v, recv, n, mask, occ),
                                  lambda: (torch.segment_reduce(pair_sum, "sum", lengths=lengths, axis=0),
                                           torch.segment_reduce(pair_max, "max", lengths=lengths, axis=0))),
            "pna_bwd_count": (lambda b: bwd.pna_bwd_count(v, recv, mask, both, n, ptr, b),
                              lambda: bwd.pna_bwd_count_plain(v, recv, mask, both, n, occ), None),
            "pna_bwd_grad": (lambda b: bwd.pna_bwd_grad(v, recv, mask, both, g_sum, g_sumsq, g_both, cnt, b),
                             lambda: bwd.pna_bwd_grad_plain(v, recv, mask, both, g_sum, g_sumsq, g_both, cnt, occ),
                             None),
        }
        r = min(max(int(occ_h), 0), e)
        node = n * 2 * hidden * 4
        # bytes for the edges up to `to` of which `real` are unmasked
        nbytes = {
            "pna_aggregate_fwd": lambda to, real: real * hidden * 4 + to + (n + 1) * 4 + n * hidden * 8 + n * 4 + node,
            "pna_bwd_count": lambda to, real: real * hidden * 4 + to + (n + 1) * 4 + 2 * node,
            "pna_bwd_grad": lambda to, real: real * hidden * 4 + to * 5 + n * hidden * 8 + 3 * node + e * hidden * 4,
        }
        ops = {"pna_aggregate_fwd": 5, "pna_bwd_count": 4, "pna_bwd_grad": 7}
        real_r, real_e = int(mask_h[:r].sum()), int(mask_h.sum())
        for name, (kern, plain, library) in calls.items():
            a, b_ = kern(occ), kern(None)
            for x, y in zip(a if isinstance(a, tuple) else (a,), b_ if isinstance(b_, tuple) else (b_,)):
                compare(x, y, f"{name} {label} bound vs none", exact=True)
            t = {"kernel": [], "unbounded": []}
            for which in ("kernel", "unbounded", "unbounded", "kernel"):
                t[which].append(cuda_ms(lambda: kern(occ if which == "kernel" else None), 20))
            bms, by = bound(nbytes[name](r, real_r), real_r * hidden * ops[name])
            entry = {"ms": float(np.mean(t["kernel"])), "graph_ms": graph_ms(lambda: kern(occ), 20),
                     "ms_without_bound": float(np.mean(t["unbounded"])),
                     "graph_ms_without_bound": graph_ms(lambda: kern(None), 20),
                     "plain_ms": cuda_ms(plain, 3),
                     "library_ms": None if library is None else cuda_ms(library, 10),
                     "bound_ms": bms, "bound_by": by,
                     "bound_ms_whole_pad": bound(nbytes[name](e, real_e), real_e * hidden * ops[name])[0],
                     "E": e, "occupancy": r, "real_edges": real_r, "N": n, "H": hidden}
            out[f"{name}_{label}"] = entry
            line("timing", kernel=name, shape=f"{label}_bound_vs_none", card=repr(card), bit_equal=True,
                 **{kk: (round(x, 5) if isinstance(x, float) else x) for kk, x in entry.items()})
        del vm, pair_sum, pair_max
    return out


def stack_phase(dev, layouts, hidden, n_layers, mods, card):
    """Phase 8b: ``fused_conv_stack`` (B9) at full width on each layout
    of ``layouts`` (label -> host batch). Per layout the op runs forward
    and backward once with every launch count at 0 before it (the main
    path; its counts are returned), then is held against its plain
    version and the B8 loop, and timed beside the library calls that
    compute the same layers. Returns (counts by layout,
    timing by layout, the largest error against the plain version)."""
    from hydragnn_tpu_torch.ops import fused_conv as b8

    b9 = importlib.import_module("hydragnn_tpu_torch.ops.fused_conv_stack")
    rng = np.random.default_rng(SEED + 9)
    h, n_l = hidden, n_layers
    acts = ("sigmoid", "relu")
    w = torch.from_numpy((rng.normal(size=(n_l, h, h)) / np.sqrt(h)).astype(np.float32)).to(dev)
    bias = torch.from_numpy((rng.normal(size=(n_l, h)) * 0.1).astype(np.float32)).to(dev)
    counts, timing, worst = {}, {}, 0.0
    for k, (label, hb) in enumerate(layouts.items()):
        bd_ = hb.to(dev)
        n, e = bd_.num_nodes, bd_.num_edges
        x = quarter_grid((n, h), 95 + k).to(dev)
        g = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(dev)
        args = (bd_.senders, bd_.receivers, bd_.edge_mask, n)
        kw = dict(edge_act=acts[0], inter_act=acts[1], win=bd_.sender_win, real_edges=bd_.edge_occupancy)

        def op(xx, ww, bb):
            return b9.fused_conv_stack(xx, *args, ww, bb, **kw)

        # the main path: the op forward and backward, launches counted
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, bias)]
        for m in mods.values():
            m.launches.reset()
        out = op(*leaves)
        out.backward(g)
        torch.cuda.synchronize()
        counts[label] = {name: m.launches.value for name, m in mods.items()}
        grads = [t.grad for t in leaves]

        # B9 against its plain version on the card, and the B8 loop
        out = out.detach()
        with torch.no_grad():
            plain = b9.fused_conv_stack_plain(x, *args, w, bias, *acts)
            again = op(x, w, bias)

            def b8_loop():
                hh, lo = x, None
                for layer in range(n_l):
                    lo = b8.fused_conv(hh, *args, ((w[layer], bias[layer], None, None),), (acts[0],),
                                       real_edges=bd_.edge_occupancy)
                    hh = torch.relu(lo)
                return lo

            loop = b8_loop()
        torch.cuda.synchronize()
        if not torch.equal(bits(out), bits(again)):
            raise AssertionError(f"stack {label}: two launches differ")
        scale = float(plain.abs().max())
        err = float((out - plain).abs().max())
        loop_err = float((out - loop).abs().max())
        if not (np.isfinite(scale) and err <= STACK_TOL_REL * scale and loop_err <= STACK_TOL_REL * scale):
            raise AssertionError(f"stack {label}: B9 differs from plain by {err}, from the B8 loop by {loop_err} "
                                 f"(output scale {scale})")
        worst = max(worst, err)
        # the gradients against autograd through the plain version
        pleaves = [t.detach().clone().requires_grad_(True) for t in (x, w, bias)]
        b9.fused_conv_stack_plain(pleaves[0], *args, pleaves[1], pleaves[2], *acts).backward(g)
        grad_rel = {nm: rel_l2(a, p.grad) for nm, a, p in zip(("x", "W", "b"), grads, pleaves)}
        if max(grad_rel.values()) > STACK_GRAD_TOL:
            raise AssertionError(f"stack {label}: gradients differ from the plain version's: {grad_rel}")

        # the library yardsticks: one layer's node product (torch.addmm, then
        # the edge activation), one walk (torch.sparse.mm on the masked
        # adjacency), and their per-layer composition for the whole stack
        act_fn = b8.ACTS[acts[0]][0]
        crow = torch.zeros(n + 1, dtype=torch.int64)
        crow[1:] = torch.cumsum(torch.bincount(hb.receivers.long(), minlength=n), 0)
        adj = torch.sparse_csr_tensor(crow, hb.senders.long(), hb.edge_mask.float(), size=(n, n)).to(dev)
        q0 = act_fn(torch.addmm(bias[0], x, w[0]))

        def lib_stack():
            hh, lo = x, None
            for layer in range(n_l):
                lo = torch.sparse.mm(adj, act_fn(torch.addmm(bias[layer], hh, w[layer])))
                if layer + 1 < n_l:
                    hh = torch.relu(lo)
            return lo

        with torch.no_grad():
            lib_err = float((lib_stack() - plain).abs().max())
        if not lib_err <= STACK_TOL_REL * scale:
            raise AssertionError(f"stack {label}: the library composition differs from plain by {lib_err}")
        lib = {
            "addmm_act_ms": cuda_ms(lambda: act_fn(torch.addmm(bias[0], x, w[0])), 20),
            "addmm_act_graph_ms": graph_ms(lambda: act_fn(torch.addmm(bias[0], x, w[0])), 10),
            "sparse_mm_ms": cuda_ms(lambda: torch.sparse.mm(adj, q0), 20),
            "sparse_mm_graph_ms": graph_ms(lambda: torch.sparse.mm(adj, q0), 10),
            "library_ms": cuda_ms(lib_stack, 10), "library_graph_ms": graph_ms(lib_stack, 3),
        }

        # times: B9 forward, the B8 loop, forward + backward, plain
        xg, wg, bg = (t.detach().clone().requires_grad_(True) for t in (x, w, bias))
        fwd = lambda: op(x, w, bias)  # noqa: E731
        fwd_bwd = lambda: torch.autograd.grad(op(xg, wg, bg), (xg, wg, bg), g)  # noqa: E731
        t_fwd = [cuda_ms(fwd, 20)]
        plain_ms = cuda_ms(lambda: b9.fused_conv_stack_plain(x, *args, w, bias, *acts), 3)
        loop_ms = cuda_ms(b8_loop, 3)
        fwd_bwd_ms = cuda_ms(fwd_bwd, 3)
        t_fwd.append(cuda_ms(fwd, 20))
        graphs = {"ms": graph_ms(fwd, 10), "b8_loop_ms": graph_ms(b8_loop, 2), "fwd_bwd_ms": graph_ms(fwd_bwd, 2)}
        # the forward's device time by kernel: the node products, the walks
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
        split = {key: 0.0 for key in ("stack_product", "stack_walk", "csr_row_ptr_kernel")}
        for ev in prof.key_averages():
            for key in split:
                if key in ev.key:
                    split[key] += ev.self_device_time_total / 1e3
        real = int(hb.edge_mask.sum())
        # each input read once (x, the ids and mask, W, b), the output
        # written once; the node-level products and the masked adds
        nbytes = n * h * 4 + e * 9 + n_l * (h * h + h) * 4 + n * h * 4
        ops = 2 * n * h * h * n_l + real * h * n_l
        bms, by = bound(nbytes, ops)
        # a layer's product (its operations) and walk (Q and the senders,
        # mask and row pointers read once, h written once)
        product_bound = bound(0, 2 * n * h * h)[0]
        walk_bound = bound(2 * n * h * 4 + e * 5 + (n + 1) * 4, 0)[0]
        timing[label] = {
            "ms": float(np.mean(t_fwd)), "graph_ms": graphs["ms"], "plain_ms": plain_ms, **lib,
            "bound_ms": bms, "bound_by": by, "b8_loop_ms": loop_ms, "b8_loop_graph_ms": graphs["b8_loop_ms"],
            "backward_ms": fwd_bwd_ms - float(np.mean(t_fwd)),
            "backward_graph_ms": graphs["fwd_bwd_ms"] - graphs["ms"], "product_ms": split["stack_product"],
            "walk_ms": split["stack_walk"], "row_ptr_ms": split["csr_row_ptr_kernel"],
            "product_layer_ms": split["stack_product"] / n_l, "product_layer_bound_ms": product_bound,
            "walk_layer_ms": split["stack_walk"] / n_l, "walk_layer_bound_ms": walk_bound,
            "bytes": nbytes, "ops": ops,
            "E": e, "N": n, "H": h, "L": n_l,
        }
        line("stack", layout=label, E=e, N=n, H=h, L=n_l, acts="/".join(acts), real_edges=real,
             edge_occupancy=int(hb.edge_occupancy), max_abs_err_vs_plain=err, output_scale=scale,
             library_max_abs_err_vs_plain=lib_err,
             tol_rel=STACK_TOL_REL, max_abs_err_vs_b8_loop=loop_err,
             equal_to_b8_loop=bool(torch.equal(out, loop)), grad_rel_l2_vs_plain=json.dumps(grad_rel),
             grad_tol=STACK_GRAD_TOL, deterministic=True, card_kernels_per_call=2 * n_l + 2,
             kernel_launches_fwd_bwd=json.dumps(counts[label], separators=(",", ":")), card=repr(card),
             **{k: (round(v, 5) if isinstance(v, float) else v) for k, v in timing[label].items()
                if k not in ("E", "N", "H", "L")})
    return counts, timing, worst


# the [data-path] phase: the flagship trained from files (the [train]
# phase's 1,280 graphs written as LSMS text and as an HGC container)
DATA_EPOCHS = 2
# the LSMS text holds 10 significant digits: the prepared features within
# rtol 1e-6 of the in-memory set, the losses within rtol 1e-5
DATA_FEATURE_RTOL, DATA_LOSS_RTOL = 1e-6, 1e-5
# one large cloud where the radius search takes the cell grid (the
# flagship's graphs, at most 54 atoms, take the brute-force pairs)
DATA_CLOUD_CELLS = 16
# the [data-eam] phase: the NiNb EAM multitask example config, read from
# disk, on synthetic CFG files (BCC, a = 3.30 A: 8 first-shell neighbours
# at 2.86 A inside its radius of 3.0, the second shell at 3.30 outside)
EAM_CONFIG, EAM_FILES, EAM_EPOCHS, EAM_LATTICE = "examples/eam/NiNb_EAM_bulk_multitask.json", 1280, 2, 3.30
EAM_SPECIES = {"Ni": (28, 58.693), "Nb": (41, 92.906)}  # proton number, mass
PORT_KERNELS = ("gather_stats", "gather_stats_bwd", "segment_sum", "gather_rows", "segment_sum_local")


def write_cfg_files(path, n_files, seed, a=EAM_LATTICE, cells=(2, 4)):
    """AtomEye CFG files as the EAM examples read them: BCC supercells of
    2-3 unit cells a side at lattice constant ``a``, each atom Ni or Nb
    (proton number and mass), seeded ``c_peratom``, ``fx``, ``fy``,
    ``fz``, and a ``.bulk`` sidecar whose column 2 holds a seeded bulk
    modulus. The same writer as ``tests/test_torch_cuda_kernels.py``."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for k in range(n_files):
        reps = rng.integers(cells[0], cells[1], 3)
        frac = np.array([[i, j, l] for i in range(reps[0]) for j in range(reps[1]) for l in range(reps[2])],
                        dtype=np.float64)
        frac = np.concatenate([frac, frac + 0.5]) / reps
        names = np.where(rng.random(frac.shape[0]) < 0.5, "Ni", "Nb")
        aux = rng.normal(size=(frac.shape[0], 4))
        lines = [f"Number of particles = {frac.shape[0]}", "A = 1.0 Angstrom (basic length-scale)"]
        for i in range(3):
            for j in range(3):
                lines.append(f"H0({i + 1},{j + 1}) = {float(a * reps[i]) if i == j else 0.0!r} A")
        lines += [".NO_VELOCITY.", "entry_count = 7", "auxiliary[0] = c_peratom", "auxiliary[1] = fx",
                  "auxiliary[2] = fy", "auxiliary[3] = fz"]
        for name in ("Ni", "Nb"):
            rows = np.nonzero(names == name)[0]
            if rows.size == 0:
                continue
            lines += [repr(EAM_SPECIES[name][1]), name]
            lines += [" ".join(repr(float(v)) for v in (*frac[r], *aux[r])) for r in rows]
        stem = os.path.join(path, f"cfg{k:05d}")
        with open(stem + ".cfg", "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(stem + ".bulk", "w") as f:
            f.write(" ".join(repr(float(v)) for v in (k, frac.shape[0], 150.0 + 40.0 * rng.random())) + "\n")


@contextlib.contextmanager
def deterministic_algorithms(phase, label, card=None):
    """PyTorch's deterministic algorithms for bit-equal runs (the pooling's
    ``index_add_`` adds with atomics otherwise); the warnings of ops
    without a deterministic implementation are counted and printed (with
    the card line when given)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message)[:160] for w in caught if "deterministic" in str(w.message)})
    line(phase, part="determinism", runs=label, deterministic_algorithms=True,
         nondeterministic_op_warnings=len(nondet), first=json.dumps(nondet[:3]),
         **({"card": repr(card)} if card is not None else {}))


def pna_step_vs_cpu(label, nn_cfg_, batch_, step_want, counts, reordered=()):
    """The train step at ``batch_`` on the card against the CPU, held to
    the STEP_* tiers, the card's launches to ``step_want`` and the CPU's
    to none; with ``reordered`` (the same graphs batched in other
    orders) the head tier is the stacks' spread rule instead.
    ``counts`` is the (reset, read) pair of the kernels' launch counts."""
    from hydragnn_tpu_torch.models.base import model_loss
    from hydragnn_tpu_torch.models.create import create_model_config

    reset_counts, read_counts = counts
    results = {}
    orders = [f"order{j}" for j in range(len(reordered))]
    for where in ["cpu", "cuda"] + orders:
        m = create_model_config(nn_cfg_, seed=SEED + 1, device="cuda" if where == "cuda" else "cpu")
        b = (reordered[orders.index(where)] if where in orders else batch_).to(next(m.parameters()).device)
        reset_counts()
        m.zero_grad(set_to_none=True)
        loss, tasks = model_loss(m.cfg, m(b, train=True), b)
        loss.backward()
        results[where] = (
            loss.item(), {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
            {k: v.detach().cpu() for k, v in m.state_dict().items() if "running" in k}, read_counts(),
        )
    step_want = {name: step_want.get(name, 0) for name in results["cpu"][3]}
    if results["cuda"][3] != step_want or any(any(results[w][3].values()) for w in ["cpu"] + orders):
        raise AssertionError(f"{label} step launches card {results['cuda'][3]}, cpu {results['cpu'][3]}; "
                             f"want {step_want}")
    rel = {}  # relative L2 difference, card against CPU, per gradient
    worst = {"head": ("", 0.0), "conv": ("", 0.0), "zero": ("", 0.0)}
    gc_all, gp_all = results["cuda"][1], results["cpu"][1]
    head_bad, head_limit = {}, {}
    for k, g in gp_all.items():
        if k.startswith("convs.") and k.endswith("post.bias"):
            ref_w = max(float(gp_all[k[:-4] + "weight"].abs().max()), 1e-30)
            r = max(float(g.abs().max()), float(gc_all[k].abs().max())) / ref_w
            tier = "zero"
        else:
            r = rel_l2(gc_all[k], g)
            tier = "conv" if k.startswith(("convs.", "norms.")) else "head"
        if tier == "head" and orders:
            spread = max(rel_l2(results[o][1][k], g) for o in orders)
            head_limit[k] = max(STACK_GRAD_TOL, STACK_SPREAD_FACTOR * spread)
            if r > head_limit[k]:
                head_bad[k] = (r, spread)
        rel[k] = r
        if r >= worst[tier][1]:
            worst[tier] = (k, r)
    bn_ok = all(torch.allclose(results["cuda"][2][k], v, **STEP_BN_TOL) for k, v in results["cpu"][2].items())
    worst_spread = (max(rel_l2(results[o][1][worst["head"][0]], gp_all[worst["head"][0]]) for o in orders)
                    if orders else "not measured")
    line(label, graphs=batch_.num_graphs - 1, edge_pad=batch_.num_edges, loss_card=results["cuda"][0],
         loss_cpu=results["cpu"][0], head_rule="spread" if orders else "tier",
         head_grad_rel_l2_and_spread_above_tol=json.dumps(head_bad), worst_head_spread=worst_spread,
         worst_head_limit=head_limit.get(worst["head"][0], STEP_HEAD_TOL),
         head_limit_min_max=json.dumps([min(head_limit.values()), max(head_limit.values())])
         if head_limit else json.dumps([STEP_HEAD_TOL] * 2),
         worst_head_grad_rel_l2=json.dumps(worst["head"]),
         worst_conv_grad_rel_l2=json.dumps(worst["conv"]), worst_bn_fed_bias_grad=json.dumps(worst["zero"]),
         bn_stats_close=bn_ok, params=len(rel), kernel_launches=json.dumps(results["cuda"][3], separators=(",", ":")))
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0], rtol=STEP_LOSS_RTOL, err_msg=f"{label} loss")
    # with the spread rule the heads are held by head_bad instead
    limits = {"head": float("inf") if orders else STEP_HEAD_TOL, "conv": STEP_CONV_TOL, "zero": STEP_ZERO_TOL}
    if not bn_ok or head_bad or any(worst[t][1] > limits[t] for t in worst):
        raise AssertionError(f"{label}: card and CPU differ beyond the tolerance: {rel}, BN close {bn_ok}")


def data_path_phase(dev, card, counts):
    """[data-path]: the flagship at full width trained from files. The
    [train] phase's 1,280 graphs go to disk twice, as LSMS text
    (``write_lsms_files``) and as an HGC container (``ContainerWriter``,
    which stores float32 features and targets); their read times, the
    radius graph native and numpy, ``prepare_dataset``; then
    ``run_training`` from ``Dataset.path`` for each, under deterministic
    algorithms: the HGC run's history bit-equal to ``samples=`` on the
    samples as stored, the LSMS run's prepared features within
    DATA_FEATURE_RTOL and its losses within DATA_LOSS_RTOL of the
    in-memory set in the files' lexical order; ``run_prediction`` from the
    container, denormalized. Returns the HGC run's launches."""
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch import native
    from hydragnn_tpu_torch.api import prepare_config_and_samples
    from hydragnn_tpu_torch.data.container import ContainerDataset, ContainerWriter
    from hydragnn_tpu_torch.data.lsms import read_lsms_dir
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data, write_lsms_files
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.train.loop import EPOCH_KEYS

    rg = importlib.import_module("hydragnn_tpu_torch.data.radius_graph")
    reset_counts, read_counts = counts
    native._load()
    line("data-path", part="native", have_native=native.HAVE_NATIVE,
         library=os.path.relpath(os.path.join(native._BUILD_DIR, "libhgc.so"), os.path.dirname(os.path.abspath(__file__))))
    if not native.HAVE_NATIVE:
        raise AssertionError("data-path: the native host core (native/*.cpp) did not build or load")

    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    lsms_dir, hgc_dir = os.path.join(root, "lsms"), os.path.join(root, "flagship.hgc")
    gen = dict(number_configurations=TRAIN_SAMPLES, unit_cell_x_range=TRAIN_UNIT_CELLS,
               unit_cell_y_range=TRAIN_UNIT_CELLS, unit_cell_z_range=TRAIN_UNIT_CELLS, seed=SEED)

    def stored():
        """The set as the container stores it (float32 features, targets)."""
        out = deterministic_graph_data(**gen)
        for s in out:
            s.x, s.graph_y = s.x.astype(np.float32), s.graph_y.astype(np.float32)
        return out

    def config(fmt=None, path=None):
        cfg = flagship_config(batch_size=TRAIN_BATCH, num_epoch=DATA_EPOCHS)
        cfg["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] = True
        if fmt is not None:
            cfg["Dataset"].update(format=fmt, path={"total": path})
        return cfg

    t0 = time.perf_counter()
    write_lsms_files(lsms_dir, **gen)
    t1 = time.perf_counter()
    writer = ContainerWriter(hgc_dir)
    writer.add(stored())
    writer.save()
    t2 = time.perf_counter()
    hgc_mib = sum(os.path.getsize(os.path.join(hgc_dir, f)) for f in os.listdir(hgc_dir)) / 2**20
    line("data-path", part="write", graphs=TRAIN_SAMPLES, lsms_files=len(os.listdir(lsms_dir)),
         lsms_write_s=round(t1 - t0, 4), hgc_write_s=round(t2 - t1, 4), hgc_mib=round(hgc_mib, 3))

    # read times: the LSMS text, the container in each mode (and its bulk gather)
    reads = {}
    t0 = time.perf_counter()
    lsms = read_lsms_dir(lsms_dir, config()["Dataset"])
    reads["lsms_text"] = time.perf_counter() - t0
    want = stored()
    for mode in ("mmap", "preload", "shm"):
        t0 = time.perf_counter()
        ds = ContainerDataset(hgc_dir, mode=mode, shm_dir=os.path.join(root, "shm") if mode == "shm" else None)
        got = ds.samples()
        reads[f"hgc_{mode}"] = time.perf_counter() - t0
        if mode == "mmap":
            t0 = time.perf_counter()
            bulk = ds.fetch_samples(range(len(ds)))
            reads["hgc_mmap_fetch_samples"] = time.perf_counter() - t0
            got = got + bulk
        for a, b in zip(got, want + want):
            if not (np.array_equal(a.x, b.x) and np.array_equal(a.pos, b.pos) and np.array_equal(a.graph_y, b.graph_y)
                    and a.x.dtype == b.x.dtype):
                raise AssertionError(f"data-path: the container read ({mode}) differs from what was written")
    line("data-path", part="read", graphs=len(lsms), card=repr(card),
         **{f"{k}_s": round(v, 4) for k, v in reads.items()})

    # the radius graph over the set, native and numpy; then one large cloud
    positions = [s.pos for s in lsms]

    def graph_all():
        return [rg.radius_graph(p, 2.0, max_num_neighbors=100) for p in positions]

    def numpy_only(fn):
        saved = native.native_radius_pairs
        native.native_radius_pairs = lambda *a: None
        try:
            return fn()
        finally:
            native.native_radius_pairs = saved

    t0 = time.perf_counter()
    e_native = graph_all()
    t1 = time.perf_counter()
    e_numpy = numpy_only(graph_all)
    t2 = time.perf_counter()
    if not all(np.array_equal(a, b) for a, b in zip(e_native, e_numpy)):
        raise AssertionError("data-path: native and numpy radius graphs differ over the set")
    grid_calls = sum(p.shape[0] ** 2 > 4096 for p in positions)
    g = np.stack(np.meshgrid(*[np.arange(DATA_CLOUD_CELLS)] * 3, indexing="ij"), -1).reshape(-1, 3)
    cloud = np.concatenate([g, g + 0.5]).astype(np.float64)
    cloud += np.random.default_rng(SEED).normal(scale=0.01, size=cloud.shape)  # no distance ties
    t3 = time.perf_counter()
    c_native = rg.radius_graph(cloud, 2.0, max_num_neighbors=100)
    t4 = time.perf_counter()
    c_numpy = numpy_only(lambda: rg.radius_graph(cloud, 2.0, max_num_neighbors=100))
    t5 = time.perf_counter()
    if not np.array_equal(c_native, c_numpy):
        raise AssertionError("data-path: native and numpy radius graphs differ on the large cloud")
    line("data-path", part="radius_graph", graphs=len(positions), edges=sum(e.shape[1] for e in e_native),
         set_native_s=round(t1 - t0, 4), set_numpy_s=round(t2 - t1, 4), set_calls_through_the_grid=int(grid_calls),
         cloud_atoms=cloud.shape[0], cloud_edges=c_native.shape[1], cloud_native_s=round(t4 - t3, 4),
         cloud_numpy_s=round(t5 - t4, 4), card=repr(card))

    # prepare_dataset: the LSMS set against the in-memory set in the files' lexical order
    order = sorted(range(TRAIN_SAMPLES), key=lambda k: f"output{k}.txt")

    def lexical():
        mem = deterministic_graph_data(**gen)
        return [mem[k] for k in order]

    t0 = time.perf_counter()
    prep_lsms = prepare_config_and_samples(config(), lsms)
    prepare_s = time.perf_counter() - t0
    prep_mem = prepare_config_and_samples(config(), lexical())
    worst = 0.0
    for split_a, split_b in zip(prep_lsms[:3], prep_mem[:3]):
        for a, b in zip(split_a, split_b):
            np.testing.assert_allclose(a.x, b.x, rtol=DATA_FEATURE_RTOL, atol=0, err_msg="data-path features")
            if not np.array_equal(a.edge_index, b.edge_index):
                raise AssertionError("data-path: the LSMS set's edges differ from the in-memory set's")
            worst = max(worst, float(np.abs(a.x - b.x).max()))
    line("data-path", part="prepare", graphs=TRAIN_SAMPLES, prepare_dataset_s=round(prepare_s, 4),
         lsms_vs_memory_max_abs_feature_err=worst, feature_rtol=DATA_FEATURE_RTOL, card=repr(card))

    # training: from each format and from memory, deterministic
    runs = {}
    with deterministic_algorithms("data-path", "memory_hgc_lexical_lsms"):
        for label, cfg, samples in (("memory", config(), stored()), ("hgc", config("HGC", hgc_dir), None),
                                    ("memory_lexical", config(), lexical()),
                                    ("lsms", config("unit_test", lsms_dir), None)):
            log_dir = tempfile.mkdtemp(prefix=f"chip_smoke_data_{label}_")
            reset_counts()
            t0 = time.perf_counter()
            _, _, hist, _ = hydragnn_tpu_torch.run_training(cfg, samples, log_dir=log_dir, device="cuda", seed=SEED)
            torch.cuda.synchronize()
            runs[label] = (hist, read_counts(), time.perf_counter() - t0, log_dir)
            if not all(np.isfinite(hist[k]).all() for k in ("train_loss", "val_loss", "test_loss")):
                raise AssertionError(f"data-path {label}: a loss is not finite: {hist}")
            line("data-path", part="train", source=label, epochs=DATA_EPOCHS, batch=TRAIN_BATCH,
                 train_loss=json.dumps(hist["train_loss"]), val_loss=json.dumps(hist["val_loss"]),
                 test_loss=json.dumps(hist["test_loss"]), epoch_wall_s=json.dumps([round(w, 4) for w in hist["train_wall_s"]]),
                 run_wall_s=round(runs[label][2], 3),
                 kernel_launches=json.dumps({k: v for k, v in runs[label][1].items() if v}, separators=(",", ":")),
                 card=repr(card))
    h_mem, h_hgc = runs["memory"][0], runs["hgc"][0]
    if any(h_mem[k] != h_hgc[k] for k in EPOCH_KEYS):
        raise AssertionError(f"data-path: the HGC run is not bit-equal to the in-memory run: {h_hgc} vs {h_mem}")
    for k in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(runs["lsms"][0][k], runs["memory_lexical"][0][k], rtol=DATA_LOSS_RTOL,
                                   err_msg=f"data-path LSMS {k}")
    lsms_err = max(abs(a - b) / abs(b) for k in ("train_loss", "val_loss", "test_loss")
                   for a, b in zip(runs["lsms"][0][k], runs["memory_lexical"][0][k]))
    hgc_counts = runs["hgc"][1]
    if any(r[1] != hgc_counts for r in runs.values()) or not all(hgc_counts.get(k) for k in PORT_KERNELS):
        raise AssertionError(f"data-path: launches {[(k, r[1]) for k, r in runs.items()]}; B1-B4 must all run")
    line("data-path", part="parity", hgc_history_bit_equal=True, lsms_loss_max_rel_err=lsms_err,
         loss_rtol=DATA_LOSS_RTOL, launches_equal=True)

    # prediction from the container, denormalized
    err, err_h, trues, preds = hydragnn_tpu_torch.run_prediction(config("HGC", hgc_dir), log_dir=runs["hgc"][3],
                                                               device="cuda")
    maes = [float(np.mean(np.abs(t - p))) for t, p in zip(trues, preds)]
    if not (np.isfinite(err) and all(np.isfinite(m) for m in maes)):
        raise AssertionError(f"data-path predict: not finite: {err}, {maes}")
    line("data-path", part="predict", source="hgc", test_loss=err, heads=len(maes), denormalized=True,
         mae_per_head=json.dumps(maes), rows=json.dumps([int(p.shape[0]) for p in preds]), card=repr(card))
    return hgc_counts


def data_eam_phase(dev, card, counts):
    """[data-eam]: ``examples/eam/NiNb_EAM_bulk_multitask.json`` read from
    disk at its published width (PNA, hidden 50, 10 layers, edge lengths,
    PBC, rotational invariance, a graph and two node heads, batch 16) with
    only ``Dataset.path`` (synthetic CFG files) and ``num_epoch`` changed:
    run_training on the card (finite, falling loss), the first batch's
    forward and backward against the CPU, the step on CUDA events, the
    card's busy share, launches a step, and run_prediction's per-head
    MAE. Returns the run's launches."""
    import hydragnn_tpu_torch

    from hydragnn_tpu_torch.api import prepare_loaders_and_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import train_step

    reset_counts, read_counts = counts
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), EAM_CONFIG)) as f:
        published = json.load(f)
    root = tempfile.mkdtemp(prefix="chip_smoke_eam_")
    cfg_dir = os.path.join(root, "cfg")

    def config():
        cfg = copy.deepcopy(published)
        cfg["Dataset"]["path"] = {"total": cfg_dir}
        cfg["NeuralNetwork"]["Training"]["num_epoch"] = EAM_EPOCHS
        return cfg

    arch = published["NeuralNetwork"]["Architecture"]
    line("data-eam", part="config", source=EAM_CONFIG,
         overrides=json.dumps({"Dataset.path": {"total": "<temporary directory>"},
                               "NeuralNetwork.Training.num_epoch": EAM_EPOCHS}),
         model_type=arch["model_type"], hidden=arch["hidden_dim"], conv_layers=arch["num_conv_layers"],
         edge_features=json.dumps(arch.get("edge_features")), pbc=arch["periodic_boundary_conditions"],
         rotational_invariance=published["Dataset"]["rotational_invariance"], radius=arch["radius"],
         max_neighbours=arch["max_neighbours"], heads=json.dumps(published["NeuralNetwork"]["Variables_of_interest"]["output_names"]),
         batch=published["NeuralNetwork"]["Training"]["batch_size"])
    t0 = time.perf_counter()
    write_cfg_files(cfg_dir, EAM_FILES, SEED)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaders = prepare_loaders_and_config(config())
    train_loader, done = loaders[0], loaders[3]
    prepare_s = time.perf_counter() - t0
    first = next(iter(train_loader))
    degrees = np.bincount(first.receivers[first.edge_mask].numpy().astype(np.int64))
    line("data-eam", part="data", files=EAM_FILES, write_s=round(write_s, 3), read_and_prepare_s=round(prepare_s, 3),
         train_graphs=len(train_loader.samples), steps_per_epoch=len(train_loader), node_pad=first.num_nodes,
         edge_pad=first.num_edges, run_align=first.run_align,
         dense_slots=None if first.dense_senders is None else first.dense_senders.shape[1],
         edge_dim=done["NeuralNetwork"]["Architecture"]["edge_dim"],
         in_degree_min_max=json.dumps([int(degrees[degrees > 0].min()), int(degrees.max())]), card=repr(card))

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_eam_logs_")
    reset_counts()
    t0 = time.perf_counter()
    model, optimizer, hist, done = hydragnn_tpu_torch.run_training(config(), log_dir=log_dir, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts = read_counts()
    losses = hist["train_loss"]
    if not all(np.isfinite(hist[k]).all() for k in ("train_loss", "val_loss", "test_loss")):
        raise AssertionError(f"data-eam: a loss is not finite: {hist}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"data-eam: the train loss did not fall: {losses}")
    launched = {k: v for k, v in run_counts.items() if v}
    per_step, per_fwd = launch_plan(done["NeuralNetwork"]["Architecture"], "run_aligned")
    steps = EAM_EPOCHS * len(train_loader)
    fwds = EAM_EPOCHS * (len(loaders[1]) + len(loaders[2])) + 2 * len(train_loader)
    want = plus({k: steps * per_step.get(k, 0) + fwds * per_fwd.get(k, 0) for k in run_counts},
                telemetry_launches(per_step, per_fwd, EAM_EPOCHS, model.cfg.num_heads))
    if run_counts != want:
        raise AssertionError(f"data-eam: launches {run_counts}, want {want}")
    line("data-eam", part="train", epochs=EAM_EPOCHS, steps=steps, eval_and_bn_forwards=fwds,
         train_loss=json.dumps(losses),
         val_loss=json.dumps(hist["val_loss"]), test_loss=json.dumps(hist["test_loss"]),
         epoch_wall_s=json.dumps([round(w, 4) for w in hist["train_wall_s"]]), run_wall_s=round(wall, 3),
         kernels_launched=json.dumps(sorted(launched)), kernel_launches=json.dumps(launched, separators=(",", ":")),
         card=repr(card))

    # the first batch's forward and backward against the CPU, and its launches
    pna_step_vs_cpu("data-eam-step-vs-cpu", done["NeuralNetwork"], first, per_step, counts)

    # the step: launches, CUDA events, the card's busy share
    bd = first.to(dev)
    m = create_model_config(done["NeuralNetwork"], seed=SEED, device="cuda")
    o = select_optimizer(m, done["NeuralNetwork"]["Training"])
    step_ms = [round(cuda_ms(lambda: train_step(m, o, bd), 10), 4) for _ in range(3)]
    prof_wall_ms, rows = step_profile(m, o, bd)
    line("data-eam", part="step", graphs=int(first.graph_mask.sum()), step_ms_cuda_events=json.dumps(step_ms),
         profiled_wall_ms=round(prof_wall_ms, 3), **busy_fields(prof_wall_ms, rows),
         device_kernels_seen=len(rows), port_launches_per_step=json.dumps(per_step, separators=(",", ":")),
         card=repr(card))
    for key, ms, calls in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  profile[data-eam]: {ms:9.3f} ms {calls:5d} calls  {key[:110]}")

    # prediction, denormalized (the config's denormalize_output)
    err, err_h, trues, preds = hydragnn_tpu_torch.run_prediction(config(), log_dir=log_dir, device="cuda")
    maes = [float(np.mean(np.abs(t - p))) for t, p in zip(trues, preds)]
    if not (np.isfinite(err) and all(np.isfinite(v) for v in maes)):
        raise AssertionError(f"data-eam predict: not finite: {err}, {maes}")
    line("data-eam", part="predict", test_loss=err,
         heads=json.dumps(published["NeuralNetwork"]["Variables_of_interest"]["output_names"]),
         mae_per_head=json.dumps(maes), denormalized=published["NeuralNetwork"]["Variables_of_interest"].get(
             "denormalize_output", False), card=repr(card))
    return run_counts


# the [examples] phase: each example driver through main([...]) on the
# card, the published config unedited, data counts through the driver's
# own arguments (the JAX drivers' defaults; the Ising lattice 3 x 3 x 3
# at a histogram cutoff of 100, about 2,460 configurations)
EXAMPLE_DRIVERS = (
    ("ising_model", "ising_model.train_ising", True, ["--natom", "3", "--cutoff", "100"]),
    ("lsms", "lsms.lsms", True, ["--nconfig", "200"]),
    ("eam", "eam.eam", True, ["--nconfig", "100"]),
    ("csce", "csce.train_gap", True, []),
    ("ogb", "ogb.train_gap", True, []),
    ("qm9", "qm9.qm9", False, ["--nsamples", "1000"]),
    ("md17", "md17.md17", False, ["--maxframes", "1000"]),
)
# the [records] phase: the flagship at batch 128 for 2 epochs, tracing
# epoch 1; 1,800 graphs give 1,440 train graphs, 12 steps an epoch, so the
# profiler's 5 + 3 untraced steps leave 3 to trace
RECORDS_SAMPLES, RECORDS_EPOCHS, RECORDS_PROFILE = 1800, 2, {"enable": 1, "target_epoch": 1}


def batch_layout(batch):
    """The layout the loader's AUTO pick gave ``batch``."""
    if batch.dense_senders is not None:
        return "dense"
    return "run_aligned" if batch.run_align else "unaligned"


def launch_plan(arch, layout):
    """(per train step, per eval or BatchNorm-statistics forward) kernel
    launches of a model of ``arch`` on ``layout``: the one source of the
    counts that [train], [train-stacks], [train-pna-layouts], [data-eam],
    [examples] and [records] hold (the conv stacks by ``stack_launches``;
    their conv does not read the dense map)."""
    n = arch["num_conv_layers"]
    edge = bool(arch.get("edge_features"))
    if arch["model_type"] != "PNA":
        return stack_launches(arch["model_type"], n), {"fused_conv": n, "row_pointers": 1}
    if layout == "dense" and not edge:
        # the slot gather (B3; its backward B3 and B2 over the real slots),
        # then the slot reductions in plain PyTorch
        return {"gather_rows": 2 * n, "segment_sum": n}, {"gather_rows": n}
    if layout == "run_aligned" and edge:
        # v = gather (B3; its backward B3 and B2) + the edge term, K-group
        # statistics in plain PyTorch, then B2 (its backward B3) and the
        # E/K segment max (its backward B2 and B3)
        return {"gather_rows": 5 * n, "segment_sum": 3 * n}, {"gather_rows": n, "segment_sum": n}
    if layout == "run_aligned":
        # a train step: B1 (forward) and its backward kernel, B2 twice
        # (forward E/K sum, backward tie counts), B3 three times (backward:
        # the max's two gathers, the E/K sum's cotangent), B4 (backward
        # into bsend), a layer each; a forward: B1 and B2
        return ({"gather_stats": n, "gather_stats_bwd": n, "segment_sum": 2 * n, "gather_rows": 3 * n,
                 "segment_sum_local": n}, {"gather_stats": n, "segment_sum": n})
    if layout == "unaligned" and not edge:
        # the sender gather (B3; its backward the permuted pair, B3 then
        # B2), B5 forward, B6 and B7 backward, a layer each; B5's row
        # pointers once a forward
        return ({"pna_aggregate_fwd": n, "pna_bwd_count": n, "pna_bwd_grad": n, "gather_rows": 2 * n,
                 "segment_sum": n, "row_pointers": 1}, {"pna_aggregate_fwd": n, "gather_rows": n, "row_pointers": 1})
    raise AssertionError(f"no launch plan for {arch['model_type']} on {layout} with edge features {edge}")


def telemetry_launches(per_step, per_fwd, epochs, heads):
    """The launches the training loop's telemetry adds to a run of
    ``epochs`` epochs of a model with ``heads`` heads (diagnostics on, the
    default): a diagnostics sample an epoch, one forward and ``heads`` + 1
    backward pulls through its graph, and the hardware ledger's one
    forward and backward before the first epoch. A backward's launches are
    a train step's less its forward's (``launch_plan``)."""
    names = set(per_step) | set(per_fwd)
    bwd = {k: per_step.get(k, 0) - per_fwd.get(k, 0) for k in names}
    return {k: epochs * (per_fwd.get(k, 0) + (heads + 1) * bwd[k]) + per_step.get(k, 0) for k in names}


def plus(a, b):
    """The sum of two launch-count dicts, over ``a``'s keys."""
    return {k: a[k] + b.get(k, 0) for k in a}


def step_profile(model, optimizer, batch):
    """One train step under torch.profiler: its wall ms and the card's
    kernels as (name, self device ms, calls); no kernels where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_tpu_torch.train.state import train_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, optimizer, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]
    return wall, rows


def busy_fields(wall_ms, rows):
    """The card's busy ms and busy share of a profiled step, or "not
    measured" where the profiler saw no device time."""
    busy = sum(ms for _, ms, _ in rows)
    if not rows:
        return {"device_busy_ms": "not measured", "device_busy_share": "not measured"}
    return {"device_busy_ms": round(busy, 3), "device_busy_share": round(busy / wall_ms, 4)}


def examples_phase(dev, card, counts):
    """[examples]: the seven example drivers (``hydragnn_tpu_torch/examples``)
    through ``main([...])`` in a temporary working directory on the card:
    ``--preonly`` where the driver has it, then training, each on its
    published config at its published width. For each: the layout AUTO
    picked, the kernels launched (held to ``launch_plan``), the step on
    CUDA events and the card's busy share on its first train batch, the
    epoch wall, the first and last train loss (finite, falling), its
    seconds. A driver's output goes to a log in the directory; the log's
    tail is printed when it fails. Returns each driver's launches."""
    import contextlib
    import importlib

    from hydragnn_tpu_torch.train.state import train_step

    reset_counts, read_counts = counts
    root = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    cwd = os.getcwd()
    launches = {}
    os.chdir(root)
    try:
        for name, module, preonly, args in EXAMPLE_DRIVERS:
            driver = importlib.import_module(f"hydragnn_tpu_torch.examples.{module}")
            log_path = os.path.join(root, f"{name}.log")
            t0 = time.perf_counter()
            try:
                with open(log_path, "w") as log, contextlib.redirect_stdout(log):
                    if preonly:
                        driver.main(["--preonly", *args, "--device", "cuda"])
                    pre_s = time.perf_counter() - t0
                    reset_counts()
                    result = driver.main([*args, "--device", "cuda"])
                    torch.cuda.synchronize()
                    got = read_counts()
            except BaseException:
                with open(log_path) as f:
                    print(f"[examples] driver={name} failed; the end of its output:", flush=True)
                    print("".join(f.readlines()[-40:]), flush=True)
                raise
            hist, (tl, vl, tel) = result.history, result.loaders
            arch = result.config["NeuralNetwork"]["Architecture"]
            first = next(iter(tl))
            layout = batch_layout(first)
            per_step, per_fwd = launch_plan(arch, layout)
            epochs = len(hist["train_loss"])
            steps, fwds = epochs * len(tl), epochs * (len(vl) + len(tel)) + 2 * len(tl)
            want = plus({k: steps * per_step.get(k, 0) + fwds * per_fwd.get(k, 0) for k in got},
                        telemetry_launches(per_step, per_fwd, epochs, result.model.cfg.num_heads))
            if got != want:
                raise AssertionError(f"examples {name}: launches {got}, want {want}")
            losses = hist["train_loss"]
            if not all(np.isfinite(hist[k]).all() for k in ("train_loss", "val_loss", "test_loss")):
                raise AssertionError(f"examples {name}: a loss is not finite: {hist}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"examples {name}: the train loss did not fall: {losses}")
            bd = first.to(dev)
            step_ms = [round(cuda_ms(lambda: train_step(result.model, result.optimizer, bd), 10), 4)
                       for _ in range(2)]
            prof_wall, rows = step_profile(result.model, result.optimizer, bd)
            launched = {k: v for k, v in got.items() if v}
            launches[name] = got
            line("examples", driver=name, module=f"hydragnn_tpu_torch.examples.{module}", args=json.dumps(args),
                 model_type=arch["model_type"], hidden=arch["hidden_dim"], conv_layers=arch["num_conv_layers"],
                 edge_features=json.dumps(arch.get("edge_features")), layout=layout, run_align=first.run_align,
                 dense_slots=None if first.dense_senders is None else first.dense_senders.shape[1],
                 node_pad=first.num_nodes, edge_pad=first.num_edges, batch=result.config["NeuralNetwork"][
                     "Training"]["batch_size"], train_graphs=len(tl.samples), epochs=epochs, steps=steps,
                 eval_and_bn_forwards=fwds, kernels_launched=json.dumps(sorted(launched)),
                 kernel_launches=json.dumps(launched, separators=(",", ":")),
                 step_ms_cuda_events=json.dumps(step_ms), profiled_step_wall_ms=round(prof_wall, 3),
                 **busy_fields(prof_wall, rows),
                 epoch_wall_s=json.dumps([round(w, 4) for w in hist["train_wall_s"]]),
                 first_loss=losses[0], last_loss=losses[-1], preonly_s=round(pre_s, 2),
                 seconds=round(time.perf_counter() - t0, 2), card=repr(card))
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return launches


def records_phase(dev, card, counts, samples):
    """[records]: the flagship at full width in the training loop, batch
    128, 2 epochs, with ``Profile {enable: 1, target_epoch: 1}`` under
    deterministic algorithms: ``metrics.jsonl`` has a line an epoch equal
    to the returned history; the peak memory the loop prints after epoch 0
    equals ``torch.cuda.max_memory_allocated`` read as it prints; the
    Chrome trace exists, holds the traced steps' CUDA kernels and names
    the port's; the history and parameters are bit-equal to the same
    per-step run without ``Profile``. Prints whether the tensorboard
    writer is real and whether matplotlib is present, and plots the test
    pass when it is. Returns the profiled run's launches."""
    import contextlib
    import importlib.util
    import io

    from hydragnn_tpu_torch.api import create_dataloaders, prepare_config_and_samples
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train import loop as t_loop
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.utils.tensorboard import get_summary_writer

    reset_counts, read_counts = counts
    tr, va, te, done = prepare_config_and_samples(
        flagship_config(batch_size=LOOP_BATCH, num_epoch=RECORDS_EPOCHS), samples())
    root = tempfile.mkdtemp(prefix="chip_smoke_records_")
    peaks = []
    real_peak = t_loop.print_peak_memory

    def spy(*a, **kw):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            value = real_peak(*a, **kw)
        peaks.append((value, torch.cuda.max_memory_allocated(dev), buf.getvalue().strip()))
        print(buf.getvalue(), end="", flush=True)
        return value

    def run(label, profile):
        nn = copy.deepcopy(done["NeuralNetwork"])
        nn["Training"]["scan_epoch"] = False  # per-step, as Profile makes the traced run
        if profile is not None:
            nn["Profile"] = dict(profile)
        loaders = create_dataloaders(tr, va, te, {"NeuralNetwork": nn})
        model = create_model_config(nn, seed=SEED, device=dev)
        optimizer = select_optimizer(model, nn["Training"])
        torch.cuda.reset_peak_memory_stats(dev)  # the printed peak is then this run's
        reset_counts()
        t0 = time.perf_counter()
        hist = t_loop.train_validate_test(model, optimizer, *loaders, nn, verbosity=1, log_name="run",
                                          log_dir=os.path.join(root, label) + "/")
        torch.cuda.synchronize()
        return model, hist, read_counts(), time.perf_counter() - t0, loaders

    t_loop.print_peak_memory = spy
    try:
        with deterministic_algorithms("records", "profiled,plain"):
            m_prof, h_prof, prof_counts, prof_wall, loaders = run("profiled", RECORDS_PROFILE)
            m_plain, h_plain, _, plain_wall, _ = run("plain", None)
    finally:
        t_loop.print_peak_memory = real_peak
    steps_per_epoch = len(loaders[0])
    if steps_per_epoch < 11:
        raise AssertionError(f"records: {steps_per_epoch} steps an epoch; the profiler traces steps 9-11")
    per_step, per_fwd = launch_plan(done["NeuralNetwork"]["Architecture"], batch_layout(next(iter(loaders[0]))))
    fwds = RECORDS_EPOCHS * (len(loaders[1]) + len(loaders[2])) + 2 * steps_per_epoch
    want = plus({k: RECORDS_EPOCHS * steps_per_epoch * per_step.get(k, 0) + fwds * per_fwd.get(k, 0)
                 for k in prof_counts}, telemetry_launches(per_step, per_fwd, RECORDS_EPOCHS, m_prof.cfg.num_heads))
    if prof_counts != want:
        raise AssertionError(f"records: launches {prof_counts}, want {want}")
    for key in t_loop.EPOCH_KEYS:
        if h_prof[key] != h_plain[key]:
            raise AssertionError(f"records: {key} differs with Profile: {h_prof[key]} vs {h_plain[key]}")
    params_equal = all(torch.equal(a, b) for a, b in zip(m_prof.state_dict().values(),
                                                         m_plain.state_dict().values()))
    if not params_equal:
        raise AssertionError("records: the parameters differ with Profile")
    with open(os.path.join(root, "profiled", "run", "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    if [r["epoch"] for r in records] != list(range(RECORDS_EPOCHS)) or \
            [r["train_loss"] for r in records] != h_prof["train_loss"] or \
            [r["val_loss"] for r in records] != h_prof["val_loss"] or \
            [r["test_loss"] for r in records] != h_prof["test_loss"] or [r["lr"] for r in records] != h_prof["lr"]:
        raise AssertionError(f"records: metrics.jsonl {records} is not the history {h_prof}")
    # two runs each print once, after their epoch 0
    if len(peaks) != 2 or any(v is None or v != now or f"{v / 1e6:.1f} MB" not in text for v, now, text in peaks):
        raise AssertionError(f"records: the printed peak memory is not torch.cuda.max_memory_allocated: {peaks}")
    trace_dir = os.path.join(root, "profiled", "run", "profile")
    traces = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    if traces != [f"epoch{RECORDS_PROFILE['target_epoch']}.pt.trace.json"]:
        raise AssertionError(f"records: traces {traces}")
    trace_path = os.path.join(trace_dir, traces[0])
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [ev.get("name", "") for ev in events if ev.get("cat") == "kernel"]
    # the port's kernels on this path: B1 (and its backward), B2, B3, B4
    named = sorted({m for n in kernels for m in re.findall(r"\w*(?:gather_stats|segment_sum|gather_rows)\w*", n)})
    if not named:
        raise AssertionError(f"records: the trace names none of the port's kernels among {len(kernels)} kernels")
    plain_counts = read_counts()
    writer = get_summary_writer("writer_probe", root)
    writer_kind = type(writer).__name__
    writer.close()
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    plots = "not run: matplotlib is not installed"
    if have_mpl:
        from hydragnn_tpu_torch.postprocess.visualizer import Visualizer

        _, _, tv, pv = t_loop.test_epoch(loaders[2], m_prof)
        viz = Visualizer("run", num_heads=m_prof.cfg.num_heads, head_names=m_prof.cfg.output_names,
                         log_dir=os.path.join(root, "profiled"))
        paths = viz.create_scatter_plots(tv, pv) + viz.create_reference_plot_suite(
            tv, pv, m_prof.cfg.output_type, [s.num_nodes for s in loaders[2].samples])
        plots = json.dumps(sorted(os.path.basename(q) for q in paths))
    line("records", samples=RECORDS_SAMPLES, batch=LOOP_BATCH, epochs=RECORDS_EPOCHS,
         steps_per_epoch=steps_per_epoch, profile=json.dumps(RECORDS_PROFILE),
         dispatch=h_prof["dispatch_mode"]["mode"], history_bit_equal_without_profile=True,
         parameters_bit_equal=True, metrics_jsonl_lines=len(records), metrics_equal_history=True,
         peak_memory_bytes=json.dumps([v for v, _, _ in peaks]),
         max_memory_allocated_at_print=json.dumps([now for _, now, _ in peaks]),
         trace=os.path.basename(trace_path), trace_mib=round(os.path.getsize(trace_path) / 2**20, 3),
         trace_kernel_events=len(kernels), trace_port_kernels=json.dumps(named),
         epoch_wall_s=json.dumps([round(w, 4) for w in h_prof["train_wall_s"]]),
         epoch_wall_s_without_profile=json.dumps([round(w, 4) for w in h_plain["train_wall_s"]]),
         run_wall_s=round(prof_wall, 3), run_wall_s_without_profile=round(plain_wall, 3),
         tensorboard_writer=writer_kind, matplotlib=have_mpl, plots=plots,
         kernel_launches=json.dumps(prof_counts, separators=(",", ":")),
         kernel_launches_without_profile_equal=plain_counts == prof_counts, card=repr(card))
    shutil.rmtree(root, ignore_errors=True)
    return prof_counts


# the [train-obs] phase: [records]' set and batch, 3 epochs
TRAIN_OBS_EPOCHS = 3
# one diagnostics sample at LOOP_BATCH, card (kernels) against CPU (plain
# versions), same weights and batch: each head's gradient norm, the
# weighted total's and the update's within the train step's conv tier
# (STEP_CONV_TOL: a per-tensor relative L2 bound bounds the norm of
# their concatenation), each cosine within twice it, the parameter norm
# (the same weights) within 1e-6. The update norm leaves out the
# BatchNorm-fed conv biases by name (frozen in the comparison's
# optimizer): their gradient is 0 up to rounding, so their first AdamW
# step is any value up to lr on each side. Below the train step's tiers,
# a tighter limit from the card's readings (H100 80GB HBM3, 700 W: norms
# 8e-5 to 1.1e-4 relative, cosines 6.8e-5, the update norm 1.5e-6
# relative): 1e-3 on every norm and cosine
DIAG_NORM_TOL, DIAG_COS_TOL, DIAG_PARAM_RTOL = STEP_CONV_TOL, 2 * STEP_CONV_TOL, 1e-6
DIAG_READING_TOL = 1e-3


def train_obs_phase(dev, card, counts, samples, keep_flight=None):
    """[train-obs]: the training loop's telemetry on the flagship at full
    width, batch LOOP_BATCH on ``samples()`` ([records]' 1,800 graphs),
    TRAIN_OBS_EPOCHS epochs under deterministic algorithms: (a) per-step
    with telemetry, diagnostics, ``slo_triggers``, an injected
    ``train_loss_spike`` and ``prometheus_dir``; (b) the same with
    ``HGTORCH_TELEMETRY=0``; (c) the fixed-membership epoch with
    telemetry. Raises unless (a)'s history and parameters are bit-equal to
    (b)'s; (a)'s and (c)'s flight records are complete and valid; every
    epoch of (a) has per-head diagnostics (finite gradient norms, a 4 x 4
    cosine matrix with a unit diagonal), MAE/RMSE equal to
    ``per_head_error_metrics`` of the same test pass, achieved TFLOP/s > 0
    and 0 < MFU < 1.05; the manifest's FLOPs a step equal the CPU's count
    of the same step (plain versions); the watermark equals
    ``torch.cuda.max_memory_allocated``; the spans' modes are per_step and
    fixed_epoch with 3 sampled steps in each epoch no capture ran in; (a)
    opens one incident whose bundle validates and whose profile names a
    port kernel; ``train.prom``'s loss is the last epoch's; (a)'s and (c)'s
    launches are (b)'s plus ``telemetry_launches``; and one diagnostics
    sample on the card matches the CPU's. Prints the telemetry-on against
    telemetry-off epoch wall, the sample's ms on CUDA events, the ledger
    per epoch, the spans, the incident and the flight event count.
    Copies (a)'s flight record to ``keep_flight`` where given. Returns
    (a)'s launches."""
    from hydragnn_tpu_torch.api import create_dataloaders, prepare_config_and_samples
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.obs import introspect, read_flight_record, reset_registry, validate_flight_record
    from hydragnn_tpu_torch.obs.triggers import INCIDENT_MANIFEST, list_incidents, validate_incident_bundle
    from hydragnn_tpu_torch.resilience import inject
    from hydragnn_tpu_torch.train import loop as t_loop
    from hydragnn_tpu_torch.train.optimizer import Optimizer, select_optimizer

    reset_counts, read_counts = counts
    tr, va, te, done = prepare_config_and_samples(
        flagship_config(batch_size=LOOP_BATCH, num_epoch=TRAIN_OBS_EPOCHS), samples())
    root = tempfile.mkdtemp(prefix="chip_smoke_train_obs_")
    real_test_epoch = t_loop.test_epoch
    knobs = ("HGTORCH_TELEMETRY", "HGTORCH_DIAGNOSTICS", "HGTORCH_INJECT_TRIGGER")

    def run(label, telemetry, fixed, triggers):
        nn = copy.deepcopy(done["NeuralNetwork"])
        nn["Training"]["scan_epoch"] = fixed
        if triggers:
            nn["Training"].update(slo_triggers=True, prometheus_dir=os.path.join(root, label, "prom"))
        saved = {k: os.environ.pop(k, None) for k in knobs}
        os.environ["HGTORCH_TELEMETRY"] = "1" if telemetry else "0"
        if triggers:
            os.environ["HGTORCH_INJECT_TRIGGER"] = "train_loss_spike"
        inject.TRIGGER.reset()
        reset_registry()
        passes = []

        def spy(*a, **kw):  # the loop's test passes, for the MAE/RMSE recomputation
            out = real_test_epoch(*a, **kw)
            passes.append(out)
            return out

        t_loop.test_epoch = spy
        try:
            loaders = create_dataloaders(tr, va, te, {"NeuralNetwork": nn})
            model = create_model_config(nn, seed=SEED, device=dev)
            optimizer = select_optimizer(model, nn["Training"])
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            hist = t_loop.train_validate_test(model, optimizer, *loaders, nn, log_name="run",
                                              log_dir=os.path.join(root, label) + "/", run_config={"NeuralNetwork": nn})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            t_loop.test_epoch = real_test_epoch
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
            inject.TRIGGER.reset()
            reset_registry()
        return types.SimpleNamespace(model=model, optimizer=optimizer, hist=hist, counts=got, wall=wall, peak=peak,
                                     loaders=loaders, dir=os.path.join(root, label, "run"), passes=passes)

    with deterministic_algorithms("train-obs", "telemetry_on,off,fixed"):
        a = run("a_per_step", True, False, True)
        b = run("b_telemetry_off", False, False, False)
        c = run("c_fixed_epoch", True, True, False)

    def state(r):
        return (list(r.model.state_dict().values()) + r.optimizer.state_tensors() + [r.optimizer.steps])

    for key in t_loop.EPOCH_KEYS:
        if a.hist[key] != b.hist[key]:
            raise AssertionError(f"train-obs: {key} differs with telemetry: {a.hist[key]} vs {b.hist[key]}")
    if not all(torch.equal(x, y) for x, y in zip(state(a), state(b))):
        raise AssertionError("train-obs: the parameters or the optimizer state differ with telemetry")
    if os.path.exists(os.path.join(b.dir, "flight.jsonl")):
        raise AssertionError("train-obs: the telemetry-off run wrote a flight record")
    names = list(a.model.cfg.output_names)
    records = {}
    for label, r, mode in (("a", a, "per_step"), ("c", c, "fixed_epoch")):
        path = os.path.join(r.dir, "flight.jsonl")
        problems = validate_flight_record(path, require_complete=True)
        if problems:
            raise AssertionError(f"train-obs {label}: the flight record is not valid: {problems}")
        events = read_flight_record(path)
        epochs = [e for e in events if e["kind"] == "epoch"]
        if len(epochs) != TRAIN_OBS_EPOCHS or any(e["step_time"]["mode"] != mode for e in epochs):
            raise AssertionError(f"train-obs {label}: epochs {[e.get('step_time') for e in epochs]}, want {mode}")
        records[label] = events
    a_epochs = [e for e in records["a"] if e["kind"] == "epoch"]
    c_epochs = [e for e in records["c"] if e["kind"] == "epoch"]
    for i, ep in enumerate(a_epochs):
        heads, hw = ep["heads"], ep["hw"]
        cos = np.asarray(heads.get("cosine"))
        if not (heads["available"] and sorted(heads["grad_norm"]) == sorted(names)
                and all(np.isfinite(v) for v in heads["grad_norm"].values())
                and cos.shape == (4, 4) and np.abs(np.diagonal(cos) - 1.0).max() <= 1e-5):
            raise AssertionError(f"train-obs: epoch {i}'s head diagnostics: {heads}")
        want = introspect.per_head_error_metrics(a.passes[i][2], a.passes[i][3], names)
        if heads["mae"] != {n: m["mae"] for n, m in want.items()} or \
                heads["rmse"] != {n: m["rmse"] for n, m in want.items()}:
            raise AssertionError(f"train-obs: epoch {i}'s MAE/RMSE {heads['mae']} {heads['rmse']}, want {want}")
        if not (hw["available"] and hw["achieved_tflops"] > 0 and hw["mfu"] is not None and 0 < hw["mfu"] < 1.05):
            raise AssertionError(f"train-obs: epoch {i}'s hardware record {hw}")
    if any(e["step_time"]["sampled_steps"] != 3 for e in c_epochs):
        raise AssertionError(f"train-obs c: sampled steps {[e['step_time'] for e in c_epochs]}")
    incident_events = [e for e in records["a"] if e["kind"] == "incident"]
    # an incident opened at an epoch's end captures in the next epoch's first steps
    captured, last_epoch = set(), -1
    for e in records["a"]:
        if e["kind"] == "epoch":
            last_epoch = e["epoch"]
        elif e["kind"] == "incident":
            captured.add(last_epoch + 1)
    if any(e["step_time"]["sampled_steps"] != 3 for e in a_epochs if e["epoch"] not in captured):
        raise AssertionError(f"train-obs a: sampled steps {[e['step_time'] for e in a_epochs]}")
    man = records["a"][0]["manifest"]
    cpu_model = create_model_config(done["NeuralNetwork"], seed=SEED, device="cpu")
    example = a.loaders[0].make_batch(np.arange(min(LOOP_BATCH, len(a.loaders[0].samples))))
    cpu_flops = introspect.step_flops(cpu_model, example)
    if man["hw_cost"]["flops_per_step"] != cpu_flops or man["hw_cost"]["flops_source"] != "torch.utils.flop_counter":
        raise AssertionError(f"train-obs: FLOPs a step {man['hw_cost']}, the CPU's count {cpu_flops}")
    end = records["a"][-1]
    marks = [e["hw"]["memory"]["peak_bytes_in_use"] for e in a_epochs]
    if max(marks) != a.peak or end["hw"]["peak_bytes_in_use"] != a.peak:
        raise AssertionError(f"train-obs: watermarks {marks}, run_end {end['hw']}, max_memory_allocated {a.peak}")
    # the incident
    bundles = list_incidents(os.path.join(a.dir, "incidents"))
    if len(bundles) != 1 or len(incident_events) != 1 or validate_incident_bundle(bundles[0]):
        raise AssertionError(f"train-obs: incidents {bundles} {incident_events}: "
                             f"{[validate_incident_bundle(x) for x in bundles]}")
    with open(os.path.join(bundles[0], INCIDENT_MANIFEST)) as f:
        inc = json.load(f)
    with open(os.path.join(bundles[0], "profile", "trace.pt.trace.json")) as f:
        trace_kernels = [ev.get("name", "") for ev in json.load(f)["traceEvents"] if ev.get("cat") == "kernel"]
    named = sorted({m for n in trace_kernels for m in re.findall(r"\w*(?:gather_stats|segment_sum|gather_rows)\w*", n)})
    if not (inc["rule"] == "train_loss_spike" and inc["profile"]["nonempty"] and named):
        raise AssertionError(f"train-obs: the incident {inc} names no port kernel among {len(trace_kernels)}")
    # train.prom
    prom = {}
    with open(os.path.join(root, "a_per_step", "prom", "train.prom")) as f:
        for ln in f:
            if ln.strip() and not ln.startswith("#"):
                k, v = ln.rsplit(" ", 1)
                prom[k] = float(v)
    prom_loss = prom.get('hydragnn_train_loss{rank="0"}')
    if prom_loss != a.hist["train_loss"][-1]:
        raise AssertionError(f"train-obs: train.prom's loss {prom_loss}, the last epoch's {a.hist['train_loss'][-1]}")
    # the launches: (b) the plain run's, (a) and (c) that and the telemetry's
    per_step, per_fwd = launch_plan(done["NeuralNetwork"]["Architecture"], batch_layout(example))
    steps = TRAIN_OBS_EPOCHS * len(a.loaders[0])
    fwds = TRAIN_OBS_EPOCHS * (len(a.loaders[1]) + len(a.loaders[2])) + 2 * len(a.loaders[0])
    plain = {k: steps * per_step.get(k, 0) + fwds * per_fwd.get(k, 0) for k in b.counts}
    extra = telemetry_launches(per_step, per_fwd, TRAIN_OBS_EPOCHS, len(names))
    if b.counts != plain or a.counts != plus(b.counts, extra) or c.counts != a.counts:
        raise AssertionError(f"train-obs: launches a {a.counts}, b {b.counts}, c {c.counts}; want b {plain}, "
                             f"a and c b + {extra}")
    # one diagnostics sample, card against CPU
    sides = {}
    for where in ("cpu", "cuda"):
        m = create_model_config(done["NeuralNetwork"], seed=SEED + 1, device=where if where == "cpu" else dev)
        run_opt = select_optimizer(m, done["NeuralNetwork"]["Training"])
        by_name = list(m.named_parameters())
        o = Optimizer([p for _, p in by_name], run_opt.kind, float(run_opt.param_groups[0]["lr"]),
                      frozen=[k.startswith("convs.") and k.endswith("post.bias") for k, _ in by_name])
        fn = introspect.make_diagnostics_step(m, o)
        bd = example.to(next(m.parameters()).device)
        sides[where] = {k: v.detach().cpu().double().numpy() for k, v in fn(bd).items()}
        if where == "cuda":
            diag_ms = cuda_ms(lambda: fn(bd), 3)
    gc, gp = sides["cuda"], sides["cpu"]
    norm_err = max(float(np.max(np.abs(gc[k] / gp[k] - 1.0))) for k in ("grad_norms", "grad_norm_total"))
    cos_err = float(np.max(np.abs(gc["cosine"] - gp["cosine"])))
    param_err = abs(float(gc["param_norm"]) / float(gp["param_norm"]) - 1.0)
    upd_err = abs(float(gc["update_norm"]) / float(gp["update_norm"]) - 1.0)
    line("train-obs", part="diagnostics_vs_cpu", batch=LOOP_BATCH, heads=len(names),
         grad_norms_card=json.dumps(gc["grad_norms"].tolist()), grad_norms_cpu=json.dumps(gp["grad_norms"].tolist()),
         worst_norm_rel_err=norm_err, norm_tol=DIAG_NORM_TOL, worst_cosine_abs_err=cos_err, cosine_tol=DIAG_COS_TOL,
         reading_tol=DIAG_READING_TOL, param_norm_rel_err=param_err, update_norm_card=float(gc["update_norm"]),
         update_norm_cpu=float(gp["update_norm"]), update_norm_rel_err_without_bn_fed_biases=upd_err,
         diagnostics_sample_ms_cuda_events=round(diag_ms, 3), card=repr(card))
    if (norm_err > DIAG_NORM_TOL or cos_err > DIAG_COS_TOL or param_err > DIAG_PARAM_RTOL or upd_err > DIAG_NORM_TOL
            or max(norm_err, cos_err, upd_err) > DIAG_READING_TOL):
        raise AssertionError("train-obs: the diagnostics sample on the card differs from the CPU's beyond the tiers")
    for label, events in records.items():
        for e in events:
            if e["kind"] != "epoch":
                continue
            st, hw = e["step_time"], e.get("hw", {})
            line("train-obs", run=label, epoch=e["epoch"], mode=st["mode"], steps=st["steps"],
                 data_wait_s=st["data_wait_s"], dispatch_s=st["dispatch_s"], sampled_steps=st["sampled_steps"],
                 device_wait_ms_mean=st["device_wait_ms_mean"], sync_step_ms_mean=st["sync_step_ms_mean"],
                 train_wall_s=hw.get("train_wall_s"), flops_per_step=man["hw_cost"]["flops_per_step"],
                 achieved_tflops=hw.get("achieved_tflops"), mfu=hw.get("mfu"),
                 peak_bytes_in_use=hw.get("memory", {}).get("peak_bytes_in_use"), card=repr(card))
    line("train-obs", part="summary", samples=RECORDS_SAMPLES, batch=LOOP_BATCH, epochs=TRAIN_OBS_EPOCHS,
         steps_per_epoch=len(a.loaders[0]), history_and_parameters_bit_equal_without_telemetry=True,
         epoch_wall_s_telemetry_on=json.dumps([round(w, 4) for w in a.hist["train_wall_s"]]),
         epoch_wall_s_telemetry_off=json.dumps([round(w, 4) for w in b.hist["train_wall_s"]]),
         epoch_wall_s_fixed_epoch=json.dumps([round(w, 4) for w in c.hist["train_wall_s"]]),
         run_wall_s=json.dumps([round(a.wall, 3), round(b.wall, 3), round(c.wall, 3)]),
         flops_per_step=man["hw_cost"]["flops_per_step"], flops_per_step_cpu=cpu_flops,
         peak_bf16_tflops=man["hw_cost"]["peak_bf16_tflops"], mfu_mean=end["hw"].get("mfu_mean"),
         max_memory_allocated=a.peak, incident=os.path.basename(bundles[0]), incident_status=inc["status"],
         incident_steps=inc["profile"]["steps"], incident_capture_s=inc["profile"]["duration_s"],
         incident_trace_kernel_events=len(trace_kernels), incident_trace_port_kernels=json.dumps(named),
         triggers=json.dumps(end["triggers"], separators=(",", ":")),
         flight_events=json.dumps({k: len(v) for k, v in records.items()}),
         train_prom_loss=prom_loss, manifest_card=json.dumps(man.get("card")),
         kernel_launches=json.dumps(a.counts, separators=(",", ":")),
         telemetry_launches=json.dumps(extra, separators=(",", ":")), card=repr(card))
    if keep_flight is not None:  # [serve-drift] reads its reference back
        shutil.copyfile(os.path.join(a.dir, "flight.jsonl"), keep_flight)
    shutil.rmtree(root, ignore_errors=True)
    return a.counts


def serve_burst(server, work, threads=SERVE_THREADS):
    """Every request of ``work`` submitted from ``threads`` client threads
    at once; returns (answers, per-request latencies in s, wall s). A
    request's latency ends when the server resolves its future."""
    results, lat = [None] * len(work), [0.0] * len(work)

    def client(k):
        futs = []
        for i in range(k, len(work), threads):
            t = time.perf_counter()
            f = server.submit(work[i])
            f.add_done_callback(lambda _f, i=i, t=t: lat.__setitem__(i, time.perf_counter() - t))
            futs.append((i, f))
        for i, f in futs:
            results[i] = f.result(timeout=300)

    t_start = time.perf_counter()
    pool = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("serve: a client thread did not finish")
    wall = time.perf_counter() - t_start
    if None in results:
        raise AssertionError("serve: a request got no answer")
    return results, lat, wall


def serve_latency_fields(lat, wall, serial):
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    return dict(p50_ms=round(float(np.percentile(lat_ms, 50)), 3), p99_ms=round(float(np.percentile(lat_ms, 99)), 3),
                requests_per_s=round(len(lat) / wall, 1), serial_p50_ms=round(float(np.median(serial)) * 1e3, 3))


def serial_latencies(server, requests):
    """One request at a time (light load): seconds each."""
    out = []
    for r in requests:
        t = time.perf_counter()
        server.predict(r, timeout=300)
        out.append(time.perf_counter() - t)
    return out


def record_batches(cache):
    """Keep every batch the server runs on its live weights, with its
    outputs: ``cache.run`` wrapped on the instance. Returns the list."""
    records, run = [], cache.run

    def recording(slot, bucket_index, batch):
        outs = run(slot, bucket_index, batch)
        if slot is None:
            records.append((bucket_index, batch, [o.copy() for o in outs]))
        return outs

    cache.run = recording
    return records


def bit_equal_to_eager(records, model, dev, label):
    """Each recorded batch's outputs against the eager forward of the
    same padded batch by ``model`` on the card, bit for bit."""
    for bi, batch, outs in records:
        with torch.inference_mode():
            want = [o.float().cpu().numpy() for o in model(batch.to(dev), train=False)]
        for ih, (a, b) in enumerate(zip(outs, want)):
            if a.shape != b.shape or not np.array_equal(a.view(np.int32), b.view(np.int32)):
                raise AssertionError(f"{label}: bucket {bi} head {ih} differs from the eager forward "
                                     f"(max abs {float(np.abs(a - b).max())})")
    return len(records)


def serve_phase(dev, card, counts, raw, launches_per):
    """[serve]: the flagship at full width served on the card from one
    CUDA graph per bucket and weight slot, under deterministic
    algorithms. The kernel wrappers run at start only (a warm-up forward
    and the capture, each bucket and slot); the 128-request burst from 4
    threads makes 0 wrapper calls and 0 captures, one replay a batch,
    and every batch's outputs equal the eager forward of the same padded
    batch bit for bit; every answer equals the CPU forward within
    SERVE_TOL. Returns the launches of the path (start and burst)."""
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.graph.batch import batch_graphs
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serve import request_to_dict

    reset, read = counts
    with deterministic_algorithms("serve", "capture, burst and eager on the card"):
        reset()
        server = hydragnn_tpu_torch.serve_model(flagship_config(), raw, device=dev, seed=SEED)
        try:
            cache = server._cache
            start_counts = read()
            n_buckets = len(server.buckets)
            if not cache.graphs or cache.captures != 2 * n_buckets or cache.warm_forwards != cache.captures:
                raise AssertionError(f"serve: {cache.captures} captures, {cache.warm_forwards} warm-up forwards, "
                                     f"graphs={cache.graphs} ({cache.reason}); want 2 x {n_buckets} buckets")
            want = {name: v * (cache.captures + cache.warm_forwards) for name, v in launches_per.items()}
            if start_counts != want:
                raise AssertionError(f"serve: launches at start {start_counts}, want {want}")
            requests = [request_to_dict(s) for s in server.reference_samples]
            work = requests * 2
            records = record_batches(cache)
            snap0 = server.metrics_snapshot()
            reset()
            results, lat, wall = serve_burst(server, work)
            burst_counts = read()
            snap = server.metrics_snapshot()
            serial = serial_latencies(server, requests[:32])
            forwards = snap["forwards_total"] - snap0["forwards_total"]
            batches = snap["batches_total"] - snap0["batches_total"]
            replays = snap["graph_replays_total"] - snap0["graph_replays_total"]
            captures = cache.captures
            if any(burst_counts.values()) or captures != 2 * n_buckets or snap["compile_misses"]:
                raise AssertionError(f"serve: the burst launched {burst_counts}, captures {captures}, "
                                     f"misses {snap['compile_misses']}")
            if not forwards == batches == replays or len(records) < batches:
                raise AssertionError(f"serve: {forwards} forwards, {batches} batches, {replays} replays")
            n_eq = bit_equal_to_eager(records, server.served.model, dev, "serve")
            cpu_model = create_model(server.served.cfg, seed=SEED, device="cpu")
            cpu_model.load_state_dict({k: t.cpu() for k, t in server.served.model.state_dict().items()})
            mcfg = server.served.cfg
            worst = 0.0
            for g, res in zip(work, results):
                with torch.no_grad():
                    ref = cpu_model(batch_graphs([g]), train=False)
                nn_ = g["x"].shape[0]
                for ih, name in enumerate(mcfg.output_names):
                    out = res[name]
                    want_ = (ref[ih][0] if mcfg.output_type[ih] == "graph" else ref[ih][:nn_]).numpy()
                    if out.shape != want_.shape or not np.all(np.isfinite(out)):
                        raise AssertionError(f"serve: head {name} shape {out.shape} or non-finite")
                    np.testing.assert_allclose(out, want_, err_msg=f"serve head {name}", **SERVE_TOL)
                    worst = max(worst, float(np.abs(out - want_).max()))
        finally:
            server.stop()
    line("serve", requests=len(work), threads=SERVE_THREADS, forwards=forwards, batches=batches, replays=replays,
         captures=captures, warm_forwards=cache.warm_forwards, buckets=n_buckets, weight_slots=cache.SLOTS,
         launches_at_start=json.dumps(start_counts, separators=(",", ":")),
         launches_in_burst=json.dumps(burst_counts, separators=(",", ":")),
         batches_bit_equal_to_eager=n_eq, deterministic=True, **serve_latency_fields(lat, wall, serial),
         max_abs_err_vs_cpu=worst, hidden=mcfg.hidden_dim, conv_layers=mcfg.num_conv_layers, heads=mcfg.num_heads,
         card=repr(card))
    line("serve-buckets", **{k: json.dumps(v, separators=(",", ":")) for k, v in snap["buckets"].items()})
    return {name: start_counts[name] + burst_counts[name] for name in start_counts}


def serve_resilience_phase(dev, card, counts, raw):
    """[serve-resilience]: the flagship at full width on the card under
    deterministic algorithms, with the Prometheus textfile and a flight
    record: reloads with the same and with other weights (0 captures;
    the live batches bit-equal before and after the first, equal to the
    eager forward of the new weights after the second), a torn reload
    refused with the live outputs unchanged, a killed dispatch thread
    restarted with every future resolved, a wedge seen and cleared by
    health(), ``tools/serve_probe.py`` on the textfile (0 while ready, 1
    after stop), and the flight file valid with no problems."""
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.obs import FlightRecorder, read_flight_record, validate_flight_record
    from hydragnn_tpu_torch.resilience import inject
    from hydragnn_tpu_torch.serve import ReloadFailed, RequestFailed, ServeConfig, request_to_dict

    reset, read = counts
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    prom, flight_path = os.path.join(root, "serve.prom"), os.path.join(root, "flight.jsonl")
    probe = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "serve_probe.py")

    def probe_rc(*args):
        return subprocess.run([sys.executable, probe, "--prom", prom, *args], capture_output=True, text=True,
                              timeout=60).returncode

    def until(pred, seconds):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.005)
        return False

    cfg = ServeConfig(dispatch_stall_s=0.5, dispatch_backoff_base_s=0.2, prometheus_path=prom,
                      prometheus_every_s=0.1)
    out = {}
    with deterministic_algorithms("serve-resilience", "reloads, faults and probes on the card"):
        server = hydragnn_tpu_torch.serve_model(flagship_config(), raw, device=dev, seed=SEED, serve_config=cfg,
                                                flight=FlightRecorder(flight_path))
        cache = server._cache
        requests = [request_to_dict(s) for s in server.reference_samples]
        try:
            captures = cache.captures
            reset()
            records = record_batches(cache)
            server.predict_many(requests, timeout=300)
            base = list(records)

            def replay_equal(recs, label):
                # the live slot on the recorded batches, bit for bit
                for bi, batch, outs in recs:
                    again = cache.run(None, bi, batch)
                    if not all(np.array_equal(a.view(np.int32), b.view(np.int32)) for a, b in zip(again, outs)):
                        raise AssertionError(f"serve-resilience: {label}: bucket {bi} changed")

            # reload with the same weights: 0 captures, bit-equal answers
            t0 = time.perf_counter()
            info_same = server.reload(variables={k: v.clone() for k, v in server.served.model.state_dict().items()})
            out["reload_same_s"] = round(time.perf_counter() - t0, 4)
            replay_equal(base, "reload with the same weights")
            # reload with other weights: equal to their eager forward
            other = {k: v * 1.1 if v.is_floating_point() else v for k, v in server.served.model.state_dict().items()}
            server.reload(variables=other)
            del records[:]
            server.predict_many(requests, timeout=300)
            served = read()  # the eager forwards below are the check's, not the server's
            n_eq = bit_equal_to_eager(records, server.served.model, dev, "reload with other weights")
            reset()
            after_other = list(records)
            bi, batch, outs = base[0]
            moved = float(np.abs(cache.run(None, bi, batch)[0] - outs[0]).max())
            # a torn reload: refused, the live outputs bit-unchanged
            os.environ["HGTORCH_INJECT_SERVE_TORN_RELOAD"] = "1"
            try:
                server.reload(variables=other)
                raise AssertionError("serve-resilience: the torn reload was accepted")
            except ReloadFailed:
                pass
            finally:
                del os.environ["HGTORCH_INJECT_SERVE_TORN_RELOAD"]
            replay_equal(after_other, "after the torn reload")
            snap = server.metrics_snapshot()
            if (cache.captures != captures or snap["compile_misses"] or snap["reloads"] != 2
                    or snap["reload_failed"] != 1 or not moved > 0):
                raise AssertionError(f"serve-resilience: captures {captures} -> {cache.captures}, snapshot {snap}")
            out.update(reloads=snap["reloads"], reload_failed=snap["reload_failed"], captures=cache.captures,
                       reload_same_slot=info_same["slot"], other_weights_batches_bit_equal=n_eq,
                       other_weights_max_change=moved)
            # a killed dispatch thread: restarted, every future resolved
            os.environ["HGTORCH_INJECT_SERVE_KILL_DISPATCH"] = str(server._dispatched_batches + 1)
            try:
                futs = [server.submit(r) for r in requests[:16]]
                ok = failed = 0
                for f in futs:
                    try:
                        f.result(timeout=120)
                        ok += 1
                    except RequestFailed as exc:
                        if exc.reason != "dispatch":
                            raise
                        failed += 1
            finally:
                del os.environ["HGTORCH_INJECT_SERVE_KILL_DISPATCH"]
            if not (failed >= 1 and ok + failed == 16 and until(lambda: server.health()["ready"], 30)):
                raise AssertionError(f"serve-resilience: kill: {ok} answered, {failed} failed, {server.health()}")
            after = server.predict_many(requests[:16], timeout=300)
            if server.health()["dispatch_restarts"] != 1 or len(after) != 16:
                raise AssertionError(f"serve-resilience: after the kill {server.health()}")
            out.update(killed_batch_failed=failed, killed_batch_answered=ok, dispatch_restarts=1)
            # a wedge: liveness false while stalled, true again after
            inject.SERVE_WEDGE.fired = False
            seq = next(server._seq) + 1
            os.environ["HGTORCH_INJECT_SERVE_WEDGE"] = f"{seq}:2"
            try:
                fut = server.submit(requests[0])
                saw_down = until(lambda: not server.health()["live"], 10)
                fut.result(timeout=120)
                saw_up = until(lambda: server.health()["live"] and server.health()["ready"], 10)
            finally:
                del os.environ["HGTORCH_INJECT_SERVE_WEDGE"]
            if not (saw_down and saw_up):
                raise AssertionError(f"serve-resilience: wedge: live false {saw_down}, back {saw_up}")
            out.update(wedge_live_false=saw_down, wedge_live_again=saw_up)
            # the textfile, probed as an orchestrator would, once the
            # monitor has rewritten it since readiness came back
            t_ready = time.time()
            until(lambda: os.path.exists(prom) and os.stat(prom).st_mtime > t_ready, 10)
            out["probe_ready_rc"], out["probe_live_rc"] = probe_rc(), probe_rc("--live")
            launches_after_start = {name: n + served[name] for name, n in read().items()}
        finally:
            server.stop()
    server.export_prometheus(prom)
    out["probe_after_stop_rc"] = probe_rc()
    events = read_flight_record(flight_path)
    problems = validate_flight_record(flight_path)
    kinds = sorted({e["kind"] for e in events})
    if (out["probe_ready_rc"], out["probe_live_rc"], out["probe_after_stop_rc"]) != (0, 0, 1) or problems \
            or any(launches_after_start.values()):
        raise AssertionError(f"serve-resilience: probes {out}, flight problems {problems}, "
                             f"launches after start {launches_after_start}")
    for kind in ("run_start", "reload", "reload_failed", "dispatch_restart", "watchdog", "trace_capture", "run_end"):
        if kind not in kinds:
            raise AssertionError(f"serve-resilience: no {kind} event in the flight record")
    line("serve-resilience", **out, flight_events=len(events), flight_kinds=json.dumps(kinds),
         flight_problems=len(problems), launches_after_start=sum(launches_after_start.values()), card=repr(card))
    shutil.rmtree(root, ignore_errors=True)


def serve_timing_phase(dev, card, make_raw):
    """[serve-timing]: graphs against the eager forward in one run, with
    PyTorch's default algorithms (as users run): the largest bucket's
    forward (copy in, forward, copy out; host clock, synchronised,
    median of 20), then a 128-request burst from 4 threads (p50, p99,
    requests/s) and the serial p50 on a server of each kind."""
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.graph.batch import batch_graphs
    from hydragnn_tpu_torch.serve import ServeConfig, request_to_dict

    fields = {}
    for mode in ("graph", "eager"):
        server = hydragnn_tpu_torch.serve_model(flagship_config(), make_raw(), device=dev, seed=SEED,
                                                serve_config=ServeConfig(cuda_graphs=mode == "graph"))
        try:
            cache = server._cache
            if cache.graphs != (mode == "graph"):
                raise AssertionError(f"serve-timing: {mode} server's executor is {cache.reason}")
            top = server.buckets[-1]
            requests = [request_to_dict(s) for s in server.reference_samples]
            biggest = sorted(requests, key=lambda g: -len(g["senders"]))[: top.max_batch]
            hb = batch_graphs(biggest, n_node_pad=top.node_pad, n_edge_pad=top.edge_pad, n_graph_pad=top.graph_pad)
            for _ in range(5):
                cache.run(None, top.index, hb)
            ts = []
            for _ in range(SERVE_TIMING_ITERS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                cache.run(None, top.index, hb)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            serve_burst(server, requests[:8])  # warm the path
            _, lat, wall = serve_burst(server, requests * 2)
            serial = serial_latencies(server, requests[:32])
        finally:
            server.stop()
        lf = serve_latency_fields(lat, wall, serial)
        fields[f"{mode}_forward_ms"] = round(float(np.median(ts)) * 1e3, 4)
        fields.update({f"{mode}_{k}": v for k, v in lf.items()})
    line("serve-timing", bucket=f"{top.node_pad}x{top.edge_pad}", iters=SERVE_TIMING_ITERS, requests=2 * len(requests),
         threads=SERVE_THREADS, **fields, deterministic=torch.are_deterministic_algorithms_enabled(),
         cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"), card=repr(card))
    return fields


# [serve-drift]: the spool, the drift monitor and the serving triggers on
# the flagship served from CUDA graphs
DRIFT_SHIFT = "5.0"  # HGTORCH_INJECT_DRIFT of (c)
DRIFT_PROFILE_STEPS = 8  # (c)'s incident captures 8 batches
# (c)'s spool rotates a shard each ~0.25 MB and keeps 1 MB: the shards
# pinned for the incident must outlive the evictions of its capture
DRIFT_SPOOL = dict(spool_shard_mb=0.25, spool_max_mb=1.0)
# (d): the served answers (bucket pads, B5) against an eval forward of the
# same graphs in the loader's run-aligned batches (B1, B2): f32 sums in
# another order. The card read 2.4e-6 at most (H100 80GB HBM3, 700 W, two
# runs): the tier is 1e-5
REPLAY_TOL = dict(rtol=1e-5, atol=1e-5)
# The pred_drift rule is off in this phase (drift_pred_psi=None); its
# gauge is still published and printed. Prediction drift is baselined on
# the session's first answers (obs/drift.py:_HeadSketch), and a 4-thread
# burst's first answers are not a sample of its traffic: the buckets'
# flush order skews them toward some graph sizes. On clean traffic the
# gauge read 0.655-0.789 on the graph head in the CPU rehearsal (hidden
# 16, warm-up 64 rows) and up to 2.49 on a node head on the card (hidden
# 128; NVIDIA H100 80GB HBM3, 700 W), over the 0.5 threshold; at a
# warm-up of 512 rows the rule opened a pred_drift incident on the card:
# a false alarm of the JAX package's design, which the port copies
# (ROADMAP C6).


class _Timed:
    """Accumulated seconds and calls of one bound method, wrapped on its
    instance."""

    def __init__(self, obj, name):
        self.s, self.n, fn = 0.0, 0, getattr(obj, name)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s += time.perf_counter() - t
                self.n += 1

        setattr(obj, name, timed)


def serve_drift_phase(dev, card, counts, make_raw, launches_per, train_flight):
    """[serve-drift]: the flagship at full width (``make_raw()``'s 64 BCC
    graphs) served from CUDA graphs under deterministic algorithms, with
    the spool at 1 (every answer spooled), a drift reference, all three
    SLO rules and the feature and error drift rules (pred_drift off, its
    gauge printed: see above), the triggers evaluated every 50 ms:
    (a) the reference: ``build_reference`` of the serve samples as JSON;
        ``train_flight`` ([train-obs]'s record) read by ``load_reference``;
    (b) 256 clean requests from 4 threads: no incident, feature PSI under
        0.25, 0 captures after start and 0 kernel wrapper calls in the
        burst, a replay a batch, every batch bit-equal to the eager
        forward;
    (c) the same with ``HGTORCH_INJECT_DRIFT``: exactly one
        ``feature_drift`` incident, its bundle, drift report and spool
        manifests valid (the port's validators and CLIs), its pinned
        shards alive at its close while the spool evicted others, a
        ``drift`` flight event and no ``error`` event;
    (d) the spool's shards through ``ContainerDataset`` and the
        run-aligned ``GraphLoader``: the batches' inputs bit-equal to
        batching the shifted requests, an eval forward on the card equal
        to the spooled answers within REPLAY_TOL;
    (e) ``export_trace`` holds the sampled requests' ``serve.*`` spans,
        ``flight_to_chrome`` reads the serving record;
    (f) the cost: a 128-request burst (p50, p99, requests/s) and the
        serial p50 with every plane off, with the spool at 1 and at 8
        (drift and rules on), in turns, beside ``overhead_frac``, the mean
        us of an ``observe``, the mean ms of a rotation and the
        incident's capture s.
    Raises on any failed check. Returns the path's launches: the start,
    both bursts and the replay's forwards."""
    import contextlib
    import dataclasses
    import io

    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.api import prepare_config_and_samples
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.obs import (FlightRecorder, build_reference, flight_to_chrome, list_incidents,
                                        load_reference, read_flight_record, read_spool, validate_drift_report,
                                        validate_flight_record, validate_incident_bundle, validate_spool_manifest)
    from hydragnn_tpu_torch.obs.spool import list_shards, read_shard_manifest
    from hydragnn_tpu_torch.resilience import inject
    from hydragnn_tpu_torch.serve import ServeConfig, request_to_dict
    from hydragnn_tpu_torch.tools import drift_report, incident_report

    reset, read = counts
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_drift_")
    out = {}
    # (a) the reference of the serve samples, and [train-obs]'s
    tr, _, _, done = prepare_config_and_samples(flagship_config(), make_raw())
    ref = build_reference(list(tr))
    ref_path = os.path.join(root, "ref.json")
    with open(ref_path, "w") as f:
        json.dump(ref, f)
    train_ref = load_reference(train_flight)
    if len(train_ref["feature"]["channels"]) != len(ref["feature"]["channels"]) or not train_ref["heads"]:
        raise AssertionError(f"serve-drift: [train-obs]'s reference does not match the serve samples': {train_ref}")
    out.update(ref_channels=len(ref["feature"]["channels"]), ref_rows=ref["num_rows"],
               train_ref_rows=train_ref["num_rows"], train_ref_heads=len(train_ref["heads"]))
    flight_path = os.path.join(root, "flight.jsonl")
    cfg = ServeConfig(spool=True, spool_sample=1, spool_dir=os.path.join(root, "spool"), drift_ref=ref_path,
                      slo_p99_ms=60_000.0, slo_queue_depth=10_000, slo_queue_age_s=600.0, trigger_eval_every_s=0.05,
                      incident_dir=os.path.join(root, "incidents"), drift_pred_psi=None, **DRIFT_SPOOL)
    os.environ.pop("HGTORCH_INJECT_DRIFT", None)
    os.environ["HGTORCH_INCIDENT_PROFILE_STEPS"] = str(DRIFT_PROFILE_STEPS)
    path_counts = []
    with deterministic_algorithms("serve-drift", "capture, bursts, replay and eager on the card"):
        reset()
        try:
            server = hydragnn_tpu_torch.serve_model(flagship_config(), make_raw(), device=dev, seed=SEED,
                                                    serve_config=cfg,
                                                    flight=FlightRecorder(flight_path))
        finally:
            os.environ.pop("HGTORCH_INCIDENT_PROFILE_STEPS")
        cache = server._cache
        start_counts = read()
        path_counts.append(start_counts)
        try:
            want = {name: v * (cache.captures + cache.warm_forwards) for name, v in launches_per.items()}
            if start_counts != want or not cache.graphs or cache.captures != 2 * len(server.buckets):
                raise AssertionError(f"serve-drift: start launched {start_counts} (want {want}), "
                                     f"{cache.captures} captures, graphs={cache.graphs}")
            captures = cache.captures
            observe = _Timed(server._drift, "observe")
            rotate = _Timed(server._spool, "_rotate_locked")
            # the spool's evictions as the incident opens, and its pinned
            # shards and the evictions as it closes
            at_open, at_close = [], []
            attach, on_close = server._attach_drift_evidence, server._incidents.on_close

            def open_hook(opened, verdict):
                at_open.append(server._spool._evicted)
                attach(opened, verdict)

            def close_hook(inc, status):
                pinned_ = list(server._incident_pins.get(inc.id, []))
                alive = all(os.path.isdir(os.path.join(server.spool_dir(), n)) for n in pinned_)
                at_close.append((pinned_, alive, server._spool._evicted))
                on_close(inc, status)

            server._attach_drift_evidence = open_hook
            server._incidents.on_close = close_hook
            requests = [request_to_dict(s) for s in server.reference_samples]
            # (b) clean traffic
            records = record_batches(cache)
            snap0 = server.metrics_snapshot()
            reset()
            _, lat_b, wall_b = serve_burst(server, requests * 4)
            b_counts = read()
            path_counts.append(b_counts)
            snap = server.metrics_snapshot()
            batches = snap["batches_total"] - snap0["batches_total"]
            replays = snap["graph_replays_total"] - snap0["graph_replays_total"]
            psi_clean = server.metrics.registry.gauge("serve.drift.feature_psi").value
            time.sleep(0.1)  # one more evaluation window, on the next batch
            server.predict(requests[0], timeout=300)
            if (any(b_counts.values()) or cache.captures != captures or replays != batches
                    or len(records) < batches or list_incidents(cfg.incident_dir) or not psi_clean < 0.25):
                raise AssertionError(f"serve-drift (b): launches {b_counts}, captures {cache.captures}, "
                                     f"{replays} replays of {batches} batches, feature psi {psi_clean}, "
                                     f"incidents {list_incidents(cfg.incident_dir)}")
            n_eq = bit_equal_to_eager(records, server.served.model, dev, "serve-drift (b)")
            out.update(clean_requests=4 * len(requests), clean_batches=batches, clean_replays=replays,
                       clean_batches_bit_equal_to_eager=n_eq, clean_feature_psi=psi_clean,
                       clean_pred_psi=server.metrics.registry.gauge("serve.drift.pred_psi").value,
                       clean_head_psi=json.dumps({k: round(v, 4) for k, v in server._drift.head_psi().items()}),
                       clean_p50_ms=round(float(np.percentile(lat_b, 50)) * 1e3, 3),
                       clean_requests_per_s=round(len(lat_b) / wall_b, 1))
            del cache.run  # record_batches' wrapper off
            # (c) drift
            first_shifted = next(server._seq) + 1
            os.environ["HGTORCH_INJECT_DRIFT"] = DRIFT_SHIFT
            try:
                reset()
                shifted_results, _, _ = serve_burst(server, requests * 3)
                c_counts = read()
                path_counts.append(c_counts)
                deadline = time.monotonic() + 60
                while server._incidents.open is not None and time.monotonic() < deadline:
                    server.predict(requests[0], timeout=300)  # ticks the capture to its end
            finally:
                del os.environ["HGTORCH_INJECT_DRIFT"]
            if any(c_counts.values()) or cache.captures != captures:
                raise AssertionError(f"serve-drift (c): launches {c_counts}, captures {cache.captures}")
            spool_root = server.spool_dir()
        finally:
            server.stop()
        events = read_flight_record(flight_path)
        problems = validate_flight_record(flight_path)
        errors = [e for e in events if e["kind"] == "error"]
        bundles = list_incidents(cfg.incident_dir)
        drifts = [e for e in events if e["kind"] == "drift"]
        end = events[-1]
        if problems or errors or len(bundles) != 1 or [e["rule_kind"] for e in drifts] != ["feature_drift"] \
                or end["kind"] != "run_end":
            raise AssertionError(f"serve-drift (c): flight problems {problems}, errors "
                                 f"{[(e.get('where'), e.get('error')) for e in errors]}, bundles {bundles}, "
                                 f"drift events {drifts}")
        bundle = bundles[0]
        with open(os.path.join(bundle, "incident_manifest.json")) as f:
            inc_man = json.load(f)
        with open(os.path.join(bundle, "drift_report.json")) as f:
            report = json.load(f)
        man_problems = validate_incident_bundle(bundle) + validate_drift_report(report)
        pinned = report["pinned_shards"]
        bundle_mans = sorted(os.listdir(os.path.join(bundle, "spool_manifests")))
        for name in bundle_mans:
            with open(os.path.join(bundle, "spool_manifests", name)) as f:
                man_problems += validate_spool_manifest(json.load(f))
        shards = list_shards(spool_root)
        for shard in shards:
            man_problems += validate_spool_manifest(read_shard_manifest(shard))
        cli_out = io.StringIO()
        with contextlib.redirect_stdout(cli_out):
            cli_rc = (drift_report.main(["--validate", spool_root, os.path.join(bundle, "drift_report.json"),
                                         flight_path]),
                      incident_report.main(["--validate", cfg.incident_dir]))
        if len(at_open) != 1 or len(at_close) != 1:
            raise AssertionError(f"serve-drift (c): {len(at_open)} drift incidents opened, {len(at_close)} closed")
        (close_pins, close_alive, evicted_at_close), evicted_at_open = at_close[0], at_open[0]
        if (man_problems or cli_rc != (0, 0) or inc_man["rule"] != "serve_feature_drift"
                or bundle_mans != sorted(f"{n}.json" for n in pinned) or not pinned or close_pins != pinned
                or not close_alive or not evicted_at_close > evicted_at_open):
            raise AssertionError(f"serve-drift (c): problems {man_problems}, CLIs {cli_rc} {cli_out.getvalue()}, "
                                 f"manifest {inc_man}, pinned {pinned}, at close {at_close}, evicted at open "
                                 f"{evicted_at_open}")
        out.update(incident=os.path.basename(bundle), incident_status=inc_man["status"],
                   incident_steps=inc_man["profile"]["steps"], incident_capture_s=inc_man["profile"]["duration_s"],
                   observed_feature_psi=report["trigger"]["observed"], pinned_shards=len(pinned),
                   pinned_alive_at_close=close_alive, evicted_while_open=evicted_at_close - evicted_at_open,
                   spool=json.dumps(end["spool"], separators=(",", ":")),
                   drift=json.dumps(end["drift"], separators=(",", ":")),
                   triggers=json.dumps(end["triggers"], separators=(",", ":")),
                   observe_us=round(observe.s / max(observe.n, 1) * 1e6, 2), observes=observe.n,
                   rotation_ms=round(rotate.s / max(rotate.n, 1) * 1e3, 3), rotations=rotate.n)
        # the capture's trace: the kernels inside the replayed graphs, or only their launches
        trace_path = os.path.join(bundle, "profile", "trace.pt.trace.json")
        kernels, graph_launches = set(), 0
        if os.path.exists(trace_path):
            with open(trace_path) as f:
                for ev in json.load(f).get("traceEvents", []):
                    if ev.get("cat") == "kernel":
                        kernels.add(ev.get("name", ""))
                    elif "cudaGraphLaunch" in str(ev.get("name", "")):
                        graph_launches += 1
        out.update(trace_kernel_names=len(kernels), trace_graph_launches=graph_launches,
                   trace_names_b5=any("pna_aggregate" in k for k in kernels),
                   trace_names_b3=any("gather_rows" in k for k in kernels))
        # (d) replay the spool
        spooled = [s for s in read_spool(spool_root) if s.meta["spool"]["seq"] >= first_shifted]

        def key(s):
            return np.asarray(s.x, np.float32).tobytes(), np.asarray(s.edge_index, np.int32).tobytes()

        os.environ["HGTORCH_INJECT_DRIFT"] = DRIFT_SHIFT
        try:  # the shifted requests, shifted as the server shifted them
            shifted = [dataclasses.replace(s, x=inject.maybe_drift_shift(s.x)) for s in server.reference_samples]
        finally:
            del os.environ["HGTORCH_INJECT_DRIFT"]
        by_graph = {key(s): s for s in shifted}
        originals = [by_graph[key(s)] for s in spooled]
        if len(spooled) < 8:
            raise AssertionError(f"serve-drift (d): {len(spooled)} shifted requests in the spool")
        loader_kw = dict(batch_size=8, shuffle=False, dense_slots=False, run_align=True)
        got_batches = list(GraphLoader(spooled, **loader_kw))
        want_batches = list(GraphLoader(originals, **loader_kw))
        fields = ("nodes", "senders", "receivers", "node_graph", "n_node", "n_edge", "node_mask", "edge_mask",
                  "graph_mask", "edge_attr", "pos", "sender_perm", "in_degree", "edge_occupancy", "n_real_nodes",
                  "sender_win")
        for gb, wb in zip(got_batches, want_batches):
            for fld in fields:
                a, b = getattr(gb, fld), getattr(wb, fld)
                if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"serve-drift (d): the spooled batch's {fld} differs from the original's")
            if gb.run_align != 8:
                raise AssertionError(f"serve-drift (d): the loader's batch is not run-aligned ({gb.run_align})")
        mcfg = server.served.cfg
        model = server.served.model
        reset()
        outs = []
        with torch.inference_mode():
            for gb in got_batches:
                outs.append([o.float().cpu() for o in model(gb.to(dev), train=False)])
        d_counts = read()
        path_counts.append(d_counts)
    per_fwd = launch_plan(done["NeuralNetwork"]["Architecture"], "run_aligned")[1]
    want_d = {name: len(got_batches) * per_fwd.get(name, 0) for name in d_counts}
    if d_counts != want_d:
        raise AssertionError(f"serve-drift (d): the replay launched {d_counts}, want {want_d}")
    worst = 0.0
    for gb, o in zip(got_batches, outs):
        for ih, name in enumerate(mcfg.output_names):
            graph = mcfg.output_type[ih] == "graph"
            mask = gb.graph_mask if graph else gb.node_mask
            tgt = (gb.graph_targets if graph else gb.node_targets)[name][mask]
            got = o[ih][mask]
            np.testing.assert_allclose(got.numpy(), tgt.numpy(), err_msg=f"serve-drift (d) head {name}",
                                       **REPLAY_TOL)
            worst = max(worst, float((got - tgt).abs().max()))
    out.update(replay_samples=len(spooled), replay_batches=len(got_batches), replay_batches_bit_equal=True,
               replay_max_abs_err=worst, replay_tol=json.dumps(REPLAY_TOL))
    # (e) the Chrome traces
    trace_out = server.export_trace(os.path.join(root, "serve_trace.json"))
    with open(trace_out) as f:
        trace_events = json.load(f)["traceEvents"]
    names = {e["name"] for e in trace_events}
    from_flight = flight_to_chrome(flight_path)["traceEvents"]
    if not {"serve.route", "serve.queue_wait", "serve.batch_build", "serve.device_execute"} <= names \
            or not from_flight or not all(e["name"].startswith("serve.") for e in from_flight):
        raise AssertionError(f"serve-drift (e): trace names {sorted(names)}, {len(from_flight)} from the flight")
    out.update(trace_events=len(trace_events), trace_requests=len({e["tid"] for e in trace_events}),
               flight_chrome_events=len(from_flight))
    line("serve-drift", **out, card=repr(card))
    # (f) the cost: three servers, bursts in turns
    timing_cfgs = {
        "off": ServeConfig(),
        "spool1": dataclasses.replace(cfg, spool_dir=os.path.join(root, "spool1"), spool_shard_mb=1.0,
                                      spool_max_mb=64.0, incident_dir=os.path.join(root, "inc1")),
        "spool8": dataclasses.replace(cfg, spool_sample=8, spool_dir=os.path.join(root, "spool8"), spool_shard_mb=1.0,
                                      spool_max_mb=64.0, incident_dir=os.path.join(root, "inc8")),
    }
    servers, flights, timers = {}, {}, {}
    with deterministic_algorithms("serve-drift", "the cost's bursts"):
        try:
            for mode, tcfg in timing_cfgs.items():
                flights[mode] = os.path.join(root, f"{mode}.jsonl")
                servers[mode] = hydragnn_tpu_torch.serve_model(flagship_config(), make_raw(), device=dev, seed=SEED,
                                                               serve_config=tcfg, flight=FlightRecorder(flights[mode]))
                if servers[mode]._drift is not None:
                    timers[mode] = (_Timed(servers[mode]._drift, "observe"), _Timed(servers[mode]._spool,
                                                                                    "_rotate_locked"))
                serve_burst(servers[mode], requests[:16])  # warm the path
            lat = {m: [] for m in servers}
            walls = {m: [] for m in servers}
            serial = {m: [] for m in servers}
            for mode in ("off", "spool1", "spool8", "spool8", "spool1", "off"):
                _, l_, w_ = serve_burst(servers[mode], requests * 2)
                lat[mode] += l_
                walls[mode].append(w_)
                serial[mode] += serial_latencies(servers[mode], requests[:16])
        finally:
            for s_ in servers.values():
                s_.stop()
    cost = {}
    for mode in servers:
        fields_ = serve_latency_fields(lat[mode], sum(walls[mode]), serial[mode])
        end_ = read_flight_record(flights[mode])[-1]
        errs = [e for e in read_flight_record(flights[mode]) if e["kind"] == "error"]
        if errs or list_incidents(timing_cfgs[mode].incident_dir or os.path.join(root, "none")):
            raise AssertionError(f"serve-drift (f): {mode}: errors {errs} or an incident")
        if mode in timers:
            ob, ro = timers[mode]
            fields_.update(overhead_frac=end_["spool"]["overhead_frac"], spooled=end_["spool"]["spooled"],
                           observe_us=round(ob.s / max(ob.n, 1) * 1e6, 2),
                           rotation_ms=round(ro.s / max(ro.n, 1) * 1e3, 3), rotations=ro.n)
        cost[mode] = fields_
        line("serve-drift", part="cost", mode=mode, requests=len(lat[mode]), **fields_, card=repr(card))
    line("serve-drift", part="cost_summary", incident_capture_s=out["incident_capture_s"],
         **{f"{m}_p50_ms": c["p50_ms"] for m, c in cost.items()},
         **{f"{m}_serial_p50_ms": c["serial_p50_ms"] for m, c in cost.items()}, card=repr(card))
    shutil.rmtree(root, ignore_errors=True)
    total = {name: sum(c[name] for c in path_counts) for name in path_counts[0]}
    return total


RES_EPOCHS, RES_GRACE_S = 3, 8.0  # [train-resilience]: 3 epochs of 8 steps; (a)'s short grace window
RES_STALL_S = 3.0  # (d)'s watchdog
# a resumed child's final val loss against the uninterrupted run's: after
# a mid-epoch stop the stopped epoch is re-run on weights that took part
# of it (rel 0.2); after the torn checkpoint the run resumes from the
# newest intact version (rel 1e-3); the JAX package's own bars
# (tests/test_resilience.py:433-498)
RES_MIDEPOCH_REL, RES_TORN_REL = 0.2, 1e-3

_RES_CHILD = r'''
import json, os, pickle, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {repo!r})
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
t_torch = time.perf_counter()
from hydragnn_tpu_torch.api import run_training
from hydragnn_tpu_torch.resilience import run_guard
t_port = time.perf_counter()
cfg_path, samples_path, log_dir = sys.argv[1:4]
with open(cfg_path) as f:
    cfg = json.load(f)
with open(samples_path, "rb") as f:
    samples = pickle.load(f)
t_data = time.perf_counter()
print("CHILD-STARTUP", round(t_data - t0, 3), "torch", round(t_torch - t0, 3), "port", round(t_port - t_torch, 3),
      "data", round(t_data - t_port, 3), flush=True)
with run_guard():
    run_training(cfg, samples=samples, log_dir=log_dir, device="cuda", seed={seed})
print("CHILD-COMPLETED", round(time.perf_counter() - t0, 3), flush=True)
'''


def train_resilience_phase(dev, card, counts, samples, per_step, per_fwd):
    """[train-resilience]: the flagship at full width (batch LOOP_BATCH, 8
    steps an epoch, RES_EPOCHS epochs, checkpoint_every 1, per-step
    dispatch, deterministic algorithms, diagnostics off) through
    ``run_training``, in process and in ``sys.executable`` children that
    wrap it in ``run_guard()`` and load the kernels this process built:
    (a) SIGTERM at epoch 2 in process, then the auto-resume, bit-equal to
    the uninterrupted run, the signal-to-raise seconds and the hard-exit
    timer cancelled; (b) a mid-epoch SIGTERM in a child (75), then its
    resume (0); (c) a torn checkpoint (-9), then its resume; (d) a stalled
    loader under the watchdog (79); (e) the supervise CLI through a
    preemption (0), bit-equal to the uninterrupted run; (f) the NaN
    injection bit-equal to a poisoning loader wrapper; (g) the handler's
    and the watchdog's cost on the epoch wall. The launches of the
    uninterrupted run and (a)'s two runs are held to ``launch_plan``
    (``per_step``, ``per_fwd``) and returned."""
    import pickle

    from hydragnn_tpu_torch.api import create_dataloaders, prepare_config_and_samples, run_training, \
        train_with_loaders
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.obs import read_flight_record, validate_flight_record
    from hydragnn_tpu_torch.ops._build import BUILD_DIR
    from hydragnn_tpu_torch.resilience import EXIT_HUNG, EXIT_PREEMPTED, TrainingPreempted, inject
    from hydragnn_tpu_torch.train.loop import EPOCH_KEYS
    from hydragnn_tpu_torch.utils import checkpoint as ckpt
    from hydragnn_tpu_torch.utils.config import get_log_name_config

    reset, read = counts
    root = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    saved_env = {k: os.environ.get(k) for k in ("HGTORCH_DIAGNOSTICS", "HGTORCH_NUM_PREFETCH")}
    os.environ.update(HGTORCH_DIAGNOSTICS="0", HGTORCH_NUM_PREFETCH="2")
    raw = samples()
    samples_path = os.path.join(root, "samples.pkl")
    with open(samples_path, "wb") as f:
        pickle.dump(raw, f)
    cfg0 = flagship_config(batch_size=LOOP_BATCH, num_epoch=RES_EPOCHS)
    cfg0["NeuralNetwork"]["Training"].update(checkpoint_every=1, scan_epoch=False)
    tr, va, te, done = prepare_config_and_samples(copy.deepcopy(cfg0), copy.deepcopy(raw))
    loaders = create_dataloaders(tr, va, te, done)
    n_train, n_eval = len(loaders[0]), len(loaders[1]) + len(loaders[2])
    log_name = get_log_name_config(done)
    script = os.path.join(root, "child.py")
    with open(script, "w") as f:
        f.write(_RES_CHILD.format(repo=os.path.dirname(os.path.abspath(__file__)), seed=SEED))
    built = sorted(os.listdir(BUILD_DIR))

    def config(**training):
        cfg = copy.deepcopy(cfg0)
        cfg["NeuralNetwork"]["Training"].update(training)
        return cfg

    def want(steps, fwds):
        names = set(per_step) | set(per_fwd)
        return {k: steps * per_step.get(k, 0) + fwds * per_fwd.get(k, 0) for k in names}

    def state_of(model, optimizer):
        return ([t.detach().clone() for t in model.state_dict().values()]
                + [t.clone() for t in optimizer.state_tensors()] + [optimizer.steps.clone()])

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

    def events(label, name=log_name):
        return read_flight_record(os.path.join(root, label, name, "flight.jsonl"))

    def final_val(label):
        with open(os.path.join(root, label, log_name, "metrics.jsonl")) as f:
            return [json.loads(ln) for ln in f][-1]["val_loss"]

    def in_process(label, cfg, **kw):
        t0 = time.perf_counter()
        model, optimizer, hist, _ = run_training(cfg, copy.deepcopy(raw), log_dir=os.path.join(root, label),
                                                 device="cuda", seed=SEED, **kw)
        torch.cuda.synchronize()
        return model, optimizer, hist, time.perf_counter() - t0

    def start(label, training, extra, argv=None):
        """A child (``argv`` before it: the supervise CLI) started in the
        background, its output to a file."""
        cfg_path = os.path.join(root, f"{label}.json")
        with open(cfg_path, "w") as f:
            json.dump(config(**training), f)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("HGTORCH_INJECT_", "HGTORCH_AUTO_RESUME"))}
        env.update(extra)
        cmd = [sys.executable, script, cfg_path, samples_path, os.path.join(root, label)]
        log = open(os.path.join(root, f"{label}.{len(os.listdir(root))}.log"), "w+")
        return subprocess.Popen((argv or []) + cmd, env=env, stdout=log, stderr=subprocess.STDOUT), log, time.time()

    def finish(handle, timeout=600):
        """(exit code, output, start-up seconds of each child, wall s, the
        time it ended)."""
        proc, log, t0 = handle
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
        t_end = time.time()
        log.seek(0)
        out = log.read()
        log.close()
        startup = [[float(x) for x in ln.split()[1::2]] for ln in out.splitlines() if ln.startswith("CHILD-STARTUP")]
        return rc, out, startup, t_end - t0, t_end

    def expect_rc(label, rc, want_rc, out):
        if rc != want_rc:
            raise AssertionError(f"train-resilience {label}: exit code {rc}, want {want_rc}\n{out[-4000:]}")

    try:
        with deterministic_algorithms("train-resilience", "uninterrupted, (a), (f), (g)", card):
            # the uninterrupted run: the reference of (a), (b), (c), (e)
            reset()
            ref_model, ref_opt, ref_hist, ref_wall = in_process("reference", config())
            path_counts = read()
            ref_state = state_of(ref_model, ref_opt)
            ref_cpu = {k: t.detach().cpu() for k, t in ref_model.state_dict().items()}
            ref_val = ref_hist["val_loss"][-1]
            if not (np.isfinite(ref_hist["train_loss"]).all() and ref_hist["train_loss"][-1] < ref_hist["train_loss"][0]):
                raise AssertionError(f"train-resilience: the reference's loss is not finite and falling: {ref_hist}")
            need = ref_need = want(RES_EPOCHS * n_train, RES_EPOCHS * n_eval + 2 * n_train)

            # (a) SIGTERM at the start of epoch 2, in process; then the resume
            real_sigterm, fired_at = inject.maybe_sigterm, []
            handler_before = signal.getsignal(signal.SIGTERM)

            def timed_sigterm(step=None, epoch=None):
                if epoch is not None and epoch == 2:
                    if threading.current_thread() is not threading.main_thread():
                        raise AssertionError("train-resilience (a): the loop is off the main thread")
                    fired_at.append(time.perf_counter())
                real_sigterm(step=step, epoch=epoch)

            os.environ["HGTORCH_INJECT_SIGTERM_EPOCH"] = "2"
            inject.maybe_sigterm = timed_sigterm
            reset()
            try:
                in_process("a", config(preempt_grace_s=RES_GRACE_S))
                raise AssertionError("train-resilience (a): the run was not preempted")
            except TrainingPreempted as exc:
                t_raise = time.perf_counter()
                if (exc.signum, exc.epoch) != (signal.SIGTERM, 2):
                    raise AssertionError(f"train-resilience (a): {exc.signum}, epoch {exc.epoch}")
            finally:
                inject.maybe_sigterm = real_sigterm
                del os.environ["HGTORCH_INJECT_SIGTERM_EPOCH"]
            pre_counts = read()
            signal_to_raise = t_raise - fired_at[0]
            if signal.getsignal(signal.SIGTERM) != handler_before:
                raise AssertionError("train-resilience (a): the handler was not uninstalled")
            os.environ["HGTORCH_AUTO_RESUME"] = "1"
            reset()
            try:
                a_model, a_opt, a_hist, a_wall = in_process("a", config(preempt_grace_s=RES_GRACE_S))
            finally:
                del os.environ["HGTORCH_AUTO_RESUME"]
            resume_counts = read()
            for name, c in (("pre", pre_counts), ("resume", resume_counts)):
                path_counts = {k: path_counts[k] + c[k] for k in path_counts}
            need = plus(need, want(2 * n_train, 2 * n_eval))
            need = plus(need, want((RES_EPOCHS - 2) * n_train, (RES_EPOCHS - 2) * n_eval + 2 * n_train))
            if path_counts != {k: need.get(k, 0) for k in path_counts}:
                raise AssertionError(f"train-resilience: launches {path_counts}, want {need}")
            if any(a_hist[k] != ref_hist[k] for k in EPOCH_KEYS) or not same(state_of(a_model, a_opt), ref_state):
                raise AssertionError("train-resilience (a): the resumed run differs from the uninterrupted one")
            a_events = events("a")
            kinds = [e["kind"] for e in a_events if e["kind"] in ("preempt", "resumed", "run_end")]
            if kinds != ["preempt", "run_end", "resumed", "run_end"] or validate_flight_record(a_events):
                raise AssertionError(f"train-resilience (a): flight {kinds}, {validate_flight_record(a_events)}")
            # the hard-exit timer was cancelled: this process outlives the grace window
            time.sleep(max(0.0, RES_GRACE_S + 1.0 - (time.perf_counter() - fired_at[0])))
            line("train-resilience", scenario="a_epoch_boundary_in_process", signal=15, preempt_epoch=2,
                 signal_to_raise_s=round(signal_to_raise, 4), grace_s=RES_GRACE_S,
                 alive_after_grace_s=round(time.perf_counter() - fired_at[0], 2), resumed_bit_equal=True,
                 history_epochs=len(a_hist["train_loss"]), wall_s_uninterrupted=round(ref_wall, 3),
                 wall_s_resume=round(a_wall, 3), card=repr(card))

            # (f) NaN injection against a poisoning loader wrapper
            nan_hists = {}
            nan_cfg = copy.deepcopy(done)
            nan_cfg["NeuralNetwork"]["Training"]["num_epoch"] = 2
            for label in ("f_wrapper", "f_injected"):
                tl, vl, tel = create_dataloaders(tr, va, te, copy.deepcopy(nan_cfg))
                if label == "f_injected":
                    os.environ["HGTORCH_INJECT_NAN_STEP"] = "3:2"
                else:
                    tl = _PoisonAt(tl, 3, 2)
                try:
                    _, _, nan_hists[label] = train_with_loaders(copy.deepcopy(nan_cfg), tl, vl, tel,
                                                                log_dir=os.path.join(root, label), device=dev,
                                                                seed=SEED)
                finally:
                    os.environ.pop("HGTORCH_INJECT_NAN_STEP", None)
            fw, fi = nan_hists["f_wrapper"], nan_hists["f_injected"]
            skipped = {e["epoch"]: e["nonfinite"]["skipped"] for e in events("f_injected", get_log_name_config(nan_cfg))
                       if e["kind"] == "epoch" and e.get("nonfinite")}
            if (any(fw[k] != fi[k] for k in EPOCH_KEYS) or not np.isfinite(fi["train_loss"]).all()
                    or fi["nonfinite_skipped"] != fw["nonfinite_skipped"] or skipped != {0: 2}):
                raise AssertionError(f"train-resilience (f): {fi['nonfinite_skipped']} vs {fw['nonfinite_skipped']}, "
                                     f"flight {skipped}")
            line("train-resilience", scenario="f_nan_injection", steps="3:2", skipped=json.dumps(fi["nonfinite_skipped"]),
                 bit_equal_to_wrapper=True, dispatch=fi["dispatch_mode"]["reason"], card=repr(card))

            # (g) the cost: the handler off (bit-equal, the same launches), the
            # watchdog's per-step epoch against the fixed epoch it turns off
            reset()
            off_model, off_opt, off_hist, _ = in_process("g_handler_off", config(preempt_handler=False))
            off_counts = read()
            if (any(off_hist[k] != ref_hist[k] for k in EPOCH_KEYS) or not same(state_of(off_model, off_opt), ref_state)
                    or off_counts != {k: ref_need.get(k, 0) for k in off_counts}):
                raise AssertionError("train-resilience (g): the handler changed the run or its launches")
            wd_hist = in_process("g_watchdog", config(scan_epoch=None, watchdog_stall_s=600))[2]
            fixed_hist = in_process("g_fixed", config(scan_epoch=None))[2]
            if wd_hist["dispatch_mode"]["reason"] != "hang watchdog active" or fixed_hist["dispatch_mode"]["mode"] != "fixed_epoch":
                raise AssertionError(f"train-resilience (g): {wd_hist['dispatch_mode']}, {fixed_hist['dispatch_mode']}")
            walls = {k: [round(x, 4) for x in h["train_wall_s"]] for k, h in
                     (("handler_on", ref_hist), ("handler_off", off_hist), ("watchdog_per_step", wd_hist),
                      ("fixed", fixed_hist))}
            mean = {k: float(np.mean(v[1:])) for k, v in walls.items()}
            line("train-resilience", scenario="g_cost", epoch_wall_s=json.dumps(walls, separators=(",", ":")),
                 handler_on_minus_off_ms=round((mean["handler_on"] - mean["handler_off"]) * 1e3, 2),
                 watchdog_per_step_minus_fixed_ms=round((mean["watchdog_per_step"] - mean["fixed"]) * 1e3, 2),
                 handler_bit_equal=True, handler_launches_equal=True, steps_per_epoch=n_train, card=repr(card))

        # the children, each under deterministic algorithms (the child script
        # sets them) and loading this process's kernels: (b), (c) and (e)
        # together, then (b)'s and (c)'s resumes, then (d) alone (its 3 s
        # watchdog must not see another process's load)
        ctimes = {}
        sup_flight = os.path.join(root, "e_supervisor.jsonl")
        running = {"b": start("b", {}, {"HGTORCH_INJECT_SIGTERM_STEP": "11"}),
                   "c": start("c", {}, {"HGTORCH_INJECT_KILL_CHECKPOINT": "2"}),
                   "e": start("e", {}, {"HGTORCH_INJECT_SIGTERM_EPOCH": "2"},
                              argv=[sys.executable, "-m", "hydragnn_tpu_torch.tools.supervise", "--flight",
                                    sup_flight, "--"])}
        try:
            rc, out, st, _, _ = finish(running.pop("b"))
            expect_rc("(b)", rc, EXIT_PREEMPTED, out)
            ev = events("b")
            pre = [e for e in ev if e["kind"] == "preempt"]
            if (len(pre) != 1 or pre[0]["signal"] != 15 or ev[-1]["kind"] != "run_end"
                    or ev[-1]["status"] != "preempted"
                    or not os.path.exists(os.path.join(root, "b", log_name, f"{log_name}.pt"))
                    or not os.path.exists(os.path.join(root, "b", log_name, f"{log_name}.meta.json"))):
                raise AssertionError(f"train-resilience (b): {[e['kind'] for e in ev]}")
            ctimes["b"] = st
            running["b"] = start("b", {}, {"HGTORCH_AUTO_RESUME": "1"})
            rc, out, st, _, _ = finish(running.pop("c"))
            expect_rc("(c)", rc, -signal.SIGKILL, out)
            if ckpt.validate_checkpoint_file(os.path.join(root, "c", log_name, f"{log_name}.pt")):
                raise AssertionError("train-resilience (c): the torn pointer validates")
            ctimes["c"] = st
            running["c"] = start("c", {}, {"HGTORCH_AUTO_RESUME": "1"})

            rc, out, st, _, _ = finish(running.pop("b"))
            expect_rc("(b) resume", rc, 0, out)
            ev = events("b")
            statuses = [e["status"] for e in ev if e["kind"] == "run_end"]
            b_val = final_val("b")
            if (sum(e["kind"] == "resumed" for e in ev) != 1 or statuses != ["preempted", "completed"]
                    or validate_flight_record(ev) or abs(b_val - ref_val) > RES_MIDEPOCH_REL * abs(ref_val)):
                raise AssertionError(f"train-resilience (b): {statuses}, val {b_val} vs {ref_val}")
            ctimes["b"] += st
            line("train-resilience", scenario="b_mid_epoch_child", rcs="75,0", preempt_epoch=pre[0]["epoch"],
                 preempt_step=pre[0]["step"], final_val_loss=b_val, uninterrupted_val_loss=ref_val,
                 rel=round(abs(b_val - ref_val) / abs(ref_val), 6), tol_rel=RES_MIDEPOCH_REL,
                 child_startup_s=json.dumps(ctimes["b"]), card=repr(card))

            rc, out, st, _, _ = finish(running.pop("c"))
            expect_rc("(c) resume", rc, 0, out)
            c_val = final_val("c")
            ev = events("c")
            if ("rejected" not in out or ev[-1]["status"] != "completed"
                    or sum(e["kind"] == "resumed" for e in ev) != 1 or abs(c_val - ref_val) > RES_TORN_REL * abs(ref_val)):
                raise AssertionError(f"train-resilience (c): val {c_val} vs {ref_val}\n{out[-3000:]}")
            ctimes["c"] += st
            line("train-resilience", scenario="c_torn_checkpoint_child", rcs="-9,0", rejected_warning=True,
                 final_val_loss=c_val, uninterrupted_val_loss=ref_val,
                 rel=round(abs(c_val - ref_val) / abs(ref_val), 8), tol_rel=RES_TORN_REL,
                 child_startup_s=json.dumps(ctimes["c"]), card=repr(card))

            rc, out, st, e_wall, _ = finish(running.pop("e"))
            expect_rc("(e)", rc, 0, out)
            sup = read_flight_record(sup_flight)
            restarts = [e for e in sup if e["kind"] == "restart"]
            e_state = torch.load(os.path.join(root, "e", log_name, f"{log_name}.pt"), map_location="cpu",
                                 weights_only=True)["model"]
            if (len(restarts) != 1 or restarts[0]["cause"] != "preempted" or restarts[0]["delay_s"] != 0.0
                    or sup[-1]["status"] != "completed" or validate_flight_record(sup)
                    or list(e_state) != list(ref_cpu) or not all(torch.equal(e_state[k], ref_cpu[k]) for k in ref_cpu)):
                raise AssertionError(f"train-resilience (e): {[e['kind'] for e in sup]}, {sup[-1]}")
            ctimes["e"] = st
            line("train-resilience", scenario="e_supervisor_cli", rc=0, restarts=1, cause="preempted", delay_s=0.0,
                 status="completed", params_bit_equal_to_uninterrupted=True, wall_s=round(e_wall, 3),
                 child_startup_s=json.dumps(st), card=repr(card))

            rc, out, st, _, t_exit = finish(start("d", {"watchdog_stall_s": RES_STALL_S},
                                                  {"HGTORCH_INJECT_STALL_LOADER": "2:120"}), timeout=300)
            expect_rc("(d)", rc, EXIT_HUNG, out)
            ev = events("d")
            wd = [e for e in ev if e["kind"] == "watchdog"]
            main_stack = wd[0]["stacks"].get("MainThread", "") if wd else ""
            if (len(wd) != 1 or wd[0]["stall_s"] < RES_STALL_S or "loader.py" not in main_stack
                    or ev[-1]["kind"] != "run_end" or ev[-1]["status"] != "hung" or validate_flight_record(ev)):
                raise AssertionError(f"train-resilience (d): {[e['kind'] for e in ev]}\n{main_stack[-2000:]}")
            stall_began = wd[0]["t"] - wd[0]["stall_s"]
            ctimes["d"] = st
            line("train-resilience", scenario="d_stalled_loader_child", rc=79, stall_s=wd[0]["stall_s"],
                 watchdog_s=RES_STALL_S, stall_to_exit_s=round(t_exit - stall_began, 3),
                 main_thread_in="GraphLoader.__iter__ (queue wait)", child_startup_s=json.dumps(st), card=repr(card))
        finally:
            for proc, log, _ in running.values():  # only after a failure: stop what still runs
                proc.kill()
                proc.wait()
                log.close()
        rebuilt = sorted(os.listdir(BUILD_DIR)) != built
        if rebuilt:
            raise AssertionError("train-resilience: a child built kernels again")
        line("train-resilience", part="children", children=sum(len(v) for v in ctimes.values()),
             startup_s_total_torch_port_data=json.dumps(ctimes, separators=(",", ":")), kernels_rebuilt=False,
             launches=json.dumps(path_counts, separators=(",", ":")), card=repr(card))
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return path_counts


class _PoisonAt:
    """A train loader that gives train steps ``start .. start+count-1``
    (counted over the run, as ``HGTORCH_INJECT_NAN_STEP`` counts them) new
    batches with NaN node features, and offers no resident batches."""

    def __init__(self, loader, start, count):
        self.loader, self.start, self.count, self.step = loader, start, count, 0
        self.shuffle = loader.shuffle

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def set_device(self, device):
        self.loader.set_device(device)

    def __iter__(self):
        for b in self.loader:
            bad = self.start <= self.step < self.start + self.count
            self.step += 1
            yield dataclasses.replace(b, nodes=torch.full_like(b.nodes, float("nan"))) if bad else b


def device_lock_turns(run_burst, rounds=1):
    """``run_burst(label)``'s latency fields under ``serve/buckets.py``'s
    DEVICE_LOCK (``shared``: runs side by side), under one plain lock in
    its place (``plain``: one run at a time) and under none (``none``),
    in turns (shared, plain, none, none, plain, shared) ``rounds`` times,
    and the medians of each: the lock's cost where no capture runs."""
    from hydragnn_tpu_torch.serve import buckets

    lock, plain = buckets.DEVICE_LOCK, threading.Lock()
    stand_ins = {"shared": lock,
                 "plain": types.SimpleNamespace(shared=lambda: plain, exclusive=lambda: plain),
                 "none": types.SimpleNamespace(shared=contextlib.nullcontext, exclusive=contextlib.nullcontext)}
    turns = {mode: [] for mode in stand_ins}
    for _ in range(rounds):
        for mode in ("shared", "plain", "none", "none", "plain", "shared"):
            buckets.DEVICE_LOCK = stand_ins[mode]
            try:
                turns[mode].append(run_burst(f"lock {mode}"))
            finally:
                buckets.DEVICE_LOCK = lock
    medians = {f"{k}_{mode}": float(np.median([f[k] for f in turns[mode]]))
               for mode in turns for k in ("p50_ms", "requests_per_s")}
    return turns, medians


def lock_witness_phase(dev, card, counts, make_raw, per_forward):
    """[lock-witness]: the [serve] burst on the flagship at full width with
    the lock-order witness off, then on (``HGTORCH_LOCK_DEBUG=1``): 0
    violations on clean traffic, the p50 and requests/s of both; then
    ``HGTORCH_INJECT_LOCK_ORDER`` on two of the server's locks: one
    injected ``lock_order`` event, valid, and the server goes on
    answering. With the witness off, the same burst under the device
    lock, a plain lock and none, in turns (``device_lock_turns``). Every start's
    launches (the warm-up forwards and the captures) are held to
    ``per_forward``; a burst launches nothing. Returns the launches."""
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.obs import FlightRecorder, read_flight_record, validate_flight_record
    from hydragnn_tpu_torch.serve import request_to_dict
    from hydragnn_tpu_torch.utils import syncdebug

    reset, read = counts
    root = tempfile.mkdtemp(prefix="chip_smoke_witness_")
    saved = os.environ.get("HGTORCH_LOCK_DEBUG")
    total = {k: 0 for k in per_forward}
    fields = {}
    try:
        for label, on, injected in (("off", "0", None), ("on", "1", None),
                                    ("injected", "1", "server.ModelServer._reload_lock,server.ModelServer._pin_lock")):
            os.environ["HGTORCH_LOCK_DEBUG"] = on
            if injected:
                os.environ["HGTORCH_INJECT_LOCK_ORDER"] = injected
            syncdebug.reset()  # the witness reads its knob once a process
            flight_path = os.path.join(root, f"{label}.jsonl")
            flight = FlightRecorder(flight_path)
            reset()
            server = hydragnn_tpu_torch.serve_model(flagship_config(), make_raw(), device=dev, seed=SEED,
                                                    flight=flight)
            try:
                cache = server._cache
                start = read()
                need = {k: v * (cache.captures + cache.warm_forwards) for k, v in per_forward.items()}
                if {k: start[k] for k in need} != need:
                    raise AssertionError(f"lock-witness {label}: launches at start {start}, want {need}")
                requests = [request_to_dict(s) for s in server.reference_samples]
                reset()
                results, lat, wall = serve_burst(server, requests * 2)
                burst = read()
                serial = serial_latencies(server, requests[:16])
                if any(burst.values()):
                    raise AssertionError(f"lock-witness {label}: the burst launched {burst}")
                if label == "off":

                    def lock_burst(mode):
                        reset()
                        _, lat_, wall_ = serve_burst(server, requests * 2)
                        if any(read().values()):
                            raise AssertionError(f"lock-witness ({mode}): the burst launched {read()}")
                        return serve_latency_fields(lat_, wall_, [0.0])

                    turns, medians = device_lock_turns(lock_burst)
                    line("lock-witness", part="device_lock", turns=json.dumps(turns), **medians, card=repr(card))
            finally:
                server.stop()
                flight.close()
                os.environ.pop("HGTORCH_INJECT_LOCK_ORDER", None)
            total = {k: total[k] + start[k] for k in total}
            ev = read_flight_record(flight_path)
            orders = [e for e in ev if e["kind"] == "lock_order"]
            witnessed = syncdebug.enabled()
            n_viol = len(syncdebug.violations())
            want_n = 1 if injected else 0
            if (witnessed != (on == "1") or n_viol != want_n or len(orders) != want_n or validate_flight_record(ev)
                    or (injected and not orders[0]["injected"]) or ev[-1]["kind"] != "run_end"):
                raise AssertionError(f"lock-witness {label}: witness {witnessed}, {n_viol} violations, "
                                     f"{len(orders)} lock_order events")
            fields[label] = serve_latency_fields(lat, wall, serial)
            line("lock-witness", run=label, witness=witnessed, violations=n_viol, lock_order_events=len(orders),
                 injected=bool(injected), answered=len(results), locks_witnessed=len(syncdebug._REGISTERED),
                 **fields[label], card=repr(card))
        line("lock-witness", part="cost", p50_ms_off=fields["off"]["p50_ms"], p50_ms_on=fields["on"]["p50_ms"],
             requests_per_s_off=fields["off"]["requests_per_s"], requests_per_s_on=fields["on"]["requests_per_s"],
             card=repr(card))
    finally:
        if saved is None:
            os.environ.pop("HGTORCH_LOCK_DEBUG", None)
        else:
            os.environ["HGTORCH_LOCK_DEBUG"] = saved
        syncdebug.reset()
        shutil.rmtree(root, ignore_errors=True)
    return total


PILOT_BATCH, PILOT_EPOCHS = 16, 2  # [pilot]'s serving run: run_training on [serve]'s 64 graphs
# the knobs of the JAX package's own closed-loop smoke (ci.sh:1872-1874):
# the loop's mechanics, not a model-quality statement. A fine-tune ends in
# the BatchNorm recalibration over the shifted window, so the candidate's
# clean reference slice moves by more than the default 0.2 tolerance; the
# injected regression (+1e6) still fails any tolerance
PILOT_ENV = {"HGTORCH_PILOT_CANARY_TOL": "10.0", "HGTORCH_PILOT_TUNE_EPOCHS": "1",
             "HGTORCH_PILOT_TUNE_BACKOFF_S": "0.1", "HGTORCH_PILOT_COOLDOWN_S": "1.0",
             "HGTORCH_PILOT_MAX_WALL_S": "300", "HGTORCH_DIAGNOSTICS": "0"}
# a fine-tune child: deterministic algorithms (as this process runs them),
# and the seconds its interpreter and its `import torch` took
_PILOT_SITE = r'''
import json, os, time
_t0 = time.time()
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
with open(os.environ["CHIP_SMOKE_CHILD_LOG"], "a") as _f:
    _f.write(json.dumps({"pid": os.getpid(), "t_python": _t0, "t_torch": time.time()}) + "\n")
'''


def _sha256(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _answers_equal(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(np.asarray(a[k]).view(np.int32),
                                                         np.asarray(b[k]).view(np.int32)) for k in a)


def pilot_phase(dev, card, counts, make_raw, per_forward):
    """[pilot]: the retrain pilot on the flagship at full width, served
    from CUDA graphs under deterministic algorithms, from a run on disk
    (``run_training`` on [serve]'s 64 graphs, PILOT_EPOCHS epochs), with
    the spool at 1, the feature drift rule and the knobs of PILOT_ENV:
    (a) a shift of 5.0 opens one feature_drift incident; the pilot runs
        the real supervised fine-tune child on this card and journals
        drift_confirmed -> fine_tuning -> canary -> reloading -> cooldown;
        every request answered, no error event, the serving checkpoint's
        bytes unchanged, 0 captures after start, the replays after the
        reload bit-equal to the candidate checkpoint's eager forward; the
        same fine-tune in process on the pinned window gives parameters
        bit-equal to the child's, its launches held to launch_plan;
    (b) HGTORCH_INJECT_PILOT_TRAIN_CRASH=1: the first child exits 70, one
        restart, the stripped retry completes the cycle;
    (c) HGTORCH_INJECT_PILOT_CANARY_REGRESS (a's candidate through the
        tuner seam): canary_regression, no reload, the answers bit-equal;
    (d) HGTORCH_INJECT_PILOT_TORN_RELOAD (a's candidate, its pointer torn;
        no versioned checkpoints): reload_failed, the answers bit-equal.
    Prints each state's seconds, the children's start-up and `import
    torch`, the fine-tune's wall, the canary's ms, the reload's swap_s and
    the burst while the child trains against the same burst before.
    Returns the path's launches: the canary's forwards and the in-process
    fine-tune's."""
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.api import create_dataloaders, prepare_config_and_samples
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.obs import FlightRecorder, build_reference, list_incidents, read_flight_record
    from hydragnn_tpu_torch.obs import validate_flight_record
    from hydragnn_tpu_torch.obs.triggers import TriggerVerdict
    from hydragnn_tpu_torch.pilot import RetrainPilot
    from hydragnn_tpu_torch.pilot import tune
    from hydragnn_tpu_torch.serve import ServeConfig, request_to_dict
    from hydragnn_tpu_torch.serve.registry import load_served_variables
    from hydragnn_tpu_torch.utils.checkpoint import checkpoint_path
    from hydragnn_tpu_torch.utils.config import get_log_name_config

    reset, read = counts
    root = tempfile.mkdtemp(prefix="chip_smoke_pilot_")
    log_dir = os.path.join(root, "logs") + "/"
    site_dir = os.path.join(root, "site")
    os.makedirs(site_dir)
    with open(os.path.join(site_dir, "sitecustomize.py"), "w") as f:
        f.write(_PILOT_SITE)
    child_log = os.path.join(root, "children.jsonl")
    env_keys = list(PILOT_ENV) + ["PYTHONPATH", "CHIP_SMOKE_CHILD_LOG", "HGTORCH_INJECT_DRIFT",
                                  "HGTORCH_INCIDENT_PROFILE_STEPS"]
    saved = {k: os.environ.get(k) for k in env_keys}
    repo = os.path.dirname(os.path.abspath(__file__))
    os.environ.update(PILOT_ENV, CHIP_SMOKE_CHILD_LOG=child_log, HGTORCH_INCIDENT_PROFILE_STEPS="4",
                      PYTHONPATH=os.pathsep.join([site_dir, repo] + [p for p in [saved["PYTHONPATH"]] if p]))
    out, fields = {}, {}
    try:
        with deterministic_algorithms("pilot", "the serving run, the server, the children and the in-process "
                                      "fine-tune on the card", card):
            cfg0 = flagship_config(batch_size=PILOT_BATCH, num_epoch=PILOT_EPOCHS)
            _, _, _, done = hydragnn_tpu_torch.run_training(copy.deepcopy(cfg0), make_raw(), log_dir=log_dir,
                                                            device=dev, seed=SEED)
            run = get_log_name_config(done)
            ckpt = checkpoint_path(run, log_dir)
            ckpt_sha = _sha256(ckpt)
            tr, va, te, _ = prepare_config_and_samples(copy.deepcopy(cfg0), make_raw())
            ref_path = os.path.join(root, "ref.json")
            with open(ref_path, "w") as f:
                json.dump(build_reference(list(tr)), f)
            flight_path = os.path.join(root, "flight.jsonl")
            scfg = ServeConfig(spool=True, spool_sample=1, spool_shard_mb=0.25, spool_max_mb=64.0,
                               spool_dir=os.path.join(root, "spool"), drift_ref=ref_path, drift_pred_psi=None,
                               drift_min_count=400, trigger_eval_every_s=0.05,
                               incident_dir=os.path.join(root, "incidents"))
            reset()
            server = hydragnn_tpu_torch.serve_model(copy.deepcopy(cfg0), make_raw(), serve_config=scfg, device=dev,
                                                    log_dir=log_dir, flight=FlightRecorder(flight_path))
            try:
                cache = server._cache
                start = read()
                need = {k: v * (cache.captures + cache.warm_forwards) for k, v in per_forward.items()}
                if {k: start[k] for k in need} != need or cache.captures != 2 * len(server.buckets):
                    raise AssertionError(f"pilot: launches at start {start}, want {need}; {cache.captures} captures")
                captures = cache.captures
                tuned = []

                def timed_tuner(candidate):
                    # the shift has done its work once a cycle starts; a child
                    # must not inherit it (an injection turns the loop's
                    # dispatch per-step, and the in-process run below has none)
                    os.environ.pop("HGTORCH_INJECT_DRIFT", None)
                    t = time.time()
                    res = pilot._default_tuner(candidate)
                    tuned.append({"candidate": candidate, "t_spawn": t, "t_end": time.time(), **res})
                    return res

                pilot = RetrainPilot(server, run, reference_samples=list(va) + list(te), tuner=timed_tuner)
                server.attach_pilot(pilot)
                requests = [request_to_dict(s) for s in server.reference_samples]
                serve_burst(server, requests)  # warm the path
                _, lat0, wall0 = serve_burst(server, requests * 2)
                fields["before"] = serve_latency_fields(lat0, wall0, [0.0])
                # (a) the shift opens the incident; the cycle's launches are the canary's
                reset()
                os.environ["HGTORCH_INJECT_DRIFT"] = DRIFT_SHIFT
                answered = len(serve_burst(server, requests * 3)[0])
                deadline = time.monotonic() + 120
                while pilot.status()["cycle"] == 0 and time.monotonic() < deadline:
                    server.predict(requests[answered % len(requests)], timeout=300)
                    answered += 1
                os.environ.pop("HGTORCH_INJECT_DRIFT", None)
                if pilot.status()["cycle"] != 1:
                    raise AssertionError(f"pilot (a): no cycle after {answered} shifted requests: {pilot.status()}")
                lat1, wall1 = [], 0.0
                while pilot.poll() in ("drift_confirmed", "fine_tuning") and len(lat1) < 6 * 2 * len(requests):
                    res, l_, w_ = serve_burst(server, requests * 2)
                    answered += len(res)
                    if pilot.poll() in ("drift_confirmed", "fine_tuning"):
                        lat1 += l_
                        wall1 += w_
                pilot.join(timeout=float(PILOT_ENV["HGTORCH_PILOT_MAX_WALL_S"]) * 3)
                a_counts = read()
                if lat1:
                    fields["while_training"] = serve_latency_fields(lat1, wall1, [0.0])
                entries = pilot.journal.entries()
                states = [e["state"] for e in entries]
                tail = entries[-1]["detail"]
                want_states = ["idle", "drift_confirmed", "fine_tuning", "canary", "reloading", "cooldown"]
                if states != want_states or tail.get("reason") != "reloaded":
                    raise AssertionError(f"pilot (a): journal {states}, tail {tail}")
                pinned = entries[1]["detail"]["pinned_shards"]
                cand = tail["candidate"]
                # the replays after the reload against the candidate checkpoint's eager forward
                records = record_batches(cache)
                serve_burst(server, requests)
                del cache.run
                cand_model = create_model(server.served.cfg, device=dev)
                cand_model.load_state_dict(load_served_variables(server.served, cand, log_dir))
                n_eq = bit_equal_to_eager(records, cand_model, dev, "pilot (a)")
                # the same fine-tune in process: bit-equal parameters, its launches as launch_plan
                window = tune._load_window(server.spool_dir(), pinned)
                t_sp, v_sp, e_sp = tune._split(window)
                with open(os.path.join(log_dir, run, "config.json")) as f:
                    run_cfg = json.load(f)
                tl, vl, el = create_dataloaders(t_sp, v_sp, e_sp, run_cfg)
                per_step, per_fwd = launch_plan(run_cfg["NeuralNetwork"]["Architecture"],
                                                batch_layout(next(iter(tl))))
                epochs = int(PILOT_ENV["HGTORCH_PILOT_TUNE_EPOCHS"])
                steps, fwds = epochs * len(tl), epochs * (len(vl) + len(el)) + 2 * len(tl)
                reset()
                t_in = time.perf_counter()
                tune.fine_tune(log_dir, run, f"{run}-inprocess", spool_dir=server.spool_dir(), shards=pinned,
                               epochs=epochs, device=dev)
                inproc_s = time.perf_counter() - t_in
                f_counts = read()
                want_f = {k: steps * per_step.get(k, 0) + fwds * per_fwd.get(k, 0) for k in f_counts}
                if f_counts != want_f:
                    raise AssertionError(f"pilot (a): the in-process fine-tune launched {f_counts}, want {want_f}")
                child_sd = load_served_variables(server.served, cand, log_dir)
                inproc_sd = load_served_variables(server.served, f"{run}-inprocess", log_dir)
                differ = [k for k in child_sd if not torch.equal(child_sd[k], inproc_sd[k])]
                if differ:
                    raise AssertionError(f"pilot (a): the child's candidate differs from the in-process one at "
                                         f"{differ[:5]}")
                n_canary = sum(min(len(s), pilot.config.canary_samples) for s in (list(va) + list(te), window))
                want_a = {k: 2 * n_canary * per_forward.get(k, 0) for k in a_counts}
                if a_counts != want_a:
                    raise AssertionError(f"pilot (a): the cycle launched {a_counts} in this process, want {want_a} "
                                         f"({n_canary} samples scored twice)")
                path_counts = {k: a_counts[k] + f_counts[k] for k in a_counts}
                secs = {s: round(entries[i + 1]["t"] - entries[i]["t"], 3) for i, s in enumerate(states[:-1])}
                cflight = read_flight_record(os.path.join(log_dir, cand, "flight.jsonl"))
                c_start = next(e for e in cflight if e["kind"] == "run_start")["t"]
                c_end = next(e for e in reversed(cflight) if e["kind"] == "run_end")["t"]
                out.update(answered=answered, incidents=len(list_incidents(scfg.incident_dir)), candidate=cand,
                           pinned_shards=len(pinned), window_samples=len(window), state_s=json.dumps(secs),
                           canary_ms=round(secs["canary"] * 1e3, 1), fine_tune_wall_s=round(c_end - c_start, 3),
                           child_start_up_s=round(c_start - tuned[0]["t_spawn"], 3),
                           replays_bit_equal_to_candidate=n_eq, candidate_bit_equal_in_process=True,
                           in_process_fine_tune_s=round(inproc_s, 3), canary=json.dumps(tail.get("reference")),
                           canary_window=json.dumps(tail.get("window")),
                           launches_cycle=json.dumps(a_counts, separators=(",", ":")),
                           launches_fine_tune=json.dumps(f_counts, separators=(",", ":")))
                line("pilot", scenario="a", **out, card=repr(card))
                # (b)-(d) through the pilot's own entry, on (a)'s pinned window
                inc_dir = os.path.join(root, "stub_incident")
                os.makedirs(inc_dir)
                with open(os.path.join(inc_dir, "drift_report.json"), "w") as f:
                    json.dump({"pinned_shards": pinned}, f)
                incident = types.SimpleNamespace(id="stub", dir=inc_dir)
                verdict = TriggerVerdict("serve_feature_drift", "feature_drift", "serve.drift.feature_psi", 1.0,
                                         0.25, time.time())

                def cycle(label, injection, reuse):
                    deadline_ = time.monotonic() + 30
                    while pilot.poll() != "idle" and time.monotonic() < deadline_:
                        time.sleep(0.1)
                    if injection:
                        os.environ[injection] = "1"
                    if reuse:
                        def copy_tuner(candidate):
                            shutil.copytree(os.path.join(log_dir, cand), os.path.join(log_dir, candidate))
                            for name in os.listdir(os.path.join(log_dir, candidate)):
                                if name.startswith(cand):
                                    os.rename(os.path.join(log_dir, candidate, name),
                                              os.path.join(log_dir, candidate, candidate + name[len(cand):]))
                            return {"status": "completed"}

                        pilot.tuner = copy_tuner
                    else:
                        pilot.tuner = timed_tuner
                    before = [server.predict(r, timeout=300) for r in requests[:16]]
                    n_ev = len(read_flight_record(flight_path))
                    try:
                        if not pilot.on_drift_incident(incident, verdict):
                            raise AssertionError(f"pilot ({label}): the incident started no cycle: {pilot.status()}")
                        pilot.join(timeout=900)
                    finally:
                        if injection:
                            del os.environ[injection]
                    after = [server.predict(r, timeout=300) for r in requests[:16]]
                    new_events = read_flight_record(flight_path)[n_ev:]
                    return pilot.journal.last()["detail"], before, after, new_events

                n_tuned = len(tuned)
                tail, before, after, ev = cycle("b", "HGTORCH_INJECT_PILOT_TRAIN_CRASH", reuse=False)
                res = tuned[n_tuned]
                causes = [h["cause"] for h in res["history"]]
                if (tail.get("reason") != "reloaded" or res["restarts"] != 1 or causes != ["crash", "completed"]
                        or res["history"][0]["exit_code"] != 70):
                    raise AssertionError(f"pilot (b): tail {tail}, supervisor {res}")
                line("pilot", scenario="b", reason=tail["reason"], candidate=tail["candidate"],
                     restarts=res["restarts"], exit_codes=json.dumps([h["exit_code"] for h in res["history"]]),
                     supervised_s=round(res["t_end"] - res["t_spawn"], 3),
                     reloads=len([e for e in ev if e["kind"] == "reload"]), card=repr(card))
                for label, injection, reason, kind in (("c", "HGTORCH_INJECT_PILOT_CANARY_REGRESS",
                                                        "canary_regression", None),
                                                       ("d", "HGTORCH_INJECT_PILOT_TORN_RELOAD", "reload_failed",
                                                        "reload_failed")):
                    tail, before, after, ev = cycle(label, injection, reuse=True)
                    reloads = [e["kind"] for e in ev if e["kind"] in ("reload", "reload_failed")]
                    same = all(_answers_equal(a, b) for a, b in zip(before, after))
                    if tail.get("reason") != reason or reloads != ([kind] if kind else []) or not same:
                        raise AssertionError(f"pilot ({label}): tail {tail}, reload events {reloads}, "
                                             f"answers unchanged {same}")
                    line("pilot", scenario=label, reason=reason, reload_events=json.dumps(reloads),
                         answers_bit_equal_to_before=same, card=repr(card))
                if cache.captures != captures or _sha256(ckpt) != ckpt_sha:
                    raise AssertionError(f"pilot: {cache.captures - captures} captures after start, or the serving "
                                         f"checkpoint changed")
            finally:
                server.stop()
        events = read_flight_record(flight_path)
        errors = [e for e in events if e["kind"] == "error"]
        drifts = [e for e in events if e["kind"] == "drift"]
        swaps = [e["swap_s"] for e in events if e["kind"] == "reload"]
        if validate_flight_record(flight_path) or errors or [e["rule_kind"] for e in drifts] != ["feature_drift"] \
                or len(swaps) != 2:
            raise AssertionError(f"pilot: flight problems {validate_flight_record(flight_path)}, errors "
                                 f"{[(e.get('where'), e.get('error')) for e in errors]}, drift events "
                                 f"{len(drifts)}, reloads {swaps}")
        with open(child_log) as f:
            kids = [json.loads(ln) for ln in f if ln.strip()]
        line("pilot", part="summary", children=len(kids),
             child_import_torch_s=json.dumps([round(k["t_torch"] - k["t_python"], 3) for k in kids]),
             reload_swap_s=json.dumps(swaps), burst_before=json.dumps(fields["before"]),
             burst_while_training=json.dumps(fields.get("while_training")), serving_checkpoint_unchanged=True,
             captures_after_start=0, card=repr(card))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    return path_counts


FLEET_BURST = 2  # [fleet]'s burst: [serve]'s 64 requests twice, from SERVE_THREADS threads


def fleet_phase(dev, card, counts, make_raw, per_forward):
    """[fleet]: a ``Fleet`` of flagship replicas at full width on one card,
    each with its own weights and CUDA graphs, under deterministic
    algorithms (``ServeConfig()``, [serve]'s 64 graphs):
    (a) the 128-request burst at N = 1 and N = 2: requests/s and p99,
        every answer bit-equal to its replica's eager forward;
    (h) ``tools/serve_probe.py --fleet`` on ``export_probes``: exit 0,
        naming router, r0 and r1;
    (d) a rolling reload of the same weights: ok on each replica, one
        fleet_reload event each, the answers bit-identical;
    (f) a rolling reload to other weights: after r0's swap r1 answers on
        the old ones; then both on the new, and so does a replica whose
        spawn was asked for after r0's swap (it waits for the roll);
    (g) a quiet scale-down under traffic: drain_stop drops no request;
    (b) a replica killed under a burst: the router retries each dead
        future, none lost; the controller's step replaces it, the
        replacement captures its own graphs, the survivor none;
    (c) a sustained fleet_queue_depth breach under a burst: one ``up``,
        the new replica capturing while the others replay, no failed
        request;
    (e) a replica killed mid-roll: ReloadFailed "died mid-roll", every
        future resolved, the survivor bit-equal to the old weights, one
        aborted_roll event and none ok.
    Prints each spawn's capture seconds and the card memory it adds, the
    kill-to-replace seconds and the rolls' walls. Every spawn's launches
    are held to ``per_forward`` x (captures + warm-up forwards); a burst
    launches nothing. Returns the launches."""
    from hydragnn_tpu_torch.api import prepare_config_and_samples
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.fleet import ControllerConfig, Fleet, FleetController
    from hydragnn_tpu_torch.obs import FlightRecorder, read_flight_record, validate_flight_record
    from hydragnn_tpu_torch.serve import ModelRegistry, ReloadFailed, RequestFailed, ServeConfig, request_to_dict
    from hydragnn_tpu_torch.serve import buckets

    reset, read = counts
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    flight_path = os.path.join(root, "flight.jsonl")
    total = {k: 0 for k in per_forward}
    spawns = []
    with deterministic_algorithms("fleet", "the replicas' captures, bursts and eager forwards on the card", card):
        tr, va, te, done = prepare_config_and_samples(flagship_config(), make_raw())
        samples = list(tr) + list(va) + list(te)
        served = ModelRegistry(device=dev).register("flagship", done["NeuralNetwork"], seed=SEED)
        requests = [request_to_dict(s) for s in samples]
        work = requests * FLEET_BURST
        fleet = Fleet(flight=FlightRecorder(flight_path))
        spawn = fleet._spawn

        def card_memory():
            # the memory a spawn adds, not the garbage earlier steps left;
            # each capture empties the allocator's cache (torch.cuda.graph),
            # so both readings are taken on an emptied cache
            gc.collect()
            with buckets.DEVICE_LOCK.exclusive():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                return torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)

        def measured_spawn(model):
            alloc, resv = card_memory()
            c0 = dict(read())
            t = time.perf_counter()
            rep = spawn(model)
            secs = time.perf_counter() - t
            alloc1, resv1 = card_memory()
            c1 = read()
            cache = rep.server._cache
            launched = {k: c1[k] - c0[k] for k in c1}
            need = {k: v * (cache.captures + cache.warm_forwards) for k, v in per_forward.items()}
            if {k: launched[k] for k in need} != need or cache.captures != 2 * len(rep.server.buckets) \
                    or not cache.graphs:
                raise AssertionError(f"fleet: spawning {rep.name} launched {launched} (want {need}), "
                                     f"{cache.captures} captures, graphs={cache.graphs}")
            for k in total:
                total[k] += launched[k]
            spawns.append(dict(replica=rep.name, capture_s=round(secs, 3), captures=cache.captures,
                               allocated_mib=round((alloc1 - alloc) / 2**20, 2),
                               reserved_mib=round((resv1 - resv) / 2**20, 2)))
            return rep

        fleet._spawn = measured_spawn

        def burst(label):
            c0 = dict(read())
            res, lat, wall = serve_burst(fleet, work)
            launched = {k: read()[k] - c0[k] for k in c0}
            if any(launched.values()):
                raise AssertionError(f"fleet ({label}): the burst launched {launched}")
            return res, serve_latency_fields(lat, wall, [0.0])

        def recorded():
            return {r.name: record_batches(r.server._cache) for r in fleet.replicas()}

        def check_eager(recs, label):
            n = 0
            for r in fleet.replicas():
                if r.name in recs:
                    n += bit_equal_to_eager(recs[r.name], r.server.served.model, dev, f"fleet ({label}) {r.name}")
                    if "run" in vars(r.server._cache):
                        del r.server._cache.run
            return n

        def answers():
            return [fleet.predict(r, timeout=300) for r in requests]

        try:
            reset()
            # (a) N = 1, then N = 2
            fleet.add_model("flagship", served, samples, ServeConfig(), replicas=1)
            recs = recorded()
            _, one = burst("a, N=1")
            n_eq = check_eager(recs, "a, N=1")
            fleet.scale_up()
            recs = recorded()
            _, two = burst("a, N=2")
            n_eq += check_eager(recs, "a, N=2")
            # the device lock's cost on the burst (no capture runs here):
            # N = 2 under it, a plain lock and none, in turns
            turns, medians = device_lock_turns(lambda mode: burst(f"a, {mode}")[1])
            line("fleet", scenario="a", n1=json.dumps(one), n2=json.dumps(two), batches_bit_equal_to_eager=n_eq,
                 n2_device_lock=json.dumps(turns), **{f"n2_{k}": v for k, v in medians.items()}, card=repr(card))
            # (h) the probes
            probe_dir = os.path.join(root, "probes")
            fleet.export_probes(probe_dir)
            probe = subprocess.run([sys.executable, "tools/serve_probe.py", "--fleet", probe_dir],
                                   cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                                   timeout=120)
            if probe.returncode != 0 or not all(n in probe.stdout for n in ("router", "r0", "r1")):
                raise AssertionError(f"fleet (h): serve_probe --fleet exit {probe.returncode}: {probe.stdout}"
                                     f"{probe.stderr}")
            line("fleet", scenario="h", serve_probe_exit=probe.returncode,
                 probed=json.dumps(sorted(os.listdir(probe_dir))), card=repr(card))
            # (d) the same weights, rolled
            before = answers()
            n_ev = len(read_flight_record(flight_path))
            t = time.perf_counter()
            outcomes = fleet.rolling_reload("flagship", variables=served.model.state_dict())
            roll_same_s = time.perf_counter() - t
            evs = [e for e in read_flight_record(flight_path)[n_ev:] if e["kind"] == "fleet_reload"]
            same = all(_answers_equal(a, b) for a, b in zip(before, answers()))
            if [o["ok"] for o in outcomes] != [True, True] or [(e["replica"], e["ok"]) for e in evs] != \
                    [("r0", True), ("r1", True)] or not same:
                raise AssertionError(f"fleet (d): outcomes {outcomes}, events {evs}, bit-identical {same}")
            line("fleet", scenario="d", outcomes=json.dumps([o["replica"] for o in outcomes]),
                 swap_s=json.dumps([o["swap_s"] for o in outcomes]), roll_wall_s=round(roll_same_s, 3),
                 answers_bit_identical=same, card=repr(card))
            # (f) other weights: r1 stays on the old ones until its turn; a
            # spawn asked for after r0's swap waits for the roll and serves
            # its weights
            new_state = {k: (v * 0.9 if v.is_floating_point() else v) for k, v in served.model.state_dict().items()}
            r0, r1 = fleet.get_replica("r0"), fleet.get_replica("r1")
            probe_req = requests[:8]
            old1 = [r1.server.predict(r, timeout=300) for r in probe_req]
            seen = {}
            r0_reload = r0.server.reload

            def reload_then_look(*a, **kw):
                info = r0_reload(*a, **kw)
                seen["r0"] = [r0.server.predict(r, timeout=300) for r in probe_req]
                seen["r1"] = [r1.server.predict(r, timeout=300) for r in probe_req]
                seen["spawner"] = threading.Thread(target=lambda: seen.update(later=fleet._spawn("flagship")))
                seen["spawner"].start()
                seen["spawner"].join(0.2)
                seen["waited"] = seen["spawner"].is_alive()
                return info

            r0.server.reload = reload_then_look
            t = time.perf_counter()
            fleet.rolling_reload("flagship", variables=new_state)
            roll_new_s = time.perf_counter() - t
            del r0.server.reload
            seen["spawner"].join(300)
            later = seen.get("later")
            if later is None or not seen["waited"]:
                raise AssertionError(f"fleet (f): the spawn asked for mid-roll gave {later}, waited {seen['waited']}")
            spawns[-1]["asked_mid_roll"] = True  # its seconds include the wait for r1's turn
            new1 = [r1.server.predict(r, timeout=300) for r in probe_req]
            new2 = [later.server.predict(r, timeout=300) for r in probe_req]
            ok = (all(_answers_equal(a, b) for a, b in zip(seen["r1"], old1))
                  and not all(_answers_equal(a, b) for a, b in zip(seen["r0"], old1))
                  and all(_answers_equal(a, b) for a, b in zip(new1, seen["r0"]))
                  and all(_answers_equal(a, b) for a, b in zip(new2, seen["r0"])))
            if not ok:
                raise AssertionError("fleet (f): a replica answered on weights that were not its own")
            line("fleet", scenario="f", r1_old_until_its_turn=True, spawned_mid_roll=later.name,
                 roll_wall_s=round(roll_new_s, 3), card=repr(card))
            # (g) a quiet scale-down under traffic
            futures = [fleet.submit(r) for r in work]
            ctl = FleetController(fleet, registry=fleet.registry, flight=fleet.flight,
                                  config=ControllerConfig(min_replicas=1, max_replicas=4, quiet_for_s=0.0,
                                                          cooldown_s=0.0, quiet_load=10 ** 6))
            down = ctl.step()
            got = [f.result(timeout=300) for f in futures]
            if [d["action"] for d in down] != ["down"] or len(got) != len(work) or fleet.replica_count() != 2:
                raise AssertionError(f"fleet (g): decisions {down}, {len(got)} of {len(work)} answered")
            line("fleet", scenario="g", retired=down[0]["retired"], answered=len(got), card=repr(card))
            # (b) a replica killed under a burst, then replaced
            victim, survivor = sorted(fleet.replicas(), key=lambda r: r.name)
            surv_captures = survivor.server._cache.captures
            box = {}
            client = threading.Thread(target=lambda: box.update(res=serve_burst(fleet, work * 2)))
            client.start()
            time.sleep(0.01)
            t_kill = time.perf_counter()
            victim.kill()
            client.join(timeout=600)
            if "res" not in box:
                raise AssertionError("fleet (b): the burst did not finish")
            ctl = FleetController(fleet, registry=fleet.registry, flight=fleet.flight,
                                  config=ControllerConfig(min_replicas=1, max_replicas=4))
            dec = ctl.step()
            kill_to_replace = time.perf_counter() - t_kill
            repl = [r for r in fleet.replicas() if r.name != survivor.name]
            retries = fleet.registry.get("fleet.death_retries").value
            if ([d["action"] for d in dec] != ["replace"] or len(repl) != 1
                    or repl[0].server._cache.captures != 2 * len(repl[0].server.buckets)
                    or survivor.server._cache.captures != surv_captures):
                raise AssertionError(f"fleet (b): decisions {dec}, replacement {[r.name for r in repl]}")
            line("fleet", scenario="b", killed=victim.name, replacement=repl[0].name, answered=len(box["res"][0]),
                 death_retries=retries, kill_to_replace_s=round(kill_to_replace, 3),
                 survivor_captures_after_start=0, card=repr(card))
            # (c) a sustained queue-depth breach under a burst: one `up`
            ctl = FleetController(fleet, registry=fleet.registry, flight=fleet.flight,
                                  config=ControllerConfig(min_replicas=1, max_replicas=3, cooldown_s=600.0,
                                                          breach_evals=2, slo_queue_depth=8.0))
            box = {}
            client = threading.Thread(target=lambda: box.update(res=serve_burst(fleet, work * 4)))
            client.start()
            ups = []
            deadline = time.monotonic() + 60
            while not ups and client.is_alive() and time.monotonic() < deadline:
                ups += [d for d in ctl.step() if d["action"] in ("up", "up_failed")]
                time.sleep(0.002)
            client.join(timeout=600)
            if [d["action"] for d in ups] != ["up"] or "res" not in box:
                raise AssertionError(f"fleet (c): decisions {ups}, burst finished {'res' in box}")
            line("fleet", scenario="c", spawned=ups[0]["spawned"], answered=len(box["res"][0]),
                 replicas=fleet.replica_count(), card=repr(card))
            # (e) a replica killed mid-roll
            before = {r.name: [r.server.predict(q, timeout=300) for q in probe_req] for r in fleet.replicas()}
            first = sorted(fleet.replicas(), key=lambda r: r.name)[0]
            first.kill()
            futures = [fleet.submit(r) for r in requests]
            n_ev = len(read_flight_record(flight_path))
            try:
                fleet.rolling_reload("flagship", variables=served.model.state_dict(), drain_timeout_s=10.0)
                raise AssertionError("fleet (e): the roll did not abort")
            except ReloadFailed as exc:
                if "died mid-roll" not in str(exc):
                    raise
            resolved = 0
            for f_ in futures:
                try:
                    f_.result(timeout=300)
                except RequestFailed:
                    pass
                resolved += 1
            evs = [e for e in read_flight_record(flight_path)[n_ev:] if e["kind"] == "fleet_reload"]
            alive = [r for r in fleet.replicas() if r.live]
            same = all(_answers_equal(a, b) for r in alive
                       for a, b in zip(before[r.name], [r.server.predict(q, timeout=300) for q in probe_req]))
            if (resolved != len(futures) or [e["replica"] for e in evs if e.get("aborted_roll")] != [first.name]
                    or any(e.get("ok") for e in evs) or not same or not alive):
                raise AssertionError(f"fleet (e): {resolved} resolved, events {evs}, survivors bit-equal {same}")
            line("fleet", scenario="e", killed=first.name, resolved=resolved, survivors=len(alive),
                 survivors_bit_equal=same, card=repr(card))
        finally:
            fleet.stop()
            fleet.flight.close()
    events = read_flight_record(flight_path)
    errors = [e for e in events if e["kind"] == "error" and e.get("where") != "dispatch_giveup"]
    if validate_flight_record(flight_path) or errors:
        raise AssertionError(f"fleet: flight problems {validate_flight_record(flight_path)}, errors {errors}")
    for s in spawns:
        line("fleet", part="spawn", **s, card=repr(card))
    line("fleet", part="summary", spawns=len(spawns),
         decisions=json.dumps([e["action"] for e in events if e["kind"] == "fleet_scale"]),
         launches=json.dumps(total, separators=(",", ":")), card=repr(card))
    shutil.rmtree(root, ignore_errors=True)
    return total



# ---- [parallel] -----------------------------------------------------------
# The Partitioner over torch.distributed (hydragnn_tpu_torch/parallel/):
# one group of ranks, spawned once, runs every case. On one card two ranks
# share it over gloo (NCCL refuses two ranks on one device); with a card a
# rank, NCCL.
PARALLEL_EPOCHS = 2  # (a)-(c) at [train]'s batch of 1,024 graphs (512 a rank)
PARALLEL_TIMEOUT_S = 900
GIANT_LATTICE, GIANT_HIDDEN, GIANT_STEPS = (50, 50, 48), 32, 8  # the giant driver's defaults
# the PNA hidden-128 giant-graph step (tests/test_edge_sharded.py:320's
# shape) on the driver's lattice, with its SGD step
GIANT_PNA = dict(model_type="PNA", input_dim=4, hidden_dim=128, output_dim=(1,), output_type=("graph",),
                 output_names=("energy",), task_weights=(1.0,), num_conv_layers=2, graph_num_sharedlayers=1,
                 graph_dim_sharedlayers=8, graph_num_headlayers=1, graph_dim_headlayers=(8,), pna_avg_deg_lin=20.0,
                 pna_avg_deg_log=3.0)
# (a) against one process on the same global batches: both epochs' losses
# at the step tier (STEP_LOSS_RTOL; chip runs 1-6 of the port's parallel
# slice measured them equal to the bit), and one step's reduced gradient
# against the mean of the sub-batches' gradients at the same state, rtol
# 1e-5 (two ranks: the sum of two addends, halved, as one process adds
# them). (b) and (c) against (a): rtol 1e-5 (the rule runs on slices of
# the same reduced gradients). (d): the driver and the PNA step against
# one process rtol 1e-4, the planted tie's gradient rtol 1e-6.
PAR_LAYOUT_RTOL, PAR_EDGE_RTOL, PAR_TIE_RTOL = 1e-5, 1e-4, 1e-6
_PARALLEL_CHILD = r'''
import os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {repo!r})
import torch
t_torch = time.perf_counter() - t0
import chip_smoke
chip_smoke.parallel_rank(sys.argv[1], sys.argv[2], t_torch)
'''


def kernel_modules():
    """Every kernel's wrapper module (its ``launches`` count, ``SOURCE``
    and ``REPLACES``), by the kernel's name in the ``kernels`` line."""
    from hydragnn_tpu_torch.ops import fused_conv as b8
    from hydragnn_tpu_torch.ops import gather_rows as b3
    from hydragnn_tpu_torch.ops import gather_stats as b1
    from hydragnn_tpu_torch.ops import pna_aggregate as agg
    from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd
    from hydragnn_tpu_torch.ops import row_pointers as rp
    from hydragnn_tpu_torch.ops import segment_sum as b2
    from hydragnn_tpu_torch.ops import segment_sum_local as b4

    return {"pna_aggregate_fwd": agg, "gather_stats": b1,
            "gather_stats_bwd": types.SimpleNamespace(launches=b1.bwd_launches, SOURCE=b1.SOURCE,
                                                      REPLACES=b1.BWD_REPLACES),
            "segment_sum": b2,
            "gather_rows": b3, "segment_sum_local": b4, "fused_conv": b8,
            "pna_bwd_count": types.SimpleNamespace(launches=bwd.count_launches, SOURCE=bwd.SOURCE,
                                                   REPLACES=bwd.COUNT_REPLACES),
            "pna_bwd_grad": types.SimpleNamespace(launches=bwd.grad_launches, SOURCE=bwd.SOURCE,
                                                  REPLACES=bwd.GRAD_REPLACES),
            "fused_conv_stack": importlib.import_module("hydragnn_tpu_torch.ops.fused_conv_stack"),
            "row_pointers": rp}


def giant_gin_launches(n_layers):
    """One train step of GIN on an edge shard: B8 a layer and the row
    pointers once (forward); a layer whose input takes a gradient gathers
    the cotangent (B3) and scatters grad_x through the permuted pair (B3,
    then B2), the window plan being dropped on a shard."""
    return {"fused_conv": n_layers, "gather_rows": 2 * (n_layers - 1), "segment_sum": n_layers - 1,
            "row_pointers": 1}


def _tie_inputs(dev, h=128):
    """v [E, h] on sorted receivers, one node's run straddling the middle
    of the edge list, with a maximum of v and of -v planted on both sides."""
    counts = np.asarray([5, 7, 6, 4, 8, 6, 4, 8] * 63)  # 3,024 slots: the middle falls inside a run
    recv = torch.from_numpy(np.repeat(np.arange(len(counts)), counts).astype(np.int32))
    e = recv.shape[0]
    v = quarter_grid((e, h), 97)
    mid = e // 2
    if int(recv[mid - 1]) != int(recv[mid]):
        raise AssertionError("the planted tie must straddle the boundary")
    v[[mid - 1, mid], 0] = 9.0
    v[[mid - 1, mid], 1] = -9.0
    return v.to(dev), recv.to(dev), len(counts)


def _profile_step(step, batch):
    """One partitioned train step under torch.profiler: its wall ms, the
    card's kernels' busy ms, and the collectives' ms (the host's gloo or
    c10d spans, NCCL's device kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]
    coll = [(ev.key, ev.cpu_time_total / 1e3) for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CPU
            and any(t in ev.key.lower() for t in ("gloo:", "nccl:", "c10d::all", "c10d::broadcast"))]
    nccl_dev = sum(ms for key, ms, _ in rows if "nccl" in key.lower())
    coll_ms = max(sum(ms for _, ms in coll), nccl_dev)
    return {"wall_ms": round(wall, 3), **busy_fields(wall, rows),
            "collectives_ms": round(coll_ms, 3), "collectives_share": round(coll_ms / wall, 4) if wall else None,
            "collective_ops": sorted({k for k, _ in coll})[:6]}


def _rank_kernel_checks(b1, b2, b3, b4, bd, hidden, seed):
    """B1 (and its backward kernel), B2, B3 and B4 at this rank's
    sub-batch against their plain versions on the host copy."""
    host = bd.to("cpu")
    n, e = host.num_nodes, host.num_edges
    dev = bd.nodes.device
    tab = quarter_grid((n, hidden), seed)
    err = {}
    stats, both = b1.gather_stats(tab.to(dev), bd.senders, bd.edge_mask, K)
    r_stats, r_both = b1.gather_stats_plain(tab, host.senders, host.edge_mask, K)
    err["gather_stats"] = max(compare(stats, r_stats, "parallel gather_stats"),
                              compare(both, r_both, "parallel gather_stats both", exact=True))
    g_stats, g_both = quarter_grid(tuple(r_stats.shape), seed + 1, 1.0), quarter_grid(tuple(r_both.shape), seed + 2, 1.0)
    gv = b1.gather_presum_bwd(tab.to(dev), bd.senders, bd.edge_mask, both, g_stats.to(dev), g_both.to(dev), K)
    err["gather_stats_bwd"] = compare(gv, b1.gather_presum_bwd_plain(tab, host.senders, host.edge_mask, r_both,
                                                                      g_stats, g_both, K), "parallel gather_stats_bwd")
    vals = quarter_grid((e, hidden), seed + 3)
    err["segment_sum"] = compare(b2.segment_sum(vals.to(dev), bd.receivers, n),
                                 b2.segment_sum_plain(vals, host.receivers, n), "parallel segment_sum")
    err["gather_rows"] = compare(b3.gather_rows(tab.to(dev), bd.senders), b3.gather_rows_plain(tab, host.senders),
                                 "parallel gather_rows", exact=True)
    err["segment_sum_local"] = compare(b4.segment_sum_local(vals.to(dev), bd.senders, bd.sender_win, n),
                                       b4.segment_sum_local_plain(vals, host.senders, n), "parallel segment_sum_local")
    return err


def _shard_kernel_checks(agg, bwd, b8, rp, shard, hidden, seed):
    """B5, B6, B7 and B8 (and the row pointers) at this rank's edge shard
    of the giant graph against their plain versions on the host copy."""
    host = shard.to("cpu")
    n, e = host.num_nodes, host.num_edges
    dev = shard.nodes.device
    err = {}
    ptr = rp.row_pointers(shard.receivers, n)
    err["row_pointers"] = compare(ptr, rp.row_pointers_plain(host.receivers, n), "parallel row_pointers", exact=True)
    v = quarter_grid((e, hidden), seed)
    out = agg.pna_aggregate(v.to(dev), shard.receivers, n, shard.edge_mask, ptr)
    ref = agg.pna_aggregate_plain(v, host.receivers, n, host.edge_mask)
    err["pna_aggregate_fwd"] = max(compare(a, r, f"parallel pna_aggregate {i}", exact=True)
                                   for i, (a, r) in enumerate(zip(out, ref)))
    g_sum, g_sq = quarter_grid((n, hidden), seed + 1, 1.0), quarter_grid((n, hidden), seed + 2, 1.0)
    g_both = quarter_grid((n, 2 * hidden), seed + 3, 1.0)
    cnt = bwd.pna_bwd_count(v.to(dev), shard.receivers, shard.edge_mask, out[3], n, ptr)
    cnt_ref = bwd.pna_bwd_count_plain(v, host.receivers, host.edge_mask, ref[3], n)
    err["pna_bwd_count"] = compare(cnt, cnt_ref, "parallel pna_bwd_count", exact=True)
    grad = bwd.pna_bwd_grad(v.to(dev), shard.receivers, shard.edge_mask, out[3], g_sum.to(dev), g_sq.to(dev),
                            g_both.to(dev), cnt)
    err["pna_bwd_grad"] = compare(grad, bwd.pna_bwd_grad_plain(v, host.receivers, host.edge_mask, ref[3], g_sum, g_sq,
                                                                g_both, cnt_ref), "parallel pna_bwd_grad", exact=True)
    x = quarter_grid((n, GIANT_HIDDEN), seed + 4)
    err["fused_conv"] = compare(b8.fused_conv(x.to(dev), shard.senders, shard.receivers, shard.edge_mask, n),
                                b8.fused_conv_plain(x, host.senders, host.receivers, host.edge_mask, n),
                                "parallel fused_conv")
    return err


# the pod planes ride on [parallel]'s layouts: each cuts a pod generation
# an epoch (single files without versions, so (a) keeps one .pt)
POD_RIDER_TRAINING = {"checkpoint_every": 1, "checkpoint_keep_last": 0}
STORE_FETCHES = 16  # graphs each rank fetches from the next rank's shard of the store


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _store_rider(rank, world):
    """The sample store over the group: each rank owns its share of the
    1,280 graphs (``data/diststore.py``) and fetches ``STORE_FETCHES`` of
    the next rank's over TCP; the fetched graphs go back to the parent."""
    import torch.distributed as dist

    from hydragnn_tpu_torch.data.diststore import DistSampleStore

    raw = _parallel_raw()
    per = len(raw) // world
    t0 = time.perf_counter()
    store = DistSampleStore(raw[rank * per:(rank + 1) * per])
    up = time.perf_counter() - t0
    other = (rank + 1) % world
    ids = [other * per + j for j in range(0, per, per // STORE_FETCHES)][:STORE_FETCHES]
    t0 = time.perf_counter()
    fetched = {gi: store.get(gi) for gi in ids}
    fetch_s = time.perf_counter() - t0
    owners = {gi: store.owner_of(gi) for gi in ids}
    counts = [int(c) for c in store.counts]
    dist.barrier()  # every fetch served before a server closes
    store.close()
    return {"counts": counts, "fetched": fetched, "owners": owners, "up_s": round(up, 3),
            "fetch_ms_mean": round(fetch_s / len(ids) * 1e3, 3)}


def parallel_rank(spec_path, out_dir, t_torch):
    """One rank of [parallel] (started by ``parallel_phase``): every case
    in order; its results into ``out_dir``."""
    import pickle
    import traceback

    import torch.distributed as dist

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    from hydragnn_tpu_torch.parallel import setup_distributed

    t0 = time.perf_counter()
    rank = int(os.environ["RANK"])
    try:
        world, rank = setup_distributed("cuda", backend=spec["backend"])
        res = {"torch_import_s": round(t_torch, 2), "group_up_s": round(time.perf_counter() - t0, 2)}
        res.update(_parallel_cases(spec, world, rank))
    except BaseException:
        with open(os.path.join(out_dir, f"error.rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _parallel_cases(spec, world, rank):
    import torch.distributed as dist

    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.api import create_dataloaders, prepare_config_and_samples, train_with_loaders
    from hydragnn_tpu_torch.examples.giant_graph.train_giant import build_giant_batch, train_giant
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.models.base import ModelConfig
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd_mod
    from hydragnn_tpu_torch.parallel import Partitioner, place_giant_batch
    from hydragnn_tpu_torch.parallel.edge_sharded import pna_aggregate_edge_sharded
    from hydragnn_tpu_torch.parallel.sharded import held_bytes
    from hydragnn_tpu_torch.train.optimizer import Optimizer

    dev = hydragnn_tpu_torch.resolve_device("cuda")
    mods = kernel_modules()

    def reset():
        for m in mods.values():
            m.launches.reset()

    def read():
        return {name: m.launches.value for name, m in mods.items()}

    out = {"rank": rank, "world": world, "backend": dist.get_backend(), "cuda_index": dev.index,
           "kind": torch.cuda.get_device_name(dev.index), "cases": {}, "kernel_err": {}}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    # the data prepared once for the layouts after (a), which goes through
    # run_training from raw samples as a user's run does
    prepared = prepare_config_and_samples(flagship_config(batch_size=TRAIN_BATCH, num_epoch=PARALLEL_EPOCHS),
                                          _parallel_raw())
    for name, par, zero1 in spec["layouts"]:
        log_dir = os.path.join(spec["log_dir"], name)
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        t0 = time.perf_counter()
        if name == spec["layouts"][0][0]:
            cfg = flagship_config(batch_size=TRAIN_BATCH, num_epoch=PARALLEL_EPOCHS)
            cfg["NeuralNetwork"]["Parallel"] = dict(par)
            cfg["NeuralNetwork"]["Training"].update(POD_RIDER_TRAINING)
            model, opt, hist, done = hydragnn_tpu_torch.run_training(cfg, _parallel_raw(), log_dir=log_dir,
                                                                     device="cuda", seed=SEED)
        else:
            done = copy.deepcopy(prepared[3])
            done["NeuralNetwork"]["Parallel"] = dict(par)
            done["NeuralNetwork"]["Training"].update(POD_RIDER_TRAINING)
            if zero1:
                done["NeuralNetwork"]["Training"]["Optimizer"]["use_zero_redundancy"] = True
            model, opt, hist = train_with_loaders(done, *create_dataloaders(*prepared[:3], done), log_dir=log_dir,
                                                  device="cuda", seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read()
        final_state = None
        if name == spec["layouts"][1][0]:
            # (b)'s whole final state, gathered on every rank (a collective),
            # for the parent's restore of its last pod generation onto one process
            final_state = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                           "optimizer": _to_cpu(opt.state_dict()), "nn": done["NeuralNetwork"]}
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        part = Partitioner.from_config(done["NeuralNetwork"], device_stack=world // int(par.get("edge", 1)))
        man = part.manifest(model, opt)
        held = held_bytes(model, opt)  # what the rank keeps between steps (none of FSDP's whole parameters)
        # the step alone: this rank's first sub-batch, timed and profiled
        loaders = create_dataloaders(*prepared[:3], done)
        for lo in loaders:
            part.attach_loader(lo)
        bd = next(iter(loaders[0])).to(dev)
        step = part.shard_train_step(model, opt)
        probe = None
        if name == spec["layouts"][0][0]:
            # (a)'s reduced gradient of one step from the run's last state
            # (its checkpoint), held in the parent against one process
            probe = {"state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     "batch": bd.to("cpu"), "config": done["NeuralNetwork"]}
            step(bd)
            probe["grads"] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        step_ms = cuda_ms(lambda: step(bd), 3)
        prof = _profile_step(step, bd)
        out["cases"][name] = {
            "history": {k: hist[k] for k in ("train_loss", "val_loss", "test_loss")},
            "counts": counts, "wall_s": round(wall, 2), "peak_mib": round(peak, 1), "step_ms": round(step_ms, 3),
            "profile": prof, "manifest": {k: man.get(k) for k in ("params", "opt", "replicated_leaves", "mesh")},
            "param_bytes": held[0], "opt_bytes": held[1], "grad_probe": probe,
            "buffers": {k: b.detach().cpu().numpy() for k, b in model.named_buffers()},
            # through state_dict: FSDP gathers the parameters it freed after the step
            "param_sum": float(sum(v.double().sum() for k, v in model.state_dict().items()
                                   if k in dict(model.named_parameters()))),
            "steps": len(loaders[0]) * PARALLEL_EPOCHS,
            "forwards": PARALLEL_EPOCHS * (len(loaders[1]) + len(loaders[2])) + 2 * len(loaders[0]),
            "files": sorted(os.listdir(os.path.join(log_dir, os.listdir(log_dir)[0]))) if rank == 0 else None,
            "sub_batch_graphs": int(bd.graph_mask.sum()),
            "run_dir": os.path.join(log_dir, os.listdir(log_dir)[0]),
            "final_state": final_state if rank == 0 else None,
        }
        if name == spec["layouts"][0][0]:
            hidden = done["NeuralNetwork"]["Architecture"]["hidden_dim"]
            out["kernel_err"].update(_rank_kernel_checks(mods["gather_stats"], mods["segment_sum"],
                                                         mods["gather_rows"], mods["segment_sum_local"], bd, hidden,
                                                         200 + rank))
        del model, opt, step, bd
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    out["store"] = _store_rider(rank, world)
    if not spec["giant"]:
        return out
    # (d) the giant driver at its defaults, then the PNA step and the tie
    reset()
    t0 = time.perf_counter()
    gin = train_giant(*GIANT_LATTICE, hidden=GIANT_HIDDEN, steps=GIANT_STEPS, device="cuda", verbose=False)
    torch.cuda.synchronize()
    gin_counts = read()
    out["cases"]["giant_gin"] = {"losses": gin["losses"], "step_ms": gin["step_ms"], "residency": gin["residency"],
                                 "wall_s": round(time.perf_counter() - t0, 2), "counts": gin_counts,
                                 "peak_mib": round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)}
    del gin
    part = Partitioner(edge=world)
    batch = build_giant_batch(*GIANT_LATTICE, world)
    batch = dataclasses.replace(batch, graph_targets={"energy": torch.tensor([[0.7], [0.0]])}, node_targets={})
    model = create_model(ModelConfig(**GIANT_PNA), seed=SEED, device=dev)
    opt = part.shard_init(model, Optimizer(list(model.parameters()), "SGD", 0.05))
    shard = place_giant_batch(part.edge_group, batch).to(dev)
    step = part.shard_train_step(model, opt)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step(shard)[0])
    pna_ms = (time.perf_counter() - t0) * 1e3
    pna_counts = read()
    out["cases"]["giant_pna"] = {"loss": loss, "step_ms": round(pna_ms, 3), "counts": pna_counts,
                                 "params": {k: p.detach().cpu().numpy() for k, p in model.named_parameters()},
                                 "rows": int(shard.senders.shape[0]), "global_rows": int(batch.senders.shape[0]),
                                 "win_dropped": shard.sender_win is None,
                                 "profile": _profile_step(step, shard)}
    out["kernel_err"].update(_shard_kernel_checks(mods["pna_aggregate_fwd"], bwd_mod, mods["fused_conv"],
                                                  mods["row_pointers"], shard, GIANT_PNA["hidden_dim"], 300 + rank))
    del model, opt, step, shard
    # the planted tie across the boundary: the shard's gradient (over the
    # group's width, the edge axis's convention) against the whole graph's
    v, recv, n = _tie_inputs(dev)
    e = v.shape[0]
    lo, hi = rank * e // world, (rank + 1) * e // world
    weight = torch.linspace(0.5, 1.5, 2 * v.shape[1], device=dev)
    full = v.clone().requires_grad_(True)
    s, _, _, both = mods["pna_aggregate_fwd"].pna_aggregate(full, recv, n)
    ((both * weight).sum() + (s * s).sum()).backward()
    loc = v[lo:hi].clone().requires_grad_(True)
    s2, _, _, both2 = pna_aggregate_edge_sharded(loc, recv[lo:hi].contiguous(), n, part.edge_group)
    ((both2 * weight).sum() + (s2 * s2).sum()).backward()
    tie_err = compare(loc.grad / world, full.grad[lo:hi], "parallel tie", tol=dict(rtol=PAR_TIE_RTOL, atol=1e-6))
    mid = e // 2
    out["cases"]["tie"] = {"max_abs_err": tie_err, "split": float(full.grad[mid, 0]) == float(full.grad[mid - 1, 0])}
    return out


def parallel_phase(dev, card, world=2):
    """[parallel]: one group of ``world`` ranks on the card(s) (two on one
    card over gloo; one a card over NCCL) runs (a) data-parallel training
    through ``run_training`` with ``Parallel`` set, (b) FSDP and (c) ZeRO-1
    (two ranks: fsdp = 2 and data = 2; four: data 2 × fsdp 2 and data 2 ×
    edge 2), and (d) the giant-graph driver at its defaults on the edge
    axis, the PNA hidden-128 giant step and a planted cross-shard tie.
    Each rank checks its kernels against their plain versions at its own
    shapes. Here: (a) against one process on the same global batches, the
    checkpoint and ``serve_model`` from it, (b) and (c) against (a), (d)
    against one process. Returns the path's launches summed over the
    ranks (held to ``launch_plan`` × ranks) and the kernels' errors."""
    import pickle

    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.examples.giant_graph.train_giant import build_giant_batch, train_giant
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.models.base import ModelConfig
    from hydragnn_tpu_torch.models.create import create_model, create_model_config
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.state import _loss, make_train_step

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    # each layout's reference: (a)'s run, or one process accumulating the
    # step's K sub-batches in order (``one:K``)
    if world == 2:
        layouts = [("a_data2", {}, False), ("b_fsdp2", {"fsdp": 2}, False), ("c_zero1", {}, True)]
        refs = {"a_data2": "one:2", "b_fsdp2": "a_data2", "c_zero1": "a_data2"}
    else:
        layouts = [("a_data4", {}, False), ("b_data2_fsdp2", {"fsdp": 2}, False),
                   ("d_data2_edge2", {"edge": 2}, False)]
        refs = {"a_data4": "one:4", "b_data2_fsdp2": "a_data4", "d_data2_edge2": "one:2"}
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    spec = {"backend": backend, "layouts": layouts, "log_dir": os.path.join(work, "logs"), "giant": True}
    spec_path = os.path.join(work, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    code = _PARALLEL_CHILD.format(repo=repo)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), HGTORCH_DIAGNOSTICS="0", CUBLAS_WORKSPACE_CONFIG=":4096:8")
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-c", code, spec_path, work], env=env, cwd=repo,
                                      stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"[parallel]: the group did not finish within {PARALLEL_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    spawn_s = time.perf_counter() - t0
    errors = [open(os.path.join(work, f)).read() for f in sorted(os.listdir(work)) if f.startswith("error.")]
    if errors or any(p.returncode != 0 for p in procs):
        tails = [open(os.path.join(work, f"rank{r}.log")).read()[-3000:] for r in range(world)]
        raise AssertionError(f"[parallel]: ranks exited {[p.returncode for p in procs]}:\n" + "\n".join(errors or tails))
    ranks = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    r0 = ranks[0]
    line("parallel", part="group", world=world, backend=backend, cards=cards, card=repr(card),
         collective_via="gloo_cuda_tensors" if backend == "gloo" else "nccl",
         spawn_s=round(spawn_s, 2), torch_import_s=json.dumps([r["torch_import_s"] for r in ranks]),
         group_up_s=json.dumps([r["group_up_s"] for r in ranks]))
    # (a)-(c): every rank the same history, parameters and statistics
    a_name = layouts[0][0]
    for name, _, _ in layouts:
        for r in ranks[1:]:
            if r["cases"][name]["history"] != r0["cases"][name]["history"]:
                raise AssertionError(f"[parallel] {name}: the ranks' histories differ")
            if r["cases"][name]["param_sum"] != r0["cases"][name]["param_sum"]:
                raise AssertionError(f"[parallel] {name}: the ranks' parameters differ")
            for k, v in r0["cases"][name]["buffers"].items():
                if not np.array_equal(v, r["cases"][name]["buffers"][k]):
                    raise AssertionError(f"[parallel] {name}: BatchNorm statistics {k} differ between the ranks")
        c = r0["cases"][name]
        for rk, r in enumerate(ranks):
            cr = r["cases"][name]
            line("parallel", case=name, rank=rk, backend=backend, world=world, card=repr(card),
                 train_loss=json.dumps(cr["history"]["train_loss"]), step_ms=cr["step_ms"], wall_s=cr["wall_s"],
                 peak_mib=cr["peak_mib"], sub_batch_graphs=cr["sub_batch_graphs"],
                 param_bytes=cr["param_bytes"], opt_bytes=cr["opt_bytes"],
                 **{f"profile_{k}": (json.dumps(v) if isinstance(v, list) else v) for k, v in cr["profile"].items()})
        man = c["manifest"]
        line("parallel", case=name, part="layout", card=repr(card), mesh=json.dumps(man["mesh"]),
             params=json.dumps(man["params"]), opt=json.dumps(man["opt"]),
             replicated_leaves=json.dumps(man["replicated_leaves"][:6]), n_replicated=len(man["replicated_leaves"]))
        if not refs[name].startswith("one:"):
            np.testing.assert_allclose(c["history"]["train_loss"], r0["cases"][refs[name]]["history"]["train_loss"],
                                       rtol=PAR_LAYOUT_RTOL, err_msg=f"[parallel] {name} against {refs[name]}")
    a = r0["cases"][a_name]
    if a["files"].count(a["files"][0]) != 1 or sum(f.endswith(".pt") for f in a["files"]) != 1:
        raise AssertionError(f"[parallel] (a): want exactly one checkpoint, got {a['files']}")
    # (b) fsdp 2 (and (c) ZeRO-1 on two ranks) hold about half of (a)'s
    # optimizer state; fsdp keeps its slices alone between steps, as the
    # manifest says
    for name in [layouts[1][0]] + (["c_zero1"] if world == 2 else []):
        c = r0["cases"][name]
        if not c["opt_bytes"] < 0.6 * a["opt_bytes"]:
            raise AssertionError(f"[parallel] {name}: optimizer state {c['opt_bytes']} B, (a) {a['opt_bytes']} B")
    b = r0["cases"][layouts[1][0]]
    if not (b["param_bytes"] < 0.6 * a["param_bytes"] and b["param_bytes"] == b["manifest"]["params"]["bytes_per_device"]):
        raise AssertionError(f"[parallel] {layouts[1][0]}: holds {b['param_bytes']} B of parameters, (a) "
                             f"{a['param_bytes']} B, manifest {b['manifest']['params']}")
    # against one process on the same global batches: batch 1024 / K with
    # K accumulated micro-batches (the step's K sub-batches, in order),
    # streamed
    for name, ref in refs.items():
        if not ref.startswith("one:"):
            continue
        k = int(ref[4:])
        ref_cfg = flagship_config(batch_size=TRAIN_BATCH // k, num_epoch=PARALLEL_EPOCHS)
        ref_cfg["NeuralNetwork"]["Training"].update(grad_accum_steps=k, scan_epoch=False)
        with deterministic_algorithms("parallel", f"one_process_reference_{name}", card):
            _, _, ref_hist, _ = hydragnn_tpu_torch.run_training(ref_cfg, _parallel_raw(),
                                                                log_dir=os.path.join(work, f"ref_{name}"),
                                                                device="cuda", seed=SEED)
        got = r0["cases"][name]["history"]["train_loss"]
        np.testing.assert_allclose(got, ref_hist["train_loss"], rtol=STEP_LOSS_RTOL,
                                   err_msg=f"[parallel] {name} against one process")
        line("parallel", case=name, part="vs_one_process", micro_batches=k, card=repr(card),
             train_loss=json.dumps(got), one_process=json.dumps(ref_hist["train_loss"]),
             rel_err=json.dumps([abs(x - y) / abs(y) for x, y in zip(got, ref_hist["train_loss"])]))
    # (a)'s reduced gradient against one process: each rank's sub-batch's
    # gradient at the same state, averaged (AdamW's update hides a
    # gradient's scale; this does not)
    probes = [r["cases"][a_name]["grad_probe"] for r in ranks]
    gmodel = create_model_config(probes[0]["config"], seed=SEED, device=dev)
    gmodel.load_state_dict(probes[0]["state"])
    mean = None
    with deterministic_algorithms("parallel", "one_process_gradient", card):
        for pr in probes:
            gmodel.zero_grad(set_to_none=True)
            loss, _ = _loss(gmodel, pr["batch"].to(dev), None)
            loss.backward()
            g = {k: p.grad.detach().clone() for k, p in gmodel.named_parameters()}
            mean = g if mean is None else {k: mean[k] + g[k] for k in g}
    grad_err = 0.0
    for rk, pr in enumerate(probes):
        for k, v in mean.items():
            grad_err = max(grad_err, compare(pr["grads"][k], v / world, f"[parallel] {a_name} rank {rk} gradient {k}",
                                             tol=dict(rtol=PAR_LAYOUT_RTOL, atol=1e-9)))
    line("parallel", case=a_name, part="gradient_vs_one_process", ranks=world, tensors=len(mean),
         max_abs_err=grad_err, tol=json.dumps(dict(rtol=PAR_LAYOUT_RTOL, atol=1e-9)), card=repr(card))
    del gmodel, mean, probes
    # the one checkpoint serves
    serve_dir = os.path.join(spec["log_dir"], a_name)
    scfg = flagship_config(batch_size=TRAIN_BATCH, num_epoch=PARALLEL_EPOCHS)
    server = hydragnn_tpu_torch.serve_model(scfg, _parallel_raw(), log_dir=serve_dir, device="cuda", start=True)
    try:
        answers = server.predict_many(server.reference_samples[:4], timeout=120)
    finally:
        server.stop()
    if len(answers) != 4 or not all(np.isfinite(np.asarray(v)).all() for ans in answers for v in ans.values()):
        raise AssertionError("[parallel] serve_model from (a)'s checkpoint: answers not finite")
    line("parallel", case=a_name, part="serve_from_checkpoint", answers=len(answers), card=repr(card))
    # (d) against one process
    gin = [r["cases"]["giant_gin"] for r in ranks]
    one = train_giant(*GIANT_LATTICE, hidden=GIANT_HIDDEN, steps=GIANT_STEPS, device="cuda", verbose=False)
    for rk, g in enumerate(gin):
        np.testing.assert_allclose(g["losses"], one["losses"], rtol=PAR_EDGE_RTOL,
                                   err_msg="[parallel] giant driver against one process")
        res = g["residency"]["senders"]
        if res["rows_per_device"] * world != res["global_rows"]:
            raise AssertionError(f"[parallel] giant driver: rank {rk} holds {res}")
        line("parallel", case="d_giant_gin", rank=rk, world=world, backend=backend, card=repr(card),
             losses=json.dumps([round(x, 6) for x in g["losses"]]), step_ms_median=round(float(np.median(g["step_ms"])), 3),
             one_process_step_ms_median=round(float(np.median(one["step_ms"])), 3),
             edge_rows=res["rows_per_device"], global_rows=res["global_rows"],
             edge_bytes_per_rank=sum(v["bytes_per_device"] for v in g["residency"].values()), peak_mib=g["peak_mib"])
    if not gin[0]["losses"][-1] < gin[0]["losses"][0]:
        raise AssertionError(f"[parallel] giant driver: the loss did not fall {gin[0]['losses']}")
    del one
    batch = build_giant_batch(*GIANT_LATTICE, 1)
    batch = dataclasses.replace(batch, graph_targets={"energy": torch.tensor([[0.7], [0.0]])}, node_targets={})
    model = create_model(ModelConfig(**GIANT_PNA), seed=SEED, device=dev)
    step = make_train_step(model, Optimizer(list(model.parameters()), "SGD", 0.05))
    loss = float(step(batch.to(dev))[0])
    pna = r0["cases"]["giant_pna"]
    np.testing.assert_allclose(pna["loss"], loss, rtol=PAR_EDGE_RTOL, err_msg="[parallel] PNA giant step loss")
    worst = 0.0
    for k, p in model.named_parameters():
        ref = p.detach().cpu().numpy()
        np.testing.assert_allclose(pna["params"][k], ref, rtol=PAR_EDGE_RTOL, atol=1e-6, err_msg=k)
        worst = max(worst, float(np.abs(pna["params"][k] - ref).max()))
    for rk, r in enumerate(ranks):
        pr = r["cases"]["giant_pna"]
        line("parallel", case="d_giant_pna", rank=rk, card=repr(card), loss=pr["loss"], one_process_loss=loss,
             step_ms=pr["step_ms"], edge_rows=pr["rows"], global_rows=pr["global_rows"],
             window_plans_dropped=pr["win_dropped"], param_max_abs_err=worst,
             **{f"profile_{k}": (json.dumps(v) if isinstance(v, list) else v) for k, v in pr["profile"].items()})
    for rk, r in enumerate(ranks):
        t = r["cases"]["tie"]
        if not t["split"]:
            raise AssertionError("[parallel] the planted tie was not split evenly")
        line("parallel", case="d_cross_shard_tie", rank=rk, max_abs_err=t["max_abs_err"], split_evenly=True)
    _pod_riders(ranks, layouts, world, card, work)
    # the path's launches, summed over the ranks, against the plans
    arch = flagship_config()["NeuralNetwork"]["Architecture"]
    per_step, per_fwd = launch_plan(arch, "run_aligned")
    pna_step, _ = launch_plan(dict(model_type="PNA", num_conv_layers=GIANT_PNA["num_conv_layers"]), "unaligned")
    gin_step = giant_gin_launches(2)
    names = list(ranks[0]["cases"][a_name]["counts"])
    summed = {k: sum(r["cases"][a_name]["counts"][k] + r["cases"]["giant_gin"]["counts"][k]
                     + r["cases"]["giant_pna"]["counts"][k] for r in ranks) for k in names}
    want = {k: world * (a["steps"] * per_step.get(k, 0) + a["forwards"] * per_fwd.get(k, 0)
                        + GIANT_STEPS * gin_step.get(k, 0) + pna_step.get(k, 0)) for k in names}
    if summed != want:
        raise AssertionError(f"[parallel]: launches {summed}, want {want}")
    missing = [k for k in names if k != "fused_conv_stack" and summed[k] == 0]
    if missing:
        raise AssertionError(f"[parallel]: no launch of {missing} on the path")
    kernel_err = {k: max(r["kernel_err"].get(k, 0.0) for r in ranks) for k in names}
    line("parallel", part="launches", world=world, kernel_launches=json.dumps(summed, separators=(",", ":")),
         kernel_max_abs_err=json.dumps(kernel_err, separators=(",", ":")), card=repr(card))
    shutil.rmtree(work, ignore_errors=True)
    return summed, kernel_err


def _pod_riders(ranks, layouts, world, card, work):
    """The pod planes on [parallel]'s group: (a)'s per-host flight shards
    merged (one ``host_epoch`` a host an epoch, host 0's ``podview``
    verdicts, the plane's ``overhead_frac`` under 0.01, a Chrome track a
    host); every layout's committed pod generations (each slice written
    once, by its replica 0; (a)'s leaves whole, FSDP's and ZeRO-1's with
    slices) and (b)'s newest restored onto this one process equal to
    (b)'s gathered final state to the bit; the sample store's fetches
    bit-equal to this process's copy of the graphs."""
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.obs import (
        export_flight_chrome,
        flight_to_chrome,
        host_epoch_table,
        merge_host_flights,
        read_flight_record,
    )
    from hydragnn_tpu_torch.resilience import podckpt
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    r0 = ranks[0]
    a_name, b_name = layouts[0][0], layouts[1][0]
    # (a): the shards of a clean run of `world` hosts
    run_a = r0["cases"][a_name]["run_dir"]
    merged = merge_host_flights(run_a)
    table = host_epoch_table(merged.events)
    if merged.hosts != list(range(world)) or merged.problems:
        raise AssertionError(f"[parallel] podview: hosts {merged.hosts}, problems {merged.problems}")
    if sorted(table) != list(range(PARALLEL_EPOCHS)) or any(sorted(v) != list(range(world)) for v in table.values()):
        raise AssertionError(f"[parallel] podview: host_epoch table {{epoch: hosts}} "
                             f"{ {e: sorted(v) for e, v in table.items()} }")
    verdicts = [e for e in merged.events if e["kind"] == "podview"]
    end = [e for e in read_flight_record(os.path.join(run_a, "flight.jsonl")) if e["kind"] == "run_end"][-1]
    pv = end.get("podview") or {}
    chrome = flight_to_chrome(merged.events)["traceEvents"]
    tracks = {e["tid"] for e in chrome if e.get("ph") == "X" and str(e.get("name", "")).startswith("host")}
    export_flight_chrome(run_a, os.path.join(work, "pod_trace.json"))
    if not verdicts or not pv.get("overhead_frac", 1.0) < 0.01 or tracks != set(range(world)):
        raise AssertionError(f"[parallel] podview: {len(verdicts)} verdicts, run_end {pv}, tracks {tracks}")
    line("parallel", part="podview", case=a_name, hosts=json.dumps(merged.hosts), shards=len(merged.hosts),
         host_epochs=sum(len(v) for v in table.values()), podview_verdicts=len(verdicts),
         skew_frac=json.dumps([v["skew_frac"] for v in verdicts]), overhead_s=pv.get("overhead_s"),
         overhead_frac=pv.get("overhead_frac"), chrome_tracks=len(tracks), card=repr(card))
    # every layout's generations: each slice once, every leaf covered
    for name, _, _ in layouts:
        run_dir = r0["cases"][name]["run_dir"]
        gens = podckpt.list_committed_generations(run_dir)
        if gens != list(range(1, PARALLEL_EPOCHS + 1)):
            raise AssertionError(f"[parallel] {name}: committed generations {gens}")
        entries = []
        for h in range(world):
            with open(os.path.join(run_dir, "podckpt", f"ckpt.gen{gens[-1]}.host{h}.manifest.json")) as f:
                entries += json.load(f)["leaves"]
        keys = [(e["path"], json.dumps(e["slices"])) for e in entries]
        sliced = sorted({e["path"] for e in entries if e["slices"] is not None})
        podckpt.load_generation(run_dir, gens[-1])  # every leaf wholly covered
        if len(keys) != len(set(keys)):
            raise AssertionError(f"[parallel] {name}: a slice written twice in generation {gens[-1]}")
        want_sliced = name != a_name and not name.startswith("d_")
        if bool(sliced) != want_sliced:
            raise AssertionError(f"[parallel] {name}: sliced leaves {sliced[:4]}")
        line("parallel", part="pod_generations", case=name, committed=json.dumps(gens), writers=world,
             entries=len(entries), sliced_leaves=len(sliced),
             sliced_model=sum(p.startswith("model/") for p in sliced),
             sliced_optimizer=sum(p.startswith("optimizer/") for p in sliced), card=repr(card))
    # (b)'s newest generation onto this one process, against (b)'s gathered state
    fin = r0["cases"][b_name]["final_state"]
    model = create_model_config(fin["nn"], seed=SEED + 7, device="cuda")
    opt = select_optimizer(model, fin["nn"]["Training"])
    t0 = time.perf_counter()
    epoch, info = podckpt.restore_pod_checkpoint(model, r0["cases"][b_name]["run_dir"], optimizer=opt)
    restore_s = time.perf_counter() - t0
    got = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
           "optimizer": _to_cpu(opt.state_dict())}
    diffs = []

    def walk(a, b, path):
        if isinstance(b, torch.Tensor):
            if not (isinstance(a, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)):
                diffs.append(path)
        elif isinstance(b, dict):
            if set(a) != set(b):
                diffs.append(path + "{keys}")
            for k in b:
                if k in a:
                    walk(a[k], b[k], f"{path}/{k}")
    walk(got["model"], fin["model"], "model")
    walk(got["optimizer"]["rule"]["state"], fin["optimizer"]["rule"]["state"], "optimizer/state")
    walk(got["optimizer"]["shared"], fin["optimizer"]["shared"], "optimizer/shared")
    walk(got["optimizer"]["steps"], fin["optimizer"]["steps"], "optimizer/steps")
    if info is None or info["hosts"] != world or info["fallbacks"] or diffs:
        raise AssertionError(f"[parallel] {b_name}: restore onto one process {info}, differs at {diffs[:6]}")
    held = r0["cases"][b_name]["param_bytes"]
    line("parallel", part="pod_restore", case=b_name, gen=info["gen"], prior_hosts=info["hosts"], onto_hosts=1,
         loader_epoch=epoch, tensors=len(got["model"]) + sum(len(v) for v in got["optimizer"]["rule"]["state"].values()),
         bit_equal=True, restore_s=round(restore_s, 3), b_param_bytes_held=held, layout=json.dumps(info["layout"]),
         card=repr(card))
    del model, opt
    # the sample store
    raw = _parallel_raw()
    for rk, r in enumerate(ranks):
        st = r["store"]
        for gi, s in st["fetched"].items():
            want = raw[gi]
            for f in ("x", "pos", "edge_index", "edge_attr", "graph_y"):
                a, b = getattr(s, f), getattr(want, f)
                if (a is None) != (b is None) or (b is not None and not (np.asarray(a).dtype == np.asarray(b).dtype
                                                                          and np.array_equal(a, b))):
                    raise AssertionError(f"[parallel] store: rank {rk} graph {gi} field {f} differs")
            if st["owners"][gi] == rk:
                raise AssertionError(f"[parallel] store: rank {rk} fetched its own graph {gi}")
        if len(st["fetched"]) < STORE_FETCHES or sum(st["counts"]) != len(raw):
            raise AssertionError(f"[parallel] store: rank {rk} fetched {len(st['fetched'])}, counts {st['counts']}")
        line("parallel", part="store", rank=rk, owns=st["counts"][rk], fetched=len(st["fetched"]),
             from_rank=(rk + 1) % world, bit_equal=True, up_s=st["up_s"], fetch_ms_mean=st["fetch_ms_mean"],
             card=repr(card))


# [pod]: the flagship at full width on [train-loop]'s data at batch 128, 3
# epochs of 8 steps, a pod generation an epoch, per-step dispatch,
# deterministic algorithms, diagnostics off, through
# ``python -m hydragnn_tpu_torch.tools.supervise --pod 2``. Host 1 dies of
# SIGKILL in its generation-2 save; host 0 waits POD_COMMIT_TIMEOUT_S for
# it at each of its two cuts of generation 2 (the epoch's, then the
# preemption's) before it exits 75. The straggler sleeps POD_STRAGGLE_MS in
# each of host 1's steps (about four of the ~60 ms steps).
POD_EPOCHS, POD_COMMIT_TIMEOUT_S, POD_GRACE_S, POD_STRAGGLE_MS = 3, 5.0, 60.0, 250
POD_TIMEOUT_S = 420
_POD_CHILD = r'''
import sys, time
t0 = time.perf_counter()
sys.path.insert(0, {repo!r})
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
t_torch = time.perf_counter() - t0
import chip_smoke
chip_smoke.pod_host(sys.argv[1:], t0, t_torch)
'''


def pod_host(argv, t0, t_torch):
    """One host of [pod] (``_POD_CHILD``, started by the supervisor or by
    ``pod_phase``): a start barrier with its peers, ``run_training`` under
    ``run_guard``, then (whatever the exit) its launches, start-up seconds
    and status into ``<out>.host<k>.<pid>.json``; a host that completed
    also checks B1-B4 against their plain versions at its first batch."""
    import pickle

    from hydragnn_tpu_torch import resolve_device
    from hydragnn_tpu_torch.api import prepare_loaders_and_config, train_with_loaders
    from hydragnn_tpu_torch.obs.podview import host_flight_path, host_identity
    from hydragnn_tpu_torch.obs.flight import read_flight_record
    from hydragnn_tpu_torch.resilience import run_guard
    from hydragnn_tpu_torch.resilience.podckpt import pod_barrier

    cfg_path, samples_path, log_dir, out, sync = argv
    t_port = time.perf_counter() - t0 - t_torch
    with open(cfg_path) as f:
        cfg = json.load(f)
    with open(samples_path, "rb") as f:
        raw = pickle.load(f)
    # run_training's two halves, the data prepared before the barrier: the
    # hosts enter their loops (and install their SIGTERM handlers) together
    *loaders, done = prepare_loaders_and_config(cfg, raw)
    host, hosts = host_identity()
    attempt = int(os.environ.get("HGTORCH_AUTO_RESUME", "0") == "1")
    mods = kernel_modules()
    for m in mods.values():
        m.launches.reset()
    startup = time.perf_counter() - t0
    barrier_s = 0.0
    if hosts > 1 and sync == "barrier":
        # the hosts start their epochs together, so host 0's bounded commit
        # waits for a live peer take seconds, not a start-up's skew
        tb = time.perf_counter()
        pod_barrier(log_dir, f"start.{attempt}.{hosts}", host, hosts, timeout_s=120)
        barrier_s = time.perf_counter() - tb
    rec = {"host": host, "hosts": hosts, "attempt": attempt, "pid": os.getpid(), "torch_import_s": round(t_torch, 2),
           "port_import_s": round(t_port, 2), "startup_s": round(startup, 2), "barrier_s": round(barrier_s, 2),
           "status": "failed"}
    path = f"{out}.host{host}.{os.getpid()}.json"
    try:
        with run_guard():
            train_with_loaders(done, *loaders, log_dir=log_dir, device="cuda", seed=SEED)
        rec["status"] = "completed"
    finally:
        rec["counts"] = {n: m.launches.value for n, m in mods.items()}
        (shard,) = glob.glob(os.path.join(log_dir, "*", os.path.basename(host_flight_path(".", host))))
        seg = read_flight_record(shard)
        last = max(i for i, e in enumerate(seg) if e["kind"] == "run_start")
        # this attempt's epochs and the steps they ran (a preempted epoch may stop early)
        rec["epochs"] = sum(e["kind"] == "epoch" for e in seg[last:])
        rec["steps"] = sum(e["step_time"]["steps"] for e in seg[last:] if e["kind"] == "epoch")
        rec["wall_s"] = round(time.perf_counter() - t0, 2)
        with open(path, "w") as f:
            json.dump(rec, f)
    bd = next(iter(loaders[0])).to(resolve_device("cuda"))
    rec["kernel_err"] = _rank_kernel_checks(mods["gather_stats"], mods["segment_sum"], mods["gather_rows"],
                                            mods["segment_sum_local"], bd,
                                            done["NeuralNetwork"]["Architecture"]["hidden_dim"], 400 + host)
    with open(path, "w") as f:
        json.dump(rec, f)


def pod_phase(dev, card, counts, samples, per_step, per_fwd):
    """[pod]: two pod legs side by side through ``supervise --pod 2``,
    each with host 1 SIGKILLed mid-save of generation 2 (``fixed``: the
    pod restarts at 2 hosts and cuts generation 3; ``elastic``: host 1
    straggling in the first attempt, the pod restarts at 1 host, the last
    COMMIT staying 1), and a straggler pair run as ``ci.sh`` runs
    it (host 1, then host 0, whose monitor must open one ``step_skew``
    incident naming host 1: in a concurrent pod, host 0 reaches an epoch's
    boundary before the straggler has written that epoch's summary, so it
    never sees the skew). The reference, the same run uninterrupted, runs
    in this process meanwhile; every leg's per-epoch losses equal it to the
    bit. Each host's launches equal ``launch_plan`` × its epochs, and each
    completed host checks B1-B4 at its shapes. Returns the reference's
    launches and the hosts' kernels' worst errors."""
    import pickle

    from hydragnn_tpu_torch.api import create_dataloaders, prepare_config_and_samples, run_training
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.obs import read_flight_record, validate_podview_report
    from hydragnn_tpu_torch.obs.triggers import list_incidents, validate_incident_bundle
    from hydragnn_tpu_torch.resilience.podckpt import latest_commit_info
    from hydragnn_tpu_torch.utils.checkpoint import load_train_meta

    reset, read = counts
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_pod_")
    raw = samples()
    samples_path = os.path.join(root, "samples.pkl")
    with open(samples_path, "wb") as f:
        pickle.dump(raw, f)
    cfg0 = flagship_config(batch_size=LOOP_BATCH, num_epoch=POD_EPOCHS)
    cfg0["NeuralNetwork"]["Training"].update(checkpoint_every=1, scan_epoch=False)
    tr, va, te, done = prepare_config_and_samples(copy.deepcopy(cfg0), copy.deepcopy(raw))
    loaders = create_dataloaders(tr, va, te, done)
    n_train, n_eval = len(loaders[0]), len(loaders[1]) + len(loaders[2])
    paths = {}
    for label, training in (("legs", {}), ("straggler", {"slo_triggers": True})):
        cfg = copy.deepcopy(cfg0)
        cfg["NeuralNetwork"]["Training"].update(training)
        paths[label] = os.path.join(root, f"{label}.json")
        with open(paths[label], "w") as f:
            json.dump(cfg, f)
    child = os.path.join(root, "child.py")
    with open(child, "w") as f:
        f.write(_POD_CHILD.format(repo=os.path.dirname(os.path.abspath(__file__))))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("HGTORCH_INJECT_", "HGTORCH_AUTO_RESUME", "HGTORCH_PODVIEW"))}
    base.update(HGTORCH_DIAGNOSTICS="0", CUBLAS_WORKSPACE_CONFIG=":4096:8",
                HGTORCH_POD_COMMIT_TIMEOUT_S=str(POD_COMMIT_TIMEOUT_S))
    procs, logs = {}, []

    def start(label, argv, **env):
        log = open(os.path.join(root, f"{label}.log"), "w+")
        logs.append(log)
        procs[label] = (subprocess.Popen(argv, env=dict(base, **env), cwd=os.path.dirname(os.path.abspath(__file__)),
                                         stdout=log, stderr=subprocess.STDOUT), log, time.perf_counter())

    def host_argv(label, cfg, sync="barrier"):
        return [sys.executable, child, paths[cfg], samples_path, os.path.join(root, label, "logs"),
                os.path.join(root, "out", label), sync]

    os.makedirs(os.path.join(root, "out"))
    for leg, extra, env in (("fixed", [], {}),
                            ("elastic", ["--pod-elastic"], {"HGTORCH_INJECT_STRAGGLER": f"1:{POD_STRAGGLE_MS}"})):
        start(leg, [sys.executable, "-m", "hydragnn_tpu_torch.tools.supervise", "--pod", "2", *extra,
                    "--pod-grace", str(POD_GRACE_S), "--run-id", f"pod{leg}", "--flight",
                    os.path.join(root, f"sup_{leg}.jsonl"), "--", *host_argv(leg, "legs")],
              HGTORCH_INJECT_POD_KILL_HOST="1:2", **env)
    start("straggler1", host_argv("straggler", "straggler", "none"), HGTORCH_PODVIEW_HOST="1", HGTORCH_PODVIEW_HOSTS="2",
          HGTORCH_PODVIEW_RUN_ID="podstrag", HGTORCH_INJECT_STRAGGLER=f"1:{POD_STRAGGLE_MS}")

    def finish(label):
        proc, log, t0 = procs[label]
        try:
            rc = proc.wait(timeout=max(1.0, POD_TIMEOUT_S - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"[pod] {label} did not finish within {POD_TIMEOUT_S} s")
        log.seek(0)
        out = log.read()
        if rc != 0:
            raise AssertionError(f"[pod] {label}: exit {rc}\n{out[-4000:]}")
        return time.perf_counter() - t0

    saved = os.environ.get("HGTORCH_DIAGNOSTICS")
    os.environ["HGTORCH_DIAGNOSTICS"] = "0"  # as the hosts run
    try:
        # the reference: the same run uninterrupted, in this process
        with deterministic_algorithms("pod", "reference", card):
            reset()
            t0 = time.perf_counter()
            _, _, ref_hist, _ = run_training(copy.deepcopy(cfg0), copy.deepcopy(raw), log_dir=os.path.join(root, "ref"),
                                             device="cuda", seed=SEED)
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            ref_counts = read()
        walls = {"straggler1": finish("straggler1")}
        start("straggler0", host_argv("straggler", "straggler", "none"), HGTORCH_PODVIEW_HOST="0", HGTORCH_PODVIEW_HOSTS="2",
              HGTORCH_PODVIEW_RUN_ID="podstrag", HGTORCH_INCIDENT_PROFILE_STEPS="2")
        for label in ("fixed", "elastic", "straggler0"):
            walls[label] = finish(label)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
        if saved is None:
            os.environ.pop("HGTORCH_DIAGNOSTICS", None)
        else:
            os.environ["HGTORCH_DIAGNOSTICS"] = saved

    def want(steps, epochs, completed):
        fwds = epochs * n_eval + (2 * n_train if completed else 0)
        return {k: steps * per_step.get(k, 0) + fwds * per_fwd.get(k, 0) for k in ref_counts}

    if ref_counts != want(POD_EPOCHS * n_train, POD_EPOCHS, True):
        raise AssertionError(f"[pod] reference launches {ref_counts}, want {want(POD_EPOCHS * n_train, POD_EPOCHS, True)}")
    ref = {k: ref_hist[k] for k in ("train_loss", "val_loss", "test_loss")}

    def bit_equal(events, label):
        got = {e["epoch"]: e for e in events if e["kind"] == "epoch"}  # a re-run epoch's last record wins
        if sorted(got) != list(range(POD_EPOCHS)):
            raise AssertionError(f"[pod] {label}: epochs {sorted(got)}")
        for k, v in ref.items():
            if [got[ep][k] for ep in range(POD_EPOCHS)] != v:
                raise AssertionError(f"[pod] {label}: {k} {[got[ep][k] for ep in range(POD_EPOCHS)]} != reference {v}")

    for leg, width, last_gen in (("fixed", 2, 3), ("elastic", 1, 1)):
        sup = read_flight_record(os.path.join(root, f"sup_{leg}.jsonl"))
        lost = [e for e in sup if e["kind"] == "host_lost"]
        restarts = [e for e in sup if e["kind"] == "restart"]
        if (len(lost) != 1 or lost[0]["host"] != 1 or not lost[0]["exit_code"] < 0 or len(restarts) != 1
                or (restarts[0]["cause"], restarts[0]["delay_s"], restarts[0]["hosts"]) != ("host_lost", 0, width)
                or [e["status"] for e in sup if e["kind"] == "run_end"] != ["completed"]):
            raise AssertionError(f"[pod] {leg}: supervisor record {lost}, {restarts}")
        (flight,) = glob.glob(os.path.join(root, leg, "logs", "*", "flight.jsonl"))
        run_dir = os.path.dirname(flight)
        ev = read_flight_record(flight)
        ends = [e["status"] for e in ev if e["kind"] == "run_end"]
        signals = [e["signal"] for e in ev if e["kind"] == "preempt"]
        fails = [e for e in ev if e["kind"] == "error" and e.get("error_type") == "PodCommitFailed"]
        resumes = [e for e in ev if e["kind"] == "pod_resume"]
        lineage = [e for e in ev if e["kind"] == "run_start"][-1]["manifest"].get("pod_resume") or {}
        commit = latest_commit_info(run_dir) or {}
        meta = load_train_meta(os.path.basename(run_dir), os.path.dirname(run_dir)) or {}
        if (ends != ["preempted", "completed"] or signals != [15] or not fails or len(resumes) != 1
                or (resumes[0]["gen"], resumes[0]["prior_hosts"], resumes[0]["fallbacks"]) != (1, 2, [])
                or lineage.get("resumed_from_gen") != 1 or commit.get("gen") != last_gen or meta.get("epoch") != 3):
            raise AssertionError(f"[pod] {leg}: run_end {ends}, preempt {signals}, {len(fails)} PodCommitFailed, "
                                 f"pod_resume {resumes}, lineage {lineage}, COMMIT {commit}, meta epoch "
                                 f"{meta.get('epoch')}")
        bit_equal(ev, leg)
        line("pod", leg=leg, hosts_after=width, lost_host=1, lost_exit=lost[0]["exit_code"],
             restart_delay_s=restarts[0]["delay_s"], run_end=json.dumps(ends), preempt_signal=15,
             pod_commit_failed=len(fails), resumed_from_gen=1, last_commit_gen=commit["gen"], meta_epoch=meta["epoch"],
             losses_bit_equal_to_reference=True, wall_s=round(walls[leg], 2), card=repr(card))
    # the straggler pair: one step_skew incident naming host 1
    (flight,) = glob.glob(os.path.join(root, "straggler", "logs", "*", "flight.jsonl"))
    bundles = list_incidents(os.path.join(os.path.dirname(flight), "incidents"))
    if len(bundles) != 1 or validate_incident_bundle(bundles[0]):
        raise AssertionError(f"[pod] straggler: incidents {bundles}")
    with open(os.path.join(bundles[0], "incident_manifest.json")) as f:
        man = json.load(f)
    with open(os.path.join(bundles[0], "podview_report.json")) as f:
        report = json.load(f)
    verdicts = [e for e in read_flight_record(flight) if e["kind"] == "podview"]
    if ((man["rule"], man["kind"]) != ("podview_step_skew", "step_skew")
            or man["trigger"]["detail"].get("slowest_host") != 1 or validate_podview_report(report)
            or report["slowest_host"] != 1 or not os.path.exists(os.path.join(bundles[0], "flight_tail.host1.jsonl"))):
        raise AssertionError(f"[pod] straggler: incident {man}, report {report}")
    bit_equal(read_flight_record(flight), "straggler host 0")
    line("pod", leg="straggler", straggle_ms=POD_STRAGGLE_MS, incidents=1, rule=man["rule"], slowest_host=1,
         skew_frac=json.dumps([v["skew_frac"] for v in verdicts]), threshold=report["threshold"],
         cause=report["cause"], losses_bit_equal_to_reference=True, card=repr(card))
    # every host: launch_plan x its epochs; every completed host's kernels
    recs = []
    for p in sorted(glob.glob(os.path.join(root, "out", "*.json"))):
        with open(p) as f:
            recs.append(dict(json.load(f), label=os.path.basename(p).split(".")[0]))
    kernel_err = {}
    for r in recs:
        w = want(r["steps"], r["epochs"], r["status"] == "completed")
        if r["counts"] != {k: w.get(k, 0) for k in r["counts"]}:
            raise AssertionError(f"[pod] {r['label']} host {r['host']} attempt {r['attempt']}: launches {r['counts']}, "
                                 f"want {w} ({r['steps']} steps, {r['epochs']} epochs, {r['status']})")
        for k, v in (r.get("kernel_err") or {}).items():
            kernel_err[k] = max(kernel_err.get(k, 0.0), v)
    done_hosts = [r for r in recs if r["status"] == "completed"]
    if len(done_hosts) != 2 + 1 + 2 or set(kernel_err) != set(PORT_KERNELS):
        raise AssertionError(f"[pod] completed hosts {[(r['label'], r['host']) for r in done_hosts]}, "
                             f"kernels checked {sorted(kernel_err)}")
    seconds = time.perf_counter() - t_phase
    line("pod", part="hosts", records=len(recs), completed=len(done_hosts),
         startup_s=json.dumps(sorted(r["startup_s"] for r in recs)),
         torch_import_s=json.dumps(sorted(r["torch_import_s"] for r in recs)),
         barrier_s=json.dumps(sorted(r["barrier_s"] for r in recs)),
         kernel_launches_by_host=json.dumps({f"{r['label']}{r['host']}.a{r['attempt']}": sum(r["counts"].values())
                                             for r in recs}),
         kernel_max_abs_err=json.dumps(kernel_err, separators=(",", ":")), reference_s=round(ref_s, 2),
         seconds=round(seconds, 1), card=repr(card))
    shutil.rmtree(root, ignore_errors=True)
    return ref_counts, kernel_err


# Bytecode for the children: the card's machine sets PYTHONDONTWRITEBYTECODE
# and its site-packages hold no .pyc, so every child compiled torch's
# sources anew at its import (PERF.md §6). The children write and read
# their bytecode here instead (gitignored, beside ops/build/).
PYCACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hydragnn_tpu_torch", "ops", "build_pycache")


def child_bytecode_cache():
    """Point every child this process starts at ``PYCACHE_DIR`` (writing
    allowed) and warm it: one ``import`` of torch and the port in the
    background, which the caller waits for. Returns the process."""
    os.makedirs(PYCACHE_DIR, exist_ok=True)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE_DIR
    return subprocess.Popen([sys.executable, "-c", "import torch, torch.distributed, numpy, hydragnn_tpu_torch, "
                             "hydragnn_tpu_torch.tools.supervise, hydragnn_tpu_torch.pilot.tune, chip_smoke"],
                            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)


def _parallel_raw():
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    return deterministic_graph_data(number_configurations=TRAIN_SAMPLES, unit_cell_x_range=TRAIN_UNIT_CELLS,
                                    unit_cell_y_range=TRAIN_UNIT_CELLS, unit_cell_z_range=TRAIN_UNIT_CELLS, seed=SEED)



def main():
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card")
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.api import prepare_config_and_samples, prepare_loaders_and_config, train_with_loaders
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.flagship import flagship_config
    from hydragnn_tpu_torch.graph import segment as S
    from hydragnn_tpu_torch.graph.batch import batch_graphs
    from hydragnn_tpu_torch.models.base import model_loss
    from hydragnn_tpu_torch.models.create import create_model, create_model_config
    from hydragnn_tpu_torch.ops import gather_rows as b3
    from hydragnn_tpu_torch.ops import gather_stats as b1
    from hydragnn_tpu_torch.ops import pna_aggregate as agg
    from hydragnn_tpu_torch.ops import pna_aggregate_bwd as bwd
    from hydragnn_tpu_torch.ops import segment_sum as b2
    from hydragnn_tpu_torch.ops import segment_sum_local as b4
    from hydragnn_tpu_torch.ops import fused_conv as b8
    from hydragnn_tpu_torch.ops import row_pointers as rp
    from hydragnn_tpu_torch.ops._build import build_all
    from hydragnn_tpu_torch.serve import ServeConfig, build_bucket_ladder, request_to_dict
    from hydragnn_tpu_torch.train.loop import test_epoch
    from hydragnn_tpu_torch.train.state import train_step
    from hydragnn_tpu_torch.utils.config import max_in_degree, update_config

    def stack_config(model_type, batch_size=TRAIN_BATCH, num_epoch=TRAIN_EPOCHS):
        """The flagship chassis with ``model_type`` swapped, as a user
        would set it in a config file; SchNet at the reference's 126
        filters and 50 Gaussians, CGCNN at the input width."""
        cfg = flagship_config(batch_size=batch_size, num_epoch=num_epoch)
        arch = cfg["NeuralNetwork"]["Architecture"]
        arch["model_type"] = model_type
        if model_type == "SchNet":
            arch["num_filters"], arch["num_gaussians"] = 126, 50
        return cfg

    dev = hydragnn_tpu_torch.resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    line("device", kind=repr(kind), count=count, nvidia_smi=repr(card),
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32=torch.backends.cuda.matmul.allow_tf32)
    mods = kernel_modules()
    sources = {name: os.path.basename(m.SOURCE) for name, m in mods.items()}

    def reset_counts():
        for m in mods.values():
            m.launches.reset()

    def read_counts():
        return {name: m.launches.value for name, m in mods.items()}

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    warm = child_bytecode_cache()
    logs = build_all(list(sources.values()))
    line("build", kernels=len(mods), sources=len(logs), parallel_nvcc=len(logs), seconds=round(time.time() - t0, 2))
    warm.wait()
    line("build", part="child_bytecode", prefix=os.path.relpath(PYCACHE_DIR), warm_rc=warm.returncode,
         seconds_with_build=round(time.time() - t0, 2))
    for src, log in logs.items():
        for ln in log.splitlines():
            if "Used" in ln or "Compiling entry" in ln or "spill" in ln:
                print(f"  ptxas[{src}]:", ln.strip())

    # every section's seconds, the ones that print no phase line of their own too
    t_section = [time.perf_counter()]

    def section_end(name):
        now = time.perf_counter()
        line("section", ended=name, seconds=round(now - t_section[0], 1))
        t_section[0] = now

    # ---- 3. check: pna_aggregate_fwd at serving shapes -------------------
    cfg = flagship_config()
    raw = deterministic_graph_data(
        number_configurations=N_SAMPLES, unit_cell_x_range=UNIT_CELLS,
        unit_cell_y_range=UNIT_CELLS, unit_cell_z_range=UNIT_CELLS, seed=SEED,
    )
    tr, va, te, cfg = prepare_config_and_samples(cfg, raw)
    prepared = list(tr) + list(va) + list(te)
    hidden = cfg["NeuralNetwork"]["Architecture"]["hidden_dim"]
    n_layers = cfg["NeuralNetwork"]["Architecture"]["num_conv_layers"]
    top = build_bucket_ladder(prepared, ServeConfig().max_batch)[-1]
    biggest = sorted(prepared, key=lambda s: -s.num_edges)[: top.max_batch]
    serve_batch = batch_graphs(
        [request_to_dict(s) for s in biggest],
        n_node_pad=top.node_pad, n_edge_pad=top.edge_pad, n_graph_pad=top.graph_pad,
    )
    rng = np.random.default_rng(SEED)
    recv, n_rows = serve_batch.receivers, serve_batch.num_nodes
    recv_dev = recv.to(dev)
    dead = torch.isin(recv, torch.tensor([0, 5, 17], dtype=torch.int32))  # all-masked rows
    max_err = {name: 0.0 for name in mods}
    # the shared row pointers (the chassis builds them once per forward)
    serve_ptr = rp.row_pointers(recv_dev, n_rows)
    compare(serve_ptr, rp.row_pointers_plain(recv, n_rows), "row_pointers serve", exact=True)
    line("check", kernel="row_pointers", case="serve_batch8", E=serve_batch.num_edges, N=n_rows, max_abs_err=0.0)
    b5_cases = [
        ("conv0_f32_h1", 1, torch.float32, serve_batch.edge_mask, False),
        ("conv1-5_f32_h128", hidden, torch.float32, serve_batch.edge_mask, False),
        ("conv1-5_bf16_h128", hidden, torch.bfloat16, serve_batch.edge_mask, False),
        ("adversarial_f32_h128", hidden, torch.float32, serve_batch.edge_mask & ~dead, True),
        ("adversarial_bf16_h1", 1, torch.bfloat16, serve_batch.edge_mask & ~dead, True),
    ] + [(f"width_{str(dt)[6:]}_h{w}", w, dt, serve_batch.edge_mask & ~dead, False)
         for w in (3, 31, 32) for dt in (torch.float32, torch.bfloat16)]
    for label, h, dtype, mask, ties in b5_cases:
        vals = rng.normal(size=(serve_batch.num_edges, h)).astype(np.float32)
        if ties:
            vals = np.round(vals * 2.0) / 2.0 + 0.0
        v = torch.from_numpy(vals).to(dtype)
        ref = agg.pna_aggregate_plain(v, recv, n_rows, mask)  # host copy, sequential f32 order
        args = (v.to(dev), recv_dev, n_rows, mask.to(dev))
        out1, out2 = agg.pna_aggregate(*args, row_ptr=serve_ptr), agg.pna_aggregate(*args, row_ptr=serve_ptr)
        own = agg.pna_aggregate(*args)  # the wrapper's own pass
        torch.cuda.synchronize()
        if not all(torch.equal(bits(a), bits(b)) and torch.equal(bits(a), bits(c)) for a, b, c in zip(out1, out2, own)):
            raise AssertionError(f"{label}: two launches, or the call with its own row pointers, differ")
        # every output bit-equal: both sides sum the same f32 values in edge order
        err = max(compare(a, r, f"{label} {nm}", exact=True)
                  for nm, a, r in zip(("sum", "sumsq", "cnt", "both"), out1, ref))
        max_err["pna_aggregate_fwd"] = max(max_err["pna_aggregate_fwd"], err)
        line("check", kernel="pna_aggregate_fwd", case=label, E=serve_batch.num_edges, N=n_rows, H=h,
             dtype=str(dtype)[6:], max_abs_err=err, bit_equal=True, row_ptr="shared_and_own", deterministic=True)

    section_end("3. check")
    # ---- 4. check-train: B1-B4 at the flagship training shapes ------------
    tcfg = flagship_config(batch_size=TRAIN_BATCH, num_epoch=TRAIN_EPOCHS)

    def train_samples():
        return deterministic_graph_data(
            number_configurations=TRAIN_SAMPLES, unit_cell_x_range=TRAIN_UNIT_CELLS,
            unit_cell_y_range=TRAIN_UNIT_CELLS, unit_cell_z_range=TRAIN_UNIT_CELLS, seed=SEED,
        )

    def records_samples():
        return deterministic_graph_data(
            number_configurations=RECORDS_SAMPLES, unit_cell_x_range=TRAIN_UNIT_CELLS,
            unit_cell_y_range=TRAIN_UNIT_CELLS, unit_cell_z_range=TRAIN_UNIT_CELLS, seed=SEED,
        )

    t0 = time.time()
    train_loader, val_loader, test_loader, _ = prepare_loaders_and_config(tcfg, train_samples())
    host = next(iter(train_loader))
    line("check-train", batch_build_s=round(time.time() - t0, 3), graphs=int(host.graph_mask.sum()),
         node_pad=host.num_nodes, edge_pad=host.num_edges, real_edges=int(host.edge_mask.sum()),
         real_nodes=int(host.n_real_nodes), run_align=host.run_align,
         sender_win=tuple(host.sender_win.shape), win_block_rows=train_loader.win_block_rows)
    bd = host.to(dev)
    n, e = host.num_nodes, host.num_edges
    send, recv8 = bd.senders, bd.receivers[::K].contiguous()
    extra_dead = torch.zeros(e, dtype=torch.bool)
    extra_dead[torch.arange(0, e // K, 97) * K + torch.arange(K)[:, None]] = True  # whole K-groups
    adv_mask = (host.edge_mask & ~extra_dead.reshape(-1)).to(dev)
    # a window plan whose blocks overlap: every window widened by 300
    # positions both ways (strays must be skipped by their id)
    win_wide = torch.stack([torch.clamp(host.sender_win[0] - 300, min=0),
                            torch.clamp(host.sender_win[1] + 300, max=e)]).to(torch.int32)
    win_wide = torch.where(host.sender_win[1] > host.sender_win[0], win_wide, host.sender_win).to(dev)

    def twice(label, fn, *args):
        out1, out2 = fn(*args), fn(*args)
        torch.cuda.synchronize()
        o1 = out1 if isinstance(out1, tuple) else (out1,)
        o2 = out2 if isinstance(out2, tuple) else (out2,)
        if not all(torch.equal(bits(a) if a.is_floating_point() else a, bits(b) if b.is_floating_point() else b)
                   for a, b in zip(o1, o2)):
            raise AssertionError(f"{label}: two launches differ")
        return out1

    cpu_send, cpu_adv = host.senders, adv_mask.cpu()
    for h in (1, hidden):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{'conv0' if h == 1 else 'conv1-5'}_{str(dtype)[6:]}_h{h}"
            # B1 and its backward kernel (adversarial mask), bit-equal to
            # their plain versions on the host: the forward adds each group
            # in slot order, the backward follows the plain chain op for op
            for values in ("grid", "normal"):
                table_h = (quarter_grid((n, h), h) if values == "grid" else normal_values((n, h), h + 50)).to(dtype)
                table = table_h.to(dev)
                stats, both = twice("gather_stats " + tag, b1.gather_stats, table, send, adv_mask, K)
                rs, rb = b1.gather_stats_plain(table_h, cpu_send, cpu_adv, K)
                err = max(compare(stats, rs, f"gather_stats stats {values} {tag}", exact=True),
                          compare(both, rb, f"gather_stats both {values} {tag}", exact=True))
                lowest = torch.finfo(dtype).min
                if not bool((both[extra_dead.reshape(-1, K)[:, 0].to(dev)] == lowest).all()):
                    raise AssertionError("gather_stats: an all-masked group lost its fill value")
                max_err["gather_stats"] = max(max_err["gather_stats"], err)
                line("check-train", kernel="gather_stats", case=f"{values}_{tag}", E=e, N=n, H=h, max_abs_err=err,
                     bit_equal=True, deterministic=True)
                g_st = normal_values((e // K, 2 * h), h + 51)
                g_bo = normal_values((e // K, 2 * h), h + 52).to(dtype)
                grad_v = twice("gather_stats_bwd " + tag, b1.gather_presum_bwd, table, send, adv_mask, both,
                               g_st.to(dev), g_bo.to(dev), K)
                ref_g = b1.gather_presum_bwd_plain(table_h, cpu_send, cpu_adv, rb, g_st, g_bo, K)
                err = compare(grad_v, ref_g, f"gather_stats_bwd {values} {tag}", exact=True)
                if bool((grad_v[~adv_mask] != 0).any()):
                    raise AssertionError("gather_stats_bwd: a masked slot got a gradient")
                max_err["gather_stats_bwd"] = max(max_err["gather_stats_bwd"], err)
                line("check-train", kernel="gather_stats_bwd", case=f"{values}_{tag}", E=e, N=n, H=h,
                     max_abs_err=err, bit_equal=True, deterministic=True)
            table = quarter_grid((n, h), h).to(dtype).to(dev)
            stats, both = b1.gather_stats(table, send, adv_mask, K)
            # B2: the E/K sum of the statistics (and a 0/1 tie mask in the data's dtype)
            for label, data in (("stats", stats), ("ties", (both == both.roll(1, 0)).to(dtype))):
                out = twice("segment_sum " + tag, b2.segment_sum, data, recv8, n)
                err = compare(out, b2.segment_sum_plain(data, recv8, n), f"segment_sum {label} {tag}")
                max_err["segment_sum"] = max(max_err["segment_sum"], err)
                line("check-train", kernel="segment_sum", case=f"{label}_{tag}", E=e // K, N=n, W=data.shape[1],
                     max_abs_err=err, empty_rows=int((out.abs().sum(1) == 0).sum()), deterministic=True)
            # B3: the sorted E/K gather of a node table, and the local
            # E-level regather of v
            node_table = quarter_grid((n, 2 * h), h + 7).to(dtype).to(dev)
            for label, src, ids in (("sorted", node_table, recv8), ("local", table, send)):
                out = twice("gather_rows " + tag, b3.gather_rows, src, ids)
                compare(out, b3.gather_rows_plain(src, ids), f"gather_rows {label} {tag}", exact=True)
                line("check-train", kernel="gather_rows", case=f"{label}_{tag}", rows=ids.shape[0], W=src.shape[1],
                     max_abs_err=0.0, deterministic=True)
            # B4: the windowed scatter into the senders, tight and overlapping
            # windows; bit-equal to the plain version on the host (both sum
            # each element in edge order), on the 1/4 grid and on normal values
            for values in ("grid", "normal"):
                data_h = quarter_grid((e, h), h + 3) if values == "grid" else normal_values((e, h), h + 4)
                data_h = data_h.to(dtype)
                ref = b4.segment_sum_local_plain(data_h, host.senders, n)
                data = data_h.to(dev)
                for label, win in (("tight", bd.sender_win), ("overlapping", win_wide)):
                    out = twice("segment_sum_local " + tag, b4.segment_sum_local, data, send, win, n)
                    err = compare(out, ref, f"segment_sum_local {label} {values} {tag}", exact=True)
                    max_err["segment_sum_local"] = max(max_err["segment_sum_local"], err)
                    line("check-train", kernel="segment_sum_local", case=f"{label}_{values}_{tag}", E=e, N=n, H=h,
                         max_abs_err=err, bit_equal=True, deterministic=True)

    # the backward of every autograd op on the path, card (kernels) against
    # CPU (plain versions), at the training shapes, f32
    for h in (1, hidden):
        tab_h = quarter_grid((n, h), 40 + h)
        g_stats = quarter_grid((e // K, 2 * h), 41 + h, scale=1.0)
        g_both = quarter_grid((e // K, 2 * h), 42 + h, scale=1.0)
        g_node = quarter_grid((n, 2 * h), 43 + h, scale=1.0)
        cpu_mask = adv_mask.cpu()
        grads = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else torch.device("cpu")
            t = tab_h.to(d).requires_grad_(True)
            st, bo = b1.gather_presum_stats(t, send.to(d), cpu_mask.to(d), host.sender_win.to(d), n, K)
            r8 = recv8.to(d)
            pair = S.segment_sum_sorted(st, r8, n, grad_dtype=torch.float32)
            mx = S.segment_max(bo, r8, n, indices_are_sorted=True, empty_value=0.0)
            torch.autograd.backward((st, bo, pair, mx), (g_stats.to(d), g_both.to(d), g_node.to(d), g_node.to(d)))
            grads[where] = (t.grad.cpu(), pair.detach().cpu(), mx.detach().cpu())
        err = max(compare(a, b, f"backward h{h}") for a, b in zip(grads["cuda"], grads["cpu"]))
        for name in ("gather_stats", "gather_stats_bwd", "segment_sum", "gather_rows", "segment_sum_local"):
            max_err[name] = max(max_err[name], err)
        line("check-train", case=f"autograd_backward_f32_h{h}", ops="gather_presum_stats,segment_sum_sorted,segment_max",
             max_abs_err_grad_table=err, grad_norm=float(grads["cuda"][0].norm()))

    section_end("4. check-train")
    # ---- 4b. check-pna-bwd: B6 and B7 at the flagship's unaligned shapes --
    def unaligned_loader(samples, shuffle=False):
        return GraphLoader(samples, TRAIN_BATCH, shuffle=shuffle, dense_slots=False, run_align=False)

    uhost = next(iter(unaligned_loader(train_loader.samples)))
    un, ue = uhost.num_nodes, uhost.num_edges
    urecv = uhost.receivers.to(dev)
    # rows 0, 5 and 17 all masked; the padding node's masked edges carry
    # v = 0, equal to its cleaned max (they must not tie)
    u_dead = torch.isin(uhost.receivers, torch.tensor([0, 5, 17], dtype=torch.int32))
    u_mask = uhost.edge_mask & ~u_dead
    u_pad = ~uhost.edge_mask
    line("check-pna-bwd", batch="flagship_unaligned", node_pad=un, edge_pad=ue,
         real_edges=int(uhost.edge_mask.sum()), padding_node_edges=int(u_pad.sum()),
         max_in_degree=int(torch.bincount(uhost.receivers[uhost.edge_mask].long()).max()))
    max_err["pna_bwd_count"] = max_err["pna_bwd_grad"] = 0.0
    u_mask_d = u_mask.to(dev)
    uptr = rp.row_pointers(urecv, un)
    compare(uptr, rp.row_pointers_plain(uhost.receivers, un), "row_pointers unaligned", exact=True)
    for h in (1, hidden):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{'conv0' if h == 1 else 'conv1-5'}_{str(dtype)[6:]}_h{h}"
            v = quarter_grid((ue, h), 60 + h)
            v[u_pad] = 0.0
            vd = v.to(dtype).to(dev)
            # B5 at the training shapes, bit-equal to its plain version on the host
            b5_out = twice("pna_aggregate " + tag, agg.pna_aggregate, vd, urecv, un, u_mask_d, uptr)
            b5_ref = agg.pna_aggregate_plain(v.to(dtype), uhost.receivers, un, u_mask)
            for nm, a, r in zip(("sum", "sumsq", "cnt", "both"), b5_out, b5_ref):
                compare(a, r, f"pna_aggregate train {nm} {tag}", exact=True)
            line("check-pna-bwd", kernel="pna_aggregate_fwd", case=tag, E=ue, N=un, H=h, max_abs_err=0.0,
                 bit_equal=True, deterministic=True)
            both = b5_out[3]
            g_sum = quarter_grid((un, h), 61 + h, scale=1.0).to(dev)
            g_sumsq = quarter_grid((un, h), 62 + h, scale=1.0).to(dev)
            g_both = quarter_grid((un, 2 * h), 63 + h, scale=1.0).to(dtype).to(dev)
            cnt_ref = bwd.pna_bwd_count_plain(vd, urecv, u_mask_d, both, un)
            cnt = twice("pna_bwd_count " + tag, bwd.pna_bwd_count, vd, urecv, u_mask_d, both, un, uptr)
            compare(cnt, cnt_ref, "pna_bwd_count " + tag, exact=True)
            grad_ref = bwd.pna_bwd_grad_plain(vd, urecv, u_mask_d, both, g_sum, g_sumsq, g_both, cnt_ref)
            grad = twice("pna_bwd_grad " + tag, bwd.pna_bwd_grad, vd, urecv, u_mask_d, both, g_sum, g_sumsq,
                         g_both, cnt)
            f32 = dtype == torch.float32
            err = compare(grad, grad_ref, "pna_bwd_grad " + tag, exact=f32, tol=PNA_BWD_BF16_TOL)
            if bool((grad[~u_mask_d] != 0).any()):
                raise AssertionError(f"pna_bwd_grad {tag}: a masked edge got a gradient")
            max_err["pna_bwd_grad"] = max(max_err["pna_bwd_grad"], err)
            line("check-pna-bwd", kernel="pna_bwd_count", case=tag, E=ue, N=un, H=h, max_abs_err=0.0,
                 max_ties=int(cnt.max()), deterministic=True)
            line("check-pna-bwd", kernel="pna_bwd_grad", case=tag, E=ue, N=un, H=h, max_abs_err=err,
                 bit_equal=f32, tol="exact" if f32 else json.dumps(PNA_BWD_BF16_TOL), deterministic=True)
    # the autograd pna_aggregate (B5, then B6 and B7) on the card against
    # the same op on the CPU (plain versions), f32
    for h in (1, hidden):
        v = quarter_grid((ue, h), 70 + h)
        cots = (quarter_grid((un, h), 71 + h, scale=1.0), quarter_grid((un, h), 72 + h, scale=1.0),
                quarter_grid((un, 2 * h), 73 + h, scale=1.0))
        grads = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else torch.device("cpu")
            vt = v.detach().to(d).requires_grad_(True)
            s_, sq_, _, both_ = agg.pna_aggregate(vt, uhost.receivers.to(d), un, u_mask.to(d))
            torch.autograd.backward((s_, sq_, both_), tuple(c.to(d) for c in cots))
            grads[where] = vt.grad.cpu()
        compare(grads["cuda"], grads["cpu"], f"pna_aggregate backward h{h}", exact=True)
        line("check-pna-bwd", case=f"autograd_backward_f32_h{h}", ops="pna_aggregate", bit_equal=True,
             grad_norm=float(grads["cuda"].norm()))
    # the flagship's unaligned batch of LOOP_BATCH graphs, whose masked
    # tail is one receiver row at the padding node past the edge
    # occupancy (the bound of B5, B6 and B7 on the main path), and a hub
    # of 60,000 slots among 4,096 rows of 24 (B6's long-row kernel): each
    # kernel with the bound and without it, bit-equal to its plain version
    # on the host (B7 in bf16 within PNA_BWD_BF16_TOL), two launches
    # bitwise equal
    u128 = next(iter(GraphLoader(train_loader.samples, LOOP_BATCH, dense_slots=False, run_align=False)))
    hub_recv, hub_mask, hub_n = pna_hub_case()
    pna_cases = {"unaligned_batch128": (u128.receivers, u128.edge_mask, u128.num_nodes, u128.edge_occupancy),
                 "hub_60000": (hub_recv, hub_mask, hub_n, torch.tensor(hub_recv.shape[0], dtype=torch.int32))}
    for case, (rh, mh, nh, occ_h) in pna_cases.items():
        eh = rh.shape[0]
        rd, md, occ_d = rh.to(dev), mh.to(dev), occ_h.to(dev)
        ptr_h = rp.row_pointers(rd, nh)
        for h in (1, hidden):
            for dtype in (torch.float32, torch.bfloat16):
                tag = f"{case}_{str(dtype)[6:]}_h{h}"
                v = quarter_grid((eh, h), 80 + h)
                v[~mh] = 0.0  # as gathered from the padding node's zero row
                vh = v.to(dtype)
                vd = vh.to(dev)
                b5_ref = agg.pna_aggregate_plain(vh, rh, nh, mh)
                for bl, bnd in (("bound", occ_d), ("none", None)):
                    b5_out = twice(f"pna_aggregate {tag} {bl}", agg.pna_aggregate, vd, rd, nh, md, ptr_h, bnd)
                    for nm, a, r in zip(("sum", "sumsq", "cnt", "both"), b5_out, b5_ref):
                        compare(a, r, f"pna_aggregate {nm} {tag} {bl}", exact=True)
                g_sum = quarter_grid((nh, h), 81 + h, scale=1.0)
                g_sumsq = quarter_grid((nh, h), 82 + h, scale=1.0)
                g_both = quarter_grid((nh, 2 * h), 83 + h, scale=1.0).to(dtype)
                cnt_ref = bwd.pna_bwd_count_plain(vh, rh, mh, b5_ref[3], nh)
                grad_ref = bwd.pna_bwd_grad_plain(vh, rh, mh, b5_ref[3], g_sum, g_sumsq, g_both, cnt_ref)
                cots_d = [t.to(dev) for t in (b5_ref[3], g_sum, g_sumsq, g_both)]
                f32 = dtype == torch.float32
                for bl, bnd in (("bound", occ_d), ("none", None)):
                    cnt = twice(f"pna_bwd_count {tag} {bl}", bwd.pna_bwd_count, vd, rd, md, cots_d[0], nh, ptr_h, bnd)
                    compare(cnt, cnt_ref, f"pna_bwd_count {tag} {bl}", exact=True)
                    grad = twice(f"pna_bwd_grad {tag} {bl}", bwd.pna_bwd_grad, vd, rd, md, *cots_d, cnt, bnd)
                    err = compare(grad, grad_ref, f"pna_bwd_grad {tag} {bl}", exact=f32, tol=PNA_BWD_BF16_TOL)
                    if bool(grad[~md].any()):
                        raise AssertionError(f"pna_bwd_grad {tag} {bl}: a masked edge got a gradient")
                    worst = max(worst, err) if bl == "none" else err
                max_err["pna_bwd_grad"] = max(max_err["pna_bwd_grad"], worst)
                line("check-pna-bwd", kernel="pna_aggregate_fwd,pna_bwd_count,pna_bwd_grad", case=tag, E=eh, N=nh, H=h,
                     occupancy=int(occ_h), bound_and_none=True, count_bit_equal=True, grad_bit_equal=f32,
                     max_abs_err_grad=worst, max_ties=int(cnt_ref.max()), deterministic=True)

    section_end("4b. check-pna-bwd")
    # ---- 5. serve-timing, 5a. serve, 5b. serve-resilience ---------------
    def serve_raw():
        return deterministic_graph_data(
            number_configurations=N_SAMPLES, unit_cell_x_range=UNIT_CELLS,
            unit_cell_y_range=UNIT_CELLS, unit_cell_z_range=UNIT_CELLS, seed=SEED,
        )

    per_forward = {name: 0 for name in mods}
    per_forward.update(pna_aggregate_fwd=n_layers, gather_rows=n_layers, row_pointers=1)
    t0 = time.perf_counter()
    # timing first: before the phases below set CUBLAS_WORKSPACE_CONFIG
    # for deterministic algorithms (the eager forward ran 9.6-15.5 ms
    # with it set, 6.5-7.7 without, in one process; PERF.md §6)
    serve_timing_phase(dev, card, serve_raw)
    serve_counts = serve_phase(dev, card, (reset_counts, read_counts), serve_raw(), per_forward)
    serve_resilience_phase(dev, card, (reset_counts, read_counts), serve_raw())
    line("serve", part="phases", seconds=round(time.perf_counter() - t0, 1))

    section_end("5. serve-timing, serve, serve-resilience")
    # ---- 6. train --------------------------------------------------------
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_logs_")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model, optimizer, history, done = hydragnn_tpu_torch.run_training(
        flagship_config(batch_size=TRAIN_BATCH, num_epoch=TRAIN_EPOCHS), train_samples(),
        log_dir=log_dir, device="cuda", seed=SEED,
    )
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = read_counts()
    losses = history["train_loss"]
    if not (np.isfinite(losses).all() and np.isfinite(history["val_loss"]).all()
            and np.isfinite(history["test_loss"]).all()):
        raise AssertionError(f"train: a loss is not finite: {history}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the train loss did not fall: {losses}")
    steps = TRAIN_EPOCHS * len(train_loader)
    forwards = TRAIN_EPOCHS * (len(val_loader) + len(test_loader)) + 2 * len(train_loader)
    per_step, per_fwd = launch_plan(done["NeuralNetwork"]["Architecture"], "run_aligned")
    want = plus({name: steps * per_step.get(name, 0) + forwards * per_fwd.get(name, 0) for name in mods},
                telemetry_launches(per_step, per_fwd, TRAIN_EPOCHS, model.cfg.num_heads))
    if train_counts != want:
        raise AssertionError(f"train: launches {train_counts}, want {want}")
    line("train", epochs=TRAIN_EPOCHS, steps=steps, eval_and_bn_forwards=forwards, batch=TRAIN_BATCH,
         hidden=hidden, conv_layers=n_layers, train_loss=json.dumps(losses),
         val_loss=json.dumps(history["val_loss"]), test_loss=json.dumps(history["test_loss"]),
         kernel_launches=json.dumps(train_counts, separators=(",", ":")),
         per_step=json.dumps(per_step, separators=(",", ":")), wall_s=round(train_wall, 3),
         max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), card=repr(card))

    # one train step at STEP_GRAPHS graphs: card (kernels) against CPU (plain)
    step_loader = GraphLoader(train_loader.samples[:STEP_GRAPHS], STEP_GRAPHS)
    step_batch = next(iter(step_loader))
    nn_cfg = done["NeuralNetwork"]
    pna_step_vs_cpu("train-step-vs-cpu", nn_cfg, step_batch, per_step, (reset_counts, read_counts))

    # ---- 7. predict ------------------------------------------------------
    in_memory = test_epoch(test_loader, model)
    err, tasks, trues, preds = hydragnn_tpu_torch.run_prediction(
        flagship_config(batch_size=TRAIN_BATCH, num_epoch=TRAIN_EPOCHS), train_samples(),
        log_dir=log_dir, device="cuda",
    )
    np.testing.assert_allclose(err, in_memory[0], err_msg="predict loss", **PREDICT_TOL)
    worst = 0.0
    for a, b in zip(preds + trues, in_memory[3] + in_memory[2]):
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError("predict: shape or non-finite")
        np.testing.assert_allclose(a, b, err_msg="predict values", **PREDICT_TOL)
        worst = max(worst, float(np.abs(a - b).max()))
    line("predict", test_loss=err, in_memory_test_loss=in_memory[0], heads=len(preds),
         rows=json.dumps([int(p.shape[0]) for p in preds]), max_abs_err=worst)

    section_end("6. train, 7. predict")
    # ---- 7b. train-loop: the training loop at batch 128 -------------------
    def launches_per(epochs, loaders, bn_recal):
        """A run's launches: per_step a train step, per_fwd an eval or
        BatchNorm-statistics forward, and the telemetry's."""
        tl, vl, tel = loaders
        steps_ = epochs * len(tl)
        fwds = epochs * (len(vl) + len(tel)) + (2 * len(tl) if bn_recal else 0)
        return plus({name: steps_ * per_step.get(name, 0) + fwds * per_fwd.get(name, 0) for name in mods},
                    telemetry_launches(per_step, per_fwd, epochs, model.cfg.num_heads))

    t0 = time.perf_counter()
    loop_counts, loop_batch = train_loop_phase(dev, card, train_samples, (reset_counts, read_counts), launches_per,
                                               step_batch)
    line("train-loop", part="phase", seconds=round(time.perf_counter() - t0, 1))

    section_end("7b. train-loop")
    # ---- 8. check-conv: B8 at the flagship training shapes ----------------
    rng8 = np.random.default_rng(SEED + 8)

    def normal(shape, scale=0.3):
        return torch.from_numpy((rng8.normal(size=shape) * scale).astype(np.float32))

    def b8_case(variant, rows, edges, seed, values="grid"):
        """(x, branches, acts, scale) of one B8 variant on the host, f32;
        identity and scale on the 1/4 grid (every order sums exactly), or
        on normal values (``values="normal"``)."""
        walk = quarter_grid if values == "grid" else (lambda shape, sd, scale=4.0: normal_values(shape, sd))
        if variant.startswith("identity_h"):  # H = 1 (conv_0), 3, 31 (under a warp), 32, 128
            return walk((rows, int(variant[len("identity_h"):])), seed), (), (), None
        if variant == "scale_f126":
            return walk((rows, 126), seed), (), (), walk((edges, 126), seed + 1, scale=2.0)
        if variant == "gate_w1":  # CGCNN at the flagship's input width
            return normal((rows, 1), 1.0), tuple(
                (normal((1, 1)), None, normal((rows, 1)), None) for _ in range(2)
            ), ("sigmoid", "softplus"), None
        w = hidden  # a gate at width 128: the staged product at a real width
        return normal((rows, w), 1.0), (
            (normal((w, w), 0.1), normal((w,)), normal((rows, w)), normal((edges, w))),
            (normal((w, w), 0.1), None, normal((rows, w)), normal((edges, w))),
        ), ("sigmoid", "softplus"), None

    def cast_case(branches, scale, dtype):
        """The streamed operands (rtab, eterm, scale) in ``dtype``; W and b stay f32."""
        br = tuple((w, b, *(None if t is None else t.to(dtype) for t in (r, et))) for w, b, r, et in branches)
        return br, None if scale is None else scale.to(dtype)

    def on_dev(branches, d):
        return tuple(tuple(None if t is None else t.to(d) for t in br) for br in branches)

    def as_f32(branches):
        return tuple(tuple(None if t is None else t.float() for t in br) for br in branches)

    B8_VARIANTS = ("identity_h1", "identity_h128", "scale_f126", "gate_w1", "gate_w128")
    B8_WIDTHS = ("identity_h3", "identity_h31", "identity_h32")  # checked, not timed
    mask_h = adv_mask.cpu()
    occ = bd.edge_occupancy
    e_all = torch.tensor(e, dtype=torch.int32, device=dev)
    max_err["fused_conv"] = 0.0

    def check_b8(tag, variant, hb, mask_host, dtype, reals, seed, values="grid"):
        """B8 on the card against its plain version on the host, on the
        f32 values of the same inputs; two launches bitwise equal; the
        identity and scale walks bit-equal (each element summed in edge
        order, as index_add_ on the host); with the receivers' shared row
        pointers and with the wrapper's own pass alike."""
        rows, edges = hb.num_nodes, hb.num_edges
        x, branches, acts, scale = b8_case(variant, rows, edges, seed, values)
        if variant == "gate_w128":  # +inf edge terms on the masked slots
            for br in branches:
                br[3][~mask_host] = float("inf")
        branches, scale = cast_case(branches, scale, dtype)
        x = x.to(dtype)
        args_h = (hb.senders, hb.receivers, mask_host, rows)
        ref = b8.fused_conv_plain(x.float(), *args_h, as_f32(branches), acts, None if scale is None else scale.float())
        if not bool(torch.isfinite(ref).all()):
            raise AssertionError(f"fused_conv {tag}: the plain version is not finite")
        args_d = (hb.senders.to(dev), hb.receivers.to(dev), mask_host.to(dev), rows)
        xd, bd_, sd_ = x.to(dev), on_dev(branches, dev), None if scale is None else scale.to(dev)
        tol = GATE_TOL if branches else SUM_TOL
        err = 0.0
        ptr = rp.row_pointers(args_d[1], rows)
        for real in reals:
            out = twice(f"fused_conv {tag}", b8.fused_conv, xd, *args_d, bd_, acts, sd_, real, ptr)
            if not torch.equal(bits(out), bits(b8.fused_conv(xd, *args_d, bd_, acts, sd_, real))):
                raise AssertionError(f"fused_conv {tag}: the shared row pointers and the wrapper's own differ")
            err = max(err, compare(out, ref, f"fused_conv {tag} real_edges={int(real)}", exact=not branches,
                                   tol=tol))
        max_err["fused_conv"] = max(max_err["fused_conv"], err)
        empty = int((hb.receivers[mask_host].bincount(minlength=rows) == 0).sum())
        line("check-conv", kernel="fused_conv", case=tag, E=edges, N=rows, H_out=ref.shape[1],
             dtype=str(dtype)[6:], real_edges=json.dumps([int(r) for r in reals]), empty_rows=empty,
             max_abs_err=err, tol="bit-equal" if not branches else json.dumps(tol), row_ptr="shared_and_own",
             deterministic=True)

    for variant in B8_VARIANTS + B8_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            check_b8(f"{variant}_{str(dtype)[6:]}", variant, host, mask_h, dtype, (occ, e_all), 80)
    for variant in ("identity_h1", "identity_h128", "scale_f126") + B8_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            check_b8(f"{variant}_normal_{str(dtype)[6:]}", variant, host, mask_h, dtype, (occ, e_all), 84, "normal")

    # an unaligned batch of the molecular data (tests/test_train_e2e.py):
    # the loader picks the dense slot map, and still emits sender windows
    mcfg = stack_config("GIN", batch_size=MOLECULE_BATCH)
    mcfg["Dataset"]["compositional_stratified_splitting"] = True
    mcfg["NeuralNetwork"]["Training"]["perc_train"] = 0.7
    mol_train, _, _, _ = prepare_loaders_and_config(
        mcfg, deterministic_graph_data(number_configurations=MOLECULE_SAMPLES, seed=SEED)
    )
    mhost = next(iter(mol_train))
    if not (mol_train.dense_slots and mhost.run_align == 0 and mhost.sender_win is not None):
        raise AssertionError("check-conv: the molecular loader did not pick the dense map with sender windows")
    line("check-conv", batch="molecular", dense_slots=mol_train.dense_slots, run_align=mhost.run_align,
         node_pad=mhost.num_nodes, edge_pad=mhost.num_edges, real_edges=int(mhost.edge_mask.sum()),
         edge_occupancy=int(mhost.edge_occupancy))
    mol_reals = (mhost.edge_occupancy.to(dev), torch.tensor(mhost.num_edges, dtype=torch.int32, device=dev))
    for variant, dtype in (("identity_h128", torch.float32), ("identity_h128", torch.bfloat16),
                           ("scale_f126", torch.float32), ("gate_w1", torch.float32)):
        check_b8(f"molecular_{variant}_{str(dtype)[6:]}", variant, mhost, mhost.edge_mask, dtype, mol_reals, 81)

    # the autograd backward on the card (B8, then B3, B2, B4) against the
    # same op on the CPU, f32: every gradient
    def check_b8_backward(tag, variant, hb, mask_host, seed):
        x, branches, acts, scale = b8_case(variant, hb.num_nodes, hb.num_edges, seed)
        hout = branches[0][0].shape[1] if branches else x.shape[1]
        g = normal((hb.num_nodes, hout), 1.0)
        grads = {}
        for where in ("cpu", "cuda"):
            d = torch.device("cpu") if where == "cpu" else dev
            # detach: on the CPU .to() returns the host tensor itself
            xl = x.detach().to(d).requires_grad_(True)
            brl = tuple(tuple(None if t is None else t.detach().to(d).requires_grad_(True) for t in br)
                        for br in branches)
            scl = None if scale is None else scale.detach().to(d).requires_grad_(True)
            out = b8.fused_aggregate(xl, hb.senders.to(d), hb.receivers.to(d), mask_host.to(d), hb.num_nodes,
                                     brl, acts, scl, win=hb.sender_win.to(d), real_edges=hb.edge_occupancy.to(d))
            out.backward(g.to(d))
            named = [("out", out.detach()), ("grad_x", xl.grad)]
            for k, br in enumerate(brl):
                for nm, t in zip(("gW", "gb", "grtab", "geterm"), br):
                    if t is not None:
                        named.append((f"{nm}{k}", t.grad))
            if scl is not None:
                named.append(("g_scale", scl.grad))
            grads[where] = {nm: t.cpu() for nm, t in named}
        rel = {nm: rel_l2(grads["cuda"][nm], grads["cpu"][nm]) for nm in grads["cpu"]}
        line("check-conv", case=f"autograd_backward_{tag}", grads=json.dumps(sorted(rel)),
             worst_rel_l2=max(rel.values()), tol=CONV_BWD_TOL)
        if max(rel.values()) > CONV_BWD_TOL:
            raise AssertionError(f"fused_aggregate backward {tag}: card and CPU differ: {rel}")

    for variant in ("identity_h128", "scale_f126", "gate_w1", "gate_w128"):
        check_b8_backward(f"{variant}_f32", variant, host, mask_h, 82)
    check_b8_backward("molecular_identity_h128_f32", "identity_h128", mhost, mhost.edge_mask, 83)

    section_end("8. check-conv")
    # ---- 8b. stack: fused_conv_stack (B9) at full width ----------------
    stack_counts_by_layout, stack_timing, max_err["fused_conv_stack"] = stack_phase(
        dev, {"unaligned": uhost, "run_aligned": host}, hidden, n_layers, mods, card)
    for label, counts in stack_counts_by_layout.items():
        # per call: the row pointers once, walked by B9 and by the
        # backward, which recomputes each layer through B8 on them and,
        # per layer, gathers
        # the cotangent and the layer's input (B3) and scatters grad_x
        # through the window plan (B4)
        want_ = {name: 0 for name in mods}
        want_.update(fused_conv_stack=1, fused_conv=n_layers, gather_rows=2 * n_layers, segment_sum_local=n_layers,
                     row_pointers=1)
        if counts != want_:
            raise AssertionError(f"stack {label}: launches {counts}, want {want_}")

    section_end("8b. stack")
    # ---- 9. train-stacks: GIN, SAGE, MFC, SchNet, CGCNN -------------------
    gin_log = tempfile.mkdtemp(prefix="chip_smoke_gin_")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    gin_model, gin_opt, gin_hist, gin_done = hydragnn_tpu_torch.run_training(
        stack_config("GIN"), train_samples(), log_dir=gin_log, device="cuda", seed=SEED,
    )
    torch.cuda.synchronize()
    gin_wall = time.perf_counter() - t0
    stack_counts = {"GIN": read_counts()}

    def check_stack_run(mt, history, counts, epochs, wall):
        losses = history["train_loss"]
        if not all(np.isfinite(history[k]).all() for k in ("train_loss", "val_loss", "test_loss")):
            raise AssertionError(f"train-stacks {mt}: a loss is not finite: {history}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train-stacks {mt}: the train loss did not fall: {losses}")
        steps_ = epochs * len(train_loader)
        fwds = epochs * (len(val_loader) + len(test_loader)) + 2 * len(train_loader)
        per, per_fwd = launch_plan({"model_type": mt, "num_conv_layers": n_layers}, None)
        want_ = plus({name: steps_ * per.get(name, 0) + fwds * per_fwd.get(name, 0) for name in mods},
                     telemetry_launches(per, per_fwd, epochs, model.cfg.num_heads))
        if counts != want_:
            raise AssertionError(f"train-stacks {mt}: launches {counts}, want {want_}")
        line("train-stacks", stack=mt, epochs=epochs, steps=steps_, eval_and_bn_forwards=fwds, batch=TRAIN_BATCH,
             hidden=hidden, conv_layers=n_layers, train_loss=json.dumps(losses),
             val_loss=json.dumps(history["val_loss"]), test_loss=json.dumps(history["test_loss"]),
             kernel_launches=json.dumps(counts, separators=(",", ":")),
             row_pointer_passes_per_forward=counts["row_pointers"] / (steps_ + fwds),
             per_step=json.dumps(per, separators=(",", ":")), wall_s=round(wall, 3),
             max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), card=repr(card))

    check_stack_run("GIN", gin_hist, stack_counts["GIN"], TRAIN_EPOCHS, gin_wall)
    gin_mem = test_epoch(test_loader, gin_model)
    err, tasks, trues, preds = hydragnn_tpu_torch.run_prediction(
        stack_config("GIN"), train_samples(), log_dir=gin_log, device="cuda",
    )
    np.testing.assert_allclose(err, gin_mem[0], err_msg="GIN predict loss", **PREDICT_TOL)
    worst = 0.0
    for a, b in zip(preds + trues, gin_mem[3] + gin_mem[2]):
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError("GIN predict: shape or non-finite")
        np.testing.assert_allclose(a, b, err_msg="GIN predict values", **PREDICT_TOL)
        worst = max(worst, float(np.abs(a - b).max()))
    line("train-stacks", stack="GIN", part="predict", test_loss=err, in_memory_test_loss=gin_mem[0],
         heads=len(preds), max_abs_err=worst)

    minmax = {k: gin_done["NeuralNetwork"]["Variables_of_interest"][k]
              for k in ("minmax_graph_feature", "minmax_node_feature")}
    stack_cfgs = {"GIN": gin_done["NeuralNetwork"]}
    stack_models = {"GIN": (gin_model, gin_opt)}
    for mt in STACKS[1:]:
        cfg_mt = stack_config(mt, num_epoch=STACK_EPOCHS)
        cfg_mt["NeuralNetwork"]["Variables_of_interest"].update(minmax)
        cfg_mt = update_config(cfg_mt, train_loader.samples, val_loader.samples, test_loader.samples)
        stack_cfgs[mt] = cfg_mt["NeuralNetwork"]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        m_mt, o_mt, h_mt = train_with_loaders(
            cfg_mt, train_loader, val_loader, test_loader,
            log_dir=tempfile.mkdtemp(prefix=f"chip_smoke_{mt}_"), device="cuda", seed=SEED,
        )
        torch.cuda.synchronize()
        stack_counts[mt] = read_counts()
        check_stack_run(mt, h_mt, stack_counts[mt], STACK_EPOCHS, time.perf_counter() - t0)
        stack_models[mt] = (m_mt, o_mt)

    # each stack's train step at STEP_GRAPHS graphs: card (kernels)
    # against CPU (plain versions)
    # the step's graphs batched in three other orders (the spread)
    step_samples = train_loader.samples[:STEP_GRAPHS]
    shuffles = [np.random.default_rng(SEED + k).permutation(STEP_GRAPHS) for k in (1, 2)]
    reordered = [next(iter(GraphLoader([step_samples[i] for i in order], STEP_GRAPHS)))
                 for order in [np.arange(STEP_GRAPHS)[::-1]] + shuffles]
    def stack_step_vs_cpu(mt, nn_cfg_, per_step_, phase="train-stacks", part="step-vs-cpu"):
        """One train step of ``nn_cfg_`` at STEP_GRAPHS graphs on the card
        (kernels) against the CPU (plain versions), each gradient held to
        max(STACK_GRAD_TOL, STACK_SPREAD_FACTOR x its spread over three
        other batch orders on the CPU); the card's launches must equal
        ``per_step_``. Returns them."""
        res = {}
        for where in ("cpu", "cuda", "order1", "order2", "order3"):
            m = create_model_config(nn_cfg_, seed=SEED + 1, device="cuda" if where == "cuda" else "cpu")
            b = reordered[int(where[-1]) - 1] if where.startswith("order") else step_batch
            b = b.to(next(m.parameters()).device)
            reset_counts()
            m.zero_grad(set_to_none=True)
            loss, _ = model_loss(m.cfg, m(b, train=True), b)
            loss.backward()
            counts = read_counts()
            res[where] = (loss.item(), {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
                          {k: v.detach().cpu() for k, v in m.state_dict().items() if "running" in k}, counts)
        want_ = {name: per_step_.get(name, 0) for name in mods}
        if res["cuda"][3] != want_ or any(res["cpu"][3].values()):
            raise AssertionError(f"{mt} {part} launches card {res['cuda'][3]}, cpu {res['cpu'][3]}; want {want_}")
        gcpu, gcard = res["cpu"][1], res["cuda"][1]
        g_max = max(float(g.abs().max()) for g in gcpu.values())
        worst_rel, worst_zero, worst_share = ("", 0.0, 0.0), ("", 0.0), ("", 0.0)
        spread_above_tol = 0
        bad = {}
        for k, g in gcpu.items():
            if float(g.abs().max()) <= 1e-6 * g_max:
                r = max(float(g.abs().max()), float(gcard[k].abs().max())) / g_max
                if r >= worst_zero[1]:
                    worst_zero = (k, r)
                if r > STACK_ZERO_TOL:
                    bad[k] = r
                continue
            r = rel_l2(gcard[k], g)
            spread = max(rel_l2(res[f"order{j}"][1][k], g) for j in (1, 2, 3))
            tol = max(STACK_GRAD_TOL, STACK_SPREAD_FACTOR * spread)
            spread_above_tol += STACK_SPREAD_FACTOR * spread > STACK_GRAD_TOL
            if r >= worst_rel[1]:
                worst_rel = (k, r, spread)
            if r / tol >= worst_share[1]:
                worst_share = (k, r / tol)
            if r > tol:
                bad[k] = (r, spread)
        bn_ok = all(torch.allclose(res["cuda"][2][k], v, **STEP_BN_TOL) for k, v in res["cpu"][2].items())
        line(phase, stack=mt, part=part, graphs=STEP_GRAPHS, loss_card=res["cuda"][0],
             loss_cpu=res["cpu"][0], worst_grad_rel_l2_and_spread=json.dumps(worst_rel),
             worst_share_of_tol=json.dumps(worst_share), tensors_held_by_spread=spread_above_tol,
             worst_zero_grad=json.dumps(worst_zero), bn_stats_close=bn_ok, params=len(gcpu),
             kernel_launches=json.dumps(res["cuda"][3], separators=(",", ":")))
        np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=STEP_LOSS_RTOL, err_msg=f"{mt} {part} loss")
        if bad or not bn_ok:
            raise AssertionError(f"{mt} {part}: card and CPU differ beyond the tolerance: {bad}, BN close {bn_ok}")
        return res["cuda"][3]

    for mt in STACKS:
        stack_step_vs_cpu(mt, stack_cfgs[mt], stack_launches(mt, n_layers))

    section_end("9. train-stacks")
    # ---- 9b. train-pna-layouts: the flagship on its other layouts -------
    layout_models, layout_counts, layout_batches = {}, {}, {}

    def layout_run(label, cfg_, loaders, per_step_, per_fwd_):
        """train_with_loaders for ``LAYOUT_EPOCHS`` epochs: finite, falling
        losses, and the launches of every kernel equal to the per-step and
        per-forward counts; keeps the model, its optimizer and the counts
        under ``label``."""
        cfg_["NeuralNetwork"]["Training"]["num_epoch"] = LAYOUT_EPOCHS
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        m_, o_, h_ = train_with_loaders(cfg_, *loaders, log_dir=tempfile.mkdtemp(prefix=f"chip_smoke_{label}_"),
                                        device="cuda", seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        losses = h_["train_loss"]
        if not all(np.isfinite(h_[k]).all() for k in ("train_loss", "val_loss", "test_loss")):
            raise AssertionError(f"train-pna-layouts {label}: a loss is not finite: {h_}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train-pna-layouts {label}: the train loss did not fall: {losses}")
        tr_, va_, te_ = loaders
        steps_ = LAYOUT_EPOCHS * len(tr_)
        fwds = LAYOUT_EPOCHS * (len(va_) + len(te_)) + 2 * len(tr_)
        want_ = plus({name: steps_ * per_step_.get(name, 0) + fwds * per_fwd_.get(name, 0) for name in mods},
                     telemetry_launches(per_step_, per_fwd_, LAYOUT_EPOCHS, m_.cfg.num_heads))
        if counts != want_:
            raise AssertionError(f"train-pna-layouts {label}: launches {counts}, want {want_}")
        hb = next(iter(tr_))
        line("train-pna-layouts", layout=label, epochs=LAYOUT_EPOCHS, steps=steps_, eval_and_bn_forwards=fwds,
             batch=TRAIN_BATCH, node_pad=hb.num_nodes, edge_pad=hb.num_edges, run_align=hb.run_align,
             dense_slots=None if hb.dense_senders is None else hb.dense_senders.shape[1],
             edge_features=m_.cfg.use_edge_attr, train_loss=json.dumps(losses),
             val_loss=json.dumps(h_["val_loss"]), test_loss=json.dumps(h_["test_loss"]),
             kernel_launches=json.dumps(counts, separators=(",", ":")),
             per_step=json.dumps(per_step_, separators=(",", ":")),
             per_forward=json.dumps(per_fwd_, separators=(",", ":")),
             row_pointer_passes_per_forward=counts["row_pointers"] / (steps_ + fwds), wall_s=round(wall, 3),
             max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), card=repr(card))
        layout_models[label], layout_counts[label] = (m_, o_), counts

    def completed(edge_lengths=False):
        cfg_ = flagship_config(batch_size=TRAIN_BATCH, num_epoch=LAYOUT_EPOCHS)
        if edge_lengths:
            cfg_["NeuralNetwork"]["Architecture"]["edge_features"] = ["lengths"]
        cfg_["NeuralNetwork"]["Variables_of_interest"].update(minmax)
        return update_config(cfg_, train_loader.samples, val_loader.samples, test_loader.samples)

    u_loaders = (unaligned_loader(train_loader.samples, shuffle=True), unaligned_loader(val_loader.samples),
                 unaligned_loader(test_loader.samples))
    per_u, fwd_u = launch_plan(completed()["NeuralNetwork"]["Architecture"], "unaligned")
    layout_run("unaligned", completed(), u_loaders, per_u, fwd_u)
    layout_batches["unaligned"] = (u_loaders[0], uhost.to(dev))
    # its train step at STEP_GRAPHS graphs against the CPU
    u_step = next(iter(GraphLoader(train_loader.samples[:STEP_GRAPHS], STEP_GRAPHS, dense_slots=False,
                                   run_align=False)))
    u_step_samples = train_loader.samples[:STEP_GRAPHS]
    u_reordered = [next(iter(GraphLoader([u_step_samples[i] for i in order], STEP_GRAPHS, dense_slots=False,
                                         run_align=False)))
                   for order in [np.arange(STEP_GRAPHS)[::-1]]
                   + [np.random.default_rng(SEED + k).permutation(STEP_GRAPHS) for k in (1, 2)]]
    pna_step_vs_cpu("train-pna-layouts-step-vs-cpu", completed()["NeuralNetwork"], u_step, per_u,
                    (reset_counts, read_counts), reordered=u_reordered)
    # edge lengths on the AUTO layout (run-aligned)
    per_e, fwd_e = launch_plan(completed(edge_lengths=True)["NeuralNetwork"]["Architecture"], "run_aligned")
    layout_run("edge_lengths", completed(edge_lengths=True), (train_loader, val_loader, test_loader), per_e, fwd_e)
    layout_batches["edge_lengths"] = (train_loader, bd)
    # the dense slot map: D = the largest in-degree of the data
    d_slots = max(max_in_degree(ld.samples) for ld in (train_loader, val_loader, test_loader))

    def dense_loader(samples, shuffle=False):
        return GraphLoader(samples, TRAIN_BATCH, shuffle=shuffle, dense_slots=d_slots, run_align=False)

    d_loaders = (dense_loader(train_loader.samples, shuffle=True), dense_loader(val_loader.samples),
                 dense_loader(test_loader.samples))
    layout_run("dense", completed(), d_loaders, *launch_plan(completed()["NeuralNetwork"]["Architecture"], "dense"))
    layout_batches["dense"] = (d_loaders[0], next(iter(dense_loader(train_loader.samples))).to(dev))

    section_end("9b. train-pna-layouts")
    # ---- 9c. accuracy: the reference bar on tests/test_train_e2e.py's PNA config
    acc_counts = {}
    for multihead in (False, True):
        label = "multihead" if multihead else "singlehead"
        acc_log = tempfile.mkdtemp(prefix=f"chip_smoke_acc_{label}_")
        reset_counts()
        t0 = time.perf_counter()
        _, _, acc_hist, _ = hydragnn_tpu_torch.run_training(
            e2e_config(multihead), deterministic_graph_data(number_configurations=E2E_SAMPLES, seed=SEED),
            log_dir=acc_log, device="cuda",
        )
        torch.cuda.synchronize()
        acc_wall = time.perf_counter() - t0
        acc_counts[label] = read_counts()
        acc_train, _, _, _ = prepare_loaders_and_config(
            e2e_config(multihead), deterministic_graph_data(number_configurations=E2E_SAMPLES, seed=SEED))
        _, err_h, trues, preds = hydragnn_tpu_torch.run_prediction(
            e2e_config(multihead), deterministic_graph_data(number_configurations=E2E_SAMPLES, seed=SEED),
            log_dir=acc_log, device="cuda",
        )
        # per head: the test error run_prediction returns (what
        # tests/test_train_e2e.py holds to its "RMSE" bar: the per-head test
        # loss, an MSE under this config), the MAE, and sqrt(MSE) beside them
        heads = [(float(err_h[i]), float(np.mean(np.abs(t - p_))), float(np.sqrt(np.mean((t - p_) ** 2))))
                 for i, (t, p_) in enumerate(zip(trues, preds))]
        line("accuracy", case=label, epochs=len(acc_hist["train_loss"]), dense_slots=acc_train.dense_slots,
             run_align=acc_train.run_align, heads=len(heads), error_mae_sqrtmse=json.dumps(heads),
             thresholds=json.dumps(E2E_THRESHOLDS), train_loss_first_last=json.dumps(
                 [acc_hist["train_loss"][0], acc_hist["train_loss"][-1]]), wall_s=round(acc_wall, 3),
             kernel_launches=json.dumps(acc_counts[label], separators=(",", ":")), card=repr(card))
        if acc_train.dense_slots != 7 or acc_train.run_align:
            raise AssertionError(f"accuracy {label}: the loader did not pick the dense map of 7 slots")
        if not (acc_counts[label]["gather_rows"] and acc_counts[label]["segment_sum"]):
            raise AssertionError(f"accuracy {label}: the permuted gather's kernels did not run")
        for i, (r, mae, _) in enumerate(heads):
            if not (np.isfinite(r) and r < E2E_THRESHOLDS[0] and mae < E2E_THRESHOLDS[1]):
                raise AssertionError(f"accuracy {label} head {i}: error {r}, MAE {mae} not below {E2E_THRESHOLDS}")

    # the five other stacks on tests/test_train_e2e.py's config, single-head
    for mt, (bar_err, bar_mae) in STACK_E2E_THRESHOLDS.items():
        acc_log = tempfile.mkdtemp(prefix=f"chip_smoke_acc_{mt}_")
        reset_counts()
        t0 = time.perf_counter()
        hydragnn_tpu_torch.run_training(
            e2e_config(False, mt), deterministic_graph_data(number_configurations=E2E_SAMPLES, seed=SEED),
            log_dir=acc_log, device="cuda",
        )
        torch.cuda.synchronize()
        acc_wall = time.perf_counter() - t0
        acc_counts[f"stack_{mt}"] = read_counts()
        _, err_h, trues, preds = hydragnn_tpu_torch.run_prediction(
            e2e_config(False, mt), deterministic_graph_data(number_configurations=E2E_SAMPLES, seed=SEED),
            log_dir=acc_log, device="cuda",
        )
        r, mae = float(err_h[0]), float(np.mean(np.abs(trues[0] - preds[0])))
        gated = mt != "GIN"
        line("accuracy", case=f"stack_{mt}", error=r, mae=mae, thresholds=json.dumps([bar_err, bar_mae]),
             gated=gated, jax_cpu_same_seed=json.dumps(JAX_GIN_E2E_CPU) if mt == "GIN" else "not run",
             wall_s=round(acc_wall, 3), kernel_launches=json.dumps(acc_counts[f"stack_{mt}"], separators=(",", ":")),
             card=repr(card))
        if not acc_counts[f"stack_{mt}"]["fused_conv"]:
            raise AssertionError(f"accuracy {mt}: fused_conv did not run")
        if gated and not (np.isfinite(r) and r < bar_err and mae < bar_mae):
            raise AssertionError(f"accuracy {mt}: error {r}, MAE {mae} not below {(bar_err, bar_mae)}")

    section_end("9c. accuracy")
    # ---- 9d. train-gat: GAT at full width, and the e2e GAT bar ----------
    gat_log = tempfile.mkdtemp(prefix="chip_smoke_gat_")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    gat_model, gat_opt, gat_hist, _ = hydragnn_tpu_torch.run_training(
        stack_config("GAT"), train_samples(), log_dir=gat_log, device="cuda", seed=SEED,
    )
    torch.cuda.synchronize()
    gat_wall = time.perf_counter() - t0
    gat_counts = read_counts()
    gat_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = gat_hist["train_loss"]
    if not all(np.isfinite(gat_hist[k]).all() for k in ("train_loss", "val_loss", "test_loss")):
        raise AssertionError(f"train-gat: a loss is not finite: {gat_hist}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train-gat: the train loss did not fall: {losses}")
    # GAT's gathers, softmax and sums are plain PyTorch (XLA ops in the JAX
    # package, which has no Pallas kernel for them)
    if any(gat_counts.values()):
        raise AssertionError(f"train-gat: port kernels launched: {gat_counts}")
    gat_mem = test_epoch(test_loader, gat_model)
    err, tasks, trues, preds = hydragnn_tpu_torch.run_prediction(
        stack_config("GAT"), train_samples(), log_dir=gat_log, device="cuda",
    )
    np.testing.assert_allclose(err, gat_mem[0], err_msg="GAT predict loss", **PREDICT_TOL)
    for a, b in zip(preds + trues, gat_mem[3] + gat_mem[2]):
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError("GAT predict: shape or non-finite")
        np.testing.assert_allclose(a, b, err_msg="GAT predict values", **PREDICT_TOL)
    gcfg = gat_model.cfg
    line("train-gat", epochs=TRAIN_EPOCHS, batch=TRAIN_BATCH, hidden=gcfg.hidden_dim, heads=gcfg.gat_heads,
         conv_layers=gcfg.num_conv_layers, dropout=gcfg.dropout, node_pad=host.num_nodes,
         edge_slots_with_self_loops=host.num_edges + host.num_nodes, train_loss=json.dumps(losses),
         val_loss=json.dumps(gat_hist["val_loss"]), test_loss=json.dumps(gat_hist["test_loss"]),
         predict_test_loss=err, kernel_launches=json.dumps(gat_counts, separators=(",", ":")),
         wall_s=round(gat_wall, 3), max_memory_allocated_gib=round(gat_peak_gib, 3), card=repr(card))

    def gat_e2e_config():
        cfg_ = e2e_config(False)
        cfg_["NeuralNetwork"]["Architecture"]["model_type"] = "GAT"
        return cfg_

    gat_e2e_log = tempfile.mkdtemp(prefix="chip_smoke_gat_e2e_")
    t0 = time.perf_counter()
    _, _, gat_e2e_hist, _ = hydragnn_tpu_torch.run_training(
        gat_e2e_config(), deterministic_graph_data(number_configurations=E2E_SAMPLES, seed=SEED),
        log_dir=gat_e2e_log, device="cuda",
    )
    torch.cuda.synchronize()
    gat_e2e_wall = time.perf_counter() - t0
    _, err_h, trues, preds = hydragnn_tpu_torch.run_prediction(
        gat_e2e_config(), deterministic_graph_data(number_configurations=E2E_SAMPLES, seed=SEED),
        log_dir=gat_e2e_log, device="cuda",
    )
    heads = [(float(err_h[i]), float(np.mean(np.abs(t - p_)))) for i, (t, p_) in enumerate(zip(trues, preds))]
    line("train-gat", case="e2e_singlehead", epochs=len(gat_e2e_hist["train_loss"]), error_mae=json.dumps(heads),
         thresholds=json.dumps(GAT_THRESHOLDS), train_loss_first_last=json.dumps(
             [gat_e2e_hist["train_loss"][0], gat_e2e_hist["train_loss"][-1]]), wall_s=round(gat_e2e_wall, 3),
         card=repr(card))
    for i, (r, mae) in enumerate(heads):
        if not (np.isfinite(r) and r < GAT_THRESHOLDS[0] and mae < GAT_THRESHOLDS[1]):
            raise AssertionError(f"train-gat e2e head {i}: error {r}, MAE {mae} not below {GAT_THRESHOLDS}")

    section_end("9d. train-gat")
    # ---- 9e. knobs: fused_conv false, conv_bf16, the in-forward radius graph
    knob_counts = {}

    def with_arch(nn_cfg_, **arch):
        out = copy.deepcopy(nn_cfg_)
        out["Architecture"].update(arch)
        return out

    # the composed path at STEP_GRAPHS graphs, card against CPU
    for mt in ("GIN", "SchNet"):
        knob_counts[f"composed_{mt}"] = stack_step_vs_cpu(
            mt, with_arch(stack_cfgs[mt], fused_conv=False), composed_launches(mt, n_layers),
            phase="knobs", part="fused_conv_false_step_vs_cpu")
    # conv_bf16 against f32 on the card, the same weights, BatchNorm on
    # batch statistics. (The JAX package's test runs its 2-layer model on
    # running statistics; at 6 layers with the initial statistics GIN's
    # eps = 100 grows the activations ~100x a layer, to a loss of 6.6e19
    # on the H100, a regime no trained model is in.)
    b_step = step_batch.to(dev)
    for mt in ("GIN", "CGCNN"):
        res = {}
        for bf16 in (False, True):
            m = create_model_config(with_arch(stack_cfgs[mt], conv_bf16=bf16), seed=SEED + 1, device="cuda")
            reset_counts()
            loss, _ = model_loss(m.cfg, m(b_step, train=True), b_step)
            loss.backward()
            torch.cuda.synchronize()
            res[bf16] = (loss.item(), {k: p.grad.detach().float() for k, p in m.named_parameters()}, read_counts())
        (l0, g0, _), (l1, g1, c1) = res[False], res[True]
        g_max = max(float(g.abs().max()) for g in g0.values())
        g_err = max(float((g1[k] - g0[k]).abs().max()) for k in g0)
        knob_counts[f"bf16_{mt}"] = c1
        line("knobs", stack=mt, part="conv_bf16_vs_f32", graphs=STEP_GRAPHS, loss_f32=l0, loss_bf16=l1,
             loss_rel=abs(l1 - l0) / max(abs(l0), 1.0), loss_tol=BF16_LOSS_TOL, grad_err_over_max=g_err / g_max,
             grad_tol=BF16_GRAD_TOL, kernel_launches=json.dumps(c1, separators=(",", ":")))
        if c1["fused_conv"] != n_layers:
            raise AssertionError(f"knobs bf16 {mt}: B8 launched {c1['fused_conv']} times, want {n_layers}")
        if not (np.isfinite(l1) and abs(l1 - l0) <= BF16_LOSS_TOL * max(abs(l0), 1.0)
                and g_err / g_max < BF16_GRAD_TOL):
            raise AssertionError(f"knobs bf16 {mt}: outside the JAX package's bound")
    # SchNet on the in-forward radius graph against the host-built edges:
    # tests/test_train_e2e.py's molecular config (126 filters, 50
    # Gaussians, radius 2.0), one train-split batch, the same weights
    sch_cfg = e2e_config(False)
    sch_cfg["NeuralNetwork"]["Architecture"].update(model_type="SchNet", num_filters=126, num_gaussians=50)
    sch_tr, _, _, sch_done = prepare_loaders_and_config(
        sch_cfg, deterministic_graph_data(number_configurations=E2E_SAMPLES, seed=SEED))
    sch_b = next(iter(sch_tr)).to(dev)
    res = {}
    for inforward in (False, True):
        m = create_model_config(with_arch(sch_done["NeuralNetwork"], radius_graph_in_forward=inforward),
                                seed=SEED + 1, device="cuda")
        reset_counts()
        outs = m(sch_b, train=True)
        loss, _ = model_loss(m.cfg, outs, sch_b)
        loss.backward()
        torch.cuda.synchronize()
        res[inforward] = ([o.detach() for o in outs], loss.item(),
                          {k: p.grad.detach() for k, p in m.named_parameters()}, read_counts(),
                          m.edge_context(sch_b).edge_mask)
    (o0, l0, g0, _, m0), (o1, l1, g1, c1, m1) = res[False], res[True]
    rels = [rel_l2(a, b) for a, b in zip(o1, o0)] + [abs(l1 - l0) / max(abs(l0), 1e-30)]
    # a conv bias that feeds a BatchNorm (SchNet's dense_3.bias) has a
    # gradient that is 0 up to rounding (about 1e-7 of the largest entry;
    # relative L2 above 1 between the two edge orders on the H100):
    # it, and any gradient at most 1e-6 of the largest entry, is held within
    # STACK_ZERO_TOL of the largest entry on both sides, as the stacks' step
    # holds such gradients; every other gradient by relative L2
    g_max = max(float(g.abs().max()) for g in g0.values())
    zero_worst = 0.0
    for k in g0:
        if k.endswith("dense_3.bias") or float(g0[k].abs().max()) <= 1e-6 * g_max:
            zero_worst = max(zero_worst, max(float(g0[k].abs().max()), float(g1[k].abs().max())) / g_max)
        else:
            rels.append(rel_l2(g1[k], g0[k]))
    knob_counts["inforward_SchNet"] = c1
    line("knobs", stack="SchNet", part="inforward_vs_precomputed", graphs=sch_b.num_graphs - 1,
         node_pad=sch_b.num_nodes, slots_inforward=int(m1.numel()), real_edges_inforward=int(m1.sum()),
         real_edges_host=int(m0.sum()), max_neighbours=sch_done["NeuralNetwork"]["Architecture"]["max_neighbours"],
         loss_inforward=l1, loss_host=l0, worst_rel_l2=max(rels), tol=INFORWARD_TOL, worst_zero_grad=zero_worst,
         zero_tol=STACK_ZERO_TOL, kernel_launches=json.dumps(c1, separators=(",", ":")))
    if (int(m1.sum()) != int(m0.sum()) or max(rels) > INFORWARD_TOL or zero_worst > STACK_ZERO_TOL
            or c1["fused_conv"] == 0):
        raise AssertionError(f"knobs inforward SchNet: {int(m1.sum())} vs {int(m0.sum())} edges, rel {max(rels)}, "
                             f"launches {c1}")

    section_end("9e. knobs")
    # ---- 9f. data-path, 9g. data-eam: training from Dataset.path ---------
    t0 = time.perf_counter()
    data_path_counts = data_path_phase(dev, card, (reset_counts, read_counts))
    line("data-path", part="phase", seconds=round(time.perf_counter() - t0, 1))
    t0 = time.perf_counter()
    eam_counts = data_eam_phase(dev, card, (reset_counts, read_counts))
    line("data-eam", part="phase", seconds=round(time.perf_counter() - t0, 1))

    # ---- 9h. examples, 9i. records, 9j. train-obs --------------------------
    t0 = time.perf_counter()
    example_counts = examples_phase(dev, card, (reset_counts, read_counts))
    line("examples", part="phase", seconds=round(time.perf_counter() - t0, 1))
    t0 = time.perf_counter()
    records_counts = records_phase(dev, card, (reset_counts, read_counts), records_samples)
    line("records", part="phase", seconds=round(time.perf_counter() - t0, 1))
    t0 = time.perf_counter()
    train_obs_flight = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_train_obs_record_"), "flight.jsonl")
    train_obs_counts = train_obs_phase(dev, card, (reset_counts, read_counts), records_samples,
                                       keep_flight=train_obs_flight)
    line("train-obs", part="phase", seconds=round(time.perf_counter() - t0, 1))

    # ---- 9k. serve-drift: the spool, drift and the serving triggers --------
    t0 = time.perf_counter()
    serve_drift_counts = serve_drift_phase(dev, card, (reset_counts, read_counts), serve_raw, per_forward,
                                           train_obs_flight)
    shutil.rmtree(os.path.dirname(train_obs_flight), ignore_errors=True)
    line("serve-drift", part="phase", seconds=round(time.perf_counter() - t0, 1))

    # ---- 9l. train-resilience, 9m. lock-witness -----------------------------
    t0 = time.perf_counter()
    resilience_counts = train_resilience_phase(dev, card, (reset_counts, read_counts), train_samples, per_step,
                                               per_fwd)
    line("train-resilience", part="phase", seconds=round(time.perf_counter() - t0, 1), card=repr(card))
    t0 = time.perf_counter()
    witness_counts = lock_witness_phase(dev, card, (reset_counts, read_counts), serve_raw, per_forward)
    line("lock-witness", part="phase", seconds=round(time.perf_counter() - t0, 1), card=repr(card))

    # ---- 9n. pilot, 9o. fleet: the retrain loop and the serving fleet -------
    t0 = time.perf_counter()
    pilot_counts = pilot_phase(dev, card, (reset_counts, read_counts), serve_raw, per_forward)
    line("pilot", part="phase", seconds=round(time.perf_counter() - t0, 1), card=repr(card))
    t0 = time.perf_counter()
    fleet_counts = fleet_phase(dev, card, (reset_counts, read_counts), serve_raw, per_forward)
    line("fleet", part="phase", seconds=round(time.perf_counter() - t0, 1), card=repr(card))

    section_end("9f-9o. data-path to fleet (their phase lines)")
    # ---- 10. timing ------------------------------------------------------
    h = hidden
    table = torch.randn(n, h, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    stats, both = b1.gather_stats(table, send, bd.edge_mask, K)
    g_stats = torch.randn(e // K, 2 * h, device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    g_both = torch.randn(e // K, 2 * h, device=dev, generator=torch.Generator(device=dev).manual_seed(6))
    bwd_args = (table, send, bd.edge_mask, both, g_stats, g_both, K)
    gsend = torch.randn(e, h, device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    node_w = torch.randn(n, 2 * h, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    lengths = torch.bincount(recv8.long(), minlength=n)
    real = int(host.edge_mask.sum())
    s4 = 4
    nb = int(bd.sender_win.shape[1])
    # B2 and B4 as the main path calls them: bounded by the batch's
    # occupancy (in K-group rows for B2)
    occ = bd.edge_occupancy
    gocc = torch.div(occ + (K - 1), K, rounding_mode="floor")
    rows_b, real_e = int(gocc), int(occ)
    specs = {
        # name: (kernel, plain, library or None, bytes, ops, shape)
        "gather_stats": (
            lambda: b1.gather_stats(table, send, bd.edge_mask, K),
            lambda: b1.gather_stats_plain(table, send, bd.edge_mask, K), None,
            e * 4 + e * 1 + n * h * s4 + (e // K) * 2 * h * s4 * 2, real * h * 5,
            dict(E=e, N=n, H=h, K=K)),
        # reads the table, ids, mask and three [E/K, 2H] rows; writes grad_v
        # [E, H]; per real element 2 compares, 2 count adds, 6 products and sums
        "gather_stats_bwd": (
            lambda: b1.gather_presum_bwd(*bwd_args),
            lambda: b1.gather_presum_bwd_plain(*bwd_args), None,
            n * h * s4 + e * 4 + e * 1 + 3 * (e // K) * 2 * h * s4 + e * h * s4, real * h * 10,
            dict(E=e, N=n, H=h, K=K)),
        "segment_sum": (
            lambda: b2.segment_sum(stats, recv8, n, real_rows=gocc),
            lambda: b2.segment_sum_plain(stats, recv8, n, real_rows=gocc),
            lambda: torch.segment_reduce(stats, "sum", lengths=lengths, axis=0),
            rows_b * 2 * h * s4 + rows_b * 4 + n * 2 * h * s4, rows_b * 2 * h,
            dict(rows=e // K, real_rows=rows_b, N=n, W=2 * h)),
        "gather_rows": (
            lambda: b3.gather_rows(node_w, recv8),
            lambda: b3.gather_rows_plain(node_w, recv8),
            lambda: torch.index_select(node_w, 0, recv8),
            n * 2 * h * s4 + (e // K) * 4 + (e // K) * 2 * h * s4, 0,
            dict(rows=e // K, N=n, W=2 * h)),
        "segment_sum_local": (
            lambda: b4.segment_sum_local(gsend, send, bd.sender_win, n, real_edges=occ),
            lambda: b4.segment_sum_local_plain(gsend, send, n, occ),
            lambda: torch.zeros(n, h, device=dev).index_add_(0, send, gsend),
            real_e * h * s4 + real_e * 4 + 2 * nb * 4 + n * h * s4, real_e * h,
            dict(E=e, real_edges=real_e, N=n, H=h, blocks=nb)),
    }
    timing = {}
    for name, (kern, plain, library, nbytes, ops, shape) in specs.items():
        t = {"kernel": [], "plain": [], "library": []}
        for which in ("kernel", "plain", "library", "kernel"):  # kernel first and last
            fn = {"kernel": kern, "plain": plain, "library": library}[which]
            if fn is not None:
                t[which].append(cuda_ms(fn, 50))
        bms, by = bound(nbytes, ops)
        timing[name] = {
            "ms": float(np.mean(t["kernel"])), "graph_ms": graph_ms(kern, 20),
            "plain_ms": t["plain"][0], "library_ms": t["library"][0] if t["library"] else None,
            # torch.segment_reduce cannot be captured: it invalidates the capture
            "library_graph_ms": graph_ms(library, 20) if library is not None and name != "segment_sum" else None,
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, **shape,
        }
        line("timing", kernel=name, card=repr(card),
             **{k: (round(x, 5) if isinstance(x, float) else x) for k, x in timing[name].items()})
    # B2 and B4 at the training loop's batch-128 shapes, with the bound and
    # without it; B2 at batch 1024 without it and on a 60,000-slot row
    bound_timings = bound_timing(dev, card, loop_batch, bd, hidden, b1, b2, b4)
    # B1's backward: the chain the kernel replaced (B3's E-level regather,
    # then the elementwise block op by op), the regather alone, and the
    # op's whole backward (the kernel, then B4's scatter)
    def replaced_chain():
        return b1.presum_bwd_plain(b3.gather_rows(table, send), bd.edge_mask, both, g_stats, g_both, K)

    def whole_backward():
        return b4.segment_sum_local(b1.gather_presum_bwd(*bwd_args), send, bd.sender_win, n)

    regather_ms = cuda_ms(lambda: b3.gather_rows(table, send), 50)
    regather_bound, _ = bound(n * h * s4 + e * 4 + e * h * s4, 0)
    line("timing", kernel="gather_rows", case="regather_E", rows=e, W=h, ms=round(regather_ms, 5),
         graph_ms=round(graph_ms(lambda: b3.gather_rows(table, send), 20), 5),
         library_ms=round(cuda_ms(lambda: torch.index_select(table, 0, send), 50), 5),
         bound_ms=round(regather_bound, 5))
    line("timing", kernel="gather_stats_bwd", case="replaced_chain", E=e, H=h, card=repr(card),
         ms=round(cuda_ms(replaced_chain, 10), 5), kernel_ms=round(timing["gather_stats_bwd"]["ms"], 5))
    line("timing", kernel="gather_stats_bwd", case="op_backward_with_b4", E=e, H=h, card=repr(card),
         ms=round(cuda_ms(whole_backward, 20), 5), graph_ms=round(graph_ms(whole_backward, 10), 5))
    v = torch.randn(serve_batch.num_edges, hidden, generator=torch.Generator().manual_seed(1)).to(dev)
    recv_d, mask_d, ns = serve_batch.receivers.to(dev), serve_batch.edge_mask.to(dev), serve_batch.num_nodes
    lengths_s = torch.bincount(serve_batch.receivers.long(), minlength=ns).to(dev)
    vm = torch.where(mask_d[:, None], v, 0.0)
    pair_sum = torch.cat([vm, vm * vm], dim=1)
    pair_max = torch.where(mask_d[:, None], torch.cat([v, -v], dim=1), float("-inf"))
    real_s = int(serve_batch.edge_mask.sum())
    es, sv = serve_batch.num_edges, 4
    # v on the real edges, the mask, the row pointers; sum, sumsq, cnt, both written
    pna_bytes = real_s * hidden * sv + es + (ns + 1) * 4 + ns * hidden * 8 + ns * 4 + ns * 2 * hidden * sv
    bms, by = bound(pna_bytes, real_s * hidden * 5)
    ptr_s = rp.row_pointers(recv_d, ns)
    timing["pna_aggregate_fwd"] = {
        "ms": float(np.mean([cuda_ms(lambda: agg.pna_aggregate(v, recv_d, ns, mask_d, ptr_s), 200)
                             for _ in range(2)])),
        "graph_ms": graph_ms(lambda: agg.pna_aggregate(v, recv_d, ns, mask_d, ptr_s), 50),
        "graph_ms_own_row_ptr": graph_ms(lambda: agg.pna_aggregate(v, recv_d, ns, mask_d), 50),
        "plain_ms": cuda_ms(lambda: agg.pna_aggregate_plain(v, recv_d, ns, mask_d), 200),
        "library_ms": cuda_ms(lambda: (torch.segment_reduce(pair_sum, "sum", lengths=lengths_s, axis=0),
                                       torch.segment_reduce(pair_max, "max", lengths=lengths_s, axis=0)), 200),
        "bound_ms": bms, "bound_by": by, "E": es, "N": ns, "H": hidden,
    }
    line("timing", kernel="pna_aggregate_fwd", shape="serve_batch8", card=repr(card),
         **{k: (round(x, 5) if isinstance(x, float) else x) for k, x in timing["pna_aggregate_fwd"].items()})

    # B5, B6 and B7 at the flagship's unaligned batches of LOOP_BATCH and
    # TRAIN_BATCH graphs, with the occupancy bound and without it, and on
    # the hub; the batch-1024 bounded calls are the main path's
    pna_timings = pna_bound_timing(dev, card, {
        "batch128": (u128.receivers, u128.edge_mask, u128.num_nodes, u128.edge_occupancy),
        "batch1024": (uhost.receivers, uhost.edge_mask, un, uhost.edge_occupancy),
        "hub": (hub_recv, hub_mask, hub_n, torch.tensor(hub_recv.shape[0], dtype=torch.int32)),
    }, hidden, agg, bwd, rp)
    for name in ("pna_bwd_count", "pna_bwd_grad"):
        timing[name] = dict(pna_timings[f"{name}_batch1024"])

    # the sender gather's backward pairs at each layout's flagship
    # training shapes, H=128 and H=1, f32: the permuted pair PNAConv
    # takes (B3, then B3 and B2; on the dense map over the real slots
    # only, "permuted_masked") against the JAX package's windowed pair
    # (B3, then B4), which it takes from 200,000 gathered rows on the
    # TPU. The forward B3 is common to all; each backward is timed as the
    # autograd Function runs it, eager and in a CUDA graph, and the
    # autograd gradients of the pairs must agree. The dense map's
    # cotangent is 0 on its empty slots, as in PNAConv.
    dense_dev = layout_batches["dense"][1]
    gather_ids = {
        "unaligned": (uhost.senders.to(dev), uhost.sender_perm.to(dev), uhost.sender_win.to(dev), un, None),
        "run_aligned": (send, bd.sender_perm, bd.sender_win, n, None),
        "dense": (dense_dev.dense_senders.reshape(-1), dense_dev.dense_sender_perm, dense_dev.dense_sender_win,
                  dense_dev.num_nodes, dense_dev.dense_mask.reshape(-1)),
    }
    for lay, (ids, perm, win, n_g, gmask) in gather_ids.items():
        for h_g in (hidden, 1):
            xg = torch.randn(n_g, h_g, device=dev, generator=torch.Generator(device=dev).manual_seed(7),
                             requires_grad=True)
            gg = torch.randn(ids.shape[0], h_g, device=dev, generator=torch.Generator(device=dev).manual_seed(8))
            if gmask is not None:
                gg = torch.where(gmask[:, None], gg, torch.zeros((), device=dev))
            grads = [torch.autograd.grad(S.gather_rows_permuted(xg, ids, perm, n_g), xg, gg)[0],
                     torch.autograd.grad(S.gather_rows_local(xg, ids, win, n_g), xg, gg)[0]]
            bwd_pairs = {
                "permuted": lambda: b2.segment_sum(b3.gather_rows(gg, perm), ids.index_select(0, perm), n_g),
                "local": lambda: b4.segment_sum_local(gg, ids, win, n_g),
            }
            if gmask is not None:
                grads.append(torch.autograd.grad(S.gather_rows_permuted(xg, ids, perm, n_g, mask=gmask), xg, gg)[0])
                bwd_pairs["permuted_masked"] = lambda: b2.segment_sum(
                    b3.gather_rows(gg, perm),
                    torch.where(gmask.index_select(0, perm), ids.index_select(0, perm), n_g), n_g)
            agree = max(rel_l2(gr, grads[0]) for gr in grads)
            slow = lay == "dense"  # the unmasked pairs take 20-180 ms there
            t = {k: [] for k in bwd_pairs}
            for which in list(bwd_pairs) + list(bwd_pairs)[::-1]:
                t[which].append(cuda_ms(bwd_pairs[which], 3 if slow and which != "permuted_masked" else 20))
            g_ms = {k: graph_ms(fn, 2 if slow and k != "permuted_masked" else 10) for k, fn in bwd_pairs.items()}
            line("timing-gather-pairs", layout=lay, rows=ids.shape[0], N=n_g, H=h_g, card=repr(card),
                 **{f"{k}_bwd_ms": round(float(np.mean(v)), 5) for k, v in t.items()},
                 **{f"{k}_bwd_graph_ms": round(v, 5) for k, v in g_ms.items()},
                 grad_rel_l2_between_pairs=agree)
            if agree > 1e-5:
                raise AssertionError(f"gather pairs {lay} H={h_g}: the backwards differ ({agree})")

    # B8 per variant at the flagship training shapes, f32, with the
    # batch's own mask and occupancy bound (as the conv stacks call it)
    real_t = int(bd.edge_mask.sum())
    crow = torch.zeros(n + 1, dtype=torch.int64)
    crow[1:] = torch.cumsum(torch.bincount(host.receivers.long(), minlength=n), 0)
    # the receiver-by-sender CSR matrix (values = mask), built once: the
    # library's one call for the identity variant
    adj = torch.sparse_csr_tensor(crow, host.senders.long(), host.edge_mask.float(), size=(n, n)).to(dev)
    b8_timing = {}
    ptr_t = rp.row_pointers(bd.receivers, n)
    for variant in B8_VARIANTS:
        x, branches, acts, scale = b8_case(variant, n, e, 90)
        xd, brd, scd = x.to(dev), on_dev(branches, dev), None if scale is None else scale.to(dev)
        hin = x.shape[1]
        hout = branches[0][0].shape[1] if branches else hin
        kb = len(branches)
        args_d = (xd, send, bd.receivers, bd.edge_mask, n, brd, acts, scd)
        # as the chassis calls it: on the forward's shared row pointers
        kern = lambda a=args_d: b8.fused_conv(*a, real_edges=occ, row_ptr=ptr_t)  # noqa: E731
        plain = lambda a=args_d: b8.fused_conv_plain(*a)  # noqa: E731
        # one library call computes the identity variant; none the others
        library = (lambda xx=xd: torch.sparse.mm(adj, xx)) if variant.startswith("identity") else None
        # senders and mask, the row pointers, x; the output
        nbytes = e * 5 + (n + 1) * 4 + n * hin * s4 + n * hout * s4
        ops = real_t * hout
        if scale is not None:
            nbytes += e * hout * s4
            ops = 2 * real_t * hout
        if branches:
            nbytes += hin * kb * hout * s4 + kb * hout * s4 + n * kb * hout * s4
            nbytes += e * kb * hout * s4 if branches[0][3] is not None else 0
            ops = 2 * real_t * hin * kb * hout  # the products' multiply-adds
        t = {"kernel": [], "plain": [], "library": []}
        for which in ("kernel", "plain", "library", "kernel"):
            fn = {"kernel": kern, "plain": plain, "library": library}[which]
            if fn is not None:
                t[which].append(cuda_ms(fn, 20))
        bms, by = bound(nbytes, ops)
        g_ms = graph_ms(kern, 10)
        b8_timing[variant] = {
            "ms": float(np.mean(t["kernel"])), "graph_ms": g_ms, "plain_ms": t["plain"][0],
            "library_ms": t["library"][0] if t["library"] else None,
            "library_graph_ms": graph_ms(library, 10) if library is not None else None,
            "graph_ms_own_row_ptr": graph_ms(lambda a=args_d: b8.fused_conv(*a, real_edges=occ), 10),
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops,
            "E": e, "N": n, "H_in": hin, "H_out": hout, "branches": kb,
        }
        if not branches:
            # the rate of the gather itself: each real edge's row of x (and
            # of the scale) over the time in a CUDA graph
            rows_b = real_t * hin * s4 * (2 if scale is not None else 1)
            b8_timing[variant]["gather_tb_per_s"] = rows_b / (g_ms * 1e-3) / 1e12
        line("timing", kernel="fused_conv", variant=variant, card=repr(card),
             **{k: (round(v, 5) if isinstance(v, float) else v) for k, v in b8_timing[variant].items()})
    # the receivers' row-pointer pass (a zero fill and csr_row_ptr_kernel),
    # once per forward, alone; its plain version (searchsorted with the row
    # ids made anew) and the one library call (searchsorted) beside it
    rows_t = torch.arange(n + 1, dtype=torch.int32, device=dev)
    t_rp = [cuda_ms(lambda: rp.row_pointers(bd.receivers, n), 50)]
    rp_plain_ms = cuda_ms(lambda: rp.row_pointers_plain(bd.receivers, n), 50)
    rp_lib_ms = cuda_ms(lambda: torch.searchsorted(bd.receivers, rows_t), 50)
    t_rp.append(cuda_ms(lambda: rp.row_pointers(bd.receivers, n), 50))
    rp_bms, rp_by = bound(e * 4 + (n + 1) * 4, 0)
    timing["row_pointers"] = {
        "ms": float(np.mean(t_rp)), "graph_ms": graph_ms(lambda: rp.row_pointers(bd.receivers, n), 20),
        "plain_ms": rp_plain_ms, "library_ms": rp_lib_ms,
        "library_graph_ms": graph_ms(lambda: torch.searchsorted(bd.receivers, rows_t), 20),
        "bound_ms": rp_bms, "bound_by": rp_by, "E": e, "N": n,
    }
    line("timing", kernel="row_pointers", card=repr(card),
         share_of_identity_h1_graph=round(timing["row_pointers"]["graph_ms"] / b8_timing["identity_h1"]["graph_ms"], 4),
         **{k: (round(x, 5) if isinstance(x, float) else x) for k, x in timing["row_pointers"].items()})
    # B8 and B4 on the molecular data's dense-map batch (phase 8's): on its
    # edge list (the conv stacks' call and their grad_x scatter) and on its
    # dense slots, whose padding node's empty slots make one long row
    md = mhost.to(dev)
    mn, d_slots = mhost.num_nodes, mhost.dense_senders.shape[1]
    dsend, dmask = md.dense_senders.reshape(-1).contiguous(), md.dense_mask.reshape(-1).contiguous()
    drecv = torch.arange(mn, dtype=torch.int32, device=dev).repeat_interleave(d_slots)
    mol_calls = {
        "b8_identity_h128_edges": lambda xx=quarter_grid((mn, hidden), 91).to(dev): b8.fused_conv(
            xx, md.senders, md.receivers, md.edge_mask, mn, real_edges=md.edge_occupancy),
        "b8_identity_h128_slots": lambda xx=quarter_grid((mn, hidden), 92).to(dev): b8.fused_conv(
            xx, dsend, drecv, dmask, mn),
        "b8_scale_f126_edges": lambda xx=quarter_grid((mn, 126), 93).to(dev),
        ss=quarter_grid((mhost.num_edges, 126), 94).to(dev): b8.fused_conv(
            xx, md.senders, md.receivers, md.edge_mask, mn, scale=ss, real_edges=md.edge_occupancy),
        "b4_h128_edges": lambda gg=quarter_grid((mhost.num_edges, hidden), 95).to(dev): b4.segment_sum_local(
            gg, md.senders, md.sender_win, mn),
        "b4_h128_slots": lambda gg=quarter_grid((mn * d_slots, hidden), 96).to(dev): b4.segment_sum_local(
            gg, dsend, md.dense_sender_win, mn),
    }
    for label, fn in mol_calls.items():
        line("timing", batch="molecular_dense_map", call=label, N=mn, E=mhost.num_edges, slots=mn * d_slots,
             card=repr(card), ms=round(cuda_ms(fn, 50), 5), graph_ms=round(graph_ms(fn, 20), 5))
    # the main path's B8 call: the GIN/SAGE/MFC layers 1-5 (identity, H=128)
    timing["fused_conv"] = dict(b8_timing["identity_h128"])

    # where one flagship train step's time goes (host clock, synchronised
    # between stages, median of 5 steps at batch 1024), per stack
    order = np.arange(len(train_loader.samples))

    def breakdown(label, model_, optimizer_, loader_=train_loader, bd_=bd):
        stages = {"batch_build": [], "h2d": [], "forward": [], "backward": [], "optimizer": []}
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hb = loader_.make_batch(order[:TRAIN_BATCH])
            t1 = time.perf_counter()
            b = hb.to(dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            optimizer_.zero_grad(set_to_none=True)
            loss, _ = model_loss(model_.cfg, model_(b, train=True), b)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            optimizer_.step()
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            for k, a, z in (("batch_build", t0, t1), ("h2d", t1, t2), ("forward", t2, t3),
                            ("backward", t3, t4), ("optimizer", t4, t5)):
                stages[k].append((z - a) * 1e3)
        step_ms = cuda_ms(lambda: train_step(model_, optimizer_, bd_), 5)
        line("breakdown", stack=label, shape=f"train_batch{TRAIN_BATCH}", card=repr(card),
             device_step_ms=round(step_ms, 4), graphs_per_s=round(TRAIN_BATCH / step_ms * 1e3, 1),
             **{f"{k}_ms": round(float(np.median(v)), 4) for k, v in stages.items()})

    breakdown("PNA", model, optimizer)
    for lay in ("unaligned", "edge_lengths", "dense"):
        breakdown(f"PNA-{lay}", *layout_models[lay], *layout_batches[lay])
    breakdown("GIN", *stack_models["GIN"])
    breakdown("SchNet", *stack_models["SchNet"])
    torch.cuda.reset_peak_memory_stats()
    breakdown("GAT", gat_model, gat_opt)
    line("breakdown", stack="GAT", max_memory_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
         card=repr(card))

    # the device time of one train step by kernel (torch.profiler), and
    # the share of the step's wall time the card was busy
    ours = ("gather_stats_warp_kernel", "gather_stats_narrow_kernel", "gather_stats_bwd_warp_kernel",
            "gather_stats_bwd_narrow_kernel", "segment_sum_kernel", "gather_rows_kernel", "segment_sum_local_kernel",
            "csr_row_ptr_kernel", "zero_kernel", "fused_identity_warp_kernel",
            "fused_identity_h1_kernel", "fused_branch_kernel", "fused_narrow_kernel", "pna_aggregate_warp_kernel",
            "pna_aggregate_h1_kernel",
            "pna_bwd_count_kernel", "pna_bwd_count_h1_kernel", "pna_bwd_count_long_kernel", "pna_bwd_grad_kernel",
            "stack_product", "stack_walk")

    def profile_step(label, model_, optimizer_, bd_=bd):
        prof_wall_ms, kernel_rows = step_profile(model_, optimizer_, bd_)
        busy_ms = sum(ms for _, ms, _ in kernel_rows)
        port_ms = sum(ms for key, ms, _ in kernel_rows if any(o in key for o in ours))
        gemm_ms = sum(ms for key, ms, _ in kernel_rows if "gemm" in key.lower())
        line("profile", stack=label, shape=f"train_batch{TRAIN_BATCH}", card=repr(card),
             wall_ms=round(prof_wall_ms, 3), **busy_fields(prof_wall_ms, kernel_rows),
             port_kernels_ms=round(port_ms, 3), gemm_ms=round(gemm_ms, 3),
             other_pytorch_ms=round(busy_ms - port_ms - gemm_ms, 3), kernels_seen=len(kernel_rows))
        for key, ms, calls in sorted(kernel_rows, key=lambda r: -r[1])[:15]:
            print(f"  profile[{label}]: {ms:9.3f} ms {calls:5d} calls  {key[:110]}")

    profile_step("PNA", model, optimizer)
    profile_step("PNA-unaligned", *layout_models["unaligned"], layout_batches["unaligned"][1])
    profile_step("PNA-dense", *layout_models["dense"], layout_batches["dense"][1])
    profile_step("GIN", *stack_models["GIN"])
    profile_step("GAT", gat_model, gat_opt)

    section_end("10. timing")
    # ---- 10b. parallel: the Partitioner over torch.distributed ------------
    t0 = time.perf_counter()
    parallel_counts, parallel_err = parallel_phase(dev, card)
    for name, err in parallel_err.items():
        max_err[name] = max(max_err[name], err)
    line("parallel", part="phase", seconds=round(time.perf_counter() - t0, 1), card=repr(card))

    # ---- 10c. pod: the pod planes under supervise --pod 2 ---------------------
    t0 = time.perf_counter()
    pod_counts, pod_err = pod_phase(dev, card, (reset_counts, read_counts), train_samples, per_step, per_fwd)
    for name, err in pod_err.items():
        max_err[name] = max(max_err[name], err)
    line("pod", part="phase", seconds=round(time.perf_counter() - t0, 1), card=repr(card))

    # ---- 11. summary -----------------------------------------------------
    # each kernel's launches on its own main path (serve: B5; PNA
    # training: B1, its backward kernel, B2-B4; GIN training: B8;
    # unaligned PNA training: B6, B7; the stack op forward and backward on
    # both layouts: B9; GIN training: the row-pointer pass), and on every path
    stack_op = {name: sum(c[name] for c in stack_counts_by_layout.values()) for name in mods}
    timing["fused_conv_stack"] = dict(stack_timing["unaligned"])
    paths = {"stack_op": stack_op, "train_gat": gat_counts, **{f"knobs_{k}": c for k, c in knob_counts.items()},
             "serve": serve_counts, "train_pna": train_counts, "train_gin": stack_counts["GIN"],
             "train_pna_unaligned": layout_counts["unaligned"], "train_pna_edge_lengths": layout_counts["edge_lengths"],
             "train_pna_dense": layout_counts["dense"], "accuracy_pna_dense_singlehead": acc_counts["singlehead"],
             "accuracy_pna_dense_multihead": acc_counts["multihead"],
             **{f"accuracy_{k}": v for k, v in acc_counts.items() if k.startswith("stack_")}, **loop_counts,
             "data_path_hgc": data_path_counts, "data_eam": eam_counts, "records": records_counts,
             "train_obs": train_obs_counts, "serve_drift": serve_drift_counts,
             "train_resilience": resilience_counts, "lock_witness": witness_counts,
             "pilot": pilot_counts, "fleet": fleet_counts, "parallel": parallel_counts, "pod": pod_counts,
             **{f"examples_{k}": c for k, c in example_counts.items()}}
    home = {name: "train_pna" for name in mods}
    home.update(pna_aggregate_fwd="serve", fused_conv="train_gin", pna_bwd_count="train_pna_unaligned",
                pna_bwd_grad="train_pna_unaligned", fused_conv_stack="stack_op", row_pointers="train_gin")
    kernels = []
    for name, m in mods.items():
        t = timing[name]
        entry = {
            "name": name, "route": "cuda", "source": m.SOURCE, "replaces": m.REPLACES,
            "launches": paths[home[name]][name], "max_abs_err": max_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "graph_ms": t["graph_ms"],
            "library_graph_ms": t.get("library_graph_ms"), "path": home[name],
            "launches_by_path": {p: c[name] for p, c in paths.items()},
        }
        if name == "fused_conv":
            entry["variants"] = {v: {k: b8_timing[v][k] for k in ("ms", "graph_ms", "plain_ms", "library_ms",
                                                                  "bound_ms", "bound_by")} for v in b8_timing}
        if name in ("segment_sum", "segment_sum_local"):
            # the training loop's batch-128 shape, with the occupancy bound
            # and without it (and for B2 the batch-1024 shape without it
            # and a 60,000-slot row)
            shapes = ("batch128", "batch1024", "long_row") if name == "segment_sum" else ("batch128",)
            entry["shapes"] = {sh: bound_timings[f"{name}_{sh}"] for sh in shapes}
        if name in ("pna_aggregate_fwd", "pna_bwd_count", "pna_bwd_grad"):
            # the unaligned batches of 128 and 1024 graphs with the
            # occupancy bound and without it, and the 60,000-slot hub
            entry["shapes"] = {sh: pna_timings[f"{name}_{sh}"] for sh in ("batch128", "batch1024", "hub")}
        if name == "fused_conv_stack":
            # the yardstick: the loop of B8 launches B9 replaces; and the
            # op's backward (recomputed through B8, B3, B4), per layout
            entry["layouts"] = {lay: {k: v for k, v in t_.items() if k not in ("bytes", "ops")}
                                for lay, t_ in stack_timing.items()}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


def parallel_only(world, pod=False):
    """``python3 chip_smoke.py --parallel-only N``: the kernels built and
    [parallel] alone in a group of N ranks (a card a rank on a machine
    with N cards); ``--pod-only``: [parallel] on two ranks, then [pod]."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card")
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.ops._build import build_all

    dev = hydragnn_tpu_torch.resolve_device("cuda")
    card = card_line()
    line("device", kind=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(), nvidia_smi=repr(card),
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.time()
    warm = child_bytecode_cache()
    build_all(sorted({os.path.basename(m.SOURCE) for m in kernel_modules().values()}))
    warm.wait()
    line("build", seconds=round(time.time() - t0, 2))
    t0 = time.perf_counter()
    parallel_phase(dev, card, world=world)
    line("parallel", part="phase", seconds=round(time.perf_counter() - t0, 1), card=repr(card))
    if pod:
        from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
        from hydragnn_tpu_torch.flagship import flagship_config

        mods = kernel_modules()
        per_step, per_fwd = launch_plan(flagship_config()["NeuralNetwork"]["Architecture"], "run_aligned")
        t0 = time.perf_counter()
        pod_phase(dev, card, (lambda: [m.launches.reset() for m in mods.values()],
                              lambda: {n: m.launches.value for n, m in mods.items()}),
                  lambda: deterministic_graph_data(number_configurations=TRAIN_SAMPLES, unit_cell_x_range=TRAIN_UNIT_CELLS,
                                                   unit_cell_y_range=TRAIN_UNIT_CELLS,
                                                   unit_cell_z_range=TRAIN_UNIT_CELLS, seed=SEED),
                  per_step, per_fwd)
        line("pod", part="phase", seconds=round(time.perf_counter() - t0, 1), card=repr(card))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-only":
        parallel_only(int(sys.argv[2]))
    elif sys.argv[1:] == ["--pod-only"]:
        parallel_only(2, pod=True)
    else:
        main()
    sys.exit(0)
