#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root; needs one CUDA card)

Phases, each printing a line; any failure raises and exits non-zero:

1. device  - requires CUDA; prints the card's name and power limit.
2. build   - builds every CUDA kernel of the port from ``csrc/`` with nvcc
             (one process per source, all started together).
3. kernels - holds each kernel against its plain PyTorch version on the card
             at the main paths' shapes and at ragged ones, and times the
             kernel, the plain version and the one PyTorch call that computes
             the same function (``library_ms``; the port never calls it).
             Every output is held elementwise; a bfloat16 one also normwise,
             ||kernel - plain|| / ||plain|| <= BF16_REL_L2. The forward (B1;
             bf16 on the wgmma kernel of csrc/flash_fwd_sm90.cuh, float32 on
             the 3xTF32 kernel of csrc/flash_fwd_f32_sm90.cuh) is held at
             the serving, MAE decoder (and its pipe microbatches
             [16,513,16,48] and [8,513,16,48], B2 too) and DINO student and
             teacher shapes
             ([256,517,12,64] and [128,517,12,64] bf16) and, in both types, at the
             edges of its key tiles and 128-row blocks, head dims 12 to 128
             and a view 4 elements into its storage; two runs must be
             bit-identical; at the downstream fine-tune's [64,513,12,64] bf16
             on LoRA's layout (q and v contiguous, k a view of the fused
             [64,513,3*768] projection), B2 too. The blocked
             kernels B3 (forward), B4 (dK, dV) and B5 (dQ) are held at the
             192^3 MAE's shapes, in float32, with rectangular q/k and a kv_len
             that masks whole key tiles, at head dims 12 to 128, at the
             edges of their 64-row tiles and on misaligned views; their
             masked dK, dV must be exactly 0 and two runs of B3, B4 and B5
             bit-identical. The backward B2 (bf16 on the wgmma passes of
             csrc/flash_bwd_sm90.cuh, B4's and B5's kernels) is held at the
             MAE decoder's and the DINO student's shapes, at the edges of its
             64-row tiles, head dims
             12 to 128 and a misaligned view; two runs bit-identical.
             ptxas's report (registers, spills, shared memory) of every
             wgmma instantiation (the forward, the dK/dV and dQ passes) is
             printed after the build, a spill failing the run. B1 (float32
             and bf16), B2, B3-B5 and B8 are timed on an idle stream and
             behind a device sleep (B1 and B2 also at the DINO shapes), beside their bound and their
             exponentials' floor; float32 B1 beside both bounds (3xTF32 on
             the tensor cores, its route's, and the float32 CUDA cores) and
             the names of the kernels its library call launched.
4. slice   - the embedding server at full width: ViT-B/12 at 96^3, 3
             channels, random weights from a seeded generator, behind
             ``build_server(max_batch=8)``; 8 concurrent POSTs of synthetic
             head-CT scans. Checks 200s, finite 768-d embeddings equal to the
             same volumes run with the plain attention, and that the forward
             kernel ran 12 times per server forward (counts set to 0 just
             before).
5. train   - the MAE pretraining step at full width (configs/mae/mae_HeadCT.yaml:
             ViT-B/12 encoder, 8-block decoder of width 768 with 16 heads,
             96^3, bf16 compute, AdamW with cosine warm-up) on batch 32 of
             synthetic hu16 head phantoms: one step's loss and gradients with
             the kernels against the plain attention (bf16 and float32), then
             ``train_one_epoch`` over 6 batches and ``val_one_epoch`` over 1,
             checking finite losses, moved parameters and 20 forward + 20
             backward kernel launches per train step (12 encoder blocks at
             T = 129, 8 decoder blocks at 513), 20 forward per eval
             batch (counts set to 0 just before each); then step time,
             throughput, peak memory, a breakdown (CUDA events) and the
             device time by kernel group over 2 profiled steps.
6. dino    - DINO pretraining at full width (configs/dino/dino_HeadCT.yaml as
             shipped: ViT-B/12 with 4 registers, head 3 x 2048 -> 256 ->
             65536, 2 global + 2 local crops to 96^3, bf16 compute, AdamW with
             the weight decay 0.04 -> 0.4, teacher momentum 0.999 -> 1) on its
             batch of 64 synthetic hu16 phantoms: one step at 4 volumes (16
             student crops) with the kernels against the plain attention (bf16
             and float32, every trainable gradient), then train_one_epoch for
             epoch 0 (last layer frozen) and epoch 1, 3 batches each, and
             val_one_epoch over 1 batch: finite losses, last_layer.weight_v
             bit-equal after epoch 0 and moved after epoch 1, every other
             trainable tensor and the teacher moved, a finite centre, and
             exactly 24 B1 + 12 B2 launches per train step (the teacher's 12
             forwards at [128,517,12,64], the student's 12 forwards and
             backwards at [256,517,12,64]) and 24 B1 per eval batch; then the
             median step, volumes/s, peak memory, a breakdown (CUDA events:
             crops, teacher, student, AdamW, EMA) and the device time by
             kernel group over 2 profiled steps.
7. dino-bn - the DINO step with the BatchNorm head (DINO.USE_BN True, the rest
             as shipped): one step at 4 volumes with the kernels against the
             plain attention (float32 on the batch's statistics; in bf16 the loss
             on the batch's statistics, loss and gradients on the running ones,
             see dino_compare), every trainable gradient but
             dino_engine.bn_rounding_only's; 2 train steps at batch 64 with
             exactly 24 B1 + 12 B2 each, finite losses, both heads' running
             statistics moved and apart; a checkpoint restored with head_stats
             and teacher_head_stats bit for bit; the median of 5 steps.
8. cli     - the MAE pretraining CLI end to end at full width: the native
             decoder built with g++ (its time printed), 32 synthetic head scans
             (256x256x40 int16 at 0.5x0.5x1.0 mm) and train / val / test
             manifests of 128 / 64 / 64 rows; the cache's device backend
             ("training" and "hu16" orders) on the card held against the native
             decoder on the same heads at 1.0 mm (the JAX tests' native-vs-scipy
             limits) and against its own CPU run at 0.5 mm;
             ``python -m headct_foundation_tpu_torch.main_pretrain_mae --cfg
             configs/mae/mae_HeadCT.yaml`` in a subprocess with only the paths,
             TRAIN.MAX_EPOCHS 2 and TRAIN.VAL_EVERY 1 overridden (batch 64, the
             windowed wire through the native cache and the pinned prefetcher):
             exit 0, latest_ and best_ checkpoints, finite losses and exactly 20 B1
             + 20 B2 launches per train step and 20 B1 per eval batch, counted in
             the CLI process; the latest_ file restored beside the state bit for
             bit and the checkpoint write timed (sync and async); then a resume
             with TRAIN.MAX_EPOCHS 2 that restarts at the saved epoch index
             and re-runs that epoch.
9. dino-cli - ``python -m headct_foundation_tpu_torch.main_pretrain_dino --cfg
             configs/dino/dino_HeadCT.yaml`` on the cli phase's heads and
             manifests (batch 64, 2 steps an epoch), only the paths,
             TRAIN.MAX_EPOCHS 2 and TRAIN.VAL_EVERY 1 overridden: exit 0,
             latest_ and best_ with the four DINO extras, 0 placeholders,
             exactly 24 B1 + 12 B2 per train step and 24 B1 per eval batch
             counted in the CLI process, latest_ restored beside the state bit
             for bit (student, teacher, optimizer, centre), then a resume with
             TRAIN.MAX_EPOCHS 2 ("Resumed (full)") at the saved epoch index.
10. extract - feature extraction at full width on the cli phase's heads and
             files: ``python -m headct_foundation_tpu_torch.tools.eval_retrieval
             --cfg configs/downstream/vit_HeadCT_cq500.yaml`` on a cq500 label
             manifest of the 32 heads with the MAE latest_ (exit 0, one finite
             mAP per label, exactly 12 B1 per forward counted in its process);
             8 heads embedded on the card and on the CPU (max abs <= 1e-3); the
             96^3 extractor on [2,3,96,96,120] (12 B1 at T = 641); an extractor
             with VIT.INPUT_SIZE 192 from the 96^3 file (the position embedding
             interpolated 512 -> 4096 at load, the card's within 1e-6 of the
             CPU's; 12 B3 at [2,4097,12,64] float32 and no B1; B3 and the
             forward timed); attention_maps of the DINO backbone from the
             dino-cli latest_ (12 x [2,12,517,517], rows summing to 1, no
             kernel launched, the save_attn forward within 1e-3 of the kernel
             forward, a finite cls_attention_volume). Each against the plain
             attention on the card within 1e-3.
11. downstream - the downstream fine-tune at full width
             (configs/downstream/vit_HeadCT_cq500.yaml as shipped: ViT-B/12 at
             96^3, T = 513, linear head, AdamW with the head at 100x the LR,
             batch 64) on hu16 head phantoms with labels (a bleed where the
             label is 1): one step at 4 volumes with the kernels against the
             plain attention (bf16 and float32, every trainable gradient but
             downstream_engine.ROUNDING_ONLY's, those 0 but for rounding; the
             head's BatchNorm on the batch's statistics in float32, on its
             running statistics in bf16, see DOWNSTREAM_COMPARE_BATCH), then train_one_epoch over 8 batches
             and val_one_epoch over 1, then 2 batches under --lock and under
             --lora: finite losses, every trainable tensor and the BatchNorm
             statistics moved and every frozen tensor bit-identical, exactly
             12 B1 + 12 B2 launches per fine-tune and LoRA step, 12 B1 and no
             B2 per lock step, 12 B1 per eval batch; then the median step,
             volumes/s, peak memory, a breakdown (CUDA events: augment,
             forward, backward, the two AdamW groups) and the device time by
             kernel group over 2 profiled steps.
12. downstream-cli - ``python -m headct_foundation_tpu_torch.main_downstream --cfg
             configs/downstream/vit_HeadCT_cq500.yaml`` on the cli phase's heads
             and cache with cq500 label manifests, TRAIN.MAX_EPOCHS 2: a
             fine-tune warm-started from the cli phase's MAE latest_ file,
             --lock --few_shots 4, and --lora --classifier attentive, the
             three processes side by side on the card; each exit 0, 0 placeholders, the exact launches counted in the CLI
             process, a best_ file whose params and batch_stats restore bit
             for bit, a predictions pickle of the test manifest, the warm
             start's merged count printed, the mean AUROC printed (random
             labels: no bound).
12b. tools - on the cli phase's files: ``tools.build_cache --packed`` of the
             32 heads (each tensor byte-equal to a cache miss) serving the MAE
             main's next epoch from the packed index alone (0 placeholders,
             no per-volume file written, 20 B1 + 20 B2 per step);
             ``tools.export_torch`` of its latest_ into FeatureExtractor on
             the card (CLS of 8 heads bit-equal to the pickle's, 12 B1 at
             [8,513,12,64] float32); ``tools.parity_check`` on its oracle
             checkpoint at ViT-B/12 (every cosine >= 0.999, 12 B1); the
             on-card preprocessing against the scipy chain (HEADCT_NATIVE=0)
             at the JAX tests' native-vs-scipy limits.
12c. soak  - ``tools.soak_resume`` on the flagship MAE main (full width, the
             disk cache, the threaded loader, the pinned prefetch, async
             epoch checkpoints) over the cli phase's 32 heads, SOAK_ROWS rows
             at batch 32 (48 steps an epoch; the tool's own corpus is not
             built) for SOAK_EPOCHS epochs: SIGKILLed mid-epoch
             SOAK_KILL_AFTER + 1 (the log shows that epoch every 8 steps, so
             the kill may fall at step 8, 16, 24, 32 or 40), resumed from the
             complete latest_ file; the
             tool's assertions (the resume line, the restart at the chosen
             file's epoch, the kill inside epoch K + 1, finite and continuous
             losses) hard, exactly 20 B1 + 20 B2 a train step and 20 B1 an eval
             batch in both processes (the killed one's completed epochs from
             its log, the resumed one's from its JSON line) and nothing
             else, 0 placeholders; both processes' seconds and the kill to
             the resumed run's first logged step printed.
13. stretch - the long-context MAE step of configs/mae/mae_HeadCT_192.yaml at
             full width (192^3, patch 12: encoder T=1025 at 12 heads x 64,
             decoder T=4097 at 16 heads x 48) on batches of 2 synthetic hu16
             phantoms: one step at batch 1 with the kernels against the plain
             attention (bf16 and float32, every trainable gradient), then 6
             train steps and 1 eval batch with exactly 20 B3 + 20 B4 + 20 B5
             launches per train step, 20 B3 per eval batch and no B1 or B2;
             then the same timings as the train phase.
14. lion   - the 96^3 MAE of the train phase trained by the fused Lion update
             (TRAIN.OPTIMIZER Lion, LION_FUSED True, GRAD_CLIP 1.0): kernel B6
             against its plain version first (bit for bit, at the model's
             shapes and at ragged ones), then 6 train steps and 1 eval batch
             with exactly one B6 launch per trainable tensor per step and 20
             B1 + 20 B2 per step (the attention comparison is the train
             phase's); on the run's state, every tensor's B6 output bit for
             bit against its plain version and the fused optimizer step bit
             for bit against those outputs, then the unfused step against
             it; B6 timed over every trainable tensor; the same timings as
             the train phase.
15. dropout - the MAE step (96^3 as shipped) and the DINO step (as
             shipped) at dropout 0.1, batch 4: each with the kernels against
             the plain attention on the same generators (the train and dino
             phases' limits), then one step each with exactly 20 B1 + 20 B2
             (MAE) and 24 B1 + 12 B2 (DINO); a second run from seed 0
             bit-identical, the rate-0 step different.
16. context - the ``seq`` split of B3/B4/B5 on one card: the 96^3 decoder
             [32,513,16,48] and the 192^3 decoder [2,4097,16,48] and encoder
             [2,1025,12,64], bf16, at s = 2 and 4: the port's sharded branch
             (``ops.attention.attend_shard``) once per emulated rank, its Q
             shard against the padded whole K, V with kv_len, its backward
             summing the dK, dV partials in rank order; O, dQ, dK, dV held
             against the unsharded kernel call and the plain versions
             (rel_l2 <= 1e-2); each shard's B3, B4, B5 timed beside its bound
             and the whole sequence's.
17. tensor - the ``tensor`` split of B1/B2: [32,513,16,48] at t = 2 and 4
             local heads against the matching heads of the full call (bit
             for bit expected), timed beside the bound, and each rank
             against the plain version; the Megatron linears' float32
             partial products against the unsplit linear; on a machine with
             two cards or more the MAE CLI at SEQ 2 and at TENSOR 2 under
             torchrun against one process in bf16
             (``tools/check_data_parallel.py``), else one line says it did
             not run.
18. dino-mesh - the DINO step's attention on the mesh, emulated on one card:
             the student [256,517,12,64] (B1, B2) and the teacher
             [128,517,12,64] (B1) on t = 2 and 4 ranks' heads, bit for bit
             against the full call and within 1e-2 of the plain version;
             their B3 (student: B4, B5 too) on s = 2 and 4 ranks' Q shards
             against the gathered keys with kv_len 517, within 1e-2 of the
             unsharded call and the plain version, the padded keys' dK and
             dV exactly 0; each timed beside its bound, the plain version
             and SDPA, with exact launch counts.
19. downstream-mesh - the same for the fine-tune at [64,513,12,64] on
             LoRA's layout (q and v contiguous, k a view of the projection).
20. fsdp   - every parameter of the three shipped models (the MAE, the DINO
             student, the downstream ViT with LoRA and its attentive head),
             built at full width on the card, split by the rule table into
             f = 2 and 4 shards and joined back bit for bit, each rank's
             parameter and AdamW bytes printed; B6 on an fsdp shard bit for
             bit and timed; on a machine with two cards or more
             ``tools/check_data_parallel.py --fsdp 2`` for the three mains
             and ``--seq 2`` / ``--tensor 2`` for DINO and the downstream
             main (DINO's fsdp and tensor runs in float32 at batch 32; a
             downstream float32 miss printed, not raised) and the
             downstream main at DATA, FSDP, SEQ and TENSOR 2 in float64 at
             batch 32 (``--float64``, held), else one line says they did
             not run.
20b. pipe  - GPipe (``parallel/pipeline.py``) of the flagship MAE at batch 32
             bf16, its stages emulated in this process through the per-stage
             forward and backward of ``pipeline_apply``: PIPE 2 at M = 2 and
             4 and PIPE 4 at M = 4 against the unpipelined step (loss and
             every gradient within TRAIN_TOL), exactly (20 / S) x M B1 + as
             many B2 per stage (the encoder's 12 / S blocks and the decoder's
             8 / S); the clip over the stacked leaves against the
             stacked tensors' clip; the stacked checkpoint at full width
             warm-started into one process bit for bit; B1/B2 at
             [16,513,16,48] and [8,513,16,48] in the kernels phase; with two
             cards or more ``tools/check_data_parallel.py --pipe 2`` (and
             ``--nproc 4 --pipe 2`` on four).
20c. bench - the port's measuring tools in this process at full width, each
             tool's line printed with the card's name and power limit: the
             bench's compute-only mode (the MAE CLI's step, 10 chained steps,
             best of 2; those steps' loss equal within 1e-6 relative to the
             same steps called one by one from the same seed state),
             with-loader (a packed cache, one warm and one timed epoch of 4
             steps, 0 placeholders) and feature-latency (6 scans);
             tools/perf_breakdown.py's five variants; tools/op_profile.py over
             2 MAE steps (shares summing to 100%, top kernels by call site);
             tools/bench_dino.py at 64, tools/bench_downstream.py fine-tune and
             --lock at 64, tools/bench_longcontext.py at 2; the attention bench
             and sweep (every kernel path within the plain path's limits).
             Launches over each timed window held exactly: 20 B1 + 20 B2 a MAE
             step (the fwd variant 20 B1, the encoder variant 12 + 12), 24 B1 + 12
             B2 a DINO step, 12 + 12 a fine-tune step, 12 B1 a lock step, 20
             B3 + 20 B4 + 20 B5 a 192^3 step.
20d. study - the study tools in this process at full width, each tool's
             output in build/study_phase.jsonl and its artifacts under
             build/study/: tools/trajectory.py for the MAE (5 x 20 steps
             at 16), DINO (5 x 20 at 8) and downstream (5 x 20 at 8), pools
             on the card, its own assertions holding;
             tools/wire_equivalence.py (100 steps at 16 on each wire, then
             16 scans' CLS cosines through the bf16 extractor), both series
             finite and the bf16 extractor's CLS within BF16_REL_L2 of
             float32 on the same weights;
             tools/transfer_study.py --scale tiny with the JAX slow test's
             arguments and checks (tests/test_transfer.py), its T = 65 on
             B1/B2; a short
             tools/dino_semantics.py (4 x 50 steps: finite diagnostics,
             accuracies in [0, 1], no kernel at T = 11); tools/bench_int8.py (the int8
             products equal to an int64 product); then the bench's
             compute-only in a new process and under torchrun on every card
             (on one card the torchrun line has the one-process line's
             fields, launches and final loss and a rate within
             TORCHRUN_RATE_BAND of it). Launches exact: 20 B1 + 20 B2 a MAE
             step, 24 B1 + 12 B2 a DINO step, 12 + 12 a fine-tune step, 12 B1
             a probe step under lock and an eval or extraction batch, 12 B1
             bf16 at [4,513,12,64] an extractor call.
21. tm     - the token-major attention tool: kernels B7 and B8 against their
             plain versions at the tool's four shapes (bf16) and at float32
             and ragged ones, and against B1 and B2 on the same inputs (bit
             for bit: the same tile code), then ``tools.bench_tm_attention``
             at its four shapes.
22. report - a JSON line of the kernels, the card line, then the result line.

Float32 matmuls and convolutions are pinned to full float32 (TF32 off for
cuBLAS and cuDNN): the serving forward is float32, like the JAX package's.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import http.client
import json
import logging
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from headct_foundation_tpu_torch.tools.bench_tm_attention import SHAPES as TM_BENCH_SHAPES
from headct_foundation_tpu_torch.tools.bench_tm_attention import cuda_ms
from headct_foundation_tpu_torch.tools.cli_runs import card_lines, run_cli, write_scans

ROOT = Path(__file__).resolve().parent

PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
PEAK_TF32 = 495e12  # the tensor cores' dense TF32 rate, which the float32 forward runs on
PEAK_BYTES = 3.35e12
SERVING = (8, 513, 12, 64)
MAE_DECODER = (32, 513, 16, 48)
# DINO at batch 64: 512 patches + CLS + 4 registers, 12 heads x 64; the
# student's 4 crops a volume and the teacher's 2 global ones
DINO_STUDENT = (256, 517, 12, 64)
DINO_TEACHER = (128, 517, 12, 64)
# the downstream fine-tune at batch 64: 512 patches + CLS, 12 heads x 64; LoRA
# hands q and v over as fresh tensors and k as a view of the fused projection
DOWNSTREAM = (64, 513, 12, 64)
# the 96^3 decoder's microbatches under pipe at the flagship batch of 32: a
# PIPE 2 stage at M = 2, and a PIPE 4 stage at M = 4 (or PIPE 2 at M = 4)
PIPE_2 = (16, 513, 16, 48)
PIPE_4 = (8, 513, 16, 48)
# the bfloat16 extractor of tools/wire_equivalence.py: 4 scans, ViT-B/12
EXTRACTOR_BF16 = (4, 513, 12, 64)
LORA = "lora"  # a case's layout: q, v contiguous, k a view of [B, T, 3 H D]
KERNEL_CASES = [  # (shape [B, T, H, D], dtype, atol, rtol, storage offset) for O; LSE at
    # 1e-4 / 1e-4; reruns bit-identical. q, k, v are strided views of one [B, T, 3, H, D].
    # The bf16 cases from the block edges on hold the wgmma forward's 64-key tiles and
    # 128-row blocks (T one below, at and one above each), head dims 12 (the 8-byte copy
    # route, several key tiles) and 128, and a view whose start (4 elements in) breaks the
    # 16-byte alignment of every operand. The float32 cases after them hold the 3xTF32
    # forward (csrc/flash_fwd_f32_sm90.cuh) at the same edges, at its 32-key tiles of head
    # dim 128, and on a view 4 elements in (still 16-byte aligned in float32).
    (SERVING, torch.float32, 2e-5, 1e-4, 0),               # serving path, every ViT-B block
    (MAE_DECODER, torch.bfloat16, 2e-2, 2e-2, 0),          # MAE decoder, every block
    (DINO_STUDENT, torch.bfloat16, 2e-2, 2e-2, 0),         # DINO student and teacher, every
    (DINO_TEACHER, torch.bfloat16, 2e-2, 2e-2, 0),         # block (5 rows in the last tile)
    (DOWNSTREAM, torch.bfloat16, 2e-2, 2e-2, 0, LORA),     # downstream fine-tune and LoRA
    (PIPE_2, torch.bfloat16, 2e-2, 2e-2, 0),               # the MAE decoder's pipe
    (PIPE_4, torch.bfloat16, 2e-2, 2e-2, 0),               # microbatches
    (EXTRACTOR_BF16, torch.bfloat16, 2e-2, 2e-2, 0),       # the bf16 extractor
    ((2, 129, 3, 32), torch.float32, 2e-5, 1e-4, 0),       # ragged tiles
    ((2, 9, 3, 12), torch.float32, 2e-5, 1e-4, 0),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2, 0),      # the tensor-core path's other
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2, 0),        # head-dim paddings (32, 16,
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),      # 64, 128)
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 63, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),       # block edges
    ((2, 64, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 65, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 127, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 128, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 12), torch.bfloat16, 2e-2, 2e-2, 0),      # head dims 12 and 128
    ((2, 130, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 3, 64), torch.bfloat16, 2e-2, 2e-2, 4),      # misaligned view
    ((2, 63, 2, 48), torch.float32, 2e-5, 1e-4, 0),        # float32 block edges
    ((2, 64, 2, 48), torch.float32, 2e-5, 1e-4, 0),
    ((2, 65, 2, 48), torch.float32, 2e-5, 1e-4, 0),
    ((2, 127, 2, 64), torch.float32, 2e-5, 1e-4, 0),
    ((2, 128, 2, 64), torch.float32, 2e-5, 1e-4, 0),
    ((2, 129, 2, 64), torch.float32, 2e-5, 1e-4, 0),
    ((2, 200, 2, 12), torch.float32, 2e-5, 1e-4, 0),       # float32 head dims 12 and 128
    ((2, 31, 2, 128), torch.float32, 2e-5, 1e-4, 0),       # (32-key tiles)
    ((2, 32, 2, 128), torch.float32, 2e-5, 1e-4, 0),
    ((2, 33, 2, 128), torch.float32, 2e-5, 1e-4, 0),
    ((2, 130, 2, 128), torch.float32, 2e-5, 1e-4, 0),
    ((2, 129, 3, 64), torch.float32, 2e-5, 1e-4, 4),       # a view 4 elements in
]
BWD_CASES = [  # (shape, dtype, atol, rtol, storage offset) for dq, dk, dv against the plain
    # backward; reruns bit-identical. q, k, v are strided views of one [B, T, 3, H, D]. The
    # bf16 cases from the block edges on hold the wgmma passes (csrc/flash_bwd_sm90.cuh) at
    # the whole-sequence shapes: T one below, at and one above their 64-row tiles and the
    # decoder's T = 513 (one real row in the last tile), head dims 16 to 128, the 8-byte
    # copy route (D = 12 over several tiles) and a view whose start (4 elements in) breaks
    # the 16-byte alignment of every operand.
    (MAE_DECODER, torch.bfloat16, 2e-2, 2e-2, 0),          # MAE decoder (main path)
    (DINO_STUDENT, torch.bfloat16, 2e-2, 2e-2, 0),         # DINO student (main path)
    (DOWNSTREAM, torch.bfloat16, 2e-2, 2e-2, 0, LORA),     # downstream fine-tune and LoRA
    (PIPE_2, torch.bfloat16, 2e-2, 2e-2, 0),               # the MAE decoder's pipe
    (PIPE_4, torch.bfloat16, 2e-2, 2e-2, 0),               # microbatches
    (EXTRACTOR_BF16, torch.bfloat16, 2e-2, 2e-2, 0),       # the bf16 extractor
    (MAE_DECODER, torch.float32, 1e-4, 1e-3, 0),
    ((2, 129, 3, 32), torch.float32, 1e-4, 1e-3, 0),       # ragged tiles
    ((2, 9, 3, 12), torch.float32, 1e-4, 1e-3, 0),
    ((2, 129, 3, 32), torch.bfloat16, 2e-2, 2e-2, 0),      # the head-dim paddings 32, 16,
    ((2, 9, 3, 12), torch.bfloat16, 2e-2, 2e-2, 0),        # 64 and 128
    ((2, 200, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 70, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 63, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),       # block edges
    ((2, 64, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 65, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 127, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 128, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 513, 2, 48), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 12), torch.bfloat16, 2e-2, 2e-2, 0),      # head dims 12 (8-byte copies)
    ((2, 129, 2, 16), torch.bfloat16, 2e-2, 2e-2, 0),      # to 128
    ((2, 200, 2, 32), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 64), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 128), torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 3, 64), torch.bfloat16, 2e-2, 2e-2, 4),      # misaligned view
]
STRETCH_DECODER = (2, 4097, 16, 48)   # 192^3 MAE: 4096 patches + CLS, 16 heads x 48
STRETCH_ENCODER = (2, 1025, 12, 64)   # 1024 kept after 75% masking + CLS, 12 heads x 64
BLOCKED_CASES = [  # (q [B, Tq, H, D], Tk, kv_len, dtype, atol, rtol, storage offset) for O;
    # LSE at 1e-4 / 1e-4; dq, dk, dv at BLOCKED_BWD_TOL. kv_len 70 of 700 masks ten whole
    # 64-key tiles. The bf16 cases from the block edges on hold B4/B5's 64-row blocks: Tq
    # and kv_len one below, at and one above a multiple of 64 and 128, head dims 16 to 128,
    # and the 8-byte copy route (D = 12; an offset of 4 elements breaks the 16-byte
    # alignment of every operand). Square q, k, v are strided views of one [B, T, 3, H, D].
    (STRETCH_DECODER, 4097, None, torch.bfloat16, 2e-2, 2e-2, 0),  # every stretch decoder block
    (STRETCH_ENCODER, 1025, None, torch.bfloat16, 2e-2, 2e-2, 0),  # every stretch encoder block
    (STRETCH_ENCODER, 1025, None, torch.float32, 2e-5, 1e-4, 0),
    ((2, 300, 3, 32), 700, 650, torch.float32, 2e-5, 1e-4, 0),     # rectangular, kv_len
    ((2, 300, 3, 32), 700, 70, torch.float32, 2e-5, 1e-4, 0),
    ((2, 300, 3, 32), 700, 650, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 300, 3, 32), 700, 70, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 1100, 2, 12), 1100, None, torch.bfloat16, 2e-2, 2e-2, 0),  # head dims 12 and 128
    ((2, 200, 2, 128), 1500, 1300, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 200, 2, 128), 1500, 1300, torch.float32, 2e-5, 1e-4, 0),
    ((2, 127, 2, 64), 257, 128, torch.bfloat16, 2e-2, 2e-2, 0),    # block edges
    ((2, 128, 2, 64), 257, 129, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 64), 257, 127, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 2, 16), 129, None, torch.bfloat16, 2e-2, 2e-2, 0),   # head dims 16 to 128
    ((2, 200, 2, 32), 200, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 300, 2, 48), 300, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 130, 2, 128), 130, None, torch.bfloat16, 2e-2, 2e-2, 0),
    ((2, 129, 3, 64), 129, None, torch.bfloat16, 2e-2, 2e-2, 4),   # misaligned views
    ((2, 100, 2, 64), 300, 250, torch.bfloat16, 2e-2, 2e-2, 4),
    ((2, 63, 2, 48), 130, 65, torch.bfloat16, 2e-2, 2e-2, 0),      # the forward's 64-key
    ((2, 64, 2, 48), 130, 63, torch.bfloat16, 2e-2, 2e-2, 0),      # tile edges
    ((2, 65, 2, 48), 130, 64, torch.bfloat16, 2e-2, 2e-2, 0),
]
BLOCKED_BWD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
# A bfloat16 output is also held normwise: ||a - b|| / ||b|| against its plain
# version. The elementwise 2e-2 + 2e-2|x| is as large as a typical |o|, |dq|,
# |dk|, |dv| at 4097 keys (about 0.026), so it would pass a kernel that skips
# one 64-key or 64-query tile (about 1/8 of the norm at 4097 tokens).
BF16_REL_L2 = 1e-2
# Kernel B6 (fused Lion) against its plain version, bit for bit: (shape, p and
# g dtype). [3072, 768] and [768] are the MAE's MLP weight and a bias, [2359299]
# an odd length (a scalar tail of 3), [700] and [1] ragged ones.
LION_CASES = [((3072, 768), torch.float32), ((768,), torch.float32), ((700,), torch.float32),
              ((1,), torch.float32), ((2359299,), torch.float32), ((3072, 768), torch.bfloat16)]
LION_SCALARS = (1.5e-4, 0.05, 0.9, 0.95)  # lr, wd, b1, b2 of the MAE recipe
# Unfused against fused Lion on one step: the unfused branch forms 1 - b1 in
# float64 (as the JAX package's does), one float32 step from the kernel's, so
# a sign within an ulp of 0 may flip: this share of parameter elements may
# differ (15 of the MAE's 150.3 M), and the momenta agree within LION_M_REL *
# max|m|. The fused step itself is held bit for bit.
LION_FLIP_SHARE, LION_M_REL = 1e-7, 1e-6
# Device-side sleep queued before timing B6 and the blocked kernels (cuda_ms
# ``ahead``), in clock cycles: about 1 ms and 15 ms at the H100's 1.98 GHz,
# above the host's time to launch one kernel call (tens of microseconds) and
# one B6 call per trainable tensor (~6 ms).
AHEAD_ONE, AHEAD_ALL = 2_000_000, 30_000_000
# Kernels B7, B8 (token-major): (shape, dtype, forward atol, rtol, backward atol,
# rtol). Every shape of the tm bench (its main path) in bf16, MAE_DECODER
# among them, then float32 and ragged ones.
TM_CASES = [(shape, torch.bfloat16, 2e-2, 2e-2, 2e-2, 2e-2) for _, shape in TM_BENCH_SHAPES] + [
    ((8, 513, 12, 64), torch.float32, 2e-5, 1e-4, 1e-4, 1e-3),
    ((2, 70, 4, 32), torch.float32, 2e-5, 1e-4, 1e-4, 1e-3),
    ((2, 129, 2, 128), torch.bfloat16, 2e-2, 2e-2, 2e-2, 2e-2)]
MAE_CONFIG = "configs/mae/mae_HeadCT.yaml"
# Attention blocks of both MAE configurations (12 encoder, 8 decoder): each
# takes the kernels, at 96^3 the whole-sequence B1/B2 (T = 129 and 513).
MAE_ENCODER_BLOCKS, MAE_BLOCKS = 12, 20
STRETCH_CONFIG = "configs/mae/mae_HeadCT_192.yaml"
DINO_CONFIG = "configs/dino/dino_HeadCT.yaml"
DINO_EPOCH_BATCHES = 3     # batches in each of the two epochs (the first freezes the last layer)
DINO_COMPARE_BATCH = 4     # volumes (16 student crops) of the kernel-vs-plain attention step
TRAIN_BATCH = 32          # the JAX bench's batch per chip (bench.py:54)
TRAIN_BATCHES, VAL_BATCHES, WARMUP_STEPS = 6, 1, 2
STRETCH_COMPARE_BATCH = 1  # autograd through the plain attention keeps ~3 [B,16,4097,4097]
                           # float32 tensors per decoder block
TRAIN_TOL = {  # kernel vs plain attention, one step, same weights and randomness
    torch.bfloat16: {"loss_rel": 1e-2, "grad_cos": 0.99},
    torch.float32: {"loss_rel": 1e-4, "grad_rel_max": 1e-3},
}
N_REQUESTS = 8
EMBED_ATOL = 1e-3  # kernel vs plain attention through 12 float32 blocks


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """Normwise relative error ||a - b|| / ||b||, in float32."""
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp_min(1e-30)).item()


def within(a: torch.Tensor, b: torch.Tensor, atol: float, rtol: float, dtype) -> tuple:
    """(elementwise ok, normwise ok, max |a - b|, ||a - b|| / ||b||) of a
    kernel's output a against its plain version b; float32 outputs are held
    elementwise only."""
    err = (a.float() - b.float()).abs()
    rel = rel_l2(a, b)
    return (bool((err <= atol + rtol * b.float().abs()).all()),
            dtype != torch.bfloat16 or rel <= BF16_REL_L2, err.max().item(), rel)


def card_line() -> str:
    return card_lines()[0]


def attention_bound_ms(shape, dtype, backward: bool = False, tf32x3: bool = False) -> tuple:
    """Least time for the work, the larger of operations at the type's dense
    peak and bytes at the memory rate. Forward: 4*B*H*T^2*D operations; q, k,
    v read once, o and lse written once. Backward: 10*B*H*T^2*D operations
    (5 products); q, k, v, o, dO and lse read once, dq, dk, dv written once.
    ``tf32x3``: a float32 product done as three TF32 products on the tensor
    cores (the float32 forward's route), three times the operations at the
    TF32 peak."""
    B, T, H, D = shape
    elt = torch.tensor([], dtype=dtype).element_size()
    ops = (10 if backward else 4) * B * H * T * T * D
    nbytes = (8 if backward else 4) * B * T * H * D * elt + B * H * T * 4
    return bound_ms(3 * ops if tf32x3 else ops, nbytes, dtype, PEAK_TF32 if tf32x3 else None)


def bound_ms(ops: float, nbytes: float, dtype, peak=None) -> tuple:
    t_ops = ops / (peak or PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def blocked_bound_ms(name: str, q_shape, tk: int, kv_len, dtype) -> tuple:
    """Least time of one blocked kernel on these inputs, counting the L =
    kv_len keys it reads. B3 (flash_attention_blocked_fwd): 4*B*H*Tq*L*D
    operations (S, P.V); q and L rows of k, v read, o and lse written. B4
    (flash_attention_blocked_dkv): 8*B*H*Tq*L*D (S, dP, dV, dK); q, dO, L rows
    of k, v, lse and delta read, dk, dv (Tk rows) written. B5
    (flash_attention_blocked_dq): 6*B*H*Tq*L*D (S, dP, dQ); the same reads, dq
    written."""
    B, Tq, H, D = q_shape
    L = tk if kv_len is None else kv_len
    row = B * H * D * torch.tensor([], dtype=dtype).element_size()  # one token, all heads
    rows_f32 = B * H * Tq * 4                                       # lse or delta
    mult, nbytes = {
        "flash_attention_blocked_fwd": (4, (2 * Tq + 2 * L) * row + rows_f32),
        "flash_attention_blocked_dkv": (8, (2 * Tq + 2 * L + 2 * tk) * row + 2 * rows_f32),
        "flash_attention_blocked_dq": (6, (3 * Tq + 2 * L) * row + 2 * rows_f32),
    }[name]
    return bound_ms(mult * B * H * Tq * L * D, nbytes, dtype)


def exp_floor_ms(q_shape, n_keys: int) -> float:
    """Least time of the exponentials of one attention pass (the forward, B4
    or B5): one per P element, B*H*Tq*n_keys, at 16 a clock on each SM's
    special function units (the card's SM count and its maximum SM clock)."""
    B, Tq, H, _ = q_shape
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return B * H * Tq * n_keys / (sms * 16 * mhz * 1e6) * 1e3


def norm_note(dtype) -> str:
    return f" and rel_l2 {BF16_REL_L2}" if dtype == torch.bfloat16 else ""


def phase_kernels(fused_attention, fused_attention_reference) -> dict:
    results = {}
    for shape, dtype, atol, rtol, offset, *layout in KERNEL_CASES:
        B, T, H, D = shape
        g = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = qkv_inputs(shape, offset, g, dtype, layout)
        o, lse = fused_attention(q, k, v)
        again = fused_attention(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = fused_attention_reference(q, k, v)
        elem_ok, norm_ok, err_o, rel_o = within(o, o_ref, atol, rtol, dtype)
        err_lse = (lse - lse_ref).abs()
        same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        ok = (elem_ok and norm_ok and same
              and bool((err_lse <= 1e-4 + 1e-4 * lse_ref.abs()).all()))
        at = (f" offset {offset}" if offset else "") + (" LoRA layout" if layout else "")
        print(f"kernel flash_attention_fwd {list(shape)} {str(dtype)[6:]}{at}: max_abs_err "
              f"o={err_o:.3e} lse={err_lse.max().item():.3e}, rel_l2 o={rel_o:.3e} "
              f"(tolerance o atol {atol} rtol {rtol}{norm_note(dtype)}, lse atol 1e-4 rtol "
              f"1e-4); reruns bit-identical {same} {'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"flash_attention_fwd disagrees with its plain version at {shape} {dtype} "
                  f"offset {offset}")
        row = {"max_abs_err": err_o}
        if T in (513, 517):  # the main paths' shapes: time kernel, plain version and library call
            time_fwd(fused_attention, fused_attention_reference, row, q, k, v, shape, dtype)
        results[(shape, dtype)] = row
    return results


def time_fwd(fused_attention, fused_attention_reference, row, q, k, v, shape, dtype) -> None:
    """Kernel, plain version, bound and library call (scaled_dot_product_attention's
    forward) of B1 at a main-path shape, on an idle stream (``ms``,
    ``library_ms``) and behind a device sleep (``ms_device``,
    ``library_ms_device``: the device's time alone) beside the exp floor. In
    float32 the bound is the 3xTF32 tensor-core route's (``bound_ms``), with
    the float32 CUDA cores' beside it (``bound_ms_cuda_cores``), and the
    library call's kernels are named from a profile (``library_kernels``)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row["ms"] = cuda_ms(lambda: fused_attention(q, k, v))
    row["plain_ms"] = cuda_ms(lambda: fused_attention_reference(q, k, v))
    row["library_ms"] = cuda_ms(lambda: sdpa(qt, kt, vt))
    row["bound_ms"], row["bound_by"] = attention_bound_ms(shape, dtype)
    row["ms_device"] = cuda_ms(lambda: fused_attention(q, k, v), ahead=AHEAD_ONE)
    row["library_ms_device"] = cuda_ms(lambda: sdpa(qt, kt, vt), ahead=AHEAD_ONE)
    floor = exp_floor_ms(shape, shape[1])
    bounds = f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}"
    if dtype == torch.float32:
        row["bound_ms_cuda_cores"] = row["bound_ms"]
        row["bound_ms"], row["bound_by"] = attention_bound_ms(shape, dtype, tf32x3=True)
        row["library_kernels"] = device_kernels(lambda: sdpa(qt, kt, vt))
        bounds = (f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} (three TF32 products "
                  f"each at {PEAK_TF32 / 1e12:.0f} TFLOP/s, the route's; on the float32 CUDA "
                  f"cores {row['bound_ms_cuda_cores']:.4f} ms)")
        print(f"timing flash_attention_fwd {list(shape)} float32: scaled_dot_product_attention "
              f"launched {row['library_kernels']}", flush=True)
    print(f"timing flash_attention_fwd {list(shape)} {str(dtype)[6:]}: "
          f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention {row['library_ms']:.4f} ms "
          f"({row['ms'] / row['library_ms']:.2f}x), on an idle stream; {bounds} "
          f"({100 * row['bound_ms'] / row['ms']:.1f}% of bound); behind a device sleep kernel "
          f"{row['ms_device']:.4f} ms, scaled_dot_product_attention "
          f"{row['library_ms_device']:.4f} ms "
          f"({row['ms_device'] / row['library_ms_device']:.2f}x); exp floor "
          f"{floor:.4f} ms (one exponential per P element, B*H*T^2 = "
          f"{shape[0] * shape[2] * shape[1] ** 2}, at 16 per SM per clock), "
          f"{100 * floor / row['ms_device']:.1f}% of the kernel's device time", flush=True)


def device_kernels(fn) -> list:
    """Names of the kernels that one call of fn launches on the card, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({ev.key[:160] for ev in prof.key_averages()
                   if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)})


def phase_bwd_kernels(fused_attention, fused_attention_bwd, fused_attention_bwd_reference) -> dict:
    """B2 against its plain version at every BWD_CASES case, on the kernel
    forward's o and lse; two runs bit-identical. Timed at the main path's
    shape."""
    results = {}
    for shape, dtype, atol, rtol, offset, *layout in BWD_CASES:
        B, T, H, D = shape
        g = torch.Generator(device="cuda").manual_seed(2)
        q, k, v = qkv_inputs(shape, offset, g, dtype, layout)
        o, lse = fused_attention(q, k, v)
        do = randn_at((B, T, H, D), offset, g, dtype)
        got = fused_attention_bwd(q, k, v, o, do, lse)
        again = fused_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        want = fused_attention_bwd_reference(q, k, v, o, do, lse)
        errs, rels, ok = [], [], True
        for a, b in zip(got, want):
            elem_ok, norm_ok, err, rel = within(a, b, atol, rtol, dtype)
            errs.append(err)
            rels.append(rel)
            ok &= elem_ok and norm_ok
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok &= same
        at = (f" offset {offset}" if offset else "") + (" LoRA layout" if layout else "")
        print(f"kernel flash_attention_bwd {list(shape)} {str(dtype)[6:]}{at}: max_abs_err "
              f"dq={errs[0]:.3e} dk={errs[1]:.3e} dv={errs[2]:.3e}, rel_l2 dq={rels[0]:.3e} "
              f"dk={rels[1]:.3e} dv={rels[2]:.3e} (tolerance atol {atol} rtol {rtol}"
              f"{norm_note(dtype)}); reruns bit-identical {same} {'ok' if ok else 'FAILED'}",
              flush=True)
        check(ok, f"flash_attention_bwd disagrees with its plain version at {shape} {dtype} "
                  f"offset {offset}")
        row = {"max_abs_err": max(errs)}
        if shape in (MAE_DECODER, DINO_STUDENT, DOWNSTREAM, PIPE_2, PIPE_4) \
                and dtype == torch.bfloat16:
            time_bwd(fused_attention_bwd, fused_attention_bwd_reference, row, q, k, v, o, do,
                     lse, shape, dtype)
        results[(shape, dtype)] = row
    return results


def time_bwd(fused_attention_bwd, fused_attention_bwd_reference, row, q, k, v, o, do, lse,
             shape, dtype) -> None:
    """Kernel, plain version, bound and library call (scaled_dot_product_attention's
    backward, its forward+backward minus its forward) of B2 at the main path's
    shape, on an idle stream (``ms``, ``library_ms``) and behind a device sleep
    (``ms_device``, ``library_ms_device``: the device's time alone) beside the
    exp floor of its two passes."""
    row["ms"] = cuda_ms(lambda: fused_attention_bwd(q, k, v, o, do, lse))
    row["ms_device"] = cuda_ms(lambda: fused_attention_bwd(q, k, v, o, do, lse), ahead=AHEAD_ONE)
    row["plain_ms"] = cuda_ms(lambda: fused_attention_bwd_reference(q, k, v, o, do, lse),
                              iters=10)
    fwd_ms, fwd_dev, row["library_ms"], row["library_ms_device"] = sdpa_backward_ms(q, k, v, do)
    row["bound_ms"], row["bound_by"] = attention_bound_ms(shape, dtype, backward=True)
    floor = 2 * exp_floor_ms(shape, shape[1])
    print(f"timing flash_attention_bwd {list(shape)} {str(dtype)[6:]}: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, backward of "
          f"scaled_dot_product_attention {row['library_ms']:.4f} ms "
          f"({row['ms'] / row['library_ms']:.2f}x; measured as its forward+backward minus its "
          f"forward, {fwd_ms:.4f} ms), on an idle stream; bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']} ({100 * row['bound_ms'] / row['ms']:.1f}% of bound); behind a "
          f"device sleep kernel {row['ms_device']:.4f} ms, scaled_dot_product_attention "
          f"backward {row['library_ms_device']:.4f} ms "
          f"({row['ms_device'] / row['library_ms_device']:.2f}x; forward {fwd_dev:.4f} ms); exp "
          f"floor {floor:.4f} ms (one exponential per P element in each of the two passes, "
          f"2*B*H*T^2 = {2 * shape[0] * shape[2] * shape[1] ** 2}, at 16 per SM per clock), "
          f"{100 * floor / row['ms_device']:.1f}% of the kernel's device time", flush=True)


def sdpa_backward_ms(q, k, v, do) -> tuple:
    """(forward ms, forward device ms, backward ms, backward device ms) of
    scaled_dot_product_attention on these inputs: its backward is timed as
    its forward+backward minus its forward, on an idle stream and behind a
    device sleep. The port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd_bwd():
        sdpa(qt, kt, vt).backward(dot)

    fwd_ms = cuda_ms(lambda: sdpa(qt, kt, vt))
    fwd_dev = cuda_ms(lambda: sdpa(qt, kt, vt), ahead=AHEAD_ONE)
    return (fwd_ms, fwd_dev, cuda_ms(fwd_bwd) - fwd_ms,
            cuda_ms(fwd_bwd, ahead=AHEAD_ONE) - fwd_dev)


def randn_at(shape, offset: int, g, dtype) -> torch.Tensor:
    """A [shape] tensor on the card starting ``offset`` elements into its storage."""
    n = math.prod(shape)
    return torch.randn(n + offset, device="cuda", generator=g).to(dtype)[offset:].view(shape)


def qkv_inputs(shape, offset: int, g, dtype, layout=()) -> tuple:
    """q, k, v [B, T, H, D] as the model passes them: strided views of one
    [B, T, 3, H, D], or with ``LORA`` in ``layout`` q and v contiguous and
    k a view of a [B, T, 3 H D] projection."""
    B, T, H, D = shape
    qkv = randn_at((B, T, 3, H, D), offset, g, dtype)
    if LORA in layout:
        return randn_at(shape, 0, g, dtype), qkv[:, :, 1], randn_at(shape, 0, g, dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def blocked_inputs(shape, tk: int, dtype, seed: int, offset: int = 0) -> tuple:
    """q, k, v (strided views of one [B, T, 3, H, D] tensor when square, as
    the model passes them) and an incoming gradient, on the card, each
    starting ``offset`` elements into its storage."""
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if tk == T:
        qkv = randn_at((B, T, 3, H, D), offset, g, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = randn_at((B, T, H, D), offset, g, dtype)
        k, v = (randn_at((B, tk, H, D), offset, g, dtype) for _ in range(2))
    return q, k, v, randn_at((B, T, H, D), offset, g, dtype)


def phase_blocked_kernels() -> dict:
    """B3, B4 and B5 against their plain versions at every BLOCKED_CASES case;
    timed at the two stretch shapes. Returns {(kernel, shape): row}."""
    from headct_foundation_tpu_torch.ops import flash_attention as fa

    results = {}
    for shape, tk, kv_len, dtype, atol, rtol, offset in BLOCKED_CASES:
        q, k, v, do = blocked_inputs(shape, tk, dtype, seed=3, offset=offset)
        o, lse = fa.blocked_fused_attention(q, k, v, kv_len=kv_len)
        delta = fa.attention_delta(o, do)
        dk, dv = fa.blocked_attention_dkv(q, k, v, do, lse, delta, kv_len=kv_len)
        dq = fa.blocked_attention_dq(q, k, v, do, lse, delta, kv_len=kv_len)
        again = (*fa.blocked_fused_attention(q, k, v, kv_len=kv_len),
                 *fa.blocked_attention_dkv(q, k, v, do, lse, delta, kv_len=kv_len),
                 fa.blocked_attention_dq(q, k, v, do, lse, delta, kv_len=kv_len))
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.blocked_attention_reference(q, k, v, kv_len=kv_len)
        err_lse = (lse - lse_ref).abs()
        # o against its plain version; the backward passes against theirs on
        # the kernel's o, lse
        want = (*fa.blocked_attention_dkv_reference(q, k, v, do, lse, delta, kv_len=kv_len),
                fa.blocked_attention_dq_reference(q, k, v, do, lse, delta, kv_len=kv_len))
        batol, brtol = BLOCKED_BWD_TOL[dtype]
        res = [within(o, o_ref, atol, rtol, dtype)] + [
            within(a, b, batol, brtol, dtype) for a, b in zip((dk, dv, dq), want)]
        elem_ok = all(r[0] for r in res) and bool((err_lse <= 1e-4 + 1e-4 * lse_ref.abs()).all())
        norm_ok = all(r[1] for r in res)
        errs, rels = [r[2] for r in res], [r[3] for r in res]
        same = all(torch.equal(a, b) for a, b in zip((o, lse, dk, dv, dq), again))
        masked_zero = kv_len is None or not (dk[:, kv_len:].any() or dv[:, kv_len:].any())
        ok = elem_ok and norm_ok and same and masked_zero
        at = f" offset {offset}" if offset else ""
        print(f"kernel blocked B3/B4/B5 q {list(shape)} k/v length {tk} kv_len {kv_len} "
              f"{str(dtype)[6:]}{at}: max_abs_err o={errs[0]:.3e} lse={err_lse.max().item():.3e} "
              f"dk={errs[1]:.3e} dv={errs[2]:.3e} dq={errs[3]:.3e}, rel_l2 o={rels[0]:.3e} "
              f"dk={rels[1]:.3e} dv={rels[2]:.3e} dq={rels[3]:.3e} (tolerance o atol {atol} "
              f"rtol {rtol}, lse 1e-4/1e-4, grads atol {batol} rtol {brtol}: "
              f"{'ok' if elem_ok else 'FAILED'}{norm_note(dtype)}: "
              f"{'ok' if norm_ok else 'FAILED'}); B3/B4/B5 reruns bit-identical {same}; masked "
              f"dk/dv exactly 0 {masked_zero} {'ok' if ok else 'FAILED'}", flush=True)
        check(ok, f"blocked kernels disagree with their plain versions at {shape} {tk} "
                  f"{kv_len} {dtype} offset {offset}")
        rows = {"flash_attention_blocked_fwd": {"max_abs_err": errs[0]},
                "flash_attention_blocked_dkv": {"max_abs_err": max(errs[1:3])},
                "flash_attention_blocked_dq": {"max_abs_err": errs[3]}}
        if shape in (STRETCH_DECODER, STRETCH_ENCODER) and dtype == torch.bfloat16:
            time_blocked(fa, rows, q, k, v, o, do, lse, delta, shape, dtype)
        for name, row in rows.items():
            results[(name, shape, dtype)] = row
        del q, k, v, o, do, lse, delta, dk, dv, dq, again, want, o_ref, lse_ref, res
        torch.cuda.empty_cache()
    return results


def time_blocked(fa, rows, q, k, v, o, do, lse, delta, shape, dtype) -> None:
    """Kernel, plain version and bound of B3, B4 and B5 at a main-path shape;
    the library call: scaled_dot_product_attention's forward for B3, and its
    backward against delta + B4 + B5 together. Kernels, library calls and
    the port's backward are timed on an idle stream (``ms``, ``library_ms``,
    ``backward_ms``, ``library_backward_ms``: events that bracket the host's
    launch work too) and behind a device sleep (the same keys with
    ``_device``: device time alone; at the encoder's shape a launch from the
    host takes about as long as the kernel)."""
    def both(fn):
        return cuda_ms(fn, iters=10), cuda_ms(fn, iters=10, ahead=AHEAD_ONE)

    calls = {
        "flash_attention_blocked_fwd": (lambda: fa.blocked_fused_attention(q, k, v),
                                        lambda: fa.blocked_attention_reference(q, k, v)),
        "flash_attention_blocked_dkv": (
            lambda: fa.blocked_attention_dkv(q, k, v, do, lse, delta),
            lambda: fa.blocked_attention_dkv_reference(q, k, v, do, lse, delta)),
        "flash_attention_blocked_dq": (
            lambda: fa.blocked_attention_dq(q, k, v, do, lse, delta),
            lambda: fa.blocked_attention_dq_reference(q, k, v, do, lse, delta)),
    }
    for name, (kernel, plain) in calls.items():
        rows[name]["ms"], rows[name]["ms_device"] = both(kernel)
        rows[name]["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
        rows[name]["bound_ms"], rows[name]["bound_by"] = blocked_bound_ms(
            name, shape, shape[1], None, dtype)
        rows[name]["library_ms"] = None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    fwd_ms, fwd_dev = both(lambda: sdpa(qt, kt, vt))
    rows["flash_attention_blocked_fwd"]["library_ms"] = fwd_ms
    rows["flash_attention_blocked_fwd"]["library_ms_device"] = fwd_dev
    sdpa_bwd_ms, sdpa_bwd_dev = (t - f for t, f in
                                 zip(both(lambda: sdpa(qt, kt, vt).backward(dot)),
                                     (fwd_ms, fwd_dev)))

    def port_bwd():
        d = fa.attention_delta(o, do)
        fa.blocked_attention_dkv(q, k, v, do, lse, d)
        fa.blocked_attention_dq(q, k, v, do, lse, d)

    bwd_ms, bwd_dev = both(port_bwd)
    for name in ("flash_attention_blocked_dkv", "flash_attention_blocked_dq"):
        rows[name].update(backward_ms=bwd_ms, backward_ms_device=bwd_dev,  # delta + B4 + B5
                          library_backward_ms=sdpa_bwd_ms,
                          library_backward_ms_device=sdpa_bwd_dev)
    floor = exp_floor_ms(shape, shape[1])
    for name, r in rows.items():
        print(f"timing {name} {list(shape)} {str(dtype)[6:]}: kernel {r['ms']:.4f} ms on an "
              f"idle stream ({r['ms_device']:.4f} ms behind a device sleep), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound; "
              f"{100 * r['bound_ms'] / r['ms_device']:.1f}% of the device time)", flush=True)
        print(f"timing {name} {list(shape)} {str(dtype)[6:]}: exp floor {floor:.4f} ms "
              f"(one exponential per P element, B*H*Tq*Tk = "
              f"{shape[0] * shape[2] * shape[1] ** 2}, at 16 per SM per clock), "
              f"{100 * floor / r['ms_device']:.1f}% of the kernel's device time", flush=True)
    print(f"timing blocked backward {list(shape)} {str(dtype)[6:]}: delta (torch) + B4 + B5 "
          f"{bwd_ms:.4f} ms ({bwd_ms / sdpa_bwd_ms:.2f}x) against the backward of "
          f"scaled_dot_product_attention {sdpa_bwd_ms:.4f} ms (its forward+backward minus its "
          f"forward, {fwd_ms:.4f} ms), on an idle stream; behind a device sleep {bwd_dev:.4f} "
          f"ms ({bwd_dev / sdpa_bwd_dev:.2f}x) against {sdpa_bwd_dev:.4f} ms ({fwd_dev:.4f} ms); "
          f"B3 {rows['flash_attention_blocked_fwd']['ms']:.4f} ms against its forward",
          flush=True)


def lion_bound_ms(n: int, dtype) -> tuple:
    """Least time of B6 over n elements: p, g, m read and delta, m_new written
    once (20 bytes per element with float32 p and g, 14 with bfloat16), and
    8 float32 operations per element."""
    elt = torch.tensor([], dtype=dtype).element_size()
    return bound_ms(8 * n, n * (3 * elt + 8), torch.float32)


def phase_lion_kernel() -> dict:
    """B6 against its plain version at every LION_CASES case, bit for bit,
    with m_new written to a new tensor and over m in place; timed at the
    MAE's [3072, 768] float32 weight."""
    from headct_foundation_tpu_torch.ops.lion_kernel import (
        lion_update_leaf,
        lion_update_leaf_reference,
    )

    row = {"max_abs_err": 0.0}
    for shape, dtype in LION_CASES:
        g = torch.Generator(device="cuda").manual_seed(5)
        p = torch.randn(shape, device="cuda", generator=g).to(dtype)
        grad = (1e-2 * torch.randn(shape, device="cuda", generator=g)).to(dtype)
        m = 1e-3 * torch.randn(shape, device="cuda", generator=g)
        delta, m_new = lion_update_leaf(p, grad, m, *LION_SCALARS)
        m_in_place = m.clone()
        delta_in_place, _ = lion_update_leaf(p, grad, m_in_place, *LION_SCALARS, m_out=m_in_place)
        torch.cuda.synchronize()
        want = lion_update_leaf_reference(p, grad, m, *LION_SCALARS)
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip((delta, m_new), want)]
        differ = (delta != want[0]).float().mean().item()
        same = (torch.equal(delta, want[0]) and torch.equal(m_new, want[1])
                and torch.equal(delta_in_place, delta) and torch.equal(m_in_place, m_new))
        print(f"kernel lion_update {list(shape)} p/g {str(dtype)[6:]}: max_abs_err "
              f"delta={errs[0]:.3e} m_new={errs[1]:.3e}, share of delta elements differing "
              f"{differ:.3e}; bit-identical to the plain version, in place over m too: {same} "
              f"{'ok' if same else 'FAILED'}", flush=True)
        check(same, f"lion_update disagrees with its plain version at {shape} {dtype}")
        row["max_abs_err"] = max(row["max_abs_err"], *errs)
        if shape == LION_CASES[0][0] and dtype == torch.float32:
            row["ms"] = cuda_ms(lambda: lion_update_leaf(p, grad, m, *LION_SCALARS),
                                ahead=AHEAD_ONE)
            row["plain_ms"] = cuda_ms(
                lambda: lion_update_leaf_reference(p, grad, m, *LION_SCALARS), ahead=AHEAD_ONE)
            # on an idle stream, with the host's launch work
            row["ms_idle_stream"] = cuda_ms(lambda: lion_update_leaf(p, grad, m, *LION_SCALARS))
            row["bound_ms"], row["bound_by"] = lion_bound_ms(p.numel(), dtype)
            row["library_ms"] = None  # no one PyTorch call computes a Lion update
            print(f"timing lion_update {list(shape)} float32: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms (launches queued behind a device sleep), no "
                  f"library call; kernel {row['ms_idle_stream']:.4f} ms on an idle stream "
                  f"(host launch work included); bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']} ({100 * row['bound_ms'] / row['ms']:.1f}% of bound)",
                  flush=True)
    return row


def phase_tm_kernels() -> dict:
    """B7 and B8 against their plain versions (held as B1 and B2 are) at every
    TM_CASES case, the tm bench's four shapes among them, and against B1 and
    B2 on the same contiguous inputs, bit for bit (the same tile code over the
    same strides); two runs of B8 bit-identical. Timed at the MAE decoder's
    shape. Returns {kernel: row}."""
    from headct_foundation_tpu_torch.ops import flash_attention as fa
    from headct_foundation_tpu_torch.tools import experimental_tm_attention as tm

    rows = {"tm_attention_fwd": {"max_abs_err": 0.0}, "tm_attention_bwd": {"max_abs_err": 0.0}}
    for shape, dtype, fatol, frtol, batol, brtol in TM_CASES:
        g = torch.Generator(device="cuda").manual_seed(6)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(4))
        o, lse = tm.tm_attention_fwd(q, k, v)
        grads = tm.tm_attention_bwd(q, k, v, o, do, lse)
        again = tm.tm_attention_bwd(q, k, v, o, do, lse)
        o_b1, lse_b1 = fa.fused_attention(q, k, v)
        grads_b2 = fa.fused_attention_bwd(q, k, v, o_b1, do, lse_b1)
        torch.cuda.synchronize()
        o_ref, lse_ref = tm.tm_attention_fwd_reference(q, k, v)
        want = tm.tm_attention_bwd_reference(q, k, v, o, do, lse)
        res = [within(o, o_ref, fatol, frtol, dtype)] + [
            within(a, b, batol, brtol, dtype) for a, b in zip(grads, want)]
        err_lse = (lse - lse_ref).abs()
        elem_ok = all(r[0] for r in res) and bool((err_lse <= 1e-4 + 1e-4 * lse_ref.abs()).all())
        norm_ok = all(r[1] for r in res)
        rerun = all(torch.equal(a, b) for a, b in zip(grads, again))
        as_b1_b2 = (torch.equal(o, o_b1) and torch.equal(lse.flatten(), lse_b1.flatten())
                    and all(torch.equal(a, b) for a, b in zip(grads, grads_b2)))
        ok = elem_ok and norm_ok and rerun and as_b1_b2
        errs, rels = [r[2] for r in res], [r[3] for r in res]
        print(f"kernel tm_attention B7/B8 {list(shape)} {str(dtype)[6:]}: max_abs_err "
              f"o={errs[0]:.3e} lse={err_lse.max().item():.3e} dq={errs[1]:.3e} "
              f"dk={errs[2]:.3e} dv={errs[3]:.3e}, rel_l2 o={rels[0]:.3e} dq={rels[1]:.3e} "
              f"dk={rels[2]:.3e} dv={rels[3]:.3e} (tolerance o atol {fatol} rtol {frtol}, lse "
              f"1e-4/1e-4, grads atol {batol} rtol {brtol}: {'ok' if elem_ok else 'FAILED'}"
              f"{norm_note(dtype)}: {'ok' if norm_ok else 'FAILED'}); B8 reruns bit-identical "
              f"{rerun}; equal to B1/B2 bit for bit {as_b1_b2} {'ok' if ok else 'FAILED'}",
              flush=True)
        check(ok, f"tm_attention kernels disagree at {shape} {dtype}")
        rows["tm_attention_fwd"]["max_abs_err"] = max(rows["tm_attention_fwd"]["max_abs_err"],
                                                      errs[0])
        rows["tm_attention_bwd"]["max_abs_err"] = max(rows["tm_attention_bwd"]["max_abs_err"],
                                                      *errs[1:])
        if shape == MAE_DECODER and dtype == torch.bfloat16:
            time_tm(tm, rows, q, k, v, o, do, lse, shape, dtype)
        del q, k, v, do, o, lse, grads, again, o_b1, lse_b1, grads_b2, want, o_ref, lse_ref
        torch.cuda.empty_cache()
    return rows


def time_tm(tm, rows, q, k, v, o, do, lse, shape, dtype) -> None:
    """Kernel, plain version, bound and library call of B7 and B8: the
    library call is scaled_dot_product_attention's forward for B7 and its
    backward (forward+backward minus forward) for B8, on an idle stream
    (``ms``, ``library_ms``); B8 and its library call also behind a device
    sleep (``ms_device``, ``library_ms_device``)."""
    fwd, bwd = rows["tm_attention_fwd"], rows["tm_attention_bwd"]
    fwd["ms"] = cuda_ms(lambda: tm.tm_attention_fwd(q, k, v))
    fwd["plain_ms"] = cuda_ms(lambda: tm.tm_attention_fwd_reference(q, k, v))
    bwd["ms"] = cuda_ms(lambda: tm.tm_attention_bwd(q, k, v, o, do, lse))
    bwd["ms_device"] = cuda_ms(lambda: tm.tm_attention_bwd(q, k, v, o, do, lse),
                               ahead=AHEAD_ONE)
    bwd["plain_ms"] = cuda_ms(lambda: tm.tm_attention_bwd_reference(q, k, v, o, do, lse),
                              iters=10)
    fwd["library_ms"], _, bwd["library_ms"], bwd["library_ms_device"] = sdpa_backward_ms(
        q, k, v, do)
    for r, backward in ((fwd, False), (bwd, True)):
        r["bound_ms"], r["bound_by"] = attention_bound_ms(shape, dtype, backward)
    for name, r in rows.items():
        device = (f"; behind a device sleep kernel {r['ms_device']:.4f} ms, library "
                  f"{r['library_ms_device']:.4f} ms" if "ms_device" in r else "")
        print(f"timing {name} {list(shape)} {str(dtype)[6:]}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{'backward' if r is bwd else 'forward'} {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound){device}", flush=True)


def phase_tm_bench() -> dict:
    """The token-major A/B tool at its four shapes; every shape's out and
    gradients must equal the whole-sequence kernels' bit for bit. Returns
    each kernel's launches in it."""
    from headct_foundation_tpu_torch.tools import bench_tm_attention

    zero_launches()  # the tool's run: every kernel count is 0 just before it
    t0 = time.perf_counter()
    shapes = bench_tm_attention.run()
    counts = launches()
    bad = [n for n, r in shapes.items() if not r["bit_identical"]]
    check(not bad, f"bench_tm_attention: FusedAttentionTM differs from FusedAttention at {bad}")
    print(f"tm bench: {len(shapes)} shapes in {time.perf_counter() - t0:.2f} s, every one "
          f"bit-identical to FusedAttention; launches {counts}; speedup of FusedAttentionTM "
          f"{ {n: round(r['speedup_tm'], 4) for n, r in shapes.items()} }", flush=True)
    return counts


def lion_step_checks(state) -> dict:
    """On the Lion path's state and gradients: each trainable tensor's B6
    output (delta and m_new) bit for bit against its plain version; one
    optimizer step fused from cloned parameters, gradients and momenta, whose
    parameters and momenta must be p + delta and m_new of those B6 outputs
    bit for bit; the same step unfused (at most LION_FLIP_SHARE of the
    parameter elements differ, the momenta within LION_M_REL * max|m|); then
    B6 timed over every trainable tensor, one launch each as the optimizer
    makes them."""
    from headct_foundation_tpu_torch.ops.lion_kernel import (
        lion_update_leaf,
        lion_update_leaf_reference,
    )
    from headct_foundation_tpu_torch.optim.optimizers import Lion

    group = state.optimizer.param_groups[0]
    lr, wd, (b1, b2) = group["lr"], group["weight_decay"], group["betas"]
    params = [p for p in group["params"] if p.grad is not None]
    after = []
    for fused in (True, False):
        clones = [p.detach().clone() for p in params]
        opt = Lion(clones, lr=lr, betas=group["betas"], weight_decay=wd, fused=fused)
        for c, p in zip(clones, params):
            c.grad = p.grad.clone()
            opt.state[c]["exp_avg"] = state.optimizer.state[p]["exp_avg"].clone()
        opt.step()
        after.append((clones, [opt.state[c]["exp_avg"] for c in clones]))
        del opt
    (p_f, m_f), (p_u, m_u) = after
    as_plain = as_step = 0
    for p, pf, mf in zip(params, p_f, m_f):
        m = state.optimizer.state[p]["exp_avg"]
        delta, m_new = lion_update_leaf(p, p.grad, m, lr, wd, b1, b2)
        want = lion_update_leaf_reference(p, p.grad, m, lr, wd, b1, b2)
        as_plain += torch.equal(delta, want[0]) and torch.equal(m_new, want[1])
        as_step += torch.equal(pf, p + delta) and torch.equal(mf, m_new)
    n = sum(p.numel() for p in params)
    differ = sum(int((a != b).sum()) for a, b in zip(p_f, p_u))
    m_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(m_f, m_u))
    ok = (as_plain == as_step == len(params) and differ <= LION_FLIP_SHARE * n
          and m_rel <= LION_M_REL)
    print(f"lion: B6 on the run's state, bit-identical to its plain version in {as_plain} of "
          f"{len(params)} tensors (delta and m_new), and the fused step's parameters and "
          f"momenta equal p + delta and m_new bit for bit in {as_step}; unfused against fused "
          f"from cloned state: {differ} of {n} parameter elements differ ({differ / n:.3e}, "
          f"tolerance {LION_FLIP_SHARE}), momenta max |dm|/max|m| {m_rel:.3e} (tolerance "
          f"{LION_M_REL}) {'ok' if ok else 'FAILED'}", flush=True)
    check(ok, "B6, the fused Lion step and the unfused one disagree on the run's state")
    del after, p_f, m_f, p_u, m_u

    moms = [state.optimizer.state[p]["exp_avg"].clone() for p in params]

    def every_tensor():
        for p, m in zip(params, moms):
            lion_update_leaf(p, p.grad, m, lr, wd, b1, b2, m_out=m)

    all_ms = cuda_ms(every_tensor, iters=5, warmup=1, ahead=AHEAD_ALL)
    idle_ms = cuda_ms(every_tensor, iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    every_tensor()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    bound, by = lion_bound_ms(n, torch.float32)
    print(f"lion: B6 over all {len(params)} trainable tensors ({n} float32 elements), one "
          f"launch each: {all_ms:.4f} ms of device time (CUDA events, launches queued behind a "
          f"device sleep), {idle_ms:.4f} ms from the first launch to the last on an idle "
          f"stream, {host_ms:.2f} ms on the host clock to launch and finish them; bound "
          f"{bound:.4f} ms by {by} ({100 * bound / all_ms:.1f}% of bound)", flush=True)
    return {"tensors": len(params), "elements": n, "ms": all_ms, "ms_idle_stream": idle_ms,
            "host_ms": host_ms, "bound_ms": bound, "bit_identical_tensors": as_plain,
            "flip_share": differ / n, "m_rel": m_rel}


def post_scans(port: int, blobs) -> list:
    out = [None] * len(blobs)

    def hit(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/embed", body=blobs[i])
            resp = conn.getresponse()
            body = json.loads(resp.read())
            out[i] = (resp.status, body, time.perf_counter() - t0)
        finally:
            conn.close()

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(blobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        check(not t.is_alive(), "a request did not finish")
    check(all(r is not None for r in out), "a request failed before its reply")
    return out


def phase_slice(workdir: Path) -> dict:
    """Drive the server at full width; returns each kernel's launches in it."""
    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
    from headct_foundation_tpu_torch.ops import attention as port_attn
    from headct_foundation_tpu_torch.ops.flash_attention import fused_attention
    from headct_foundation_tpu_torch.serve_features import build_server

    t0 = time.perf_counter()
    fe = FeatureExtractor(device="cuda", seed=0)  # ViT-B/12 @ 96^3, 3 channels, sincos
    warm = torch.zeros((N_REQUESTS, 3, 96, 96, 96), device="cuda")
    fe(warm)
    torch.cuda.synchronize()
    print(f"slice set-up: FeatureExtractor(ViT-B/12, 96^3, seed 0) on {fe.device} and warm "
          f"forward in {time.perf_counter() - t0:.2f} s", flush=True)

    paths = write_scans(workdir, range(N_REQUESTS))
    blobs = [Path(p).read_bytes() for p in paths]

    server, batcher = build_server(fe, host="127.0.0.1", port=0, max_batch=N_REQUESTS,
                                   window_ms=20.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        # the main path's run: every kernel count is 0 just before it
        fused_attention.launches = 0
        t0 = time.perf_counter()
        replies = post_scans(server.server_address[1], blobs)
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fused_attention.launches}
        forwards = batcher.batches
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)

    for i, (status, body, _) in enumerate(replies):
        check(status == 200, f"request {i}: HTTP {status} {body}")
        emb = np.asarray(body["embedding"], np.float32)
        check(emb.shape == (768,) and bool(np.isfinite(emb).all()),
              f"request {i}: embedding shape {emb.shape} or non-finite values")
    check(forwards >= 1 and launches["flash_attention_fwd"] == 12 * forwards,
          f"flash_attention_fwd ran {launches['flash_attention_fwd']} times in "
          f"{forwards} server forwards; expected 12 per forward")
    lat = sorted(r[2] * 1e3 for r in replies)
    print(f"slice: {N_REQUESTS} POST /embed of 256x256x40 int16 scans at 0.5x0.5x1.0 mm -> "
          f"200 x{N_REQUESTS}, 768-d finite; {forwards} server forwards "
          f"(batched_with {[r[1]['batched_with'] for r in replies]}); flash_attention_fwd "
          f"launches {launches['flash_attention_fwd']} = 12 per forward; latency p50 "
          f"{statistics.median(lat):.1f} ms max {lat[-1]:.1f} ms; "
          f"{N_REQUESTS / wall:.2f} volumes/s", flush=True)

    # The same volumes with the attention forced to the plain version.
    vols = torch.stack([fe.preprocess(p) for p in paths])
    prev = port_attn.set_attention_backend("plain")
    try:
        ref = fe.cls_embedding(vols)
    finally:
        port_attn.set_attention_backend(prev)
    got = np.stack([np.asarray(r[1]["embedding"], np.float32) for r in replies])
    err = float(np.abs(got - ref).max())
    print(f"slice: embeddings vs plain-attention forward: max_abs_err {err:.3e} "
          f"(tolerance {EMBED_ATOL})", flush=True)
    check(err <= EMBED_ATOL, "server embeddings disagree with the plain-attention forward")

    # Where the time goes (device times from CUDA events, batch 8).
    prep_ms = cuda_ms(lambda: fe.preprocess(blobs[0]), iters=5, warmup=1)
    fwd_ms = cuda_ms(lambda: fe(vols), iters=5, warmup=1)
    prev = port_attn.set_attention_backend("plain")
    try:
        fwd_plain_ms = cuda_ms(lambda: fe(vols), iters=5, warmup=1)
    finally:
        port_attn.set_attention_backend(prev)
    print(f"breakdown: preprocess one scan (decode + device ops) {prep_ms:.2f} ms; forward "
          f"batch {N_REQUESTS}: {fwd_ms:.2f} ms with the kernel, {fwd_plain_ms:.2f} ms with "
          f"the plain attention", flush=True)
    return launches


def head_phantoms(seed: int, n: int, size: int = 96) -> np.ndarray:
    """n head-like hu16 wire volumes [n, 1, size^3] int16: air, a skull
    shell, brain tissue with noise, each ellipsoid placed and sized at random."""
    from headct_foundation_tpu_torch.data.transforms import hu16_encode

    rng = np.random.RandomState(seed)
    g = (np.arange(size, dtype=np.float32) - size / 2) / (size / 2)
    x, y, z = g[:, None, None], g[None, :, None], g[None, None, :]
    out = np.empty((n, 1, size, size, size), np.int16)
    for i in range(n):
        c = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
        r = rng.uniform(0.65, 0.9, 3).astype(np.float32)
        d = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((z - c[2]) / r[2]) ** 2
        hu = np.where(d < 1.0, 1000.0, -1000.0).astype(np.float32)
        brain = d < 0.8
        hu[brain] = 35.0 + 8.0 * rng.randn(int(brain.sum())).astype(np.float32)
        out[i, 0] = hu16_encode(hu)
    return out


def loss_and_grads(model, wire, cfg, draws, backend: str, names) -> tuple:
    """One step's loss and the gradients of ``names`` under ``backend``."""
    from headct_foundation_tpu_torch.data.augment import apply_mae_augment
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.ops import attention as port_attn

    prev = port_attn.set_attention_backend(backend)
    try:
        model.zero_grad(set_to_none=True)
        batch = apply_mae_augment(wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS), draws["augment"])
        loss, _, _ = model(batch, noise=draws["noise"])
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: params[n].grad.detach().clone() for n in names}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads
    finally:
        port_attn.set_attention_backend(prev)


def compare_backends(model, wire, cfg, draws, dtype, label: str = "train") -> dict:
    """Kernel against plain attention on the same step: loss and every
    trainable gradient."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return hold_backends(lambda backend: loss_and_grads(model, wire, cfg, draws, backend, names),
                         dtype, label, "trainable")


def hold_backends(loss_and_grads_of, dtype, label: str, what: str) -> dict:
    """One step's loss and gradients with the kernels against the plain
    attention, under TRAIN_TOL; ``loss_and_grads_of(backend)`` returns (loss,
    {name: gradient})."""
    loss_k, g_k = loss_and_grads_of("kernel")
    loss_p, g_p = loss_and_grads_of("plain")
    names = list(g_k)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = min(torch.nn.functional.cosine_similarity(
        g_k[n].flatten().double(), g_p[n].flatten().double(), dim=0).item() for n in names)
    grad_rel = max(((g_k[n] - g_p[n]).abs().max() / g_p[n].abs().max().clamp_min(1e-30)).item()
                   for n in names)
    tol = TRAIN_TOL[dtype]
    ok = rel <= tol["loss_rel"] and (cos >= tol["grad_cos"] if "grad_cos" in tol
                                     else grad_rel <= tol["grad_rel_max"])
    print(f"{label}: kernel vs plain attention, one step at {str(dtype)[6:]}: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (relative {rel:.3e}, tolerance {tol['loss_rel']}); over "
          f"{len(names)} {what} gradient tensors min cosine "
          f"{cos:.6f}, max "
          f"|dg|/max|g| {grad_rel:.3e} (tolerance "
          f"{'cosine >= ' + str(tol['grad_cos']) if 'grad_cos' in tol else 'max |dg| <= ' + str(tol['grad_rel_max']) + ' max|g|'}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    check(ok, f"kernel and plain attention disagree on the {label} step at {dtype}")
    return {"loss_rel": rel, "grad_cos_min": cos, "grad_rel_max": grad_rel}


def profile_steps(run_step, step_ms: float, n: int = 2) -> None:
    """Device time by kernel group over n train steps (torch.profiler; each
    ``run_step()``), and the device busy share: summed kernel time per step
    over the unprofiled median step time ``step_ms`` (the profiler slows the
    host)."""
    from torch.profiler import ProfilerActivity, profile

    from headct_foundation_tpu_torch.tools.op_profile import category

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups, total, top = {}, 0.0, []
    for ev in prof.key_averages():
        # kernels only: an annotated range on the device timeline (such as
        # "Optimizer.step#AdamW.step") would count its kernels twice
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0))
        total += us
        group = category(ev.key)
        groups[group] = groups.get(group, 0.0) + us
        top.append((us, ev.key[:100]))
    if total <= 0:
        print("profile: the profiler recorded no device time; busy share not measured",
              flush=True)
        return
    parts = ", ".join(f"{g} {us / n / 1e3:.2f} ms ({100 * us / total:.1f}%)"
                      for g, us in sorted(groups.items(), key=lambda kv: -kv[1]))
    per_step = total / n / 1e3
    print(f"profile (torch.profiler, {n} train steps): device time per step {per_step:.2f} ms "
          f"(host time per profiled step {wall_us / n / 1e3:.2f} ms); busy share against the "
          f"unprofiled median step {100 * per_step / step_ms:.1f}%; by kernel group: {parts}",
          flush=True)
    print("profile: top kernels per step: " + "; ".join(
        f"{us / n / 1e3:.2f} ms {name}" for us, name in sorted(top, reverse=True)[:8]),
        flush=True)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its CUDA launches."""
    from headct_foundation_tpu_torch.ops import flash_attention as fa
    from headct_foundation_tpu_torch.ops.lion_kernel import lion_update_leaf
    from headct_foundation_tpu_torch.tools import experimental_tm_attention as tm

    return {"flash_attention_fwd": fa.fused_attention,
            "flash_attention_bwd": fa.fused_attention_bwd,
            "flash_attention_blocked_fwd": fa.blocked_fused_attention,
            "flash_attention_blocked_dkv": fa.blocked_attention_dkv,
            "flash_attention_blocked_dq": fa.blocked_attention_dq,
            "lion_update": lion_update_leaf,
            "tm_attention_fwd": tm.tm_attention_fwd,
            "tm_attention_bwd": tm.tm_attention_bwd}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_train(label: str, config: str, batch: int, compare_batch: int, seed0: int,
                per_step: dict, per_eval: dict, kernel_note: str, overrides=(),
                compare: bool = True) -> dict:
    """Drive one MAE pretraining configuration at full width; returns every
    kernel's launches in the train and eval runs. ``overrides`` are config
    keys and values merged over the YAML. ``per_step`` and ``per_eval`` are
    the launches expected of each kernel per train step and per eval batch (0
    for a kernel not named); the fused Lion update adds one B6 launch per
    trainable tensor per step. ``compare_batch`` is the batch of the
    kernel-vs-plain attention step, run when ``compare``. That step checks
    every trainable gradient (the kernels run in the encoder and the decoder
    of both MAE configurations)."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.data.augment import apply_mae_augment, draw_mae_augment
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.engines import mae_engine

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / config))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16", *overrides])
    total = TRAIN_BATCHES + 5  # the epoch, then the timed steps
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    state, _ = mae_engine.create_train_state(cfg, total, WARMUP_STEPS, seed=0, device=dev)
    n_params = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
    n_tensors = sum(p.requires_grad for p in state.model.parameters())
    optimizer = type(state.optimizer).__name__
    if optimizer == "Lion" and cfg.TRAIN.LION_FUSED:
        per_step = {**per_step, "lion_update": n_tensors}
    wires = [head_phantoms(seed0 + i, batch, cfg.MAE.INPUT_SIZE)
             for i in range(TRAIN_BATCHES + VAL_BATCHES)]
    torch.cuda.synchronize()
    m = cfg.MAE
    print(f"{label} set-up: MAE from {config} (encoder {m.ENCODER_DEPTH}x"
          f"{m.ENCODER_EMBED_DIM}/{m.ENCODER_NUM_HEADS} heads, decoder {m.DECODER_DEPTH}x"
          f"{m.DECODER_EMBED_DIM}/{m.DECODER_NUM_HEADS} heads, {m.INPUT_SIZE}^3 patch "
          f"{m.PATCH_SIZE}, {m.IN_CHANS} channels), {n_params} trainable parameters in "
          f"{n_tensors} tensors, seed 0, bf16 compute, {optimizer} (TRAIN.GRAD_CLIP "
          f"{cfg.TRAIN.GRAD_CLIP}, LION_FUSED {cfg.TRAIN.LION_FUSED}); {len(wires)} synthetic "
          f"hu16 batches of "
          f"{list(wires[0].shape)} int16 in {time.perf_counter() - t0:.2f} s", flush=True)

    g = mae_engine.step_generator(dev, 7, 0, 0)
    n_tok = int(np.prod(state.model.grid_size))
    if compare:  # kernel against plain attention on one step, same weights and randomness
        draws = {"noise": torch.rand((compare_batch, n_tok), generator=g, device=dev),
                 "augment": draw_mae_augment(compare_batch, g, dev)}
        wire0 = torch.from_numpy(wires[0][:compare_batch]).to(dev)
        compare = {torch.bfloat16: compare_backends(state.model, wire0, cfg, draws,
                                                    torch.bfloat16, label)}
        m32 = mae_engine.build_mae_model(cfg, dtype=torch.float32).to(dev)
        m32.load_state_dict(state.model.state_dict())
        for n, p in m32.named_parameters():
            p.requires_grad_(dict(state.model.named_parameters())[n].requires_grad)
        compare[torch.float32] = compare_backends(m32, wire0, cfg, draws, torch.float32, label)
        del m32
        torch.cuda.empty_cache()

    # The main path's run: every kernel count is 0 just before it.
    log = logging.getLogger(f"chip_smoke.{label}")
    before = {n: p.detach().clone() for n, p in state.model.named_parameters() if p.requires_grad}
    step = mae_engine.make_train_step(augment=True, config=cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    state, stats = mae_engine.train_one_epoch(cfg, state, step, wires[:TRAIN_BATCHES], 0, 0, 1,
                                              logger=log)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    train_launches = launches()
    peak = torch.cuda.max_memory_allocated()
    zero_launches()
    val = mae_engine.val_one_epoch(cfg, state, mae_engine.make_eval_step(cfg),
                                   wires[TRAIN_BATCHES:], 0, 0, 1, logger=log)
    val_launches = launches()

    check(state.step == TRAIN_BATCHES and math.isfinite(stats["loss"])
          and math.isfinite(val["loss"]), f"train/val losses not finite: {stats} {val}")
    want_train = {n: per_step.get(n, 0) * TRAIN_BATCHES for n in train_launches}
    want_eval = {n: per_eval.get(n, 0) * VAL_BATCHES for n in val_launches}
    check(train_launches == want_train,
          f"training launches {train_launches}; expected {want_train}")
    check(val_launches == want_eval, f"eval launches {val_launches}; expected {want_eval}")
    params = dict(state.model.named_parameters())
    unmoved = [n for n, p in before.items() if torch.equal(p, params[n].detach())]
    check(not unmoved, f"parameters that did not move in {TRAIN_BATCHES} steps: {unmoved[:5]}")
    print(f"{label}: train_one_epoch over {TRAIN_BATCHES} batches of {batch} in "
          f"{epoch_s:.2f} s, mean loss {stats['loss']:.6f}, mean lr {stats['lr']:.3e}; "
          f"val_one_epoch over {VAL_BATCHES} batch: loss {val['loss']:.6f}; all finite; every "
          f"trainable tensor moved; launches train {train_launches} = {per_step} per step, "
          f"eval {val_launches} = {per_eval} per batch, exactly; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)", flush=True)

    # Step time: host clock around synchronised steps (warm).
    times = []
    for i in range(5):
        wire = torch.from_numpy(wires[i % TRAIN_BATCHES]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, wire, 0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)

    # Breakdown (CUDA events): input, forward+backward, optimizer.
    model = state.model
    wire = torch.from_numpy(wires[0]).to(dev)
    aug = draw_mae_augment(batch, g, dev)
    noise = torch.rand((batch, n_tok), generator=g, device=dev)
    prep_ms = cuda_ms(lambda: apply_mae_augment(
        wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS), aug), iters=5, warmup=1)
    vols = apply_mae_augment(wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS), aug)

    def fwd_bwd():
        model(vols, noise=noise)[0].backward()

    fb_ms = cuda_ms(fwd_bwd, iters=5, warmup=1)
    lion = lion_step_checks(state) if optimizer == "Lion" and cfg.TRAIN.LION_FUSED else None
    opt_ms = cuda_ms(state.optimizer.step, iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state.optimizer.step()
    torch.cuda.synchronize()
    opt_host_ms = (time.perf_counter() - t0) * 1e3
    state.optimizer.zero_grad(set_to_none=True)
    print(f"{label}: median step {step_ms:.2f} ms over {len(times)} synchronised steps "
          f"({', '.join(f'{t:.1f}' for t in times)}), {batch / step_ms * 1e3:.2f} volumes/s; "
          f"breakdown: window+augment {prep_ms:.2f} ms, forward+backward {fb_ms:.2f} ms "
          f"(of which {kernel_note}, from the kernel timings), {optimizer} step {opt_ms:.2f} ms "
          f"(CUDA events; {opt_host_ms:.2f} ms on the host clock, synchronised)", flush=True)
    profile_steps(lambda: step(state, wire, 0), step_ms)
    return {"train": train_launches, "eval": val_launches, "compare": compare, "lion": lion,
            "volumes_per_s": batch / step_ms * 1e3}


CLI_SCANS = 32          # distinct synthetic head scans
CLI_ROWS = {"train": 4, "val": 2, "test": 2}  # manifest rows per scan: 2 steps, 1 eval batch
CLI_DEVICE_CHECK = 8    # scans held device-vs-native in both orders


def check_cli_launches(result: dict, label: str, per_step: dict, per_eval: dict) -> dict:
    """Exactly ``per_step`` launches per train step and ``per_eval`` per eval
    batch, nothing else; returns the run's training and eval launches of B1
    and B2."""
    total = {"cli training": {"flash_attention_fwd": 0, "flash_attention_bwd": 0},
             "cli eval": {"flash_attention_fwd": 0, "flash_attention_bwd": 0}}
    evals = [e["val"] for e in result["epochs"] if "val" in e] + [result["test"]]
    for stats, path, per in ([(e["train"], "cli training", "steps") for e in result["epochs"]]
                             + [(v, "cli eval", "batches") for v in evals]):
        n = stats[per]
        want = {k: 0 for k in stats["launches"]}
        for k, v in (per_step if path == "cli training" else per_eval).items():
            want[k] = v * n
        check(n > 0 and stats["launches"] == want,
              f"{label} {path}: launches {stats['launches']} over {n} {per}; expected {want}")
        for k in total[path]:
            total[path][k] += stats["launches"][k]
    return total


def device_vs_native(workdir: Path, scans: list, seeds: list, roi: tuple, card: str) -> None:
    """The cache's device backend ("training" and "hu16" orders of
    ``DevicePreprocessor``) on the card, held three ways:

    * against the native decoder on the same heads (``seeds``) written at 1.0 mm, within
      the JAX tests' native-vs-scipy limits (tests/test_native_loader.py:37-38:
      max < 2e-2, mean < 1e-4; hu16 within 1 step);
    * on the 0.5 x 0.5 x 1.0 mm scans, against the same ``DevicePreprocessor``
      on the CPU (the plain PyTorch ops; its resample is scipy's zoom by
      construction): <= 1e-4 in the windowed order, hu16 within 1 step;
    * on the 0.5 mm scans against the native decoder: printed, not held. The
      JAX package's native resample leaves the spline prefilter on an axis
      it does not zoom (here z), and the port's native output is the JAX
      package's byte for byte; see ROADMAP.md C.6 and
      tests/test_torch_port_data.py::test_jax_native_keeps_the_prefilter_on_an_unzoomed_axis."""
    from headct_foundation_tpu_torch.data import datasets
    from headct_foundation_tpu_torch.data.device_preprocess import DevicePreprocessor
    from headct_foundation_tpu_torch.data.native_loader import decode_native
    from headct_foundation_tpu_torch.data.transforms import hu16_encode

    def caches(backend_device):
        if backend_device is not None:
            os.environ["HEADCT_DEVICE_CACHE"] = "1"
        try:
            return {w: datasets.DiskCache(None, roi, 3, wire=w, device=backend_device)
                    for w in ("windowed", "hu16")}
        finally:
            os.environ.pop("HEADCT_DEVICE_CACHE", None)

    def errors(got, want, paths):
        """(max, worst mean) windowed error and max hu16 steps over ``paths``."""
        mx = mean = 0.0
        steps = 0
        for p in paths:
            d = np.abs(got["windowed"].load(p).astype(np.float32)
                       - want["windowed"].load(p).astype(np.float32))
            mx, mean = max(mx, float(d.max())), max(mean, float(d.mean()))
            steps = max(steps, int(np.abs(got["hu16"].load(p).astype(np.int32)
                                          - want["hu16"].load(p).astype(np.int32)).max()))
        return mx, mean, steps

    on_card, native = caches("cuda"), caches(None)
    iso = write_scans(workdir, seeds, spacing=(1.0, 1.0, 1.0), prefix="head1mm_")
    t0 = time.perf_counter()
    mx, mean, steps = errors(on_card, native, iso)
    ms = (time.perf_counter() - t0) / len(iso) * 1e3
    print(f"cli: device backend on the card vs the native decoder, {len(iso)} heads at 1.0 mm: "
          f"windowed max_abs_err {mx:.3e} (limit 2e-2), worst mean {mean:.3e} (limit 1e-4); "
          f"hu16 max {steps} steps (limit 1); {ms:.1f} ms per scan for both backends and wires "
          f"| {card}", flush=True)
    check(mx < 2e-2 and mean < 1e-4 and steps <= 1,
          "the device preprocessing orders disagree with the native decoder at 1.0 mm")

    worst = {"training": 0.0, "hu16": 0}
    for order in worst:
        card_prep = DevicePreprocessor(roi, 3, "cuda", order=order, decoder=decode_native)
        cpu_prep = DevicePreprocessor(roi, 3, "cpu", order=order, decoder=decode_native)
        for p in scans:
            a, b = card_prep(p).cpu().numpy(), cpu_prep(p).numpy()
            if order == "hu16":
                a, b = hu16_encode(a).astype(np.int32), hu16_encode(b).astype(np.int32)
            worst[order] = max(worst[order], np.abs(a - b).max().item())
    print(f"cli: device backend on the card vs on the CPU, {len(scans)} scans at 0.5x0.5x1.0 mm: "
          f"\"training\" max_abs_err {worst['training']:.3e} (limit 1e-4), \"hu16\" max "
          f"{worst['hu16']} steps (limit 1) | {card}", flush=True)
    check(worst["training"] <= 1e-4 and worst["hu16"] <= 1,
          "the device preprocessing on the card disagrees with its CPU run")
    mx, mean, steps = errors(on_card, native, scans)
    print(f"cli: device backend vs the native decoder at 0.5x0.5x1.0 mm (not held: the native "
          f"resample keeps the spline prefilter on the unzoomed z axis, ROADMAP.md C.6): windowed max_abs_err {mx:.3e}, worst mean {mean:.3e}; hu16 max "
          f"{steps} steps | {card}", flush=True)


def _leaves(tree, prefix=""):
    """(path, array) of each leaf of a nested dict."""
    if not isinstance(tree, dict):
        yield prefix, np.asarray(tree)
        return
    for k, v in tree.items():
        yield from _leaves(v, f"{prefix}/{k}")


def run_pretrain_cli(label: str, module: str, config: str, opts: list, saved_dir: Path,
                     per_step: dict, per_eval: dict, card: str, rate_note: str = "") -> tuple:
    """The pretraining CLI ``module`` on ``config`` for 2 epochs, validating
    each: exit 0, ``latest_`` and ``best_`` written, finite losses, no scan
    served as a placeholder, exactly ``per_step`` launches per train step and
    ``per_eval`` per eval batch; prints each epoch. Returns the CLI's result,
    its launches by path, its wall seconds and the files written."""
    from headct_foundation_tpu_torch.config import default_config

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / config))
    name, batch = cfg.MODEL.SAVE_NAME, int(cfg.DATA.BATCH_SIZE)
    _, first, wall = run_cli(["--cfg", config, "--device", "cuda", "--opts", *opts,
                              "TRAIN.MAX_EPOCHS", "2"], label, module=module)
    saved = sorted(os.listdir(saved_dir))
    check(saved == sorted([f"best_{name}", f"latest_{name}"]), f"{label}: checkpoints {saved}")
    losses = ([e["train"]["loss"] for e in first["epochs"]]
              + [e["val"]["loss"] for e in first["epochs"]] + [first["test"]["loss"]])
    check(all(math.isfinite(x) for x in losses), f"{label}: losses not finite: {losses}")
    check(first["placeholders"] == 0,
          f"{label}: {first['placeholders']} scans were served as placeholders")
    launches = check_cli_launches(first, label, per_step, per_eval)
    for e in first["epochs"]:
        t = e["train"]
        print(f"{label}: epoch {e['epoch'] + 1}: {t['steps']} steps of batch {batch} in "
              f"{e['seconds']:.2f} s ({t['steps'] * batch / e['seconds']:.2f} volumes/s"
              f"{rate_note}), iter_time {t['iter_time'] * 1e3:.1f} ms, data_time "
              f"{t['data_time'] * 1e3:.1f} ms per step, train loss {t['loss']:.6f}, val loss "
              f"{e['val']['loss']:.6f} over {e['val']['batches']} batch | {card}", flush=True)
    return first, launches, wall, saved


def check_restored(label: str, latest: Path, payload: dict, got: dict, epoch: int, step: int,
                   first: dict) -> int:
    """The state restored from ``latest`` beside the file: each tree of
    ``got`` equals ``payload``'s under the same key bit for bit, at epoch
    index 1 and the step count of the first run's two epochs. Returns the
    number of leaves held."""
    want = dict(_leaves({k: payload[k] for k in got}))
    got = dict(_leaves(got))
    differ = [k for k in want if k not in got or got[k].dtype != want[k].dtype
              or not np.array_equal(got[k], want[k])]
    check(got.keys() == want.keys() and not differ and epoch == 1
          and step == payload["step"] == 2 * first["epochs"][0]["train"]["steps"],
          f"{label}: the restored state differs from {latest.name}: {differ[:5]} (epoch {epoch}, "
          f"step {step})")
    return len(want)


def resume_cli(label: str, module: str, config: str, opts: list, latest: Path, said: str,
               per_step: dict, per_eval: dict, launches: dict, card: str) -> None:
    """The CLI resumed from ``latest`` with ``TRAIN.MAX_EPOCHS 2``: its log
    says ``said`` and it re-runs epoch 1 from the saved index, with no
    placeholder and the exact launches, which are added to ``launches``."""
    log, resumed, wall = run_cli(["--cfg", config, "--device", "cuda", "--opts", *opts,
                                  "TRAIN.MAX_EPOCHS", "2", "--model_load_path", str(latest)],
                                 f"{label} resume", module=module)
    check(f"{said} from {latest} at epoch 1" in log and resumed["start_epoch"] == 1
          and [e["epoch"] for e in resumed["epochs"]] == [1],
          f"{label} resume: no resume at the saved epoch index 1: {resumed['epochs']}")
    check(resumed["placeholders"] == 0,
          f"{label} resume: {resumed['placeholders']} scans were served as placeholders")
    more = check_cli_launches(resumed, f"{label} resume", per_step, per_eval)
    for path in launches:
        for k in launches[path]:
            launches[path][k] += more[path][k]
    print(f"{label}: resume from {latest.name} with TRAIN.MAX_EPOCHS 2: '{said} from ... at "
          f"epoch 1', epochs {[e['epoch'] for e in resumed['epochs']]} re-run from the saved "
          f"index, test loss {resumed['test']['loss']:.6f}, exit 0 in {wall:.2f} s; launches "
          f"{json.dumps(more)} | {card}", flush=True)


def phase_cli(workdir: Path, card: str, train_volumes_per_s: float) -> dict:
    """The MAE pretraining CLI end to end at full width on the shipped
    config; returns the B1 and B2 launches of its runs by path."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.data import datasets, native_loader
    from headct_foundation_tpu_torch.engines import mae_engine
    from headct_foundation_tpu_torch.utils import checkpoint, torch_interop

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / MAE_CONFIG))
    roi, name = tuple(cfg.MODEL.ROI), cfg.MODEL.SAVE_NAME
    t0 = time.perf_counter()
    native_loader.get_lib()
    built = (f"g++ {native_loader.build_seconds:.2f} s" if native_loader.build_seconds is not None
             else "already built")
    flags = native_loader.library_path().with_suffix(".flags").read_text().strip()
    print(f"cli: native decoder {native_loader.library_path().relative_to(ROOT)} ({built}; "
          f"{flags}) in {time.perf_counter() - t0:.2f} s | {card}", flush=True)

    seeds = [1000 + i for i in range(CLI_SCANS)]
    scans = write_scans(workdir, seeds)
    for split, rows in CLI_ROWS.items():
        (workdir / f"{split}.csv").write_text("img_path\n" + "".join(
            f"{p}\n" for _ in range(rows) for p in scans))
    t0 = time.perf_counter()
    uncached = datasets.DiskCache(None, roi, 3)
    for p in scans:
        uncached.load(p)
    per_scan_ms = (time.perf_counter() - t0) / len(scans) * 1e3
    print(f"cli: {CLI_SCANS} synthetic head scans (256x256x40 int16, 0.5x0.5x1.0 mm, .nii.gz); "
          f"native preprocessing to the windowed 3x{roi[0]}^3 float16 wire {per_scan_ms:.1f} ms "
          f"per scan on one thread (host clock) | {card}", flush=True)

    device_vs_native(workdir, scans[:CLI_DEVICE_CHECK], seeds[:CLI_DEVICE_CHECK], roi, card)

    opts = ["DATA.TRAIN_CSV_PATH", str(workdir / "train.csv"),
            "DATA.VAL_CSV_PATH", str(workdir / "val.csv"),
            "DATA.TEST_CSV_PATH", str(workdir / "test.csv"),
            "DATA.CACHE_DIR", str(workdir / "cache"), "MODEL.DIR", str(workdir / "model_saved"),
            "LOG.OUTPUT_DIR", str(workdir / "log"), "OUTPUT", str(workdir / "out"),
            "TRAIN.VAL_EVERY", "1"]
    mae_step = {"flash_attention_fwd": MAE_BLOCKS, "flash_attention_bwd": MAE_BLOCKS}
    mae_eval = {"flash_attention_fwd": MAE_BLOCKS}
    first, launches, wall, saved = run_pretrain_cli(
        "cli", "main_pretrain_mae", MAE_CONFIG, opts, workdir / "model_saved", mae_step,
        mae_eval, card, rate_note=f"; the train phase's step at batch {TRAIN_BATCH}: "
        f"{train_volumes_per_s:.2f} volumes/s")
    peak = first["peak_memory_bytes"]
    print(f"cli: python -m headct_foundation_tpu_torch.main_pretrain_mae --cfg {MAE_CONFIG} "
          f"(2 epochs) exit 0 in {wall:.2f} s; {saved} written; 0 placeholders; test loss "
          f"{first['test']['loss']:.6f}; launches {json.dumps(launches)} = {MAE_BLOCKS} B1 + "
          f"{MAE_BLOCKS} B2 per train step, {MAE_BLOCKS} B1 per eval batch; peak memory "
          f"{(peak or 0) / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) | {card}", flush=True)
    print(json.dumps({"cli_launches": launches}), flush=True)

    # the saved state restored beside the file: bit for bit; then the writes timed
    latest = workdir / "model_saved" / f"latest_{name}"
    payload = checkpoint.load_checkpoint(str(latest))
    state, _ = mae_engine.create_train_state(cfg, 10, 1, seed=7, device="cuda")
    state, epoch, _ = checkpoint.restore_state(state, payload)
    held = check_restored("cli", latest, payload, {
        "params": torch_interop.jax_tree_from_state_dict(state.model.state_dict()),
        "opt_state": torch_interop.opt_state_to_jax(state.optimizer, state.model, cfg,
                                                    state.step)}, epoch, state.step, first)
    nbytes = latest.stat().st_size
    times = {}
    for mode in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(state, epoch, 1.0, str(workdir / "timing"), "ckpt.pt",
                                   async_save=mode)
        returned = time.perf_counter() - t0
        checkpoint.wait_for_saves()
        times[mode] = (returned, time.perf_counter() - t0)
    print(f"cli: {latest.name} ({nbytes / 2**20:.1f} MiB) restored beside the file: "
          f"{held} parameter and optimizer leaves equal bit for bit, step {state.step}, "
          f"epoch {epoch}; checkpoint write sync {times[False][1] * 1e3:.0f} ms, async returns in "
          f"{times[True][0] * 1e3:.0f} ms and is written in {times[True][1] * 1e3:.0f} ms "
          f"(host clock) | {card}", flush=True)
    del state, payload
    torch.cuda.empty_cache()

    resume_cli("cli", "main_pretrain_mae", MAE_CONFIG, opts, latest, "Resumed", mae_step,
               mae_eval, launches, card)
    return launches


def dino_compare(cfg, state, wire, label: str, skip=(), dropout_seed=None) -> dict:
    """One DINO step at DINO_COMPARE_BATCH volumes of ``wire`` with the
    kernels against the plain attention: the same weights, crops, teacher
    and centre, in bf16 (the state's networks) and in float32 (copies), over
    every trainable gradient but those named in ``skip``. Both networks run
    in train mode, as the train step runs them (a BatchNorm head normalises
    with its batch's statistics), but for the bf16 gradients of a BatchNorm
    head: train-mode statistics over a few random-init CLS features turn
    bf16 roundings into the signal (on an NVIDIA H100 80GB HBM3: the loss
    within its limit, the gradients at cosine 0.17, though B1/B2 agree with
    their plain versions), so in bf16
    the loss is held on the batch's statistics and the loss and gradients
    on the running ones, as the downstream phase holds its head.
    ``dropout_seed``: both runs draw the backbones' dropout masks from
    generators seeded alike from it (the teacher's and the student's)."""
    from headct_foundation_tpu_torch.data.augment import apply_dino_multicrop, draw_dino_multicrop
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.engines import dino_engine, mae_engine
    from headct_foundation_tpu_torch.losses.dino_loss import dino_loss
    from headct_foundation_tpu_torch.models.multicrop import DINOModel
    from headct_foundation_tpu_torch.ops import attention as port_attn
    from headct_foundation_tpu_torch.optim.optimizers import without_key_bias

    dev, roi = state.device, tuple(cfg.MODEL.ROI)
    ncrops, in_chans = int(cfg.DINO.LOCAL_CROP_NUM) + 2, int(cfg.VIT.IN_CHANS)
    g = mae_engine.step_generator(dev, 7, 0, 0)
    draws = draw_dino_multicrop(DINO_COMPARE_BATCH, g, dev, roi[0], **dino_engine.crop_args(cfg))
    wire0 = torch.from_numpy(wire[:DINO_COMPARE_BATCH]).to(dev)
    temp = float(state.temp_sched[0])
    trainable = {n for n, p in state.student.named_parameters() if p.requires_grad}

    def loss_and_grads_of(s_model, t_model, running: bool = False):
        names = [n for n, p in s_model.named_parameters() if p.requires_grad and n not in skip]

        def run(backend):
            prev = port_attn.set_attention_backend(backend)
            try:
                s_model.train()
                t_model.train()
                if running:  # the heads' BatchNorms on their running statistics
                    s_model.head.eval()
                    t_model.head.eval()
                s_model.zero_grad(set_to_none=True)
                crops = apply_dino_multicrop(wire_to_compute(wire0, cfg, in_chans), draws, roi)
                t_drop, s_drop = ((None, None) if dropout_seed is None else
                                  (mae_engine.step_generator(dev, dropout_seed, k)
                                   for k in (101, 102)))
                with torch.no_grad():
                    t_out = t_model(crops[:2], t_drop)
                loss = dino_loss(s_model(crops, s_drop), t_out, state.center, temp, ncrops)
                loss.backward()
                params = dict(s_model.named_parameters())
                grads = {n: without_key_bias(n, params[n].grad.detach().clone()) for n in names}
                s_model.zero_grad(set_to_none=True)
                return loss.item(), grads
            finally:
                port_attn.set_attention_backend(prev)

        return run

    bn = bool(cfg.DINO.USE_BN)
    if bn:  # the bf16 loss on the batch's statistics, as the step runs
        run = loss_and_grads_of(state.student, state.teacher)
        (loss_k, _), (loss_p, _) = run("kernel"), run("plain")
        rel, tol = abs(loss_k - loss_p) / abs(loss_p), TRAIN_TOL[torch.bfloat16]["loss_rel"]
        print(f"{label}: kernel vs plain attention, one step at bfloat16 with the head's "
              f"BatchNorm on the batch's statistics: loss {loss_k:.6f} vs {loss_p:.6f} "
              f"(relative {rel:.3e}, tolerance {tol}) {'ok' if rel <= tol else 'FAILED'}",
              flush=True)
        check(rel <= tol, f"kernel and plain attention disagree on the {label} loss at bf16")
    compare = {torch.bfloat16: hold_backends(
        loss_and_grads_of(state.student, state.teacher, running=bn), torch.bfloat16,
        f"{label} (head BatchNorm on running statistics)" if bn else label, "trainable")}
    f32 = [DINOModel(dino_engine.build_vit_model(cfg, torch.float32),
                     dino_engine.build_dino_head(cfg, torch.float32)).to(dev) for _ in range(2)]
    for m32, src in zip(f32, (state.student, state.teacher)):
        m32.load_state_dict(src.state_dict())
        for n, p in m32.named_parameters():
            p.requires_grad_(n in trainable and src is state.student)
    compare[torch.float32] = hold_backends(loss_and_grads_of(*f32), torch.float32, label,
                                           "trainable")
    del f32
    torch.cuda.empty_cache()
    return compare


def phase_dino(card: str) -> dict:
    """DINO pretraining at full width on configs/dino/dino_HeadCT.yaml as
    shipped, on batches of synthetic hu16 phantoms; returns the launches of
    its train and eval runs and its timings."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.data.augment import apply_dino_multicrop, draw_dino_multicrop
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.engines import dino_engine, mae_engine
    from headct_foundation_tpu_torch.losses.dino_loss import dino_loss

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / DINO_CONFIG))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16"])
    depth, batch, roi = int(cfg.VIT.NUM_LAYERS), int(cfg.DATA.BATCH_SIZE), tuple(cfg.MODEL.ROI)
    ncrops, in_chans = int(cfg.DINO.LOCAL_CROP_NUM) + 2, int(cfg.VIT.IN_CHANS)
    per_step = {"flash_attention_fwd": 2 * depth, "flash_attention_bwd": depth}
    per_eval = {"flash_attention_fwd": 2 * depth}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # lr(0) = 0 under the one warm-up step; the 5 timed steps follow the two epochs
    state = dino_engine.create_train_state(cfg, 2 * DINO_EPOCH_BATCHES + 10, 1,
                                           DINO_EPOCH_BATCHES, seed=0, device=dev)
    student, teacher = state.student, state.teacher
    trainable = {n: p for n, p in student.named_parameters() if p.requires_grad}
    wires = [head_phantoms(400 + i, batch, roi[0]) for i in range(DINO_EPOCH_BATCHES)]
    torch.cuda.synchronize()
    v, d = cfg.VIT, cfg.DINO
    print(f"dino set-up: {DINO_CONFIG} (ViT {v.NUM_LAYERS}x{v.HIDDEN_SIZE}/{v.NUM_HEADS} heads, "
          f"{v.NUM_REGISTER_TOKENS} registers, {v.INPUT_SIZE}^3 patch {v.PATCH_SIZE}; head "
          f"{d.HEAD_N_LAYERS} x {d.HEAD_HIDDEN_DIM} -> {d.BOTTLENECK_DIM} -> "
          f"{d.HEAD_N_PROTOTYPES}; 2 global + {d.LOCAL_CROP_NUM} local crops to {roi}), "
          f"{sum(p.numel() for p in trainable.values())} trainable parameters in "
          f"{len(trainable)} tensors, seed 0, bf16 compute, "
          f"{type(state.optimizer).__name__} (WD {cfg.TRAIN.WEIGHT_DECAY} -> "
          f"{cfg.TRAIN.WEIGHT_DECAY_END}, teacher momentum {d.MOMENTUM_TEACHER} -> "
          f"{d.MOMENTUM_TEACHER_END}); {len(wires)} synthetic hu16 batches of "
          f"{list(wires[0].shape)} int16 in {time.perf_counter() - t0:.2f} s", flush=True)

    # kernel against plain attention on one step, same weights, crops and teacher
    compare = dino_compare(cfg, state, wires[0], "dino")
    g = mae_engine.step_generator(dev, 7, 0, 0)
    temp = float(state.temp_sched[0])

    # The main path: epoch 0 (last layer frozen), epoch 1, one eval batch; every
    # kernel count is 0 just before each and read just after.
    log = logging.getLogger("chip_smoke.dino")
    step, eval_step = dino_engine.make_train_step(cfg), dino_engine.make_eval_step(cfg)
    snap = lambda model: {n: p.detach().clone() for n, p in model.named_parameters()}
    before_s, before_t = snap(student), snap(teacher)
    torch.cuda.reset_peak_memory_stats()
    epochs, runs = [], {}
    for epoch in range(2):
        zero_launches()
        t0 = time.perf_counter()
        state, stats = dino_engine.train_one_epoch(cfg, state, step, wires, 0, epoch, 2,
                                                   logger=log)
        torch.cuda.synchronize()
        runs[f"epoch {epoch}"] = launches()
        epochs.append((stats, time.perf_counter() - t0, snap(student), snap(teacher)))
    peak = torch.cuda.max_memory_allocated()
    zero_launches()
    val = dino_engine.val_one_epoch(cfg, state, eval_step, wires[:1], 0, 1, 2, logger=log)
    runs["eval"] = launches()

    v_name = "head.last_layer.weight_v"
    (s0, sec0, after0, t_after0), (s1, sec1, after1, t_after1) = epochs
    losses = [s0["loss"], s1["loss"], val["loss"]]
    check(all(math.isfinite(x) for x in losses) and state.step == 2 * DINO_EPOCH_BATCHES,
          f"dino: losses not finite or steps missing: {losses}, step {state.step}")
    check(torch.equal(after0[v_name], before_s[v_name])
          and not torch.equal(after1[v_name], after0[v_name]),
          "dino: last_layer.weight_v not bit-frozen in epoch 0, or unmoved in epoch 1")
    unmoved = [n for n in trainable if n != v_name and torch.equal(after0[n], before_s[n])]
    t_unmoved = [n for n in trainable if torch.equal(t_after1[n], before_t[n])]
    check(not unmoved and not t_unmoved,
          f"dino: student tensors unmoved in epoch 0 {unmoved[:5]}, teacher tensors unmoved "
          f"{t_unmoved[:5]}")
    check(bool(torch.isfinite(state.center).all()) and bool(state.center.abs().sum() > 0),
          "dino: the centre is not finite, or never moved")
    want = {"epoch 0": {n: per_step.get(n, 0) * DINO_EPOCH_BATCHES for n in runs["epoch 0"]},
            "epoch 1": {n: per_step.get(n, 0) * DINO_EPOCH_BATCHES for n in runs["epoch 1"]},
            "eval": {n: per_eval.get(n, 0) for n in runs["eval"]}}
    check(runs == want, f"dino: launches {runs}; expected {want}")
    print(f"dino: train_one_epoch epoch 0 (last layer frozen) over {DINO_EPOCH_BATCHES} batches "
          f"of {batch} in {sec0:.2f} s, mean loss {s0['loss']:.6f}; epoch 1 in {sec1:.2f} s, mean "
          f"loss {s1['loss']:.6f}, mean lr {s1['lr']:.3e}, wd {s1['wd']:.6f}; val_one_epoch "
          f"over 1 batch: loss {val['loss']:.6f}; all finite; last_layer.weight_v bit-equal "
          f"after epoch 0 and moved in epoch 1, every other trainable tensor and the teacher "
          f"moved, the centre finite (max |c| {state.center.abs().max().item():.3e}); launches "
          f"{json.dumps(runs)} = {per_step} per step, {per_eval} per eval batch, exactly; peak "
          f"memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) | {card}", flush=True)

    # Step time: host clock around synchronised steps (warm), epoch 1's settings.
    momentum = float(state.momentum_sched[0])
    times = []
    for i in range(5):
        wire = torch.from_numpy(wires[i % len(wires)]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, wire, 0, momentum, temp, False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)

    # Breakdown (CUDA events): crops, teacher, student forward+backward, optimizer, EMA.
    wire = torch.from_numpy(wires[0]).to(dev)
    draws = draw_dino_multicrop(batch, g, dev, roi[0], **dino_engine.crop_args(cfg))
    crop = lambda: apply_dino_multicrop(wire_to_compute(wire, cfg, in_chans), draws, roi)
    crop_ms = cuda_ms(crop, iters=5, warmup=1)
    crops = crop()
    with torch.no_grad():
        t_out = teacher(crops[:2])

    def teacher_fwd():
        with torch.no_grad():
            teacher(crops[:2])

    def student_fwd_bwd():
        dino_loss(student(crops), t_out, state.center, temp, ncrops).backward()

    teacher_ms = cuda_ms(teacher_fwd, iters=5, warmup=1)
    student_ms = cuda_ms(student_fwd_bwd, iters=5, warmup=1)
    opt_ms = cuda_ms(state.optimizer.step, iters=5, warmup=1)
    state.optimizer.zero_grad(set_to_none=True)
    ema_ms = cuda_ms(lambda: dino_engine.update_teacher(teacher, student, momentum), iters=5,
                     warmup=1)
    print(f"dino: median step {step_ms:.2f} ms over {len(times)} synchronised steps "
          f"({', '.join(f'{t:.1f}' for t in times)}), {batch / step_ms * 1e3:.2f} volumes/s; "
          f"breakdown (CUDA events): window+multi-crop {crop_ms:.2f} ms, teacher forward "
          f"{teacher_ms:.2f} ms, student forward+backward with the loss {student_ms:.2f} ms, "
          f"AdamW step {opt_ms:.2f} ms, teacher EMA {ema_ms:.2f} ms | {card}", flush=True)
    profile_steps(lambda: step(state, wire, 0, momentum, temp, False), step_ms)
    total = {n: runs["epoch 0"][n] + runs["epoch 1"][n] for n in runs["epoch 0"]}
    return {"train": total, "eval": runs["eval"], "compare": compare, "step_ms": step_ms,
            "volumes_per_s": batch / step_ms * 1e3, "peak_bytes": peak}


DINO_BN_STEPS = 2  # train steps of the BatchNorm head at the shipped batch


def phase_dino_bn(card: str, shipped_step_ms: float) -> dict:
    """The DINO step with the BatchNorm head (DINO.USE_BN True, otherwise
    configs/dino/dino_HeadCT.yaml as shipped): the kernels against the plain
    attention on one step at DINO_COMPARE_BATCH volumes, in bf16 and float32,
    over every trainable gradient but ``dino_engine.bn_rounding_only``'s
    (0 but for rounding under a train-mode BatchNorm); then DINO_BN_STEPS
    train steps at the batch of 64 with exactly 24 B1 + 12 B2 a step, finite
    losses, both heads' running statistics moved and apart; then a
    checkpoint written and restored with both statistics bit for bit; then
    the median of 5 synchronised steps beside ``shipped_step_ms``, the dino
    phase's. Returns the launches of its train steps and the median."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines import dino_engine
    from headct_foundation_tpu_torch.models.layers import TorchBatchNorm
    from headct_foundation_tpu_torch.utils import checkpoint

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / DINO_CONFIG))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16", "DINO.USE_BN", True])
    depth, batch, roi = int(cfg.VIT.NUM_LAYERS), int(cfg.DATA.BATCH_SIZE), tuple(cfg.MODEL.ROI)
    per_step = {"flash_attention_fwd": 2 * depth, "flash_attention_bwd": depth}
    dev = torch.device("cuda")
    state = dino_engine.create_train_state(cfg, 10, 1, DINO_BN_STEPS, seed=0, device=dev)
    skip = dino_engine.bn_rounding_only(cfg)
    wires = [head_phantoms(450 + i, batch, roi[0]) for i in range(DINO_BN_STEPS)]
    bn = [n for n, m in state.student.head.mlp.named_children()
          if isinstance(m, TorchBatchNorm)]
    print(f"dino-bn set-up: {DINO_CONFIG} with DINO.USE_BN True: head [Linear, BatchNorm, "
          f"GELU] x {int(cfg.DINO.HEAD_N_LAYERS) - 1} (BatchNorms at mlp.{', mlp.'.join(bn)}), "
          f"seed 0, bf16 compute; left out of the gradient comparison as 0 but for "
          f"rounding: {[n for n in skip if not n.endswith('running_mean')]}", flush=True)
    compare = dino_compare(cfg, state, wires[0], "dino-bn", skip=skip)

    stats = lambda model: {k: v.detach().clone() for k, v in model.state_dict().items()
                           if k.endswith(("running_mean", "running_var"))}
    s0, t0_stats = stats(state.student), stats(state.teacher)
    step = dino_engine.make_train_step(cfg)
    momentum, temp = float(state.momentum_sched[0]), float(state.temp_sched[0])
    losses, times, runs = [], [], []
    for i, wire in enumerate(wires):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, torch.from_numpy(wire).to(dev), 0, momentum, temp, False)
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
        runs.append(launches())
    want = {n: per_step.get(n, 0) for n in runs[0]}
    check(all(r == want for r in runs), f"dino-bn: launches {runs}; expected {want} a step")
    check(all(math.isfinite(x) for x in losses), f"dino-bn: losses {losses}")
    s1, t1 = stats(state.student), stats(state.teacher)
    unmoved = [k for k in s1 if torch.equal(s1[k], s0[k]) or torch.equal(t1[k], t0_stats[k])]
    same = [k for k in s1 if torch.equal(s1[k], t1[k])]
    check(not unmoved and not same, f"dino-bn: head statistics unmoved {unmoved} or equal "
                                    f"between student and teacher {same}")
    total = {n: sum(r[n] for r in runs) for n in runs[0]}
    print(f"dino-bn: {DINO_BN_STEPS} train steps at batch {batch}: losses "
          f"{[round(x, 6) for x in losses]}, all finite; launches {json.dumps(runs)} = "
          f"{per_step} per step, exactly; {len(s1)} head statistics moved in the student and "
          f"the teacher and apart (student mlp.1 running_var mean "
          f"{s1['head.mlp.1.running_var'].mean().item():.6f}, teacher "
          f"{t1['head.mlp.1.running_var'].mean().item():.6f}); steps "
          f"{', '.join(f'{t:.1f}' for t in times)} ms (host clock, the first warms up) | {card}",
          flush=True)

    # the statistics through a checkpoint, both ways bit for bit
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = checkpoint.save_checkpoint(state, 0, 1.0, tmp, "dino_bn.ckpt")
        payload = checkpoint.load_checkpoint(path)
    fresh = dino_engine.create_train_state(cfg, 10, 1, DINO_BN_STEPS, seed=7, device=dev)
    fresh, _, _ = checkpoint.restore_dino_state(fresh, payload)
    got_s, got_t = stats(fresh.student), stats(fresh.teacher)
    differ = [k for k in s1 if not (torch.equal(got_s[k], s1[k]) and torch.equal(got_t[k], t1[k]))]
    check(not differ and set(payload["head_stats"]) == {f"mlp_bn_{i}" for i in range(len(bn))},
          f"dino-bn: head statistics not restored bit for bit: {differ}")
    print(f"dino-bn: save_checkpoint / restore_dino_state: head_stats and teacher_head_stats "
          f"({sorted(payload['head_stats'])}) restored bit for bit | {card}", flush=True)
    del fresh, payload
    times = []
    for i in range(5):  # host clock around synchronised steps (warm), as the dino phase's
        wire = torch.from_numpy(wires[i % len(wires)]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, wire, 0, momentum, temp, False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    print(f"dino-bn: median step {step_ms:.2f} ms over {len(times)} synchronised steps "
          f"({', '.join(f'{t:.1f}' for t in times)}), {batch / step_ms * 1e3:.2f} volumes/s; "
          f"the shipped head's (dino phase) {shipped_step_ms:.2f} ms, "
          f"{100 * (step_ms / shipped_step_ms - 1):+.1f}% | {card}", flush=True)
    del state
    torch.cuda.empty_cache()
    return {"train": total, "compare": compare, "step_ms": step_ms}


def phase_dino_cli(workdir: Path, card: str) -> dict:
    """The DINO pretraining CLI end to end on the cli phase's heads and
    manifests; returns the B1 and B2 launches of its runs by path."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines import dino_engine
    from headct_foundation_tpu_torch.utils import checkpoint, torch_interop

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / DINO_CONFIG))
    name, depth = cfg.MODEL.SAVE_NAME, int(cfg.VIT.NUM_LAYERS)
    per_step = {"flash_attention_fwd": 2 * depth, "flash_attention_bwd": depth}
    per_eval = {"flash_attention_fwd": 2 * depth}
    saved_dir = workdir / "dino_saved"
    opts = ["DATA.TRAIN_CSV_PATH", str(workdir / "train.csv"),
            "DATA.VAL_CSV_PATH", str(workdir / "val.csv"),
            "DATA.TEST_CSV_PATH", str(workdir / "test.csv"),
            "DATA.CACHE_DIR", str(workdir / "cache"), "MODEL.DIR", str(saved_dir),
            "LOG.OUTPUT_DIR", str(workdir / "dino_log"), "OUTPUT", str(workdir / "dino_out"),
            "TRAIN.VAL_EVERY", "1"]
    first, launches, wall, saved = run_pretrain_cli(
        "dino-cli", "main_pretrain_dino", DINO_CONFIG, opts, saved_dir, per_step, per_eval, card)
    extras = {"momentum_model_state_dict", "center", "head_stats", "teacher_head_stats"}
    best = checkpoint.load_checkpoint(str(saved_dir / f"best_{name}"))
    check(extras <= set(best), f"dino-cli: best_ lacks {extras - set(best)}")
    del best
    peak = first["peak_memory_bytes"]
    print(f"dino-cli: python -m headct_foundation_tpu_torch.main_pretrain_dino --cfg "
          f"{DINO_CONFIG} (2 epochs) exit 0 in {wall:.2f} s; {saved} written with "
          f"{sorted(extras)}; 0 placeholders; test loss {first['test']['loss']:.6f}; launches "
          f"{json.dumps(launches)} = {per_step} per train step, {per_eval} per eval batch; peak "
          f"memory {(peak or 0) / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) | {card}",
          flush=True)

    # the saved state restored beside the file: bit for bit
    latest = saved_dir / f"latest_{name}"
    payload = checkpoint.load_checkpoint(str(latest))
    check(extras <= set(payload), f"dino-cli: latest_ lacks {extras - set(payload)}")
    state = dino_engine.create_train_state(cfg, 10, 1, 2, seed=7, device="cuda")
    state, epoch, _ = checkpoint.restore_dino_state(state, payload)
    norm = state.norm_layer
    held = check_restored("dino-cli", latest, payload, {
        "params": torch_interop.jax_tree_from_state_dict(state.student.state_dict(), norm),
        "momentum_model_state_dict": torch_interop.jax_tree_from_state_dict(
            state.teacher.state_dict(), norm),
        "opt_state": torch_interop.opt_state_to_jax(state.optimizer, state.student, cfg,
                                                    state.step, norm_layer=norm),
        "center": state.center.cpu().numpy()}, epoch, state.step, first)
    print(f"dino-cli: {latest.name} ({latest.stat().st_size / 2**20:.1f} MiB) restored beside "
          f"the file: {held} student, teacher, optimizer and centre leaves equal bit for "
          f"bit, step {state.step}, epoch {epoch} | {card}", flush=True)
    del state, payload
    torch.cuda.empty_cache()

    resume_cli("dino-cli", "main_pretrain_dino", DINO_CONFIG, opts, latest, "Resumed (full)",
               per_step, per_eval, launches, card)
    return launches


EXTRACT_BATCH = 8          # the retrieval tool's batch (its --batch-size default)
EXTRACT_HELD = 8           # heads embedded on the card and on the CPU in this process
ODD_SIZE = (96, 96, 120)   # a non-cubic input: T = 1 + 8 * 8 * 10 = 641
BIG = 192                  # an extractor whose grid is interpolated 512 -> 4096 at load
EXTRACT_641 = (2, 641, 12, 64)
EXTRACT_4097 = (2, 4097, 12, 64)
PE_ATOL = 1e-6             # the interpolated position embedding, card against CPU


def phase_extract(workdir: Path, card: str) -> dict:
    """Retrieval, another input size, another grid at load and attention maps
    at full width, on the cli phase's heads, its MAE latest_ and the dino-cli
    phase's DINO latest_. Returns the launches by path and the timings of B1
    at [2,641,12,64] and B3 at [2,4097,12,64], float32."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.eval.retrieval import retrieval_map_per_class
    from headct_foundation_tpu_torch.feature_extraction import build_extractor_from_config
    from headct_foundation_tpu_torch.models.pos_embed import interpolate_pos_embed
    from headct_foundation_tpu_torch.ops import attention as port_attn
    from headct_foundation_tpu_torch.ops import flash_attention as fa
    from headct_foundation_tpu_torch.tools.cli_runs import CLI_TIMEOUT_S, CQ500_COLUMNS, \
        write_label_manifest
    from headct_foundation_tpu_torch.tools.eval_retrieval import read_labelled_manifest
    from headct_foundation_tpu_torch.utils import checkpoint
    from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax

    configs = {}
    for key, path in (("vit", DOWNSTREAM_CONFIG), ("mae", MAE_CONFIG), ("dino", DINO_CONFIG)):
        configs[key] = default_config()
        configs[key].merge_from_file(str(ROOT / path))
    cfg = configs["vit"]
    depth = int(cfg.VIT.NUM_LAYERS)
    mae_latest = workdir / "model_saved" / f"latest_{configs['mae'].MODEL.SAVE_NAME}"
    dino_latest = workdir / "dino_saved" / f"latest_{configs['dino'].MODEL.SAVE_NAME}"
    heads = list(dict.fromkeys((workdir / "train.csv").read_text().splitlines()[1:]))
    manifest = workdir / "retrieval_labels.csv"
    write_label_manifest(manifest, heads, seed=20)
    _, labels = read_labelled_manifest(str(manifest))
    runs = {}

    def plain(fn):
        prev = port_attn.set_attention_backend("plain")
        try:
            return fn()
        finally:
            port_attn.set_attention_backend(prev)

    def only(got: dict, name: str, n: int) -> bool:
        return got == {k: (n if k == name else 0) for k in got}

    # 1. Retrieval: the tool in a subprocess, its launches counted there.
    cmd = [sys.executable, "-m", "headct_foundation_tpu_torch.tools.eval_retrieval", "--cfg",
           str(ROOT / DOWNSTREAM_CONFIG), "--csv", str(manifest), "--checkpoint",
           str(mae_latest), "--batch-size", str(EXTRACT_BATCH), "--device", "cuda"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(x for x in (str(ROOT), env.get("PYTHONPATH")) if x)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"extract: the retrieval tool exited {r.returncode}:\n"
                             f"{(r.stdout + r.stderr)[-4000:]}")
    lines = r.stdout.strip().splitlines()
    maps, info = json.loads(lines[-1]), json.loads(lines[-2])["retrieval"]
    check(list(maps) == [f"mAP_{c}" for c in CQ500_COLUMNS]
          and all(math.isfinite(x) for x in maps.values()),
          f"extract: the retrieval tool printed {maps}; one finite mAP per label expected")
    forwards = math.ceil(len(heads) / EXTRACT_BATCH)
    check(only(info["launches"], "flash_attention_fwd", depth * forwards),
          f"extract: the retrieval tool launched {info['launches']}; expected {depth} B1 in "
          f"each of its {forwards} forwards and nothing else")
    runs["retrieval tool"] = info["launches"]
    print(f"extract: python -m headct_foundation_tpu_torch.tools.eval_retrieval --cfg "
          f"{DOWNSTREAM_CONFIG} --checkpoint <cli latest_> on {info['scans']} heads (random "
          f"cq500 labels, seed 20: no bound) exit 0 in {wall:.2f} s, embedding "
          f"{info['embed_seconds']:.2f} s (host clock, decode and preprocess included); "
          f"{json.dumps(maps)}; launches {json.dumps(info['launches'])} = {depth} B1 x "
          f"{forwards} forwards, exactly | {card}", flush=True)

    # The same checkpoint in this process: 8 heads on the card and on the CPU.
    fe = build_extractor_from_config(cfg, checkpoint_path=str(mae_latest), device="cuda")
    fe_cpu = build_extractor_from_config(cfg, checkpoint_path=str(mae_latest), device="cpu")
    held = heads[:EXTRACT_HELD]
    zero_launches()
    on_card = fe.extract_from_files(held, batch_size=EXTRACT_BATCH)
    runs["extract card"] = launches()
    t0 = time.perf_counter()
    on_cpu = fe_cpu.extract_from_files(held, batch_size=EXTRACT_BATCH)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(on_card - on_cpu).max())
    check(err <= EMBED_ATOL and only(runs["extract card"], "flash_attention_fwd", depth),
          f"extract: {EXTRACT_HELD} heads on the card are {err:.3e} from the CPU's (limit "
          f"{EMBED_ATOL}), launches {runs['extract card']}")
    sub = {c: labels[c][:EXTRACT_HELD] for c in labels}
    map_card, map_cpu = (retrieval_map_per_class(f, sub) for f in (on_card, on_cpu))
    print(f"extract: {EXTRACT_HELD} heads through the extractor on the card and on the CPU "
          f"({cpu_s:.2f} s there): CLS max abs {err:.3e} (limit {EMBED_ATOL}); launches "
          f"{json.dumps(runs['extract card'])}; mAP over these {EXTRACT_HELD} on the card "
          f"{json.dumps({k: round(v, 4) for k, v in map_card.items()})}, on the CPU "
          f"{json.dumps({k: round(v, 4) for k, v in map_cpu.items()})} (nan where a label has "
          f"one positive; no bound) | {card}", flush=True)
    del fe_cpu

    # 2. Another input size: 96 x 96 x 120, T = 641, on B1 in float32.
    g = torch.Generator(device="cuda").manual_seed(21)
    odd = torch.rand((2, 3, *ODD_SIZE), generator=g, device="cuda")
    zero_launches()
    out_k = fe(odd)[0]
    torch.cuda.synchronize()
    runs["size 641"] = launches()
    out_p = plain(lambda: fe(odd)[0])
    err = (out_k - out_p).abs().max().item()
    check(out_k.shape == (2, EXTRACT_641[1], 768) and err <= EMBED_ATOL
          and only(runs["size 641"], "flash_attention_fwd", depth),
          f"extract: {list(odd.shape)} gave {list(out_k.shape)}, {err:.3e} from the plain "
          f"attention, launches {runs['size 641']}")
    print(f"extract: the 96^3 extractor on {list(odd.shape)} inputs (grid 8 x 8 x 10, T = "
          f"{out_k.shape[1]}): last layer max abs {err:.3e} from the plain attention on the card "
          f"(limit {EMBED_ATOL}); launches {json.dumps(runs['size 641'])} | {card}", flush=True)
    q, k, v = qkv_inputs(EXTRACT_641, 0, torch.Generator(device="cuda").manual_seed(23),
                         torch.float32)
    o, lse = fa.fused_attention(q, k, v)
    o_ref, _ = fa.fused_attention_reference(q, k, v)
    ok, _, err, _ = within(o, o_ref, 2e-5, 1e-4, torch.float32)
    check(ok, f"extract: flash_attention_fwd at {EXTRACT_641} float32 is {err:.3e} off")
    b1 = {"max_abs_err": err}
    time_fwd(fa.fused_attention, fa.fused_attention_reference, b1, q, k, v, EXTRACT_641,
             torch.float32)
    del q, k, v, o, lse, o_ref, odd, out_k, out_p

    # 3. Another grid at load: VIT.INPUT_SIZE 192 from the 96^3 file, 512 -> 4096 patches.
    big_cfg = cfg.clone()
    big_cfg.merge_from_list(["VIT.INPUT_SIZE", BIG])
    fe_big = build_extractor_from_config(big_cfg, checkpoint_path=str(mae_latest),
                                         device="cuda")
    pe_file = state_dict_from_jax(checkpoint.load_checkpoint(str(mae_latest))["params"])[
        "patch_embedding.position_embeddings"]
    pe_cpu = interpolate_pos_embed(pe_file, 0, new_num_patches=(BIG // 12) ** 3)
    pe_card = interpolate_pos_embed(pe_file.cuda(), 0, new_num_patches=(BIG // 12) ** 3)
    pe_err = (pe_card.cpu() - pe_cpu).abs().max().item()
    loaded = fe_big.model.patch_embedding.position_embeddings.detach().cpu()
    check(fe.missing == fe_big.missing == [] and fe_big.unexpected == fe.unexpected
          and not any("shape" in u for u in fe_big.unexpected),
          f"extract: the {BIG}^3 extractor's load: missing {fe_big.missing}, unexpected "
          f"{fe_big.unexpected[:5]} (the 96^3 one's: {fe.unexpected[:5]})")
    check(pe_err <= PE_ATOL and torch.equal(loaded, pe_cpu),
          f"extract: the interpolated position embedding is {pe_err:.3e} off on the card")
    print(f"extract: VIT.INPUT_SIZE {BIG} from the 96^3 cli latest_: position embedding "
          f"{list(pe_file.shape)} -> {list(loaded.shape)} interpolated at load, the card's "
          f"{pe_err:.3e} from the CPU's (limit {PE_ATOL}); 0 missing keys; "
          f"{len(fe_big.unexpected)} unexpected, the MAE decoder's, as at 96^3 (none a shape "
          f"mismatch) | {card}", flush=True)
    del fe, pe_card
    big = torch.rand((2, 3, BIG, BIG, BIG), generator=g, device="cuda")
    zero_launches()
    out_k = fe_big(big)[0]
    torch.cuda.synchronize()
    runs["grid 192"] = launches()
    out_p = plain(lambda: fe_big(big)[0])
    err = (out_k - out_p).abs().max().item()
    check(out_k.shape == (2, EXTRACT_4097[1], 768) and err <= EMBED_ATOL
          and only(runs["grid 192"], "flash_attention_blocked_fwd", depth),
          f"extract: {list(big.shape)} gave {list(out_k.shape)}, {err:.3e} from the plain "
          f"attention, launches {runs['grid 192']}")
    del out_p
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fe_big(big)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = statistics.median(times)
    print(f"extract: the {BIG}^3 extractor on {list(big.shape)}: T = {out_k.shape[1]}, last "
          f"layer max abs {err:.3e} from the plain attention on the card (limit {EMBED_ATOL}); "
          f"launches {json.dumps(runs['grid 192'])}; forward median {fwd_ms:.2f} ms over "
          f"{len(times)} synchronised runs ({', '.join(f'{t:.1f}' for t in times)}) | {card}",
          flush=True)
    del fe_big, big, out_k
    torch.cuda.empty_cache()
    b3 = time_blocked_f32(fa, EXTRACT_4097)
    b3["forward_ms"] = fwd_ms

    # 4. Attention maps of the DINO backbone (4 registers, T = 517), from the dino-cli file.
    dino_cfg = configs["dino"]
    fe_dino = build_extractor_from_config(dino_cfg, checkpoint_path=str(dino_latest),
                                          device="cuda")
    check(fe_dino.missing == [] and fe_dino.unexpected == [],
          f"extract: the DINO backbone's load: missing {fe_dino.missing}, unexpected "
          f"{fe_dino.unexpected}")
    x = torch.stack([fe_dino.preprocess(p) for p in heads[:2]])
    out_k = fe_dino(x)[0]
    zero_launches()
    att = fe_dino.attention_maps(x)
    prev = fe_dino.model.set_save_attn(True)
    out_sa = fe_dino(x)[0]
    fe_dino.model.set_save_attn(prev)
    torch.cuda.synchronize()
    runs["attention maps"] = launches()
    t = 1 + int(dino_cfg.VIT.NUM_REGISTER_TOKENS) + (96 // 12) ** 3
    rows = max(float(np.abs(m.sum(-1) - 1.0).max()) for m in att)
    err = (out_sa - out_k).abs().max().item()
    vol = fe_dino.cls_attention_volume(x)
    check(len(att) == depth and all(m.shape == (2, 12, t, t) for m in att) and rows <= 1e-5
          and err <= EMBED_ATOL and all(n == 0 for n in runs["attention maps"].values())
          and vol.shape == (2, 96, 96, 96) and bool(np.isfinite(vol).all()),
          f"extract: attention maps {[m.shape for m in att[:1]]} x {len(att)}, row sums "
          f"{rows:.3e} from 1, save_attn forward {err:.3e} from the kernels', launches "
          f"{runs['attention maps']}, volume {vol.shape}")
    print(f"extract: {DINO_CONFIG}'s backbone from the dino-cli latest_ (0 missing, 0 "
          f"unexpected): attention_maps on 2 heads gave {len(att)} x {list(att[0].shape)}, "
          f"rows sum to 1 within {rows:.3e}; the save_attn forward {err:.3e} from the kernel "
          f"forward (limit {EMBED_ATOL}); launches while they ran {json.dumps(runs['attention maps'])}; "
          f"cls_attention_volume {list(vol.shape)} finite, max {vol.max():.4e} | {card}",
          flush=True)
    del fe_dino, att, x
    torch.cuda.empty_cache()
    return {"runs": runs, "b1_641": b1, "b3_4097": b3}


def time_blocked_f32(fa, shape) -> dict:
    """B3 in float32 at a square ``shape`` held against its plain version,
    then timed as ``time_blocked`` times it: kernel on an idle stream and
    behind a device sleep, plain version, scaled_dot_product_attention, and
    the bound of the route (three TF32 products on the tensor cores)."""
    q, k, v, _ = blocked_inputs(shape, shape[1], torch.float32, seed=24)
    o, lse = fa.blocked_fused_attention(q, k, v)
    o_ref, lse_ref = fa.blocked_attention_reference(q, k, v)
    ok, _, err, _ = within(o, o_ref, 2e-5, 1e-4, torch.float32)
    ok = ok and bool(((lse - lse_ref).abs() <= 1e-4 + 1e-4 * lse_ref.abs()).all())
    check(ok, f"flash_attention_blocked_fwd at {shape} float32 is {err:.3e} off")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = {"max_abs_err": err, "shape": list(shape), "dtype": "float32",
           "ms": cuda_ms(lambda: fa.blocked_fused_attention(q, k, v), iters=10),
           "ms_device": cuda_ms(lambda: fa.blocked_fused_attention(q, k, v), iters=10,
                                ahead=AHEAD_ONE),
           "plain_ms": cuda_ms(lambda: fa.blocked_attention_reference(q, k, v), iters=3,
                               warmup=1),
           "library_ms": cuda_ms(lambda: sdpa(qt, kt, vt), iters=10),
           "library_ms_device": cuda_ms(lambda: sdpa(qt, kt, vt), iters=10, ahead=AHEAD_ONE)}
    B, T, H, D = shape
    row["bound_ms"], row["bound_by"] = bound_ms(3 * 4 * B * H * T * T * D,
                                                4 * B * T * H * D * 4 + B * H * T * 4,
                                                torch.float32, PEAK_TF32)
    print(f"timing flash_attention_blocked_fwd {list(shape)} float32: kernel {row['ms']:.4f} ms "
          f"on an idle stream ({row['ms_device']:.4f} ms behind a device sleep), plain "
          f"{row['plain_ms']:.4f} ms, scaled_dot_product_attention {row['library_ms']:.4f} ms "
          f"({row['library_ms_device']:.4f} ms; kernel {row['ms_device'] / row['library_ms_device']:.2f}x), "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} (three TF32 products each at "
          f"{PEAK_TF32 / 1e12:.0f} TFLOP/s) ({100 * row['bound_ms'] / row['ms_device']:.1f}% "
          f"of bound on the device time); max_abs_err {err:.3e}", flush=True)
    del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return row


DOWNSTREAM_CONFIG = "configs/downstream/vit_HeadCT_cq500.yaml"
DOWNSTREAM_BATCHES = 8        # the fine-tune epoch: 500 draws at 64 are 8 steps (the last 52)
DOWNSTREAM_MODE_BATCHES = 2   # the lock and LoRA epochs
DOWNSTREAM_COMPARE_BATCH = 4  # volumes of the kernel-vs-plain attention step
# The kernel-vs-plain step leaves out the tensors of
# downstream_engine.ROUNDING_ONLY (gradients 0 but for rounding). In float32
# the head's BatchNorm takes the batch's statistics, as the timed step does;
# in bf16 it takes its running statistics: the random-init ViT gives CLS
# features that differ across heads by a few percent of their size, so
# train-mode statistics over 4 of them turn bf16 roundings into the signal (on
# the card: loss 7.7e-2 apart, a gradient cosine of -1, with train-mode
# statistics in bf16; PERF.md §6).


def downstream_config(extra=()):
    from headct_foundation_tpu_torch.config import default_config

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / DOWNSTREAM_CONFIG))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16", *extra])
    return cfg


def labelled_phantoms(seed: int, n: int, size: int = 96) -> tuple:
    """n head phantoms as ``head_phantoms`` draws them, but each with its own
    tissue (brain 20-50 HU, noise 4-14 HU, skull 700-1600 HU), and a label:
    1 where a bleed (a 60-85 HU ellipsoid inside the brain) was added.
    Returns (hu16 wire [n, 1, size^3] int16, labels [n] int64). Heads that
    differ only in shape give CLS features so alike that the classifier's
    BatchNorm over a few of them turns bf16 roundings into the signal."""
    from headct_foundation_tpu_torch.data.transforms import hu16_encode

    rng = np.random.RandomState(seed)
    g = (np.arange(size, dtype=np.float32) - size / 2) / (size / 2)
    x, y, z = g[:, None, None], g[None, :, None], g[None, None, :]
    out = np.empty((n, 1, size, size, size), np.int16)
    labels = rng.randint(0, 2, n).astype(np.int64)
    for i in range(n):
        c = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
        r = rng.uniform(0.65, 0.9, 3).astype(np.float32)
        d = ((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2 + ((z - c[2]) / r[2]) ** 2
        hu = np.where(d < 1.0, rng.uniform(700, 1600), -1000.0).astype(np.float32)
        brain = d < 0.8
        hu[brain] = (rng.uniform(20, 50)
                     + rng.uniform(4, 14) * rng.randn(int(brain.sum()))).astype(np.float32)
        if labels[i]:
            b = c + rng.uniform(-0.3, 0.3, 3).astype(np.float32)
            rb = rng.uniform(0.08, 0.25, 3).astype(np.float32)
            bleed = brain & ((((x - b[0]) / rb[0]) ** 2 + ((y - b[1]) / rb[1]) ** 2
                              + ((z - b[2]) / rb[2]) ** 2) < 1.0)
            hu[bleed] = rng.uniform(60, 85)
        out[i, 0] = hu16_encode(hu)
    return out, labels


def downstream_batches(n: int, batch: int, seed0: int, unique: int = 4) -> list:
    """``n`` (hu16 wire, int64 target, names) batches of ``labelled_phantoms``;
    ``unique`` distinct batches, cycled."""
    made = [labelled_phantoms(seed0 + i, batch) for i in range(min(unique, n))]
    return [(*made[i % len(made)], [f"phantom{seed0 + i}_{j}" for j in range(batch)])
            for i in range(n)]


def phase_downstream(card: str) -> dict:
    """The downstream fine-tune at full width on configs/downstream/
    vit_HeadCT_cq500.yaml as shipped (ViT-B/12 at 96^3, linear head,
    batch 64), on hu16 head phantoms with labels; then the same under lock
    and under LoRA. Returns the launches of its train and eval runs and its
    timings."""
    import torch.nn.functional as F

    from headct_foundation_tpu_torch.data.augment import apply_mae_augment, draw_mae_augment
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.engines import downstream_engine, mae_engine
    from headct_foundation_tpu_torch.ops import attention as port_attn
    from headct_foundation_tpu_torch.optim.optimizers import without_key_bias

    cfg = downstream_config()
    depth, batch = int(cfg.VIT.NUM_LAYERS), int(cfg.DATA.BATCH_SIZE)
    in_chans = int(cfg.VIT.IN_CHANS)
    per_step = {"flash_attention_fwd": depth, "flash_attention_bwd": depth}
    per_lock_step = {"flash_attention_fwd": depth}
    per_eval = {"flash_attention_fwd": depth}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    total = DOWNSTREAM_BATCHES + 10
    state = downstream_engine.create_train_state(cfg, total, 1, seed=0, device=dev)
    batches = downstream_batches(DOWNSTREAM_BATCHES + 1, batch, 600)
    trainable = {f"{m}.{n}": p for m, mod in (("model", state.model),
                                              ("classifier", state.classifier))
                 for n, p in mod.named_parameters() if p.requires_grad}
    torch.cuda.synchronize()
    v = cfg.VIT
    print(f"downstream set-up: {DOWNSTREAM_CONFIG} (ViT {v.NUM_LAYERS}x{v.HIDDEN_SIZE}/"
          f"{v.NUM_HEADS} heads, {v.INPUT_SIZE}^3 patch {v.PATCH_SIZE}, "
          f"{v.NUM_REGISTER_TOKENS} registers; {cfg.TRAIN.CLASSIFIER} head, "
          f"{cfg.DATA.NUM_CLASSES} classes; {cfg.TRAIN.OPTIMIZER} at BASE_LR "
          f"{cfg.TRAIN.BASE_LR}, the head at x100), {sum(p.numel() for p in trainable.values())} "
          f"trainable parameters in {len(trainable)} tensors, seed 0, bf16 compute; "
          f"{len(batches)} batches of {list(batches[0][0].shape)} int16 phantoms with labels in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # kernel against plain attention on one step: same weights, augmentation,
    # targets; the head's BatchNorm on its running statistics (see above)
    g = mae_engine.step_generator(dev, 7, 0, 0)
    n = DOWNSTREAM_COMPARE_BATCH
    wire0 = torch.from_numpy(batches[0][0][:n]).to(dev)
    target0 = torch.from_numpy(batches[0][1][:n]).to(dev)
    decisions = draw_mae_augment(n, g, dev)

    def loss_and_grads_of(model, classifier, dtype, batch_stats: bool):
        modules = {"model": model, "classifier": classifier}
        names = [k for k in trainable if k not in downstream_engine.ROUNDING_ONLY]

        def run(backend):
            prev = port_attn.set_attention_backend(backend)
            try:
                model.train()
                classifier.train(batch_stats)  # see DOWNSTREAM_COMPARE_BATCH
                for m in modules.values():
                    m.zero_grad(set_to_none=True)
                vols = apply_mae_augment(wire_to_compute(wire0, cfg, in_chans, dtype=dtype),
                                         decisions)
                logits = classifier(model(vols)[0][:, 0])
                loss = F.cross_entropy(logits.float(), target0)
                loss.backward()
                params = {f"{m}.{k}": p for m, mod in modules.items()
                          for k, p in mod.named_parameters()}
                grads = {k: without_key_bias(k, params[k].grad.detach().clone()) for k in names}
                for m in modules.values():
                    m.zero_grad(set_to_none=True)
                return loss.item(), grads
            finally:
                port_attn.set_attention_backend(prev)

        return run

    compare = {torch.bfloat16: hold_backends(
        loss_and_grads_of(state.model, state.classifier, torch.bfloat16, False), torch.bfloat16,
        "downstream (head on running statistics)", "trainable")}
    m32 = downstream_engine.build_vit_model(cfg, torch.float32).to(dev)
    c32 = downstream_engine.build_classifier(cfg, torch.float32).to(dev)
    m32.load_state_dict(state.model.state_dict())
    c32.load_state_dict(state.classifier.state_dict())
    for mod, src in ((m32, state.model), (c32, state.classifier)):
        for name, p in mod.named_parameters():
            p.requires_grad_(dict(src.named_parameters())[name].requires_grad)
    compare[torch.float32] = hold_backends(loss_and_grads_of(m32, c32, torch.float32, True),
                                           torch.float32, "downstream (head on batch statistics)",
                                           "trainable")
    del m32, c32
    torch.cuda.empty_cache()

    # The main path: the fine-tune epoch, one eval batch, then the lock and LoRA
    # epochs; every kernel count is 0 just before each and read just after.
    log = logging.getLogger("chip_smoke.downstream")
    snap = lambda s: {f"{m}.{k}": v.detach().clone()
                      for m, mod in (("model", s.model), ("classifier", s.classifier))
                      for k, v in mod.state_dict().items()}

    def epoch(s, label, data, per):
        before = snap(s)
        zero_launches()
        t = time.perf_counter()
        s, stats = downstream_engine.train_one_epoch(
            s.config, s, downstream_engine.make_train_step(s.config), data, 0, 0, 1, logger=log)
        torch.cuda.synchronize()
        got = launches()
        after = snap(s)
        moved = {k for k in before if not torch.equal(before[k], after[k])}
        want_moved = {f"{m}.{k}" for m, mod in (("model", s.model),
                                               ("classifier", s.classifier))
                      for k, p in mod.named_parameters() if p.requires_grad}
        want_moved |= {k for k in before if k.endswith(("running_mean", "running_var"))}
        want = {k: per.get(k, 0) * len(data) for k in got}
        check(math.isfinite(stats["loss"]) and stats["steps"] == len(data),
              f"downstream {label}: loss {stats.get('loss')} over {stats['steps']} steps")
        check(moved == want_moved, f"downstream {label}: moved {sorted(moved ^ want_moved)[:6]} "
              "against the trainable set and the BatchNorm statistics")
        check(got == want, f"downstream {label}: launches {got}; expected {want}")
        frozen = len(before) - len(moved)
        print(f"downstream {label}: train_one_epoch over {len(data)} batches of {batch} in "
              f"{time.perf_counter() - t:.2f} s, mean loss {stats['loss']:.6f}; "
              f"{len(moved)} tensors moved (every trainable one and the BatchNorm statistics), "
              f"{frozen} frozen ones bit-identical; launches {json.dumps(got)} = {per} per step, "
              f"exactly | {card}", flush=True)
        return s, stats, got

    torch.cuda.reset_peak_memory_stats()
    state, train_stats, runs_ft = epoch(state, "fine-tune", batches[:DOWNSTREAM_BATCHES],
                                        per_step)
    peak = torch.cuda.max_memory_allocated()
    zero_launches()
    val = downstream_engine.val_one_epoch(cfg, state, downstream_engine.make_eval_step(cfg),
                                          batches[DOWNSTREAM_BATCHES:], logger=log)
    runs_eval = launches()
    check(math.isfinite(val["loss"]) and runs_eval == {k: per_eval.get(k, 0) for k in runs_eval},
          f"downstream eval: loss {val.get('loss')}, launches {runs_eval}")
    print(f"downstream: val_one_epoch over 1 batch: loss {val['loss']:.6f}, mean AUROC "
          f"{val['mean_auroc']:.4f} (random labels: no bound); launches {json.dumps(runs_eval)} "
          f"= {per_eval} per batch, exactly; peak memory {peak / 2**30:.2f} GiB over the "
          f"fine-tune epoch (torch.cuda.max_memory_allocated) | {card}", flush=True)

    # Step time: host clock around synchronised steps (warm), then the breakdown.
    step = downstream_engine.make_train_step(cfg)
    wire = torch.from_numpy(batches[0][0]).to(dev)
    target = torch.from_numpy(batches[0][1]).to(dev)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, wire, target, 0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    decisions = draw_mae_augment(batch, g, dev)
    prep = lambda: apply_mae_augment(wire_to_compute(wire, cfg, in_chans), decisions)
    prep_ms = cuda_ms(prep, iters=5, warmup=1)
    vols = prep()
    model, classifier = state.model, state.classifier
    model.train()
    classifier.train()

    def forward():
        return F.cross_entropy(classifier(model(vols)[0][:, 0]).float(), target)

    fwd_ms = cuda_ms(forward, iters=5, warmup=1)
    fb_ms = cuda_ms(lambda: forward().backward(), iters=5, warmup=1)
    opt_ms = {label: cuda_ms(opt.step, iters=5, warmup=1)
              for label, opt in state.optimizers.items()}
    for opt in state.optimizers.values():
        opt.zero_grad(set_to_none=True)
    print(f"downstream: median step {step_ms:.2f} ms over {len(times)} synchronised steps "
          f"({', '.join(f'{t:.1f}' for t in times)}), {batch / step_ms * 1e3:.2f} volumes/s; "
          f"breakdown (CUDA events): window+augment {prep_ms:.2f} ms, forward with the head and "
          f"the loss {fwd_ms:.2f} ms, backward {fb_ms - fwd_ms:.2f} ms (forward+backward "
          f"{fb_ms:.2f}), AdamW model {opt_ms['model']:.2f} ms, AdamW classifier "
          f"{opt_ms['classifier']:.2f} ms | {card}", flush=True)
    profile_steps(lambda: step(state, wire, target, 0), step_ms)
    del state, model, classifier, vols
    torch.cuda.empty_cache()

    runs_mode = {}
    for label, extra, per in (("lock", ["TRAIN.LOCK", True], per_lock_step),
                              ("lora", ["TRAIN.LORA", True], per_step)):
        mode_cfg = downstream_config(extra)
        s = downstream_engine.create_train_state(mode_cfg, total, 1, seed=0, device=dev)
        s, _, runs_mode[label] = epoch(s, label, batches[:DOWNSTREAM_MODE_BATCHES], per)
        del s
        torch.cuda.empty_cache()
    train = {k: runs_ft[k] + runs_mode["lock"][k] + runs_mode["lora"][k] for k in runs_ft}
    return {"train": train, "eval": runs_eval, "compare": compare, "step_ms": step_ms,
            "volumes_per_s": batch / step_ms * 1e3, "peak_bytes": peak,
            "val_auroc": val["mean_auroc"]}


def phase_downstream_cli(workdir: Path, card: str) -> dict:
    """The downstream CLI end to end on the cli phase's heads and cache, with
    cq500 label manifests: a fine-tune warm-started from the MAE cli run's
    latest_ file, --lock --few_shots 4, and --lora --classifier attentive,
    the three processes side by side on the card (about 37 GiB together);
    returns the B1 and B2 launches of its runs by path."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines import downstream_engine
    from headct_foundation_tpu_torch.tools.cli_runs import write_label_manifest
    from headct_foundation_tpu_torch.utils import checkpoint, torch_interop

    cfg = downstream_config()
    depth, name = int(cfg.VIT.NUM_LAYERS), cfg.MODEL.SAVE_NAME
    scans = (workdir / "test.csv").read_text().splitlines()[1:]
    manifests = {}
    for i, split in enumerate(CLI_ROWS):
        rows = (workdir / f"{split}.csv").read_text().splitlines()[1:]
        manifests[split] = workdir / f"{split}_labels.csv"
        write_label_manifest(manifests[split], rows, seed=i)
    mae_cfg = default_config()
    mae_cfg.merge_from_file(str(ROOT / MAE_CONFIG))
    mae_latest = workdir / "model_saved" / f"latest_{mae_cfg.MODEL.SAVE_NAME}"
    launches_by_path = {"cli training": {"flash_attention_fwd": 0, "flash_attention_bwd": 0},
                        "cli eval": {"flash_attention_fwd": 0, "flash_attention_bwd": 0}}
    runs = (("fine-tune", ["--model_load_path", str(mae_latest)],
             {"flash_attention_fwd": depth, "flash_attention_bwd": depth}),
            ("lock-few-shot", ["--lock", "--few_shots", "4"], {"flash_attention_fwd": depth}),
            ("lora-attentive", ["--lora", "--classifier", "attentive"],
             {"flash_attention_fwd": depth, "flash_attention_bwd": depth}))

    def launch(label, flags):
        out = workdir / f"downstream_{label}"
        out.mkdir()
        opts = ["DATA.TRAIN_CSV_PATH", str(manifests["train"]),
                "DATA.VAL_CSV_PATH", str(manifests["val"]),
                "DATA.TEST_CSV_PATH", str(manifests["test"]),
                "DATA.CACHE_DIR", str(workdir / "cache"), "MODEL.DIR", str(out / "saved"),
                "LOG.OUTPUT_DIR", str(out / "log"), "OUTPUT", "", "TRAIN.VAL_EVERY", "1",
                "TRAIN.MAX_EPOCHS", "2"]
        return run_cli(
            ["--cfg", str(ROOT / DOWNSTREAM_CONFIG), "--device", "cuda", "--dataset", "cq500",
             "--label_name", "ICH", "--preds_save_name", label, *flags, "--opts", *opts],
            f"downstream-cli {label}", module="main_downstream", cwd=out)

    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        done = list(pool.map(lambda run: launch(*run[:2]), runs))
    for (label, flags, per), (log, result, wall) in zip(runs, done):
        out = workdir / f"downstream_{label}"
        check(result["placeholders"] == 0,
              f"downstream-cli {label}: {result['placeholders']} scans were placeholders")
        losses = [e["train"]["loss"] for e in result["epochs"]] + [result["test"]["loss"]]
        check(all(math.isfinite(x) for x in losses), f"downstream-cli {label}: losses {losses}")
        got = check_cli_launches(result, f"downstream-cli {label}", per,
                                 {"flash_attention_fwd": depth})
        for path in launches_by_path:
            for k in launches_by_path[path]:
                launches_by_path[path][k] += got[path][k]
        with open(out / "preds_pkl" / f"{label}_preds.pkl", "rb") as f:
            preds = pickle.load(f)
        check(preds["fnames"] == scans and len(preds["preds"]) == len(scans),
              f"downstream-cli {label}: the predictions pickle does not list the test manifest")
        # best_ restored beside the file: params and batch_stats bit for bit
        best = out / "saved" / f"best_{name}"
        payload = checkpoint.load_checkpoint(str(best))
        mode_cfg = downstream_config(["TRAIN.LOCK", "--lock" in flags, "TRAIN.LORA",
                                      "--lora" in flags, "TRAIN.CLASSIFIER",
                                      "attentive" if "attentive" in label else "linear"])
        state = downstream_engine.create_train_state(mode_cfg, 10, 1, seed=7, device="cuda")
        state, epoch, _ = checkpoint.restore_downstream_state(state, payload)
        params, stats = torch_interop.downstream_params_to_jax(state.model.state_dict(),
                                                               state.classifier.state_dict())
        want = dict(_leaves({"params": payload["params"], "batch_stats": payload["batch_stats"]}))
        have = dict(_leaves({"params": params, "batch_stats": stats}))
        differ = [k for k in want if k not in have or not np.array_equal(have[k], want[k])]
        check(have.keys() == want.keys() and not differ,
              f"downstream-cli {label}: best_ restored differs: {differ[:5]}")
        del state
        ws = result["warm_start"]
        print(f"downstream-cli {label}: python -m headct_foundation_tpu_torch.main_downstream "
              f"--cfg {DOWNSTREAM_CONFIG} {' '.join(flags)} exit 0 in {wall:.2f} s (the three "
              f"runs side by side); epochs "
              f"{[e['train']['steps'] for e in result['epochs']]} steps, train losses "
              f"{[round(e['train']['loss'], 6) for e in result['epochs']]}, best val mean AUROC "
              f"{result['best_val_mean_auroc']:.4f}, test loss {result['test']['loss']:.6f} mean "
              f"AUROC {result['test'].get('mean_auroc', float('nan')):.4f} (random labels: no "
              f"bound); 0 placeholders; launches {json.dumps(got)}; best_ ({best.stat().st_size / 2**20:.1f} "
              f"MiB, epoch {epoch}) restored: {len(want)} params and batch_stats leaves equal bit "
              f"for bit; predictions pickle of {len(scans)} rows; warm start "
              f"{'none' if ws is None else str(ws['merged']) + ' merged, ' + str(ws['missing']) + ' missing, ' + str(ws['unexpected']) + ' unexpected'}"
              f"; peak memory {(result['peak_memory_bytes'] or 0) / 2**30:.2f} GiB | {card}",
              flush=True)
        torch.cuda.empty_cache()
    return launches_by_path


# Libraries holding wgmma kernels -> instantiations ptxas must report: the
# bf16 forward at 5 padded head dims x 2 copy widths and the float32 forward
# at 5 (16-byte copies only) in each of B1's, B3's and B7's library; the dK/dV
# and dQ passes at 5 x 2 each in B2's, B4/B5's and B8's.
DROPOUT_RATE = 0.1      # the dropout phase's MAE.DROPOUT_RATE and VIT.DROPOUT_RATE
DROPOUT_BATCH = 4       # volumes of each dropout step
CONTEXT_SHAPES = [MAE_DECODER, STRETCH_DECODER, STRETCH_ENCODER]  # [B, T, H, D] bf16
CONTEXT_SPLITS = (2, 4)
TENSOR_SHAPES = [MAE_DECODER]  # the DINO student's heads are the dino-mesh phase's
TENSOR_SPLITS = (2, 4)
MESH_SPLITS = (2, 4)  # t and s of the dino-mesh and downstream-mesh phases
BLOCKED_LABEL = {"flash_attention_blocked_fwd": "B3", "flash_attention_blocked_dkv": "B4",
                 "flash_attention_blocked_dq": "B5"}


def mae_dropout_state(rate: float, dev):
    """The shipped 96^3 MAE at dropout ``rate``, seed 0, and its config."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines import mae_engine

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / MAE_CONFIG))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16", "MAE.DROPOUT_RATE", rate])
    return cfg, mae_engine.create_train_state(cfg, 10, 0, seed=0, device=dev)[0]


def dino_dropout_state(rate: float, dev):
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines import dino_engine

    cfg = default_config()
    cfg.merge_from_file(str(ROOT / DINO_CONFIG))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16", "VIT.DROPOUT_RATE", rate])
    return cfg, dino_engine.create_train_state(cfg, 10, 0, 5, seed=0, device=dev)


def phase_dropout(card: str) -> dict:
    """The MAE step (96^3 as shipped) and the DINO step (as shipped) at
    dropout DROPOUT_RATE, batch DROPOUT_BATCH: each with the kernels against
    the plain attention on the same generators (the train and dino phases'
    limits), then one step on the main path with exactly the shipped
    launches (20 B1 + 20 B2 for the MAE, 24 B1 + 12 B2 for DINO); a second run
    from the same seed bit-identical, the rate-0 step different."""
    from headct_foundation_tpu_torch.data.augment import draw_mae_augment
    from headct_foundation_tpu_torch.engines import dino_engine, mae_engine
    from headct_foundation_tpu_torch.ops import attention as port_attn

    dev = torch.device("cuda")
    runs = {}
    wire = torch.from_numpy(head_phantoms(900, DROPOUT_BATCH)).to(dev)

    # MAE: the kernels against the plain attention, every trainable gradient
    cfg, state = mae_dropout_state(DROPOUT_RATE, dev)
    g = mae_engine.step_generator(dev, 7, 0, 0)
    n_tok = int(np.prod(state.model.grid_size))
    draws = {"noise": torch.rand((DROPOUT_BATCH, n_tok), generator=g, device=dev),
             "augment": draw_mae_augment(DROPOUT_BATCH, g, dev)}
    grads = mae_engine.make_grad_step(augment=True, config=cfg)
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]

    def mae_loss_and_grads(backend):
        prev = port_attn.set_attention_backend(backend)
        try:
            step_draws = [{**draws, "dropout": mae_engine.step_generator(dev, 7, 0, 0, 1)}]
            loss = grads(state, wire, 0, step_draws).item()
            params = dict(state.model.named_parameters())
            out = {n: params[n].grad.detach().clone() for n in names}
            state.optimizer.zero_grad(set_to_none=True)
            return loss, out
        finally:
            port_attn.set_attention_backend(prev)

    compare = {"mae": hold_backends(mae_loss_and_grads, torch.bfloat16, "dropout mae",
                                    "trainable")}
    step = mae_engine.make_train_step(augment=True, config=cfg)
    zero_launches()
    state, m = step(state, wire, 0)
    torch.cuda.synchronize()
    runs["mae"] = launches()
    results = [m["loss"].item(), {n: p.detach().clone() for n, p in
                                  state.model.named_parameters()}]
    for rate in (DROPOUT_RATE, 0.0):
        cfg_r, again = mae_dropout_state(rate, dev)
        again, m_r = mae_engine.make_train_step(augment=True, config=cfg_r)(again, wire, 0)
        same = m_r["loss"].item() == results[0] and all(
            torch.equal(p, results[1][n]) for n, p in again.model.named_parameters())
        check(same == (rate == DROPOUT_RATE),
              f"dropout mae: the rate-{rate} step is {'not ' if not same else ''}bit-identical "
              f"to the rate-{DROPOUT_RATE} step")
        del again
    del state, results
    torch.cuda.empty_cache()

    # DINO: teacher and student drop out, each from its own generator
    cfg, state = dino_dropout_state(DROPOUT_RATE, dev)
    compare["dino"] = dino_compare(cfg, state, wire.cpu().numpy(), "dropout dino",
                                   dropout_seed=17)[torch.bfloat16]
    step = dino_engine.make_train_step(cfg)
    zero_launches()
    state, m = step(state, wire, 0, 0.996, 0.04, False)
    torch.cuda.synchronize()
    runs["dino"] = launches()
    loss = m["loss"].item()
    for rate in (DROPOUT_RATE, 0.0):
        cfg_r, again = dino_dropout_state(rate, dev)
        again, m_r = dino_engine.make_train_step(cfg_r)(again, wire, 0, 0.996, 0.04, False)
        same = m_r["loss"].item() == loss and all(
            torch.equal(p, q) for p, q in zip(again.student.parameters(), state.student.parameters()))
        check(same == (rate == DROPOUT_RATE),
              f"dropout dino: the rate-{rate} step is {'not ' if not same else ''}bit-identical "
              f"to the rate-{DROPOUT_RATE} step")
        del again
    depth = {"mae": MAE_BLOCKS, "dino": 12}
    want = {"mae": {"flash_attention_fwd": depth["mae"], "flash_attention_bwd": depth["mae"]},
            "dino": {"flash_attention_fwd": 2 * depth["dino"],
                     "flash_attention_bwd": depth["dino"]}}
    for k in runs:
        expected = {n: want[k].get(n, 0) for n in runs[k]}
        check(runs[k] == expected, f"dropout {k}: launches {runs[k]}; expected {expected}")
    print(f"dropout: MAE (96^3 as shipped) and DINO (as shipped) at rate {DROPOUT_RATE}, batch "
          f"{DROPOUT_BATCH}: kernels against plain attention held; one step each on the main "
          f"path with launches {json.dumps(runs)} (the shipped counts, exactly); a second run "
          f"from seed 0 bit-identical, the rate-0 step different | {card}", flush=True)
    del state
    torch.cuda.empty_cache()
    return {"runs": runs, "compare": compare}


def pad_tokens(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, T, H, D] with zero rows appended to n tokens."""
    if x.shape[1] == n:
        return x
    pad = torch.zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=1)


BLOCKED_NAMES = ("flash_attention_blocked_fwd", "flash_attention_blocked_dkv",
                 "flash_attention_blocked_dq")


def seq_shards_case(shape, s: int, card: str, label: str, backward: bool = True) -> dict:
    """One emulated ``seq`` split of B3 (and with ``backward`` B4/B5) at
    ``shape`` [B, T, H, D] bf16: the port's sharded branch
    (``ops.attention.attend_shard``, through ``BlockedFusedAttention``) once
    per emulated rank, its Q shard of ceil(T/s) rows against the whole padded
    K, V with kv_len = T, and its backward summing the dK and dV partials in
    rank order. O (dQ, dK, dV) are held against the unsharded kernel call
    (``flash_attention``) and the plain versions at BF16_REL_L2, and the
    padded keys' dK and dV must be exactly 0. Each shard's kernels are timed
    (CUDA events) beside their bound, the plain versions, SDPA on the
    shard's real keys and the whole sequence. Returns the timing record and
    the launches of the emulated ranks."""
    from headct_foundation_tpu_torch.ops import attention as port_attn
    from headct_foundation_tpu_torch.ops import flash_attention as fa
    from headct_foundation_tpu_torch.parallel import mesh

    dt = torch.bfloat16
    names = BLOCKED_NAMES if backward else BLOCKED_NAMES[:1]
    B, T, H, D = shape
    q, k, v, do = blocked_inputs(shape, T, dt, seed=T + H + s)
    qf, kf, vf = (x.detach().clone().requires_grad_(backward) for x in (q, k, v))
    o_k = fa.flash_attention(qf, kf, vf)
    o_p, lse_p = fa.blocked_attention_reference(q, k, v)
    kernel, plain = {"o": o_k.detach()}, {"o": o_p}
    if backward:
        o_k.backward(do)
        kernel.update(dq=qf.grad, dk=kf.grad, dv=vf.grad)
        delta = fa.attention_delta(o_p, do)
        dk_p, dv_p = fa.blocked_attention_dkv_reference(q, k, v, do, lse_p, delta)
        plain.update(dq=fa.blocked_attention_dq_reference(q, k, v, do, lse_p, delta),
                     dk=dk_p, dv=dv_p)
    whole = {name: blocked_shard_ms(fa, name, q, k, v, do, T) for name in names}
    tl = mesh.tokens_per_rank(T, s)
    qp, dop = pad_tokens(q, s * tl), pad_tokens(do, s * tl)
    kp = pad_tokens(k, s * tl).requires_grad_(backward)
    vp = pad_tokens(v, s * tl).requires_grad_(backward)
    zero_launches()
    outs, dqs = [], []
    for r in range(s):
        qr = qp[:, r * tl:(r + 1) * tl].clone().requires_grad_(backward)
        if backward:
            o = port_attn.attend_shard(qr, kp, vp, T)
            o.backward(dop[:, r * tl:(r + 1) * tl])  # dK, dV partials summed in rank order
            dqs.append(qr.grad)
        else:
            with torch.no_grad():
                o = port_attn.attend_shard(qr, kp, vp, T)
        outs.append(o.detach())
    torch.cuda.synchronize()
    n = launches()
    for name in names:
        check(n[name] == s, f"{label} {shape} s={s}: {name} launched {n[name]} times, "
                            f"expected {s}")
    got = {"o": torch.cat(outs, 1)[:, :T]}
    if backward:
        got.update(dq=torch.cat(dqs, 1)[:, :T], dk=kp.grad[:, :T], dv=vp.grad[:, :T])
        check(not kp.grad[:, T:].any() and not vp.grad[:, T:].any(),
              f"{label} {shape} s={s}: the padded keys took a gradient")
    errs = {f"{x} vs {ref_name}": rel_l2(got[x], ref[x])
            for ref_name, ref in (("kernel", kernel), ("plain", plain)) for x in got}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= BF16_REL_L2,
          f"{label} {shape} s={s}: {worst} rel_l2 {errs[worst]:.3e} > {BF16_REL_L2}")
    q0, kd, vd = qp[:, :tl], kp.detach(), vp.detach()
    plain_ms = blocked_shard_ms(fa, names, q0, kd, vd, dop[:, :tl], T, plain=True)
    # the library: SDPA over the T real keys; its backward covers B4 and B5 together
    _, lib_fwd, _, lib_bwd = sdpa_backward_ms(q0, k, v, dop[:, :tl])
    shard = {}
    for name in names:
        ms = blocked_shard_ms(fa, name, q0, kd, vd, dop[:, :tl], T)
        bound, by = blocked_bound_ms(name, (B, tl, H, D), s * tl, T, dt)
        w_bound = blocked_bound_ms(name, shape, T, T, dt)[0]
        shard[name] = {"ms": ms, "bound_ms": bound, "bound_by": by, "plain_ms": plain_ms[name],
                       "library_ms": lib_fwd if name == names[0] else None,
                       "library_backward_ms": None if name == names[0] else lib_bwd,
                       "whole_ms": whole[name], "whole_bound_ms": w_bound}
    print(f"{label}: {list(shape)} bf16 at seq {s}: Q shards [{B},{tl},{H},{D}] against "
          f"{s * tl} gathered keys, kv_len {T}; {', '.join(got)} against the unsharded kernel "
          f"call and the plain version worst rel_l2 {errs[worst]:.3e} ({worst}; limit "
          f"{BF16_REL_L2}){'; padded dK, dV exactly 0' if backward else ''}; launches "
          f"{ {BLOCKED_LABEL[x]: n[x] for x in names} }; per shard (CUDA events): " + "; ".join(
              f"{BLOCKED_LABEL[name]} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}%; plain "
              f"{r['plain_ms']:.4f} ms; whole sequence {r['whole_ms']:.4f} ms, "
              f"{100 * r['whole_bound_ms'] / r['whole_ms']:.1f}%)"
              for name, r in shard.items()) + f"; scaled_dot_product_attention on the "
          f"shard, device: forward {lib_fwd:.4f} ms" + (
              f", backward {lib_bwd:.4f} ms (against B4 + B5 + delta)" if backward else "")
          + f" | {card}", flush=True)
    record = {"shape": list(shape), "s": s, "q_shard": [B, tl, H, D], "keys": s * tl,
              "kv_len": T, "rel_l2_worst": errs[worst], "kernels": shard}
    del q, k, v, do, qf, kf, vf, kernel, plain, kp, vp
    torch.cuda.empty_cache()
    return {"timing": record, "launches": {x: n[x] for x in names}}


def _add(total: dict, n: dict) -> None:
    for name, count in n.items():
        total[name] = total.get(name, 0) + count


def phase_context(card: str) -> dict:
    """The ``seq`` split of B3/B4/B5 on one card: ``seq_shards_case`` at each
    CONTEXT_SHAPES shape and s in CONTEXT_SPLITS. Returns the launches of
    the emulated ranks and the timings."""
    timings, total = [], {}
    for shape in CONTEXT_SHAPES:
        for s in CONTEXT_SPLITS:
            case = seq_shards_case(shape, s, card, "context")
            timings.append(case["timing"])
            _add(total, case["launches"])
    return {"launches": total, "timings": timings}


def blocked_shard_ms(fa, name, q, k, v, do, kv_len, plain: bool = False):
    """Device time (CUDA events) of one blocked kernel on these inputs; with
    ``plain``, ``name`` is a tuple of kernels and the result {name: ms} of
    their plain versions."""
    o, lse = fa.blocked_fused_attention(q, k, v, None, kv_len)
    delta = fa.attention_delta(o, do)
    if plain:
        calls = {"flash_attention_blocked_fwd": lambda: fa.blocked_attention_reference(
                     q, k, v, None, kv_len),
                 "flash_attention_blocked_dkv": lambda: fa.blocked_attention_dkv_reference(
                     q, k, v, do, lse, delta, None, kv_len),
                 "flash_attention_blocked_dq": lambda: fa.blocked_attention_dq_reference(
                     q, k, v, do, lse, delta, None, kv_len)}
        return {n: cuda_ms(calls[n], iters=3, warmup=1) for n in name}
    call = {"flash_attention_blocked_fwd": lambda: fa.blocked_fused_attention(q, k, v, None,
                                                                              kv_len),
            "flash_attention_blocked_dkv": lambda: fa.blocked_attention_dkv(
                q, k, v, do, lse, delta, None, kv_len),
            "flash_attention_blocked_dq": lambda: fa.blocked_attention_dq(
                q, k, v, do, lse, delta, None, kv_len)}[name]
    return cuda_ms(call, iters=10, warmup=2, ahead=AHEAD_ONE)


def _head_leaves(shape, layout, g, dt) -> dict:
    """The leaf tensors the attention's q, k, v come from, with the axis of
    their heads: one [B, T, 3, H, D] projection, or on LoRA's layout q and v
    contiguous [B, T, H, D] and k a view of the projection."""
    B, T, H, D = shape
    qkv = torch.randn((B, T, 3, H, D), generator=g, device="cuda", dtype=dt)
    if LORA not in layout:
        return {"qkv": (qkv, 3)}
    return {"q": (torch.randn(shape, generator=g, device="cuda", dtype=dt), 2),
            "qkv": (qkv, 3), "v": (torch.randn(shape, generator=g, device="cuda", dtype=dt), 2)}


def _qkv_of(leaves: dict) -> tuple:
    qkv = leaves["qkv"]
    return (leaves.get("q", qkv[:, :, 0]), qkv[:, :, 1], leaves.get("v", qkv[:, :, 2]))


def tensor_heads_case(shape, t: int, card: str, label: str, backward: bool = True,
                      layout=()) -> dict:
    """One emulated ``tensor`` split of B1 (and with ``backward`` B2) at
    ``shape`` [B, T, H, D] bf16: each rank's H / t heads of the inputs (as
    the column-parallel projection gives them: strided views of a local
    [B, T, 3, H/t, D] qkv, or on LoRA's layout q and v contiguous) through
    ``FusedAttention`` and its backward, held against the matching heads of
    the full call: bit for bit, heads being independent (a difference is
    printed and then held at BF16_REL_L2), and against the plain version
    on the same inputs at BF16_REL_L2. Timed per rank beside the bound, the
    plain version and SDPA. Returns the timing record and the launches."""
    from headct_foundation_tpu_torch.ops import flash_attention as fa

    dt = torch.bfloat16
    B, T, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(T + H + t)
    base = _head_leaves(shape, layout, g, dt)
    do = torch.randn((B, T, H, D), generator=g, device="cuda", dtype=dt)
    full = {k: x.clone().requires_grad_(backward) for k, (x, _) in base.items()}
    o = fa.FusedAttention.apply(*_qkv_of(full))[0]
    if backward:
        o.backward(do)
    o_full = o.detach()
    g_full = {k: x.grad for k, x in full.items()} if backward else {}
    del o, full
    hl = H // t
    heads = lambda x, ax, r: x.narrow(ax, r * hl, hl).contiguous()  # noqa: E731
    zero_launches()
    parts = []
    for r in range(t):
        local = {k: heads(x, ax, r).requires_grad_(backward) for k, (x, ax) in base.items()}
        if backward:
            o = fa.FusedAttention.apply(*_qkv_of(local))[0]
            o.backward(heads(do, 2, r))
        else:
            with torch.no_grad():
                o = fa.FusedAttention.apply(*_qkv_of(local))[0]
        parts.append((o.detach(), {k: x.grad for k, x in local.items()}, local))
    torch.cuda.synchronize()
    n = launches()
    names = ("flash_attention_fwd", "flash_attention_bwd") if backward else \
        ("flash_attention_fwd",)
    for name in names:
        check(n[name] == t, f"{label} {shape} t={t}: {name} launched {n[name]} times")
    plain_err = 0.0  # each rank against the plain version on its own inputs
    for r, (o_r, g_r, local) in enumerate(parts):
        q, k, v = (x.detach() for x in _qkv_of(local))
        o_ref, lse_ref = fa.fused_attention_reference(q, k, v)
        err = rel_l2(o_r, o_ref)
        if backward:
            d_ref = fa.fused_attention_bwd_reference(q, k, v, o_ref, heads(do, 2, r), lse_ref)
            got = _qkv_of({kk: gg for kk, gg in g_r.items()})
            err = max([err] + [rel_l2(a, b) for a, b in zip(got, d_ref)])
        check(err <= BF16_REL_L2, f"{label} {shape} t={t} rank {r}: rel_l2 {err:.3e} "
                                  f"against the plain version (limit {BF16_REL_L2})")
        plain_err = max(plain_err, err)
    o_got = torch.cat([p[0] for p in parts], dim=2)
    pairs = [(o_got, o_full)] + [
        (torch.cat([p[1][k] for p in parts], dim=ax), g_full[k])
        for k, (_, ax) in base.items() if backward]
    equal = all(torch.equal(a, b) for a, b in pairs)
    note = "bit-equal"
    if not equal:
        err = max(rel_l2(a, b) for a, b in pairs)
        note = (f"NOT bit-equal: max |diff| {max((a - b).abs().max().item() for a, b in pairs):.3e}"
                f", rel_l2 {err:.3e} (limit {BF16_REL_L2})")
        check(err <= BF16_REL_L2, f"{label} {shape} t={t}: {note}")
    local = parts[0][2]
    q, k, v = (x.detach() for x in _qkv_of(local))
    o, lse = fa.fused_attention(q, k, v)
    dshape = (B, T, hl, D)
    d_l = heads(do, 2, 0)
    record = {"shape": list(shape), "t": t, "local": list(dshape), "bit_equal": equal,
              "plain_rel_l2": plain_err, "layout": "lora" if LORA in layout else "fused"}
    timed = [("flash_attention_fwd", lambda: fa.fused_attention(q, k, v),
              lambda: fa.fused_attention_reference(q, k, v), False)]
    if backward:
        timed.append(("flash_attention_bwd", lambda: fa.fused_attention_bwd(q, k, v, o, d_l, lse),
                      lambda: fa.fused_attention_bwd_reference(q, k, v, o, d_l, lse), True))
    _, lib_fwd, _, lib_bwd = sdpa_backward_ms(q, k, v, d_l)
    for name, call, plain, bwd in timed:
        ms = cuda_ms(call, iters=10, warmup=2, ahead=AHEAD_ONE)
        bound, by = attention_bound_ms(dshape, dt, backward=bwd)
        record[name] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                        "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                        "library_ms": lib_bwd if bwd else lib_fwd}
    print(f"{label}: {list(shape)} bf16{' on LoRA layout' if LORA in layout else ''} at tensor "
          f"{t}: {t} ranks of {hl} heads against the full call's heads: {note}; against the "
          f"plain version on each rank's inputs: max rel_l2 {plain_err:.3e} (limit "
          f"{BF16_REL_L2}); launches { {x: n[x] for x in names} }; per rank (CUDA events, "
          f"device) " + ", ".join(
              f"{'B2' if name.endswith('bwd') else 'B1'} {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}%; "
              f"plain {r['plain_ms']:.4f} ms; scaled_dot_product_attention "
              f"{'backward ' if name.endswith('bwd') else ''}{r['library_ms']:.4f} ms)"
              for name, r in record.items() if name.startswith("flash")) + f" | {card}",
          flush=True)
    del base, do, o_full, g_full, parts, q, k, v, o, lse
    torch.cuda.empty_cache()
    return {"timing": record, "launches": {x: n[x] for x in names}}


PIPE_LAYOUTS = [(2, 2), (2, 4), (4, 4)]  # (S stages, M microbatches) of the pipe phase
PIPE_CLIPS = (1.0, 1e-3)   # the pipe phase's clip steps: the 96^3 recipe's value
                           # (inactive at random init) and one that clips every leaf


def _grads_of(model, names, loss_fn) -> tuple:
    """(loss, {name: gradient}) of one forward and backward of ``loss_fn``."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    params = dict(model.named_parameters())
    grads = {n: params[n].grad.detach().clone() for n in names}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(),
                                                 dim=0).item()


def phase_pipe(card: str) -> dict:
    """``pipe`` (GPipe, ``parallel/pipeline.py``) of the flagship MAE on one
    card: NCCL puts no two ranks on one card, so the S stages run in this
    process, chained microbatch by microbatch through the per-stage forward
    and backward that ``pipeline_apply`` calls (``emulate_pipeline``), inside
    the engine's ``pipelined_loss``. At batch 32 in bf16, from the same
    weights, masks and batch as the unpipelined step, for each (S, M) of
    PIPE_LAYOUTS: the loss and every trainable gradient within the 96^3
    bf16 TRAIN_TOL of the unpipelined step's, and exactly (8 / S) x M B1 and
    as many B2 launches per stage (8 + 8 at PIPE 2, M = 2 and at PIPE 4, M =
    4), nothing else launched; the forward+backward timed (CUDA events)
    beside the unpipelined one. Steps clipped at GRAD_CLIP 1.0 and 1e-3 (which
    clips every leaf) by the port's per-parameter clip over the stacked
    leaves (``stacked_groups``) against the unpipelined gradients clipped by
    the norms of the stacked tensors (``torch.stack`` over the layers): each
    stacked leaf's clipped norm within 1e-2 and its cosine within TRAIN_TOL. The stacked PIPE
    checkpoint written at full width (as a PIPE state's ``jax_trees`` give
    it: ``blocks`` [12, ...], ``decoder_blocks`` [8, ...]) and read back by a
    one-process warm start, every trunk tensor bit-equal. On a machine with
    two cards or more ``tools.check_data_parallel --pipe 2`` (and with four
    ``--nproc 4 --pipe 2``, DATA 2 x PIPE 2), else a line says they did not
    run."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.data.augment import apply_mae_augment, draw_mae_augment
    from headct_foundation_tpu_torch.data.device_preprocess import wire_to_compute
    from headct_foundation_tpu_torch.engines import mae_engine
    from headct_foundation_tpu_torch.optim.optimizers import clip_by_per_param_norm
    from headct_foundation_tpu_torch.parallel import pipeline
    from headct_foundation_tpu_torch.utils import checkpoint
    from headct_foundation_tpu_torch.utils.torch_interop import load_pretrained_into

    dev = torch.device("cuda")
    cfg = default_config()
    cfg.merge_from_file(str(ROOT / MAE_CONFIG))
    cfg.merge_from_list(["DATA.WIRE_FORMAT", "hu16"])
    state, _ = mae_engine.create_train_state(cfg, 10, 1, seed=0, device=dev)
    model = state.model
    model.train()
    g = mae_engine.step_generator(dev, 11, 0, 0)
    wire = torch.from_numpy(head_phantoms(500, TRAIN_BATCH)).to(dev)
    noise = torch.rand((TRAIN_BATCH, int(np.prod(model.grid_size))), generator=g, device=dev)
    batch = apply_mae_augment(wire_to_compute(wire, cfg, cfg.MAE.IN_CHANS),
                              draw_mae_augment(TRAIN_BATCH, g, dev))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    zero_launches()
    ref_loss, ref = _grads_of(model, names, lambda: model(batch, noise=noise)[0])
    ref_launches = launches()
    check(ref_launches["flash_attention_fwd"] == MAE_BLOCKS
          and ref_launches["flash_attention_bwd"] == MAE_BLOCKS,
          f"pipe: the unpipelined step launched {ref_launches}")
    ref_ms = cuda_ms(lambda: model(batch, noise=noise)[0].backward(), iters=3, warmup=1)
    model.zero_grad(set_to_none=True)
    tol = TRAIN_TOL[torch.bfloat16]
    out = {"layouts": [], "launches": {"flash_attention_fwd": 0, "flash_attention_bwd": 0}}
    clip_grads = None
    for S, M in PIPE_LAYOUTS:
        per_stage = [dict.fromkeys(kernel_wrappers(), 0) for _ in range(S)]

        @contextlib.contextmanager
        def on_stage(s):
            before = launches()
            yield
            for k, v in launches().items():
                per_stage[s][k] += v - before[k]

        def trunk(blocks, x, S=S, M=M):
            return pipeline.emulate_pipeline(pipeline.split_stages(blocks, S), x, M, on_stage)

        zero_launches()
        loss, got = _grads_of(model, names,
                              lambda: mae_engine.pipelined_loss(model, batch, noise, trunk))
        total = launches()
        per = (cfg.MAE.ENCODER_DEPTH // S + cfg.MAE.DECODER_DEPTH // S) * M
        want = {k: (per if k in ("flash_attention_fwd", "flash_attention_bwd") else 0)
                for k in per_stage[0]}
        check(all(st == want for st in per_stage),
              f"pipe S={S} M={M}: launches per stage {per_stage}; expected {want} each")
        check(total == {k: S * v for k, v in want.items()},
              f"pipe S={S} M={M}: launches {total}")
        rel = abs(loss - ref_loss) / abs(ref_loss)
        cos = min(_cosine(got[n], ref[n]) for n in names)
        ok = rel <= tol["loss_rel"] and cos >= tol["grad_cos"]
        ms = cuda_ms(lambda: mae_engine.pipelined_loss(model, batch, noise, trunk).backward(),
                     iters=3, warmup=1)
        model.zero_grad(set_to_none=True)
        shape = PIPE_2 if TRAIN_BATCH // M == PIPE_2[0] else PIPE_4
        print(f"pipe: PIPE {S}, M {M} emulated on one card at batch {TRAIN_BATCH} bf16: loss "
              f"{loss:.6f} vs unpipelined {ref_loss:.6f} (relative {rel:.3e}, tolerance "
              f"{tol['loss_rel']}); over {len(names)} trainable gradients min cosine {cos:.6f} "
              f"(tolerance {tol['grad_cos']}) {'ok' if ok else 'FAILED'}; launches per stage "
              f"{per} B1 + {per} B2 at {list(shape)}, nothing else, exactly; forward+backward "
              f"{ms:.2f} ms against the unpipelined {ref_ms:.2f} ms (CUDA events, the stages "
              f"in series) | {card}", flush=True)
        check(ok, f"pipe S={S} M={M}: the pipelined step disagrees with the unpipelined one")
        out["layouts"].append({"S": S, "M": M, "shape": list(shape), "loss_rel": rel,
                               "grad_cos_min": cos, "per_stage": per, "ms": ms,
                               "unpipelined_ms": ref_ms})
        for k in out["launches"]:
            out["launches"][k] += total[k]
        if (S, M) == PIPE_LAYOUTS[0]:
            clip_grads = got

    # the clip over the stacked leaves against the stacked tensors' own norms:
    # GRAD_CLIP 1.0 (inactive on these gradients) and one that clips every leaf
    params = dict(model.named_parameters())
    stacked = pipeline.stacked_groups(model, emulated=True)
    by_leaf = {}
    for n in names:
        m = re.match(r"^(blocks|decoder_blocks)\.(\d+)\.(.+)$", n)
        by_leaf.setdefault(f"{m.group(1)}.{m.group(3)}" if m else n, []).append(n)
    out["clip"] = []
    for clip in PIPE_CLIPS:
        for n in names:
            params[n].grad = clip_grads[n].clone()
        clip_by_per_param_norm(model.parameters(), clip, stacked=stacked)
        worst_norm, worst_cos, clipped = 0.0, 1.0, 0
        for leaf, members in by_leaf.items():
            want = torch.stack([ref[n].float() for n in members])
            coef = min(clip / (want.norm().item() + 1e-6), 1.0)
            clipped += coef < 1.0
            want = want * coef
            got = torch.stack([params[n].grad.float() for n in members])
            worst_norm = max(worst_norm, abs(got.norm().item() - want.norm().item())
                             / max(want.norm().item(), 1e-30))
            worst_cos = min(worst_cos, _cosine(got, want))
        model.zero_grad(set_to_none=True)
        ok = worst_norm <= 1e-2 and worst_cos >= tol["grad_cos"] and (clip >= 1.0 or clipped)
        print(f"pipe: GRAD_CLIP {clip} over the stacked leaves (PIPE 2, M 2) against the "
              f"unpipelined gradients clipped by their stacked tensors' norms: {len(by_leaf)} "
              f"leaves, {clipped} clipped; worst clipped-norm difference {worst_norm:.3e} (limit "
              f"1e-2), min cosine {worst_cos:.6f} {'ok' if ok else 'FAILED'} | {card}", flush=True)
        check(ok, f"pipe: the stacked-leaf clip at {clip} disagrees with the stacked tensors'")
        out["clip"].append({"clip": clip, "leaves": len(by_leaf), "clipped": clipped,
                            "norm_rel": worst_norm, "cos_min": worst_cos})

    # the stacked checkpoint at full width, and a one-process warm start from it
    pipe_cfg = cfg.clone()
    pipe_cfg.defrost()
    pipe_cfg.PARALLEL.PIPE = 2
    state.config = pipe_cfg
    build = ROOT / "build"
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.perf_counter()
        path = checkpoint.save_checkpoint(state, 0, 1.0, tmp, "pipe.ckpt")
        write_s = time.perf_counter() - t0
        state.config = cfg
        payload = checkpoint.load_checkpoint(path)
        depths = (payload["params"]["blocks"]["attn"]["qkv"]["kernel"].shape[0],
                  payload["params"]["decoder_blocks"]["attn"]["qkv"]["kernel"].shape[0])
        del payload
        fresh, _ = mae_engine.create_train_state(cfg, 10, 1, seed=7, device=dev)
        missing, unexpected = load_pretrained_into(fresh.model, path)
        mine = fresh.model.state_dict()
        trunk_names = [n for n in model.state_dict() if n.startswith(pipeline.TRUNKS)]
        same = all(torch.equal(mine[n], t) for n, t in model.state_dict().items())
        nbytes = os.path.getsize(path)
    ok = depths == (12, 8) and not missing and not unexpected and same
    print(f"pipe: the stacked checkpoint ({nbytes / 2**20:.1f} MiB, blocks [{depths[0]}, ...], "
          f"decoder_blocks [{depths[1]}, ...]) written in {write_s:.2f} s and warm-started into "
          f"one process: {len(missing)} missing, {len(unexpected)} unexpected, every tensor "
          f"({len(trunk_names)} in the trunks) bit-equal {same} {'ok' if ok else 'FAILED'} "
          f"| {card}", flush=True)
    check(ok, "pipe: the stacked checkpoint did not warm-start every trunk tensor")
    del fresh, state, model
    torch.cuda.empty_cache()
    runs = [(MAE_CONFIG, ["--nproc", "2", "--pipe", "2"])]
    if torch.cuda.device_count() >= 4:
        runs.append((MAE_CONFIG, ["--nproc", "4", "--pipe", "2"]))
    out["multi"] = multi_card_runs("pipe", runs)
    return out


def phase_tools(workdir: Path, card: str) -> dict:
    """The four tools and the scipy chain on the cli phase's files:

    * ``tools.build_cache --packed`` over the 32 heads (the cli config's
      windowed wire at 96^3): each packed tensor byte-equal to an uncached
      ``DiskCache`` miss; the per-volume files removed, the MAE main's next
      epoch (``TRAIN.MAX_EPOCHS 1`` on the cli manifests) served from the
      packed index alone: exit 0, 0 placeholders, no per-volume file written,
      20 B1 + 20 B2 per train step and 20 B1 per eval batch;
    * ``tools.export_torch`` of the cli phase's ``latest_`` to a reference
      ``.pt``, loaded into ``FeatureExtractor`` on the card: the CLS of 8
      heads bit-equal to the extractor loaded from the pickle, 12 B1 counted
      at [8,513,12,64] float32;
    * ``tools.parity_check --make-oracle-ckpt`` at ViT-B/12, then the check on
      8 heads (the port's chain on the card against the oracle on the CPU on
      the scipy preprocessing): every cosine >= 0.999, 12 B1 counted;
    * the on-card preprocessing chain (the cache's ``device`` backend)
      against the scipy chain (``python``, HEADCT_NATIVE=0) on 8 heads:
      windowed max < 2e-2 and mean < 1e-4 (the JAX tests' native-vs-scipy
      limits), hu16 steps printed."""
    from headct_foundation_tpu_torch.data import datasets
    from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
    from headct_foundation_tpu_torch.tools import build_cache, export_torch, parity_check

    scans = [str(workdir / f"scan{1000 + i}.nii.gz") for i in range(CLI_SCANS)]  # phase_cli's
    check(all(os.path.exists(p) for p in scans), "tools: the cli phase's heads are missing")
    roi = (96, 96, 96)
    (workdir / "unique.csv").write_text("img_path\n" + "".join(f"{p}\n" for p in scans))
    packed = workdir / "packed"
    t0 = time.perf_counter()
    counts = build_cache.build(str(workdir / "unique.csv"), str(packed), roi=roi[0],
                               in_chans=3, wire="windowed", workers=8, packed=True,
                               log=lambda *a: None)
    build_s = time.perf_counter() - t0
    check(counts == {"done": CLI_SCANS, "errors": 0, "packed": CLI_SCANS, "skipped": 0},
          f"tools: build_cache {counts}")
    reader = datasets.PackedShardReader.open(str(packed))
    cache, uncached = datasets.DiskCache(str(packed), roi, 3), datasets.DiskCache(None, roi, 3)
    differ = [p for p in scans if not np.array_equal(reader.get(cache.key(p)),
                                                     uncached.load(p))]
    check(not differ, f"tools: packed tensors differ from a cache miss: {differ[:3]}")
    for f in packed.glob("*.npy"):
        f.unlink()
    opts = ["DATA.TRAIN_CSV_PATH", str(workdir / "train.csv"),
            "DATA.VAL_CSV_PATH", str(workdir / "val.csv"),
            "DATA.TEST_CSV_PATH", str(workdir / "test.csv"), "DATA.CACHE_DIR", str(packed),
            "MODEL.DIR", str(workdir / "model_tools"), "LOG.OUTPUT_DIR", str(workdir / "log_tools"),
            "OUTPUT", "", "TRAIN.VAL_EVERY", "1", "TRAIN.MAX_EPOCHS", "1"]
    _, result, wall = run_cli(["--cfg", MAE_CONFIG, "--device", "cuda", "--opts", *opts],
                              "tools build_cache epoch", module="main_pretrain_mae")
    runs = check_cli_launches(result, "tools", {"flash_attention_fwd": MAE_BLOCKS,
                                                "flash_attention_bwd": MAE_BLOCKS},
                              {"flash_attention_fwd": MAE_BLOCKS})
    written = list(packed.glob("*.npy"))
    check(result["placeholders"] == 0 and not written,
          f"tools: the packed cache's epoch: {result['placeholders']} placeholders, "
          f"{len(written)} per-volume files written")
    print(f"tools: build_cache --packed of {CLI_SCANS} heads in {build_s:.2f} s (8 threads, "
          f"host clock), each tensor byte-equal to a cache miss; the MAE main's epoch on the "
          f"packed index alone: exit 0 in {wall:.2f} s, 0 placeholders, no per-volume file, "
          f"launches {json.dumps(runs)} | {card}", flush=True)

    latest = workdir / "model_saved" / "latest_mae_headct.ckpt"
    pt = workdir / "export.pt"
    export_torch.export(str(latest), str(pt))
    heads = scans[:EXTRACT_BATCH]
    from_pickle = FeatureExtractor(checkpoint_path=str(latest), device="cuda")
    want = from_pickle.extract_from_files(heads, batch_size=EXTRACT_BATCH)
    del from_pickle
    from_pt = FeatureExtractor(checkpoint_path=str(pt), device="cuda")
    zero_launches()
    got = from_pt.extract_from_files(heads, batch_size=EXTRACT_BATCH)
    export_launches = launches()
    del from_pt
    ok = (np.array_equal(got, want) and export_launches["flash_attention_fwd"] == 12
          and sum(export_launches.values()) == 12)
    print(f"tools: export_torch of {latest.name} -> {pt.name} ({pt.stat().st_size / 2**20:.1f} "
          f"MiB) into FeatureExtractor on the card: CLS of {len(heads)} heads bit-equal to the "
          f"pickle's {np.array_equal(got, want)}, launches {export_launches} "
          f"{'ok' if ok else 'FAILED'} | {card}", flush=True)
    check(ok, "tools: the exported .pt does not give the pickle's CLS with 12 B1")

    head_dir = workdir / "parity_heads"
    head_dir.mkdir()
    for p in heads:
        os.symlink(p, head_dir / Path(p).name)
    oracle = workdir / "oracle.pt"
    parity_check.run(["--make-oracle-ckpt", str(oracle)])
    zero_launches()
    t0 = time.perf_counter()
    report = parity_check.run(["--checkpoint", str(oracle), "--nifti-dir", str(head_dir),
                               "--device", "cuda"])
    parity_s = time.perf_counter() - t0
    parity_launches = launches()
    ok = report["pass"] and parity_launches["flash_attention_fwd"] == 12
    print(f"tools: parity_check on its oracle checkpoint (ViT-B/12 at 96^3), {report['n_scans']} "
          f"heads: min cosine {report['min_cosine']:.6f}, mean {report['mean_cosine']:.6f} "
          f"(threshold 0.999), {'PASS' if report['pass'] else 'FAIL'} in {parity_s:.2f} s; "
          f"launches {parity_launches} | {card}", flush=True)
    check(ok, "tools: parity_check failed on its oracle checkpoint")

    def caches(env):
        os.environ.update(env)
        try:
            return {w: datasets.DiskCache(None, roi, 3, wire=w, device="cuda")
                    for w in ("windowed", "hu16")}
        finally:
            for k in env:
                os.environ.pop(k, None)

    on_card, scipy_chain = caches({"HEADCT_DEVICE_CACHE": "1"}), caches({"HEADCT_NATIVE": "0"})
    check(scipy_chain["windowed"].backend == "python" and on_card["hu16"].backend == "device",
          "tools: the backends were not the device and the python ones")
    mx = mean = 0.0
    steps = 0
    t0 = time.perf_counter()
    for p in heads:
        d = np.abs(on_card["windowed"].load(p).astype(np.float32)
                   - scipy_chain["windowed"].load(p).astype(np.float32))
        mx, mean = max(mx, float(d.max())), max(mean, float(d.mean()))
        steps = max(steps, int(np.abs(on_card["hu16"].load(p).astype(np.int32)
                                      - scipy_chain["hu16"].load(p).astype(np.int32)).max()))
    ms = (time.perf_counter() - t0) / len(heads) * 1e3
    ok = mx < 2e-2 and mean < 1e-4
    print(f"tools: the on-card chain against the scipy chain (HEADCT_NATIVE=0), {len(heads)} "
          f"heads at 0.5x0.5x1.0 mm: windowed max_abs_err {mx:.3e} (limit 2e-2), worst mean "
          f"{mean:.3e} (limit 1e-4); hu16 max {steps} steps (printed); {ms:.1f} ms per head for "
          f"both chains and wires (host clock) {'ok' if ok else 'FAILED'} | {card}", flush=True)
    check(ok, "tools: the on-card chain disagrees with the scipy chain")
    return {"cli": runs, "export": export_launches["flash_attention_fwd"],
            "parity": parity_launches["flash_attention_fwd"],
            "parity_min_cosine": report["min_cosine"],
            "scipy": {"max_abs_err": mx, "mean_abs_err": mean, "hu16_steps": steps}}


def multi_card_runs(label: str, runs, recorded=()) -> dict:
    """On a machine with two cards or more, ``tools.check_data_parallel``
    for each (config, flags) of ``runs`` (torchrun against one process, at
    the tool's limits); on one card a line says they did not run. A run in
    ``recorded`` is one whose miss of the tool's limits on H100s is recorded
    in PERF.md and ROADMAP.md (the downstream main's in float32, rounding
    that its float64 runs hold apart: ROADMAP.md C.12): it must run to its
    result line, and a miss is printed, not raised."""
    if torch.cuda.device_count() < 2:
        print(f"{label}: the multi-process runs ({'; '.join(' '.join(f) for _, f in runs)}) "
              f"did not take place on this machine: it has {torch.cuda.device_count()} card",
              flush=True)
        return None
    out = {}
    for config, flags in runs:
        cmd = [sys.executable, "-m", "headct_foundation_tpu_torch.tools.check_data_parallel",
               "--config", config, *flags]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1800)
        tail = proc.stdout.strip().splitlines()[-3:]
        key = f"{config} {' '.join(flags)}"
        result = json.loads(tail[-1]) if tail and tail[-1].startswith('{"ok"') else None
        missed = proc.returncode != 0 and result is not None and (config, flags) in recorded
        print(f"{label}: {key}: exit {proc.returncode}"
              f"{' (a miss recorded in PERF.md)' if missed else ''}; " + " | ".join(tail),
              flush=True)
        check(proc.returncode == 0 or missed, f"{key} failed the tool's limits or did not "
                                              f"run: {proc.stderr[-2000:]}")
        check(result is not None and result["placeholders"] == 0,
              f"{key}: no result line, or placeholders")
        out[key] = result
    return out


# 48 steps an epoch at batch 32: the kill has 40 steps of epoch 3 to fall in (at
# 12 the log showed epoch 3 mid-way for 4 steps only, and a run missed them); the
# writer joins epoch 1's write before it starts epoch 2's, so from epoch 3 on a
# complete latest_ file is always there
SOAK_ROWS, SOAK_EPOCHS, SOAK_KILL_AFTER = 1536, 3, 2


def phase_soak(workdir: Path, scans: list, card: str) -> dict:
    """The soak tool's SIGKILL and resume of the MAE main on ``scans`` (the
    cli phase's heads, repeated to SOAK_ROWS training rows; val and test
    the heads once), in a subprocess (its own subprocesses are the two
    runs); returns the B1 and B2 launches of both runs by path."""
    from headct_foundation_tpu_torch.engines.mae_engine import LOSS_FLUSH

    data = workdir / "data"
    data.mkdir()
    for split, rows in (("train", (scans * SOAK_ROWS)[:SOAK_ROWS]), ("val", scans),
                        ("test", scans)):
        (data / f"{split}.csv").write_text("img_path\n" + "".join(f"{p}\n" for p in rows))
    prefix = workdir / "soak"
    cmd = [sys.executable, "-m", "headct_foundation_tpu_torch.tools.soak_resume",
           "--scans", str(SOAK_ROWS), "--epochs", str(SOAK_EPOCHS), "--batch", str(TRAIN_BATCH),
           "--kill-after-epoch", str(SOAK_KILL_AFTER), "--data-root", str(data),
           "--out", str(workdir / "out"), "--out-prefix", str(prefix)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"soak: the tool exited {proc.returncode}:\n"
                                f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    result = json.loads((workdir / "soak.json").read_text())
    per_step = {"flash_attention_fwd": MAE_BLOCKS, "flash_attention_bwd": MAE_BLOCKS}
    killed = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    for e in result["phase1_epochs"]:
        want = {k: v * e["steps"] for k, v in per_step.items()}
        check(e["steps"] > 0 and e["launches"] == want and e["placeholders"] == 0,
              f"soak killed run epoch {e['epoch']}: {e}; expected {want}, 0 placeholders")
        for k in killed:
            killed[k] += e["launches"][k]
    resumed = result["phase2_cli"]
    check(resumed is not None and resumed["placeholders"] == 0,
          f"soak resumed run: no JSON line or placeholders: {resumed}")
    resumed_launches = check_cli_launches(resumed, "soak resumed", per_step,
                                          {"flash_attention_fwd": MAE_BLOCKS})
    s = result["seconds"]
    print(f"soak: killed at epoch {result['killed_at']['epoch']} step "
          f"{result['killed_at']['step_in_epoch']} of {result['steps_per_epoch']} (kill after "
          f"epoch {result['kill_after_epoch']}), resumed from the file of epoch "
          f"{result['checkpoint_epoch']} (from 0) at logged epoch "
          f"{result['resume_epoch_restarted']}; losses {result['pre_kill_loss']:.4f} before, "
          f"{result['post_resume_loss']:.4f} after, {result['init_loss']:.4f} at the start; "
          f"killed run {s['phase1']:.2f} s ({result['steps_phase1']} logged steps, "
          f"{len(result['phase1_epochs'])} epochs done: {killed}), resumed run "
          f"{s['phase2']:.2f} s ({result['steps_phase2']} steps: "
          f"{resumed_launches}), kill to the first resumed step logged "
          f"{s['kill_to_first_resumed_step']:.2f} s (its launch to it "
          f"{s['resume_launch_to_first_step']:.2f} s; the first {LOSS_FLUSH} losses are logged at "
          f"once); the tool {seconds:.2f} s | {card}", flush=True)
    return {"killed training": killed, "resumed training": resumed_launches["cli training"],
            "resumed eval": resumed_launches["cli eval"], "seconds": seconds}


def phase_tensor(card: str) -> dict:
    """The ``tensor`` split of B1/B2: ``tensor_heads_case`` at each
    TENSOR_SHAPES shape and t in TENSOR_SPLITS. Then ``split_linear_check``,
    and, on a machine with two cards or more, the MAE CLI under torchrun at
    SEQ 2 and at TENSOR 2 against one process in bf16
    (``tools.check_data_parallel``); on one card a line says it did not
    run."""
    total, timings = {}, []
    for shape in TENSOR_SHAPES:
        for t in TENSOR_SPLITS:
            case = tensor_heads_case(shape, t, card, "tensor")
            timings.append(case["timing"])
            _add(total, case["launches"])
    split_linear = split_linear_check(card)
    multi = multi_card_runs("tensor", [(MAE_CONFIG, ["--nproc", "2", f"--{axis}", "2"])
                                       for axis in ("seq", "tensor")])
    return {"launches": total, "timings": timings, "split_linear": split_linear, "multi": multi}


def phase_mesh(label: str, student, teacher, card: str, layout=()) -> dict:
    """The mesh of one engine's attention on one card: the student's (or
    fine-tune's) B1/B2 on ``tensor`` heads and B3/B4/B5 on ``seq`` shards,
    and the teacher's forward (B1 heads, B3 shards) when given, at t and s
    in MESH_SPLITS. Returns the launches and the timings by kind."""
    total = {}
    out = {"tensor": [], "seq": []}
    for shape, backward in ((student, True), (teacher, False)):
        if shape is None:
            continue
        for n in MESH_SPLITS:
            case = tensor_heads_case(shape, n, card, label, backward, layout)
            out["tensor"].append(case["timing"])
            _add(total, case["launches"])
            case = seq_shards_case(shape, n, card, label, backward)
            out["seq"].append(case["timing"])
            _add(total, case["launches"])
    out["launches"] = total
    return out


def phase_fsdp(card: str) -> dict:
    """The ``fsdp`` layout of the three shipped models on one card: every
    parameter of the MAE, the DINO student (and its teacher's layout, the
    same) and the downstream ViT with LoRA and its attentive classifier,
    built at full width on the card, split into f shards by the rule table
    (``parallel/mesh.py fsdp_dim``, after the ``tensor`` split at t = 1) and
    joined back, bit for bit, at f = 2 and 4; each rank's parameter and
    AdamW-moment bytes printed beside one process's. Kernel B6 on an
    ``fsdp`` shard (the MLP weight's half) against its plain version bit for
    bit, timed beside its bound. On a machine with two cards or more,
    ``tools.check_data_parallel --fsdp 2`` for the three mains and ``--seq
    2`` / ``--tensor 2`` for DINO and the downstream main (DINO's fsdp and
    tensor runs in float32 at batch 32, a float32 miss of the downstream
    main's printed), and the downstream main at DATA, FSDP, SEQ and TENSOR 2
    in float64 at batch 32, held; on one card a line says they did not
    run."""
    from headct_foundation_tpu_torch.config import default_config
    from headct_foundation_tpu_torch.engines import dino_engine, downstream_engine, mae_engine
    from headct_foundation_tpu_torch.ops.lion_kernel import (
        lion_update_leaf,
        lion_update_leaf_reference,
    )
    from headct_foundation_tpu_torch.parallel import mesh

    def config(path, extra=()):
        cfg = default_config()
        cfg.merge_from_file(str(ROOT / path))
        cfg.merge_from_list(list(extra))
        return cfg

    models = {
        "mae": mae_engine.build_mae_model(config(MAE_CONFIG)),
        "dino": dino_engine.build_dino_model(config(DINO_CONFIG)),
        "downstream": torch.nn.ModuleDict({
            "model": dino_engine.build_vit_model(config(DOWNSTREAM_CONFIG), lora=True),
            "classifier": downstream_engine.build_classifier(
                config(DOWNSTREAM_CONFIG, ["TRAIN.CLASSIFIER", "attentive"]))})}
    models = {k: m.to("cuda") for k, m in models.items()}
    g = torch.Generator(device="cuda").manual_seed(17)
    layout = {}
    for label, model in models.items():
        named = list(model.named_parameters())
        with torch.no_grad():
            for _, p in named:
                p.normal_(generator=g)
        one = {"params": sum(p.numel() * 4 for _, p in named),
               "optimizer": sum(2 * p.numel() * 4 for _, p in named)}
        layout[label] = {"one_process": one}
        for f in (2, 4):
            held, split = {"params": 0, "optimizer": 0}, 0
            for name, p in named:
                leaf = name.split(".", 1)[1] if label == "downstream" else name
                dim = mesh.fsdp_dim(leaf, p.shape, f)
                shards = [mesh.split_param(leaf, p, f, j, "fsdp", dim) for j in range(f)]
                check(torch.equal(mesh.join_params(leaf, shards, "fsdp", dim), p),
                      f"fsdp: {label} {name} at f={f} does not join back bit for bit")
                check(all(sh.shape == shards[0].shape for sh in shards),
                      f"fsdp: {label} {name} at f={f}: uneven shards")
                split += dim is not None
                held["params"] += shards[0].numel() * 4
                held["optimizer"] += 2 * shards[0].numel() * 4
            layout[label][f"f{f}"] = {**held, "split_tensors": split}
            print(f"fsdp: {label} at FSDP {f}: {len(named)} tensors, {split} split by the rule "
                  f"table, each split and joined bit for bit; per rank {held['params']} "
                  f"parameter bytes and {held['optimizer']} AdamW-moment bytes (one process "
                  f"{one['params']} and {one['optimizer']}; "
                  f"{100 * held['params'] / one['params']:.1f}%) | {card}", flush=True)
    del models
    torch.cuda.empty_cache()
    # B6 on a shard: the MAE MLP's [3072, 768] weight at FSDP 2 is [3072, 384] per rank
    shape = (3072, 384)
    p = torch.randn(shape, generator=g, device="cuda")
    grad = 1e-2 * torch.randn(shape, generator=g, device="cuda")
    m = 1e-3 * torch.randn(shape, generator=g, device="cuda")
    zero_launches()
    delta, m_new = lion_update_leaf(p, grad, m, *LION_SCALARS)
    torch.cuda.synchronize()
    n = launches()["lion_update"]
    check(n == 1, f"fsdp: lion_update launched {n} times on the shard, expected 1")
    want = lion_update_leaf_reference(p, grad, m, *LION_SCALARS)
    same = torch.equal(delta, want[0]) and torch.equal(m_new, want[1])
    check(same, "fsdp: lion_update on the [3072, 384] shard disagrees with its plain version")
    err = max((a - b).abs().max().item() for a, b in zip((delta, m_new), want))
    ms = cuda_ms(lambda: lion_update_leaf(p, grad, m, *LION_SCALARS), ahead=AHEAD_ONE)
    plain_ms = cuda_ms(lambda: lion_update_leaf_reference(p, grad, m, *LION_SCALARS),
                       ahead=AHEAD_ONE)
    bound, by = lion_bound_ms(p.numel(), torch.float32)
    print(f"fsdp: B6 on a [3072, 384] shard (FSDP 2 of the MAE MLP weight) bit-identical to "
          f"its plain version; {ms:.4f} ms (bound {bound:.4f} ms by {by}, "
          f"{100 * bound / ms:.1f}%; plain {plain_ms:.4f} ms; no library call) | {card}",
          flush=True)
    lion_shard = {"shape": list(shape), "ms": ms, "bound_ms": bound, "bound_by": by,
                  "plain_ms": plain_ms, "library_ms": None, "max_abs_err": err, "launches": n}
    # DINO in bf16 misses the update limit at DATA 2 (= FSDP 2) and TENSOR 2
    # by rounding (PERF.md §5): those layouts are held in float32
    dino_f32 = ["--float32", "--batch", "32"]
    runs = [(MAE_CONFIG, ["--nproc", "2", "--fsdp", "2"]),
            (DINO_CONFIG, ["--nproc", "2", "--fsdp", "2", *dino_f32]),
            (DINO_CONFIG, ["--nproc", "2", "--seq", "2"]),
            (DINO_CONFIG, ["--nproc", "2", "--tensor", "2", *dino_f32])]
    downstream = [(DOWNSTREAM_CONFIG, ["--nproc", "2", f"--{axis}", "2"])
                  for axis in ("fsdp", "seq", "tensor")]
    # the downstream main misses the float32 limits by rounding (ROADMAP.md C.12,
    # its miss printed); in float64 (batch 32: one process's activations on one
    # card) every layout holds the float64 limits
    downstream64 = [(DOWNSTREAM_CONFIG, ["--nproc", "2", *axis, "--float64", "--batch", "32"])
                    for axis in ([], ["--fsdp", "2"], ["--seq", "2"], ["--tensor", "2"])]
    multi = multi_card_runs("fsdp", runs + downstream + downstream64, recorded=downstream)
    return {"layout": layout, "lion_shard": lion_shard, "multi": multi}


def split_linear_check(card: str) -> dict:
    """The Megatron linears' partial products on the card, at the 96^3
    decoder's MLP ([32, 513] tokens, 768 <-> 3072, bf16), t = 2 emulated
    ranks: the row-parallel ``linear2``'s forward and the column-parallel
    ``linear1``'s input gradient, each the ranks' float32 partials
    (``models/layers.py _LinearF32``) summed and rounded once, against the
    unsplit bf16 linear and against partials rounded to bf16 before the sum.
    Each is measured against the float64 product; the float32 partials are
    held at BF16_REL_L2 of the unsplit result."""
    from headct_foundation_tpu_torch.models import layers

    g = torch.Generator(device="cuda").manual_seed(13)
    dt, (B, T, C, F), t = torch.bfloat16, (32, 513, 768, 3072), 2
    out = {}
    # row-parallel linear2: [B, T, F] -> [B, T, C], input columns split
    lin = layers.Linear(F, C, dtype=dt).cuda()
    with torch.no_grad():
        lin.weight.copy_(torch.randn((C, F), generator=g, device="cuda") * F ** -0.5)
        lin.bias.copy_(torch.randn((C,), generator=g, device="cuda") * 0.1)
    x = torch.randn((B, T, F), generator=g, device="cuda", dtype=dt)
    w, w64 = lin.weight.to(dt), lin.weight.to(dt).double()
    truth = x.double() @ w64.t() + lin.bias.to(dt).double()
    w_cols = F // t
    parts = [layers._LinearF32.apply(x[..., r * w_cols:(r + 1) * w_cols],
                                     w[:, r * w_cols:(r + 1) * w_cols]) for r in range(t)]
    split = layers._add_bias(lin, sum(parts))
    rounded = (sum(torch.nn.functional.linear(x[..., r * w_cols:(r + 1) * w_cols],
                                              w[:, r * w_cols:(r + 1) * w_cols]).float()
                   for r in range(t)) + lin.bias.to(dt).float()).to(dt)
    out["row_forward"] = {"unsplit": rel_l2(lin(x), truth), "float32_partials": rel_l2(split, truth),
                          "bf16_partials": rel_l2(rounded, truth),
                          "against_unsplit": rel_l2(split, lin(x))}
    # column-parallel linear1: [B, T, C] -> [B, T, F], its input gradient
    # the sum of the ranks' partials
    w1 = (torch.randn((F, C), generator=g, device="cuda") * C ** -0.5).to(dt)
    dy = torch.randn((B, T, F), generator=g, device="cuda", dtype=dt)
    truth = dy.double() @ w1.double()
    gx = 0
    for r in range(t):
        x32 = torch.zeros((B, T, C), device="cuda", requires_grad=True)
        layers._LinearF32.apply(x32, w1[r * w_cols:(r + 1) * w_cols]).backward(
            dy[..., r * w_cols:(r + 1) * w_cols].float())
        gx = gx + x32.grad
    gx = gx.to(dt)
    rounded = sum((dy[..., r * w_cols:(r + 1) * w_cols] @ w1[r * w_cols:(r + 1) * w_cols])
                  .float() for r in range(t)).to(dt)
    out["column_input_grad"] = {"unsplit": rel_l2(dy @ w1, truth),
                                "float32_partials": rel_l2(gx, truth),
                                "bf16_partials": rel_l2(rounded, truth),
                                "against_unsplit": rel_l2(gx, dy @ w1)}
    for name, e in out.items():
        check(e["against_unsplit"] <= BF16_REL_L2,
              f"split linear {name}: rel_l2 {e['against_unsplit']:.3e} against the unsplit one")
        print(f"tensor: split linear {name} at tensor {t} ([{B}, {T}] tokens, {C} <-> {F}, "
              f"bf16), rel_l2 against the float64 product: unsplit {e['unsplit']:.4e}, "
              f"float32 partials summed then rounded {e['float32_partials']:.4e}, bf16 partials "
              f"{e['bf16_partials']:.4e}; float32 partials against the unsplit "
              f"{e['against_unsplit']:.4e} (limit {BF16_REL_L2}) | {card}", flush=True)
    return out


BENCH_STEPS, BENCH_RUNS = 10, 2  # compute-only: chained steps a timed run, best of
BENCH_LOADER_STEPS = 4          # with-loader: steps an epoch, one warm epoch and one timed
BENCH_SCANS = 6                 # feature-latency: scans (p50 over them)
BENCH_BREAKDOWN_STEPS = 5       # perf_breakdown: iterations a timed run of each variant
BENCH_PROFILE_STEPS = 2         # op_profile: profiled MAE steps
BENCH_ENGINE_STEPS = 3          # the DINO, downstream and 192^3 benches: chained steps a run
BENCH_ATTN_ITERS = 5            # bench_attention and sweep_attention: timed calls a path
BENCH_LOG = "build/bench_phase.jsonl"  # every tool's full output, under the root


def phase_bench(card: str) -> dict:
    """The port's measuring tools in this process at full width: the bench's
    compute-only (its chained loss against the same steps one by one),
    with-loader and feature-latency modes, perf_breakdown's five variants,
    op_profile over MAE steps, the DINO, downstream (fine-tune and lock) and
    192^3 benches, the attention bench and the sweep. Each tool's launches
    over its timed window are held exactly; returns them by tool. Each tool
    gets one line here with the card's name and power limit; its own output
    and full JSON go to ``BENCH_LOG``."""
    log_path = ROOT / BENCH_LOG
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "w") as log:
        return bench_tools(card, log)


def bench_tools(card: str, log) -> dict:
    """``phase_bench``'s runs, the tools' own output written to ``log``."""
    from headct_foundation_tpu_torch import bench
    from headct_foundation_tpu_torch.tools import (
        bench_attention,
        bench_dino,
        bench_downstream,
        bench_longcontext,
        op_profile,
        perf_breakdown,
        sweep_attention,
    )

    mae = {"flash_attention_fwd": MAE_BLOCKS, "flash_attention_bwd": MAE_BLOCKS}
    blocked = {n: 20 for n in ("flash_attention_blocked_fwd", "flash_attention_blocked_dkv",
                               "flash_attention_blocked_dq")}
    runs: dict = {}

    def quiet(fn, *args, **kw):
        """``fn``'s result, its prints sent to the log."""
        with contextlib.redirect_stdout(log):
            out = fn(*args, **kw)
        log.flush()
        return out

    def held(label: str, result: dict, per_step: dict, steps: int, note: str = "") -> None:
        got = result["launches"]
        want = {n: per_step.get(n, 0) * steps for n in got}
        check(got == want, f"bench {label}: launches {got} over {steps} steps; expected {want}")
        runs[label] = {n: k for n, k in got.items() if k}
        log.write(json.dumps({"tool": label, **result}) + "\n")
        rate = (f"{result['value']:.2f} {result['unit']}, " if "value" in result else "")
        print(f"bench {label}: {rate}{result['ms_per_step']:.2f} ms a step{note}; launches "
              f"{json.dumps(runs[label])} = {per_step} a step over {steps} timed steps, "
              f"exactly | {card}", flush=True)

    t_phase = time.perf_counter()
    r = quiet(bench.compute_only, device="cuda", steps=BENCH_STEPS, runs=BENCH_RUNS,
              check_chain=True)
    c = r["chain_check"]
    held("compute-only", r, mae, r["timed_steps"],
         f" (best of {BENCH_RUNS} chains of {BENCH_STEPS}, vs_baseline {r['vs_baseline']:.1f}); "
         f"the first {BENCH_STEPS} chained steps end on loss {c['chained_loss']:.9g}, the same "
         f"steps one by one on {c['single_loss']:.9g} (relative {c['rel']:.3e} <= 1e-6)")
    torch.cuda.empty_cache()
    r = quiet(bench.with_loader, device="cuda", epochs=2, warm_epochs=1,
              steps_per_epoch=BENCH_LOADER_STEPS, workdir=str(ROOT / "build"))
    check(r["placeholders"] == 0 and 0.0 <= r["input_wait_frac"] <= 1.0,
          f"bench with-loader: placeholders {r['placeholders']}, input_wait_frac "
          f"{r['input_wait_frac']}")
    r["ms_per_step"] = TRAIN_BATCH / r["value"] * 1e3
    held("with-loader", r, mae, r["timed_steps"],
         f"; input_wait_frac {r['input_wait_frac']:.4f}, 0 placeholders, H2D "
         f"{r['h2d_MB_per_s']:.0f} MB/s (bound {r['h2d_bound_vols_per_s']:.0f} volumes/s), host "
         f"loader {json.dumps(r['host_loader_vols_per_s_by_workers'])} volumes/s")
    torch.cuda.empty_cache()
    r = quiet(bench.feature_latency, "cuda", n_scans=BENCH_SCANS, workdir=str(ROOT / "build"))
    check(math.isfinite(r["value"]) and r["value"] > 0, f"bench feature-latency: {r}")
    log.write(json.dumps({"tool": "feature-latency", **r}) + "\n")
    print(f"bench feature-latency: p50 {r['value']:.2f} ms a scan over {BENCH_SCANS} scans, "
          f"{json.dumps(r['decomposition_ms'])} | {card}", flush=True)
    torch.cuda.empty_cache()

    r = quiet(perf_breakdown.run, batch=TRAIN_BATCH, steps=BENCH_BREAKDOWN_STEPS,
              runs=BENCH_RUNS, device="cuda")
    per_variant = {"full": mae, "fwd_bwd": mae, "fwd": {"flash_attention_fwd": MAE_BLOCKS},
                   "encoder_fwd_bwd": {"flash_attention_fwd": MAE_ENCODER_BLOCKS,
                                       "flash_attention_bwd": MAE_ENCODER_BLOCKS},
                   "optimizer": {}}
    for name, per in per_variant.items():
        held(f"perf_breakdown {name}", {"launches": r["launches"][name],
                                        "ms_per_step": r["ms_per_step"][name]},
             per, r["steps"] * r["runs"])
    log.write(json.dumps({"tool": "perf_breakdown", **r}) + "\n")
    print(f"bench perf_breakdown: derived ms {json.dumps(r['derived_ms'])}, full "
          f"{r['vols_per_s_per_gpu_full']:.2f} volumes/s | {card}", flush=True)
    torch.cuda.empty_cache()
    r = quiet(op_profile.run, "mae", batch=TRAIN_BATCH, steps=BENCH_PROFILE_STEPS,
              device="cuda")
    quiet(op_profile.report, r)
    check(abs(sum(r["categories"].values()) - 100.0) <= 0.1, f"op_profile shares {r['categories']}")
    held("op_profile", {**r, "ms_per_step": r["device_ms_per_step"]}, mae, BENCH_PROFILE_STEPS,
         " of device time; " + ", ".join(f"{c} {v:.1f}%" for c, v in r["categories"].items()))
    for k in r["top_kernels"][:6]:
        print(f"bench op_profile top: {k['share']:.1f}% {k['ms_per_step']:.3f} ms "
              f"x{k['count_per_step']:g} {k['kernel'][:60]} <- {k['op']} @ {k['frame']}",
              flush=True)
    for k in r["elementwise_sites"][:6]:
        print(f"bench op_profile elementwise site: {k['share']:.1f}% {k['ms_per_step']:.3f} ms "
              f"x{k['count_per_step']:g} {k['op']} @ {k['frame']}", flush=True)
    torch.cuda.empty_cache()

    r = quiet(bench_dino.run, batch=64, steps=BENCH_ENGINE_STEPS, runs=BENCH_RUNS,
              device="cuda")
    held("dino", r, {"flash_attention_fwd": 24, "flash_attention_bwd": 12}, r["timed_steps"])
    torch.cuda.empty_cache()
    for lock in (False, True):
        r = quiet(bench_downstream.run, batch=64, lock=lock, steps=BENCH_ENGINE_STEPS,
                  runs=BENCH_RUNS, device="cuda")
        per = {"flash_attention_fwd": 12, **({} if lock else {"flash_attention_bwd": 12})}
        held("downstream lock" if lock else "downstream fine-tune", r, per, r["timed_steps"])
        torch.cuda.empty_cache()
    r = quiet(bench_longcontext.run, batch=2, steps=BENCH_ENGINE_STEPS, runs=BENCH_RUNS,
              device="cuda")
    held("192^3", r, blocked, r["timed_steps"])
    torch.cuda.empty_cache()

    r = quiet(bench_attention.run, iters=BENCH_ATTN_ITERS, device="cuda")
    calls = 3 + BENCH_ATTN_ITERS  # warm-up and timed calls of each mode
    for name, res in r["shapes"].items():
        check(res["kernel"]["launches"] == {"flash_attention_fwd": 2 * calls,
                                            "flash_attention_bwd": calls}
              and not res["plain"]["launches"] and not res["sdpa"]["launches"],
              f"bench_attention {name}: launches "
              f"{[res[p]['launches'] for p in bench_attention.PATHS]}")
        print(f"bench attention {name} {res['shape']}: forward+backward "
              + ", ".join(f"{p} {res[p]['fwd_bwd_ms']:.4f} ms ({res[p]['tf_s_fwd_bwd']:.1f} TF/s)"
                          for p in bench_attention.PATHS)
              + f"; forward kernel {res['kernel']['fwd_ms']:.4f}, sdpa {res['sdpa']['fwd_ms']:.4f}"
              f" ms | {card}", flush=True)
    runs["attention"] = {n: sum(res["kernel"]["launches"].get(n, 0) for res in r["shapes"].values())
                         for n in ("flash_attention_fwd", "flash_attention_bwd")}
    log.write(json.dumps({"tool": "bench_attention", **r}) + "\n")
    torch.cuda.empty_cache()
    r = quiet(sweep_attention.run, iters=BENCH_ATTN_ITERS, device="cuda")
    sweep: dict = {}
    want = {"whole": {"flash_attention_fwd": 2 * calls, "flash_attention_bwd": calls},
            "blocked": {"flash_attention_blocked_fwd": 2 * calls,
                        "flash_attention_blocked_dkv": calls, "flash_attention_blocked_dq": calls}}
    for res in r["points"]:
        for path, entry in res["paths"].items():
            check(entry["launches"] == want.get(path, {}),
                  f"sweep_attention {res['point']} {path}: launches {entry['launches']}")
            for n, k in entry["launches"].items():
                sweep[n] = sweep.get(n, 0) + k
        check(("whole" in res["left_out"]) == (res["shape"][1] > 1024),
              f"sweep_attention {res['point']}: left out {res['left_out']}")
        print(f"bench sweep {res['point']} {res['shape']}: forward+backward "
              + ", ".join(f"{p} {e['fwd_bwd_ms']:.4f} ms" for p, e in res["paths"].items())
              + "".join(f"; {p} left out: {why}" for p, why in res["left_out"].items())
              + f"; worst kernel rel_l2 {max(e['agreement'][g]['rel_l2'] for e in res['paths'].values() if 'agreement' in e for g in ('o', 'dq', 'dk', 'dv')):.2e} | {card}",
              flush=True)
    runs["sweep"] = sweep
    log.write(json.dumps({"tool": "sweep_attention", **r}) + "\n")
    cross = r["crossovers"]
    print(f"bench sweep: implied pallas_min_t {cross['pallas_min_t']['implied']} (current "
          f"{cross['pallas_min_t']['current']}), implied VMEM_PATH_MAX_T "
          f"{cross['VMEM_PATH_MAX_T']['implied']} (current {cross['VMEM_PATH_MAX_T']['current']};"
          f" the whole path takes no T above it) | {card}", flush=True)
    print(f"bench: phase in {time.perf_counter() - t_phase:.2f} s; every tool's output in "
          f"{BENCH_LOG} | {card}", flush=True)
    return runs


STUDY_LOG = "build/study_phase.jsonl"  # every study tool's output, under the root
STUDY_DIR = "build/study"              # their artifacts
# The study runs are cut in steps (the tools' defaults: 10 x 30 / 25 and 300
# a wire) to hold the phase near 150 s: a step of these loops takes about
# 110 ms on an H100, most of it the host's launches (PERF.md §6).
STUDY_EPOCHS, STUDY_STEPS = 5, 20  # each trajectory: epochs x steps an epoch
WIRE_STEPS, WIRE_SCANS, WIRE_BATCH = 100, 16, 4  # wire_equivalence: steps a wire; cosines
SEMANTICS_EPOCHS, SEMANTICS_STEPS = 4, 50  # dino_semantics: one short horizon
TORCHRUN_RATE_BAND = (0.8, 1.25)  # one card under torchrun against the in-process rate
# tests/test_transfer.py's arguments of the tiny transfer study
TRANSFER_TINY = ["--scale", "tiny", "--classifier", "linear", "--noise", "0.15", "--warp", "0.2",
                 "--probe-train", "8", "--pretrain-epochs", "10", "--pretrain-steps", "50",
                 "--probe-epochs", "4", "--probe-steps", "20", "--pool", "256",
                 "--margin", "0.01", "--min-auroc", "0.7"]


def phase_study(card: str) -> dict:
    """The study tools in this process at full width (the module docstring's
    phase 20d); returns each run's launches. Each tool gets a line here with
    the card's name and power limit; its own output goes to ``STUDY_LOG``."""
    log_path = ROOT / STUDY_LOG
    log_path.parent.mkdir(parents=True, exist_ok=True)
    with open(log_path, "w") as log:
        return study_tools(card, log)


def study_tools(card: str, log) -> dict:
    """``phase_study``'s runs, the tools' own output written to ``log``."""
    from headct_foundation_tpu_torch.tools import (
        bench_int8,
        dino_semantics,
        trajectory,
        transfer_study,
        wire_equivalence,
    )

    out = ROOT / STUDY_DIR
    runs: dict = {}
    t_phase = time.perf_counter()

    def quiet(fn, *args, **kw):
        with contextlib.redirect_stdout(log):
            result = fn(*args, **kw)
        log.flush()
        return result

    def held(label: str, want: dict) -> dict:
        """The launches since ``zero_launches``, exactly ``want``."""
        got = launches()
        want = {n: want.get(n, 0) for n in got}
        check(got == want, f"study {label}: launches {got}; expected {want}")
        runs[label] = {n: k for n, k in got.items() if k}
        return runs[label]

    def per(steps: int, fwd: int, bwd: int = 0, extra_fwd: int = 0) -> dict:
        return {"flash_attention_fwd": steps * fwd + extra_fwd, "flash_attention_bwd": steps * bwd}

    for engine, batch, fwd, bwd in (("mae", 16, MAE_BLOCKS, MAE_BLOCKS), ("dino", 8, 24, 12),
                                    ("downstream", 8, 12, 12)):
        epochs, steps = STUDY_EPOCHS, STUDY_STEPS
        zero_launches()
        t0 = time.perf_counter()
        r = quiet(trajectory.main, ["--engine", engine, "--epochs", str(epochs),
                                    "--steps-per-epoch", str(steps), "--batch", str(batch),
                                    "--device-pool",
                                    "--out-prefix", str(out / f"trajectory_{engine}")])
        got = held(f"trajectory {engine}", per(epochs * steps, fwd, bwd))
        check(all(r["launches"][n] == got.get(n, 0) for n in r["launches"]),
              f"trajectory {engine}: the epochs' launches {r['launches']}, the wrappers' {got}")
        what = {"mae": "", "dino": f", ln K {r.get('ln_k', 0):.4f}",
                "downstream": f", train AUROC by epoch {r.get('epoch_aurocs')}"}[engine]
        log.write(json.dumps({"tool": f"trajectory {engine}", **r}) + "\n")
        print(f"study trajectory {engine}: {r['steps']} steps at batch {batch}, loss start "
              f"{r['start_loss']:.4f}, first 15% {r['head_mean']:.4f}, last 15% "
              f"{r['tail_mean']:.4f}, min {r['min_loss']:.4f}{what}; the tool's assertions "
              f"passed; launches {json.dumps(got)} = ({fwd} B1 + {bwd} B2) x {r['steps']}; "
              f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
        torch.cuda.empty_cache()

    zero_launches()
    t0 = time.perf_counter()
    r = quiet(wire_equivalence.main, ["--steps", str(WIRE_STEPS), "--batch", "16",
                                      "--cosine-scans", str(WIRE_SCANS),
                                      "--out-prefix", str(out / "wire_equivalence")])
    calls = 2 * -(-WIRE_SCANS // WIRE_BATCH)  # hu16 and hu8 windows, batches of 4
    got = held("wire_equivalence", per(2 * WIRE_STEPS, MAE_BLOCKS, MAE_BLOCKS,
                                       extra_fwd=12 * calls))
    series = np.asarray(r["losses_hu16"] + r["losses_hu8"])
    check(len(series) == 2 * WIRE_STEPS and bool(np.isfinite(series).all()),
          "wire_equivalence: a loss series is short or not finite")
    pool = wire_equivalence.make_hu_pool(WIRE_BATCH, 96)  # the tool's first scans
    w16, _ = wire_equivalence.windows(pool)
    bf16 = wire_equivalence.extractor(96, device="cuda").cls_embedding(w16)
    f32 = wire_equivalence.extractor(96, device="cuda", dtype=torch.float32).cls_embedding(w16)
    rel = float(np.linalg.norm(bf16 - f32) / np.linalg.norm(f32))
    check(np.isfinite(bf16).all() and rel <= BF16_REL_L2,
          f"wire_equivalence: the bf16 extractor's CLS is {rel:.3e} from float32 (> {BF16_REL_L2})")
    log.write(json.dumps({"tool": "wire_equivalence", **r, "bf16_vs_f32_cls_rel_l2": rel}) + "\n")
    print(f"study wire_equivalence: {WIRE_STEPS} steps a wire at batch 16, loss hu16 "
          f"{r['loss_hu16_start']:.4f} -> {r['loss_hu16_final']:.4f}, hu8 -> "
          f"{r['loss_hu8_final']:.4f}, mean relative |dloss| {r['mean_rel_dloss']:.3e} (max "
          f"{r['max_rel_dloss']:.3e}), equivalent_training {r['equivalent_training']}; feature "
          f"cosine min {r['feature_cosine_min']:.6f} mean {r['feature_cosine_mean']:.6f} over "
          f"{WIRE_SCANS} scans (bf16 extractor, float32 arithmetic), equivalent_features "
          f"{r['equivalent_features']}; bf16 CLS vs float32 rel_l2 {rel:.3e} (<= {BF16_REL_L2}); "
          f"launches {json.dumps(got)} = ({MAE_BLOCKS} B1 + {MAE_BLOCKS} B2) x {2 * WIRE_STEPS} + "
          f"12 B1 bf16 x {calls} "
          f"extractor calls; {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    torch.cuda.empty_cache()

    zero_launches()
    t0 = time.perf_counter()
    prefix = out / "transfer_tiny"
    r = quiet(transfer_study.main, TRANSFER_TINY + ["--out-prefix", str(prefix)])
    # T = 65 (32^3, patch 8) takes B1/B2: the decoder's 2 blocks a pretrain step, the locked
    # probe's and the extractor's 4 a batch; the masked encoder's T = 17 the plain attention
    arg = lambda name: int(TRANSFER_TINY[TRANSFER_TINY.index(name) + 1])
    pre_steps = arg("--pretrain-epochs") * arg("--pretrain-steps")
    batches = sum(r["probe"][k]["train_steps"] + r["probe"][k]["eval_batches"]
                  + r["launches"][f"extract_{k}"]["batches"] for k in ("pretrained", "random"))
    got = held("transfer tiny", per(pre_steps, 2, 2, extra_fwd=4 * batches))
    ok = (r["auroc_margin"] > 0.01 and r["map_margin"] > 0.01
          and r["probe"]["pretrained"]["best_val_auroc"] > 0.7
          and r["retrieval"]["pretrained"]["mean_map"] > 2 * r["retrieval"]["chance_map"]
          and r["pretrain"]["final_loss"] < r["pretrain"]["start_loss"]
          and (r["png"] is None or os.path.exists(r["png"])))
    check(ok, f"transfer tiny: the JAX slow test's checks failed: {json.dumps(r)[:2000]}")
    print(f"study transfer tiny: pretrain loss {r['pretrain']['start_loss']:.4f} -> "
          f"{r['pretrain']['final_loss']:.4f}; probe best val AUROC pretrained "
          f"{r['probe']['pretrained']['best_val_auroc']:.4f} / random "
          f"{r['probe']['random']['best_val_auroc']:.4f} (margin {r['auroc_margin']}); "
          f"retrieval mAP {r['retrieval']['pretrained']['mean_map']:.4f} / "
          f"{r['retrieval']['random']['mean_map']:.4f} (margin {r['map_margin']}, chance "
          f"{r['retrieval']['chance_map']:.4f}); tests/test_transfer.py's checks passed; "
          f"stages {json.dumps(r['stage_s'])} s; launches {json.dumps(got)} = (2 B1 + 2 B2) x "
          f"{pre_steps} pretrain steps + 4 B1 x {batches} probe and extraction batches (T = 65); "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
    log.write(json.dumps({"tool": "transfer tiny", **r}) + "\n")
    torch.cuda.empty_cache()

    zero_launches()
    t0 = time.perf_counter()
    r = quiet(dino_semantics.main, ["--epochs", str(SEMANTICS_EPOCHS), "--steps-per-epoch",
                                    str(SEMANTICS_STEPS),
                                    "--out-prefix", str(out / "dino_semantics_short")])
    held("dino_semantics", {})  # T = 11: the plain attention, as in JAX
    diags = r["runs"][0]["diags"]
    check(all(math.isfinite(d[k]) for d in diags for k in ("centroid_acc", "within_cos",
                                                           "between_cos", "loss_tail"))
          and all(0.0 <= d["centroid_acc"] <= 1.0 for d in diags),
          f"dino_semantics: diagnostics {diags}")
    print(f"study dino_semantics: {SEMANTICS_EPOCHS} x {SEMANTICS_STEPS} steps at 16, by epoch "
          f"centroid accuracy "
          f"{[d['centroid_acc'] for d in diags]} (chance {r['chance']}), within/between cosine "
          f"{diags[-1]['within_cos']}/{diags[-1]['between_cos']}, loss tail "
          f"{diags[-1]['loss_tail']}; semantics_emerged {r['semantics_emerged']}, retained_at_end "
          f"{r['retained_at_end']} (no gate); no launches (T = 11); "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
    log.write(json.dumps({"tool": "dino_semantics", **r}) + "\n")

    t0 = time.perf_counter()
    r = quiet(bench_int8.run, "cuda")
    for name, e in r["report"].items():
        print(f"study bench_int8 {name} {e['shape']}: bf16 {e['bf16_ms']:.4f} ms "
              f"({e['bf16_TFs']:.1f} TF/s of {bench_int8.DENSE_PEAK['bf16_TFs']:.0f}), int8 "
              f"prequantised {e['int8_prequant_ms']:.4f} ms ({e['int8_prequant_TOPs']:.1f} TOP/s "
              f"of {bench_int8.DENSE_PEAK['int8_TOPs']:.0f}), int8 dynamic "
              f"{e['int8_dynamic_ms']:.4f} ms; speedups {e['speedup_prequant']:.2f}x / "
              f"{e['speedup_dynamic']:.2f}x; the products alone bf16 {e['bf16_alone_ms']:.4f} ms, "
              f"int8 {e['int8_prequant_alone_ms']:.4f} ms ({e['speedup_prequant_alone']:.2f}x); "
              f"the int8 product's first {e['int8_exact_rows']} rows "
              f"equal to an int64 product; chains of {bench_int8.CHAIN} (each product's sum "
              f"feeds the next) | {card}", flush=True)
    log.write(json.dumps({"tool": "bench_int8", **r}) + "\n")
    torch.cuda.empty_cache()

    n = torch.cuda.device_count()
    bench_args = ["-m", "headct_foundation_tpu_torch.bench", "--compute-only",
                  "--chain-steps", str(BENCH_STEPS), "--runs", str(BENCH_RUNS)]
    launcher = ["-m", "torch.distributed.run", "--nproc_per_node", str(n), "--master_addr",
                "localhost", "--master_port", str(free_port())]
    t0 = time.perf_counter()
    # the one-process line from a fresh process too: the chained step is set by
    # the host's launches, which run faster in a new process than in this one
    one, line = (bench_line(cmd, log, label) for cmd, label in (
        (bench_args, "bench one process"), (launcher + bench_args, f"bench torchrun x{n}")))
    if n == 1:
        ratio = line["value"] / one["value"]
        check(set(line) == set(one) and line["launches"] == one["launches"]
              and line["final_loss"] == one["final_loss"]
              and TORCHRUN_RATE_BAND[0] <= ratio <= TORCHRUN_RATE_BAND[1],
              f"bench under torchrun on one card: {line}; one process {one}")
        note = (f"the one-process line's fields, launches and final loss "
                f"({line['final_loss']:.9g}); {ratio:.3f} x its {one['value']:.2f} volumes/s "
                f"(band {TORCHRUN_RATE_BAND})")
    else:
        check(line["n_gpus"] == n and all(math.isfinite(v) for v in line["per_rank"]),
              f"bench under torchrun on {n} cards: {line}")
        note = (f"{n} cards: summed {line['summed']:.2f} volumes/s, per card "
                f"{line['per_card_vs_one']:.3f} x one card's {line['one_card']:.2f}")
    print(f"study bench torchrun --nproc_per_node {n}: {line['value']:.2f} {line['unit']} "
          f"({line['ms_per_step']:.2f} ms a step, best of {BENCH_RUNS} chains of {BENCH_STEPS}); "
          f"{note}; {time.perf_counter() - t0:.2f} s with the process start | {card}", flush=True)
    print(f"study: phase in {time.perf_counter() - t_phase:.2f} s; every tool's output in "
          f"{STUDY_LOG}, the artifacts in {STUDY_DIR}/ | {card}", flush=True)
    return runs


def bench_line(args: list, log, label: str) -> dict:
    """``python args`` from the root; its one JSON line (rank 0's)."""
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and len(lines) == 1,
          f"{label}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    log.write(json.dumps({"tool": label, **json.loads(lines[0])}) + "\n")
    return json.loads(lines[0])


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


WGMMA_BUILDS = {"flash_attention_fwd": 15, "flash_attention_blocked_fwd": 15,
                "flash_attention_bwd": 20, "flash_attention_blocked_bwd": 20,
                "tm_attention": 35}


def report_wgmma_build(_build) -> None:
    """ptxas's registers and spills of each instantiation of the wgmma
    kernels -- the bf16 forward (csrc/flash_fwd_sm90.cuh), the float32
    forward (csrc/flash_fwd_f32_sm90.cuh) and B4/B5 (csrc/flash_bwd_sm90.cuh):
    head dim padded to DP, walked tile NT, copy width -- with its dynamic
    shared memory, and any line where ptxas says it serialized wgmma. A
    spill fails the run. A library built before this run is held by the
    report saved beside it."""
    import ctypes

    fwd_smem = _build.load("flash_attention_blocked_fwd").headct_flash_attention_blocked_fwd_smem
    fwd_smem.argtypes, fwd_smem.restype = [ctypes.c_longlong], ctypes.c_longlong
    f32_smem = _build.load(
        "flash_attention_blocked_fwd").headct_flash_attention_blocked_fwd_f32_smem
    f32_smem.argtypes, f32_smem.restype = [ctypes.c_longlong], ctypes.c_longlong
    bwd_smem = _build.load("flash_attention_blocked_bwd").headct_flash_attention_blocked_bwd_smem
    bwd_smem.argtypes, bwd_smem.restype = [ctypes.c_int, ctypes.c_longlong], ctypes.c_longlong
    kinds = {"flash_fwd_wgmma_kernel": ("forward", fwd_smem),
             "flash_fwd_tf32_kernel": ("float32 forward", f32_smem),
             "dkv_wgmma_kernel": ("dK/dV pass", lambda dp: bwd_smem(1, dp)),
             "dq_wgmma_kernel": ("dQ pass", lambda dp: bwd_smem(0, dp))}
    seen = {}
    for lib in WGMMA_BUILDS:
        log = _build.ptxas_log(lib)
        for line in log.splitlines():
            if "wgmma" in line and "serialized" in line:
                print(f"build: {lib}: ptxas: {line.strip()}", flush=True)
        for entry in log.split("Compiling entry function '")[1:]:
            name = entry.split("'")[0]
            kind = next((k for k in kinds if k in name), None)
            if kind is None:
                continue
            label, smem = kinds[kind]
            ints = [int(x) for x in re.findall(r"Li(\d+)E", name)]  # DP, NT, copy elements
            dp, nt = ints[:2]
            copy = 2 * ints[2] if len(ints) > 2 else 16  # the float32 forward: 16 bytes
            regs = int(re.search(r"Used (\d+) registers", entry).group(1))
            spills = int(re.search(r"(\d+) bytes spill stores", entry).group(1))
            print(f"build: {lib} {label} {kind}<DP {dp}, NT {nt}, {copy}-byte copies>: "
                  f"{regs} registers, {spills} bytes spill stores, {smem(dp)} bytes dynamic "
                  f"shared memory per block", flush=True)
            check(spills == 0, f"{kind} at DP {dp} in {lib} spills {spills} bytes")
            seen[lib] = seen.get(lib, 0) + 1
    check(seen == WGMMA_BUILDS,
          f"ptxas reported {seen} instantiations of the wgmma kernels; expected {WGMMA_BUILDS}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 matmuls
    torch.backends.cudnn.allow_tf32 = False        # and convolutions
    card = card_line()
    print(f"device: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from headct_foundation_tpu_torch.ops import _build
    from headct_foundation_tpu_torch.ops.flash_attention import (
        fused_attention,
        fused_attention_bwd,
        fused_attention_bwd_reference,
        fused_attention_reference,
    )

    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {sorted(_build.SOURCES)} with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (set-up)", flush=True)
    for name, log in sorted(_build.build_logs.items()):  # ptxas -v, per instantiation
        used = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"build: {name} ptxas registers {used} spill-store bytes {spills}", flush=True)

    report_wgmma_build(_build)

    kernel_rows = phase_kernels(fused_attention, fused_attention_reference)
    bwd_rows = phase_bwd_kernels(fused_attention, fused_attention_bwd,
                                 fused_attention_bwd_reference)
    blocked_rows = phase_blocked_kernels()
    lion_row = phase_lion_kernel()
    tm_rows = phase_tm_kernels()
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        serve_launches = phase_slice(Path(tmp))["flash_attention_fwd"]
    fwd_mae = kernel_rows[(MAE_DECODER, torch.bfloat16)]
    bwd_mae = bwd_rows[(MAE_DECODER, torch.bfloat16)]
    depth = MAE_BLOCKS - MAE_ENCODER_BLOCKS  # decoder blocks of both MAE configurations
    train = phase_train(
        "train", MAE_CONFIG, TRAIN_BATCH, TRAIN_BATCH, 100,
        {"flash_attention_fwd": MAE_BLOCKS, "flash_attention_bwd": MAE_BLOCKS},
        {"flash_attention_fwd": MAE_BLOCKS},
        f"the decoder's flash_attention_fwd {depth} x {fwd_mae['ms']:.4f} = "
        f"{depth * fwd_mae['ms']:.2f} ms and flash_attention_bwd {depth} x {bwd_mae['ms']:.4f} = "
        f"{depth * bwd_mae['ms']:.2f} ms, and {MAE_ENCODER_BLOCKS} of each at the encoder's "
        f"[{TRAIN_BATCH},129,12,64]")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dino = phase_dino(card)
    print(f"dino: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dino_bn = phase_dino_bn(card, dino["step_ms"])
    print(f"dino-bn: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    downstream = phase_downstream(card)
    print(f"downstream: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        cli = phase_cli(Path(tmp), card, train["volumes_per_s"])
        print(f"cli: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dino_cli = phase_dino_cli(Path(tmp), card)  # the cli phase's heads and manifests
        print(f"dino-cli: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        extract = phase_extract(Path(tmp), card)  # the cli and dino-cli phases' files
        print(f"extract: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        downstream_cli = phase_downstream_cli(Path(tmp), card)  # its heads, cache, MAE file
        print(f"downstream-cli: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tools = phase_tools(Path(tmp), card)  # the cli phase's heads, manifests and latest_
        print(f"tools: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        (Path(tmp) / "soak").mkdir()
        soak = phase_soak(Path(tmp) / "soak", [str(Path(tmp) / f"scan{1000 + i}.nii.gz")
                                               for i in range(CLI_SCANS)], card)
    print(f"soak: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)

    blocked = ("flash_attention_blocked_fwd", "flash_attention_blocked_dkv",
               "flash_attention_blocked_dq")
    enc_blocks = MAE_ENCODER_BLOCKS
    def per_step(n):
        dec_ms = blocked_rows[(n, STRETCH_DECODER, torch.bfloat16)]["ms"]
        enc_ms = blocked_rows[(n, STRETCH_ENCODER, torch.bfloat16)]["ms"]
        return (f"{n} {depth} x {dec_ms:.4f} + {enc_blocks} x {enc_ms:.4f} = "
                f"{depth * dec_ms + enc_blocks * enc_ms:.2f} ms")

    note = "; ".join(per_step(n) for n in blocked)
    stretch = phase_train(
        "stretch", STRETCH_CONFIG, STRETCH_DECODER[0], STRETCH_COMPARE_BATCH, 200,
        {n: depth + enc_blocks for n in blocked}, {blocked[0]: depth + enc_blocks}, note)
    torch.cuda.empty_cache()

    # The 96^3 MAE trained by the fused Lion update; the train phase has
    # already held its attention kernels against the plain attention.
    lion = phase_train(
        "lion", MAE_CONFIG, TRAIN_BATCH, TRAIN_BATCH, 300,
        {"flash_attention_fwd": MAE_BLOCKS, "flash_attention_bwd": MAE_BLOCKS},
        {"flash_attention_fwd": MAE_BLOCKS},
        "flash_attention_fwd and flash_attention_bwd as in the train phase",
        overrides=["TRAIN.OPTIMIZER", "Lion", "TRAIN.LION_FUSED", True, "TRAIN.GRAD_CLIP", 1.0],
        compare=False)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dropout = phase_dropout(card)
    print(f"dropout: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    t0 = time.perf_counter()
    context = phase_context(card)
    print(f"context: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    t0 = time.perf_counter()
    tensor = phase_tensor(card)
    print(f"tensor: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dino_mesh = phase_mesh("dino-mesh", DINO_STUDENT, DINO_TEACHER, card)
    print(f"dino-mesh: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    t0 = time.perf_counter()
    downstream_mesh = phase_mesh("downstream-mesh", DOWNSTREAM, None, card, layout=(LORA,))
    print(f"downstream-mesh: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    t0 = time.perf_counter()
    fsdp = phase_fsdp(card)
    print(f"fsdp: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe = phase_pipe(card)
    print(f"pipe: phase in {time.perf_counter() - t0:.2f} s | {card}", flush=True)
    torch.cuda.empty_cache()
    bench = phase_bench(card)
    torch.cuda.empty_cache()
    study = phase_study(card)
    torch.cuda.empty_cache()
    tm_launches = phase_tm_bench()
    meshes = {"dino-mesh": dino_mesh, "downstream-mesh": downstream_mesh}

    by_path = {
        "flash_attention_fwd": {"serving": serve_launches,
                                "training": train["train"]["flash_attention_fwd"],
                                "eval": train["eval"]["flash_attention_fwd"],
                                "lion training": lion["train"]["flash_attention_fwd"],
                                "lion eval": lion["eval"]["flash_attention_fwd"],
                                "cli training": cli["cli training"]["flash_attention_fwd"],
                                "cli eval": cli["cli eval"]["flash_attention_fwd"],
                                "dino training": dino["train"]["flash_attention_fwd"],
                                "dino eval": dino["eval"]["flash_attention_fwd"],
                                "dino-cli training":
                                    dino_cli["cli training"]["flash_attention_fwd"],
                                "dino-cli eval": dino_cli["cli eval"]["flash_attention_fwd"],
                                "downstream training":
                                    downstream["train"]["flash_attention_fwd"],
                                "downstream eval": downstream["eval"]["flash_attention_fwd"],
                                "downstream-cli training":
                                    downstream_cli["cli training"]["flash_attention_fwd"],
                                "downstream-cli eval":
                                    downstream_cli["cli eval"]["flash_attention_fwd"],
                                "dino-bn training": dino_bn["train"]["flash_attention_fwd"],
                                "extract retrieval tool":
                                    extract["runs"]["retrieval tool"]["flash_attention_fwd"],
                                "extract card":
                                    extract["runs"]["extract card"]["flash_attention_fwd"],
                                "extract size 641":
                                    extract["runs"]["size 641"]["flash_attention_fwd"],
                                "dropout mae training": dropout["runs"]["mae"]["flash_attention_fwd"],
                                "dropout dino training":
                                    dropout["runs"]["dino"]["flash_attention_fwd"],
                                "tensor heads": tensor["launches"]["flash_attention_fwd"],
                                **{f"{k} tensor heads": m["launches"]["flash_attention_fwd"]
                                   for k, m in meshes.items()},
                                "pipe training": pipe["launches"]["flash_attention_fwd"],
                                "tools epoch training":
                                    tools["cli"]["cli training"]["flash_attention_fwd"],
                                "tools epoch eval": tools["cli"]["cli eval"]["flash_attention_fwd"],
                                "tools export": tools["export"],
                                "tools parity": tools["parity"],
                                **{f"soak {k}": v["flash_attention_fwd"]
                                   for k, v in soak.items() if k != "seconds"},
                                **{f"bench {k}": r["flash_attention_fwd"]
                                   for k, r in bench.items() if r.get("flash_attention_fwd")},
                                **{f"study {k}": r["flash_attention_fwd"]
                                   for k, r in study.items() if r.get("flash_attention_fwd")}},
        "flash_attention_bwd": {"training": train["train"]["flash_attention_bwd"],
                                "lion training": lion["train"]["flash_attention_bwd"],
                                "cli training": cli["cli training"]["flash_attention_bwd"],
                                "dino training": dino["train"]["flash_attention_bwd"],
                                "dino-cli training":
                                    dino_cli["cli training"]["flash_attention_bwd"],
                                "downstream training":
                                    downstream["train"]["flash_attention_bwd"],
                                "downstream-cli training":
                                    downstream_cli["cli training"]["flash_attention_bwd"],
                                "dino-bn training": dino_bn["train"]["flash_attention_bwd"],
                                "dropout mae training": dropout["runs"]["mae"]["flash_attention_bwd"],
                                "dropout dino training":
                                    dropout["runs"]["dino"]["flash_attention_bwd"],
                                "tensor heads": tensor["launches"]["flash_attention_bwd"],
                                **{f"{k} tensor heads": m["launches"]["flash_attention_bwd"]
                                   for k, m in meshes.items()},
                                "pipe training": pipe["launches"]["flash_attention_bwd"],
                                "tools epoch training":
                                    tools["cli"]["cli training"]["flash_attention_bwd"],
                                "soak killed training":
                                    soak["killed training"]["flash_attention_bwd"],
                                "soak resumed training":
                                    soak["resumed training"]["flash_attention_bwd"],
                                **{f"bench {k}": r["flash_attention_bwd"]
                                   for k, r in bench.items() if r.get("flash_attention_bwd")},
                                **{f"study {k}": r["flash_attention_bwd"]
                                   for k, r in study.items() if r.get("flash_attention_bwd")}},
        "flash_attention_blocked_fwd": {"stretch training": stretch["train"][blocked[0]],
                                        "stretch eval": stretch["eval"][blocked[0]],
                                        "extract grid 192":
                                            extract["runs"]["grid 192"][blocked[0]],
                                        "context seq shards": context["launches"][blocked[0]],
                                        **{f"{k} seq shards": m["launches"][blocked[0]]
                                           for k, m in meshes.items()},
                                        **{f"bench {k}": r[blocked[0]]
                                           for k, r in bench.items() if r.get(blocked[0])}},
        "flash_attention_blocked_dkv": {"stretch training": stretch["train"][blocked[1]],
                                        "context seq shards": context["launches"][blocked[1]],
                                        **{f"{k} seq shards": m["launches"][blocked[1]]
                                           for k, m in meshes.items()},
                                        **{f"bench {k}": r[blocked[1]]
                                           for k, r in bench.items() if r.get(blocked[1])}},
        "flash_attention_blocked_dq": {"stretch training": stretch["train"][blocked[2]],
                                       "context seq shards": context["launches"][blocked[2]],
                                       **{f"{k} seq shards": m["launches"][blocked[2]]
                                          for k, m in meshes.items()},
                                       **{f"bench {k}": r[blocked[2]]
                                          for k, r in bench.items() if r.get(blocked[2])}},
        "lion_update": {"lion training": lion["train"]["lion_update"],
                        "fsdp shard": fsdp["lion_shard"]["launches"]},
        "tm_attention_fwd": {"tm bench": tm_launches["tm_attention_fwd"]},
        "tm_attention_bwd": {"tm bench": tm_launches["tm_attention_bwd"]},
    }
    for name, paths in by_path.items():
        check(all(n > 0 for n in paths.values()),
              f"{name} was not launched on every main path: {paths}")

    def row(name, source, replaces, r, shape, dtype, **extra):
        """``replaces`` is a line of the JAX package's ops/flash_attention.py
        or a "file:line" of another TPU kernel."""
        if isinstance(replaces, int):
            replaces = f"headct_foundation_tpu/ops/flash_attention.py:{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"headct_foundation_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
                "shape": list(shape), "dtype": str(dtype)[6:],
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}, **extra}

    def blocked_row(name, replaces):
        dec = blocked_rows[(name, STRETCH_DECODER, torch.bfloat16)]
        enc = blocked_rows[(name, STRETCH_ENCODER, torch.bfloat16)]
        err = max(r["max_abs_err"] for (n, _, _), r in blocked_rows.items() if n == name)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_device",
                "library_ms_device", "backward_ms", "backward_ms_device",
                "library_backward_ms", "library_backward_ms_device")
        # the bf16 kernels are in the sm_90a headers, their C entries in the .cu
        source, entry = (("flash_fwd_sm90.cuh", "flash_attention_blocked_fwd.cu")
                         if name == blocked[0] else
                         ("flash_bwd_sm90.cuh", "flash_attention_blocked_bwd.cu"))
        entry = {"entry": f"headct_foundation_tpu_torch/csrc/{entry}",
                 "at_seq_shards": [{"shape": c["shape"], "s": c["s"], "q_shard": c["q_shard"],
                                    "keys": c["keys"], "kv_len": c["kv_len"],
                                    **c["kernels"][name]} for c in context["timings"]]}
        for k, m in meshes.items():
            entry[f"at_{k.replace('-', '_')}_seq_shards"] = [
                {"shape": c["shape"], "s": c["s"], "q_shard": c["q_shard"], "keys": c["keys"],
                 "kv_len": c["kv_len"], **c["kernels"][name]}
                for c in m["seq"] if name in c["kernels"]]
        if name == blocked[0]:
            entry.update(f32_source, at_extract_192_shape=extract["b3_4097"])
        return row(name, source, replaces, {**dec, "max_abs_err": err}, STRETCH_DECODER, torch.bfloat16,
                   at_encoder_shape={"shape": list(STRETCH_ENCODER),
                                     **{k: enc[k] for k in keys if k in enc}},
                   **{k: dec[k] for k in keys[5:] if k in dec}, **entry)

    f32_source = {"float32_source": "headct_foundation_tpu_torch/csrc/flash_fwd_f32_sm90.cuh"}
    serving = kernel_rows[(SERVING, torch.float32)]
    timing_keys = ("max_abs_err", "ms", "ms_device", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "library_ms_device")

    def at(rows, shape):
        return {"shape": list(shape), "dtype": "bfloat16",
                **{k: rows[(shape, torch.bfloat16)][k] for k in timing_keys}}

    def mesh_heads(name):
        return {f"at_{k.replace('-', '_')}_tensor_heads": [
            {"shape": c["shape"], "t": c["t"], "local": c["local"], "layout": c["layout"],
             "bit_equal": c["bit_equal"], **c[name]} for c in m["tensor"] if name in c]
            for k, m in meshes.items()}

    print(json.dumps({"kernels": [
        # float32 B1 runs the 3xTF32 kernel of the sm_90a header; its C entry is in the .cu
        row("flash_attention_fwd", "flash_fwd_f32_sm90.cuh", 60, serving, SERVING,
            torch.float32, entry="headct_foundation_tpu_torch/csrc/flash_attention_fwd.cu",
            **{k: serving[k] for k in ("ms_device", "library_ms_device", "library_kernels")},
            at_mae_decoder_shape={
                "shape": list(MAE_DECODER), "dtype": "bfloat16",
                "kernel_source": "headct_foundation_tpu_torch/csrc/flash_fwd_sm90.cuh",
                **{k: fwd_mae[k] for k in timing_keys}},
            at_dino_student_shape=at(kernel_rows, DINO_STUDENT),
            at_dino_teacher_shape=at(kernel_rows, DINO_TEACHER),
            at_downstream_shape=at(kernel_rows, DOWNSTREAM),
            at_pipe_2_shape=at(kernel_rows, PIPE_2), at_pipe_4_shape=at(kernel_rows, PIPE_4),
            at_extractor_bf16_shape=at(kernel_rows, EXTRACTOR_BF16),
            pipe_layouts=pipe["layouts"],
            at_extract_641_shape={"shape": list(EXTRACT_641), "dtype": "float32",
                                  **{k: extract["b1_641"][k] for k in timing_keys}},
            at_tensor_heads=[{"shape": c["shape"], "t": c["t"], "local": c["local"],
                              "bit_equal": c["bit_equal"], **c["flash_attention_fwd"]}
                             for c in tensor["timings"]],
            **mesh_heads("flash_attention_fwd")),
        # bf16 B2 and B8 run the passes of the sm_90a header; their C entries are in the .cu
        row("flash_attention_bwd", "flash_bwd_sm90.cuh", 86, bwd_mae, MAE_DECODER,
            torch.bfloat16, entry="headct_foundation_tpu_torch/csrc/flash_attention_bwd.cu",
            **{k: bwd_mae[k] for k in ("ms_device", "library_ms_device")},
            at_dino_student_shape=at(bwd_rows, DINO_STUDENT),
            at_downstream_shape=at(bwd_rows, DOWNSTREAM),
            at_pipe_2_shape=at(bwd_rows, PIPE_2), at_pipe_4_shape=at(bwd_rows, PIPE_4),
            at_tensor_heads=[{"shape": c["shape"], "t": c["t"], "local": c["local"],
                              "bit_equal": c["bit_equal"], **c["flash_attention_bwd"]}
                             for c in tensor["timings"]],
            **mesh_heads("flash_attention_bwd")),
        blocked_row(blocked[0], 256),
        blocked_row(blocked[1], 292),
        blocked_row(blocked[2], 342),
        row("lion_update", "lion_update.cu", "headct_foundation_tpu/ops/lion_kernel.py:31",
            lion_row, LION_CASES[0][0], torch.float32, all_trainable_tensors=lion["lion"],
            at_fsdp_shard=fsdp["lion_shard"]),
        row("tm_attention_fwd", "tm_attention.cu", "tools/experimental_tm_attention.py:55",
            tm_rows["tm_attention_fwd"], MAE_DECODER, torch.bfloat16, **f32_source),
        row("tm_attention_bwd", "flash_bwd_sm90.cuh", "tools/experimental_tm_attention.py:80",
            tm_rows["tm_attention_bwd"], MAE_DECODER, torch.bfloat16,
            entry="headct_foundation_tpu_torch/csrc/tm_attention.cu",
            **{k: tm_rows["tm_attention_bwd"][k] for k in ("ms_device", "library_ms_device")}),
    ]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
