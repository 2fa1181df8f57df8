#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ugpg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ugpg_tpu_torch/csrc with nvcc, one
   nvcc per source, all started together, and beside them csrc/double_conv.cu
   once more with -Xptxas -v: registers and spills of each instance of the
   float32 conv kernel (conv3x3_f32_kernel).
3. Serving kernels: holds each against its plain PyTorch version on the
   card at the stage-4 shapes, batch 8, in bfloat16 and in float32 (TF32
   off for cuDNN and matmul).  Tolerance: max |kernel - plain| <= 1e-4
   (float32) or 2e-2 (bfloat16: the double conv rounds its middle
   activation) times max(1, max |plain|).  Then the uncertainty map of
   2^31 + 11 float32 logits (about 17 GB in and out) against the closed
   form: a body and a tail past 2^31 of two constants, the last 3 elements
   taken by the scalar n % 4 epilogue, whose index would wrap in int32.
4. Times each serving kernel at batch 64 in bfloat16 with CUDA events
   (warm-up, then the median of repeats) beside its plain version, one
   PyTorch library call computing the same function (cuDNN conv pair +
   ReLU, F.interpolate, the sigmoid expression; the port never calls
   these) and the card's bound for the work; each line also gives the
   achieved TFLOP/s (double conv) or GB/s and the share of the bound, and
   the double conv's middle-activation round trip in GB.  The uncertainty
   map is timed at each serving bucket (1, 8, 64) on float32 logits and
   at 64 on bfloat16: CUDA-event, device (torch.profiler, which must show
   exactly one uncertainty kernel per call; at 64 also with the L2 cold,
   the time the kernels line gives) and host time per call.  Then the host
   time per call of each serving kernel through its ctypes wrapper and
   through its operator (torch.ops.ugpg_torch, ops/cuda/library.py, which
   the models and the artifacts call), at bucket 1 in float32.
5. Serves stage 4 at full width through the port's entry points: seeded
   random weights with non-trivial BN stats saved as a reference-format
   .pth, Predictor(buckets=(1, 8, 64)), requests of 1, 5, 8 and 11 images
   in uint8 and float32, 16 concurrent BatchingServer submits, and
   images/s at bucket 64 in bfloat16 with a torch.profiler breakdown of
   one such call, whose double-conv device time must come from the
   tensor-core kernel (conv3x3_mma_kernel) and none from the float32
   CUDA-core kernel (conv3x3_f32_kernel, also none by the C side's own
   launch count), and which gives the uncertainty map's device time in
   serving.  The launch counters, reset just before, must show 9
   double-conv, 4 upsample and 1 uncertainty launches per device call.  A
   float32 GPU Predictor must agree with the same Predictor on
   device="cpu" (probabilities 1e-4).
6. Loss kernels (forward and backward of the uncertainty-weighted BCE):
   against their plain versions at (8,1,R,R) for the four stage
   resolutions, (2,1,17,19), a slice off a 16-byte boundary and 2^24 + 8
   elements, alpha 0, 1 and 2 (means rtol 1e-5, dx 1e-5 x max|dx|), the
   forward bit-identical on a repeat, a 0-d p at alpha = 0 bit-identical to
   a full map of 0.5, the last element at 2^24 + 8 counted, and one case of
   2^31 + 2^24 elements against the closed form; then timed at batch 8 for
   the four stage resolutions, batch 64 at 256 px, and alpha = 0 at 32 px:
   CUDA-event, device (torch.profiler, which must show exactly one forward
   kernel per forward call) and host time per call, beside the plain
   versions, F.binary_cross_entropy_with_logits (and its autograd backward)
   and the byte bound.
7. Trains, the training path: UncertaintyGuidedProgressiveTrainer at full
   width with fused_loss=True, stages 1-4 (32-256 px, 2 epochs each) on
   the synthetic disk task, 16 train and 8 validation images, batch 8.
   The counters, reset just before, must show one forward and one backward
   loss launch per train step and none from validation; the losses must be
   finite, the stage >= 2 uncertainty means > 0, a .pth per stage written;
   the stage-4 .pth then serves one request (9/4/1 launches per call).
   Prints images/s per stage and a torch.profiler breakdown of one stage-4
   step.
8. One stage-4 step, fused vs plain loss, from the same weights and batch;
   one stage-2 step at width 0.25 on the card vs on the CPU.
9. Trains on MoNuSeg, segmentation's main path.  The script writes a
   MoNuSeg tree with the standard library (struct, zlib), no PIL: 32
   patches of 256 px (PNG, about 30 polygon nuclei each, in train/aug) and
   four 1000 x 1000 Deflate TIFF tiles of about 400 nuclei (two in train,
   two in val), each with its Aperio XML.  The port's rasterizer must give
   the pixel count Pillow 12.1.0 gives for a fixed polygon set (embedded).
   AugMoNuSegTrainer at full width, fused_loss=True, augment=True, batch 8,
   num_workers=4, stages 1-4 at 1 epoch each through the loaders and the
   device prefetch queue; then one stage-2 epoch with aug_quantize=8.  The
   counters, reset before each run, must show one loss forward and one
   backward per train step and none from validation; the losses must be
   finite, pos_weight (1 - r) / r from the masks, a .pth per stage written,
   and the stage-4 .pth must serve one request (9/4/1 launches per call).
   The augmentation on the card must equal its CPU run on the same
   parameters (images 1e-5, masks exactly; continuous and 8 grid angles).
   Prints images/s per stage, the host decode + rasterize + resize time per
   batch, the time per step the steps waited on the prefetch queue and a
   torch.profiler breakdown of one stage-4 augmented step.
10. MoNuSeg through the command lines, on phase 9's tree.  Trains with
   `python -m ugpg_tpu_torch.cli.train_monuseg` in a child process (full
   width, --epochs 2, --checkpoint_every 1, batch 8) and sends it SIGTERM
   when it prints its first "Stage 2, Batch" line: the child must exit 75
   and leave ug_pgunet_stage2_last.pth at stage 2, epoch 0, with optimizer
   state and history, and no stage-3 file.  The same command with --resume
   must exit 0 with a _best.pth for stages 1-4 and exactly 8 epochs, none
   repeated, in training_log.csv and the history.  Then test_monuseg runs
   in this process on the stage-4 _best.pth (--eval_full, once with
   --native_res, --num_images 2 --save_uncertainty, and --infer_dir on the
   validation tiles): finite metrics in both JSON files, every PNG read
   back by the port's decoders, and the counters, reset just before,
   showing 9 double-conv, 4 upsample and 1 uncertainty launches per
   forward and no call of a plain version.  The evaluator and
   SlidePredictor on the card against the same on device="cpu" on one
   tile cropped to 400 x 344 px (padded to 400 x 352), with the trained
   checkpoint and phase 5's seeded one: probabilities and uncertainty
   1e-4, preds equal except within 1e-4 of the threshold, native metrics
   1e-4.
   Each of the three kernels against its plain version at every stage-4
   native-evaluation shape (float32, batch 1, 1008 -> 63 px) with phase
   3's tolerance.  Prints the float32 double conv's event time per stage-4
   forward at 1008 px, batch 1, and at 256 px, batch 8 (the stage-resolution
   evaluator's shapes), per shape and in total, beside cuDNN's pair (float32,
   TF32 off), its plain version and its FP32 bound, with each launch's BN,
   tile, blocks, registers and spills; seconds per tile of native
   evaluation, images/s of the stage-resolution evaluation and a
   torch.profiler breakdown of one native-resolution forward, in which the
   float32 conv kernel must show device time and 18 launches (and 18 by the
   C side's count).
11. Herlev classification, the classification workload's main path.  The
   script writes a Herlev tree with struct: the 7 class folders, 12 BMPs
   each, 64-512 px a side with odd widths, 24-bit bottom-up, some 32-bit
   and some top-down; the port's decoder must return every written pixel.  Trains
   with `python -m ugpg_tpu_torch.cli.train_herlev` in a child (stages
   1-4, --epochs 2, --batch_size 16, float32, the in-memory 70/20/10
   split) and sends it SIGTERM at its first "Stage 2, Batch" line: exit 75
   and herlev_stage2_last.pth at stage 2, epoch 1; then the same command
   with --resume in this process: exit 0, a _best.pth per stage, each
   (stage, epoch) once in training_log.csv and the history, finite
   losses, stage >= 2 uncertainty-weight means above 1 and no loss-kernel
   launch.  Train images/s per stage at batch 16 (the train split read 8
   times an epoch, 28 steps; three timed epochs after a warm one, each
   epoch's rate and their spread; the loader alone over one epoch; the
   step alone on one batch) and a profile of one stage-4 train step.  test_herlev on the
   stage-4 _best.pth (the test split, then --predict): finite metrics, and
   the counters, reset just before, showing 4 double-conv calls per
   forward, 8 conv3x3_f32_kernel launches by the C side's count and no
   plain-version call.  The classification Predictor (buckets 1, 8, 64)
   on a seeded full-width stage-4 checkpoint in bf16, uint8 and float32
   and with mc_dropout=8: requests of 1, 5, 8, 11 images, 16 concurrent
   BatchingServer submits, float32 card vs CPU (probabilities 1e-4,
   labels equal away from ties), images/s at bucket 64 in bf16 with a
   profile whose double-conv time is conv3x3_mma_kernel's, bucket-1
   latency over 50 requests, 4 double-conv launches per device call.  The
   double conv against its plain version at every classifier shape in
   bf16 and float32 (and stage 1's at batch 1), and one stage-4
   classifier forward's double convs timed at bucket 64 in bf16 and batch
   16 in float32 beside cuDNN's pair and the bound.
12. The serving stack and MoNuSeg's tools, on phase 5's seeded stage-4
   checkpoint, phase 11's seeded classifier and phase 9's tree.  The
   export command (python -m ugpg_tpu_torch.cli.export_model, buckets 1 8
   64) in two children, float32 and --uint8 --compact, beside the demo
   command (--demo all --stages 2 --epochs 1) and the augment command
   (--variants 1, on a copy of the tree's tiles).  Each artifact on the
   card answers bit for bit as the live float32 Predictor on requests of
   1, 5, 8 and 11 images (uint8 and float32), with 9 double-conv, 4
   upsample and 1 uncertainty launches per device call and 18
   conv3x3_f32_kernel launches by the C side's count; a profiled bucket-64
   call shows the float32 conv kernel's device time and no library conv
   kernel; images/s at bucket 64, live and exported in turns; 16
   concurrent BatchingServer submits; the artifact loaded on the CPU
   within 1e-4 of the live CPU Predictor.  The classifier exported plain
   and with mc_dropout=8 (4 double convs per device call) and the slide
   predictor at 1000 px (18 float32-conv launches), bit for bit.  The
   serve command in a child with --model, --cls_model --mc_dropout 8,
   --slide_model and --artifact: 16 concurrent single-image POSTs equal
   the direct call in fewer than 16 device calls, a batch, a JSON
   classification and a slide bit for bit, latency over 50 requests per
   model, SIGINT and an exit within 10 s.  The augment command's patches
   against extract_patches' grid, every PNG and XML read back, and one
   stage-1 AugMoNuSegTrainer epoch on them.
13. W8A8 int8 serving (``Predictor(quantize=True)``, ``ops/quant.py``) on
   phase 5's seeded stage-4 checkpoint and phase 11's seeded classifier,
   calibrated on 8 seeded images.  ``_conv_i8`` (``torch._int_mm`` on 3x3
   patches) on the card equals int64 sums on the CPU at 1024 channels of
   +-127 and at K = 27.  The int8 Predictor at buckets 1, 8, 64, 128 on
   requests of 1, 5, 8, 11 images: 4 upsample and 1 uncertainty launches per
   device call, no double conv.  Its logits against the float32 Predictor's
   on the card (``tests/test_quant.py``'s RMS bound; decisions equal away
   from 1e-3 of the threshold in 99.9% of pixels, or no more than 0.05
   points below the JAX package's int8 program (the same model with JAX's
   bf16 resize) on the same images, where that falls short); against the same
   ``QuantizedModel`` on the CPU (max |d| and the share of int8 values that
   differ at each point, printed).  The export command's ``--quantize
   --calibration`` artifact bit for bit as the live int8 Predictor.  Images/s
   int8 against bf16 at buckets 64 and 128 and the Herlev classifier at 64,
   in turns (median and spread of 5 calls); one bucket-64 call profiled, its
   device time split into host copies, int8 GEMM, patch gather, upsample,
   epilogue and the rest, beside its idle share; the peak memory of a
   bucket-128 call.  The int8 path's upsample is the bf16-taps instance
   (``upsample2x_bf16_taps``, JAX's bf16 resize rounding): 4 of its launches
   per device call, none of ``upsample2x``; card and CPU give every int8
   point equal and the logits within 1e-5.
14. The trainers' last single-device options and the uncertainty pipeline.
   The bf16-taps upsample against its plain version bit for bit at the four
   stage-4 Up shapes at buckets 8 and 64, timed at bucket 64 beside the
   float32-tap instance, F.interpolate and the byte bound.  remat at full
   width: a stage-4 float32 segmentation step at batch 8 (fused loss, the
   frozen stage 3) and a Herlev stage-4 step at batch 16, each with and
   without remat from the same weights, cuDNN deterministic: the
   gradients and the BN state equal bit for bit; the peak memory and step
   time of each.  The pipeline at full width: UncertaintyPipeline on
   [cuda:0, cuda:0] (n_unc=1) for segmentation stage 4 (the previous stage
   at 128 px), batch 8, fused_loss, augment, depth 2, over 6 batches:
   step 0 against the fused step on the same drawn parameters (rtol 2e-5),
   one loss forward and one backward launch per step; the pipelined epoch
   against the fused steps in turns (median and spread of 5); one
   pipelined step traced with ``utils.profiling.trace`` (the file names
   both pipeline regions) and its device idle share.  Herlev stage 2
   through the classification pipeline: step 0 against the fused step
   (rtol 2e-5).  The command line on phase 9's tree: ``train_monuseg
   --remat --tb_logdir``, one stage-1 epoch (events written, or the one
   warning), and ``--pipeline_unc 1`` on one card exiting 2 with the JAX
   package's message.
15. Serving on a device mesh, every mesh [cuda:0] * n (one card named more
   than once: the halo and gather overhead, not scaling).  conv3x3 (one
   launch of the double conv's kernel) against its plain version in bf16
   and float32 at the stage-4 convs and at the half-channel slices of the
   column-parallel ones.  spatial_predict at stage 4 on a 1000 px slide
   padded to each grid's divisor, 2 x 1 and 2 x 2 (W over "model"), float32,
   against native_forward on the same padded image: probabilities and
   uncertainty 1e-4, decisions equal away from 1e-4 of the threshold, 18
   conv3x3 and 1 uncertainty launches per shard (TF32 off, asserted); CUDA-
   event ms and peak memory beside the unsharded forward; bf16's gap.  The
   mesh Predictor: data 2 at bucket 64 in bf16 and float32 against the
   unsharded Predictor (1e-6), shard_model on a 1 x 2 mesh at bucket 8
   (1e-5), int8 data-parallel (every output and int8 point equal).  serve
   --mesh 1 bit for bit as without it, test_monuseg --native_res --mesh 1 on
   phase 10's tree within 1e-4 of the run without it, serve --mesh 2 on one
   card exiting 2 with the visible-devices message.  conv3x3 timed over one
   shard's 18 convs of the 2 x 1 grid at 1024 px, float32.
16. Training on a device mesh, every mesh [cuda:0] * n (the overhead,
   not scaling), TF32 off.  The trainer at full width on synthetic disks
   (batch 8, fused loss, stages 1-2) on 2 x 1 and on 2 x 2 with
   shard_model: each stage's first step against the unsharded trainer from
   the same seed (metrics rtol 2e-5), one loss forward and one backward
   launch per data shard, the loss kernels held against their plain
   versions on those shards' own inputs, stage-2 images/s against the
   unsharded trainer in turns.  The spatial train step at stage 4, full
   width, on a 992 x 992 crop of a phase-9 tile (the seeded stage 3 as the
   uncertainty source), 2 x 1 and 2 x 2 (W over "model"): step 0 against
   the unsharded make_seg_train_step on the crop (metrics rtol 2e-4, BN
   stats 1e-4), 14 conv3x3 and one loss forward and backward launch per
   shard, both held on their own inputs, seconds per step and peak memory
   against the unsharded step.  train_monuseg --mesh 2 --native_finetune 1
   on phase 9's tree and its _native.pth served by SlidePredictor;
   train_herlev --mesh 2 on phase 11's tree.
17. The pipeline's device groups and training over processes, TF32 off.
   UncertaintyPipeline on [cuda:0] * 6 with n_unc=2, n_model=2 (a 2 x 2
   train mesh with column-parallel convs, a 2 x 1 unc mesh): segmentation
   stage 4, full width, batch 8, fused loss, augment, depth 2, over 6
   batches; step 0 against the unsharded fused step on the same draws
   (rtol 2e-5); one loss forward and one backward launch per train data
   shard and step, the loss kernels held on those shards' inputs;
   images/s against the fused steps in turns (median and spread of 5);
   Herlev stage 2 through the classification pipeline on the same groups
   (step 0, rtol 2e-5).  Two gloo processes spawned on the card (NCCL
   cannot run two ranks on one card), each on a one-device local mesh:
   stage 2 at full width, global batch 8, fused loss; step 0's metrics and
   BN stats against one process on the 2 x 1 mesh (rtol 2e-5), the
   parameters bit for bit equal across the processes, one loss forward
   and one backward launch per process.  train_monuseg --mesh 1 under a
   coordinator on phase 9's tree, 2 processes, stage 1, one epoch: both
   exit 0 and only process 0 writes; serve --mesh 1 under a coordinator
   exits 2 with the reason.
18. Whole epochs (``scan_epochs``), TF32 off, cuDNN deterministic: the
   trainer at full width, float32, batch 8, fused loss, augmented, noisy
   disks at 256 px, 24 batches and a ragged tail of 4 in 3 chunks, stages
   1 and 4 (a seeded stage 3 as the frozen source): the whole-epoch path
   replays a CUDA graph of the step (3 warm-up steps, 1 capture) and its
   train and validation epochs, parameters and BN statistics equal the
   per-step path's bit for bit (else within twice the per-step path's own
   run-to-run distance, printed); one loss forward and one backward launch
   per step, the kernels held on the last replayed step's own inputs.
   Stage-1 and stage-4 images/s of both paths in turns (median and spread
   of 5; stage 4 also without augmentation), host us per step and per
   replay, the device's idle share, capture seconds, peak memory.
   Herlev stage 2 (batch 16) through both paths, the plateau scheduler
   halving the learning rate after every epoch, equal, one capture.
   train_monuseg --scan_epochs --scan_chunk_mb 64 on phase 9's tree and
   train_herlev --scan_epochs on phase 11's, at once: exit 0, epoch logged.
19. The JAX package's checkpoint formats, flax-msgpack, orbax and
   orbax-async directories, TF32 off.  Phase 5's seeded stage 4 saved as a
   .pth and as a directory of each form: the directory's variables,
   decoded, equal the state dict bit for bit, and a bucket-64 bf16
   Predictor from each answers as the .pth's bit for bit, each directory's
   call launching 9 double-conv, 4 upsample and 1 uncertainty kernels.  On
   phase 9's tree, train_monuseg --checkpoint_backend msgpack, orbax and
   orbax-async (stages 1-2, two epochs) in three children at once, SIGTERM
   at each one's first "Stage 2, Batch" line: exit 75 and a
   ug_pgunet_stage2_last directory of its form, no .pth; --resume in this
   process with the fused loss: every epoch logged once, one loss forward
   and backward launch per step (4 + 4); one step from the restored _last
   equals the resumed run's next step bit for bit (cuDNN deterministic).
   test_monuseg on the msgpack _best directory equals it on the same
   weights as a .pth, and the serve command (in a child) answers from the
   seeded msgpack and orbax-async directories as from their .pth, bit for
   bit.  train_herlev --checkpoint_backend msgpack (stage 1, one epoch, on
   phase 11's tree written again, in a child) and test_herlev on its _best
   directory.  Then the save and restore seconds and the bytes of a
   full-width stage-4 _last (weights, RMSprop state, history) as a .pth and
   as a directory of each form, the median of 3 in turns; for orbax-async
   also the seconds until save_checkpoint returns (the host snapshot).
20. The .pth conversion commands on phase 19's files, TF32 off.
   export_torch in children on phase 19's seeded stage-4 msgpack and orbax
   directories: exit 0, each .pth's tensors the directory's decoded state
   dict bit for bit with int64 zero num_batches_tracked, and a bucket-64
   bf16 Predictor from each .pth answering as from its directory bit for
   bit, each call launching 9 double-conv, 4 upsample and 1 uncertainty
   kernels.  import_torch in a child on phase 5's seeded .pth: exit 0, its
   variables.msgpack decoded equal to the .pth's tensors bit for bit, and
   test_monuseg on the imported directory giving the .pth's metrics with
   the same launches.  export_torch --task classification of phase 19's
   Herlev _best directory: test_herlev on the .pth gives the directory's
   results with the same launches.  Logs whether matplotlib is present and
   the plot files the evaluation wrote (none without it).
21. Prints a "kernels" JSON line, then as its last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero without the last line.  Without
CUDA, or without the port next to this file, it fails at once.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import http.client
import io
import itertools
import json
import math
import re
import shutil
import os
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")

from ugpg_tpu_torch import native  # noqa: E402
from ugpg_tpu_torch.data.augment import (  # noqa: E402
    apply_monuseg_params,
    sample_herlev_params,
    sample_monuseg_params,
)
from ugpg_tpu_torch.data.loader import DataLoader, prefetch_to_device  # noqa: E402
from ugpg_tpu_torch.data.monuseg import load_rgb, resize_image, resize_mask  # noqa: E402
from ugpg_tpu_torch.data.rasterize import parse_polygons, rasterize_polygons  # noqa: E402
from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset  # noqa: E402
from ugpg_tpu_torch.cli import (  # noqa: E402
    augment_monuseg,
    test_herlev,
    test_monuseg,
    train_herlev,
)
from ugpg_tpu_torch.data.herlev import CLASS_NAMES, HerlevDataset  # noqa: E402
from ugpg_tpu_torch.data.monuseg import AugMoNuSegDataset, MoNuSegDataset  # noqa: E402
from ugpg_tpu_torch.eval.monuseg import MoNuSegEvaluator  # noqa: E402
from ugpg_tpu_torch.eval.exported import ExportedPredictor  # noqa: E402
from ugpg_tpu_torch.eval.serving import BatchingServer, Predictor, stage_model  # noqa: E402
from ugpg_tpu_torch.eval.slide import (  # noqa: E402
    ExportedSlidePredictor,
    SlidePredictor,
    native_forward,
)
from ugpg_tpu_torch.io.checkpoint import (  # noqa: E402
    full_classifier_state_dict,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
    wait_for_async_saves,
)
from ugpg_tpu_torch.models.classifier import (  # noqa: E402
    CLS_STAGE_RESOLUTIONS,
    ENCODER_SPECS,
    HerlevClassificationModel,
)
from ugpg_tpu_torch.models.folding import fold_batchnorm  # noqa: E402
from ugpg_tpu_torch.models.blocks import init_parameters  # noqa: E402
from ugpg_tpu_torch.models.pgunet import PGUNet1, PGUNet2, PGUNet3, PGUNet4  # noqa: E402
from ugpg_tpu_torch.ops import quant  # noqa: E402
from ugpg_tpu_torch.ops.cuda import _lib  # noqa: E402
from ugpg_tpu_torch.ops.cuda import double_conv as double_conv_mod  # noqa: E402
from ugpg_tpu_torch.ops.cuda import resize2x as resize2x_mod  # noqa: E402
from ugpg_tpu_torch.ops.cuda import uncertainty as uncertainty_mod  # noqa: E402
from ugpg_tpu_torch.ops.cuda import uncertainty_bce as uncertainty_bce_mod  # noqa: E402
from ugpg_tpu_torch.ops.cuda import library as library_ops  # noqa: E402
from ugpg_tpu_torch.ops.cuda.double_conv import (  # noqa: E402
    F32_TILE,
    f32_blocks,
    f32_launches,
    f32_plan,
    fused_double_conv,
    fused_double_conv_reference,
    pack_double_conv,
)
from ugpg_tpu_torch.ops.cuda.resize2x import (  # noqa: E402
    upsample2x,
    upsample2x_bf16_taps,
    upsample2x_bf16_taps_reference,
    upsample2x_reference,
)
from ugpg_tpu_torch.ops.resize import upsample2x_bilinear_align_corners  # noqa: E402
from ugpg_tpu_torch.ops.cuda.uncertainty import (  # noqa: E402
    uncertainty_from_logits,
    uncertainty_from_logits_reference,
)
from ugpg_tpu_torch.ops.cuda.uncertainty_bce import (  # noqa: E402
    uncertainty_weighted_bce_backward,
    uncertainty_weighted_bce_backward_reference,
    uncertainty_weighted_bce_forward,
    uncertainty_weighted_bce_reference,
)
from ugpg_tpu_torch.train.aug_trainer import AugMoNuSegTrainer  # noqa: E402
from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer  # noqa: E402
from ugpg_tpu_torch.train.cls_trainer import create_config as create_herlev_config  # noqa: E402
from ugpg_tpu_torch.train.graphs import WARMUP_STEPS  # noqa: E402
from ugpg_tpu_torch.train.optim import (  # noqa: E402
    load_optimizer_state,
    param_names,
    torch_rmsprop,
)
from ugpg_tpu_torch.train.seg_trainer import (  # noqa: E402
    DEFAULT_STAGE_CONFIGS,
    UncertaintyGuidedProgressiveTrainer,
)
from ugpg_tpu_torch.parallel import distributed  # noqa: E402
from ugpg_tpu_torch.parallel.mesh import make_mesh, tp_sharded  # noqa: E402
from ugpg_tpu_torch.parallel.pipeline import UncertaintyPipeline  # noqa: E402
from ugpg_tpu_torch.parallel.spatial import (  # noqa: E402
    SpatialWeights,
    make_spatial_train_step,
    pad_to_divisible,
    spatial_predict,
)
from ugpg_tpu_torch.train.steps import make_cls_train_step, make_seg_train_step  # noqa: E402
from ugpg_tpu_torch.utils import profiling  # noqa: E402

CL = torch.channels_last
DEV = torch.device("cuda", 0)
# one H100 SXM (NVIDIA data sheet, dense): HBM 3.35 TB/s, bf16 tensor cores
# 989 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
CHECK_BATCH, TIME_BATCH = 8, 64

# stage-4 shapes at full width: (H, Cin, Cm, Cout) of the 9 DoubleConvs in
# forward order, (C, H) of the 4 Up-block inputs, the logits' (K, H)
DOUBLE_CONVS = {
    "inc": (256, 3, 64, 64), "down1": (128, 64, 128, 128), "down2": (64, 128, 256, 256),
    "down3": (32, 256, 512, 512), "down4": (16, 512, 512, 512), "up1": (32, 1024, 256, 256),
    "up2": (64, 512, 128, 128), "up3": (128, 256, 64, 64), "up4": (256, 128, 64, 64),
}
UPSAMPLES = {"up1": (512, 16), "up2": (256, 32), "up3": (128, 64), "up4": (64, 128)}
LOGITS = (1, 256)

KERNELS = {
    "fused_double_conv": ("ugpg_tpu_torch/csrc/double_conv.cu",
                          "ugpg_tpu/ops/pallas/double_conv.py:196"),
    # the same kernels, one conv per launch: the sharded and column-parallel forwards
    "conv3x3": ("ugpg_tpu_torch/csrc/double_conv.cu", "ugpg_tpu/ops/pallas/double_conv.py:196"),
    "upsample2x": ("ugpg_tpu_torch/csrc/upsample2x.cu", "ugpg_tpu/ops/pallas/resize2x.py:126"),
    # the same kernel's bf16 instance with JAX's bf16 resize rounding (the int8 path)
    "upsample2x_bf16_taps": ("ugpg_tpu_torch/csrc/upsample2x.cu",
                             "ugpg_tpu/ops/pallas/resize2x.py:126"),
    "uncertainty_from_logits": ("ugpg_tpu_torch/csrc/uncertainty.cu",
                                "ugpg_tpu/ops/pallas/uncertainty_fused.py:66"),
    "uncertainty_weighted_bce_fwd": ("ugpg_tpu_torch/csrc/uncertainty_bce.cu",
                                     "ugpg_tpu/ops/pallas/uncertainty_fused.py:139"),
    "uncertainty_weighted_bce_bwd": ("ugpg_tpu_torch/csrc/uncertainty_bce.cu",
                                     "ugpg_tpu/ops/pallas/uncertainty_fused.py:178"),
}
LOSS_KERNELS = ("uncertainty_weighted_bce_fwd", "uncertainty_weighted_bce_bwd")
F32_KERNEL = "conv3x3_f32_kernel"  # the float32 double conv's kernel, two launches per call
PW = 5.0  # the trainer's pos_weight
TRAIN_BATCH = 8
STAGE_RES = (32, 64, 128, 256)  # the four stages' resolutions in training


def log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------- inputs
def dc_inputs(n, h, cin, cm, cout, dtype, g):
    x = torch.randn(n, cin, h, h, device=DEV, generator=g).to(dtype).contiguous(memory_format=CL)
    w1 = (torch.randn(cm, cin, 3, 3, device=DEV, generator=g) * (2 / (9 * cin)) ** 0.5).to(dtype)
    w2 = (torch.randn(cout, cm, 3, 3, device=DEV, generator=g) * (2 / (9 * cm)) ** 0.5).to(dtype)
    b1 = torch.randn(cm, device=DEV, generator=g) * 0.1
    b2 = torch.randn(cout, device=DEV, generator=g) * 0.1
    return x, w1, b1, w2, b2


def up_inputs(n, c, h, dtype, g):
    return (torch.randn(n, c, h, h, device=DEV, generator=g).to(dtype).contiguous(memory_format=CL),)


def unc_inputs(n, k, h, dtype, g):
    return ((torch.randn(n, k, h, h, device=DEV, generator=g) * 4).to(dtype),)


def library_double_conv(x, w1, b1, w2, b2):
    """cuDNN: the conv pair with ReLU in x's dtype (tensor cores in bf16)."""
    mid = F.relu(F.conv2d(x, w1, b1.to(x.dtype), padding=1))
    return F.relu(F.conv2d(mid, w2, b2.to(x.dtype), padding=1))


def library_upsample(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def library_uncertainty(x):
    return torch.sigmoid(x).sub_(0.5).abs_().mul_(-2.0).add_(1.0)


def cases():
    """(kernel, label, make_inputs(n, dtype, g), kernel fn, plain fn, library fn,
    bytes(n, itemsize), ops(n))."""
    out = []
    for name, (h, cin, cm, cout) in DOUBLE_CONVS.items():
        out.append((
            "fused_double_conv", name,
            lambda n, dt, g, s=(h, cin, cm, cout): dc_inputs(n, *s, dt, g),
            fused_double_conv, fused_double_conv_reference, library_double_conv,
            lambda n, sz, s=(h, cin, cm, cout): (
                n * s[0] * s[0] * (s[1] + s[3]) * sz + 9 * s[2] * (s[1] + s[3]) * sz
                + 4 * (s[2] + s[3])),
            lambda n, s=(h, cin, cm, cout): 2 * n * s[0] * s[0] * 9 * (s[1] * s[2] + s[2] * s[3]),
        ))
    for name, (c, h) in UPSAMPLES.items():
        out.append((
            "upsample2x", name, lambda n, dt, g, s=(c, h): up_inputs(n, *s, dt, g),
            upsample2x, upsample2x_reference, library_upsample,
            lambda n, sz, s=(c, h): 5 * n * s[0] * s[1] * s[1] * sz,
            lambda n, s=(c, h): 9 * 4 * n * s[0] * s[1] * s[1],
        ))
    k, h = LOGITS
    out.append((
        "uncertainty_from_logits", "logits", lambda n, dt, g: unc_inputs(n, k, h, dt, g),
        uncertainty_from_logits, uncertainty_from_logits_reference, library_uncertainty,
        lambda n, sz: 2 * n * k * h * h * sz,
        lambda n: 20 * n * k * h * h,
    ))
    return out


# ---------------------------------------------------------------- phases
@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN and matmul TF32 set to ``enabled`` inside, restored after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@tf32(False)
def check_kernels():
    """Each kernel against its plain version, batch 8, bf16 and float32."""
    worst = {}
    g = torch.Generator(device=DEV).manual_seed(0)
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for kernel, label, make, fn, plain, _, _, _ in cases():
            args = make(CHECK_BATCH, dtype, g)
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype, (kernel, label)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            ok = err <= rel * max(1.0, scale)
            log(f"check {kernel:24s} {label:7s} {str(dtype)[6:]:9s} max_abs_err={err:.3e} "
                f"max|plain|={scale:.3e} tol={rel:g}x -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kernel} {label} {dtype}: {err} > {rel} * {scale}")
            if dtype == torch.bfloat16:
                worst[kernel] = max(worst.get(kernel, 0.0), err)
    return worst


def time_ms(fn, args, reps=3, repeats=5):
    fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def time_kernels():
    """Per-forward sums over the stage-4 shapes, batch 64, bf16."""
    dtype, n = torch.bfloat16, TIME_BATCH
    g = torch.Generator(device=DEV).manual_seed(1)
    totals = {}
    for kernel, label, make, fn, plain, library, nbytes, nops in cases():
        if kernel == "uncertainty_from_logits":  # per bucket, below
            continue
        args = make(n, dtype, g)
        t = {"ms": time_ms(fn, args), "plain_ms": time_ms(plain, args, reps=1, repeats=3),
             "library_ms": time_ms(library, args)}
        itemsize = dtype.itemsize
        bytes_ms = nbytes(n, itemsize) / HBM_BYTES_PER_S * 1e3
        ops_ms = nops(n) / PEAK_OPS_PER_S[dtype if kernel == "fused_double_conv"
                                          else torch.float32] * 1e3
        t["bytes_ms"], t["ops_ms"] = bytes_ms, ops_ms
        rate = {"bound_share": max(bytes_ms, ops_ms) / t["ms"]}
        if kernel == "fused_double_conv":
            rate["tflop_per_s"] = nops(n) / t["ms"] / 1e9
            # the bf16 path writes the middle activation and reads it back
            rate["mid_roundtrip_gb"] = 2 * n * DOUBLE_CONVS[label][0] ** 2 \
                * DOUBLE_CONVS[label][2] * itemsize / 1e9
        else:
            rate["gb_per_s"] = nbytes(n, itemsize) / t["ms"] / 1e6
        log("time", json.dumps({"kernel": kernel, "shape": label, "batch": n,
                                **{k: round(v, 4) for k, v in {**t, **rate}.items()}}))
        acc = totals.setdefault(kernel, dict.fromkeys(t, 0.0))
        for key, value in t.items():
            acc[key] += value
        del args
    torch.cuda.empty_cache()
    for kernel, t in totals.items():
        bound = max(t["bytes_ms"], t["ops_ms"])
        log("time total", json.dumps({"kernel": kernel, "batch": n, **t,
                                      "bound_share": bound / t["ms"]}))
    # the logits of the main path are float32 (the heads' dtype); the
    # kernels line gives the device time the HBM byte bound applies to
    unc = time_uncertainty(g)[n, torch.float32]
    totals["uncertainty_from_logits"] = {**unc, "device_ms": unc["device_ms_cold"]}
    return totals


# (batch, dtype) of the uncertainty-map timings: the serving buckets on the
# heads' float32 logits, and bucket 64 in bfloat16
UNC_TIMES = [(b, torch.float32) for b in (1, CHECK_BATCH, TIME_BATCH)] + [
    (TIME_BATCH, torch.bfloat16)]


def time_uncertainty(g):
    """uncertainty_from_logits on (B, 1, 256, 256) logits at each (B, dtype)
    of UNC_TIMES: CUDA-event time per call (``ms``, at the small buckets the
    rate the host issues calls at), device time (``device_ms``, in a
    torch.profiler window that must hold exactly one uncertainty kernel per
    call) and host time per call (``host_us``), beside the plain version,
    the library yardstick and the byte bound (8n bytes float32, 4n
    bfloat16).  The timing loops call the map on the same logits, which
    at bucket 64 (33.5 MB read and written) stay in the 50 MB L2;
    ``device_ms_cold`` at bucket 64 takes 8 logits tensors in turn and
    keeps every output, so that the reads and the writes reach device
    memory.  Phase 5 reads the map's device time in a serving call."""
    k, h = LOGITS
    out = {}
    for batch, dtype in UNC_TIMES:
        args = unc_inputs(batch, k, h, dtype, g)
        n = args[0].numel()
        t = {"ms": time_ms(uncertainty_from_logits, args, reps=20),
             "host_us": host_us(uncertainty_from_logits, args),
             "plain_ms": time_ms(uncertainty_from_logits_reference, args, reps=20),
             "library_ms": time_ms(library_uncertainty, args, reps=20),
             "bytes_ms": 2 * n * args[0].element_size() / HBM_BYTES_PER_S * 1e3,
             "ops_ms": 20 * n / PEAK_OPS_PER_S[torch.float32] * 1e3}
        windows = {"device_ms": (uncertainty_from_logits, args)}
        if batch == TIME_BATCH:
            cold = itertools.cycle([args[0]] + [unc_inputs(batch, k, h, dtype, g)[0]
                                                for _ in range(7)])
            outs = []
            windows["device_ms_cold"] = (
                lambda: outs.append(uncertainty_from_logits(next(cold))), ())
        for key, (fn, fn_args) in windows.items():
            t[key], kernels = device_ms(fn, fn_args, ("uncertainty_kernel",))
            # one launch per call: every kernel of the window is the map's
            assert sum(kernels.values()) == 20, kernels
            assert all("uncertainty_kernel" in name for name in kernels), kernels
        bound = max(t["bytes_ms"], t["ops_ms"])
        shares = {f"bound_share_{key.replace('_ms', '')}": bound / t[key] for key in windows}
        log("time", json.dumps({
            "kernel": "uncertainty_from_logits", "shape": [batch, k, h, h],
            "dtype": str(dtype)[6:], **t, "bound_share_event": bound / t["ms"], **shares,
            "gb_per_s_device": t["bytes_ms"] * HBM_BYTES_PER_S / t["device_ms"] / 1e9}))
        out[batch, dtype] = t
        del args, windows
    log(f"time uncertainty: one uncertainty kernel per call at every bucket ({json.dumps(kernels)} "
        "in the last 20 calls)")
    return out


# the host-cost timings: each serving kernel's smallest stage-4 call at
# bucket 1, float32 (down4's double conv, up1's upsample, the logits)
HOST_CASES = {"fused_double_conv": ("down4", 1), "upsample2x": ("up1", 1),
              "uncertainty_from_logits": ("logits", 1)}


def time_host_dispatch():
    """Host us per call of each serving kernel through its ctypes wrapper
    (how the models called the kernels before the operators) and through
    its operator (``torch.ops.ugpg_torch``, how they call them now), in
    turns: wrapper, operator, operator, wrapper."""
    g = torch.Generator(device=DEV).manual_seed(4)
    by_case = {(kernel, label): (make, fn) for kernel, label, make, fn, *_ in cases()}
    ops = {"fused_double_conv": library_ops.fused_double_conv,
           "upsample2x": library_ops.upsample2x,
           "uncertainty_from_logits": library_ops.uncertainty_from_logits}
    out = {}
    for kernel, (label, n) in HOST_CASES.items():
        make, wrapper = by_case[kernel, label]
        args = make(n, torch.float32, g)
        op_args = args
        if kernel == "fused_double_conv":  # the models pass the packed weights
            packed = pack_double_conv(*args[1:])
            wrapper_args = args
            op_args = (*args, *packed)

            def wrapper(*a, packed=packed):
                return fused_double_conv(*a, packed=packed)
        else:
            wrapper_args = args
        assert torch.equal(wrapper(*wrapper_args), ops[kernel](*op_args)), kernel
        samples = {"wrapper": [], "operator": []}
        for name in ("wrapper", "operator", "operator", "wrapper"):
            fn, a = (wrapper, wrapper_args) if name == "wrapper" else (ops[kernel], op_args)
            samples[name].append(host_us(fn, a))
        out[kernel] = {f"host_us_{k}": statistics.median(v) for k, v in samples.items()}
        log("time host", json.dumps({"kernel": kernel, "shape": [n, *args[0].shape[1:]],
                                     **out[kernel],
                                     "samples": {k: v for k, v in samples.items()}}))
        del args, op_args, wrapper_args
    return out


def check_uncertainty_past_2_31():
    """n = 2^31 + 11 float32 logits (about 17 GB in and out): the body and
    the last 11 elements, past where an int32 index wraps, hold two
    constants, so the map is known in closed form.  n % 4 = 3: the last 3
    elements, at indices past 2^31, take the kernel's scalar epilogue."""
    n1, n = 1 << 31, (1 << 31) + 11
    body, tail = 0.75, -3.0
    x = torch.full((n,), body, device=DEV)
    x[n1:] = tail
    out = uncertainty_from_logits(x)
    torch.cuda.synchronize()
    want = [1 - 2 * abs(1 / (1 + math.exp(-v)) - 0.5) for v in (body, tail)]
    got = [(out[:n1].amin().item(), out[:n1].amax().item()),
           (out[n1:].amin().item(), out[n1:].amax().item())]
    log(f"check uncertainty past 2^31 (n={n}): body min/max {got[0]} want {want[0]:.9g}, "
        f"tail min/max {got[1]} want {want[1]:.9g}")
    for pair, w in zip(got, want):
        assert all(abs(v - w) <= 1e-6 for v in pair), (pair, w)
    del x, out
    torch.cuda.empty_cache()


def random_checkpoint(path: Path, seed: int = 0) -> None:
    """Full-width stage-4 weights from a seed, He-scaled convs and
    non-trivial BN stats, as a reference-format container."""
    g = np.random.default_rng(seed)
    sd = {}
    for key, value in PGUNet4(use_bn=True).state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.int64)
            continue
        if value.dim() == 4:
            v = g.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif key.endswith("running_var"):
            v = 1 + 0.2 * g.random(shape)
        elif key.endswith("weight"):  # BN scale
            v = 1 + 0.1 * g.standard_normal(shape)
        else:  # biases, running means
            v = 0.1 * g.standard_normal(shape)
        sd[key] = torch.from_numpy(np.asarray(v, np.float32))
    torch.save({"stage": 4, "epoch": 0, "model_state_dict": sd}, path)


def check_response(outs, n):
    preds, probs, unc = outs
    assert preds.shape == probs.shape == unc.shape == (n, 256, 256, 1), preds.shape
    assert np.isfinite(probs).all() and np.isfinite(unc).all()
    assert set(np.unique(preds)) <= {0.0, 1.0}
    assert probs.min() >= 0 and probs.max() <= 1 and unc.min() >= 0 and unc.max() <= 1
    np.testing.assert_allclose(unc, 1 - 2 * np.abs(probs - 0.5), atol=1e-5)


def profile_call(label, fn):
    """Device time by kernel for one call of ``fn`` (torch.profiler), the
    share of the call's wall time the device sat idle, and the launches by
    kernel: -> (ms by kernel, wall ms, launches by kernel)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device, counts = {}, {}
    for e in prof.key_averages():
        # device-side rows (kernels, copies) carry no CPU time; the
        # profiler's own buffer request is not the program's work
        if e.cpu_time_total == 0 and e.self_device_time_total > 0 \
                and e.key != "Activity Buffer Request":
            device[e.key] = device.get(e.key, 0.0) + e.self_device_time_total / 1e3
            counts[e.key] = counts.get(e.key, 0) + e.count
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:10]
    log("profile", json.dumps({
        "call": label, "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1 - busy / wall_ms, "top_ms": {k[:90]: v for k, v in top}}))
    return device, wall_ms, counts


PROFILE_TRIES = 6


def profile_kernel(label, fn, kernel, launches):
    """``profile_call`` of ``fn``, taken again until its window holds the
    ``launches`` launches of ``kernel`` (a name part) that one call makes,
    at most ``PROFILE_TRIES`` times, each short window logged.  Late in a
    long process torch.profiler loses launches of the port's kernels at
    random on an H100 (a window of one Herlev call held 1 or 2 of its 8
    launches, once none), while a fresh process's windows hold every one.
    Returns the fullest window's (ms by kernel, wall ms, launches by
    kernel) and the number of calls made."""
    best, calls = None, 0
    for attempt in range(PROFILE_TRIES):
        device, wall_ms, counts = profile_call(label, fn)
        calls += 1
        seen = sum(v for k, v in counts.items() if kernel in k)
        if best is None or seen > best[0]:
            best = (seen, device, wall_ms, counts)
        if seen >= launches:
            break
        log(f"profile: the window held {seen} of {launches} {kernel} launches; "
            + ("taken again" if attempt + 1 < PROFILE_TRIES else "not taken again"))
    return (*best[1:], calls)


def serve(tmp: Path):
    """The main path: stage-4 serving through Predictor and BatchingServer."""
    ckpt = tmp / "ug_pgunet_stage4_best.pth"
    random_checkpoint(ckpt)
    g = np.random.default_rng(1)
    images8 = g.integers(0, 256, (16, 256, 256, 3), dtype=np.uint8)
    images = images8.astype(np.float32) / 255.0

    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    pf = Predictor(str(ckpt), buckets=(1, 8, 64))
    p8 = Predictor(str(ckpt), buckets=(1, 8, 64), input_dtype=np.uint8)
    p32 = Predictor(str(ckpt), buckets=(2,), dtype=torch.float32)
    log(f"serve: predictors built in {time.perf_counter() - t0:.2f} s")

    for n in (1, 5, 8, 11):
        a, b = pf(images[:n]), p8(images8[:n])
        check_response(a, n)
        check_response(b, n)
        for u, v in zip(a, b):  # x/255 on the host == on the device
            np.testing.assert_array_equal(u, v)
    log("serve: requests of 1, 5, 8, 11 images (float32 and uint8) ok")

    server = BatchingServer(pf, max_latency_ms=20.0)
    try:
        futures = [server.submit(im) for im in images]
        results = [f.result(timeout=600) for f in futures]
    finally:
        server.close()
    direct = pf(images)
    for i, outs in enumerate(results):
        for got, want in zip(outs, direct):
            np.testing.assert_allclose(got, want[i], atol=1e-6)
    log("serve: 16 concurrent submits ok", json.dumps(server.stats()))

    big = np.concatenate([images] * 4)  # 64 images
    pf(big)  # warm
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        outs = pf(big)
    dt = time.perf_counter() - t0
    check_response(outs, 64)
    ips = reps * 64 / dt
    log(f"serve: bucket 64 bf16: {ips:.2f} images/s ({dt / reps * 1e3:.1f} ms per call)")
    f32_before = f32_launches()
    device, wall_ms, _, _ = profile_kernel("serve: bucket 64, 64 images", lambda: pf(big),
                                           "conv3x3_mma_kernel", 18)
    f32_calls = f32_launches() - f32_before
    # the bf16 double conv must run on the tensor-core kernel, never the
    # float32 CUDA-core one (neither in the profile nor by the C side's count)
    mma_ms = sum(v for k, v in device.items() if "conv3x3_mma_kernel" in k)
    f32_ms = sum(v for k, v in device.items() if F32_KERNEL in k)
    log(f"serve: bf16 double conv (conv3x3_mma_kernel, 18 launches): {mma_ms:.3f} ms of device "
        f"time, {mma_ms / wall_ms:.1%} of the call, {mma_ms / sum(device.values()):.1%} of "
        f"device busy; float32 CUDA-core kernel ({F32_KERNEL}) {f32_ms:.3f} ms, "
        f"{f32_calls} launches")
    assert mma_ms > 0 and f32_ms == 0 and f32_calls == 0, (mma_ms, f32_ms, f32_calls)
    unc_ms = sum(v for k, v in device.items() if "uncertainty_kernel" in k)
    log(f"serve: uncertainty map (uncertainty_kernel, 1 launch): {unc_ms * 1e3:.3f} us of device "
        "time in that call")

    g32 = p32(images[:2])
    counts = _lib.launch_counts()
    calls = sum(p.stats()["device_calls"] for p in (pf, p8, p32))
    expect = {"fused_double_conv": 9 * calls, "upsample2x": 4 * calls,
              "uncertainty_from_logits": calls}
    log(f"serve: {calls} device calls, launches {json.dumps(counts)}")
    assert counts == expect, (counts, expect)

    cpu = Predictor(str(ckpt), buckets=(2,), dtype=torch.float32, device="cpu")(images[:2])
    err = float(np.abs(g32[1] - cpu[1]).max())
    err_unc = float(np.abs(g32[2] - cpu[2]).max())
    flips = g32[0] != cpu[0]
    log(f"serve: float32 GPU vs CPU: max|dprob|={err:.3e} max|dunc|={err_unc:.3e} "
        f"pred flips={int(flips.sum())}")
    assert err <= 1e-4 and err_unc <= 1e-4
    assert np.all(np.abs(cpu[1][flips] - 0.5) < 1e-4)
    bf = pf(images[:2])[1]
    mean_err = float(np.abs(bf - cpu[1]).mean())
    log(f"serve: bf16 GPU vs float32 CPU: mean|dprob|={mean_err:.3e} "
        f"max|dprob|={float(np.abs(bf - cpu[1]).max()):.3e}")
    assert mean_err < 2e-2
    return counts, ips

# ---------------------------------------------------------------- training: the loss kernels
def loss_inputs(shape, g):
    x = torch.randn(shape, device=DEV, generator=g) * 4
    z = (torch.rand(shape, device=DEV, generator=g) > 0.6).float()
    p = torch.rand(shape, device=DEV, generator=g)
    return x, z, p


def pixel_loss(x: float, z: float) -> float:
    """float64 closed form of the per-pixel loss and of its derivative."""
    return (1 - z) * x + (1 + (PW - 1) * z) * (max(-x, 0.0) + math.log1p(math.exp(-abs(x))))


def pixel_grad(x: float, z: float) -> float:
    return (1 - z) - (1 + (PW - 1) * z) / (1 + math.exp(x))


def weight(p: float, alpha: float) -> float:
    return 1 + alpha * (1 - 2 * abs(p - 0.5))


def check_loss_kernels():
    """Both loss kernels against their plain versions: the two means to
    rtol 1e-5 (float32 terms, summed in float64 by the kernel and in
    float32 by torch), dx to 1e-5 x max|dx|; the forward bit-identical on a
    repeat; at alpha = 0 a 0-d p gives the bits of a full map of 0.5; the
    four stage resolutions at batch 8, a ragged shape, a slice off a 16-byte
    boundary; the last element at 2^24 + 8; one case past 2^31 elements
    against the closed form."""
    g = torch.Generator(device=DEV).manual_seed(2)
    gup = torch.ones((), device=DEV)
    half = torch.full((), 0.5, device=DEV)
    worst = dict.fromkeys(LOSS_KERNELS, 0.0)
    shapes = [(TRAIN_BATCH, 1, r, r) for r in STAGE_RES] + [(2, 1, 17, 19), "x[1:]",
                                                           ((1 << 24) + 8,)]
    for shape in shapes:
        if shape == "x[1:]":  # off a 16-byte boundary, n % 4 = 1
            x, z, p = (t[1:] for t in loss_inputs((TRAIN_BATCH * 64 * 64 + 2,), g))
        else:
            x, z, p = loss_inputs(shape, g)
        for alpha in (0.0, 1.0, 2.0):
            got = uncertainty_weighted_bce_forward(x, z, p, PW, alpha)
            again = uncertainty_weighted_bce_forward(x, z, p, PW, alpha)
            want = uncertainty_weighted_bce_reference(x, z, p, PW, alpha)
            dx = uncertainty_weighted_bce_backward(x, z, p, PW, alpha, gup)
            want_dx = uncertainty_weighted_bce_backward_reference(x, z, p, PW, alpha, gup)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if alpha == 0.0:  # the stage-1 call: p is not read
                same = same and all(torch.equal(a, b) for a, b in zip(
                    got, uncertainty_weighted_bce_forward(x, z, half, PW, alpha)))
                same = same and torch.equal(
                    dx, uncertainty_weighted_bce_backward(x, z, half, PW, alpha, gup))
            torch.cuda.synchronize()
            fwd_err = max(abs(a.item() - b.item()) for a, b in zip(got, want))
            fwd_rel = max(abs(a.item() - b.item()) / abs(b.item()) for a, b in zip(got, want))
            bwd_err = (dx - want_dx).abs().max().item()
            scale = want_dx.abs().max().item()
            log(f"check loss {str(shape):20s} alpha={alpha} final={got[0].item():.7g} "
                f"base={got[1].item():.7g} fwd rel err={fwd_rel:.2e} "
                f"bwd err={bwd_err:.2e} (max|dx|={scale:.2e}) repeat identical={same}")
            assert fwd_rel <= 1e-5 and bwd_err <= 1e-5 * scale and same, shape
            worst["uncertainty_weighted_bce_fwd"] = max(worst["uncertainty_weighted_bce_fwd"], fwd_err)
            worst["uncertainty_weighted_bce_bwd"] = max(worst["uncertainty_weighted_bce_bwd"], bwd_err)
        del dx, want_dx
    # 2^24 + 8: the last element counts (the JAX kernel's float32 index
    # compare once dropped it); give it a loss that moves the mean
    n = x.numel()
    before = uncertainty_weighted_bce_forward(x, z, p, PW, 1.0)[0].item()
    old = pixel_loss(x[-1].item(), z[-1].item()) * weight(p[-1].item(), 1.0)
    x[-1], z[-1], p[-1] = -1e4, 1.0, 0.5
    after = uncertainty_weighted_bce_forward(x, z, p, PW, 1.0)[0].item()
    delta = (pixel_loss(-1e4, 1.0) * weight(0.5, 1.0) - old) / n
    log(f"check loss last element of {n}: mean moved by {after - before:.6e}, expected {delta:.6e}")
    assert abs((after - before) - delta) <= 1e-3 * delta
    del x, z, p
    torch.cuda.empty_cache()
    return worst


def check_loss_kernels_past_2_31():
    """n = 2^31 + 2^24 float32 elements (about 26 GB of x, z, p): the body
    and the last 2^24 elements hold two different constants, so both means
    and dx are known in closed form."""
    n1, n2 = 1 << 31, 1 << 24
    n, alpha = n1 + n2, 1.0
    body, tail = (0.5, 1.0, 0.25), (-1.5, 0.0, 0.5)  # (x, z, p)
    x, z, p = (torch.full((n,), b, device=DEV) for b in body)
    for t, v in zip((x, z, p), tail):
        t[n1:] = v
    final, base = uncertainty_weighted_bce_forward(x, z, p, PW, alpha)
    again = uncertainty_weighted_bce_forward(x, z, p, PW, alpha)
    dx = uncertainty_weighted_bce_backward(x, z, p, PW, alpha, torch.ones((), device=DEV))
    torch.cuda.synchronize()
    pix = [pixel_loss(v[0], v[1]) for v in (body, tail)]
    w = [weight(v[2], alpha) for v in (body, tail)]
    want_final = (n1 * pix[0] * w[0] + n2 * pix[1] * w[1]) / n
    want_base = (n1 * pix[0] + n2 * pix[1]) / n
    want_dx = [wi * pixel_grad(v[0], v[1]) / n for wi, v in zip(w, (body, tail))]
    got_dx = [(dx[:n1].amin().item(), dx[:n1].amax().item()),
              (dx[n1:].amin().item(), dx[n1:].amax().item()), (dx[-1].item(),)]
    log(f"check loss past 2^31 (n={n}): final={final.item():.7g} want {want_final:.7g}, "
        f"base={base.item():.7g} want {want_base:.7g}, dx body/tail/last={got_dx} "
        f"want {want_dx}, repeat identical={torch.equal(final, again[0])}")
    assert torch.equal(final, again[0]) and torch.equal(base, again[1])
    assert abs(final.item() - want_final) <= 1e-5 * want_final
    assert abs(base.item() - want_base) <= 1e-5 * want_base
    for got, want in zip(got_dx, (want_dx[0], want_dx[1], want_dx[1])):
        assert all(abs(v - want) <= 1e-5 * abs(want) for v in got), (got, want)
    del x, z, p, dx
    torch.cuda.empty_cache()


def device_ms(fn, args, names, reps=20):
    """Device time per call of the kernels whose names contain one of
    ``names`` (torch.profiler), over ``reps`` calls after a warm-up, and
    the launches of every kernel in that window, by name.  Each call
    launches one kernel of ``names``; a window that holds fewer is taken
    again, up to three times, and logged: torch.profiler has been seen to
    lose a window's kernels at random on an H100 (windows of 20 calls held
    none, twice in a row)."""
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.cpu_time_total == 0
                and e.self_device_time_total > 0 and e.key != "Activity Buffer Request"]
        mine = [e for e in rows if any(n in e.key for n in names)]
        if sum(e.count for e in mine) >= reps:
            break
        log(f"profile: a window of {reps} calls held {json.dumps({e.key: e.count for e in rows})}; "
            "taken again")
    ms = sum(e.self_device_time_total for e in mine)
    return ms / 1e3 / reps, {e.key: e.count for e in rows}


def host_us(fn, args, calls=200, repeats=5):
    """Host time per call: a host clock around ``calls`` calls with no
    synchronise among them, the rate the host issues them at; the median
    of ``repeats`` such runs, since the host's clock spreads far more than
    the device's."""
    fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        samples.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


# (batch, px, alpha) of the loss timings: the training path's four stage
# shapes, batch 64 at 256 px, and stage 1's call (alpha = 0, a 0-d p)
LOSS_TIMES = [(TRAIN_BATCH, r, 1.0) for r in STAGE_RES] + [(TIME_BATCH, 256, 1.0),
                                                          (TRAIN_BATCH, 32, 0.0)]


def time_loss_kernels():
    """Forward and backward, float32, at each (B, 1, px, px) of LOSS_TIMES,
    beside their plain versions, the library yardstick
    (F.binary_cross_entropy_with_logits with the weights precomputed, and
    its autograd backward) and the byte bound (12n + 8 and 16n + 4 bytes;
    8n + 8 and 12n + 4 at alpha = 0, where p is not read).  ``ms`` is
    CUDA-event time per call, which at small sizes is the rate the host
    issues calls at; ``device_ms`` the kernel's own device time, in a
    profile that must hold exactly one forward kernel per forward call;
    ``host_us`` host time per call without a synchronise."""
    g = torch.Generator(device=DEV).manual_seed(3)
    out = {}
    for batch, res, alpha in LOSS_TIMES:
        shape = (batch, 1, res, res)
        x, z, p = loss_inputs(shape, g)
        weighted = alpha != 0.0
        if not weighted:
            p = torch.full((), 0.5, device=DEV)  # as the stage-1 step passes it
        n = x.numel()
        gup = torch.ones((), device=DEV)
        w = 1 + alpha * (1 - 2 * (p - 0.5).abs()) if weighted else None
        pw = torch.tensor([PW], device=DEV)
        xr = x.clone().requires_grad_()
        lib_loss = F.binary_cross_entropy_with_logits(xr, z, weight=w, pos_weight=pw)
        args = (x, z, p, PW, alpha)
        t = {
            "uncertainty_weighted_bce_fwd": {
                "ms": time_ms(uncertainty_weighted_bce_forward, args, reps=20),
                "host_us": host_us(uncertainty_weighted_bce_forward, args),
                "plain_ms": time_ms(uncertainty_weighted_bce_reference, args, reps=20),
                "library_ms": time_ms(lambda: F.binary_cross_entropy_with_logits(
                    x, z, weight=w, pos_weight=pw), (), reps=20),
                "bytes_ms": ((12 if weighted else 8) * n + 8) / HBM_BYTES_PER_S * 1e3,
                "ops_ms": (21 if weighted else 16) * n / PEAK_OPS_PER_S[torch.float32] * 1e3,
            },
            "uncertainty_weighted_bce_bwd": {
                "ms": time_ms(uncertainty_weighted_bce_backward, (*args, gup), reps=20),
                "host_us": host_us(uncertainty_weighted_bce_backward, (*args, gup)),
                "plain_ms": time_ms(uncertainty_weighted_bce_backward_reference, (*args, gup),
                                    reps=20),
                "library_ms": time_ms(lambda: torch.autograd.grad(lib_loss, xr, retain_graph=True),
                                      (), reps=20),
                "bytes_ms": ((16 if weighted else 12) * n + 4) / HBM_BYTES_PER_S * 1e3,
                "ops_ms": (15 if weighted else 10) * n / PEAK_OPS_PER_S[torch.float32] * 1e3,
            },
        }
        fwd_ms, fwd_kernels = device_ms(uncertainty_weighted_bce_forward, args, ("bce_forward",))
        # one launch per forward: every kernel of the window is the forward's
        assert sum(fwd_kernels.values()) == 20 and all("bce_forward" in k for k in fwd_kernels), \
            fwd_kernels
        bwd_ms, _ = device_ms(uncertainty_weighted_bce_backward, (*args, gup), ("bce_backward",))
        t["uncertainty_weighted_bce_fwd"]["device_ms"] = fwd_ms
        t["uncertainty_weighted_bce_bwd"]["device_ms"] = bwd_ms
        for kernel, v in t.items():
            bound = max(v["bytes_ms"], v["ops_ms"])
            log("time", json.dumps({
                "kernel": kernel, "shape": list(shape), "batch": batch, "alpha": alpha, **v,
                "bound_share_event": bound / v["ms"], "bound_share_device": bound / v["device_ms"],
                "gb_per_s_device": v["bytes_ms"] * HBM_BYTES_PER_S / v["device_ms"] / 1e9}))
        log(f"time loss {shape} alpha={alpha}: one forward kernel per call "
            f"({json.dumps(fwd_kernels)} in 20 calls)")
        out[batch, res, alpha] = t
        del x, z, p, w, xr, lib_loss
    torch.cuda.empty_cache()
    return out


def train_progressive(tmp: Path):
    """The training path: UncertaintyGuidedProgressiveTrainer at full
    width, fused loss, stages 1-4 at 32/64/128/256 px, 2 epochs each, on
    the synthetic disk task (16 train and 8 validation images, batch 8).
    Exactly one forward and one backward loss launch per train step, none
    from validation; then the stage-4 checkpoint serves one request."""
    images, masks = disk_dataset(24, 256, seed=0)
    train = ArrayLoader(images[:16], masks[:16], batch_size=TRAIN_BATCH, shuffle=True, seed=0)
    val = ArrayLoader(images[16:], masks[16:], batch_size=TRAIN_BATCH)
    cfgs = {s: {**c, "epochs_per_stage": 2} for s, c in DEFAULT_STAGE_CONFIGS.items()}
    trainer = UncertaintyGuidedProgressiveTrainer(fused_loss=True, width=1.0, stage_configs=cfgs,
                                                  verbose=False)
    epoch_s: dict[int, list] = {}
    train_epoch = trainer.train_epoch

    def timed_train_epoch(loader, stage):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_epoch(loader, stage)  # ends by reading the epoch's metrics back
        epoch_s.setdefault(stage, []).append(time.perf_counter() - t0)
        return out

    trainer.train_epoch = timed_train_epoch
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.train_progressive(train, val, save_dir=str(tmp))
    wall = time.perf_counter() - t0
    counts = _lib.launch_counts()
    steps = sum(c["epochs_per_stage"] for c in cfgs.values()) * len(train)
    log(f"train: stages 1-4, full width, fused loss, {steps} train steps in {wall:.1f} s, "
        f"launches {json.dumps(counts)}")
    assert counts == {k: steps for k in LOSS_KERNELS}, counts
    assert flags == (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    for key in ("train_loss", "val_loss", "base_loss"):
        assert np.isfinite(history[key]).all(), (key, history[key])
    assert history["stage_transitions"] == [0, 2, 4, 6], history["stage_transitions"]
    assert all(u > 0 for u in history["uncertainty_weights_mean"][2:]), history
    for stage in (1, 2, 3, 4):
        assert (tmp / f"ug_pgunet_stage{stage}_best.pth").exists(), stage
    log("train: history", json.dumps({k: [round(v, 5) for v in vs] for k, vs in history.items()
                                      if k != "stage_transitions"}))
    ips = {s: [16 / dt for dt in times] for s, times in epoch_s.items()}
    log(f"train: images/s per stage (epoch 1, epoch 2), batch {TRAIN_BATCH}, float32, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}: "
        + json.dumps({s: [round(v, 2) for v in vs] for s, vs in ips.items()}))

    _lib.reset_launch_counts()
    predictor = Predictor(str(tmp / "ug_pgunet_stage4_best.pth"), buckets=(TRAIN_BATCH,))
    check_response(predictor(images[16:]), 8)
    served = _lib.launch_counts()
    calls = predictor.stats()["device_calls"]
    log(f"train: the stage-4 checkpoint served 8 images in {calls} device call(s), "
        f"launches {json.dumps(served)}")
    assert served == {"fused_double_conv": 9 * calls, "upsample2x": 4 * calls,
                      "uncertainty_from_logits": calls}, served

    batch = next(iter(train))
    step = make_seg_train_step(trainer.models[4], trainer.optimizer, 4, 256,
                               prev_model=trainer.models[3], prev_resolution=128,
                               fused_loss=True)
    step(batch, PW)
    profile_call("train: one stage-4 step, batch 8, fused loss", lambda: step(batch, PW))
    return trainer, batch, counts, ips


@tf32(False)
def fused_vs_plain(trainer, batch):
    """One stage-4 full-width step from the same weights and batch, fused
    and plain loss (TF32 off): the means to rtol 1e-5, every gradient to
    1e-4 x the model's largest gradient (cuDNN's backward sums in no fixed
    order, and the bias of a conv before BN has a true gradient of 0)."""
    out = {}
    for fused in (True, False):
        model = copy.deepcopy(trainer.models[4])
        opt = torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4)
        step = make_seg_train_step(model, opt, 4, 256, prev_model=trainer.models[3],
                                   prev_resolution=128, fused_loss=fused)
        m = step(batch, PW)
        out[fused] = ({k: v.item() for k, v in m.items()},
                      {n: p.grad for n, p in model.named_parameters()})
    (mf, gf), (mp, gp) = out[True], out[False]
    gmax = max(g.abs().max().item() for g in gp.values())
    worst = max((gf[n] - gp[n]).abs().max().item() for n in gp) / gmax
    rel = {k: abs(mf[k] - mp[k]) / abs(mp[k]) for k in ("final_loss", "base_loss")}
    log(f"fused vs plain, stage 4: final {mf['final_loss']:.7g} / {mp['final_loss']:.7g}, "
        f"base {mf['base_loss']:.7g} / {mp['base_loss']:.7g}, rel {json.dumps(rel)}, "
        f"max|dgrad|/max|g|={worst:.2e}")
    assert all(v <= 1e-5 for v in rel.values()) and worst <= 1e-4


@tf32(False)
def gpu_vs_cpu():
    """One stage-2 step at width 0.25, float32, TF32 off, on the card and on
    the CPU from the same weights and batch, with the rule of the CPU test
    (tests/test_torch_train.py): metrics rtol 1e-5, BN stats 1e-5,
    gradients rtol 1e-4 plus a noise floor x max|g|, parameters after the
    update to 1e-5 except where the gradient RMSprop sees lies below that
    floor.  The floor is 1e-4: the test takes 1e-5 at its size and 1e-3
    where a ReLU or max-pool branch decided by float32 rounding moves a
    gradient; this step showed gaps of 4.5e-7 and 6.5e-7 on an H100."""
    tr = UncertaintyGuidedProgressiveTrainer(device="cpu", width=0.25, verbose=False, seed=1)
    tr.transfer_weights(1, 2)  # builds both stages
    before = {k: v.clone() for k, v in tr.models[2].state_dict().items()}
    images, masks = disk_dataset(4, 40, seed=3)
    res = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(tr.models[2]).to(dev)
        prev = copy.deepcopy(tr.models[1]).to(dev)
        opt = torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4)
        m = make_seg_train_step(model, opt, 2, 32, prev_model=prev, prev_resolution=16,
                                fused_loss=True)((images, masks), PW)
        res[dev] = ({k: v.item() for k, v in m.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()},
                    {k: v.cpu() for k, v in model.state_dict().items()})
    (mc, gc, sc), (mg, gg, sg) = res["cpu"], res["cuda"]
    metric_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-7) for k in mc)
    gmax = max(g.abs().max().item() for g in gc.values())
    noise = 1e-4
    grad_gap = max(((gg[n] - gc[n]).abs() - 1e-4 * gc[n].abs()).max().item() for n in gc) / gmax
    kept = total = 0
    param_gap = 0.0
    for n in gc:
        seen = (gc[n] + 1e-4 * before[n]).abs()
        keep = seen >= noise * gmax
        kept, total = kept + int(keep.sum()), total + keep.numel()
        param_gap = max(param_gap, (sg[n] - sc[n]).abs()[keep].max().item() if keep.any() else 0.0)
    bn_gap = max((sg[k] - sc[k]).abs().max().item() for k in sc if "running" in k)
    log(f"gpu vs cpu, stage 2, width 0.25: metrics max rel {metric_rel:.2e}, grad gap "
        f"{grad_gap:.2e} x max|g|, params {param_gap:.2e} on {kept}/{total} elements, "
        f"BN stats {bn_gap:.2e}")
    assert metric_rel <= 1e-5 and grad_gap <= noise and bn_gap <= 1e-5
    assert param_gap <= 1e-5 and kept > 0.9 * total


# ---------------------------------------------------------------- MoNuSeg training
AUG_PATCHES, PATCH_PX, PATCH_NUCLEI = 32, 256, 30
TILE_PX, TILE_NUCLEI = 1000, 400
# ImageDraw.polygon(fill=1) of Pillow 12.1.0 over fixed_polygons() on a
# 1000 x 1000 "L" image fills this many pixels (Pillow run once, off the
# card); the even-odd scanline of backend="native" fills the second count
PIL_FIXED_COUNT, NATIVE_FIXED_COUNT = 66767, 60787


def fixed_polygons(n=TILE_NUCLEI, size=TILE_PX):
    """n nucleus-like polygons of 8-20 vertices on a size x size tile, from a
    64-bit LCG: the same floats on every machine."""
    state = 0x2545F4914F6CDD1D

    def rnd():
        nonlocal state
        state = (state * 6364136223846793005 + 1442695040888963407) % (1 << 64)
        return (state >> 11) / float(1 << 53)

    polys = []
    for _ in range(n):
        k = 8 + int(rnd() * 13)
        cx, cy, r = rnd() * size, rnd() * size, 4 + 8 * rnd()
        polys.append([(cx + r * (0.7 + 0.3 * rnd()) * math.cos(2 * math.pi * (i + 0.5 * rnd()) / k),
                       cy + r * (0.7 + 0.3 * rnd()) * math.sin(2 * math.pi * (i + 0.5 * rnd()) / k))
                      for i in range(k)])
    return polys


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG (filter 0 on every row, one zlib IDAT)."""
    h, w, _ = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def tiff_bytes(img: np.ndarray, rows_per_strip: int = 64) -> bytes:
    """A little-endian classic TIFF, 8-bit RGB, chunky strips, Deflate (8)."""
    h, w, _ = img.shape
    strips = [zlib.compress(img[r:r + rows_per_strip].tobytes(), 6)
              for r in range(0, h, rows_per_strip)]
    n_tags = 10
    data_at = 8 + 2 + 12 * n_tags + 4
    bits_at, offs_at = data_at, data_at + 6
    counts_at = offs_at + 4 * len(strips)
    strip_at = counts_at + 4 * len(strips)
    offsets = list(itertools.accumulate([strip_at] + [len(b) for b in strips[:-1]]))
    short, long_ = 3, 4
    tags = [(256, long_, 1, w), (257, long_, 1, h), (258, short, 3, bits_at), (259, short, 1, 8),
            (262, short, 1, 2), (273, long_, len(strips), offs_at), (277, short, 1, 3),
            (278, long_, 1, rows_per_strip), (279, long_, len(strips), counts_at),
            (284, short, 1, 1)]
    out = [b"II", struct.pack("<HI", 42, 8), struct.pack("<H", n_tags)]
    out += [struct.pack("<HHII", *t) for t in tags] + [struct.pack("<I", 0)]
    out += [struct.pack("<3H", 8, 8, 8), struct.pack(f"<{len(strips)}I", *offsets),
            struct.pack(f"<{len(strips)}I", *[len(b) for b in strips])]
    return b"".join(out + strips)


def aperio_xml(polys) -> str:
    regions = "".join(
        "<Region><Vertices>" + "".join(f'<Vertex X="{x:.3f}" Y="{y:.3f}"/>' for x, y in p)
        + "</Vertices></Region>" for p in polys)
    return (f'<?xml version="1.0"?>\n<Annotations MicronsPerPixel="0.252"><Annotation><Regions>'
            f"{regions}</Regions></Annotation></Annotations>")


def he_image(rng, polys, size):
    """An H&E-like RGB tile: pink stroma with noise, purple nuclei where
    the polygons lie."""
    nuclei = rasterize_polygons([np.asarray(p) for p in polys], (size, size)).astype(bool)
    img = np.empty((size, size, 3), np.float32)
    img[:] = (232, 182, 205)
    img[nuclei] = (110, 62, 152)
    img += rng.normal(0, 14, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def nuclei(rng, n, size):
    out = []
    for _ in range(n):
        k = int(rng.integers(8, 21))
        c = rng.uniform(0, size, 2)
        r = rng.uniform(4, 12) * rng.uniform(0.7, 1.0, k)
        a = np.sort(rng.uniform(0, 2 * np.pi, k))
        out.append(list(zip((c[0] + r * np.cos(a)).tolist(), (c[1] + r * np.sin(a)).tolist())))
    return out


def write_monuseg_tree(root: Path, seed: int = 0) -> None:
    """train/aug: AUG_PATCHES PNG patches; train and val: two Deflate TIFF
    tiles each; every image with its Aperio XML."""
    rng = np.random.default_rng(seed)
    items = [("train/aug", f"patch_{i:02d}", PATCH_PX, PATCH_NUCLEI, ".png")
             for i in range(AUG_PATCHES)]
    items += [(split, f"{split}_tile_{i}", TILE_PX, TILE_NUCLEI, ".tif")
              for split in ("train", "val") for i in range(2)]
    for split, stem, size, n, ext in items:
        for sub in ("images", "annots"):
            (root / split / sub).mkdir(parents=True, exist_ok=True)
        polys = nuclei(rng, n, size)
        img = he_image(rng, polys, size)
        (root / split / "images" / f"{stem}{ext}").write_bytes(
            png_bytes(img) if ext == ".png" else tiff_bytes(img))
        (root / split / "annots" / f"{stem}.xml").write_text(aperio_xml(polys))


def host_item_ms(ds, idx: int, repeats: int = 5) -> dict:
    """One dataset item's host time by part, median of ``repeats``, one
    thread: decode, XML parse, Pillow-exact fill, image and mask resize,
    and the whole ``ds[idx]`` (which adds the float conversion)."""
    img_path, annot = ds.samples[idx]
    img, polys = load_rgb(img_path), parse_polygons(annot)
    mask = rasterize_polygons(polys, img.shape[:2])
    parts = {"decode": lambda: load_rgb(img_path), "parse_xml": lambda: parse_polygons(annot),
             "rasterize": lambda: rasterize_polygons(polys, img.shape[:2]),
             "resize_image": lambda: resize_image(img, ds.image_size),
             "resize_mask": lambda: resize_mask(mask, ds.image_size),
             "item": lambda: ds[idx]}
    out = {}
    for name, fn in parts.items():
        fn()
        samples = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(samples)
    return out


@tf32(False)
def check_augment_card_vs_cpu(images: torch.Tensor, masks: torch.Tensor) -> None:
    """The augmentation of one stage-4 batch on the card and on the CPU from
    the same parameters: images within 1e-5, masks exactly."""
    g = torch.Generator(device=DEV).manual_seed(5)
    for quantize in (0, 8):
        params = sample_monuseg_params(g, images.shape[0], quantize_angles=quantize)
        gi, gm = apply_monuseg_params(images, masks, params, quantize_angles=quantize)
        ci, cm = apply_monuseg_params(images.cpu(), masks.cpu(),
                                      {k: v.cpu() for k, v in params.items()},
                                      quantize_angles=quantize)
        err = (gi.cpu() - ci).abs().max().item()
        mask_diff = int((gm.cpu() != cm).sum())
        log(f"monuseg: augmentation card vs CPU, quantize_angles={quantize}: max|dimage|={err:.3e}, "
            f"mask pixels differing={mask_diff} of {cm.numel()}, jitter applied to "
            f"{int(params['apply'].sum())}/{images.shape[0]}")
        assert err <= 1e-5 and mask_diff == 0, (quantize, err, mask_diff)


def train_monuseg(tmp: Path):
    """MoNuSeg training: AugMoNuSegTrainer on a MoNuSeg tree the script
    writes, full width, fused loss, augmentation on the card, stages 1-4 at
    1 epoch each, then one stage-2 epoch with 8 grid angles."""
    root = tmp / "MoNuSeg"
    t0 = time.perf_counter()
    write_monuseg_tree(root)
    log(f"monuseg: wrote {AUG_PATCHES} PNG patches of {PATCH_PX} px and 4 Deflate TIFF tiles of "
        f"{TILE_PX} px in {time.perf_counter() - t0:.2f} s")

    polys = [np.asarray(p) for p in fixed_polygons()]
    got = int(rasterize_polygons(polys, (TILE_PX, TILE_PX)).sum())
    got_native = int(rasterize_polygons(polys, (TILE_PX, TILE_PX), backend="native").sum())
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        rasterize_polygons(polys, (TILE_PX, TILE_PX))
    raster_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"monuseg: rasterizer on {TILE_NUCLEI} fixed polygons: {got} pixels (Pillow {PIL_FIXED_COUNT}), "
        f"native even-odd {got_native} ({NATIVE_FIXED_COUNT}); {raster_ms:.3f} ms per "
        f"{TILE_PX} px tile")
    assert got == PIL_FIXED_COUNT and got_native == NATIVE_FIXED_COUNT, (got, got_native)

    cfgs = {s: {**c, "epochs_per_stage": 1} for s, c in DEFAULT_STAGE_CONFIGS.items()}
    trainer = AugMoNuSegTrainer(fused_loss=True, width=1.0, stage_configs=cfgs, verbose=False)
    assert trainer.augment
    trainer.setup_datasets(str(root))
    masks1 = np.stack([trainer.train_datasets[1][i][1] for i in range(AUG_PATCHES)])
    r = float(masks1.sum()) / masks1.size
    log(f"monuseg: pos_weight {trainer.pos_weight!r}, (1 - r) / r from the stage-1 masks "
        f"{(1 - r) / r!r} (r = {r:.5f})")
    assert abs(trainer.pos_weight - (1 - r) / r) <= 1e-12 * ((1 - r) / r)
    train_loaders, val_loaders = trainer.make_loaders(batch_size=TRAIN_BATCH, num_workers=4)

    host = {}
    for stage in (1, 4):  # the host side alone: decode, rasterize, resize, collate
        ds = trainer.train_datasets[stage]
        loader = DataLoader(ds, batch_size=TRAIN_BATCH, num_workers=4)
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        threaded = (time.perf_counter() - t0) / n * 1e3
        t0 = time.perf_counter()
        for i in range(TRAIN_BATCH):
            ds[i]
        host[stage] = {"loader_ms_per_batch": threaded,
                       "one_thread_ms_per_batch": (time.perf_counter() - t0) * 1e3}
    log("monuseg: host decode + rasterize + resize per batch of 8 (4 threads, and one): "
        + json.dumps(host))
    parts = {"patch 256 px -> 32 px": host_item_ms(trainer.train_datasets[1], 0),
             "patch 256 px at 256 px": host_item_ms(trainer.train_datasets[4], 0),
             "tile 1000 px -> 256 px": host_item_ms(trainer.val_datasets[4], 0)}
    log("monuseg: host ms per item by part (one thread, median of 5): " + json.dumps(parts))

    epoch = {}
    train_epoch = trainer.train_epoch

    def timed_train_epoch(loader, stage):
        torch.cuda.synchronize()
        w0, b0 = trainer.loader_stats["wait_s"], trainer.loader_stats["batches"]
        t0 = time.perf_counter()
        out = train_epoch(loader, stage)  # ends by reading the epoch's metrics back
        dt = time.perf_counter() - t0
        steps = trainer.loader_stats["batches"] - b0
        epoch[stage] = {"images_per_s": steps * TRAIN_BATCH / dt, "epoch_s": dt, "steps": steps,
                        "wait_ms_per_step": (trainer.loader_stats["wait_s"] - w0) / steps * 1e3}
        return out

    trainer.train_epoch = timed_train_epoch
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.train_progressive(train_loaders, val_loaders, save_dir=str(tmp / "ckpt"))
    wall = time.perf_counter() - t0
    counts = _lib.launch_counts()
    steps = sum(len(train_loaders[s]) for s in cfgs)
    log(f"monuseg: stages 1-4, full width, fused loss, augmented, {steps} train steps in "
        f"{wall:.1f} s, launches {json.dumps(counts)}")
    assert counts == {k: steps for k in LOSS_KERNELS}, counts
    for key in ("train_loss", "val_loss", "base_loss"):
        assert np.isfinite(history[key]).all(), (key, history[key])
    assert history["stage_transitions"] == [0, 1, 2, 3], history["stage_transitions"]
    assert all(u > 0 for u in history["uncertainty_weights_mean"][1:]), history
    for stage in (1, 2, 3, 4):
        assert (tmp / "ckpt" / f"ug_pgunet_stage{stage}_best.pth").exists(), stage
    log("monuseg: history", json.dumps({k: [round(v, 5) for v in vs] for k, vs in history.items()
                                        if k != "stage_transitions"}))
    log(f"monuseg: per stage (batch {TRAIN_BATCH}, float32, augmented, epoch of "
        f"{AUG_PATCHES} images): " + json.dumps(epoch))

    images = np.stack([trainer.train_datasets[4][i][0] for i in range(TRAIN_BATCH)])
    _lib.reset_launch_counts()
    predictor = Predictor(str(tmp / "ckpt" / "ug_pgunet_stage4_best.pth"), buckets=(TRAIN_BATCH,))
    check_response(predictor(images), TRAIN_BATCH)
    served = _lib.launch_counts()
    calls = predictor.stats()["device_calls"]
    log(f"monuseg: the stage-4 checkpoint served {TRAIN_BATCH} patches in {calls} device call(s), "
        f"launches {json.dumps(served)}")
    assert served == {"fused_double_conv": 9 * calls, "upsample2x": 4 * calls,
                      "uncertainty_from_logits": calls}, served

    tq = AugMoNuSegTrainer(fused_loss=True, width=1.0, stage_configs=cfgs, verbose=False,
                           aug_quantize=8)
    tq.setup_datasets(str(root), stages=(2,))
    tq.load_stage_weights(1, str(tmp / "ckpt" / "ug_pgunet_stage1_best.pth"))
    tl, vl = tq.make_loaders(batch_size=TRAIN_BATCH, num_workers=4)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    hq = tq.train_progressive(tl, vl, save_dir=str(tmp / "quantized"), stages=[2])
    dt = time.perf_counter() - t0
    q_counts = _lib.launch_counts()
    log(f"monuseg: stage 2 with aug_quantize=8: {len(tl[2])} steps and validation in {dt:.2f} s, "
        f"train loss {hq['train_loss']}, launches {json.dumps(q_counts)}")
    assert q_counts == {k: len(tl[2]) for k in LOSS_KERNELS}, q_counts
    assert np.isfinite(hq["train_loss"]).all() and np.isfinite(hq["val_loss"]).all()

    batch = next(iter(prefetch_to_device(iter(train_loaders[4]), device=DEV)))
    assert batch[0].device == DEV and batch[0].shape == (TRAIN_BATCH, 256, 256, 3)
    check_augment_card_vs_cpu(batch[0].permute(0, 3, 1, 2).contiguous(),
                              batch[1].permute(0, 3, 1, 2).contiguous())
    g = torch.Generator(device=DEV).manual_seed(6)
    x = batch[0].permute(0, 3, 1, 2).contiguous()
    y = batch[1].permute(0, 3, 1, 2).contiguous()
    for quantize in (0, 8):
        aug = lambda: apply_monuseg_params(  # noqa: E731
            x, y, sample_monuseg_params(g, TRAIN_BATCH, quantize_angles=quantize),
            quantize_angles=quantize)
        aug_ms = time_ms(aug, (), reps=10)
        device, _, _ = profile_call(f"monuseg: augmentation of one stage-4 batch, quantize_angles="
                                 f"{quantize} (sampling included)", aug)
        log(f"monuseg: augmentation, quantize_angles={quantize}: {aug_ms:.3f} ms per batch of 8 "
            f"(CUDA events), {sum(device.values()):.3f} ms of device time")
    step = make_seg_train_step(trainer.models[4], trainer.optimizer, 4, 256,
                               prev_model=trainer.models[3], prev_resolution=128,
                               fused_loss=True, augment=True)
    step(batch, trainer.pos_weight, g)
    profile_call("monuseg: one stage-4 augmented step, batch 8, fused loss, batch already on the "
                 "card", lambda: step(batch, trainer.pos_weight, g))
    return counts, epoch, host


# ---------------------------------------------------------------- MoNuSeg through the command lines
HERE = Path(__file__).resolve().parent
CLI_EPOCHS = 2
NATIVE_PX = 1008  # a 1000 px tile padded to a multiple of 16 (stage 4's four pools)
# the stage-4 shapes of a native-resolution forward: 1008 px down to 63 px
NATIVE_DOUBLE_CONVS = {name: (h * NATIVE_PX // 256, cin, cm, cout)
                       for name, (h, cin, cm, cout) in DOUBLE_CONVS.items()}
NATIVE_UPSAMPLES = {name: (c, h * NATIVE_PX // 256) for name, (c, h) in UPSAMPLES.items()}
SERVING_KERNELS = ("fused_double_conv", "upsample2x", "uncertainty_from_logits")


def train_command(root: Path, out: Path, *extra) -> list[str]:
    return [sys.executable, "-u", "-m", "ugpg_tpu_torch.cli.train_monuseg",
            "--data_dir", str(root), "--output_dir", str(out), "--epochs", str(CLI_EPOCHS),
            "--checkpoint_every", "1", "--batch_size", str(TRAIN_BATCH), *extra]


def run_command(cmd: list[str], stop_at: str | None = None, timeout: float = 600.0):
    """Run ``cmd`` from the repository's root; with ``stop_at``, send it
    SIGTERM when it prints a line starting so.  -> (exit code, output,
    seconds).  The child is killed if it outlives ``timeout``."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    watchdog = threading.Timer(timeout, proc.kill)
    watchdog.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if stop_at is not None and line.startswith(stop_at):
                proc.send_signal(signal.SIGTERM)
                stop_at = None
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, "".join(lines), time.perf_counter() - t0


def log_tail(label: str, text: str, n: int = 8) -> None:
    for line in text.strip().splitlines()[-n:]:
        log(f"{label} | {line}")


class _OneTile:
    """A dataset of one (image, mask) pair for ``evaluate_dataset_native``."""

    def __init__(self, image, mask):
        self.image, self.mask = image, mask

    def __len__(self):
        return 1

    def load_raw(self, idx):
        return self.image, self.mask


@contextlib.contextmanager
def counting_forwards_and_plain_calls(model_cls=PGUNet4):
    """Counts ``model_cls`` forwards and every call of the three serving
    kernels' plain versions while inside."""
    counts = {"forwards": 0, "plain": 0}
    forward = model_cls.forward

    def counted_forward(self, *args, **kwargs):
        counts["forwards"] += 1
        return forward(self, *args, **kwargs)

    plains = [(double_conv_mod, "fused_double_conv_reference"),
              (resize2x_mod, "upsample2x_reference"),
              (uncertainty_mod, "uncertainty_from_logits_reference")]
    saved = [getattr(mod, name) for mod, name in plains]

    def counted(fn):
        def wrapper(*args, **kwargs):
            counts["plain"] += 1
            return fn(*args, **kwargs)
        return wrapper

    model_cls.forward = counted_forward
    for (mod, name), fn in zip(plains, saved):
        setattr(mod, name, counted(fn))
    try:
        yield counts
    finally:
        model_cls.forward = forward
        for (mod, name), fn in zip(plains, saved):
            setattr(mod, name, fn)


@tf32(False)
def check_native_kernels() -> dict:
    """Each serving kernel against its plain version at every stage-4
    native-evaluation shape, float32, batch 1, phase 3's tolerance."""
    g = torch.Generator(device=DEV).manual_seed(7)
    worst = {}
    checks = [("fused_double_conv", name, dc_inputs(1, *shape, torch.float32, g), fused_double_conv,
               fused_double_conv_reference) for name, shape in NATIVE_DOUBLE_CONVS.items()]
    checks += [("upsample2x", name, up_inputs(1, *shape, torch.float32, g), upsample2x,
                upsample2x_reference) for name, shape in NATIVE_UPSAMPLES.items()]
    checks += [("uncertainty_from_logits", "logits", unc_inputs(1, 1, NATIVE_PX, torch.float32, g),
                uncertainty_from_logits, uncertainty_from_logits_reference)]
    for kernel, label, args, fn, plain in checks:
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, (kernel, label)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = err <= 1e-4 * max(1.0, scale)
        log(f"check native {kernel:24s} {label:7s} {tuple(args[0].shape)} float32 "
            f"max_abs_err={err:.3e} max|plain|={scale:.3e} -> {'ok' if ok else 'FAIL'}")
        assert ok, (kernel, label, err, scale)
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        del args, got, want
    torch.cuda.empty_cache()
    return worst


def start_ptxas(out_dir: Path) -> subprocess.Popen:
    """nvcc with -Xptxas -v on csrc/double_conv.cu into a cubin under
    ``out_dir``, started beside the build: the float32 conv kernel's
    registers and spills."""
    flags = [f for f in _lib.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return subprocess.Popen([_lib._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-I", str(_lib.CSRC),
                             "-o", str(out_dir / "double_conv.cubin"),
                             str(_lib.CSRC / "double_conv.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(proc: subprocess.Popen) -> dict:
    """Registers and spill bytes of each instance of the float32 conv
    kernel, by its plan: "bn32", "bn64", and "_scalar" where it stages x
    with 4-byte copies (Cin % 4 != 0)."""
    text, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, text[-4000:]
    report = {}
    for entry in text.split("Compiling entry function")[1:]:
        kernel = re.search(F32_KERNEL + r"ILi(\d+)ELb(\d)E", entry)
        if kernel is None:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        key = f"bn{32 * int(kernel.group(1))}" + ("" if kernel.group(2) == "1" else "_scalar")
        report[key] = {"registers": int(regs.group(1)), "spill_stores": int(spill.group(1)),
                       "spill_loads": int(spill.group(2))}
    log("ptxas -v", F32_KERNEL, json.dumps(report))
    assert sorted(report) == ["bn32", "bn32_scalar", "bn64", "bn64_scalar"], report
    return report


@tf32(False)
def time_double_conv(shapes: dict, n: int, label: str, ptxas: dict,
                     dtype: torch.dtype = torch.float32) -> dict:
    """The double conv (two launches of its conv kernel) over the shapes of
    one forward, batch ``n``, in ``dtype``: CUDA-event time beside its plain
    version, cuDNN's pair (TF32 off) and the bound at the card's peak for
    the dtype (bf16 tensor cores 989, FP32 CUDA cores 67 TFLOP/s) or its
    HBM rate; in float32 with each launch's plan (BN, tile, blocks) and its
    kernel's registers and spills."""
    g = torch.Generator(device=DEV).manual_seed(8)
    total = dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms", "flop"), 0.0)
    for name, (h, cin, cm, cout) in shapes.items():
        args = dc_inputs(n, h, cin, cm, cout, dtype, g)
        flop = 2 * n * h * h * 9 * (cin * cm + cm * cout)
        sz = dtype.itemsize
        nbytes = n * h * h * (cin + cout) * sz + 9 * cm * (cin + cout) * sz + 4 * (cm + cout)
        plan = []
        if dtype == torch.float32:
            for c_in, c_out in ((cin, cm), (cm, cout)):
                bn = f32_plan(n, h, h, c_out)
                plan.append({"bn": bn, "tile": list(F32_TILE),
                             "blocks": f32_blocks(n, h, h, c_out, bn),
                             **ptxas[f"bn{bn}" + ("" if c_in % 4 == 0 else "_scalar")]})
        t = {"ms": time_ms(fused_double_conv, args), "plain_ms": time_ms(
                fused_double_conv_reference, args, reps=1, repeats=3),
             "library_ms": time_ms(library_double_conv, args),
             "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": flop / PEAK_OPS_PER_S[dtype] * 1e3, "flop": flop}
        log(f"time {label}", json.dumps({"kernel": "fused_double_conv", "shape": name, "hw": h,
                                         "batch": n, "dtype": str(dtype)[6:], **t,
                                         "tflop_per_s": flop / t["ms"] / 1e9,
                                         "bound_share": max(t["bytes_ms"], t["ops_ms"]) / t["ms"],
                                         **({"launches": plan} if plan else {})}))
        for key, value in t.items():
            total[key] += value
        del args
    torch.cuda.empty_cache()
    total["tflop_per_s"] = total["flop"] / total["ms"] / 1e9
    total["bound_share"] = max(total["bytes_ms"], total["ops_ms"]) / total["ms"]
    log(f"time {label} total", json.dumps({"kernel": "fused_double_conv", "dtype": str(dtype)[6:],
                                          "px": next(iter(shapes.values()))[0], "batch": n,
                                          **total}))
    return total


def monuseg_command_lines(tmp: Path, root: Path, ptxas: dict):
    """Phase 10: train with SIGTERM and --resume through the training
    command, evaluate and infer through the test command, the card against
    the CPU, the kernels at the native-evaluation shapes, and the times."""
    out = tmp / "cli"
    rc, text, dt = run_command(train_command(root, out), stop_at="Stage 2, Batch")
    log(f"cli: train_monuseg, SIGTERM at its first 'Stage 2, Batch' line: exit {rc} after "
        f"{dt:.1f} s")
    log_tail("cli: preempted run", text)
    assert rc == 75, text[-4000:]
    last = read_checkpoint(out / "ug_pgunet_stage2_last.pth")
    log(f"cli: ug_pgunet_stage2_last.pth: stage {last['stage']}, epoch {last['epoch']}, "
        f"{len(last['optimizer_state_dict']['state'])} optimizer states, history of "
        f"{len(last['history']['train_loss'])} epochs")
    assert last["stage"] == 2 and last["epoch"] == 0, (last["stage"], last["epoch"])
    assert last["optimizer_state_dict"]["state"]
    assert len(last["history"]["train_loss"]) == CLI_EPOCHS + 1
    assert not list(out.glob("ug_pgunet_stage3*")) and not list(out.glob("ug_pgunet_stage4*"))

    rc, text, dt = run_command(train_command(root, out, "--resume"))
    log(f"cli: train_monuseg --resume: exit {rc} after {dt:.1f} s")
    log_tail("cli: resumed run", text)
    assert rc == 0 and "Resuming from stage 2" in text, text[-4000:]
    for stage in (1, 2, 3, 4):
        assert (out / f"ug_pgunet_stage{stage}_best.pth").exists(), stage
    with open(out / "training_log.csv") as f:
        rows = [(int(r["stage"]), int(r["epoch"])) for r in csv.DictReader(f)]
    history = read_checkpoint(out / "ug_pgunet_stage4_last.pth")["history"]
    log(f"cli: training_log.csv (stage, epoch) rows {rows}; history of "
        f"{len(history['train_loss'])} epochs, transitions {history['stage_transitions']}")
    assert rows == [(s, e) for s in (1, 2, 3, 4) for e in range(1, CLI_EPOCHS + 1)], rows
    assert len(history["train_loss"]) == 4 * CLI_EPOCHS
    assert history["stage_transitions"] == [0, 2, 4, 6]
    assert np.isfinite(history["train_loss"]).all() and np.isfinite(history["val_loss"]).all()

    model = str(out / "ug_pgunet_stage4_best.pth")
    res, inf = tmp / "eval", tmp / "infer"
    common = ["--model", model, "--data", str(root), "--num_images", "2", "--eval_full",
              "--save_uncertainty", "--output_dir", str(res)]
    _lib.reset_launch_counts()
    with counting_forwards_and_plain_calls() as calls:
        t0 = time.perf_counter()
        stage_res = test_monuseg.main(common)
        native_res = test_monuseg.main(common + ["--native_res"])
        inferred = test_monuseg.main(["--model", model, "--infer_dir",
                                      str(root / "val" / "images"), "--output_dir", str(inf)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = _lib.launch_counts()
    f = calls["forwards"]
    log(f"cli: test_monuseg (stage resolution, native resolution, --infer_dir) in {dt:.1f} s: "
        f"{f} stage-4 forwards, launches {json.dumps(launches)}, plain-version calls "
        f"{calls['plain']}")
    assert f > 0 and calls["plain"] == 0
    assert launches == {"fused_double_conv": 9 * f, "upsample2x": 4 * f,
                        "uncertainty_from_logits": f}, (launches, f)
    for name, got in (("evaluation_results.json", stage_res),
                      ("evaluation_results_native.json", native_res)):
        saved = json.loads((res / name).read_text())
        log(f"cli: {name}: " + json.dumps(saved))
        assert saved == got["metrics"] and saved["stage"] == 4 and saved["num_samples"] == 2
        values = [v for k, v in saved.items() if k.endswith(("_mean", "_std"))]
        assert len(values) == 12 and np.isfinite(values).all(), saved
    assert native_res["metrics"]["native_resolution"]
    pngs = {}
    for path in sorted(res.glob("uncertainty_*.png")) + sorted(inf.glob("*_mask.png")):
        pngs[path.name] = native.decode_png_gray(path).shape
    for path in sorted(inf.glob("*_vis.png")):
        pngs[path.name] = native.decode_png(path).shape
    log(f"cli: PNGs read back by the port's decoders: {json.dumps(pngs)}; inference "
        f"confidences {json.dumps(inferred['inference'])}")
    assert sorted(inferred["inference"]) == ["val_tile_0.tif", "val_tile_1.tif"]
    assert sum(name.startswith("uncertainty_") for name in pngs) == 2
    assert all(pngs[f"val_tile_{i}_{kind}.png"][:2] == (TILE_PX, TILE_PX)
               for i in (0, 1) for kind in ("mask", "vis"))

    # the card against the CPU: one tile cropped to 400 x 344 px (padded to 352),
    # through the trained checkpoint and phase 5's seeded one, whose spread
    # logits give both classes
    img, mask = MoNuSegDataset(str(root), image_size=256, split="val").load_raw(0)
    tile = _OneTile(img[:400, :344], mask[:400, :344])
    seeded = tmp / "seeded_stage4.pth"
    random_checkpoint(seeded)
    for label, ckpt in (("trained", model), ("seeded", str(seeded))):
        with tf32(False):
            gpu = SlidePredictor(ckpt)(tile.image[None])
            cpu = SlidePredictor(ckpt, device="cpu")(tile.image[None])
            gpu_m = MoNuSegEvaluator(ckpt).evaluate_dataset_native(tile)
            cpu_m = MoNuSegEvaluator(ckpt, device="cpu").evaluate_dataset_native(tile)
        err = float(np.abs(gpu[1] - cpu[1]).max())
        err_unc = float(np.abs(gpu[2] - cpu[2]).max())
        flips = gpu[0] != cpu[0]
        metric_err = max(abs(gpu_m[k] - cpu_m[k]) for k in cpu_m if isinstance(cpu_m[k], float))
        log(f"cli: card vs CPU, {label} checkpoint, a 400 x 344 crop at native resolution: "
            f"max|dprob|={err:.3e} max|dunc|={err_unc:.3e} pred flips={int(flips.sum())} of "
            f"{flips.size} ({float(cpu[0].mean()):.4f} positive), native metrics "
            f"max|d|={metric_err:.3e} (dice {gpu_m['dice_mean']:.6f} / {cpu_m['dice_mean']:.6f})")
        assert gpu[1].shape == (1, 400, 344, 1) and cpu[1].std() > 1e-3
        assert err <= 1e-4 and err_unc <= 1e-4 and metric_err <= 1e-4
        assert np.all(np.abs(cpu[1][flips] - 0.5) < 1e-4)
    assert 0.0 < float(cpu[0].mean()) < 1.0  # the seeded model predicts both classes

    errors = check_native_kernels()
    dc = time_double_conv(NATIVE_DOUBLE_CONVS, 1, "native", ptxas)
    # the stage-resolution evaluator's shapes: 256 px, batch 8
    dc_stage = time_double_conv(DOUBLE_CONVS, TRAIN_BATCH, "stage", ptxas)

    # times: native evaluation per tile, stage-resolution evaluation images/s
    ev = MoNuSegEvaluator(model)
    val = MoNuSegDataset(str(root), image_size=256, split="val")
    ev.evaluate_dataset_native(val)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.evaluate_dataset_native(val)
    s_per_tile = (time.perf_counter() - t0) / len(val)
    x = torch.from_numpy(img.astype(np.float32) / 255.0)[None].to(DEV)
    forward_ms = time_ms(lambda: native_forward(ev.model, x, (16, 16)), (), reps=2, repeats=3)
    patches = AugMoNuSegDataset(str(root), image_size=256)
    ev.evaluate_dataset(patches, batch_size=TRAIN_BATCH)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.evaluate_dataset(patches, batch_size=TRAIN_BATCH)
    ips = len(patches) / (time.perf_counter() - t0)
    log(f"cli: native evaluation {s_per_tile:.4f} s per {TILE_PX} px tile (decode, XML, fill, "
        f"forward, metrics), the padded forward alone {forward_ms:.2f} ms (CUDA events); "
        f"stage-resolution evaluation {ips:.2f} images/s (batch {TRAIN_BATCH}, {len(patches)} "
        f"{PATCH_PX} px patches, decode included)")
    # the float32 double conv must run on its CUDA-core kernel: 18 launches
    # per forward by the C side's count (exact), device time in the profile,
    # and there no more than 18 launches.  torch.profiler loses kernels on
    # that machine (``profile_kernel``), so the fullest window's count is
    # held to at most 18, not to 18.
    f32_before = f32_launches()
    device, _, counts, forwards = profile_kernel(
        f"eval: one native-resolution forward, {NATIVE_PX} px, float32",
        lambda: native_forward(ev.model, x, (16, 16)), F32_KERNEL, 18)
    f32_calls = f32_launches() - f32_before
    f32_ms = sum(v for k, v in device.items() if F32_KERNEL in k)
    f32_seen = {k[:60]: v for k, v in counts.items() if F32_KERNEL in k}
    log(f"eval: float32 double conv ({F32_KERNEL}) in one native forward: {f32_ms:.3f} ms of "
        f"device time, {f32_ms / sum(device.values()):.1%} of device busy, "
        f"{sum(f32_seen.values())} launches in the profile, {f32_calls} in {forwards} "
        "forwards by the C side's count")
    assert f32_calls == 18 * forwards and f32_ms > 0 and 0 < sum(f32_seen.values()) <= 18, \
        (f32_calls, forwards, f32_seen, f32_ms)
    times = {"native_s_per_tile": s_per_tile, "native_forward_ms": forward_ms,
             "stage_res_images_per_s": ips, "double_conv_f32_1008": dc,
             "double_conv_f32_256": dc_stage}
    return launches, errors, times


# ---------------------------------------------------------------- Herlev classification
HERLEV_PER_CLASS = 12
HERLEV_BATCH = 16  # the reference's
HERLEV_EPOCHS = 2
HERLEV_TIMED_REPEAT = 8  # the train split (56 images) read 8 times an epoch: 28 steps
HERLEV_TIMED_EPOCHS = 3
HERLEV_STEP_REPEATS = 20
SERVE_BUCKETS = (1, 8, 64)
LATENCY_REPEATS = 50


def cls_double_convs(stage: int) -> dict:
    """(H, Cin, Cm, Cout) of each DoubleConv of the stage's classifier
    encoder at its resolution, from the package's own specs."""
    inc, downs = ENCODER_SPECS[stage]
    px = CLS_STAGE_RESOLUTIONS[stage]
    out, c = {"inc": (px, 3, inc, inc)}, inc
    for name, width in downs:
        px //= 2
        out[name] = (px, c, width, width)
        c = width
    return out


def bmp_bytes(img: np.ndarray, bits: int = 24, top_down: bool = False) -> bytes:
    """An uncompressed BI_RGB BMP of an (H, W, 3) uint8 image, rows padded
    to 4 bytes; 32-bit files carry an alpha byte."""
    h, w, _ = img.shape
    bpp = bits // 8
    stride = (w * bpp + 3) // 4 * 4
    px = img[::1 if top_down else -1, :, ::-1]  # rows in file order, RGB -> BGR
    if bpp == 4:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], 2)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bpp] = px.reshape(h, w * bpp)
    data = rows.tobytes()
    header = struct.pack("<2sIHHI", b"BM", 54 + len(data), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, len(data),
                       2835, 2835, 0, 0)
    return header + info + data


def write_herlev_tree(root: Path, seed: int = 0) -> dict:
    """The 7 class folders with HERLEV_PER_CLASS cell images each, 64-512 px
    a side, odd widths; 24-bit bottom-up, every fourth file 32-bit and
    every fourth (offset 2) top-down.  The nucleus's shade and size follow
    the class.  -> {path: written pixels}."""
    rng = np.random.default_rng(seed)
    written = {}
    for ci, name in enumerate(CLASS_NAMES):
        d = root / name
        d.mkdir(parents=True)
        for i in range(HERLEV_PER_CLASS):
            h, w = int(rng.integers(64, 513)), int(rng.integers(64, 512)) | 1
            yy, xx = np.mgrid[:h, :w]
            img = rng.integers(170, 235, (h, w, 3)).astype(np.int64)
            r = min(h, w) * (0.15 + 0.03 * ci)
            nucleus = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < r * r
            img[nucleus] = (40 + 20 * ci, 60, 160 - 15 * ci)
            img = np.clip(img + rng.integers(-12, 12, (h, w, 3)), 0, 255).astype(np.uint8)
            path = d / f"{name}_{i:02d}.bmp"
            path.write_bytes(bmp_bytes(img, bits=32 if i % 4 == 1 else 24,
                                       top_down=i % 4 == 2))
            written[path] = img
    return written


def herlev_train_command(root: Path, out: Path, *extra) -> list[str]:
    return [sys.executable, "-u", "-m", "ugpg_tpu_torch.cli.train_herlev", "--data_dir",
            str(root), "--output_dir", str(out), "--epochs", str(HERLEV_EPOCHS),
            "--batch_size", str(HERLEV_BATCH), *extra]


def random_classifier_checkpoint(path: Path, stage: int = 4, seed: int = 0) -> None:
    """Full-width classifier weights from a seed (He-scaled convs and
    linears, non-trivial BN stats) in the reference's container and key set."""
    g = np.random.default_rng(seed)
    sd = {}
    for key, value in HerlevClassificationModel(stage, 7).state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.int64)
            continue
        if value.dim() in (2, 4):
            v = g.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif key.endswith("running_var"):
            v = 1 + 0.2 * g.random(shape)
        elif key.endswith("weight"):  # BN scale
            v = 1 + 0.1 * g.standard_normal(shape)
        else:  # biases, running means
            v = 0.1 * g.standard_normal(shape)
        sd[key] = torch.from_numpy(np.asarray(v, np.float32))
    torch.save({"stage": stage, "epoch": 0, "config": {"num_classes": 7},
                "model_state_dict": full_classifier_state_dict(sd, stage)}, path)


@tf32(False)
def check_classifier_kernels() -> float:
    """The double conv against its plain version at every classifier shape
    (stages 1-4), batch 8, bf16 and float32, and at stage 1's 512 channels
    at batch 1 (float32, BN 32), phase 3's tolerance."""
    g = torch.Generator(device=DEV).manual_seed(9)
    worst = 0.0
    cases = [(stage, name, shape, dtype, CHECK_BATCH) for dtype in (torch.float32, torch.bfloat16)
             for stage in (1, 2, 3, 4) for name, shape in cls_double_convs(stage).items()]
    cases.append((1, "inc", cls_double_convs(1)["inc"], torch.float32, 1))
    for stage, name, shape, dtype, n in cases:
        args = dc_inputs(n, *shape, dtype, g)
        got, want = fused_double_conv(*args), fused_double_conv_reference(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        rel = 1e-4 if dtype == torch.float32 else 2e-2
        ok = got.shape == want.shape and err <= rel * max(1.0, scale)
        log(f"check herlev stage {stage} {name:5s} {tuple(args[0].shape)} {str(dtype)[6:]:8s} "
            f"max_abs_err={err:.3e} max|plain|={scale:.3e} -> {'ok' if ok else 'FAIL'}")
        assert ok, (stage, name, dtype, n, err, scale)
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        del args, got, want
    torch.cuda.empty_cache()
    return worst


class Repeated:
    """A map-style dataset read ``times`` over; every read decodes and
    resizes its file anew."""

    def __init__(self, dataset, times: int):
        self.dataset, self.times = dataset, times

    def __len__(self) -> int:
        return self.times * len(self.dataset)

    def __getitem__(self, i: int):
        return self.dataset[i % len(self.dataset)]


def herlev_train_throughput(root: Path, class_weights: list) -> dict:
    """Train images/s per stage at batch 16, float32 with cuDNN's default
    TF32, from the tree through the loaders (4 threads) and the device
    prefetch queue.  An epoch reads the train split HERLEV_TIMED_REPEAT
    times; one warm-up epoch, then HERLEV_TIMED_EPOCHS timed ones, each
    epoch's rate kept; then one epoch of the loader alone, the host's rate,
    and the step alone, repeated on one host batch.  And a profile of one
    stage-4 train step."""
    cfg = create_herlev_config()
    cfg.update(data_dir=str(root), class_weights=class_weights, verbose=False)
    trainer = HerlevTrainer(cfg)
    out = {}
    for stage in (1, 2, 3, 4):
        ds = Repeated(HerlevDataset(str(root), image_size=CLS_STAGE_RESOLUTIONS[stage],
                                    split="train", verbose=False), HERLEV_TIMED_REPEAT)
        loader = DataLoader(ds, batch_size=HERLEV_BATCH, shuffle=True, num_workers=4,
                            seed=42 + stage)
        trainer.setup_optimizer_scheduler(stage)
        trainer.train_epoch(loader, stage)  # warm: cuDNN's plans, the allocator
        torch.cuda.synchronize()
        rates = []
        for _ in range(HERLEV_TIMED_EPOCHS):
            t0 = time.perf_counter()
            tr_loss = trainer.train_epoch(loader, stage)[0]  # reads the epoch's metrics back
            rates.append(len(ds) / (time.perf_counter() - t0))
            assert math.isfinite(tr_loss)
        t0 = time.perf_counter()
        for _ in loader:
            pass
        loader_ips = len(ds) / (time.perf_counter() - t0)
        batch = next(iter(loader))
        step = trainer._get_train_step(stage)
        step(batch, trainer.class_weights, trainer.generator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HERLEV_STEP_REPEATS):  # one host batch, no loader running
            step(batch, trainer.class_weights, trainer.generator)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / HERLEV_STEP_REPEATS * 1e3
        median = statistics.median(rates)
        out[stage] = {"images_per_s": median, "epochs": rates,
                      "spread": (max(rates) - min(rates)) / median,
                      "loader_images_per_s": loader_ips, "step_alone_ms": step_ms,
                      "timed_steps": HERLEV_TIMED_EPOCHS * len(loader)}
    profile_call(f"herlev train: one stage-4 step, batch {HERLEV_BATCH}, float32",
                 lambda: step(batch, trainer.class_weights, trainer.generator))
    log(f"herlev train: per stage at batch {HERLEV_BATCH}, {len(ds)} images an epoch (the "
        f"train split {HERLEV_TIMED_REPEAT} times, decoded and resized on 4 threads), "
        f"{HERLEV_TIMED_EPOCHS} timed epochs; the loader alone over one epoch; the step "
        f"alone, {HERLEV_STEP_REPEATS} on one host batch: "
        + json.dumps({s: {k: [round(x, 2) for x in v] if isinstance(v, list) else round(v, 4)
                          for k, v in r.items()} for s, r in out.items()}))
    return out


def serve_herlev(tmp: Path) -> tuple[dict, dict]:
    """The classification Predictor at full width, stage 4 (224 px):
    requests, the micro-batcher, the card against the CPU, images/s at
    bucket 64 in bf16 with a profile, and the bucket-1 latency."""
    ckpt = tmp / "herlev_stage4_seeded.pth"
    random_classifier_checkpoint(ckpt)
    rng = np.random.default_rng(3)
    px = CLS_STAGE_RESOLUTIONS[4]
    images8 = rng.integers(0, 256, (64, px, px, 3), dtype=np.uint8)
    images = images8.astype(np.float32) / 255.0
    common = dict(task_type="classification", num_classes=7, buckets=SERVE_BUCKETS)

    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    pb = Predictor(str(ckpt), **common)
    p8 = Predictor(str(ckpt), input_dtype=np.uint8, **common)
    p32 = Predictor(str(ckpt), dtype=torch.float32, **common)
    pmc = Predictor(str(ckpt), dtype=torch.float32, mc_dropout=8, **common)
    log(f"herlev serve: predictors built in {time.perf_counter() - t0:.2f} s")
    for n in (1, 5, 8, 11):
        a, b = pb(images[:n]), p8(images8[:n])
        for labels, probs in (a, b):
            assert labels.shape == (n,) and labels.dtype == np.int32 and probs.shape == (n, 7)
            assert np.isfinite(probs).all() and np.allclose(probs.sum(-1), 1.0, atol=1e-5)
            np.testing.assert_array_equal(labels, probs.argmax(-1))
        for u, v in zip(a, b):  # x/255 on the host == on the device
            np.testing.assert_array_equal(u, v)
    odd = pb(images[:3, :200, :180])  # any request size: resized on the host
    assert odd[1].shape == (3, 7)
    log("herlev serve: requests of 1, 5, 8, 11 images (float32 and uint8) and 3 of 200 x 180 "
        "px ok")

    server = BatchingServer(pb, max_latency_ms=20.0)
    try:
        futures = [server.submit(im) for im in images[:16]]
        results = [f.result(timeout=600) for f in futures]
    finally:
        server.close()
    direct = pb(images[:16])
    for i, (label, probs) in enumerate(results):
        assert label == direct[0][i]
        np.testing.assert_allclose(probs, direct[1][i], atol=1e-6)
    log("herlev serve: 16 concurrent submits ok", json.dumps(server.stats()))

    labels, mean, var = pmc(images[:8])
    again = pmc(images[:8])
    assert labels.shape == (8,) and mean.shape == (8, 7) and var.shape == (8,)
    assert (var >= 0).all() and var.max() > 0 and np.allclose(mean.sum(-1), 1.0, atol=1e-5)
    for u, v in zip(again, (labels, mean, var)):
        np.testing.assert_array_equal(u, v)
    log(f"herlev serve: mc_dropout=8, 8 images: variance {np.round(var, 6).tolist()}, equal on "
        "a repeat")

    with tf32(False):
        g32 = p32(images[:4])
        cpu = Predictor(str(ckpt), dtype=torch.float32, device="cpu", **common)(images[:4])
    err = float(np.abs(g32[1] - cpu[1]).max())
    top2 = np.sort(cpu[1], -1)[:, -2:]
    flips = g32[0] != cpu[0]
    log(f"herlev serve: float32 card vs CPU: max|dprob|={err:.3e}, label flips {int(flips.sum())}, "
        f"top-2 gaps {np.round(top2[:, 1] - top2[:, 0], 5).tolist()}")
    assert err <= 1e-4 and np.all(top2[flips, 1] - top2[flips, 0] < 1e-4)
    bf_err = float(np.abs(pb(images[:4])[1] - cpu[1]).max())
    log(f"herlev serve: bf16 card vs float32 CPU: max|dprob|={bf_err:.3e}")
    assert bf_err < 5e-2

    pb(images)  # warm
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        pb(images)
    dt = time.perf_counter() - t0
    ips = reps * 64 / dt
    log(f"herlev serve: bucket 64 bf16: {ips:.2f} images/s ({dt / reps * 1e3:.2f} ms per call)")
    f32_before = f32_launches()
    device, wall_ms, seen, _ = profile_kernel("herlev serve: bucket 64, 64 images, bf16",
                                              lambda: pb(images), "conv3x3_mma_kernel", 8)
    f32_calls = f32_launches() - f32_before
    mma_ms = sum(v for k, v in device.items() if "conv3x3_mma_kernel" in k)
    mma_seen = sum(v for k, v in seen.items() if "conv3x3_mma_kernel" in k)
    f32_ms = sum(v for k, v in device.items() if F32_KERNEL in k)
    log(f"herlev serve: bf16 double conv (conv3x3_mma_kernel, 8 launches a call, {mma_seen} in "
        f"the profile): {mma_ms:.3f} ms of device time, {mma_ms / wall_ms:.1%} of the call, "
        f"{mma_ms / sum(device.values()):.1%} of device busy; {F32_KERNEL} {f32_ms:.3f} ms, "
        f"{f32_calls} launches")
    assert mma_ms > 0 and f32_ms == 0 and f32_calls == 0, (mma_ms, f32_ms, f32_calls)

    latency = latency_ms(lambda: pb(images[:1]))  # numpy out: the device's work is done
    log("herlev serve: bucket-1 latency, bf16, one 224 px image:", json.dumps(latency))

    counts = _lib.launch_counts()
    calls = sum(p.stats()["device_calls"] for p in (pb, p8, p32, pmc))
    log(f"herlev serve: {calls} device calls, launches {json.dumps(counts)}")
    assert counts == {"fused_double_conv": 4 * calls}, (counts, calls)
    return counts, {"images_per_s": ips, "latency": latency}


def herlev(tmp: Path, ptxas: dict):
    """Phase 11: Herlev classification through its command lines, the
    trainer's throughput, the evaluator, serving, and the double conv at
    the classifier's shapes."""
    root = tmp / "Herlev"
    t0 = time.perf_counter()
    written = write_herlev_tree(root)
    for path, img in written.items():
        np.testing.assert_array_equal(native.decode_bmp(path), img, err_msg=str(path))
    log(f"herlev: wrote and decoded {len(written)} BMPs (7 classes, 64-512 px, 24/32-bit, "
        f"bottom-up/top-down) in {time.perf_counter() - t0:.2f} s, every pixel as written")

    out = tmp / "herlev_cli"
    rc, text, dt = run_command(herlev_train_command(root, out), stop_at="Stage 2, Batch")
    log(f"herlev cli: train_herlev, SIGTERM at its first 'Stage 2, Batch' line: exit {rc} after "
        f"{dt:.1f} s")
    log_tail("herlev cli: preempted run", text)
    assert rc == 75, text[-4000:]
    last = read_checkpoint(out / "herlev_stage2_last.pth")
    assert last["stage"] == 2 and last["epoch"] == 1, (last["stage"], last["epoch"])
    assert last["optimizer_state_dict"]["state"] and last["generator_state"] is not None
    assert not list(out.glob("herlev_stage3*")) and not list(out.glob("herlev_stage4*"))

    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    rc = train_herlev.cli(["--data_dir", str(root), "--output_dir", str(out), "--epochs",
                           str(HERLEV_EPOCHS), "--batch_size", str(HERLEV_BATCH), "--resume"])
    torch.cuda.synchronize()
    train_launches = _lib.launch_counts()
    log(f"herlev cli: train_herlev --resume (in this process): exit {rc} after "
        f"{time.perf_counter() - t0:.1f} s, launches {json.dumps(train_launches)}")
    assert rc == 0 and not any(train_launches.get(k) for k in LOSS_KERNELS), train_launches
    with open(out / "training_log.csv") as f:
        rows = [(int(r["stage"]), int(r["epoch"])) for r in csv.DictReader(f)]
    history = json.loads((out / "training_history.json").read_text())
    log(f"herlev cli: training_log.csv (stage, epoch) rows {rows}; history",
        json.dumps({k: [round(v, 5) if isinstance(v, float) else v for v in vs]
                    for k, vs in history.items()}))
    assert rows == [(s, e) for s in (1, 2, 3, 4) for e in range(1, HERLEV_EPOCHS + 1)], rows
    assert [t["stage"] for t in history["stage_transitions"]] == [1, 2, 3, 4]
    assert len(history["train_loss"]) == 4 * HERLEV_EPOCHS
    for key in ("train_loss", "val_loss", "base_loss"):
        assert np.isfinite(history[key]).all(), (key, history[key])
    assert all(u > 1.0 for u in history["uncertainty_weights_mean"][HERLEV_EPOCHS:]), history
    for stage in (1, 2, 3, 4):
        assert (out / f"herlev_stage{stage}_best.pth").exists(), stage
    config = json.loads((out / "config.json").read_text())

    train_ips = herlev_train_throughput(root, config["class_weights"])

    model = str(out / "herlev_stage4_best.pth")
    res = tmp / "herlev_eval"
    image = str(next(iter(written)))
    _lib.reset_launch_counts()
    f32_before = f32_launches()
    with tf32(False), counting_forwards_and_plain_calls(HerlevClassificationModel) as calls:
        t0 = time.perf_counter()
        results = test_herlev.main(["--model", model, "--data_dir", str(root), "--output_dir",
                                    str(res)])
        predicted = test_herlev.main(["--model", model, "--data_dir", str(root), "--predict",
                                      image])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    eval_launches = _lib.launch_counts()
    f32_calls = f32_launches() - f32_before
    f = calls["forwards"]
    log(f"herlev cli: test_herlev (test split, --predict) in {dt:.1f} s: {f} stage-4 forwards, "
        f"launches {json.dumps(eval_launches)}, {F32_KERNEL} {f32_calls} by the C side's count, "
        f"plain-version calls {calls['plain']}; accuracy {results['accuracy']:.4f}, ROC-AUC "
        f"{results['roc_auc']:.4f}, --predict {predicted['prediction']}")
    assert f > 0 and calls["plain"] == 0 and f32_calls == 8 * f, (f, calls, f32_calls)
    assert eval_launches == {"fused_double_conv": 4 * f}, (eval_launches, f)
    assert json.loads((res / "evaluation_results.json").read_text()) == results
    assert results["num_samples"] == 7 * (HERLEV_PER_CLASS - int(HERLEV_PER_CLASS * 0.7)
                                          - int(HERLEV_PER_CLASS * 0.2))
    assert np.isfinite([results["accuracy"], results["roc_auc"]]).all()
    assert predicted["prediction"] in CLASS_NAMES

    serve_launches, serving = serve_herlev(tmp)
    worst = check_classifier_kernels()
    shapes = cls_double_convs(4)
    dc_bf16 = time_double_conv(shapes, TIME_BATCH, "herlev bf16", ptxas, torch.bfloat16)
    dc_f32 = time_double_conv(shapes, HERLEV_BATCH, "herlev float32", ptxas)
    launches = eval_launches["fused_double_conv"] + serve_launches["fused_double_conv"]
    return launches, worst, {"train_images_per_s": train_ips, **serving,
                             "double_conv_bf16_64": dc_bf16, "double_conv_f32_16": dc_f32}


# ---------------------------------------------------------------- the serving stack and the tools
ART_BUCKETS = SERVE_BUCKETS
SLIDE_PX = TILE_PX
HTTP_DEADLINE_MS = 5.0  # the serve command's default --max_latency_ms
HTTP_CONCURRENT = 16
# kernels of a library convolution (cuDNN's fprop, implicit-GEMM and Winograd
# kernels); the port's own are conv3x3_*, and cuBLAS's GEMMs (xmma_gemm) serve
# the heads' matmuls
LIBRARY_CONV = re.compile(r"cudnn|fprop|implicit|winograd|conv(?!3x3_)", re.IGNORECASE)


def port_command(module: str, *args) -> list[str]:
    """One of the port's command lines, as a user runs it."""
    return [sys.executable, "-u", "-m", module, *args]


def start_command(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def finish_command(proc: subprocess.Popen, label: str, timeout: float = 600.0) -> str:
    """Wait for a child of ``start_command``; raise unless it exits 0."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"{label}: no exit after {timeout} s\n{out[-4000:]}")
    log_tail(label, out, 4)
    assert proc.returncode == 0, f"{label}: exit {proc.returncode}\n{out[-4000:]}"
    return out


def drain_launches(total: dict) -> None:
    """Add the launch counts so far to ``total`` and set them to 0."""
    for kernel, n in _lib.launch_counts().items():
        total[kernel] = total.get(kernel, 0) + n
    _lib.reset_launch_counts()


def assert_same(got, want, label):
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (label, g.dtype, w.dtype, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=label)


def http_call(port: int, method: str, path: str, body: bytes | None = None, ctype=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def npz(data: bytes) -> dict:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def latency_ms(fn, repeats: int = LATENCY_REPEATS) -> dict:
    """Wall ms of ``repeats`` calls of ``fn`` after one: median, p10, p90,
    min and max."""
    fn()
    lat = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    return {"median_ms": statistics.median(lat), "p10_ms": lat[len(lat) // 10],
            "p90_ms": lat[len(lat) * 9 // 10], "min_ms": lat[0], "max_ms": lat[-1],
            "repeats": repeats}


def artifacts(tmp: Path, seg: Path, cls: Path, tile: np.ndarray,
              launches: dict) -> tuple[dict, dict]:
    """Phase 12, artifacts: the export command's float32 and uint8 compact
    artifacts (exported in children), the classifier's and the slide
    predictor's (here), each against the live predictor on the card.  Adds
    the phase's launches to ``launches``; the timings come after, in
    ``artifact_times``."""
    out = {}
    g = np.random.default_rng(12)
    images8 = g.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
    images = images8.astype(np.float32) / 255.0
    live = {"float32": Predictor(str(seg), buckets=ART_BUCKETS, dtype=None),
            "uint8_compact": Predictor(str(seg), buckets=ART_BUCKETS, dtype=None,
                                       input_dtype=np.uint8, compact_output=True)}
    requests = [(n, req) for n in (1, 5, 8, 11) for req in (images[:n], images8[:n])]
    want = {key: [p(req) for _, req in requests] for key, p in live.items()}
    arts = {key: ExportedPredictor(tmp / f"art_{key}") for key in live}
    for key, art in arts.items():
        assert art.manifest["buckets"] == list(ART_BUCKETS), art.manifest
        drain_launches(launches)
        f32_before = f32_launches()
        for (n, req), w in zip(requests, want[key]):
            assert_same(art(req), w, f"artifact {key}, {n} images, {req.dtype}")
        torch.cuda.synchronize()
        counts, f32_calls = _lib.launch_counts(), f32_launches() - f32_before
        calls = art.stats()["device_calls"]
        log(f"artifacts: {key}: bit-identical to the live float32 Predictor on requests of 1, 5, "
            f"8, 11 images (float32 and uint8); {calls} device calls, launches "
            f"{json.dumps(counts)}, {F32_KERNEL} {f32_calls} by the C side's count")
        assert counts == {"fused_double_conv": 9 * calls, "upsample2x": 4 * calls,
                          "uncertainty_from_logits": calls}, (counts, calls)
        assert f32_calls == 18 * calls, (f32_calls, calls)
    cpu_art = ExportedPredictor(tmp / "art_float32", device="cpu")
    cpu = cpu_art(images[:1])
    cpu_live = Predictor(str(seg), buckets=(1,), dtype=None, device="cpu")(images[:1])
    err = max(float(np.abs(a - b).max()) for a, b in zip(cpu[1:], cpu_live[1:]))
    flips = cpu[0] != cpu_live[0]
    log(f"artifacts: the card's float32 artifact loaded on the CPU vs the live CPU Predictor: "
        f"max|d| {err:.3e} (probabilities and uncertainty), pred flips {int(flips.sum())}")
    assert err <= 1e-4 and np.all(np.abs(cpu_live[1][flips] - 0.5) < 1e-4)
    del cpu_art

    px = CLS_STAGE_RESOLUTIONS[4]
    cls_images = np.random.default_rng(13).random((11, px, px, 3), dtype=np.float32)
    for mc in (0, 8):
        live_cls = Predictor(str(cls), task_type="classification", num_classes=7,
                             buckets=ART_BUCKETS, dtype=None, mc_dropout=mc)
        path = live_cls.export(tmp / f"cls_art_{mc}")
        want_cls = [live_cls(cls_images[:n]) for n in (1, 5, 8, 11)]
        served = ExportedPredictor(path)
        drain_launches(launches)
        for n, w in zip((1, 5, 8, 11), want_cls):
            assert_same(served(cls_images[:n]), w, f"classifier artifact, mc_dropout={mc}, {n}")
        counts, calls = _lib.launch_counts(), served.stats()["device_calls"]
        log(f"artifacts: classifier (stage 4, 224 px, float32, mc_dropout={mc}): bit-identical to "
            f"the live Predictor on 1, 5, 8, 11 images; {calls} device calls, launches "
            f"{json.dumps(counts)}")
        assert counts == {"fused_double_conv": 4 * calls}, (counts, calls)

    slide = SlidePredictor(str(seg))
    t0 = time.perf_counter()
    path = slide.export(tmp / "slide_art", sizes=((SLIDE_PX, SLIDE_PX),))
    export_s = time.perf_counter() - t0
    want_slide = slide(tile[None])
    served = ExportedSlidePredictor(path)
    drain_launches(launches)
    f32_before = f32_launches()
    got = served(tile[None])
    torch.cuda.synchronize()
    f32_calls, counts = f32_launches() - f32_before, _lib.launch_counts()
    assert_same(got, want_slide, "slide artifact")
    log(f"artifacts: slide ({SLIDE_PX} px, exported in {export_s:.1f} s): bit-identical to the "
        f"live SlidePredictor on one {SLIDE_PX} px tile; launches {json.dumps(counts)}, "
        f"{F32_KERNEL} {f32_calls} by the C side's count")
    assert f32_calls == 18 and counts == {"fused_double_conv": 9, "upsample2x": 4,
                                          "uncertainty_from_logits": 1}, (f32_calls, counts)
    return out, {"live": live["float32"], "art": arts["float32"], "images": images,
                  "tile": tile, "slide": want_slide}


def artifact_times(ref: dict) -> dict:
    """Phase 12: the float32 artifact's bucket-64 profile (its float32 conv
    kernel, no library conv kernel), images/s beside the live Predictor in
    turns, and 16 concurrent BatchingServer submits."""
    out = {}
    art, live, images = ref["art"], ref["live"], ref["images"]
    f32_before = f32_launches()
    art(images)
    per_call = f32_launches() - f32_before
    assert per_call > 0, per_call
    device, wall_ms, seen, _ = profile_kernel(
        "artifacts: the float32 artifact, bucket 64, 64 images", lambda: art(images), F32_KERNEL,
        per_call)
    f32_ms = sum(v for k, v in device.items() if F32_KERNEL in k)
    library_convs = {k[:90]: v for k, v in device.items() if LIBRARY_CONV.search(k)}
    log(f"artifacts: bucket-64 profile: {F32_KERNEL} {f32_ms:.3f} ms of device time "
        f"({sum(v for k, v in seen.items() if F32_KERNEL in k)} launches in the profile), "
        f"library conv kernels {json.dumps(library_convs)}")
    assert f32_ms > 0 and not library_convs, (f32_ms, library_convs)

    reps, ips = 3, {"live": [], "artifact": []}
    for name in ("live", "artifact", "artifact", "live"):
        p = live if name == "live" else art
        p(images)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            p(images)
        ips[name].append(reps * 64 / (time.perf_counter() - t0))
    out["images_per_s"] = {k: statistics.mean(v) for k, v in ips.items()}
    out["images_per_s_runs"] = ips
    log(f"artifacts: bucket 64, float32: live Predictor {ips['live']} images/s, exported "
        f"{ips['artifact']} images/s (in turns: live, exported, exported, live)")

    server = BatchingServer(art, max_latency_ms=20.0)
    try:
        results = [f.result(timeout=600) for f in
                   [server.submit(im) for im in images[:HTTP_CONCURRENT]]]
    finally:
        server.close()
    direct = art(images[:HTTP_CONCURRENT])
    for i, outs in enumerate(results):
        for got, w in zip(outs, direct):
            np.testing.assert_allclose(got, w[i], atol=1e-6)
    log(f"artifacts: {HTTP_CONCURRENT} concurrent BatchingServer submits to the artifact ok",
        json.dumps(server.stats()))

    return out


def start_server(tmp: Path, seg: Path, cls: Path) -> dict:
    """Start the serve command in a child with all four kinds of model: a
    checkpoint, a classifier with MC dropout, a slide model and the
    float32 artifact.  A thread keeps its output."""
    import queue as queue_mod

    cmd = port_command("ugpg_tpu_torch.cli.serve", "--model", f"seg={seg}", "--cls_model",
                       f"cls={cls}", "--mc_dropout", "8", "--slide_model", f"slide={seg}",
                       "--artifact", f"art={tmp / 'art_float32'}", "--host", "127.0.0.1",
                       "--port", "0", "--max_latency_ms", str(HTTP_DEADLINE_MS))
    server = {"t0": time.perf_counter(), "proc": start_command(cmd), "lines": queue_mod.Queue(),
              "text": []}

    def pump():
        for line in server["proc"].stdout:
            server["text"].append(line)
            server["lines"].put(line)
        server["lines"].put(None)

    threading.Thread(target=pump, daemon=True).start()
    return server


def server_port(server: dict) -> int:
    """The port the serve command prints once it listens; its health
    answer lists the four models."""
    port = None
    while port is None:
        line = server["lines"].get(timeout=300)
        assert line is not None, "".join(server["text"])[-4000:]
        m = re.search(r"^serving .* on http://127\.0\.0\.1:(\d+)", line)
        port = int(m.group(1)) if m else None
    status, body = http_call(port, "GET", "/v1/health")
    server["ready_s"] = time.perf_counter() - server["t0"]
    health = json.loads(body)
    log(f"http: serve command up {server['ready_s']:.1f} s after its start, on port {port}: "
        f"{json.dumps(health)}")
    assert status == 200 and health["models"] == ["art", "cls", "seg", "slide"], health
    return port


def stop_server(server: dict) -> float:
    """SIGINT; the child must exit 0 within 10 s.  -> seconds to its exit."""
    proc = server["proc"]
    t1 = time.perf_counter()
    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("http: the serve command outlived SIGINT by 10 s")
    stop_s = time.perf_counter() - t1
    log(f"http: SIGINT -> exit {rc} after {stop_s:.2f} s")
    log_tail("http: serve command", "".join(server["text"]), 3)
    assert rc == 0, "".join(server["text"])[-4000:]
    return stop_s


def serve_over_http(server: dict, port: int, cls: Path, ref: dict) -> dict:
    """Phase 12, HTTP: concurrent single images, a batch, a JSON
    classification and a slide against the live predictors, and the
    latency of single requests."""
    out = {"ready_s": server["ready_s"]}
    g = np.random.default_rng(14)
    images = g.random((HTTP_CONCURRENT, 256, 256, 3), dtype=np.float32)
    direct = ref["live"](images)
    before = json.loads(http_call(port, "GET", "/v1/stats")[1])["seg"]["predictor"]
    results = [None] * HTTP_CONCURRENT

    def call(i):
        results[i] = http_call(port, "POST", "/v1/models/seg:predict", npy(images[i]),
                               "application/x-npy")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(HTTP_CONCURRENT)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (status, body) in enumerate(results):
        assert status == 200, body[:400]
        got = npz(body)
        for name, w in zip(("preds", "probs", "uncertainty"), direct):
            np.testing.assert_allclose(got[name], w[i], atol=1e-6, err_msg=name)
    stats = json.loads(http_call(port, "GET", "/v1/stats")[1])["seg"]
    calls = stats["predictor"]["device_calls"] - before["device_calls"]
    out["coalescing"] = {"requests": HTTP_CONCURRENT, "device_calls": calls,
                         "device_calls_per_request": calls / HTTP_CONCURRENT,
                         "batcher": stats["batcher"]}
    log(f"http: {HTTP_CONCURRENT} concurrent single-image POSTs to seg equal the direct "
        f"Predictor call; {calls} device calls ({calls / HTTP_CONCURRENT:.4f} per request), "
        f"batcher {json.dumps(stats['batcher'])}")
    assert calls < HTTP_CONCURRENT, stats

    status, body = http_call(port, "POST", "/v1/models/art:predict", npy(images[:8]),
                             "application/x-npy")
    assert status == 200, body[:400]
    got = npz(body)
    for name, w in zip(("preds", "probs", "uncertainty"), ref["live"](images[:8])):
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    px = CLS_STAGE_RESOLUTIONS[4]
    cls_x = g.random((2, px, px, 3), dtype=np.float32)
    status, body = http_call(port, "POST", "/v1/models/cls:predict",
                             json.dumps({"instances": cls_x.tolist()}).encode(),
                             "application/json")
    assert status == 200, body[:400]
    preds = json.loads(body)["predictions"]
    want = Predictor(str(cls), task_type="classification", num_classes=7, buckets=ART_BUCKETS,
                     dtype=None, mc_dropout=8)(cls_x)
    assert sorted(preds) == ["labels", "mc_variance", "probs"], sorted(preds)
    for name, w in zip(("labels", "probs", "mc_variance"), want):
        np.testing.assert_array_equal(np.asarray(preds[name], w.dtype), w, err_msg=name)
    status, body = http_call(port, "POST", "/v1/models/slide:predict", npy(ref["tile"]),
                             "application/x-npy")
    assert status == 200, body[:400]
    got = npz(body)
    for name, w in zip(("preds", "probs", "uncertainty"), ref["slide"]):
        np.testing.assert_array_equal(got[name], w[0], err_msg=name)
    log("http: a batch of 8 to the artifact equals the live Predictor bit for bit; a JSON "
        "classification with mc_variance equals the live mc_dropout=8 Predictor; a "
        f"{SLIDE_PX} px slide equals the live SlidePredictor")

    one_seg = npy(images[:1])
    one_cls = npy(cls_x[:1])
    single = npy(images[0])

    def post(model, body):
        def fn():
            status, data = http_call(port, "POST", f"/v1/models/{model}:predict", body,
                                     "application/x-npy")
            assert status == 200, data[:400]
        return fn

    out["latency"] = {
        "seg_bucket1": latency_ms(post("seg", one_seg)),
        "art_bucket1": latency_ms(post("art", one_seg)),
        "cls_mc8_bucket1": latency_ms(post("cls", one_cls)),
        "seg_single_image_micro_batched": latency_ms(post("seg", single)),
    }
    log("http: latency over localhost, 50 sequential requests each (a (1, H, W, 3) batch: "
        "bucket 1; a (H, W, 3) image: through the micro-batcher, deadline "
        f"{HTTP_DEADLINE_MS} ms):", json.dumps(out["latency"]))
    return out


def augment_tool(tmp: Path, mon_root: Path, aug_proc: subprocess.Popen,
                 aug_root: Path) -> dict:
    """Phase 12, tools: the augment command's patches (its child started
    earlier) against extract_patches' grid, every file read back, and one
    stage-1 AugMoNuSegTrainer epoch on them."""
    text = finish_command(aug_proc, "augment_monuseg")
    m = re.search(r"Wrote (\d+) patches to .* in ([0-9.]+) s", text)
    written, seconds = int(m.group(1)), float(m.group(2))
    grid = 0
    for path in sorted((aug_root / "train" / "images").glob("*.tif")):
        polys = parse_polygons(aug_root / "train" / "annots" / f"{path.stem}.xml")
        grid += sum(1 for _ in augment_monuseg.extract_patches(load_rgb(str(path)), polys))
    pngs = sorted((aug_root / "train" / "aug" / "images").glob("*.png"))
    xmls = sorted((aug_root / "train" / "aug" / "annots").glob("*.xml"))
    shapes = {native.decode_png(p).shape for p in pngs}
    nuclei = sum(len(parse_polygons(x)) for x in xmls)
    log(f"tools: augment_monuseg --variants 1 wrote {written} patches in {seconds:.3f} s "
        f"({written / seconds:.2f} patches/s on the host), the grid holds {grid} patches; "
        f"{len(pngs)} PNGs decode to {shapes}, {len(xmls)} XMLs parse ({nuclei} polygons)")
    assert written == len(pngs) == len(xmls) == 2 * grid and shapes == {(256, 256, 3)}

    cfgs = {1: {**DEFAULT_STAGE_CONFIGS[1], "epochs_per_stage": 1}}
    trainer = AugMoNuSegTrainer(fused_loss=True, width=1.0, stage_configs=cfgs, verbose=False)
    trainer.setup_datasets(str(aug_root), stages=(1,))
    assert len(trainer.train_datasets[1]) == written
    tl, vl = trainer.make_loaders(batch_size=TRAIN_BATCH, num_workers=4)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    history = trainer.train_progressive(tl, vl, save_dir=str(tmp / "aug_ckpt"), stages=[1])
    counts = _lib.launch_counts()
    log(f"tools: one stage-1 AugMoNuSegTrainer epoch on the written patches: {len(tl[1])} steps "
        f"in {time.perf_counter() - t0:.2f} s, train loss {history['train_loss']}, launches "
        f"{json.dumps(counts)}")
    assert counts == {k: len(tl[1]) for k in LOSS_KERNELS}, counts
    assert np.isfinite(history["train_loss"]).all() and np.isfinite(history["val_loss"]).all()
    return {"patches": written, "seconds": seconds, "patches_per_s": written / seconds}


def serving_stack(tmp: Path, mon_root: Path) -> tuple[dict, dict]:
    """Phase 12: artifacts, HTTP and the MoNuSeg tools.  Returns the three
    serving kernels' launches in the phase and its numbers."""
    seg, cls = tmp / "seeded_stage4.pth", tmp / "herlev_stage4_seeded.pth"
    random_checkpoint(seg)
    random_classifier_checkpoint(cls)
    aug_root = tmp / "aug_tree"
    for split in ("train", "val"):
        for sub in ("images", "annots"):
            shutil.copytree(mon_root / split / sub, aug_root / split / sub)
    buckets = [str(b) for b in ART_BUCKETS]
    export = "ugpg_tpu_torch.cli.export_model"
    t0 = time.perf_counter()
    children = {
        "export float32": start_command(port_command(
            export, "--model", str(seg), "--out", str(tmp / "art_float32"), "--buckets",
            *buckets)),
        "export uint8 compact": start_command(port_command(
            export, "--model", str(seg), "--out", str(tmp / "art_uint8_compact"), "--buckets",
            *buckets, "--uint8", "--compact")),
        "demo": start_command(port_command(
            "ugpg_tpu_torch.cli.demo", "--demo", "all", "--stages", "2", "--epochs", "1",
            "--save_dir", str(tmp / "demo"))),
        "augment": start_command(port_command(
            "ugpg_tpu_torch.cli.augment_monuseg", "--data_dir", str(aug_root), "--variants",
            "1")),
    }
    for label in ("export float32", "export uint8 compact", "demo"):
        finish_command(children.pop(label), label)
    log(f"serving stack: both exports and the demo (--demo all --stages 2 --epochs 1) exited 0 "
        f"after {time.perf_counter() - t0:.1f} s; artifacts "
        + json.dumps({p.name: sum(f.stat().st_size for f in p.iterdir()) // 2**20
                      for p in sorted(tmp.glob("art_*"))}) + " MiB")
    server = start_server(tmp, seg, cls)  # it loads while the artifacts are checked here
    try:
        tile = load_rgb(str(mon_root / "val" / "images" / "val_tile_0.tif"))
        _lib.reset_launch_counts()
        total = dict.fromkeys(SERVING_KERNELS, 0)
        numbers, ref = artifacts(tmp, seg, cls, tile, total)
        drain_launches(total)
        port = server_port(server)  # up and idle before anything is timed
        numbers.update(artifact_times(ref))
        drain_launches(total)
        numbers["http"] = serve_over_http(server, port, cls, ref)
        drain_launches(total)
    finally:
        stop_s = stop_server(server)
    numbers["http"]["sigint_exit_s"] = stop_s
    numbers["tools"] = augment_tool(tmp, mon_root, children.pop("augment"), aug_root)
    return {k: total[k] for k in SERVING_KERNELS}, numbers


# ---------------------------------------------------------------- int8 serving (phase 13)
QUANT_BUCKETS = (1, 8, 64, 128)
QUANT_CALIBRATION = 8  # seeded calibration images
QUANT_TIMED = 5  # calls per predictor and bucket, in turns
# a bucket-64 call's device time by part: the first part whose marks name the kernel or
# an op on the stack of the op that launched it
QUANT_SPLIT = (("host copies", ("Memcpy",)), ("int8 GEMM", ("aten::_int_mm",)),
               ("patch gather and concats", ("aten::cat", "aten::constant_pad_nd")),
               ("upsample", ("upsample2x",)), ("uncertainty map", ("uncertainty",)),
               ("epilogue and requantize", ("aten::addcmul", "aten::relu", "aten::round",
                                            "aten::clamp", "aten::_to_copy", "aten::mul")))


def check_conv_i8() -> None:
    """``_conv_i8`` on the card against int64 sums on the CPU: 1024 input
    channels of +-127 (an output at 127^2 * 9 * 1024, past 2^24) and 3
    input channels (K = 27, padded to 72)."""
    rng = np.random.default_rng(13)
    for n, h, cin, cout in ((2, 16, 1024, 64), (2, 64, 3, 64)):
        x = rng.choice([-127, 127], (n, h, h, cin)).astype(np.int8)
        k = rng.choice([-127, 127], (3, 3, cin, cout)).astype(np.int8)
        x[0], k[..., 0] = 127, 127
        xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
        want = sum(xp[:, ky:ky + h, kx:kx + h] @ k[ky, kx].astype(np.int64)
                   for ky in range(3) for kx in range(3))
        got = quant._conv_i8(torch.from_numpy(x).to(DEV),
                             quant.weight_matrix(torch.from_numpy(k)).to(DEV)).cpu().numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want), (cin, np.abs(got - want).max())
        log(f"int8: _conv_i8 on the card equals int64 sums at {n}x{h}x{h}x{cin} -> {cout} "
            f"(K = {9 * cin}; max |sum| {int(np.abs(want).max())})")


def turns_ips(label: str, predictors: dict, images: np.ndarray) -> dict:
    """Images/s of each predictor on ``images`` (one bucket), one call of each
    in turn, ``QUANT_TIMED`` rounds after a warm call: median and spread."""
    for p in predictors.values():
        p(images)
    runs = {name: [] for name in predictors}
    for _ in range(QUANT_TIMED):
        for name, p in predictors.items():
            t0 = time.perf_counter()
            p(images)
            runs[name].append(len(images) / (time.perf_counter() - t0))
    out = {name: {"median": statistics.median(v), "min": min(v), "max": max(v), "runs": v}
           for name, v in runs.items()}
    log(f"int8: {label}, images/s in turns (median [min, max] of {QUANT_TIMED}): "
        + ", ".join(f"{name} {v['median']:.2f} [{v['min']:.2f}, {v['max']:.2f}]"
                    for name, v in out.items()))
    return out


def int8_split(fn) -> tuple[dict, dict]:
    """Device ms of one call by ``QUANT_SPLIT`` part (the rest "other"), from
    the kernels each op of a profile launched; and ms by kernel name with
    its part."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = dict.fromkeys([name for name, _ in QUANT_SPLIT] + ["other"], 0.0)
    by_kernel = {}
    for e in prof.events():
        if not e.kernels:
            continue
        chain, p = [e.name], e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        for k in e.kernels:
            part = next((name for name, marks in QUANT_SPLIT
                         if any(m in link for link in [k.name, *chain] for m in marks)), "other")
            split[part] += k.duration / 1e3
            key = (k.name[:70], part)
            by_kernel[key] = by_kernel.get(key, 0.0) + k.duration / 1e3
    return split, by_kernel


def int8_serving(tmp: Path) -> tuple[dict, dict]:
    """Phase 13: the W8A8 int8 Predictor (``quantize=True``) on phase 5's
    seeded stage-4 checkpoint and phase 11's seeded classifier.  Returns the
    serving kernels' launches on its main path (the int8 requests and the
    int8 artifact) and its numbers."""
    seg, cls = tmp / "seeded_stage4.pth", tmp / "herlev_stage4_seeded.pth"
    random_checkpoint(seg)
    random_classifier_checkpoint(cls)
    rng = np.random.default_rng(13)
    res, cls_res = 256, CLS_STAGE_RESOLUTIONS[4]
    calibration = rng.random((QUANT_CALIBRATION, res, res, 3), dtype=np.float32)
    np.save(tmp / "calibration.npy", calibration)
    export = start_command(port_command(
        "ugpg_tpu_torch.cli.export_model", "--model", str(seg), "--out", str(tmp / "art_int8"),
        "--buckets", *map(str, QUANT_BUCKETS), "--quantize", "--calibration",
        str(tmp / "calibration.npy")))
    check_conv_i8()

    t0 = time.perf_counter()
    pq = Predictor(str(seg), buckets=QUANT_BUCKETS, quantize=True,
                   calibration_batches=[calibration])
    log(f"int8: Predictor(quantize=True) built and calibrated on {QUANT_CALIBRATION} images in "
        f"{time.perf_counter() - t0:.2f} s; scales {json.dumps(pq.model.scales)}")
    images = rng.random((128, res, res, 3), dtype=np.float32)
    total = dict.fromkeys(SERVING_KERNELS, 0)
    _lib.reset_launch_counts()
    replies = {n: pq(images[:n]) for n in (1, 5, 8, 11)}
    counts, calls = _lib.launch_counts(), pq.stats()["device_calls"]
    log(f"int8: requests of 1, 5, 8, 11 images in {calls} device calls, launches "
        f"{json.dumps(counts)}")
    assert counts == {"upsample2x_bf16_taps": 4 * calls, "uncertainty_from_logits": calls}, counts
    for n, outs in replies.items():
        check_response(outs, n)
    drain_launches(total)

    # the maps against the float32 Predictor on the card (tests/test_quant.py:56-61), beside
    # the same int8 model with JAX's bf16 two-pass resize in place of the upsample operator:
    # the JAX package's jitted int8 program (tests/test_torch_quant.py holds them equal), which
    # the bf16-taps kernel now computes
    p32 = Predictor(str(seg), buckets=(8,), dtype=torch.float32)
    x = torch.from_numpy(images[:8]).to(DEV).permute(0, 3, 1, 2)
    with torch.inference_mode():
        lq, lf = pq.model(x).cpu().numpy(), p32.model(x).cpu().numpy()
        operator = library_ops.upsample2x_bf16_taps
        library_ops.upsample2x_bf16_taps = upsample2x_bilinear_align_corners
        try:
            lj = pq.model(x).cpu().numpy()
        finally:
            library_ops.upsample2x_bf16_taps = operator
    log(f"int8 on the card: the bf16-taps kernel against JAX's bf16 resize in plain torch, "
        f"logits max|d| {np.abs(lq - lj).max():.3e}")
    assert np.abs(lq - lj).max() <= 1e-5
    rms, std = float(np.sqrt(np.mean((lq - lf) ** 2))), float(lf.std())
    pf_, pq_ = p32(images[:8])[1], replies[8][1]
    away = np.abs(pf_ - 0.5) > 1e-3

    def agreement(logits):  # decisions equal away from 1e-3 of the threshold
        return float(np.mean(((pf_ > 0.5) == (logits.transpose(0, 2, 3, 1) > 0)) | ~away))

    agree, agree_jax = agreement(lq), agreement(lj)
    log(f"int8 vs float32 on the card, 8 images: logits RMS {rms:.4e} (std {std:.4e}, bound "
        f"{0.2 * std + 1e-4:.4e}), max|d| {np.abs(lq - lf).max():.4e}, max|dprob| "
        f"{np.abs(pq_ - pf_).max():.4e}; decisions equal away from 1e-3 of the threshold in "
        f"{agree:.6%} of pixels, JAX's program {agree_jax:.6%} (RMS "
        f"{float(np.sqrt(np.mean((lj - lf) ** 2))):.4e}); 99.9% "
        + ("met" if agree >= 0.999 else "missed"))
    # tests/test_quant.py's 99.9% holds for its checkpoint; held here to JAX's own program
    # on this one where that falls short (the seeded logits sit near 0: std 0.35)
    assert rms < 0.2 * std + 1e-4 and agree >= min(0.999, agree_jax - 5e-4), (rms, agree)

    # the card against the CPU: the same qparams and scales, 2 images
    cpu_model = quant.QuantizedModel(quant.quantize_weights(
        fold_batchnorm(read_checkpoint(seg)["model_state_dict"]), 4, pq.model.scales),
        pq.model.scales, 4)
    card_points, cpu_points = {}, {}
    with torch.inference_mode():
        gl = pq.model.forward_nhwc(torch.from_numpy(images[:2]).to(DEV), card_points).cpu()
        cl = cpu_model.forward_nhwc(torch.from_numpy(images[:2]), cpu_points)
    shares = {k: float((card_points[k].cpu() != v).float().mean()) for k, v in cpu_points.items()}
    steps = max(int((card_points[k].cpu().int() - v.int()).abs().max())
                for k, v in cpu_points.items())
    log(f"int8 card vs CPU, 2 images, same qparams and scales: logits max|d| "
        f"{(gl - cl).abs().max().item():.4e} (std {cl.std().item():.4e}); int8 values that "
        f"differ, by point: {json.dumps({k: round(v, 6) for k, v in shares.items() if v})} "
        f"(all other points equal; largest step {steps})")
    assert steps == 0 and (gl - cl).abs().max().item() <= 1e-5  # every point equal
    del p32, cpu_model

    # the export command's int8 artifact, bit for bit
    finish_command(export, "export --quantize")
    art = ExportedPredictor(tmp / "art_int8")
    _lib.reset_launch_counts()
    for n in (1, 5, 8, 11, 100):
        assert_same(art(images[:n]), pq(images[:n]), f"int8 artifact, {n} images")
    counts = _lib.launch_counts()
    calls = art.stats()["device_calls"] + pq.stats()["device_calls"] - calls
    assert counts == {"upsample2x_bf16_taps": 4 * calls, "uncertainty_from_logits": calls}, counts
    log(f"int8: the export command's artifact (buckets {list(QUANT_BUCKETS)}) answers bit for "
        f"bit as the live int8 Predictor on requests of 1, 5, 8, 11, 100 images; launches "
        f"{json.dumps(counts)}")
    drain_launches(total)
    del art

    # images/s, int8 against bf16, in turns; Herlev at bucket 64
    numbers = {"rms": rms, "logit_std": std, "agree": agree, "card_vs_cpu": shares}
    pb = Predictor(str(seg), buckets=(64, 128))
    numbers["images_per_s"] = {b: turns_ips(f"segmentation, bucket {b}",
                                            {"int8": pq, "bf16": pb}, images[:b])
                               for b in (64, 128)}
    del pb
    torch.cuda.empty_cache()
    _lib.reset_launch_counts()  # the bf16 yardsticks' launches are not the int8 path's
    cls_images = rng.random((64, cls_res, cls_res, 3), dtype=np.float32)
    common = dict(task_type="classification", num_classes=7, buckets=(64,))
    cq = Predictor(str(cls), quantize=True, calibration_batches=[cls_images[:QUANT_CALIBRATION]],
                   **common)
    cb = Predictor(str(cls), **common)
    lab_q, prob_q = cq(cls_images)
    lab_b, prob_b = cb(cls_images)
    log(f"int8: Herlev classifier, 64 images: labels equal to bf16's for "
        f"{int((lab_q == lab_b).sum())}, max|dprob| {np.abs(prob_q - prob_b).max():.4e}")
    numbers["herlev_images_per_s"] = turns_ips("Herlev, bucket 64", {"int8": cq, "bf16": cb},
                                               cls_images)
    assert _lib.launch_counts().get("fused_double_conv", 0) == 4 * cb.stats()["device_calls"]
    del cq, cb
    _lib.reset_launch_counts()

    # one bucket-64 call profiled, split by part; peak memory at bucket 128
    device, wall_ms, _ = profile_call("int8: bucket 64, 64 images", lambda: pq(images[:64]))
    busy = sum(device.values())
    split, by_kernel = int8_split(lambda: pq(images[:64]))
    numbers["split"] = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
                        "ms": split}
    log(f"int8: bucket-64 call {wall_ms:.2f} ms wall, device busy {busy:.2f} ms, idle "
        f"{1 - busy / wall_ms:.1%}; device ms by part (a second profile): "
        + ", ".join(f"{k} {v:.3f} ({v / (sum(split.values()) or 1):.1%})"
                    for k, v in split.items()))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    log("int8: the kernels of that call by device ms: "
        + "; ".join(f"{name} [{part}] {ms:.3f}" for (name, part), ms in top))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pq(images)
    peak = torch.cuda.max_memory_allocated()
    numbers["peak_gib_128"] = {"peak": peak / 2**30, "above_resident": (peak - before) / 2**30}
    log(f"int8: bucket 128 call: torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB "
        f"({(peak - before) / 2**30:.3f} GiB above the {before / 2**30:.3f} GiB resident)")
    drain_launches(total)  # the timed and profiled int8 calls
    return {k: total.get(k, 0) for k in (*SERVING_KERNELS, "upsample2x_bf16_taps")}, numbers


# ---------------------------------------------------------------- phase 14: remat, the pipeline
PIPE_BATCHES = 6  # batches of the pipelined epoch
PIPE_TURNS = 5  # pipelined epochs and fused-step epochs, in turns
REMAT_TIMED = 5  # timed steps with and without remat
HERLEV_REMAT_BATCH = 16
PIPE_REGIONS = ("uncertainty_pipeline.produce", "uncertainty_pipeline.train_step")


def check_bf16_taps() -> dict:
    """The bf16-taps upsample (the int8 path's) against its plain version,
    bit for bit, at the four stage-4 Up shapes at buckets 8 and 64; then the
    four timed at bucket 64 (per stage-4 forward) beside the float32-tap
    instance of the same kernel, F.interpolate and the byte bound."""
    g = torch.Generator(device=DEV).manual_seed(14)
    t = dict.fromkeys(("ms", "float32_taps_ms", "plain_ms", "library_ms", "bytes_ms",
                       "ops_ms"), 0.0)
    for n in (CHECK_BATCH, TIME_BATCH):
        for name, (c, h) in UPSAMPLES.items():
            args = up_inputs(n, c, h, torch.bfloat16, g)
            got, want = upsample2x_bf16_taps(*args), upsample2x_bf16_taps_reference(*args)
            torch.cuda.synchronize()
            assert got.is_contiguous(memory_format=CL) and torch.equal(got, want), (name, n)
            if n != TIME_BATCH:
                continue
            t["ms"] += time_ms(upsample2x_bf16_taps, args)
            t["float32_taps_ms"] += time_ms(upsample2x, args)
            t["plain_ms"] += time_ms(upsample2x_bf16_taps_reference, args, reps=1, repeats=3)
            t["library_ms"] += time_ms(library_upsample, args)
            t["bytes_ms"] += 5 * n * c * h * h * 2 / HBM_BYTES_PER_S * 1e3
            t["ops_ms"] += 2 * 3 * 4 * n * c * h * h / PEAK_OPS_PER_S[torch.float32] * 1e3
            del args, got, want
    torch.cuda.empty_cache()
    log(f"bf16-taps upsample: bit for bit its plain version at {list(UPSAMPLES)} x buckets "
        f"{CHECK_BATCH} and {TIME_BATCH}; per stage-4 forward at bucket {TIME_BATCH}: "
        + json.dumps({k: round(v, 5) for k, v in t.items()})
        + f", {max(t['bytes_ms'], t['ops_ms']) / t['ms']:.1%} of the bound")
    return t


def _seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``model`` with seeded weights and non-trivial BN stats, on the card."""
    init_parameters(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.8, 1.2, generator=g)
    return model.to(DEV)


def _remat_pair(label: str, build, make_step, batch, extra) -> dict:
    """One step with and without remat from the same weights (``extra(remat)``:
    the step's other arguments): gradients, BN state and metrics bit for
    bit; then the peak memory of that step and the median of
    ``REMAT_TIMED`` more."""
    ref = build(False).state_dict()
    runs = {}
    for remat in (False, True):
        model = build(remat)
        model.load_state_dict(ref)
        step = make_step(model)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        metrics = step(batch, *extra(remat))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        grads = [p.grad.detach().clone() for p in model.parameters()]
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        times = []
        for _ in range(REMAT_TIMED):
            t0 = time.perf_counter()
            step(batch, *extra(remat))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        runs[remat] = {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": grads,
                       "state": state, "peak_gib": peak / 2**30,
                       "above_resident_gib": (peak - before) / 2**30,
                       "step_ms": statistics.median(times), "step_ms_runs": times}
        del model, step
    a, b = runs[False], runs[True]
    worst = max((x.float() - y.float()).abs().max().item() for x, y in zip(a["grads"], b["grads"]))
    worst_state = max((a["state"][k].float() - b["state"][k].float()).abs().max().item()
                      for k in a["state"])
    out = {k: {"peak_gib": r["peak_gib"], "above_resident_gib": r["above_resident_gib"],
               "step_ms": r["step_ms"], "step_ms_runs": r["step_ms_runs"]}
           for k, r in (("plain", a), ("remat", b))}
    log(f"remat, {label}: gradients max|d| {worst:.3e}, BN state max|d| {worst_state:.3e}; "
        + json.dumps(out))
    assert a["metrics"] == b["metrics"], (a["metrics"], b["metrics"])
    assert all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])), worst
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"]), worst_state
    return out


def remat_full_width() -> dict:
    """remat at full width, float32, cuDNN deterministic: a stage-4
    segmentation step at batch 8 (fused loss, the frozen stage 3 at 128 px)
    and a Herlev stage-4 step at batch 16 (the frozen stage 3)."""
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        prev = _seeded(PGUNet3(use_bn=True), 30)
        images, masks = disk_dataset(TRAIN_BATCH, 256, seed=14)
        batch = (torch.from_numpy(images).to(DEV), torch.from_numpy(masks).to(DEV))
        seg = _remat_pair(
            f"segmentation stage 4, batch {TRAIN_BATCH}",
            lambda r: _seeded(PGUNet4(use_bn=True, remat=r), 40),
            lambda m: make_seg_train_step(m, torch_rmsprop(m.parameters(), 1e-4,
                                                           weight_decay=1e-4),
                                          4, 256, prev_model=prev, prev_resolution=128,
                                          fused_loss=True),
            batch, lambda r: (PW,))
        del prev, batch
        res, k = CLS_STAGE_RESOLUTIONS[4], 7
        cprev = _seeded(HerlevClassificationModel(3, k), 50)
        rng = np.random.default_rng(14)
        cbatch = (torch.from_numpy(rng.random((HERLEV_REMAT_BATCH, res, res, 3),
                                              dtype=np.float32)).to(DEV),
                  torch.from_numpy(rng.integers(0, k, HERLEV_REMAT_BATCH)).to(DEV))
        cw = torch.ones(k, device=DEV)
        herlev = _remat_pair(
            f"Herlev stage 4, batch {HERLEV_REMAT_BATCH}",
            lambda r: _seeded(HerlevClassificationModel(4, k, remat=r), 60),
            lambda m: make_cls_train_step(m, torch_rmsprop(m.parameters(), 1e-4), 4, res, k,
                                          prev_model=cprev,
                                          prev_resolution=CLS_STAGE_RESOLUTIONS[3],
                                          normalize=True),
            cbatch, lambda r: (cw, torch.Generator(device=DEV).manual_seed(7)))
    finally:
        torch.backends.cudnn.deterministic = prev_det
    torch.cuda.empty_cache()
    return {"segmentation": seg, "herlev": herlev}


def _busy_ms(prof) -> tuple[float, float]:
    """(the union of the device intervals, their sum) in ms, from a profile."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name != "Activity Buffer Request")
    union, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    return union / 1e3, sum(b - a for a, b in spans) / 1e3


def _assert_step0(got: dict, want: dict, keys, label: str) -> None:
    for key in keys:
        g, w = float(got[key]), float(want[key])
        assert abs(g - w) <= 2e-5 * abs(w) + 1e-6, (label, key, g, w)
    log(f"pipeline, {label}: step 0 equals the fused step to rtol 2e-5: "
        + json.dumps({key: [float(got[key]), float(want[key])] for key in keys}))


def pipeline_full_width(tmp: Path) -> tuple[dict, dict]:
    """The uncertainty pipeline at full width on one card (the CPU's
    counterpart of two devices: [cuda:0, cuda:0], n_unc=1).  Returns the
    loss kernels' launches of its epochs and its numbers."""
    prev = _seeded(PGUNet3(use_bn=True), 30)
    ref = _seeded(PGUNet4(use_bn=True), 40).state_dict()
    images, masks = disk_dataset(TRAIN_BATCH * PIPE_BATCHES, 256, seed=15)
    batches = [(images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                masks[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]) for i in range(PIPE_BATCHES)]
    g = torch.Generator(device=DEV).manual_seed(15)
    draws = [sample_monuseg_params(g, TRAIN_BATCH) for _ in batches]

    def fresh():
        model = PGUNet4(use_bn=True).to(DEV)
        model.load_state_dict(ref)
        return model, torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4)

    model, opt = fresh()
    pipe = UncertaintyPipeline(model, prev, opt, 4, 256, 128, devices=[DEV, DEV], n_unc=1,
                               fused_loss=True, augment=True, depth=2)
    pipe.create_state()
    pipe.place_prev()
    fmodel, fopt = fresh()
    fused = make_seg_train_step(fmodel, fopt, 4, 256, prev_model=prev, prev_resolution=128,
                                augment=True, fused_loss=True)
    _lib.reset_launch_counts()
    piped = pipe.run_epoch(batches, PW, aug=draws)
    torch.cuda.synchronize()
    launches = _lib.launch_counts()
    log(f"pipeline: segmentation stage 4, {PIPE_BATCHES} batches of {TRAIN_BATCH}, launches "
        f"{json.dumps(launches)}")
    assert launches == {k: PIPE_BATCHES for k in LOSS_KERNELS}, launches
    want = [fused(b, PW, d) for b, d in zip(batches, draws)]
    _assert_step0(piped[0], want[0], ("final_loss", "base_loss", "dice", "accuracy",
                                      "uncertainty_weight_mean", "uncertainty_weight_std"),
                  "segmentation stage 4")
    drift = max(abs(float(p["final_loss"]) / float(w["final_loss"]) - 1)
                for p, w in zip(piped, want))
    log(f"pipeline: largest relative gap of the {PIPE_BATCHES} steps' losses {drift:.3e}")
    _lib.reset_launch_counts()

    # the pipelined epoch against the fused steps, in turns
    runs = {"pipelined": [], "fused": []}
    for _ in range(PIPE_TURNS):
        for name in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "pipelined":
                pipe.run_epoch(batches, PW, aug=draws)
            else:
                for b, d in zip(batches, draws):
                    fused(b, PW, d)
            torch.cuda.synchronize()
            runs[name].append(len(images) / (time.perf_counter() - t0))
    ips = {k: {"median": statistics.median(v), "min": min(v), "max": max(v), "runs": v}
           for k, v in runs.items()}
    log(f"pipeline: images/s over {PIPE_BATCHES} steps, in turns (median [min, max] of "
        f"{PIPE_TURNS}): " + ", ".join(f"{k} {v['median']:.2f} [{v['min']:.2f}, {v['max']:.2f}]"
                                       for k, v in ips.items()))

    # one pipelined step, traced (utils.profiling.trace), and one fused step
    idle = {}
    for name in ("pipelined", "fused"):
        torch.cuda.synchronize()
        with profiling.trace(tmp / f"trace_{name}") as prof:
            t0 = time.perf_counter()
            if name == "pipelined":
                pipe.run_epoch(batches[:1], PW, aug=draws[:1])
            else:
                fused(batches[0], PW, draws[0])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        union, total = _busy_ms(prof)
        idle[name] = {"wall_ms": wall, "busy_ms": union, "kernel_ms_sum": total,
                      "idle_share": 1 - union / wall}
    files = list((tmp / "trace_pipelined").glob("*.pt.trace.json"))
    assert len(files) == 1, files
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert set(PIPE_REGIONS) <= names, sorted(n for n in names if n and "pipeline" in n)
    log(f"pipeline: one step traced to {files[0].name} ({files[0].stat().st_size} bytes, "
        f"regions {list(PIPE_REGIONS)}); device busy and idle: {json.dumps(idle)}")
    drain = _lib.launch_counts()  # the timed and traced epochs: 1 + 1 per step
    steps = PIPE_TURNS * PIPE_BATCHES * 2 + 2
    assert drain == {k: steps for k in LOSS_KERNELS}, drain
    _lib.reset_launch_counts()
    del pipe, fused, model, fmodel
    torch.cuda.empty_cache()

    # Herlev stage 2 through the classification pipeline
    k, res, prev_res = 7, CLS_STAGE_RESOLUTIONS[2], CLS_STAGE_RESOLUTIONS[1]
    cprev = _seeded(HerlevClassificationModel(1, k), 70)
    cref = _seeded(HerlevClassificationModel(2, k), 80).state_dict()
    rng = np.random.default_rng(16)
    cbatch = (rng.random((HERLEV_BATCH, res, res, 3), dtype=np.float32),
              rng.integers(0, k, HERLEV_BATCH))
    cw = torch.linspace(0.5, 2.0, k, device=DEV)
    params = sample_herlev_params(torch.Generator(device=DEV).manual_seed(17), HERLEV_BATCH,
                                  res, res)
    out = []
    for piped_run in (True, False):
        cmodel = HerlevClassificationModel(2, k).to(DEV)
        cmodel.load_state_dict(cref)
        copt = torch_rmsprop(cmodel.parameters(), 1e-4)
        dropout = torch.Generator(device=DEV).manual_seed(18)
        if piped_run:
            cpipe = UncertaintyPipeline(cmodel, cprev, copt, 2, res, prev_res,
                                        devices=[DEV, DEV], task_type="classification",
                                        num_classes=k, augment=True, normalize=True)
            out.append(cpipe.run_epoch([cbatch], cw, aug=[params], generator=dropout)[0])
        else:
            step = make_cls_train_step(cmodel, copt, 2, res, k, prev_model=cprev,
                                       prev_resolution=prev_res, augment=True, normalize=True)
            out.append(step(cbatch, cw, dropout, aug=params))
    _assert_step0(out[0], out[1], ("final_loss", "base_loss", "uncertainty_weight_mean",
                                   "uncertainty_weight_std"),
                  f"Herlev stage 2, batch {HERLEV_BATCH}")
    assert int(out[0]["correct"]) == int(out[1]["correct"])
    _lib.reset_launch_counts()
    return {kernel: PIPE_BATCHES for kernel in LOSS_KERNELS}, {
        "images_per_s": ips, "idle": idle, "loss_drift": drift}


def options_command_lines(tmp: Path, root: Path) -> dict:
    """``train_monuseg --remat --tb_logdir`` for one stage-1 epoch on phase 9's
    tree, and ``--pipeline_unc 1``, which on one card exits 2 with the JAX
    package's message."""
    tb = tmp / "tb"
    remat = start_command(port_command(
        "ugpg_tpu_torch.cli.train_monuseg", "--data_dir", str(root), "--output_dir",
        str(tmp / "remat_out"), "--stages", "1", "--epochs", "1", "--batch_size",
        str(TRAIN_BATCH), "--remat", "--tb_logdir", str(tb)))
    piped = start_command(port_command(
        "ugpg_tpu_torch.cli.train_monuseg", "--data_dir", str(root), "--output_dir",
        str(tmp / "piped_out"), "--stages", "1", "2", "--epochs", "1", "--pipeline_unc", "1"))
    out = finish_command(remat, "train_monuseg --remat --tb_logdir")
    events = list(tb.glob("events.out.tfevents.*"))
    warned = "event logging disabled" in out
    assert events or warned, out[-2000:]
    assert (tmp / "remat_out" / "ug_pgunet_stage1_best.pth").exists()
    log("command line: train_monuseg --remat --tb_logdir: "
        + (f"{len(events)} events file(s) written" if events else
           "the tensorboard package is missing: the one warning printed, no events"))
    text, _ = piped.communicate(timeout=600)
    message = "n_unc=1 must leave at least one train device out of 1 visible"
    log(f"command line: train_monuseg --pipeline_unc 1 on {torch.cuda.device_count()} card(s): "
        f"exit {piped.returncode}")
    if torch.cuda.device_count() == 1:
        assert piped.returncode == 2 and message in text, text[-2000:]
    return {"tb_events": len(events), "tb_warning": warned, "pipeline_unc_exit": piped.returncode}


def options_and_pipeline(tmp: Path, root: Path) -> tuple[dict, dict]:
    """Phase 14."""
    taps = check_bf16_taps()
    remat = remat_full_width()
    with tf32(False):
        launches, pipe = pipeline_full_width(tmp)
    commands = options_command_lines(tmp, root)
    return launches, {"bf16_taps": taps, "remat": remat, "pipeline": pipe, "commands": commands}


# ------------------------------------------------------------ phase 15: serving on a device mesh
MESH_PX = TILE_PX  # a MoNuSeg tile, padded to each grid's divisor
MESH_GRIDS = (((2, 1), None), ((2, 2), "model"))  # (data, model), the W axis
MESH_BUCKET, TP_BUCKET = 64, 8


def conv3x3_shapes(convs: dict, px: int, n: int, parts: int = 1) -> list:
    """(n, h, w, cin, cout) of every conv of a stage-4 forward's DoubleConvs
    at ``px`` (``convs``: DOUBLE_CONVS-like at 256 px), each conv's output
    channels cut into ``parts`` (the column-parallel slices)."""
    out = []
    for h, cin, cm, cout in convs.values():
        side = h * px // 256
        for ci, co in ((cin, cm), (cm, cout)):
            out.append((n, side, side, ci, co // parts))
    return out


def conv3x3_inputs(n, h, w, cin, cout, dtype, g):
    x = torch.randn(n, cin, h, w, device=DEV, generator=g).to(dtype).contiguous(memory_format=CL)
    wt = (torch.randn(cout, cin, 3, 3, device=DEV, generator=g) * (2 / (9 * cin)) ** 0.5).to(dtype)
    b = torch.randn(cout, device=DEV, generator=g) * 0.1
    return x, wt, b


def conv3x3_plain(x, wt, b):
    """The kernel's plain version: in bf16 its own order of sums."""
    if x.dtype == torch.bfloat16:
        return double_conv_mod.conv3x3_packed_reference(
            x, double_conv_mod.pack_conv3x3(wt), b).to(x.dtype)
    return double_conv_mod.conv3x3_reference(x, wt, b)


@tf32(False)
def check_conv3x3(card: str) -> float:
    """conv3x3 against its plain version at the stage-4 convs (256 px,
    batch 2) and at the half-channel slices of the column-parallel ones
    (batch 8), bfloat16 and float32, phase 3's tolerance."""
    g = torch.Generator(device=DEV).manual_seed(15)
    tp = [s for s in conv3x3_shapes(DOUBLE_CONVS, 256, TP_BUCKET, 2) if tp_sharded(2 * s[4], 2)]
    worst = 0.0
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for label, shapes in (("conv", conv3x3_shapes(DOUBLE_CONVS, 256, 2)), ("half", tp)):
            err_max = 0.0
            for n, h, w, cin, cout in shapes:
                x, wt, b = conv3x3_inputs(n, h, w, cin, cout, dtype, g)
                got = double_conv_mod.conv3x3(x, wt, b)
                want = conv3x3_plain(x, wt, b)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                assert err <= rel * max(1.0, scale), (label, n, h, cin, cout, dtype, err, scale)
                err_max = max(err_max, err)
            log(f"check conv3x3 {label} {str(dtype)[6:]}: {len(shapes)} shapes, max_abs_err="
                f"{err_max:.3e} tol={rel:g}x -> ok on {card}")
            worst = max(worst, err_max)
    return worst


@contextlib.contextmanager
def captured_conv3x3():
    """The arguments of every ``conv3x3`` operator call made inside (the
    spatial forward's and the column-parallel convs' own tensors), held to
    check the kernel on after the counted run."""
    calls, op = [], library_ops.conv3x3

    def record(*args):
        calls.append(args)
        return op(*args)

    library_ops.conv3x3 = record
    try:
        yield calls
    finally:
        library_ops.conv3x3 = op


@torch.inference_mode()
def hold_conv3x3(calls: list, label: str, card: str) -> float:
    """conv3x3 against its plain version on the main path's own inputs
    (``captured_conv3x3``), once per distinct shape, at check_conv3x3's
    tolerances; returns the max |d|."""
    rel = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    seen, worst = set(), 0.0
    for x, wt, b, pw, pb in calls:
        key = (tuple(x.shape), tuple(wt.shape), x.dtype)
        if key in seen:
            continue
        seen.add(key)
        got = double_conv_mod.conv3x3(x, wt, b, packed=None if pw is None else (pw, pb))
        want = conv3x3_plain(x, wt, b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        assert err <= rel[x.dtype] * max(1.0, scale), (label, key, err, scale)
        worst = max(worst, err)
    log(f"check conv3x3 at the main path's shapes and inputs, {label}: {len(seen)} shapes of "
        f"{len(calls)} calls, max_abs_err={worst:.3e} tol={rel[calls[0][0].dtype]:g}x -> ok "
        f"on {card}")
    return worst


@torch.inference_mode()
def time_conv3x3(calls: list, halo_rows: int) -> dict:
    """Sums over ``calls`` (float32 conv3x3 calls with their own inputs) of
    conv3x3's CUDA-event ms, its plain version's, cuDNN's conv + ReLU (TF32
    off) and the FP32 bound of the work the shard keeps: the bound
    reads every input row once and computes and writes only the kept ones
    (``halo_rows`` rows of each output: the halo the shard crops)."""
    t = dict.fromkeys(("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms"), 0.0)
    for x, wt, b, pw, pb in calls:
        n, cin, h, w = x.shape
        cout, kept = wt.shape[0], x.shape[2] - halo_rows
        t["ms"] += time_ms(lambda: double_conv_mod.conv3x3(x, wt, b, packed=(pw, pb)), ())
        t["plain_ms"] += time_ms(double_conv_mod.conv3x3_reference, (x, wt, b), reps=1,
                                 repeats=3)
        t["library_ms"] += time_ms(lambda: F.relu(F.conv2d(x, wt, b, padding=1)), ())
        t["bytes_ms"] += 4 * (n * h * w * cin + n * kept * w * cout + 9 * cin * cout + cout) \
            / HBM_BYTES_PER_S * 1e3
        t["ops_ms"] += 2 * n * kept * w * 9 * cin * cout / PEAK_OPS_PER_S[torch.float32] * 1e3
    return t


def mesh_of(shape):
    return make_mesh(*shape, devices=[DEV] * (shape[0] * shape[1]))


def peak_gib(fn) -> float:
    """Peak device memory of one call of ``fn`` above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def sharded_forwards(seeded: Path, card: str) -> tuple[dict, dict, float]:
    """Phase 15, the spatially sharded stage-4 forward (the main path):
    spatial_predict on a 1000 px slide padded to each grid's divisor
    against native_forward on the same padded image, float32, then bf16
    against the bf16 native_forward; conv3x3 held against its plain version
    on every shape each run gave it.  Returns launches, numbers and the
    largest conv3x3 |d|."""
    stage, sd = load_checkpoint(seeded)
    model = stage_model(stage, sd, DEV)
    model_bf16 = stage_model(stage, sd, DEV, 1, torch.bfloat16)
    g = np.random.default_rng(15)
    slide = torch.from_numpy(g.random((1, MESH_PX, MESH_PX, 3), dtype=np.float32)).to(DEV)
    launches, out, conv_err = {}, {}, 0.0
    assert not torch.backends.cuda.matmul.allow_tf32  # the resize bands: float32 matmuls
    for shape, w_axis in MESH_GRIDS:
        mesh = mesh_of(shape)
        n_shards = shape[0] * (shape[1] if w_axis else 1)
        label = f"{shape[0]}x{shape[1]}" + (f" (W over {w_axis})" if w_axis else "")
        padded, _ = pad_to_divisible(slide, stage, mesh, w_axis=w_axis)
        weights = SpatialWeights(sd, stage, mesh)
        want = native_forward(model, padded, (1, 1))
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        with captured_conv3x3() as calls:
            got = spatial_predict(weights, padded, mesh, stage=stage, w_axis=w_axis)
        torch.cuda.synchronize()
        counts = _lib.launch_counts()
        assert counts == {"conv3x3": 18 * n_shards, "uncertainty_from_logits": n_shards}, counts
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        conv_err = max(conv_err, hold_conv3x3(calls, f"{label} grid, float32", card))
        if shape == (2, 1):  # the conv3x3 line: shard 0's 18 convs (calls go shard by shard)
            out["conv3x3_one_shard"] = time_conv3x3(calls[0::n_shards], halo_rows=1)
            conv_shapes = [tuple(c[0].shape) for c in calls[0::n_shards]]
        del calls
        err = max((a - b).abs().max().item() for a, b in zip(got[1:], want[1:]))
        flips = got[0] != want[0]
        assert err <= 1e-4, err
        assert bool(((want[1][flips] - 0.5).abs() < 1e-4).all())
        ms = time_ms(lambda: spatial_predict(weights, padded, mesh, stage=stage, w_axis=w_axis),
                     (), reps=1, repeats=3)
        ms_plain = time_ms(lambda: native_forward(model, padded, (1, 1)), (), reps=1, repeats=3)
        peak = peak_gib(lambda: spatial_predict(weights, padded, mesh, stage=stage,
                                                w_axis=w_axis))
        peak_plain = peak_gib(lambda: native_forward(model, padded, (1, 1)))
        # bf16: sharded against unsharded on the same padded image; sharding may
        # move the map at most twice as far as bf16 moves the unsharded one from
        # float32, and decisions only within that distance of the threshold
        with captured_conv3x3() as calls:
            bf16 = spatial_predict(SpatialWeights(sd, stage, mesh, torch.bfloat16), padded,
                                   mesh, stage=stage, w_axis=w_axis, dtype=torch.bfloat16)
        conv_err = max(conv_err, hold_conv3x3(calls, f"{label} grid, bfloat16", card))
        del calls
        want16 = native_forward(model_bf16, padded, (1, 1))
        own = (want16[1] - want[1]).abs()
        gap = (bf16[1] - want16[1]).abs()
        flips16 = bf16[0] != want16[0]
        bf16_stats = {"bf16_max_abs_gap": gap.max().item(), "bf16_mean_abs_gap": gap.mean().item(),
                      "bf16_own_max": own.max().item(), "bf16_own_mean": own.mean().item(),
                      "bf16_decisions_equal": float((~flips16).float().mean())}
        assert gap.max() <= 2 * own.max() and gap.mean() <= 2 * own.mean(), bf16_stats
        assert bool(((want16[1][flips16] - 0.5).abs() <= gap.max()).all()), bf16_stats
        out[label] = {"padded": list(padded.shape[1:3]), "shards": n_shards,
                      "max_abs_err": err, "pred_flips": int(flips.sum()),
                      "positive_share": float(want[0].mean()),
                      "ms": ms, "unsharded_ms": ms_plain, "peak_gib": peak,
                      "unsharded_peak_gib": peak_plain, **bf16_stats}
        log(f"mesh: spatial_predict stage 4, {label} grid on [{DEV}] * {shape[0] * shape[1]}, "
            f"{MESH_PX} px padded to {tuple(padded.shape[1:3])}, float32: launches "
            f"{json.dumps(counts)}, max|d| against native_forward {err:.3e}, {int(flips.sum())} "
            f"decision flips (all within 1e-4 of 0.5), {float(want[0].mean()):.4f} of pixels "
            f"positive; {ms:.3f} ms against {ms_plain:.3f} unsharded (CUDA events), peak "
            f"{peak:.3f} GiB against {peak_plain:.3f}; bf16 against the bf16 native_forward: "
            f"max|d| {bf16_stats['bf16_max_abs_gap']:.3e} (mean "
            f"{bf16_stats['bf16_mean_abs_gap']:.3e}) within twice bf16's own distance from "
            f"float32 ({bf16_stats['bf16_own_max']:.3e}, mean {bf16_stats['bf16_own_mean']:.3e}), "
            f"decisions equal {bf16_stats['bf16_decisions_equal']:.4%}; on {card}")
        del weights, got, want, bf16, want16
        torch.cuda.empty_cache()
    log("time", json.dumps({"kernel": "conv3x3", "shapes": "shard 0 of the 2 x 1 grid, its own "
                            "inputs: the 1024 x 1008 padded slide's 512 rows per level-1 conv "
                            "plus one halo row, which the bound does not count as output",
                            "input_shapes": conv_shapes, "card": card,
                            **out["conv3x3_one_shard"]}))
    return launches, out, conv_err


def compare_exact(got, want, label: str, atol: float = 0.0) -> float:
    err = max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
              for a, b in zip(got, want))
    assert err <= atol, (label, err)
    return err


def mesh_predictors(seeded: Path, card: str) -> tuple[dict, dict]:
    """Phase 15, the mesh Predictor: data-parallel on [cuda:0] * 2 at bucket
    64 in bf16 and float32 against the unsharded Predictor (1e-6), the
    column-parallel convs on a 1 x 2 mesh at bucket 8 (1e-5), int8
    data-parallel (every int8 point equal)."""
    g = np.random.default_rng(16)
    x = g.random((MESH_BUCKET, 256, 256, 3), dtype=np.float32)
    launches, out = {}, {}
    dp = mesh_of((2, 1))
    for dtype in (torch.bfloat16, torch.float32):
        want = Predictor(str(seeded), buckets=(MESH_BUCKET,), dtype=dtype)(x)
        pm = Predictor(str(seeded), buckets=(MESH_BUCKET,), dtype=dtype, mesh=dp)
        _lib.reset_launch_counts()
        got = pm(x)
        counts = _lib.launch_counts()
        assert counts == {"fused_double_conv": 18, "upsample2x": 8,
                          "uncertainty_from_logits": 2}, counts
        err = compare_exact(got, want, f"data-parallel {dtype}", 1e-6)
        out[f"data_parallel_{str(dtype)[6:]}"] = err
        log(f"mesh: Predictor on [{DEV}] * 2 (data 2), bucket {MESH_BUCKET}, {dtype}: launches "
            f"{json.dumps(counts)}, max|d| against the unsharded Predictor {err:.3e} on {card}")
    xt = x[:TP_BUCKET]
    want = Predictor(str(seeded), buckets=(TP_BUCKET,), dtype=None)(xt)
    pm = Predictor(str(seeded), buckets=(TP_BUCKET,), dtype=None, mesh=mesh_of((1, 2)),
                   shard_model=True)
    _lib.reset_launch_counts()
    with captured_conv3x3() as calls:
        got = pm(xt)
    counts = _lib.launch_counts()
    # down2, down3, down4 and up1 shard both convs (256 or 512 outputs): 2 x 2 launches each
    assert counts == {"conv3x3": 16, "fused_double_conv": 5, "upsample2x": 4,
                      "uncertainty_from_logits": 1}, counts
    launches["conv3x3"] = counts["conv3x3"]
    out["conv3x3_max_abs_err"] = hold_conv3x3(calls, "column-parallel slices, float32", card)
    del calls
    out["tensor_parallel_float32"] = compare_exact(got, want, "tensor-parallel", 1e-5)
    log(f"mesh: Predictor on [{DEV}] * 2 (model 2, shard_model), bucket {TP_BUCKET}, float32: "
        f"launches {json.dumps(counts)}, max|d| against the unsharded Predictor "
        f"{out['tensor_parallel_float32']:.3e} on {card}")
    calib = [g.random((8, 256, 256, 3), dtype=np.float32)]
    quant = dict(buckets=(MESH_BUCKET,), quantize=True, calibration_batches=calib)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # both calibrations take the same scales
    try:
        with warnings.catch_warnings():  # bucket 64's off-128 int8 warning, known
            warnings.simplefilter("ignore", UserWarning)
            ps = Predictor(str(seeded), **quant)
            pm = Predictor(str(seeded), mesh=dp, **quant)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    compare_exact(pm(x), ps(x), "int8 data-parallel")
    # on one card both data rows serve the mesh Predictor's own model (one
    # replica per distinct device): its points, against a second calibration
    assert pm._rows[1][1] is pm.model
    points = ({}, {})
    for predictor, pts in zip((pm.model, ps.model), points):
        predictor.forward_nhwc(torch.from_numpy(x[:4]).to(DEV), pts)
    assert sorted(points[0]) == sorted(points[1])
    assert all(torch.equal(points[0][k], points[1][k]) for k in points[1])
    log(f"mesh: int8 Predictor on [{DEV}] * 2 (data 2), bucket {MESH_BUCKET}: outputs and all "
        f"{len(points[1])} int8 points of its model (both rows serve it: one card, no replica) "
        f"equal to the unsharded int8 Predictor's on {card}")
    return launches, out


def mesh_commands(tmp: Path, root: Path, seeded: Path, card: str) -> dict:
    """Phase 15, the command lines: serve --mesh 1 bit for bit as without
    it, test_monuseg --native_res --mesh 1 on phase 10's tree (its trained
    checkpoint and the seeded one) within 1e-4 of the run without it,
    --mesh 2 on one card exiting 2 with the visible-devices message."""
    from ugpg_tpu_torch.cli import serve as serve_cli
    from ugpg_tpu_torch.eval.http_server import ServingHTTPServer

    registries = []
    stub = ServingHTTPServer.serve_forever
    ServingHTTPServer.serve_forever = lambda self: registries.append(self.registry)
    try:
        argv = ["--model", f"m={seeded}", "--slide_model", f"s={seeded}", "--buckets", "1", "8",
                "--port", "0", "--host", "127.0.0.1"]
        for extra in ([], ["--mesh", "1"]):
            assert serve_cli.main(argv + extra) == 0
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.suppress(SystemExit):
            serve_cli.main(argv + ["--mesh", "2"])
    finally:
        ServingHTTPServer.serve_forever = stub
    plain, meshed = registries[0], registries[1]
    assert meshed.get("m").mesh.shape == {"data": 1, "model": 1}
    x = np.random.default_rng(17).random((5, 256, 256, 3), dtype=np.float32)
    compare_exact(meshed.predict("m", x), plain.predict("m", x), "serve --mesh 1")
    tile = (np.random.default_rng(18).random((1, 200, 176, 3)) * 255).astype(np.uint8)
    slide_err = compare_exact(meshed.predict("s", tile)[1:], plain.predict("s", tile)[1:],
                              "serve --mesh 1 slide", 1e-4)
    message = "exceeds the 1 visible device"
    if torch.cuda.device_count() == 1:
        assert len(registries) == 2 and message in err.getvalue(), err.getvalue()[-2000:]
    log(f"command line: serve --mesh 1: a batch of 5 bit for bit as without it, a slide within "
        f"{slide_err:.3e}; --mesh 2 on {torch.cuda.device_count()} card(s): "
        + (err.getvalue().strip().splitlines()[-1] if err.getvalue() else "served"))

    # phase 10's trained checkpoint and the seeded one: the first, trained an
    # epoch a stage, gives a near-constant map on these tiles
    evals, conv_launches = {}, 0
    for name, ckpt in (("trained", tmp / "cli" / "ug_pgunet_stage4_best.pth"),
                       ("seeded", seeded)):
        argv = ["--model", str(ckpt), "--data", str(root), "--eval_full", "--native_res",
                "--num_images", "0"]
        want = test_monuseg.main(argv + ["--output_dir", str(tmp / f"mesh_eval_{name}0")])
        _lib.reset_launch_counts()
        got = test_monuseg.main(argv + ["--mesh", "1",
                                        "--output_dir", str(tmp / f"mesh_eval_{name}1")])
        counts = _lib.launch_counts()
        got, want = got["metrics"], want["metrics"]
        metric_err = max(abs(got[k] - want[k]) for k in want if isinstance(want[k], float))
        assert metric_err <= 1e-4 and counts == {"conv3x3": 18 * got["num_samples"],
                                                 "uncertainty_from_logits": got["num_samples"]}, \
            (name, metric_err, counts)
        conv_launches += counts["conv3x3"]
        evals[name] = {"metric_err": metric_err, **{k: got[f"{k}_mean"] for k in (
            "dice", "recall", "specificity")}}
        log(f"command line: test_monuseg --native_res --mesh 1 on phase 10's tree, {name} "
            f"checkpoint: metrics max|d| {metric_err:.3e} against the run without --mesh (dice "
            f"{got['dice_mean']:.6f} / {want['dice_mean']:.6f}, recall {got['recall_mean']:.4f}, "
            f"specificity {got['specificity_mean']:.4f}), launches {json.dumps(counts)} on "
            f"{card}")
    return {"conv3x3": conv_launches, "evals": evals, "slide_err": slide_err}


def mesh_serving(tmp: Path, root: Path, card: str) -> tuple[dict, dict]:
    """Phase 15: serving on a device mesh of one card named more than once."""
    t0 = time.perf_counter()
    seeded = tmp / "seeded_stage4.pth"
    random_checkpoint(seeded, seed=15)
    with tf32(False):
        err = check_conv3x3(card)
        launches, spatial_out, spatial_err = sharded_forwards(seeded, card)
        pred_launches, pred_out = mesh_predictors(seeded, card)
        commands = mesh_commands(tmp, root, seeded, card)
    launches["conv3x3"] += pred_launches["conv3x3"] + commands["conv3x3"]
    log(f"mesh: phase 15 in {time.perf_counter() - t0:.1f} s on {card}")
    return launches, {"conv3x3_max_abs_err": max(err, spatial_err,
                                                 pred_out.pop("conv3x3_max_abs_err")),
                      "spatial": spatial_out, "predictors": pred_out, "commands": commands}


# ------------------------------------------------------------ phase 16: training on a device mesh
MESH_TRAIN_GRIDS = (((2, 1), False), ((2, 2), True))  # (data, model), shard_model
MESH_TRAIN_TURNS = 5  # stage-2 epochs of the mesh and the unsharded trainer, in turns
MESH_TRAIN_WIDTH = 1.0
SPATIAL_PX = 992  # a phase-9 tile cropped to the stage-4 grids' divisor (2 * 16 and 2 * 16)
SPATIAL_GRIDS = (((2, 1), None), ((2, 2), "model"))
SPATIAL_TIMED = 3
SEG_STEP_KEYS = ("final_loss", "base_loss", "dice", "accuracy", "uncertainty_weight_mean",
                 "uncertainty_weight_std")


@contextlib.contextmanager
def captured_loss():
    """The arguments of every loss-kernel forward made inside (each data
    shard's own logits, masks and probabilities), held to check the
    kernels on after the counted run."""
    calls, fwd = [], uncertainty_bce_mod.uncertainty_weighted_bce_forward

    def record(x, z, p, pos_weight, alpha):
        calls.append((x, z, p, pos_weight, alpha))
        return fwd(x, z, p, pos_weight, alpha)

    uncertainty_bce_mod.uncertainty_weighted_bce_forward = record
    try:
        yield calls
    finally:
        uncertainty_bce_mod.uncertainty_weighted_bce_forward = fwd


@torch.no_grad()
def hold_loss(calls: list, g: float, label: str, card: str) -> dict:
    """Both loss kernels against their plain versions on the main path's
    own per-shard inputs, the backward at the shard's upstream gradient
    ``g`` (1 / shards): phase 6's tolerances."""
    worst = dict.fromkeys(LOSS_KERNELS, 0.0)
    gup = torch.full((), g, device=DEV)
    for x, z, p, pw, alpha in calls:
        got = uncertainty_weighted_bce_forward(x, z, p, pw, alpha)
        want = uncertainty_weighted_bce_reference(x, z, p, pw, alpha)
        dx = uncertainty_weighted_bce_backward(x, z, p, pw, alpha, gup)
        want_dx = uncertainty_weighted_bce_backward_reference(x, z, p, pw, alpha, gup)
        torch.cuda.synchronize()
        rel = max(abs(a.item() - b.item()) / abs(b.item()) for a, b in zip(got, want))
        err = (dx - want_dx).abs().max().item()
        assert rel <= 1e-5 and err <= 1e-5 * want_dx.abs().max().item(), (label, rel, err)
        worst["uncertainty_weighted_bce_fwd"] = max(
            worst["uncertainty_weighted_bce_fwd"],
            max(abs(a.item() - b.item()) for a, b in zip(got, want)))
        worst["uncertainty_weighted_bce_bwd"] = max(worst["uncertainty_weighted_bce_bwd"], err)
    log(f"check loss kernels at the main path's shapes and inputs, {label}: {len(calls)} "
        f"shard calls of shapes {sorted({tuple(c[0].shape) for c in calls})}, max_abs_err "
        f"{json.dumps(worst)} -> ok on {card}")
    return worst


def _assert_close(got: dict, want: dict, keys, rtol: float, atol: float, label: str) -> float:
    worst = 0.0
    for k in keys:
        a, b = float(got[k]), float(want[k])
        assert abs(a - b) <= atol + rtol * abs(b), (label, k, a, b)
        worst = max(worst, abs(a - b) / max(abs(b), 1e-12))
    return worst


def mesh_trainers(card: str) -> tuple[dict, dict, dict]:
    """Phase 16, the mesh trainer at full width: synthetic disks, batch 8,
    fused loss, stages 1 and 2 on [cuda:0] * 2 (2 x 1) and [cuda:0] * 4
    (2 x 2, shard_model).  Each stage's first epoch (one step) against the
    unsharded trainer built from the same seed: metrics rtol 2e-5.  The
    counters, reset just before the mesh epoch, must show one loss forward
    and one backward per data shard; the kernels are then held on those
    shards' inputs (stage 2 from the mesh trainer's stage-1 result in
    both).  Stage-2 images/s, mesh and unsharded epochs in turns."""
    images, masks = disk_dataset(40, 64, seed=16)
    noise = np.random.default_rng(16).standard_normal(images.shape).astype(np.float32)
    images = np.clip(images + 0.05 * noise, 0.0, 1.0)  # no exact ties between the two runs
    first = ArrayLoader(images[:TRAIN_BATCH], masks[:TRAIN_BATCH], batch_size=TRAIN_BATCH)
    timed = ArrayLoader(images[8:], masks[8:], batch_size=TRAIN_BATCH)
    cfgs = {s: {**DEFAULT_STAGE_CONFIGS[s], "epochs_per_stage": 1} for s in (1, 2)}
    launches, errors, out = dict.fromkeys(LOSS_KERNELS, 0), dict.fromkeys(LOSS_KERNELS, 0.0), {}
    for shape, shard_model in MESH_TRAIN_GRIDS:
        label = f"{shape[0]}x{shape[1]}" + (" shard_model" if shard_model else "")
        trainers = {name: UncertaintyGuidedProgressiveTrainer(
            fused_loss=True, width=MESH_TRAIN_WIDTH, stage_configs=cfgs, verbose=False, seed=16,
            mesh=mesh, shard_model=shard_model) for name, mesh in (("mesh", mesh_of(shape)),
                                                                   ("unsharded", None))}
        worst = 0.0
        for stage in (1, 2):
            if stage > 1:
                # stage 2 from the mesh trainer's weights in both: RMSprop's first step
                # moves a near-zero gradient's element by ~10 lr either way
                trainers["mesh"].transfer_weights(1, 2)
                for s in (1, 2):
                    trainers["unsharded"]._model(s).load_state_dict(
                        trainers["mesh"]._model(s).state_dict())
            _lib.reset_launch_counts()
            with captured_loss() as calls:
                got = trainers["mesh"].train_epoch(first, stage)
            torch.cuda.synchronize()
            counts = _lib.launch_counts()
            assert counts == {k: shape[0] for k in LOSS_KERNELS}, (label, stage, counts)
            for k in LOSS_KERNELS:
                launches[k] += counts[k]
            for k, v in hold_loss(calls, 1.0 / shape[0], f"mesh trainer {label}, stage {stage}",
                                  card).items():
                errors[k] = max(errors[k], v)
            del calls
            want = trainers["unsharded"].train_epoch(first, stage)
            worst = max(worst, _assert_close(dict(zip(SEG_STEP_KEYS, got)),
                                             dict(zip(SEG_STEP_KEYS, want)), SEG_STEP_KEYS,
                                             2e-5, 1e-7, f"mesh trainer {label} stage {stage}"))
        ips = {name: [] for name in trainers}
        for _ in range(MESH_TRAIN_TURNS):
            for name, tr in trainers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_epoch(timed, 2)  # ends by reading the epoch's metrics back
                ips[name].append(len(timed) * TRAIN_BATCH / (time.perf_counter() - t0))
        out[label] = {"step0_max_rel_err": worst,
                      **{f"{name}_images_per_s": statistics.median(v) for name, v in ips.items()},
                      **{f"{name}_images_per_s_spread": [min(v), max(v)]
                         for name, v in ips.items()}}
        log(f"mesh training: trainer on [{DEV}] * {shape[0] * shape[1]} ({label}), full width, "
            f"fused loss, batch {TRAIN_BATCH}: step 0 of stages 1-2 against the unsharded trainer "
            f"max rel err {worst:.2e}; loss launches per step {shape[0]} + {shape[0]} (one "
            f"forward and one backward per data shard); stage-2 images/s, median of "
            f"{MESH_TRAIN_TURNS} epochs in turns: mesh {out[label]['mesh_images_per_s']:.2f} "
            f"against unsharded {out[label]['unsharded_images_per_s']:.2f} (spreads "
            f"{out[label]['mesh_images_per_s_spread']}, "
            f"{out[label]['unsharded_images_per_s_spread']}) on {card}")
        del trainers
        torch.cuda.empty_cache()
    return launches, errors, out


def spatial_training(mon_root: Path, card: str) -> tuple[dict, dict, dict]:
    """Phase 16, the spatial train step at stage 4, full width, on a 992 x
    992 crop of a phase-9 tile with the seeded stage 3 as the uncertainty
    source (BN folded, conv3x3 per shard), fused loss, float32, TF32 off:
    step 0 on the 2 x 1 and 2 x 2 (W over 'model') grids against the
    unsharded make_seg_train_step on the same crop (metrics rtol 2e-4 /
    atol 1e-5, BN stats rtol 1e-4 / atol 1e-6); the counters, reset just
    before, must show 14 conv3x3 launches and one loss forward and backward
    per shard; conv3x3 and the loss kernels held on those inputs; seconds
    per step and peak memory, sharded against unsharded."""
    ds = MoNuSegDataset(str(mon_root), image_size=TILE_PX, split="train", augment=False)
    image, mask = ds[0]
    batch = (np.ascontiguousarray(image[None, :SPATIAL_PX, :SPATIAL_PX]),
             np.ascontiguousarray(mask[None, :SPATIAL_PX, :SPATIAL_PX]))
    prev = _seeded(PGUNet3(use_bn=True, width=MESH_TRAIN_WIDTH), 31).eval()
    base = _seeded(PGUNet4(use_bn=True, width=MESH_TRAIN_WIDTH), 41)
    launches = {"conv3x3": 0, **dict.fromkeys(LOSS_KERNELS, 0)}
    errors, out = {"conv3x3": 0.0, **dict.fromkeys(LOSS_KERNELS, 0.0)}, {}

    def fresh():
        model = copy.deepcopy(base)
        return model, torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4)

    plain, opt = fresh()
    plain_step = make_seg_train_step(plain, opt, 4, SPATIAL_PX, prev_model=prev,
                                     prev_resolution=SPATIAL_PX // 2, fused_loss=True)
    want = plain_step(batch, PW)
    want_stats = {k: v.clone() for k, v in plain.state_dict().items() if "running" in k}
    plain_s = time_ms(lambda: plain_step(batch, PW), (), reps=1, repeats=SPATIAL_TIMED) / 1e3
    plain_peak = peak_gib(lambda: plain_step(batch, PW))
    del plain, opt, plain_step
    for shape, w_axis in SPATIAL_GRIDS:
        mesh = mesh_of(shape)
        shards = shape[0] * (shape[1] if w_axis else 1)
        label = f"{shape[0]}x{shape[1]}" + (f" (W over {w_axis})" if w_axis else "")
        model, opt = fresh()
        step = make_spatial_train_step(model, opt, 4, mesh, w_axis=w_axis, prev_model=prev,
                                       fused_loss=True)
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        with captured_conv3x3() as convs, captured_loss() as losses:
            got = step(batch, PW)
        torch.cuda.synchronize()
        counts = _lib.launch_counts()
        assert counts == {"conv3x3": 14 * shards, **{k: shards for k in LOSS_KERNELS}}, \
            (label, counts)
        for k, v in counts.items():
            launches[k] += v
        errors["conv3x3"] = max(errors["conv3x3"], hold_conv3x3(convs, f"spatial step {label}",
                                                                card))
        for k, v in hold_loss(losses, 1.0 / shards, f"spatial step {label}", card).items():
            errors[k] = max(errors[k], v)
        del convs, losses
        metric_err = _assert_close(got, want, SEG_STEP_KEYS, 2e-4, 1e-5, f"spatial {label}")
        stats = model.state_dict()
        stat_err = 0.0
        for k, v in want_stats.items():
            d = (stats[k] - v).abs()
            assert bool((d <= 1e-6 + 1e-4 * v.abs()).all()), (label, k, d.max().item())
            stat_err = max(stat_err, d.max().item())
        step_s = time_ms(lambda: step(batch, PW), (), reps=1, repeats=SPATIAL_TIMED) / 1e3
        peak = peak_gib(lambda: step(batch, PW))
        out[label] = {"shards": shards, "metric_max_rel_err": metric_err,
                      "bn_stats_max_abs_err": stat_err, "s_per_step": step_s,
                      "unsharded_s_per_step": plain_s, "peak_gib": peak,
                      "unsharded_peak_gib": plain_peak, "dice": float(got["dice"]),
                      "uncertainty_mean": float(got["uncertainty_weight_mean"])}
        log(f"mesh training: spatial train step, stage 4, full width, {SPATIAL_PX} px crop, "
            f"{label} grid on [{DEV}] * {shape[0] * shape[1]}: launches {json.dumps(counts)}; "
            f"metrics max rel err {metric_err:.2e} and BN stats max|d| {stat_err:.2e} against the "
            f"unsharded step; {step_s:.4f} s per step against {plain_s:.4f} unsharded (CUDA "
            f"events, median of {SPATIAL_TIMED}), peak {peak:.3f} GiB against {plain_peak:.3f} "
            f"on {card}")
        del model, opt, step
        torch.cuda.empty_cache()
    return launches, errors, out


def mesh_train_commands(tmp: Path, mon_root: Path, card: str) -> tuple[dict, dict]:
    """Phase 16, the command lines in this process: train_monuseg --mesh 2
    --native_finetune 1 on phase 9's tree (stages 1-2, one epoch, batch 8,
    then stage 2 fine-tuned on the 1000 px tiles over the 2 x 1 grid, its
    uncertainty source's conv3x3 per shard: 6 launches per shard and
    native step, train and validation), its _native.pth served by
    SlidePredictor on a tile (5 double-conv, 2 upsample, 1 uncertainty
    launches); train_herlev --mesh 2 on phase 11's tree (stage 1, one
    epoch, batch 16).  Both commands' --mesh 2 names cuda:0 twice."""
    import ugpg_tpu_torch.cli as cli_pkg
    from ugpg_tpu_torch.cli import train_monuseg as train_monuseg_cli

    # --mesh takes the visible cards and exits 2 asking for more (phase 15); on one
    # card the commands' mesh names cuda:0 as often as the spec asks
    def one_card_mesh(spec, device="cuda"):
        n_data, n_model = ([int(v) for v in spec.split(",")] + [1])[:2]
        return mesh_of((n_data, n_model))

    parse_mesh = cli_pkg.parse_mesh
    cli_pkg.parse_mesh = one_card_mesh
    try:
        out = tmp / "mesh_cli"
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_monuseg_cli.main([
            "--data_dir", str(mon_root), "--output_dir", str(out), "--stages", "1", "2",
            "--epochs", "1", "--batch_size", str(TRAIN_BATCH), "--mesh", "2",
            "--native_finetune", "1", "--native_size", str(TILE_PX)])
        wall = time.perf_counter() - t0
        counts = _lib.launch_counts()
        herlev_root = tmp / "mesh_herlev"
        write_herlev_tree(herlev_root)
        t0 = time.perf_counter()
        cls = train_herlev.main(["--data_dir", str(herlev_root), "--output_dir",
                                 str(tmp / "mesh_herlev_out"), "--stages", "1", "--epochs", "1",
                                 "--batch_size", str(HERLEV_BATCH), "--mesh", "2"])
        herlev_wall = time.perf_counter() - t0
    finally:
        cli_pkg.parse_mesh = parse_mesh
    native_steps = 4  # two train tiles, then two validation tiles
    assert trainer.mesh.shape == {"data": 2, "model": 1} and not trainer.preempted
    assert counts == {"conv3x3": 6 * 2 * native_steps}, counts
    obj = read_checkpoint(out / "ug_pgunet_stage2_native.pth")
    assert obj["native_finetune"] is True and obj["stage"] == 2, sorted(obj)
    hist = obj["history"]
    assert all(np.isfinite(hist[k]).all() for k in ("train_loss", "val_loss")), hist
    tile = load_rgb(str(mon_root / "val" / "images" / "val_tile_0.tif"))[None].astype(
        np.float32) / 255.0
    _lib.reset_launch_counts()
    preds, probs, unc = SlidePredictor(str(out / "ug_pgunet_stage2_native.pth"))(tile)
    served = _lib.launch_counts()
    assert served == {"fused_double_conv": 5, "upsample2x": 2, "uncertainty_from_logits": 1}, \
        served
    assert probs.shape == (1, TILE_PX, TILE_PX, 1) and np.isfinite(probs).all()
    assert np.isfinite(unc).all() and set(np.unique(preds)) <= {0.0, 1.0}
    log(f"mesh training: train_monuseg --mesh 2 --native_finetune 1 (stages 1-2, one epoch, "
        f"then stage 2 at {TILE_PX} px) in {wall:.1f} s: launches {json.dumps(counts)}, native "
        f"history {json.dumps(hist)}; its _native.pth served by SlidePredictor on a {TILE_PX} px "
        f"tile: launches {json.dumps(served)}, positive share {float(preds.mean()):.4f} on "
        f"{card}")

    assert cls.mesh.shape == {"data": 2, "model": 1} and (1, "mesh") in cls._train_steps
    assert np.isfinite(cls.history["train_loss"]).all(), cls.history
    assert (tmp / "mesh_herlev_out" / "herlev_stage1_best.pth").exists()
    log(f"mesh training: train_herlev --mesh 2 (stage 1, one epoch, batch {HERLEV_BATCH}) in "
        f"{herlev_wall:.1f} s: train loss {cls.history['train_loss']}, val acc "
        f"{cls.history['val_acc']} on {card}")
    return counts, {"monuseg_s": wall, "native_history": hist, "herlev_s": herlev_wall}


def mesh_training(tmp: Path, mon_root: Path, card: str) -> tuple[dict, dict, dict]:
    """Phase 16: training on a device mesh of one card named more than once."""
    t0 = time.perf_counter()
    with tf32(False):
        launches, errors, trainers = mesh_trainers(card)
        spatial_launches, spatial_errors, spatial = spatial_training(mon_root, card)
        command_launches, commands = mesh_train_commands(tmp, mon_root, card)
    for source in (spatial_launches, command_launches):
        for k, v in source.items():
            launches[k] = launches.get(k, 0) + v
    for k, v in spatial_errors.items():
        errors[k] = max(errors.get(k, 0.0), v)
    log(f"mesh training: phase 16 in {time.perf_counter() - t0:.1f} s on {card}")
    return launches, errors, {"trainers": trainers, "spatial": spatial, "commands": commands}


# ------------------------------------------------------------ phase 17: pipeline groups, processes
GROUP_DEVICES, GROUP_UNC, GROUP_MODEL = 6, 2, 2  # a 2 x 2 train mesh and a 2 x 1 unc mesh
DIST_PROCS = 2  # gloo processes on the one card (NCCL refuses two ranks on one card)
DIST_TIMEOUT_S = 120
# a training command joined to the others with gloo before it parses --mesh (its own join
# would take NCCL on a card); every checkpoint it writes is printed as "WROTE <path>"
DIST_BOOT = (
    "import sys\n"
    "from ugpg_tpu_torch.parallel import distributed\n"
    f"distributed.initialize(backend='gloo', timeout={DIST_TIMEOUT_S})\n"
    "from ugpg_tpu_torch.train import seg_trainer\n"
    "save = seg_trainer.save_checkpoint\n"
    "def logged(path, *a, **k):\n"
    "    print('WROTE', path, flush=True)\n"
    "    return save(path, *a, **k)\n"
    "seg_trainer.save_checkpoint = logged\n"
    "from ugpg_tpu_torch.cli import train_monuseg\n"
    "sys.exit(train_monuseg.cli(sys.argv[1:]))\n")


def pipeline_groups(card: str) -> tuple[dict, dict, dict]:
    """Phase 17, the pipeline over two meshes of [cuda:0] * 6 (n_unc=2,
    n_model=2: a 2 x 2 train mesh with column-parallel convs, a 2 x 1 unc
    mesh): segmentation stage 4, full width, batch 8, fused loss, augment,
    depth 2, over 6 batches; step 0 against the unsharded fused step on the
    same draws (rtol 2e-5); the counters, reset just before the epoch, must
    show one loss forward and one backward per train data shard and step;
    the loss kernels held on those shards' inputs; images/s against the
    fused steps in turns.  Herlev stage 2 through the classification
    pipeline on the same groups, step 0 against the fused step."""
    devices = [DEV] * GROUP_DEVICES
    prev = _seeded(PGUNet3(use_bn=True), 30)
    ref = _seeded(PGUNet4(use_bn=True), 40).state_dict()
    images, masks = disk_dataset(TRAIN_BATCH * PIPE_BATCHES, 256, seed=17)
    batches = [(images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                masks[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]) for i in range(PIPE_BATCHES)]
    g = torch.Generator(device=DEV).manual_seed(17)
    draws = [sample_monuseg_params(g, TRAIN_BATCH) for _ in batches]

    def fresh():
        model = PGUNet4(use_bn=True).to(DEV)
        model.load_state_dict(ref)
        return model, torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4)

    model, opt = fresh()
    pipe = UncertaintyPipeline(model, prev, opt, 4, 256, 128, devices=devices, n_unc=GROUP_UNC,
                               n_model=GROUP_MODEL, fused_loss=True, augment=True, depth=2)
    assert pipe.train_mesh.shape == {"data": 2, "model": 2}, pipe.train_mesh
    assert pipe.unc_mesh.shape == {"data": 2, "model": 1}, pipe.unc_mesh
    pipe.create_state()
    pipe.place_prev()
    fmodel, fopt = fresh()
    fused = make_seg_train_step(fmodel, fopt, 4, 256, prev_model=prev, prev_resolution=128,
                                augment=True, fused_loss=True)
    n_t = pipe.train_mesh.shape["data"]
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    with captured_loss() as calls:
        piped = pipe.run_epoch(batches, PW, aug=draws)
    torch.cuda.synchronize()
    launches = _lib.launch_counts()
    assert launches == {k: PIPE_BATCHES * n_t for k in LOSS_KERNELS}, launches
    errors = hold_loss(calls, 1.0 / n_t, "pipeline groups (2 x 2 train mesh)", card)
    del calls
    want = [fused(b, PW, d) for b, d in zip(batches, draws)]
    step0 = _assert_close(piped[0], want[0], SEG_STEP_KEYS, 2e-5, 1e-6,
                          "pipeline groups, segmentation stage 4")
    log("pipeline groups: step 0, pipelined against fused: "
        + json.dumps({k: [float(piped[0][k]), float(want[0][k])] for k in SEG_STEP_KEYS}))
    _lib.reset_launch_counts()
    runs = {"pipelined": [], "fused": []}
    for _ in range(PIPE_TURNS):
        for name in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "pipelined":
                pipe.run_epoch(batches, PW, aug=draws)
            else:
                for b, d in zip(batches, draws):
                    fused(b, PW, d)
            torch.cuda.synchronize()
            runs[name].append(len(images) / (time.perf_counter() - t0))
    _lib.reset_launch_counts()
    ips = {k: {"median": statistics.median(v), "min": min(v), "max": max(v)}
           for k, v in runs.items()}
    log(f"pipeline groups: [{DEV}] * {GROUP_DEVICES}, n_unc={GROUP_UNC}, n_model={GROUP_MODEL} "
        f"(train mesh 2 x 2, unc mesh 2 x 1), segmentation stage 4, full width, batch "
        f"{TRAIN_BATCH}, {PIPE_BATCHES} batches: loss launches {json.dumps(launches)} ({n_t} "
        f"train data shards a step); step 0 against the unsharded fused step max rel err "
        f"{step0:.2e}; images/s in turns (median [min, max] of {PIPE_TURNS}): "
        + ", ".join(f"{k} {v['median']:.2f} [{v['min']:.2f}, {v['max']:.2f}]"
                    for k, v in ips.items()) + f" on {card} (one card: the overhead, not "
        "scaling)")
    del pipe, fused, model, fmodel
    torch.cuda.empty_cache()

    k, res, prev_res = 7, CLS_STAGE_RESOLUTIONS[2], CLS_STAGE_RESOLUTIONS[1]
    cprev = _seeded(HerlevClassificationModel(1, k), 70)
    cref = _seeded(HerlevClassificationModel(2, k), 80).state_dict()
    rng = np.random.default_rng(17)
    cbatch = (rng.random((HERLEV_BATCH, res, res, 3), dtype=np.float32),
              rng.integers(0, k, HERLEV_BATCH))
    cw = torch.linspace(0.5, 2.0, k, device=DEV)
    params = sample_herlev_params(torch.Generator(device=DEV).manual_seed(18), HERLEV_BATCH,
                                  res, res)
    out = []
    for piped_run in (True, False):
        cmodel = HerlevClassificationModel(2, k).to(DEV)
        cmodel.load_state_dict(cref)
        copt = torch_rmsprop(cmodel.parameters(), 1e-4)
        dropout = torch.Generator(device=DEV).manual_seed(19)
        if piped_run:
            cpipe = UncertaintyPipeline(cmodel, cprev, copt, 2, res, prev_res, devices=devices,
                                        n_unc=GROUP_UNC, n_model=GROUP_MODEL,
                                        task_type="classification", num_classes=k,
                                        augment=True, normalize=True)
            out.append(cpipe.run_epoch([cbatch], cw, aug=[params], generator=dropout)[0])
        else:
            step = make_cls_train_step(cmodel, copt, 2, res, k, prev_model=cprev,
                                       prev_resolution=prev_res, augment=True, normalize=True)
            out.append(step(cbatch, cw, dropout, aug=params))
    cls0 = _assert_close(out[0], out[1], ("final_loss", "base_loss", "uncertainty_weight_mean",
                                          "uncertainty_weight_std"), 2e-5, 1e-6,
                         "pipeline groups, Herlev stage 2")
    assert int(out[0]["correct"]) == int(out[1]["correct"])
    log(f"pipeline groups: Herlev stage 2, batch {HERLEV_BATCH}, the same groups: step 0 "
        f"against the fused step max rel err {cls0:.2e} on {card}")
    return launches, errors, {"step0_max_rel_err": step0, "herlev_step0_max_rel_err": cls0,
                              "images_per_s": ips}


def _dist_models():
    prev = _seeded(PGUNet1(use_bn=True), 21)
    model = _seeded(PGUNet2(use_bn=True), 22)
    return model, prev


def _dist_step(mesh, batch, rows):
    """Step 0 of stage 2 at full width (fused loss, augmentation drawn from
    seed 23) on ``mesh`` over ``batch[rows]``: (metrics, state, loss launches)."""
    model, prev = _dist_models()
    step = make_seg_train_step(model, torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4),
                               2, STAGE_RES[1], prev_model=prev, prev_resolution=STAGE_RES[0],
                               augment=True, fused_loss=True, mesh=mesh)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    m = step((batch[0][rows], batch[1][rows]), PW, torch.Generator(device=DEV).manual_seed(23))
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    _lib.reset_launch_counts()
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().cpu() for k, v in model.state_dict().items()}, counts)


def dist_worker(rank: int, tmp: str) -> None:
    """One of the gloo processes (``python -c``, see ``two_processes``):
    step 0 on a one-device mesh over its rows of ``tmp/batch.npz``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"file://{tmp}/rdzv", num_processes=DIST_PROCS, process_id=rank,
                           backend="gloo", timeout=DIST_TIMEOUT_S)
    try:
        with np.load(Path(tmp) / "batch.npz") as f:
            batch = (f["images"], f["masks"])
        result = _dist_step(make_mesh(1, 1, devices=[DEV]), batch,
                            distributed.host_batch_slice(TRAIN_BATCH))
        torch.save(result, Path(tmp) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def two_processes(tmp: Path, mon_root: Path, card: str) -> tuple[dict, dict]:
    """Phase 17, two gloo processes on the card (NCCL cannot run two ranks
    on one card, so it is not measured here): each on a one-device local
    mesh, stage 2 at full width, global batch 8, fused loss, augmented;
    step 0's metrics and BN stats against one process on the 2 x 1 mesh
    (rtol 2e-5), the parameters bit for bit equal across the processes,
    one loss forward and one backward launch per process.  Beside them
    train_monuseg --mesh 1 under a coordinator on phase 9's tree (2
    processes, stage 1, one epoch: both exit 0, only process 0 writes) and
    serve --mesh 1 under a coordinator (exit 2 with the reason); the three
    groups of children run at once, each finishing or killed."""
    images, masks = disk_dataset(TRAIN_BATCH, STAGE_RES[1], seed=24)
    noise = np.random.default_rng(24).standard_normal(images.shape).astype(np.float32)
    batch = (np.clip(images + 0.05 * noise, 0.0, 1.0), masks)
    np.savez(tmp / "batch.npz", images=batch[0], masks=batch[1])
    out = tmp / "dist_cli"
    env = {**os.environ, "UGPG_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
           "WORLD_SIZE": str(DIST_PROCS)}
    t0 = time.perf_counter()
    # children that import this script and run dist_worker
    workers = [start_command([sys.executable, "-c", "import sys, chip_smoke as c; "
                              "c.dist_worker(int(sys.argv[1]), sys.argv[2])", str(r), str(tmp)])
               for r in range(DIST_PROCS)]
    commands = [subprocess.Popen(
        [sys.executable, "-u", "-c", DIST_BOOT, "--data_dir", str(mon_root), "--output_dir",
         str(out), "--stages", "1", "--epochs", "1", "--batch_size", str(TRAIN_BATCH),
         "--checkpoint_every", "1", "--mesh", "1"], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env={**env, "RANK": str(r)})
        for r in range(DIST_PROCS)]
    serve_proc = subprocess.Popen(
        port_command("ugpg_tpu_torch.cli.serve", "--model", f"m={tmp / 'absent.pth'}", "--mesh",
                     "1"), cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    with tf32(False):
        want, want_state, want_counts = _dist_step(mesh_of((2, 1)), batch, slice(None))
    assert want_counts == {k: 2 for k in LOSS_KERNELS}, want_counts
    for r, proc in enumerate(workers):
        finish_command(proc, f"gloo process {r} of {DIST_PROCS}", timeout=2 * DIST_TIMEOUT_S)
    texts = [finish_command(p, f"train_monuseg --mesh 1, process {r} of {DIST_PROCS}",
                            timeout=2 * DIST_TIMEOUT_S) for r, p in enumerate(commands)]
    served_out, served_err = serve_proc.communicate(timeout=2 * DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0

    runs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(DIST_PROCS)]
    worst, stats_err = 0.0, 0.0
    for metrics, state, counts in runs:
        assert counts == {k: 1 for k in LOSS_KERNELS}, counts
        worst = max(worst, _assert_close(metrics, want, SEG_STEP_KEYS, 2e-5, 1e-7,
                                         "two processes, stage 2"))
        for k, v in want_state.items():
            if "running" in k:
                d = (state[k] - v).abs()
                assert bool((d <= 1e-7 + 2e-5 * v.abs()).all()), (k, d.max().item())
                stats_err = max(stats_err, d.max().item())
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    log(f"processes: {DIST_PROCS} gloo processes on {DEV}, one-device local meshes, stage 2 "
        f"full width, global batch {TRAIN_BATCH}, fused loss: step 0 against one process on "
        f"the 2 x 1 mesh: metrics max rel err {worst:.2e}, BN stats max|d| {stats_err:.2e}; "
        f"parameters bit for bit equal across the processes; loss launches per process "
        f"{json.dumps(runs[0][2])} on {card}")

    wrote = [[line.split(None, 1)[1] for line in t.splitlines() if line.startswith("WROTE ")]
             for t in texts]
    assert wrote[0] and not any(wrote[1:]), wrote
    assert (out / "ug_pgunet_stage1_best.pth").exists() and (out / "ug_pgunet_stage1_last.pth")\
        .exists()
    rows = (out / "training_log.csv").read_text().splitlines()
    assert len(rows) == 2, rows  # the header and the one epoch's row, from process 0
    assert serve_proc.returncode == 2 and "ugpg_tpu/eval/serving.py:473" in served_err, \
        served_err[-2000:]
    log(f"processes: train_monuseg --mesh 1 under a coordinator, {DIST_PROCS} processes, stage "
        f"1, one epoch: both exit 0, process 0 wrote {[Path(w).name for w in wrote[0]]}, the "
        f"others nothing; serve --mesh 1 under a coordinator exits 2: "
        f"{served_err.strip().splitlines()[-1][:160]}; the children together {wall:.1f} s on "
        f"{card}")
    return {k: DIST_PROCS for k in LOSS_KERNELS}, {
        "step0_max_rel_err": worst, "bn_stats_max_abs_err": stats_err, "children_s": wall}


def groups_and_processes(tmp: Path, mon_root: Path, card: str) -> tuple[dict, dict, dict]:
    """Phase 17: the pipeline's device groups and training over processes."""
    t0 = time.perf_counter()
    with tf32(False):
        launches, errors, groups = pipeline_groups(card)
    torch.cuda.empty_cache()
    dist_launches, processes = two_processes(tmp, mon_root, card)
    for k, v in dist_launches.items():
        launches[k] += v
    log(f"groups and processes: phase 17 in {time.perf_counter() - t0:.1f} s on {card}")
    return launches, errors, {"groups": groups, "processes": processes}


# ------------------------------------------------------------ phase 18: whole epochs, CUDA graphs
SCAN_BATCHES, SCAN_TAIL, SCAN_CHUNKS = 24, 4, 3  # 3 chunks of 8 batches of 8, a tail of 4
SCAN_TURNS = 5
SCAN_HERLEV_BATCHES, SCAN_HERLEV_EPOCHS = 6, 3
SCAN_MON_CHUNK_MB = 64


@contextlib.contextmanager
def captured_graph_loss():
    """The loss kernels' tensors as a CUDA graph captures them: the
    graph's own buffers, which every replay fills again, so that after a
    replay they hold that step's logits, masks, probabilities, upstream
    gradient and the kernels' outputs.  Holding them keeps the graph's pool
    from reusing their memory within the step."""
    got, fwd = {}, uncertainty_bce_mod.uncertainty_weighted_bce_forward
    bwd = uncertainty_bce_mod.uncertainty_weighted_bce_backward

    def record_fwd(x, z, p, pos_weight, alpha):
        out = fwd(x, z, p, pos_weight, alpha)
        if torch.cuda.is_current_stream_capturing():  # detached: the storage, not autograd's graph
            got["fwd"] = (x.detach(), z, p, pos_weight, alpha, out)
        return out

    def record_bwd(x, z, p, pos_weight, alpha, g):
        dx = bwd(x, z, p, pos_weight, alpha, g)
        if torch.cuda.is_current_stream_capturing():
            got["bwd"] = (x.detach(), z, p, pos_weight, alpha, g, dx)
        return dx

    uncertainty_bce_mod.uncertainty_weighted_bce_forward = record_fwd
    uncertainty_bce_mod.uncertainty_weighted_bce_backward = record_bwd
    try:
        yield got
    finally:
        uncertainty_bce_mod.uncertainty_weighted_bce_forward = fwd
        uncertainty_bce_mod.uncertainty_weighted_bce_backward = bwd


@torch.no_grad()
def hold_replayed_loss(got: dict, label: str, card: str) -> dict:
    """Both loss kernels' outputs of the last replayed step against their
    plain versions on that step's own inputs: phase 6's tolerances."""
    x, z, p, pw, alpha, out = got["fwd"]
    want = uncertainty_weighted_bce_reference(x, z, p, pw, alpha)
    xb, zb, pb, pwb, alphab, g, dx = got["bwd"]
    want_dx = uncertainty_weighted_bce_backward_reference(xb, zb, pb, pwb, alphab, g)
    torch.cuda.synchronize()
    rel = max(abs(a.item() - b.item()) / abs(b.item()) for a, b in zip(out, want))
    err = (dx - want_dx).abs().max().item()
    assert rel <= 1e-5 and err <= 1e-5 * want_dx.abs().max().item(), (label, rel, err)
    worst = {"uncertainty_weighted_bce_fwd": max(abs(a.item() - b.item())
                                                 for a, b in zip(out, want)),
             "uncertainty_weighted_bce_bwd": err}
    log(f"check loss kernels on a replayed step's own inputs, {label}: logits "
        f"{tuple(x.shape)}, p {tuple(p.shape)}, alpha {alpha}, max_abs_err "
        f"{json.dumps(worst)} -> ok on {card}")
    return worst


def _scan_gap(a: tuple, b: tuple) -> float:
    """Largest absolute difference of two runs' (train, val metrics, model)."""
    gap = max(abs(x - y) for ma, mb in zip(a[:2], b[:2]) for x, y in zip(ma, mb))
    for x, y in zip(a[2].state_dict().values(), b[2].state_dict().values()):
        gap = max(gap, (x.double() - y.double()).abs().max().item())
    return gap


def _agree(label: str, runs: dict, again, card: str) -> dict:
    """The scan run against the per-step run bit for bit; failing that,
    within twice the per-step path's own run-to-run distance (``again``
    runs it once more), which is printed."""
    gap = _scan_gap(runs["scan"], runs["loop"])
    if gap == 0.0:
        log(f"whole epochs, {label}: metrics, parameters and BN statistics equal the per-step "
            f"path bit for bit on {card}")
        return {"bit_for_bit": True, "max_abs_gap": 0.0}
    own = _scan_gap(again(), runs["loop"])
    log(f"whole epochs, {label}: {gap:.3e} from the per-step path, whose own run-to-run "
        f"distance is {own:.3e} on {card}")
    assert gap <= 2 * own, (label, gap, own)
    return {"bit_for_bit": False, "max_abs_gap": gap, "per_step_run_to_run": own}


def _timed_epoch(tr, batches: list, stage: int) -> dict:
    """One train epoch: wall s, host s until the epoch's last step was
    enqueued (the entry of the reduction, before it reads the rows), the
    host's s in ``replay()`` calls (the scan path), peak GiB."""
    from ugpg_tpu_torch.train import seg_trainer as seg_mod

    stamp = []
    average = seg_mod._average_rows

    def at_fetch(*a):  # the epoch's rows, every launch enqueued, not yet read
        stamp.append(time.perf_counter())
        return average(*a)

    seg_mod._average_rows = at_fetch
    graph = tr._epochs.get((stage, "train", False))
    replay_s = graph.graph.replay_s if graph and graph.graph else 0.0
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.train_epoch(batches, stage)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        seg_mod._average_rows = average
    graph = tr._epochs.get((stage, "train", False))
    return {"wall_s": wall, "host_s": stamp[0] - t0,
            "replay_s": (graph.graph.replay_s - replay_s) if graph and graph.graph else None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            # a graph's pool is reserved, not allocated, while it replays
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}


def _time_paths(loop, scan, batches: list, stage: int, label: str, card: str) -> dict:
    """Train epochs of the per-step and the whole-epoch trainer in turns
    (median and spread of SCAN_TURNS), then one of each profiled for the
    device's idle share.  First one untimed epoch of each: the scan
    trainer captures its graphs there (anew where cuDNN's settings changed
    since the agreement check, which was deterministic)."""
    for tr in (loop, scan):
        tr.train_epoch(batches, stage)
    runs = {"per_step": [], "scan": []}
    for _ in range(SCAN_TURNS):
        for name, tr in (("per_step", loop), ("scan", scan)):
            runs[name].append(_timed_epoch(tr, batches, stage))
    n_images = sum(len(b[0]) for b in batches)
    speed = {}
    for name, rs in runs.items():
        ips = [n_images / r["wall_s"] for r in rs]
        host = [r["host_s"] / len(batches) * 1e6 for r in rs]
        speed[name] = {"images_per_s": {"median": statistics.median(ips), "min": min(ips),
                                        "max": max(ips), "runs": ips},
                       "host_us_per_step": {"median": statistics.median(host),
                                            "min": min(host), "max": max(host)},
                       "peak_gib": max(r["peak_gib"] for r in rs),
                       "peak_reserved_gib": max(r["peak_reserved_gib"] for r in rs)}
        if rs[0]["replay_s"] is not None:  # every uniform step of a turn is a replay
            per = [r["replay_s"] / (len(batches) - 1) * 1e6 for r in rs]
            speed[name]["host_us_per_replay"] = statistics.median(per)
    idle = {}
    for name, tr in (("per_step", loop), ("scan", scan)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_epoch(batches, stage)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        union, total = _busy_ms(prof)
        idle[name] = {"wall_ms": wall, "busy_ms": union, "kernel_ms_sum": total,
                      "idle_share": (1 - union / wall) if union > 0 else None,
                      "kernels": _kernel_ms(prof)}
    kernels = {name: idle[name].pop("kernels") for name in idle}
    log(f"whole epochs, stage {stage}, {label}, batch {TRAIN_BATCH}, float32: images/s in turns "
        f"(median [min, max] of {SCAN_TURNS}): " + ", ".join(
            f"{k} {v['images_per_s']['median']:.2f} [{v['images_per_s']['min']:.2f}, "
            f"{v['images_per_s']['max']:.2f}]" for k, v in speed.items())
        + "; host us per step until the first wait at the epoch's end: " + ", ".join(
            f"{k} {v['host_us_per_step']['median']:.1f}" for k, v in speed.items())
        + f"; host us per replay() {speed['scan'].get('host_us_per_replay', 0.0):.1f}"
        + "; peak GiB allocated (a graph's pool is reserved, not allocated, as it replays) / "
        "reserved (the process's cached pool): " + ", ".join(
            f"{k} {v['peak_gib']:.3f} / {v['peak_reserved_gib']:.3f}" for k, v in speed.items())
        + f"; device busy and idle {json.dumps(idle)} on {card}")
    _log_kernel_diff(kernels, f"stage {stage}, {label}", card)
    return {"speed": speed, "idle": idle}


def _kernel_ms(prof) -> dict:
    """Device ms per kernel name in a profile."""
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "Activity Buffer Request":
            out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def _log_kernel_diff(kernels: dict, label: str, card: str, top: int = 12) -> None:
    """Which kernels each path's epoch ran: the largest of each, and the
    kernels with the most device time that only one path ran."""
    per, scan = kernels["per_step"], kernels["scan"]
    only = {name: {k[:120]: round(v, 3) for k, v in sorted(
                ((k, v) for k, v in a.items() if k not in b), key=lambda kv: -kv[1])[:top]}
            for name, a, b in (("per_step", per, scan), ("scan", scan, per))}
    biggest = {name: {k[:120]: round(v, 3)
                      for k, v in sorted(ks.items(), key=lambda kv: -kv[1])[:top]}
               for name, ks in kernels.items()}
    log(f"whole epochs, {label}: device ms of the largest kernels {json.dumps(biggest)}; "
        f"only in one path {json.dumps(only)}; kernel names per_step {len(per)}, scan "
        f"{len(scan)} on {card}")


def scan_segmentation(card: str) -> tuple[dict, dict, dict]:
    """Phase 18, segmentation: the trainer at full width, float32 (TF32
    off; cuDNN deterministic for the agreement, its default for the
    timings), batch 8, fused loss, augmented, noisy
    synthetic disks at 256 px: 24 batches and a ragged tail of 4, chunks
    of 8 batches (3 chunks).  Stages 1 and 4 (stage 4 over a seeded stage
    3 as the frozen source): a scan trainer and the per-step path of a
    trainer built the same way (its optimizer the capturable variant) from
    the same seed, one train and one validation epoch each, equal; the
    scan trainer's counters, reset just before its train epoch, show one
    loss forward and one backward per step, replayed, and the kernels are
    held on the last replayed step's inputs.  Stages 1 and 4 then time the
    scan trainer's epochs in turns with the default per-step trainer's (the
    host-float optimizer, as a user trains without ``scan_epochs``),
    profile one of each for the device's idle share and the kernels each
    ran, and report the host's time per step, the capture seconds and the
    peak memory."""
    images, masks = disk_dataset(SCAN_BATCHES * TRAIN_BATCH + SCAN_TAIL, 256, seed=18)
    noise = np.random.default_rng(18).standard_normal(images.shape).astype(np.float32)
    images = np.clip(images + 0.05 * noise, 0.0, 1.0)
    batches = [(images[i:i + TRAIN_BATCH], masks[i:i + TRAIN_BATCH])
               for i in range(0, SCAN_BATCHES * TRAIN_BATCH, TRAIN_BATCH)]
    batches.append((images[-SCAN_TAIL:], masks[-SCAN_TAIL:]))
    chunk = (SCAN_BATCHES // SCAN_CHUNKS) * (batches[0][0].nbytes + batches[0][1].nbytes)
    cfgs = {s: {**DEFAULT_STAGE_CONFIGS[s], "epochs_per_stage": 1} for s in (1, 3, 4)}

    def trainer(scan: bool, stage: int, built_to_scan: bool = True):
        """A trainer at ``stage``.  ``built_to_scan``: built with
        ``scan_epochs``, so that every step, the per-step path's too, takes
        the capturable optimizer; its epochs are whole where ``scan``, else
        per step.  Else the per-step trainer a user runs by default."""
        tr = UncertaintyGuidedProgressiveTrainer(
            stage_configs=cfgs, verbose=False, seed=18, augment=True, fused_loss=True,
            scan_epochs=built_to_scan, scan_chunk_bytes=chunk)
        if stage == 4:  # a seeded frozen source
            tr._model(3).load_state_dict(_seeded(PGUNet3(use_bn=True), 33).state_dict())
        tr.current_stage = stage
        tr.setup_optimizer(stage)
        tr.scan_epochs = scan
        return tr

    def epoch(tr, stage):
        return (tr.train_epoch(batches, stage), tr.validate_epoch(batches, stage),
                tr.models[stage])

    launches = dict.fromkeys(LOSS_KERNELS, 0)
    errors = dict.fromkeys(LOSS_KERNELS, 0.0)
    out = {"agreement": {}, "capture_s": {}}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for stage in (1, 4):
            scan, loop = trainer(True, stage), trainer(False, stage)
            with captured_graph_loss() as got:
                _lib.reset_launch_counts()
                train_metrics = scan.train_epoch(batches, stage)
                torch.cuda.synchronize()
                counts = _lib.launch_counts()
                held = hold_replayed_loss(got, f"stage {stage}, the last replayed step", card)
            runs = {"scan": (train_metrics, scan.validate_epoch(batches, stage),
                             scan.models[stage]),
                    "loop": epoch(loop, stage)}
            steps = SCAN_BATCHES + 1
            assert counts == dict.fromkeys(LOSS_KERNELS, steps), counts
            graph = scan._epochs[(stage, "train", False)].graph
            assert graph.captures == 1 and graph.eager_steps == WARMUP_STEPS, graph.stats()
            assert graph.replays == SCAN_BATCHES - WARMUP_STEPS
            assert graph.launches == dict.fromkeys(LOSS_KERNELS, 1), graph.launches
            for kernel in LOSS_KERNELS:
                launches[kernel] += counts[kernel]
                errors[kernel] = max(errors[kernel], held[kernel])
            out["agreement"][stage] = _agree(f"stage {stage}", runs,
                                             lambda: epoch(trainer(False, stage), stage), card)
            out["capture_s"][stage] = {kind: scan._epochs[(stage, kind, False)].graph.capture_s
                                       for kind in ("train", "eval")}
            if stage == 1:  # a small step, where the host holds the card back
                torch.backends.cudnn.deterministic = prev
                out["stage1"] = _time_paths(trainer(False, 1, False), scan, batches, 1,
                                            "augmented", card)
                torch.backends.cudnn.deterministic = True
            log(f"whole epochs, stage {stage}: {steps} steps ({SCAN_CHUNKS} chunks of "
                f"{SCAN_BATCHES // SCAN_CHUNKS} batches, the tail per step), loss launches "
                f"{json.dumps(counts)}, graph: {WARMUP_STEPS} warm-up steps, 1 capture "
                f"({graph.capture_s:.3f} s), {graph.replays} replays on {card}")
        # stage 4: both paths' epochs in turns, on the trainers of the check above, with
        # cuDNN's default (non-deterministic) algorithms, as a user trains; then the same
        # without augmentation (phase 7's step)
        torch.backends.cudnn.deterministic = prev
        out["augmented"] = _time_paths(trainer(False, 4, False), scan, batches, 4, "augmented",
                                       card)
        del scan, loop
        torch.cuda.empty_cache()
        plain = {}
        for name, flag in (("per_step", False), ("scan", True)):
            tr = trainer(flag, 4, flag)
            tr.augment = False
            plain[name] = tr
        out["plain"] = _time_paths(plain["per_step"], plain["scan"], batches, 4,
                                   "without augmentation", card)
        log(f"whole epochs: capture s {json.dumps(out['capture_s'])} on {card}")
    finally:
        torch.backends.cudnn.deterministic = prev
    return launches, errors, out


def scan_herlev(card: str) -> dict:
    """Phase 18, Herlev stage 2 (64 px, the reference widths, float32,
    cuDNN deterministic, batch 16, augmented, dropout on): 6 batches and a
    tail of 4 in chunks of 3 batches, three epochs with the plateau
    scheduler halving the learning rate after each (patience -1), through
    the whole-epoch path and the per-step path from the same seed: equal,
    the graph captured once (the learning rate is a tensor it reads)."""
    rng = np.random.default_rng(19)
    res = CLS_STAGE_RESOLUTIONS[2]
    sizes = [HERLEV_BATCH] * SCAN_HERLEV_BATCHES + [4]
    batches = [(rng.random((n, res, res, 3), dtype=np.float32),
                rng.integers(0, 7, n).astype(np.int64)) for n in sizes]
    per = batches[0][0].nbytes + batches[0][1].nbytes

    def run(scan: bool):
        cfg = create_herlev_config()
        cfg.update(num_classes=7, verbose=False, augment=True, scan_epochs=True,
                   scan_chunk_bytes=3 * per, class_weights=[1.0, 1.5, 0.8, 1.2, 1.0, 0.9, 1.1])
        tr = HerlevTrainer(cfg, seed=19)
        tr.transfer_weights(1, 2)
        tr.setup_optimizer_scheduler(2)
        tr.scan_epochs = scan  # off: per step, on the same (capturable) optimizer
        tr._scheduler.patience = -1  # every epoch's step halves the learning rate
        lrs, metrics = [], []
        for _ in range(SCAN_HERLEV_EPOCHS):
            lrs.append(float(tr.optimizer.param_groups[0]["lr"]))
            metrics.append((tr.train_epoch(batches, 2), tr.validate_epoch(batches, 2)))
            tr._scheduler.step(metrics[-1][1][0], tr.optimizer)
        return tr, metrics, lrs

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (scan, ms, lrs), (loop, ml, lrl) = run(True), run(False)
        gap = max(abs(a - b) for x, y in zip(ms, ml) for u, v in zip(x, y) for a, b in zip(u, v))
        for x, y in zip(scan.models[2].state_dict().values(), loop.models[2].state_dict().values()):
            gap = max(gap, (x.double() - y.double()).abs().max().item())
        if gap:
            (_, again, _) = run(False)
            own = max(abs(a - b) for x, y in zip(again, ml) for u, v in zip(x, y)
                      for a, b in zip(u, v))
            assert gap <= 2 * own, (gap, own)
        graph = scan._epochs[(2, "train", False)].graph
        assert lrs == lrl and lrs[1] == lrs[0] / 2 and lrs[2] == lrs[0] / 4, (lrs, lrl)
        assert graph.captures == 1, graph.stats()
    finally:
        torch.backends.cudnn.deterministic = prev
    log(f"whole epochs, Herlev stage 2, batch {HERLEV_BATCH}: {SCAN_HERLEV_EPOCHS} epochs, "
        f"learning rate {lrs} (the plateau scheduler, one capture), "
        + ("bit for bit the per-step path" if not gap else f"{gap:.3e} from the per-step path")
        + f"; train metrics {ms[-1][0]} on {card}")
    return {"max_abs_gap": gap, "lrs": lrs, "capture_s": graph.capture_s}


def scan_command_lines(tmp: Path, mon_root: Path, card: str) -> dict:
    """``train_monuseg --scan_epochs --scan_chunk_mb 64`` on phase 9's tree
    and ``train_herlev --scan_epochs`` on phase 11's (written again), stage
    1, one epoch each, at once: exit 0 and the epoch logged."""
    herlev_root = tmp / "Herlev"
    write_herlev_tree(herlev_root)
    procs = {
        "train_monuseg": start_command(port_command(
            "ugpg_tpu_torch.cli.train_monuseg", "--data_dir", str(mon_root), "--output_dir",
            str(tmp / "mon"), "--stages", "1", "--epochs", "1", "--batch_size",
            str(TRAIN_BATCH), "--scan_epochs", "--scan_chunk_mb", str(SCAN_MON_CHUNK_MB))),
        "train_herlev": start_command(port_command(
            "ugpg_tpu_torch.cli.train_herlev", "--data_dir", str(herlev_root), "--output_dir",
            str(tmp / "herlev"), "--stages", "1", "--epochs", "1", "--batch_size",
            str(HERLEV_BATCH), "--scan_epochs")),
    }
    t0 = time.perf_counter()
    rows = {}
    for (label, proc), out in zip(procs.items(), ("mon", "herlev")):
        finish_command(proc, f"{label} --scan_epochs")
        with open(tmp / out / "training_log.csv") as f:
            rows[label] = list(csv.DictReader(f))
        assert len(rows[label]) == 1 and rows[label][0]["epoch"] == "1", rows[label]
    log(f"command lines: train_monuseg --scan_epochs --scan_chunk_mb {SCAN_MON_CHUNK_MB} and "
        f"train_herlev --scan_epochs, stage 1, one epoch each at once: exit 0, the epoch logged "
        f"({json.dumps({k: v[0] for k, v in rows.items()})}) in "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return {k: v[0] for k, v in rows.items()}


def whole_epochs(tmp: Path, mon_root: Path, card: str) -> tuple[dict, dict, dict]:
    """Phase 18."""
    with tf32(False):
        launches, errors, seg = scan_segmentation(card)
        torch.cuda.empty_cache()
        herlev_run = scan_herlev(card)
    torch.cuda.empty_cache()
    commands = scan_command_lines(tmp, mon_root, card)
    return launches, errors, {"segmentation": seg, "herlev": herlev_run, "commands": commands}


# ------------------------------------------------------------ phase 19: JAX checkpoint forms
MSG_BUCKET = 64  # the bf16 Predictor's bucket, from the .pth and from each directory
MSG_TIMED = 3  # saves and loads of the stage-4 _last per form; the median is kept
DIR_FORMS = ("msgpack", "orbax", "orbax-async")  # the JAX package's checkpoint directories
DIR_FILES = {"msgpack": ["metadata.json", "opt_state.msgpack", "variables.msgpack"],
             "orbax": ["metadata.json", "opt_state_orbax", "variables_orbax"]}
DIR_FILES["orbax-async"] = DIR_FILES["orbax"]


def disk_bytes(path: Path) -> int:
    """The bytes of a file, or of every file under a directory."""
    return path.stat().st_size if path.is_file() else sum(
        f.stat().st_size for f in path.rglob("*") if f.is_file())


def seeded_directory(tmp: Path) -> tuple[dict, Path, dict]:
    """Phase 5's seeded stage 4 as a .pth and as a directory of each form
    (form -> path), whose variables, decoded, equal the state dict bit for
    bit."""
    pth = tmp / "seeded_stage4.pth"
    random_checkpoint(pth)
    _, sd = load_checkpoint(pth)
    folders = {form: save_checkpoint(tmp / f"seeded_{form}" / "ug_pgunet_stage4_best", sd,
                                     backend=form, stage=4, epoch=0) for form in DIR_FORMS}
    for form, folder in folders.items():
        decoded = read_checkpoint(folder)["model_state_dict"]  # waits for orbax-async
        assert set(decoded) == set(sd), (form, sorted(set(decoded) ^ set(sd)))
        for key, value in sd.items():
            assert torch.equal(decoded[key], value), (form, key)
    return sd, pth, folders


def predictor_from_directory(pth: Path, folders: dict, card: str) -> dict:
    """A bucket-64 bf16 Predictor from the .pth and from each directory
    answer bit for bit, each directory's call launching 9 double-conv, 4
    upsample and 1 uncertainty kernels; -> the launches of those calls."""
    images = np.random.default_rng(19).random((MSG_BUCKET, 256, 256, 3), dtype=np.float32)
    from_pth = Predictor(str(pth), buckets=(MSG_BUCKET,), dtype=torch.bfloat16)
    want = from_pth(images)
    del from_pth
    total: dict = {}
    for form, folder in folders.items():
        from_dir = Predictor(str(folder), buckets=(MSG_BUCKET,), dtype=torch.bfloat16)
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        got = from_dir(images)
        torch.cuda.synchronize()
        launches = _lib.launch_counts()
        del from_dir
        assert_same(got, want, f"Predictor from the {form} directory against the .pth")
        check_response(got, MSG_BUCKET)
        assert launches == {"fused_double_conv": 9, "upsample2x": 4,
                            "uncertainty_from_logits": 1}, (form, launches)
        for kernel, n in launches.items():
            total[kernel] = total.get(kernel, 0) + n
        log(f"{form}: phase 5's seeded stage 4 as a directory ({disk_bytes(folder)} bytes): "
            f"decoded equal to the state dict bit for bit; bucket-{MSG_BUCKET} bf16 Predictor "
            f"from it equal to the .pth's bit for bit, one call's launches "
            f"{json.dumps(launches)} on {card}")
    return total


def save_load_times(tmp: Path, sd: dict, card: str) -> dict:
    """Seconds to save and to restore a full-width stage-4 _last (weights,
    RMSprop square averages, history) in each form, the median of
    MSG_TIMED, in turns: the trainer's own save (for orbax-async until its
    trees commit, and apart the seconds until save_checkpoint returns), and
    its restore (read, load the model on the card, load the optimizer)."""
    model = PGUNet4(use_bn=True).to(DEV)
    model.load_state_dict(sd, strict=True)
    opt = torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4)
    g = torch.Generator(device=DEV).manual_seed(19)
    for p in model.parameters():
        opt.state[p] = {"step": torch.tensor(3.0),
                        "square_avg": torch.rand(p.shape, generator=g, device=DEV)}
    names = param_names(opt, model)
    history = {"train_loss": [0.5] * 40, "val_dice": [0.25] * 40, "stage_transitions": [0]}
    paths = {"pth": tmp / "timed_last.pth",
             **{form: tmp / f"timed_{form}" / "ug_pgunet_stage4_last" for form in DIR_FORMS}}
    times = {form: {"save_s": [], "load_s": [], "return_s": []} for form in paths}
    for _ in range(MSG_TIMED):
        for form, path in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(path, model.state_dict(), backend=form, param_names=names,
                            stage=4, epoch=7, optimizer_state_dict=opt.state_dict(),
                            uncertainty_alpha=1.0, history=history, val_dice=0.25)
            times[form]["return_s"].append(time.perf_counter() - t0)
            wait_for_async_saves()
            times[form]["save_s"].append(time.perf_counter() - t0)
            fresh = PGUNet4(use_bn=True).to(DEV)
            fresh_opt = torch_rmsprop(fresh.parameters(), 1e-4, weight_decay=1e-4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            obj = read_checkpoint(path)
            fresh.load_state_dict(obj["model_state_dict"], strict=True)
            load_optimizer_state(fresh_opt, obj["optimizer_state_dict"],
                                 param_names(fresh_opt, fresh), obj.get("lr"))
            torch.cuda.synchronize()
            times[form]["load_s"].append(time.perf_counter() - t0)
            for p, q in zip(opt.param_groups[0]["params"], fresh_opt.param_groups[0]["params"]):
                assert torch.equal(opt.state[p]["square_avg"], fresh_opt.state[q]["square_avg"])
    out = {}
    for form, path in paths.items():
        size = disk_bytes(path)
        save, load, ret = (statistics.median(times[form][k])
                           for k in ("save_s", "load_s", "return_s"))
        out[form] = {"bytes": size, "save_s": save, "load_s": load,
                     "save_mb_per_s": size / save / 1e6, "load_mb_per_s": size / load / 1e6,
                     "save_s_all": times[form]["save_s"], "load_s_all": times[form]["load_s"]}
        if form == "orbax-async":
            out[form].update(return_s=ret, return_s_all=times[form]["return_s"])
    log("checkpoints: a full-width stage-4 _last (weights, RMSprop state, history), save and "
        f"restore seconds, median of {MSG_TIMED} in turns (page cache warm): "
        + "; ".join(f"{form} {v['bytes']} bytes, save {v['save_s']:.4f} s "
                    f"({v['save_mb_per_s']:.1f} MB/s)"
                    + (f", returns after {v['return_s']:.4f} s" if "return_s" in v else "")
                    + f", restore {v['load_s']:.4f} s ({v['load_mb_per_s']:.1f} MB/s), all "
                    f"{json.dumps(v['save_s_all'])} / {json.dumps(v['load_s_all'])}"
                    for form, v in out.items())
        + f" on {card}")
    return out


class _FusedAugTrainer(AugMoNuSegTrainer):
    """The training command's trainer with the fused loss kernels on."""

    def __init__(self, config=None, **kwargs):
        kwargs.setdefault("fused_loss", True)
        super().__init__(config, **kwargs)


def msgpack_argv(mon_root: Path, out: Path, backend: str = "msgpack") -> list[str]:
    """train_monuseg --checkpoint_backend ``backend`` on phase 9's tree,
    stages 1-2 at two epochs."""
    return ["--data_dir", str(mon_root), "--output_dir", str(out), "--stages", "1", "2",
            "--epochs", str(CLI_EPOCHS), "--checkpoint_every", "1", "--batch_size",
            str(TRAIN_BATCH), "--checkpoint_backend", backend]


def msgpack_training(out: Path, mon_root: Path, stopped: tuple, backend: str,
                     card: str) -> tuple[dict, Path]:
    """The run of ``msgpack_argv`` that a child ran until SIGTERM at its
    first 'Stage 2, Batch' line (``stopped``: its exit code, output and
    seconds) must have exited 75 with a _last directory of ``backend``'s
    form; then --resume in this process with the fused loss (every epoch
    logged once, one loss forward and backward per step), then one step
    from the restored _last against the resumed run's own next step, bit
    for bit."""
    from ugpg_tpu_torch.cli import train_monuseg as train_monuseg_cli
    from ugpg_tpu_torch.train import aug_trainer as aug_trainer_mod

    argv = msgpack_argv(mon_root, out, backend)
    rc, text, dt = stopped
    log(f"{backend}: train_monuseg --checkpoint_backend {backend}, SIGTERM at its first "
        f"'Stage 2, Batch' line: exit {rc} after {dt:.1f} s")
    assert rc == 75, text[-4000:]
    last = out / "ug_pgunet_stage2_last"
    meta = json.loads((last / "metadata.json").read_text())
    assert meta["stage"] == 2 and meta["epoch"] == 0, meta
    assert sorted(p.name for p in last.iterdir()) == DIR_FILES[backend]
    assert not list(out.glob("*.pth")), sorted(p.name for p in out.iterdir())

    aug_cls = aug_trainer_mod.AugMoNuSegTrainer
    aug_trainer_mod.AugMoNuSegTrainer = _FusedAugTrainer
    try:
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = train_monuseg_cli.main(argv + ["--resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _lib.launch_counts()
    finally:
        aug_trainer_mod.AugMoNuSegTrainer = aug_cls
    steps = math.ceil(AUG_PATCHES / TRAIN_BATCH)  # stage 2's second epoch (CLI_EPOCHS = 2)
    with open(out / "training_log.csv") as f:
        rows = [(int(r["stage"]), int(r["epoch"])) for r in csv.DictReader(f)]
    log(f"{backend}: train_monuseg --resume (in this process, fused loss) in {wall:.1f} s: "
        f"launches {json.dumps(counts)}; training_log.csv (stage, epoch) rows {rows}")
    assert resumed.fused_loss and not resumed.preempted
    assert counts == {k: steps for k in LOSS_KERNELS}, counts
    assert rows == [(s, e) for s in (1, 2) for e in (1, 2)], rows
    final = json.loads((last / "metadata.json").read_text())
    assert final["epoch"] == 1 and len(final["history"]["train_loss"]) == 4, final["epoch"]
    assert final["history"]["stage_transitions"] == [0, 2]
    assert np.isfinite(final["history"]["train_loss"]).all()

    # one step from the restored _last against the resumed run's next step
    again = _FusedAugTrainer(stage_configs=resumed.stage_configs, width=1.0, verbose=False)
    again.pos_weight = resumed.pos_weight
    assert again._find_resume_point(out) == (2, 1)
    again.setup_optimizer(2)
    again._restore_last(out, 2)
    again.aug_generator.set_state(resumed.aug_generator.get_state())
    loader = DataLoader(AugMoNuSegDataset(str(mon_root), image_size=64), batch_size=TRAIN_BATCH)
    with contextlib.closing(prefetch_to_device(iter(loader), size=1, device=DEV)) as batches:
        batch = next(batches)
    def same_state(label: str) -> None:
        s1, s2 = resumed.models[2].state_dict(), again.models[2].state_dict()
        for key in s1:  # flax has no num_batches_tracked: it reads back as 0
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(s1[key], s2[key]), (label, key)
        for p, q in zip(resumed.optimizer.param_groups[0]["params"],
                        again.optimizer.param_groups[0]["params"]):
            for k, v in resumed.optimizer.state[p].items():
                assert torch.equal(v, again.optimizer.state[q][k]), (label, k)

    same_state("restored")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's backward may sum in any order otherwise
    try:
        m1 = resumed._get_train_step(2)(batch, resumed.pos_weight, resumed.aug_generator)
        m2 = again._get_train_step(2)(batch, again.pos_weight, again.aug_generator)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k in m1:
        assert torch.equal(m1[k], m2[k]), (k, m1[k], m2[k])
    same_state("after a step")
    log(f"{backend}: one stage-2 step from the restored _last equals the resumed run's next "
        f"step bit for bit (metrics, weights, BN stats, square averages; loss "
        f"{float(m1['final_loss']):.6f}) on {card}")
    return counts, out / "ug_pgunet_stage2_best"


def msgpack_checkpoints(tmp: Path, mon_root: Path, card: str) -> tuple[dict, dict]:
    """Phase 19: the JAX package's checkpoint directories (msgpack, orbax,
    orbax-async) on the card.  The training commands, the serve command and
    the Herlev command run in children while this process checks the
    Predictor."""
    sd, seeded_pth, seeded = seeded_directory(tmp)
    seeded_dir = seeded["msgpack"]
    outs = {form: tmp / f"{form}_cli" for form in DIR_FORMS}
    stopped = {}
    trainer_children = [threading.Thread(target=lambda form=form: stopped.__setitem__(
        form, run_command(port_command("ugpg_tpu_torch.cli.train_monuseg",
                                       *msgpack_argv(mon_root, outs[form], form)),
                          stop_at="Stage 2, Batch")), daemon=True) for form in DIR_FORMS]
    for child in trainer_children:
        child.start()
    server = {"proc": start_command(port_command(
        "ugpg_tpu_torch.cli.serve", "--model", f"dir={seeded_dir}", "--model",
        f"orbax={seeded['orbax-async']}", "--model", f"pth={seeded_pth}", "--buckets", "1",
        "--host", "127.0.0.1", "--port", "0"))}
    herlev_root = tmp / "Herlev"
    write_herlev_tree(herlev_root)
    herlev_out = tmp / "msgpack_herlev"
    herlev_proc = start_command(port_command(
        "ugpg_tpu_torch.cli.train_herlev", "--data_dir", str(herlev_root), "--output_dir",
        str(herlev_out), "--stages", "1", "--epochs", "1", "--batch_size", str(HERLEV_BATCH),
        "--checkpoint_backend", "msgpack"))
    try:
        launches = predictor_from_directory(seeded_pth, seeded, card)
        for child in trainer_children:
            child.join()
        for form in DIR_FORMS:
            assert form in stopped, f"the {form} training command's child did not run"
            loss_launches, form_best = msgpack_training(outs[form], mon_root, stopped[form],
                                                        form, card)
            for kernel, n in loss_launches.items():
                launches[kernel] = launches.get(kernel, 0) + n
            if form == "msgpack":
                best = form_best

        # test_monuseg on the _best directory and on the same weights as a .pth
        best_pth = tmp / "stage2_best_copy.pth"
        stage, best_sd = load_checkpoint(best)
        save_checkpoint(best_pth, best_sd, stage=stage)
        results = {}
        for label, model in (("dir", best), ("pth", best_pth)):
            results[label] = test_monuseg.main([
                "--model", str(model), "--data", str(mon_root), "--eval_full", "--output_dir",
                str(tmp / f"msgpack_eval_{label}")])["metrics"]
        assert results["dir"] == results["pth"] and results["dir"]["stage"] == 2, results
        log(f"msgpack: test_monuseg --model {best.name} (a directory) equals the same weights as "
            f"a .pth: dice_mean {results['dir']['dice_mean']:.6f}")

        # the serve command answers from the directory as from the .pth
        lines = []
        port = None
        for line in server["proc"].stdout:
            lines.append(line)
            m = re.search(r"^serving .* on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port is not None, "".join(lines)[-4000:]
        image = np.random.default_rng(20).random((256, 256, 3), dtype=np.float32)
        answers = {}
        for name in ("dir", "orbax", "pth"):
            status, body = http_call(port, "POST", f"/v1/models/{name}:predict", npy(image),
                                     "application/x-npy")
            assert status == 200, body[:400]
            answers[name] = npz(body)
        for key, value in answers["pth"].items():
            for name in ("dir", "orbax"):
                np.testing.assert_array_equal(answers[name][key], value, err_msg=(name, key))
        log(f"msgpack, orbax-async: serve --model dir=<msgpack> --model orbax=<orbax-async> "
            f"answer as --model pth={seeded_pth.name}, bit for bit ({sorted(answers['dir'])})")
    except BaseException:
        herlev_proc.kill()
        herlev_proc.communicate()
        raise
    finally:
        server["proc"].send_signal(signal.SIGINT)
        try:
            server["proc"].communicate(timeout=30)
        except subprocess.TimeoutExpired:
            server["proc"].kill()
            server["proc"].communicate()
    finish_command(herlev_proc, "train_herlev --checkpoint_backend msgpack")
    herlev_best = herlev_out / "herlev_stage1_best"
    assert (herlev_best / "variables.msgpack").is_file() and not list(herlev_out.glob("*.pth"))
    herlev_res = test_herlev.main(["--model", str(herlev_best), "--data_dir", str(herlev_root),
                                   "--output_dir", str(tmp / "msgpack_herlev_eval")])
    assert np.isfinite(herlev_res["accuracy"]), herlev_res
    log(f"msgpack: train_herlev --checkpoint_backend msgpack (stage 1, one epoch) wrote "
        f"{herlev_best.name}/; test_herlev on it: accuracy {herlev_res['accuracy']:.4f}")
    times = save_load_times(tmp, sd, card)
    files = {"pth": seeded_pth, "dirs": seeded, "herlev_best": herlev_best,
             "herlev_root": herlev_root}
    return launches, times, files


# ------------------------------------------------------------ phase 20: .pth conversion commands
def conversion_children(tmp: Path, files: dict) -> tuple[dict, dict]:
    """export_torch on the seeded msgpack and orbax directories and on the
    Herlev _best directory (classification), import_torch on the seeded
    .pth: four children at once, each exiting 0.  -> (the written paths,
    each command's seconds)."""
    out = {"msgpack": tmp / "exported_msgpack.pth", "orbax": tmp / "exported_orbax.pth",
           "herlev": tmp / "exported_herlev.pth", "imported": tmp / "imported_stage4"}
    cmds = {form: port_command("ugpg_tpu_torch.cli.export_torch", "--ckpt",
                               str(files["dirs"][form]), "--out", str(out[form]))
            for form in ("msgpack", "orbax")}
    cmds["herlev"] = port_command("ugpg_tpu_torch.cli.export_torch", "--ckpt",
                                  str(files["herlev_best"]), "--out", str(out["herlev"]),
                                  "--task", "classification")
    cmds["imported"] = port_command("ugpg_tpu_torch.cli.import_torch", "--pth",
                                    str(files["pth"]), "--out", str(out["imported"]))
    t0 = time.perf_counter()
    procs = {name: start_command(cmd) for name, cmd in cmds.items()}
    seconds = {}
    try:
        for name, proc in procs.items():
            finish_command(proc, f"{cmds[name][3]} ({name})", timeout=300)
            seconds[name] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out, seconds


def assert_reference_pth(got: dict, want: dict, label: str) -> None:
    """``got`` (an exported .pth's state dict) equals ``want`` bit for bit,
    each BN's num_batches_tracked an int64 zero."""
    assert set(got) == set(want), (label, sorted(set(got) ^ set(want))[:8])
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), (label, key)
        if key.endswith("num_batches_tracked"):
            assert got[key].dtype == torch.int64 and int(got[key]) == 0, (label, key)


def pth_conversions(tmp: Path, mon_root: Path, files: dict, card: str) -> dict:
    """Phase 20: the .pth conversion commands on phase 19's files (its
    seeded .pth and directories, its Herlev _best directory and tree) on the
    card.  -> the kernel launches of the main path's calls."""
    import importlib.util

    from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
    from ugpg_tpu_torch.io.msgpack import msgpack_restore

    out, seconds = conversion_children(tmp, files)
    log("conversions: export_torch (msgpack, orbax, Herlev classification) and import_torch in "
        "four children at once, exit 0, done after "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()) + f" on {card}")
    launches: dict = {}
    _lib.reset_launch_counts()

    # the exported .pth files against their directories, and a Predictor from each
    images = np.random.default_rng(19).random((MSG_BUCKET, 256, 256, 3), dtype=np.float32)
    for form in ("msgpack", "orbax"):
        folder = files["dirs"][form]
        exported = torch.load(out[form], map_location="cpu", weights_only=True)
        assert exported["stage"] == 4 and exported["epoch"] == 0, (form, exported["stage"])
        assert_reference_pth(exported["model_state_dict"],
                             read_checkpoint(folder)["model_state_dict"], form)
        from_dir = Predictor(str(folder), buckets=(MSG_BUCKET,), dtype=torch.bfloat16)
        want = from_dir(images)
        del from_dir
        from_pth = Predictor(str(out[form]), buckets=(MSG_BUCKET,), dtype=torch.bfloat16)
        torch.cuda.synchronize()
        drain_launches(launches)
        got = from_pth(images)
        torch.cuda.synchronize()
        counts = _lib.launch_counts()
        drain_launches(launches)
        del from_pth
        assert_same(got, want, f"Predictor from the .pth exported from the {form} directory")
        check_response(got, MSG_BUCKET)
        assert counts == {"fused_double_conv": 9, "upsample2x": 4,
                          "uncertainty_from_logits": 1}, (form, counts)
        log(f"conversions: export_torch of the seeded {form} directory: "
            f"{out[form].stat().st_size} bytes, tensors the directory's bit for bit; bucket-"
            f"{MSG_BUCKET} bf16 Predictor from it equal to the directory's bit for bit, one "
            f"call's launches {json.dumps(counts)} on {card}")

    # import_torch: the directory decodes to the .pth's tensors; test_monuseg on both
    imported = out["imported"]
    assert sorted(p.name for p in imported.iterdir()) == ["metadata.json", "variables.msgpack"]
    meta = json.loads((imported / "metadata.json").read_text())
    assert meta["stage"] == 4 and meta["imported_from"] == str(files["pth"]), meta
    decoded = state_dict_from_jax(msgpack_restore((imported / "variables.msgpack").read_bytes()))
    _, pth_sd = load_checkpoint(files["pth"])
    assert_reference_pth(decoded, pth_sd, "imported")
    results, counts = {}, {}
    for label, model in (("dir", imported), ("pth", files["pth"])):
        drain_launches(launches)
        results[label] = test_monuseg.main([
            "--model", str(model), "--data", str(mon_root), "--eval_full", "--output_dir",
            str(tmp / f"imported_eval_{label}")])["metrics"]
        torch.cuda.synchronize()
        counts[label] = _lib.launch_counts()
        drain_launches(launches)
    assert results["dir"] == results["pth"] and results["dir"]["stage"] == 4, results
    assert counts["dir"] == counts["pth"] and counts["dir"].get("fused_double_conv"), counts
    log(f"conversions: import_torch of the seeded .pth: variables.msgpack decoded equal to its "
        f"tensors bit for bit; test_monuseg on the directory equals it on the .pth: dice_mean "
        f"{results['dir']['dice_mean']:.6f}, launches {json.dumps(counts['dir'])} each on {card}")

    # Herlev: the classifier exported from phase 19's _best directory
    exported = torch.load(out["herlev"], map_location="cpu", weights_only=True)
    assert exported["stage"] == 1 and exported["config"]["stage"] == 1, exported["config"]
    assert_reference_pth(exported["model_state_dict"],
                         read_checkpoint(files["herlev_best"])["model_state_dict"], "herlev")
    has_matplotlib = importlib.util.find_spec("matplotlib") is not None
    results, counts, plots = {}, {}, {}
    for label, model in (("dir", files["herlev_best"]), ("pth", out["herlev"])):
        eval_dir = tmp / f"exported_herlev_eval_{label}"
        drain_launches(launches)
        results[label] = test_herlev.main(["--model", str(model), "--data_dir",
                                           str(files["herlev_root"]), "--output_dir",
                                           str(eval_dir)])
        torch.cuda.synchronize()
        counts[label] = _lib.launch_counts()
        drain_launches(launches)
        plots[label] = sorted(p.name for p in eval_dir.glob("*.png"))
    assert results["dir"] == results["pth"] and np.isfinite(results["pth"]["accuracy"]), results
    assert counts["dir"] == counts["pth"] and counts["dir"].get("fused_double_conv"), counts
    assert plots["dir"] == plots["pth"] and bool(plots["pth"]) == has_matplotlib, plots
    log(f"conversions: export_torch --task classification of {files['herlev_best'].name}: "
        f"test_herlev on the .pth equals it on the directory (accuracy "
        f"{results['pth']['accuracy']:.4f}), launches {json.dumps(counts['pth'])} each; "
        f"matplotlib {'present' if has_matplotlib else 'absent'}, plot files written: "
        f"{plots['pth'] or 'none'} on {card}")
    return launches


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    with tempfile.TemporaryDirectory() as tmp:
        ptxas_proc = start_ptxas(Path(tmp))
        t0 = time.perf_counter()
        _lib.build()
        log(f"build: {len(_lib.SOURCES)} kernels in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        native.build()
        log(f"build: the host C++ (rasterizers, PNG and TIFF decoders, g++) in "
            f"{time.perf_counter() - t0:.2f} s")
        ptxas = ptxas_report(ptxas_proc)

    with tf32(False):  # the serving phases, as their numbers in PERF.md were taken
        errors = check_kernels()
        check_uncertainty_past_2_31()
        totals = time_kernels()
        for kernel, host in time_host_dispatch().items():
            totals[kernel].update(host)
        with tempfile.TemporaryDirectory() as tmp:
            launches, ips = serve(Path(tmp))

    errors.update(check_loss_kernels())
    check_loss_kernels_past_2_31()
    loss_times = time_loss_kernels()
    totals.update(loss_times[TRAIN_BATCH, 256, 1.0])  # the stage-4 train step's call
    with tempfile.TemporaryDirectory() as tmp:
        trainer, batch, train_launches, train_ips = train_progressive(Path(tmp))
        fused_vs_plain(trainer, batch)
        del trainer, batch
    torch.cuda.empty_cache()
    gpu_vs_cpu()
    log(f"train (synthetic disks): loss launches {json.dumps(train_launches)}")
    with tempfile.TemporaryDirectory() as mon_tmp:  # phase 9's tree, read again in phase 12
        mon_launches, mon_epoch, mon_host = train_monuseg(Path(mon_tmp))
        cli_launches, native_errors, cli_times = monuseg_command_lines(
            Path(mon_tmp), Path(mon_tmp) / "MoNuSeg", ptxas)
        launches.update(mon_launches)  # the loss kernels: MoNuSeg training
        for kernel in SERVING_KERNELS:  # and the evaluator's launches
            launches[kernel] += cli_launches[kernel]
            errors[kernel] = max(errors[kernel], native_errors[kernel])
        with tempfile.TemporaryDirectory() as tmp:
            herlev_launches, herlev_error, herlev_times = herlev(Path(tmp), ptxas)
        launches["fused_double_conv"] += herlev_launches  # Herlev evaluation and serving
        errors["fused_double_conv"] = max(errors["fused_double_conv"], herlev_error)
        torch.cuda.empty_cache()
        with tf32(False), tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            stack_launches, stack = serving_stack(Path(tmp), Path(mon_tmp) / "MoNuSeg")
            log(f"serving stack: phase 12 in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        with tf32(False), tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            int8_launches, int8 = int8_serving(Path(tmp))
            log(f"int8: phase 13 in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:  # phase 9's tree for the command line
            t0 = time.perf_counter()
            pipe_launches, phase14 = options_and_pipeline(Path(tmp), Path(mon_tmp) / "MoNuSeg")
            log(f"remat and pipeline: phase 14 in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # phase 10's tree and trained checkpoint for test_monuseg --mesh
        mesh_launches, phase15 = mesh_serving(Path(mon_tmp), Path(mon_tmp) / "MoNuSeg", card)
        torch.cuda.empty_cache()
        train_mesh_launches, train_mesh_errors, phase16 = mesh_training(
            Path(mon_tmp), Path(mon_tmp) / "MoNuSeg", card)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            group_launches, group_errors, phase17 = groups_and_processes(
                Path(tmp), Path(mon_tmp) / "MoNuSeg", card)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            scan_launches, scan_errors, phase18 = whole_epochs(
                Path(tmp), Path(mon_tmp) / "MoNuSeg", card)
            log(f"whole epochs: phase 18 in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        with tf32(False), tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            msgpack_launches, phase19, phase19_files = msgpack_checkpoints(
                Path(tmp), Path(mon_tmp) / "MoNuSeg", card)
            log(f"JAX checkpoint forms: phase 19 in {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            conversion_launches = pth_conversions(Path(tmp), Path(mon_tmp) / "MoNuSeg",
                                                  phase19_files, card)
            log(f".pth conversions: phase 20 in {time.perf_counter() - t0:.1f} s")
    for kernel in SERVING_KERNELS:  # the artifacts' and the HTTP server's; the int8 path's
        launches[kernel] += stack_launches[kernel] + int8_launches[kernel]
    # the int8 path is the bf16-taps instance's main path; the pipeline's epoch, the loss
    # kernels' (beside MoNuSeg training's)
    launches["upsample2x_bf16_taps"] = int8_launches["upsample2x_bf16_taps"]
    for kernel in LOSS_KERNELS:
        launches[kernel] += pipe_launches[kernel]
    totals["upsample2x_bf16_taps"] = phase14["bf16_taps"]
    errors["upsample2x_bf16_taps"] = 0.0  # bit for bit (phase 14), asserted
    # conv3x3: the sharded forwards', the column-parallel Predictor's and test_monuseg
    # --mesh's launches; timed over one shard's 18 convs of the 2 x 1 grid at 1024 px
    launches["conv3x3"] = mesh_launches["conv3x3"]
    totals["conv3x3"] = phase15["spatial"]["conv3x3_one_shard"]
    errors["conv3x3"] = phase15["conv3x3_max_abs_err"]
    # phase 16: the frozen stage's conv3x3 per shard of the spatial steps and the native
    # fine-tune; the loss kernels per data shard of the mesh trainers and the spatial steps
    for kernel, n in train_mesh_launches.items():
        launches[kernel] += n
    for kernel, err in train_mesh_errors.items():
        errors[kernel] = max(errors[kernel], err)
    # phase 17: the loss kernels per train data shard of the pipeline's 2 x 2 mesh, and
    # once in each of the two processes
    for kernel, n in group_launches.items():
        launches[kernel] += n
    for kernel, err in group_errors.items():
        errors[kernel] = max(errors[kernel], err)
    # phase 18: one loss forward and backward per step of the whole-epoch path, replayed
    # from a CUDA graph, held on a replayed step's own inputs
    for kernel, n in scan_launches.items():
        launches[kernel] += n
    for kernel, err in scan_errors.items():
        errors[kernel] = max(errors[kernel], err)
    # phase 19: a bucket-64 call of the Predictor read from each JAX checkpoint directory,
    # and the loss kernels of the training command resumed from each form
    for kernel, n in msgpack_launches.items():
        launches[kernel] += n
    # phase 20: the Predictor calls from the exported .pth files, test_monuseg on the imported
    # directory and its .pth, test_herlev on the exported classifier and its directory
    for kernel, n in conversion_launches.items():
        launches[kernel] += n

    rows = []
    for kernel, (source, replaces) in KERNELS.items():
        t = totals[kernel]
        bound = max(t["bytes_ms"], t["ops_ms"])
        rows.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kernel], "max_abs_err": errors[kernel],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
            "library_ms": t["library_ms"],
            **{key: t[key] for key in ("device_ms", "host_us", "host_us_wrapper",
                                        "host_us_operator", "float32_taps_ms") if key in t},
        })
        if kernel == "fused_double_conv":  # one stage-4 forward's double convs
            for key, dc in (("float32_native_1008", cli_times["double_conv_f32_1008"]),
                            ("float32_stage_256_batch8", cli_times["double_conv_f32_256"]),
                            ("herlev_bf16_224_batch64", herlev_times["double_conv_bf16_64"]),
                            ("herlev_float32_224_batch16", herlev_times["double_conv_f32_16"])):
                rows[-1][key] = {
                    "ms": dc["ms"], "plain_ms": dc["plain_ms"], "library_ms": dc["library_ms"],
                    "bound_ms": max(dc["bytes_ms"], dc["ops_ms"]),
                    "bound_by": "bytes" if dc["bytes_ms"] >= dc["ops_ms"] else "operations"}
    log(f"serving: {ips:.2f} images/s, stage 4, bucket 64, bf16 on {card}")
    log(f"training: images/s at batch {TRAIN_BATCH}, epoch 2 of each stage: "
        + ", ".join(f"stage {s} {v[-1]:.2f}" for s, v in train_ips.items()) + f" on {card}")
    log(f"monuseg training: images/s at batch {TRAIN_BATCH} (augmented, 1 epoch of "
        f"{AUG_PATCHES}), and ms per step waiting on the prefetch queue: "
        + ", ".join(f"stage {s} {v['images_per_s']:.2f} ({v['wait_ms_per_step']:.3f} ms)"
                    for s, v in mon_epoch.items())
        + f"; host per batch of 8 (4 threads): stage 1 "
        f"{mon_host[1]['loader_ms_per_batch']:.2f} ms, stage 4 "
        f"{mon_host[4]['loader_ms_per_batch']:.2f} ms on {card}")
    dc = cli_times["double_conv_f32_1008"]
    log(f"monuseg evaluation: native {cli_times['native_s_per_tile']:.4f} s per {TILE_PX} px tile "
        f"(forward {cli_times['native_forward_ms']:.2f} ms), stage resolution "
        f"{cli_times['stage_res_images_per_s']:.2f} images/s; float32 double conv per stage-4 "
        f"forward at {NATIVE_PX} px {dc['ms']:.3f} ms, cuDNN {dc['library_ms']:.3f} ms, bound "
        f"{max(dc['bytes_ms'], dc['ops_ms']):.3f} ms; at 256 px, batch {TRAIN_BATCH} "
        f"{cli_times['double_conv_f32_256']['ms']:.3f} ms, cuDNN "
        f"{cli_times['double_conv_f32_256']['library_ms']:.3f} ms on {card}")
    hc = herlev_times
    log(f"herlev: serving {hc['images_per_s']:.2f} images/s at bucket 64, bf16; bucket-1 latency "
        f"median {hc['latency']['median_ms']:.3f} ms (p10 {hc['latency']['p10_ms']:.3f}, p90 "
        f"{hc['latency']['p90_ms']:.3f}); train images/s at batch {HERLEV_BATCH} (median of "
        f"{HERLEV_TIMED_EPOCHS} epochs; the loader alone; ms of the step alone): "
        + ", ".join(f"stage {s} {v['images_per_s']:.2f} ({v['loader_images_per_s']:.2f}; "
                    f"{v['step_alone_ms']:.2f} ms)"
                    for s, v in hc["train_images_per_s"].items())
        + f"; stage-4 double convs {hc['double_conv_bf16_64']['ms']:.3f} ms at bucket 64 bf16 "
        f"(cuDNN {hc['double_conv_bf16_64']['library_ms']:.3f}), "
        f"{hc['double_conv_f32_16']['ms']:.3f} ms at batch 16 float32 (cuDNN "
        f"{hc['double_conv_f32_16']['library_ms']:.3f}) on {card}")
    lat = stack["http"]["latency"]
    log(f"serving stack: bucket 64 float32 images/s, live {stack['images_per_s']['live']:.2f}, "
        f"exported {stack['images_per_s']['artifact']:.2f}; HTTP latency on localhost (median / "
        "p90 of 50, ms): " + ", ".join(f"{k} {v['median_ms']:.3f} / {v['p90_ms']:.3f}"
                                       for k, v in lat.items())
        + f"; {HTTP_CONCURRENT} concurrent single images in "
        f"{stack['http']['coalescing']['device_calls']} device calls; augment_monuseg "
        f"{stack['tools']['patches_per_s']:.2f} patches/s on {card}")
    ips = {b: {k: v["median"] for k, v in d.items()} for b, d in int8["images_per_s"].items()}
    split = int8["split"]
    log(f"int8 serving, images/s (median of {QUANT_TIMED}, in turns with bf16): stage 4 bucket 64 "
        f"int8 {ips[64]['int8']:.2f} vs bf16 {ips[64]['bf16']:.2f}, bucket 128 int8 "
        f"{ips[128]['int8']:.2f} vs bf16 {ips[128]['bf16']:.2f}; Herlev bucket 64 int8 "
        f"{int8['herlev_images_per_s']['int8']['median']:.2f} vs bf16 "
        f"{int8['herlev_images_per_s']['bf16']['median']:.2f}; a bucket-64 call's device ms: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split["ms"].items())
        + f", idle {split['idle_share']:.1%}; peak {int8['peak_gib_128']['peak']:.2f} GiB at "
        f"bucket 128 on {card}")
    remat, pipe = phase14["remat"], phase14["pipeline"]
    log("remat (float32, full width): "
        + "; ".join(f"{task} peak {r['plain']['peak_gib']:.3f} -> {r['remat']['peak_gib']:.3f} "
                    f"GiB, step {r['plain']['step_ms']:.2f} -> {r['remat']['step_ms']:.2f} ms"
                    for task, r in remat.items())
        + f"; pipeline at stage 4, batch {TRAIN_BATCH}: images/s pipelined "
        f"{pipe['images_per_s']['pipelined']['median']:.2f} vs fused "
        f"{pipe['images_per_s']['fused']['median']:.2f}, idle "
        f"{pipe['idle']['pipelined']['idle_share']:.1%} vs "
        f"{pipe['idle']['fused']['idle_share']:.1%}; bf16-taps upsample "
        f"{phase14['bf16_taps']['ms']:.4f} ms per forward at bucket {TIME_BATCH} (float32 taps "
        f"{phase14['bf16_taps']['float32_taps_ms']:.4f}) on {card}")
    spatial = phase15["spatial"]
    log("mesh (one card named twice: the halo and gather overhead, not scaling): "
        + "; ".join(f"{label} grid {v['ms']:.3f} ms against {v['unsharded_ms']:.3f} unsharded, "
                    f"peak {v['peak_gib']:.3f} against {v['unsharded_peak_gib']:.3f} GiB, "
                    f"max|d| {v['max_abs_err']:.3e}, bf16 gap {v['bf16_max_abs_gap']:.3e}"
                    for label, v in spatial.items() if label != "conv3x3_one_shard")
        + f"; Predictor max|d| {json.dumps(phase15['predictors'])} on {card}")
    trainers, spatial = phase16["trainers"], phase16["spatial"]
    log("mesh training (one card named 2 or 4 times: the overhead, not scaling): trainer images/s "
        + "; ".join(f"{label} {v['mesh_images_per_s']:.2f} against {v['unsharded_images_per_s']:.2f}"
                    for label, v in trainers.items())
        + "; spatial stage-4 step at " + str(SPATIAL_PX) + " px "
        + "; ".join(f"{label} {v['s_per_step']:.4f} s against {v['unsharded_s_per_step']:.4f}, "
                    f"peak {v['peak_gib']:.3f} against {v['unsharded_peak_gib']:.3f} GiB"
                    for label, v in spatial.items()) + f" on {card}")
    groups, processes = phase17["groups"], phase17["processes"]
    log(f"pipeline groups and processes (one card: the overhead, not scaling; NCCL not "
        f"measured): pipeline on [{DEV}] * {GROUP_DEVICES} images/s "
        f"{groups['images_per_s']['pipelined']['median']:.2f} against the fused steps' "
        f"{groups['images_per_s']['fused']['median']:.2f}, step 0 max rel err "
        f"{groups['step0_max_rel_err']:.2e} (Herlev {groups['herlev_step0_max_rel_err']:.2e}); "
        f"two gloo processes step 0 max rel err {processes['step0_max_rel_err']:.2e}, BN stats "
        f"max|d| {processes['bn_stats_max_abs_err']:.2e} on {card}")
    seg, herlev_scan = phase18["segmentation"], phase18["herlev"]
    log(f"whole epochs (scan_epochs; CUDA graph replays against per-step epochs, stage 4, batch "
        f"{TRAIN_BATCH}, float32): " + "; ".join(
            f"{label}: images/s " + ", ".join(
                f"{k} {v['images_per_s']['median']:.2f}" for k, v in seg[label]["speed"].items())
            + ", idle " + ", ".join(
                f"{k} " + ("not measured" if v["idle_share"] is None
                           else format(v["idle_share"], ".1%"))
                for k, v in seg[label]["idle"].items())
            + f", host us per replay() {seg[label]['speed']['scan']['host_us_per_replay']:.1f}"
            for label in ("stage1", "augmented", "plain"))
        + f"; capture s {json.dumps(seg['capture_s'])}; agreement "
        f"{json.dumps(seg['agreement'])}; Herlev {json.dumps(herlev_scan)} on {card}")
    log("checkpoints (a full-width stage-4 _last, median seconds): " + "; ".join(
        f"{form} {v['bytes']} bytes, save {v['save_s']:.4f}"
        + (f", returns {v['return_s']:.4f}" if "return_s" in v else "")
        + f", restore {v['load_s']:.4f}" for form, v in phase19.items()) + f" on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
