"""Smoke run of the PyTorch/CUDA port (`gauspcc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline FILE] [--baseline-rans FILE]
    python3 chip_smoke.py --decode BIN|BINB --out NPY [--weights NPZ]
    python3 chip_smoke.py --decode-scene DIR

Phases, each printed with its wall time; any failure ends the run with a
non-zero exit and no result line:

  device  the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  build   nvcc builds every kernel of the port from gauspcc_tpu_torch/csrc,
          one nvcc per source, all started together, beside g++ building the
          host arithmetic coder (csrc/ac_coder.cpp) and the packed-map
          code (csrc/neighbor.cpp); ptxas registers, shared memory and
          spills per kernel
  kernel  the tile-blend kernel against its plain PyTorch version on random
          tiles at K = 1024 (empty tiles, short ones, tiles over K); the
          backward kernel against autograd of the plain version, for a
          seeded upstream gradient, on those tiles and on random tiles at
          K = 256, within gradient_tolerance; both on thin Gaussians near 45
          degrees whose alpha lies at the 1/255 cut (cut_lists); K3's backward
          (the hash grid's table gradient) against its plain version at the
          HAC training cell's shape (262,144 points: 159,990 anchors and the
          bucket's padding rows at anchor 0, HACConfig's four tables), within
          kernel_grad_tolerance of the exact gradient (a dropped chunk of
          the longest row must lie outside it) and bit-identical over two
          calls, timed beside its byte bound, the sort before it, the plain
          version and autograd's index_put_ with accumulation (the call it
          replaces)
  scene   the r5 soak scene (512x512, textured, white background, 6,000
          ground-truth Gaussians, 24 orbit cameras, 30,000 seed points)
          built on the card, ground truth rendered by the port
  serve   a seeded, untrained HAC state at the full HACConfig width served
          through `pipeline.evaluate` on the 3 held-out views (K = 1024, D
          from select_eval_d capped at 128); the kernel's launches in that
          run are counted, and one whole frame is blended by both the
          kernel and the plain version and compared; then each stage of a
          view is timed alone, and one whole view by wall clock, by CUDA
          events, for its host syncs and under torch.profiler (device busy
          time, idle share, longest kernels). At the frame's lists it also
          prints the kernel's launch shape, the per-tile load, the SFU's
          exp term beside the bound, and the device time of each of the
          two kernels a call launches (order_kernel, blend_kernel) under
          torch.profiler
  train   `soak.train` on the same scene at the full HACConfig width, 600
          steps with the soak's compressed phase schedule (phases 0, 1, 2)
          and densification at steps 100, 200 and 300: the loss per phase,
          the anchors after each densification, the raster caps, the
          non-finite gradient count, both kernels' launches and K3's
          backward launches (more than 0: phase 2 trains the grid); checks a
          finite loss falling in phase 0, bits per parameter > 0 in phase
          2, and a held-out PSNR above the serve phase's. Then a step at
          phases 0 and 2 by wall clock, CUDA events and torch.profiler, its
          host syncs; on one training frame's lists, both kernels against
          their plain versions, timed beside their bounds, the backward's
          global atomics and its time with only the longest list kept; and
          the forward re-timed on trained lists at K = 1024
  scene codec  HAC's scene bitstream on the trained state, with the
          GausPcgc weights the r5 soak coded its anchors with
          (model/gauspcgc/best_model.npz): estimate_final_bits per
          component; conduct_encoding twice (the second must write the same
          sizes), timed and split into the anchors' codec, the context (CUDA
          events) and the host coder, with its rANS encode launches and the
          networks' bits checked against their parameter count; the state,
          the held-out views and what the decoder must give back handed to
          a fresh process (this script with --decode-scene), which decodes,
          checks anchors, masks, hash signs, feat, scaling and offsets
          exactly, evaluates the decoded state (K = 1024), counts its rANS
          decode and tile_blend launches and checks one decoded frame's blend
          against the plain version; both rANS kernels against their plain
          versions on the finest level of the anchors' cloud; the float
          state evaluated here (K = 1024), its quantised attributes against
          the decoded ones, and its PSNR with its rows in a seeded random
          order (the renderer's order sensitivity, printed); codec_delta_db
          (the float PSNR minus the decoded one) within +-0.01 dB
  hac_plus  HAC++ (`soak.train(model="hac_plus")`) on the same scene at the
          full HACPlusConfig width (feat_dim 50 in 5 chunks of 10, 10
          offsets, mlp_grid 225 wide, the full channel context), 600 steps
          as the train phase runs HAC, with the same checks (finite loss
          falling in phase 0, bits per parameter > 0 in phase 2, two
          densifications, held-out PSNR above the serve phase's), the
          channel context moved by phase 2, both kernels' launches; its
          scene stream encoded twice (the same sizes), split into anchors,
          context, chunk mixtures (CUDA events) and host coder, beside
          HAC's sizes; decoded in a fresh process (--decode-scene, the
          family read from the handoff) with every value exact, each of the
          five feature chunks too, K5 and K1 launches counted and one
          decoded frame checked against the plain blend; codec_delta_db
          printed, not held (the float eval of a HAC++ state renders
          unquantised attributes, as the JAX package's does)
  tcgs    TC-GS (`soak.train(model="tcgs")`) on the same scene at the full
          TCGSConfig width (feat_dim 50, 10 offsets, planes [3, 16, 32, 32]
          sampled 4 times an anchor in repeat mode, an 8-channel latent,
          mlp_triplane 195 -> 100 -> 175), 600 steps as the train phase
          runs HAC (the soak's schedule stops at phase 2, as the JAX
          package's does), with the same checks, the planes and
          mlp_triplane moved and the autoencoder not; the triplane
          context of a phase-2 step timed (forward, and forward with
          backward, CUDA events); then 50 steps at phase 3
          through the family's train step (lae joins the loss): finite
          loss, lae finite and positive, the autoencoder moved, both
          kernels launched; its scene stream encoded twice (the same
          sizes; mlps exactly 1,636,320 bits and the f16 latent 6,144, as
          the JAX r5 record), split into anchors, context and host coder,
          beside HAC's and HAC++'s sizes; decoded in a fresh process
          (--decode-scene) with every value exact, the f16 latent and the
          planes reconstructed from it too, K5 and K1 launches counted and
          one decoded frame checked against the plain blend;
          codec_delta_db printed, not held (a TC-GS float eval renders
          unquantised attributes, as the JAX package's does)
  cat3dgs CAT-3DGS (`soak.train(model="cat3dgs")`) on the same scene at the
          full CATConfig width (feat_dim 50 in chcm slices (25, 25), 10
          offsets, one-channel planes at 64, 128 and 256, four 16-wide ARM
          layers a plane group, mlp_attr 9 -> 100 -> 125, mlp_chcm[0] 25
          -> 100 -> 50), 600 steps as the train phase runs HAC (the soak's
          schedule stops at phase 2, as the JAX package's does), with the
          same checks, set_pca_frame once (the LOF's kept count printed),
          the planes, mlp_attr and mlp_chcm moved and the ARMs not; the
          nine planes' phase-2 rate timed (forward, and forward with
          backward, CUDA events) beside its bound; then on a copy, from
          zeroed Adam moments, 20 steps at each of phases 3, 4 and 5
          through the family's train step: phase 3 moves only the ARMs and
          its loss is the planes' rate, phase 4 everything but the planes,
          phase 5 everything; its scene stream encoded twice (the same
          sizes; mlps exactly 1,124,320 bits and arm_q.bin 13,680 bytes,
          as the JAX r5 record), split into anchors, the triplane coder,
          the context and the host coder, beside the other families'
          sizes; decoded in a fresh process (--decode-scene) with every
          value exact, the nine integer planes and each feature slice too,
          K5 and K1 launches counted and one decoded frame checked against
          the plain blend; codec_delta_db printed, not held (a CAT-3DGS
          float eval renders unquantised attributes, as the JAX package's
          does)
  reference  the whole slice at small widths on a 64x64 scene, on the card
          and through the port's CPU path, compared: ground truth, eval
          renders, and 3 training steps at phase 0
  codec   the GausPcgc geometry codec (sib engine, bf16) with the r5
          weights (model/gauspcgc_r5/best_model.npz) on bench.py's
          159,822-point cloud (a copy of `_bench_cloud`, seed 0):
          `compress_point_cloud` on the card, timed with its per-level
          geometry, context, stage-CDF and rANS times (CUDA events) and the
          rANS encode kernel's launches; `decompress_point_cloud` in a fresh
          process (this script with --decode), whose points must equal the
          cloud and whose rANS decode kernel must have launched; bpp within
          0.05 of the JAX package's 11.3381; one encode under
          torch.profiler (busy, idle share, longest kernels); at the finest
          level the conv GEMM's time and TFLOP/s, and both rANS kernels
          against their plain versions bit for bit, on its real tables and
          symbols and on seeded random tables (n_valid below the capacity
          and 0), each stage timed beside its byte bound and the chain
          floor: the same per-step arithmetic with every operand in
          registers (rans.encode_floor, rans.decode_floor at 3, 5 and 17
          columns), 1,280 steps a lane
  codec_train  GausPcgc codec training at the full NetConfig(32, 5, bf16):
          the corpus the JAX package's r5 codec trained on
          (data/pcc_corpus_r4, kept off the card) regenerated by the port's
          `synth` (seed 7, 48 clouds; seed 1234, 8 clouds), its points
          summed against the tracked files' 8,485,509; the tracked r5
          weights' teacher-forced val bpp (full-precision GEMMs) within
          0.05 of the JAX record's 10.6988; `train.train` from init (seed
          11) on <= 150,000-point KD patches for 150 steps, validating at
          75 and 150 (and the init at 0), the val bpp at 150 below the
          init's, the train bpp every 10 steps, the first step's seconds
          and the peak memory; on one patch, its geometry's host time and
          cached steps of a copy of the trained network by wall clock, by
          CUDA events, for their host syncs and under torch.profiler, and
          the finest level's forward and forward-and-backward; then the
          trained best_model.npz, loaded through `convert` (JAX's keys),
          codes val cloud 0 through K5 within [0.98, 1.1] x its
          teacher-forced bits + 5,000 and a fresh process (--decode BIN
          --weights NPZ) decodes it exactly
  codec_engines  the general conv's engines with the r5 weights at
          NetConfig(32, 5, bf16): the bench cloud through engine 6
          (host-built geometry: csrc/neighbor.cpp's packed maps) and engine
          7 (device-built geometry), each encoded twice (the second timed,
          points/s, bits, bpp within 0.05 of the codec phase's sib bpp, peak
          memory, K5 launches, per level its geometry, context, stage-CDF
          and rANS ms by CUDA events and, for engine 6, the host ms of the
          native map code and the packed maps' bytes; one encode under
          torch.profiler: busy, idle share, longest kernels) and decoded in a
          fresh process (--decode) exactly, with the host syncs of a decode
          (engine 7's exactly one, on the final coordinates, whatever the
          number of levels); bench.py:179-191's eight seeded clouds as one
          merged .binb in engines 5, 6 and 7, each below 1.1 x the bits of
          the eight single streams, timed beside them, decoded in a fresh
          process (--decode of the .binb) with every cloud exact; then
          `train.pyramid_batches` (the legacy levels) against
          `pyramid_batches_sib` on the bench cloud, in float32 (total
          teacher-forced bits within 1e-4 relative, every leaf's gradient
          within 1e-3 of its norm) and in bf16 (bits within 1e-3 of the
          sib levels'; every legacy leaf's gradient within 5e-2 of the
          float32 one; the leaves' distance from the sib levels' bf16
          gradients is printed, not checked), the finest level's forward
          and forward-and-backward ms (CUDA events) and peak memory of
          each in bf16
  dp      data parallelism on the trained HAC state at full width (the
          train phase's, white background): (a) this process as the one
          rank of an NCCL group: at phases 0 and 2 a DP scene step and
          make_train_step's body from the same state, camera and noise,
          every gradient, moment and statistic leaf held within 2x the
          spread of five single steps (K1's backward sums by atomics) plus
          1e-6 of the leaf's largest value; (c) the DP codec step at
          NetConfig(32, 5, bf16) with the r5 weights on a KD patch of the
          bench cloud at the codec trainer's patch size (150,000 points),
          packed at printed capacities that fit it (and what the default
          schedule does with it), held the same way against
          `dp.patch_gradients`; (d) 20 phase-2 DP steps timed against
          make_train_step in turns (CUDA events), the all-reduce of the
          step's gradients under `profiling.PhaseTimer` and torch.profiler,
          its bytes, `device_memory_stats()`; (b) two spawned gloo ranks on
          the one card (NCCL refuses two ranks on one device) with CUDA
          tensors: a DP scene step on two cameras against the mean of two
          single steps' gradients and the sum of their increments, the
          ranks' leaves bitwise equal, and (c) the DP codec step on two
          patches against the mean of their gradients; (e) resume:
          `soak.train` 100 steps straight (twice), 50 with a snapshot
          (`stop_at`), every tensor of the snapshot reloaded exactly and
          its generator, rng, order and caps those of the straight run's
          snapshot at 50, then a resume to 100 whose anchors, caps, camera
          order and generator states equal the straight run's, whose
          trained fields drift from it at most 2x as far as the second
          straight run's, held-out PSNR printed; and the step after a
          snapshot, straight and resumed three times, every leaf, moment
          and statistic held within 2x the resumed runs' spread plus 1e-6
          of its largest value; then `python -m
          gauspcc_tpu_torch.parallel.dryrun
          --ranks 1 --backend nccl --device cuda`; K1's launches counted
  tools   on the train phase's HAC state and scene: (a) `evaluate` with
          `out_dir` on the 3 held-out views at K = 1024: a file per view
          (.npy where PIL is missing, else .png) equal to the view's render
          on the host, the LPIPS surrogate finite and positive per view and
          its variant "vgg_random_v1", view 0's LPIPS against the same
          module's on the CPU within 1e-4 relative, LPIPS ms per view (CUDA
          events); (b) a viewer on localhost served by 3 steps of
          `train_scene(gui=)` on the scene: the frame equal to
          image_to_bytes of render_view on the state the poll saw, the
          verify string the model directory; (c) `soak_eval.main --device
          cuda` on a 20-step `soak.train` snapshot written here:
          soak_summary.json with the JAX package's keys, its sizes those of
          a second encode of the snapshot's state, its stream decoded again
          here exactly; (d) `sweep.main --device cuda` on a COLMAP scene
          written here (4 images at 64 px, 200 points), 2 lambdas,
          30 steps each: summary.json with both runs, each with a finite
          PSNR and a size; (e) the factorized coder on the card (its bytes
          equal the CPU's, its decode exact) and `sparse_conv_window` on the
          bench cloud's voxels in bf16 against `sparse_conv_apply` over
          `nmap_from_packed` of the same packed map, both timed; every
          kernel's launches in the phase counted

With --baseline FILE, an earlier tile_blend.cu is built and run on the
thin Gaussians at the cut (its values outside the tolerance are reported,
not checked). Its forward is checked against the plain version and must
give the kernel's image bit for bit on the serve frame and on the trained
frame, and is timed beside the kernel on the serve frame in turns
(baseline, kernel, kernel, baseline). Its backward is checked within
gradient_tolerance on the trained frame and timed beside the kernel's
there in turns, and with only the longest list kept. Its C interface is
PR 6's: tile_blend_forward(7 pointers, 5 ints, schedule scratch, out,
stream) and tile_blend_backward(8 pointers, 5 ints, schedule scratch, the
4 gradients, stream).

With --baseline-rans FILE, an earlier rans.cu with the same C interface
(rans_encode_stage, rans_decode_stage; for example
tests/baseline/rans_direct.cu, the first kernels, which read each step's
operands from device memory inside the chain) is built. In the codec
phase it must give the kernels' words, word counts, states, pointers,
symbols and prev, and the same packed stream, on the finest level's
tables and on every random case; each of the finest level's stages is
timed in turns (baseline, kernel, kernel, baseline) beside the kernels.

Then one JSON line per the port's kernels (launches, error, times, bound;
`launches_hac_plus`, `launches_tcgs` and `launches_cat3dgs`, each
kernel's launches on the HAC++, the TC-GS and the CAT-3DGS path:
training's for the blend kernels, TC-GS's 600 steps and 50 at phase 3,
CAT-3DGS's 600 and 20 at each of phases 3, 4 and 5, the scene encode's
and decode's for rANS; `launches_codec_train` for rANS, the trained
weights' encode and decode of the held-out cloud; `launches_codec_engines`
for rANS, the codec_engines phase's encodes and decodes; `launches_dp`,
the dp phase's, in this process and on the gloo ranks; `launches_tools`,
the tools phase's; K3's backward has no TC-GS, CAT-3DGS or codec
counts, as those paths build no hash grid: `launches` is the train
phase's 600 steps, `launches_hac_plus` HAC++'s, `launches_dp` and
`launches_tools` those phases' in this process, each counted around the
runs that count the blend kernels; its library_ms is autograd's
index_put_) and, last, {"ok": true, "device": {...}}. Nothing is
written into the tree except the builds under gauspcc_tpu_torch/build/
(gitignored); the codecs' streams, the handed-off state, the decoded
points and the tools phase's runs go to temporary directories.

With --decode BIN --out NPY it only decodes BIN (a .bin of any of the
port's engines, or a .binb batch stream, whose clouds go to NPY as the
arrays of an .npz) with the r5 weights (or the .npz given by --weights),
twice (the two must agree), saves the first decode's points to NPY and
prints one JSON line with the decode times, the per-level profile, the
launches and the host syncs of a third decode.
With --decode-scene DIR it only decodes and evaluates the scene (of any
family) that the scene codec, the hac_plus, the tcgs or the cat3dgs phase
handed off in DIR and prints one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import itertools
import json
import pickle
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gauspcc_tpu_torch import convert, native
from gauspcc_tpu_torch.cli import soak, soak_eval, sweep
from gauspcc_tpu_torch.codecs.gauspcgc import cli as pcgc_cli
from gauspcc_tpu_torch.codecs.gauspcgc import codec as pcgc_codec
from gauspcc_tpu_torch.codecs.gauspcgc import data as pcgc_data
from gauspcc_tpu_torch.codecs.gauspcgc import model as pcgc_model
from gauspcc_tpu_torch.codecs.gauspcgc import train as pcgc_train
from gauspcc_tpu_torch.core import cdf, entropy
from gauspcc_tpu_torch.core.quant import ste_multistep
from gauspcc_tpu_torch.fields import hashgrid
from gauspcc_tpu_torch.fields import triplane as tri
from gauspcc_tpu_torch.models import registry
from gauspcc_tpu_torch.models.cat3dgs import codec as cat_codec
from gauspcc_tpu_torch.models.cat3dgs import field as cat_field
from gauspcc_tpu_torch.models.cat3dgs import model as cat
from gauspcc_tpu_torch.models.cat3dgs import render as cat_render
from gauspcc_tpu_torch.models.hac import codec as hac_codec
from gauspcc_tpu_torch.models.hac import model as hac
from gauspcc_tpu_torch.models.hac import pipeline
from gauspcc_tpu_torch.models.hac import render as hac_render
from gauspcc_tpu_torch.models.hac import train as hac_train
from gauspcc_tpu_torch.models.hac_plus import codec as hacp_codec
from gauspcc_tpu_torch.models.hac_plus import model as hacp
from gauspcc_tpu_torch.models.tcgs import codec as tcgs_codec
from gauspcc_tpu_torch.models.tcgs import model as tcgs
from gauspcc_tpu_torch.ops import entropy_coding as ec
from gauspcc_tpu_torch.ops import hostmap, rans, sparse
from gauspcc_tpu_torch.parallel import dist as pdist
from gauspcc_tpu_torch.parallel import dp, dp_scene
from gauspcc_tpu_torch.render import raster, tile_blend
from gauspcc_tpu_torch.utils import checkpoint, image as img_lib, lpips
from gauspcc_tpu_torch.utils import network_gui, profiling
from gauspcc_tpu_torch.utils.scalars import ScalarLogger

SEED = 0
# r5 soak settings (gauspcc_tpu/cli/soak.py:135-147) and eval caps (runs/soak_hac_r5)
HW, N_GT, N_CAMS, N_SEED, VOXEL_SIZE = 512, 6000, 24, 30_000, 0.01
EVAL_K = 1024
# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations per pixel-entry: evaluating it (offsets 2, quadratic form
# 8, clamp + exp + opacity + cap + threshold 5), and, only for an entry with
# alpha >= 1/255, blending it (weight, 3 FMAs, transmittance, test)
EVAL_OPS_PER_ENTRY = 15
BLEND_OPS_PER_ENTRY = 10
# Hopper's SFU: 16 exp a clock per SM (one per evaluated pixel-entry)
SFU_EXP_PER_CLOCK = 16
# a delay kernel's length: the host enqueues a timed run behind it
DELAY_CYCLES = 50_000_000
# reference phase: small widths (as the CPU parity tests use) on a 64x64
# scene. GT renders (no quantisation) must agree to the kernel's tolerance
# plus REF_ATOL of float32 rounding in project; HAC renders pass through the
# STE quantiser, where a rounding tie can move one symbol, so they are held
# to a PSNR between the two renders instead.
SMALL_CFG = dict(feat_dim=16, n_offsets=4, voxel_size=0.05,
                 resolutions_3d=(6, 10, 16), resolutions_2d=(16, 32),
                 log2_hashmap_size=13, log2_hashmap_size_2d=13)
REF_ATOL = 1e-4
REF_PSNR_DB = 60.0
# gradient fp32 operations per blended pixel-entry in the backward: c . g
# (5), w and S (3), dL/dalpha (5: T c.g, G - S, 1 - alpha, the quotient),
# T (2), the colour partials (6), opacity (2), dL/dpower (1), the mean
# partials (10) and the conic's (11); the alpha is recomputed as the
# forward evaluates it (EVAL_OPS_PER_ENTRY per evaluated pixel-entry)
BWD_OPS_PER_BLENDED = 45
# bytes of the atomics of one record and warp that touched it: 9 floats
ATOMIC_BYTES_PER_WARP_RECORD = 36
# train phase: a smoke-length run of the soak at full width, with the soak's
# compressed phase schedule (600 steps: phase 0 to 300, 1 to 400, 2 after)
# and densification at steps 100, 200 and 300
TRAIN_STEPS = 600
# K3's backward at the hac.train_rd cell's shape: its anchors, its bucket
# (models/hac/model.py bucket_capacity), whose padding rows hold anchor 0
GRID_ANCHORS, GRID_BUCKET = 159_990, 262_144
TRAIN_DENSIFY = dict(start_stat=50, update_from=50, update_interval=100,
                     update_until=400)
# reference phase: training steps of the small scene at phase 0 on the card
# and on the CPU. The first step's losses differ by the blend's float32
# reordering (the kernels' tolerance, 2e-4); Adam's first steps move every
# element by about its lr whatever the size of its gradient, so an element
# whose gradient lies within that reordering of 0 may move the other way on
# the other device, which the later losses see: loss rtol 1e-3, and the
# change of mlp_color's output weight within 2% of its norm (a few of its
# 1,500 elements).
REF_TRAIN_STEPS = 3
REF_LOSS_RTOL = 1e-3
REF_LEAF_RTOL = 0.02
# codec phase: the r5 GausPcgc weights (tracked, so they reach the card)
CODEC_WEIGHTS = Path(__file__).resolve().parent / "model" / "gauspcgc_r5" / "best_model.npz"
# the JAX package's bpp on `bench.py:44` `_bench_cloud()` with these
# weights (BENCH_r05.json, TPU, bf16): a compression figure, not a time
CODEC_BPP_JAX = 11.3381
CODEC_BPP_TOL = 0.05
# codec_train phase: the corpus the JAX package's r5 codec trained on
# (data/pcc_corpus_r4, kept off the card), regenerated from its seeds: `cli
# synth --kind mixed` with seed 7, 48 clouds (train/) and seed 1234, 8
# clouds (val/); the tracked files hold 8,485,509 points together
CORPUS_TRAIN = (7, 48)
CORPUS_VAL = (1234, 8)
CORPUS_POINTS = 8_485_509
# the r5 weights' teacher-forced val bpp on those 8 clouds in the JAX
# package's record (model/gauspcgc_r5/train.log, step 400, the lowest val
# of the run, so the one best_model.npz was saved at; TPU, bf16): a
# compression figure, not a time
R5_VAL_BPP_JAX = 10.6988
R5_VAL_BPP_TOL = 0.05
# training from init (TrainConfig's seed 11, full width, its defaults but
# the validation and logging cadence) for a smoke-length run
CODEC_TRAIN_STEPS = 150
CODEC_TRAIN_VAL_EVERY = 75
CODEC_TRAIN_LOG_EVERY = 10
# the coded size of a cloud against its teacher-forced bits, as
# tests/test_gauspcgc.py:68 bounds it: [0.98 x, 1.1 x + 5,000]
CODED_LOW, CODED_HIGH, CODED_SLACK = 0.98, 1.1, 5000
# codec_engines phase: the general conv's engines within this bpp of the
# sib engine's on the bench cloud; bench.py:179-191's eight clouds (numpy
# default_rng(5); per cloud 60 centres in [0, 2500), 40,000 draws, N(0, 18),
# rounded and deduplicated) as one batch stream below 1.1 x the bits of
# their single streams (tests/test_gauspcgc.py:117); the legacy training
# levels' bf16 bits against the sib levels', and every leaf's bf16
# gradient against the float32 one (at trained weights a gradient can be a
# small remainder of cancelling sums, so two bf16 gradients are held to
# the exact one, not to each other)
ENGINE_BPP_TOL = 0.05
BATCH_SEED, BATCH_CLOUDS, BATCH_CENTRES, BATCH_DRAWS = 5, 8, 60, 40_000
BATCH_SPAN, BATCH_SIGMA = 2500, 18
BATCH_RATIO = 1.1
LEGACY_BITS_RTOL = 1e-3
LEGACY_GRAD_RTOL = 5e-2
# float32: JAX's own rule for the bits (tests/test_sibconv.py:138), and
# every leaf's gradient (the same sums in another order)
LEGACY_F32_BITS_RTOL = 1e-4
LEGACY_F32_GRAD_RTOL = 1e-3
# random tables for the rANS kernels: (capacity, valid positions)
RANS_RANDOM_CASES = ((16384, 11_111), (16384, 0), (2048, 2047))
# scene codec phase: the GausPcgc weights the r5 soak coded its anchors with
# (gauspcc_tpu/cli/soak.py:154; tracked), and the JAX package's pin on the
# PSNR the coding may cost (tests/test_hac_pipeline.py:62)
ROOT = Path(__file__).resolve().parent
SCENE_CODEC_WEIGHTS = ROOT / "model" / "gauspcgc" / "best_model.npz"
SCENE_DELTA_DB = 0.01
# tcgs phase: the steps at phase 3 after the soak's 600 (the soak's schedule
# stops at phase 2, as the JAX package's does), and the sizes TCGSConfig's
# full width must give, as the JAX r5 record (runs/soak_tcgs_r5) has them
TCGS_PHASE3_STEPS = 50
TCGS_MLP_BITS = 1_636_320
TCGS_LATENT_BITS = 6_144
# cat3dgs phase: the steps at each of phases 3, 4 and 5 after the soak's 600
# (its schedule stops at phase 2, as the JAX package's does), and the sizes
# CATConfig's full width must give, as the JAX r5 record
# (runs/soak_cat3dgs_r5) has them
CAT_LATE_STEPS = 20
CAT_MLP_BITS = 1_124_320
CAT_ARM_BYTES = 13_680
# a plane pixel's ARM: 12 -> 16, 3 x (16 -> 16 + residual), 16 -> 2, in
# multiply-adds, and the rate's fp32 operations after it (clip, exp, two
# Laplace CDFs with their expm1, the difference, floor and log2)
ARM_MACS_PER_PIXEL = 12 * 16 + 3 * 16 * 16 + 16 * 2
ARM_RATE_OPS_PER_PIXEL = 30
# dp: single steps from one state, to measure the card's run-to-run spread;
# the phases of the DP-vs-single checks; timed steps; KD patch size of the
# DP codec checks; resume at full width,
# the resumed steps after the snapshot that measure the spread of its
# first step, and how far the resumed run may drift from the straight one,
# as a multiple of a second straight run's drift (the card's atomics)
DP_SPREAD_RUNS = 5
DP_PHASES = (0, 2)
DP_TIMED_STEPS = 20
DP_PROFILED_STEPS = 5  # under torch.profiler (its trace's export is slow)
DP_PATCH_POINTS = 20_000  # the DP codec checks' KD parts (the time at the
# codec trainer's own size, data.MAX_PATCH_POINTS, is measured beside them)
RESUME_STEPS, RESUME_EVERY = 100, 50
RESUME_SPREAD_RUNS = 3
RESUME_DRIFT_FACTOR = 2.0
# the tools phase
LPIPS_CPU_RTOL = 1e-4  # the card's LPIPS of a view against the CPU's
TOOLS_GUI_STEPS = 3
TOOLS_SOAK_STEPS = 20
TOOLS_SWEEP_SCENE = (4, 64, 200)  # images, their size, points
TOOLS_SWEEP_LMBDAS = "0.004,0.0005"
TOOLS_SWEEP_STEPS = 30
TOOLS_FACT_SHAPE = (100_000, 8)  # values coded by the factorized model
# gauspcc_tpu/cli/soak_eval.py:84-93: the JAX package's summary keys (its
# evaluate's, pipeline.py:487-499, with the surrogate's LPIPS, minus
# per_view) with the size and the iteration
SOAK_SUMMARY_KEYS = {"psnr", "ssim", "eval_k", "eval_d", "lpips_surrogate",
                     "lpips_variant", "fps", "size_bits", "size_mb", "iteration"}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints the phase's wall time when it ends without an exception."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"[{self.name}] start")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"[{self.name}] ok in {time.perf_counter() - self.t0:.3f} s")
        return False


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms, host ms) per run of fn() over `reps` back-to-back runs
    after one warm-up. The runs are enqueued behind a delay kernel, so the
    card runs them without gaps however long the host takes to enqueue
    each (for a short kernel `cuda_ms` measures the host's rate of
    enqueueing); host ms is that enqueueing, by wall clock. The delay
    doubles until the card is still in it when the last run is enqueued."""
    fn()
    torch.cuda.synchronize()
    delay = DELAY_CYCLES
    for _ in range(6):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(delay)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        e1.record()
        covered = not e0.query()
        e1.synchronize()
        if covered:
            return e0.elapsed_time(e1) / reps, host
        delay *= 2
    raise RuntimeError("the delay kernel never covered the host's enqueueing")


def wall_ms(fn, reps: int) -> list[float]:
    """Host wall-clock milliseconds of each of `reps` calls of fn(), with
    the device synchronised before and after each call."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def host_syncs(fn) -> Counter:
    """Where fn() makes the host wait for the device: the Python lines of
    its synchronising CUDA operations (torch's sync debug mode), counted."""
    root = Path(__file__).resolve().parent
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = Counter()
    for w in caught:
        if "synchroniz" in str(w.message):
            path = Path(w.filename).resolve()
            name = path.relative_to(root) if path.is_relative_to(root) else path.name
            where[f"{name}:{w.lineno}"] += 1
    return where


def device_profile(fn):
    """One fn() under torch.profiler -> (busy ms, device activities, top
    kernels): busy is the union of the intervals in which a kernel, copy or
    fill ran on the card; top kernels are (name, count, ms), longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name.setdefault(e.name, []).append(
                e.time_range.end - e.time_range.start)
    top = sorted(((n, len(d), sum(d) / 1e3) for n, d in per_name.items()),
                 key=lambda t: -t[2])[:8]
    return busy_us / 1e3, len(spans), top


def hac_grid_points(seed: int, device) -> torch.Tensor:
    """Grid inputs [262,144, 3] shaped as the hac.train_rd cell's: 159,990
    seeded anchors on a sphere shell and a floor, then the bucket's padding
    rows at anchor 0, normalised by update_anchor_bound's box (the anchors'
    bounds widened by 20%)."""
    rng = np.random.default_rng(seed)
    n_shell = GRID_ANCHORS * 2 // 3
    shell = rng.standard_normal((n_shell, 3))
    shell *= (0.8 + 0.02 * rng.standard_normal((n_shell, 1))) / np.linalg.norm(
        shell, axis=1, keepdims=True)
    floor = np.concatenate([rng.uniform(-1.5, 1.5, (GRID_ANCHORS - n_shell, 2)),
                            np.full((GRID_ANCHORS - n_shell, 1), -0.9)], 1)
    anchors = np.concatenate([shell, floor]).astype(np.float32)
    lo, hi = anchors.min(0), anchors.max(0)
    lo = np.where(lo < 0, lo * 1.2, lo * 0.8)
    hi = np.where(hi > 0, hi * 1.2, hi * 0.8)
    x = np.concatenate([anchors, np.zeros((GRID_BUCKET - GRID_ANCHORS, 3),
                                          np.float32)])
    return torch.from_numpy(((x - lo) / (hi - lo)).astype(np.float32)).to(device)


def grid_slices(spec: hashgrid.MixedGridSpec, x: torch.Tensor) -> dict:
    """The mixed grid's tables as MixedTables looks them up: name -> (spec,
    the coordinates it takes from x [N, 3])."""
    return {"xyz": (spec.xyz, x), "xy": (spec.plane, x[:, 0:2]),
            "xz": (spec.plane, x[:, 0::2]), "yz": (spec.plane, x[:, 1:3])}


def grid_lookups(spec: hashgrid.MixedGridSpec, x: torch.Tensor,
                 gen: torch.Generator) -> dict:
    """Per table of the mixed grid: (its spec, idx [N, L, C] int32, w [N, L,
    C], a seeded output gradient [N, L * F] zeroed where the table's
    coordinates are out of range, as the table gradient receives it)."""
    out = {}
    for name, (s, xs) in grid_slices(spec, x).items():
        idxs, ws = zip(*hashgrid._level_lookups(s, xs))
        g = torch.randn((x.shape[0], s.output_dim), generator=gen,
                        device=x.device)
        oob = ((xs < 0.0) | (xs > 1.0)).any(-1)
        out[name] = (s, torch.stack([i.to(torch.int32) for i in idxs], 1),
                     torch.stack(ws, 1), torch.where(oob[:, None], 0.0, g))
    return out


def library_table_grad(idx, w, g, rows: int) -> torch.Tensor:
    """Autograd's table gradient as the plain encode takes it: level by
    level, index_put_ with accumulation of the terms w * g (PyTorch's
    sort-based indexing backward), into one table gradient."""
    n, levels, _ = idx.shape
    gl = g.reshape(n, levels, 1, -1)
    out = torch.zeros((rows, gl.shape[-1]), dtype=torch.float32, device=g.device)
    for lvl in range(levels):
        out.index_put_((idx[:, lvl].long(),), gl[:, lvl] * w[:, lvl, :, None],
                       accumulate=True)
    return out


def dropped_chunk_excess(idx, w, g, rows: int, got, tol) -> tuple[int, float]:
    """The power of kernel_grad_tolerance on the longest row: the exact
    gradient with the row's first CHUNK sorted lookups left out, as a K3
    that dropped a chunk would give. Returns (the row's lookups, the largest
    excess of that gradient's |diff| from K3's over the tolerance in the
    row), which must be positive."""
    keys, order = torch.sort(idx.reshape(-1), stable=True)
    counts = torch.bincount(keys.long(), minlength=rows)
    row = int(counts.argmax())
    start = int(torch.searchsorted(keys, torch.tensor(row, dtype=torch.int32,
                                                      device=keys.device)))
    w_drop = w.reshape(-1).clone()
    w_drop[order[start:start + hashgrid.CHUNK]] = 0.0
    dropped = hashgrid.table_grad_reference(idx, w_drop.view(w.shape).double(),
                                            g.double(), rows)
    return int(counts[row]), float(((dropped[row] - got[row].double()).abs()
                                    - tol[row]).max())


def check_table_grads(dev) -> dict:
    """K3's backward at the HAC training cell's shape, each of the four
    tables: bit-identical over two calls, within kernel_grad_tolerance of
    the exact gradient (the plain version in float64), and that tolerance
    tight enough to see a dropped chunk of the longest row. Times it (the
    sort and the kernel apart) beside its byte bound, the plain version and
    autograd's index_put_. Returns the four tables' sums (device ms, bytes)
    and the largest |diff| from the exact gradient."""
    lookups = grid_lookups(hashgrid.make_mixed_spec(),
                           hac_grid_points(SEED, dev),
                           torch.Generator(device=dev).manual_seed(SEED))
    totals = Counter()
    for name, (s, idx, w, g) in lookups.items():
        before = hashgrid.backward_launches
        got = hashgrid.table_grad(idx, w, g, s.n_rows)
        again = hashgrid.table_grad(idx, w, g, s.n_rows)
        torch.cuda.synchronize()
        if hashgrid.backward_launches != before + 2:
            raise RuntimeError("table_grad did not launch K3")
        if not torch.equal(got, again):
            raise RuntimeError(f"table {name}: K3's gradient differs between "
                               "two calls on the same inputs")
        exact = hashgrid.table_grad_reference(idx, w.double(), g.double(),
                                              s.n_rows)
        tol = hashgrid.kernel_grad_tolerance(idx, w, g, s.n_rows)
        diff = (got.double() - exact).abs()
        excess = float((diff - tol).max())
        # the error in units of u sum|w g|, the bound's own scale
        mags = hashgrid.table_grad_reference(idx, w.double().abs(),
                                             g.double().abs(), s.n_rows)
        in_u = float((diff / (hashgrid.F32_ULP * mags).clamp_min(1e-300)).max())
        long_n, long_excess = dropped_chunk_excess(idx, w, g, s.n_rows, got, tol)
        counts = torch.bincount(idx.reshape(-1).long(), minlength=s.n_rows)
        log(f"  K3 table {name}: {idx.numel():,} lookups into {s.n_rows:,} "
            f"rows ({int((counts == 0).sum()):,} unhit, longest run "
            f"{int(counts.max()):,}); vs exact: max |diff| "
            f"{float(diff.max()):.3e}, largest |diff| / (u sum|w g|) "
            f"{in_u:.2f}, worst excess over kernel_grad_tolerance "
            f"{excess:.3e}; one chunk of the {long_n:,}-lookup row dropped "
            f"exceeds it by {long_excess:.3e}; bit-identical over two calls")
        if not excess <= 0.0:
            raise RuntimeError(f"table {name}: K3 outside kernel_grad_tolerance")
        if not (long_n > hashgrid.CHUNK and long_excess > 0.0):
            raise RuntimeError(f"table {name}: kernel_grad_tolerance does not "
                               "see a dropped chunk of the longest row")
        totals["max_abs_err"] = max(totals["max_abs_err"], float(diff.max()))
        totals["err_in_u"] = max(totals["err_in_u"], in_u)
        keys, order = torch.sort(idx.reshape(-1), stable=True)
        times = {
            "sort": device_ms(lambda: torch.sort(idx.reshape(-1), stable=True),
                              10)[0],
            "kernel": device_ms(lambda: hashgrid.launch_table_grad(
                keys, order, w, g, s.n_rows), 10)[0],
            "table_grad": device_ms(lambda: hashgrid.table_grad(
                idx, w, g, s.n_rows), 10)[0],
            "plain": cuda_ms(lambda: hashgrid.table_grad_reference(
                idx, w, g, s.n_rows), 3),
            "library": cuda_ms(lambda: library_table_grad(idx, w, g, s.n_rows),
                               2),
        }
        # what the gradient needs, each read or written once: each lookup's
        # int32 row and weight, the output gradient, the table gradient.
        # The sorted keys (int32) and order (int64, torch.sort's) K3 reads
        # are the design's cost, outside the bound.
        nbytes = idx.numel() * (4 + 4) + g.numel() * 4 + got.numel() * 4
        totals.update(times)
        totals["bytes"] += nbytes
        log(f"  K3 table {name} (device ms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items())
            + f"; kernel bound {nbytes / 3.35e9:.4f} ms ({nbytes:,} bytes)")
    bound = totals["bytes"] / 3.35e9
    log(f"  K3 four tables (device ms): sort {totals['sort']:.4f}, kernel "
        f"{totals['kernel']:.4f} (bound {bound:.4f}, "
        f"{100 * bound / totals['kernel']:.1f}%), table_grad "
        f"{totals['table_grad']:.4f}, plain {totals['plain']:.4f}, library "
        f"(index_put_) {totals['library']:.4f}")
    return dict(totals, bound_ms=bound)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol: float) -> float:
    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: non-finite values")
    diff = (got - want).abs()
    bad = int((diff > atol + rtol * want.abs()).sum())
    max_abs = float(diff.max())
    log(f"  {name}: max |diff| = {max_abs:.3e} "
        f"(tolerance atol {atol:.3e} + rtol {rtol:g} * |reference|), {bad} outside")
    if bad:
        raise RuntimeError(f"{name}: {bad} values outside the tolerance")
    return max_abs


def random_tiles(gen: torch.Generator, device, tiles_x: int, tiles_y: int,
                 max_k: int):
    """Tile lists with empty tiles, short ones, ones up to K and ones over
    K; each tile's Gaussians lie around it, stored in shuffled order so the
    kernel's gather is a real one."""
    n_tiles = tiles_x * tiles_y

    def randint(lo, hi):
        return torch.randint(lo, hi, (n_tiles,), generator=gen)

    kind = randint(0, 4)
    half = max_k // 2 + 1
    counts = torch.where(kind == 0, 0, torch.where(
        kind == 1, randint(1, half), torch.where(
            kind == 2, randint(half, max_k + 1), randint(max_k + 1, 2 * max_k))))
    n = int(counts.sum())
    tile_of = torch.repeat_interleave(torch.arange(n_tiles), counts)
    origin = torch.stack([tile_of % tiles_x, tile_of // tiles_x], -1) * 16
    mean2d = origin.float() + torch.rand(n, 2, generator=gen) * 32 - 8
    conic = torch.stack([torch.rand(n, generator=gen) * 0.3 + 0.02,
                         (torch.rand(n, generator=gen) - 0.5) * 0.02,
                         torch.rand(n, generator=gen) * 0.3 + 0.02], -1)
    # per-tile opacity scale: faint tiles run their whole list, dense ones
    # saturate early
    opacity = (torch.rand(n_tiles, generator=gen) * 0.9 + 0.02)[tile_of] * (
        0.5 + 0.5 * torch.rand(n, generator=gen))
    colors = torch.rand(n, 3, generator=gen)
    perm = torch.randperm(n, generator=gen)

    def shuffled(v):
        out = torch.empty_like(v)
        out[perm] = v
        return out.to(device)

    tile_start = torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)])
    bg = torch.rand(3, generator=gen)
    return (tile_start.int().to(device), perm.int().to(device),
            shuffled(mean2d), shuffled(conic), shuffled(opacity),
            shuffled(colors), bg.to(device))


def cut_lists(device, tiles_x: int, tiles_y: int, seed: int = 0):
    """One thin Gaussian near 45 degrees alone in each tile, whose alpha at
    one pixel of the tile lies within a few ulps of 1/255, on both sides.

    The 2-D covariance is L u u^T + 0.3 I with u at 45 degrees (the +0.3 px
    low-pass bounds the thin axis), so the conic entries are near 1/0.6; the
    mean lies 120-160 px along u from the pixel, where the quadratic form's
    terms are about 10^4 and cancel to a power of -3 to -5. The opacity is
    set from the plain version's own exp(power) on `device`, moved by -2 to
    +2 ulps, so the plain version keeps about half of the entries and drops
    the rest."""
    rng = np.random.default_rng(seed)
    n = tiles_x * tiles_y
    tile = np.arange(n)
    target = np.stack([tile % tiles_x, tile // tiles_x], -1) * 16 + \
        rng.integers(0, 16, (n, 2))
    u = np.array([1.0, 1.0]) / np.sqrt(2.0)
    u_perp = np.array([1.0, -1.0]) / np.sqrt(2.0)
    d_par = rng.uniform(120, 160, n) * rng.choice([-1.0, 1.0], n)
    d_perp = rng.uniform(-1.0, 1.0, n)
    q = rng.uniform(6.0, 10.0, n)  # -2 * power at the pixel
    length = d_par**2 / (q - d_perp**2 / 0.3)
    cov = length[:, None, None] * np.outer(u, u)[None] + 0.3 * np.eye(2)[None]
    inv = np.linalg.inv(cov)
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    mean2d = target - d_par[:, None] * u - d_perp[:, None] * u_perp
    f32 = dict(dtype=torch.float32, device=device)
    mean_t, conic_t = torch.tensor(mean2d, **f32), torch.tensor(conic, **f32)
    # the plain version's power and exp at the pixel, on the same device
    dx = torch.tensor(target[:, 0], **f32) - mean_t[:, 0]
    dy = torch.tensor(target[:, 1], **f32) - mean_t[:, 1]
    power = -0.5 * (conic_t[:, 0] * dx * dx + conic_t[:, 2] * dy * dy
                    ) - conic_t[:, 1] * dx * dy
    e = torch.exp(torch.clamp_max(power, 0.0))
    opacity = (1.0 / 255.0) / e
    for _ in range(2):  # ulp steps from the quotient, on either side
        step = torch.tensor(rng.integers(-1, 2, n), device=device)
        opacity = torch.where(step > 0, torch.nextafter(opacity, torch.ones_like(opacity)),
                              torch.where(step < 0, torch.nextafter(
                                  opacity, torch.zeros_like(opacity)), opacity))
    colors = torch.tensor(rng.uniform(0, 1, (n, 3)), **f32)
    tile_start = torch.arange(n + 1, dtype=torch.int32, device=device)
    pair_gauss = torch.arange(n, dtype=torch.int32, device=device)
    bg = torch.tensor(rng.uniform(0, 1, 3), **f32)
    return (tile_start, pair_gauss, mean_t, conic_t, opacity, colors, bg)


def entries_per_tile(tile_start, pair_gauss, mean2d, conic, opacity, *,
                     tiles_x: int, max_k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(evaluated [T], blended [T]) pixel-entries of each tile's blend on
    these inputs: for each pixel, the entries of its tile (at most max_k)
    whose T_before is still at or above 1e-4, and of those the ones with
    alpha >= 1/255, which are blended."""
    evaluated, blended = [], []
    for _, _, alpha, t_before, _, _ in tile_blend._alpha_chunks(
            tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
        live = t_before >= tile_blend.T_MIN
        evaluated.append(live.sum((1, 2)))
        blended.append((live & (alpha > 0)).sum((1, 2)))
    empty = torch.zeros(0, dtype=torch.long, device=mean2d.device)
    return torch.cat([empty, *evaluated]), torch.cat([empty, *blended])


def entries_evaluated(tile_start, pair_gauss, mean2d, conic, opacity, *,
                      tiles_x: int, max_k: int) -> tuple[int, int]:
    """(evaluated, blended) pixel-entries of the whole blend on these
    inputs (`entries_per_tile`, summed): the data-dependent work its bound
    counts."""
    evaluated, blended = entries_per_tile(
        tile_start, pair_gauss, mean2d, conic, opacity, tiles_x=tiles_x,
        max_k=max_k)
    return int(evaluated.sum()), int(blended.sum())


def blend_bound(tile_start, pair_gauss, mean2d, conic, opacity, *, tiles_x,
                height, width, max_k):
    """(bound_ms, bound_by, detail) for one blend on these inputs: each
    input read once (tile starts, the list entries blended, the records of
    the Gaussians they name), the image written once, and the operations of
    the pixel-entries evaluated and blended, at the published peaks."""
    counts = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k).long()
    starts = tile_start[:-1].long()
    n_entries = int(counts.sum())
    first = torch.repeat_interleave(counts.cumsum(0) - counts, counts)
    idx = torch.repeat_interleave(starts, counts) + (
        torch.arange(n_entries, device=counts.device) - first)
    n_records = int(pair_gauss[idx].unique().numel())
    n_bytes = (4 * tile_start.numel() + 4 * n_entries + 36 * n_records + 12
               + 12 * height * width)
    evaluated, blended = entries_evaluated(
        tile_start, pair_gauss, mean2d, conic, opacity, tiles_x=tiles_x,
        max_k=max_k)
    ops = EVAL_OPS_PER_ENTRY * evaluated + BLEND_OPS_PER_ENTRY * blended
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    detail = (f"{n_entries} list entries, {n_records} records, {n_bytes} B; "
              f"{evaluated} pixel-entries evaluated, {blended} of them blended "
              f"({blended / max(evaluated, 1):.4f}), {ops} fp32 ops")
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", detail
    return bytes_ms, "bytes", detail


def ptxas_lines(build_log: str) -> list[str]:
    """Registers, shared memory and spills of each kernel of a build, one
    line per kernel, from nvcc's -Xptxas -v output."""
    out, name = [], "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in ("backward_kernel", "blend_kernel",
                                     "order_kernel", "encode_stage_kernel",
                                     "decode_stage_kernel", "encode_floor_kernel",
                                     "decode_floor_kernel") if k in mangled),
                        mangled)
            if "IL" in mangled:  # a template's argument, e.g. ILi17E -> <17>
                name += f"<{mangled.split('IL')[1].split('E')[0][1:]}>"
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def warp_records(tile_start, pair_gauss, mean2d, conic, opacity, *,
                 tiles_x: int, max_k: int, quadrants: bool = False) -> int:
    """Records touched per warp, summed: for each tile, entry and warp of
    the backward (4 warps of 64 pixels), whether any of its pixels blends
    the entry, which costs that warp one gradient and one warp reduction.
    The warps of PR 6's design take rows 2w, 2w + 1, 2w + 8 and 2w + 9 (PR
    6's 9 scalar atomics per warp-record are charged by backward_bound);
    with `quadrants`, warp w takes the 8x8 quadrant (w % 2, w // 2), as
    the kernel now does."""
    total = 0
    pix = torch.arange(tile_blend.PIX, device=mean2d.device)
    rows, cols = pix // tile_blend.TILE, pix % tile_blend.TILE
    warp = (rows // 8) * 2 + cols // 8 if quadrants else (rows % 8) // 2
    for _, _, alpha, t_before, _, _ in tile_blend._alpha_chunks(
            tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
        blended = (t_before >= tile_blend.T_MIN) & (alpha > 0)  # [C, 256, K]
        for w in range(4):
            total += int(blended[:, warp == w].any(1).sum())
    return total


def backward_bound(tile_start, pair_gauss, mean2d, conic, opacity, *,
                   tiles_x, height, width, max_k):
    """(bound_ms, bound_by, detail) for one backward on these inputs: each
    input read once (tile starts, the list entries, the records of the
    Gaussians they name, the image and its gradient), the gradients of those
    Gaussians written once, the atomics' bytes of the warps that touched a
    record; the operations of the alpha recompute per evaluated pixel-entry
    and of the gradient per blended one, at the published peaks."""
    counts = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k).long()
    starts = tile_start[:-1].long()
    n_entries = int(counts.sum())
    first = torch.repeat_interleave(counts.cumsum(0) - counts, counts)
    idx = torch.repeat_interleave(starts, counts) + (
        torch.arange(n_entries, device=counts.device) - first)
    n_records = int(pair_gauss[idx].unique().numel())
    touched = warp_records(tile_start, pair_gauss, mean2d, conic, opacity,
                           tiles_x=tiles_x, max_k=max_k)
    n_bytes = (4 * tile_start.numel() + 4 * n_entries + 36 * n_records
               + 24 * height * width + 36 * n_records
               + ATOMIC_BYTES_PER_WARP_RECORD * touched)
    evaluated, blended = entries_evaluated(
        tile_start, pair_gauss, mean2d, conic, opacity, tiles_x=tiles_x,
        max_k=max_k)
    ops = EVAL_OPS_PER_ENTRY * evaluated + BWD_OPS_PER_BLENDED * blended
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    detail = (f"{n_entries} list entries, {n_records} records, {touched} "
              f"warp-records touched, {n_bytes} B; {evaluated} pixel-entries "
              f"evaluated, {blended} blended, {ops} fp32 ops")
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", detail
    return bytes_ms, "bytes", detail


def check_gradients(name: str, frame, out, g, kw, got=None) -> float:
    """The backward kernel's gradients (or `got`) against autograd of the
    plain version on one set of lists, within gradient_tolerance; returns
    the largest |difference|."""
    if got is None:
        got = tile_blend.blend_tiles_backward(*frame, out, g, **kw)
    torch.cuda.synchronize()
    want = tile_blend.blend_backward_reference(*frame, g, **kw)
    tol = tile_blend.gradient_tolerance(*frame, g, **kw)
    worst = 0.0
    for part, a, b in zip(("mean2d", "conic", "opacity", "colors"), got, want):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{name} {part}: non-finite gradient")
        diff = (a - b).abs()
        bad = int((diff > tol[part]).sum())
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        log(f"  {name}, d{part}: max |diff| {float(diff.max()):.3e}, largest "
            f"|reference| {float(b.abs().max()):.3e}, median tolerance "
            f"{float(tol[part].median()):.3e}, {bad} of {diff.numel()} outside")
        if bad:
            raise RuntimeError(f"{name} d{part}: {bad} values outside "
                               f"gradient_tolerance")
    return worst


def baseline_library(path: Path):
    """An earlier tile_blend.cu, built, with PR 6's C interface:
    tile_blend_forward(7 pointers, 5 ints, schedule scratch, out, stream)
    and tile_blend_backward(8 pointers, 5 ints, schedule scratch, the 4
    gradients mean2d, conic, opacity, colors, stream)."""
    built = native.load_source(path)
    log(f"  baseline {path}: nvcc {built.seconds:.3f} s")
    for line in ptxas_lines(built.log):
        log(f"  baseline ptxas: {line}")
    lib = built.lib
    lib.tile_blend_forward.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    lib.tile_blend_forward.restype = ctypes.c_int
    lib.tile_blend_backward.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
    lib.tile_blend_backward.restype = ctypes.c_int
    return lib


def baseline_launcher(lib, frame, kw):
    """fn() -> image of the baseline's forward on the frame's lists."""
    args = [t.contiguous() for t in frame]
    n_tiles = args[0].shape[0] - 1
    sched = torch.empty(tile_blend.schedule_words(n_tiles), dtype=torch.int32,
                        device=args[0].device)

    def run():
        out = torch.empty((3, kw["height"], kw["width"]), device=args[0].device)
        rc = lib.tile_blend_forward(
            *[t.data_ptr() for t in args], n_tiles, kw["tiles_x"],
            kw["height"], kw["width"], kw["max_k"], sched.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        return out
    return run


def baseline_backward(lib, frame, out, g, kw):
    """fn() -> (mean2d, conic, opacity, colors) gradients of the baseline's
    backward for the image `out` and upstream gradient g."""
    args = [t.contiguous() for t in frame[:6]] + [out.contiguous(), g.contiguous()]
    n_tiles = args[0].shape[0] - 1
    sched = torch.empty(tile_blend.schedule_words(n_tiles), dtype=torch.int32,
                        device=args[0].device)

    def run():
        grads = [torch.zeros_like(t) for t in args[2:6]]
        rc = lib.tile_blend_backward(
            *[t.data_ptr() for t in args], n_tiles, kw["tiles_x"],
            kw["height"], kw["width"], kw["max_k"], sched.data_ptr(),
            *[t.data_ptr() for t in grads],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline backward launch failed: CUDA error {rc}")
        return tuple(grads)
    return run


def only_longest_list(frame, max_k: int):
    """The frame's lists with every tile emptied but the one with the
    longest list (at most max_k entries of it)."""
    tile_start, pair_gauss = frame[0], frame[1]
    counts = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k)
    tile = int(counts.argmax())
    start, count = int(tile_start[tile]), int(counts[tile])
    ts = torch.zeros_like(tile_start)
    ts[tile + 1:] = count
    return (ts, pair_gauss[start:start + count].contiguous(), *frame[2:])


def quadrant_reach(tile_start, pair_gauss, mean2d, conic, opacity, *,
                   tiles_x: int, max_k: int) -> torch.Tensor:
    """[entries, 4] bool over the first min(count, max_k) entries of every
    tile's list, tile by tile: the quadrants (q = (q % 2, q // 2) of 8x8)
    where quadrant_mask (tile_blend.cu) finds that the entry's alpha can
    reach 1/255, so the backward's warp of that quadrant walks it (before
    the early stop). Mirrors its bound: opacity exp(-lmin d^2 / 2) with lmin
    an underestimate of the conic's least eigenvalue and d the distance to
    the quadrant's pixels, with slack for the near-cut window."""
    counts = (tile_start[1:] - tile_start[:-1]).clamp_max(max_k).long()
    tile = torch.repeat_interleave(torch.arange(counts.numel(),
                                                device=counts.device), counts)
    first = torch.repeat_interleave(counts.cumsum(0) - counts, counts)
    entry = torch.arange(int(counts.sum()), device=counts.device) - first
    g = pair_gauss[tile_start[:-1].long()[tile] + entry].long()
    a, b, c = conic[g, 0], conic[g, 1], conic[g, 2]
    mx, my, o = mean2d[g, 0], mean2d[g, 1], opacity[g]
    x0 = (tile % tiles_x * tile_blend.TILE).float()
    y0 = (tile // tiles_x * tile_blend.TILE).float()
    lmin = (0.5 * (a + c) - torch.sqrt((0.5 * (a - c)) ** 2 + b * b)
            - 1e-5 * (a.abs() + c.abs())).clamp_min(0.0)
    dxm = torch.maximum((x0 - mx).abs(), (x0 + 15 - mx).abs())
    dym = torch.maximum((y0 - my).abs(), (y0 + 15 - my).abs())
    window = 1e-4 + 16 * tile_blend.F32_ULP * (
        0.5 * a.abs() * dxm * dxm + b.abs() * dxm * dym + 0.5 * c.abs() * dym * dym)
    room = torch.log(255.0 * o) + 2 * window + 1e-3
    reach = []
    for q in range(4):
        bx, by = x0 + (q % 2) * 8, y0 + (q // 2) * 8
        dx = torch.clamp_min(torch.maximum(bx - mx, mx - (bx + 7)), 0.0)
        dy = torch.clamp_min(torch.maximum(by - my, my - (by + 7)), 0.0)
        reach.append(0.5 * lmin * (dx * dx + dy * dy) <= room)
    return torch.stack(reach, -1)


def tile_records(tile_start, pair_gauss, mean2d, conic, opacity, *,
                 tiles_x: int, max_k: int) -> int:
    """(tile, list entry) pairs that some pixel of the tile blends: the
    backward adds each such record's block sum with one flush of
    kGradStride / 4 = 3 vector atomics."""
    total = 0
    for _, _, alpha, t_before, _, _ in tile_blend._alpha_chunks(
            tile_start, pair_gauss, mean2d, conic, opacity, tiles_x, max_k):
        total += int(((t_before >= tile_blend.T_MIN) & (alpha > 0)).any(1).sum())
    return total


def bench_cloud() -> np.ndarray:
    """A copy of bench.py:44-52 `_bench_cloud()`: an anchor-like clustered
    cloud of 159,822 voxels, seed 0."""
    rng = np.random.default_rng(0)
    centers = rng.integers(0, 4000, size=(200, 3))
    pts = centers[rng.integers(0, len(centers), 160_000)] + rng.normal(
        0, 20, (160_000, 3)
    )
    return np.unique(np.round(pts), axis=0).astype(np.int64)


def rans_stage_ms(tables, n_valid: int, words=None, syms=None,
                  reps: int = 3, coder=None) -> list[float]:
    """Device ms of each of one level's four rANS stage launches (indexed
    by stage), the encode kernel when `syms` is given, else the decode
    kernel on `words`: CUDA events around each launch, queued behind a
    delay kernel so that no event waits for the host, mean of `reps` runs
    from a fresh carry. `coder` is an (encode_stage, decode_stage) pair
    in place of the port's (`baseline_rans_coder`)."""
    encode = syms is not None
    enc_fn, dec_fn = coder or (rans.encode_stage, rans.decode_stage)
    cap = tables[0].shape[0]
    total = [0.0] * 4
    for _ in range(reps):
        if encode:
            carry = rans.enc_init(cap, device=tables[0].device)
        else:
            carry = rans.dec_init(words)
            prev = torch.zeros(cap, dtype=torch.int32, device=words.device)
        torch.cuda.synchronize()
        torch.cuda._sleep(DELAY_CYCLES // 50)
        marks = []
        for stage in ((3, 2, 1, 0) if encode else range(4)):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if encode:
                carry = enc_fn(carry, tables[stage], syms[stage], n_valid)
            else:
                carry, _, prev = dec_fn(carry, tables[stage], words, n_valid,
                                        prev, stage)
            e1.record()
            marks.append((stage, e0, e1))
        torch.cuda.synchronize()
        for stage, e0, e1 in marks:
            total[stage] += e0.elapsed_time(e1) / reps
    return total


def rans_encode_all(tables, syms, n_valid, plain: bool, coder=None):
    """The four encode stages (3..0) of one level from a fresh carry, by
    the kernel (or `coder`'s) or its plain version -> (state, n_words,
    words)."""
    carry = rans.enc_init(tables[0].shape[0], device=tables[0].device)
    step = (rans.encode_stage_reference if plain
            else (coder or (rans.encode_stage,))[0])
    for stage in (3, 2, 1, 0):
        carry = step(carry, tables[stage], syms[stage], n_valid)
    return carry


def rans_decode_all(tables, words, n_valid, plain: bool, coder=None):
    """The four decode stages (0..3) -> (state, ptr, syms per stage, prev)."""
    dec_fn = (coder or (None, rans.decode_stage))[1]
    carry = rans.dec_init(words)
    prev = torch.zeros(tables[0].shape[0], dtype=torch.int32, device=words.device)
    out = []
    for stage in range(4):
        if plain:
            carry, s = rans.decode_stage_reference(carry, tables[stage], words,
                                                   n_valid)
            prev = rans.advance_prev(prev, s, stage)
        else:
            carry, s, prev = dec_fn(carry, tables[stage], words, n_valid, prev,
                                    stage)
        out.append(s)
    return carry[0], carry[1], out, prev


def check_rans(label: str, tables, syms, n_valid: int) -> dict:
    """Both rANS kernels against their plain versions on the card, bit for
    bit: the encode's state, word counts and words (before and after the
    flush), then the decode of the packed stream (state, pointer, every
    stage's symbols, the fused prev). Returns the words (reversed, padded)
    for timing."""
    cap = tables[0].shape[0]
    got = rans_encode_all(tables, syms, n_valid, plain=False)
    torch.cuda.synchronize()
    want = rans_encode_all(tables, syms, n_valid, plain=True)
    for name, a, b in zip(("state", "n_words", "words"), got, want):
        if not torch.equal(a, b):
            raise RuntimeError(f"rans encode {label}: {name} differs from the "
                               f"plain version")
    words, n_words = rans.enc_flush(got)
    stream = rans.pack_stream(words.cpu().numpy(), n_words.cpu().numpy())
    w_np, _ = rans.unpack_stream(stream, rans.word_capacity(cap))
    dwords = torch.as_tensor(w_np, device=tables[0].device)
    dg = rans_decode_all(tables, dwords, n_valid, plain=False)
    torch.cuda.synchronize()
    dw = rans_decode_all(tables, dwords, n_valid, plain=True)
    for name, a, b in (("state", dg[0], dw[0]), ("ptr", dg[1], dw[1]),
                       ("prev", dg[3], dw[3])):
        if not torch.equal(a, b):
            raise RuntimeError(f"rans decode {label}: {name} differs from the "
                               f"plain version")
    for stage in range(4):
        if not torch.equal(dg[2][stage], dw[2][stage]):
            raise RuntimeError(f"rans decode {label}: stage {stage} symbols "
                               f"differ from the plain version")
        if not torch.equal(dg[2][stage][:n_valid], syms[stage][:n_valid]):
            raise RuntimeError(f"rans {label}: stage {stage} decodes other "
                               f"symbols than were coded")
    log(f"  rans {label}: cap {cap}, {rans.lane_count(cap)} lanes x "
        f"{cap // rans.lane_count(cap)} steps, n_valid {n_valid}, "
        f"{len(stream)} B: encode and decode kernels equal to the plain "
        f"versions bit for bit, symbols decoded")
    return {"words": dwords, "n_words": n_words, "stream_bytes": len(stream)}


def baseline_rans_coder(path: Path):
    """(encode_stage, decode_stage) on an earlier rans.cu with the same C
    interface, built: the signatures of rans.encode_stage and
    rans.decode_stage, on CUDA tensors, the carries updated in place."""
    built = native.load_source(path)
    log(f"  baseline rans {path}: nvcc {built.seconds:.3f} s")
    for line in ptxas_lines(built.log):
        log(f"  baseline ptxas: {line}")
    lib = built.lib
    c_int, ptr = ctypes.c_int, ctypes.c_void_p
    lib.rans_encode_stage.argtypes = [ptr, ptr, ptr, c_int, ptr, c_int, ptr,
                                      c_int, c_int, c_int, ptr]
    lib.rans_encode_stage.restype = c_int
    lib.rans_decode_stage.argtypes = [ptr, ptr, ptr, c_int, ptr, c_int, c_int,
                                      c_int, c_int, c_int, ptr, ptr, ptr, ptr]
    lib.rans_decode_stage.restype = c_int

    def encode(carry, table, syms, n_valid):
        state, n_words, words = carry
        lanes = state.shape[0]
        rc = lib.rans_encode_stage(
            state.data_ptr(), n_words.data_ptr(), words.data_ptr(),
            words.shape[1], table.data_ptr(), table.shape[1], syms.data_ptr(),
            table.shape[0] // lanes, lanes, n_valid,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline rans_encode_stage failed: CUDA error {rc}")
        return carry

    def decode(carry, table, words, n_valid, prev, stage):
        state, ptr = carry
        lanes = state.shape[0]
        syms, prev_out = torch.empty_like(prev), torch.empty_like(prev)
        rc = lib.rans_decode_stage(
            state.data_ptr(), ptr.data_ptr(), words.data_ptr(), words.shape[1],
            table.data_ptr(), table.shape[1], table.shape[0] // lanes, lanes,
            n_valid, stage, prev.data_ptr(), prev_out.data_ptr(),
            syms.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline rans_decode_stage failed: CUDA error {rc}")
        return (state, ptr), syms, prev_out
    return encode, decode


def check_rans_baseline(label: str, tables, syms, n_valid: int, coder) -> None:
    """The kernels against the baseline's (`coder`) on the same inputs, bit
    for bit: the encode's state, word counts and words, the packed stream,
    then the decode's state, pointer, every stage's symbols and prev."""
    cap = tables[0].shape[0]
    got = rans_encode_all(tables, syms, n_valid, plain=False)
    base = rans_encode_all(tables, syms, n_valid, plain=False, coder=coder)
    torch.cuda.synchronize()
    for name, a, b in zip(("state", "n_words", "words"), got, base):
        if not torch.equal(a, b):
            raise RuntimeError(f"rans encode {label}: {name} differs from the "
                               f"baseline's")
    streams = [rans.pack_stream(*(t.cpu().numpy() for t in rans.enc_flush(c)))
               for c in (got, base)]
    if streams[0] != streams[1]:
        raise RuntimeError(f"rans {label}: the packed stream differs from the "
                           f"baseline's")
    w_np, _ = rans.unpack_stream(streams[0], rans.word_capacity(cap))
    words = torch.as_tensor(w_np, device=tables[0].device)
    dg = rans_decode_all(tables, words, n_valid, plain=False)
    db = rans_decode_all(tables, words, n_valid, plain=False, coder=coder)
    torch.cuda.synchronize()
    pairs = [("state", dg[0], db[0]), ("ptr", dg[1], db[1]), ("prev", dg[3], db[3])]
    pairs += [(f"stage {k} symbols", dg[2][k], db[2][k]) for k in range(4)]
    for name, a, b in pairs:
        if not torch.equal(a, b):
            raise RuntimeError(f"rans decode {label}: {name} differ from the "
                               f"baseline's")
    log(f"  rans {label}, n_valid {n_valid}: words, word counts, states, "
        f"pointers, symbols, prev and the {len(streams[0])}-byte stream equal "
        f"to the baseline's")


def rans_chain_floor(tables, syms, steps: int) -> dict:
    """Device ms of the chain floor kernels, `steps` steps a lane with every
    operand in registers, on the level's first step: encode on stage 3's
    (lo, freq) of the coded symbols, dividing as the kernel does and, in
    turns with it, by u32 `/` and `%`; decode on the rows of stages 0, 2
    and 3 (3, 5 and 17 columns). -> {"encode": ms, "encode_divide": ms,
    3: ms, 5: ms, 17: ms}."""
    dev = tables[0].device
    cap = tables[0].shape[0]
    lanes = rans.lane_count(cap)
    t3 = tables[3][:lanes].to(torch.int64)
    s3 = syms[3][:lanes].to(torch.int64).clamp(0, t3.shape[1] - 2)[:, None]
    lo = t3.gather(1, s3)[:, 0]
    freq = ((t3.gather(1, s3 + 1)[:, 0] - lo) & 0xFFFF).clamp(1, 0xFFFF - 63)
    lo_freq = torch.stack([lo, freq], 1).to(torch.int32)
    carry = rans.enc_init(cap, device=dev)
    out = {}
    for divide in (True, False, False, True):  # in turns
        key = "encode_divide" if divide else "encode"
        ms = device_ms(lambda: rans.encode_floor(carry, lo_freq, steps, divide), 10)[0]
        out[key] = out.get(key, 0.0) + ms / 2
    for stage in (0, 2, 3):
        rows = tables[stage][:lanes].contiguous()
        dcarry = (torch.full((lanes,), 0x9E3779B9, dtype=torch.int64, device=dev),
                  torch.zeros(lanes, dtype=torch.int32, device=dev))
        out[rows.shape[1]] = device_ms(
            lambda r=rows, c=dcarry: rans.decode_floor(c, r, 0x5A5A, steps), 10)[0]
    return out


def random_rans_inputs(gen: torch.Generator, cap: int, dev):
    """Seeded tables (from random probabilities) and symbols, per stage."""
    tables, syms = [], []
    for n_sym in pcgc_model.STAGE_SIZES:
        logits = torch.randn((cap, n_sym), generator=gen) * 3.0
        probs = torch.softmax(logits, -1)
        tables.append(cdf.probs_to_cdf_int16(probs).to(dev))
        syms.append(torch.multinomial(probs, 1, generator=gen)[:, 0]
                    .to(torch.int32).to(dev))
    return tables, syms


def rans_bytes(tables, n_valid: int, encode: bool, words_moved: int) -> int:
    """Bytes one level's four stages must move: per valid position its
    symbol and the two table entries it needs on encode, or its whole row
    on decode (the search reads it), plus the words written or read, and on
    decode the symbols and prev written and prev read (int32 each)."""
    total = 4 * words_moved
    for stage, t in enumerate(tables):
        cap, lp = t.shape
        if encode:
            total += n_valid * (4 + 8)
        else:
            total += n_valid * 4 * lp + cap * 4 * (2 if stage == 0 else 3)
    return total


def decode_main(bin_path: str, out_path: str, weights: Path = CODEC_WEIGHTS) -> int:
    """--decode: decode `bin_path` (a .bin, or a .binb batch stream) in this
    fresh process on the card, twice (both must agree), save the first
    decode's points to `out_path` (a batch's clouds as arr_0, arr_1, ... of
    an .npz) and print one JSON line with the times, the per-level profile
    of the second, its rANS decode launches, and the host syncs of a third
    (torch's sync debug mode: where the host waits for the card)."""
    dev = torch.device("cuda")
    net = convert.load_codec_npz(weights, device=dev)
    batch = bin_path.endswith(".binb")
    decode = (pcgc_codec.decompress_point_cloud_batch if batch
              else pcgc_codec.decompress_point_cloud)
    key = "point_clouds" if batch else "point_cloud"
    t0 = time.perf_counter()
    first = decode(bin_path, net, device=dev)
    first_s = time.perf_counter() - t0
    if batch:
        with open(out_path, "wb") as f:
            np.savez(f, *first[key])
    else:
        np.save(out_path, first[key])
    rans.decode_launches = 0
    profile = []
    t0 = time.perf_counter()
    second = decode(bin_path, net, device=dev, profile=profile)
    second_s = time.perf_counter() - t0
    launches = rans.decode_launches
    if not all(np.array_equal(a, b) for a, b in
               zip(*(([r[key]] if not batch else r[key]) for r in (first, second)))):
        raise RuntimeError("two decodes of one stream in one process differ")
    syncs = host_syncs(lambda: decode(bin_path, net, device=dev))
    print(json.dumps({"first_s": first_s, "dec_s": second_s,
                      "dec_time": second["dec_time"],
                      "num_points": second["num_points"],
                      "launches": launches, "profile": profile,
                      "host_syncs": sum(syncs.values()),
                      "host_sync_lines": dict(syncs)}), flush=True)
    return 0


def decode_fresh(path: str, out: str, weights: Path = CODEC_WEIGHTS) -> dict:
    """This script's --decode of `path` in a fresh process -> its JSON line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--decode", path, "--out", out, "--weights",
                           str(weights)], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the decoding process failed (exit "
                           f"{proc.returncode}):\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    dec = json.loads(proc.stdout.strip().splitlines()[-1])
    dec["process_s"] = time.perf_counter() - t0
    return dec


def finest_level(pts: np.ndarray, net, cfg, dev):
    """The geometry, the four stage tables and the symbols of a cloud's
    finest coded level, as the codec's encode builds them."""
    levels = sparse.build_occupancy_pyramid(
        sparse.dedupe_lex(pts - pts.min(axis=0)), min_points=pcgc_codec.MIN_BASE_POINTS,
        sorted_unique=True)
    depth = len(levels) - 2
    pc, po = levels[depth]
    c_coords, c_occ = levels[depth + 1]
    with torch.no_grad(), pcgc_codec._exact_gemms():
        g = pcgc_codec._SibLevelGeometry(
            torch.as_tensor(pc, device=dev), torch.as_tensor(po.astype(np.int64), device=dev),
            c_coords.shape[0])
        cf = pcgc_codec._context_sib(net, cfg, g)
        tables, syms = pcgc_codec._encode_tables(
            net, g, cf, torch.as_tensor(c_occ.astype(np.int32), device=dev))
    return g, tables, syms


def codec_phase(dev, baseline_rans: Path | None = None) -> tuple[list[dict], float]:
    """The GausPcgc codec on the bench cloud with the r5 weights; returns
    the kernel rows of rans_encode and rans_decode and the bench cloud's
    bpp. With `baseline_rans`, an earlier rans.cu is checked and timed
    beside the kernels."""
    cfg = pcgc_model.NetConfig()
    net = convert.load_codec_npz(CODEC_WEIGHTS, cfg, device=dev)
    pts = bench_cloud()
    log(f"  bench cloud: {pts.shape[0]} points; r5 weights {CODEC_WEIGHTS.name}, "
        f"{cfg}")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "bench.bin")
        t0 = time.perf_counter()
        pcgc_codec.compress_point_cloud(pts, net, path, config=cfg, device=dev)
        log(f"  first encode (cuBLAS and kernel set-up included): "
            f"{time.perf_counter() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        rans.encode_launches = 0
        profile = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pcgc_codec.compress_point_cloud(pts, net, path, config=cfg,
                                              device=dev, profile=profile)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        enc_launches = rans.encode_launches
        log(f"  encode: {enc_s:.4f} s wall ({pts.shape[0] / enc_s:.1f} points/s), "
            f"{out['file_size_bits']} bits, bpp {out['bpp']:.4f}, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"rans_encode launches {enc_launches}")
        if enc_launches == 0:
            raise RuntimeError("the encode did not launch the rans encode kernel")
        for d, lvl in enumerate(profile):
            log(f"  encode level {d}: n_child {lvl['n_child']}, ccap {lvl['ccap']}: "
                f"geometry {lvl['geometry']:.3f} ms, context {lvl['context']:.3f} "
                f"ms, stage CDFs {lvl['cdf']:.3f} ms, rans {lvl['rans']:.3f} ms "
                f"(CUDA events)")

        # decode in a fresh process on the card
        out_npy = str(Path(tmp) / "decoded.npy")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--decode", path, "--out", out_npy],
                              capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"the decoding process failed (exit "
                               f"{proc.returncode}):\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        dec = json.loads(proc.stdout.strip().splitlines()[-1])
        got = np.load(out_npy)
        want_rows = np.unique(pts, axis=0)
        got_rows = np.unique(got.astype(np.int64), axis=0)
        if dec["num_points"] != pts.shape[0] or got.shape[0] != pts.shape[0] \
                or not np.array_equal(got_rows, want_rows):
            raise RuntimeError(f"lossy decode: {got.shape[0]} points decoded of "
                               f"{pts.shape[0]}")
        dec_launches = dec["launches"]
        log(f"  decode in a fresh process ({child_s:.3f} s with start-up): "
            f"lossless, {dec['num_points']} points; first decode "
            f"{dec['first_s']:.4f} s, second {dec['dec_s']:.4f} s wall "
            f"({pts.shape[0] / dec['dec_s']:.1f} points/s), rans_decode "
            f"launches {dec_launches}")
        if dec_launches == 0:
            raise RuntimeError("the decode did not launch the rans decode kernel")
        for d, lvl in enumerate(dec["profile"]):
            log(f"  decode level {d}: n_child {lvl['n_child']}, ccap "
                f"{lvl['ccap']}: geometry {lvl['geometry']:.3f} ms, context "
                f"{lvl['context']:.3f} ms, stage CDFs and rans "
                f"{lvl['cdf_and_rans']:.3f} ms (CUDA events)")
        log(f"  bpp {out['bpp']:.4f} against the JAX package's {CODEC_BPP_JAX} "
            f"(limit +-{CODEC_BPP_TOL})")
        if not abs(out["bpp"] - CODEC_BPP_JAX) <= CODEC_BPP_TOL:
            raise RuntimeError(f"bpp {out['bpp']:.4f} outside {CODEC_BPP_JAX} "
                               f"+- {CODEC_BPP_TOL}")

        # one encode under torch.profiler
        def encode():
            pcgc_codec.compress_point_cloud(pts, net, path, config=cfg, device=dev)
        wall = float(np.median(wall_ms(encode, 3)))
        busy, n_act, top = device_profile(encode)
        log(f"  one encode under torch.profiler: {n_act} device activities, busy "
            f"{busy:.3f} ms of a median wall clock of {wall:.3f} ms (idle share "
            f"{1 - busy / wall:.4f})")
        for name, count, ms in top:
            log(f"    {ms:9.3f} ms  {count:5d}x  {name[:100]}")

    # the finest level: the conv GEMM and both rANS kernels on its tables
    g, tables, syms = finest_level(pts, net, cfg, dev)
    with torch.no_grad(), pcgc_codec._exact_gemms():
        groups = g.c_gmapT.shape[0]
        k_dim = 27 * 8 * cfg.channels
        gen = torch.Generator(device=dev).manual_seed(SEED)
        xg = torch.randn((groups, k_dim), generator=gen, device=dev).to(torch.bfloat16)
        wm = net.target_resnet.conv.conv_matrix(torch.bfloat16)
        gemm_ms = cuda_ms(lambda: torch.matmul(xg, wm), 10)
        flop = 2.0 * groups * k_dim * wm.shape[1]
        x = torch.randn((groups * 8, cfg.channels), generator=gen, device=dev
                        ).to(torch.bfloat16)
        conv_ms = cuda_ms(lambda: net.target_resnet.conv(x, g.c_map, g.cmask8), 10)
        del xg
    log(f"  finest level: {g.n_parents} parents, {g.n_child} children (ccap "
        f"{g.ccap}), conv at G = {groups} groups: the [G, {k_dim}] x [{k_dim}, "
        f"{wm.shape[1]}] bf16 GEMM {gemm_ms:.4f} ms = {flop / gemm_ms / 1e9:.1f} "
        f"TFLOP/s ({flop / 1e12:.3f} TFLOP); one whole conv (gather, GEMM, bias, "
        f"mask) {conv_ms:.4f} ms")

    n = g.n_child
    real = check_rans("finest level's tables", tables, syms, n)
    coder = None
    if baseline_rans is not None:
        coder = baseline_rans_coder(baseline_rans)
        check_rans_baseline("finest level's tables", tables, syms, n, coder)
    gen = torch.Generator().manual_seed(SEED)
    for cap, n_valid in RANS_RANDOM_CASES:
        t_r, s_r = random_rans_inputs(gen, cap, dev)
        check_rans("random tables", t_r, s_r, n_valid)
        if coder is not None:
            check_rans_baseline("random tables", t_r, s_r, n_valid, coder)

    steps = g.ccap // rans.lane_count(g.ccap)
    enc_stage_ms = rans_stage_ms(tables, n, syms=syms)
    dec_stage_ms = rans_stage_ms(tables, n, words=real["words"])
    enc_ms, dec_ms = sum(enc_stage_ms), sum(dec_stage_ms)
    enc_plain = cuda_ms(lambda: rans_encode_all(tables, syms, n, plain=True), 2)
    dec_plain = cuda_ms(lambda: rans_decode_all(tables, real["words"], n, plain=True), 2)
    words_total = int(real["n_words"].sum())
    enc_bytes = rans_bytes(tables, n, True, words_total - 2 * rans.lane_count(g.ccap))
    dec_bytes = rans_bytes(tables, n, False, words_total)
    enc_bound = enc_bytes / PEAK_BYTES_PER_S * 1e3
    dec_bound = dec_bytes / PEAK_BYTES_PER_S * 1e3
    floor = rans_chain_floor(tables, syms, steps)
    log(f"  chain floor ({steps} steps a lane, operands in registers, device "
        f"time behind a delay, mean of 10): encode {floor['encode']:.4f} ms "
        f"({floor['encode'] / steps * 1e6:.1f} ns a step; dividing by u32 / and % "
        f"instead, in turns: {floor['encode_divide']:.4f} ms, "
        f"{floor['encode_divide'] / steps * 1e6:.1f} ns a step); decode at 3 / 5 / 17 "
        f"columns {floor[3]:.4f} / {floor[5]:.4f} / {floor[17]:.4f} ms "
        f"({floor[3] / steps * 1e6:.1f} / {floor[5] / steps * 1e6:.1f} / "
        f"{floor[17] / steps * 1e6:.1f} ns a step)")
    floors = {"rans_encode": [floor["encode"]] * 4,
              "rans_decode": [floor[t.shape[1]] for t in tables]}
    lanes = rans.lane_count(g.ccap)
    log("  ring of a launch at the finest level (ops/rans.py ring_plan, as "
        "csrc/rans.cu plans it): " + "; ".join(
            f"{'encode' if enc else 'decode'} at {lp} columns {c} steps x {n} "
            f"slots, {b} B of dynamic shared memory"
            for enc in (True, False) for lp in (3, 5, 17)
            for c, n, b in [rans.ring_plan(lanes, lp, enc)]))
    for name, per, tot, plain, bound, nbytes in (
            ("rans_encode", enc_stage_ms, enc_ms, enc_plain, enc_bound, enc_bytes),
            ("rans_decode", dec_stage_ms, dec_ms, dec_plain, dec_bound, dec_bytes)):
        log(f"  {name} at the finest level ({rans.lane_count(g.ccap)} lanes x "
            f"{steps} steps a stage): stages "
            f"{', '.join(f'{t:.4f}' for t in per)} ms (stages 0-3, CUDA events), "
            f"{tot:.4f} ms for the level ({tot / (4 * steps) * 1e6:.1f} ns a "
            f"step); plain version {plain:.3f} ms; bound {bound:.5f} ms "
            f"(bytes: {nbytes} B at 3.35 TB/s), {100 * bound / tot:.2f}% of it")
        log(f"    per stage: {', '.join(f'{t / steps * 1e6:.1f}' for t in per)} "
            f"ns a step, {', '.join(f'{t / f:.2f}' for t, f in zip(per, floors[name]))}"
            f" x the chain floor")
    if coder is not None:
        turns = []
        for who in ("baseline", "kernel", "kernel", "baseline"):
            c = coder if who == "baseline" else None
            turns.append((rans_stage_ms(tables, n, syms=syms, coder=c),
                          rans_stage_ms(tables, n, words=real["words"], coder=c)))
        for k, name in enumerate(("rans_encode", "rans_decode")):
            base = [(a + b) / 2 for a, b in zip(turns[0][k], turns[3][k])]
            kern = [(a + b) / 2 for a, b in zip(turns[1][k], turns[2][k])]
            log(f"  {name} in turns (baseline, kernel, kernel, baseline), stages "
                f"0-3: baseline {', '.join(f'{t:.4f}' for t in base)} ms "
                f"({sum(base):.4f}; {sum(base) / (4 * steps) * 1e6:.1f} ns a "
                f"step), kernel {', '.join(f'{t:.4f}' for t in kern)} ms "
                f"({sum(kern):.4f}; {sum(kern) / (4 * steps) * 1e6:.1f} ns a "
                f"step): {sum(base) / sum(kern):.2f}x; every turn "
                f"{[round(sum(t[k]), 4) for t in turns]}")
    rows.append({"name": "rans_encode", "route": "cuda",
                 "source": "gauspcc_tpu_torch/csrc/rans.cu",
                 "replaces": "gauspcc_tpu/ops/rans.py:80",
                 "launches": enc_launches, "max_abs_err": 0.0, "ms": enc_ms,
                 "plain_ms": enc_plain, "bound_ms": enc_bound,
                 "bound_by": "bytes", "library_ms": None})
    rows.append({"name": "rans_decode", "route": "cuda",
                 "source": "gauspcc_tpu_torch/csrc/rans.cu",
                 "replaces": "gauspcc_tpu/ops/rans.py:142",
                 "launches": dec_launches, "max_abs_err": 0.0, "ms": dec_ms,
                 "plain_ms": dec_plain, "bound_ms": dec_bound,
                 "bound_by": "bytes", "library_ms": None})
    return rows, out["bpp"]


def regenerate_corpus(root: Path) -> tuple[list[str], list[str]]:
    """The r5 training corpus, written by the port's `synth` generator
    under root/train and root/val; prints the host seconds and the
    points, and checks their sum against the tracked files'."""
    paths = {}
    counts = {}
    t0 = time.perf_counter()
    for split, (seed, count) in (("train", CORPUS_TRAIN), ("val", CORPUS_VAL)):
        (root / split).mkdir(parents=True)
        paths[split], counts[split] = [], []
        for i, (pts, _) in enumerate(pcgc_cli.synth_clouds(seed, count)):
            paths[split].append(str(root / split / f"synth_{i:04d}.npy"))
            np.save(paths[split][-1], pts)
            counts[split].append(pts.shape[0])
    total = sum(map(sum, counts.values()))
    log(f"  corpus regenerated on the host in {time.perf_counter() - t0:.3f} s: "
        f"train (seed {CORPUS_TRAIN[0]}) {len(counts['train'])} clouds "
        f"{counts['train']}; val (seed {CORPUS_VAL[0]}) {len(counts['val'])} "
        f"clouds {counts['val']}; {total} points in all (the tracked "
        f"data/pcc_corpus_r4: {CORPUS_POINTS})")
    if total != CORPUS_POINTS:
        raise RuntimeError(f"the regenerated corpus holds {total} points, the "
                           f"tracked one {CORPUS_POINTS}")
    return paths["train"], paths["val"]


def val_bpp(net, cfg, val) -> float:
    """Teacher-forced bpp over a WholeCloudDataset, as the trainer
    validates (one cloud's geometry on the card at a time)."""
    bits = n = 0
    for i in range(len(val)):
        b, k = pcgc_train.cloud_bits(net, cfg, val.get(i))
        bits, n = bits + b, n + k
    return bits / n


def training_records(model_dir: Path) -> tuple[list, list, float]:
    """From the trainer's own records: (step, train bpp) and (step, val
    bpp) from scalars.jsonl, and the first step's seconds from train.log."""
    rows = [json.loads(line) for line in open(model_dir / "scalars.jsonl")]
    train_bpp = [(r["step"], r["train/bpp"]) for r in rows if "train/bpp" in r]
    vals = [(r["step"], r["val/bpp"]) for r in rows if "val/bpp" in r]
    first = next(line for line in open(model_dir / "train.log")
                 if "first step done" in line)
    return train_bpp, vals, float(first.rsplit("(", 1)[1].split("s", 1)[0])


def codec_train_phase(dev) -> dict[str, int]:
    """GausPcgc codec training at full width on the regenerated r5 corpus:
    the r5 weights' val bpp against JAX's record, 150 steps from init, a
    cached step timed and profiled, then the trained weights coding a
    held-out cloud through K5 and decoding it in a fresh process. Returns
    the rANS kernels' launches of that coding."""
    cfg = pcgc_model.NetConfig()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        train_paths, val_paths = regenerate_corpus(root / "corpus")
        val = pcgc_data.WholeCloudDataset(val_paths)

        # the tracked r5 weights on the val clouds, beside the JAX record
        r5 = convert.load_codec_npz(CODEC_WEIGHTS, cfg, device=dev)
        t0 = time.perf_counter()
        with pcgc_codec._exact_gemms():
            r5_bpp = val_bpp(r5, cfg, val)
        log(f"  r5 weights ({CODEC_WEIGHTS.name}): val bpp {r5_bpp:.4f} over "
            f"{len(val)} clouds ({time.perf_counter() - t0:.3f} s, full-precision "
            f"GEMMs) against the JAX package's record {R5_VAL_BPP_JAX} (limit "
            f"+-{R5_VAL_BPP_TOL})")
        if not abs(r5_bpp - R5_VAL_BPP_JAX) <= R5_VAL_BPP_TOL:
            raise RuntimeError(f"r5 val bpp {r5_bpp:.4f} outside "
                               f"{R5_VAL_BPP_JAX} +- {R5_VAL_BPP_TOL}")
        del r5

        # training from init
        tcfg = pcgc_train.TrainConfig(model_dir=str(root / "model"),
                                      val_interval=CODEC_TRAIN_VAL_EVERY,
                                      log_interval=CODEC_TRAIN_LOG_EVERY)
        init = pcgc_model.init_net(tcfg.net, tcfg.seed).to(dev)
        t0 = time.perf_counter()
        val0 = val_bpp(init, tcfg.net, val)
        log(f"  init (seed {tcfg.seed}): val bpp {val0:.4f} "
            f"({time.perf_counter() - t0:.3f} s); {tcfg}")
        del init
        t0 = time.perf_counter()
        ds = pcgc_data.PatchDataset(train_paths, seed=tcfg.seed)
        log(f"  PatchDataset: {len(ds)} clouds read in "
            f"{time.perf_counter() - t0:.3f} s, patches of at most {ds.max_num} points")
        scalars = ScalarLogger(tcfg.model_dir, use_tensorboard=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            net = pcgc_train.train(tcfg, ds, val, max_steps=CODEC_TRAIN_STEPS,
                                   scalar_logger=scalars, device=dev)
        finally:
            scalars.close()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_run = torch.cuda.max_memory_allocated()
        train_bpp, vals, first_s = training_records(root / "model")
        log(f"  {CODEC_TRAIN_STEPS} steps in {run_s:.3f} s (validations "
            f"included), the first {first_s:.1f} s; peak device memory "
            f"{peak_run / 2**30:.2f} GiB")
        log("  train bpp: " + ", ".join(f"{k}: {v:.4f}" for k, v in train_bpp))
        log(f"  val bpp: 0: {val0:.4f}, " + ", ".join(f"{k}: {v:.4f}" for k, v in vals))
        if [k for k, _ in vals] != list(range(CODEC_TRAIN_VAL_EVERY,
                                              CODEC_TRAIN_STEPS + 1,
                                              CODEC_TRAIN_VAL_EVERY)):
            raise RuntimeError(f"validations at {[k for k, _ in vals]}")
        if not all(np.isfinite(v) for _, v in train_bpp + vals):
            raise RuntimeError("a non-finite bpp")
        if not vals[-1][1] < val0:
            raise RuntimeError(f"val bpp after {CODEC_TRAIN_STEPS} steps "
                               f"{vals[-1][1]:.4f} is not below the init's {val0:.4f}")

        # one patch: its geometry on the host clock, then cached steps of a
        # copy of the trained network (the run's weights stay as they are)
        xyz = pcgc_data.quantize_cloud(
            pcgc_data.kdtree_partition(ds.clouds[0], ds.max_num)[0])
        geo_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prepared = pcgc_train.pyramid_batches_sib(xyz, dev)
            torch.cuda.synchronize()
            geo_ms.append((time.perf_counter() - t0) * 1e3)
        batches, n_points = prepared
        log(f"  one patch ({n_points} points, {len(batches)} coded levels, "
            f"{pcgc_train._prepared_nbytes(prepared) / 2**20:.1f} MiB on the "
            f"card): its geometry {', '.join(f'{t:.3f}' for t in geo_ms)} ms "
            f"(host wall clock with a sync)")
        work = copy.deepcopy(net)
        opt = pcgc_train.make_optimizer(tcfg)
        box = {"state": opt.init(dict(work.named_parameters()))}

        def step():
            box["state"], box["bpp"] = pcgc_train.train_step(
                work, opt, box["state"], tcfg.net, None, prepared=prepared)

        torch.cuda.reset_peak_memory_stats()
        walls = wall_ms(step, 5)
        peak_step = torch.cuda.max_memory_allocated()
        ev_ms = cuda_ms(step, 5)
        busy, n_act, top = device_profile(step)
        wall = float(np.median(walls))
        syncs = host_syncs(step)
        log(f"  a cached step: {', '.join(f'{t:.3f}' for t in walls)} ms (host "
            f"wall clock with a sync, median {wall:.3f}); {ev_ms:.3f} ms (CUDA "
            f"events, mean of 5 back-to-back); peak device memory "
            f"{peak_step / 2**30:.2f} GiB; bpp {box['bpp']:.4f}")
        log(f"  one cached step under torch.profiler: {n_act} device activities, "
            f"busy {busy:.3f} ms of a median wall clock of {wall:.3f} ms (idle "
            f"share {1 - busy / wall:.4f}); host syncs "
            f"{sum(syncs.values())}: {dict(syncs)}")
        for name, count, ms in top:
            log(f"    {ms:9.3f} ms  {count:5d}x  {name[:100]}")
        fine = batches[-1]
        groups = fine.c_maps.index.shape[0] // 27

        def forward():
            pcgc_train._batch_bits(work, tcfg.net, fine)

        def forward_backward():
            pcgc_train._batch_bits(work, tcfg.net, fine)[0].backward()

        fwd_ms = cuda_ms(forward, 5)
        torch.cuda.reset_peak_memory_stats()
        fb_ms = cuda_ms(forward_backward, 5)
        peak_fine = torch.cuda.max_memory_allocated()
        work.zero_grad(set_to_none=True)
        log(f"  the finest level ({int(fine.cmask.sum())} children, {groups} "
            f"parent groups): forward {fwd_ms:.3f} ms, forward and backward "
            f"{fb_ms:.3f} ms (CUDA events, mean of 5 back-to-back); peak device "
            f"memory {peak_fine / 2**30:.2f} GiB")
        del work, box, prepared, batches, fine

        # the trained weights, through JAX's keys, code a held-out cloud
        best = root / "model" / "best_model.npz"
        trained = convert.load_codec_npz(best, cfg, device=dev)
        cloud = val.get(0)
        with pcgc_codec._exact_gemms():
            tf_bits, n_cloud = pcgc_train.cloud_bits(trained, cfg, cloud)
        path = str(root / "val0.bin")
        rans.encode_launches = 0
        out = pcgc_codec.compress_point_cloud(cloud, trained, path, config=cfg,
                                              device=dev)
        torch.cuda.synchronize()
        enc_launches = rans.encode_launches
        low, high = CODED_LOW * tf_bits, CODED_HIGH * tf_bits + CODED_SLACK
        log(f"  val cloud 0 ({n_cloud} points) coded with the trained "
            f"{best.name}: {out['file_size_bits']} bits, bpp {out['bpp']:.4f}, "
            f"teacher-forced {tf_bits:.1f} bits ({tf_bits / n_cloud:.4f} bpp; "
            f"limits {low:.1f} to {high:.1f}); encode {out['enc_time']:.3f} s, "
            f"rans_encode launches {enc_launches}")
        if not low <= out["file_size_bits"] <= high:
            raise RuntimeError("the coded size is outside its teacher-forced bounds")
        if enc_launches == 0:
            raise RuntimeError("the encode did not launch the rans encode kernel")
        out_npy = str(root / "val0.npy")
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--decode", path, "--out", out_npy,
                               "--weights", str(best)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"the decoding process failed (exit "
                               f"{proc.returncode}):\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        dec = json.loads(proc.stdout.strip().splitlines()[-1])
        got = np.unique(np.load(out_npy).astype(np.int64), axis=0)
        want = np.unique(cloud, axis=0)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError(f"lossy decode: {got.shape[0]} points of {want.shape[0]}")
        log(f"  decoded in a fresh process with {best.name}: lossless, "
            f"{dec['num_points']} points, {dec['dec_s']:.4f} s, rans_decode "
            f"launches {dec['launches']}")
        if dec["launches"] == 0:
            raise RuntimeError("the decode did not launch the rans decode kernel")
    return {"rans_encode": enc_launches, "rans_decode": dec["launches"]}


def batch_clouds() -> list[np.ndarray]:
    """A copy of bench.py:179-191's eight clouds."""
    rng = np.random.default_rng(BATCH_SEED)
    out = []
    for _ in range(BATCH_CLOUDS):
        centers = rng.integers(0, BATCH_SPAN, size=(BATCH_CENTRES, 3))
        pts = centers[rng.integers(0, len(centers), BATCH_DRAWS)] + rng.normal(
            0, BATCH_SIGMA, (BATCH_DRAWS, 3))
        out.append(np.unique(np.round(pts), axis=0).astype(np.int64))
    return out


def same_points(got: np.ndarray, want: np.ndarray) -> bool:
    got = np.unique(np.asarray(got).astype(np.int64), axis=0)
    return got.shape == want.shape and np.array_equal(got, want)


def engine_levels_report(label: str, profile: list) -> None:
    for d, lvl in enumerate(profile):
        host = (f", host geometry {lvl['host_ms']:.3f} ms (neighbor.cpp and "
                f"packing), packed maps {lvl['map_bytes']} B"
                if "host_ms" in lvl else "")
        log(f"  {label} level {d}: n_child {lvl['n_child']}, ccap {lvl['ccap']}: "
            f"geometry {lvl['geometry']:.3f} ms, context {lvl['context']:.3f} ms, "
            f"stage CDFs {lvl['cdf']:.3f} ms, rans {lvl['rans']:.3f} ms (CUDA "
            f"events){host}")


def legacy_grads(net, cfg, batches) -> tuple[float, dict]:
    """Total bits and every leaf's gradient summed over a cloud's levels."""
    net.zero_grad(set_to_none=True)
    total = 0.0
    for b in batches:
        bits, _ = pcgc_train._batch_bits(net, cfg, b)
        bits.backward()
        total += float(bits.detach())
    grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    return total, grads


def codec_engines_phase(dev, sib_bpp: float) -> dict[str, int]:
    """The general conv's engines (6: host-built geometry, 7: device-built)
    on the bench cloud, the eight-cloud batch in engines 5, 6 and 7, and
    the legacy training levels against the sib levels, at full width with
    the r5 weights. Returns the rANS kernels' launches of its coding."""
    cfg = pcgc_model.NetConfig()
    net = convert.load_codec_npz(CODEC_WEIGHTS, cfg, device=dev)
    pts = bench_cloud()
    want = np.unique(pts, axis=0)
    launches = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        for geom, version in (("host", 6), ("device", 7)):
            path = str(Path(tmp) / f"bench_{geom}.bin")
            t0 = time.perf_counter()
            pcgc_codec.compress_point_cloud(pts, net, path, config=cfg,
                                            geom=geom, device=dev)
            log(f"  engine {version} ({geom}-built geometry): first encode "
                f"(set-up included) {time.perf_counter() - t0:.3f} s")
            torch.cuda.reset_peak_memory_stats()
            rans.encode_launches = 0
            profile = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pcgc_codec.compress_point_cloud(pts, net, path, config=cfg,
                                                  geom=geom, device=dev,
                                                  profile=profile)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
            enc_launches = rans.encode_launches
            launches["rans_encode"] += enc_launches
            log(f"  engine {version} encode: {enc_s:.4f} s wall "
                f"({pts.shape[0] / enc_s:.1f} points/s), {out['file_size_bits']} "
                f"bits, bpp {out['bpp']:.4f} against the sib engine's "
                f"{sib_bpp:.4f} in this run (limit +-{ENGINE_BPP_TOL}), peak "
                f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                f"GiB, rans_encode launches {enc_launches}")
            engine_levels_report(f"engine {version} encode", profile)
            if enc_launches == 0:
                raise RuntimeError(f"engine {version}'s encode did not launch "
                                   "the rans encode kernel")
            if not abs(out["bpp"] - sib_bpp) <= ENGINE_BPP_TOL:
                raise RuntimeError(f"engine {version}'s bpp {out['bpp']:.4f} is "
                                   f"not within {ENGINE_BPP_TOL} of {sib_bpp:.4f}")
            dec = decode_fresh(path, str(Path(tmp) / f"bench_{geom}.npy"))
            if not same_points(np.load(str(Path(tmp) / f"bench_{geom}.npy")), want):
                raise RuntimeError(f"engine {version}: lossy decode")
            launches["rans_decode"] += dec["launches"]
            n_levels = len(dec["profile"])
            log(f"  engine {version} decode in a fresh process "
                f"({dec['process_s']:.3f} s with start-up): lossless, "
                f"{dec['num_points']} points; first {dec['first_s']:.4f} s, "
                f"second {dec['dec_s']:.4f} s wall ({pts.shape[0] / dec['dec_s']:.1f} "
                f"points/s), rans_decode launches {dec['launches']}; host syncs "
                f"of a decode of {n_levels} levels: {dec['host_syncs']} "
                f"{dec['host_sync_lines']}")
            for d, lvl in enumerate(dec["profile"]):
                log(f"  engine {version} decode level {d}: n_child "
                    f"{lvl['n_child']}: geometry {lvl['geometry']:.3f} ms, context "
                    f"{lvl['context']:.3f} ms, stage CDFs and rans "
                    f"{lvl['cdf_and_rans']:.3f} ms (CUDA events)")
            if dec["launches"] == 0:
                raise RuntimeError(f"engine {version}'s decode did not launch "
                                   "the rans decode kernel")
            if geom == "device" and dec["host_syncs"] != 1:
                raise RuntimeError(f"engine 7's decode waits {dec['host_syncs']} "
                                   f"times over {n_levels} levels, not once: "
                                   f"{dec['host_sync_lines']}")

            def encode():
                pcgc_codec.compress_point_cloud(pts, net, path, config=cfg,
                                                geom=geom, device=dev)
            wall = float(np.median(wall_ms(encode, 3)))
            busy, n_act, top = device_profile(encode)
            log(f"  engine {version}, one encode under torch.profiler: {n_act} "
                f"device activities, busy {busy:.3f} ms of a median wall clock "
                f"of {wall:.3f} ms (idle share {1 - busy / wall:.4f})")
            for name, count, ms in top:
                log(f"    {ms:9.3f} ms  {count:5d}x  {name[:100]}")

        # the eight clouds as one merged stream, in each engine
        clouds = batch_clouds()
        wants = [np.unique(c, axis=0) for c in clouds]
        n_total = sum(c.shape[0] for c in clouds)
        log(f"  batch: {len(clouds)} clouds (bench.py:179-191), {n_total} points")
        for geom, version in (("sib", 5), ("host", 6), ("device", 7)):
            single_bits, single_enc, single_dec = 0, 0.0, 0.0
            rans.encode_launches = rans.decode_launches = 0
            for i, c in enumerate(clouds):
                path = str(Path(tmp) / f"single_{geom}_{i}.bin")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                single_bits += pcgc_codec.compress_point_cloud(
                    c, net, path, config=cfg, geom=geom, device=dev)["file_size_bits"]
                torch.cuda.synchronize()
                single_enc += time.perf_counter() - t0
                t0 = time.perf_counter()
                dec = pcgc_codec.decompress_point_cloud(path, net, config=cfg,
                                                        device=dev)
                single_dec += time.perf_counter() - t0
                if not same_points(dec["point_cloud"], wants[i]):
                    raise RuntimeError(f"engine {version}: cloud {i} decoded lossy")
            path = str(Path(tmp) / f"batch_{geom}.binb")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pcgc_codec.compress_point_cloud_batch(clouds, net, path,
                                                        config=cfg, geom=geom,
                                                        device=dev)
            torch.cuda.synchronize()
            batch_enc = time.perf_counter() - t0
            launches["rans_encode"] += rans.encode_launches
            launches["rans_decode"] += rans.decode_launches
            dec = decode_fresh(path, str(Path(tmp) / f"batch_{geom}.npz"))
            with np.load(str(Path(tmp) / f"batch_{geom}.npz")) as z:
                got = [z[f"arr_{i}"] for i in range(len(clouds))]
            if not all(same_points(g, w) for g, w in zip(got, wants)):
                raise RuntimeError(f"engine {version}: a batch cloud decoded lossy")
            launches["rans_decode"] += dec["launches"]
            ratio = out["file_size_bits"] / single_bits
            log(f"  engine {version} batch: {out['file_size_bits']} bits "
                f"(bpp {out['bpp']:.4f}) against {single_bits} bits of the 8 "
                f"single streams ({ratio:.4f} x, limit {BATCH_RATIO}); encode "
                f"{batch_enc:.4f} s wall (singles {single_enc:.4f} s), decode in "
                f"a fresh process {dec['dec_s']:.4f} s wall, second of two "
                f"(singles here {single_dec:.4f} s); every cloud lossless; "
                f"rans launches encode {rans.encode_launches}, decode "
                f"{rans.decode_launches} + {dec['launches']}")
            if not ratio < BATCH_RATIO:
                raise RuntimeError(f"engine {version}'s batch costs {ratio:.4f} x")
            if dec["launches"] == 0 or rans.encode_launches == 0:
                raise RuntimeError(f"engine {version}'s batch coding did not "
                                   "launch both rans kernels")

    # the legacy training levels against the sib levels, in float32 (the
    # two convs' gradients must agree) and in bf16 (the codec's dtype)
    xyz = pts
    t0 = time.perf_counter()
    legacy, n_legacy = pcgc_train.pyramid_batches(xyz, cfg.kernel_size, dev)
    torch.cuda.synchronize()
    legacy_geo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sib, n_sib = pcgc_train.pyramid_batches_sib(xyz, dev)
    torch.cuda.synchronize()
    sib_geo_s = time.perf_counter() - t0
    if n_legacy != n_sib or len(legacy) != len(sib):
        raise RuntimeError("the legacy and sib levels disagree on the cloud")
    log(f"  legacy training levels (pyramid_batches, {len(legacy)} levels, "
        f"geometry {legacy_geo_s:.3f} s) against the sib levels (geometry "
        f"{sib_geo_s:.3f} s), r5 weights, the bench cloud")
    res = {}
    for dtype in ("f32", "bf16"):
        dcfg = cfg._replace(dtype=dtype)
        for label, batches in (("legacy", legacy), ("sib", sib)):
            torch.cuda.reset_peak_memory_stats()
            bits, grads = legacy_grads(net, dcfg, batches)
            res[dtype, label] = (bits, grads, torch.cuda.max_memory_allocated())
        (bl, gl, pl), (bs, gs, ps) = res[dtype, "legacy"], res[dtype, "sib"]
        rel_bits = abs(bl - bs) / bs
        limit = LEGACY_BITS_RTOL if dtype == "bf16" else LEGACY_F32_BITS_RTOL
        log(f"  {dtype}: bits {bl:.1f} vs {bs:.1f} (relative {rel_bits:.3e}, limit "
            f"{limit}); peak device memory with the backward {pl / 2**30:.2f} vs "
            f"{ps / 2**30:.2f} GiB")
        if not rel_bits <= limit:
            raise RuntimeError(f"{dtype}: the legacy levels' bits differ by "
                               f"{rel_bits:.3e}")
        # f32: legacy against sib, checked; bf16: legacy and sib each
        # against the float32 sib gradient, legacy checked, and legacy
        # against sib, printed
        g32 = res["f32", "sib"][1]
        dists = ((("legacy - sib", gl, gs, LEGACY_F32_GRAD_RTOL),)
                 if dtype == "f32" else
                 (("legacy - f32", gl, g32, LEGACY_GRAD_RTOL),
                  ("sib - f32", gs, g32, None), ("legacy - sib", gl, gs, None)))
        for what, ga, gb, glimit in dists:
            rel = {k: float((ga[k] - gb[k]).norm() / gb[k].norm().clamp_min(1e-30))
                   for k in gb}
            worst = max(rel, key=rel.get)
            log(f"    {dtype} every leaf's gradient, |{what}| / |{what.split()[-1]}|: "
                f"largest {rel[worst]:.3e} ({worst}; limit {glimit or 'none, printed'}), "
                f"median {float(np.median(list(rel.values()))):.3e}")
            log("      " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rel.items())))
            bad = [k for k, v in rel.items() if glimit is not None and v > glimit]
            if bad:
                raise RuntimeError(f"{dtype}: the legacy gradients of {bad} are "
                                   f"past {glimit} ({what})")
    del res
    for label, batches in (("legacy", legacy), ("sib", sib)):
        fine = batches[-1]

        def forward():
            pcgc_train._batch_bits(net, cfg, fine)

        def forward_backward():
            pcgc_train._batch_bits(net, cfg, fine)[0].backward()

        fwd_ms = cuda_ms(forward, 3)
        torch.cuda.reset_peak_memory_stats()
        fb_ms = cuda_ms(forward_backward, 3)
        peak = torch.cuda.max_memory_allocated()
        net.zero_grad(set_to_none=True)
        log(f"  bf16 {label} finest level: forward {fwd_ms:.3f} ms, forward and "
            f"backward {fb_ms:.3f} ms (CUDA events, mean of 3 back-to-back); "
            f"peak device memory {peak / 2**30:.2f} GiB")
    return dict(launches)


def training_report(tres) -> None:
    """The training run's loss per phase, densifications, raster caps and
    non-finite gradients; raises unless the loss is finite and falls in
    phase 0, bits per parameter are > 0 in phase 2 and at least two
    densifications ran."""
    h = tres["history"]
    for ph in (0, 1, 2):
        sel = h["phase"] == ph
        log(f"  phase {ph}: {int(sel.sum())} steps, loss mean "
            f"{h['loss'][sel].mean():.5f} (first {h['loss'][sel][0]:.5f}, "
            f"last {h['loss'][sel][-1]:.5f}), train PSNR mean "
            f"{h['psnr'][sel].mean():.3f} dB, bits per parameter mean "
            f"{h['bit_per_param'][sel].mean():.4f}")
    if not np.isfinite(h["loss"]).all():
        raise RuntimeError("non-finite training loss")
    p0 = h["loss"][h["phase"] == 0]
    log(f"  phase 0 loss: first 50 steps {p0[:50].mean():.5f}, last 50 "
        f"{p0[-50:].mean():.5f}")
    if not p0[-50:].mean() < p0[:50].mean():
        raise RuntimeError("the phase-0 loss did not fall")
    if not (h["bit_per_param"][h["phase"] == 2] > 0).all():
        raise RuntimeError("bit_per_param is not > 0 in phase 2")
    for it, info in tres["densify"]:
        log(f"  densify at step {it}: {info['n_anchors']} anchors "
            f"(+{info['n_added']} / -{info['n_pruned']}), capacity grown: "
            f"{info['recompiled']}")
    if len(tres["densify"]) < 2:
        raise RuntimeError("fewer than two densifications")
    rcfg_t = tres["rcfg"]
    log(f"  raster caps after adapt_caps: " + (", ".join(
        f"step {it}: D={d} K={k}" for it, d, k in tres["caps"]) or "unchanged")
        + f"; final D={rcfg_t.max_tiles_per_gaussian} "
        f"K={rcfg_t.max_gaussians_per_tile}")
    log(f"  non-finite gradient components over the run: "
        f"{int(h['nonfinite_grads'].sum())}")


def scene_mlp_bits(state) -> int:
    """32 bits a parameter of mlp_opacity, mlp_cov, mlp_color and mlp_grid,
    counted here apart from the codec's own `mlp_size_bits`."""
    nets = state["nets"]
    return 32 * sum(p.numel() for m in (nets.mlp_opacity, nets.mlp_cov,
                                        nets.mlp_color, nets.mlp_grid)
                    for p in m.parameters())


@torch.no_grad()
def float_eval_diagnostics(state, cfg, scene, values, index, float_psnr) -> None:
    """What could separate the float eval from the decoded one: the float
    eval's STE-quantised attributes at the coded anchors against the
    decoded ones, and the renderer's sensitivity to the anchors' row order
    (the tile sort keeps the rows' order among equal keys, and training
    keeps the rows in the coded order, `train.sort_anchors`): the float
    state's PSNR with its valid rows in a seeded random order."""
    ctx = hac.grid_mlp_split(state, cfg, hac.calc_interp_feat(
        state, cfg, hac.get_anchor(state, cfg)))
    feat_mean, scaling_mean, offset_mean = hac._live_means(state, cfg)
    a = state["anchors"]
    mask = hac.get_mask(state)[index]
    float_q = {
        "feat": ste_multistep(a["anchor_feat"], ctx["q_feat"], feat_mean)[index],
        "scaling": ste_multistep(hac.get_scaling(state), ctx["q_scaling"],
                                 scaling_mean)[index],
        "offset": ste_multistep(a["offset"], ctx["q_offsets"][:, None, :],
                                offset_mean)[index] * mask,
    }
    for name, want in float_q.items():
        diff = (values[name] - want).abs()
        log(f"  float eval's quantised {name} vs the decoded: max |diff| "
            f"{float(diff.max()):.3e}, {int((diff > 0).sum())} of "
            f"{diff.numel()} differ")
    valid = torch.nonzero(state["valid"])[:, 0]
    gen = torch.Generator().manual_seed(SEED)
    rows = torch.cat([valid[torch.randperm(valid.numel(), generator=gen).to(valid.device)],
                      torch.nonzero(~state["valid"])[:, 0]])
    shuffled = dict(state, anchors={f: t[rows] for f, t in a.items()},
                    valid=state["valid"][rows])
    res = pipeline.evaluate(shuffled, cfg, scene.test_cameras, max_k=EVAL_K,
                            white_background=True)
    log(f"  the float state with its valid rows in a seeded random order: "
        f"PSNR {res['psnr']:.4f} dB, {res['psnr'] - float_psnr:+.5f} dB from "
        f"the coded order (the renderer's order sensitivity; not checked)")


def decode_in_fresh_process(tmp: str, model: str, state, cfg, scene, values,
                            data) -> tuple[dict, float]:
    """Hand the stream in tmp/bitstreams to a fresh process (this script
    with --decode-scene): the family's name and configuration, the state,
    the held-out views and what the decoder must give back. Returns (the
    decoder's JSON line, the child's wall seconds)."""
    checkpoint.save_pytree(str(Path(tmp) / "state.npz"), state)
    with open(Path(tmp) / "cfg.json", "w") as f:
        json.dump({"model": model, "cfg": cfg._asdict()}, f)
    with open(Path(tmp) / "cams.pkl", "wb") as f:
        pickle.dump(scene.test_cameras, f)
    extra = {}
    if hasattr(state["nets"], "tables"):
        extra["hash"] = (hac.encoding_params_flat(state).detach().cpu().numpy()
                         .astype(np.int8))
    for k, v in values.items():  # a list (CAT-3DGS's planes) one per entry
        for i, t in (enumerate(v) if isinstance(v, list) else ((None, v),)):
            extra[k if i is None else f"{k}_{i}"] = t.detach().cpu().numpy()
    np.savez(Path(tmp) / "expect.npz",
             anchor=data["anchor_int"].astype(np.float32) * cfg.voxel_size,
             mask=data["mask"].cpu().numpy(), **extra)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--decode-scene", tmp],
                          capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the scene decoding process failed (exit "
                           f"{proc.returncode}):\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    for line in proc.stdout.strip().splitlines()[:-1]:
        log(f"  (decoder) {line}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), child_s


def scene_codec_phase(dev, scene, tstate, tcfg) -> dict:
    """HAC's scene bitstream on the trained state: estimate, encode, hand
    the stream to a fresh process that decodes and evaluates it, compare.
    Returns the encoded sizes."""
    pcc_cfg = pcgc_model.NetConfig()
    net = convert.load_codec_npz(SCENE_CODEC_WEIGHTS, pcc_cfg, device=dev)
    log(f"  anchors' codec: {SCENE_CODEC_WEIGHTS.relative_to(ROOT)}, {pcc_cfg}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, _ = hac_codec.estimate_final_bits(tstate, tcfg)
    torch.cuda.synchronize()
    log(f"  estimate_final_bits ({time.perf_counter() - t0:.3f} s): " + ", ".join(
        f"{k} {v:.0f} bits ({v / hac_codec.BIT2MB:.4f} MB)" for k, v in est.items()))
    with tempfile.TemporaryDirectory() as tmp:
        bs_dir = str(Path(tmp) / "bitstreams")
        t0 = time.perf_counter()
        first, _ = hac_codec.conduct_encoding(tstate, tcfg, bs_dir, net, pcc_cfg)
        log(f"  first encode (cuBLAS and kernel set-up included): "
            f"{time.perf_counter() - t0:.3f} s")
        values, prof = {}, {}
        rans.encode_launches = 0
        sizes, _ = hac_codec.conduct_encoding(tstate, tcfg, bs_dir, net, pcc_cfg,
                                              values=values, profile=prof)
        enc_launches = rans.encode_launches
        if sizes != first:
            raise RuntimeError(f"two encodes of one state differ: {first} "
                               f"vs {sizes}")
        n = values["feat"].shape[0]
        log(f"  encode: {prof['total_s']:.4f} s wall, {n} anchors: anchors "
            f"(GausPcgc) {prof['anchors_s']:.4f} s, context {prof['context_ms']:.3f} "
            f"ms (CUDA events, {(n + hac_codec.BATCH - 1) // hac_codec.BATCH} "
            f"batches), host coder {prof['coder_s']:.4f} s (host wall clock), "
            f"the rest {prof['total_s'] - prof['anchors_s'] - prof['coder_s']:.4f} "
            f"s; rans_encode launches {enc_launches}")
        log("  encoded sizes: " + ", ".join(
            f"{k} {v} bits ({v / hac_codec.BIT2MB:.4f} MB)" for k, v in sizes.items()))
        if enc_launches == 0:
            raise RuntimeError("the scene encode did not launch the rans "
                               "encode kernel")
        if sizes["mlps"] != scene_mlp_bits(tstate):
            raise RuntimeError(f"mlps {sizes['mlps']} bits, the parameters "
                               f"give {scene_mlp_bits(tstate)}")
        data = hac_codec._gather_sorted_attributes(tstate, tcfg)
        dec, child_s = decode_in_fresh_process(tmp, "hac", tstate, tcfg, scene,
                                               values, data)
        # the finest level of the anchors' cloud: both rANS kernels against
        # their plain versions on its tables
        g, tables, syms = finest_level(data["anchor_int"], net, pcc_cfg, dev)
        check_rans("scene anchors' finest level", tables, syms, g.n_child)
    dp = dec["profile"]
    log(f"  decode in a fresh process ({child_s:.3f} s with start-up): "
        f"first decode {dec['first_s']:.4f} s; second {dp['total_s']:.4f} s "
        f"wall: anchors (GausPcgc) {dp['anchors_s']:.4f} s, context "
        f"{dp['context_ms']:.3f} ms (CUDA events), host coder "
        f"{dp['coder_s']:.4f} s; rans_decode launches {dec['rans_decode']}; "
        f"anchors, masks, hash signs, feat, scaling and offsets equal to the "
        f"encoder's")
    log(f"  decoded eval: tile_blend launches {dec['tile_blend']}, K="
        f"{dec['eval_k']} D={dec['eval_d']}, ms/view "
        f"{', '.join(f'{m:.3f}' for m in dec['ms'])} (CUDA events, after a "
        f"warm-up render)")
    if dec["rans_decode"] == 0 or dec["tile_blend"] == 0:
        raise RuntimeError("the scene decode did not launch the rans decode "
                           "kernel, or its eval the tile_blend kernel")
    float_res = pipeline.evaluate(tstate, tcfg, scene.test_cameras,
                                  max_k=EVAL_K, white_background=True)
    float_eval_diagnostics(tstate, tcfg, scene, values, data["index"],
                           float_res["psnr"])
    delta = float_res["psnr"] - dec["psnr"]
    log(f"  PSNR decoded {dec['psnr']:.4f} dB (fresh process), float "
        f"{float_res['psnr']:.4f} dB (the same state, this process; K="
        f"{float_res['eval_k']} D={float_res['eval_d']}, ms/view "
        f"{', '.join(f'{v['ms']:.3f}' for v in float_res['per_view'].values())}):"
        f" codec_delta_db {delta:+.5f} (limit +-{SCENE_DELTA_DB}); size "
        f"{sizes['total']} bits = {sizes['total'] / hac_codec.BIT2MB:.4f} MB")
    if not abs(delta) <= SCENE_DELTA_DB:
        raise RuntimeError(f"codec_delta_db {delta:+.5f} outside "
                           f"+-{SCENE_DELTA_DB}")
    return sizes


def hac_plus_phase(dev, scene, serve_psnr: float, hac_sizes: dict) -> dict:
    """HAC++ on the soak scene at the full HACPlusConfig width: train
    through the soak's schedule, check it, encode twice, decode and evaluate
    in a fresh process, evaluate the float state. Returns the path's
    launches of each kernel."""
    tile_blend.launches = 0
    tile_blend.backward_launches = 0
    hashgrid.backward_launches = 0
    t0 = time.perf_counter()
    state, cfg, _, res = soak.train(
        scene, TRAIN_STEPS, model="hac_plus", voxel_size=VOXEL_SIZE,
        white_background=True, log=lambda m: log(f"  {m}"), log_every=100,
        device=dev, **TRAIN_DENSIFY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = tile_blend.launches, tile_blend.backward_launches
    k3 = hashgrid.backward_launches
    nets = state["nets"]
    log(f"  HACPlusConfig: feat_dim {cfg.feat_dim} ({hacp.N_CHUNKS} chunks of "
        f"{cfg.chunk}), {cfg.n_offsets} offsets, mlp_grid "
        f"{nets.mlp_grid.fc1.out_features} wide, channel context "
        f"{'tiny' if cfg.tiny_ctx else 'full'} "
        f"({sum(p.numel() for p in nets.channel_ctx.parameters())} parameters)")
    log(f"  {TRAIN_STEPS} steps in {wall:.3f} s ({wall / TRAIN_STEPS * 1e3:.3f} "
        f"ms a step, densification and cap checks included); tile_blend "
        f"launches {fwd}, backward launches {bwd}; K3 backward launches {k3}")
    if fwd == 0 or bwd == 0:
        raise RuntimeError("HAC++ training did not launch both blend kernels")
    if k3 == 0:
        raise RuntimeError("HAC++ training did not launch K3's backward")
    training_report(res)
    # the channel context has no gradient before phase 2 (its objective is
    # the rate's), so what moved it is phase 2
    init = hacp.HACPlusNets(cfg).init_seeded(np.random.default_rng(SEED))
    moved = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(nets.channel_ctx.parameters(),
                                init.channel_ctx.parameters()))
    log(f"  channel_ctx: largest change from its seeded init {moved:.4e}")
    if not moved > 0:
        raise RuntimeError("phase 2 did not train the channel context")
    trained = pipeline.evaluate(state, cfg, scene.test_cameras, max_k=EVAL_K,
                                white_background=True)
    log(f"  held-out PSNR {trained['psnr']:.3f} dB trained (float attributes, "
        f"as the JAX package renders a HAC++ state), {serve_psnr:.3f} dB "
        f"untrained (serve phase); K={trained['eval_k']} D={trained['eval_d']}")
    if not trained["psnr"] > serve_psnr:
        raise RuntimeError("HAC++ training did not raise the held-out PSNR")

    pcc_cfg = pcgc_model.NetConfig()
    net = convert.load_codec_npz(SCENE_CODEC_WEIGHTS, pcc_cfg, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        bs_dir = str(Path(tmp) / "bitstreams")
        t0 = time.perf_counter()
        first, _ = hacp_codec.conduct_encoding(state, cfg, bs_dir, net, pcc_cfg)
        log(f"  first encode (set-up included): {time.perf_counter() - t0:.3f} s")
        values, prof = {}, {}
        rans.encode_launches = 0
        sizes, _ = hacp_codec.conduct_encoding(state, cfg, bs_dir, net, pcc_cfg,
                                               values=values, profile=prof)
        enc_launches = rans.encode_launches
        if sizes != first:
            raise RuntimeError(f"two encodes of one state differ: {first} vs "
                               f"{sizes}")
        n = values["feat"].shape[0]
        batches = (n + hacp_codec.BATCH - 1) // hacp_codec.BATCH
        log(f"  encode: {prof['total_s']:.4f} s wall, {n} anchors: anchors "
            f"(GausPcgc) {prof['anchors_s']:.4f} s, context "
            f"{prof['context_ms']:.3f} ms and chunk mixtures "
            f"{prof['mixture_ms']:.3f} ms (CUDA events, {batches} batches, "
            f"{hacp.N_CHUNKS * batches} feature streams), host coder "
            f"{prof['coder_s']:.4f} s (host wall clock), the rest "
            f"{prof['total_s'] - prof['anchors_s'] - prof['coder_s']:.4f} s; "
            f"rans_encode launches {enc_launches}")
        log("  encoded sizes, HAC++ beside HAC (this run): " + ", ".join(
            f"{k} {v / hac_codec.BIT2MB:.4f} MB ({hac_sizes[k] / hac_codec.BIT2MB:.4f})"
            for k, v in sizes.items()))
        if enc_launches == 0:
            raise RuntimeError("the HAC++ encode did not launch the rans "
                               "encode kernel")
        if sizes["mlps"] != scene_mlp_bits(state):
            raise RuntimeError(f"mlps {sizes['mlps']} bits, the four MLPs' "
                               f"parameters give {scene_mlp_bits(state)}")
        data = hac_codec._gather_sorted_attributes(state, cfg.as_hac())
        dec, child_s = decode_in_fresh_process(tmp, "hac_plus", state, cfg,
                                               scene, values, data)
    dp = dec["profile"]
    log(f"  decode in a fresh process ({child_s:.3f} s with start-up): first "
        f"{dec['first_s']:.4f} s; second {dp['total_s']:.4f} s wall: anchors "
        f"(GausPcgc) {dp['anchors_s']:.4f} s, context {dp['context_ms']:.3f} "
        f"ms, chunk mixtures {dp['mixture_ms']:.3f} ms (CUDA events), host "
        f"coder {dp['coder_s']:.4f} s; rans_decode launches "
        f"{dec['rans_decode']}; exact: {', '.join(dec['exact'])}")
    log(f"  decoded eval: tile_blend launches {dec['tile_blend']}, K="
        f"{dec['eval_k']} D={dec['eval_d']}, ms/view "
        f"{', '.join(f'{m:.3f}' for m in dec['ms'])}; one decoded frame, "
        f"kernel vs plain max |diff| {dec['frame_err']:.3e}")
    if dec["rans_decode"] == 0 or dec["tile_blend"] == 0:
        raise RuntimeError("the HAC++ decode did not launch the rans decode "
                           "kernel, or its eval the tile_blend kernel")
    float_res = pipeline.evaluate(state, cfg, scene.test_cameras, max_k=EVAL_K,
                                  white_background=True)
    log(f"  PSNR decoded {dec['psnr']:.4f} dB (fresh process), float "
        f"{float_res['psnr']:.4f} dB (unquantised attributes, this process): "
        f"codec_delta_db {float_res['psnr'] - dec['psnr']:+.5f} (not held to "
        f"a limit: the JAX package's float eval of a HAC++ state does not "
        f"quantise); size {sizes['total'] / hac_codec.BIT2MB:.4f} MB")
    return {"tile_blend": fwd, "tile_blend_backward": bwd,
            "hashgrid_table_grad": k3, "rans_encode": enc_launches,
            "rans_decode": dec["rans_decode"]}, sizes


def context_ms(state, cfg) -> tuple[float, float, Counter]:
    """CUDA-event ms (mean of 10 back-to-back runs) of TC-GS's triplane
    context over every capacity row at a training step: the planes sampled
    and mlp_triplane's heads, forward; and forward with the backward to
    the planes and mlp_triplane for a seeded upstream gradient; and the
    forward's host syncs."""
    anchor = hac.get_anchor(state, cfg.as_hac()).detach()
    nets = state["nets"]
    leaves = [nets.planes, *nets.mlp_triplane.parameters()]
    gen = torch.Generator(device=anchor.device).manual_seed(SEED)

    def forward():
        return tcgs.grid_mlp_split(state, cfg,
                                   tcgs.triplane_context(state, cfg, anchor))

    with torch.no_grad():
        upstream = {k: torch.randn(v.shape, generator=gen, device=v.device)
                    for k, v in forward().items()}
        fwd = cuda_ms(forward, 10)
        syncs = host_syncs(forward)

    def forward_backward():
        with torch.enable_grad():
            ctx = forward()
            torch.autograd.grad(sum((ctx[k] * g).sum() for k, g in
                                    upstream.items()), leaves)

    return fwd, cuda_ms(forward_backward, 10), syncs


@torch.no_grad()
def context_diagnostics(state, cfg, scene) -> None:
    """The quantisation steps the triplane context gives the coded anchors
    from the state's planes (training's context) and from the planes the
    codec reconstructs from the f16 latent (the coded context): their
    means, and the largest ratio between the two; and the held-out PSNR of
    the state with its attributes quantised as the codec quantises them,
    through either context, all three attributes or one at a time."""
    data = hac_codec._gather_sorted_attributes(state, cfg.as_hac())
    pos = hac_codec._positions(data["anchor_int"], cfg.as_hac(),
                               state["valid"].device)
    latent, recon = tcgs.reconstructed_planes(state)
    lat16 = latent.half().float()
    coded = tri.decode_latent(state["nets"].autoencoder, lat16)
    heads = {}
    for name, planes in (("training's planes", state["nets"].planes),
                         ("the latent's reconstruction", coded)):
        heads[name] = tcgs_codec._batch_context(state, cfg, pos, planes)
    for q in ("q_feat", "q_scaling", "q_offsets"):
        a, b = (h[q] for h in heads.values())
        log(f"  {q} at the {pos.shape[0]} coded anchors: mean "
            + ", ".join(f"{float(h[q].mean()):.5g} from {n}"
                        for n, h in heads.items())
            + f"; largest ratio {float(torch.maximum(a / b, b / a).max()):.4g}")
    log(f"  planes: training's mean {float(state['nets'].planes.mean()):.4f}, "
        f"std {float(state['nets'].planes.std()):.4f}; the reconstruction's "
        f"mean {float(coded.mean()):.4f}, std {float(coded.std()):.4f}; "
        f"|reconstruction - autoencode(planes)| max "
        f"{float((coded - recon).abs().max()):.3e}")
    a = state["anchors"]
    anchor = hac.get_anchor(state, cfg.as_hac())
    scaling = hac.get_scaling(state)
    for name, planes in (("training's", state["nets"].planes),
                         ("the coded", coded)):
        ctx = tcgs_codec._batch_context(state, cfg, anchor, planes)
        quantised = {
            "anchor_feat": ste_multistep(a["anchor_feat"], ctx["q_feat"],
                                         a["anchor_feat"].mean()),
            "scaling": torch.log(torch.clamp_min(ste_multistep(
                scaling, ctx["q_scaling"], scaling.mean()), 1e-9)),
            "offset": ste_multistep(a["offset"], ctx["q_offsets"][:, None, :],
                                    a["offset"].mean())}
        psnr = {}
        for which in ("all", *quantised):
            fields = quantised if which == "all" else {which: quantised[which]}
            st = dict(state, anchors=dict(a, **fields))
            psnr[which] = pipeline.evaluate(st, cfg, scene.test_cameras,
                                            max_k=EVAL_K,
                                            white_background=True)["psnr"]
        log(f"  held-out PSNR with the attributes quantised through "
            f"{name} context: " + ", ".join(f"{k} {v:.4f} dB"
                                            for k, v in psnr.items()))


def tcgs_phase(dev, scene, serve_psnr: float, hac_sizes: dict,
               hacp_sizes: dict) -> dict:
    """TC-GS on the soak scene at the full TCGSConfig width: train through
    the soak's schedule (phases 0-2), then TCGS_PHASE3_STEPS steps at phase
    3 through the family's own train step, check both; encode twice,
    decode and evaluate in a fresh process, evaluate the float state.
    Returns the path's launches of each kernel."""
    family = registry.get_family("tcgs")
    tile_blend.launches = 0
    tile_blend.backward_launches = 0
    t0 = time.perf_counter()
    state, cfg, opt, res = soak.train(
        scene, TRAIN_STEPS, model="tcgs", voxel_size=VOXEL_SIZE,
        white_background=True, log=lambda m: log(f"  {m}"), log_every=100,
        device=dev, **TRAIN_DENSIFY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = tile_blend.launches, tile_blend.backward_launches
    nets = state["nets"]
    log(f"  TCGSConfig: feat_dim {cfg.feat_dim}, {cfg.n_offsets} offsets, "
        f"planes {tuple(nets.planes.shape)}, {cfg.tri_samples} samples an "
        f"anchor ({'knn' if cfg.knn_sampling else 'repeat'} mode), latent "
        f"{cfg.ae_compressed} channels, mlp_triplane {cfg.ctx_dim} -> "
        f"{2 * cfg.feat_dim} -> {cfg.grid_out_dim}, q_offsets base "
        f"{cfg.q_offsets}")
    log(f"  {TRAIN_STEPS} steps in {wall:.3f} s ({wall / TRAIN_STEPS * 1e3:.3f} "
        f"ms a step, densification and cap checks included); tile_blend "
        f"launches {fwd}, backward launches {bwd}")
    if fwd == 0 or bwd == 0:
        raise RuntimeError("TC-GS training did not launch both blend kernels")
    training_report(res)
    if res["history"]["phase"].max() != 2:
        raise RuntimeError("the soak's schedule did not stop at phase 2")
    # planes and mlp_triplane have no gradient before phase 2 (their
    # objective is the rate's), the autoencoder none before phase 3
    init = tcgs.TCGSNets(cfg).init_seeded(np.random.default_rng(SEED))

    def leaves(module, part: str) -> list:
        return [p for name, p in module.named_parameters()
                if name.split(".")[0] == part]

    changes = {part: max(float((p.detach().cpu() - q.detach()).abs().max())
                         for p, q in zip(leaves(nets, part), leaves(init, part)))
               for part in ("planes", "mlp_triplane", "autoencoder")}
    log("  largest change from the seeded init after the soak: " + ", ".join(
        f"{k} {v:.4e}" for k, v in changes.items()))
    if not (changes["planes"] > 0 and changes["mlp_triplane"] > 0):
        raise RuntimeError("phase 2 did not train the planes and mlp_triplane")
    if changes["autoencoder"] != 0:
        raise RuntimeError("the autoencoder moved before phase 3")
    trained = pipeline.evaluate(state, cfg, scene.test_cameras, max_k=EVAL_K,
                                white_background=True)
    log(f"  held-out PSNR {trained['psnr']:.3f} dB trained (float attributes, "
        f"as the JAX package renders a TC-GS state), {serve_psnr:.3f} dB "
        f"untrained (serve phase); K={trained['eval_k']} D={trained['eval_d']}")
    if not trained["psnr"] > serve_psnr:
        raise RuntimeError("TC-GS training did not raise the held-out PSNR")

    # the triplane context of a phase-2 step, the step itself, and phase 3,
    # on a copy: the soak's state is what is coded, as the JAX package's
    # soak codes it
    work = copy.deepcopy(state)
    rcfg = res["rcfg"]
    optimizer = hac_train.make_optimizer(opt, scene.cameras_extent)
    step_fn = hac_train.make_train_step(cfg, rcfg, optimizer, opt,
                                        loss_fn=family.training_loss,
                                        white_background=True)
    params, rest = hac.split_state(work)
    box = copy.deepcopy({"opt": res["opt_state"], "stats": res["stats"]})
    cams = [hac_render.CameraArrays.from_camera(c, dev, with_image=True)
            for c in scene.train_cameras]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    turn = [0]

    def one_step(phase):
        cam = cams[turn[0] % len(cams)]
        turn[0] += 1
        _, box["opt"], box["stats"], m = step_fn(
            params, rest, box["opt"], box["stats"], cam, phase=phase,
            generator=gen)
        return m

    ctx_fwd, ctx_both, syncs = context_ms(work, cfg)
    walls = sorted(wall_ms(lambda: one_step(2), 5))
    log(f"  triplane context of a phase-2 step ({int(work['valid'].shape[0])} "
        f"capacity rows): forward {ctx_fwd:.4f} ms, forward and backward "
        f"{ctx_both:.4f} ms (CUDA events, mean of 10 back-to-back runs); "
        f"forward's host syncs {sum(syncs.values())} "
        + ", ".join(f"{k} x{v}" for k, v in syncs.most_common())
        + f"; the whole phase-2 step {walls[2]:.4f} ms (host wall clock, "
        f"median of 5)")

    # phase 3, the reference's objective after step 15,000: lae joins
    @torch.no_grad()
    def lae_now() -> float:
        _, aux = family.training_loss(
            params, rest, cfg, cams[0], rcfg, torch.ones(3, device=dev), 3,
            None, None, opt.lmbda, generator=torch.Generator(
                device=dev).manual_seed(SEED))
        return float(aux["lae"])

    ae = work["nets"].autoencoder
    ae_before = [p.detach().clone() for p in ae.parameters()]
    lae0 = lae_now()
    tile_blend.launches = 0
    tile_blend.backward_launches = 0
    t0 = time.perf_counter()
    p3 = [one_step(3) for _ in range(TCGS_PHASE3_STEPS)]
    torch.cuda.synchronize()
    p3_wall = time.perf_counter() - t0
    fwd3, bwd3 = tile_blend.launches, tile_blend.backward_launches
    lae1 = lae_now()
    losses = [float(m["loss"]) for m in p3]
    nonfinite = sum(int(m["nonfinite_grads"]) for m in p3)
    ae_moved = max(float((p.detach() - q).abs().max())
                   for p, q in zip(ae.parameters(), ae_before))
    log(f"  phase 3: {TCGS_PHASE3_STEPS} steps in {p3_wall:.3f} s, loss first "
        f"{losses[0]:.5f} last {losses[-1]:.5f}, bits per parameter last "
        f"{float(p3[-1]['bit_per_param']):.4f}, lae {lae0:.5f} -> {lae1:.5f}, "
        f"autoencoder's largest change {ae_moved:.4e}, non-finite gradient "
        f"components {nonfinite}; tile_blend launches {fwd3}, backward {bwd3}")
    if not (np.isfinite(losses).all() and np.isfinite([lae0, lae1]).all()
            and lae0 > 0 and lae1 > 0):
        raise RuntimeError("phase 3's loss or lae is not finite and positive")
    if not ae_moved > 0:
        raise RuntimeError("phase 3 did not train the autoencoder")
    if fwd3 == 0 or bwd3 == 0:
        raise RuntimeError("phase 3 did not launch both blend kernels")

    pcc_cfg = pcgc_model.NetConfig()
    net = convert.load_codec_npz(SCENE_CODEC_WEIGHTS, pcc_cfg, device=dev)
    # what the coding costs after phase 3, in this process (not held)
    with tempfile.TemporaryDirectory() as tmp:
        tcgs_codec.conduct_encoding(work, cfg, tmp, net, pcc_cfg)
        dec3, _ = tcgs_codec.conduct_decoding(work, cfg, tmp, net, pcc_cfg)
    psnr3 = [pipeline.evaluate(st, cfg, scene.test_cameras, max_k=EVAL_K,
                               white_background=True, decoded=d)["psnr"]
             for st, d in ((work, False), (dec3, True))]
    log(f"  after phase 3, in this process: PSNR float {psnr3[0]:.4f} dB, "
        f"decoded {psnr3[1]:.4f} dB, codec_delta_db {psnr3[0] - psnr3[1]:+.5f}")
    del work, params, rest, box, dec3
    context_diagnostics(state, cfg, scene)

    with tempfile.TemporaryDirectory() as tmp:
        bs_dir = str(Path(tmp) / "bitstreams")
        t0 = time.perf_counter()
        first, _ = tcgs_codec.conduct_encoding(state, cfg, bs_dir, net, pcc_cfg)
        log(f"  first encode (set-up included): {time.perf_counter() - t0:.3f} s")
        values, prof = {}, {}
        rans.encode_launches = 0
        sizes, _ = tcgs_codec.conduct_encoding(state, cfg, bs_dir, net, pcc_cfg,
                                               values=values, profile=prof)
        enc_launches = rans.encode_launches
        if sizes != first:
            raise RuntimeError(f"two encodes of one state differ: {first} vs "
                               f"{sizes}")
        n = values["feat"].shape[0]
        log(f"  encode: {prof['total_s']:.4f} s wall, {n} anchors: anchors "
            f"(GausPcgc) {prof['anchors_s']:.4f} s, context "
            f"{prof['context_ms']:.3f} ms (CUDA events, the latent's "
            f"reconstruction and {(n + tcgs_codec.BATCH - 1) // tcgs_codec.BATCH}"
            f" batches), host coder {prof['coder_s']:.4f} s (host wall clock), "
            f"the rest {prof['total_s'] - prof['anchors_s'] - prof['coder_s']:.4f}"
            f" s; rans_encode launches {enc_launches}")
        others = {"hac": hac_sizes, "hac_plus": hacp_sizes}
        log("  encoded sizes in MB, TC-GS (HAC, HAC++ in this run): " + ", ".join(
            f"{k} {v / hac_codec.BIT2MB:.4f} (" + ", ".join(
                f"{o[k] / hac_codec.BIT2MB:.4f}" if k in o else "-"
                for o in others.values()) + ")" for k, v in sizes.items()))
        if enc_launches == 0:
            raise RuntimeError("the TC-GS encode did not launch the rans "
                               "encode kernel")
        if (sizes["mlps"], sizes["triplane"]) != (TCGS_MLP_BITS, TCGS_LATENT_BITS):
            raise RuntimeError(f"mlps {sizes['mlps']} and triplane "
                               f"{sizes['triplane']} bits, not {TCGS_MLP_BITS} "
                               f"and {TCGS_LATENT_BITS}")
        data = hac_codec._gather_sorted_attributes(state, cfg.as_hac())
        dec, child_s = decode_in_fresh_process(tmp, "tcgs", state, cfg, scene,
                                               values, data)
    dp = dec["profile"]
    log(f"  decode in a fresh process ({child_s:.3f} s with start-up): first "
        f"{dec['first_s']:.4f} s; second {dp['total_s']:.4f} s wall: anchors "
        f"(GausPcgc) {dp['anchors_s']:.4f} s, context {dp['context_ms']:.3f} "
        f"ms (CUDA events), host coder {dp['coder_s']:.4f} s; rans_decode "
        f"launches {dec['rans_decode']}; exact: {', '.join(dec['exact'])}")
    log(f"  decoded eval: tile_blend launches {dec['tile_blend']}, K="
        f"{dec['eval_k']} D={dec['eval_d']}, ms/view "
        f"{', '.join(f'{m:.3f}' for m in dec['ms'])}; one decoded frame, "
        f"kernel vs plain max |diff| {dec['frame_err']:.3e}")
    if dec["rans_decode"] == 0 or dec["tile_blend"] == 0:
        raise RuntimeError("the TC-GS decode did not launch the rans decode "
                           "kernel, or its eval the tile_blend kernel")
    float_res = pipeline.evaluate(state, cfg, scene.test_cameras, max_k=EVAL_K,
                                  white_background=True)
    log(f"  PSNR decoded {dec['psnr']:.4f} dB (fresh process), float "
        f"{float_res['psnr']:.4f} dB (unquantised attributes, this process): "
        f"codec_delta_db {float_res['psnr'] - dec['psnr']:+.5f} (not held to "
        f"a limit: the JAX package's float eval of a TC-GS state does not "
        f"quantise); size {sizes['total'] / hac_codec.BIT2MB:.4f} MB")
    return {"tile_blend": fwd + fwd3, "tile_blend_backward": bwd + bwd3,
            "rans_encode": enc_launches, "rans_decode": dec["rans_decode"]}, sizes


def plane_rate_ms(field) -> tuple[float, float, Counter, float, str]:
    """CUDA-event ms (mean of 10 back-to-back runs) of the phase-2 rate of
    every plane (the planes with seeded noise, each through its group's
    ARM): forward, and forward with the backward to the planes, the gains
    and the ARMs; the forward's host syncs; and the bound of the forward:
    the larger of its bytes (the planes and the noise read, once each)
    over the memory rate and its fp32 operations over the fp32 peak."""
    gen = torch.Generator(device=field.gains.device).manual_seed(SEED)
    noise = cat_field.plane_noise(field, gen)
    leaves = [*field.scales, field.gains, *field.arms.parameters()]

    def forward():
        return cat_field.field_rate_bits(
            field, cat_field.quantized_planes(field, noise))

    with torch.no_grad():
        fwd = cuda_ms(forward, 10)
        syncs = host_syncs(forward)

    def forward_backward():
        with torch.enable_grad():
            torch.autograd.grad(forward(), leaves)

    pixels = sum(p.numel() for p in field.scales)
    n_bytes = 2 * 4 * pixels
    ops = pixels * (2 * ARM_MACS_PER_PIXEL + ARM_RATE_OPS_PER_PIXEL)
    byte_s, op_s = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    by = "bytes" if byte_s >= op_s else "operations"
    return fwd, cuda_ms(forward_backward, 10), syncs, max(byte_s, op_s) * 1e3, (
        f"{by}: {pixels} plane pixels, {n_bytes} B, {ops} fp32 ops")


@torch.no_grad()
def cat_quantisation_diagnostics(state, cfg, scene) -> None:
    """What separates CAT-3DGS's float eval from its decoded one: the
    quantisation steps the hyperprior gives the valid anchors from the
    integer planes the stream carries, beside the attributes' spread and
    the share of features that round to their window's centre; and the
    held-out PSNR of the state with its attributes quantised as the codec
    quantises them, all three or one at a time."""
    a = state["anchors"]
    valid = state["valid"]
    hyper = cat.hyper_split(state, cfg, hac.get_anchor(state, cfg.as_hac()),
                            cat_codec.coded_planes(state))
    scaling = hac.get_scaling(state)
    feat_mean = a["anchor_feat"][valid].mean()
    quantised = {
        "anchor_feat": ste_multistep(a["anchor_feat"], hyper["q_feat"], feat_mean),
        "scaling": torch.log(torch.clamp_min(ste_multistep(
            scaling, hyper["q_scaling"], scaling[valid].mean()), 1e-9)),
        "offset": ste_multistep(a["offset"], hyper["q_offsets"][:, None, :],
                                a["offset"][valid].mean())}
    feat_q = quantised["anchor_feat"][valid]
    log("  at the valid anchors: " + ", ".join(
        f"{q} mean {float(hyper[q][valid].mean()):.5g}"
        for q in ("q_feat", "q_scaling", "q_offsets"))
        + f"; features std {float(a['anchor_feat'][valid].std()):.5g}, "
        f"{float((feat_q == 0).float().mean()):.4f} of them quantised to 0; "
        f"scaling std {float(scaling[valid].std()):.5g}, offsets std "
        f"{float(a['offset'][valid].std()):.5g}")
    psnr = {}
    for which in ("all", *quantised):
        fields = quantised if which == "all" else {which: quantised[which]}
        st = dict(state, anchors=dict(a, **fields))
        psnr[which] = pipeline.evaluate(st, cfg, scene.test_cameras,
                                        max_k=EVAL_K,
                                        white_background=True)["psnr"]
    log("  held-out PSNR with the attributes quantised as the codec "
        "quantises them: " + ", ".join(f"{k} {v:.4f} dB" for k, v in psnr.items()))


def cat3dgs_phase(dev, scene, serve_psnr: float, others: dict) -> dict:
    """CAT-3DGS on the soak scene at the full CATConfig width: train
    through the soak's schedule (phases 0-2, the PCA frame fitted once on
    entering phase 2), then on a copy CAT_LATE_STEPS steps at each of
    phases 3, 4 and 5 through the family's train step; check both; encode
    twice, decode and evaluate in a fresh process, evaluate the float
    state. `others`: the other families' encoded sizes in this run.
    Returns the path's launches of each kernel."""
    family = registry.get_family("cat3dgs")
    fits = []

    def counted_fit(state, cfg):  # the family's hook, counted
        valid = state["valid"].cpu().numpy()
        pts = state["anchors"]["anchor"].detach().cpu().numpy()[valid]
        fits.append((pts.shape[0], int(cat_field.lof_inliers(pts).sum())))
        return fit(state, cfg)

    # soak.train resolves the family itself: its hook is the module's
    fit, cat.set_pca_frame = cat.set_pca_frame, counted_fit
    tile_blend.launches = 0
    tile_blend.backward_launches = 0
    t0 = time.perf_counter()
    try:
        state, cfg, opt, res = soak.train(
            scene, TRAIN_STEPS, model="cat3dgs", voxel_size=VOXEL_SIZE,
            white_background=True, log=lambda m: log(f"  {m}"), log_every=100,
            device=dev, **TRAIN_DENSIFY)
        torch.cuda.synchronize()
    finally:
        cat.set_pca_frame = fit
    wall = time.perf_counter() - t0
    fwd, bwd = tile_blend.launches, tile_blend.backward_launches
    nets = state["nets"]
    field = nets.field
    log(f"  CATConfig: feat_dim {cfg.feat_dim} in chcm slices "
        f"{cfg.chcm_slices}, {cfg.n_offsets} offsets, planes "
        + ", ".join(str(tuple(p.shape)) for p in field.scales)
        + f", four {cfg.field.layers_arm[0]}-wide ARM layers a plane group, "
        f"mlp_attr {cfg.ctx_dim} -> {2 * cfg.feat_dim} -> {cfg.grid_out_dim}, "
        f"mlp_chcm[0] {cfg.chcm_slices[0]} -> {2 * cfg.feat_dim} -> "
        f"{2 * cfg.chcm_slices[1]}")
    log(f"  {TRAIN_STEPS} steps in {wall:.3f} s ({wall / TRAIN_STEPS * 1e3:.3f} "
        f"ms a step, densification, cap checks and the PCA fit included); "
        f"tile_blend launches {fwd}, backward launches {bwd}")
    if fwd == 0 or bwd == 0:
        raise RuntimeError("CAT-3DGS training did not launch both blend kernels")
    training_report(res)
    if res["history"]["phase"].max() != 2:
        raise RuntimeError("the soak's schedule did not stop at phase 2")
    log(f"  set_pca_frame calls {len(fits)}: " + ", ".join(
        f"{n} anchors, the LOF kept {kept}" for n, kept in fits)
        + "; frame: mean " + ", ".join(f"{v:.4f}" for v in field.pca_mean.tolist())
        + ", std " + ", ".join(f"{v:.4f}" for v in field.pca_std.tolist())
        + ", gains " + ", ".join(f"{v:.4f}" for v in field.gains.tolist()))
    if len(fits) != 1:
        raise RuntimeError(f"set_pca_frame ran {len(fits)} times, not once")
    # the planes, the field's frame, mlp_attr and mlp_chcm have no gradient
    # before phase 2 (their objective is the rate's); phase 2 freezes the ARMs
    init = cat.CATNets(cfg).init_seeded(np.random.default_rng(SEED))

    def change(prefix: str) -> float:
        mine = dict(nets.named_parameters())
        return max(float((mine[n].detach().cpu() - p.detach()).abs().max())
                   for n, p in init.named_parameters() if n.startswith(prefix))

    changes = {part: change(part) for part in (
        "field.scales", "field.arms", "field.gains", "mlp_attr", "mlp_chcm")}
    log("  largest change from the seeded init after the soak: " + ", ".join(
        f"{k} {v:.4e}" for k, v in changes.items()))
    if not all(changes[k] > 0 for k in ("field.scales", "mlp_attr", "mlp_chcm")):
        raise RuntimeError("phase 2 did not train the planes, mlp_attr and "
                           "mlp_chcm")
    if changes["field.arms"] != 0:
        raise RuntimeError("the ARMs moved in the soak (phase 2 freezes them)")
    trained = pipeline.evaluate(state, cfg, scene.test_cameras, max_k=EVAL_K,
                                white_background=True)
    log(f"  held-out PSNR {trained['psnr']:.3f} dB trained (float attributes, "
        f"as the JAX package renders a CAT-3DGS state), {serve_psnr:.3f} dB "
        f"untrained (serve phase); K={trained['eval_k']} D={trained['eval_d']}")
    if not trained["psnr"] > serve_psnr:
        raise RuntimeError("CAT-3DGS training did not raise the held-out PSNR")
    rate_fwd, rate_both, syncs, rate_bound, rate_detail = plane_rate_ms(field)
    log(f"  phase-2 rate of the {3 * len(field.scales)} planes (the ARMs over "
        f"every pixel's 12-tap context): forward {rate_fwd:.4f} ms, forward "
        f"and backward {rate_both:.4f} ms (CUDA events, mean of 10 "
        f"back-to-back runs); forward's host syncs {sum(syncs.values())}; "
        f"bound {rate_bound:.5f} ms ({rate_detail})")

    # phases 3, 4 and 5 on a copy, from zeroed Adam moments: a group that
    # grad_mask freezes gets zero gradients, and only moments carried from
    # earlier steps would move it (as in the JAX package)
    work = copy.deepcopy(state)
    rcfg = res["rcfg"]
    optimizer = hac_train.make_optimizer(opt, scene.cameras_extent)
    step_fn = hac_train.make_train_step(cfg, rcfg, optimizer, opt,
                                        loss_fn=family.training_loss,
                                        grad_mask=family.grad_mask,
                                        white_background=True)
    params, rest = hac.split_state(work)
    leaves = hac_train.param_leaves(params)
    zeros = optimizer.init(leaves)
    box = copy.deepcopy({"opt": dict(res["opt_state"], mu=zeros["mu"],
                                     nu=zeros["nu"]), "stats": res["stats"]})
    cams = [hac_render.CameraArrays.from_camera(c, dev, with_image=True)
            for c in scene.train_cameras]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    turn = [0]

    def one_step(phase):
        cam = cams[turn[0] % len(cams)]
        turn[0] += 1
        _, box["opt"], box["stats"], m = step_fn(
            params, rest, box["opt"], box["stats"], cam, phase=phase,
            generator=gen)
        return m

    late_fwd = late_bwd = 0
    for phase, moves in ((3, lambda n: n.startswith("nets/field/arms/")),
                         (4, lambda n: not n.startswith("nets/field/scales/")),
                         (5, lambda n: True)):
        before = {n: t.detach().clone() for n, t in leaves.items()}
        # the loss of phase 3 is the planes' rate alone: the same noise
        # through the objective and through the rate
        noise = (*(torch.rand(shape, generator=gen, device=dev) for shape in (
            params["anchors"]["anchor_feat"].shape, (rest["valid"].shape[0], 6),
            params["anchors"]["offset"].shape)),
            cat_field.plane_noise(params["nets"].field, gen))
        with torch.no_grad():
            loss, _ = family.training_loss(
                params, rest, cfg, cams[0], rcfg, torch.ones(3, device=dev),
                phase, noise, None, opt.lmbda)
            _, rate, planes_rate = cat_render.rate_gaussians(
                hac.merge_state(params, rest), cfg, cams[0].camera_center,
                hac_render.prefilter_voxel(hac.merge_state(params, rest),
                                           cfg.as_hac(), cams[0], rcfg),
                noise, None, None)
        tile_blend.launches = 0
        tile_blend.backward_launches = 0
        t0 = time.perf_counter()
        metrics = [one_step(phase) for _ in range(CAT_LATE_STEPS)]
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
        late_fwd += tile_blend.launches
        late_bwd += tile_blend.backward_launches
        losses = [float(m["loss"]) for m in metrics]
        moved = {n: float((t.detach() - before[n]).abs().max())
                 for n, t in leaves.items()}
        wrong = [n for n, v in moved.items() if (v > 0) != moves(n)]
        log(f"  phase {phase}: {CAT_LATE_STEPS} steps in {p_wall:.3f} s, loss "
            f"first {losses[0]:.5f} last {losses[-1]:.5f}, bits per parameter "
            f"last {float(metrics[-1]['bit_per_param']):.4f}; with one seeded "
            f"draw the objective {float(loss):.6f}, the rate "
            f"{float(rate):.6f}, the planes' share {float(planes_rate):.6f}; "
            f"leaves moved {sum(v > 0 for v in moved.values())} of "
            f"{len(moved)}; tile_blend launches {tile_blend.launches}, "
            f"backward {tile_blend.backward_launches}")
        if not np.isfinite(losses).all():
            raise RuntimeError(f"phase {phase}'s loss is not finite")
        if wrong:
            raise RuntimeError(f"phase {phase} moved a frozen leaf or left "
                               f"one it trains: {wrong[:5]}")
        if phase == 3 and not float(loss) == float(planes_rate):
            raise RuntimeError("phase 3's loss is not the planes' rate")
        if tile_blend.launches == 0:
            raise RuntimeError(f"phase {phase} did not launch the blend kernel")
    # where a phase-2 step's time goes (after the checks: these steps leave
    # moments behind)
    walls = sorted(wall_ms(lambda: one_step(2), 5))
    busy, n_dev, top = device_profile(lambda: one_step(2))
    idle = (f"idle share {1 - busy / walls[2]:.4f} of the median wall clock"
            if n_dev else "idle share not measured")
    log(f"  a phase-2 step: {walls[2]:.4f} ms (host wall clock with a sync at "
        f"each end, median of 5; min {walls[0]:.4f}, max {walls[-1]:.4f}); "
        f"under torch.profiler {n_dev} device activities, device busy "
        f"{busy:.4f} ms, {idle}")
    for name, n, ms in top:
        log(f"    {ms:9.4f} ms  x{n:<4d} {name[:100]}")
    del work, params, rest, box, leaves, zeros

    pcc_cfg = pcgc_model.NetConfig()
    net = convert.load_codec_npz(SCENE_CODEC_WEIGHTS, pcc_cfg, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        bs_dir = str(Path(tmp) / "bitstreams")
        t0 = time.perf_counter()
        first, _ = cat_codec.conduct_encoding(state, cfg, bs_dir, net, pcc_cfg)
        log(f"  first encode (set-up included): {time.perf_counter() - t0:.3f} s")
        values, prof = {}, {}
        rans.encode_launches = 0
        sizes, _ = cat_codec.conduct_encoding(state, cfg, bs_dir, net, pcc_cfg,
                                              values=values, profile=prof)
        enc_launches = rans.encode_launches
        if sizes != first:
            raise RuntimeError(f"two encodes of one state differ: {first} vs "
                               f"{sizes}")
        arm_bytes = (Path(bs_dir) / "arm_q.bin").stat().st_size
        n = values["feat"].shape[0]
        batches = (n + cat_codec.BATCH - 1) // cat_codec.BATCH
        rest_s = (prof["total_s"] - prof["anchors_s"] - prof["triplane_s"]
                  - prof["coder_s"])
        log(f"  encode: {prof['total_s']:.4f} s wall, {n} anchors: anchors "
            f"(GausPcgc) {prof['anchors_s']:.4f} s, triplane coder "
            f"{prof['triplane_s']:.4f} s (host: the fixed-point ARM and its "
            f"coder, {3 * len(values['planes'])} planes), context "
            f"{prof['context_ms']:.3f} ms (CUDA events, {batches} batches of "
            f"{cat_codec.BATCH}, {len(cfg.chcm_slices) * batches} feature "
            f"streams), host coder {prof['coder_s']:.4f} s (host wall clock), "
            f"the rest {rest_s:.4f} s; rans_encode launches {enc_launches}; "
            f"arm_q.bin {arm_bytes} B")
        log("  encoded sizes in MB, CAT-3DGS (" + ", ".join(others)
            + " in this run): " + ", ".join(
                f"{k} {v / hac_codec.BIT2MB:.4f} (" + ", ".join(
                    f"{o[k] / hac_codec.BIT2MB:.4f}" if k in o else "-"
                    for o in others.values()) + ")" for k, v in sizes.items()))
        if enc_launches == 0:
            raise RuntimeError("the CAT-3DGS encode did not launch the rans "
                               "encode kernel")
        if (sizes["mlps"], arm_bytes) != (CAT_MLP_BITS, CAT_ARM_BYTES):
            raise RuntimeError(f"mlps {sizes['mlps']} bits and arm_q.bin "
                               f"{arm_bytes} B, not {CAT_MLP_BITS} and "
                               f"{CAT_ARM_BYTES}")
        data = hac_codec._gather_sorted_attributes(state, cfg.as_hac())
        dec, child_s = decode_in_fresh_process(tmp, "cat3dgs", state, cfg, scene,
                                               values, data)
    dp = dec["profile"]
    log(f"  decode in a fresh process ({child_s:.3f} s with start-up): first "
        f"{dec['first_s']:.4f} s; second {dp['total_s']:.4f} s wall: anchors "
        f"(GausPcgc) {dp['anchors_s']:.4f} s, triplane coder "
        f"{dp['triplane_s']:.4f} s (host), context {dp['context_ms']:.3f} ms "
        f"(CUDA events), host coder {dp['coder_s']:.4f} s; rans_decode "
        f"launches {dec['rans_decode']}; exact: {', '.join(dec['exact'])}")
    log(f"  decoded eval: tile_blend launches {dec['tile_blend']}, K="
        f"{dec['eval_k']} D={dec['eval_d']}, ms/view "
        f"{', '.join(f'{m:.3f}' for m in dec['ms'])}; one decoded frame, "
        f"kernel vs plain max |diff| {dec['frame_err']:.3e}")
    if dec["rans_decode"] == 0 or dec["tile_blend"] == 0:
        raise RuntimeError("the CAT-3DGS decode did not launch the rans decode "
                           "kernel, or its eval the tile_blend kernel")
    float_res = pipeline.evaluate(state, cfg, scene.test_cameras, max_k=EVAL_K,
                                  white_background=True)
    log(f"  PSNR decoded {dec['psnr']:.4f} dB (fresh process), float "
        f"{float_res['psnr']:.4f} dB (unquantised attributes, this process): "
        f"codec_delta_db {float_res['psnr'] - dec['psnr']:+.5f} (not held to "
        f"a limit: the JAX package's float eval of a CAT-3DGS state does not "
        f"quantise; its r5 record has +1.29 dB); size "
        f"{sizes['total'] / hac_codec.BIT2MB:.4f} MB")
    cat_quantisation_diagnostics(state, cfg, scene)
    return {"tile_blend": fwd + late_fwd, "tile_blend_backward": bwd + late_bwd,
            "rans_encode": enc_launches, "rans_decode": dec["rans_decode"]}


# ---------------------------------------------------------------------------
# the dp phase: data parallelism, resume, profiling
# ---------------------------------------------------------------------------

def train_copy(params, rest, opt_state, stats):
    """A deep copy of a training state, which a step updates in place."""
    return copy.deepcopy((params, rest, opt_state, stats))


def step_record(opt_state, stats, grads) -> dict:
    """A scene step's gradients, moments and statistics, by kind and leaf."""
    return {"grad": grads, "mu": opt_state["mu"], "nu": opt_state["nu"],
            "stat": stats}


def train_step_body(tcfg, rcfg, optimizer, topt, params, rest, opt_state,
                    stats, cam, phase, noise) -> dict:
    """One step of make_train_step's body, its parts called in its order
    (step_gradients, apply_gradients, add_stats_) so that the gradients
    are kept; returns its step_record."""
    g = hac_train.step_gradients(tcfg, rcfg, topt, params, rest, cam, phase,
                                 noise, white_background=True)
    opt_state, _ = hac_train.apply_gradients(
        optimizer, g.grads, opt_state, hac_train.param_leaves(params))
    hac_train.add_stats_(stats, g.increments)
    return step_record(opt_state, stats, g.grads)


def trained_record(state, results) -> dict:
    """A training run's leaves, moments and statistics, by kind and leaf."""
    return {"leaf": hac_train.param_leaves(hac.split_state(state)[0]),
            "mu": results["opt_state"]["mu"], "nu": results["opt_state"]["nu"],
            "stat": results["stats"]}


def same_host_states(a: dict, b: dict) -> bool:
    """Whether two resume snapshots hold the same iteration, generator and
    numpy rng states, camera order and caps."""
    return (a["iteration"] == b["iteration"]
            and torch.equal(a["generator"].get_state(),
                            b["generator"].get_state())
            and a["rng"].bit_generator.state == b["rng"].bit_generator.state
            and a["order"] == b["order"] and a["caps"] == b["caps"])


def hold_within_spread(label: str, got: dict, runs: list[dict]) -> None:
    """Hold every leaf of `got` ({kind: {name: tensor}}) against runs[0]
    within 2x the run-to-run spread of `runs` (the largest difference
    between any two of them, leaf by leaf) plus 1e-6 of the leaf's largest
    |value|; prints the largest spread and the tightest leaf. The card's
    sums by atomics make two runs of one step differ in the last bits."""
    worst, widest = (-1.0, "", 0.0, 0.0), (0.0, "none")
    for kind, leaves in got.items():
        for name, g in leaves.items():
            ref = runs[0][kind][name]
            spread = max(float((a[kind][name] - b[kind][name]).detach().abs()
                               .max())
                         for a, b in itertools.combinations(runs, 2))
            bound = 2 * spread + 1e-6 * float(ref.detach().abs().max())
            diff = float((g.to(ref.device) - ref).detach().abs().max())
            if spread > widest[0]:
                widest = (spread, f"{kind} {name}")
            ratio = diff / bound if bound > 0 else (0.0 if diff == 0 else np.inf)
            if ratio > worst[0]:
                worst = (ratio, f"{kind} {name}", diff, bound)
            if not diff <= bound:
                raise RuntimeError(f"{label}: {kind} {name} differs by {diff:.3e}"
                                   f", beyond its bound {bound:.3e} (spread "
                                   f"{spread:.3e})")
    log(f"  {label}: every leaf within 2 x spread + 1e-6 x max; largest "
        f"spread {widest[0]:.3e} ({widest[1]}), largest difference / bound "
        f"{worst[0]:.3f} at {worst[1]} ({worst[2]:.3e} / {worst[3]:.3e})")


def scene_noise(params, rest, cfg, gen) -> tuple:
    """One draw of the quantization noise of a step (feat, scaling,
    offsets), as generate_neural_gaussians draws it."""
    dev = rest["valid"].device
    return tuple(torch.rand(shape, generator=gen, device=dev) for shape in (
        params["anchors"]["anchor_feat"].shape, (rest["valid"].shape[0], 6),
        params["anchors"]["offset"].shape))


def mean_record(a: dict, b: dict, start_stats: dict, optimizer, opt_state,
                leaves) -> dict:
    """What a two-rank DP step gives from two single steps' records (taken
    from zero statistics): the mean gradient, the moments of one update
    with it from `opt_state`, and `start_stats` plus the summed
    increments."""
    grads = {k: (a["grad"][k] + b["grad"][k]) / 2 for k in a["grad"]}
    st = copy.deepcopy(opt_state)
    lv = {k: v.detach().clone() for k, v in leaves.items()}
    st = optimizer.update(dict(grads), st, lv)
    stats = {k: start_stats[k] + (a["stat"][k] + b["stat"][k])
             for k in start_stats}
    return {"grad": grads, "mu": st["mu"], "nu": st["nu"], "stat": stats}


def fitting_caps(patches: list[np.ndarray]) -> list[int]:
    """Per-level parent capacities (powers of two, at least 64) that hold
    the finest coded levels of every patch, coarse to fine."""
    counts = []
    for p in patches:
        xyz0 = sparse.dedupe_lex(p - p.min(axis=0))
        levels = sparse.build_occupancy_pyramid(xyz0, min_points=64,
                                                sorted_unique=True)
        counts.append([c.shape[0] for c, _ in levels[:-1]])
    n = max(len(c) for c in counts)
    caps = []
    for i in range(n):
        most = max((c[i - (n - len(c))] for c in counts if i >= n - len(c)),
                   default=0)
        cap = 64
        while cap < most:
            cap *= 2
        caps.append(cap)
    return caps


def dp_codec_patches(max_points: int) -> list[dict]:
    """The first two KD parts of the bench cloud of at most `max_points`
    points, packed at capacities that fit them; prints the capacities and
    what the default schedule does."""
    parts = pcgc_data.kdtree_partition(bench_cloud(), max_points)[:2]
    caps = fitting_caps(parts)
    log(f"  codec patches: two KD parts (at most {max_points} points) of the "
        f"bench cloud, {[len(p) for p in parts]} points; explicit caps {caps}")
    default = dp.default_capacity_schedule(caps[-1], len(caps))
    try:
        dp.pack_patch(parts[0], default)
        log(f"  default_capacity_schedule({caps[-1]}, {len(caps)}) = {default} "
            f"holds patch 0")
    except ValueError as e:
        log(f"  default_capacity_schedule({caps[-1]}, {len(caps)}) = {default} "
            f"raises on patch 0: {e}")
    return [dp.pack_patch(p, caps) for p in parts]


def patch_levels(packed: dict, dev) -> list:
    return [tuple(torch.as_tensor(packed[k][i], device=dev)
                  for k in ("pc", "po", "pm", "gt"))
            for i in range(len(packed["pc"]))]


def dp_phase(dev, smi: str, scene, tstate, tcfg, topt, tres) -> dict[str, int]:
    """The data-parallel steps under NCCL (one rank, this process) and gloo
    (two spawned ranks on the one card) against single-process steps, the
    DP codec step, the DP step and its all-reduce timed, resume at full
    width, and the dry run. Returns K1's launches in the phase."""
    log(f"  card: {smi} (every time below is on it)")
    params0, rest0 = hac.split_state(tstate)
    rcfg = tres["rcfg"]
    optimizer = hac_train.make_optimizer(topt, scene.cameras_extent)
    cams = [hac_render.CameraArrays.from_camera(c, dev, with_image=True)
            for c in scene.train_cameras[:2]]
    codec_cfg = pcgc_model.NetConfig()
    packed = dp_codec_patches(DP_PATCH_POINTS)
    secs, mark = {}, [time.perf_counter()]

    def lap(part: str) -> None:  # the phase's seconds by part
        now = time.perf_counter()
        secs[part] = now - mark[0]
        mark[0] = now
    gen = torch.Generator(device=dev).manual_seed(SEED)
    noises = [scene_noise(params0, rest0, tcfg, gen) for _ in cams]
    start = (params0, rest0, tres["opt_state"], tres["stats"])
    tile_blend.launches = 0
    tile_blend.backward_launches = 0
    hashgrid.backward_launches = 0

    def single_runs(cam, phase, noise, zero_stats=False) -> list[dict]:
        out = []
        for _ in range(DP_SPREAD_RUNS):
            p, r, o, s = train_copy(*start)
            if zero_stats:
                s = {k: torch.zeros_like(v) for k, v in s.items()}
            out.append(train_step_body(tcfg, rcfg, optimizer, topt, p, r, o,
                                       s, cam, phase, noise))
        return out

    def codec_runs(packs) -> list[dict]:
        net = convert.load_codec_npz(CODEC_WEIGHTS, codec_cfg, device=dev)
        out = []
        for _ in range(DP_SPREAD_RUNS):
            grads = [dp.patch_gradients(net, codec_cfg, patch_levels(p, dev),
                                        p["n_points"])[0] for p in packs]
            out.append({"grad": {k: sum(g[k] for g in grads) / len(grads)
                                 for k in grads[0]}})
        return out

    # the gloo pair's inputs, from the trained state before anything moves
    tmp = tempfile.mkdtemp(prefix="dp-")
    in_path = f"{tmp}/inputs.npz"
    pdist.write_inputs(
        in_path,
        scene=dp_scene.scene_inputs(
            tstate, tcfg, "hac", cams, rcfg, topt, scene.cameras_extent, 2,
            noise=tuple(torch.stack([n[i] for n in noises]) for i in range(3)),
            opt_state=tres["opt_state"], stats=tres["stats"],
            white_background=True),
        codec=dp.codec_inputs(convert.load_codec_npz(
            CODEC_WEIGHTS, codec_cfg, device=dev), codec_cfg, packed))

    # (a) NCCL, one rank: this process
    t0 = time.perf_counter()
    rank_dev = pdist.init(0, 1, "nccl", "cuda", f"{tmp}/rdzv")
    log(f"  (a) NCCL process group, world 1, on {rank_dev} "
        f"({time.perf_counter() - t0:.3f} s to initialise)")
    try:
        for phase in DP_PHASES:
            noise = noises[0] if phase > 0 else None
            runs = single_runs(cams[0], phase, noise)
            p, r, o, s = train_copy(*start)
            step = dp_scene.make_dp_scene_step(tcfg, rcfg, optimizer, topt,
                                               white_background=True)
            _, o, s, m = step(p, r, o, s, dp_scene.stack_cameras(cams[:1]),
                              phase=phase, noise=None if noise is None
                              else tuple(n[None] for n in noise))
            hold_within_spread(f"(a) phase {phase}, DP step (NCCL, 1 rank) vs "
                               f"make_train_step's body",
                               step_record(o, s, m["grads"]), runs)
            del runs

        lap("(a)")

        # (c) the DP codec step under NCCL, one rank, on patch 0; then once
        # on a KD part of the codec trainer's own size, timed
        def codec_dp_step(patch):
            net = convert.load_codec_npz(CODEC_WEIGHTS, codec_cfg, device=dev)
            c_opt = dp.adam(1e-3)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, bpp, grads = dp.make_dp_train_step(c_opt, codec_cfg)(
                net, c_opt.init(dict(net.named_parameters())),
                dp.stack_patches([patch], dev))
            torch.cuda.synchronize()
            return bpp, grads, (time.perf_counter() - t1) * 1e3

        bpp, grads, step_ms = codec_dp_step(packed[0])
        hold_within_spread("(c) DP codec step (NCCL, 1 rank) vs patch_gradients",
                           {"grad": grads}, codec_runs(packed[:1]))
        del grads
        log(f"  (c) NetConfig{tuple(codec_cfg)} with {CODEC_WEIGHTS.name}: "
            f"patch 0 at {bpp:.4f} bpp, the DP step {step_ms:.3f} ms (host "
            f"wall clock, synchronised)")
        big = dp_codec_patches(pcgc_data.MAX_PATCH_POINTS)[0]
        big_bpp, _, big_ms = codec_dp_step(big)
        log(f"  (c) at the codec trainer's patch size (KD parts of at most "
            f"{pcgc_data.MAX_PATCH_POINTS} points): patch 0 "
            f"({int(big['n_points'])} points) one DP step {big_ms:.3f} ms "
            f"(host wall clock, synchronised; {smi}), {big_bpp:.4f} bpp; "
            f"the checks run at {DP_PATCH_POINTS} points for the phase's time")
        del big
        lap("(c) NCCL")

        # (d) 20 DP steps under NCCL, one rank, beside make_train_step
        p, r, o, s = train_copy(*start)
        single = hac_train.make_train_step(tcfg, rcfg, optimizer, topt,
                                           white_background=True)
        step = dp_scene.make_dp_scene_step(tcfg, rcfg, optimizer, topt,
                                           white_background=True)
        stacked = dp_scene.stack_cameras(cams[:1])
        box = {"o": o, "s": s}

        def dp_step():
            _, box["o"], box["s"], box["m"] = step(
                p, r, box["o"], box["s"], stacked, phase=2, generator=gen)

        def single_step():
            _, box["o"], box["s"], _ = single(p, r, box["o"], box["s"],
                                              cams[0], phase=2, generator=gen)

        turns = []
        for who, fn in (("make_train_step", single_step), ("DP step", dp_step),
                        ("DP step", dp_step), ("make_train_step", single_step)):
            turns.append(cuda_ms(fn, DP_TIMED_STEPS))
            log(f"  (d) turn {len(turns)}: {who} {turns[-1]:.4f} ms a step "
                f"(CUDA events over {DP_TIMED_STEPS} phase-2 steps)")
        nbytes = pdist.bucket_bytes(box["m"]["grads"]) + 16
        bucket = {k: v.clone() for k, v in box["m"]["grads"].items()}
        timer = profiling.PhaseTimer(dev)
        for _ in range(DP_TIMED_STEPS):
            with timer.phase("all_reduce_mean_"):
                pdist.all_reduce_mean_(bucket)
        with profiling.trace(f"{tmp}/trace", dev) as prof:
            for _ in range(DP_PROFILED_STEPS):
                dp_step()
        coll = [e for e in prof.key_averages()
                if "nccl" in e.key.lower() or "all_reduce" in e.key.lower()]
        dev_us = sum(e.device_time_total if hasattr(e, "device_time_total")
                     else e.cuda_time_total for e in coll)
        log(f"  (d) DP step {(turns[1] + turns[2]) / 2:.4f} ms, make_train_step "
            f"{(turns[0] + turns[3]) / 2:.4f} ms (means of the turns; {smi}); "
            f"all-reduce of {nbytes} bytes a step: "
            f"{timer.totals['all_reduce_mean_'] / DP_TIMED_STEPS * 1e3:.4f} ms "
            f"(PhaseTimer, synchronised, the bucket's packing included; "
            f"{timer.summary()}); under torch.profiler over "
            f"{DP_PROFILED_STEPS} DP steps "
            + (", ".join(f"{e.key} x{e.count} {e.cpu_time_total / DP_PROFILED_STEPS / 1e3:.4f} "
                         f"ms host" for e in coll) or "no collective event")
            + f", device {dev_us / DP_PROFILED_STEPS / 1e3:.4f} ms a step "
            f"({'no NCCL kernel: a one-rank all-reduce launches none' if not dev_us else 'NCCL kernels'})")
        log(f"  (d) device_memory_stats(): {profiling.device_memory_stats()}")
        lap("(d)")
        del bucket, box, p, r, o, s
    finally:
        torch.distributed.destroy_process_group()

    # (b) and (c): gloo, two ranks on the one card, CUDA tensors
    t0 = time.perf_counter()
    pdist.launch((dp_scene.rank_main, dp.rank_main), 2, "gloo", "cuda",
                 in_path, tmp)
    log(f"  (b) gloo, 2 ranks on cuda:0 (NCCL refuses two ranks on one "
        f"device), CUDA tensors reduced as they are, no host staging in the "
        f"port's code: spawned, one DP scene step and one DP codec step in "
        f"{time.perf_counter() - t0:.3f} s")
    outs = []
    for rk in range(2):
        with np.load(pdist.output_path(tmp, "scene", rk)) as f:
            outs.append({k: f[k] for k in f.files})
    for key in outs[0]:
        if key.startswith(("leaf/", "mu/", "nu/", "stat/")) and not \
                np.array_equal(outs[0][key], outs[1][key]):
            raise RuntimeError(f"(b) the ranks' {key} differ")
    log(f"  (b) both ranks' leaves, moments and statistics bitwise equal; "
        f"K1 launches on the ranks: {[int(o['launches']) for o in outs]} "
        f"forward, {[int(o['backward_launches']) for o in outs]} backward")
    per_cam = [single_runs(c, 2, n, zero_stats=True) for c, n in zip(cams, noises)]
    leaves0 = hac_train.param_leaves(params0)
    combos = [mean_record(a, b, tres["stats"], optimizer, tres["opt_state"],
                          leaves0) for a, b in zip(*per_cam)]
    del per_cam
    got = {kind: {k[len(kind) + 1:]: torch.from_numpy(v).to(dev)
                  for k, v in outs[0].items() if k.startswith(kind + "/")}
           for kind in ("grad", "mu", "nu", "stat")}
    hold_within_spread("(b) phase 2, DP step (gloo, 2 ranks) vs the mean of two "
                       "single steps", got, combos)
    del combos, got
    with np.load(pdist.output_path(tmp, "codec", 0)) as f0, \
            np.load(pdist.output_path(tmp, "codec", 1)) as f1:
        for key in f0.files:
            if key.startswith("param/") and not np.array_equal(f0[key], f1[key]):
                raise RuntimeError(f"(c) the ranks' {key} differ")
        cgot = {"grad": {k[len("grad/"):]: torch.from_numpy(f0[k]).to(dev)
                         for k in f0.files if k.startswith("grad/")}}
        cbpp = float(f0["bpp"])
    hold_within_spread("(c) DP codec step (gloo, 2 ranks) vs the mean of two "
                       "patch_gradients", cgot, codec_runs(packed))
    log(f"  (c) gloo pair: mean bpp {cbpp:.4f}; both ranks' parameters "
        f"bitwise equal")
    scene_launches = (sum(int(o["launches"]) for o in outs),
                      sum(int(o["backward_launches"]) for o in outs))
    del outs, cgot
    shutil.rmtree(tmp, ignore_errors=True)
    lap("(b) and (c) gloo")

    # (e) resume at full width: straight, cut at 50, resumed to 100; and
    # the step after a snapshot, straight and resumed
    with tempfile.TemporaryDirectory() as rtmp:
        kw = dict(voxel_size=VOXEL_SIZE, white_background=True, log_every=0,
                  device=dev, log=lambda m: None)

        def run(name, **train_kw):
            state, rc, _, res = soak.train(
                scene, RESUME_STEPS, model_dir=f"{rtmp}/{name}", train_kw=dict(
                    checkpoint_every=RESUME_EVERY, **train_kw), **kw)
            return state, rc, res

        def snapshot(name, suffix=""):
            return pipeline.load_training_snapshot(
                f"{rtmp}/{name}/train_ckpt.pkl{suffix}", rc, dev)

        t0 = time.perf_counter()
        s_straight, rc, r_straight = run("straight")
        s_again, _, _, _ = soak.train(scene, RESUME_STEPS, **kw)
        s_cut, _, r_cut = run("cut", stop_at=RESUME_EVERY)
        snap = snapshot("cut")
        exact = [torch.equal(snap["state"]["anchors"][k], s_cut["anchors"][k])
                 for k in s_cut["anchors"]]
        exact += [torch.equal(snap["state"][k], s_cut[k])
                  for k in ("valid", "x_bound_min", "x_bound_max")]
        exact += [torch.equal(a, b) for a, b in zip(
            s_cut["nets"].parameters(), snap["state"]["nets"].parameters())]
        for mom in ("mu", "nu"):
            exact += [torch.equal(snap["opt_state"][mom][k], v)
                      for k, v in r_cut["opt_state"][mom].items()]
        exact += [torch.equal(snap["stats"][k], v)
                  for k, v in r_cut["stats"].items()]
        exact += [snap["opt_state"]["count"] == r_cut["opt_state"]["count"],
                  snap["caps"] == (r_cut["rcfg"].max_tiles_per_gaussian,
                                   r_cut["rcfg"].max_gaussians_per_tile),
                  same_host_states(snap, snapshot("straight", ".prev"))]
        if not all(exact):
            raise RuntimeError(f"(e) the snapshot reloads {exact.count(False)} "
                               f"of {len(exact)} values differently")
        log(f"  (e) snapshot at step {snap['iteration']}: all {len(exact) - 1} "
            f"tensors and values reload as the cut run left them (the "
            f"moments' count and the caps among them), and its generator, "
            f"numpy rng, camera order and caps are those of the straight "
            f"run's snapshot at step {RESUME_EVERY}")
        s_res, _, r_res = run("resumed", start_checkpoint=f"{rtmp}/cut/"
                                                          "train_ckpt.pkl")
        ends_same = same_host_states(snapshot("straight"), snapshot("resumed"))
        # the step after a snapshot: straight on from it in memory, and
        # resumed from it in fresh train_scene calls
        s_next, _, r_next = run("next", stop_at=RESUME_EVERY + 1)
        resumed_next = [run(f"next_resumed{i}", stop_at=RESUME_EVERY + 1,
                            start_checkpoint=f"{rtmp}/next/train_ckpt.pkl")
                        for i in range(RESUME_SPREAD_RUNS)]
        wall = time.perf_counter() - t0
    same = {"anchors": torch.equal(s_res["anchors"]["anchor"],
                                   s_straight["anchors"]["anchor"]),
            "valid": torch.equal(s_res["valid"], s_straight["valid"]),
            "caps": r_res["rcfg"] == r_straight["rcfg"],
            "order, rng, generator": ends_same}

    def moved(a, b):
        return max(float((a["anchors"][k] - b["anchors"][k]).detach().abs().max())
                   for k in hac.TRAINABLE_ANCHOR_FIELDS)

    drift, drift_again = moved(s_res, s_straight), moved(s_again, s_straight)
    psnr = [pipeline.evaluate(s, tcfg, scene.test_cameras, max_k=EVAL_K,
                              white_background=True)["psnr"]
            for s in (s_straight, s_again, s_res)]
    log(f"  (e) {RESUME_STEPS} steps straight (twice), {RESUME_EVERY} then a "
        f"resume to {RESUME_STEPS}, {RESUME_EVERY + 1} straight and "
        f"{RESUME_SPREAD_RUNS} resumes to {RESUME_EVERY + 1} ({wall:.3f} s "
        f"for the {6 + RESUME_SPREAD_RUNS} runs): at {RESUME_STEPS} the "
        f"anchors' positions, valid, caps (D="
        f"{r_res['rcfg'].max_tiles_per_gaussian} K="
        f"{r_res['rcfg'].max_gaussians_per_tile}), camera order, rng and "
        f"generator states equal: {same} (the soak's schedule does not "
        f"densify in {RESUME_STEPS} steps); the trained anchor fields differ "
        f"from the straight run's by at most {drift:.3e} resumed and "
        f"{drift_again:.3e} straight again (the card's atomics, through "
        f"Adam; bound {RESUME_DRIFT_FACTOR:g}x the latter); held-out PSNR "
        f"{psnr[2]:.4f} dB resumed, {psnr[0]:.4f} / {psnr[1]:.4f} dB straight")
    if not all(same.values()):
        raise RuntimeError(f"(e) the resumed run differs from the straight one: "
                           f"{same}")
    if not drift <= RESUME_DRIFT_FACTOR * drift_again:
        raise RuntimeError(f"(e) the resumed run drifts {drift:.3e} from the "
                           f"straight one, beyond {RESUME_DRIFT_FACTOR:g}x "
                           f"a second straight run's {drift_again:.3e}")
    hold_within_spread(
        f"(e) step {RESUME_EVERY + 1} (phase 1, noise from the restored "
        f"generator), straight on from the snapshot vs {RESUME_SPREAD_RUNS} "
        f"resumes", trained_record(s_next, r_next),
        [trained_record(st, res) for st, _, res in resumed_next])
    del s_straight, s_again, s_cut, s_res, s_next, resumed_next
    lap("(e)")

    launches = (tile_blend.launches, tile_blend.backward_launches,
                hashgrid.backward_launches)
    # the dry run, as a user runs it
    t0 = time.perf_counter()
    dry = subprocess.run(
        [sys.executable, "-m", "gauspcc_tpu_torch.parallel.dryrun", "--ranks",
         "1", "--backend", "nccl", "--device", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    line = dry.stdout.strip().splitlines()[-1] if dry.stdout.strip() else ""
    if dry.returncode != 0 or ": ok," not in line:
        raise RuntimeError(f"dryrun failed (exit {dry.returncode}):\n"
                           f"{dry.stdout[-2000:]}\n{dry.stderr[-4000:]}")
    log(f"  dryrun --ranks 1 --backend nccl --device cuda: {line} "
        f"({time.perf_counter() - t0:.3f} s)")
    lap("dry run")
    log("  the phase's seconds by part: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()))
    log(f"  K1 launches in the phase: {launches[0] + scene_launches[0]} forward, "
        f"{launches[1] + scene_launches[1]} backward (this process "
        f"{launches[0]} / {launches[1]}, the gloo ranks {scene_launches[0]} / "
        f"{scene_launches[1]}; the dry run's rank is not counted); K3 "
        f"backward launches in this process {launches[2]}")
    if not (launches[0] and launches[1] and scene_launches[0] and scene_launches[1]):
        raise RuntimeError("the DP steps did not launch both blend kernels")
    return {"tile_blend": launches[0] + scene_launches[0],
            "tile_blend_backward": launches[1] + scene_launches[1],
            "hashgrid_table_grad": launches[2]}


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix, the inverse of colmap.qvec2rotmat."""
    k = np.array([
        [r[0, 0] - r[1, 1] - r[2, 2], 0, 0, 0],
        [r[0, 1] + r[1, 0], r[1, 1] - r[0, 0] - r[2, 2], 0, 0],
        [r[0, 2] + r[2, 0], r[1, 2] + r[2, 1], r[2, 2] - r[0, 0] - r[1, 1], 0],
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1],
         r[0, 0] + r[1, 1] + r[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def write_colmap_scene(root: Path, n_images: int, wh: int, n_points: int,
                       seed: int = SEED) -> None:
    """A COLMAP scene as the sweep reads it: sparse/0/{cameras, images,
    points3D}.bin (one PINHOLE camera, orbit views of the origin, seeded
    points in [-0.6, 0.6]^3) and images/*.png of smooth seeded colours."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    sparse_dir, img_dir = root / "sparse" / "0", root / "images"
    sparse_dir.mkdir(parents=True)
    img_dir.mkdir()
    focal = wh * 1.2
    with open(sparse_dir / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, wh, wh))
        f.write(struct.pack("<4d", focal, focal, wh / 2, wh / 2))
    yy, xx = np.mgrid[0:wh, 0:wh].astype(np.float64) / wh
    with open(sparse_dir / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in range(n_images):
            cam = soak._orbit_camera(i, 2 * np.pi * i / n_images, wh, radius=3.0)
            name = f"frame_{i:03d}.png"
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<7d", *rotmat_to_qvec(cam.R.T), *cam.T))
            f.write(struct.pack("<i", 1) + name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
            phase = rng.random(3) * 2 * np.pi
            rgb = 0.5 + 0.4 * np.sin(np.stack([3 * xx, 2 * yy, 2 * (xx + yy)], -1)
                                     + phase)
            Image.fromarray((rgb * 255).astype(np.uint8)).save(img_dir / name)
    xyz = rng.random((n_points, 3)) * 1.2 - 0.6
    with open(sparse_dir / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n_points))
        for i in range(n_points):
            f.write(struct.pack("<Q3d3Bd", i + 1, *xyz[i],
                                *rng.integers(0, 256, 3).tolist(), 0.5))
            f.write(struct.pack("<Q", 0))


def viewer_message(cam) -> bytes:
    """The SIBR viewer's request for `cam`'s view: the view matrix with the
    axis flips NetworkGUI.receive undoes."""
    m = cam.world_view_transform.astype(np.float32).copy()
    m[:, 1] = -m[:, 1]
    m[:, 2] = -m[:, 2]
    payload = json.dumps({
        "resolution_x": cam.width, "resolution_y": cam.height, "train": True,
        "keep_alive": False, "scaling_modifier": 1.0, "fov_x": cam.fovx,
        "fov_y": cam.fovy, "z_near": 0.01, "z_far": 100.0,
        "view_matrix": m.reshape(-1).tolist()}).encode()
    return struct.pack("<I", len(payload)) + payload


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the training side closed early")
        buf += chunk
    return buf


def check_scene_decode(dec, state, cfg, values, data) -> list[str]:
    """The decoded HAC state against what the encoder wrote: anchors,
    masks, features, scalings, offsets and hash signs exactly."""
    n = values["feat"].shape[0]
    a = dec["anchors"]
    pairs = {
        "anchor": (a["anchor"][:n], data["anchor_int"].astype(np.float32) * cfg.voxel_size),
        "mask": (a["mask"][:n], data["mask"]),
        "feat": (a["anchor_feat"][:n], values["feat"]),
        "scaling": (a["scaling"][:n], values["scaling"]),
        "offset": (a["offset"][:n], values["offset"]),
        "hash": (dec["nets"].tables.flat().to(torch.int8),
                 hac.encoding_params_flat(state).to(torch.int8)),
    }
    for name, (got, want) in pairs.items():
        want = want.detach().cpu().numpy() if torch.is_tensor(want) else want
        if not np.array_equal(got.detach().cpu().numpy(), want):
            raise RuntimeError(f"decoded {name} differs from the encoder's")
    if int(dec["valid"].sum()) != n:
        raise RuntimeError("the decoded state holds another anchor count")
    return [f"{k} {tuple(v[0].shape)}" for k, v in pairs.items()]


def tools_phase(dev, smi: str, scene, tstate, tcfg) -> dict[str, int]:
    """The evaluation outputs, the viewer, soak_eval, sweep and the last
    functions ported (the factorized coder, sparse_conv_window) on the
    card, on the train phase's HAC state and scene. Returns the phase's
    launches of each kernel."""
    log(f"  card: {smi} (every time below is on it)")
    launches = dict.fromkeys(("tile_blend", "tile_blend_backward",
                              "rans_encode", "rans_decode",
                              "hashgrid_table_grad"), 0)

    def count():
        tile_blend.launches = tile_blend.backward_launches = 0
        rans.encode_launches = rans.decode_launches = 0
        hashgrid.backward_launches = 0

    def counted() -> tuple[int, int, int, int]:
        got = (tile_blend.launches, tile_blend.backward_launches,
               rans.encode_launches, rans.decode_launches)
        for k, v in zip(launches, got + (hashgrid.backward_launches,)):
            launches[k] += v
        return got

    secs, mark = {}, [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        secs[part] = now - mark[0]
        mark[0] = now

    net = convert.load_codec_npz(SCENE_CODEC_WEIGHTS, pcgc_model.NetConfig(),
                                 device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) evaluate's renders and LPIPS
        count()
        res = pipeline.evaluate(tstate, tcfg, scene.test_cameras, max_k=EVAL_K,
                                white_background=True, out_dir=str(tmp / "renders"))
        torch.cuda.synchronize()
        fwd = counted()[0]
        files = sorted(p.name for p in (tmp / "renders").iterdir())
        kind = files[0].rsplit(".", 1)[-1] if files else "none"
        if files != [f"{i:05d}.{kind}" for i in range(len(scene.test_cameras))]:
            raise RuntimeError(f"evaluate wrote {files}")
        for name, img in zip(files, res["renders"]):
            host = img.cpu().numpy()
            if kind == "npy":
                same = np.array_equal(np.load(tmp / "renders" / name), host)
            else:
                from PIL import Image

                same = np.array_equal(
                    np.asarray(Image.open(tmp / "renders" / name)),
                    np.clip(host.transpose(1, 2, 0) * 255.0, 0, 255).astype(np.uint8))
            if not same:
                raise RuntimeError(f"renders/{name} is not the view's render")
        if res["lpips_variant"] != "vgg_random_v1":
            raise RuntimeError(f"LPIPS variant {res['lpips_variant']!r}")
        per_view = [v["lpips_surrogate"] for v in res["per_view"].values()]
        if not all(np.isfinite(v) and v > 0 for v in per_view):
            raise RuntimeError(f"LPIPS per view {per_view}")
        fn = pipeline._lpips_for(dev)
        gts = [torch.from_numpy(c.image).to(dev) for c in scene.test_cameras]
        lp_ms = [cuda_ms(lambda: fn(img, gt), 3) for img, gt in zip(res["renders"], gts)]
        t0 = time.perf_counter()
        cpu_fn = lpips.load_default_lpips(device="cpu")
        on_cpu = float(cpu_fn(res["renders"][0].cpu(), gts[0].cpu()))
        cpu_s = time.perf_counter() - t0
        rel = abs(per_view[0] - on_cpu) / on_cpu
        log(f"  (a) evaluate at K={res['eval_k']} D={res['eval_d']}: "
            f"{len(files)} .{kind} renders, each equal to its view's render on "
            f"the host; PSNR {res['psnr']:.4f} dB, SSIM {res['ssim']:.4f}, "
            f"lpips_surrogate {res['lpips_surrogate']:.6f} "
            f"({', '.join(f'{v:.6f}' for v in per_view)}), variant "
            f"{res['lpips_variant']}; LPIPS ms per view (CUDA events, 3 runs "
            f"after a warm-up) {', '.join(f'{m:.4f}' for m in lp_ms)}; view 0 "
            f"card {per_view[0]:.8f} vs CPU {on_cpu:.8f}: rel {rel:.3e} (limit "
            f"{LPIPS_CPU_RTOL:g}; the CPU's module built and run in "
            f"{cpu_s:.3f} s); tile_blend launches {fwd}")
        if not rel <= LPIPS_CPU_RTOL:
            raise RuntimeError("the card's LPIPS disagrees with the CPU's")
        if fwd == 0:
            raise RuntimeError("evaluate did not launch the tile_blend kernel")
        lap("(a)")

        # (b) the viewer: a frame served between training steps
        gui = network_gui.NetworkGUI("127.0.0.1", 0)
        cam = scene.test_cameras[0]
        viewer = socket.create_connection(
            ("127.0.0.1", gui.listener.getsockname()[1]), timeout=120)
        viewer.sendall(viewer_message(cam))  # read at the first poll
        got, polled = {}, []

        def read_frame():
            try:
                got["img"] = recv_exact(viewer, cam.width * cam.height * 3)
                n = struct.unpack("<I", recv_exact(viewer, 4))[0]
                got["verify"] = recv_exact(viewer, n).decode()
            finally:
                viewer.close()

        real_poll = pipeline._poll_gui

        def poll(gui_, state, cfg_, verify, log=print):
            if not polled:
                polled.append(copy.deepcopy(state))
            real_poll(gui_, state, cfg_, verify, log=log)

        reader = threading.Thread(target=read_frame, daemon=True)
        reader.start()
        model_dir = str(tmp / "gui")
        gui_logs = []
        count()
        pipeline._poll_gui = poll
        try:
            pipeline.train_scene(
                scene, tcfg, hac_train.OptConfig(iterations=TOOLS_GUI_STEPS),
                white_background=True, device=dev, model_dir=model_dir,
                eval_at_end=False, log_every=0, gui=gui, log=gui_logs.append)
        finally:
            pipeline._poll_gui = real_poll
            gui.close()
        reader.join(timeout=120)
        torch.cuda.synchronize()
        fwd, bwd, _, _ = counted()
        if reader.is_alive() or "img" not in got:
            raise RuntimeError("the viewer got no frame")
        ca = hac_render.CameraArrays(
            viewmatrix=torch.from_numpy(cam.world_view_transform.astype(np.float32)).to(dev),
            camera_center=torch.from_numpy(
                np.linalg.inv(cam.world_view_transform.astype(np.float32))[3, :3]
                .astype(np.float32)).to(dev))
        rcfg = raster.RasterConfig(cam.height, cam.width, float(np.tan(cam.fovx * 0.5)),
                                   float(np.tan(cam.fovy * 0.5)),
                                   max_gaussians_per_tile=256)
        with torch.no_grad():
            want = network_gui.image_to_bytes(hac_render.render_view(
                polled[0], tcfg, ca, rcfg, torch.zeros(3, device=dev))["render"]
                .cpu().numpy())
        log(f"  (b) viewer on localhost: a {cam.width}x{cam.height} frame "
            f"({len(got['img'])} bytes) served before step 1 of "
            f"{TOOLS_GUI_STEPS}, verify {got['verify']!r}; equal to "
            f"image_to_bytes(render_view) of the state it polled: "
            f"{got['img'] == want}; tile_blend launches {fwd}, backward {bwd}; "
            f"the viewer's disconnect logged: "
            f"{any('viewer disconnected' in m for m in gui_logs)}")
        if got["img"] != want or got["verify"] != model_dir:
            raise RuntimeError("the viewer's frame or verify string is wrong")
        if fwd == 0:
            raise RuntimeError("the viewer's steps did not launch tile_blend")
        lap("(b)")

        # (c) soak_eval on a snapshot written here
        run = tmp / "soak"
        count()
        soak.train(scene, TOOLS_SOAK_STEPS, voxel_size=VOXEL_SIZE,
                   white_background=True, device=dev, model_dir=str(run),
                   log_every=0, log=lambda m: None,
                   train_kw=dict(checkpoint_every=TOOLS_SOAK_STEPS))
        soak_eval.main(["--run", str(run), "--hw", str(HW), "--gt_gaussians",
                        str(N_GT), "--cams", str(N_CAMS), "--seed_points",
                        str(N_SEED), "--voxel_size", str(VOXEL_SIZE), "--pcc_ckpt",
                        str(SCENE_CODEC_WEIGHTS), "--device", dev.type])
        with open(run / "soak_summary.json") as f:
            summary = json.load(f)
        snap = pipeline.load_training_snapshot(str(run / "train_ckpt.pkl"), tcfg, dev)
        values = {}
        sizes, _ = hac_codec.conduct_encoding(snap["state"], tcfg, str(tmp / "again"),
                                              net, values=values)
        dec, _ = hac_codec.conduct_decoding(snap["state"], tcfg,
                                            str(run / "bitstreams"), net)
        exact = check_scene_decode(dec, snap["state"], tcfg, values,
                                   hac_codec._gather_sorted_attributes(snap["state"], tcfg))
        torch.cuda.synchronize()
        fwd, bwd, enc, dcd = counted()
        log(f"  (c) soak_eval --device cuda on a {TOOLS_SOAK_STEPS}-step "
            f"snapshot: keys {sorted(summary)}; PSNR {summary['psnr']:.4f} dB, "
            f"size {summary['size_mb']:.4f} MB ({summary['size_bits']['total']} "
            f"bits; a second encode of the snapshot's state: {sizes['total']}); "
            f"its stream decoded again here, exact: {', '.join(exact)}; "
            f"launches: tile_blend {fwd}, backward {bwd}, rans_encode {enc}, "
            f"rans_decode {dcd}")
        if set(summary) != SOAK_SUMMARY_KEYS:
            raise RuntimeError(f"soak_summary.json keys {sorted(summary)}")
        if summary["size_bits"] != sizes or summary["iteration"] != TOOLS_SOAK_STEPS:
            raise RuntimeError("soak_eval's sizes or iteration disagree")
        if not np.isfinite(summary["psnr"]) or enc == 0 or dcd == 0:
            raise RuntimeError("soak_eval gave no PSNR or launched no rANS")
        lap("(c)")

        # (d) sweep on a COLMAP scene written here
        write_colmap_scene(tmp / "data" / "scene", *TOOLS_SWEEP_SCENE)
        count()
        sweep.main(["--data_root", str(tmp / "data"), "--dataset", "tandt",
                    "--scenes", "scene", "--lmbdas", TOOLS_SWEEP_LMBDAS,
                    "--iterations", str(TOOLS_SWEEP_STEPS), "--out_root",
                    str(tmp / "runs"), "--pcc_ckpt", str(SCENE_CODEC_WEIGHTS),
                    "--device", dev.type])
        with open(tmp / "runs" / "summary.json") as f:
            swept = json.load(f)
        torch.cuda.synchronize()
        fwd, bwd, enc, dcd = counted()
        log(f"  (d) sweep --device cuda, {TOOLS_SWEEP_SCENE[0]} images at "
            f"{TOOLS_SWEEP_SCENE[1]} px, {TOOLS_SWEEP_SCENE[2]} points, "
            f"{TOOLS_SWEEP_STEPS} steps a lambda: {json.dumps(swept)}; "
            f"launches: tile_blend {fwd}, backward {bwd}, rans_encode {enc}, "
            f"rans_decode {dcd}")
        want_runs = [f"scene/l{float(x)}" for x in TOOLS_SWEEP_LMBDAS.split(",")]
        if list(swept) != want_runs or not all(
                v["psnr"] is not None and np.isfinite(v["psnr"]) and v["size_mb"] > 0
                for v in swept.values()):
            raise RuntimeError("the sweep's summary lacks a run, a PSNR or a size")
        lap("(d)")

        # (e) the factorized coder and sparse_conv_window
        gen = torch.Generator().manual_seed(SEED)
        params = entropy.init_factorized_params(TOOLS_FACT_SHAPE[1], generator=gen)
        x = torch.from_numpy(np.random.default_rng(SEED).laplace(
            0, 6, TOOLS_FACT_SHAPE).astype(np.float32))
        params_dev = {k: [v.to(dev) for v in vs] for k, vs in params.items()}
        card_bits = ec.encode_factorized(params_dev, x.to(dev), 1.0, str(tmp / "f_card.b"))
        cpu_bits = ec.encode_factorized(params, x, 1.0, str(tmp / "f_cpu.b"))
        back = ec.decode_factorized(params_dev, *TOOLS_FACT_SHAPE, 1.0, str(tmp / "f_card.b"))
        same_bytes = (tmp / "f_card.b").read_bytes() == (tmp / "f_cpu.b").read_bytes()
        exact_fact = bool(torch.equal(back.cpu(), torch.round(x)))
        log(f"  (e) factorized coder, {TOOLS_FACT_SHAPE[0]} x {TOOLS_FACT_SHAPE[1]} "
            f"values: {card_bits} bits on the card, {cpu_bits} on the CPU, bytes "
            f"equal {same_bytes}, the card's decode exact {exact_fact} "
            f"(device {back.device})")
        if not (same_bytes and exact_fact and back.device.type == dev.type):
            raise RuntimeError("the factorized coder on the card disagrees")
        pts = bench_cloud()
        coords = sparse.dedupe_lex(pts - pts.min(axis=0))
        n = coords.shape[0]
        k = pcgc_model.NetConfig().kernel_size
        lo, codes = hostmap.build_map_packed(coords, n, k, n)
        packed = sparse.PackedLo(*(torch.from_numpy(a).to(dev)
                                   for a in sparse.pack_lo_np(lo)))
        wmap = sparse.WindowMap(sparse.expand_lo(packed, n),
                                torch.from_numpy(codes.astype(np.int32)).to(dev))
        cg = torch.Generator(device=dev).manual_seed(SEED)
        c = pcgc_model.NetConfig().channels
        feats = torch.randn((n, c), generator=cg, device=dev).to(torch.bfloat16)
        w = 0.05 * torch.randn((k**3, c, c), generator=cg, device=dev)
        b = torch.randn((c,), generator=cg, device=dev)
        nmap = sparse.nmap_from_packed(wmap, k)
        win = sparse.sparse_conv_window(feats, wmap, w, b)
        dense = sparse.sparse_conv_apply(feats, nmap, w, b)
        err = float((win.float() - dense.float()).abs().max())
        scale = float(dense.float().abs().max())
        win_ms = cuda_ms(lambda: sparse.sparse_conv_window(feats, wmap, w, b), 5)
        dense_ms = cuda_ms(lambda: sparse.sparse_conv_apply(feats, nmap, w, b), 5)
        log(f"  (e) sparse_conv_window on the bench cloud's {n} voxels (k {k}, "
            f"C {c}, bf16, the window map from pack_lo_np and expand_lo) against "
            f"sparse_conv_apply over nmap_from_packed: max |diff| {err:.4e} "
            f"of the largest |y| {scale:.4e} (limit one bf16 step, 2^-7 of "
            f"it); {win_ms:.4f} ms against {dense_ms:.4f} ms (CUDA events, 5 "
            f"runs after a warm-up)")
        if not err <= 2.0**-7 * scale:
            raise RuntimeError("sparse_conv_window disagrees with the dense conv")
        lap("(e)")
    log("  the phase's seconds by part: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items()))
    log(f"  launches in the phase: {launches}")
    return launches


def decode_scene_main(tmp: str, device="cuda") -> int:
    """--decode-scene: in this fresh process, load the handed-off family,
    configuration and state, decode the scene twice (the second with
    counted launches), check it exactly against what the encoder wrote (for
    HAC++ each feature chunk too), evaluate it on the held-out views, check
    one decoded frame's blend against the plain version and print one JSON
    line."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(Path(tmp) / "cfg.json") as f:
        meta = json.load(f)
    family = registry.get_family(meta["model"])
    cfg = family.make_config(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in meta["cfg"].items()})
    base = cfg.as_hac() if hasattr(cfg, "as_hac") else cfg
    state = convert.state_from_numpy(
        checkpoint.load_pytree(str(Path(tmp) / "state.npz")), cfg, device=dev)
    net = convert.load_codec_npz(SCENE_CODEC_WEIGHTS, device=dev)
    bs_dir = str(Path(tmp) / "bitstreams")
    t0 = time.perf_counter()
    family.conduct_decoding(state, cfg, bs_dir, net)
    first_s = time.perf_counter() - t0
    rans.decode_launches = 0
    prof = {}
    dec, _ = family.conduct_decoding(state, cfg, bs_dir, net, profile=prof)
    rans_launches = rans.decode_launches
    want = np.load(Path(tmp) / "expect.npz")
    n = want["feat"].shape[0]
    a = dec["anchors"]
    got = {"anchor": a["anchor"][:n], "mask": a["mask"][:n],
           "feat": a["anchor_feat"][:n], "scaling": a["scaling"][:n],
           "offset": a["offset"][:n]}
    if hasattr(dec["nets"], "tables"):
        got["hash"] = dec["nets"].tables.flat().to(torch.int8)
    if hasattr(dec["nets"], "planes"):  # TC-GS: the latent and its planes
        got["latent"] = torch.from_numpy(np.load(
            Path(bs_dir) / tcgs_codec.LATENT_FILE)["latent"])
        got["planes"] = dec["nets"].planes
    if hasattr(dec["nets"], "field"):  # CAT-3DGS: the integer planes
        for i, planes in enumerate(cat_field.quantized_planes(dec["nets"].field)):
            got[f"planes_{i}"] = planes
    checked = [f"{name} {tuple(t.shape)}" for name, t in got.items()]
    for name, t in got.items():
        if not np.array_equal(t.detach().cpu().numpy(), want[name]):
            raise RuntimeError(f"decoded {name} differs from the encoder's")
    if hasattr(cfg, "chunk"):
        feat = got["feat"].cpu().numpy()
        for cc in range(hacp.N_CHUNKS):
            cols = slice(cc * cfg.chunk, (cc + 1) * cfg.chunk)
            if not np.array_equal(feat[:, cols], want["feat"][:, cols]):
                raise RuntimeError(f"decoded feature chunk {cc} differs")
            checked.append(f"feat chunk {cc}")
    if hasattr(cfg, "chcm_slices"):
        feat = got["feat"].cpu().numpy()
        for i, cols in enumerate(cat_codec._slices(cfg)):
            if not np.array_equal(feat[:, cols], want["feat"][:, cols]):
                raise RuntimeError(f"decoded feature slice {i} differs")
            checked.append(f"feat slice {i}")
    if int(dec["valid"].sum()) != n:
        raise RuntimeError("the decoded state holds another anchor count")
    with open(Path(tmp) / "cams.pkl", "rb") as f:
        cams = pickle.load(f)
    tile_blend.launches = 0
    res = pipeline.evaluate(dec, cfg, cams, max_k=EVAL_K, white_background=True,
                            decoded=True)
    torch.cuda.synchronize()
    blend_launches = tile_blend.launches
    # one decoded frame blended by the kernel and the plain version
    rcfg = pipeline._raster_cfg(cams[0], res["eval_k"], res["eval_d"])
    ca = hac_render.CameraArrays.from_camera(cams[0], dev)
    bg = torch.ones(3, device=dev)
    with torch.no_grad():
        vis = hac_render.prefilter_voxel(dec, base, ca, rcfg, True)
        ng, _ = hac.generate_neural_gaussians(dec, base, ca.camera_center, vis,
                                              decoded=True)
        proj = raster.project(ng.xyz, ng.scaling, ng.rot, ca.viewmatrix, rcfg,
                              ng.valid)
        ts, pg, _ = raster._build_tile_lists(proj, rcfg)
    frame = (ts, pg, proj.mean2d, proj.conic, ng.opacity.reshape(-1), ng.color, bg)
    kw = dict(tiles_x=rcfg.tiles_x, height=cams[0].height, width=cams[0].width,
              max_k=rcfg.max_gaussians_per_tile)
    img = tile_blend.blend_tiles(*frame, **kw)
    torch.cuda.synchronize()
    if not torch.equal(img, res["renders"][0]):
        raise RuntimeError("the decoded frame re-blended from its lists differs "
                           "from evaluate's render")
    rtol, atol = tile_blend.kernel_tolerance(bg, frame[5])
    err = check_close("decoded frame, kernel vs plain", img,
                      tile_blend.blend_tiles_reference(*frame, **kw), rtol, atol)
    print(json.dumps({"model": meta["model"], "exact": checked,
                      "first_s": first_s, "profile": prof,
                      "rans_decode": rans_launches, "tile_blend": blend_launches,
                      "psnr": res["psnr"], "eval_k": res["eval_k"],
                      "eval_d": res["eval_d"],
                      "ms": [v["ms"] for v in res["per_view"].values()],
                      "frame_err": err}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, default=None,
                        help="an earlier tile_blend.cu to time beside the kernel")
    parser.add_argument("--baseline-rans", type=Path, default=None,
                        help="an earlier rans.cu (same C interface) to check "
                        "and time beside the rANS kernels")
    parser.add_argument("--decode", metavar="BIN", default=None,
                        help="only decode BIN with the r5 codec weights (the "
                        "codec phase runs this in a fresh process)")
    parser.add_argument("--out", metavar="NPY", default=None,
                        help="with --decode: where to save the decoded points")
    parser.add_argument("--weights", metavar="NPZ", type=Path, default=CODEC_WEIGHTS,
                        help="with --decode: the codec weights (the r5 ones by "
                        "default; the codec_train phase passes its own)")
    parser.add_argument("--decode-scene", metavar="DIR", default=None,
                        help="only decode and evaluate the scene handed off "
                        "in DIR (the scene codec, hac_plus, tcgs and cat3dgs "
                        "phases run this in a fresh process)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if opts.decode is not None:
        return decode_main(opts.decode, opts.out, opts.weights)
    if opts.decode_scene is not None:
        return decode_scene_main(opts.decode_scene)
    dev = torch.device("cuda")
    # float32 matmuls in full precision (the default), stated and set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.strip().splitlines()[0]
        log(smi)
        max_sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.split()[0])
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        log(f"  {n_sms} SMs, clocks.max.sm {max_sm_mhz:g} MHz")
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)")

    with Phase("build"):
        sources = ("tile_blend", "rans", "hashgrid")
        hosts = ("ac_coder", "neighbor")
        with ThreadPoolExecutor(len(sources) + len(hosts)) as pool:
            host_builds = [pool.submit(native.load_host, h) for h in hosts]
            builds = list(pool.map(native.load, sources))  # one nvcc per source
            host_libs = [h.result() for h in host_builds]
        for name, built in zip(sources, builds):
            log(f"  {name}: nvcc {built.seconds:.3f} s -> {built.path.name}")
            for line in ptxas_lines(built.log):
                log(f"  ptxas {line}")
        for name, lib in zip(hosts, host_libs):
            log(f"  {name} (host): g++ {lib.seconds:.3f} s -> {lib.path.name}")

    with Phase("kernel"):
        gen = torch.Generator().manual_seed(SEED)
        args = random_tiles(gen, dev, 32, 32, EVAL_K)
        kw = dict(tiles_x=32, height=HW, width=HW, max_k=EVAL_K)
        got = tile_blend.blend_tiles(*args, **kw)
        torch.cuda.synchronize()
        want = tile_blend.blend_tiles_reference(*args, **kw)
        counts = args[0][1:] - args[0][:-1]
        log(f"  random tiles: {int((counts == 0).sum())} empty, "
            f"{int((counts > EVAL_K).sum())} over K={EVAL_K}, "
            f"{int(counts.sum())} entries")
        rtol, atol = tile_blend.kernel_tolerance(args[6], args[5])
        check_close("random tiles, kernel vs plain", got, want, rtol, atol)
        # the backward against autograd of the plain version, for a seeded
        # upstream gradient, on these tiles at K = 1024 and at K = 256
        g = torch.randn((3, HW, HW), generator=torch.Generator().manual_seed(SEED)
                        ).to(dev)
        check_gradients("random tiles, K=1024, backward vs plain autograd",
                        args, got, g, kw)
        kw256 = dict(kw, max_k=256)
        check_gradients("random tiles, K=256, backward vs plain autograd",
                        args, tile_blend.blend_tiles(*args, **kw256), g, kw256)
        # thin Gaussians near 45 degrees with alpha at the 1/255 cut
        cut = cut_lists(dev, 32, 32)
        kw_cut = dict(kw, max_k=4)
        cut_out = tile_blend.blend_tiles(*cut, **kw_cut)
        torch.cuda.synchronize()
        cut_want = tile_blend.blend_tiles_reference(*cut, **kw_cut)
        rtol_c, atol_c = tile_blend.kernel_tolerance(cut[6], cut[5])
        check_close("thin Gaussians at the cut, kernel vs plain", cut_out,
                    cut_want, rtol_c, atol_c)
        check_gradients("thin Gaussians at the cut, backward vs plain autograd",
                        cut, cut_out, g, kw_cut)
        base_lib = None
        if opts.baseline is not None:
            base_lib = baseline_library(opts.baseline)
            base_cut = baseline_launcher(base_lib, cut, kw_cut)()
            torch.cuda.synchronize()
            diff = (base_cut - cut_want).abs()
            log(f"  baseline on the thin Gaussians at the cut: max |diff| "
                f"{float(diff.max()):.3e}, "
                f"{int((diff > atol_c + rtol_c * cut_want.abs()).sum())} values "
                f"outside the tolerance (reported, not checked)")
        k3 = check_table_grads(dev)

    with Phase("scene"):
        scene = soak.build_scene(np.random.default_rng(SEED), HW, N_GT, N_CAMS,
                                 N_SEED, white_background=True, device=dev)
        torch.cuda.synchronize()
        log(f"  {len(scene.train_cameras)} train / {len(scene.test_cameras)} "
            f"test cameras at {HW}x{HW}, {scene.points.shape[0]} seed points")

    with Phase("serve"):
        cfg = hac.HACConfig(voxel_size=VOXEL_SIZE)
        points = hac.voxelize_points(scene.points, cfg.voxel_size, SEED)
        state = hac.update_anchor_bound(hac.init_state(
            cfg, points, np.random.default_rng(SEED), device=dev))
        cap = state["valid"].shape[0]
        spec = cfg.grid_spec
        log(f"  HAC state (seeded, untrained): {points.shape[0]} anchors in "
            f"capacity {cap}, {cap * cfg.n_offsets} neural Gaussians, "
            f"feat_dim {cfg.feat_dim}, n_offsets {cfg.n_offsets}, "
            f"{spec.xyz.n_rows + 3 * spec.plane.n_rows} table rows")
        torch.cuda.reset_peak_memory_stats()
        tile_blend.launches = 0
        res = pipeline.evaluate(state, cfg, scene.test_cameras, max_k=EVAL_K,
                                white_background=True)
        torch.cuda.synchronize()
        launches = tile_blend.launches
        log(f"  K={res['eval_k']} D={res['eval_d']}, tile_blend launches in "
            f"evaluate: {launches}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if launches == 0:
            raise RuntimeError("evaluate did not launch the tile_blend kernel")
        for name, v in res["per_view"].items():
            log(f"  view {name}: {v['ms']:.3f} ms after warm-up, PSNR "
                f"{v['psnr']:.3f} dB, SSIM {v['ssim']:.4f} (untrained state: "
                f"a smoke number, not a quality figure)")
        serve_psnr = res["psnr"]
        for img in res["renders"]:
            if img.shape != (3, HW, HW) or not bool(torch.isfinite(img).all()):
                raise RuntimeError(f"bad render: {tuple(img.shape)}")
            if float(img.min()) < -1e-5 or float(img.max()) > 1 + 1e-5:
                raise RuntimeError("render outside [0, 1]")

        # one whole frame, kernel against plain version on the same lists
        cam = scene.test_cameras[0]
        rcfg = pipeline._raster_cfg(cam, res["eval_k"], res["eval_d"])
        ca = hac_render.CameraArrays.from_camera(cam, dev)
        bg = torch.ones(3, device=dev)
        with torch.no_grad():
            visible = hac_render.prefilter_voxel(state, cfg, ca, rcfg)
            ng, _ = hac.generate_neural_gaussians(state, cfg, ca.camera_center,
                                                  visible)
            proj = raster.project(ng.xyz, ng.scaling, ng.rot, ca.viewmatrix,
                                  rcfg, ng.valid)
            tile_start, pair_gauss, _ = raster._build_tile_lists(proj, rcfg)
        frame = (tile_start, pair_gauss, proj.mean2d, proj.conic,
                 ng.opacity.reshape(-1), ng.color, bg)
        kw = dict(tiles_x=rcfg.tiles_x, height=HW, width=HW, max_k=rcfg.max_gaussians_per_tile)
        got = tile_blend.blend_tiles(*frame, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, res["renders"][0]):
            raise RuntimeError("frame re-blended from the same lists differs "
                               "from evaluate's render")
        want = tile_blend.blend_tiles_reference(*frame, **kw)
        rtol, atol = tile_blend.kernel_tolerance(bg, frame[5])
        frame_err = check_close("whole frame, kernel vs plain", got, want, rtol, atol)
        counts = tile_start[1:] - tile_start[:-1]
        log(f"  frame: {int(proj.radius.gt(0).sum())} Gaussians on screen, "
            f"{int(counts.sum())} pairs, {int(counts.gt(rcfg.max_gaussians_per_tile).sum())} "
            f"of {rcfg.n_tiles} tiles over K")
        shape = tile_blend.launch_shape(rcfg.n_tiles)
        log(f"  launch: {shape['blocks']} blocks x {shape['threads']} threads, "
            f"{shape['pix_per_thread']} pixels per thread, "
            f"{shape['shared_bytes']} B static shared memory, "
            f"{shape['blocks_per_sm']} resident blocks per SM, "
            f"{shape['registers']} registers")
        kernel_ms, host_ms = device_ms(
            lambda: tile_blend.blend_tiles(*frame, **kw), 20)
        events_ms = cuda_ms(lambda: tile_blend.blend_tiles(*frame, **kw), 20)
        plain_ms = cuda_ms(lambda: tile_blend.blend_tiles_reference(*frame, **kw), 3)
        bound_ms, bound_by, detail = blend_bound(*frame[:5], **kw)
        log(f"  tile_blend at the frame's shapes: kernel {kernel_ms:.4f} ms "
            f"(device time, behind a delay; host enqueue {host_ms:.4f} ms a "
            f"call; {events_ms:.4f} ms by CUDA events over 20 back-to-back "
            f"calls), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {detail})")
        per_tile, _ = entries_per_tile(*frame[:5], tiles_x=rcfg.tiles_x,
                                       max_k=kw["max_k"])
        mean_load = float(per_tile.double().mean())
        log(f"  per-tile load: largest {int(per_tile.max())}, mean "
            f"{mean_load:.1f} evaluated pixel-entries per tile (largest / "
            f"mean {int(per_tile.max()) / max(mean_load, 1e-9):.3f}), "
            f"{int((per_tile == per_tile.max()).sum())} tiles at the largest")
        sfu_ms = int(per_tile.sum()) / (SFU_EXP_PER_CLOCK * n_sms
                                        * max_sm_mhz * 1e6) * 1e3
        log(f"  SFU term beside the bound: {int(per_tile.sum())} exps at "
            f"{SFU_EXP_PER_CLOCK} a clock per SM x {n_sms} SMs at "
            f"{max_sm_mhz:g} MHz = {sfu_ms:.4f} ms")
        # the two kernels of a call, each alone, by the profiler's device
        # times over 20 calls
        _, _, top = device_profile(
            lambda: [tile_blend.blend_tiles(*frame, **kw) for _ in range(20)])
        for part in ("order_kernel", "blend_kernel"):
            hit = [(n, ms) for name, n, ms in top if part in name]
            log(f"  {part}: " + (f"{hit[0][1] / hit[0][0]:.4f} ms a launch "
                                 f"(torch.profiler, {hit[0][0]} launches)"
                                 if hit else "not measured (no device time "
                                 "in the profile)"))
        if base_lib is not None:
            base = baseline_launcher(base_lib, frame, kw)
            base_img = base()
            check_close("baseline, frame vs plain", base_img, want, rtol, atol)
            if not torch.equal(base_img, got):
                raise RuntimeError("the forward's image differs from the "
                                   "baseline's on the serve frame")
            log("  serve frame: the forward's image is bit-equal to the "
                "baseline's")
            turns = []
            for who in ("baseline", "kernel", "kernel", "baseline"):
                fn = base if who == "baseline" else (
                    lambda: tile_blend.blend_tiles(*frame, **kw))
                ms, host = device_ms(fn, 20)
                turns.append(ms)
                log(f"  turn {len(turns)}: {who} {ms:.4f} ms (host {host:.4f} ms)")
            log(f"  baseline {(turns[0] + turns[3]) / 2:.4f} ms, kernel "
                f"{(turns[1] + turns[2]) / 2:.4f} ms (means of the turns)")
        with torch.no_grad():
            stages = {
                "prefilter": lambda: hac_render.prefilter_voxel(
                    state, cfg, ca, rcfg),
                "context (hash grid + mlp_grid)": lambda: hac.grid_mlp_split(
                    state, cfg, hac.calc_interp_feat(
                        state, cfg, hac.get_anchor(state, cfg))),
                "neural Gaussians (context included)":
                    lambda: hac.generate_neural_gaussians(
                        state, cfg, ca.camera_center, visible),
                "project": lambda: raster.project(
                    ng.xyz, ng.scaling, ng.rot, ca.viewmatrix, rcfg, ng.valid),
                "tile lists (N*D sort)": lambda: raster._build_tile_lists(
                    proj, rcfg),
                "blend kernel": lambda: tile_blend.blend_tiles(*frame, **kw),
            }
            for name, fn in stages.items():
                log(f"  view stage {name}: {cuda_ms(fn, 5):.4f} ms "
                    f"(CUDA events over 5 back-to-back runs)")

            # one whole view (render_image, as evaluate times it), by three
            # clocks, and how much of it the card is busy
            def view():
                return hac_render.render_image(state, cfg, ca, rcfg, bg)
            walls = sorted(wall_ms(view, 10))
            log(f"  whole view, host wall clock with a sync at each end, 10 "
                f"runs: min {walls[0]:.4f}, median {walls[5]:.4f}, max "
                f"{walls[-1]:.4f} ms")
            log(f"  whole view, CUDA events over 10 back-to-back runs: "
                f"{cuda_ms(view, 10):.4f} ms")
            syncs = host_syncs(view)
            log(f"  whole view, host syncs: {sum(syncs.values())} "
                + ", ".join(f"{k} x{v}" for k, v in syncs.most_common()))
            busy, n_dev, top = device_profile(view)
            idle = (f"idle share {1 - busy / walls[5]:.4f} of the median wall "
                    f"clock" if n_dev else "idle share not measured")
            log(f"  whole view under torch.profiler: {n_dev} device "
                f"activities, device busy {busy:.4f} ms, {idle}")
            for name, n, ms in top:
                log(f"    {ms:9.4f} ms  x{n:<4d} {name[:100]}")

    with Phase("train"):
        tile_blend.launches = 0
        tile_blend.backward_launches = 0
        hashgrid.backward_launches = 0
        t0 = time.perf_counter()
        tstate, tcfg, topt, tres = soak.train(
            scene, TRAIN_STEPS, voxel_size=VOXEL_SIZE, white_background=True,
            log=lambda m: log(f"  {m}"), log_every=100, device=dev,
            **TRAIN_DENSIFY)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_launches = tile_blend.launches
        bwd_launches = tile_blend.backward_launches
        log(f"  {TRAIN_STEPS} steps in {train_wall:.3f} s "
            f"({train_wall / TRAIN_STEPS * 1e3:.3f} ms a step, densification "
            f"and cap checks included); tile_blend launches {train_launches}, "
            f"backward launches {bwd_launches}")
        if train_launches == 0 or bwd_launches == 0:
            raise RuntimeError("training did not launch both blend kernels")
        k3_train = hashgrid.backward_launches
        log(f"  K3 backward launches {k3_train}")
        if k3_train == 0:
            raise RuntimeError("phase 2's steps did not launch K3's backward")
        training_report(tres)
        rcfg_t = tres["rcfg"]
        trained = pipeline.evaluate(tstate, tcfg, scene.test_cameras,
                                    max_k=EVAL_K, white_background=True)
        for name, v in trained["per_view"].items():
            log(f"  held-out view {name} after training: PSNR {v['psnr']:.3f} "
                f"dB, SSIM {v['ssim']:.4f}")
        log(f"  held-out PSNR {trained['psnr']:.3f} dB trained, "
            f"{serve_psnr:.3f} dB untrained (serve phase, same views); K="
            f"{trained['eval_k']} D={trained['eval_d']}")
        if not trained["psnr"] > serve_psnr:
            raise RuntimeError("training did not raise the held-out PSNR")

        # the step alone, by phase: wall clock, CUDA events, profile
        optimizer = hac_train.make_optimizer(topt, scene.cameras_extent)
        step_fn = hac_train.make_train_step(tcfg, rcfg_t, optimizer, topt,
                                            white_background=True)
        params, rest = hac.split_state(tstate)
        box = {"opt": tres["opt_state"], "stats": tres["stats"]}
        step_cams = [hac_render.CameraArrays.from_camera(c, dev, with_image=True)
                     for c in scene.train_cameras[:4]]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        turn = [0]

        def one_step(phase):
            cam = step_cams[turn[0] % len(step_cams)]
            turn[0] += 1
            _, box["opt"], box["stats"], _ = step_fn(
                params, rest, box["opt"], box["stats"], cam, phase=phase,
                generator=gen)

        step_ms = {}
        for ph in (0, 2):
            walls = sorted(wall_ms(lambda: one_step(ph), 10))
            events = cuda_ms(lambda: one_step(ph), 10)
            tile_blend.backward_launches = 0
            hashgrid.backward_launches = 0
            profiling.reset()
            busy, n_dev, top = device_profile(lambda: one_step(ph))
            per_step = tile_blend.backward_launches
            step_ms[ph] = walls[5]
            log(f"  step at phase {ph}: host wall clock with a sync at each "
                f"end, 10 steps: min {walls[0]:.4f}, median {walls[5]:.4f}, max "
                f"{walls[-1]:.4f} ms; CUDA events over 10 back-to-back steps "
                f"{events:.4f} ms; backward launches in one step {per_step}, "
                f"K3's {hashgrid.backward_launches}")
            # the recorder's view of the traced step: K3 counted in the
            # backward, its span's device time
            grid = [sp for sp in profiling.spans() if sp.name == "hac.grid.bwd"]
            counted = profiling.counters().get("grid_bwd_launches", 0)
            log(f"  traced phase-{ph} step: grid_bwd_launches {counted}, "
                f"hac.grid.bwd spans {len(grid)}"
                + "".join(f", {sp.device_ms:.4f} ms" for sp in grid))
            if ph == 2 and (counted != 4 or len(grid) != 1):
                raise RuntimeError("a traced phase-2 step did not count K3's "
                                   "four launches in one hac.grid.bwd")
            idle = (f"idle share {1 - busy / walls[5]:.4f} of the median wall "
                    f"clock" if n_dev else "idle share not measured")
            log(f"  one phase-{ph} step under torch.profiler: {n_dev} device "
                f"activities, device busy {busy:.4f} ms, {idle}")
            for name, n, ms in top:
                log(f"    {ms:9.4f} ms  x{n:<4d} {name[:100]}")
        syncs = host_syncs(lambda: one_step(0))
        log(f"  one step, host syncs: {sum(syncs.values())} "
            + ", ".join(f"{k} x{v}" for k, v in syncs.most_common()))

        # one training frame's lists (the trained state, training caps)
        cam = scene.train_cameras[0]
        ca = hac_render.CameraArrays.from_camera(cam, dev)
        bg = torch.ones(3, device=dev)

        def frame_of(rc, ca):
            with torch.no_grad():
                vis = hac_render.prefilter_voxel(tstate, tcfg, ca, rc)
                ngt, _ = hac.generate_neural_gaussians(
                    tstate, tcfg, ca.camera_center, vis, training=True, phase=0)
                pj = raster.project(ngt.xyz, ngt.scaling, ngt.rot,
                                    ca.viewmatrix, rc, ngt.valid)
                ts, pg, _ = raster._build_tile_lists(pj, rc)
            return (ts, pg, pj.mean2d, pj.conic, ngt.opacity.reshape(-1),
                    ngt.color, bg)

        frame_t = frame_of(rcfg_t, ca)
        kw_t = dict(tiles_x=rcfg_t.tiles_x, height=HW, width=HW,
                    max_k=rcfg_t.max_gaussians_per_tile)
        out_t = tile_blend.blend_tiles(*frame_t, **kw_t)
        torch.cuda.synchronize()
        rtol_t, atol_t = tile_blend.kernel_tolerance(bg, frame_t[5])
        check_close("trained frame, kernel vs plain", out_t,
                    tile_blend.blend_tiles_reference(*frame_t, **kw_t),
                    rtol_t, atol_t)
        g_t = torch.randn((3, HW, HW), generator=torch.Generator().manual_seed(SEED)
                          ).to(dev)
        bwd_err = check_gradients("trained frame, backward vs plain autograd",
                                  frame_t, out_t, g_t, kw_t)
        counts_t = frame_t[0][1:] - frame_t[0][:-1]
        log(f"  trained frame (train view 0, D={rcfg_t.max_tiles_per_gaussian} "
            f"K={kw_t['max_k']}): {int(counts_t.sum())} pairs, "
            f"{int(counts_t.gt(kw_t['max_k']).sum())} of {rcfg_t.n_tiles} tiles "
            f"over K, longest list {int(counts_t.max())}")
        shape_b = tile_blend.launch_shape(rcfg_t.n_tiles, backward=True)
        log(f"  backward launch: {shape_b['blocks']} blocks x "
            f"{shape_b['threads']} threads, {shape_b['blocks_per_sm']} resident "
            f"blocks per SM, {shape_b['registers']} registers")
        bwd_ms, bwd_host = device_ms(lambda: tile_blend.blend_tiles_backward(
            *frame_t, out_t, g_t, **kw_t), 20)
        leaves = [t.detach().requires_grad_(True) for t in frame_t[2:6]]
        with torch.enable_grad():
            ref_out = tile_blend.blend_tiles_reference(
                frame_t[0], frame_t[1], *leaves, bg, **kw_t)
        bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(
            ref_out, leaves, g_t, retain_graph=True), 3)
        del ref_out, leaves
        bwd_bound_ms, bwd_bound_by, bwd_detail = backward_bound(
            *frame_t[:5], **kw_t)
        log(f"  backward at the trained frame: kernel {bwd_ms:.4f} ms (device "
            f"time, behind a delay; host enqueue {bwd_host:.4f} ms a call), "
            f"plain (autograd of the plain version, backward only) "
            f"{bwd_plain_ms:.4f} ms, bound {bwd_bound_ms:.4f} ms "
            f"({bwd_bound_by}: {bwd_detail})")
        # what the flush issues: 3 vector atomics per (tile, record) that some
        # pixel blends, where PR 6's kernel issued 9 scalar ones per
        # warp-record touched
        n_warp_records = warp_records(*frame_t[:5], tiles_x=rcfg_t.tiles_x,
                                      max_k=kw_t["max_k"])
        n_quad_records = warp_records(*frame_t[:5], tiles_x=rcfg_t.tiles_x,
                                      max_k=kw_t["max_k"], quadrants=True)
        n_tile_records = tile_records(*frame_t[:5], tiles_x=rcfg_t.tiles_x,
                                      max_k=kw_t["max_k"])
        n_reach = int(quadrant_reach(*frame_t[:5], tiles_x=rcfg_t.tiles_x,
                                     max_k=kw_t["max_k"]).sum())
        n_entries = int((frame_t[0][1:] - frame_t[0][:-1]).clamp_max(
            kw_t["max_k"]).sum())
        log(f"  backward's culling on the trained frame: {n_reach} of "
            f"{4 * n_entries} warp-records ({n_reach / max(4 * n_entries, 1):.4f}) "
            f"can reach their warp's quadrant and are walked, before the "
            f"early stop")
        log(f"  backward's global atomics on the trained frame: "
            f"{3 * n_tile_records} 16-byte vector atomics ({n_tile_records} "
            f"tile-records touched), after {n_quad_records} warp reductions "
            f"(warp-records touched, a quadrant a warp); PR 6's design: "
            f"{9 * n_warp_records} scalar atomics after {n_warp_records} "
            f"warp reductions (warp-records touched, rows 2w, 2w + 1, 2w + 8, "
            f"2w + 9 a warp)")
        # the serial walk of the longest list alone
        one = only_longest_list(frame_t, kw_t["max_k"])
        out_one = tile_blend.blend_tiles(*one, **kw_t)
        one_ms, _ = device_ms(lambda: tile_blend.blend_tiles_backward(
            *one, out_one, g_t, **kw_t), 20)
        log(f"  backward with only the longest list kept ({one[1].shape[0]} "
            f"entries, one block): {one_ms:.4f} ms, against {bwd_ms:.4f} ms for "
            f"the whole frame ({one_ms / bwd_ms:.3f})")
        if base_lib is not None:
            base_t = baseline_launcher(base_lib, frame_t, kw_t)
            if not torch.equal(base_t(), out_t):
                raise RuntimeError("the forward's image differs from the "
                                   "baseline's on the trained frame")
            log("  trained frame: the forward's image is bit-equal to the "
                "baseline's")
            base_bwd = baseline_backward(base_lib, frame_t, out_t, g_t, kw_t)
            check_gradients("trained frame, baseline backward vs plain autograd",
                            frame_t, out_t, g_t, kw_t, got=base_bwd())
            turns = []
            for who in ("baseline", "kernel", "kernel", "baseline"):
                fn = base_bwd if who == "baseline" else (
                    lambda: tile_blend.blend_tiles_backward(
                        *frame_t, out_t, g_t, **kw_t))
                ms, host = device_ms(fn, 20)
                turns.append(ms)
                log(f"  backward turn {len(turns)}: {who} {ms:.4f} ms (host "
                    f"{host:.4f} ms)")
            log(f"  backward in turns: baseline {(turns[0] + turns[3]) / 2:.4f} "
                f"ms, kernel {(turns[1] + turns[2]) / 2:.4f} ms (means of the "
                f"turns)")
            base_one = baseline_backward(base_lib, one, out_one, g_t, kw_t)
            base_one_ms, _ = device_ms(base_one, 20)
            log(f"  baseline backward with only the longest list kept: "
                f"{base_one_ms:.4f} ms")
        fwd_t_ms, _ = device_ms(lambda: tile_blend.blend_tiles(*frame_t, **kw_t), 20)
        fb_ms, fb_by, fb_detail = blend_bound(*frame_t[:5], **kw_t)
        log(f"  tile_blend at the trained frame: {fwd_t_ms:.4f} ms, bound "
            f"{fb_ms:.4f} ms ({fb_by}: {fb_detail})")
        # K1 re-timed on trained lists at the eval caps, held-out view 0 (the
        # serve phase's frame, with the trained state)
        cam_e = scene.test_cameras[0]
        rcfg_e = pipeline._raster_cfg(cam_e, EVAL_K, trained["eval_d"])
        frame_e = frame_of(rcfg_e, hac_render.CameraArrays.from_camera(cam_e, dev))
        kw_e = dict(tiles_x=rcfg_e.tiles_x, height=HW, width=HW, max_k=EVAL_K)
        counts_e = frame_e[0][1:] - frame_e[0][:-1]
        fwd_e_ms, _ = device_ms(lambda: tile_blend.blend_tiles(*frame_e, **kw_e), 20)
        fe_ms, fe_by, fe_detail = blend_bound(*frame_e[:5], **kw_e)
        per_tile_e, _ = entries_per_tile(*frame_e[:5], tiles_x=rcfg_e.tiles_x,
                                         max_k=EVAL_K)
        log(f"  tile_blend on trained lists at K={EVAL_K} D={trained['eval_d']} "
            f"(held-out view 0): {fwd_e_ms:.4f} ms, bound {fe_ms:.4f} ms "
            f"({fe_by}: {fe_detail}); {int(counts_e.gt(EVAL_K).sum())} of "
            f"{rcfg_e.n_tiles} tiles over K; per-tile load largest "
            f"{int(per_tile_e.max())}, mean {float(per_tile_e.double().mean()):.1f}")

    with Phase("scene codec"):
        hac_sizes = scene_codec_phase(dev, scene, tstate, tcfg)

    with Phase("hac_plus"):
        hacp_launches, hacp_sizes = hac_plus_phase(dev, scene, serve_psnr,
                                                   hac_sizes)

    with Phase("tcgs"):
        tcgs_launches, tcgs_sizes = tcgs_phase(dev, scene, serve_psnr, hac_sizes,
                                               hacp_sizes)

    with Phase("cat3dgs"):
        cat_launches = cat3dgs_phase(dev, scene, serve_psnr, {
            "hac": hac_sizes, "hac_plus": hacp_sizes, "tcgs": tcgs_sizes})

    with Phase("reference"):
        # the whole slice on the card against the port's CPU path (plain
        # blend), which the CPU tests hold against the JAX package
        small = hac.HACConfig(**SMALL_CFG)
        runs, runs_device = {}, {}
        for d in (dev, torch.device("cpu")):
            sc = soak.build_scene(np.random.default_rng(SEED), 64, 300, 8, 2000,
                                  white_background=True, device=d)
            pts = hac.voxelize_points(sc.points, small.voxel_size, SEED)
            st = hac.update_anchor_bound(hac.init_state(
                small, pts, np.random.default_rng(SEED), device=d))
            runs[d.type] = (sc, pipeline.evaluate(st, small, sc.test_cameras,
                                                  max_k=256, white_background=True))
            runs_device[id(sc)] = d
        (sc_gpu, res_gpu), (sc_cpu, res_cpu) = runs["cuda"], runs["cpu"]
        for cg, cc in zip(sc_gpu.train_cameras + sc_gpu.test_cameras,
                          sc_cpu.train_cameras + sc_cpu.test_cameras):
            # the kernel's tolerance (white background, colours in [0, 1])
            # plus float32 differences in project
            rtol, atol = tile_blend.kernel_tolerance(torch.ones(3), torch.ones(3))
            check_close(f"small scene GT view {cg.uid}, card vs CPU",
                        torch.from_numpy(cg.image), torch.from_numpy(cc.image),
                        rtol, atol + REF_ATOL)
        for rg, rc in zip(res_gpu["renders"], res_cpu["renders"]):
            agree = float(img_lib.psnr(rg.cpu(), rc))
            log(f"  small HAC eval render, card vs CPU: PSNR {agree:.2f} dB "
                f"(limit {REF_PSNR_DB} dB), max |diff| "
                f"{float((rg.cpu() - rc).abs().max()):.3e}")
            if not agree >= REF_PSNR_DB:
                raise RuntimeError("card and CPU renders disagree")
        # a few training steps at phase 0 (no noise: the card's and the
        # CPU's generators draw different numbers) on each side
        steps = {}
        for sc in (sc_gpu, sc_cpu):
            d = runs_device[id(sc)]
            pts = hac.voxelize_points(sc.points, small.voxel_size, SEED)
            st = hac.update_anchor_bound(hac.init_state(
                small, pts, np.random.default_rng(SEED), device=d))
            params, rest = hac.split_state(st)
            o = hac_train.OptConfig(iterations=100)
            optimizer = hac_train.make_optimizer(o, sc.cameras_extent)
            ostate = optimizer.init(hac_train.param_leaves(params))
            stats = hac_train.zero_stats(rest["valid"].shape[0], small.n_offsets, d)
            step = hac_train.make_train_step(
                small, pipeline._raster_cfg(sc.train_cameras[0]), optimizer, o,
                white_background=True)
            w0 = params["nets"].mlp_color.fc1.weight.detach().clone()
            losses = []
            for i in range(REF_TRAIN_STEPS):
                cam = hac_render.CameraArrays.from_camera(
                    sc.train_cameras[i], d, with_image=True)
                params, ostate, stats, m = step(params, rest, ostate, stats,
                                                cam, phase=0)
                losses.append(float(m["loss"]))
            steps[d.type] = (losses, (params["nets"].mlp_color.fc1.weight.detach()
                                      - w0).cpu())
        (lg, dg), (lc, dc) = steps["cuda"], steps["cpu"]
        rel = float((dg - dc).norm() / dc.norm())
        log(f"  {REF_TRAIN_STEPS} training steps of the small scene, card vs "
            f"CPU: losses {[f'{x:.6f}' for x in lg]} vs "
            f"{[f'{x:.6f}' for x in lc]} (rtol {REF_LOSS_RTOL}); mlp_color "
            f"output weight change differs by {rel:.3e} of its norm (limit "
            f"{REF_LEAF_RTOL})")
        if not np.allclose(lg, lc, rtol=REF_LOSS_RTOL, atol=0):
            raise RuntimeError("card and CPU training losses disagree")
        if not rel <= REF_LEAF_RTOL:
            raise RuntimeError("card and CPU training steps disagree")

    with Phase("codec"):
        codec_rows, sib_bpp = codec_phase(dev, opts.baseline_rans)

    with Phase("codec_train"):
        train_launches = codec_train_phase(dev)

    with Phase("codec_engines"):
        engine_launches = codec_engines_phase(dev, sib_bpp)

    with Phase("dp"):
        dp_launches = dp_phase(dev, smi, scene, tstate, tcfg, topt, tres)

    with Phase("tools"):
        tools_launches = tools_phase(dev, smi, scene, tstate, tcfg)

    for row in codec_rows:
        row["launches_hac_plus"] = hacp_launches[row["name"]]
        row["launches_tcgs"] = tcgs_launches[row["name"]]
        row["launches_cat3dgs"] = cat_launches[row["name"]]
        row["launches_codec_train"] = train_launches[row["name"]]
        row["launches_codec_engines"] = engine_launches[row["name"]]
        row["launches_dp"] = 0  # the DP steps code nothing
        row["launches_tools"] = tools_launches[row["name"]]
    log(json.dumps({"kernels": [{
        "name": "tile_blend",
        "route": "cuda",
        "source": "gauspcc_tpu_torch/csrc/tile_blend.cu",
        "replaces": "gauspcc_tpu/render/pallas_blend.py:46",
        "launches": launches,
        "launches_hac_plus": hacp_launches["tile_blend"],
        "launches_tcgs": tcgs_launches["tile_blend"],
        "launches_cat3dgs": cat_launches["tile_blend"],
        "launches_dp": dp_launches["tile_blend"],
        "launches_tools": tools_launches["tile_blend"],
        "max_abs_err": frame_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "tile_blend_backward",
        "route": "cuda",
        "source": "gauspcc_tpu_torch/csrc/tile_blend.cu",
        "replaces": "gauspcc_tpu/render/raster.py:264",
        "launches": bwd_launches,
        "launches_hac_plus": hacp_launches["tile_blend_backward"],
        "launches_tcgs": tcgs_launches["tile_blend_backward"],
        "launches_cat3dgs": cat_launches["tile_blend_backward"],
        "launches_dp": dp_launches["tile_blend_backward"],
        "launches_tools": tools_launches["tile_blend_backward"],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }, {
        "name": "hashgrid_table_grad",
        "route": "cuda",
        "source": "gauspcc_tpu_torch/csrc/hashgrid.cu",
        # no TPU kernel: XLA's transpose of the table gather
        "replaces": "gauspcc_tpu/fields/hashgrid.py:18",
        "launches": k3_train,
        "launches_hac_plus": hacp_launches["hashgrid_table_grad"],
        "launches_dp": dp_launches["hashgrid_table_grad"],
        "launches_tools": tools_launches["hashgrid_table_grad"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["kernel"],
        "plain_ms": k3["plain"],
        "bound_ms": k3["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k3["library"],
    }, *codec_rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
