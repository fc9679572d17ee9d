#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``event_utils_tpu_torch``) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``event_utils_tpu_torch/csrc`` and, beside them, the native ingest
   runtime (``g++``, ``csrc/evio.cpp``), and prints the build times.
2. Holds each kernel, by route, against its plain PyTorch version at the
   main path's shapes, and times the kernel, the plain version and one
   PyTorch library call on the device (CUDA events around CUDA-graph
   replays; see ``time_ms``):
   - voxel, on the vector route (one float2 reduction per event) and on
     the direct one: 2^21 time-sorted events, B=5, 180x240, also masked,
     with a t1 override that pins half the events to t_norm = B-1 exactly,
     unsorted, all masked, with NaN, +-inf, +-1e30 and first bins of -1
     among the t_norm, B = 1, 4 and 9, and a 4096-event stream (which the
     dispatch sends to the direct route);
   - per-tile voxel: the same stream at 720p bucketed into 80 (96, 128)
     tiles, the same three cases, on the private route and on the direct
     one, both also at VGA; the private route with unsorted slots and with
     B=9; the direct route at a (240, 256) tile, whose plane
     exceeds a block's shared memory;
   - bilinear: the floor of one graph node (an empty kernel,
     ``torch.cuda._sleep(0)``); K=1 (private route against direct) at
     181x241 on 200k events, the planted scene warped onto its 400 tracks;
     K=4 on the vector route against direct (the planted scene's
     timestamp image and uniform weights, held per pixel within
     ``splat_limits``); ~2k events of one ROI into 21x21 and 181x241 (the
     one-block form of the private kernel, which no shape is sent to,
     against direct); NaN, +-1e30 and all-out-of-frame coordinates on
     every route, and autograd gradients;
   - batched bilinear (``jax.vmap`` of the TPU kernel): one grid level
     (25 velocity samples of the 200k planted scene, per-sample masked
     weights, K=1: the private route, also forced onto the direct one),
     S = 1, one chunk of the loss (83 samples, 3 private blocks a sample in
     two waves), the rotating scene's grid level, 25 samples with every
     event on one pixel, S at and across the samples one launch takes
     (65535, 65536: one launch, two), a sample wholly off the image and
     NaN, +-inf and huge coordinates on every route, zhu's K=4 stack
     (vector, against direct), each against its plain version in
     float64 within a per-pixel limit that scales with the pixel's f32
     sums (``splat_limits``) and against S single ``bilinear_scatter``
     launches;
   - bilinear patches: one batched ``grid_cmax_batched`` loss evaluation
     (108 ROIs x 25 samples x 2048 slots into (64, 128) patches) at K=1 and
     K=4, against the plain version and against the atlas route it
     replaced (direct kernel + un-tiling copy); one descent step of it (108
     patches: the direct patch route, at K=1 and K=4 and with every slot
     on one pixel, held per pixel within ``splat_limits``); 1 and 767
     patches; a ragged case (P=7, C=1000, (24, 40)) on both routes; a
     (240, 256) patch; gradients;
   - batched voxel (``jax.vmap`` of the TPU kernel): the three routes of
     ``voxel_scatter_batched`` (direct, vector, and private: a block per
     (grid, bin) in shared memory, stored once) against the plain version
     and against S single ``voxel_scatter`` launches (2S with the polarity
     split; the private route's on ``voxel_route``'s route), within
     GRID_REL of the grids' scale, timed beside the plain version and one
     ``index_put_``: the 2^21-event stream in 104 windows of 20,000 and in
     8 of 2^18 (DAVIS240, B=5), the trainers' split grids of padded rows
     (``fit``'s 8 x 32,768 at 184x240, the flow batch's 8 x 65,536 and the
     E2VID batch's 96 windows of 12,288 at 128x128), and on the flow
     batch's shape B = 1 and 9, every row masked, a row of one event,
     per-row windows that pin events to the last bin, NaN, +-inf and huge
     bins;
   - flat, on the vector route (one float2 or float4 reduction per id)
     and on the direct one: the D=2 derivative stack of 200k events (800k
     ids), also with ids -1 and num_buckets mixed in, with all-zero weight
     columns and with an all-zero row; D = 3, 4, 5 at 200k ids; D = 1 at 2^21 ids into 180x240
     (the event image: direct route only).
3. Drives the main path through the public entry points with every launch
   count set to 0 first: ``events_to_voxel(impl="matmul")`` on 2^21 events
   (vector route) and on their first 4096 (direct route),
   ``events_to_image(impl="matmul")``,
   ``events_to_timestamp_image(impl="matmul")``, the analytic
   ``variance_objective.evaluate_gradient(impl="matmul")``, then
   ``optimize_contrast_jit(grid_search_init=True)`` and
   ``optimize_contrast(grid_search_init=True)`` on a 200k-event DAVIS240
   scene with a planted velocity, which both must recover within 4 px/s.
   Then the ROI-bucketed path: ``events_to_voxel(impl="tiled")`` and
   ``events_to_voxel_tiled`` at VGA and 720p on 2^21 events (each against
   the exact route; 720p also with (240, 256) tiles), ``grid_cmax_batched``
   on the rotating bench scene (all-ROI median flow error at most 4.5
   px/s; again with ``pyramid="auto"``), one patch loss with (240, 256)
   patches, and the host loop ``grid_cmax`` on one 40x60 corner of it.
   Every call must have launched the route that the dispatch names for
   its shape (``voxel_route``, ``flat_route``, ``bilinear_route``, ...),
   and every route of this path must have launched; then the vector
   route at the shapes this path sent it, against its plain version per
   pixel and timed beside the direct route on the same inputs.
4. The batched solves (``batched``), with the launch counts set to 0 again
   first: ``optimize_contrast_jit(grid_search_init=True)``,
   ``grid_search_optimisation`` and ``optimize_contrast`` on the 200k
   planted scene, one ``grid_search_initial`` level of zhu's objective,
   the 20x20 landscape on 15,000 events and on all 200k, and
   ``grid_cmax_batched(solver='bfgs')`` and a full-frame objective's ROI
   solve on the rotating scene. Every grid level and landscape must launch
   ``bilinear_scatter_batched`` once per chunk of samples and no single
   splat; the ROI BFGS must be one batched solve; the answers are held to
   the planted velocity (4 px/s) and the rotation field (4.5 px/s), the
   landscapes card vs CPU and batched vs the per-sample loop (1e-4 of
   their range), the BFGS field card vs CPU (medians within 0.5 px/s).
   Then warm walls, device busy and idle shares, and each shape the phase
   sent the batched splat against its plain version.
5. JAX's vmapped voxel grids (``voxel_batched``), with the launch counts
   set to 0 again first: ``voxel_grids_fixed_n(impl='matmul')`` on the
   2^21-event DAVIS240 stream in windows of 20,000 (104 windows) and of
   2^18 (8), and ``voxelize_batch`` under ``'pallas'`` at the flow batch's
   and ``fit``'s shapes; each call must launch ``voxel_scatter_batched`` on
   the route its shape is sent to (``voxel_batched_route``), once per
   chunk of rows, and nothing else (no ``voxel_scatter:*``). Then every
   grid against the per-window loop of single launches that the port ran
   before (``window_loop_grids``) and the exact 'xla' route, and the walls
   of both in turns (loop, batched, batched, loop), with device busy, idle
   share, largest entries and launches.
6. The serving path, with the launch counts set to 0 again first: a
   recording made here from ``SEED`` (128x128, the sensor of the committed
   weights; 2 s of a textured plane under the similarity motion of the
   seed-91 flow recording, v = (24, -15) px/s, omega = 4 rad/s, divergence
   0.35 about the centre; log-intensity crossings at C = 0.15, >= 10^6
   events; 21 frames at 0, 0.1, ..., 2 s, so 20 ``between_frames``
   windows, the first empty as in the simulator's recordings, each frame
   with the analytic flow) written by the port's ``memmap_packager``; then
   the port's ``infer_flow`` with ``runs/flow128_similarity/params.npz``
   (``--eval_gt --batch_size 8``) on the card under
   ``set_default_impl('pallas')``, again under ``'xla'``, and on the CPU,
   and ``reconstruct`` with ``runs/recon128v2/params.npz`` on the card
   (``'pallas'``) and on the CPU. Every 'pallas' run on the card must
   launch ``flat_scatter:direct`` exactly twice per window (the positive
   and the negative grid) and nothing else; the card's flows must agree
   with the CPU's to 1e-3 of max|flow|, its frames to 1e-3 after all 20
   recurrent windows, the 'pallas' voxel grids with the 'xla' ones to 1e-5
   of their scale. AEE, PSNR and SSIM are printed, not gated (the scene is
   not the simulator's). Then ``flat_scatter:direct`` at one window's
   shape against its plain version (a case of its record), and warm
   timings: windows/s of each CLI, the dataset's host ms per window and
   one window's two grids alone (from host arrays and from card tensors),
   each with the flat kernel and with ``index_add_`` in turns, the
   networks' device ms per batch (CUDA events), and each CLI's device idle
   share (``torch.profiler`` busy time over the unprofiled warm wall).
7. The published serving anchors, with the launch counts set to 0 again
   first, everything under ``set_default_impl('pallas')``: the port's
   ``simulate`` CLI makes the three recordings of the JAX simulator on the
   card from the committed textures (seed 91, similarity, 2 s: 746,962
   events, 162 dropped; seed 77, translate, 0.4 s and 1.0 s: 31,242 and
   81,926), each held to JAX's event count and drops within 0.1% of the
   count and its per-window counts within 0.5%; seed 91 again, warm, on
   the card and on the CPU (events/s, and the card-vs-CPU difference in
   events and per-window grids, printed); ``infer_flow`` with the flow
   weights on seed 91 (AEE 27.114 +- 0.30 px/s, each of windows 1-19
   within 1.0 of JAX's, zero-flow 196.634 +- 0.01); ``reconstruct`` on
   the seed-77 recordings (steady 24.626 +- 0.10 dB / SSIM 0.8561 +-
   0.003 at 8 windows, 25.212 / 0.8818 at 20); each serving CLI must
   launch ``flat_scatter:direct`` exactly twice per window and nothing
   else; ``eval_cmax --max_windows 4`` on seed 91 (median AEE within 1% of
   52.523 px/s), which may launch only the patch routes; the
   background-activity filter on the labelled 48x48 scene of
   ``tests/test_denoise.py`` simulated on the card (signal recall > 0.95,
   noise removal > 0.6). After the counts are read, the kernels at this
   path's own shapes against their plain versions (cases of their
   records): the inputs of the first call of every distinct shape that
   ``eval_cmax`` sent to the patch splat (grid-search evaluations and
   descent steps, kept during the run), and ``flat_scatter:direct`` on
   the densest window's positive grid of each served recording.
8. The training path, with the launch counts set to 0 again first,
   everything under ``set_default_impl('pallas')`` and TF32 off: JAX's
   two pinned eval batches (stage 9 of ``runs/flow128_similarity``,
   stage 8 of ``runs/recon128v2``) rebuilt on the card from the committed
   scene parameters (``event_utils_tpu_torch/training/data``), each
   scene's event count within 0.1% of JAX's, and the committed weights
   scored through the trainers' evals (AEE within 1% of JAX-on-the-CPU's,
   zero-flow within 0.01 px/s; PSNR/SSIM, all and steady windows, within
   0.10 dB / 0.003); then ``train_flow --simulate`` (stage-9 recipe, 20
   steps at lr 5e-6 from the committed weights, eval at the end),
   ``train_reconstruction --simulate`` (stage-8 recipe, 6 steps: 2 batches
   x 3 carried segments) and ``train_reconstruction`` on the seed-77
   recording of phase 5 (2 steps): finite losses, the final evals within
   bands around the CPU port's readings of the same commands,
   ``--params_out`` reloaded into fresh trainers bit-identical, and
   exactly one ``voxel_scatter_batched`` (both polarities' grids) and one
   ``flat_scatter:direct`` (the loss's splat) per flow step plus one
   batched launch for the eval grids, ``flat_scatter:direct`` 2 per
   simulated E2VID batch and 2 per recording window, nothing else. After the counts are read: 2 Adam
   steps of each recipe on one batch on the card and on the CPU (losses
   to 1e-4; gradients per leaf, cosine >= 0.9999 and 1e-3 of the leaf's
   scale; weights and EMA, 99% of the coordinates the CPU run moved
   within 1e-3 of the summed learning rate, all within twice it),
   'pallas' against 'xla' grids (1e-5), ``contrast_flow_loss``'s gradient
   against the CPU's (cosine >= 0.9999, 1e-4 of its scale), the batched
   simulator (one render, frame loop and sort per batch) against the
   per-scene loop it replaced (``scene_loop_flow``, ``scene_loop_recon``)
   on both eval batches: events, masks, ground truth, saturation, frames
   and the segmented scatters' inputs bit for bit, each E2VID window's
   first and last stamp (read off the sorted rows) bit for bit the
   ``scatter_reduce`` ones, the grids within 1e-5 (float atomics), the
   flat and batched voxel kernels at every shape the path sent them,
   forward against the plain version (the flat adjoint against the plain
   gather, exact), and warm timings: forward+backward device ms, one flow
   step, one E2VID batch generation and one segment step with their
   device idle shares, the flow and E2VID batch generations of the
   per-scene loop and the batched simulator in turns (loop, batched,
   batched, loop; 5 warm walls each, busy, idle share, peak memory), and
   a flow step and an E2VID batch generation with the trainers' grids as
   built before the batched voxel kernel (``old_segment_route``:
   ``scatter_reduce`` per segment) and now, in turns (old, new, new, old; 5 warm walls each,
   busy, idle share, largest entries, launches; the new route's largest
   entries may hold no ``_scatter_gather_elementwise_kernel``).
9. The streaming path, with the launch counts set to 0 again first,
   everything under ``set_default_impl('pallas')`` (``g++`` built the
   native runtime, ``csrc/evio.cpp``, in step 1): the port's ``simulate``
   CLI writes a DAVIS240 recording on the card (a texture translating at
   (30, -20) px/s for 1.5 s: 17 windows of 20,000 events);
   ``stream_flow`` streams it at the JAX CLI's defaults (k = 20,000, 20x20
   ROIs, 30 iterations, ``--pyramid_first``), every window's field held
   to the ground truth (the median's error and the median ROI error each
   within 21 px/s: limits from the CPU port's reading), window 1 to the
   CPU port's solve of the same inputs (medians within 0.5 px/s) and
   window 0, a cold pyramid solve that is ill-conditioned, by the function
   each solver computes: its batched patch loss (the fine level's) and the
   gradient of its sum, card against the CPU port, at the fine level's
   start and at the CPU's answer + (5, -5) px/s (per ROI within 1e-4
   relative; cosine >= 0.9999, norms within 1e-3), its two answers logged;
   ``train_flow`` on the recording at 184x240, batch 8 (finite losses, a
   checkpoint at the last step); ``FlowTrainer.fit`` from the committed
   flow weights, 2 steps on the card and on the CPU over the same batches
   (losses to 1e-4 relative, gradients and weights by the training
   phase's rules). Every launch of the phase must be one that the
   dispatch rules name for a call's shape. After the counts are read:
   ``fill_padded_batches`` (8 x 32768) and ``bucket_fill`` (the first
   window into 108 ROIs; 720p tiled) equal their plain versions exactly,
   with host times; the pinned prefetch hands a consumer that lags every
   copy batches equal to their host batches; each route the phase
   launched, at the largest shape it was sent, against its plain version;
   and warm ``fit`` steps through the pinned prefetch and through
   pageable copies, in turns: wall, the device's idle share and the share
   of the copy time under kernels (``torch.profiler`` trace).
10. The augmentation path, with the launch counts set to 0 again first
   around its drive: the slider-like scene of
   ``benchmarks/bench_configs.py:36-50`` (2^20 draws at 180x240, 0.5 s,
   600 points at (70, 30) px/s, floored to pixels) written as ECD text by
   ``write_txt_events``, read back, packaged by ``memmap_packager`` and
   read back (counts and values exact); ``add_correlated_events_torch``
   on the card from the memmap's int16 arrays (config 3's 1 ms jitter,
   one stable sort), then ``events_to_voxel`` (B=5, masked:
   ``voxel_scatter:vector``) and ``events_to_image``
   (``flat_scatter:direct``), exactly one launch each and nothing else.
   After the counts are read: the same draws through the core with float
   coordinates and with ``sort_block=None`` (the inputs of JAX's general
   path and global sort), and the CPU port's core on the card's draws,
   all identical; epoch stamps; an integer stream outside JAX's packed
   word equal to its float-coordinate run; rotate, flips and the remove
   keep-mask card against CPU; ``bilinear_scatter_matmul`` at K = 1 and
   4; both kernels at this path's shapes against their plain versions;
   ``augment_demo``'s host sweep on 50,000 events (its ``main`` must name
   matplotlib where that is missing); warm times in turns: the densify
   with integer and float coordinates and unsorted, in M input events/s,
   the voxel and image calls, and the pipeline's idle share.
11. The multi-card path (``parallel``), with the launch counts set to 0
   again first around a world of one: this process joins a one-rank
   NCCL group (``file://`` store in the work directory) and
   ``make_mesh(1)`` spans it; ``sharded_events_to_voxel`` (2^21 events,
   DAVIS240, B=5), ``sharded_iwe`` and
   ``sharded_events_to_timestamp_image`` (the 200k-event planted scene),
   3 steps of ``make_sharded_cmax_train_step`` with ``normalize_grad`` on
   and off, and ``sharded_grid_cmax`` on the rotating scene: each
   against its single-card counterpart (grids and params within 1e-5 of
   their scale; the flow error within 4.5 px/s), every launch one that
   the dispatch rules name, with the sharded calls' ms beside their
   ``all_reduce``'s. Then two ranks spawned on the one card
   (``torch.multiprocessing``, gloo, which stages CUDA tensors through
   the host) run the same suite: every rank's results identical, each
   within 1e-5 of the world of one's, the ROI solve's flow error within
   4.5 px/s and each ROI's reported loss within 1e-4 of the single
   card's loss at its answer (the answers' distances logged). Then
   ``python -m torch.distributed.run --nproc_per_node 2`` runs this file
   as ``train_flow --simulate --data_parallel`` ranks (gloo, 3 steps at
   128x128, batch 8, from the committed flow weights; ``DP_FLAG``): its
   losses within 1e-5 relative of a one-rank run, its weights' 99%
   quantile by the training phase's rule (the max is logged: the two
   runs can step a near-zero-gradient coordinate opposite ways), and
   steps/s of each.
12. The remaining host-side modules' device halves (``visualization``),
    counted: ``draw_objective_function``'s landscape (20x20 samples at
    20 px/s over +-200 px/s on 15,000 events of the planted scene; within
    1e-4 of the CPU port, its peak within one cell of the planted
    velocity), ``cmax_demo.run`` on the same events (each objective's
    loss at the card's and at the CPU's argmax, card vs CPU within
    1e-4), ``motion_compensate`` of 20,000 events of the streaming
    recording at its ground-truth flow (card vs CPU within 1e-5; the
    PNG it writes decodes to its levels) and the 2-D visualizers' images
    under ``'pallas'`` (card vs CPU within 1e-5).
13. Times the tiled route and its host bucketing alone (now the native
    bucket fill), warm, and prints the bucketing's share of the route's
    wall.

Prints a ``{"batched": {...}}`` JSON line (the phase's levels, answers,
walls and idle shares), a ``{"voxel_batched": {...}}`` line (its
comparisons, the fixed-n walls in turns), a ``{"serving": {...}}`` JSON
line, a ``{"simulated_anchors":
{...}}`` line (the gated numbers, walls and windows/s), a ``{"training":
{...}}`` line (gated numbers, steps/s, Mev/s, the simulator's share,
timings, the batched simulator against the per-scene loop), a ``{"streaming": {...}}`` line (the stream's errors, Mev/s and
windows/s, card vs CPU, the native runtime's times, the fit timings), an
``{"augmentation": {...}}`` line, a ``{"parallel": {...}}`` and a
``{"visualization": {...}}`` line, a ``{"kernels": [...]}`` line (one
entry per route; ``launches`` counts the contrast-maximisation path,
``launches_batched`` the batched solves, ``launches_voxel_batched`` the
vmapped voxel grids, ``launches_serving`` the serving
path, ``launches_sim`` the simulated
anchors, ``launches_train`` the training path, ``launches_stream`` the
streaming path, ``launches_aug`` the augmentation path,
``launches_parallel`` the world of one of the multi-card path,
``launches_vis`` the visualization phase), then the card line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SENSOR = (180, 240)          # DAVIS240
B = 5
N_VOXEL = 1 << 21
N_SMALL = 4096               # a short stream: the direct voxel route
N_SCENE = 200_000
VELOCITY = (60.0, -35.0)     # px/s, planted in the scene
SEED = 0
REPS = 20                    # timed graph replays (median)
CALLS = 10                   # calls captured in each graph
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
FIXED_N = 20_000             # voxel_grids_fixed_n's DAVIS240 windows (104)
FIXED_N_VECTOR = 1 << 18     # 8 windows of the same stream: :vector
VOXEL_WALLS = 5              # warm walls of each turn of the fixed-n A/B
F32_FLOPS = 67e12            # H100 SXM, f32 outside the tensor cores
TILED_SENSORS = {"VGA": (480, 640), "720p": (720, 1280)}
TILE = (96, 128)
BIG_TILE = (240, 256)        # one plane exceeds a block's shared memory
ROT_SENSOR = (180, 240)      # the rotating bench scene
ROT_ROI = (20, 20)
ROT_EVENTS = 200_000
ROT_OMEGA = 1.2              # rad/s about the sensor centre
ROT_CAPACITY = 2048
ROT_MAXITER = 30
FLOW_ERR_LIMIT = 4.5         # px/s, all-ROI median against the field
TILED_REPS = 5               # warm calls timed per route for the share
# the batched splat against its plain version in float64, per pixel:
# SPLAT_ROUNDING x sqrt(m) x eps32 x sum|terms| over the pixel's m terms
# (splat_limits); against S single launches twice that
SPLAT_ROUNDING = 8.0
BATCH_CPU_MED_TOL = 0.5       # px/s, the all-ROI median, card vs CPU
BATCH_CORNER = (60, 80)       # the rotating scene's corner solved on both
# px/s, the full-frame objective's ROI solve on the rotating scene: the CPU
# port reads 4.389 (the patch solve's limit sits ~0.55 above its readings)
FULL_FRAME_ERR_LIMIT = 5.0
BATCH_REPS = 3                # warm synchronised walls (median)
# The serving scene: the motion of the seed-91 similarity recording that
# scores the committed flow weights (runs/flow128_similarity/README.md)
SERVE_SENSOR = (128, 128)    # the sensor both committed models were trained on
SERVE_SECONDS = 2.0
SERVE_FRAMES = 21            # frames at 0, 0.1, ..., 2 s: 20 windows, the
                             # first one (before frame 0) empty
SERVE_RENDER_HZ = 1000.0     # log-intensity samples per second
SERVE_C = 0.15               # contrast threshold, log units
SERVE_V = (24.0, -15.0)      # px/s
SERVE_OMEGA = 4.0            # rad/s about the sensor centre
SERVE_DIV = 0.35             # 1/s about the sensor centre
SERVE_MIN_EVENTS = 1_000_000
SERVE_TIMED = 10             # CUDA-event-timed network calls (median)
SERVE_PASSES = 10            # timed passes per scatter route (in turns)
SERVE_GRID_CALLS = 20        # calls per timed pass of one window's grids
ROOT = os.path.dirname(os.path.abspath(__file__))
FLOW_PARAMS = os.path.join(ROOT, "runs", "flow128_similarity", "params.npz")
RECON_PARAMS = os.path.join(ROOT, "runs", "recon128v2", "params.npz")

# The published serving anchors: recordings of the JAX simulator (commands
# of runs/flow128_similarity/README.md:114-118 and runs/recon128v2/
# README.md:10-14,32-37), served with the committed weights. The counts and
# metrics below are the JAX package's on the CPU, run from the same
# commands; the textures are JAX's, committed as data
# (scripts/make_sim_textures.py), found by ``simulation.texture_path(seed)``.
SIM_COMMON = ["--sensor", "128", "128", "--c_pos", "0.15", "--c_neg", "0.15",
              "--octaves", "3", "--format", "memmap"]
ANCHOR_SIMS = {
    "flow91": {
        "args": ["--scene", "similarity", "--velocity", "24", "-15",
                 "--omega", "4.0", "--divergence", "0.35", "--duration",
                 "2.0", "--fps", "100", "--frame_fps", "10", "--seed", "91"],
        "seed": 91, "events": 746_962,
        "dropped": 162,
        "windows": [52503, 56094, 54106, 47078, 42403, 47547, 47160, 39620,
                    35303, 36962, 37774, 34737, 30023, 30657, 29779, 27563,
                    24726, 26858, 24213, 21856]},
    "recon77_8": {
        "args": ["--scene", "translate", "--velocity", "28", "-17",
                 "--duration", "0.4", "--fps", "80", "--frame_fps", "20",
                 "--seed", "77"],
        "seed": 77, "events": 31_242, "dropped": 0,
        "windows": [1378, 4093, 4338, 4308, 4409, 4184, 4342, 4190]},
    "recon77_20": {
        "args": ["--scene", "translate", "--velocity", "28", "-17",
                 "--duration", "1.0", "--fps", "80", "--frame_fps", "20",
                 "--seed", "77"],
        "seed": 77, "events": 81_926, "dropped": 0,
        "windows": [1378, 4093, 4338, 4308, 4409, 4184, 4342, 4190, 4242,
                    4291, 4155, 4242, 4221, 4183, 4331, 4076, 4232, 4240,
                    4212, 4259]},
}
EVENTS_REL = 1e-3            # event count and drops, of the event count
WINDOW_REL = 5e-3            # per-window event counts
FLOW_AEE = 27.114            # px/s over the 19 informative windows
FLOW_AEE_TOL = 0.30
FLOW_AEE_WINDOWS = [21.803, 24.402, 24.725, 22.558, 22.834, 27.759, 23.940,
                    24.365, 20.007, 20.556, 28.681, 23.364, 23.646, 28.989,
                    30.979, 31.114, 38.861, 36.430, 40.159]  # windows 1-19
FLOW_WINDOW_TOL = 1.0
FLOW_ZERO = 196.634
FLOW_ZERO_TOL = 0.01
RECON_STEADY = {"recon77_8": (24.626, 0.8561),   # PSNR dB, SSIM
                "recon77_20": (25.212, 0.8818)}
PSNR_TOL = 0.10
SSIM_TOL = 0.003
CMAX_MEDIAN = 52.523         # px/s, eval_cmax --max_windows 4 on flow91
CMAX_REL_TOL = 0.01          # 0.525 px/s; the port read 52.679 on the CPU
                             # and 52.715 on the H100
CMAX_WINDOWS = 4
BAF_RECALL = 0.95            # tests/test_denoise.py's limits
BAF_REMOVAL = 0.6
# The training path (the stage-9 flow recipe of runs/flow128_similarity and
# the stage-8 E2VID recipe of runs/recon128v2, metrics_stage9.json and
# metrics_stage8.json), gated on JAX-on-the-CPU's numbers on the pinned
# eval batches (event_utils_tpu_torch/training/data/eval_anchors.json,
# written by scripts/make_train_eval_scenes.py)
TRAIN_FLOW = ["--simulate", "--sensor", "128", "128", "--batch_size", "8",
              "--capacity", "65536", "--v_max", "40", "--window_t", "0.1",
              "--num_frames", "9", "--omega_max", "6", "--s_max", "0.6",
              "--burn_in", "1", "--fresh_prob", "0.25", "--age_max", "2.5",
              "--supervised_weight", "1.0"]
TRAIN_RECON = ["--sensor", "128", "128", "--seq_len", "8", "--batch_size",
               "4", "--capacity", "294912", "--window_t", "0.05",
               "--carry_segments", "3", "--burn_in", "1", "--lpips_weight",
               "0.1", "--mse_weight", "4.0", "--ema_decay", "0.999",
               "--recurrent_levels", "3", "--num_res_blocks", "2"]
# on the seed-77 recording of the simulated anchors: one sequence a step
TRAIN_RECON_FILE = ["--seq_len", "8", "--batch_size", "1", "--burn_in", "1",
                    "--lpips_weight", "0.1", "--mse_weight", "4.0",
                    "--ema_decay", "0.999", "--recurrent_levels", "3",
                    "--num_res_blocks", "2"]
RECON_KWARGS = {"recurrent_levels": 3, "num_res_blocks": 2}
TRAIN_FLOW_STEPS = 20
TRAIN_RECON_STEPS = 6        # 2 simulated batches x 3 carried segments
TRAIN_FILE_STEPS = 2
TRAIN_SEED = 7
TRAIN_EVENTS_REL = 1e-3      # per-scene event counts of the eval batches
TRAIN_AEE_REL = 0.01         # held-out AEE, of JAX's
TRAIN_ZERO_TOL = 0.01        # zero-flow baseline, px/s
STEP_LOSS_REL = 1e-4         # card vs CPU, per step
STEP_GRAD_COS = 0.9999       # the gradients, card vs CPU, per leaf; max
STEP_GRAD_REL = 1e-3         # |diff| of the leaf's scale (E2VID's worst
#                              leaf read 1.4e-6 and 1.5e-4 in two runs on
#                              an H100: cuDNN's algorithms, not the inputs)
# card vs CPU weights after the steps: of the coordinates the CPU run
# moved and whose step direction the gradients determine, 99% within 1e-3
# of the summed learning rate; every coordinate within 2x it. A coordinate
# whose gradient lies within the card-vs-CPU gradient noise takes Adam's
# ~lr step in a direction that noise decides: a dead channel's exactly
# zero gradient (0.6-0.8% of either net, which the CPU run leaves in
# place) gets ~1e-7 of its leaf's scale from cuDNN's transforms on the
# card, and a gradient near zero may change sign between the devices (an
# E2VID weight stepped 5.988e-5 apart of a summed lr of 6e-5 and lifted
# the quantile to 6.333e-8; measured on an H100, 700 W). Such a
# coordinate is undetermined (``undetermined``): its gradients differ in
# sign at a compared step, or the CPU's lies within its leaf's card-vs-CPU
# difference there, a difference taken no larger than STEP_GRAD_REL of the
# leaf's scale (what check_grads accepts). It is held to the max alone, and
# counted; more than STEP_UNDETERMINED_MAX of the coordinates undetermined
# fails (E2VID read 0.068-0.121, EV-FlowNet 0.044, on an H100 at 700 W).
STEP_PARAM_Q99 = 1e-3
STEP_PARAM_MAX = 2.0
STEP_UNDETERMINED_MAX = 0.2
GRID_REL = 1e-5              # 'pallas' vs 'xla' voxel grids
GRAD_COS = 0.9999            # contrast_flow_loss gradient, card vs CPU
GRAD_REL = 1e-4
# the final held-out evals of the short CLI runs: bands around the CPU
# port's readings of the same commands (PERF.md section 2)
# (CPU: AEE 57.1736 px/s; PSNR 25.1996 dB, SSIM 0.8517): +-0.3 px/s, and
# the anchors' +-0.10 dB / +-0.003
CLI_FLOW_AEE = (56.87, 57.47)
CLI_RECON_PSNR = (25.10, 25.30)
CLI_RECON_SSIM = (0.8487, 0.8547)
# The streaming path: a DAVIS240 recording of a texture translating at a
# uniform (30, -20) px/s (the example velocity of the JAX package's
# cli/eval_cmax.py:11, simulate's default fps), written by the port's
# simulate CLI; 1.5 s, so that it holds 17 windows of stream_flow's default
# 20,000 events (352,151 events on the CPU).
STREAM_SIM = ["--sensor", "180", "240", "--scene", "translate", "--velocity",
              "30", "-20", "--duration", "1.5", "--c_pos", "0.15", "--c_neg",
              "0.15", "--octaves", "3", "--seed", "7", "--format", "memmap"]
STREAM_GT = (30.0, -20.0)     # px/s, everywhere
STREAM_ARGS = ["--k", "20000", "--roi_size", "20", "20", "--maxiter", "30",
               "--pyramid_first"]
STREAM_WINDOWS = 16           # at least
# Limits fixed from the CPU port's reading of the same command before the
# first card run (PERF.md section 2): |median(field) - GT| of each window
# (CPU max 19.99 px/s) and the median over ROIs of |v_roi - GT| of each
# window (CPU max 20.12). The warm start carries the solver towards vy = 0
# after 8-10 windows in both packages and on the card, at a window that
# the last bits decide (PERF.md section 6), so these two only catch a
# field far off; a field that lost vy reads 20 px/s and passes them.
STREAM_MEDIAN_ERR = 21.0
STREAM_ROI_ERR = 21.0
# ... and before the drift, limits that such a field fails: windows 0-4,
# |median(field) - GT| (CPU port 1.39-6.57 px/s, JAX 3.22-6.19), and the
# cold solve of window 0, its median ROI error (CPU port 5.61, JAX 5.52).
# The drift has begun as early as window 7 on the card (PERF.md section 6).
STREAM_EARLY_WINDOWS = 5
STREAM_EARLY_MEDIAN_ERR = 8.0
STREAM_FIRST_ROI_ERR = 7.0
STREAM_CPU_TOL = 0.5          # px/s per component: window 1, card vs CPU
# Window 0 is a cold pyramid solve, ill-conditioned: 1e-7 noise in its
# stamps moves the answer by up to 3 px/s on the CPU (PERF.md section 6), so
# its two answers are logged and the function each solver computes is held
# instead: window 0's batched patch loss (the fine level's) and the
# gradient of its sum, card against CPU, at the fine level's start x0 and
# at the CPU's answer plus STREAM_OFFSET (away from the optimum, where the
# gradient is well defined). Rule fixed before its first chip run.
STREAM_OFFSET = (5.0, -5.0)   # px/s on every ROI
STREAM_LOSS_REL = 1e-4        # per ROI, of the CPU's loss
STREAM_GRAD_COS = 0.9999      # the summed loss's gradient over all ROIs
STREAM_GRAD_REL = 1e-3        # its norm, of the CPU's
# JAX's stream_flow on the same recording on the CPU: the medians of
# windows 0 and 1, and the largest and mean errors as above
STREAM_JAX = {"medians_0_1": [[28.803, -17.015], [27.874, -15.494]],
              "median_err_max": 20.031, "median_err_mean": 10.220,
              "roi_err_max": 20.458}
# The augmentation path (BASELINE config 3, the 2x densify sweep on
# slider_depth): the slider-like scene of benchmarks/bench_configs.py:36-50,
# 2^20 draws at 180x240 over 0.5 s, 600 points moving at (70, 30) px/s.
AUG_DRAWS = 1 << 20
AUG_POINTS = 600
AUG_VELOCITY = (70.0, 30.0)   # px/s
AUG_SECONDS = 0.5
AUG_TS_STD = 1e-3             # s, the copies' time jitter: config 3's
AUG_EPOCH = 1.5e9             # s, added to the stamps for the epoch case
AUG_EPOCH_TOL = 1e-6          # s: the sorted stamps, epoch against not
AUG_DEMO_WINDOW = 50_000      # events in augment_demo's window
AUG_REMOVE = 300_000          # slots the keep-mask drops
AUG_ROTATE_TOL = 3.1e-5       # px, card vs CPU: 2 f32 ulps at 256
AUG_REPS = 5                  # warm calls timed (median)
TRAIN_STREAM = ["--sensor", "184", "240", "--k", "20000", "--batch_size", "8",
                "--num_bins", "5", "--epochs", "1"]
FIT_PARITY_STEPS = 2
SRC = "event_utils_tpu_torch/csrc/scatter_kernels.cu"
SOURCES = {"patch_variance_vg":
           "event_utils_tpu_torch/csrc/patch_loss_kernels.cu"}
REPLACES = {
    "voxel_scatter": "event_utils_tpu/ops/pallas_scatter.py:113",
    "voxel_tiles_scatter": "event_utils_tpu/ops/pallas_scatter.py:455",
    "flat_scatter": "event_utils_tpu/ops/pallas_scatter.py:496",
    "bilinear_scatter": "event_utils_tpu/ops/pallas_scatter.py:576",
    "bilinear_patches_scatter": "event_utils_tpu/ops/pallas_scatter.py:576",
    # under jax.vmap (grid_search_initial, events_cmax.py:348; the refine,
    # :451; draw_objective_function, :1557): the call at :732 batched
    "bilinear_scatter_batched": "event_utils_tpu/ops/pallas_scatter.py:576",
    # under jax.vmap (voxel_grids_fixed_n, voxel_grid.py:328; the trainers'
    # padded rows, training/loop.py:174-185): the call at :353 batched
    "voxel_scatter_batched": "event_utils_tpu/ops/pallas_scatter.py:113",
    # no TPU kernel: the JAX patch loss composes bilinear_matmul and XLA ops
    "patch_variance_vg": "none (event_utils_tpu/contrast_max/"
                         "events_cmax.py:506-662)",
}


T_START = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T_START:6.1f} s]", *a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, torch, calls=CALLS, reps=REPS):
    """Device time of one call of ``fn``, in ms.

    ``fn`` (output allocation, zeroing and launches) is captured ``calls``
    times into one CUDA graph, so that the replay runs back to back on the
    card with no host gaps; the result is the median over ``reps`` replays,
    each timed with CUDA events, divided by ``calls``. Slow plain versions
    at the largest shapes pass smaller counts.
    """
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bilinear_bound(x, y, K: int, H: int, W: int, P: int = 1):
    """Bound of one bilinear splat on this run's coordinates, into a
    (K, H, W) image or (K, P, H, W) patches: x and y are read for every
    event, the K weights (and their taps) only for events with a tap inside
    their image; the output is written once. No memset is counted."""
    x0, y0 = x.floor(), y.floor()
    live = int(((x0 >= -1) & (x0 < W) & (y0 >= -1) & (y0 < H)).sum())
    return bound(len(x) * 8 + live * 4 * K + K * P * H * W * 4,
                 live * K * 20)


def check_close(name, got, ref, rel=1e-5):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"  {name}: max|err| {err:.3e} of scale {scale:.3e}")
    if not (err <= rel * max(scale, 1.0)):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"({err} > {rel} * {scale})")
    return err


def voxel_events(rng, sensor=SENSOR):
    """N_VOXEL uniform, time-sorted events over ``sensor``."""
    H, W = sensor
    xs = rng.integers(0, W, N_VOXEL).astype(np.int16)
    ys = rng.integers(0, H, N_VOXEL).astype(np.int16)
    ts = np.sort(rng.uniform(0.0, 0.5, N_VOXEL))
    ps = rng.choice(np.array([-1.0, 1.0]), N_VOXEL)
    return xs, ys, ts, ps


def planted_scene(rng):
    """Points moving with VELOCITY over a 0.25 s window, 200k events."""
    H, W = SENSOR
    n_pts, t_max = 400, 0.25
    vx, vy = VELOCITY
    px = rng.uniform(5 + max(0, -vx * t_max), W - 5 - max(0, vx * t_max),
                     n_pts)
    py = rng.uniform(5 + max(0, -vy * t_max), H - 5 - max(0, vy * t_max),
                     n_pts)
    pol = rng.choice(np.array([-1.0, 1.0]), n_pts)
    idx = rng.integers(0, n_pts, N_SCENE)
    ts = np.sort(rng.uniform(0.0, t_max, N_SCENE))
    xs = px[idx] + vx * ts + rng.normal(0, 0.2, N_SCENE)
    ys = py[idx] + vy * ts + rng.normal(0, 0.2, N_SCENE)
    return xs, ys, ts, pol[idx]


def rotating_scene(seed=0):
    """The bench's rotating scene (180x240, 400 points turning at
    ROT_OMEGA about the centre for 0.2 s, 200k events): the flow varies
    across the sensor and is ~constant within each 20x20 ROI."""
    rng = np.random.default_rng(seed)
    H, W = ROT_SENSOR
    n_pts = 400
    px = rng.uniform(10, W - 10, n_pts)
    py = rng.uniform(10, H - 10, n_pts)
    pol = rng.choice([-1.0, 1.0], n_pts)
    cx, cy = W / 2, H / 2
    idx = rng.integers(0, n_pts, ROT_EVENTS)
    ts = np.sort(rng.uniform(0, 0.2, ROT_EVENTS))
    ang = ROT_OMEGA * ts
    rx = px[idx] - cx
    ry = py[idx] - cy
    xs = (cx + np.cos(ang) * rx - np.sin(ang) * ry
          + rng.normal(0, 0.2, ROT_EVENTS))
    ys = (cy + np.sin(ang) * rx + np.cos(ang) * ry
          + rng.normal(0, 0.2, ROT_EVENTS))
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    return xs[keep], ys[keep], ts[keep], pol[idx][keep]


def flow_error(params, rois, valid):
    """All-valid-ROI median |v - v_true| (px/s) against the rotation field
    at each ROI centre."""
    p, r, v = (a.cpu().numpy() for a in (params, rois, valid))
    cx, cy = ROT_SENSOR[1] / 2, ROT_SENSOR[0] / 2
    gt = np.stack([-ROT_OMEGA * (r[:, 0] + ROT_ROI[0] / 2 - cy),
                   ROT_OMEGA * (r[:, 1] + ROT_ROI[1] / 2 - cx)], 1)
    return float(np.median(np.linalg.norm(p - gt, axis=1)[v])), int(v.sum())


def bucketed_tiles(torch, rng, sensor, tile):
    """N_VOXEL events over ``sensor`` bucketed into ``tile``s by the port's
    bucket_events_by_roi: tile-local (lx, ly), bt, bp, the slot mask and
    the sorted timestamps."""
    from event_utils_tpu_torch.contrast_max import bucket_events_by_roi
    (H, W), (th, tw) = sensor, tile
    ny, nx = -(-H // th), -(-W // tw)
    xs, ys, ts, ps = voxel_events(rng, sensor)
    bx, by, bt, bp, bmask, org, _ = bucket_events_by_roi(
        xs, ys, ts, ps, (ny * th, nx * tw), tile, capacity_cap=None,
        device=torch.device("cuda"))
    lx = bx.int() - org[:, 1:2].int()
    ly = by.int() - org[:, 0:1].int()
    log(f"per-tile voxel {sensor} in {tile} tiles: T={lx.shape[0]}, "
        f"capacity {lx.shape[1]}, {N_VOXEL} events")
    return lx, ly, bt, bp, bmask, ts


def tiles_phase(torch, cs, rng, records):
    """The per-tile voxel kernel's two routes at 720p (80 (96, 128) tiles)
    and VGA, the private route also with unsorted slots and with B=9, and
    the direct route at a tile too large for shared memory."""
    from event_utils_tpu_torch.errors import ConfigurationError
    dev = torch.device("cuda")
    th, tw = TILE
    routes = ("private", "direct")
    lx, ly, bt, bp, bmask, ts = bucketed_tiles(torch, rng,
                                               TILED_SENSORS["720p"], TILE)
    T, cap = lx.shape
    keep = torch.as_tensor(rng.random((T, cap)) > 0.2, device=dev).float()
    errs = {r: [] for r in routes}
    for label, mask, t1 in (("plain window", bmask, ts[-1]),
                            ("masked", bmask * keep, ts[-1]),
                            ("t1 override", bmask, ts[N_VOXEL // 2])):
        args = cs.voxel_tiles_inputs(lx, ly, bt, bp, B, TILE, ts[0], t1,
                                     mask=mask)
        ref = cs.voxel_tiles_scatter_plain(*args, B, th, tw)
        for r in routes:
            errs[r].append(check_close(
                f"voxel_tiles_scatter:{r} ({label})",
                cs.voxel_tiles_scatter(*args, B, th, tw, route=r), ref))
    args = cs.voxel_tiles_inputs(lx, ly, bt, bp, B, TILE, ts[0], ts[-1],
                                 mask=bmask)
    ref = cs.voxel_tiles_scatter_plain(*args, B, th, tw)
    # slots in any order give the same grid, to the order of the atomics
    perm = torch.rand((T, cap), device=dev).argsort(1)
    shuffled = [a.gather(1, perm).contiguous() for a in args]
    errs["private"].append(check_close(
        "voxel_tiles_scatter:private (unsorted slots)",
        cs.voxel_tiles_scatter(*shuffled, B, th, tw), ref))
    # more bins than a tile has in any caller: still one launch
    args9 = cs.voxel_tiles_inputs(lx, ly, bt, bp, 9, TILE, ts[0], ts[-1],
                                  mask=bmask)
    before = cs.launch_counts()["voxel_tiles_scatter:private"]
    errs["private"].append(check_close(
        "voxel_tiles_scatter:private (B=9)",
        cs.voxel_tiles_scatter(*args9, 9, th, tw),
        cs.voxel_tiles_scatter_plain(*args9, 9, th, tw)))
    if cs.launch_counts()["voxel_tiles_scatter:private"] != before + 1:
        raise AssertionError("B=9 did not take the private route")

    t_norm, pv = args[2], args[3]
    b0 = torch.floor(t_norm)
    base = (torch.arange(T, device=dev)[:, None] * B * th * tw
            + args[1].long() * tw + args[0].long())
    ids, vals = [], []
    for b, wt in ((b0, pv * (1 - (t_norm - b0))), (b0 + 1, pv * (t_norm - b0))):
        # dead taps are left out, as for the bilinear library call
        ok = (b >= 0) & (b < B) & (pv != 0)
        ids.append((base + b.long() * th * tw)[ok])
        vals.append(wt[ok])
    ids, vals = torch.cat(ids), torch.cat(vals)
    # the kernel reads bp (4 B) of every slot, and bx, by, t_norm (12 B)
    # only of the live ones; dead slots hold the pad sentinel bp = 0
    live = int((pv != 0).sum())
    log(f"  {live} live slots of {T * cap}")
    shared = dict(
        plain_ms=time_ms(lambda: cs.voxel_tiles_scatter_plain(*args, B, th,
                                                              tw), torch),
        library_ms=time_ms(lambda: torch.zeros(T * B * th * tw, device=dev)
                           .index_put_((ids,), vals, accumulate=True), torch),
        bound=bound(T * cap * 4 + live * 12 + T * B * th * tw * 4, live * 8))
    for r in routes:
        records[f"voxel_tiles_scatter:{r}"] = dict(
            shared, shape=f"720p, {T} tiles x {cap} slots, B={B}",
            ms=time_ms(lambda: cs.voxel_tiles_scatter(*args, B, th, tw,
                                                      route=r), torch))
    log("  720p timed: " + ", ".join(
        f"{r} {records[f'voxel_tiles_scatter:{r}']['ms']:.4f} ms"
        for r in routes) + f", bound {shared['bound'][0]:.4f} ms")

    # ---- VGA, both routes -------------------------------------------------
    vx, vy, vt, vp, vmask, vts = bucketed_tiles(torch, rng,
                                                TILED_SENSORS["VGA"], TILE)
    vargs = cs.voxel_tiles_inputs(vx, vy, vt, vp, B, TILE, vts[0], vts[-1],
                                  mask=vmask)
    vref = cs.voxel_tiles_scatter_plain(*vargs, B, th, tw)
    vlive = int((vargs[3] != 0).sum())
    for r in routes:
        err = check_close(f"voxel_tiles_scatter:{r} (VGA)",
                          cs.voxel_tiles_scatter(*vargs, B, th, tw, route=r),
                          vref)
        errs[r].append(err)
        records[f"voxel_tiles_scatter:{r}"]["cases"] = [dict(
            shape=f"VGA, {vx.shape[0]} tiles x {vx.shape[1]} slots, B={B}",
            ms=time_ms(lambda: cs.voxel_tiles_scatter(*vargs, B, th, tw,
                                                      route=r), torch),
            max_abs_err=err,
            bound_ms=bound(vx.numel() * 4 + vlive * 12 + vref.numel() * 4,
                           vlive * 8)[0])]

    # ---- a tile whose plane exceeds shared memory: the direct route ------
    bh, bw = BIG_TILE
    gx, gy, gt, gp, gmask, gts = bucketed_tiles(torch, rng,
                                                TILED_SENSORS["720p"],
                                                BIG_TILE)
    gargs = cs.voxel_tiles_inputs(gx, gy, gt, gp, B, BIG_TILE, gts[0],
                                  gts[-1], mask=gmask)
    if cs.voxel_tiles_route(B, bh, bw) != "direct":
        raise AssertionError(f"{BIG_TILE} tiles must take the direct route")
    errs["direct"].append(check_close(
        f"voxel_tiles_scatter:direct ({BIG_TILE} tiles)",
        cs.voxel_tiles_scatter(*gargs, B, bh, bw),
        cs.voxel_tiles_scatter_plain(*gargs, B, bh, bw)))
    try:
        cs.voxel_tiles_scatter(*gargs, B, bh, bw, route="private")
    except ConfigurationError:
        pass
    else:
        raise AssertionError("the private route took a plane that cannot "
                             "fit shared memory")
    for r in routes:
        records[f"voxel_tiles_scatter:{r}"]["max_abs_err"] = max(errs[r])


def live_taps(torch, x, y, w, H, W, base=None, pixels=None):
    """Flat ids and values of the in-image taps of a bilinear splat of the
    K rows of ``w``, for one ``index_put_`` into (K * pixels,); ``base`` is
    each slot's first pixel id (patches) and ``pixels`` the size of one
    channel (H * W for an image). Taps outside the image are left out: sent
    to one id with weight 0 they would serialise index_put_'s duplicate
    runs."""
    pixels = H * W if pixels is None else pixels
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    taps_i, taps_v = [], []
    for oy, wy in ((0, 1 - (y - y0)), (1, y - y0)):
        for ox, wx in ((0, 1 - (x - x0)), (1, x - x0)):
            ok = ((x0 + ox >= 0) & (x0 + ox < W) & (y0 + oy >= 0)
                  & (y0 + oy < H))
            pix = ((y0 + oy) * W + x0 + ox)[ok].long()
            if base is not None:
                pix = pix + base[ok]
            for k in range(w.shape[0]):
                taps_i.append(pix + k * pixels)
                taps_v.append((w[k] * wx * wy)[ok])
    return torch.cat(taps_i), torch.cat(taps_v)


def patches_library_ms(torch, x, y, w, P, C, PH, PW, **counts):
    """Time of one ``index_put_(accumulate=True)`` that computes the patch
    splat of all K channels on precomputed ids and weights."""
    dev = x.device
    K, pixels = w.shape[0], P * PH * PW
    base = torch.arange(P, device=dev).repeat_interleave(C) * (PH * PW)
    bi, bv = live_taps(torch, x, y, w, PH, PW, base, pixels)
    return time_ms(lambda: torch.zeros(K * pixels, device=dev).index_put_(
        (bi,), bv, accumulate=True), torch, **counts)


def bilinear_case(torch, cs, label, x, y, w1, H, W, routes):
    """One splat of the K rows of ``w1`` (K, N) at (x, y) into (H, W) on
    each of ``routes``: every route against the plain version, its time,
    and the plain, ``index_put_`` and bound times of the shape. Returns
    ``{route: record}``."""
    K = w1.shape[0]
    bi, bv = live_taps(torch, x, y, w1, H, W)
    shape = f"K={K}, {len(x)} events ({label}) into {H}x{W}"
    ref = cs.bilinear_scatter_plain(x, y, w1, H, W)
    shared = dict(
        shape=shape,
        plain_ms=time_ms(lambda: cs.bilinear_scatter_plain(x, y, w1, H, W),
                         torch),
        library_ms=time_ms(lambda: torch.zeros(K * H * W, device=x.device)
                           .index_put_((bi,), bv, accumulate=True), torch),
        bound=bilinear_bound(x, y, K, H, W))
    out = {}
    for r in routes:
        got = cs.bilinear_scatter(x, y, w1, H, W, route=r)
        out[r] = dict(
            shared,
            max_abs_err=check_close(f"bilinear_scatter:{r} ({shape})", got,
                                    ref),
            ms=time_ms(lambda: cs.bilinear_scatter(x, y, w1, H, W, route=r),
                       torch))
        if r == "vector":
            out[r]["max_abs_err"], out[r]["limit_share"] = single_splat_check(
                torch, cs, f"bilinear_scatter:{r} ({shape})", got, x, y, w1,
                H, W)
    log("  timed: " + ", ".join(f"{r} {out[r]['ms']:.4f} ms" for r in routes)
        + f", plain {shared['plain_ms']:.4f} ms, index_put_ "
        f"{shared['library_ms']:.4f} ms, bound {shared['bound'][0]:.5f} ms")
    return out


def single_splat_check(torch, cs, name, got, x, y, w, H, W):
    """A single (K, H, W) splat held per pixel, as ``batched_case`` holds a
    batched one: ``got`` viewed as one sample against the plain version in
    float64 within ``splat_limits``. Returns the max |err| and the largest
    share of a pixel's limit used."""
    K = w.shape[0]
    return check_splat(
        f"{name}, against the plain version in float64 per pixel",
        got.view(1, K, H, W),
        cs.bilinear_scatter_batched_plain(x[None].double(), y[None].double(),
                                          w.double(), H, W),
        splat_limits(torch, x[None], y[None], w, H, W))


def as_case(rec, **extra):
    """A timed case for the kernels line; ``direct_ms`` where the case was
    also timed on the direct route (the vector route's shapes), and
    ``limit_share`` where it was held per pixel."""
    return dict({k: rec[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                     "max_abs_err", "direct_ms",
                                     "limit_share", "dispatch")
                 if k in rec}, bound_ms=rec["bound"][0], **extra)


def batched_bound(x, y, w, H: int, W: int):
    """Bound of one batched splat on this run's coordinates: x and y read
    for every slot; weights read once where the samples share them, else
    for the slots with a tap inside their image; the S images written
    once. No memset is counted."""
    S, n = x.shape
    K = w.shape[-2]
    x0, y0 = x.floor(), y.floor()
    live = int(((x0 >= -1) & (x0 < W) & (y0 >= -1) & (y0 < H)).sum())
    w_bytes = K * n * 4 if w.dim() == 2 else live * K * 4
    return bound(S * n * 8 + w_bytes + S * K * H * W * 4, live * K * 20)


def batched_library_ms(torch, x, y, w, H, W, **counts):
    """Time of one ``index_put_(accumulate=True)`` over the S x 4 x N flat
    ids (live taps only) of a batched splat of all K channels."""
    S, n = x.shape
    K = w.shape[-2]
    wk = (w[:, None, :].expand(K, S, n) if w.dim() == 2
          else w.transpose(0, 1)).reshape(K, S * n)
    base = torch.arange(S, device=x.device).repeat_interleave(n) * (H * W)
    bi, bv = live_taps(torch, x.reshape(-1), y.reshape(-1), wk, H, W, base,
                       S * H * W)
    return time_ms(lambda: torch.zeros(K * S * H * W, device=x.device)
                   .index_put_((bi,), bv, accumulate=True), torch, **counts)


def splat_limits(torch, x, y, w, H: int, W: int):
    """Per-pixel limit of a batched splat's f32 rounding against its
    float64 plain version: SPLAT_ROUNDING x sqrt(m) x eps32 x sum|terms|,
    where m counts the pixel's terms ``w*wx*wy`` (non-zero weights, taps
    inside the image). Each term is rounded twice, within eps32 |term|;
    m terms summed in any order (shared memory, then the L2's atomics)
    err by at most (m-1)/2 x eps32 x sum|terms|, which the limit covers up
    to m = 254, and by ~sqrt(m) of that in the random orders of atomics
    beyond. A pixel that gets no term must stay exactly zero, and a lost or
    misplaced term misses the limit by orders of magnitude."""
    S, n = x.shape
    K = w.shape[-2]
    f64 = torch.float64
    x, y = x.double(), y.double()
    x0, y0 = x.floor(), y.floor()
    wabs = w.abs().to(f64).expand(S, K, n)
    live = wabs != 0
    mag = torch.zeros((S, K, H * W), dtype=f64, device=x.device)
    cnt = torch.zeros_like(mag)
    for oy, wy in ((0, 1 - (y - y0)), (1, y - y0)):
        for ox, wx in ((0, 1 - (x - x0)), (1, x - x0)):
            ok = ((x0 + ox >= 0) & (x0 + ox < W) & (y0 + oy >= 0)
                  & (y0 + oy < H))
            pix = torch.where(ok, (y0 + oy) * W + x0 + ox, 0.0).long()
            pix = pix[:, None, :].expand(S, K, n)
            on = ok[:, None, :] & live
            mag.scatter_add_(-1, pix, torch.where(
                on, wabs * (wx * wy)[:, None, :], 0.0))
            cnt.scatter_add_(-1, pix, on.to(f64))
    eps = torch.finfo(torch.float32).eps
    return (SPLAT_ROUNDING * eps * cnt.sqrt() * mag).view(S, K, H, W)


def check_splat(name, got, ref, limit):
    """Every pixel of ``got`` within its ``limit`` of ``ref``. Returns the
    max |err| and the largest share of a pixel's limit used."""
    err = (got.double() - ref.double()).abs()
    over = err > limit
    share = float((err / limit.clamp_min(1e-300)).max())
    worst = float(err.max())
    log(f"  {name}: max|err| {worst:.3e} of scale "
        f"{float(ref.abs().max()):.3e}, {share:.3e} of a pixel's limit")
    if bool(over.any()):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"at {int(over.sum())} pixels (max|err| "
                             f"{worst}, {share} of a pixel's limit)")
    return worst, share


def batched_case(torch, cs, label, x, y, w, H, W, route, single=True):
    """One batched splat on ``route`` against its plain version and, with
    ``single``, against S single ``bilinear_scatter`` launches; its time
    beside the plain version's, ``index_put_``'s and the bound."""
    S, n = x.shape
    K = w.shape[-2]
    slow = dict(calls=2, reps=5)
    kernel = lambda: cs.bilinear_scatter_batched(x, y, w, H, W, route=route)
    shape = f"S={S} x {n} events, K={K} ({label}) into {H}x{W}"
    before = cs.launch_counts()[f"bilinear_scatter_batched:{route}"]
    got = kernel()
    chunks = -(-S // cs.batched_chunk(route, K, H, W))
    if cs.launch_counts()[f"bilinear_scatter_batched:{route}"] != (
            before + chunks):
        raise AssertionError(f"{shape}: not {chunks} launches")
    limit = splat_limits(torch, x, y, w, H, W)
    err, share = check_splat(
        f"bilinear_scatter_batched:{route} ({shape}), against the plain "
        f"version in float64", got, cs.bilinear_scatter_batched_plain(
            x.double(), y.double(), w.double(), H, W), limit)
    if single:
        e1, s1 = check_splat(
            f"bilinear_scatter_batched:{route} vs {S} single launches "
            f"({shape})", got, torch.stack([cs.bilinear_scatter(
                x[s], y[s], w if w.dim() == 2 else w[s], H, W)
                for s in range(S)]), 2.0 * limit)
        err, share = max(err, e1), max(share, s1)
    del limit
    case = dict(shape=shape, max_abs_err=err, limit_share=share,
                ms=time_ms(kernel, torch),
                plain_ms=time_ms(lambda: cs.bilinear_scatter_batched_plain(
                    x, y, w, H, W), torch, **slow),
                library_ms=batched_library_ms(torch, x, y, w, H, W, **slow),
                bound=batched_bound(x, y, w, H, W))
    log(f"  timed: {case['ms']:.4f} ms ({chunks} launch"
        f"{'es' if chunks > 1 else ''}), plain {case['plain_ms']:.4f} ms, "
        f"index_put_ {case['library_ms']:.4f} ms, bound "
        f"{case['bound'][0]:.5f} ms")
    return case


def grid_samples(v, dims=2):
    """(S, dims) velocity samples of one grid level: a 5-point axis each."""
    return np.stack(np.meshgrid(*[v] * dims, indexing="ij"),
                    -1).reshape(-1, dims)


def batched_kernel_cases(torch, cs, rng, records):
    """The batched splat's routes at the grid searches' shapes against
    their plain version and against S single splats: one grid level (25
    velocity samples of the 200k planted scene warped, per-sample masked
    weights, K = 1: private), S = 1, one chunk of the loss (83 samples of
    200k events), the rotating scene's grid level, 25 samples with every
    event on one pixel, S at and across the samples one launch takes (65535 and
    65536, one launch and two) on both routes, a sample wholly off the
    image and one with NaN, +-inf and huge coordinates on both routes, and
    zhu's K = 4 stack (direct). Each is held per pixel within
    ``splat_limits`` of the plain version in float64. Fills both routes'
    records."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    dev = torch.device("cuda")
    H, W = SENSOR[0] + 1, SENSOR[1] + 1
    sx, sy, st, sp = planted_scene(np.random.default_rng(SEED))
    t = torch.as_tensor(st - st[-1], dtype=torch.float32, device=dev)
    ex = torch.as_tensor(sx, dtype=torch.float32, device=dev)
    ey = torch.as_tensor(sy, dtype=torch.float32, device=dev)
    ep = torch.as_tensor(sp, dtype=torch.float32, device=dev)

    def warped(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        x = (ex - t * v[:, 0:1]).contiguous()
        y = (ey - t * v[:, 1:2]).contiguous()
        valid = (x > 0) & (x < W - 1) & (y > 0) & (y < H - 1)
        return x, y, (ep * valid)[:, None, :].contiguous()

    level = grid_samples(np.linspace(-150.0, 150.0, 5))
    x, y, w = warped(level)
    chunk = ec.batch_chunk(len(sx), SENSOR)
    log(f"batched splat: {len(level)} samples x {len(sx)} events into "
        f"{H}x{W} (the loss's chunks: {chunk} samples)")
    priv = [batched_case(torch, cs, "one grid level", x, y, w, H, W,
                         "private")]
    forced = batched_case(torch, cs, "one grid level", x, y, w, H, W,
                          "direct", single=False)
    priv.append(batched_case(torch, cs, "S = 1", x[:1], y[:1], w[:1], H, W,
                             "private"))
    xb, yb, wb = warped(rng.uniform(-150, 150, (chunk, 2)))
    priv.append(batched_case(torch, cs, "one chunk of the loss", xb, yb, wb,
                             H, W, "private", single=False))
    del xb, yb, wb
    # the rotating scene's grid level, and every event of every sample on
    # one pixel: the longest chains of the shared-memory CAS loop
    rx, ry, rt, rp = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in rotating_scene())
    v = torch.as_tensor(level, dtype=torch.float32, device=dev)
    rt = rt - rt[-1]
    xr = (rx - rt * v[:, 0:1]).contiguous()
    yr = (ry - rt * v[:, 1:2]).contiguous()
    ok = (xr > 0) & (xr < W - 1) & (yr > 0) & (yr < H - 1)
    priv.append(batched_case(torch, cs, "the rotating scene's grid level",
                             xr, yr, (rp * ok)[:, None, :].contiguous(), H, W,
                             "private", single=False))
    del xr, yr, ok
    priv.append(batched_case(torch, cs, "every event on one pixel",
                             x * 0 + 100.25, y * 0 + 50.75,
                             w.abs().contiguous(), H, W, "private",
                             single=False))
    # at and across the samples one launch takes (the grid's y extent):
    # one launch and two, 4 events a sample into 6x8
    edge = []
    for S in (cs.BATCH_MAX_SAMPLES, cs.BATCH_MAX_SAMPLES + 1):
        xe, ye = (torch.as_tensor(rng.uniform(-1, hi, (S, 4)),
                                  dtype=torch.float32, device=dev)
                  for hi in (9, 7))
        we = torch.as_tensor(rng.normal(size=(1, 4)), dtype=torch.float32,
                             device=dev)
        for r in ("private", "direct"):
            (priv if r == "private" else edge).append(batched_case(
                torch, cs, f"{S} samples", xe, ye, we, 6, 8, r,
                single=False))
    # zhu's timestamp stack: K = 4 per-sample weights past 227 KB, on the
    # vector route (part 11 of the tune script) and forced onto the direct
    # one
    tn = (t - t.min()) / (t.max() - t.min())
    pos, neg = (ep > 0).float(), (ep <= 0).float()
    w4 = (torch.stack([tn * pos, pos, tn * neg, neg])[None]
          * (w[:, 0:1] != 0)).contiguous()
    if cs.bilinear_batched_route(4, H, W, len(sx)) != "vector":
        raise AssertionError("K=4 at 181x241, 200k events a sample: want "
                             "the vector route")
    k4 = batched_case(torch, cs, "zhu's stack", x, y, w4, H, W, "vector")
    k4d = batched_case(torch, cs, "zhu's stack", x, y, w4, H, W, "direct",
                       single=False)
    k4["direct_ms"] = k4d["ms"]
    xo, yo = x[:4].clone(), y[:4].clone()
    xo[1] = -1000.0                                 # every tap off
    odd = torch.as_tensor([np.nan, np.inf, -np.inf, 1e30, -1e30, 2.0 ** 31],
                          dtype=torch.float32, device=dev)
    xo[2, ::5] = odd[torch.arange(len(xo[2, ::5]), device=dev) % 6]
    yo[3, 3::7] = odd[torch.arange(len(yo[3, 3::7]), device=dev) % 6]
    wo = {r: (w4 if r == "vector" else w)[:4].contiguous()
          for r in ("private", "direct", "vector")}
    odd_cases = {r: batched_case(torch, cs, "odd coordinates", xo, yo, wo[r],
                                 H, W, r) for r in wo}
    for r in wo:
        if float(cs.bilinear_scatter_batched(xo, yo, wo[r], H, W,
                                             route=r)[1].abs().max()):
            raise AssertionError(f"bilinear_scatter_batched:{r}: a sample "
                                 f"off the image left a mark")
    for route, cases in (("private", priv + [odd_cases["private"]]),
                         ("vector", [k4, odd_cases["vector"]]),
                         ("direct", [k4d, forced, odd_cases["direct"]]
                          + edge)):
        rec = dict(cases[0])
        rec["cases"] = [as_case(c, limit_share=c["limit_share"])
                        for c in cases]
        rec["max_abs_err"] = max(c["max_abs_err"] for c in cases)
        records[f"bilinear_scatter_batched:{route}"] = rec


def odd_coordinates(torch, cs, rng):
    """NaN, +-inf, +-1e30 and out-of-frame coordinates on every bilinear
    route (two channels: the vector route pairs them): dropped, never
    wrapped; a stream wholly out of frame gives an exact zero image.
    Returns ``{route: max |err|}``."""
    dev = torch.device("cuda")
    H, W, n = 40, 60, 4096
    odd = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, -1.0, -1.5, W - 1,
                    W - 0.5, W, 2.0 ** 31, -2.0 ** 31, 2.0 ** 40])
    x = rng.uniform(-2, W + 1, n)
    y = rng.uniform(-2, H + 1, n)
    x[::7] = odd[np.arange(len(x[::7])) % len(odd)]
    y[3::11] = odd[np.arange(len(y[3::11])) % len(odd)]
    x, y = (torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (x, y))
    w = torch.as_tensor(rng.uniform(-1, 1, (2, n)), dtype=torch.float32,
                        device=dev)
    ref = cs.bilinear_scatter_plain(x, y, w, H, W)
    errs = {}
    for r in ("direct", "single", "private", "vector"):
        errs[r] = check_close(f"bilinear_scatter:{r} (odd coordinates)",
                              cs.bilinear_scatter(x, y, w, H, W, route=r),
                              ref)
        away = cs.bilinear_scatter(x * 0 - 10.0, y, w, H, W, route=r)
        if float(away.abs().max()) != 0.0:
            raise AssertionError(f"bilinear_scatter:{r}: out-of-frame events "
                                 f"left a mark")
    P, C = 4, n // 4
    pref = cs.bilinear_patches_scatter_plain(x, y, w, P, C, H, W)
    for r in ("patch", "direct"):
        errs[f"patches {r}"] = check_close(
            f"bilinear_patches_scatter {r} route (odd coordinates)",
            cs.bilinear_patches_scatter(x, y, w, P, C, H, W, route=r), pref)
        away = cs.bilinear_patches_scatter(x, y * 0 + 1e30, w, P, C, H, W,
                                           route=r)
        if float(away.abs().max()) != 0.0:
            raise AssertionError(f"bilinear_patches_scatter {r}: "
                                 f"out-of-frame events left a mark")
    return errs


def patch_loss_inputs(torch, objective):
    """The patch kernel's inputs in one evaluation of the batched patch
    loss of ``grid_cmax_batched``'s first grid-search step: the rotating
    scene bucketed into 108 ROIs at capacity 2048, 25 velocity samples per
    ROI. Returns (x, y, w, P, C, PH, PW) as the loss hands them to
    ``bilinear_patches_scatter`` (K=1 for 'variance', K=4 for 'zhu')."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.contrast_max import linvel_warp
    dev = torch.device("cuda")
    H, W = ROT_SENSOR
    bx, by, bt, bp, bm, org, _ = ec.bucket_events_by_roi(
        *rotating_scene(), ROT_SENSOR, ROT_ROI, ROT_CAPACITY, device=dev)
    R = bx.shape[0]
    loss = ec.make_patch_loss(linvel_warp(), ROT_ROI, objective,
                              full_pixels=(H + 1) * (W + 1))
    g = torch.linspace(-150.0, 150.0, 5, device=dev)
    params = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1)
    params = params.reshape(1, 25, 2).expand(R, 25, 2)
    seen = []
    splat = ec.bilinear_patches_scatter

    def capture(*a, **kw):
        seen.append(a)
        return splat(*a, **kw)

    ec.bilinear_patches_scatter = capture
    try:
        with torch.no_grad():
            loss(params, bx, by, bt, bp, bm, org.float())
    finally:
        ec.bilinear_patches_scatter = splat
    x, y, w, P, C, PH, PW = seen[0]
    log(f"patch loss ({objective}): {R} ROIs x 25 samples = {P} patches of "
        f"({PH}, {PW}), {C} slots each, K={w.shape[0]}")
    return x.contiguous(), y.contiguous(), w.contiguous(), P, C, PH, PW


def atlas_route(torch, cs, x, y, w, P, C, PH, PW):
    """The route the patch kernel replaced: every patch splatted by the
    direct kernel into one near-square atlas (zeroed first), then un-tiled
    with a copy. The same function where every slot with a tap outside its
    patch has weight 0, as the patch loss makes them. Returns the callable
    (atlas coordinates are made once, outside it)."""
    K = w.shape[0]
    ncol = max(1, int(round(np.sqrt(P * PH / PW))))
    nrow = -(-P // ncol)
    q = torch.arange(P, device=x.device).repeat_interleave(C)
    x0, y0 = torch.floor(x), torch.floor(y)
    inpatch = (x0 >= 0) & (x0 + 1 < PW) & (y0 >= 0) & (y0 + 1 < PH)
    ax = torch.where(inpatch, x + (q % ncol * PW).float(), -2.0)
    ay = torch.where(inpatch, y + (q // ncol * PH).float(), -2.0)

    def run():
        img = cs.bilinear_scatter(ax, ay, w, nrow * PH, ncol * PW,
                                  route="direct")
        img = img.view(K, nrow, PH, ncol, PW).permute(0, 1, 3, 2, 4)
        return img.reshape(K, nrow * ncol, PH, PW)[:, :P]

    return run


def patches_phase(torch, cs, rng, records, odd_errs):
    """The patch kernel at one batched loss evaluation (K=1 and K=4),
    against its plain version and the atlas route; a ragged shape; a patch
    too large for shared memory (direct route); gradients. ``odd_errs``:
    what ``odd_coordinates`` returned (its patch routes' errors count
    here)."""
    dev = torch.device("cuda")
    slow = dict(calls=2, reps=5)
    errs, cases, steps = [], [], []
    for objective in ("variance", "zhu"):
        x, y, w, P, C, PH, PW = patch_loss_inputs(torch, objective)
        K = w.shape[0]
        kernel = lambda: cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW)
        plain = lambda: cs.bilinear_patches_scatter_plain(x, y, w, P, C, PH,
                                                          PW)
        atlas = atlas_route(torch, cs, x, y, w, P, C, PH, PW)
        ref = plain()
        shape = (f"K={K}, {P} patches x {C} slots into ({PH}, {PW}) "
                 f"(one {objective} loss evaluation)")
        rec = dict(
            shape=shape,
            max_abs_err=check_close(f"bilinear_patches_scatter ({shape})",
                                    kernel(), ref),
            bound=bilinear_bound(x, y, K, PH, PW, P))
        # the atlas offsets ride on the f32 coordinates (up to ~4.7e3 px):
        # the bilinear fractions there keep ~5e-4 px, hence 1e-3
        check_close("  atlas route (direct kernel + un-tiling) on the same "
                    "evaluation", atlas(), ref, rel=1e-3)
        del ref
        rec["ms"] = time_ms(kernel, torch)
        rec["atlas_ms"] = time_ms(atlas, torch, **slow)
        rec["plain_ms"] = time_ms(plain, torch, **slow)
        rec["library_ms"] = patches_library_ms(torch, x, y, w, P, C, PH, PW,
                                               **slow)
        log(f"  timed: patch kernel {rec['ms']:.4f} ms, atlas route "
            f"{rec['atlas_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"index_put_ {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound'][0]:.4f} ms")
        errs.append(rec["max_abs_err"])
        cases.append(rec)
        # one descent step: one sample per ROI, the direct route
        steps.append(descent_step_case(torch, cs, x, y, w, P // 25, C, PH,
                                       PW))
        if K == 1:   # the descent's worst case: every slot on one pixel
            steps.append(descent_step_case(
                torch, cs, x * 0 + 60.5, y * 0 + 30.25, w.abs(), P // 25, C,
                PH, PW, label="every slot on one pixel"))
        del x, y, w, kernel, plain, atlas
        torch.cuda.empty_cache()

    # ---- ragged: sizes that are no multiple of any block --------------------
    P, C, PH, PW = 7, 1000, 24, 40
    x = torch.as_tensor(rng.uniform(-2, PW + 1, P * C), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.uniform(-2, PH + 1, P * C), dtype=torch.float32,
                        device=dev)
    w = torch.as_tensor(rng.uniform(-1, 1, (3, P * C)), dtype=torch.float32,
                        device=dev)
    ref = cs.bilinear_patches_scatter_plain(x, y, w, P, C, PH, PW)
    derr = check_close(
        f"bilinear_patches_scatter:direct (ragged: P={P}, C={C}, "
        f"({PH}, {PW}), K=3)",
        cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW), ref)
    # the fewest and the most patches the direct route takes at (64, 128),
    # per pixel
    dshare = 0.0
    for P1, C1 in ((1, 2048), (cs.PATCH_MIN_PATCHES - 1, 256)):
        x1 = torch.as_tensor(rng.uniform(-2, 129, P1 * C1),
                             dtype=torch.float32, device=dev)
        y1 = torch.as_tensor(rng.uniform(-2, 65, P1 * C1),
                             dtype=torch.float32, device=dev)
        w1 = torch.as_tensor(rng.normal(size=(1, P1 * C1)),
                             dtype=torch.float32, device=dev)
        e1, s1 = patch_splat_check(
            torch, cs, f"bilinear_patches_scatter:direct ({P1} patches x "
            f"{C1} slots into (64, 128))",
            cs.bilinear_patches_scatter(x1, y1, w1, P1, C1, 64, 128), x1, y1,
            w1, P1, C1, 64, 128)
        derr, dshare = max(derr, e1), max(dshare, s1)
    patch = lambda *a: cs.bilinear_patches_scatter(*a, route="patch")
    errs.append(check_close(
        "bilinear_patches_scatter (the same, patch route)",
        patch(x, y, w, P, C, PH, PW), ref))
    # P = 1 is the whole-image splat
    errs.append(check_close(
        "bilinear_patches_scatter (P=1) vs bilinear_scatter_plain",
        patch(x, y, w, 1, P * C, PH, PW)[:, 0],
        cs.bilinear_scatter_plain(x, y, w, PH, PW)))
    # gradients: kernel forward + gather backward vs autograd of index_add_
    tgt = torch.as_tensor(rng.normal(size=(3, P, PH, PW)),
                          dtype=torch.float32, device=dev)
    grads = []
    for fn in (patch, cs.bilinear_patches_scatter_plain):
        leaves = [a.clone().requires_grad_(True) for a in (x, y, w)]
        grads.append(torch.autograd.grad(
            (fn(*leaves, P, C, PH, PW) * tgt).sum(), leaves))
    for name, gk, gp in zip("xyw", *grads):
        errs.append(check_close(f"bilinear_patches grad d{name}", gk, gp,
                                rel=1e-4))
    errs.append(max(odd_errs["patches patch"], odd_errs["patches direct"]))

    top = cases[0]
    top["cases"] = [as_case(c, atlas_ms=c["atlas_ms"]) for c in cases]
    top["max_abs_err"] = max(errs)
    records["bilinear_patches_scatter"] = top

    # ---- a patch whose plane exceeds shared memory: the direct route ----
    P, C, (PH, PW) = 2, 100_000, BIG_TILE
    if cs.bilinear_patches_route(2700, PH, PW) != "direct":
        raise AssertionError(f"{BIG_TILE} patches must take the direct route")
    x = torch.as_tensor(rng.uniform(-2, PW + 1, P * C), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.uniform(-2, PH + 1, P * C), dtype=torch.float32,
                        device=dev)
    w = torch.as_tensor(rng.uniform(-1, 1, (1, P * C)), dtype=torch.float32,
                        device=dev)
    shape = f"K=1, {P} patches x {C} slots into ({PH}, {PW})"
    wide = dict(
        shape=shape,
        max_abs_err=check_close(
            f"bilinear_patches_scatter:direct ({shape})",
            cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW),
            cs.bilinear_patches_scatter_plain(x, y, w, P, C, PH, PW)),
        ms=time_ms(lambda: cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW),
                   torch),
        plain_ms=time_ms(lambda: cs.bilinear_patches_scatter_plain(
            x, y, w, P, C, PH, PW), torch),
        library_ms=patches_library_ms(torch, x, y, w, P, C, PH, PW),
        bound=bilinear_bound(x, y, 1, PH, PW, P))
    step = dict(steps[0])
    step["cases"] = [as_case(c, limit_share=c["limit_share"],
                             atlas_ms=c["atlas_ms"],
                             patch_route_ms=c["patch_route_ms"])
                     for c in steps] + [as_case(wide)]
    step["max_abs_err"] = max([c["max_abs_err"] for c in steps]
                              + [wide["max_abs_err"], derr])
    step["limit_share"] = max([c["limit_share"] for c in steps] + [dshare])
    records["bilinear_patches_scatter:direct"] = step


def patch_variance_case(torch, cs, label, args, R, C, roi, patch, fp):
    """One fused patch-loss evaluation, value and gradient, on ``args`` (the
    wrapper's tensors) against its plain version, timed beside it and beside
    the composed body it replaces (``make_patch_loss`` with the route off:
    the warp, the patch splat, cuDNN's blur, the sums and autograd's
    backward); the bound: the slots' 20 bytes, read once."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.ops.blur import gaussian_kernel1d
    ev, params, taps = args[:6], args[6], args[7]
    sigma = (len(taps) // 2) / 4.0
    if not np.allclose(gaussian_kernel1d(sigma), taps.cpu().numpy()):
        raise AssertionError(f"patch_variance_vg: taps {taps} are no blur "
                             f"the case can rebuild")
    kernel = lambda: cs.patch_variance_vg(*ev, params, taps, roi, patch, fp)
    plain = lambda: cs.patch_variance_vg_plain(*ev, params, taps, roi, patch,
                                               fp)
    loss = ec.make_patch_loss(ec.linvel_warp(), roi, ec.variance_objective(),
                              patch=patch, blur_sigma=sigma, full_pixels=fp)

    def composed():
        was, ec.FUSED_DEVICE_TYPE = ec.FUSED_DEVICE_TYPE, "none"
        try:
            q = params.detach().requires_grad_(True)
            with torch.enable_grad():
                v = loss(q, *ev)
                return v, torch.autograd.grad(v.sum(), q)[0]
        finally:
            ec.FUSED_DEVICE_TYPE = was

    def held(what, got, ref, rel):
        # of the reference's own scale: losses ~1e-2, gradients ~1e-5
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"  patch_variance_vg {what} ({shape}): max|err| {err:.3e} of "
            f"scale {scale:.3e}")
        if not err <= rel * scale:
            raise AssertionError(f"patch_variance_vg {what} ({shape}): "
                                 f"{err} > {rel} * {scale}")
        return err

    shape = f"{R} ROIs x {C} slots into {patch} patches ({label})"
    (v, g), (pv, pg), (cv, cg) = kernel(), plain(), composed()
    err = max(held("loss", v, pv, 1e-5), held("gradient", g, pg, 1e-4))
    held("loss against the composed body", v, cv, 1e-5)
    held("gradient against the composed body", g, cg, 1e-4)
    return dict(shape=shape, max_abs_err=err, ms=time_ms(kernel, torch),
                plain_ms=time_ms(plain, torch),
                library_ms=time_ms(composed, torch),
                value_ms=time_ms(lambda: cs.patch_variance_vg(
                    *ev, params, taps, roi, patch, fp, grad=False), torch),
                bound=bound(R * C * 20 + R * 20 + len(taps) * 4 + R * 12,
                            R * C * 60))


def patch_variance_phase(torch, cs, records):
    """The fused patch loss at the stream's shapes: 20k events of the
    rotating scene in 108 ROIs of 20 x 20 at capacities 1024 and 2048,
    (64, 128) patches, the 181 x 241 frame, the rotation's velocities."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.ops.blur import gaussian_kernel1d
    sx, sy, st, sp = (a[:20_000] for a in rotating_scene())
    taps = torch.as_tensor(gaussian_kernel1d(1.0), dtype=torch.float32,
                           device="cuda")
    cases = []
    for capacity in (1024, 2048):
        bx, by, bt, bp, bm, org, _ = ec.bucket_events_by_roi(
            sx, sy, st, sp, ROT_SENSOR, ROT_ROI, capacity, device="cuda")
        org = org.to(torch.float32)
        oy = org[:, 0] + ROT_ROI[0] / 2 - ROT_SENSOR[0] / 2
        ox = org[:, 1] + ROT_ROI[1] / 2 - ROT_SENSOR[1] / 2
        params = torch.stack([-ROT_OMEGA * oy, ROT_OMEGA * ox], -1)
        cases.append(patch_variance_case(
            torch, cs, "one descent step of the stream",
            (bx, by, bt, bp, bm, org, params.contiguous(), taps),
            *bx.shape, ROT_ROI, ec._roi_patch(ROT_ROI),
            (ROT_SENSOR[0] + 1) * (ROT_SENSOR[1] + 1)))
        log(f"  patch_variance_vg at {cases[-1]['shape']}: "
            f"{cases[-1]['ms']:.4f} ms (value alone "
            f"{cases[-1]['value_ms']:.4f}), plain {cases[-1]['plain_ms']:.4f}"
            f", composed body {cases[-1]['library_ms']:.4f}, bound "
            f"{cases[-1]['bound'][0]:.5f} ms")
    rec = dict(cases[-1])
    rec["cases"] = [as_case(c, value_ms=c["value_ms"]) for c in cases]
    rec["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    records["patch_variance_vg"] = rec


def descent_step_case(torch, cs, x, y, w, P, C, PH, PW,
                      label="one descent step"):
    """One descent step of the batched patch loss (one sample per ROI: the
    first ``P`` patches of a grid-search evaluation): few patches, which
    the direct patch route serves. Gated per pixel (``splat_limits``, each
    patch a sample); its time beside the patch kernel's and the atlas
    route's on the same inputs."""
    x, y, w = (x[:P * C].contiguous(), y[:P * C].contiguous(),
               w[:, :P * C].contiguous())
    if cs.bilinear_patches_route(P, PH, PW) != "direct":
        raise AssertionError(f"{P} patches must take the direct route")
    shape = (f"K={w.shape[0]}, {P} patches x {C} slots into ({PH}, {PW}) "
             f"({label})")
    err, share = patch_splat_check(
        torch, cs, f"bilinear_patches_scatter:direct ({shape})",
        cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW), x, y, w, P, C,
        PH, PW)
    rec = dict(
        shape=shape, max_abs_err=err, limit_share=share,
        ms=time_ms(lambda: cs.bilinear_patches_scatter(x, y, w, P, C, PH, PW),
                   torch),
        patch_route_ms=time_ms(lambda: cs.bilinear_patches_scatter(
            x, y, w, P, C, PH, PW, route="patch"), torch),
        atlas_ms=time_ms(atlas_route(torch, cs, x, y, w, P, C, PH, PW),
                         torch),
        plain_ms=time_ms(lambda: cs.bilinear_patches_scatter_plain(
            x, y, w, P, C, PH, PW), torch),
        library_ms=patches_library_ms(torch, x, y, w, P, C, PH, PW),
        bound=bilinear_bound(x, y, w.shape[0], PH, PW, P))
    log(f"  timed: direct patch route {rec['ms']:.4f} ms, patch kernel "
        f"{rec['patch_route_ms']:.4f} ms, atlas route {rec['atlas_ms']:.4f} "
        f"ms, plain {rec['plain_ms']:.4f} ms, index_put_ "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound'][0]:.4f} ms")
    return rec


def patch_splat_check(torch, cs, name, got, x, y, w, P, C, PH, PW):
    """A (K, P, PH, PW) patch splat held per pixel within ``splat_limits``
    of its plain version in float64, each patch a sample of C slots.
    Returns the max |err| and the largest share of a pixel's limit."""
    K = w.shape[0]
    xs, ys = x.view(P, C), y.view(P, C)
    ws = w.view(K, P, C).permute(1, 0, 2).contiguous()
    limit = splat_limits(torch, xs, ys, ws, PH, PW)
    ref = cs.bilinear_scatter_batched_plain(xs.double(), ys.double(),
                                            ws.double(), PH, PW)
    return check_splat(name, got.permute(1, 0, 2, 3), ref, limit)


def derivative_stack(torch, x, y, w, shape):
    """The flat kernel's inputs on the main path: the int32 ids (4N,) and
    the (2, 4N) signed weights that ``bilinear_scatter_derivative`` sums for
    a two-parameter warp of the N events (x, y) with weights w."""
    from event_utils_tpu_torch.ops.scatter import derivative_taps
    n, dev = len(x), x.device
    jx = torch.stack([-(torch.rand(n, device=dev) * 0.25),
                      torch.zeros(n, device=dev)])
    fi, fw = derivative_taps(x, y, jx, jx.flip(0).contiguous(), w, shape)
    return fi.to(torch.int32).contiguous(), fw.contiguous()


def voxel_library(torch, args, B, H, W):
    """One ``index_put_(accumulate=True)`` computing the voxel scatter of
    the kernel's inputs ``args`` (xs, ys, t_norm, ps)."""
    t_norm, pv = args[2], args[3]
    b0 = torch.floor(t_norm)
    pix = args[1].long() * W + args[0].long()
    ids = torch.cat([b0.long().clamp(0, B - 1) * H * W + pix,
                     (b0.long() + 1).clamp(0, B - 1) * H * W + pix])
    vals = torch.cat([pv * (1 - (t_norm - b0)),
                      torch.where(b0 + 1 < B, pv * (t_norm - b0), 0.0)])
    return lambda: torch.zeros(B * H * W, device=pv.device).index_put_(
        (ids,), vals, accumulate=True)


def voxel_phase(torch, cs, rng, records):
    """The voxel kernel's two routes against the plain version: the main
    path's stream and its variations, odd bin coordinates, other bin
    counts, a short stream; both routes timed at 2^21 and at N_SMALL
    events."""
    dev = torch.device("cuda")
    H, W = SENSOR
    routes = ("vector", "direct")
    xs, ys, ts, ps = (torch.as_tensor(a, device=dev)
                      for a in voxel_events(rng))
    ts = ts.float()
    ps = ps.float()
    keep = torch.as_tensor(rng.random(N_VOXEL) > 0.2, device=dev)
    errs = {r: [] for r in routes}

    def hold(label, args, bins=B):
        ref = cs.voxel_scatter_plain(*args, bins, H, W)
        outs = {}
        for r in routes:
            outs[r] = cs.voxel_scatter(*args, bins, H, W, route=r)
            errs[r].append(check_close(f"voxel_scatter:{r} ({label})",
                                       outs[r], ref))
        return outs

    plain_args = cs.voxel_inputs(xs, ys, ts, ps, B, SENSOR)
    hold("plain window", plain_args)
    hold("masked", cs.voxel_inputs(xs, ys, ts, ps, B, SENSOR, mask=keep))
    pinned = cs.voxel_inputs(xs, ys, ts, ps, B, SENSOR,
                             t1=float(ts[N_VOXEL // 2]))
    log(f"  t1 override: {int((pinned[2] == B - 1).sum())} events at "
        f"t_norm = B-1 exactly")
    hold("t1 override", pinned)
    perm = torch.randperm(N_VOXEL, device=dev)
    hold("unsorted", [a[perm].contiguous() for a in plain_args])
    for r, out in hold("all masked", cs.voxel_inputs(
            xs, ys, ts, ps, B, SENSOR, mask=torch.zeros_like(keep))).items():
        if float(out.abs().max()) != 0.0:
            raise AssertionError(f"voxel_scatter:{r}: masked events left a "
                                 f"mark")
    # bin coordinates no wrapper makes: dropped, never wrapped; first bins
    # of -1 keep their second tap
    odd = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                        -1e30, -0.25, -1.0, -1.5, B - 0.5, float(B), 2.0 ** 31,
                        -2.0 ** 31], device=dev)
    t_odd = plain_args[2].clone()
    t_odd[::5] = odd[torch.arange(len(t_odd[::5]), device=dev) % len(odd)]
    hold("odd t_norm", (plain_args[0], plain_args[1], t_odd, plain_args[3]))
    for bins in (1, 4, 9):
        hold(f"B={bins}", cs.voxel_inputs(xs, ys, ts, ps, bins, SENSOR), bins)
        hold(f"B={bins}, t1 override", cs.voxel_inputs(
            xs, ys, ts, ps, bins, SENSOR, t1=float(ts[N_VOXEL // 2])), bins)

    def timed(args, n):
        shared = dict(
            shape=f"{n} events into ({B}, {H}, {W})",
            plain_ms=time_ms(lambda: cs.voxel_scatter_plain(*args, B, H, W),
                             torch),
            library_ms=time_ms(voxel_library(torch, args, B, H, W), torch),
            bound=bound(n * 16 + B * H * W * 4, n * 8))
        out = {r: dict(shared, ms=time_ms(
            lambda: cs.voxel_scatter(*args, B, H, W, route=r), torch))
            for r in routes}
        log(f"  {shared['shape']}: " + ", ".join(
            f"{r} {out[r]['ms']:.4f} ms" for r in routes)
            + f", plain {shared['plain_ms']:.4f} ms, index_put_ "
            f"{shared['library_ms']:.4f} ms, bound {shared['bound'][0]:.5f} "
            f"ms; the dispatch takes {cs.voxel_route(n, B, H, W)}")
        return out

    small_args = cs.voxel_inputs(xs[:N_SMALL], ys[:N_SMALL], ts[:N_SMALL],
                                 ps[:N_SMALL], B, SENSOR)
    hold(f"{N_SMALL} events", small_args)
    big, small = timed(plain_args, N_VOXEL), timed(small_args, N_SMALL)
    for r in routes:
        records[f"voxel_scatter:{r}"] = dict(
            big[r], max_abs_err=max(errs[r]), cases=[
                as_case(dict(c[r], max_abs_err=max(errs[r])))
                for c in (big, small)])


def padded_rows(torch, rng, S, n, sensor, counts=None):
    """S padded rows of n slots as the trainers get them: a valid prefix
    (``counts``, else 60-100% of the slots) of events on the sensor with
    sorted stamps and polarities +-1, then pads with zero coordinates and
    polarity and the row's last valid stamp. ``(events (S, n, 4), mask (S,
    n))`` on the card."""
    H, W = sensor
    if counts is None:
        counts = rng.integers(int(0.6 * n), n + 1, S)
    counts = np.asarray(counts)
    valid = np.arange(n)[None, :] < counts[:, None]
    t = np.sort(rng.uniform(0.0, 0.1, (S, n)).astype(np.float32), axis=1)
    last = np.where(counts > 0, t[np.arange(S), np.maximum(counts - 1, 0)],
                    np.float32(0.0))
    ev = np.stack([np.where(valid, rng.integers(0, W, (S, n)), 0),
                   np.where(valid, rng.integers(0, H, (S, n)), 0),
                   np.where(valid, t, last[:, None]),
                   np.where(valid, rng.choice([-1.0, 1.0], (S, n)), 0.0)],
                  -1).astype(np.float32)
    return (torch.as_tensor(ev, device="cuda"),
            torch.as_tensor(valid.astype(np.float32), device="cuda"))


def voxel_batched_taps(torch, args, B, H, W, split):
    """The live (ids, values) of a batched voxel grid's kernel inputs: each
    event's in-range taps at its grid's offset, dropped taps left out."""
    xs, ys, t_norm, ps = args
    S = xs.shape[0]
    b0 = torch.floor(t_norm)
    fb = t_norm - b0
    grid = torch.arange(S, device=xs.device)[:, None] * (2 if split else 1)
    w = ps
    if split:
        grid = grid + (ps < 0).long()
        w = ps.abs()
    base = grid * (B * H * W) + ys.long() * W + xs.long()
    ids, vals = [], []
    for b, wt in ((b0, w * (1 - fb)), (b0 + 1, w * fb)):
        ok = (ps != 0) & (b >= 0) & (b < B)
        ids.append((base + torch.where(ok, b, 0.0).long() * (H * W))[ok])
        vals.append(wt[ok])
    return torch.cat(ids), torch.cat(vals)


def voxel_batched_case(torch, cs, label, args, B, H, W, split, route,
                       time=True):
    """``voxel_scatter_batched`` on ``route`` at the kernel inputs ``args``
    against its plain version and against S single ``voxel_scatter``
    launches (2S with ``split``: the positive and negative weights; on the
    same route, or for 'private', which one grid never takes, on
    ``voxel_route``'s), within GRID_REL of the grid's scale; with ``time``,
    the kernel, the plain version and one ``index_put_`` over the live taps
    timed, and the bound (each slot's weight read, the other 12 B of a live
    slot, the grids written once)."""
    name = f"voxel_scatter_batched:{route}"
    x, y, t, p = args
    S, n = x.shape
    G = 2 if split else 1
    kernel = lambda: cs.voxel_scatter_batched(*args, B, H, W, split=split,
                                              route=route)
    plain = lambda: cs.voxel_scatter_batched_plain(*args, B, H, W, split)
    got = kernel()
    shape = (f"{S} rows x {n} events into ({G * B}, {H}, {W})"
             + (", split" if split else ""))
    err = check_close(f"{name} ({label})", got, plain(), GRID_REL)
    weights = ((torch.where(p > 0, p, 0.0), torch.where(p < 0, -p, 0.0))
               if split else (p,))
    one = None if route == "private" else route
    single = torch.stack([cs.voxel_scatter(x[s], y[s], t[s],
                                           w[s].contiguous(), B, H, W,
                                           route=one)
                          for s in range(S) for w in weights])
    err = max(err, check_close(
        f"{name} ({label}) vs {S * G} single voxel_scatter:"
        f"{one or cs.voxel_route(n, B, H, W)} launches", got,
        single.view(got.shape), GRID_REL))
    case = dict(shape=f"{shape} ({label})", max_abs_err=err,
                dispatch=cs.voxel_batched_route(S, n, B, H, W, split))
    if time:
        ids, vals = voxel_batched_taps(torch, args, B, H, W, split)
        live = int((p != 0).sum())
        case.update(
            ms=time_ms(kernel, torch), plain_ms=time_ms(plain, torch),
            library_ms=time_ms(lambda: torch.zeros(
                S * G * B * H * W, device=x.device).index_put_(
                    (ids,), vals, accumulate=True), torch),
            bound=bound(S * n * 4 + live * 12 + S * G * B * H * W * 4,
                        live * 8))
        log(f"  {name} at {case['shape']}: {case['ms']:.4f} ms, plain "
            f"{case['plain_ms']:.4f} ms, index_put_ "
            f"{case['library_ms']:.4f} ms, bound {case['bound'][0]:.5f} ms; "
            f"the dispatch takes {case['dispatch']}")
    return case


def voxel_batched_kernel_cases(torch, cs, records):
    """The batched voxel kernel's three routes at the shapes of the
    ``voxel_batched`` path and the trainers', against the plain version and
    S single launches, timed: the DAVIS240 2^21-event stream in 104 windows of
    20,000 (``voxel_grids_fixed_n``) and in 8 of 2^18; the trainers' split
    grids of padded rows, ``fit``'s 8 x 32,768 at 184x240, the flow batch's
    8 x 65,536, and 96 split windows of 12,288 at 128x128, an E2VID
    batch's size (its own grids go through ``flat_scatter``). Then
    edge cases on the flow batch's shape: B = 1 and 9, every row masked, a
    row of one event, per-row windows that pin half of each row to the
    last bin, NaN, +-inf and huge bin coordinates; the same on 96 E2VID
    windows (960 private blocks, each keeping one sign) and on 104
    DAVIS240 windows (520 blocks: four waves). Each route's record keeps
    one shape from run to run: 104 windows of 20,000 for direct and
    private, 8 of 2^18 for vector."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 16)
    H, W = SENSOR
    xs, ys, ts, ps = (torch.as_tensor(a, device=dev)
                      for a in voxel_events(rng))
    ts, ps = ts.float(), ps.float()
    cases = {"direct": [], "vector": [], "private": []}

    def hold(label, args, bins, sensor, split, time=True):
        for r in cases:
            cases[r].append(voxel_batched_case(torch, cs, label, args, bins,
                                               *sensor, split, r, time))

    for n in (FIXED_N, FIXED_N_VECTOR):
        S = N_VOXEL // n
        win = [a[:S * n].reshape(S, n) for a in (xs, ys, ts, ps)]
        hold(f"DAVIS240, {S} windows of {n}",
             cs.voxel_inputs_batched(*win, B, SENSOR), B, SENSOR, False)
    edges = {}
    for label, S, n, sensor in (("fit", 8, 32768, (184, 240)),
                                ("flow batch", 8, 65536, (128, 128)),
                                ("E2VID windows", 96, 12288, (128, 128))):
        ev, mask = padded_rows(torch, rng, S, n, sensor)
        rows = [a.contiguous() for a in ev.unbind(-1)]
        hold(label, cs.voxel_inputs_batched(*rows, B, sensor, mask=mask,
                                            split=True), B, sensor, True)
        if label != "fit":
            edges[label] = rows, mask, sensor
    S = N_VOXEL // FIXED_N
    win = [a[:S * FIXED_N].reshape(S, FIXED_N) for a in (xs, ys, ts, ps)]
    edges[f"DAVIS240, {S} windows"] = ([a.contiguous() for a in win],
                                        torch.ones_like(win[3]), SENSOR)
    for where, (rows, mask, sensor) in edges.items():
        edge_cases(torch, cs, hold, where, rows, mask, sensor)
    # the record's own numbers, each route at one shape kept from run to
    # run: 104 DAVIS240 windows of 20,000 for direct and private (the
    # latter's path shape), 8 of 2^18 for vector (its path shape)
    for r, main in (("direct", 0), ("vector", 1), ("private", 0)):
        timed = [c for c in cases[r] if "ms" in c]
        records[f"voxel_scatter_batched:{r}"] = dict(
            timed[main], max_abs_err=max(c["max_abs_err"] for c in cases[r]),
            cases=[as_case(c) for c in timed])


def edge_cases(torch, cs, hold, where, rows, mask, sensor):
    """``hold`` every route of the batched voxel kernel (untimed) on the
    padded rows ``rows`` (x, y, t, p: (S, n)) with ``mask``, split: B = 1
    and 9, every row masked, a row of one event, per-row windows that pin a
    quarter of each row to the last bin, NaN, +-inf and huge bin
    coordinates; a masked batch must leave no mark and one event must weigh
    1 on every route."""
    dev = mask.device
    for bins in (1, 9):
        hold(f"{where}, B={bins}", cs.voxel_inputs_batched(
            *rows, bins, sensor, mask=mask, split=True), bins, sensor, True,
            time=False)
    none = cs.voxel_inputs_batched(*rows, B, sensor,
                                   mask=torch.zeros_like(mask), split=True)
    one_mask = mask.clone()
    one_mask[0] = 0.0
    one_mask[0, 7] = 1.0
    one = cs.voxel_inputs_batched(*rows, B, sensor, mask=one_mask,
                                  split=True)
    n = mask.shape[1]
    pinned = cs.voxel_inputs_batched(*rows, B, sensor, mask=mask,
                                     t1=rows[2][:, n // 4], split=True)
    log(f"  {where}, per-row t1 overrides: "
        f"{int((pinned[2] == B - 1).sum())} events at t_norm = B-1 exactly")
    odd = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                        -1e30, -1.0, -0.25, float(B)], device=dev)
    t_odd = pinned[2].clone()
    t_odd[:, ::5] = odd[torch.arange(t_odd[:, ::5].shape[1], device=dev)
                        % len(odd)]
    for label, args in (("every row masked", none), ("a row of one event",
                                                     one),
                        ("pinned to the last bin", pinned),
                        ("NaN, inf and huge bins",
                         (pinned[0], pinned[1], t_odd, pinned[3]))):
        hold(f"{where}, {label}", args, B, sensor, True, time=False)
    for r in ("direct", "vector", "private"):
        grids = cs.voxel_scatter_batched(*none, B, *sensor, split=True,
                                         route=r)
        ones = cs.voxel_scatter_batched(*one, B, *sensor, split=True,
                                        route=r)
        if float(grids.abs().max()) != 0.0 or float(ones[0].sum()) != 1.0:
            raise AssertionError(f"voxel_scatter_batched:{r} ({where}): "
                                 f"masked rows left a mark, or one event "
                                 f"weighs {float(ones[0].sum())}")


def window_loop_grids(torch, events_to_voxel, ev, n, impl):
    """``voxel_grids_fixed_n`` as the port ran it before the batched kernel:
    one ``events_to_voxel`` per window of ``n`` events."""
    num = len(ev[0]) // n
    return torch.stack([events_to_voxel(*(a[i:i + n] for a in ev), B,
                                        sensor_size=SENSOR, impl=impl)
                        for i in range(0, num * n, n)])


def voxel_batched_phase(torch, cs, records):
    """The vmapped voxel grids' path (JAX's ``jax.vmap`` of the voxel
    kernel), with the launch counts set to 0 first:
    ``voxel_grids_fixed_n(impl='matmul')`` on the DAVIS240 2^21-event
    stream in windows of 20,000 (104: the private route) and of
    2^18 (8: the vector route), and ``voxelize_batch`` under 'pallas' at the
    flow batch's and ``fit``'s shapes. Each call must launch
    ``voxel_scatter_batched`` on the route its shape is sent to, once per
    chunk of rows, and nothing else. After the counts are read: every grid
    against the per-window loop of single launches (``window_loop_grids``)
    and the exact 'xla' route, the rows' grids against ``voxelize_batch``
    under 'xla', and the walls of ``voxel_grids_fixed_n`` batched and as the
    per-window loop in turns (loop, batched, batched, loop), with device
    busy, idle share and largest entries. Returns the phase's launch counts
    and what it measured."""
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    from event_utils_tpu_torch.representations import (events_to_voxel,
                                                       voxel_grids_fixed_n)
    from event_utils_tpu_torch.training import in_the_loop as itl
    rng = np.random.default_rng(SEED + 17)
    H, W = SENSOR
    ev = tuple(torch.as_tensor(a, device="cuda") for a in voxel_events(rng))
    rows = {"flow": (padded_rows(torch, rng, 8, 65536, (128, 128)),
                     (128, 128)),
            "fit": (padded_rows(torch, rng, 8, 32768, (184, 240)),
                    (184, 240))}
    out = {"card": card_line()}
    want, grids = {}, {}
    prev = get_default_impl()
    cs.reset_launch_counts()
    set_default_impl("pallas")
    try:
        with route_calls(cs) as seen:
            for n in (FIXED_N, FIXED_N_VECTOR):
                S = N_VOXEL // n
                r = cs.voxel_batched_route(S, n, B, H, W)
                chunk = (cs.voxel_batched_chunk(B, H, W) if r == "vector"
                         else cs.BATCH_MAX_SAMPLES)
                key = f"voxel_scatter_batched:{r}"
                want[key] = want.get(key, 0) + -(-S // chunk)
                grids[n], wall = synced(torch, lambda: voxel_grids_fixed_n(
                    *ev, B, n, sensor_size=SENSOR, impl="matmul"))
                log(f"voxel_batched: voxel_grids_fixed_n, {S} windows of {n}"
                    f" -> {key} ({-(-S // chunk)} launches), {wall:.4f} s")
            for name, ((e, m), sensor) in rows.items():
                S, n = m.shape
                key = "voxel_scatter_batched:" + cs.voxel_batched_route(
                    S, n, B, *sensor, split=True)
                want[key] = want.get(key, 0) + 1
                grids[name], wall = synced(torch, lambda: itl.voxelize_batch(
                    e, m, B, sensor))
                log(f"  voxelize_batch, {name}: {S} x {n} at {sensor} -> "
                    f"{key}, {wall:.4f} s")
        torch.cuda.synchronize()
    finally:
        set_default_impl(prev)
    launches = cs.launch_counts()
    got = {k: v for k, v in launches.items() if v}
    log(f"voxel_batched launches: {got}; by the dispatch rules "
        f"{seen['calls']}; expected {want}")
    if got != want or got != seen["calls"]:
        raise AssertionError(f"voxel_batched launches {got}, expected {want}"
                             f", dispatch {seen['calls']}")
    errs = {}
    for n in (FIXED_N, FIXED_N_VECTOR):
        S = N_VOXEL // n
        errs[f"fixed_n_{n}_vs_loop"] = check_close(
            f"voxel_grids_fixed_n, {S} windows of {n}, vs the per-window "
            f"loop", grids[n], window_loop_grids(torch, events_to_voxel, ev,
                                                 n, "matmul"), GRID_REL)
        errs[f"fixed_n_{n}_vs_xla"] = check_close(
            f"voxel_grids_fixed_n, {S} windows of {n}, vs 'xla'", grids[n],
            voxel_grids_fixed_n(*ev, B, n, sensor_size=SENSOR, impl="xla"),
            GRID_REL)
    for name, ((e, m), sensor) in rows.items():
        errs[f"{name}_vs_xla"] = check_close(
            f"voxelize_batch, {name}, 'pallas' vs 'xla'", grids[name],
            itl.voxelize_batch(e, m, B, sensor), GRID_REL)
    out["max_abs_err"] = errs
    calls = {
        "loop": lambda: window_loop_grids(torch, events_to_voxel, ev,
                                          FIXED_N, "matmul"),
        "batched": lambda: voxel_grids_fixed_n(*ev, B, FIXED_N,
                                               sensor_size=SENSOR,
                                               impl="matmul")}
    turns = {k: {"walls_s": []} for k in calls}
    for label in ("loop", "batched", "batched", "loop"):
        calls[label]()
        turns[label]["walls_s"].append(
            [synced(torch, calls[label])[1] for _ in range(VOXEL_WALLS)])
    for label, r in turns.items():
        r["wall_s"] = float(np.median(np.concatenate(r["walls_s"])))
        r["device_busy_s"], r["top_device"] = device_busy(torch, calls[label])
        r["idle_share"] = max(0.0, 1.0 - r["device_busy_s"] / r["wall_s"])
        before = cs.launch_counts()
        synced(torch, calls[label])
        r["launches"] = {k: v - before[k] for k, v in
                         cs.launch_counts().items() if v != before[k]}
    out["fixed_n_turns"] = turns
    log(f"  voxel_grids_fixed_n, {N_VOXEL // FIXED_N} windows of {FIXED_N} "
        f"({out['card']}): " + "; ".join(
            f"{k} walls {np.round(r['walls_s'], 5).tolist()} (median "
            f"{r['wall_s']:.5f} s), busy {r['device_busy_s']:.5f} s, idle "
            f"{r['idle_share']:.3f}, launches {r['launches']}, top "
            f"{r['top_device'][:3]}" for k, r in turns.items()))
    return launches, out


def flat_library(torch, idx, wts, buckets):
    """One ``index_put_(accumulate=True)`` computing the flat scatter;
    dropped ids are left out, as for the bilinear library call."""
    D, m = wts.shape
    ok = ((idx >= 0) & (idx < buckets))[None, :].expand(D, m)
    lid = (torch.arange(D, device=idx.device)[:, None] * buckets
           + idx.long()[None, :])[ok]
    lv = wts[ok]
    return lambda: torch.zeros(D * buckets, device=idx.device).index_put_(
        (lid,), lv, accumulate=True)


def flat_case(torch, cs, label, idx, wts, buckets, errs, time=True):
    """The flat kernel's routes for this shape against the plain version
    (errors appended to ``errs[route]``), and, with ``time``, each timed
    beside the plain version, the library call and the bound."""
    D, m = wts.shape
    ref = cs.flat_scatter_plain(idx, wts, buckets)
    routes = ("vector", "direct") if D > 1 else ("direct",)
    shape = f"D={D}, {m} ids ({label}) into {buckets} buckets"
    shared = dict(shape=shape)
    if time:
        shared.update(
            plain_ms=time_ms(lambda: cs.flat_scatter_plain(idx, wts,
                                                           buckets),
                             torch),
            library_ms=time_ms(flat_library(torch, idx, wts, buckets),
                               torch),
            bound=bound(m * 4 + D * m * 4 + D * buckets * 4, D * m))
    out = {}
    for r in routes:
        err = check_close(f"flat_scatter:{r} ({shape})",
                          cs.flat_scatter(idx, wts, buckets, route=r), ref)
        errs.setdefault(r, []).append(err)
        out[r] = dict(shared, max_abs_err=err)
        if time:
            out[r]["ms"] = time_ms(lambda: cs.flat_scatter(
                idx, wts, buckets, route=r), torch)
    if time:
        log(f"  timed: " + ", ".join(
            f"{r} {out[r]['ms']:.4f} ms" for r in routes)
            + f", plain {shared['plain_ms']:.4f} ms, index_put_ "
            f"{shared['library_ms']:.4f} ms, bound "
            f"{shared['bound'][0]:.5f} ms; the dispatch takes "
            f"{cs.flat_route(D, m, buckets)}")
    return out


def flat_phase(torch, cs, rng, records, x, y, w):
    """The flat kernel's two routes against the plain version: the D=2
    derivative stack of the events (x, y, w) into 181x241, the same with
    dropped ids and all-zero columns, D = 3, 4, 5, and the D=1 event image
    of 2^21 events (direct route only); each timed."""
    dev = torch.device("cuda")
    H, W = SENSOR
    nb = (H + 1) * (W + 1)
    errs = {"vector": [], "direct": []}

    def case(label, idx, wts, buckets, time=True):
        return flat_case(torch, cs, label, idx, wts, buckets, errs, time)

    fi, fw = derivative_stack(torch, x, y, w, (H + 1, W + 1))
    stack = case("derivative stack", fi, fw, nb)
    # ids just outside the range among the others, and columns whose weights
    # are all zero (the vector route skips their reduction)
    m = fi.shape[0]
    bad = fi.clone()
    bad[::7] = -1
    bad[3::11] = nb
    bad[5::13] = nb + 5
    gaps = fw.clone()
    gaps[:, ::3] = 0.0
    gaps[0, 1::3] = 0.0
    case("ids -1 and num_buckets mixed in, zero columns", bad, gaps, nb,
         time=False)
    gaps[1] = 0.0
    case("the same, one row all zero", bad, gaps, nb, time=False)
    rid = torch.as_tensor(rng.integers(0, nb, N_SCENE), dtype=torch.int32,
                          device=dev)
    rows = [case("random ids", rid, torch.as_tensor(
        rng.normal(size=(D, N_SCENE)), dtype=torch.float32, device=dev), nb)
        for D in (3, 4, 5)]
    # D=1: the event image of the voxel stream
    ex, ey, _, ep = voxel_events(rng)
    eid = torch.as_tensor(ey.astype(np.int32) * W + ex, dtype=torch.int32,
                          device=dev)
    ew = torch.as_tensor(ep, dtype=torch.float32, device=dev)[None]
    image = case("event image", eid, ew, H * W)

    vec = dict(stack["vector"])
    vec["cases"] = [as_case(c["vector"]) for c in [stack] + rows]
    vec["max_abs_err"] = max(errs["vector"])
    records["flat_scatter:vector"] = vec
    # the direct route's own shape on the main path is the event image
    direct = dict(image["direct"])
    direct["cases"] = [as_case(c["direct"]) for c in [image, stack] + rows]
    direct["max_abs_err"] = max(errs["direct"])
    records["flat_scatter:direct"] = direct


def kernel_phase(torch, cs, rng, records):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    H, W = SENSOR

    voxel_phase(torch, cs, rng, records)
    voxel_batched_kernel_cases(torch, cs, records)
    tiles_phase(torch, cs, rng, records)

    # ---- bilinear, whole images ------------------------------------------
    HP, WP = H + 1, W + 1
    n = N_SCENE
    x = torch.as_tensor(rng.uniform(-2, WP + 1, n), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.uniform(-2, HP + 1, n), dtype=torch.float32,
                        device=dev)
    w4 = torch.as_tensor(rng.uniform(-1, 1, (4, n)), dtype=torch.float32,
                         device=dev)
    # the floor of one graph node: an empty kernel in the same harness
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), torch)
    log(f"empty kernel (torch.cuda._sleep(0)): {floor_ms:.4f} ms a graph "
        f"node")
    # K=4 at 181x241 (the timestamp image) exceeds shared memory: the
    # vector route at 200k events (part 11 of the tune script)
    if cs.bilinear_route(4, HP, WP, n) != "vector":
        raise AssertionError("K=4 at 181x241, 200k events: want the vector "
                             "route")
    # autograd: kernel forward + gather backward vs autograd of index_add_
    from event_utils_tpu_torch.ops.scatter import bilinear_scatter as bs
    tgt = torch.as_tensor(rng.normal(size=(HP, WP)), dtype=torch.float32,
                          device=dev)
    grads, err_grad = [], []
    for impl in ("matmul", "xla"):
        xg = x.clone().requires_grad_(True)
        yg = y.clone().requires_grad_(True)
        wg = w4[0].clone().requires_grad_(True)
        loss = (bs(xg, yg, wg, (HP, WP), impl=impl) * tgt).sum()
        grads.append(torch.autograd.grad(loss, (xg, yg, wg)))
    for name, gk, gp in zip("xyw", *grads):
        err_grad.append(check_close(f"bilinear grad d{name}", gk, gp,
                                    rel=1e-4))
    # 200k uniform events, then the planted scene warped onto its tracks
    # (what a solve near its answer splats): private route against direct
    big = bilinear_case(torch, cs, "uniform", x, y, w4[:1].contiguous(), HP,
                        WP, ("private", "direct"))
    sx, sy, st, sp = planted_scene(np.random.default_rng(SEED))
    wx = torch.as_tensor(sx - VELOCITY[0] * st, dtype=torch.float32,
                         device=dev)
    wy = torch.as_tensor(sy - VELOCITY[1] * st, dtype=torch.float32,
                         device=dev)
    wp = torch.as_tensor(sp, dtype=torch.float32, device=dev)[None]
    sharp = bilinear_case(torch, cs, "planted scene, warped", wx, wy, wp, HP,
                          WP, ("private", "direct"))
    # few events: one ROI's ~2k events into a small image, and into the
    # full frame as grid_cmax's per-ROI solves splat them
    m = 2048
    small = bilinear_case(
        torch, cs, "one ROI", x[:m] % 21, y[:m] % 21, w4[:1, :m].contiguous(),
        21, 21, ("single", "direct"))
    few = bilinear_case(
        torch, cs, "one ROI of the planted scene", wx[:m].contiguous(),
        wy[:m].contiguous(), wp[:, :m].contiguous(), HP, WP,
        ("single", "direct"))
    # K = 4 at 200k: the timestamp image's four weights of the planted
    # scene, and uniform weights; the vector route against the direct one
    pos = torch.as_tensor(sp > 0, dtype=torch.float32, device=dev)
    tn = torch.as_tensor((st - st.min()) / (st.max() - st.min()),
                         dtype=torch.float32, device=dev)
    stamp = bilinear_case(
        torch, cs, "the planted scene's timestamp image", wx, wy,
        torch.stack([tn * pos, pos, tn * (1 - pos), 1 - pos]).contiguous(),
        HP, WP, ("vector", "direct"))
    uni4 = bilinear_case(torch, cs, "uniform", x, y, w4, HP, WP,
                         ("vector", "direct"))
    for label, c in (("timestamp image", stamp), ("uniform", uni4)):
        log(f"  vector against direct, K=4 ({label}): "
            f"{c['vector']['ms']:.4f} / {c['direct']['ms']:.4f} ms, floor "
            f"{floor_ms:.4f} ms")
    # the one-block form is no route of the main path (it loses to the
    # direct kernel at every shape): its times stand with the private
    # kernel, whose code it shares
    for route, cases in (
            ("private", [big["private"], sharp["private"]]),
            ("vector", [stamp["vector"], uni4["vector"]]),
            ("direct", [big["direct"], sharp["direct"], small["direct"],
                        few["direct"], stamp["direct"], uni4["direct"]])):
        rec = dict(cases[0])
        rec["cases"] = [as_case(c) for c in cases]
        rec["max_abs_err"] = max(c["max_abs_err"] for c in cases)
        records[f"bilinear_scatter:{route}"] = rec
    for c, done in zip(records["bilinear_scatter:vector"]["cases"],
                       (stamp, uni4)):
        c["direct_ms"] = done["direct"]["ms"]
    rec = records["bilinear_scatter:private"]
    rec["cases"] += [as_case(c, blocks=1) for c in (small["single"],
                                                     few["single"])]
    rec["max_abs_err"] = max(rec["max_abs_err"], small["single"]["max_abs_err"],
                             few["single"]["max_abs_err"])
    records["bilinear_scatter:direct"]["max_abs_err"] = max(
        [records["bilinear_scatter:direct"]["max_abs_err"]] + err_grad)
    err_odd = odd_coordinates(torch, cs, rng)
    for route in ("vector", "direct"):
        rec = records[f"bilinear_scatter:{route}"]
        rec["max_abs_err"] = max(rec["max_abs_err"], err_odd[route])

    batched_kernel_cases(torch, cs, rng, records)

    patches_phase(torch, cs, rng, records, err_odd)
    patch_variance_phase(torch, cs, records)

    flat_phase(torch, cs, rng, records, x, y, w4[0].contiguous())
    return floor_ms


def main_path(torch, P, rng):
    """The port's main path through its public entry points."""
    from event_utils_tpu_torch.contrast_max import (
        linvel_warp, optimize_contrast, optimize_contrast_jit,
        variance_objective)
    from event_utils_tpu_torch.representations import (
        events_to_image, events_to_timestamp_image, events_to_voxel)
    cs = P.ops.cuda_scatter
    H, W = SENSOR
    xs, ys, ts, ps = voxel_events(rng)
    sx, sy, st, sp = planted_scene(rng)
    log(f"main path: {N_VOXEL} voxel events, {len(sx)}-event scene, "
        f"planted v={VELOCITY}")

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log(f"  {label}: {time.perf_counter() - t0:.3f} s wall, "
            f"launches so far {P.ops.launch_counts()}")
        return out

    def routed(route, label, fn):
        """``timed``, and the call must add one launch of ``route``: the one
        that the dispatch names for this call's shape."""
        before = cs.launch_counts()[route]
        out = timed(f"{label} -> {route}", fn)
        if cs.launch_counts()[route] != before + 1:
            raise AssertionError(f"{label} did not launch {route}")
        return out

    for n in (N_VOXEL, N_SMALL):  # the vector route, then the direct one
        ev = (xs[:n], ys[:n], ts[:n], ps[:n])
        vox = routed(f"voxel_scatter:{cs.voxel_route(n, B, H, W)}",
                     f"events_to_voxel(impl='matmul'), {n} events",
                     lambda: events_to_voxel(*ev, B, sensor_size=SENSOR,
                                             impl="matmul"))
        check_close("voxel grid vs the exact 'xla' route", vox,
                    events_to_voxel(*ev, B, sensor_size=SENSOR, impl="xla"))
    img = routed(f"flat_scatter:{cs.flat_route(1, N_VOXEL, H * W)}",
                 "events_to_image(impl='matmul')", lambda: events_to_image(
                     xs, ys, ps, sensor_size=SENSOR, impl="matmul"))
    check_close("event image vs the exact 'xla' route", img, events_to_image(
        xs, ys, ps, sensor_size=SENSOR, impl="xla"))
    tsi = timed("events_to_timestamp_image(impl='matmul')",
                lambda: events_to_timestamp_image(sx, sy, st, sp, SENSOR,
                                                  impl="matmul"))
    for got, ref in zip(tsi, events_to_timestamp_image(sx, sy, st, sp, SENSOR,
                                                       impl="xla")):
        check_close("timestamp image vs the exact 'xla' route", got, ref)
    # the derivative stack: four taps of every event, two parameters
    flat = cs.flat_route(2, 4 * len(sx), (H + 1) * (W + 1))
    grad = routed(f"flat_scatter:{flat}", "evaluate_gradient(impl='matmul')",
                  lambda: variance_objective().evaluate_gradient(
                      np.array(VELOCITY), sx, sy, st, sp, linvel_warp(),
                      SENSOR, impl="matmul"))
    if not np.all(np.isfinite(grad)) or grad.shape != (2,):
        raise AssertionError(f"analytic gradient {grad}")

    v_jit = timed("optimize_contrast_jit", lambda: optimize_contrast_jit(
        sx, sy, st, sp, linvel_warp(), variance_objective(),
        img_size=SENSOR, grid_search_init=True))
    v_host = timed("optimize_contrast", lambda: optimize_contrast(
        sx, sy, st, sp, linvel_warp(), variance_objective(), blur_sigma=1.0,
        img_size=SENSOR, grid_search_init=True))
    for label, v in (("optimize_contrast_jit", v_jit),
                     ("optimize_contrast", v_host)):
        v = np.asarray(v, np.float64)
        err = np.abs(v - np.array(VELOCITY)).max()
        log(f"  {label}: v={v.tolist()} |err|max={err:.3f} px/s")
        if not err <= 4.0:
            raise AssertionError(f"{label} missed the planted velocity")
    roi_path(torch, P, rng, timed)


def roi_path(torch, P, rng, timed):
    """The ROI-bucketed path: tiled voxel grids at VGA and 720p, then the
    per-ROI flow solvers on the rotating bench scene."""
    from event_utils_tpu_torch.contrast_max import grid_cmax, grid_cmax_batched
    from event_utils_tpu_torch.representations import (events_to_voxel,
                                                       events_to_voxel_tiled)
    for name, (H, W) in TILED_SENSORS.items():
        xs, ys, ts, ps = voxel_events(rng, (H, W))
        exact = events_to_voxel(xs, ys, ts, ps, B, sensor_size=(H, W),
                                impl="xla")
        grids = {
            "impl='tiled'": timed(
                f"events_to_voxel(impl='tiled') {name} {(H, W)}",
                lambda: events_to_voxel(xs, ys, ts, ps, B, sensor_size=(H, W),
                                        impl="tiled")),
            "events_to_voxel_tiled": timed(
                f"events_to_voxel_tiled {name}",
                lambda: events_to_voxel_tiled(xs, ys, ts, ps, B, (H, W)))}
        if name == "720p":  # a tile plane past shared memory: direct route
            grids[f"events_to_voxel_tiled, {BIG_TILE} tiles,"] = timed(
                f"events_to_voxel_tiled {name}, {BIG_TILE} tiles",
                lambda: events_to_voxel_tiled(xs, ys, ts, ps, B, (H, W),
                                              tile=BIG_TILE))
        for label, grid in grids.items():
            check_close(f"{label} {name} vs the exact 'xla' route", grid,
                        exact)

    sx, sy, st, sp = rotating_scene()
    log(f"  rotating scene: {len(sx)} events, omega={ROT_OMEGA} rad/s, "
        f"ROI {ROT_ROI}, capacity {ROT_CAPACITY}, maxiter {ROT_MAXITER}")
    kw = dict(roi_size=ROT_ROI, img_size=ROT_SENSOR, maxiter=ROT_MAXITER,
              capacity=ROT_CAPACITY)
    for label, extra in (("grid_cmax_batched", {}),
                         ("grid_cmax_batched(pyramid='auto')",
                          {"pyramid": "auto"})):
        params, rois, f_evals, valid = timed(
            label, lambda: grid_cmax_batched(sx, sy, st, sp, **kw, **extra))
        if not bool(torch.isfinite(params).all()):
            raise AssertionError(f"{label}: non-finite params")
        err, n_valid = flow_error(params, rois, valid)
        log(f"  {label}: all-ROI median flow error {err:.3f} px/s over "
            f"{n_valid} valid ROIs (limit {FLOW_ERR_LIMIT} for the plain "
            f"solve)")
        if not extra and not err <= FLOW_ERR_LIMIT:
            raise AssertionError(f"{label}: median flow error {err} px/s")

    # one patch loss with patches past shared memory: the direct patch route
    from event_utils_tpu_torch.contrast_max import (bucket_events_by_roi,
                                                    linvel_warp,
                                                    make_patch_loss)
    dev = torch.device("cuda")
    bx, by, bt, bp, bm, org, _ = bucket_events_by_roi(
        sx, sy, st, sp, ROT_SENSOR, (60, 80), ROT_CAPACITY, device=dev)
    v0 = torch.zeros((bx.shape[0], 2), device=dev)
    wide, usual = (timed(
        f"make_patch_loss, {patch} patches",
        lambda: make_patch_loss(linvel_warp(), (60, 80), "sos",
                                patch=patch)(v0, bx, by, bt, bp, bm,
                                             org.float()))
        for patch in (BIG_TILE, (120, 160)))
    # zero motion keeps every event well inside both patches, so the sums
    # of squares (-loss x patch pixels) agree
    log(f"  patch losses {wide.tolist()} vs {usual.tolist()}")
    if not bool(torch.isfinite(wide).all()):
        raise AssertionError("make_patch_loss: non-finite loss")
    check_close("patch loss, (240, 256) vs (120, 160) patches",
                wide * (240 * 256), usual * (120 * 160), rel=1e-4)

    corner = (sx < 60) & (sy < 40)
    params, rois, _ = timed("grid_cmax (host loop, one 40x60 corner)",
                            lambda: grid_cmax(sx[corner], sy[corner],
                                              st[corner], sp[corner],
                                              roi_size=ROT_ROI,
                                              img_size=ROT_SENSOR))
    log(f"  grid_cmax: {len(params)} ROIs, params "
        f"{np.round(np.array(params), 3).tolist()}")
    if len(params) != 6 or not all(np.isfinite(p).all() for p in params):
        raise AssertionError(f"grid_cmax: {params} over {rois}")


# ---------------------------------------------------------------------------
# Serving: recording -> dataset -> voxel grid -> EV-FlowNet / E2VID
# ---------------------------------------------------------------------------

def serving_texture(rng, size, octaves=3, contrast=0.9):
    """Smooth random intensity in [1 - contrast, 1]: bilinearly upsampled
    random grids of 16, 32 and 64 cells over ``size`` px, the finer ones
    weighted 1.5x each, so that the scene crosses 10^6 events."""
    from scipy.ndimage import map_coordinates
    acc = np.zeros((size, size))
    amp, total = 1.0, 0.0
    for o in range(octaves):
        g = max(2, size // 2 ** (octaves - o + 1))
        grid = rng.uniform(size=(g + 1, g + 1))
        c = np.linspace(0, g, size)
        yy, xx = np.meshgrid(c, c, indexing="ij")
        acc += amp * map_coordinates(grid, [yy, xx], order=1)
        total += amp
        amp *= 1.5
    acc /= total
    unit = (acc - acc.min()) / max(acc.max() - acc.min(), 1e-6)
    return (1 - contrast) + contrast * unit


def serving_scene(rng):
    """Events, frames and ground-truth flow of a textured plane under the
    similarity motion u(x) = v + s (x - c) + omega J (x - c) about the
    sensor centre c (a stationary field: the same flow at every frame).

    The intensity at pixel p and time t is the texture at the point the
    flow carries to p, ``c' + exp(-A t) (p - c')`` with ``A = [[s, -w],
    [w, s]]`` and ``c' = c - A^-1 v``. Events are the crossings of the log
    intensity (``log(I + 1e-3)``) through levels ``C`` apart from each
    pixel's last event, sampled at SERVE_RENDER_HZ, each stamped at its
    linear-interpolated crossing time."""
    from scipy.ndimage import map_coordinates
    H, W = SERVE_SENSOR
    canvas = 2 * max(H, W)
    tex = serving_texture(rng, canvas)
    s, w = SERVE_DIV, SERVE_OMEGA
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    A = np.array([[s, -w], [w, s]])
    cp = c - np.linalg.solve(A, np.array(SERVE_V))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    dx, dy = (xx - c[0]).astype(np.float32), (yy - c[1]).astype(np.float32)
    flow = np.stack([SERVE_V[0] + s * dx - w * dy,
                     SERVE_V[1] + w * dx + s * dy]).astype(np.float32)
    px, py = xx.ravel() - cp[0], yy.ravel() - cp[1]
    off = (canvas - np.array([W, H])) / 2.0

    def intensity(t):
        e, ca, sa = np.exp(-s * t), np.cos(w * t), np.sin(w * t)
        x0 = cp[0] + e * (ca * px + sa * py) + off[0]
        y0 = cp[1] + e * (-sa * px + ca * py) + off[1]
        return map_coordinates(tex, [y0, x0], order=1, mode="reflect")

    steps = int(round(SERVE_SECONDS * SERVE_RENDER_HZ))
    prev = np.log(intensity(0.0) + 1e-3)
    ref = prev.copy()
    chunks = []
    for k in range(1, steps + 1):
        cur = np.log(intensity(k / SERVE_RENDER_HZ) + 1e-3)
        d = cur - ref
        n = np.floor(np.abs(d) / SERVE_C).astype(np.int64)
        hit = np.nonzero(n)[0]
        if len(hit):
            reps = n[hit]
            pix = np.repeat(hit, reps)
            j = (np.arange(reps.sum())
                 - np.repeat(np.cumsum(reps) - reps, reps) + 1)
            sign = np.sign(d[pix])
            level = ref[pix] + sign * j * SERVE_C
            frac = np.clip((level - prev[pix]) / (cur[pix] - prev[pix]), 0, 1)
            t = (k - 1 + frac) / SERVE_RENDER_HZ
            order = np.argsort(t, kind="stable")
            chunks.append((pix[order], t[order], sign[order]))
            ref[hit] += np.sign(d[hit]) * reps * SERVE_C
        prev = cur
    pix = np.concatenate([ch[0] for ch in chunks])
    frame_ts = np.linspace(0.0, SERVE_SECONDS, SERVE_FRAMES)
    frames = np.stack([np.clip(intensity(t).reshape(H, W) * 255, 0, 255)
                       .astype(np.uint8) for t in frame_ts])
    return ((pix % W).astype(np.int16), (pix // W).astype(np.int16),
            np.concatenate([ch[1] for ch in chunks]),
            np.concatenate([ch[2] for ch in chunks]), frame_ts, frames, flow)


def write_serving_recording(path, rng):
    """The serving scene as a memmap recording, through the port's
    ``memmap_packager``; returns the event count."""
    from event_utils_tpu_torch.data_formats import memmap_packager
    xs, ys, ts, ps, frame_ts, frames, flow = serving_scene(rng)
    if len(xs) < SERVE_MIN_EVENTS:
        raise AssertionError(f"serving scene: {len(xs)} events")
    with memmap_packager(path) as pk:
        pk.package_events(xs, ys, ts, ps)
        for i, (ft, fr) in enumerate(zip(frame_ts, frames)):
            pk.package_image(fr, float(ft), i)
            pk.package_flow(flow, float(ft), i)
        pk.add_metadata(len(xs), int((ps > 0).sum()), int((ps <= 0).sum()),
                        ts[-1] - ts[0], ts[0], ts[-1], len(frames),
                        len(frames), sensor_size=SERVE_SENSOR)
    return len(xs)


PROFILE_TRIES = 3


def device_busy(torch, fn):
    """Device busy seconds of ``fn`` (the card's kernel, memset and memcpy
    times under ``torch.profiler``) and its five largest device entries.
    A profile of a short block can come back with no device activity at
    all (seen once in the augmentation phase on an H100, after the
    streaming phase's scheduled profiles): ``fn`` is profiled again, up to
    PROFILE_TRIES times, and a block that never shows device time fails."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us, n = per.get(e.name, (0.0, 0))
                per[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        busy = sum(us for us, _ in per.values()) * 1e-6
        if busy > 0:
            top = sorted(per.items(), key=lambda kv: -kv[1][0])[:5]
            return busy, [[k[:60], round(us * 1e-3, 4), n]
                          for k, (us, n) in top]
    raise AssertionError(f"the profiler recorded no device time in "
                         f"{PROFILE_TRIES} profiles")


def voxel_flat_ids(torch, xs, ys, ts, ws, B, H, W):
    """The (ids, weights) that ``events_to_voxel`` sends to the flat
    scatter for one grid: two temporal taps per event, dropped taps -1."""
    t_norm = (ts - ts[0]) / torch.where(ts[-1] > ts[0], ts[-1] - ts[0],
                                        1.0) * (B - 1)
    b0 = torch.floor(t_norm)
    fb = t_norm - b0
    px = ys.long() * W + xs.long()
    ids, wts = [], []
    for ib, wb in ((b0.long(), 1.0 - fb), (b0.long() + 1, fb)):
        ok = (ib >= 0) & (ib < B)
        ids.append(torch.where(ok, ib * (H * W) + px, -1))
        wts.append(ws * wb)
    return (torch.cat(ids).to(torch.int32).contiguous(),
            torch.cat(wts)[None].contiguous())


def densest_window(rec):
    """Host events (x, y, t, p) of the densest ``between_frames`` window of
    a memmap recording, as the serving datasets read them."""
    from event_utils_tpu_torch.data_loaders import MemMapDataset
    with MemMapDataset(rec, device="cuda") as ds:
        sizes = [i1 - i0 for i0, i1 in ds.event_indices[:len(ds)]]
        i0, i1 = ds.get_event_indices(int(np.argmax(sizes)))
        return ds.get_events(i0, i1)


def window_flat_case(torch, cs, records, label, host_events, H, W):
    """``flat_scatter:direct`` on one window's positive (5, H, W) grid, the
    ids and weights that ``events_to_neg_pos_voxel`` sends it, against the
    plain version and timed; added to the route's record as a case, which
    is returned."""
    xs, ys, ts, ps = (torch.as_tensor(np.asarray(a, np.float32),
                                      device="cuda") for a in host_events)
    idx, wts = voxel_flat_ids(torch, xs, ys, ts, (ps > 0).float(), 5, H, W)
    case = as_case(flat_case(torch, cs, label, idx, wts, 5 * H * W,
                             {})["direct"])
    rec = records["flat_scatter:direct"]
    rec["cases"].append(case)
    rec["max_abs_err"] = max(rec["max_abs_err"], case["max_abs_err"])
    return case


def serving_phase(torch, cs, records):
    """The serving path through the port's CLIs on the serving scene, with
    its own launch counts; then the checks, one kernel case at its shape,
    and warm timings. Returns what it measured."""
    from event_utils_tpu_torch.cli import infer_flow, reconstruct
    from event_utils_tpu_torch.data_loaders import MemMapDataset
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    from event_utils_tpu_torch.representations import events_to_neg_pos_voxel
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                ReconstructionTrainer)
    H, W = SERVE_SENSOR
    direct = "flat_scatter:direct"
    out = {}
    prev_impl = get_default_impl()
    with tempfile.TemporaryDirectory(prefix=".smoke_serving_",
                                     dir=ROOT) as work:
        rec = os.path.join(work, "recording")
        t0 = time.perf_counter()
        out["events"] = write_serving_recording(rec,
                                                np.random.default_rng(SEED))
        log(f"serving: {out['events']} events at {SERVE_SENSOR}, "
            f"{SERVE_SECONDS} s, {SERVE_FRAMES} frames, v={SERVE_V}, "
            f"omega={SERVE_OMEGA}, div={SERVE_DIV}, C={SERVE_C}; made in "
            f"{time.perf_counter() - t0:.1f} s")
        flow_args = [rec, "--params", FLOW_PARAMS, "--method",
                     "between_frames", "--eval_gt", "--batch_size", "8",
                     "--no_window_cache"]
        recon_args = [rec, "--params", RECON_PARAMS, "--eval_gt", "--npy",
                      "--no_window_cache"]

        def run(cli, args, name, impl, device):
            set_default_impl(impl)
            dest = os.path.join(work, name)
            torch.cuda.synchronize()
            t = time.perf_counter()
            summary = cli.main(args + ["--output_dir", dest, "--device",
                                       device])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            set_default_impl(prev_impl)
            if summary["windows"] != SERVE_FRAMES - 1:
                raise AssertionError(f"{name}: {summary['windows']} windows")
            log(f"  {name}: {summary['windows']} windows in {wall:.3f} s, "
                f"launches so far {cs.launch_counts()[direct]}")
            return dest, summary, wall

        # the serving path: counts set to 0 just before it, read after it
        cs.reset_launch_counts()
        runs, expect = {}, 0
        for cli, args, name, impl, device in (
                (infer_flow, flow_args, "flow_pallas_cuda", "pallas",
                 "cuda"),
                (infer_flow, flow_args, "flow_xla_cuda", "xla", "cuda"),
                (infer_flow, flow_args, "flow_cpu", "xla", "cpu"),
                (reconstruct, recon_args, "recon_pallas_cuda", "pallas",
                 "cuda"),
                (reconstruct, recon_args, "recon_cpu", "xla", "cpu")):
            runs[name] = run(cli, args, name, impl, device)
            if impl == "pallas" and device == "cuda":
                # one grid per window, two scatters (positive, negative)
                expect += 2 * (SERVE_FRAMES - 1)
            got = cs.launch_counts()
            if got[direct] != expect or sum(got.values()) != expect:
                raise AssertionError(f"{name}: launches {got}, expected "
                                     f"{direct} {expect} and nothing else")
        launches = cs.launch_counts()
        log(f"serving-path launches: "
            f"{ {k: v for k, v in launches.items() if v} }")

        def fields(name, prefix):
            files = sorted(f for f in os.listdir(runs[name][0])
                           if f.startswith(prefix) and f.endswith(".npy"))
            return np.stack([np.load(os.path.join(runs[name][0], f))
                             for f in files])

        flows = {k: fields(k, "flow_") for k in
                 ("flow_pallas_cuda", "flow_xla_cuda", "flow_cpu")}
        ref = flows["flow_cpu"]
        scale = float(np.abs(ref).max())
        if not (np.isfinite(ref).all() and scale > 0
                and ref.shape == (SERVE_FRAMES - 1, 2, H, W)):
            raise AssertionError(f"flows {ref.shape}, max|flow| {scale}")
        for k in ("flow_pallas_cuda", "flow_xla_cuda"):
            err = float(np.abs(flows[k] - ref).max())
            log(f"  {k} vs flow_cpu: max|err| {err:.3e} of max|flow| "
                f"{scale:.3e}")
            if not err <= 1e-3 * scale:
                raise AssertionError(f"{k}: flow off the CPU run by {err}")
        frames = {k: np.load(os.path.join(runs[k][0], "frames.npy"))
                  for k in ("recon_pallas_cuda", "recon_cpu")}
        ferr = np.abs(frames["recon_pallas_cuda"]
                      - frames["recon_cpu"]).reshape(SERVE_FRAMES - 1, -1)
        log(f"  reconstruction card vs CPU: max|err| {ferr.max():.3e}, "
            f"after window 20 {ferr[-1].max():.3e}")
        if not (np.isfinite(frames["recon_cpu"]).all()
                and ferr.max() <= 1e-3):
            raise AssertionError(f"reconstruction off the CPU run by "
                                 f"{ferr.max()}")
        mf = runs["flow_pallas_cuda"][1]["metrics"]
        mr = runs["recon_pallas_cuda"][1]["metrics"]
        for k, v in (("aee_px_s", mf["aee_px_s"]),
                     ("zero_flow_aee_px_s", mf["zero_flow_aee_px_s"]),
                     ("psnr_db", mr["psnr_db"]), ("ssim", mr["ssim"])):
            if not np.isfinite(v):
                raise AssertionError(f"{k} = {v}")
            out[k] = v
        out["num_fields"] = mf["num_fields"]
        log(f"  flow AEE {mf['aee_px_s']} px/s over {mf['num_fields']} "
            f"informative windows (zero-flow {mf['zero_flow_aee_px_s']}); "
            f"reconstruction PSNR {mr['psnr_db']} dB, SSIM {mr['ssim']} "
            f"(steady {mr['psnr_steady_db']} / {mr['ssim_steady']}); no "
            "gate: this scene is not the simulator's")

        # the two cuda runs' voxel grids: 'pallas' against 'xla'
        grids = {}
        for impl in ("pallas", "xla"):
            set_default_impl(impl)
            with MemMapDataset(rec, device="cuda") as ds:
                grids[impl] = [ds[i]["voxel"] for i in range(len(ds))]
            set_default_impl(prev_impl)
        for i, (a, b) in enumerate(zip(grids["pallas"], grids["xla"])):
            check_close(f"voxel grid {i}, 'pallas' vs 'xla'",
                        torch.as_tensor(a), torch.as_tensor(b))

        # the flat kernel at the serving shape: the densest window's
        # positive grid
        host_events = densest_window(rec)
        out["flat_case"] = window_flat_case(
            torch, cs, records, "one serving window's positive grid",
            host_events, H, W)
        xs, ys, ts, ps = (torch.as_tensor(np.asarray(a, np.float32),
                                          device="cuda")
                          for a in host_events)

        # warm timings (after the counted run). The dataset: every window
        # fetched (voxelized and copied back), with the flat kernel and
        # with index_add_, in turns; medians of SERVE_PASSES passes
        walls = {"pallas": [], "xla": []}
        with MemMapDataset(rec, device="cuda") as ds:
            n = len(ds)
            for impl in ("pallas", "xla", "xla", "pallas") * (
                    SERVE_PASSES // 2):
                set_default_impl(impl)
                torch.cuda.synchronize()
                t = time.perf_counter()
                batch = [ds[i]["voxel"] for i in range(n)]
                walls[impl].append((time.perf_counter() - t) / n * 1e3)
                set_default_impl(prev_impl)
        out["dataset_ms_per_window"] = float(np.median(walls["pallas"]))
        out["dataset_ms_per_window_xla"] = float(np.median(walls["xla"]))
        # the densest window's two grids alone (the dataset's
        # events_to_neg_pos_voxel call), from host arrays as the dataset
        # passes them and from tensors already on the card: ms per call
        grid_ms = {}
        for where, ev in (("host", host_events), ("card", (xs, ys, ts, ps))):
            for impl in ("pallas", "xla", "xla", "pallas") * (
                    SERVE_PASSES // 2):
                set_default_impl(impl)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(SERVE_GRID_CALLS):
                    events_to_neg_pos_voxel(*ev, 5, sensor_size=SERVE_SENSOR,
                                            device="cuda")
                torch.cuda.synchronize()
                grid_ms.setdefault(f"{where} events, {impl}", []).append(
                    (time.perf_counter() - t) / SERVE_GRID_CALLS * 1e3)
                set_default_impl(prev_impl)
        out["grids_ms_per_window"] = {k: float(np.median(v))
                                      for k, v in grid_ms.items()}
        vox = torch.as_tensor(np.stack(batch[:8]), device="cuda")
        flow_net = FlowTrainer(SERVE_SENSOR, device="cuda")
        flow_net.load_params(FLOW_PARAMS)
        recon_net = ReconstructionTrainer(
            SERVE_SENSOR, model_kwargs={"recurrent_levels": 3,
                                        "num_res_blocks": 2}, device="cuda")
        recon_net.load_params(RECON_PARAMS)
        for label, fn in (("flow_net_ms_per_batch8",
                           lambda: flow_net.predict(vox)),
                          ("recon_net_ms_per_chunk8",
                           lambda: recon_net.reconstruct(vox[:, None]))):
            fn()
            ms = []
            for _ in range(SERVE_TIMED):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            out[label] = float(np.median(ms))
        for name, cli, args in (("flow", infer_flow, flow_args),
                                ("recon", reconstruct, recon_args)):
            _, _, wall = run(cli, args, f"{name}_warm", "pallas", "cuda")
            set_default_impl("pallas")
            busy, top = device_busy(torch, lambda: cli.main(
                args + ["--output_dir", os.path.join(work, f"{name}_prof"),
                        "--device", "cuda"]))
            set_default_impl(prev_impl)
            out[f"{name}_windows_per_s"] = (SERVE_FRAMES - 1) / wall
            out[f"{name}_wall_s"] = wall
            out[f"{name}_device_busy_s"] = busy
            out[f"{name}_idle_share"] = 1.0 - busy / wall
            out[f"{name}_top_device"] = top
    card = card_line()
    log(f"serving timings ({card}): infer_flow "
        f"{out['flow_windows_per_s']:.2f} windows/s (wall "
        f"{out['flow_wall_s']:.3f} s, device busy "
        f"{out['flow_device_busy_s']:.4f} s, idle share "
        f"{out['flow_idle_share']:.3f}); reconstruct "
        f"{out['recon_windows_per_s']:.2f} windows/s (wall "
        f"{out['recon_wall_s']:.3f} s, busy {out['recon_device_busy_s']:.4f}"
        f" s, idle {out['recon_idle_share']:.3f}); dataset "
        f"{out['dataset_ms_per_window']:.2f} ms/window on the host "
        f"('xla': {out['dataset_ms_per_window_xla']:.2f}); "
        f"EV-FlowNet {out['flow_net_ms_per_batch8']:.3f} ms per batch of 8, "
        f"E2VID {out['recon_net_ms_per_chunk8']:.3f} ms per 8 windows "
        f"(device, CUDA events)")
    log(f"  one window's two grids, ms per call (medians of {SERVE_PASSES} "
        f"passes of {SERVE_GRID_CALLS}): "
        + ", ".join(f"{k} {v:.3f}"
                    for k, v in out["grids_ms_per_window"].items()))
    log(f"  largest device entries: flow {out['flow_top_device']}; recon "
        f"{out['recon_top_device']}")
    out["card"] = card
    return launches, out


# ---------------------------------------------------------------------------
# Simulated anchors: the simulator on the card -> the published numbers
# ---------------------------------------------------------------------------

def window_counts(rec):
    """Events between consecutive frames of a memmap recording."""
    t = np.load(os.path.join(rec, "t.npy"), mmap_mode="r")[:, 0]
    stamps = np.load(os.path.join(rec, "timestamps.npy"))
    return np.diff(np.searchsorted(t, stamps)), stamps


def window_grids(ev, edges, bins, H, W):
    """(windows, bins, H, W) temporally bilinear grids of a simulated
    stream between ``edges`` (numpy: the same function for both runs)."""
    cut = np.searchsorted(ev.ts, edges)
    out = np.zeros((len(edges) - 1, bins, H * W))
    for i, (a, b) in enumerate(zip(cut[:-1], cut[1:])):
        if b - a < 2:
            continue
        ts = ev.ts[a:b]
        tn = (ts - ts[0]) / (ts[-1] - ts[0]) * (bins - 1)
        b0 = np.floor(tn).astype(np.int64)
        f = tn - b0
        px = ev.ys[a:b].astype(np.int64) * W + ev.xs[a:b].astype(np.int64)
        for bb, w in ((b0, 1 - f), (np.minimum(b0 + 1, bins - 1), f)):
            np.add.at(out[i], (bb, px), ev.ps[a:b] * w)
    return out


def synced(torch, fn):
    """``(fn(), wall seconds)``, the card synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def within(name, got, want, tol):
    if not abs(got - want) <= tol:
        raise AssertionError(f"{name}: {got}, want {want} +- {tol}")


def baf_scene(torch):
    """tests/test_denoise.py::test_baf_scores_against_simulator_labels on
    the card: six bright blocks on a 48x48 plane drifting at (120, 50)
    px/s, leak and shot noise at 1 Hz, 0.1 s at 500 fps; returns the
    filter's signal recall and noise removal."""
    from event_utils_tpu_torch.ops import background_activity_filter
    from event_utils_tpu_torch.simulation import (SimulatorConfig,
                                                  simulate_scene,
                                                  translating_scene)
    rng = np.random.default_rng(0)
    tex = np.full((48, 48), 0.3, np.float32)
    for _ in range(6):
        y, x = rng.integers(6, 42, 2)
        tex[y - 2:y + 2, x - 2:x + 2] = 1.0
    sc = translating_scene(tex, (120.0, 50.0), device="cuda")
    cfg = SimulatorConfig(c_pos=0.2, c_neg=0.2, leak_rate_hz=1.0,
                          shot_rate_hz=1.0)
    ev, *_ = simulate_scene(sc, 0.1, 500.0, cfg,
                            generator=torch.Generator().manual_seed(SEED))
    if ev.labels is None or int((ev.labels == 1).sum()) != \
            ev.stats["num_noise"] or ev.stats["num_noise"] == 0:
        raise AssertionError(f"BAF scene: labels {ev.stats}")
    keep = background_activity_filter(
        ev.xs, ev.ys, ev.ts, 0.008, sensor_size=(48, 48), n_slices=64,
        device="cuda").cpu().numpy()
    sig = ev.labels == 0
    return (float(keep[sig].mean()), float(1 - keep[~sig].mean()),
            len(ev), ev.stats["num_noise"])


@contextlib.contextmanager
def route_calls(cs):
    """Inside, every call of the voxel (single and batched), flat, bilinear
    and patch splat wrappers on card tensors counts one call of the route
    its shape is
    dispatched to,
    and the call with the most inputs of each (route, output shape) keeps a
    copy of them: yields ``{"calls": {route: n}, "kept": {(route, shape):
    (inputs, size)}}``. The calls themselves run unchanged."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    out = {"calls": {}, "kept": {}}
    vox, flat, bil, bat, patches = (cs.voxel_scatter, cs.flat_scatter,
                                    cs.bilinear_scatter,
                                    cs.bilinear_scatter_batched,
                                    ec.bilinear_patches_scatter)
    vbat = cs.voxel_scatter_batched
    pvar = cs.patch_variance_vg

    def note(route, shape, inputs, size, launches=1):
        # calls on the card only (the CPU runs the plain versions), and
        # none of an empty input, for which a wrapper launches nothing
        if inputs[0].device.type != "cuda" or size == 0:
            return
        out["calls"][route] = out["calls"].get(route, 0) + launches
        if size > out["kept"].get((route, shape), (None, -1))[1]:
            out["kept"][(route, shape)] = (
                tuple(a.detach().clone() for a in inputs), size)

    def vox_(xs, ys, t_norm, ps, B, H, W, route=None):
        n = xs.shape[0]
        note("voxel_scatter:" + (route or cs.voxel_route(n, B, H, W)),
             (B, H, W), (xs, ys, t_norm, ps), n if B else 0)
        return vox(xs, ys, t_norm, ps, B, H, W, route=route)

    def vbat_(xs, ys, t_norm, ps, B, H, W, split=False, route=None):
        S, n = xs.shape
        r = route or cs.voxel_batched_route(S, n, B, H, W, split)
        chunk = (cs.voxel_batched_chunk(B, H, W, split) if r == "vector"
                 else cs.BATCH_MAX_SAMPLES)
        note("voxel_scatter_batched:" + r, (B, H, W, split),
             (xs, ys, t_norm, ps), S * n if B else 0, -(-S // chunk))
        return vbat(xs, ys, t_norm, ps, B, H, W, split=split, route=route)

    def flat_(idx, w, num_buckets, route=None):
        D, n = w.shape
        note("flat_scatter:" + (route or cs.flat_route(D, n, num_buckets)),
             (D, num_buckets), (idx, w), n if D and num_buckets else 0)
        return flat(idx, w, num_buckets, route=route)

    def bil_(x, y, w, H, W, route=None):
        K, n = w.shape
        note("bilinear_scatter:" + (route or cs.bilinear_route(K, H, W, n)),
             (K, H, W), (x, y, w), n if K else 0)
        return bil(x, y, w, H, W, route=route)

    def bat_(x, y, w, H, W, route=None):
        (S, n), K = x.shape, w.shape[-2]
        r = route or cs.bilinear_batched_route(K, H, W, n, S)
        note("bilinear_scatter_batched:" + r, (S, K, H, W), (x, y, w),
             S * n * K, -(-S // cs.batched_chunk(r, K, H, W)))
        return bat(x, y, w, H, W, route=route)

    def patches_(x, y, w, P, C, PH, PW, route=None):
        r = route or cs.bilinear_patches_route(P, PH, PW)
        note("bilinear_patches_scatter" + ("" if r == "patch" else f":{r}"),
             (w.shape[0], P, C, PH, PW), (x, y, w),
             P * C if w.shape[0] else 0)
        return patches(x, y, w, P, C, PH, PW, route=route)

    def pvar_(x, y, t, p, mask, origin_yx, params, taps, roi_size, patch,
              full_pixels, grad=True):
        note("patch_variance_vg",
             (*x.shape, tuple(roi_size), tuple(patch), full_pixels),
             (x, y, t, p, mask, origin_yx, params, taps), x.numel())
        return pvar(x, y, t, p, mask, origin_yx, params, taps, roi_size,
                    patch, full_pixels, grad=grad)

    add = cs.add_launch_counts

    def add_(counts):
        # the ROI refine's CUDA graphs: a capture takes back the launches
        # its wrappers noted, each replay adds the launches it replays
        for route, n in counts.items():
            out["calls"][route] = out["calls"].get(route, 0) + n
        add(counts)

    cs.voxel_scatter, cs.flat_scatter, cs.bilinear_scatter = vox_, flat_, bil_
    cs.bilinear_scatter_batched = bat_
    cs.voxel_scatter_batched = vbat_
    ec.bilinear_patches_scatter = patches_
    cs.patch_variance_vg = pvar_
    cs.add_launch_counts = add_
    try:
        yield out
    finally:
        cs.voxel_scatter, cs.flat_scatter, cs.bilinear_scatter = vox, flat, bil
        cs.bilinear_scatter_batched = bat
        cs.voxel_scatter_batched = vbat
        ec.bilinear_patches_scatter = patches
        cs.patch_variance_vg = pvar
        cs.add_launch_counts = add


def route_cases(torch, cs, records, seen, label, extra=None):
    """Every (route, shape) kept by ``route_calls``, on its route, against
    its plain version: timed beside it, the library call and the bound,
    and added to the route's record as a case, with what ``extra(name,
    shape, inputs)`` returns (a dict) when given. Returns the cases."""
    slow = dict(calls=2, reps=5)
    cases = []
    for (name, shape), (args, _) in sorted(seen["kept"].items()):
        route = name.split(":")[1] if ":" in name else None
        if name == "patch_variance_vg":
            case = patch_variance_case(torch, cs, label, args, *shape)
        elif name.startswith("voxel_scatter_batched"):
            case = voxel_batched_case(torch, cs, label, args, *shape, route)
        elif name.startswith("voxel_scatter"):
            Bv, Hv, Wv = shape
            n = len(args[0])
            kernel = lambda: cs.voxel_scatter(*args, Bv, Hv, Wv, route=route)
            case = dict(
                shape=f"{n} events ({label}) into ({Bv}, {Hv}, {Wv})",
                max_abs_err=check_close(
                    f"{name} ({label})", kernel(),
                    cs.voxel_scatter_plain(*args, Bv, Hv, Wv)),
                ms=time_ms(kernel, torch),
                plain_ms=time_ms(lambda: cs.voxel_scatter_plain(
                    *args, Bv, Hv, Wv), torch),
                library_ms=time_ms(voxel_library(torch, args, Bv, Hv, Wv),
                                   torch),
                bound=bound(n * 16 + Bv * Hv * Wv * 4, n * 8))
        elif name.startswith("flat_scatter"):
            idx, w = args
            case = flat_case(torch, cs, label, idx, w, shape[1],
                             {})[route]
        elif name.startswith("bilinear_scatter_batched"):
            x, y, w = args
            case = batched_case(torch, cs, label, x, y, w, *shape[2:], route,
                                single=False)
        elif name.startswith("bilinear_scatter"):
            x, y, w = args
            K, H, W = shape
            bi, bv = live_taps(torch, x, y, w, H, W)
            ref = cs.bilinear_scatter_plain(x, y, w, H, W)
            got = cs.bilinear_scatter(x, y, w, H, W, route=route)
            case = dict(
                shape=f"K={K}, {len(x)} events ({label}) into {H}x{W}",
                max_abs_err=check_close(f"{name} ({label})", got, ref),
                ms=time_ms(lambda: cs.bilinear_scatter(x, y, w, H, W,
                                                       route=route), torch),
                plain_ms=time_ms(lambda: cs.bilinear_scatter_plain(
                    x, y, w, H, W), torch),
                library_ms=time_ms(lambda: torch.zeros(
                    K * H * W, device=x.device).index_put_(
                        (bi,), bv, accumulate=True), torch),
                bound=bilinear_bound(x, y, K, H, W))
            if route == "vector":
                # held per pixel; and the route these shapes took before,
                # on the same inputs
                case["max_abs_err"], case["limit_share"] = \
                    single_splat_check(torch, cs, f"{name} ({label})", got,
                                       x, y, w, H, W)
                case["direct_ms"] = time_ms(lambda: cs.bilinear_scatter(
                    x, y, w, H, W, route="direct"), torch)
        else:
            x, y, w = args
            K, P, C, PH, PW = shape
            kernel = lambda: cs.bilinear_patches_scatter(
                x, y, w, P, C, PH, PW, route=route or "patch")
            plain = lambda: cs.bilinear_patches_scatter_plain(x, y, w, P, C,
                                                              PH, PW)
            case = dict(
                shape=f"K={K}, {P} patches x {C} slots into ({PH}, {PW}) "
                      f"({label})",
                max_abs_err=check_close(f"{name} ({label})", kernel(),
                                        plain()),
                ms=time_ms(kernel, torch), plain_ms=time_ms(plain, torch,
                                                            **slow),
                library_ms=patches_library_ms(torch, x, y, w, P, C, PH, PW,
                                              **slow),
                bound=bilinear_bound(x, y, K, PH, PW, P))
        case = as_case(case, **(extra(name, shape, args) if extra else {}))
        log(f"  {name} at {case['shape']}: {case['ms']:.4f} ms, plain "
            f"{case['plain_ms']:.4f} ms, index_put_ {case['library_ms']:.4f}"
            f" ms, bound {case['bound_ms']:.5f} ms")
        rec = records[name]
        rec["cases"].append(case)
        rec["max_abs_err"] = max(rec["max_abs_err"], case["max_abs_err"])
        cases.append(case)
    return cases


def simulated_anchors_phase(torch, cs, records, work):
    """The published serving anchors rebuilt on the card: the port's
    simulate CLI makes the three recordings from the committed textures
    (into ``work``, where the training phase reads one of them), then
    infer_flow, reconstruct and eval_cmax serve them and the BAF filters a
    labelled scene, each gated on the JAX package's numbers. Returns the
    phase's launch counts and what it measured."""
    from event_utils_tpu_torch.cli import (eval_cmax, infer_flow,
                                           reconstruct, simulate)
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    from event_utils_tpu_torch.simulation import (SimulatorConfig,
                                                  affine_scene, load_texture,
                                                  simulate_scene,
                                                  texture_path)
    direct = "flat_scatter:direct"
    out = {"card": card_line()}
    prev_impl = get_default_impl()
    cs.reset_launch_counts()
    set_default_impl("pallas")

    try:
        recs = {}
        for name, a in ANCHOR_SIMS.items():
            rec = os.path.join(work, name)
            summary, wall = synced(torch, lambda: simulate.main(
                [rec, "--device", "cuda", "--texture",
                 texture_path(a["seed"])]
                + SIM_COMMON + a["args"]))
            counts, stamps = window_counts(rec)
            n, dropped = summary["events"], summary["stats"]["dropped"]
            log(f"simulated {name}: {n} events ({dropped} dropped; JAX "
                f"{a['events']}, {a['dropped']}) in {wall:.2f} s")
            within(f"{name} events", n, a["events"],
                   EVENTS_REL * a["events"])
            within(f"{name} dropped", dropped, a["dropped"],
                   EVENTS_REL * a["events"])
            want = np.asarray(a["windows"])
            if counts.shape != want.shape or not np.all(
                    np.abs(counts - want) <= WINDOW_REL * want):
                raise AssertionError(f"{name} window counts {counts}, "
                                     f"JAX {want}")
            out[name] = {"events": n, "dropped": dropped,
                         "cli_wall_s": wall,
                         "window_count_max_rel_err": float(
                             np.max(np.abs(counts - want) / want))}
            recs[name] = rec

        # seed 91 again, warm, on the card and on the CPU
        a = ANCHOR_SIMS["flow91"]
        tex = load_texture(texture_path(a["seed"]), (128, 128))
        cfg = SimulatorConfig(c_pos=0.15, c_neg=0.15)
        sims = {}
        for dev in ("cuda", "cpu"):
            scene = affine_scene(tex, divergence=0.35, omega=4.0,
                                 device=dev)
            (ev, *_), wall = synced(torch, lambda: simulate_scene(
                scene, 2.0, 100.0, cfg))
            sims[dev] = (ev, wall)
        card_ev, card_wall = sims["cuda"]
        edges = np.linspace(0.0, 2.0, 21)
        grids = [window_grids(sims[d][0], edges, 5, 128, 128)
                 for d in ("cuda", "cpu")]
        grid_err = max(float(np.abs(g - h).max() / np.abs(h).max())
                       for g, h in zip(*grids))
        grid_l1 = max(float(np.abs(g - h).sum() / np.abs(h).sum())
                      for g, h in zip(*grids))
        out["sim_events_per_s_card"] = len(card_ev) / card_wall
        out["sim_wall_s_card"] = card_wall
        out["sim_wall_s_cpu"] = sims["cpu"][1]
        out["card_vs_cpu_events"] = len(card_ev) - len(sims["cpu"][0])
        out["card_vs_cpu_grid_rel_err"] = grid_err
        out["card_vs_cpu_grid_rel_l1"] = grid_l1
        log(f"  seed 91 warm: card {card_wall:.3f} s "
            f"({out['sim_events_per_s_card']:.0f} events/s), CPU "
            f"{sims['cpu'][1]:.2f} s; card - CPU events "
            f"{out['card_vs_cpu_events']}, largest per-window grid "
            f"difference {grid_err:.2e} of its max|value| and "
            f"{grid_l1:.2e} of its L1")

        def serve(cli, name, args, windows):
            before = cs.launch_counts()
            summary, wall = synced(torch, lambda: cli.main(
                [recs[name]] + args + ["--output_dir",
                                       os.path.join(work, f"out_{name}"),
                                       "--device", "cuda",
                                       "--no_window_cache"]))
            got = {k: v - before[k] for k, v in cs.launch_counts().items()
                   if v != before[k]}
            if summary["windows"] != windows or got != {
                    direct: 2 * windows}:
                raise AssertionError(
                    f"{name}: {summary['windows']} windows, launches "
                    f"{got}; expected {direct} {2 * windows} only")
            return summary["metrics"], {
                "wall_s": wall, "windows": windows,
                "windows_per_s": windows / wall}

        m, out["infer_flow"] = serve(
            infer_flow, "flow91", ["--params", FLOW_PARAMS, "--method",
                                   "between_frames", "--eval_gt"], 20)
        log(f"  infer_flow: AEE {m['aee_px_s']} px/s over "
            f"{m['num_fields']} (JAX {FLOW_AEE}), zero-flow "
            f"{m['zero_flow_aee_px_s']}")
        within("AEE", m["aee_px_s"], FLOW_AEE, FLOW_AEE_TOL)
        within("zero-flow AEE", m["zero_flow_aee_px_s"], FLOW_ZERO,
               FLOW_ZERO_TOL)
        per = m["aee_per_window"][1:]
        if len(per) != len(FLOW_AEE_WINDOWS):
            raise AssertionError(f"AEE windows {per}")
        for i, (g, w) in enumerate(zip(per, FLOW_AEE_WINDOWS)):
            within(f"AEE window {i + 1}", g, w, FLOW_WINDOW_TOL)
        out["infer_flow"].update(
            aee_px_s=m["aee_px_s"],
            zero_flow_aee_px_s=m["zero_flow_aee_px_s"],
            aee_window_max_abs_err=max(abs(g - w) for g, w in
                                       zip(per, FLOW_AEE_WINDOWS)))

        for name, (psnr, ssim) in RECON_STEADY.items():
            n = len(ANCHOR_SIMS[name]["windows"])
            m, out[f"reconstruct_{name}"] = serve(
                reconstruct, name, ["--params", RECON_PARAMS,
                                    "--method", "between_frames",
                                    "--eval_gt"], n)
            log(f"  reconstruct {name}: steady {m['psnr_steady_db']} dB"
                f" / SSIM {m['ssim_steady']} (JAX {psnr} / {ssim}); all "
                f"{m['psnr_db']} / {m['ssim']}")
            within(f"{name} steady PSNR", m["psnr_steady_db"], psnr,
                   PSNR_TOL)
            within(f"{name} steady SSIM", m["ssim_steady"], ssim,
                   SSIM_TOL)
            out[f"reconstruct_{name}"].update(
                psnr_steady_db=m["psnr_steady_db"],
                ssim_steady=m["ssim_steady"], psnr_db=m["psnr_db"],
                ssim=m["ssim"])

        before = cs.launch_counts()
        with route_calls(cs) as seen:
            m, wall = synced(torch, lambda: eval_cmax.main(
                [recs["flow91"], "--max_windows", str(CMAX_WINDOWS),
                 "--device", "cuda"]))
        routes = {k: v - before[k] for k, v in cs.launch_counts().items()
                  if v != before[k]}
        log(f"  eval_cmax: median AEE {m['median_aee_px_s']} px/s over "
            f"{m['num_rois']} ROIs (JAX {CMAX_MEDIAN}) in {wall:.2f} s; "
            f"launches {routes}")
        within("eval_cmax median AEE", m["median_aee_px_s"], CMAX_MEDIAN,
               CMAX_REL_TOL * CMAX_MEDIAN)
        if not routes or routes != seen["calls"]:
            raise AssertionError(f"eval_cmax launched {routes}; its calls' "
                                 f"shapes dispatch to {seen['calls']}")
        out["eval_cmax"] = {"median_aee_px_s": m["median_aee_px_s"],
                            "num_rois": m["num_rois"], "wall_s": wall,
                            "windows": CMAX_WINDOWS,
                            "windows_per_s": CMAX_WINDOWS / wall,
                            "launches": routes}
        windows = {name: densest_window(recs[name])
                   for name in ("flow91", "recon77_20")}

        recall, removal, n, noise = baf_scene(torch)
        log(f"  BAF on the card: {n} events ({noise} noise), signal recall "
            f"{recall:.4f}, noise removal {removal:.4f}")
        if not (recall > BAF_RECALL and removal > BAF_REMOVAL):
            raise AssertionError(f"BAF recall {recall}, removal {removal}")
        out["baf"] = {"recall": recall, "removal": removal, "events": n,
                      "noise": noise}
    finally:
        set_default_impl(prev_impl)
    torch.cuda.synchronize()
    launches = cs.launch_counts()
    log(f"simulated-anchors launches: "
        f"{ {k: v for k, v in launches.items() if v} }")
    # the kernels at this path's shapes, after the counts are read
    out["patch_cases"] = route_cases(torch, cs, records, seen,
                                     "eval_cmax on flow91")
    out["flat_cases"] = [window_flat_case(
        torch, cs, records, f"densest {name} window's positive grid", ev,
        128, 128) for name, ev in windows.items()]
    return launches, out


# ---------------------------------------------------------------------------
# Training: the trainers on simulated scenes, gated on the eval anchors
# ---------------------------------------------------------------------------

def flat_gradient_case(torch, cs, idx, w, num_buckets):
    """The flat kernel under autograd against the plain adjoint (a gather
    of the cotangent, exact): returns the max abs difference."""
    wg = w.clone().requires_grad_(True)
    out = cs.scatter_add_flat_cuda(idx, wg[0] if w.shape[0] == 1 else wg,
                                   num_buckets)
    g = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(out.device).manual_seed(SEED))
    out.backward(g)
    ok = (idx >= 0) & (idx < num_buckets)
    ref = torch.where(ok, g.reshape(-1, num_buckets)[:, torch.where(
        ok, idx, 0).long()], 0.0)
    return float((wg.grad.reshape(ref.shape) - ref).abs().max())


def check_weights(name, card_state, cpu_state, init_state, lr_sum,
                  what="card vs CPU", max_share=STEP_PARAM_MAX,
                  undetermined=None):
    """Card against CPU weights after the parity steps (or two runs named
    by ``what``), from the same ``init_state``: the 99% quantile of |diff|
    over the determined coordinates the CPU run moved and (unless
    ``max_share`` is None) the max over all, against the summed learning
    rate. ``undetermined`` ({name: flat numpy bool mask}, from
    ``undetermined``) marks the coordinates whose step direction the two
    devices' gradients leave open: they are held to the max alone, and
    counted."""
    d, moved, und = [], [], []
    for k, x in card_state.items():
        ref = cpu_state[k].cpu()
        d.append((x.cpu() - ref).abs().reshape(-1).numpy())
        moved.append((ref != init_state[k].cpu()).reshape(-1).numpy())
        mask = (undetermined or {}).get(k)
        und.append(np.zeros(d[-1].shape, bool) if mask is None else mask)
    d, moved, und = (np.concatenate(a) for a in (d, moved, und))
    held = moved & ~und
    q = float(np.quantile(d[held], 0.99)) if held.any() else 0.0
    q_all = float(np.quantile(d[moved], 0.99)) if moved.any() else 0.0
    mx = float(d.max())
    log(f"  {name}: {what} weights, 99% of |diff| where the second moved "
        f"({moved.mean():.4f} of them) and the step's direction is "
        f"determined {q:.3e} ({q_all:.3e} with the undetermined), max "
        f"{mx:.3e} (summed lr {lr_sum:.2e}); undetermined {int(und.sum())} "
        f"({und.mean():.3e} of the coordinates), their max "
        f"{float(d[und].max()) if und.any() else 0.0:.3e}")
    if not (q <= STEP_PARAM_Q99 * lr_sum
            and (max_share is None or mx <= max_share * lr_sum)
            and und.mean() <= STEP_UNDETERMINED_MAX):
        raise AssertionError(f"{name}: card and CPU weights part: {q}, {mx}, "
                             f"undetermined {und.mean()}")
    return {"q99_abs_diff_moved": q, "q99_abs_diff_moved_all": q_all,
            "max_abs_diff": mx, "moved_share": float(moved.mean()),
            "undetermined": int(und.sum()),
            "undetermined_share": float(und.mean()), "lr_sum": lr_sum}


def step_grads(trainer):
    """The gradients of a trainer's last step by parameter name, flat, on
    the host (the trainers clear them before each backward, so after a
    step they are that step's)."""
    return {k: p.grad.reshape(-1).cpu().double()
            for k, p in trainer.model.named_parameters()
            if p.grad is not None}


def undetermined(steps):
    """The coordinates whose Adam step the card and the CPU may take in
    opposite directions: at some compared step (``steps``: a list of
    ``{"card": step_grads, "host": step_grads}``) their gradients differ in
    sign, or the CPU's |gradient| lies within its leaf's card-vs-CPU
    difference at that step (max |diff| over the leaf, as ``check_grads``
    measures it, capped at the ``STEP_GRAD_REL`` of the leaf's scale that
    ``check_grads`` accepts, so that a wider gap widens no exemption).
    Returns ``{name: flat numpy bool mask}``."""
    out = {}
    for i, st in enumerate(steps):
        worst, capped = 0.0, 0
        for k, b in st["host"].items():
            a = st["card"][k]
            gap, scale = float((a - b).abs().max()), float(b.abs().max())
            tol = min(gap, STEP_GRAD_REL * scale)
            if scale > 0:
                worst = max(worst, gap / scale)
            capped += gap > tol
            flip = (np.sign(a.numpy()) != np.sign(b.numpy())) | (
                b.abs().numpy() <= tol)
            out[k] = out[k] | flip if k in out else flip
        log(f"  step {i + 1} gradients, card vs CPU: worst leaf max|diff| "
            f"{worst:.3e} of its scale; {capped} leaves' exemption capped")
    return out


def check_grads(torch, name, nets, loss_fn):
    """One loss's gradients in the weights, card against CPU, leaf by leaf
    (``nets``: {"card"/"host": (trainer, batch)}; no step is taken): the
    worst leaf's cosine and max |diff| of the leaf's scale."""
    grads = {}
    for key, (t, batch) in nets.items():
        loss_fn(t, batch).backward()
        grads[key] = {k: p.grad.reshape(-1).cpu().double()
                      for k, p in t.model.named_parameters()}
    cos_min, rel_max = 1.0, 0.0
    for k, a in grads["card"].items():
        b = grads["host"][k]
        scale = float(b.abs().max())
        if scale > 0:
            cos_min = min(cos_min, float(
                torch.nn.functional.cosine_similarity(a, b, dim=0)))
            rel_max = max(rel_max, float((a - b).abs().max()) / scale)
    log(f"  {name}: gradients, card vs CPU: worst leaf cosine "
        f"{cos_min:.10f}, max|diff| {rel_max:.3e} of its scale")
    if not (cos_min >= STEP_GRAD_COS and rel_max <= STEP_GRAD_REL):
        raise AssertionError(f"{name} gradients: {cos_min}, {rel_max}")
    return {"leaf_cosine_min": cos_min, "leaf_max_rel_diff": rel_max}


def cuda_ms(torch, fn, reps=5):
    """Median device ms of ``fn`` between two CUDA events (warm)."""
    fn()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return float(np.median(ms))


def training_phase(torch, cs, records, work):
    """The training path: JAX's pinned eval batches rebuilt on the card and
    served through the trainers' evals; the three CLI runs; then card-vs-CPU
    train steps, 'pallas' vs 'xla' grids, the loss gradient against the
    CPU's, and the flat kernel at this path's shapes. ``work`` holds the
    seed-77 recording of the simulated-anchors phase. Returns the phase's
    launch counts and what it measured."""
    from event_utils_tpu_torch._device import no_tf32
    from event_utils_tpu_torch.cli import train_flow, train_reconstruction
    from event_utils_tpu_torch.models import contrast_flow_loss
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                ReconstructionTrainer,
                                                cosine_decay_schedule)
    from event_utils_tpu_torch.training import in_the_loop as itl
    with open(itl.EVAL_ANCHORS) as f:
        anchors = json.load(f)
    direct = "flat_scatter:direct"
    out = {"card": card_line()}
    prev_impl = get_default_impl()
    cs.reset_launch_counts()
    set_default_impl("pallas")

    def launched(fn, want, what):
        """``fn()``, which must launch ``want`` ({route: count}, or a count
        of ``flat_scatter:direct``) and nothing else."""
        want = want if isinstance(want, dict) else (
            {direct: want} if want else {})
        before = cs.launch_counts()
        res = fn()
        got = {k: v - before[k] for k, v in cs.launch_counts().items()
               if v != before[k]}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        return res

    try:
        with no_tf32(), route_calls(cs) as seen:
            # 1. the eval anchors
            fa, ra = anchors["flow"], anchors["recon"]
            fc, rc = fa["config"], ra["config"]
            (ev, mask, gt, sat), wall = synced(torch, lambda: launched(
                lambda: itl.simulate_flow_scenes(
                    itl.load_scenes(itl.FLOW_EVAL_SCENES), fc["capacity"],
                    window_t=fc["window_t"], num_frames=fc["num_frames"],
                    burn_in=fc["burn_in"], return_saturation=True,
                    device="cuda"), 0, "flow eval batch"))
            counts = mask.sum(1).long().tolist()
            log(f"training: stage-9 flow eval batch on the card in "
                f"{wall:.3f} s: kept events {counts} (JAX {fa['events']}), "
                f"saturated {sat.tolist()}")
            for b, (n, want) in enumerate(zip(counts, fa["events"])):
                within(f"flow eval scene {b} events", n, want,
                       TRAIN_EVENTS_REL * want)
            flow_net = FlowTrainer((128, 128), supervised_weight=1.0,
                                   device="cuda")
            flow_net.load_params(FLOW_PARAMS)
            # a batch's grids: one batched voxel launch, both polarities
            grids = "voxel_scatter_batched:" + cs.voxel_batched_route(
                *mask.shape, 5, 128, 128, split=True)
            vox = launched(lambda: itl.voxelize_batch(ev, mask, 5,
                                                      (128, 128)),
                           {grids: 1}, "flow eval grids")
            aee, zero = itl.flow_eval(flow_net, vox, gt)
            log(f"  held-out AEE {aee:.4f} px/s (JAX on the CPU "
                f"{fa['aee_px_s']:.4f}), zero-flow {zero:.4f} "
                f"({fa['zero_flow_aee_px_s']:.4f})")
            within("held-out AEE", aee, fa["aee_px_s"],
                   TRAIN_AEE_REL * fa["aee_px_s"])
            within("zero-flow AEE", zero, fa["zero_flow_aee_px_s"],
                   TRAIN_ZERO_TOL)
            out["flow_eval"] = {"events": counts, "aee_px_s": aee,
                                "zero_flow_aee_px_s": zero,
                                "sim_wall_s": wall}
            T = rc["seq_len"] * rc["carry_segments"]
            (rvox, rframes, rsat), wall = synced(torch, lambda: launched(
                lambda: itl.simulate_recon_scenes(
                    itl.load_scenes(itl.RECON_EVAL_SCENES), rc["capacity"],
                    T, window_t=rc["window_t"],
                    sim_steps_per_window=rc["sim_steps_per_window"],
                    num_bins=rc["num_bins"], return_saturation=True,
                    device="cuda"), 2, "recon eval batch"))
            counts = [int(round(float(x)))
                      for x in rvox.sum((0, 2, 3, 4)).cpu()]
            log(f"  stage-8 E2VID eval batch in {wall:.3f} s: events in "
                f"windows {counts} (JAX {ra['events_in_windows']})")
            for b, (n, want) in enumerate(zip(counts,
                                              ra["events_in_windows"])):
                within(f"recon eval scene {b} events", n, want,
                       TRAIN_EVENTS_REL * want)
            recon_net = ReconstructionTrainer(
                (128, 128), model_kwargs=RECON_KWARGS, burn_in=1,
                ema_decay=0.999, device="cuda")
            recon_net.load_params(RECON_PARAMS)
            p, s_, p_ss, s_ss = itl.recon_eval(recon_net, rvox, rframes)
            log(f"  held-out PSNR {p:.4f} dB / SSIM {s_:.4f}, steady "
                f"{p_ss:.4f} / {s_ss:.4f} (JAX {ra['psnr_db']:.4f} / "
                f"{ra['ssim']:.4f}, {ra['psnr_steady_db']:.4f} / "
                f"{ra['ssim_steady']:.4f})")
            for name, got, want, tol in (
                    ("PSNR", p, ra["psnr_db"], PSNR_TOL),
                    ("SSIM", s_, ra["ssim"], SSIM_TOL),
                    ("steady PSNR", p_ss, ra["psnr_steady_db"], PSNR_TOL),
                    ("steady SSIM", s_ss, ra["ssim_steady"], SSIM_TOL)):
                within(f"recon eval {name}", got, want, tol)
            out["recon_eval"] = {"events_in_windows": counts, "psnr_db": p,
                                 "ssim": s_, "psnr_steady_db": p_ss,
                                 "ssim_steady": s_ss, "sim_wall_s": wall}

            # 2. the CLIs: the stage-9 recipe from the committed weights,
            # the stage-8 recipe, and the seed-77 recording
            runs = {}
            flow_out = os.path.join(work, "train_flow.npz")
            res, wall = synced(torch, lambda: launched(lambda: train_flow.main(
                TRAIN_FLOW + [
                    "--resume_params", FLOW_PARAMS, "--lr", "5e-6",
                    "--steps", str(TRAIN_FLOW_STEPS), "--seed",
                    str(TRAIN_SEED), "--eval_seed", "0", "--eval_scenes",
                    itl.FLOW_EVAL_SCENES, "--eval_every",
                    str(TRAIN_FLOW_STEPS),
                    "--params_out", flow_out, "--metrics_out",
                    os.path.join(work, "train_flow.json"), "--device",
                    "cuda"]), {grids: 1 + TRAIN_FLOW_STEPS,
                               direct: TRAIN_FLOW_STEPS}, "train_flow"))
            runs["train_flow"] = res, wall
            recon_out = os.path.join(work, "train_recon.npz")
            res, wall = synced(torch, lambda: launched(
                lambda: train_reconstruction.main(TRAIN_RECON + [
                    "--simulate", "--resume_params", RECON_PARAMS, "--lr",
                    "3e-5", "--lr_end", "3e-6", "--steps",
                    str(TRAIN_RECON_STEPS), "--seed", str(TRAIN_SEED),
                    "--eval_seed", "0", "--eval_scenes",
                    itl.RECON_EVAL_SCENES, "--eval_every",
                    str(TRAIN_RECON_STEPS),
                    "--params_out", recon_out, "--device", "cuda"]),
                2 + 2 * TRAIN_RECON_STEPS // 3, "train_reconstruction"))
            runs["train_reconstruction"] = res, wall
            rec = os.path.join(work, "recon77_20")
            res, wall = synced(torch, lambda: launched(
                lambda: train_reconstruction.main([rec] + TRAIN_RECON_FILE + [
                    "--max_steps", str(TRAIN_FILE_STEPS), "--resume_params",
                    RECON_PARAMS, "--lr", "3e-6", "--device", "cuda"]),
                2 * 8 * TRAIN_FILE_STEPS, "train_reconstruction on recon77"))
            runs["train_reconstruction_file"] = res, wall
        launches = cs.launch_counts()
        log(f"training launches: { {k: v for k, v in launches.items() if v} }")
        with no_tf32():
            out["batched_vs_scene_loop"] = batched_vs_scene_loop(
                torch, itl, fc, rc, (ev, mask, gt, sat), (rvox, rframes, rsat))

        # the runs' numbers: finite losses, the final evals in their bands
        for name, (res, wall) in runs.items():
            losses = np.asarray(res["losses"])
            if not (len(losses) and np.isfinite(losses).all()):
                raise AssertionError(f"{name}: losses {losses}")
            entry = {"steps": len(losses), "wall_s": wall,
                     "steps_per_s": len(losses) / wall,
                     "loss_first": float(losses[0]),
                     "loss_last": float(losses[-1])}
            if "events" in res:
                entry.update(mev_per_s=res["events"] / res["wall_s"] / 1e6,
                             sim_share=res["sim_s"] / res["wall_s"],
                             loop_wall_s=res["wall_s"])
            out[name] = entry
            log(f"  {name}: {len(losses)} steps in {wall:.2f} s "
                f"({entry['steps_per_s']:.2f} steps/s), losses "
                f"{losses.round(5).tolist()}"
                + (f", {entry['mev_per_s']:.3f} Mev/s simulated+trained, "
                   f"simulator {entry['sim_share']:.3f} of the loop's wall"
                   if "events" in res else ""))
        (_, aee_end), = runs["train_flow"][0]["aee_curve"]
        (_, p_end, s_end, *_), = runs["train_reconstruction"][0][
            "psnr_curve"]
        out["train_flow"]["final_aee_px_s"] = aee_end
        out["train_reconstruction"].update(final_psnr_db=p_end,
                                           final_ssim=s_end)
        log(f"  final evals: AEE {aee_end:.4f} px/s (band {CLI_FLOW_AEE}), "
            f"PSNR {p_end:.4f} dB {CLI_RECON_PSNR} / SSIM {s_end:.4f} "
            f"{CLI_RECON_SSIM}")
        for name, got, (lo, hi) in (("AEE", aee_end, CLI_FLOW_AEE),
                                    ("PSNR", p_end, CLI_RECON_PSNR),
                                    ("SSIM", s_end, CLI_RECON_SSIM)):
            if not lo <= got <= hi:
                raise AssertionError(f"final {name} {got} outside "
                                     f"[{lo}, {hi}]")
        # --params_out into fresh trainers: bit-identical output
        flow_back = FlowTrainer((128, 128), device="cuda")
        flow_back.load_params(flow_out)
        recon_back = ReconstructionTrainer(
            (128, 128), model_kwargs=RECON_KWARGS, device="cuda")
        recon_back.load_params(recon_out)
        with no_tf32():
            same = (torch.equal(flow_back.predict(vox),
                                runs["train_flow"][0]["trainer"].predict(
                                    vox)),
                    torch.equal(recon_back.reconstruct(rvox[:8])[0],
                                runs["train_reconstruction"][0][
                                    "trainer"].reconstruct(rvox[:8])[0]))
        if not all(same):
            raise AssertionError(f"--params_out reloaded: bit-identical "
                                 f"(flow, recon) {same}")
        log("  --params_out reloaded on the card: predict and reconstruct "
            "bit-identical")

        # 3. card vs CPU steps on one batch drawn by the CPU generator
        with no_tf32():
            out["parity"] = step_parity(torch, itl, contrast_flow_loss,
                                        FlowTrainer, ReconstructionTrainer,
                                        cosine_decay_schedule)
    finally:
        set_default_impl(prev_impl)
    # 4. the flat kernel at this path's shapes, after the counts are read,
    # its adjoint against the plain gather too (exact)
    def adjoint(name, shape, inputs):
        if not name.startswith("flat_scatter"):
            return {}
        idx, w = inputs
        err = flat_gradient_case(torch, cs, idx, w, shape[1])
        if err != 0.0:
            raise AssertionError(f"flat adjoint at {idx.shape[0]} ids: "
                                 f"{err}")
        return {"grad_max_abs_err": err}

    out["route_cases"] = route_cases(torch, cs, records, seen,
                                     "training path", extra=adjoint)
    out["timings"] = training_timings(torch, cs, itl, FlowTrainer,
                                      ReconstructionTrainer, work)
    return launches, out


def scene_loop_flow(torch, itl, scenes, capacity, window_t=0.1,
                    num_frames=9, burn_in=0):
    """``simulate_flow_scenes`` as the port ran it before the batch: each
    scene rendered and simulated alone (``simulate_events_device``), the
    reference of the batched simulator."""
    from event_utils_tpu_torch.simulation import esim
    tex_all = scenes["texture"]
    B, H, W = tex_all.shape
    cfg = esim.SimulatorConfig(c_pos=0.15, c_neg=0.15)
    fts = itl.jax_linspace((burn_in + 1) * window_t,
                           burn_in * (num_frames - 1) + num_frames)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device="cuda") - cy,
        torch.arange(W, dtype=torch.float32, device="cuda") - cx,
        indexing="ij")
    evs, masks, gts, sats = [], [], [], []
    for b in range(B):
        v, ws = scenes["v"][b].to("cuda"), scenes["ws"][b].to("cuda")
        frames = itl._render_similarity(tex_all[b].to("cuda"), v, ws[0],
                                        ws[1], fts,
                                        age=scenes["age"][b].to("cuda"))
        ev, mask, overflow = esim.simulate_events_device(
            frames, fts, capacity, cfg, return_overflow=True)
        t_ref = np.float32(0.0)
        if burn_in:
            if bool(scenes["fresh"][b]):
                keep = ev[:, 2] < window_t
            else:
                keep = ev[:, 2] >= burn_in * window_t
                t_ref = np.float32(burn_in * window_t)
            mask = mask * keep.to(mask.dtype)
        if scenes["similarity"]:
            rx, ry = xx - v[0] * t_ref, yy - v[1] * t_ref
            gts.append(torch.stack([v[0] - ws[0] * ry + ws[1] * rx,
                                    v[1] + ws[0] * rx + ws[1] * ry]))
        else:
            gts.append(v)
        evs.append(ev)
        masks.append(mask)
        sats.append(overflow > 0)
    return tuple(torch.stack(a) for a in (evs, masks, gts, sats))


def scene_loop_recon(torch, itl, scenes, capacity, seq_len, window_t=0.05,
                     sim_steps_per_window=4, num_bins=5):
    """``simulate_recon_scenes`` as the port ran it before the batch (each
    scene rendered and simulated alone, then one pair of segmented
    scatters): ``(voxels, frames, saturation, scatter inputs (x, y, t, p,
    seg))``."""
    from event_utils_tpu_torch.simulation import esim
    tex_all = scenes["texture"]
    B, H, W = tex_all.shape
    cfg = esim.SimulatorConfig(c_pos=0.15, c_neg=0.15)
    spw = sim_steps_per_window
    fts = itl.jax_linspace(seq_len * window_t, seq_len * spw + 1)
    bounds = torch.as_tensor(fts, device="cuda")[::spw].contiguous()
    target_idx = torch.arange(1, seq_len + 1, device="cuda") * spw
    evs, segs, frames_out, sats = [], [], [], []
    for b in range(B):
        ws = scenes["ws"][b].to("cuda")
        frames = itl._render_similarity(tex_all[b].to("cuda"),
                                        scenes["v"][b].to("cuda"), ws[0],
                                        ws[1], fts)
        ev, mask, overflow = esim.simulate_events_device(
            frames, fts, capacity, cfg, return_overflow=True)
        w = torch.searchsorted(bounds, ev[:, 2].contiguous()) - 1
        segs.append(torch.where((mask > 0) & (w >= 0) & (w < seq_len),
                                w * B + b, -1))
        evs.append(ev)
        frames_out.append(frames[target_idx])
        sats.append(overflow > 0)
    inputs = torch.cat(evs).unbind(-1) + (torch.cat(segs),)
    voxels = itl.events_to_neg_pos_voxel_segments(
        *inputs, seq_len * B, num_bins, (H, W))
    return (voxels.view((seq_len, B) + voxels.shape[1:]),
            torch.stack(frames_out, 1)[:, :, None], torch.stack(sats),
            inputs)


@contextlib.contextmanager
def segment_inputs(itl):
    """The ``(x, y, t, p, seg)`` of every segmented voxel scatter that
    ``in_the_loop`` makes while open, with the per-segment ``(t0, t1)`` it
    passes."""
    kept, real = [], itl.events_to_neg_pos_voxel_segments

    def keep(*a, **kw):
        kept.append(a[:5] + (kw.get("t0"), kw.get("t1")))
        return real(*a, **kw)

    itl.events_to_neg_pos_voxel_segments = keep
    try:
        yield kept
    finally:
        itl.events_to_neg_pos_voxel_segments = real


def batched_vs_scene_loop(torch, itl, fc, rc, flow, recon):
    """Both eval batches of the batched simulator (``flow``: the phase's
    ``(ev, mask, gt, sat)``; ``recon``: its ``(voxels, frames, sat)``)
    against the per-scene loop on the same scenes: everything upstream of
    the flat kernel bit for bit, the grids (float atomics, summed in
    another order from run to run) within GRID_REL of their scale."""
    scenes = itl.load_scenes(itl.FLOW_EVAL_SCENES)
    ref = scene_loop_flow(torch, itl, scenes, fc["capacity"],
                          window_t=fc["window_t"],
                          num_frames=fc["num_frames"], burn_in=fc["burn_in"])
    for name, a, b in zip(("events", "mask", "gt", "saturation"), flow,
                          ref):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"flow eval batch {name}: batched differs "
                                 f"from the scene loop")
    grids = [itl.voxelize_batch(e, m, 5, (128, 128))
             for e, m in (flow[:2], ref[:2])]
    check_close("flow eval grids, batched vs scene loop", *grids, GRID_REL)
    scenes = itl.load_scenes(itl.RECON_EVAL_SCENES)
    T = rc["seq_len"] * rc["carry_segments"]
    kw = dict(window_t=rc["window_t"],
              sim_steps_per_window=rc["sim_steps_per_window"],
              num_bins=rc["num_bins"])
    with segment_inputs(itl) as kept:
        again = itl.simulate_recon_scenes(scenes, rc["capacity"], T,
                                          return_saturation=True,
                                          device="cuda", **kw)
    rv, rf, rs, inputs = scene_loop_recon(torch, itl, scenes,
                                          rc["capacity"], T, **kw)
    # each window's first and last stamp, read off the sorted rows, against
    # the scatter_reduce min and max over the scene loop's own segments
    from event_utils_tpu_torch.representations import segment_windows
    windows = segment_windows(inputs[2], inputs[4], T * len(rs))
    for name, a, b in [("frames", recon[1], rf), ("saturation", recon[2], rs),
                       ("frames, again", again[1], rf)] + list(zip(
                           ("x", "y", "t", "p", "segment", "window t0",
                            "window t1"), kept[0], inputs + windows)):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"E2VID eval batch {name}: batched differs "
                                 f"from the scene loop")
    for v in (recon[0], again[0]):
        check_close("E2VID eval grids, batched vs scene loop", v, rv,
                    GRID_REL)
    out = {"flow_grids_equal": bool(torch.equal(*grids)),
           "recon_grids_equal": bool(torch.equal(recon[0], rv)),
           "flow_events": int(flow[1].sum()),
           "recon_scatter_ids": int((inputs[4] >= 0).sum())}
    log(f"  batched simulator = the scene loop on both eval batches: "
        f"events, masks, ground truth, saturation, frames and scatter "
        f"inputs bit for bit, the windows' stamps from the sorted rows = "
        f"the scatter_reduce ones; grids bit-equal (flow, E2VID) "
        f"{out['flow_grids_equal']}, {out['recon_grids_equal']}")
    return out


def parity_steps(nets, step, count=2):
    """``count`` steps of each trainer of ``nets`` ({"card"/"host":
    (trainer, batch)}), in turns: the losses [[card, host], ...] and each
    step's gradients [{"card": ..., "host": ...}, ...] (``step_grads``)."""
    losses, grads = [], []
    for _ in range(count):
        losses.append([step(*nets[k]) for k in nets])
        grads.append({k: step_grads(nets[k][0]) for k in nets})
    return losses, grads


def step_parity(torch, itl, contrast_flow_loss, FlowTrainer,
                ReconstructionTrainer, cosine_decay_schedule):
    """Two Adam steps of each recipe from the committed weights on one batch
    (the CPU generator's scenes, simulated on the card), on the card and on
    the CPU; 'pallas' against 'xla' grids; the loss gradient against the
    CPU's."""
    from event_utils_tpu_torch.ops import set_default_impl
    out = {}
    ev, mask, gt = itl.simulate_flow_batch(
        TRAIN_SEED, 0, 8, (128, 128), 65536, omega_max=6.0, s_max=0.6,
        burn_in=1, fresh_prob=0.25, age_max=2.5, device="cuda")
    grids = {}
    for impl in ("xla", "pallas"):
        set_default_impl(impl)
        grids[impl] = itl.voxelize_batch(ev, mask, 5, (128, 128))
    check_close("flow grids, 'pallas' vs 'xla'", grids["pallas"],
                grids["xla"], GRID_REL)
    vox = grids["pallas"]
    batch = (vox, ev, mask, itl.dense_gt(gt, (128, 128)))
    lr = cosine_decay_schedule(1e-4, 6000, alpha=0.05)
    nets = {}
    for key, dev in (("card", "cuda"), ("host", "cpu")):
        t = FlowTrainer((128, 128), learning_rate=lr, supervised_weight=1.0,
                        device=dev)
        t.load_params(FLOW_PARAMS)
        nets[key] = (t, [a.to(dev) for a in batch])
    init = {k: v.clone() for k, v in nets["host"][0].model.state_dict()
            .items()}
    out["flow_grads"] = check_grads(torch, "flow", nets,
                                    lambda t, b: t.loss(*b))
    losses, grads = parity_steps(nets, lambda t, b: t.train_batch(*b))
    log(f"  flow steps, card vs CPU losses: {losses}")
    for a, b in losses:
        within("flow step loss", a, b, STEP_LOSS_REL * abs(b))
    out["flow_losses"] = losses
    out["flow_weights"] = check_weights(
        "flow", nets["card"][0].model.state_dict(),
        nets["host"][0].model.state_dict(), init, lr(0) + lr(1),
        undetermined=undetermined(grads))
    # the loss gradient in the flow, card ('pallas': the flat kernel and
    # its gather adjoint) against the CPU's plain route
    flow = nets["card"][0].predict(vox).detach()
    g = {}
    for key, dev in (("card", "cuda"), ("host", "cpu")):
        f = flow.detach().to(dev, copy=True).requires_grad_(True)
        contrast_flow_loss(f, ev.to(dev), mask.to(dev),
                           (128, 128)).backward()
        g[key] = f.grad.reshape(-1).cpu()
    cos = float(torch.nn.functional.cosine_similarity(g["card"], g["host"],
                                                      dim=0))
    err = float((g["card"] - g["host"]).abs().max())
    scale = float(g["host"].abs().max())
    log(f"  contrast_flow_loss gradient, card vs CPU: cosine {cos:.8f}, "
        f"max|diff| {err:.3e} of scale {scale:.3e}")
    if not (cos >= GRAD_COS and err <= GRAD_REL * scale):
        raise AssertionError(f"loss gradient: cosine {cos}, {err}/{scale}")
    out["loss_grad"] = {"cosine": cos, "max_abs_diff": err, "scale": scale}

    # E2VID: the first cold segment of one stage-8 batch, EMA on
    rvox = {}
    for impl in ("xla", "pallas"):
        set_default_impl(impl)
        rvox[impl], rframes = itl.simulate_recon_batch(
            TRAIN_SEED, 0, 4, (128, 128), 294912, 24, device="cuda")
    check_close("E2VID grids, 'pallas' vs 'xla'", rvox["pallas"],
                rvox["xla"], GRID_REL)
    seg = (rvox["pallas"][:8], rframes[:8])
    lr = cosine_decay_schedule(3e-5, 3000, alpha=0.1)
    nets = {}
    for key, dev in (("card", "cuda"), ("host", "cpu")):
        t = ReconstructionTrainer(
            (128, 128), learning_rate=lr, lpips_weight=0.1, mse_weight=4.0,
            model_kwargs=RECON_KWARGS, burn_in=1, ema_decay=0.999,
            device=dev)
        t.load_params(RECON_PARAMS)
        nets[key] = (t, [a.to(dev) for a in seg])
    init = {k: v.clone() for k, v in nets["host"][0].model.state_dict()
            .items()}
    out["recon_grads"] = check_grads(
        torch, "E2VID", nets,
        lambda t, b: t.sequence_loss(*b, burn_in=t.burn_in)[0])
    losses, grads = parity_steps(nets,
                                 lambda t, b: t.train_sequence(*b))
    log(f"  E2VID steps, card vs CPU losses: {losses}")
    for a, b in losses:
        within("E2VID step loss", a, b, STEP_LOSS_REL * abs(b))
    out["recon_losses"] = losses
    und = undetermined(grads)
    out["recon_weights"] = check_weights(
        "E2VID", nets["card"][0].model.state_dict(),
        nets["host"][0].model.state_dict(), init, lr(0) + lr(1),
        undetermined=und)
    out["recon_ema"] = check_weights(
        "E2VID EMA", nets["card"][0].ema_model.state_dict(),
        nets["host"][0].ema_model.state_dict(), init, lr(0) + lr(1),
        undetermined=und)
    return out


SIM_WALLS = 5                 # warm walls of each turn of the simulator A/B


def simulator_turns(torch, itl):
    """The flow and E2VID batch generations (``draw_scenes`` and the
    simulation, at the timings' shapes) through the per-scene loop and the
    batched simulator in turns (loop, batched, batched, loop), SIM_WALLS
    warm synchronised walls a turn, each call drawing the scenes of its
    own step (the same steps for both); then each one's device busy time
    and idle share of its median wall, and at the E2VID shape each one's
    ``max_memory_allocated`` (and its rise over the memory held before)."""
    flow_kw = dict(omega_max=6.0, s_max=0.6, age_max=2.5, fresh_prob=0.25)

    def flow(batched, step):
        scenes = itl.draw_scenes(TRAIN_SEED, step, 8, (128, 128), **flow_kw)
        if batched:
            return itl.simulate_flow_scenes(scenes, 65536, burn_in=1,
                                            device="cuda")
        return scene_loop_flow(torch, itl, scenes, 65536, burn_in=1)

    def recon(batched, step):
        scenes = itl.draw_scenes(TRAIN_SEED, step, 4, (128, 128))
        if batched:
            return itl.simulate_recon_scenes(scenes, 294912, 24,
                                             device="cuda")
        return scene_loop_recon(torch, itl, scenes, 294912, 24)

    out = {}
    for kind, fn in (("flow_batch", flow), ("recon_batch", recon)):
        res = {"scene_loop": {"walls_s": []}, "batched": {"walls_s": []}}
        for label in ("scene_loop", "batched", "batched", "scene_loop"):
            batched = label == "batched"
            fn(batched, 300)
            walls = []
            for i in range(SIM_WALLS):
                walls.append(synced(torch, lambda: fn(batched, 301 + i))[1])
            res[label]["walls_s"].append(walls)
        for label, r in res.items():
            batched = label == "batched"
            r["wall_s"] = float(np.median(np.concatenate(r["walls_s"])))
            r["device_busy_s"], r["top_device"] = device_busy(
                torch, lambda: fn(batched, 301))
            r["idle_share"] = max(0.0, 1.0 - r["device_busy_s"] / r["wall_s"])
            if kind == "recon_batch":
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn(batched, 301)
                torch.cuda.synchronize()
                r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
                r["peak_rise_bytes"] = r["max_memory_allocated"] - before
        out[kind] = res
    log("  simulator, scene loop vs batched (loop, batched, batched, loop; "
        + "; ".join(f"{k} {label} walls {np.round(r['walls_s'], 4).tolist()}"
                    f" busy {r['device_busy_s']:.4f} s idle "
                    f"{r['idle_share']:.3f}"
                    + (f" peak {r['max_memory_allocated'] / 2**30:.3f} GiB"
                       if "max_memory_allocated" in r else "")
                    for k, res in out.items() for label, r in res.items()))
    return out


@contextlib.contextmanager
def old_segment_route(torch, itl):
    """Inside, the trainers' grids are built as the port built them before
    the batched voxel kernel: ``voxelize_batch`` as one pair of segmented
    flat scatters over the padded rows, and every segmented scatter takes
    its windows' first and last stamps with two ``scatter_reduce`` calls a
    polarity (four a batch), whatever stamps its caller passes."""
    from event_utils_tpu_torch.representations import voxel_grid as vg
    real = itl.voxelize_batch, itl.events_to_neg_pos_voxel_segments

    def segments(xs, ys, ts, ps, seg, num, bins, sensor_size=(180, 240),
                 combined=False, impl=None, t0=None, t1=None):
        kw = dict(sensor_size=sensor_size, impl=impl)
        if combined:
            return vg.events_to_voxel_segments(xs, ys, ts, ps, seg, num, bins,
                                               **kw)
        return torch.cat([vg.events_to_voxel_segments(
            xs, ys, ts, sel.float(), seg, num, bins, **kw)
            for sel in (ps > 0, ps <= 0)], 1)

    def voxelize(events, mask, num_bins, sensor_size, combined=False):
        rows = mask.shape[0]
        seg = torch.where(mask != 0, torch.arange(
            rows, device=mask.device)[:, None], -1)
        x, y, t, p = (a.reshape(-1) for a in events.unbind(-1))
        return segments(x, y, t, p, seg.reshape(-1), rows, num_bins,
                        sensor_size, combined=combined)

    itl.voxelize_batch, itl.events_to_neg_pos_voxel_segments = (voxelize,
                                                                segments)
    try:
        yield
    finally:
        itl.voxelize_batch, itl.events_to_neg_pos_voxel_segments = real


def segment_route_turns(torch, cs, itl, flow):
    """A flow step (its batch simulated, its grids, one Adam step of
    ``flow``) and an E2VID batch generation, with the trainers' grids as
    the port built them before (``old_segment_route``: ``scatter_reduce``
    per segment) and as now (one batched voxel launch; the windows' stamps
    read off the sorted rows), in turns (old, new, new, old), SIM_WALLS
    warm synchronised walls a turn, each call on its own step's scenes (the
    same steps for both); then each one's device busy time, idle share of
    its median wall, five largest device entries and launches a call. The
    new route's five largest entries of either must hold no
    ``_scatter_gather_elementwise_kernel``."""
    def flow_step(step):
        ev, mask, gt = itl.simulate_flow_batch(
            TRAIN_SEED, step, 8, (128, 128), 65536, omega_max=6.0, s_max=0.6,
            burn_in=1, fresh_prob=0.25, age_max=2.5, device="cuda")
        return flow.train_batch(itl.voxelize_batch(ev, mask, 5, (128, 128)),
                                ev, mask, itl.dense_gt(gt, (128, 128)))

    def recon(step):
        return itl.simulate_recon_batch(TRAIN_SEED, step, 4, (128, 128),
                                        294912, 24, device="cuda")

    def route(label):
        return (old_segment_route(torch, itl) if label == "old"
                else contextlib.nullcontext())

    out = {}
    for kind, fn in (("flow_step", flow_step),
                     ("recon_batch_generation", recon)):
        res = {"old": {"walls_s": []}, "new": {"walls_s": []}}
        for label in ("old", "new", "new", "old"):
            with route(label):
                fn(400)
                res[label]["walls_s"].append(
                    [synced(torch, lambda: fn(401 + i))[1]
                     for i in range(SIM_WALLS)])
        for label, r in res.items():
            with route(label):
                r["wall_s"] = float(np.median(np.concatenate(r["walls_s"])))
                r["device_busy_s"], r["top_device"] = device_busy(
                    torch, lambda: fn(401))
                r["idle_share"] = max(0.0,
                                      1.0 - r["device_busy_s"] / r["wall_s"])
                before = cs.launch_counts()
                synced(torch, lambda: fn(402))
                r["launches"] = {k: v - before[k] for k, v in
                                 cs.launch_counts().items() if v != before[k]}
        out[kind] = res
    log("  trainers' grids, old segment route vs new (old, new, new, old; "
        + "; ".join(f"{k} {label} walls {np.round(r['walls_s'], 4).tolist()}"
                    f" busy {r['device_busy_s']:.4f} s idle "
                    f"{r['idle_share']:.3f} launches {r['launches']} top "
                    f"{r['top_device']}"
                    for k, res in out.items() for label, r in res.items()))
    for kind, res in out.items():
        if any("_scatter_gather_elementwise" in e[0]
               for e in res["new"]["top_device"]):
            raise AssertionError(f"{kind}: a scatter_gather kernel among the "
                                 f"largest entries {res['new']['top_device']}")
    return out


def training_timings(torch, cs, itl, FlowTrainer, ReconstructionTrainer,
                     work):
    """Warm timings of the training path on the card: one forward-plus-
    backward pass of each recipe (CUDA events), one full flow step and one
    E2VID batch generation and segment step (host wall, and the device
    idle share under torch.profiler), the simulator's batch generations
    through the per-scene loop and batched (``simulator_turns``), and a
    flow step and an E2VID batch generation with the trainers' grids as
    they were built before the batched voxel kernel and now
    (``segment_route_turns``)."""
    from event_utils_tpu_torch._device import no_tf32
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    prev = get_default_impl()
    set_default_impl("pallas")
    out = {}
    try:
        with no_tf32():
            flow = FlowTrainer((128, 128), supervised_weight=1.0,
                               learning_rate=5e-6, device="cuda")
            flow.load_params(FLOW_PARAMS)
            recon = ReconstructionTrainer(
                (128, 128), learning_rate=3e-6, lpips_weight=0.1,
                mse_weight=4.0, model_kwargs=RECON_KWARGS, burn_in=1,
                ema_decay=0.999, device="cuda")
            recon.load_params(RECON_PARAMS)
            step_no = [0]

            def flow_batch():
                step_no[0] += 1
                ev, mask, gt = itl.simulate_flow_batch(
                    TRAIN_SEED, 100 + step_no[0], 8, (128, 128), 65536,
                    omega_max=6.0, s_max=0.6, burn_in=1, fresh_prob=0.25,
                    age_max=2.5, device="cuda")
                return (itl.voxelize_batch(ev, mask, 5, (128, 128)), ev,
                        mask, itl.dense_gt(gt, (128, 128)))

            def recon_batch():
                step_no[0] += 1
                return itl.simulate_recon_batch(
                    TRAIN_SEED, 100 + step_no[0], 4, (128, 128), 294912, 24,
                    device="cuda")

            fb = flow_batch()
            rv, rf = recon_batch()
            seg = (rv[:8], rf[:8])
            out["flow_fwd_bwd_ms"] = cuda_ms(
                torch, lambda: flow.loss(*fb).backward())
            out["recon_fwd_bwd_ms"] = cuda_ms(
                torch, lambda: recon.sequence_loss(*seg, burn_in=1)[0]
                .backward())
            for name, fn in (
                    ("flow_step", lambda: flow.train_batch(*flow_batch())),
                    ("recon_batch_generation", recon_batch),
                    ("recon_segment_step",
                     lambda: recon.train_sequence(*seg))):
                fn()
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t)
                wall = float(np.median(walls))
                busy, top = device_busy(torch, fn)
                out[name] = {"wall_s": wall, "device_busy_s": busy,
                             "idle_share": max(0.0, 1.0 - busy / wall),
                             "top_device": top}
            sim = simulator_turns(torch, itl)
            grid_turns = segment_route_turns(torch, cs, itl, flow)
    finally:
        set_default_impl(prev)
    card = card_line()
    log(f"training timings ({card}): forward+backward EV-FlowNet "
        f"{out['flow_fwd_bwd_ms']:.2f} ms (batch 8), E2VID "
        f"{out['recon_fwd_bwd_ms']:.2f} ms (8 windows x 4); "
        + "; ".join(f"{k} wall {v['wall_s']:.4f} s, busy "
                    f"{v['device_busy_s']:.4f} s, idle "
                    f"{v['idle_share']:.3f}" for k, v in out.items()
                    if isinstance(v, dict)))
    out["simulator"] = sim
    out["segment_route"] = grid_turns
    out["card"] = card
    return out


# ---------------------------------------------------------------------------
# Streaming: the native window runtime, pinned prefetch, stream_flow, fit
# ---------------------------------------------------------------------------

def stream_errors(out_dir, n, roi_size, sensor):
    """Per window: the dense field's median (px/s), |median - GT| and the
    median over ROIs of |v_roi - GT| (one sample of the piecewise-constant
    field per ROI)."""
    gt = np.asarray(STREAM_GT)
    meds, med_err, roi_err = [], [], []
    for i in range(n):
        f = np.load(os.path.join(out_dir, f"flow_{i:04d}.npy"))
        if f.shape != (2,) + tuple(sensor) or not np.isfinite(f).all():
            raise AssertionError(f"flow_{i:04d}: {f.shape}, finite "
                                 f"{np.isfinite(f).all()}")
        m = np.median(f.reshape(2, -1), axis=1)
        rois = f[:, ::roi_size[0], ::roi_size[1]].reshape(2, -1)
        meds.append(m.tolist())
        med_err.append(float(np.linalg.norm(m - gt)))
        roi_err.append(float(np.median(np.linalg.norm(
            rois - gt[:, None], axis=0))))
    return meds, med_err, roi_err


def host_ms(fn, reps=5):
    """Median host wall of ``fn`` in ms (warm)."""
    fn()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t)
    return float(np.median(walls)) * 1e3


def native_cases(torch, rec, rng):
    """The native runtime at this path's shapes against its plain versions,
    exactly: a batch of 8 windows of 20,000 events at capacity 32768 from
    the recording, the bucket fill of the first window into the 108 ROIs
    of stream_flow, and the 720p tiled case (2^21 events into 80 tiles of
    (96, 128)). Host times and Mev/s of each."""
    from event_utils_tpu_torch import native
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.data_formats.read_events import \
        read_memmap_events
    d = read_memmap_events(rec)
    t, xy, p = (np.asarray(d[k]) for k in ("t", "xy", "p"))
    t, p = t.reshape(-1), p.reshape(-1)
    windows = native.k_event_windows(d["num_events"], 20000)[:8]
    out = {}

    def case(name, fn, plain, n):
        got, ref = fn(), plain()
        for a, b in zip(got, ref):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"native {name} differs from its plain "
                                     "version")
        ms, plain_ms = host_ms(fn), host_ms(plain, reps=2)
        out[name] = {"events": n, "ms": ms, "plain_ms": plain_ms,
                     "mev_per_s": n / ms / 1e3,
                     "plain_mev_per_s": n / plain_ms / 1e3}
        log(f"  native {name}: equal to the plain version; {ms:.2f} ms "
            f"({n / ms / 1e3:.1f} Mev/s), plain {plain_ms:.2f} ms")

    # into persistent buffers, as the loaders fill (fresh ones pay their
    # first-touch page faults on every call)
    bufs = (np.zeros((8, 32768, 4), np.float32),
            np.zeros((8, 32768), np.float32))
    case("fill_padded_batches (8 x 32768)",
         lambda: native.fill_padded_batches(t, xy, p, windows, 32768,
                                            out=bufs),
         lambda: native.fill_padded_batches_plain(t, xy, p, windows, 32768),
         int((windows[:, 1] - windows[:, 0]).sum()))
    s, e = windows[0]
    xs, ys = (np.asarray(xy[s:e, i], np.float32) for i in (0, 1))
    ts = t[s:e].astype(np.float32)
    ps = np.where(p[s:e] > 0, 1.0, -1.0).astype(np.float32)
    # grid_cmax_batched's capacity: the largest ROI, a power of two, <= 2048
    rid, ny, nx = ec._roi_ids(xs, ys, SENSOR, (20, 20))
    cap = min(int(2 ** np.ceil(np.log2(np.bincount(rid).max()))), 2048)
    args = (xs, ys, ts, ps, (20, 20), (ny, nx), cap)
    case(f"bucket_fill (20,000 events into {ny * nx} ROIs x {cap})",
         lambda: native.bucket_fill(*args),
         lambda: native.bucket_fill_plain(*args), len(xs))
    H, W = TILED_SENSORS["720p"]
    vx, vy, vt, vp = voxel_events(rng, (H, W))
    ny, nx = -(-H // TILE[0]), -(-W // TILE[1])
    counts = np.bincount((vy.astype(np.int64) // TILE[0]) * nx
                         + vx.astype(np.int64) // TILE[1], minlength=ny * nx)
    cap = int(2 ** np.ceil(np.log2(counts.max())))
    args = (vx, vy, vt, vp, TILE, (ny, nx), cap)
    case(f"bucket_fill (720p, {len(vx)} events into {ny * nx} tiles x "
         f"{cap})", lambda: native.bucket_fill(*args),
         lambda: native.bucket_fill_plain(*args), len(vx))
    return out


def prefetch_slow_consumer(torch, rec):
    """Pinned prefetch of every batch of the recording (8 windows of 20,000
    events, depth 3, more batches than the loader's pool of 4) to a
    consumer whose stream lags each copy: every device batch must equal
    the host batch it was copied from."""
    from event_utils_tpu_torch.data_loaders import (NativeWindowedLoader,
                                                    device_prefetch)
    kw = dict(k=20000, batch_size=2, shuffle=False)
    want = [{k: np.array(v) for k, v in b.items()}
            for b in NativeWindowedLoader(rec, **kw)]
    n = 0
    for got, ref in zip(device_prefetch(NativeWindowedLoader(rec, **kw),
                                        prefetch_depth=3, device="cuda"),
                        want):
        torch.cuda._sleep(5_000_000)  # the consumer lags the copy stream
        time.sleep(0.005)
        for k, v in ref.items():
            if not np.array_equal(got[k].cpu().numpy(), v):
                raise AssertionError(f"pinned prefetch: batch {n} {k} "
                                     "differs from its host batch")
        n += 1
    if n != len(want) or n <= 4:
        raise AssertionError(f"pinned prefetch gave {n} of {len(want)} "
                             "batches")
    log(f"  pinned prefetch under a slow consumer: {n} batches, each equal "
        "to its host batch")
    return n


def gpu_intervals(path):
    """(copies, compute) device intervals in us of a Chrome trace: the
    host-to-device copies, and the kernels and memsets."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies, compute = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            copies.append(iv)
        elif cat in ("kernel", "gpu_memset"):
            compute.append(iv)
    return copies, compute


def union_length(ivs):
    total, end = 0.0, -np.inf
    for a, b in sorted(ivs):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def overlap_length(ivs, others):
    """Length of ``ivs`` covered by the union of ``others``."""
    merged = []
    for a, b in sorted(others):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = 0.0
    for a, b in ivs:
        for c, d in merged:
            total += max(0.0, min(b, d) - max(a, c))
    return total


def fit_timings(torch, batches, work):
    """Warm ``FlowTrainer.fit`` over ``batches`` on the card through the
    pinned prefetch and through pageable copies (``torch.as_tensor`` to
    the card, no staging), in turns: wall per step, and from a
    ``torch.profiler`` trace (written under ``work``) the device's busy
    time and how much of the host-to-device copy time overlaps kernels."""
    from event_utils_tpu_torch.data_loaders import prefetch
    from event_utils_tpu_torch.training import FlowTrainer
    from event_utils_tpu_torch.utils import profiling
    pinned = prefetch.device_prefetch

    def pageable(loader, prefetch_depth=2, device=None, keys=None):
        for b in loader:
            yield {k: torch.as_tensor(v, device="cuda")
                   if keys is None or k in keys else v
                   for k, v in b.items()}

    t = FlowTrainer((184, 240), num_bins=5, device="cuda")
    t.load_params(FLOW_PARAMS)
    steps = len(batches)
    out = {}
    for name, mover in (("pinned", pinned), ("pageable", pageable),
                        ("pinned_again", pinned)):
        prefetch.device_prefetch = mover
        try:
            run = lambda: t.fit(batches, log_every=0)
            synced(torch, run)  # warm
            walls = [synced(torch, run)[1] for _ in range(3)]
            with profiling.trace(os.path.join(work, f"trace_{name}")) as path:
                run()
            copies, compute = gpu_intervals(path)
        finally:
            prefetch.device_prefetch = pinned
        wall = float(np.median(walls)) / steps
        busy = union_length(copies + compute) * 1e-6 / steps
        copy = union_length(copies)
        out[name] = {"step_wall_s": wall, "device_busy_s": busy,
                     "idle_share": max(0.0, 1.0 - busy / wall),
                     "copy_ms": copy * 1e-3 / steps,
                     "copy_overlap_share": overlap_length(copies, compute)
                     / max(copy, 1e-9)}
        log(f"  fit step, {name} copies: wall {wall:.4f} s, busy "
            f"{busy:.4f} s, idle {out[name]['idle_share']:.3f}; copies "
            f"{out[name]['copy_ms']:.3f} ms a step, "
            f"{out[name]['copy_overlap_share']:.3f} of it under kernels")
    return out


def window0_function(torch, ec, start, p_cpu):
    """Window 0's batched patch loss, the one its fine-level solve
    minimises (``_roi_patch_loss`` of the solver's own configuration), and
    the gradient of its sum, on the card and on the CPU port from the
    solver's own inputs, at the solve's start ``x0`` and at the CPU's
    answer plus STREAM_OFFSET: per-ROI losses within STREAM_LOSS_REL of the
    CPU's, the gradients at cosine >= STREAM_GRAD_COS with norms within
    STREAM_GRAD_REL. ``start`` is ``(solver args, (ex, ey, et, ep, emask,
    origin), x0)`` as the warm solver was given them. Returns the readings
    and the failures."""
    args, inputs, x0 = start
    loss = ec._roi_patch_loss(*args[:5])
    points = {"x0": x0.cpu().float(),
              "cpu_answer_plus_offset": p_cpu.cpu().float()
              + torch.tensor(STREAM_OFFSET)}
    got = {}
    for dev in ("cuda", "cpu"):
        batch = [a.to(dev) for a in inputs]
        for name, p in points.items():
            pt = p.to(dev).requires_grad_(True)
            L = loss(pt, *batch)
            (g,) = torch.autograd.grad(L.sum(), pt)
            got[dev, name] = (L.detach().cpu().double(), g.cpu().double())
    readings, fails = {}, []
    for name in points:
        (lc, gc), (lh, gh) = got["cuda", name], got["cpu", name]
        rel = float(((lc - lh).abs() / lh.abs().clamp(min=1e-30)).max())
        cos = float((gc * gh).sum() / (gc.norm() * gh.norm()))
        nrel = float((gc.norm() - gh.norm()).abs() / gh.norm())
        readings[name] = {"loss_rel": rel, "grad_cos": cos,
                          "grad_norm_rel": nrel, "rois": len(lh),
                          "loss_sum": [float(lc.sum()), float(lh.sum())]}
        log(f"  window 0's patch loss at {name}: per-ROI card vs CPU "
            f"{rel:.3e} relative (limit {STREAM_LOSS_REL}), summed "
            f"{float(lc.sum()):.6e} / {float(lh.sum()):.6e}; gradient "
            f"cosine {cos:.9f} (limit {STREAM_GRAD_COS}), norm {nrel:.3e} "
            f"apart (limit {STREAM_GRAD_REL})")
        if not (rel <= STREAM_LOSS_REL and cos >= STREAM_GRAD_COS
                and nrel <= STREAM_GRAD_REL):
            fails.append(f"stream_flow window 0's loss at {name}: "
                         f"{readings[name]}")
    return readings, fails


def streaming_phase(torch, cs, records, work):
    """The streaming path: the native runtime built and held against its
    plain versions, a DAVIS240 recording made by the simulate CLI, the
    stream_flow CLI on it (gated on the ground truth and on the CPU port),
    train_flow on it, FlowTrainer.fit card against CPU, the pinned prefetch
    under a slow consumer, and every kernel route the phase launched held
    against its plain version at the shapes it was sent. Returns the
    phase's launch counts and what it measured."""
    from event_utils_tpu_torch import native
    from event_utils_tpu_torch._device import no_tf32
    from event_utils_tpu_torch.cli import simulate, stream_flow, train_flow
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.data_loaders import NativeWindowedLoader
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    from event_utils_tpu_torch.training import FlowTrainer
    from event_utils_tpu_torch.training.in_the_loop import voxelize_batch
    out = {"card": card_line(), "evio_build_s": native.build_log.get(
        "seconds")}  # built by main beside the CUDA kernels
    log(f"streaming: libevio built with g++ in {out['evio_build_s']} s")
    rec = os.path.join(work, "davis30")
    summary, wall = synced(torch, lambda: simulate.main(
        [rec, "--device", "cuda"] + STREAM_SIM))
    out["recording"] = {"events": summary["events"], "wall_s": wall}
    log(f"  simulated DAVIS240 recording: {summary['events']} events in "
        f"{wall:.2f} s (352,151 on the CPU)")

    prev_impl = get_default_impl()
    cs.reset_launch_counts()
    set_default_impl("pallas")
    solves, depth, starts = [], [0], []
    solve, warm_solver = ec.grid_cmax_batched, ec._warm_roi_solver

    def keep(*a, **kw):  # the CLI's own solves, with inputs and answers
        depth[0] += 1
        try:
            res = solve(*a, **kw)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            solves.append((a, dict(kw), res))
        return res

    def keep_start(*args):  # the first fine-level (20x20) solve: window 0's
        run = warm_solver(*args)

        def run_kept(*b):
            if tuple(args[3]) == (20, 20) and not starts:
                starts.append((args, [a.detach().clone() for a in b[:6]],
                               b[6].detach().clone()))
            return run(*b)
        return run_kept

    sf_out = os.path.join(work, "stream")
    ck = os.path.join(work, "ck")
    try:
        with route_calls(cs) as seen:
            ec.grid_cmax_batched, ec._warm_roi_solver = keep, keep_start
            try:
                metrics, wall = synced(torch, lambda: stream_flow.main(
                    [rec, "--output_dir", sf_out, "--device", "cuda"]
                    + STREAM_ARGS))
            finally:
                ec.grid_cmax_batched, ec._warm_roi_solver = solve, warm_solver
            stream_launches = cs.launch_counts()
            stream_calls = dict(seen["calls"])
            res, twall = synced(torch, lambda: train_flow.main(
                [rec] + TRAIN_STREAM + ["--ckpt_dir", ck, "--device",
                                        "cuda"]))
            train_calls = dict(seen["calls"])
            # fit, card against CPU, on the first batches of one loader
            batches = [{k: np.array(v) for k, v in b.items()}
                       for b in NativeWindowedLoader(rec, k=20000,
                                                     batch_size=8)]
            nets = {}
            for key, dev in (("card", "cuda"), ("host", "cpu")):
                tr = FlowTrainer((184, 240), num_bins=5, learning_rate=1e-4,
                                 device=dev)
                tr.load_params(FLOW_PARAMS)
                ev = torch.as_tensor(batches[0]["events"], device=dev)
                mk = torch.as_tensor(batches[0]["events_mask"], device=dev)
                with no_tf32():
                    vox = voxelize_batch(ev, mk, 5, (184, 240))
                nets[key] = (tr, (vox, ev, mk, None))
            init = {k: v.clone() for k, v in
                    nets["host"][0].model.state_dict().items()}
            with no_tf32():
                grads = check_grads(torch, "fit's first batch", nets,
                                    lambda t, b: t.loss(*b))
            losses = {k: nets[k][0].fit(batches[:FIT_PARITY_STEPS],
                                        log_every=0) for k in nets}
        torch.cuda.synchronize()
    finally:
        set_default_impl(prev_impl)
    launches = cs.launch_counts()
    log(f"streaming launches: { {k: v for k, v in launches.items() if v} }; "
        f"by the dispatch rules: {seen['calls']} (stream_flow "
        f"{stream_calls}, then with train_flow {train_calls})")
    if {k: v for k, v in launches.items() if v} != seen["calls"]:
        raise AssertionError(f"streaming launches {launches} differ from "
                             f"the routes the calls dispatch to "
                             f"{seen['calls']}")
    if not launches["flat_scatter:direct"] or not (
            launches["bilinear_patches_scatter"]
            or launches["bilinear_patches_scatter:direct"]
            or launches["patch_variance_vg"]):
        raise AssertionError(f"streaming launches {launches}")

    # stream_flow: the windows against the ground truth and the CPU port
    n = metrics["num_windows"]
    meds, med_err, roi_err = stream_errors(sf_out, n, (20, 20), SENSOR)
    log(f"  stream_flow: {n} windows, {metrics['mevs_sustained']} Mev/s "
        f"sustained, {metrics['windows_per_s']} windows/s, {wall:.2f} s; "
        f"launches {dict((k, v) for k, v in stream_launches.items() if v)}")
    log(f"  |median - GT| per window {np.round(med_err, 3).tolist()} (max "
        f"{max(med_err):.3f}, mean {np.mean(med_err):.3f}; JAX on the CPU "
        f"{STREAM_JAX['median_err_max']}, {STREAM_JAX['median_err_mean']}); "
        f"ROI error {np.round(roi_err, 3).tolist()} (JAX max "
        f"{STREAM_JAX['roi_err_max']})")
    if n < STREAM_WINDOWS or len(solves) != n:
        raise AssertionError(f"stream_flow: {n} windows, {len(solves)} "
                             "solves")
    # the gates after the launch checks are read together and raised at
    # the end of the phase, so that one run reports every reading
    fails = []
    if not (max(med_err) <= STREAM_MEDIAN_ERR
            and max(roi_err) <= STREAM_ROI_ERR):
        fails.append(f"stream_flow errors: {med_err}, {roi_err}")
    early = med_err[:STREAM_EARLY_WINDOWS]
    if not (max(early) <= STREAM_EARLY_MEDIAN_ERR
            and roi_err[0] <= STREAM_FIRST_ROI_ERR):
        fails.append(f"stream_flow before the drift: |median - GT| of "
                     f"windows 0-{STREAM_EARLY_WINDOWS - 1} {early} (limit "
                     f"{STREAM_EARLY_MEDIAN_ERR}), window 0's ROI error "
                     f"{roi_err[0]} (limit {STREAM_FIRST_ROI_ERR})")
    cpu_meds, cpu_params = [], []
    for i in range(2):  # the CPU port's solve of the card's inputs
        a, kw, _ = solves[i]
        p, _, _, v = ec.grid_cmax_batched(*a, **dict(kw, device="cpu"))
        cpu_params.append(p)
        f = stream_flow.roi_params_to_dense_flow(p.numpy(), v.numpy(),
                                                 (20, 20), SENSOR)
        cpu_meds.append(np.median(f.reshape(2, -1), axis=1).tolist())
    diff = np.abs(np.asarray(meds[:2]) - np.asarray(cpu_meds)).max(axis=1)
    log(f"  windows 0-1 medians: card {np.round(meds[:2], 3).tolist()}, "
        f"CPU {np.round(cpu_meds, 3).tolist()}, JAX "
        f"{STREAM_JAX['medians_0_1']}; card - CPU {diff.round(4).tolist()} "
        f"px/s (window 0 logged, window 1 gated at {STREAM_CPU_TOL})")
    if diff[1] > STREAM_CPU_TOL:
        fails.append(f"stream_flow window 1: card vs CPU medians {meds[1]} "
                     f"and {cpu_meds[1]}, {diff[1]} px/s apart")
    if len(starts) != 1:
        raise AssertionError("stream_flow: window 0's fine-level start was "
                             "not seen")
    window0, w0_fails = window0_function(torch, ec, starts[0],
                                         cpu_params[0])
    fails += w0_fails
    a, kw, _ = solves[2]
    warm = lambda: solve(*a, **kw)
    walls = [synced(torch, warm)[1] for _ in range(4)][1:]
    busy, top = device_busy(torch, warm)
    w = float(np.median(walls))
    out["stream_flow"] = {
        "windows": n, "wall_s": wall,
        "mevs_sustained": metrics["mevs_sustained"],
        "windows_per_s": metrics["windows_per_s"], "medians": meds,
        "median_err": med_err, "roi_err": roi_err,
        "cpu_medians_0_1": cpu_meds, "card_vs_cpu": diff.tolist(),
        "window0_function": window0,
        "warm_window": {"wall_s": w, "device_busy_s": busy,
                        "idle_share": max(0.0, 1.0 - busy / w),
                        "top_device": top},
        "launches": {k: v for k, v in stream_launches.items() if v}}
    log(f"  a warm window (window 2's solve): wall {w:.4f} s, busy "
        f"{busy:.4f} s, idle {out['stream_flow']['warm_window']['idle_share']:.3f}")

    # train_flow on the recording, and fit card against CPU
    tl = np.asarray(res["losses"])
    steps = len(tl)
    if not (steps and np.isfinite(tl).all()
            and os.path.exists(os.path.join(ck, f"step_{steps}.pt"))):
        fails.append(f"train_flow: losses {tl}, checkpoints "
                     f"{os.listdir(ck)}")
    out["train_flow"] = {"steps": steps, "wall_s": twall,
                         "fit_wall_s": res["wall_s"],
                         "steps_per_s": steps / res["wall_s"],
                         "mev_per_s": res["events"] / res["wall_s"] / 1e6,
                         "losses": tl.tolist()}
    log(f"  train_flow: {steps} steps, losses {tl.round(5).tolist()}, "
        f"{out['train_flow']['steps_per_s']:.2f} steps/s, "
        f"{out['train_flow']['mev_per_s']:.3f} Mev/s ingested; checkpoint "
        f"step_{steps}.pt")
    log(f"  fit, card vs CPU losses: {losses['card']} / {losses['host']}")
    if not all(abs(a_ - b_) <= STEP_LOSS_REL * abs(b_)
               for a_, b_ in zip(losses["card"], losses["host"])):
        fails.append(f"fit step losses: {losses}")
    lr = nets["card"][0].opt.lr
    out["fit_parity"] = {
        "losses": [losses["card"], losses["host"]], "grads": grads,
        "weights": check_weights(
            "fit", nets["card"][0].model.state_dict(),
            nets["host"][0].model.state_dict(), init,
            sum(lr(c) for c in range(FIT_PARITY_STEPS)))}

    # the native runtime, the pinned prefetch, the routes, the timings
    out["native"] = native_cases(torch, rec, np.random.default_rng(SEED))
    out["prefetch_batches"] = prefetch_slow_consumer(torch, rec)
    out["route_cases"] = route_cases(torch, cs, records, seen,
                                     "streaming path")
    with no_tf32():  # 6 steps: the copy of each batch but the first
        #              can run under the previous step's kernels
        out["fit_timings"] = fit_timings(torch, batches[:2] * 3, work)
    if fails:
        raise AssertionError("streaming: " + "; ".join(fails))
    return launches, out


def slider_scene(rng):
    """The slider-like recording (benchmarks/bench_configs.py:36-50): a
    translating textured scene, 2^20 draws kept inside the sensor, with
    the coordinates rounded down to pixels."""
    H, W = SENSOR
    px = rng.uniform(5, W - 45, AUG_POINTS)
    py = rng.uniform(5, H - 25, AUG_POINTS)
    pol = rng.choice([-1.0, 1.0], AUG_POINTS)
    idx = rng.integers(0, AUG_POINTS, AUG_DRAWS)
    ts = np.sort(rng.uniform(0, AUG_SECONDS, AUG_DRAWS))
    xs = px[idx] + AUG_VELOCITY[0] * ts + rng.normal(0, 0.3, AUG_DRAWS)
    ys = py[idx] + AUG_VELOCITY[1] * ts + rng.normal(0, 0.3, AUG_DRAWS)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    return (np.floor(xs[keep]).astype(np.int64),
            np.floor(ys[keep]).astype(np.int64), ts[keep], pol[idx][keep])


def same_stream(name, a, b, valid_only=True):
    """Two densified streams equal: the masks everywhere, x, y, t, p on
    the valid slots (or on every slot); raises with the first difference."""
    a = [np.asarray(v.cpu() if hasattr(v, "cpu") else v) for v in a]
    b = [np.asarray(v.cpu() if hasattr(v, "cpu") else v) for v in b]
    if not np.array_equal(a[4], b[4]):
        raise AssertionError(f"{name}: masks differ")
    sel = a[4] != 0 if valid_only else slice(None)
    for label, u, v in zip("xytp", a[:4], b[:4]):
        if not np.array_equal(u[sel], v[sel]):
            raise AssertionError(f"{name}: {label} differs at "
                                 f"{int(np.sum(u[sel] != v[sel]))} slots")


def augmentation_phase(torch, cs, records, work):
    """The augmentation path: the slider-like recording written as ECD
    text, read back, packaged as a memmap and read back; the 2x densify on
    the card (one stable sort) and its voxel grid and event image through
    the kernels, with the launch counts read around it; the inputs of JAX's
    three sort routes, the CPU port and the edge cases against it; the kernels at
    this path's shapes against their plain versions; augment_demo's host
    sweep; warm times. Returns the phase's launch counts and what it
    measured."""
    from event_utils_tpu_torch.augmentation import event_augmentation as ea
    from event_utils_tpu_torch.cli import augment_demo
    from event_utils_tpu_torch.data_formats import (memmap_packager,
                                                    read_memmap_events,
                                                    read_txt_events,
                                                    write_txt_events)
    from event_utils_tpu_torch.ops import bilinear_scatter_matmul
    from event_utils_tpu_torch.representations import (events_to_image,
                                                       events_to_voxel)
    dev = torch.device("cuda")
    H, W = SENSOR
    out = {"card": card_line()}
    fails = []

    # 1. the recording: text, then the demo's memmap route
    xs, ys, ts, ps = slider_scene(np.random.default_rng(SEED))
    n = len(xs)
    txt = os.path.join(work, "slider_events.txt")
    t = time.perf_counter()
    write_txt_events(txt, xs, ys, ts, ps)
    t_write = time.perf_counter() - t
    t = time.perf_counter()
    rx, ry, rt, rp = read_txt_events(txt)
    t_read = time.perf_counter() - t
    mm = os.path.join(work, "slider_mm")
    pk = memmap_packager(mm)
    pk.package_events(rx, ry, rt, rp)
    pk.add_metadata(n, int((rp > 0).sum()), int((rp <= 0).sum()),
                    float(rt[-1] - rt[0]), float(rt[0]), float(rt[-1]), 0, 0,
                    sensor_size=SENSOR)
    data = read_memmap_events(mm, return_events=True)
    mx, my = data["xy"][:, 0], data["xy"][:, 1]
    mt = np.asarray(data["t"]).reshape(-1)
    mp = np.asarray(data["p"]).reshape(-1) * 2.0 - 1.0
    counts = [n, len(rx), int(data["num_events"]), len(mx)]
    exact = (np.array_equal(rx, xs) and np.array_equal(ry, ys)
             and np.array_equal(rp, ps) and np.array_equal(mx, xs)
             and np.array_equal(my, ys) and np.array_equal(mt, rt)
             and np.array_equal(mp, ps) and rx.dtype == np.int64)
    t_err = float(np.abs(rt - ts).max())
    log(f"augmentation: slider recording {n} events of {AUG_DRAWS} draws; "
        f"counts scene / text / memmap metadata / memmap {counts}; x, y, p "
        f"and the memmap's t exact: {exact}; text t within {t_err:.2e} s "
        f"(9 decimals); write {t_write:.2f} s, read {t_read:.2f} s")
    if len(set(counts)) != 1 or not exact or t_err > 5e-10:
        raise AssertionError(f"augmentation: the recording did not survive "
                             f"text and memmap: {counts}, exact {exact}, "
                             f"{t_err}")
    out["recording"] = {"events": n, "txt_write_s": t_write,
                        "txt_read_s": t_read, "bytes": os.path.getsize(txt)}
    # the demo's int16 coordinates, padded to AUG_DRAWS slots with a mask
    pad = AUG_DRAWS - n
    hx = np.concatenate([mx, np.zeros(pad, mx.dtype)])
    hy = np.concatenate([my, np.zeros(pad, my.dtype)])
    ht = np.concatenate([mt, np.zeros(pad)])
    hp = np.concatenate([mp, np.zeros(pad)])
    hm = (np.arange(AUG_DRAWS) < n).astype(np.float32)

    # 2-3. densify on the card, then its dense tensors, counted
    cs.reset_launch_counts()
    with route_calls(cs) as seen:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        (stream, dens_s) = synced(torch, lambda: ea.add_correlated_events_torch(
            hx, hy, ht, hp, mask=hm, ts_std=AUG_TS_STD,
            sensor_resolution=SENSOR, generator=gen))
        cx, cy, ct, cp, cm = stream
        vox = events_to_voxel(cx, cy, ct, cp, B, sensor_size=SENSOR, mask=cm,
                              impl="matmul")
        img = events_to_image(cx, cy, cp, sensor_size=SENSOR, mask=cm,
                              impl="matmul")
        torch.cuda.synchronize()
    launches = cs.launch_counts()
    got = {k: v for k, v in launches.items() if v}
    want = {f"voxel_scatter:{cs.voxel_route(2 * AUG_DRAWS, B, H, W)}": 1,
            f"flat_scatter:{cs.flat_route(1, 2 * AUG_DRAWS, (H + 1) * (W + 1))}":
            1}
    log(f"augmentation launches: {got}; by the dispatch rules "
        f"{seen['calls']}; want {want}")
    if got != seen["calls"] or got != want or set(want) != {
            "voxel_scatter:vector", "flat_scatter:direct"}:
        raise AssertionError(f"augmentation launches {got}, dispatch "
                             f"{seen['calls']}, want {want}")
    valid = cm != 0
    keys = torch.as_tensor(ct, device=dev)[valid]
    sorted_ok = bool((keys[1:] >= keys[:-1]).all())
    log(f"  densify: {n} events -> {int(valid.sum())} valid of "
        f"{len(cm)} slots, keys sorted {sorted_ok}; {dens_s:.3f} s cold "
        "from the host")
    if not (int(valid.sum()) == 2 * n and sorted_ok
            and not bool(valid[2 * n:].any())):
        raise AssertionError(f"augmentation densify: {int(valid.sum())} "
                             f"valid, keys sorted {sorted_ok}")
    out["densify"] = {"events": n, "slots": 2 * AUG_DRAWS}

    # JAX's three routes' inputs (its packed word for integer coordinates,
    # its general path for float ones, its global sort) from the same
    # draws, and the CPU port on them
    z = torch.randn((3, AUG_DRAWS), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)

    def core(x, y, blk, draws=z, device=dev, t_=ht):
        return ea._densify_core(x, y, t_, hp, hm, *draws, ts_std=AUG_TS_STD,
                                sensor_resolution=SENSOR, sort_block=blk,
                                device=device)

    routes = {"int, 'auto'": core(hx, hy, "auto"),
              "float, 'auto'": core(hx.astype(np.float32),
                                    hy.astype(np.float32), "auto"),
              "int, global": core(hx, hy, None)}
    for name, res in routes.items():
        same_stream(f"densify {name} against the public call", res, stream)
    log(f"  {list(routes)}: equal to the public call on every valid slot")
    cpu = core(hx, hy, "auto", draws=z.cpu(), device="cpu")
    same_stream("densify card against the CPU port", cpu,
                routes["int, 'auto'"], valid_only=False)
    log("  the CPU port's core on the card's draws: identical on every slot")
    out["routes_equal"] = True
    # the grids against the CPU port's of the CPU stream
    vox_cpu = events_to_voxel(*cpu[:4], B, sensor_size=SENSOR, mask=cpu[4],
                              impl="matmul", device="cpu")
    img_cpu = events_to_image(cpu[0], cpu[1], cpu[3], sensor_size=SENSOR,
                              mask=cpu[4], impl="matmul", device="cpu")
    out["grids_vs_cpu"] = [check_close("voxel grid, card vs CPU port",
                                       vox.cpu(), vox_cpu),
                           check_close("event image, card vs CPU port",
                                       img.cpu(), img_cpu)]

    # 4. edge cases
    ep_res = core(hx, hy, "auto", t_=ht + AUG_EPOCH)
    ep_t = np.asarray(ep_res[2])
    rel_t = np.asarray(routes["int, 'auto'"][2])
    vmask = np.asarray(ep_res[4].cpu()) != 0
    d_epoch = float(np.abs(ep_t[vmask] - AUG_EPOCH - rel_t[vmask]).max())
    jx, jy, jt = ea.jitter_events_torch(
        hx[:n], hy[:n], mt + AUG_EPOCH, generator=torch.Generator(
            device=dev).manual_seed(SEED))
    jit_std = float(np.std(jt - (mt + AUG_EPOCH)))
    log(f"  epoch stamps (+{AUG_EPOCH:g} s): {ep_t.dtype}, sorted stamps "
        f"within {d_epoch:.2e} s of the relative run's; jitter std "
        f"{jit_std * 1e3:.4f} ms (ts_std 1 ms)")
    if not (ep_t.dtype == np.float64 and d_epoch <= AUG_EPOCH_TOL
            and 0.9e-3 < jit_std < 1.1e-3):
        fails.append(f"epoch stamps: {d_epoch} s, jitter std {jit_std}")
    bad = [a.copy() for a in (hx, hy, hp, hm)]
    bad[0][0], bad[2][1], bad[3][2] = 20000, 0.0, 0.5
    oc = ea._densify_core(bad[0], bad[1], ht, bad[2], bad[3], *z,
                          ts_std=AUG_TS_STD, sensor_resolution=SENSOR,
                          device=dev)
    og = ea._densify_core(bad[0].astype(np.float32),
                          bad[1].astype(np.float32), ht, bad[2], bad[3], *z,
                          ts_std=AUG_TS_STD, sensor_resolution=SENSOR,
                          device=dev)
    same_stream("out-of-contract stream, int against float", oc, og,
                valid_only=False)
    log("  integer stream outside JAX's packed word (x 20000, p 0, mask "
        "0.5): equal to the float-coordinate run on every slot")
    xt, yt = (torch.as_tensor(a[:n], device=dev) for a in (hx, hy))
    edge = {}
    for name, fn in {
            "rotate": lambda x, y: ea.rotate_events_torch(
                x, y, SENSOR, 1.4, (W // 2, H // 2))[:2],
            "flip_x": lambda x, y: ea.flip_events_x_torch(
                x, y, None, None, SENSOR)[:1],
            "flip_y": lambda x, y: ea.flip_events_y_torch(
                x, y, None, None, SENSOR)[1:2]}.items():
        edge[name] = max(float((u.cpu().float() - v.float()).abs().max())
                         for u, v in zip(fn(xt, yt), fn(xt.cpu(), yt.cpu())))
    rotate_px = edge.pop("rotate")
    scores = torch.rand(AUG_DRAWS, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev, dtype=torch.float64)
    for k in (AUG_REMOVE, AUG_DRAWS, AUG_DRAWS + 1):
        keep_c = ea._remove_mask_core(scores, k)
        keep_h = ea._remove_mask_core(scores.cpu(), k)
        edge[f"remove {k}"] = int((keep_c.cpu() != keep_h).sum())
        if int(keep_c.sum()) != max(AUG_DRAWS - k, 0):
            fails.append(f"remove_events_mask {k}: kept {int(keep_c.sum())}")
    kept = ea.remove_events_mask_torch(AUG_DRAWS, AUG_REMOVE,
                                       generator=torch.Generator(device=dev)
                                       .manual_seed(SEED))
    if int(kept.sum()) != AUG_DRAWS - AUG_REMOVE:
        fails.append(f"remove_events_mask_torch kept {int(kept.sum())}")
    log(f"  card vs CPU port: rotate max |diff| {rotate_px} px (limit "
        f"{AUG_ROTATE_TOL}); flips max |diff| and remove masks' slots "
        f"differing {edge}")
    if rotate_px > AUG_ROTATE_TOL or any(edge.values()):
        fails.append(f"edge cases card vs CPU: rotate {rotate_px}, {edge}")
    bx = torch.as_tensor(rng_uniform(SEED, AUG_DRAWS, -2, W + 1), device=dev)
    by = torch.as_tensor(rng_uniform(SEED + 1, AUG_DRAWS, -2, H + 1),
                         device=dev)
    bsm = {}
    for K in (1, 4):
        w = torch.as_tensor(np.random.default_rng(SEED + K).normal(
            size=(K, AUG_DRAWS)).astype(np.float32), device=dev)
        bm = torch.as_tensor(hm, device=dev)
        got_k = bilinear_scatter_matmul(bx, by, w, SENSOR, mask=bm)
        ref = cs.bilinear_scatter_plain(bx, by, (w * bm).contiguous(), H, W)
        bsm[K] = check_close(f"bilinear_scatter_matmul K={K}", got_k, ref)
    out["edge"] = {"epoch_t_diff_s": d_epoch, "epoch_jitter_std_s": jit_std,
                   "card_vs_cpu": edge,
                   "rotate_card_vs_cpu_px": rotate_px,
                   "bilinear_scatter_matmul": bsm}

    # the kernels at this path's shapes against their plain versions
    out["route_cases"] = route_cases(torch, cs, records, seen,
                                     "augmentation path")

    # 5. augment_demo's host sweep (the figures need matplotlib)
    win = augment_demo.load_window(mm, SENSOR, 0, AUG_DEMO_WINDOW)
    t = time.perf_counter()
    sweep = augment_demo.augment_sweep(*win, SENSOR, 2.0)
    sweep_s = time.perf_counter() - t
    lengths = {k: len(v[0]) for k, v in sweep.items()}
    want_len = {"raw": AUG_DEMO_WINDOW, "add_correlated": 3 * AUG_DEMO_WINDOW,
                "add_random": 3 * AUG_DEMO_WINDOW,
                "remove": AUG_DEMO_WINDOW // 2, "rotate": AUG_DEMO_WINDOW,
                "flip_x": AUG_DEMO_WINDOW}
    try:
        import matplotlib  # noqa: F401
        demo = "matplotlib present: figures not drawn here"
    except ImportError:
        try:
            augment_demo.main([mm, "--output_path",
                               os.path.join(work, "figs")])
            demo = "ran without matplotlib"
        except ImportError as exc:
            demo = f"raised: {exc}"
    log(f"  augment_demo sweep of {AUG_DEMO_WINDOW} events: {lengths} in "
        f"{sweep_s:.3f} s; main: {demo}")
    if lengths != want_len or "matplotlib" not in demo:
        fails.append(f"augment_demo: {lengths}, {demo}")
    out["demo"] = {"lengths": lengths, "sweep_s": sweep_s, "main": demo}

    # 6. warm times (CUDA events, medians of AUG_REPS in turns), inputs on
    # the card
    dx = torch.as_tensor(hx.astype(np.int32), device=dev)
    dy = torch.as_tensor(hy.astype(np.int32), device=dev)
    dt = torch.as_tensor(ht - ht[0], dtype=torch.float32, device=dev)
    dp = torch.as_tensor(hp, dtype=torch.float32, device=dev)
    dm = torch.as_tensor(hm, device=dev)
    tg = torch.Generator(device=dev)
    timings = {}

    def densify(x, y, sort=True):
        return lambda: ea.add_correlated_events_torch(
            x, y, dt, dp, mask=dm, ts_std=AUG_TS_STD, sensor_resolution=SENSOR,
            sort=sort, generator=tg)

    cases = {"densify, int coords": densify(dx, dy),
             "densify, float coords": densify(dx.float(), dy.float()),
             "densify unsorted (sort=False)": densify(dx, dy, sort=False)}
    for name, ms in turns_ms(torch, cases, AUG_REPS).items():
        busy, top = device_busy(torch, cases[name])
        timings[name] = {"ms": ms, "mev_per_s": AUG_DRAWS / ms / 1e3,
                         "device_busy_ms": busy * 1e3, "top_device": top}
    dstream = ea.add_correlated_events_torch(dx, dy, dt, dp, mask=dm,
                                             ts_std=AUG_TS_STD,
                                             sensor_resolution=SENSOR,
                                             generator=tg)
    timings["voxel grid"] = {"ms": cuda_ms(torch, lambda: events_to_voxel(
        *dstream[:4], B, sensor_size=SENSOR, mask=dstream[4], impl="matmul"),
        reps=AUG_REPS)}
    timings["event image"] = {"ms": cuda_ms(torch, lambda: events_to_image(
        dstream[0], dstream[1], dstream[3], sensor_size=SENSOR,
        mask=dstream[4], impl="matmul"), reps=AUG_REPS)}

    def pipeline():
        s_ = ea.add_correlated_events_torch(hx, hy, ht, hp, mask=hm,
                                            ts_std=AUG_TS_STD,
                                            sensor_resolution=SENSOR,
                                            generator=tg)
        events_to_voxel(*s_[:4], B, sensor_size=SENSOR, mask=s_[4],
                        impl="matmul")
        events_to_image(s_[0], s_[1], s_[3], sensor_size=SENSOR,
                        mask=s_[4], impl="matmul")

    def device_pipeline():
        s_ = ea.add_correlated_events_torch(dx, dy, dt, dp, mask=dm,
                                            ts_std=AUG_TS_STD,
                                            sensor_resolution=SENSOR,
                                            generator=tg)
        events_to_voxel(*s_[:4], B, sensor_size=SENSOR, mask=s_[4],
                        impl="matmul")
        events_to_image(s_[0], s_[1], s_[3], sensor_size=SENSOR,
                        mask=s_[4], impl="matmul")

    for name, fn in (("from the host", pipeline),
                     ("on the card", device_pipeline)):
        walls = [synced(torch, fn)[1] for _ in range(AUG_REPS + 1)][1:]
        busy, top = device_busy(torch, fn)
        w = float(np.median(walls))
        timings[f"pipeline {name}"] = {
            "wall_s": w, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / w), "top_device": top}
    for name, v in timings.items():
        log(f"  {name}: " + ", ".join(
            f"{k} {v[k]:.4f}" if isinstance(v[k], float) else f"{k} {v[k]}"
            for k in v if k != "top_device")
            + (f"; top device entries {v['top_device'][:3]}"
               if "top_device" in v else ""))
    out["timings"] = timings
    if fails:
        raise AssertionError("augmentation: " + "; ".join(fails))
    return launches, out


# ---------------------------------------------------------------------------
# The multi-card path: parallel/sharding.py and data-parallel training
# ---------------------------------------------------------------------------

PAR_STEPS = 3                 # sharded train steps, each normalisation
PAR_LR = 0.5
PAR_P0 = (40.0, -20.0)        # px/s, the train steps' start
PAR_REL = 1e-5                # grids of the scale, params relative
PAR_ROI_LOSS_REL = 1e-4       # per-ROI loss at the answers
PAR_CARD = "cuda:0"           # both ranks of the two-rank runs
DP_FLAG = "--data-parallel-rank"
DP_ARGS = TRAIN_FLOW + ["--steps", "3", "--eval_every", "0", "--lr", "5e-6",
                        "--seed", str(TRAIN_SEED)]
DP_LOSS_REL = 1e-5


def sync_ms(torch, dev, fn, reps=5):
    """Median wall ms of ``fn`` (warm), the card synchronised around each
    call: a sharded call's host work and collectives count."""
    fn()
    ms = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ms))


def par_inputs():
    """The phase's streams, from fixed seeds (every rank makes its own)."""
    return {"voxel": voxel_events(np.random.default_rng(SEED + 10)),
            "planted": planted_scene(np.random.default_rng(SEED + 11)),
            "rotating": rotating_scene(SEED)}


def sharded_suite(torch, mesh, dev, timed=True):
    """Every function of ``parallel`` on the phase's inputs over ``mesh``:
    ``({name: tensor}, {name: ms})``, the ms beside the ms of the
    ``all_reduce`` alone of the call's output."""
    from event_utils_tpu_torch import parallel as par
    from event_utils_tpu_torch.models import linvel_warp, variance_objective
    from event_utils_tpu_torch.parallel.sharding import all_reduce
    inp = par_inputs()
    out, ms = {}, {}
    vx, vy, vt, vp = inp["voxel"]
    px, py, pt, pp = inp["planted"]
    calls = {
        "voxel": lambda: par.sharded_events_to_voxel(
            mesh, vx, vy, vt, vp, B, sensor_size=SENSOR, impl="matmul"),
        "iwe": lambda: par.sharded_iwe(
            mesh, np.float32(VELOCITY), px, py, pt, pp, linvel_warp(),
            SENSOR).detach(),
        "tsimg": lambda: torch.stack(par.sharded_events_to_timestamp_image(
            mesh, px, py, pt, pp, sensor_size=SENSOR, impl="matmul")),
    }
    for name, fn in calls.items():
        out[name] = fn()
        if timed:
            buf = out[name].clone()
            ms[name] = sync_ms(torch, dev, fn)
            ms[name + "_all_reduce"] = sync_ms(
                torch, dev, lambda: all_reduce(buf, mesh))
    shards = par.shard_events(mesh, px, py, pt, pp)
    for norm in (True, False):
        step = par.make_sharded_cmax_train_step(
            mesh, variance_objective(), linvel_warp(), SENSOR, lr=PAR_LR,
            normalize_grad=norm)
        p = torch.tensor(PAR_P0, device=dev)
        m = torch.zeros(2, device=dev)
        hist = []
        for _ in range(PAR_STEPS):
            p, m, loss = step(p, m, *shards)
            hist.append(torch.cat([p, m, loss[None]]))
        out[f"step_{int(norm)}"] = torch.stack(hist)
        if timed:
            ms[f"step_{int(norm)}"] = sync_ms(
                torch, dev, lambda: step(p, m, *shards))
    sx, sy, st, sp = inp["rotating"]
    kw = dict(roi_size=ROT_ROI, img_size=ROT_SENSOR, maxiter=ROT_MAXITER,
              capacity=ROT_CAPACITY)
    t = time.perf_counter()
    res = par.sharded_grid_cmax(mesh, sx, sy, st, sp, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms["grid_cmax"] = (time.perf_counter() - t) * 1e3
    for k, v in zip(("grid_params", "grid_rois", "grid_f", "grid_valid"),
                    res):
        out[k] = v
    return out, ms


def parallel_rank(rank, world, work):
    """One rank of the two-rank run on one card (gloo, ``file://`` store):
    the suite, each rank's results and times to ``par2_rank<r>.npz``."""
    import torch
    import torch.distributed as dist
    from event_utils_tpu_torch.parallel import make_mesh
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        work, "par2_store"), rank=rank, world_size=world)
    mesh = make_mesh(world, device=PAR_CARD)
    out, ms = sharded_suite(torch, mesh, torch.device(PAR_CARD))
    np.savez(os.path.join(work, f"par2_rank{rank}.npz"),
             **{k: v.cpu().numpy() for k, v in out.items()},
             **{"ms/" + k: np.float64(v) for k, v in ms.items()})
    dist.barrier()
    dist.destroy_process_group()


def dp_rank_main(argv):
    """A rank of ``torchrun ... chip_smoke.py --data-parallel-rank OUT
    ARGS``: ``train_flow ARGS --data_parallel``; rank 0 writes its losses,
    steps and walls to OUT (json)."""
    import torch
    from event_utils_tpu_torch.cli import train_flow
    res = train_flow.main(argv[1:] + ["--data_parallel"])
    if int(os.environ.get("RANK", 0)) == 0:
        with open(argv[0], "w") as f:
            json.dump({k: res[k] for k in ("losses", "steps", "wall_s",
                                           "sim_s", "events")}, f)
    torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reference_cmax_step(torch, p, m, xs, ys, ts, ps, norm):
    """The single-card train step the sharded one stands for: autograd
    through one IWE of the whole stream (the bilinear kernel)."""
    from event_utils_tpu_torch.models import (get_iwe, linvel_warp,
                                              variance_objective)
    from event_utils_tpu_torch.ops.blur import gaussian_filter
    p = p.detach().clone().requires_grad_(True)
    iwe, _ = get_iwe(p, xs, ys, ts, ps, linvel_warp(), SENSOR,
                     impl="matmul")
    loss = variance_objective().loss_fn(gaussian_filter(iwe, 1.0))
    (g,) = torch.autograd.grad(loss, p)
    if norm:
        g = g / (torch.linalg.vector_norm(g) + 1e-12)
    m = 0.9 * m + g
    return (p - PAR_LR * m).detach(), m, loss.detach()


def check_steps(name, got, ref):
    """Train-step histories ``(steps, 5)``: params, momentum, loss."""
    p_err = float((got[:, :2] - ref[:, :2]).abs().max())
    p_scale = float(ref[:, :2].abs().max())
    l_err = float(((got[:, 4] - ref[:, 4]).abs()
                   / ref[:, 4].abs().clamp(min=1e-12)).max())
    log(f"  {name}: params max|diff| {p_err:.3e} of {p_scale:.3e}, loss "
        f"rel {l_err:.3e}; last params {got[-1, :2].tolist()}")
    if not (p_err <= PAR_REL * p_scale and l_err <= PAR_REL):
        raise AssertionError(f"{name}: params {p_err}, loss {l_err}")
    return {"params_max_abs_diff": p_err, "loss_max_rel_diff": l_err}


def roi_losses_at(torch, params, dev):
    """The rotating scene's per-ROI patch loss (the ROI solver's own,
    variance, blur 1) at ``params``, single card."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.models import linvel_warp, variance_objective
    sx, sy, st, sp = rotating_scene(SEED)
    bx, by, bt, bp, bm, org, _ = ec.bucket_events_by_roi(
        sx, sy, st, sp, ROT_SENSOR, ROT_ROI, ROT_CAPACITY, device=dev)
    loss = ec._roi_patch_loss(linvel_warp(), variance_objective(),
                              ROT_SENSOR, ROT_ROI, 1.0)
    with torch.no_grad():
        return loss(torch.as_tensor(params, device=dev), bx, by, bt, bp, bm,
                    org.float())


def parallel_phase(torch, cs, records, work):
    """The multi-card path on the one card: a world of one in this process
    (NCCL, ``file://`` store in ``work``), each sharded function against
    its single-card counterpart, counted; two ranks spawned on the card
    (gloo) against the world of one; ``torchrun`` of ``train_flow
    --simulate --data_parallel`` on two ranks against one rank. Returns the
    phase's launch counts and what it measured."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from event_utils_tpu_torch.cli import train_flow
    from event_utils_tpu_torch.contrast_max import grid_cmax_batched
    from event_utils_tpu_torch.models import get_iwe, linvel_warp
    from event_utils_tpu_torch.parallel import make_mesh
    from event_utils_tpu_torch.representations import (
        events_to_timestamp_image, events_to_voxel)
    dev = torch.device("cuda", 0)
    out = {"card": card_line()}
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method="file://" + os.path.join(work, "par1_store"), rank=0,
        world_size=1)
    try:
        mesh = make_mesh(1, device=dev)
        cs.reset_launch_counts()
        with route_calls(cs) as seen:
            one, ms = synced(torch, lambda: sharded_suite(torch, mesh, dev,
                                                          timed=False))[0]
            torch.cuda.synchronize()
        launches = cs.launch_counts()
        got = {k: v for k, v in launches.items() if v}
        log(f"parallel launches (world of one): {got}; by the dispatch "
            f"rules {seen['calls']}")
        if got != seen["calls"] or not any(
                k.startswith("voxel_scatter") for k in got) or not any(
                k.startswith("bilinear_scatter") for k in got) or not any(
                k.startswith("bilinear_patches") for k in got):
            raise AssertionError(f"parallel launches {got}, dispatch "
                                 f"{seen['calls']}")
        _, ms = sharded_suite(torch, mesh, dev)

        # the world of one against the single-card functions
        inp = par_inputs()
        vx, vy, vt, vp = inp["voxel"]
        px, py, pt, pp = inp["planted"]
        single = {
            "voxel": events_to_voxel(vx, vy, vt, vp, B, sensor_size=SENSOR,
                                     impl="matmul", device=dev),
            "iwe": get_iwe(np.float32(VELOCITY), px, py, pt, pp,
                           linvel_warp(), SENSOR, impl="matmul",
                           device=dev)[0],
            "tsimg": torch.stack(events_to_timestamp_image(
                px, py, pt, pp, sensor_size=SENSOR, impl="matmul",
                device=dev))}
        errs = {k: check_close(f"world of one: sharded {k} vs single card",
                               one[k], v, rel=PAR_REL)
                for k, v in single.items()}
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev)
        ev = [f32(a) for a in inp["planted"]]
        for norm in (1, 0):
            p = torch.tensor(PAR_P0, device=dev)
            m = torch.zeros(2, device=dev)
            hist = []
            for _ in range(PAR_STEPS):
                p, m, loss = reference_cmax_step(torch, p, m, *ev, norm)
                hist.append(torch.cat([p, m, loss[None]]))
            errs[f"step_{norm}"] = check_steps(
                f"world of one: {PAR_STEPS} sharded train steps, "
                f"normalize_grad={bool(norm)}, vs single card",
                one[f"step_{norm}"], torch.stack(hist))
        err1, n1 = flow_error(one["grid_params"], one["grid_rois"],
                              one["grid_valid"])
        sx, sy, st, sp = inp["rotating"]
        ref = grid_cmax_batched(sx, sy, st, sp, roi_size=ROT_ROI,
                                img_size=ROT_SENSOR, maxiter=ROT_MAXITER,
                                capacity=ROT_CAPACITY, device=dev)
        d1 = float((one["grid_params"] - ref[0]).norm(dim=1).max())
        log(f"  world of one: sharded_grid_cmax median flow error "
            f"{err1:.3f} px/s over {n1} ROIs (limit {FLOW_ERR_LIMIT}); "
            f"grid_cmax_batched's answers within {d1:.3f} px/s")
        if not err1 <= FLOW_ERR_LIMIT:
            raise AssertionError(f"sharded_grid_cmax: {err1} px/s")
        out["world_one"] = {"errors": errs, "flow_error": err1,
                            "vs_grid_cmax_batched_max": d1, "ms": ms}
        for k in ("voxel", "iwe", "tsimg"):
            log(f"  world of one (NCCL): sharded {k} {ms[k]:.3f} ms, its "
                f"all_reduce {ms[k + '_all_reduce']:.3f} ms (share "
                f"{ms[k + '_all_reduce'] / ms[k]:.3f}); {out['card']}")
        log(f"  world of one: train step {ms['step_1']:.3f} ms, "
            f"sharded_grid_cmax {ms['grid_cmax']:.1f} ms (cold)")

        # two ranks on the card (gloo): the same suite, spawned
        t = time.perf_counter()
        mp.start_processes(parallel_rank, args=(2, work), nprocs=2,
                           start_method="spawn")
        wall2 = time.perf_counter() - t
        ranks = []
        for r in range(2):
            with np.load(os.path.join(work, f"par2_rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
        two = {k: torch.as_tensor(v, device=dev) for k, v in ranks[0].items()
               if not k.startswith("ms/")}
        same = all(np.array_equal(ranks[1][k], v) for k, v in
                   ranks[0].items() if not k.startswith("ms/"))
        if not same:
            raise AssertionError("two ranks: the ranks' results differ")
        errs2 = {k: check_close(f"two ranks vs world of one: {k}", two[k],
                                one[k], rel=PAR_REL)
                 for k in ("voxel", "iwe", "tsimg")}
        for norm in (1, 0):
            errs2[f"step_{norm}"] = check_steps(
                f"two ranks vs world of one: train steps, normalize_grad="
                f"{bool(norm)}", two[f"step_{norm}"], one[f"step_{norm}"])
        err2, n2 = flow_error(two["grid_params"], two["grid_rois"],
                              two["grid_valid"])
        at = roi_losses_at(torch, two["grid_params"], dev)
        lrel = float(((two["grid_f"] - at).abs()
                      / at.abs().clamp(min=1e-12)).max())
        d2 = (two["grid_params"] - one["grid_params"]).norm(dim=1)
        log(f"  two ranks: sharded_grid_cmax median flow error {err2:.3f} "
            f"px/s over {n2} ROIs; each ROI's loss against the single card's"
            f" loss at its answer: max rel {lrel:.3e} (limit "
            f"{PAR_ROI_LOSS_REL}); answers vs world of one: median "
            f"{float(d2.median()):.4f}, max {float(d2.max()):.4f} px/s "
            f"({int((d2 > 0.5).sum())} ROIs over 0.5)")
        if not (err2 <= FLOW_ERR_LIMIT and lrel <= PAR_ROI_LOSS_REL
                and bool((two["grid_rois"] == one["grid_rois"]).all())
                and bool((two["grid_valid"] == one["grid_valid"]).all())):
            raise AssertionError(f"two ranks sharded_grid_cmax: {err2}, "
                                 f"{lrel}")
        ms2 = {k[3:]: float(v) for k, v in ranks[0].items()
               if k.startswith("ms/")}
        for k in ("voxel", "iwe", "tsimg"):
            log(f"  two ranks (gloo, one card): sharded {k} {ms2[k]:.3f} "
                f"ms, its all_reduce {ms2[k + '_all_reduce']:.3f} ms (share "
                f"{ms2[k + '_all_reduce'] / ms2[k]:.3f})")
        out["two_ranks"] = {"errors": errs2, "flow_error": err2,
                            "roi_loss_rel": lrel,
                            "answers_vs_world_one_max": float(d2.max()),
                            "ms": ms2, "wall_s": wall2}

        # data-parallel training: torchrun on two ranks against one rank
        init = os.path.join(work, "dp_init.npz")
        import shutil
        shutil.copyfile(FLOW_PARAMS, init)
        args = DP_ARGS + ["--resume_params", init]
        one_out = os.path.join(work, "dp1.npz")
        (res1, wall1) = synced(torch, lambda: train_flow.main(
            args + ["--device", "cuda", "--data_parallel", "--params_out",
                    one_out]))
        two_out, two_json = (os.path.join(work, "dp2.npz"),
                             os.path.join(work, "dp2.json"))
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
               "--master_port", str(free_port()),
               os.path.abspath(__file__), DP_FLAG, two_json] + args + [
               "--device", "cuda", "--params_out", two_out]
        t = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600, cwd=ROOT)
        dp_wall = time.perf_counter() - t
        if run.returncode != 0:
            raise AssertionError(f"torchrun train_flow: {run.returncode}\n"
                                 f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
        if "data-parallel over 2 devices" not in run.stdout:
            raise AssertionError(f"torchrun: no JAX line: {run.stdout}")
        with open(two_json) as f:
            res2 = json.load(f)
        l1, l2 = np.array(res1["losses"]), np.array(res2["losses"])
        lrel = float(np.abs(l2 - l1).max() / np.abs(l1).max())
        with np.load(init) as zi, np.load(one_out) as z1, \
                np.load(two_out) as z2:
            keys = [k for k in zi.files if not k.startswith("__")]
            wq = check_weights(
                "torchrun two ranks vs one rank",
                {k: torch.as_tensor(z2[k]) for k in keys},
                {k: torch.as_tensor(z1[k]) for k in keys},
                {k: torch.as_tensor(zi[k]) for k in keys}, 3 * 5e-6,
                # both runs step a near-zero-gradient coordinate by up to
                # the rate, in opposite directions where the ranks' summed
                # gradient flips its sign: the max reaches the two runs'
                # whole travel, so only the quantile is a check
                what="two ranks vs one rank", max_share=None)
        log(f"  train_flow --data_parallel: one rank losses {l1.tolist()}, "
            f"two ranks {l2.tolist()} (max rel {lrel:.3e}, limit "
            f"{DP_LOSS_REL}); two ranks {res2['steps'] / res2['wall_s']:.3f}"
            f" steps/s in the loop ({res2['wall_s']:.2f} s for "
            f"{res2['steps']}; torchrun wall {dp_wall:.1f} s), one rank "
            f"{res1['steps'] / res1['wall_s']:.3f} steps/s; {out['card']}")
        if not (len(l1) == len(l2) == 3 and lrel <= DP_LOSS_REL):
            raise AssertionError(f"data parallel losses: {l1} vs {l2}")
        out["data_parallel"] = {
            "losses_one": l1.tolist(), "losses_two": l2.tolist(),
            "loss_max_rel": lrel, "weights": wq,
            "steps_per_s_two": res2["steps"] / res2["wall_s"],
            "steps_per_s_one": res1["steps"] / res1["wall_s"],
            "torchrun_wall_s": dp_wall}
        route_cases(torch, cs, records, seen, "parallel")
    finally:
        dist.destroy_process_group()
    return launches, out


# ---------------------------------------------------------------------------
# Visualization: the objective landscape, cmax_demo, motion compensation
# ---------------------------------------------------------------------------

VIS_EVENTS = 15_000           # of the planted scene
VIS_RES = 20                  # px/s a cell, +-200 px/s: a 20x20 grid
VIS_GRID = 20
VIS_LAND_REL = 1e-4           # card vs CPU, of the normalised range
VIS_LOSS_REL = 1e-4           # cmax_demo: card vs CPU at the same argmax
VIS_IMG_REL = 1e-5
VIS_WINDOW = 20_000           # events of the streaming recording


def png_gray_levels(path) -> np.ndarray:
    """The (H, W) uint8 levels of an 8-bit grayscale PNG with filter 0 on
    every row (what ``write_gray_png`` writes), decoded with zlib."""
    import struct
    import zlib
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, W, H = 8, b"", 0, 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            W, H, depth, color = struct.unpack(">IIBB", body[:10])
            if (depth, color) != (8, 0):
                raise AssertionError(f"{path}: not 8-bit gray")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, W + 1)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: filtered rows")
    return rows[:, 1:]


def visualization_phase(torch, cs, records, work):
    """The remaining host-side modules' device halves: the landscape of
    ``draw_objective_function`` on the planted scene, ``cmax_demo.run`` on
    the same events, ``motion_compensate`` of the streaming recording with
    its ground-truth flow (and the PNG it writes) and the 2-D visualizers'
    images, counted, each card against the CPU port. Returns the phase's
    launch counts and what it measured."""
    from event_utils_tpu_torch.cli import cmax_demo
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.contrast_max import (linvel_warp,
                                                    variance_objective)
    from event_utils_tpu_torch.data_formats import read_memmap_events
    from event_utils_tpu_torch.ops import get_default_impl, set_default_impl
    from event_utils_tpu_torch.utils.util import gray_levels, normalize_image
    from event_utils_tpu_torch.visualization import (get_visualizer,
                                                     motion_compensate)
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    out = {"card": card_line()}
    xs, ys, ts, ps = (a[:VIS_EVENTS] for a in planted_scene(
        np.random.default_rng(SEED + 20)))
    rec = read_memmap_events(os.path.join(work, "davis30"),
                             return_events=True)
    n = len(rec["t"])
    s = n // 2 - VIS_WINDOW // 2
    win = (rec["xy"][s:s + VIS_WINDOW, 0].astype(np.float32),
           rec["xy"][s:s + VIS_WINDOW, 1].astype(np.float32),
           np.asarray(rec["t"]).reshape(-1)[s:s + VIS_WINDOW],
           np.asarray(rec["p"]).reshape(-1)[s:s + VIS_WINDOW] * 2.0 - 1.0)
    H, W = SENSOR                  # the streaming recording's DAVIS240
    gt_flow = np.broadcast_to(np.float32(STREAM_GT)[:, None, None],
                              (2, H, W)).copy()
    png = os.path.join(work, "motion_compensated.png")
    data = {"events": np.stack([xs.astype(np.int64), ys.astype(np.int64),
                                ts, ps], 1).astype(np.float64)}
    lkw = dict(resolution=VIS_RES, img_size=SENSOR)

    def drive(device, fname=None):
        land = ec._objective_landscape(xs, ys, ts, ps, variance_objective(
            minimum_events=1), linvel_warp(), device=device, **lkw)
        demo = cmax_demo.run(xs, ys, ts, ps, gt=VELOCITY, img_size=SENSOR,
                             device=device)
        mc = motion_compensate(*win, gt_flow, fname=fname, device=device)
        prev = get_default_impl()
        set_default_impl("pallas")
        try:
            imgs = {name: get_visualizer(name, SENSOR, device=device)
                    .image(data) for name in ("event_image", "voxel_image",
                                              "ts_image")}
        finally:
            set_default_impl(prev)
        return land, demo, mc, imgs

    cs.reset_launch_counts()
    with route_calls(cs) as seen:
        (land, demo, mc, imgs), wall = synced(torch, lambda: drive(dev, png))
    launches = cs.launch_counts()
    got = {k: v for k, v in launches.items() if v}
    # the landscape's 400 samples: one batched launch; cmax_demo's solves
    # and motion_compensate: single splats
    n_bil = sum(v for k, v in got.items() if k.startswith("bilinear_scatter:"))
    log(f"visualization launches: {got}; by the dispatch rules "
        f"{seen['calls']} ({wall:.1f} s)")
    chunks = -(-VIS_GRID ** 2 // ec.batch_chunk(VIS_EVENTS, SENSOR))
    if got != seen["calls"] or not n_bil or got.get(
            "bilinear_scatter_batched:private") != chunks or not any(
            k.startswith("flat_scatter") for k in got):
        raise AssertionError(f"visualization launches {got}, dispatch "
                             f"{seen['calls']}")
    t = time.perf_counter()
    land_c, demo_c, mc_c, imgs_c = drive(cpu)
    cpu_s = time.perf_counter() - t

    # the landscape: card vs CPU, and its peak at the planted velocity
    land_err = float((land.cpu() - land_c).abs().max())
    iy, ix = np.unravel_index(int(torch.argmax(land).cpu()), land.shape)
    peak = (float(ix * VIS_RES - 200.0), float(iy * VIS_RES - 200.0))
    log(f"  landscape {tuple(land.shape)}: card vs CPU max|diff| "
        f"{land_err:.3e} of its [0, 1] range (limit {VIS_LAND_REL}); peak "
        f"at {peak} px/s, planted {VELOCITY}")
    if not (land.shape == (VIS_GRID, VIS_GRID) and land_err <= VIS_LAND_REL
            and abs(peak[0] - VELOCITY[0]) <= VIS_RES
            and abs(peak[1] - VELOCITY[1]) <= VIS_RES):
        raise AssertionError(f"landscape: {land_err}, peak {peak}")
    land_ms = sync_ms(torch, dev, lambda: ec._objective_landscape(
        xs, ys, ts, ps, variance_objective(minimum_events=1), linvel_warp(),
        device=dev, **lkw), reps=3)

    # cmax_demo: each objective's loss at its argmax, card vs CPU
    demo_out = {}
    for name, r in demo.items():
        obj = ec.OBJECTIVE_REGISTRY[name]()
        rc = demo_c[name]
        at_card_cpu = obj.evaluate_function(r["argmax"], xs, ys, ts, ps,
                                            linvel_warp(), img_size=SENSOR,
                                            device=cpu)
        at_cpu_card = obj.evaluate_function(rc["argmax"], xs, ys, ts, ps,
                                            linvel_warp(), img_size=SENSOR,
                                            device=dev)
        rel = max(abs(r["loss"] - at_card_cpu) / max(abs(at_card_cpu), 1e-9),
                  abs(rc["loss"] - at_cpu_card) / max(abs(rc["loss"]), 1e-9),
                  abs(r["gt_loss"] - rc["gt_loss"])
                  / max(abs(rc["gt_loss"]), 1e-9))
        d = float(np.abs(r["argmax"] - rc["argmax"]).max())
        log(f"  cmax_demo {name}: card argmax {np.round(r['argmax'], 3)} "
            f"loss {r['loss']:.6g}, CPU {np.round(rc['argmax'], 3)} "
            f"{rc['loss']:.6g} (argmax apart {d:.3f} px/s); loss at the "
            f"same argmax, card vs CPU, max rel {rel:.2e}")
        if not rel <= VIS_LOSS_REL:
            raise AssertionError(f"cmax_demo {name}: {rel}")
        demo_out[name] = {"argmax": r["argmax"].tolist(), "loss": r["loss"],
                          "cpu_argmax": rc["argmax"].tolist(),
                          "cpu_loss": rc["loss"], "loss_rel": rel}

    # motion compensation and its PNG; the visualizers' images
    mc_err = float(np.abs(mc - mc_c).max())
    levels = png_gray_levels(png)
    png_ok = np.array_equal(levels, gray_levels(normalize_image(mc)))
    log(f"  motion_compensate: {VIS_WINDOW} events of the streaming "
        f"recording at its ground truth {STREAM_GT} px/s: card vs CPU "
        f"max|diff| {mc_err:.3e}; PNG {levels.shape} decodes to its levels:"
        f" {png_ok}; sharpness (variance) {float(mc.var()):.5f}")
    if not (mc_err <= VIS_IMG_REL and png_ok):
        raise AssertionError(f"motion_compensate: {mc_err}, PNG {png_ok}")
    for name, img in imgs.items():
        check_close(f"visualizer {name}, card vs CPU", torch.as_tensor(img),
                    torch.as_tensor(imgs_c[name]), rel=VIS_IMG_REL)
    out.update(landscape={"max_abs_diff": land_err, "peak": peak,
                          "ms": land_ms},
               cmax_demo=demo_out, motion_compensate_err=mc_err,
               wall_s=wall, cpu_s=cpu_s)
    log(f"  landscape {land_ms:.2f} ms warm ({VIS_GRID * VIS_GRID} "
        f"samples); the phase's drive {wall:.1f} s on the card, "
        f"{cpu_s:.1f} s on the CPU; {out['card']}")
    route_cases(torch, cs, records, seen, "visualization")
    return launches, out




def full_frame_variance():
    """A variance objective under a name the patch loss does not know, as
    a user's own objective would be: the ROI solvers take the full-frame
    loss."""
    from event_utils_tpu_torch.contrast_max import variance_objective
    obj = variance_objective()
    obj.name = "variance_full_frame"
    return obj


def batched_phase(torch, cs, records):
    """The solves that JAX batches, on the batched splat and the batched
    BFGS, counted: ``optimize_contrast_jit(grid_search_init=True)`` and
    ``grid_search_optimisation`` on the 200k planted scene (every grid
    level one batched launch per chunk, no single splat), one
    ``grid_search_initial`` level of zhu's objective (K = 4: the vector
    route, in its chunks of samples), the 20x20 landscape on the
    visualization phase's 15,000 events (card vs CPU) and on all 200k (5
    chunks; against the per-sample loop on the card),
    ``grid_cmax_batched(solver='bfgs')`` on the rotating scene
    (one batched BFGS over its ROIs; flow error, card vs CPU) and a
    full-frame objective's ROI solve there. Then warm walls, device busy
    and idle shares, and each kept shape on its route against its plain
    version. Returns the phase's launch counts and what it measured."""
    from event_utils_tpu_torch.contrast_max import events_cmax as ec
    from event_utils_tpu_torch.contrast_max import (
        grid_cmax_batched, grid_search_initial, grid_search_optimisation,
        linvel_warp, optimize_contrast, optimize_contrast_jit,
        variance_objective, zhu_timestamp_objective)
    dev = torch.device("cuda")
    out = {"card": card_line()}
    sx, sy, st, sp = planted_scene(np.random.default_rng(SEED))
    n = len(sx)
    vx, vy, vt, vp = (a[:VIS_EVENTS] for a in planted_scene(
        np.random.default_rng(SEED + 20)))
    rx, ry, rt, rp = rotating_scene()
    single = [r for r in cs.ROUTES if r.startswith("bilinear_scatter:")]
    levels = {}      # grid function: [samples of each level, launches]

    def add_level(label, sizes, d):
        rec = levels.setdefault(label, [[], {}])
        rec[0].extend(sizes)
        for k, v in d.items():
            rec[1][k] = rec[1].get(k, 0) + v

    def delta(before):
        after = cs.launch_counts()
        return {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

    real_refine, real_initial = ec.grid_search_refine, ec.grid_search_initial

    def refine_(loss_fn, dims, *a, **kw):
        sizes = []

        def counted(P):
            sizes.append(P.shape[0])
            return loss_fn(P)

        before = cs.launch_counts()
        res = real_refine(counted, dims, *a, **kw)
        torch.cuda.synchronize()
        add_level("grid_search_refine", sizes, delta(before))
        return res

    zhu_sizes = []   # samples of each of zhu's loss chunks

    in_zhu = [False]

    def zhu_level():
        in_zhu[0] = True
        try:
            res = grid_search_initial(sx, sy, st, sp, linvel_warp(),
                                      zhu_timestamp_objective(), SENSOR,
                                      device=dev)
        finally:
            in_zhu[0] = False
        S, chunk = len(res["params"]), ec.batch_chunk(n, SENSOR)
        zhu_sizes[:] = [min(chunk, S - s0) for s0 in range(0, S, chunk)]
        return res

    def initial_(xs, *a, **kw):
        before = cs.launch_counts()
        res = real_initial(xs, *a, **kw)
        torch.cuda.synchronize()
        add_level("grid_search_initial" + ("(zhu)" if in_zhu[0] else ""),
                  [len(res["params"])], delta(before))
        return res

    bfgs_calls = []
    real_bfgs = ec.minimize_bfgs

    def bfgs_(vg, x0, **kw):
        bfgs_calls.append(tuple(x0.shape))
        return real_bfgs(vg, x0, **kw)

    lkw = dict(resolution=VIS_RES, img_size=SENSOR)
    rkw = dict(roi_size=ROT_ROI, img_size=ROT_SENSOR, maxiter=ROT_MAXITER,
               capacity=ROT_CAPACITY)
    drives = {
        "optimize_contrast_jit": lambda: optimize_contrast_jit(
            sx, sy, st, sp, linvel_warp(), variance_objective(),
            img_size=SENSOR, grid_search_init=True),
        "grid_search_optimisation": lambda: grid_search_optimisation(
            sx, sy, st, sp, linvel_warp(), variance_objective(), SENSOR,
            device=dev),
        "optimize_contrast": lambda: optimize_contrast(
            sx, sy, st, sp, linvel_warp(), variance_objective(),
            blur_sigma=1.0, img_size=SENSOR, grid_search_init=True),
        "grid_search_initial(zhu)": zhu_level,
        "landscape": lambda: ec._objective_landscape(
            vx, vy, vt, vp, variance_objective(minimum_events=1),
            linvel_warp(), device=dev, **lkw),
        "landscape, 200k events": lambda: ec._objective_landscape(
            sx, sy, st, sp, variance_objective(minimum_events=1),
            linvel_warp(), device=dev, **lkw),
        "grid_cmax_batched(solver='bfgs')": lambda: grid_cmax_batched(
            rx, ry, rt, rp, solver="bfgs", device=dev, **rkw),
        "grid_cmax_batched(full-frame objective)": lambda: grid_cmax_batched(
            rx, ry, rt, rp, obj=full_frame_variance(), device=dev, **rkw)}
    res, launches_of, walls = {}, {}, {}
    ec.grid_search_refine, ec.grid_search_initial = refine_, initial_
    ec.minimize_bfgs = bfgs_
    cs.reset_launch_counts()
    try:
        with route_calls(cs) as seen:
            for label, fn in drives.items():
                before = cs.launch_counts()
                res[label], walls[label] = synced(torch, fn)
                launches_of[label] = delta(before)
                log(f"  {label}: {walls[label]:.3f} s cold, launches "
                    f"{launches_of[label]}")
    finally:
        ec.grid_search_refine, ec.grid_search_initial = (real_refine,
                                                         real_initial)
        ec.minimize_bfgs = real_bfgs
    launches = cs.launch_counts()
    got = {k: v for k, v in launches.items() if v}
    log(f"batched launches: {got}; by the dispatch rules {seen['calls']}")
    if got != seen["calls"]:
        raise AssertionError(f"batched launches {got}, dispatch "
                             f"{seen['calls']}")

    # every grid level: one batched launch per chunk, no single splat
    for label, (sizes, d) in levels.items():
        # the loss's chunks of samples, each in its route's launches
        K = 4 if "zhu" in label else 1
        inner = min([cs.batched_chunk(k.split(":")[1], K, SENSOR[0] + 1,
                                      SENSOR[1] + 1)
                     for k in d if k.startswith("bilinear_scatter_batched")]
                    or [cs.BATCH_MAX_SAMPLES])
        L = ec.batch_chunk(n, SENSOR)
        want = sum(-(-min(L, S - s0) // inner) for S in sizes
                   for s0 in range(0, S, L))
        n_single = sum(d.get(r, 0) for r in single)
        n_batched = sum(v for k, v in d.items()
                        if k.startswith("bilinear_scatter_batched"))
        log(f"  {label}: {len(sizes)} levels of {sizes[0]} samples, "
            f"batched launches {n_batched} (levels x chunks {want}), single "
            f"{n_single}")
        if n_single or n_batched != want:
            raise AssertionError(f"{label}: {d}, want {want} batched")
    for label, S, n_ev in (("landscape", VIS_GRID ** 2, VIS_EVENTS),
                           ("landscape, 200k events", VIS_GRID ** 2, n)):
        d = launches_of[label]
        want = {"bilinear_scatter_batched:private":
                -(-S // ec.batch_chunk(n_ev, SENSOR))}
        if d != want:
            raise AssertionError(f"{label}: launches {d}, want {want}")
    for label in drives:
        if "grid_cmax" in label and any(launches_of[label].get(r)
                                        for r in single):
            raise AssertionError(f"{label}: single splats "
                                 f"{launches_of[label]}")
    # zhu's level: K = 4 past 227 KB, on the route its shape is sent to, in
    # that route's chunks of samples
    zr = cs.bilinear_batched_route(4, SENSOR[0] + 1, SENSOR[1] + 1, n,
                                   zhu_sizes[0])
    zhu_want = {f"bilinear_scatter_batched:{zr}": sum(
        -(-S // cs.batched_chunk(zr, 4, SENSOR[0] + 1, SENSOR[1] + 1))
        for S in zhu_sizes)}
    if launches_of["grid_search_initial(zhu)"] != zhu_want:
        raise AssertionError(f"zhu's level: "
                             f"{launches_of['grid_search_initial(zhu)']}, "
                             f"want {zhu_want}")
    # optimize_contrast_jit's single problem, then the ROI solve: one BFGS
    # over all R ROIs and, where ROIs overflow the capacity, one over the
    # overflow tier's rows (as JAX vmaps each tier's solver)
    R = len(res["grid_cmax_batched(solver='bfgs')"][0])
    if not (bfgs_calls[:2] == [(2,), (R, 2)] and len(bfgs_calls) <= 3
            and all(c[0] > 1 for c in bfgs_calls[1:])):
        raise AssertionError(f"BFGS calls {bfgs_calls}: want one for "
                             f"optimize_contrast_jit and one batched solve "
                             f"per tier of the ROI solve")

    # answers
    v_jit = np.asarray(res["optimize_contrast_jit"], np.float64)
    v_host = np.asarray(res["optimize_contrast"], np.float64)
    for label, v in (("optimize_contrast_jit", v_jit),
                     ("optimize_contrast", v_host)):
        err = float(np.abs(v - np.array(VELOCITY)).max())
        log(f"  {label}: v={v.tolist()} |err|max={err:.3f} px/s")
        if not err <= 4.0:
            raise AssertionError(f"{label} missed the planted velocity")
    land = res["landscape"]
    land_c = ec._objective_landscape(vx, vy, vt, vp, variance_objective(
        minimum_events=1), linvel_warp(), device="cpu", **lkw)
    land_err = float((land.cpu() - land_c).abs().max())
    big = res["landscape, 200k events"]
    loop = make_landscape_loop(torch, ec, sx, sy, st, sp, dev)
    big_err = float((big - loop).abs().max())
    peaks = []
    for img in (land, big):
        iy, ix = np.unravel_index(int(torch.argmax(img).cpu()), img.shape)
        peaks.append((float(ix * VIS_RES - 200.0), float(iy * VIS_RES
                                                          - 200.0)))
    log(f"  landscape: card vs CPU {land_err:.3e}; 200k events: batched vs "
        f"the per-sample loop on the card {big_err:.3e} (limit "
        f"{VIS_LAND_REL} of the [0, 1] range); peaks {peaks}, planted "
        f"{VELOCITY}")
    if not (land_err <= VIS_LAND_REL and big_err <= VIS_LAND_REL and all(
            abs(p[0] - VELOCITY[0]) <= VIS_RES
            and abs(p[1] - VELOCITY[1]) <= VIS_RES for p in peaks)):
        raise AssertionError(f"landscapes: {land_err}, {big_err}, {peaks}")
    rois = {}
    for label, limit in (("grid_cmax_batched(solver='bfgs')", FLOW_ERR_LIMIT),
                         ("grid_cmax_batched(full-frame objective)",
                          FULL_FRAME_ERR_LIMIT)):
        params, r_, _, valid = res[label]
        err, n_valid = flow_error(params, r_, valid)
        rois[label] = {"flow_err": err, "valid": n_valid}
        log(f"  {label}: median flow error {err:.3f} px/s over {n_valid} "
            f"ROIs (limit {limit})")
        if not (bool(torch.isfinite(params).all()) and err <= limit):
            raise AssertionError(f"{label}: flow error {err}")
    # card vs CPU on one corner of the scene (12 ROIs): the CPU solves the
    # whole scene's 108 in ~2 min
    corner = (rx < BATCH_CORNER[1]) & (ry < BATCH_CORNER[0])
    ckw = dict(rkw, img_size=BATCH_CORNER)
    cev = (rx[corner], ry[corner], rt[corner], rp[corner])
    p_card, _, _, v_card = grid_cmax_batched(*cev, solver="bfgs", device=dev,
                                             **ckw)
    t = time.perf_counter()
    p_cpu, _, _, v_cpu = grid_cmax_batched(*cev, solver="bfgs",
                                           device="cpu", **ckw)
    cpu_s = time.perf_counter() - t
    med = np.median(p_card.cpu().numpy()[v_card.cpu().numpy()], axis=0)
    med_c = np.median(p_cpu.numpy()[v_cpu.numpy()], axis=0)
    d_med = float(np.abs(med - med_c).max())
    log(f"  BFGS ROI solve on a {BATCH_CORNER} corner ({len(p_cpu)} ROIs): "
        f"median card {med.tolist()}, CPU {med_c.tolist()} ({d_med:.3f} "
        f"px/s apart, limit {BATCH_CPU_MED_TOL}; CPU {cpu_s:.1f} s)")
    if not d_med <= BATCH_CPU_MED_TOL:
        raise AssertionError(f"BFGS ROI solve: card vs CPU {d_med}")
    rois["grid_cmax_batched(solver='bfgs')"].update(
        median=med.tolist(), cpu_median=med_c.tolist(), cpu_s=cpu_s)

    # warm walls; device busy and idle shares of the short drives (the
    # ROI solves' thousands of launches are not profiled: one warm wall)
    timings = {}
    for label, fn in drives.items():
        roi = "grid_cmax" in label
        wall = float(np.median([synced(torch, fn)[1]
                                for _ in range(1 if roi else BATCH_REPS)]))
        timings[label] = {"wall_s": wall, "launches": launches_of[label]}
        if roi:
            log(f"  {label}: warm {wall:.4f} s; launches "
                f"{launches_of[label]}")
            continue
        busy, top = device_busy(torch, fn)
        timings[label].update(busy_s=busy, idle=1.0 - busy / wall, top=top)
        log(f"  {label}: warm {wall:.4f} s, busy {busy:.4f} s, idle "
            f"{1.0 - busy / wall:.3f}; launches {launches_of[label]}")
    out.update(levels=levels,
               landscape={"card_vs_cpu": land_err, "vs_loop_200k": big_err,
                          "peaks": peaks}, rois=rois, timings=timings,
               bfgs_calls=[list(c) for c in bfgs_calls])
    route_cases(torch, cs, records, seen, "batched")
    return launches, out


def make_landscape_loop(torch, ec, xs, ys, ts, ps, dev):
    """The landscape as this port evaluated it before it was batched: one
    loss, one single splat, per sample, on the card."""
    from event_utils_tpu_torch.contrast_max import (linvel_warp,
                                                    variance_objective)
    loss = ec.make_objective_loss(variance_objective(minimum_events=1),
                                  linvel_warp(), SENSOR, 0.0,
                                  iwe_impl="matmul")
    ev = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in (xs, ys, ts, ps))
    g = np.arange(VIS_GRID) * VIS_RES - 200.0
    with torch.no_grad():
        img = -torch.stack([loss(torch.tensor([vx, vy], device=dev), *ev)
                            for vy in g for vx in g]).reshape(VIS_GRID,
                                                              VIS_GRID)
    return (img - img.min()) / ((img.max() - img.min()) + 1e-6)


def turns_ms(torch, fns, reps):
    """Median device ms of each of ``fns`` ({name: fn}), one call of each
    in turns per round, each between two CUDA events, after a warm call of
    each: host gaps inside a call count."""
    for fn in fns.values():
        fn()
    ms = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms[name].append(a.elapsed_time(b))
    return {name: float(np.median(v)) for name, v in ms.items()}


def rng_uniform(seed, n, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


def bucketing_share(torch, rng):
    """Share of the tiled voxel route's wall that the host bucketing takes:
    warm medians over TILED_REPS calls of each, alternated, at VGA and
    720p (run after the launch counts are read)."""
    from event_utils_tpu_torch.contrast_max import bucket_events_by_roi
    from event_utils_tpu_torch.representations import events_to_voxel_tiled
    dev = torch.device("cuda")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name, (H, W) in TILED_SENSORS.items():
        xs, ys, ts, ps = voxel_events(rng, (H, W))
        ny, nx = -(-H // TILE[0]), -(-W // TILE[1])
        route = lambda: events_to_voxel_tiled(xs, ys, ts, ps, B, (H, W),
                                              device=dev)
        bucket = lambda: bucket_events_by_roi(
            xs, ys, ts, ps, (ny * TILE[0], nx * TILE[1]), TILE,
            capacity_cap=None, device=dev)
        route(), bucket()
        walls, buckets = [], []
        for _ in range(TILED_REPS):
            walls.append(wall(route))
            buckets.append(wall(bucket))
        w, b = float(np.median(walls)), float(np.median(buckets))
        log(f"  tiled route {name}: wall {w:.4f} s, host bucketing (with "
            f"its copies to the card) {b:.4f} s, share {b / w:.3f} "
            f"(medians of {TILED_REPS}, warm)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import event_utils_tpu_torch as P
    from event_utils_tpu_torch.ops import build
    from event_utils_tpu_torch.ops import cuda_scatter as cs

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from concurrent.futures import ThreadPoolExecutor

    from event_utils_tpu_torch import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:  # g++ builds libevio beside nvcc
        evio = ex.submit(native.library)
        build.build_all()
        evio.result()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_log}; g++ libevio {native.build_log})")

    rng = np.random.default_rng(SEED)
    records = {}
    floor_ms = kernel_phase(torch, cs, rng, records)
    torch.cuda.synchronize()

    cs.reset_launch_counts()
    with route_calls(cs) as seen:
        main_path(torch, P, rng)
    torch.cuda.synchronize()
    launches = cs.launch_counts()
    got = {k: v for k, v in launches.items() if v}
    log(f"main-path launches: {got}; by the dispatch rules {seen['calls']}")
    # every call launched the route that its shape is sent to, and every
    # route of this path launched: all but the one-block form of the
    # private bilinear kernel (sent no shape, see kernel_phase), the
    # batched vector and direct routes (the batched phase's: zhu's K = 4
    # stack) and the batched voxel routes (the voxel_batched phase's and
    # the trainers'). The single direct route takes grid_cmax's per-ROI
    # splats
    # and the streaming IWEs here
    # (route_calls counts no per-tile voxel call: tiles_phase and roi_path
    # hold those)
    if {k: v for k, v in got.items()
            if not k.startswith("voxel_tiles_scatter")} != seen["calls"]:
        raise AssertionError(f"main-path launches {got}, dispatch "
                             f"{seen['calls']}")
    off_path = {"bilinear_scatter:single",
                "bilinear_scatter_batched:vector",
                "bilinear_scatter_batched:direct",
                "voxel_scatter_batched:vector",
                "voxel_scatter_batched:direct",
                "voxel_scatter_batched:private"}
    missing = sorted(set(launches) - off_path - set(got))
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    # every route is held against its plain version (the one-block private
    # form among the private kernel's cases)
    held = set(launches) - {"bilinear_scatter:single"}
    if set(records) != held:
        raise AssertionError(f"routes not held against their plain "
                             f"version: {held ^ set(records)}")
    # the vector route at the shapes this path sent it, against its plain
    # version per pixel, timed beside the direct route on the same inputs
    route_cases(torch, cs, records, {"kept": {
        k: v for k, v in seen["kept"].items()
        if k[0] == "bilinear_scatter:vector"}}, "main path")
    batched_launches, batched = batched_phase(torch, cs, records)
    vb_launches, voxel_batched = voxel_batched_phase(torch, cs, records)
    serving_launches, serving = serving_phase(torch, cs, records)
    with tempfile.TemporaryDirectory(prefix=".smoke_sim_", dir=ROOT) as work:
        sim_launches, anchors = simulated_anchors_phase(torch, cs, records,
                                                        work)
        train_launches, training = training_phase(torch, cs, records, work)
        stream_launches, streaming = streaming_phase(torch, cs, records,
                                                     work)
        aug_launches, augmentation = augmentation_phase(torch, cs, records,
                                                        work)
        par_launches, parallel = parallel_phase(torch, cs, records, work)
        vis_launches, visualization = visualization_phase(torch, cs, records,
                                                          work)
    bucketing_share(torch, rng)

    kernels = []
    for name, rec in records.items():
        bound_ms, bound_by = rec["bound"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, SRC),
            "replaces": REPLACES[name.split(":")[0]],
            "launches": launches[name],
            "launches_batched": batched_launches[name],
            "launches_voxel_batched": vb_launches[name],
            "launches_serving": serving_launches[name],
            "launches_sim": sim_launches[name],
            "launches_train": train_launches[name],
            "launches_stream": stream_launches[name],
            "launches_aug": aug_launches[name],
            "launches_parallel": par_launches[name],
            "launches_vis": vis_launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": rec["library_ms"],
            "floor_ms": floor_ms,
            **{k: rec[k] for k in ("shape", "direct_ms", "cases")
               if k in rec}})
    print(json.dumps({"batched": batched}))
    print(json.dumps({"voxel_batched": voxel_batched}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"simulated_anchors": anchors}))
    print(json.dumps({"training": training}))
    print(json.dumps({"streaming": streaming}))
    print(json.dumps({"augmentation": augmentation}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"visualization": visualization}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


ROI_WALLS_FLAG = "--roi-bfgs-walls"


def roi_bfgs_walls(reps: int = 2) -> int:
    """``python3 chip_smoke.py --roi-bfgs-walls``: cold and warm walls of
    ``grid_cmax_batched(solver='bfgs')`` on the rotating scene on the
    card, with its launches and flow error, for the package beside this
    file; a copy of this file placed at the root of another checkout times
    that checkout (compare two in one call: A, B, B, A). Prints one JSON
    line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from event_utils_tpu_torch.contrast_max import grid_cmax_batched
    from event_utils_tpu_torch.ops import cuda_scatter as cs
    rx, ry, rt, rp = rotating_scene()
    dev = torch.device("cuda")

    def solve():
        return grid_cmax_batched(
            rx, ry, rt, rp, solver="bfgs", device=dev, roi_size=ROT_ROI,
            img_size=ROT_SENSOR, maxiter=ROT_MAXITER, capacity=ROT_CAPACITY)

    cs.reset_launch_counts()
    (params, rois, _, valid), cold = synced(torch, solve)
    launches = {k: v for k, v in cs.launch_counts().items() if v}
    warm = [synced(torch, solve)[1] for _ in range(reps)]
    err, n_valid = flow_error(params, rois, valid)
    print(json.dumps({"roi_bfgs_walls": {
        "root": ROOT, "cold_s": cold, "warm_s": warm, "launches": launches,
        "flow_err": err, "valid": n_valid, "card": card_line()}}))
    return 0


FEW_SPLAT_WALLS_FLAG = "--few-splat-walls"


def few_splat_walls(reps: int = 5) -> int:
    """``python3 chip_smoke.py --few-splat-walls``: cold and warm walls of
    the main path's host-loop ROI solver, ``grid_cmax`` on the 40x60 corner
    of the rotating scene (each loss evaluation one single splat of one
    ROI's ~2k events), with its launches, for the package beside this
    file; a copy of this file placed at the root of another checkout times
    that checkout (compare two in one call: A, B, B, A). Prints one JSON
    line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from event_utils_tpu_torch.contrast_max import grid_cmax
    from event_utils_tpu_torch.ops import cuda_scatter as cs
    sx, sy, st, sp = rotating_scene()
    corner = (sx < 60) & (sy < 40)

    def solve():
        return grid_cmax(sx[corner], sy[corner], st[corner], sp[corner],
                         roi_size=ROT_ROI, img_size=ROT_SENSOR)

    cs.reset_launch_counts()
    (params, _, _), cold = synced(torch, solve)
    launches = {k: v for k, v in cs.launch_counts().items() if v}
    warm = [synced(torch, solve)[1] for _ in range(reps)]
    print(json.dumps({"few_splat_walls": {
        "root": ROOT, "cold_s": cold, "warm_s": warm, "launches": launches,
        "params": np.round(np.array(params), 3).tolist(),
        "card": card_line()}}))
    return 0


TRAIN_WALLS_FLAG = "--train-walls"


def train_walls(reps: int = 3) -> int:
    """``python3 chip_smoke.py --train-walls``: ``train_flow --simulate``
    (the stage-9 recipe, TRAIN_FLOW_STEPS steps from the committed weights)
    and ``train_reconstruction --simulate`` (the stage-8 recipe,
    TRAIN_RECON_STEPS steps), no evals, one cold and ``reps`` warm runs
    each in this process, for the package beside this file; a copy of this
    file placed at the root of another checkout times that checkout
    (compare two in one call: A, B, B, A). Prints one JSON line: each
    run's steps/s, loop wall and the simulator's share of it."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from event_utils_tpu_torch.cli import train_flow, train_reconstruction
    runs = {"train_flow": [], "train_reconstruction": []}
    with tempfile.TemporaryDirectory(prefix=".smoke_sim_", dir=ROOT) as work:
        for _ in range(reps + 1):
            for name, res in (
                    ("train_flow", train_flow.main(TRAIN_FLOW + [
                        "--resume_params", FLOW_PARAMS, "--lr", "5e-6",
                        "--steps", str(TRAIN_FLOW_STEPS), "--seed",
                        str(TRAIN_SEED), "--eval_every", "0", "--params_out",
                        os.path.join(work, "flow.npz"), "--device",
                        "cuda"])),
                    ("train_reconstruction", train_reconstruction.main(
                        TRAIN_RECON + [
                            "--simulate", "--resume_params", RECON_PARAMS,
                            "--lr", "3e-5", "--lr_end", "3e-6", "--steps",
                            str(TRAIN_RECON_STEPS), "--seed",
                            str(TRAIN_SEED), "--eval_every", "0",
                            "--params_out", os.path.join(work, "recon.npz"),
                            "--device", "cuda"]))):
                runs[name].append({
                    "steps_per_s": res["steps"] / res["wall_s"],
                    "loop_wall_s": res["wall_s"],
                    "sim_share": res["sim_s"] / res["wall_s"]})
    print(json.dumps({"train_walls": {"root": ROOT, "runs": runs,
                                      "card": card_line()}}))
    return 0


STEP_PARITY_FLAG = "--step-parity"


def step_parity_runs(reps: int = 5) -> int:
    """``python3 chip_smoke.py --step-parity [N]``: the training phase's
    card-vs-CPU parity steps (``step_parity``) alone, N times (5 by
    default), each with its own trainers. Prints one JSON line with every
    run's weight gates (the 99% quantile over the determined coordinates,
    the max, the undetermined count and share) or its failure; exits 1 if
    any run failed."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from event_utils_tpu_torch._device import no_tf32
    from event_utils_tpu_torch.models import contrast_flow_loss
    from event_utils_tpu_torch.ops import set_default_impl
    from event_utils_tpu_torch.training import (FlowTrainer,
                                                ReconstructionTrainer,
                                                cosine_decay_schedule)
    from event_utils_tpu_torch.training import in_the_loop as itl
    runs = []
    for _ in range(reps):
        set_default_impl("pallas")
        try:
            with no_tf32():
                out = step_parity(torch, itl, contrast_flow_loss,
                                  FlowTrainer, ReconstructionTrainer,
                                  cosine_decay_schedule)
            runs.append({k: out[k] for k in ("flow_weights", "recon_weights",
                                             "recon_ema")})
        except AssertionError as e:
            runs.append({"failed": str(e)})
    print(json.dumps({"step_parity": {"card": card_line(), "runs": runs}}))
    return 1 if any("failed" in r for r in runs) else 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == DP_FLAG:   # a torchrun rank
        sys.exit(dp_rank_main(sys.argv[2:]))
    if sys.argv[1:] == [ROI_WALLS_FLAG]:
        sys.exit(roi_bfgs_walls())
    if sys.argv[1:] == [FEW_SPLAT_WALLS_FLAG]:
        sys.exit(few_splat_walls())
    if sys.argv[1:] == [TRAIN_WALLS_FLAG]:
        sys.exit(train_walls())
    if sys.argv[1:2] == [STEP_PARITY_FLAG]:
        sys.exit(step_parity_runs(*(int(a) for a in sys.argv[2:3])))
    sys.exit(main())
