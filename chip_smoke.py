#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its wall time and raising on failure:

1. device: a CUDA card is required; prints nvidia-smi's name and power limit;
2. build: compiles the port's CUDA kernels from ``csrc/`` with nvcc;
3. cuda_tests: ``tests/test_torch_cuda.py`` (every ``cuda``-marked test of
   the repo, jax-free) under pytest from the repo root, with the kernels
   just built; fails on a non-zero exit, on any skip or on no test;
4. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, in the main path's types, with times of the kernel, the
   plain version and a library yardstick, and its bound; the narrow layer's
   two bodies (``csrc/convlstm_narrow_hopper.cu``'s persistent body, the
   plan's in bfloat16 compute, and ``csrc/convlstm_narrow.cu``'s mma.sync
   body) at the main path's pixel layer, the grayscale stack's narrow
   layers, a narrow top layer and the north star's pixel layer, each within
   one ulp at each rounding point of the rounded float64 chain, the
   persistent body's rows bit-equal across batch, tile and grid, float32
   compute (the mma.sync body) against float64 sums, and odd widths at
   every plan, timed beside the route they replaced (cuDNN convs, upsample,
   adds, gate kernel) as the yardstick; the True route's gate convs
   (``convlstm_narrow.gate_convs``: ``csrc/gate_convs_wgmma.cu``'s wgmma
   body at C >= 32, asserted by launches by body, the mma.sync body at the
   pixel layer) at the main path's and the north star's four layers
   against the cuDNN convs they replaced and the float64 chain, timed beside
   the mma.sync body, cuDNN and the bound; the gate kernel
   (``csrc/lstm_gates.cu``'s scalar, vector and slab bodies) at the main
   path's pixel layer in both its contracts (the main path's bfloat16 one
   and the JAX function's float32 one), its s2d pixel layer and True-route
   layers 1-3, the True route's four north-star layers and the north
   star's s2d pixel layer
   (``scripts/gates_breakdown.py``'s shapes): the plan's body (asserted by
   launches by body) against the plain version and bit-equal to the scalar
   body, both timed as CUDA graph replays beside the eager gate math, the
   plain version, the bytes bound and each body's issue bound (its SASS
   loop's instructions an element at the SM clock under load); then every
   body that takes the call bit-equal to the scalar body at C
   1/3/8/12/48/96/192, every type, odd pixel counts and views off
   alignment; the fused
   kernel per layer at the main path's and the north star's shapes: its
   wgmma body (asserted by the wrapper's launches by body) against the plain
   version and float64 sums, with its TFLOP/s (CUDA events) beside its
   mma_sync body's, the library's and the plain version's times, each
   channel group timed at the main path; and at ragged shapes at every
   plan of both bodies and a source off its alignment; the A and Ahat
   units' kernels (``csrc/prednet_units_wgmma.cu``'s wgmma and im2col
   bodies, ``csrc/prednet_units.cu``'s mma.sync and direct bodies) at the
   main path's and the north star's four layers, the grayscale pixel layer
   and an odd shape, against their plain versions (and float64 sums: in
   float32 compute no further from them than the plain version, in
   bfloat16 compute within one ulp of the rounded float64 chain), each on
   the body of its shape's plan (counted by body: in bfloat16 compute every
   layer of C >= 8 on the wgmma body), with the times of the kernel, of its
   mma.sync body (the kernel before the wgmma bodies), the plain version
   (the cuDNN conv and eager ops they replaced), cuDNN's conv with its bias
   and the eager ops (each call replayed as a CUDA graph), and the bound;
5. reference: the port's rollout on the card against the same rollout on
   the CPU (plain versions) on a small input with the bundled weights;
6. main path: ``neat_illusion`` for two generations at the full width of the
   bundled color predictor (3,48,96,192), 160x120, the ``circles`` preset;
   asserts the kernel launch counts (a step: the narrow kernel, three fused
   launches, four Ahat and three A units), finite fitness, two generations;
7. load: two generations at the ``default_color`` run preset's shape
   (CirclesFree, 320x240, pop 40, repeat 5);
8. cli: the port's CLI (``cli.main``) for two generations at the main
   path's shape with its artifacts and a ``profile_dir`` trace; asserts the
   launch counts, finite fitness, the four PNGs (decoded by the port's
   reader), ``best.png`` against the winner's rendered row, the overlay
   colour at the winner's vectors, and the trace's kernel events; logs
   the seconds ``save_best_artifacts`` takes a generation; keeps the
   ``best.png`` it wrote for the probe;
9. probe: the single-image probe (``evolution/probe.py``) on that
   ``best.png`` at the color predictor's full width, 160x120:
   ``get_vectors`` and ``score_image`` with their seconds, then the
   reference's file bus on the same image and model (``compat.test_prednet``
   writing the frames as PNGs, ``compat.lucas_kanade`` reading them), whose
   vectors must equal the probe's; asserts the launch counts;
   analysis: the ports of the repo-root analysis and gallery scripts
   (``scripts/``), each through its ``main``: ``period_response`` at the
   bundled grayscale stack's full width (1,16,32,64, nine periods,
   160x120, bfloat16) against the port's CPU run of the same script (the
   flow frames in the mean, as the reference phase holds 22 steps), with
   its launches by wrapper and body (the narrow kernel's persistent and
   mma.sync bodies, the fused kernel's wgmma body, the units); a stand-in
   rated directory in the reference's layout (mode L and RGB PNGs from
   the cli phase's ``best.png`` and the rings, a uniform grey control that
   must score 0.0) through ``probe_rated`` as is, with ``--s2d`` (22
   gate-kernel launches a stimulus), ``--int8`` (no launch) and
   ``--lk_bf16``, ``compare_probes``, ``probe_breakdown``,
   ``field_anatomy --color``, ``drift_diag`` and ``cache_probe_vectors``
   (a temporary cache whose ``sha/`` keys are the bundled files'); then
   ``make_gallery circles_bw`` whole (30 generations, pop 24) into a
   temporary ``GALLERY``: the artifact contract, finite fitness, each
   eager chunk's launches; logs each step's seconds;
   options: the predictor's options at the main path's shape with the
   bundled weights: ``s2d_l0``, ``subpixel_up`` and ``prednet_int8`` each
   through ``neat_illusion`` for two generations (22 gate and 66 fused
   launches a generation under s2d and subpixel, whose pixel layer keeps the
   gate kernel, with 66 Ahat and 44 A units under s2d, whose pixel layer
   keeps its lifted convs, 88 and 66 under subpixel; none under int8;
   finite fitness; s/generation)
   and one step of each on the card against the port on the CPU (the
   reference phase's rules); the main path with the program cache (CUDA
   graph replay, the default) and without it for four generations each,
   vectors, masks and fitness bit-equal, the last generation replayed, the
   launch counts equal in the generations both ran eagerly, with
   s/generation at generations 1-3 (warm-up, capture, replay);
   ``debug_nans=True``: a clean generation with the fitness of the run
   without it, then NaNs planted in layer 2 raising ``FloatingPointError``
   naming ``fused_convlstm_layer_multi``: in ``lstm_b`` at an op inside its
   wrapper, in the packed ``lstm_k_r`` (read only by the kernel) at the
   wrapper's check of the kernel's outputs; the probe's ``--int8`` and
   ``--s2d`` on the cli phase's ``best.png``;
10. scorers: one generation at the ``default_color`` shape (pop 40) with
   each scoring back end (``score_backend="numpy"``, ``"native"``,
   ``score_on_device=True``): asserts the C++ scorer was built here, holds
   the native scores to numpy's and the device scores to float64 host
   scores of the same vectors (with the same ranking), and logs each one's
   ``last_timings``;
11. train: the PredNet trainer (``models/prednet/pretrain.py``) at full
   width (3,48,96,192, 160x120, batch 8, 10 open + 4 closed frames) with
   the colour stack's shipped recipe, warm-started from the bundled
   weights: ``pretrain.main`` for a few steps with a checkpoint, the same
   recipe killed after its checkpoint and resumed (weights equal bit for
   bit), every parameter moved, ``main`` turns TF32 off, the first step's
   loss and params against the port's CPU run (the second step's, and TF32
   on, logged only), one ``data="v2"`` step; logs s/step, data ms per batch
   and the peak device memory; asserts that no kernel was launched;
12. parallel: ``parallel/`` on a mesh that repeats cuda:0 (one logical
   shard per entry): the sharded evaluator at the main path's shape for
   three generations (program cache on and off), bit-equal to the unsharded
   evaluator (images, flow frames, vectors, masks, fitness), with 22
   narrow, 66 fused, 88 Ahat-unit and 66 A-unit launches per shard's eager
   pass, and the same on the ``use_pallas=True`` route (88 gate-conv
   launches a shard's pass, 66 on the wgmma body and 22 on the mma.sync
   body, and 88 gate-kernel launches)
   (on two real devices too where the machine has them, else one line
   says it could not); one data-parallel step of the train phase's recipe
   on two shards against one device (the train phase's rules); a spatial
   rollout at 1280x960 (sp 2) and a four-stage pipelined rollout at
   160x120 against the unsharded plain rollout (one step tightly, 22 in
   the mean; no kernel launched), with seconds and peak memory, and the
   spatial rollout with int8 params against the unsharded int8 rollout
   (one step bit-equal, 22 in the mean); two processes on cuda:0 over
   gloo, each evaluating half a population, whose fitness must equal the
   single-process evaluator's bit for bit on both ranks; then two processes
   running the
   data-parallel step, the spatial rollout (float and int8 params) and the
   pipelined rollout over meshes that span both (``parallel_paths``),
   against the one-process runs: the step and the float spatial rollout
   bit-equal, int8 and the pipeline one step bit-equal and 22 steps in the
   mean;
13. composition: the ``pop256_v5e8`` run preset as it stands (pop 256,
   1280x960, 3,48,96,192, global chunks of 64) through
   ``graft_entry.composition`` on the fused route over a mesh of cuda:0 x
   8: one generation, its checkpoint and the resumed generation; logs the
   fused kernel's plan at each fused layer, s/generation with its
   eager, captured and replayed shard passes, the peak device memory, the
   launches and the best fitness; fails on a non-finite fitness, a best
   fitness of 0 or launch counts that are not 22 narrow, 66 fused, 88
   Ahat-unit and 66 A-unit per eager pass;
   north_star: the generation evaluator at the north star (pop 100,
   640x480, Free, 3,48,96,192, chunks of 25) for four generations, with
   s/generation, ``last_timings``, peak memory, the fused kernel's plans
   and the launches; ``scripts/phase_bench.py`` (render / rollout /
   flow / host parts of one chunk) and ``scripts/rollout_profile.py`` (the
   rollout's kernels, dense and s2d pixel layer, and their device time by
   wrapper; the dense rollout may run no library conv); one step at the
   chunk, each layer's kernels (ConvLSTM, Ahat and A units) against their
   plain versions; fails on a non-finite fitness, wrong launch counts or a
   kernel off its plain version;
14. profile: device time by kernel and the number of kernel launches over
   one warm main-path generation, replayed as a CUDA graph (the default)
   and run eagerly (``program_cache=False``), with the device time by
   wrapper; in both the trace must hold 22 narrow and 66 fused kernels of
   the wgmma body, the units' 66 wgmma and 22 direct Ahat kernels and 44
   wgmma and 22 im2col A kernels, no library conv (cuDNN's A and Ahat convs
   are gone), and no gate kernel and no kernel of the fused kernel's or the
   units' mma.sync bodies, which in the replay
   no wrapper launched (the graph recorded them at its capture), and the
   eager pass no upsampled copy of layer 1's R (the narrow kernel reads it
   at half resolution);
15. bisect: the kernel-bisection ladder (``scripts/kernel_bisect.py``) at
   its north-star layer-1 shape (``--big --rows 48``, all ten rungs);
   asserts each rung's launch count, then holds each of the seven rung
   kernels against its plain version on the card (A also at ragged counts
   and offsets, exactly; its time and kernel duration beside
   ``torch.mul``'s) and times the kernel (with its TFLOP/s), its host glue
   (padding, window stack), the plain version and a library yardstick (and
   cuDNN's conv alone); holds the six conv rungs (C, D, H, E, I and J, one
   wgmma kernel) against float64 sums on two images, and against their
   plain versions at the tests' ragged, wide, odd-rows and cp.async-windows
   shapes; logs E's and J's times beside D's.

Every phase that reads the wrappers' launch counts fails if a fused layer
took the fused kernel's mma_sync body (``_counts``), and if a dense
"fused" step ran a cuDNN A or Ahat conv in place of a unit's kernel, or a
unit or the narrow layer took another body than its layer and compute
dtype give (the counts by body, ``_path_launches``: in bfloat16 compute no
mma.sync body).

Then one JSON line with every kernel's numbers (its launches summed over
the main path, cli, probe, analysis, options, scorers, train, parallel,
composition, north_star and bisect phases; the units both whole and by new body,
``"ahat_error_unit/wgmma"``, ``"a_unit/wgmma"``, ``"a_unit/im2col"``, and
the narrow layer whole and by body, ``"narrow_convlstm_layer/persistent"``,
``"narrow_convlstm_layer/mma_sync"``), and
as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a card or without the port beside it.
"""

import contextlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

WATCHDOG_S = 1000  # the whole run, build included, must end well inside this

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# main path shapes: chunk of 8 candidates at 160x120, channels 3,48,96,192
MAIN_BATCH = 8
MULTI_LAYERS = (  # (H, W, C, source channels [E, R, up(R_above)])
    (60, 80, 48, (96, 48, 96)),
    (30, 40, 96, (192, 96, 192)),
    (15, 20, 192, (384, 192)),
)
SINGLE_LAYER = (60, 80, 48, (240,))  # layer 1's concatenated input
# the north star's fused layers at its chunk of 25 (640x480): (H, W, C, sources)
NORTH_STAR_LAYERS = (
    (240, 320, 48, (96, 48, 96)),
    (120, 160, 96, (192, 96, 192)),
    (60, 80, 192, (384, 192)),
)
# the fused kernel's c against float64 sums: on the main path's whole chunk,
# and on this many images of a north-star layer (a float64 conv of its chunk
# of 25 takes seconds)
DRIFT_IMAGES = 2
# (B, H, W, source channels, C, state dtype name) held against the plain
# version at every plan: the wgmma body where every source's channels are a
# multiple of 8, else the mma_sync body
RAGGED_CASES = (
    (2, 13, 21, (40,), 24, "float32"),
    (2, 13, 21, (40, 12), 24, "bfloat16"),
    (2, 13, 21, (40, 12, 24), 24, "float32"),
    (2, 13, 21, (12, 40, 24), 24, "bfloat16"),
    (2, 13, 21, (40, 8, 24), 24, "float32"),
    (2, 13, 21, (40, 8, 24), 24, "bfloat16"),
)
# the wgmma plans (cg, (tile_h, tile_w, wg_stride)) the ragged cases are
# held at beside the plan's own: every channel group (C 24 masks 8 or 24 of
# 32 or 48), a row of 64 a warpgroup, and run-on tiles 2, 7 and 21 wide (an
# odd tile count: a cluster's padding block)
RAGGED_PLANS = tuple((cg, tile) for cg in (16, 32, 48)
                     for tile in ((2, 64, 66), (32, 2, 64), (14, 7, 64), (5, 21, 64)))
STEPS = 22  # 20 open-loop + 2 closed-loop steps per chunk
# the narrow layer's kernel, (B, H, W, C, C_above): the main path's pixel
# layer, the grayscale stack's (1,16,32,64) pixel layer and layer 1, a
# narrow top layer; then odd widths (a coarse width of 19; R_above of 12
# channels, staged element by element; no R_above at an odd H and W)
NARROW_SHAPES = {
    "main": (MAIN_BATCH, 120, 160, 3, 48),
    "gray_pixel": (MAIN_BATCH, 120, 160, 1, 16),
    "gray_layer1": (MAIN_BATCH, 60, 80, 16, 32),
    "top": (MAIN_BATCH, 30, 40, 3, None),
}
NARROW_ODD = ((3, 26, 38, 3, 48), (2, 14, 22, 16, 12), (2, 9, 13, 1, None))
# the north star's pixel layer at its chunk of 25
NARROW_NORTH_STAR = (25, 480, 640, 3, 48)

# the A and Ahat units' kernels, (H, W, C, C_above or None) per layer: the
# main path's at its chunk of 8 and the north star's at its chunk of 25;
# then the grayscale stack's pixel layer and an odd shape (odd H and W, C
# not a multiple of 4), each at a chunk of 8
UNIT_LAYERS = ((120, 160, 3, 48), (60, 80, 48, 96), (30, 40, 96, 192), (15, 20, 192, None))
NORTH_STAR_UNIT_LAYERS = ((480, 640, 3, 48), (240, 320, 48, 96), (120, 160, 96, 192),
                          (60, 80, 192, None))
UNIT_ODD = ((120, 160, 1, 16), (13, 21, 12, 20))
# per step at 3,48,96,192: an Ahat unit on every layer, an A unit below the top
UNITS_PER_STEP = (4, 3)
UNIT_SOURCES = {
    "ahat_error_unit": "evolutionary_illusion_generator_tpu/models/prednet/model.py:729",
    "a_unit": "evolutionary_illusion_generator_tpu/models/prednet/model.py:748",
}

# The units' kernels against their plain versions (cuDNN's bfloat16 conv
# and eager ops): the same products summed in another order, so a sum may
# round the other way, one bfloat16 ulp at a rounding point.  cuDNN's
# bfloat16 conv is itself more than one ulp off the rounded float64 conv on
# a few elements in 100,000 (3.7e-5 of the north star's layer 3 on the
# H100, against 4.6e-6 for the kernel): there the two may part by two.
# The kernel itself is held within one ulp at each rounding point of the
# rounded float64 chain on all but this share of the elements.
UNIT_BEYOND_SHARE = 1e-4

# kernel vs plain version, both at bf16 inputs with float32 sums:
GATES_TOL = 1e-5  # float32 elementwise math, last-ulp differences
# bfloat16 h and c: those differences flip a rounding now and then, by one
# bfloat16 ulp; a wrong rounding mode or a wrong element flips far more
GATES_DIFF_SHARE = 0.01
# the gate kernel's bodies held bit-equal to the scalar body at these C and
# odd pixel counts (7 x 9, and 63 x 8 + 5: several slabs), every type; its
# times are CUDA graph replays of this many calls
GATES_CHANNELS = (1, 3, 8, 12, 48, 96, 192)
GATES_ODD_PIXELS = (63, 509)
GATES_ITERS = 20
H_TOL = 1e-2  # bfloat16 h: one rounding flip is 2**-8 at |h| < 1
C_TOL = 1e-3  # float32 c after sums of up to 9 * 576 products
# The port on the card vs on the CPU (bf16 params, state and compute).
# One step from a nonzero state: float32 sums taken in another order flip
# the bfloat16 rounding of a few elements by one ulp (2**-8 relative, so
# 7.8e-3 at |x| < 4); a wrong kernel differs nearly everywhere.
STEP_ATOL = 1.6e-2
STEP_DIFF_SHARE = 0.01
# 22 steps: the recurrence amplifies those one-ulp flips step after step,
# so the rollout is held only in the mean; the phase prints, beside it, how
# far the CPU drifts from itself when only the order of the fused layers'
# float32 sums changes.
ROLLOUT_MEAN_TOL = 2e-2

# the gate kernel's layers (H, W, C) in the north star's rollout_profile runs
# (--s2d, --use_pallas): none on the dense default route
NORTH_STAR_GATE_LAYERS = {("0", "fused"): (), ("1", "fused"): ((240, 320, 12),),
                          ("0", "true"): ((480, 640, 3), (240, 320, 48), (120, 160, 96),
                                          (60, 80, 192))}

# the cuda-marked tests, run by pytest on the card
CUDA_TESTS = "tests/test_torch_cuda.py"
CUDA_TESTS_TIMEOUT_S = 300
# the cli phase's run: the main path's shape, artifacts and a profiled
# generation 1 (one chunk of 8, so 22 narrow, 66 fused, 88 Ahat-unit and 66
# A-unit launches)
CLI_ARGS = ["-s", "1", "--generations", "2"]
CLI_SHAPE = (120, 160, 3)
OVERLAY_RED = (255, 0, 0)
# the trace's kernel names, demangled: the units' bodies apart (the pixel
# layer's Ahat unit on the CUDA cores, its A unit on the im2col body, the
# other layers on the wgmma bodies; no mma.sync body)
TRACE_KERNELS = {"narrow_convlstm_layer/persistent": ("convlstm_narrow_persistent_kernel", STEPS),
                 "narrow_convlstm_layer/mma_sync": ("convlstm_narrow_kernel", 0),
                 "gate_convs": ("gate_convs_kernel", 0),
                 "gate_convs/wgmma": ("gate_convs_wgmma_kernel", 0),
                 "fused_convlstm_layer_multi": ("convlstm_fused_wgmma_kernel", STEPS * 3),
                 "ahat_error_unit/wgmma": ("::ahat_error_unit_wgmma_kernel<", STEPS * 3),
                 "ahat_error_unit/direct": ("::ahat_error_unit_kernel_direct<", STEPS),
                 "ahat_error_unit/mma_sync": ("::ahat_error_unit_kernel<", 0),
                 "a_unit/wgmma": ("::a_unit_wgmma_kernel<", STEPS * 2),
                 "a_unit/im2col": ("::a_unit_im2col_kernel<", STEPS),
                 "a_unit/mma_sync": ("::a_unit_kernel<", 0),
                 "fused_lstm_gates": ("lstm_gates_kernel", 0),
                 "fused_lstm_gates/vector": ("lstm_gates_vector_kernel", 0),
                 "fused_lstm_gates/slab": ("lstm_gates_slab_kernel", 0),
                 "convlstm_fused (mma_sync body)": ("convlstm_fused_kernel", 0)}
# the probe phase: the color predictor at full width on the cli phase's
# best.png, two probe rollouts and one file-bus rollout
PROBE_CHANNELS = (3, 48, 96, 192)
PROBE_ROLLOUTS = 3
# the options phase: the predictor's options at the main path's shape, and
# the program cache on and off over PROGRAM_GENERATIONS generations.  The
# population grows from 5 to 10 after generation 0, so its chunk from 8 to
# 16: generation 1 is the eager warm-up of the larger key, 2 its capture,
# 3 a replay
OPTIONS = (("s2d_l0", dict(s2d_l0=True)), ("subpixel_up", dict(subpixel_up=True)),
           ("prednet_int8", dict(prednet_int8=True)))
PROGRAM_GENERATIONS = 4
# the scorers phase: the default_color shape, one generation per back end
SCORER_BACKENDS = (("numpy", dict(score_backend="numpy")),
                   ("native", dict(score_backend="native")),
                   ("device", dict(score_on_device=True)))
SCORER_STEPS = 5 + 2
# The C++ scorer against numpy: the same float64 math in another summation
# order, contracted into FMAs under -march=native, so the last bits differ
# (9e-15 measured on the CPU); the JAX package's own test holds it so.
NATIVE_ATOL = 1e-12
# float32 device scores against float64 host scores, with the same ranking
# (the JAX package's tests/test_device_scoring.py)
DEVICE_RTOL, DEVICE_ATOL = 1e-3, 1e-5
# the train phase: the colour stack's shipped recipe (weights/README.md: the
# v6ab tail of scripts/campaign_r5o.sh plus the color v9L stage's hinge and
# ring scale) at full width, warm-started from the bundled weights; a few
# steps with a checkpoint and one resume
TRAIN_RECIPE = ["--channels", "3,48,96,192", "--batch", "8", "--frames", "10",
                "--height", "120", "--width", "160",
                "--regime_probs", "0,0.25,0.2,0.15,0.2,0.2,0", "--ring_speed", "1.2,2.0",
                "--onset_range", "9,11", "--closed_frames", "4", "--closed_weight", "5",
                "--ring_dir_cue", "--ring_onset_range", "10,10", "--ring_mask_prefix",
                "--cue_speed", "0.10,0.14", "--cue_period", "6,40",
                "--ring_closed_scale", "0.75", "--cue_motion_weight", "0.0625"]
TRAIN_STEPS = 4
TRAIN_SAVE_EVERY = 2
# The card against the port's CPU run of the same seed and shape, both in
# full float32 (pretrain turns TF32 off on the card): the frames are made
# on each device (float32 rounding apart) and cuDNN sums in another order
# than the CPU, over 14 recurrent steps.  The first step's loss (the
# forward pass) within TRAIN_LOSS_RTOL: TF32 alone moves it by about 5e-5,
# a dropped or wrong term by far more.  The bfloat16 params after that
# step (the backward): Adam's first update is lr times the gradient's sign
# wherever |g| >> eps, so they hold the sign of every gradient entry.  An
# entry may differ where a sign flips under reordering (|g| near zero) or
# a sum lands on a rounding boundary: on at most TRAIN_FLIP_SHARE of a
# tensor's entries (or one entry), by at most one bfloat16 ulp plus 2 lr.
# The second step's loss and params are logged only: there the reordered
# sums of the first update move the loss by about as much as TF32 does.
TRAIN_CHECK_STEPS = 2
TRAIN_LOSS_RTOL = 1e-5
TRAIN_FLIP_SHARE = 1e-2

# the bisection ladder at its --big shape; every rung runs 1 + 10 * (1 + 5)
# times (check, warm loop, timed loops)
BISECT_ARGS = ["--big", "--rows", "48", "--variants", "ABCDHEIJFX"]
BISECT_ROWS = 48
BISECT_GATES_TOL = 1e-3  # C's float32 gates: sums of 2,160 products, another order
BISECT_RUNGS = {  # ladder key -> (kernel name, line of the Pallas function)
    "A": ("variant_A", 65), "C": ("variant_C", 104), "D": ("variant_D", 151),
    "H": ("variant_H", 192), "E": ("variant_E", 245), "J": ("variant_E2", 300),
    "I": ("variant_H2", 365),
}
WGMMA_RUNGS = "CDHEIJ"  # in csrc/bisect_wgmma.cu; A in csrc/convlstm_bisect.cu
# ((B, H, W, Cin, C), rows) of tests/test_torch_bisect.py's ragged, wide,
# odd-rows and cp.async-windows shapes, and a Cin that is not a multiple of
# 8 with a C that is not a multiple of 4: the six conv rungs against their
# plain versions on the card at every channel-group width (N 64, 192 and
# 128), both main loops (TMA, cp.async), both ways of each epilogue (C's
# 16-byte or 4-byte stores, the c_prev tile staged or read in place), and
# for the row-block rungs windows of odd `rows` (a row pair whose second row
# is past its window) through the TMA (rows 3, 7 windows) and the cp.async
# loop (rows 5, one window and three)
BISECT_SHAPES = (((2, 16, 20, 24, 8), 8), ((2, 24, 70, 40, 72), 8), ((2, 5, 66, 12, 18), 5),
                 ((2, 21, 70, 40, 18), 3), ((2, 15, 66, 12, 18), 5))


def log(msg):
    print(msg, flush=True)


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            log(f"[{name}] {time.time() - t0:.2f} s")
            return out
        return run
    return wrap


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warmup=3):
    """The device time of one call of ``fn``: the durations of the kernels
    it launches, summed over ``iters`` calls under torch.profiler and
    divided by ``iters``.  Unlike :func:`cuda_ms`, whose events bracket the
    calls and so take the host's call rate where a call's kernels are
    shorter than its host work, the gaps between kernels are not in it.  A
    kernel's duration ends before the L2 has written its last dirty lines
    back, so for a kernel that writes more than the L2 holds it is short of
    the work; time that one with :func:`cuda_ms`.  In some whole script
    runs (rung A's timing in the bisect phase, after every earlier phase
    had profiled) the profiler handed back no device event, in two windows
    in a row; such a window is logged and profiled once more, and after a
    second empty one the time is taken with CUDA events (:func:`cuda_ms`,
    logged as such) and the kernels per call are NaN.
    Returns (ms, kernels launched per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evolutionary_illusion_generator_tpu_torch.utils.profiling import device_events

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_events(prof, torch.device("cuda"))
        if kernels:
            break
        log("  device_ms: torch.profiler recorded no device kernel; profiling once more")
    else:
        ms = cuda_ms(fn, iters)
        log(f"  device_ms: torch.profiler recorded no device kernel again; {ms:.4f} ms from "
            f"CUDA events instead")
        return ms, math.nan
    return (sum(us for _, _, us in kernels) / iters / 1e3,
            sum(n for _, n, _ in kernels) / iters)


def graph_ms(fn, iters, warmup=3):
    """The device time of one call of ``fn``, for calls of several kernels
    (torch.profiler dropped some of them: it kept 5 of 20 single-kernel
    calls in one window on an H100, and scaling the kept ones biased the
    yardsticks): after ``warmup`` eager calls (cuDNN chooses its algorithms
    there), ``fn`` is captured once into a CUDA graph, which is replayed
    ``iters`` times between CUDA events.  The host launches one graph a
    call, so the time is the device's: the call's kernels back to back,
    with the graph's short gaps between them.  A call that cannot be
    captured raises."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


def bound_ms(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@phase("device")
def check_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    from evolutionary_illusion_generator_tpu_torch.utils.profiling import card_line

    card = card_line(torch.device("cuda"))
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    # float32 convs and matmuls in full float32 wherever the plain versions
    # are compared (cuDNN would otherwise use TF32 for float32 convs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def _entry_name(mangled):
    """A kernel's name and its mangled template arguments from its mangled
    name: the last source name (``<length><name>``, digits allowed inside
    it) that holds ``kernel``."""
    found = ""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group(0)
        for k in range(1, len(digits) + 1):
            length = int(digits[-k:])
            name = mangled[m.end():m.end() + length]
            if len(name) == length and "kernel" in name and re.fullmatch(r"[A-Za-z_]\w*", name):
                rest = mangled[m.end() + len(name):]
                args = re.match(r"I\w*?E(?=Ev|E)", rest)
                found = name + (args.group(0) if args else "")
    return found or mangled


@phase("build")
def build():
    from evolutionary_illusion_generator_tpu_torch import _build

    _build.library()
    kernel = ""
    for line in _build.build_log().splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        wgmma = re.search(r"\((C7517|C7518)\).*function '(\w+)'", line)
        if entry:
            kernel = _entry_name(entry.group(1))
        elif wgmma:  # ptxas waited for, or serialised, a kernel's wgmma products
            log(f"  ptxas {_entry_name(wgmma.group(2))}: {line.split(':', 1)[-1].strip()[:160]}")
        elif ("registers" in line or "spill" in line) and "(C7519)" not in line:
            log(f"  ptxas {kernel}: " + line.split(":", 1)[-1].strip())


@phase("cuda_tests")
def cuda_tests():
    """The repo's ``cuda``-marked tests on the card.  A missing pytest is a
    failure, as is a skip: here every test has its card."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
         "-rs", CUDA_TESTS],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=CUDA_TESTS_TIMEOUT_S,
    )
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    counts = {k: int(n) for n, k in re.findall(r"(\d+) ([a-z]+)", summary)}
    if proc.returncode != 0 or set(counts) != {"passed"} or not counts["passed"]:
        raise AssertionError(f"cuda_tests: pytest exit {proc.returncode}, {summary!r}\n"
                             f"{proc.stdout[-6000:]}\n{proc.stderr[-3000:]}")
    log(f"  {CUDA_TESTS}: {counts['passed']} passed ({summary})")
    return counts["passed"]


def _layer_inputs(gen, params, layer, H, W, cins, B=MAIN_BATCH):
    """Sources, kernel weights, bias and c_prev at one layer's shape, with
    the bundled weights of that layer."""
    import torch

    p = params[layer]
    C = p["ahat_w"].shape[0]
    srcs = [torch.rand(B, H, W, ci, device="cuda", generator=gen)
            .mul_(2).sub_(1).bfloat16() for ci in cins]
    wks = [p[k] for k in ("lstm_k_e", "lstm_k_r", "lstm_k_up") if k in p]
    if len(cins) == 1:  # the single-source kernel takes the whole gate kernel
        wks = [torch.cat(wks, dim=3).contiguous()]
    c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()
    return srcs, wks, p["lstm_b"], c_prev


def _gate_flops(H, W, cins, C, B=MAIN_BATCH):
    return 2.0 * B * H * W * 9 * sum(cins) * 4 * C


def _plan_str(p):
    """A fused-kernel plan in a log line."""
    if p.body == "wgmma":
        return f"wgmma cg {p.cg} tile {p.tile_h}x{p.tile_w}"
    return f"mma_sync tw {p.tile_w}"


def _gates_err(out, ref):
    """Max abs error of (h, c) against the plain version's, and whether it
    is within GATES_TOL plus, for bfloat16 outputs, one bfloat16 ulp (at most
    2**-7 of the value) with at most GATES_DIFF_SHARE of the elements off."""
    import torch

    err, ok = 0.0, True
    for got, want in zip(out, ref):
        d = (got.float() - want.float()).abs()
        tol = GATES_TOL
        if want.dtype == torch.bfloat16:
            tol = tol + want.float().abs() * 2.0**-7
            ok = ok and (d > 0).float().mean().item() <= GATES_DIFF_SHARE
        ok = ok and got.dtype == want.dtype and bool((d <= tol).all())
        err = max(err, d.max().item())
    return err, ok


def _gate_plans(npix, C, types, aligned):
    """The gate kernel's plans held bit-equal to its scalar body at a small
    call: every streaming body that takes it (``body_plans``), on one and
    two blocks too, and the slab body at slabs of 16 pixels through a ring
    of two and of 32 through three (so a warp's ring wraps, and a slab ends
    inside a 16-byte granule at odd C) where a block's shared memory holds
    them."""
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates as cg

    plans = [p for p in (cg.GatesPlan("slab", 16, 2, 1), cg.GatesPlan("slab", 32, 3, 1))
             if cg.slab_smem(p.slab_pixels, C, *types, p.ring) <= cg.SMEM_PER_BLOCK]
    for body, p in cg.body_plans(npix, C, *types, aligned).items():
        if body != "scalar":
            plans += [p, p._replace(grid=1), p._replace(grid=2)]
    return plans


def check_gates(gen):
    """fused_lstm_gates (``csrc/lstm_gates.cu``: the scalar, vector and slab
    bodies) at every shape of ``scripts/gates_breakdown.py``'s ``SHAPES``
    (the main path's pixel layer in its bfloat16 contract and the JAX
    function's float32 one, the s2d pixel layer, the True route's four
    north-star layers and the north star's s2d pixel layer): the plan's
    body through the wrapper (asserted by its launches by body) against the
    plain version and bit-equal to the scalar body; every body that takes
    the shape, the eager
    gate math (the yardstick: no single PyTorch call computes the function)
    and the plain version timed as CUDA graph replays, beside the bytes
    bound and the issue bound of each body (instructions an element from
    the library's SASS, at the SM clock under the load); the wrapper's call
    rate at the main contract.  Then every body that takes the call held
    bit-equal to the scalar body at C 1/3/8/12/48/96/192, every type, odd
    pixel counts, aligned and on views one element off.  Returns the
    wrapper's row (the main contract, with every shape's numbers beside it)
    and one row a body (the scalar body at the main contract, the slab
    body at the north star's pixel layer, the vector body at its layer
    1)."""
    import torch

    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates as cg
    from evolutionary_illusion_generator_tpu_torch.scripts import gates_breakdown as gb

    bf16 = torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    scalar = cg.GatesPlan("scalar")
    shapes = gb.measure(iters=GATES_ITERS, gen=gen)  # holds each body bit-equal on the way
    for label, row in shapes.items():
        (B, H, W, C), types = gb.SHAPES[label]
        gates, c_prev = gb.inputs((B, H, W, C), types, gen)
        od = types[2]
        plan = cg.gates_plan(B * H * W, C, *types, True)
        before = dict(cg.fused_lstm_gates.body_launches)
        out = cg.fused_lstm_gates(gates, c_prev, out_dtype=od)
        ran = {k: v - before[k] for k, v in cg.fused_lstm_gates.body_launches.items()
               if v != before[k]}
        ref = cg._launch(gates, c_prev, stream, od, scalar)
        err, ok = _gates_err(out, cg.lstm_gates_plain(gates, c_prev, out_dtype=od))
        if ran != {plan.body: 1} or not ok or not all(map(torch.equal, out, ref)):
            raise AssertionError(f"fused_lstm_gates {label}: launched {ran} (plan {plan}), max "
                                 f"abs err {err} against the plain version, bit-equal to the "
                                 f"scalar body: {[torch.equal(a, b) for a, b in zip(out, ref)]}")
        row.update(body=plan.body, max_abs_err=err, plain_ms=gb.graph_ms(
            lambda: cg.lstm_gates_plain(gates, c_prev, out_dtype=od), GATES_ITERS))
        if label == "main":
            row["call_ms"] = cuda_ms(lambda: cg.fused_lstm_gates(gates, c_prev, out_dtype=od), 200)
        log(f"  fused_lstm_gates {label} {(B, H, W, C)} {row['types']}: {plan.body} body "
            f"{row['ms'][plan.body]:.5f} ms (" + ", ".join(
                f"{b} {t:.5f}" for b, t in row["ms"].items()) + "), eager gate math "
            f"{row['eager_ms']:.5f}, plain {row['plain_ms']:.5f}; bytes bound "
            f"{row['bytes_bound_ms']:.5f} ({row['bytes'] / 1e6:.2f} MB), issue bound "
            + ", ".join(f"{b} {t:.5f} ({row['per_element'][b]:.1f} instructions an element)"
                        for b, t in row["issue_bound_ms"].items())
            + f" at {row['sm_mhz']:.0f} MHz; err {err:.2e}, bit-equal to the scalar body")
        del gates, c_prev, out, ref

    # every body that takes the call, bit-equal to the scalar body
    def at_odd_offset(t):
        v = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:].view(t.shape)
        return v.copy_(t)

    worst, held = 0.0, 0
    for Cx, npix in itertools.product(GATES_CHANNELS, GATES_ODD_PIXELS):
        for types in itertools.product((torch.float32, bf16), repeat=3):
            gd, sd, od = types
            gates = torch.randn(1, 1, npix, 4 * Cx, device="cuda", generator=gen).mul_(2).to(gd)
            state = torch.randn(1, 1, npix, Cx, device="cuda", generator=gen).to(sd)
            plain = cg.lstm_gates_plain(gates, state, out_dtype=od)
            for aligned, args in ((True, (gates, state)),
                                  (False, (at_odd_offset(gates), at_odd_offset(state)))):
                err, ok = _gates_err(cg.fused_lstm_gates(*args, out_dtype=od), plain)
                ref = cg._launch(*args, stream, od, scalar)
                for p in _gate_plans(npix, Cx, types, aligned):
                    got = cg._launch(*args, stream, od, p)
                    if not (ok and torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                        raise AssertionError(f"fused_lstm_gates {npix} px C={Cx} {types} "
                                             f"{'aligned' if aligned else 'one element off'}: "
                                             f"{p} not bit-equal to the scalar body, or the "
                                             f"wrapper off the plain version by {err}")
                    held += 1
                worst = max(worst, err)
    log(f"  fused_lstm_gates at {GATES_ODD_PIXELS} px, C {GATES_CHANNELS}, every type, aligned "
        f"and one element off: {held} launches of the streaming bodies bit-equal to the "
        f"scalar body; the wrapper within {worst:.2e} of the plain version")

    def row(label, body):
        r = shapes[label]
        return dict(route="cuda",
                    source="evolutionary_illusion_generator_tpu_torch/csrc/lstm_gates.cu",
                    replaces="evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py:57",
                    shape=r["shape"], types=r["types"], max_abs_err=r["max_abs_err"],
                    ms=r["ms"][body], plain_ms=r["plain_ms"], bound_ms=r["bytes_bound_ms"],
                    bound_by="bytes", issue_bound_ms=r["issue_bound_ms"].get(body),
                    eager_ms=r["eager_ms"], library_ms=None)

    main = shapes["main"]
    out = {"fused_lstm_gates": dict(row("main", main["body"]), call_ms=main["call_ms"],
                                    shapes=shapes)}
    for body, label in (("scalar", "main"), ("slab", "north0"), ("vector", "north1")):
        out[f"fused_lstm_gates/{body}"] = row(label, body)
    return out


def _narrow_inputs(gen, B, H, W, C, C_above, params=None):
    """Sources (E, R and R_above at half resolution, bfloat16 in [-1, 1] as
    a rollout's are), packed weights, bias and bfloat16 c_prev of one
    narrow layer: the bundled layer-0 weights where ``params`` is given,
    else random ones drawn as ``init_params`` draws them (normal over the
    square root of the fan-in, so gates of the bundled weights' size)."""
    import torch

    cins = [2 * C, C] + ([C_above] if C_above else [])
    shapes = [(B, H, W, 2 * C), (B, H, W, C)] + ([(B, H // 2, W // 2, C_above)] if C_above
                                                 else [])
    srcs = [torch.rand(s, device="cuda", generator=gen).mul_(2).sub_(1).bfloat16() for s in shapes]
    if params is not None:
        p = params[0]
        wks, b = [p[k] for k in ("lstm_k_e", "lstm_k_r", "lstm_k_up")], p["lstm_b"]
    else:
        from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import pack_gate_weight

        fan_in = 9 * sum(cins)
        wks = [pack_gate_weight(torch.randn(3, 3, ci, 4 * C, device="cuda", generator=gen)
                                .div_(math.sqrt(fan_in))) for ci in cins]
        b = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.3).bfloat16()
    c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()
    return srcs, wks, b, c_prev


def _narrow_err(out, ref):
    """Max abs error of bfloat16 (h, c) against the plain version's and the
    largest share of elements that differ, held by the reference phase's
    one-step rule: the two sum each source's products in another order, so
    a source's bfloat16 conv may round the other way, a one-ulp flip of a
    gate that moves h or c by about as much (STEP_ATOL), on at most
    STEP_DIFF_SHARE of a tensor."""
    err, share, same_type = 0.0, 0.0, True
    for got, want in zip(out, ref):
        d = (got.float() - want.float()).abs()
        share = max(share, (d > 0).float().mean().item())
        same_type = same_type and got.dtype == want.dtype
        err = max(err, d.max().item())
    return err, share, same_type and err <= STEP_ATOL and share <= STEP_DIFF_SHARE


def _old_narrow_route(srcs, wks, b, c_prev):
    """The narrow layer as the main path ran it before its kernel (the
    ``use_pallas=True`` route): the upsampled copy of R_above, three cuDNN
    bfloat16 convs, the bias and two adds in bfloat16, then the gate
    kernel."""
    import torch
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates as cg

    ws = [cf.unpack_gate_weight(wk).contiguous() for wk in wks]

    def conv(x, w):
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)

    def run():
        gates = conv(srcs[0], ws[0]) + b
        gates = gates + conv(srcs[1], ws[1])
        if len(srcs) == 3:
            gates = gates + conv(model._upsample2(srcs[2]), ws[2])
        return cg.fused_lstm_gates(gates.contiguous(), c_prev, out_dtype=torch.bfloat16)
    return run


def _narrow_chain_held(label, outs, chain):
    """Each of ``outs`` ({name: (h, c)}) within one ulp at each rounding
    point of the rounded float64 chain (``convlstm_narrow.chain_float64``);
    returns {name: mean |c - c_float64|} against the unrounded float64 c."""
    drift = {}
    for name, (h, c) in outs.items():
        for t, key in ((h, "h"), (c, "c")):
            off = ((t.double() - chain[key]).abs() > chain["d" + key]).float().mean().item()
            if off:
                raise AssertionError(f"narrow_convlstm_layer {label} {name}: {off:.3e} of {key} "
                                     f"beyond one ulp at each rounding point of the float64 chain")
        drift[name] = (c.double() - chain["c_exact"]).abs().mean().item()
    return drift


def check_narrow(gen, params):
    """narrow_convlstm_layer's two bodies (``csrc/convlstm_narrow_hopper.cu``'s
    persistent body, ``csrc/convlstm_narrow.cu``'s mma.sync body) against
    the plain version: at the main path's pixel layer (8, 120, 160, C 3,
    R_above 48 at 60x80, the bundled weights), the grayscale stack's pixel
    layer (C 1, R_above 16) and layer 1 (C 16 at 60x80, R_above 32), a
    narrow top layer and the north star's pixel layer (25 x 480x640), in the
    main path's types: the wrapper launches its plan's body (the persistent
    one in bfloat16 compute, counted by body); both bodies and the plain
    version within one ulp at each rounding point of the rounded float64
    chain, the plan's body's mean |c - c_float64| no worse than the plain
    version's; the persistent body's rows bit-equal across batch, tile and
    grid.  Then float32 compute and state (the mma.sync body) against
    float64 sums, and odd widths at every strip width and tile.  Times, as
    CUDA graph replays, each body beside its bound, the plain version and
    the route it replaced (cuDNN convs, the upsampled copy, the adds and the
    gate kernel: the library time).  Returns the wrapper's row and one per
    body (``"narrow_convlstm_layer/<body>"``)."""
    import torch
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn

    bf16, f32 = torch.bfloat16, torch.float32
    wrapper = cn.narrow_convlstm_layer
    rows = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    shapes = dict(NARROW_SHAPES, north_star=NARROW_NORTH_STAR)
    for label, (B, H, W, C, C_above) in shapes.items():
        srcs, wks, b, c_prev = _narrow_inputs(gen, B, H, W, C, C_above,
                                              params if label in ("main", "north_star") else None)
        plan = cn.narrow_plan(B, H, W, C, C_above)
        # the pixel layers on the persistent body; layer 1 of 1,16,32,64
        # keeps the mma.sync body (measured faster there)
        if plan.body != ("persistent" if C <= cn.PACKED_MAX_C else "mma_sync"):
            raise AssertionError(f"narrow_convlstm_layer {label}: plan {plan}")
        old_plan = cn.NarrowPlan("mma_sync", tile_w=cn.tile_width(B, H, W))
        before = dict(wrapper.body_launches)
        out = wrapper(srcs, wks, b, c_prev)
        if wrapper.body_launches[plan.body] != before[plan.body] + 1:
            raise AssertionError(f"narrow_convlstm_layer {label}: launches by body "
                                 f"{wrapper.body_launches} (before {before})")
        old = cn.launch(srcs, wks, b, c_prev, bf16, stream(), plan=old_plan)
        ref = cn.narrow_convlstm_layer_plain(srcs, wks, b, c_prev, compute_dtype=bf16)
        torch.cuda.synchronize()
        err, share, ok = _narrow_err(out, ref)
        if not ok:
            raise AssertionError(f"narrow_convlstm_layer {label} {(B, H, W, C, C_above)}: max "
                                 f"abs err {err:.3e}, {share:.2%} of a tensor differ")
        n = DRIFT_IMAGES if B > MAIN_BATCH else B  # the float64 chain of a chunk of 25 is slow
        chain = cn.chain_float64([x[:n] for x in srcs], wks, b, c_prev[:n])
        # every element within one ulp at each rounding point; the means
        # are logged: in bfloat16 compute they part only by the few sums
        # each side rounds the other way (the float32 compute check below
        # holds the mean)
        drift = _narrow_chain_held(label, {k: (h[:n], c[:n]) for k, (h, c) in (
            (plan.body, out), ("mma_sync", old), ("plain", ref))}, chain)
        if label == "main":  # rows of a batch of 1 and 3 at other tiles and grids
            for r0, k in ((5, 1), (2, 3)):
                part_src = [x[r0:r0 + k].contiguous() for x in srcs]
                for tw in cn.PERSISTENT_TILES:
                    p = cn.persistent_plan(k, H, W, C, C_above, tile_w=tw, blocks_per_sm=1)
                    part = cn.launch(part_src, wks, b, c_prev[r0:r0 + k].contiguous(), bf16,
                                     stream(), plan=p._replace(blocks=p.blocks + 7 * k))
                    if not all(torch.equal(a[r0:r0 + k], q) for a, q in zip(out, part)):
                        raise AssertionError(f"narrow_convlstm_layer: rows {r0}..{r0 + k} at "
                                             f"{p} not bit-equal to the whole batch's")
        cins = [x.shape[-1] for x in srcs]
        flops = 2.0 * B * H * W * 9 * sum(cins) * 4 * C
        moved = nbytes(*srcs, *wks, b, c_prev, *out)
        b_ms, b_by = bound_ms(flops, moved)
        iters = 20 if B > MAIN_BATCH else 200
        call = lambda: wrapper(srcs, wks, b, c_prev)  # noqa: E731
        ms = graph_ms(call, iters)
        old_ms = graph_ms(lambda: cn.launch(srcs, wks, b, c_prev, bf16, stream(), plan=old_plan),
                          iters)
        plain_ms = graph_ms(lambda: cn.narrow_convlstm_layer_plain(
            srcs, wks, b, c_prev, compute_dtype=bf16), max(iters // 4, 5))
        lib_ms = graph_ms(_old_narrow_route(srcs, wks, b, c_prev), iters)
        rows[label] = dict(max_abs_err=err, ms=ms, mma_sync_ms=old_ms, body=plan.body,
                           plan=list(plan), call_ms=cuda_ms(call, iters), plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, drift=drift)
        log(f"  narrow_convlstm_layer {label} {B}x{H}x{W} C={C} sources {cins} (CUDA graph "
            f"replays): {plan.body} body {ms * 1e3:.2f} us, {b_ms / ms:.1%} of its "
            f"{b_ms * 1e3:.2f} us bound ({b_by}, {moved / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP); "
            f"mma.sync body {old_ms * 1e3:.2f} us"
            f"{' FASTER' if old_ms < ms and plan.body != 'mma_sync' else ''}; call rate "
            f"{rows[label]['call_ms'] * 1e3:.2f} us; plain {plain_ms * 1e3:.2f} us; the route "
            f"before (convs, upsample, adds, gate kernel) {lib_ms * 1e3:.2f} us; err {err:.2e} "
            f"({share:.3%} differ); mean |c - c_float64| {plan.body} / mma.sync / plain "
            f"{drift[plan.body]:.4e} / {drift['mma_sync']:.4e} / {drift['plain']:.4e}; plan "
            f"{tuple(plan)}")

    # float32 compute and state against float64 sums, at the main shape
    B, H, W, C, C_above = NARROW_SHAPES["main"]
    srcs, wks, b, _ = _narrow_inputs(gen, B, H, W, C, C_above, params)
    c32 = torch.randn(B, H, W, C, device="cuda", generator=gen)
    if cn.narrow_plan(B, H, W, C, C_above, f32, f32).body != "mma_sync":
        raise AssertionError("narrow_convlstm_layer: float32 compute off the mma.sync body")
    before = wrapper.body_launches["mma_sync"]
    h, c = wrapper(srcs, wks, b, c32, compute_dtype=f32)
    if wrapper.body_launches["mma_sync"] != before + 1:
        raise AssertionError("narrow_convlstm_layer: float32 compute off the mma.sync body")
    ref = cn.narrow_convlstm_layer_plain(srcs, wks, b, c32, compute_dtype=f32)
    torch.cuda.synchronize()
    eh, ec = ((x - y).abs().max().item() for x, y in zip((h, c), ref))
    if not (eh <= C_TOL and ec <= C_TOL):
        raise AssertionError(f"narrow_convlstm_layer float32: max abs err h {eh} c {ec}")
    xs = [srcs[0], srcs[1], srcs[2].repeat_interleave(2, 1).repeat_interleave(2, 2)]
    g64 = sum(F.conv2d(x.double().permute(0, 3, 1, 2), cf.unpack_gate_weight(wk).double(),
                       padding=1) for x, wk in zip(xs, wks))
    i, f, o, g = (g64.permute(0, 2, 3, 1) + b.double()).split(C, dim=-1)
    c64 = torch.sigmoid(f) * c32.double() + torch.sigmoid(i) * torch.tanh(g)
    drift, drift_p = ((t.double() - c64).abs().mean().item() for t in (c, ref[1]))
    log(f"  narrow_convlstm_layer float32 compute and state (mma.sync body): max abs err h "
        f"{eh:.2e} c {ec:.2e}; mean |c - c_float64| kernel {drift:.3e} plain {drift_p:.3e}")
    if not drift <= drift_p:
        raise AssertionError(f"narrow_convlstm_layer: mean |c - c_float64| {drift:.3e} above the "
                             f"plain version's {drift_p:.3e}")

    # odd widths at every strip width of the mma.sync body and every tile of
    # the persistent body, where it takes the channels
    for B, H, W, C, C_above in NARROW_ODD:
        srcs, wks, b, c_prev = _narrow_inputs(gen, B, H, W, C, C_above)
        ref = cn.narrow_convlstm_layer_plain(srcs, wks, b, c_prev, compute_dtype=bf16)
        plans = [cn.NarrowPlan("mma_sync", tile_w=tw)
                 for tw in sorted(set(cf.tile_candidates(W)) | {3, 7})]
        if cn.narrow_body(C, C_above, bf16) == "persistent":
            plans += [cn.persistent_plan(B, H, W, C, C_above, tile_w=tw)
                      for tw in cn.PERSISTENT_TILES]
        chain = cn.chain_float64(srcs, wks, b, c_prev)
        worst = 0.0
        for p in plans:
            out = cn.launch(srcs, wks, b, c_prev, bf16, stream(), plan=p)
            err, share, ok = _narrow_err(out, ref)
            if not ok:
                raise AssertionError(f"narrow_convlstm_layer {(B, H, W, C, C_above)} {p}: "
                                     f"max abs err {err:.3e}, {share:.2%} differ")
            _narrow_chain_held(f"{(B, H, W, C, C_above)}", {p.body: out}, chain)
            worst = max(worst, err)
        log(f"  narrow_convlstm_layer {B}x{H}x{W} C={C} R_above {C_above}: max abs err "
            f"{worst:.2e} at {[tuple(p)[:2] for p in plans]}")
    csrc = "evolutionary_illusion_generator_tpu_torch/csrc/"
    main = rows["main"]
    out = {}
    # the wrapper (its plan's body at each shape), then each body on its own:
    # the persistent body's rows are the pixel layers'
    for key, src, ms_key, body in (
            ("narrow_convlstm_layer", "convlstm_narrow_hopper.cu", "ms", None),
            ("narrow_convlstm_layer/persistent", "convlstm_narrow_hopper.cu", "ms", "persistent"),
            ("narrow_convlstm_layer/mma_sync", "convlstm_narrow.cu", "mma_sync_ms", "mma_sync")):
        out[key] = dict(route="cuda", source=csrc + src,
                        sources=[csrc + "convlstm_narrow_hopper.cu", csrc + "convlstm_narrow.cu"],
                        replaces="evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py:57",
                        **dict(main, ms=main[ms_key]),
                        shapes={k: dict(v, ms=v[ms_key]) for k, v in rows.items()
                                if k != "main" and body in (None, "mma_sync", v["body"])})
    return out


def check_gate_convs(gen, params):
    """The True route's gate convs (``convlstm_narrow.gate_convs``) at each
    layer of the main path's step (a chunk of 8) and of the north star's (a
    chunk of 25 at 640x480), the bundled weights, in bfloat16 compute: the
    wrapper on its plan's body (counted by body: the wgmma body,
    ``csrc/gate_convs_wgmma.cu``, at C >= 32; the mma.sync body at the
    pixel layer), and the mma.sync body as it ran before the wgmma body
    (its strip width for the batch) beside it; each within one ulp at each
    rounding point of the rounded float64 chain on all but
    UNIT_BEYOND_SHARE of the gates (at the north star on DRIFT_IMAGES
    images), as ``model._gate_convs`` (the cuDNN split convs it replaced,
    the library time).  Times as CUDA graph replays: the wrapper, the
    mma.sync body, the plain version and cuDNN beside the bound and its
    share, summed over a step's four layers.  Returns the wrapper's row
    and one per body (``"gate_convs/<body>"``: the wgmma body's layers, the
    mma.sync body at all four)."""
    import torch

    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn

    bf16 = torch.bfloat16
    wrapper = cn.gate_convs
    stream = torch.cuda.current_stream().cuda_stream
    shapes = {"main": (MAIN_BATCH, UNIT_LAYERS),
              "north_star": (NORTH_STAR_CHUNK, NORTH_STAR_UNIT_LAYERS)}
    keys = ("ms", "mma_sync_ms", "plain_ms", "library_ms", "ops_ms", "bytes_ms")
    steps, worst = {}, 0.0
    for label, (B, layers) in shapes.items():
        rows = []
        for l, (H, W, C, C_above) in enumerate(layers):
            p = params[l]
            cins = [2 * C, C] + ([C_above] if C_above else [])
            srcs = [torch.rand(B, H, W, 2 * C, device="cuda", generator=gen),
                    torch.rand(B, H, W, C, device="cuda", generator=gen)]
            if C_above:
                srcs.append(torch.rand(B, H // 2, W // 2, C_above, device="cuda", generator=gen))
            srcs = [x.mul_(2).sub_(1).to(bf16) for x in srcs]
            wks = [p["lstm_k_e"], p["lstm_k_r"]] + ([p["lstm_k_up"]] if C_above else [])
            b = p["lstm_b"]
            plan = cn.gate_plan(H, W, C)
            if plan.body != ("wgmma" if C >= cn.GATE_WGMMA_MIN_C else "mma_sync"):
                raise AssertionError(f"gate_convs {label} layer {l}: plan {plan}")
            n, before = wrapper.launches, dict(wrapper.body_launches)
            got = wrapper(srcs, wks, b)
            if not (wrapper.launches == n + 1
                    and wrapper.body_launches[plan.body] == before[plan.body] + 1):
                raise AssertionError(f"gate_convs {label} layer {l}: launches by body "
                                     f"{wrapper.body_launches} (before {before})")
            old_plan = cf.Plan("mma_sync", 32, 0, cf.tile_width(B, H, W), 0)
            old = cn.launch_gates(srcs, wks, b, bf16, stream, plan=old_plan)
            r_above = srcs[2] if C_above else None
            want = model._gate_convs(p, {"e": srcs[0], "r": srcs[1]}, r_above, bf16, False, False)
            torch.cuda.synchronize()
            k = DRIFT_IMAGES if B > MAIN_BATCH else B  # the float64 chain of 25 images is slow
            g, err, _ = cn.gate_chain_float64([x[:k] for x in srcs], wks, b)
            beyond = {}
            for name, t in (("gate_convs", got), ("mma_sync", old), ("model._gate_convs", want)):
                beyond[name] = ((t[:k].double() - g).abs() > err).float().mean().item()
                if beyond[name] > UNIT_BEYOND_SHARE or t.dtype != bf16 or t.shape != want.shape:
                    raise AssertionError(f"{name} {label} layer {l}: {beyond[name]:.3e} of the "
                                         f"gates beyond one ulp at each rounding point of the "
                                         f"float64 chain")
            d = (got.float() - want.float()).abs()
            worst = max(worst, d.max().item())
            flops = 2.0 * B * H * W * 9 * sum(cins) * 4 * C
            moved = nbytes(*srcs, *wks, b, got)
            iters = 20 if B > MAIN_BATCH else 50
            row = dict(layer=l, body=plan.body, plan=list(plan),
                       ms=graph_ms(lambda: wrapper(srcs, wks, b), iters),
                       mma_sync_ms=graph_ms(lambda: cn.launch_gates(  # the capture's stream
                           srcs, wks, b, bf16, torch.cuda.current_stream().cuda_stream,
                           plan=old_plan), iters),
                       plain_ms=graph_ms(lambda: cn.gate_convs_plain(
                           srcs, wks, b, compute_dtype=bf16), iters),
                       library_ms=graph_ms(lambda: model._gate_convs(
                           p, {"e": srcs[0], "r": srcs[1]}, r_above, bf16, False, False), iters),
                       ops_ms=flops / PEAK_BF16_FLOPS * 1e3,
                       bytes_ms=moved / PEAK_BYTES_PER_S * 1e3,
                       differ=(d > 0).float().mean().item(), beyond=beyond)
            bound = max(row["ops_ms"], row["bytes_ms"])
            rows.append(row)
            log(f"  gate_convs {label} layer {l} {B}x{H}x{W} C={C} sources {cins} (CUDA graph "
                f"replays): {plan.body} body {row['ms'] * 1e3:.2f} us, {bound / row['ms']:.1%} of "
                f"its {bound * 1e3:.2f} us bound ({flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB); "
                f"mma.sync body {row['mma_sync_ms'] * 1e3:.2f} us; model._gate_convs (cuDNN) "
                f"{row['library_ms'] * 1e3:.2f} us; plain {row['plain_ms'] * 1e3:.2f} us; "
                f"{row['differ']:.2e} of the gates apart from cuDNN's, max {d.max().item():.3e}; "
                f"beyond one ulp of the chain {beyond}; plan {tuple(plan)}")
            del srcs, got, old, want, g, err, d
        steps[label] = rows
    out = {}
    csrc = "evolutionary_illusion_generator_tpu_torch/csrc/"
    # the wrapper (its plan's body at each layer), the wgmma body's layers,
    # and the mma.sync body (as it launched before the wgmma body) at all four
    for key, src, ms_key, body in (("gate_convs", "gate_convs_wgmma.cu", "ms", None),
                                   ("gate_convs/wgmma", "gate_convs_wgmma.cu", "ms", "wgmma"),
                                   ("gate_convs/mma_sync", "convlstm_narrow.cu", "mma_sync_ms",
                                    None)):
        sums = {}
        for label, rows in steps.items():
            rows = [r for r in rows if body is None or r["body"] == body]
            tot = {k: sum(r[k] for r in rows) for k in keys}
            tot["ms"] = tot[ms_key]
            tot["bound_ms"] = max(tot["ops_ms"], tot["bytes_ms"])
            tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
            tot["layers"] = [r["layer"] for r in rows]
            sums[label] = tot
        main = sums["main"]
        out[key] = dict(route="cuda", source=csrc + src,
                        sources=[csrc + "gate_convs_wgmma.cu", csrc + "convlstm_narrow.cu"],
                        replaces="evolutionary_illusion_generator_tpu/models/prednet/model.py:467",
                        max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                        library_ms=main["library_ms"], mma_sync_ms=main["mma_sync_ms"],
                        layers=main["layers"], north_star=sums["north_star"])
        log(f"  {key}: a step's layers {main['layers']}: main {main['ms']:.4f} ms "
            f"({main['bound_ms'] / main['ms']:.1%} of the bound), the mma.sync body "
            f"{main['mma_sync_ms']:.4f}, cuDNN {main['library_ms']:.4f}; north star "
            f"{sums['north_star']['ms']:.4f} ms "
            f"({sums['north_star']['bound_ms'] / sums['north_star']['ms']:.1%}), the mma.sync "
            f"body {sums['north_star']['mma_sync_ms']:.4f}, cuDNN "
            f"{sums['north_star']['library_ms']:.4f}")
    out["gate_convs"]["steps"] = steps
    return out


def _unit_err(got, want, cd, *points):
    """Max abs error of a unit kernel's output against its plain version's,
    the share of elements that differ, and whether they are held.  In
    bfloat16 compute: within one bfloat16 ulp at each rounding point (2**-7
    of each point's magnitude: the conv, + b, the difference) but on at
    most UNIT_BEYOND_SHARE of the elements, there within two; on at most
    STEP_DIFF_SHARE of the elements in all.  In float32 compute within
    C_TOL, or one bfloat16 ulp more where E is bfloat16 (then on at most
    STEP_DIFF_SHARE of them).  A failure names its worst elements."""
    import torch

    d = (got.float() - want.float()).abs()
    if cd == torch.float32:
        tol = C_TOL + (2.0**-7 * want.float().abs() if want.dtype == torch.bfloat16 else 0.0)
        beyond = d > tol
        ok = not bool(beyond.any())
    else:
        tol = sum(2.0**-7 * p.float().abs() for p in points) + 1e-6
        beyond = d > tol
        ok = (beyond.float().mean().item() <= UNIT_BEYOND_SHARE
              and bool((d <= 2 * tol).all()))
    share = (d > 0).float().mean().item()
    ok = (ok and got.dtype == want.dtype and got.shape == want.shape
          and not bool(torch.isnan(got.float()).any()))
    if not cd == want.dtype == torch.float32:
        ok = ok and share <= STEP_DIFF_SHARE
    if not ok:
        worst = torch.argsort((d / tol).flatten(), descending=True)[:5]
        at = [(tuple(torch.unravel_index(i, d.shape)[k].item() for k in range(d.dim())),
               got.float().flatten()[i].item(), want.float().flatten()[i].item(),
               [p.float().flatten()[i].item() for p in points]) for i in worst]
        log(f"    worst elements (index, kernel, plain, rounding points): {at}; beyond one ulp "
            f"{beyond.float().mean().item():.3e} of the elements")
    return d.max().item(), share, ok


def _unit_inputs(gen, B, H, W, C, C_above, params=None, layer=None, cd=None, sd=None):
    """R in [-1, 1] and E in [0, 1] in the state dtype, A in [0, 1] in the
    compute dtype (bfloat16 both by default), and the packed weights and
    biases of one layer's units: the bundled ones of ``layer`` where
    ``params`` is given, else drawn as ``init_params`` draws them (normal
    over the square root of the fan-in)."""
    import torch

    from evolutionary_illusion_generator_tpu_torch.ops import prednet_units as pu

    cd, sd = cd or torch.bfloat16, sd or torch.bfloat16

    def rand(*shape):
        return torch.rand(*shape, device="cuda", generator=gen)

    r = rand(B, H, W, C).mul_(2).sub_(1).to(sd)
    a = rand(B, H, W, C).to(cd)
    e = rand(B, H, W, 2 * C).to(sd)
    if params is not None:
        p = params[layer]
        return r, a, p["ahat_k"], p["ahat_b"], e, p.get("a_k"), p.get("a_b")

    def weight(cin, cout):
        return pu.pack_unit_weight(torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
                                   .div_(math.sqrt(9 * cin)))

    cout = C_above or 8
    return (r, a, weight(C, C), torch.randn(C, device="cuda", generator=gen).mul_(0.1).bfloat16(),
            e, weight(2 * C, cout),
            torch.randn(cout, device="cuda", generator=gen).mul_(0.1).bfloat16())


def check_units(gen, params):
    """The A and Ahat units' kernels (``csrc/prednet_units_wgmma.cu``'s
    wgmma and im2col bodies, ``csrc/prednet_units.cu``'s mma.sync and
    direct bodies) against their plain versions: at the main path's four
    layers (the bundled weights, a chunk of 8) and the north star's (a chunk
    of 25) in the main path's types, both Ahat activations, each launch on
    the body of the shape's plan (counted by body; in bfloat16 compute every
    layer of C >= 8 on the wgmma body, the A unit's pixel layer on the
    im2col body), with the device times of the kernel, of its mma.sync body
    (the kernel before the wgmma bodies; the direct body where it is that),
    the plain version (``model._conv`` and the eager ops: the route the
    kernels replaced), the library yardstick (cuDNN's bfloat16 conv with
    its bias in one call and the eager ops; the conv alone logged beside it)
    and the bound; at the main path's layers in float32 compute and state
    (the mma.sync body), each output's mean distance to float64 sums beside
    the plain version's (it may be no larger); then the grayscale stack's
    pixel layer and an odd shape in every type.  Returns the two units'
    rows and one row per new body (``"<unit>/<body>"``): ms, old_ms,
    plain_ms, library_ms and bound_ms summed over a main-path step's
    launches (of that body), with each layer's and the north star's beside
    them."""
    import torch
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.ops import prednet_units as pu
    from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import tile_width

    bf16, f32 = torch.bfloat16, torch.float32
    layers = {name: {"main": [], "north_star": []} for name in UNIT_SOURCES}

    def counted(wrapper, plan, call):
        """``call()`` through ``wrapper``, which must launch ``plan``'s body
        once; in bfloat16 compute a layer of C >= 8 takes the wgmma body."""
        before = dict(wrapper.body_launches)
        out = call()
        if wrapper.body_launches[plan.body] != before[plan.body] + 1:
            raise AssertionError(f"{wrapper.__name__}: plan {plan}, launches by body "
                                 f"{wrapper.body_launches} (before {before})")
        return out
    worst = dict.fromkeys(UNIT_SOURCES, 0.0)

    def nhwc_conv(x, w, b, dtype):  # cuDNN's conv of the library yardstick (OIHW w)
        return F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w.to(dtype),
                        None if b is None else b.to(dtype),
                        padding=1).permute(0, 2, 3, 1)

    def held(name, label, *args):
        err, share, ok = _unit_err(*args)
        if not ok:
            raise AssertionError(f"{name} {label}: max abs err {err:.3e}, {share:.3%} differ")
        worst[name] = max(worst[name], err)
        return err, share

    def check_ahat(label, r, a, k, b, cd, sd):
        B, H, W, C = r.shape
        conv = model._conv(r, pu.unpack_unit_weight(k, C), None, cd)
        v = model._conv(r, pu.unpack_unit_weight(k, C), b, cd)
        plan = pu.ahat_plan(B, H, W, C, cd)
        if cd == bf16 and C >= 8 and C % 8 == 0 and plan.body != "wgmma":
            raise AssertionError(f"ahat_error_unit {label}: took {plan}")
        for layer0 in (True, False):
            e, pred = counted(pu.ahat_error_unit, plan, lambda: pu.ahat_error_unit(
                r, k, b, a, layer0=layer0, compute_dtype=cd, state_dtype=sd))
            want_e, want_p = pu.ahat_error_unit_plain(r, pu.unpack_unit_weight(k, C), b, a,
                                                      layer0=layer0,
                                                      compute_dtype=cd, state_dtype=sd)
            torch.cuda.synchronize()
            ahat = v.clamp(0.0, 1.0) if layer0 else torch.relu(v)
            pts = [torch.cat([t.float()] * 2, -1) for t in (conv, ahat, a)]
            err = held("ahat_error_unit", f"{label} layer0={layer0}", e, want_e, cd, *pts)
            if layer0:
                held("ahat_error_unit", f"{label} prediction", pred, want_p, cd, conv, ahat)
        return err

    def check_a(label, e, k, b, cd):
        B, H, W, cin = e.shape
        cout = b.shape[0]
        plan = pu.a_plan(B, H, W, cin, cout, cd)
        if cd == bf16 and plan.body != ("im2col" if cin <= pu.IM2COL_MAX_CIN else
                                        "wgmma" if cin % 8 == 0 else "mma_sync"):
            raise AssertionError(f"a_unit {label}: took {plan}")
        got = counted(pu.a_unit, plan, lambda: pu.a_unit(e, k, b, compute_dtype=cd))
        want = pu.a_unit_plain(e, pu.unpack_unit_weight(k, cout), b, compute_dtype=cd)
        torch.cuda.synchronize()
        conv = model._conv(e, pu.unpack_unit_weight(k, cout), None, cd).float().abs()
        pooled = F.max_pool2d(conv.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return held("a_unit", label, got, want, cd, pooled, want)

    def timed(name, where, label, B, H, W, cin, cout, plan, call, old, plain, library, conv,
              moved, iters):
        flops = 2.0 * B * H * W * 9 * cin * cout
        b_ms, b_by = bound_ms(flops, moved)
        ms, old_ms = graph_ms(call, iters), graph_ms(old, iters)
        row = dict(shape=[B, H, W, cin, cout], body=plan.body, plan=list(plan), ms=ms,
                   old_ms=old_ms, plain_ms=graph_ms(plain, iters),
                   library_ms=graph_ms(library, iters), conv_ms=graph_ms(conv, iters),
                   bound_ms=b_ms, bound_by=b_by, ops_ms=flops / PEAK_BF16_FLOPS * 1e3,
                   bytes_ms=moved / PEAK_BYTES_PER_S * 1e3)
        layers[name][where].append(row)
        log(f"  {name} {label} {B}x{H}x{W} {cin} -> {cout} (CUDA graph replays): {plan.body} "
            f"body {ms * 1e3:.2f} us, {b_ms / ms:.1%} of its {b_ms * 1e3:.2f} us bound "
            f"({b_by}; {moved / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP); mma.sync body (the "
            f"earlier kernel) {old_ms * 1e3:.2f} us{' SLOWER' if ms > old_ms else ''}; plain "
            f"{row['plain_ms'] * 1e3:.2f} us; library (cuDNN conv + bias, eager ops) "
            f"{row['library_ms'] * 1e3:.2f} us, its conv alone {row['conv_ms'] * 1e3:.2f} us; "
            f"plan {tuple(plan)}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for where, shapes, B, iters in (("main", UNIT_LAYERS, MAIN_BATCH, 50),
                                    ("north_star", NORTH_STAR_UNIT_LAYERS, NORTH_STAR_CHUNK, 10)):
        for l, (H, W, C, C_above) in enumerate(shapes):
            r, a, k, b, e, k2, b2 = _unit_inputs(gen, B, H, W, C, C_above, params, l)
            label = f"{where} layer {l}"
            err = check_ahat(label, r, a, k, b, bf16, bf16)
            layer0 = l == 0
            w, w2 = pu.unpack_unit_weight(k, C), C_above and pu.unpack_unit_weight(k2, C_above)

            def call():
                return pu.ahat_error_unit(r, k, b, a, layer0=layer0)

            plan = pu.ahat_plan(B, H, W, C)
            old_plan = (plan if plan.body == "direct"
                        else pu.UnitPlan("mma_sync", tile_w=tile_width(B, H, W)))

            def old():
                return pu.launch_ahat(r, k, b, a, layer0, bf16, bf16, stream(), old_plan)

            def plain():
                return pu.ahat_error_unit_plain(r, w, b, a, layer0=layer0, compute_dtype=bf16,
                                                state_dtype=bf16)

            def library():
                ahat = nhwc_conv(r, w, b, bf16)
                ahat = ahat.clamp(0.0, 1.0) if layer0 else torch.relu(ahat)
                return torch.cat([torch.relu(ahat - a), torch.relu(a - ahat)], dim=-1)

            e_out, pred = call()
            moved = nbytes(r, k, b, a, e_out, *(() if pred is None else (pred,)))
            timed("ahat_error_unit", where, label, B, H, W, C, C, plan, call, old, plain, library,
                  lambda: nhwc_conv(r, w, b, bf16), moved, iters)
            if C_above is None:
                continue
            err = check_a(label, e, k2, b2, bf16)

            def call_a():
                return pu.a_unit(e, k2, b2)

            plan_a = pu.a_plan(B, H, W, 2 * C, C_above)
            old_a_plan = pu.UnitPlan("mma_sync", tile_w=pu.pool_tile_width(H, W))

            def old_a():
                return pu.launch_a(e, k2, b2, bf16, stream(), old_a_plan)

            def plain_a():
                return pu.a_unit_plain(e, w2, b2, compute_dtype=bf16)

            def library_a():
                y = torch.relu(nhwc_conv(e, w2, b2, bf16))
                return F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

            moved = nbytes(e, k2, b2, call_a())
            timed("a_unit", where, label, B, H, W, 2 * C, C_above, plan_a, call_a, old_a, plain_a,
                  library_a, lambda: nhwc_conv(e, w2, b2, bf16), moved, iters)
            del r, a, e, e_out, pred

    # float32 compute and state against float64 sums at the main path's layers
    drift = {name: [] for name in UNIT_SOURCES}
    for l, (H, W, C, C_above) in enumerate(UNIT_LAYERS):
        r, a, k, b, e, k2, b2 = _unit_inputs(gen, MAIN_BATCH, H, W, C, C_above, params, l, f32,
                                             f32)
        check_ahat(f"main layer {l} float32", r, a, k, b, f32, f32)
        v64 = nhwc_conv(r.to(bf16), pu.unpack_unit_weight(k, C), None, torch.float64) + b.double()
        ahat64 = v64.clamp(0.0, 1.0) if l == 0 else torch.relu(v64)
        e64 = torch.cat([torch.relu(ahat64 - a.double()), torch.relu(a.double() - ahat64)], -1)
        outs = (pu.ahat_error_unit(r, k, b, a, layer0=l == 0, compute_dtype=f32,
                                   state_dtype=f32)[0],
                pu.ahat_error_unit_plain(r, pu.unpack_unit_weight(k, C), b, a, layer0=l == 0,
                                         compute_dtype=f32, state_dtype=f32)[0])
        drift["ahat_error_unit"].append([(t.double() - e64).abs().mean().item() for t in outs])
        if C_above is not None:
            check_a(f"main layer {l} float32", e, k2, b2, f32)
            y64 = torch.relu(nhwc_conv(e.to(bf16), pu.unpack_unit_weight(k2, C_above), None,
                                       torch.float64)
                             + b2.double())
            a64 = F.max_pool2d(y64.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            outs = (pu.a_unit(e, k2, b2, compute_dtype=f32),
                    pu.a_unit_plain(e, pu.unpack_unit_weight(k2, C_above), b2, compute_dtype=f32))
            drift["a_unit"].append([(t.double() - a64).abs().mean().item() for t in outs])
    for name, pairs in drift.items():
        log(f"  {name} float32 compute and state, main path's layers: mean |out - out_float64| "
            f"kernel / plain " + ", ".join(f"{d:.3e} / {q:.3e}" for d, q in pairs))
        for l, (d, q) in enumerate(pairs):
            if not d <= q:
                raise AssertionError(f"{name} layer {l}: mean |out - out_float64| {d:.3e} above "
                                     f"the plain version's {q:.3e}")

    # bfloat16 compute against the float64 chain (the conv, + b, the
    # differences, each rounded to bfloat16): how often each output is not
    # the chain's, logged; the kernel within one ulp at each rounding point
    # of the chain's on all but UNIT_BEYOND_SHARE of the elements
    beyond = []

    def off_chain(name, l, outs, ref, *points):
        tol = sum(2.0**-7 * p.abs() for p in points) + 1e-6
        share = (outs[0].double() - ref).abs().gt(tol).float().mean().item()
        beyond.append(share)
        if share > UNIT_BEYOND_SHARE:
            raise AssertionError(f"{name} main layer {l} bfloat16: {share:.3e} of the outputs "
                                 f"beyond one ulp of the rounded float64 chain")
        return (" / ".join(f"{(t.double() != ref).float().mean().item():.2e}" for t in outs)
                + f" (kernel beyond one ulp {share:.2e})")

    for l, (H, W, C, C_above) in enumerate(UNIT_LAYERS):
        r, a, k, b, e, k2, b2 = _unit_inputs(gen, MAIN_BATCH, H, W, C, C_above, params, l)
        w = pu.unpack_unit_weight(k, C)
        rb = (lambda t: t.to(bf16).double())
        conv64 = rb(nhwc_conv(r, w, None, torch.float64))
        v64 = rb(conv64 + b.double())
        ahat64 = v64.clamp(0.0, 1.0) if l == 0 else torch.relu(v64)
        e64 = torch.cat([torch.relu(rb(ahat64 - a.double())), torch.relu(rb(a.double() - ahat64))],
                        -1)
        outs = (pu.ahat_error_unit(r, k, b, a, layer0=l == 0)[0],
                pu.ahat_error_unit_plain(r, w, b, a, layer0=l == 0, compute_dtype=bf16,
                                         state_dtype=bf16)[0])
        line = ["E " + off_chain("ahat_error_unit", l, outs, e64,
                                 *(torch.cat([t] * 2, -1) for t in (conv64, ahat64, a.double())))]
        if C_above is not None:
            w2 = pu.unpack_unit_weight(k2, C_above)
            conv64 = rb(nhwc_conv(e, w2, None, torch.float64))
            y64 = torch.relu(rb(conv64 + b2.double()))
            a64, pooled = (F.max_pool2d(t.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
                           for t in (y64, conv64.abs()))
            outs = (pu.a_unit(e, k2, b2), pu.a_unit_plain(e, w2, b2, compute_dtype=bf16))
            line.append("A " + off_chain("a_unit", l, outs, a64, pooled, a64))
        log(f"  units, main layer {l}, bfloat16: share of outputs off the rounded float64 "
            f"chain, kernel / plain: {'; '.join(line)}")

    # the grayscale pixel layer and an odd shape, every type
    for H, W, C, C_above in UNIT_ODD:
        for cd, sd in ((bf16, bf16), (f32, bf16), (f32, f32)):
            r, a, k, b, e, k2, b2 = _unit_inputs(gen, MAIN_BATCH, H, W, C, C_above, cd=cd, sd=sd)
            check_ahat(f"{H}x{W} C={C} {cd} {sd}", r, a, k, b, cd, sd)
            check_a(f"{H}x{W} C={C} {cd} {sd}", e, k2, b2, cd)
    log(f"  the units at {[s[:3] for s in UNIT_ODD]}, every type: max abs err "
        f"{max(worst.values()):.2e}")

    def total(rows):
        t = {key: sum(r[key] for r in rows)
             for key in ("ms", "old_ms", "plain_ms", "library_ms", "conv_ms", "bound_ms",
                         "ops_ms", "bytes_ms")}
        t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"
        return t

    out = {}
    csrc = "evolutionary_illusion_generator_tpu_torch/csrc/"
    for name, by in layers.items():
        # the unit as a whole (every body), then each new body on its own
        # layers (the pixel layer's direct Ahat body is the earlier kernel)
        for body in (None, "wgmma", "im2col"):
            rows_main = [r for r in by["main"] if body in (None, r["body"])]
            rows_north = [r for r in by["north_star"] if body in (None, r["body"])]
            if not rows_main:
                continue
            main, north = total(rows_main), total(rows_north)
            key = name if body is None else f"{name}/{body}"
            out[key] = dict(
                route="cuda",
                source=csrc + ("prednet_units.cu" if body is None else "prednet_units_wgmma.cu"),
                sources=[csrc + "prednet_units_wgmma.cu", csrc + "prednet_units.cu"],
                replaces=UNIT_SOURCES[name], max_abs_err=worst[name],
                **{k: main[k] for k in ("ms", "old_ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "conv_ms")},
                layers=rows_main, north_star=dict(north, layers=rows_north),
                **({"drift": drift[name]} if body is None else {}))
            log(f"  {key} a step: main path kernel {main['ms']:.4f} ms (mma.sync body "
                f"{main['old_ms']:.4f}), plain {main['plain_ms']:.4f}, library "
                f"{main['library_ms']:.4f}, bound {main['bound_ms']:.4f} ({main['bound_by']}); "
                f"north star kernel {north['ms']:.4f} ms (mma.sync body {north['old_ms']:.4f}), "
                f"plain {north['plain_ms']:.4f}, library {north['library_ms']:.4f}, bound "
                f"{north['bound_ms']:.4f} ({north['bound_by']})")
    return out


@phase("kernels")
def check_kernels(params):
    import torch
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {**check_gates(gen), **check_narrow(gen, params),
               **check_gate_convs(gen, params), **check_units(gen, params)}
    stream = torch.cuda.current_stream().cuda_stream

    def check_out(label, out, ref):
        eh = (out[0].float() - ref[0].float()).abs().max().item()
        ec = (out[1] - ref[1]).abs().max().item()
        if not (out[0].dtype == ref[0].dtype and eh <= H_TOL and ec <= C_TOL):
            raise AssertionError(f"{label}: max abs err h {eh} c {ec}")
        return max(eh, ec)

    def conv_case(wrapper, shapes, B=MAIN_BATCH, sweep=True):
        """The fused kernel per layer at batch B: its wgmma body against the
        plain version and float64 sums; times of the wgmma body, of the
        mma_sync body (the kernel before the wgmma body) at its strip
        width, of the plain version and of the library yardstick; with
        ``sweep``, every channel group at the plan's tile and at a row of 64
        a warpgroup."""
        err = 0.0
        layers = []
        for layer, (H, W, C, cins) in shapes:
            srcs, wks, b, c_prev = _layer_inputs(gen, params, layer, H, W, cins, B)
            call = (lambda: wrapper(srcs, wks, b, c_prev)) if len(cins) > 1 else (
                lambda: wrapper(srcs[0], wks[0], b, c_prev))
            before = dict(wrapper.body_launches)
            h, c = call()
            ref = cf.convlstm_layer_plain(srcs, wks, b, c_prev)
            torch.cuda.synchronize()
            plan = cf.plan_for(srcs, wks, c_prev)
            if not (plan.body == "wgmma"
                    and wrapper.body_launches["wgmma"] == before["wgmma"] + 1):
                raise AssertionError(f"{wrapper.__name__} layer {layer}: took {plan}, "
                                     f"launches by body {wrapper.body_launches}")
            e = check_out(f"{wrapper.__name__} layer {layer}", (h, c), ref)
            err = max(err, e)
            w_oihw = torch.cat([cf.unpack_gate_weight(wk) for wk in wks], dim=1).contiguous()
            w_cl = w_oihw.to(memory_format=torch.channels_last)

            def library():  # cuDNN bf16 conv over the concatenated sources + eager gates
                x = torch.cat(srcs, dim=-1).permute(0, 3, 1, 2)
                gates = F.conv2d(x, w_cl, padding=1).permute(0, 2, 3, 1).float() + b.float()
                i, f, o, g = gates.split(C, dim=-1)
                cc = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
                return (torch.sigmoid(o) * torch.tanh(cc)).bfloat16(), cc

            # the float32 sums against float64 ones: the kernel's c may drift no
            # further than the plain version's
            k = B if B <= MAIN_BATCH else DRIFT_IMAGES
            g64 = sum(F.conv2d(x[:k].double().permute(0, 3, 1, 2),
                               cf.unpack_gate_weight(wk).double(), padding=1)
                      for x, wk in zip(srcs, wks))
            i, f, o, g = (g64.permute(0, 2, 3, 1) + b.double()).split(C, dim=-1)
            c64 = torch.sigmoid(f) * c_prev[:k].double() + torch.sigmoid(i) * torch.tanh(g)
            drift, drift_p = ((t[:k].double() - c64).abs().mean().item() for t in (c, ref[1]))
            del g64, i, f, o, g, c64
            if not drift <= drift_p:
                raise AssertionError(f"{wrapper.__name__} layer {layer} at batch {B}: mean "
                                     f"|c - c_float64| {drift:.3e} above the plain version's "
                                     f"{drift_p:.3e}")
            flops = _gate_flops(H, W, cins, C, B)
            moved = nbytes(*srcs, *wks, b, c_prev, h, c)
            iters = 50 if B <= MAIN_BATCH else 10
            tw = cf.tile_width(B, H, W)
            old = cf.Plan("mma_sync", 16, 0, tw, 0)
            mma_sync = lambda: cf.launch(srcs, wks, b, c_prev, stream, plan=old)  # noqa: E731
            check_out(f"{wrapper.__name__} layer {layer} mma_sync body", mma_sync(), ref)
            # in turns: mma_sync, wgmma, wgmma, mma_sync
            t_old = cuda_ms(mma_sync, iters)
            t_new = min(cuda_ms(call, iters), cuda_ms(call, iters))
            t_old = min(t_old, cuda_ms(mma_sync, iters))
            row = dict(shape=[B, H, W, C], sources=list(cins), plan=_plan_str(plan), ms=t_new,
                       tflops=flops / t_new / 1e9, mma_sync_ms=t_old,
                       library_ms=cuda_ms(library, iters),
                       plain_ms=cuda_ms(lambda: cf.convlstm_layer_plain(srcs, wks, b, c_prev),
                                        max(3, iters // 3)),
                       bound_ms=bound_ms(flops, moved)[0],
                       ops_ms=flops / PEAK_BF16_FLOPS * 1e3,
                       bytes_ms=moved / PEAK_BYTES_PER_S * 1e3, drift=drift, plain_drift=drift_p)
            layers.append(row)
            log(f"  {wrapper.__name__} layer {layer} {B}x{H}x{W} C={C} sources {cins} "
                f"({row['plan']}): err {e:.2e} kernel {t_new:.4f} ms ({row['tflops']:.1f} "
                f"TFLOP/s, {row['bound_ms'] / t_new:.1%} of its {row['bound_ms']:.4f} ms bound); "
                f"mma_sync body {t_old:.4f} ms ({flops / t_old / 1e9:.1f} TFLOP/s); library "
                f"{row['library_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms; mean |c - "
                f"c_float64| on {k} images kernel {drift:.2e} plain {drift_p:.2e}")
            if sweep:  # every channel group at the plan's tile and at a row a warpgroup
                times = []
                for cg in cf.CHANNEL_GROUPS:
                    for tile in {(plan.tile_h, plan.tile_w, plan.wg_stride), (2, 64, 66)}:
                        q = cf.Plan("wgmma", cg, *tile)
                        check_out(f"{wrapper.__name__} layer {layer} {_plan_str(q)}",
                                  cf.launch(srcs, wks, b, c_prev, stream, plan=q), ref)
                        ms = cuda_ms(lambda: cf.launch(srcs, wks, b, c_prev, stream, plan=q),
                                     iters)
                        times.append(f"{_plan_str(q)}{'*' if q == plan else ''} {ms:.4f} ms")
                log("    plans (* the wrapper's): " + ", ".join(times))
            del srcs, c_prev, h, c, ref
        total = {key: sum(r[key] for r in layers)
                 for key in ("ms", "mma_sync_ms", "library_ms", "plain_ms", "bound_ms", "ops_ms",
                             "bytes_ms")}
        return dict(
            max_abs_err=err, ms=total["ms"], plain_ms=total["plain_ms"],
            bound_ms=total["bound_ms"],
            bound_by="operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes",
            library_ms=total["library_ms"], mma_sync_ms=total["mma_sync_ms"], layers=layers)

    # ragged shapes: image edges inside a tile, channel counts not a multiple
    # of 16 (40) or of 8 (12: the mma_sync body, staged without cp.async), C
    # not a multiple of 16; every plan, both state types, one to three
    # sources; and a source 2 bytes off its alignment (the mma_sync body)
    for B, H, W, cins, C, state in RAGGED_CASES:
        srcs = [torch.randn(B, H, W, ci, device="cuda", generator=gen).bfloat16() for ci in cins]
        wks = [cf.pack_gate_weight(torch.randn(3, 3, ci, 4 * C, device="cuda", generator=gen)
                                   .mul_(0.1)) for ci in cins]
        b = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.1)
        c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).to(getattr(torch, state))
        ref = cf.convlstm_layer_plain(srcs, wks, b, c_prev)
        wrapper = cf.fused_convlstm_layer_multi if len(cins) > 1 else cf.fused_convlstm_layer
        before = dict(wrapper.body_launches)
        out = (wrapper(srcs, wks, b, c_prev) if len(cins) > 1
               else wrapper(srcs[0], wks[0], b, c_prev))
        torch.cuda.synchronize()
        label = f"ragged {B}x{H}x{W} {cins} C={C} {state}"
        e = check_out(label, out, ref)
        plan = cf.plan_for(srcs, wks, c_prev)
        want = "wgmma" if all(ci % 8 == 0 for ci in cins) else "mma_sync"
        if not (plan.body == want
                and wrapper.body_launches[want] == before[want] + 1):
            raise AssertionError(f"{label}: took {plan}, by body {wrapper.body_launches}")
        plans = [cf.Plan("mma_sync", 16, 0, tw, 0) for tw in cf.tile_candidates(W)]
        if want == "wgmma":
            plans += [cf.Plan("wgmma", cg, *tile) for cg, tile in RAGGED_PLANS]
            off = torch.empty(srcs[0].numel() + 1, dtype=srcs[0].dtype,
                              device="cuda")[1:].view(srcs[0].shape).copy_(srcs[0])
            if cf.plan_for([off, *srcs[1:]], wks, c_prev).body != "mma_sync":
                raise AssertionError(f"{label}: a source 2 bytes off its alignment took the "
                                     f"wgmma body")
            e = max(e, check_out(f"{label} unaligned", wrapper([off, *srcs[1:]], wks, b, c_prev)
                                 if len(cins) > 1 else wrapper(off, wks[0], b, c_prev), ref))
        for q in plans:
            e = max(e, check_out(f"{label} {_plan_str(q)}",
                                 cf.launch(srcs, wks, b, c_prev, stream, plan=q), ref))
        log(f"  {label}: err {e:.2e}, {_plan_str(plan)}, at {len(plans)} plans")

    fused_src = "evolutionary_illusion_generator_tpu_torch/csrc/convlstm_fused.cu"
    multi = conv_case(cf.fused_convlstm_layer_multi,
                      [(l + 1, s) for l, s in enumerate(MULTI_LAYERS)])
    multi["north_star"] = conv_case(cf.fused_convlstm_layer_multi,
                                    [(l + 1, s) for l, s in enumerate(NORTH_STAR_LAYERS)],
                                    B=NORTH_STAR_CHUNK, sweep=False)
    results["fused_convlstm_layer_multi"] = dict(
        route="cuda", source=fused_src,
        replaces="evolutionary_illusion_generator_tpu/ops/convlstm_fused_pallas.py:188", **multi)
    results["fused_convlstm_layer"] = dict(
        route="cuda", source=fused_src,
        replaces="evolutionary_illusion_generator_tpu/ops/convlstm_fused_pallas.py:74",
        **conv_case(cf.fused_convlstm_layer, [(1, SINGLE_LAYER)]))
    ns = multi["north_star"]
    log(f"  fused_convlstm_layer_multi at the north star ({NORTH_STAR_CHUNK} x 480x640), a step "
        f"of layers 1-3: kernel {ns['ms']:.4f} ms, mma_sync body {ns['mma_sync_ms']:.4f} ms, "
        f"library {ns['library_ms']:.4f} ms, plain {ns['plain_ms']:.4f} ms, bound "
        f"{ns['bound_ms']:.4f} ms ({ns['bound_by']})")
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"  {name}: err {r['max_abs_err']:.2e} kernel {r['ms']:.4f} ms "
            f"plain {r['plain_ms']:.4f} ms library {lib} "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


@phase("reference")
def check_reference(params_cuda):
    """The port on the card (kernels) against the port on the CPU (plain
    versions) on a small input: 4 noise images 64x48 at full width."""
    import torch
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import load_or_init
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf

    gen = torch.Generator().manual_seed(1)
    imgs = (torch.rand(4, 48, 64, 3, generator=gen) * 255).to(torch.uint8).float() / 255
    params_cpu = load_or_init(None, (3, 48, 96, 192), device="cpu")
    channels, bf16 = (3, 48, 96, 192), torch.bfloat16

    def rollout(params, device, steps, state=None):
        state = state or model.init_state(4, 48, 64, channels, dtype=bf16, device=device)
        preds = []
        with torch.inference_mode():
            for _ in range(steps):
                state, pred = model.prednet_step(params, state, imgs.to(device),
                                                 compute_dtype=bf16)
                preds.append(pred)
        return state, preds

    # one step from the CPU's state after 3 steps
    state3, _ = rollout(params_cpu, "cpu", 3)
    ref_state, ref_pred = rollout(params_cpu, "cpu", 1, state3)
    state3_cuda = [{k: v.cuda() for k, v in layer.items()} for layer in state3]
    out_state, out_pred = rollout(params_cuda, "cuda", 1, state3_cuda)
    pairs = [(out_pred[0], ref_pred[0])] + [
        (o[k], r[k]) for o, r in zip(out_state, ref_state) for k in "rce"]
    for a, b in pairs:
        if not (a.shape == b.shape and torch.isfinite(a).all()):
            raise AssertionError("step outputs not finite or of the wrong shape")
        d = (a.cpu().float() - b.float()).abs()
        share = (d > 0).float().mean().item()
        if not (d.max().item() <= STEP_ATOL and share <= STEP_DIFF_SHARE):
            raise AssertionError(f"one step on the card disagrees with the CPU: "
                                 f"max {d.max().item():.3e}, {share:.2%} differ")
    diffs = [(a.cpu().float() - b.float()).abs() for a, b in pairs]
    log(f"  one step card vs cpu: max abs {max(d.max().item() for d in diffs):.3e}, at most "
        f"{max((d > 0).float().mean().item() for d in diffs):.2%} of a tensor's elements "
        f"differ, over prediction and states")

    # 22 steps: card vs CPU, and the CPU against itself with the fused
    # layers' float32 sums taken over the concatenated sources
    _, ref = rollout(params_cpu, "cpu", STEPS)
    _, out = rollout(params_cuda, "cuda", STEPS)
    plain = cf.convlstm_layer_plain

    def concat_sums(srcs, wks, b, c_prev):
        x = torch.cat([t.to(bf16).float() for t in srcs], dim=-1).permute(0, 3, 1, 2)
        w = torch.cat([cf.unpack_gate_weight(wk.float()) for wk in wks], dim=1)
        gates = F.conv2d(x, w, padding=1).permute(0, 2, 3, 1) + b.float()
        h, c = cf.lstm_gates_plain(gates, c_prev)
        return h.to(c_prev.dtype), c

    cf.convlstm_layer_plain = concat_sums
    try:
        _, drift = rollout(params_cpu, "cpu", STEPS)
    finally:
        cf.convlstm_layer_plain = plain
    for t in (STEPS - 3, STEPS - 2):  # the population flow pair
        if not (out[t].shape == ref[t].shape and torch.isfinite(out[t]).all()):
            raise AssertionError("rollout frames not finite or of the wrong shape")
        d = (out[t].cpu() - ref[t]).abs()
        dd = (drift[t] - ref[t]).abs()
        log(f"  step {t}: card vs cpu max {d.max().item():.3e} mean {d.mean().item():.3e}; "
            f"cpu reordered sums vs cpu max {dd.max().item():.3e} mean {dd.mean().item():.3e}")
        if not d.mean().item() <= ROLLOUT_MEAN_TOL:
            raise AssertionError("rollout on the card disagrees with the CPU")


def _wrappers():
    """Every kernel wrapper of the port by kernel name."""
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_bisect as cb
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates as cg
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn

    from evolutionary_illusion_generator_tpu_torch.ops import prednet_units as pu

    out = {
        "fused_lstm_gates": cg.fused_lstm_gates,
        "narrow_convlstm_layer": cn.narrow_convlstm_layer,
        "gate_convs": cn.gate_convs,
        "fused_convlstm_layer_multi": cf.fused_convlstm_layer_multi,
        "fused_convlstm_layer": cf.fused_convlstm_layer,
        "ahat_error_unit": pu.ahat_error_unit,
        "a_unit": pu.a_unit,
    }
    for key, (name, _) in BISECT_RUNGS.items():
        out[name] = cb.RUNGS[key]
    return out


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "body_launches"):
            fn.body_launches = dict.fromkeys(fn.body_launches, 0)


UNIT_WRAPPERS = ("ahat_error_unit", "a_unit")
# the wrappers counted by body in the paths' launches
BY_BODY = (*UNIT_WRAPPERS, "narrow_convlstm_layer", "gate_convs", "fused_lstm_gates")
# the gate kernel's layer (H, W, C) under each option that keeps it at layer 0
GATE_LAYERS = {"s2d_l0": (60, 80, 12), "subpixel_up": (120, 160, 3)}
# the True route's layers at 3,48,96,192 and 160x120, (H, W, C)
TRUE_ROUTE_LAYERS = ((120, 160, 3), (60, 80, 48), (30, 40, 96), (15, 20, 192))


def _gate_body(npix, C, types=None):
    """The gate kernel's body at a call of ``npix`` pixels and C channels
    (``convlstm_gates.gates_plan``; ``types``: gate, state and output
    dtypes, bfloat16 by default: the evaluator's), aligned pointers."""
    import torch

    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates as cg

    types = types or (torch.bfloat16,) * 3
    return cg.gates_plan(npix, C, *types, True).body


def _counts():
    """The launches of each wrapper since the last reset, and of each body
    of the units, the narrow layer, the gate convs and the gate kernel
    (``"<wrapper>/<body>"``, which
    :func:`_path_launches` sets out); raises if a fused layer took the
    mma_sync body (every fused layer of the driven paths has sources of
    channels a multiple of 8, 16-byte aligned: the wgmma body, launch for
    launch)."""
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    for name, fn in _wrappers().items():
        bodies = getattr(fn, "body_launches", None)
        if name in BY_BODY:
            counts.update({f"{name}/{body}": n for body, n in bodies.items()})
            if sum(bodies.values()) != fn.launches:
                raise AssertionError(f"{name}: {fn.launches} launches, by body {bodies}")
        elif bodies is not None and bodies != {"wgmma": fn.launches, "mma_sync": 0}:
            raise AssertionError(f"{name}: {fn.launches} launches, by body {bodies}; every "
                                 f"fused layer of the driven paths must take the wgmma body")
    return counts


def _path_launches(passes, steps, pixel="narrow_convlstm_layer", units=UNITS_PER_STEP,
                   compute="bfloat16", gate_body=None):
    """The launches of ``passes`` chunk (or shard) passes of ``steps``
    steps at 3,48,96,192 on the dense "fused" route: the pixel layer's
    wrapper once a step (``pixel``: the narrow kernel's, on its persistent
    body in bfloat16 compute and its mma.sync body in float32 compute, or
    the gate kernel's under s2d and subpixel, on ``gate_body``), the fused
    kernel on three layers, and
    ``units`` Ahat and A units a step (every layer's, but the s2d pixel
    layer's), by body: in bfloat16 compute (the evaluator's) the three wide
    layers' Ahat and two A units on the wgmma bodies, the pixel layer's on
    the direct (Ahat) and im2col (A) bodies; in float32 compute (the
    probe's and the file bus's) every A unit and the wide layers' Ahat
    units on the mma.sync body.  A step that ran a cuDNN A or Ahat conv
    instead, or another body, is off them."""
    n = passes * steps
    wide = "wgmma" if compute == "bfloat16" else "mma_sync"
    out = {pixel: n, "fused_convlstm_layer_multi": n * 3,
           "ahat_error_unit": n * units[0], "a_unit": n * units[1],
           f"ahat_error_unit/{wide}": n * 3, "ahat_error_unit/direct": n * (units[0] - 3),
           f"a_unit/{wide}": n * 2}
    pixel_a = n * (units[1] - 2)
    if pixel_a:
        key = "a_unit/im2col" if compute == "bfloat16" else "a_unit/mma_sync"
        out[key] = out.get(key, 0) + pixel_a
    if pixel == "narrow_convlstm_layer":
        out["narrow_convlstm_layer/" + ("persistent" if compute == "bfloat16" else "mma_sync")] = n
    elif pixel == "fused_lstm_gates":
        out[f"fused_lstm_gates/{gate_body}"] = n
    return {k: v for k, v in out.items() if v or "/" not in k}


def _check_generations(label, generations, steps, records, out, kernels=True,
                       pixel="narrow_convlstm_layer", units=UNITS_PER_STEP, gate_layer=None):
    """The generation count, finite fitness, and each generation's launch
    counts (of a run that wrote ``out``/metrics.jsonl, its generations in
    ``records``): :func:`_path_launches` for each chunk run eagerly, none
    for a chunk replayed as a CUDA graph (its kernels run, but no wrapper
    launches them) or without ``kernels``; the gate kernel's launches (at
    ``gate_layer``, (H, W, C)) on its plan's body at the chunk's rows."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if not len(recs) == len(records) == generations:
        raise AssertionError(f"{label}: ran {len(recs)} generations ({len(records)} recorded)")
    for gen, r in enumerate(records):
        eager = (r["chunks"] - r["replays"]) if kernels else 0
        want = dict.fromkeys(r["launches"], 0)
        body = gate_layer and _gate_body(r["rows"] * gate_layer[0] * gate_layer[1], gate_layer[2])
        want.update(_path_launches(eager, steps, pixel, units, gate_body=body))
        if r["launches"] != want:
            raise AssertionError(f"{label}: generation {gen} kernel launches {r['launches']}, "
                                 f"expected {want} ({r['chunks']} chunks, {r['replays']} "
                                 f"replayed)")
    for r in recs:
        if not all(map(math.isfinite, (r["fitness_mean"], r["fitness_max"],
                                       r["fitness_std"]))):
            raise AssertionError(f"{label}: non-finite fitness {r}")
        log(f"  {label} generation {r['generation']}: pop {r['pop_size']} "
            f"{r['eval_seconds']:.3f} s fitness max {r['fitness_max']:.5f} "
            f"mean {r['fitness_mean']:.5f}")
    log(f"  {label} chunks replayed a generation {[r['replays'] for r in records]}")
    return recs


def run_generations(label, generations, steps, kernels=True, pixel="narrow_convlstm_layer",
                    units=UNITS_PER_STEP, gate_layer=None, **kwargs):
    """``neat_illusion`` on the card, without artifacts; checks the launch
    counts, finite fitness and the generation count.  Returns the launch
    counts, the metrics records and each generation's record
    (:func:`_recorded_generations`)."""
    from evolutionary_illusion_generator_tpu_torch.evolution import neat_illusion

    records = []
    with tempfile.TemporaryDirectory() as out, _recorded_generations(records):
        _reset_counts()
        pop = neat_illusion(out, None, generations=generations, seed=0,
                            save_artifacts=False, quiet=True, device="cuda", **kwargs)
        counts = _counts()
        recs = _check_generations(label, generations, steps, records, out, kernels, pixel,
                                  units, gate_layer)
    log(f"  {label} launches {counts}")
    if pop.generation != generations:
        raise AssertionError(f"{label}: ran {pop.generation} generations")
    return counts, recs, records


@phase("main_path")
def main_path():
    from evolutionary_illusion_generator_tpu_torch.structure import StructureType

    counts, recs, _ = run_generations(
        "main", 2, STEPS, config=None, structure=StructureType.Circles, w=160, h=120,
        channels=(3, 48, 96, 192), c_dim=3)
    log(f"  main s/generation (generation 1): {recs[1]['eval_seconds']:.4f}")
    return counts


@phase("default_color")
def default_color():
    from evolutionary_illusion_generator_tpu_torch.neat import preset
    from evolutionary_illusion_generator_tpu_torch.structure import StructureType

    _, recs, _ = run_generations(
        "default_color", 2, 5 + 2, config=preset("circles").replace(pop_size=40),
        structure=StructureType.CirclesFree, w=320, h=240, channels=(3, 48, 96, 192),
        c_dim=3, repeat=5)
    log(f"  default_color s/generation (generation 1): {recs[1]['eval_seconds']:.4f}")


@phase("cli")
def cli_run(keep_dir):
    """``python -m evolutionary_illusion_generator_tpu_torch.cli -s 1
    --generations 2 --profile_dir ...`` in process: the color predictor at
    full width, 160x120, the circles preset, with its artifacts.  The
    driver's evaluator is wrapped to keep the last generation's results and
    its ``save_best_artifacts`` to time it and take its peak device memory
    (the 800x800 poster is 640,000 CPPN points).  Copies ``best.png`` into
    ``keep_dir`` and returns the launch counts and that copy's path."""
    import torch

    from evolutionary_illusion_generator_tpu_torch import cli
    from evolutionary_illusion_generator_tpu_torch.evolution import driver
    from evolutionary_illusion_generator_tpu_torch.utils.png import read_png
    from evolutionary_illusion_generator_tpu_torch.utils.profiling import TRACE_FILE

    evaluators, artifact_s, records = [], [], []
    with tempfile.TemporaryDirectory() as out, _recorded_generations(records):
        evaluator, save = driver.GenerationEvaluator, driver.save_best_artifacts

        class Recording(evaluator):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                evaluators.append(self)

        def timed_save(*a, **kw):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            save(*a, **kw)
            artifact_s.append((time.time() - t0, torch.cuda.max_memory_allocated() - base))

        prof = os.path.join(out, "prof")
        driver.GenerationEvaluator, driver.save_best_artifacts = Recording, timed_save
        try:
            _reset_counts()
            cli.main(["-o", out, *CLI_ARGS, "--profile_dir", prof])
            counts = _counts()
        finally:
            driver.GenerationEvaluator, driver.save_best_artifacts = evaluator, save
        recs = _check_generations("cli", 2, STEPS, records, out)
        log(f"  cli launches {counts}")
        pngs = {}
        for name, shape in (("best.png", CLI_SHAPE), ("best_flow.png", CLI_SHAPE),
                            ("best_black_bg.png", CLI_SHAPE), ("enhanced.png", (800, 800, 3))):
            img, mode = read_png(os.path.join(out, name))
            if img.shape != shape or img.dtype.name != "uint8":
                raise AssertionError(f"cli: {name} decodes to {img.shape} {img.dtype} ({mode}), "
                                     f"expected {shape} uint8")
            pngs[name] = img
        res = evaluators[-1].last_results
        row = res["best_row"]
        winner = res["outputs"].fetch("images_u8", row)
        if not (winner.shape == CLI_SHAPE and (pngs["best.png"] == winner).all()):
            raise AssertionError("cli: best.png is not the winner's rendered row")
        vectors = res["vectors"][row][res["mask"][row]]
        starts = {(int(y), int(x)) for x, y in vectors[:, :2]
                  if 0 <= x < CLI_SHAPE[1] and 0 <= y < CLI_SHAPE[0]}
        if not starts:
            raise AssertionError("cli: the winner has no flow vector in the image")
        off = [p for p in starts if tuple(pngs["best_flow.png"][p]) != OVERLAY_RED]
        if off:
            raise AssertionError(f"cli: best_flow.png lacks the overlay colour at {off[:5]}")
        with open(os.path.join(prof, TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        found = {name: sum(key in k for k in kernels) for name, (key, _) in TRACE_KERNELS.items()}
        want = {name: n for name, (_, n) in TRACE_KERNELS.items()}
        if found != want:
            raise AssertionError(f"cli: the trace holds {found} kernel events, expected {want}")
        best = shutil.copy(os.path.join(out, "best.png"), keep_dir)
    log(f"  cli: {len(vectors)} winner vectors; trace of generation 1: {len(kernels)} kernel "
        f"events, {found}")
    log("  cli save_best_artifacts s/generation (device memory above its start): "
        + ", ".join(f"{t:.4f} ({peak / 2**20:.1f} MiB)" for t, peak in artifact_s))
    log(f"  cli s/generation (generation 1): {recs[1]['eval_seconds']:.4f}")
    return counts, best


@phase("probe")
def probe_run(png, card):
    """The single-image probe on the cli phase's ``best.png`` with the
    bundled color predictor at full width, 160x120, on the card; then the
    reference's file bus on the same image and model, whose vectors must
    equal the probe's: the same kernels at the same shapes, and the probe's
    PNG quantisation in place of the files' 8 bits."""
    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch import compat
    from evolutionary_illusion_generator_tpu_torch.evolution import probe
    from evolutionary_illusion_generator_tpu_torch.ops.fitness.metrics_np import swarm_score
    from evolutionary_illusion_generator_tpu_torch.structure import StructureType

    _reset_counts()
    t0 = time.time()
    vectors = probe.get_vectors(png, None, PROBE_CHANNELS)
    t1 = time.time()
    score = probe.score_image(png, StructureType.Circles, None, PROBE_CHANNELS)
    t2 = time.time()
    with tempfile.TemporaryDirectory() as out:
        compat.test_prednet("", [[png] * 20], [160, 120], PROBE_CHANNELS, output_dir=out,
                            extension_start=20, extension_duration=2)
        t3 = time.time()
        bus = compat.lucas_kanade(png, os.path.join(out, f"{21:010d}_extended.png"))
        t4 = time.time()
    counts = _counts()
    torch.cuda.synchronize()
    want = dict.fromkeys(counts, 0)
    want.update(_path_launches(PROBE_ROLLOUTS, STEPS, compute="float32"))
    if counts != want:
        raise AssertionError(f"probe: kernel launches {counts}, expected {want}")
    if not (vectors.ndim == 2 and vectors.shape[1] == 4 and np.isfinite(vectors).all()
            and len(vectors) and math.isfinite(score)):
        raise AssertionError(f"probe: vectors {vectors.shape}, score {score}")
    bus = np.asarray(bus["vectors"], np.float32).reshape(-1, 4)
    if bus.shape != vectors.shape or not np.array_equal(bus, vectors):
        far = (f"max |difference| {np.abs(bus - vectors).max():.3e}"
               if bus.shape == vectors.shape else "shapes differ")
        raise AssertionError(f"probe: the file bus's {bus.shape} vectors differ from the "
                             f"probe's {vectors.shape} ({far})")
    log(f"  probe: {len(vectors)} vectors, score {swarm_score(vectors):.6f}, fitness (circles) "
        f"{score:.6f}; equal to the file bus's {len(bus)} vectors")
    log(f"  probe seconds: get_vectors {t1 - t0:.4f}, score_image {t2 - t1:.4f}; file bus: "
        f"test_prednet {t3 - t2:.4f}, lucas_kanade {t4 - t3:.4f} ({card})")
    log(f"  probe launches {counts}")
    return counts


ANALYSIS_CHANNELS = (1, 16, 32, 64)  # the bundled grayscale stack, the scripts' BW
# the stand-in rated directory: file -> (source, mode); "best" is the cli
# phase's best.png (mirrored for manyfish), a number a ring period of
# period_response's, "grey" a uniform control that finds no corner
STAND_INS = {"rotate_01/small.png": ("best", "L"), "rotate_02/small.png": (12.0, "L"),
             "expand_01/small.png": (8.0, "L"), "expand_02/small.png": (20.0, "L"),
             "color_01_expand/small.png": ("best", "RGB"),
             "color_02_expand/small.png": (16.0, "RGB"),
             "manyfish/manyfish-small.png": ("mirrored", "RGB"),
             "control/small.png": ("grey", "L")}
GALLERY_RUN, GALLERY_CHECKPOINTS = "circles_bw", (10, 20, 30)
GALLERY_FILES = ("best.png", "best_flow.png", "best_black_bg.png", "enhanced.png",
                 "metrics.jsonl", *(f"neat-checkpoint-{g}" for g in GALLERY_CHECKPOINTS))


def _stack_launches(channels, steps, compute):
    """The launches of ``steps`` dense "fused"-route steps of one chunk at
    ``channels`` in ``compute`` dtype, by wrapper and body, from the
    model's routing (the fused kernel at C >= 32, else the narrow kernel)
    and the host plans' bodies (``narrow_body``, ``unit_body``)."""
    import collections

    from evolutionary_illusion_generator_tpu_torch.models.prednet.model import (
        FUSED_MIN_CHANNELS,
    )
    from evolutionary_illusion_generator_tpu_torch.ops.convlstm_narrow import narrow_body
    from evolutionary_illusion_generator_tpu_torch.ops.prednet_units import unit_body

    out = collections.Counter()
    for l, C in enumerate(channels):
        above = channels[l + 1] if l + 1 < len(channels) else None
        if C >= FUSED_MIN_CHANNELS:
            out["fused_convlstm_layer_multi"] += steps
        else:
            out["narrow_convlstm_layer"] += steps
            out[f"narrow_convlstm_layer/{narrow_body(C, above, compute)}"] += steps
        out["ahat_error_unit"] += steps
        out[f"ahat_error_unit/{unit_body('ahat', C, C, compute)}"] += steps
        if above:
            out["a_unit"] += steps
            out[f"a_unit/{unit_body('a', 2 * C, above, compute)}"] += steps
    return dict(out)


def _stand_ins(out_dir, best_png, rings):
    """The reference's rated layout under ``out_dir`` (:data:`STAND_INS`):
    mode L and RGB PNGs from ``best_png`` and the ring images ``rings``
    (period -> (H, W, 1) float), and a uniform grey control."""
    import numpy as np

    from evolutionary_illusion_generator_tpu_torch.utils.png import convert, read_png, write_png

    best, mode = read_png(best_png)
    for rel, (src, want) in STAND_INS.items():
        if src == "best":
            img = convert(best, mode, want)
        elif src == "mirrored":
            img = convert(best[:, ::-1].copy(), mode, want)
        elif src == "grey":
            img = np.full(best.shape[:2], 128, np.uint8)
        else:
            img = convert((rings[src][..., 0] * 255).astype(np.uint8), "L", want)
        os.makedirs(os.path.join(out_dir, os.path.dirname(rel)), exist_ok=True)
        write_png(os.path.join(out_dir, rel), img)
    return out_dir


@phase("analysis")
def analysis_phase(best_png, card):
    """The ports of the repo-root analysis and gallery scripts on the card,
    each through its ``main``: ``period_response`` at full width (the
    bundled grayscale stack, nine periods, 160x120, bfloat16) against the
    port's CPU run of the same script (the rings equal, the flow frames in
    the mean, every period with vectors), launches by wrapper and body;
    on a stand-in rated directory (the stimuli are not in the repository)
    ``probe_rated`` as is, with ``--s2d`` (the gate kernel on the s2d pixel
    layer), ``--int8`` (no kernel) and ``--lk_bf16``, ``compare_probes`` on
    two of their JSONs, ``probe_breakdown``, ``field_anatomy --color``,
    ``drift_diag`` and ``cache_probe_vectors`` into a temporary cache (the
    control at 0.0, the ``sha/`` keys the bundled files'); then
    ``make_gallery circles_bw`` whole into a temporary ``GALLERY`` (30
    generations, pop 24, its artifact contract, finite fitness, each eager
    chunk's launches).  Logs each step's seconds beside the card.  Returns
    the launches summed over the steps."""
    import hashlib
    import io

    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
        bundled_weights_path,
    )
    from evolutionary_illusion_generator_tpu_torch.scripts import (
        cache_probe_vectors,
        compare_probes,
        drift_diag,
        field_anatomy,
        make_gallery,
        period_response,
        probe_breakdown,
        probe_rated,
    )

    totals, seconds = {}, {}

    def run(label, fn, *args, tail=None):
        """``fn(*args)`` with its stdout logged (the last ``tail`` lines),
        its seconds and launches kept (the counts zeroed just before)."""
        buf = io.StringIO()
        _reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        torch.cuda.synchronize()
        seconds[label] = time.time() - t0
        counts = _counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for line in buf.getvalue().splitlines()[-tail if tail else 0:]:
            log(f"  {label} | {line}")
        return out, counts

    def no_gate_and_some(label, counts, gate=0):
        if counts["fused_lstm_gates"] != gate:
            raise AssertionError(f"{label}: {counts['fused_lstm_gates']} gate-kernel launches, "
                                 f"expected {gate}")
        for name in ("narrow_convlstm_layer", "fused_convlstm_layer_multi", "ahat_error_unit",
                     "a_unit"):
            if not counts[name]:
                raise AssertionError(f"{label}: no {name} launch ({counts})")

    # period_response: the card, then the port's CPU run of the same script
    card_out, counts = run("period_response", period_response.main, [])
    cpu_out, _ = run("period_response (cpu)", period_response.main, ["--device", "cpu"])
    periods = [row["period"] for row in card_out["rows"]]
    want = dict.fromkeys(counts, 0)
    want.update(_stack_launches(ANALYSIS_CHANNELS, STEPS, torch.bfloat16))
    if counts != want:
        raise AssertionError(f"period_response: kernel launches {counts}, expected {want}")
    for t, (a, b) in enumerate(zip(card_out["frames"], cpu_out["frames"])):
        if not (a.shape == b.shape == (len(periods), 120, 160, 1) and np.isfinite(a).all()):
            raise AssertionError(f"period_response: frame {t} {a.shape} not finite or not "
                                 f"the CPU's {b.shape}")
        d = np.abs(a - b)
        log(f"  period_response frame {t} card vs cpu: max {d.max():.3e} mean {d.mean():.3e}")
        if not d.mean() <= ROLLOUT_MEAN_TOL:
            raise AssertionError("period_response: the card's frames disagree with the CPU's")
    if not all(row["n"] > 0 for rows in (card_out["rows"], cpu_out["rows"]) for row in rows):
        raise AssertionError("period_response: a period without flow vectors")
    log(f"  period_response launches {counts}")

    rings = dict(zip(periods, period_response.rings(periods)))
    with tempfile.TemporaryDirectory() as tmp:
        rated = _stand_ins(os.path.join(tmp, "EIGEN-images"), best_png, rings)
        for mod in (probe_rated, probe_breakdown, field_anatomy, drift_diag,
                    cache_probe_vectors):
            mod.RATED_DIR = rated
        jsons = {}
        for option in ("", "--s2d", "--int8", "--lk_bf16"):
            label = "probe_rated " + (option or "as is")
            jsons[option] = os.path.join(tmp, f"probe{option}.json")
            doc, counts = run(label, probe_rated.main,
                              ["--json", jsons[option]] + ([option] if option else []))
            res = doc["results"]
            if not (len(res) == 8 and res["control"]["ours"] == 0.0
                    and res["control"]["n_vectors"] == 0
                    and all(math.isfinite(r["ours"]) for r in res.values())
                    and sum(r["n_vectors"] for r in res.values()) > 0):
                raise AssertionError(f"{label}: results {res}")
            if option == "--int8":
                if any(counts.values()):
                    raise AssertionError(f"{label}: kernel launches {counts}, expected none")
            else:
                no_gate_and_some(label, counts, STEPS * 8 if option == "--s2d" else 0)
            log(f"  {label} launches {counts}")
        run("compare_probes", compare_probes.main, [jsons[""], jsons["--s2d"]])
        for label, fn, args in (("probe_breakdown", probe_breakdown.main, []),
                                ("field_anatomy", field_anatomy.main, ["--color"]),
                                ("drift_diag", drift_diag.main, [])):
            out, counts = run(label, fn, args)
            no_gate_and_some(label, counts)
            if len(out) != {"probe_breakdown": 8, "field_anatomy": 6, "drift_diag": 5}[label]:
                raise AssertionError(f"{label}: {len(out)} rows")
        floors = os.path.join(tmp, "floors.json")
        with open(floors, "w") as f:
            json.dump({"margin": 0.005, "floors": {}, "aggregates": {}}, f)
        cache = os.path.join(tmp, "probe_vectors.npz")
        scores, counts = run("cache_probe_vectors", cache_probe_vectors.main,
                             ["--out", cache, "--floors", floors])
        no_gate_and_some("cache_probe_vectors", counts)
        with np.load(cache) as npz:
            for stack in (cache_probe_vectors.BW, cache_probe_vectors.COLOR):
                with open(bundled_weights_path(stack), "rb") as f:
                    sha = hashlib.sha256(f.read()).digest()
                if npz["sha/" + "_".join(map(str, stack))].tobytes() != sha:
                    raise AssertionError(f"cache_probe_vectors: sha of {stack} differs")
            if not (scores["control"] == 0.0 and npz["vec/control"].size == 0):
                raise AssertionError("cache_probe_vectors: the control scores "
                                     f"{scores['control']}")

        # make_gallery: one run whole, into a temporary GALLERY
        make_gallery.GALLERY = os.path.join(tmp, "gallery")
        records = []
        with _recorded_generations(records):
            best, counts = run("make_gallery " + GALLERY_RUN, make_gallery.main, [GALLERY_RUN],
                               tail=4)
        run_dir = os.path.join(make_gallery.GALLERY, GALLERY_RUN)
        missing = [f for f in GALLERY_FILES if not os.path.exists(os.path.join(run_dir, f))]
        if missing:
            raise AssertionError(f"make_gallery: {GALLERY_RUN} lacks {missing}")
        kwargs = make_gallery._runs()[GALLERY_RUN][0]
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if not (len(recs) == len(records) == kwargs["generations"]
                and all(math.isfinite(r["fitness_max"]) for r in recs)
                and math.isfinite(best[GALLERY_RUN])):
            raise AssertionError(f"make_gallery: {len(recs)} generations, best {best}")
        for gen, r in enumerate(records):
            want = dict.fromkeys(r["launches"], 0)
            eager = r["chunks"] - r["replays"]
            want.update({k: v * eager for k, v in
                         _stack_launches(ANALYSIS_CHANNELS, STEPS, torch.bfloat16).items()})
            if r["launches"] != want:
                raise AssertionError(f"make_gallery: generation {gen} launches {r['launches']}, "
                                     f"expected {want}")
        evals = [r["eval_seconds"] for r in recs]
        log(f"  make_gallery {GALLERY_RUN}: {len(recs)} generations, pop "
            f"{kwargs['config'].pop_size}, best fitness {best[GALLERY_RUN]:.6f}; s/generation "
            f"{seconds['make_gallery ' + GALLERY_RUN] / len(recs):.4f} wall, eval_seconds "
            f"median {sorted(evals)[len(evals) // 2]:.4f} (generation 1 {evals[1]:.4f}); "
            f"chunks replayed a generation {[r['replays'] for r in records]}")
    log(f"  analysis seconds ({card}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    log(f"  analysis launches {totals}")
    return totals


@contextlib.contextmanager
def _eval_options(**opt):
    """``neat_illusion`` builds its ``EvalConfig`` with ``opt`` added: the
    driver takes the JAX driver's arguments, which do not name the
    predictor's options or the program cache."""
    from evolutionary_illusion_generator_tpu_torch.evolution import driver

    make = driver.EvalConfig
    driver.EvalConfig = lambda **kw: make(**kw, **opt)
    try:
        yield
    finally:
        driver.EvalConfig = make


@contextlib.contextmanager
def _recorded_generations(records):
    """Each generation's vectors, masks and fitness, its kernel launches,
    its chunks and how many of them were replayed as a CUDA graph, appended
    to ``records`` by the driver's evaluator."""
    import numpy as np

    from evolutionary_illusion_generator_tpu_torch.evolution import driver

    evaluator = driver.GenerationEvaluator

    class Recording(evaluator):
        def __call__(self, *a, **kw):
            counts, replays = _counts(), self._programs.replays
            scores = super().__call__(*a, **kw)
            res = self.last_results
            records.append(dict(
                vectors=res["vectors"].copy(), masks=res["mask"].copy(),
                fitness=np.array(scores), chunks=len(res["outputs"]._chunks),
                rows=res["outputs"]._shard_rows,
                replays=self._programs.replays - replays,
                launches={k: v - counts[k] for k, v in _counts().items()}))
            return scores

    driver.GenerationEvaluator = Recording
    try:
        yield
    finally:
        driver.GenerationEvaluator = evaluator


def _step_card_vs_cpu(label, params_cpu, params_cuda, **opt):
    """One step of an option's route on the card against the port on the
    CPU, from the CPU's state after 3 steps, with the reference phase's
    rules (4 noise images 64x48, bf16 compute, the bundled weights)."""
    import torch

    from evolutionary_illusion_generator_tpu_torch.models.prednet import model

    gen = torch.Generator().manual_seed(1)
    imgs = (torch.rand(4, 48, 64, 3, generator=gen) * 255).to(torch.uint8).float() / 255
    s2d = opt.get("s2d_l0", False)
    frame = model._s2d(imgs) if s2d else imgs
    bf16 = torch.bfloat16

    def steps(params, device, n, state=None):
        state = state or model.init_state(4, 48, 64, (3, 48, 96, 192), dtype=bf16,
                                          device=device, s2d_l0=s2d)
        with torch.inference_mode():
            for _ in range(n):
                state, pred = model.prednet_step(params, state, frame.to(device),
                                                 compute_dtype=bf16, **opt)
        return state, pred

    # the layout weights, made once as the evaluator makes them
    params_cpu, params_cuda = (model.with_layout_weights(p, **opt)
                               for p in (params_cpu, params_cuda))
    state3, _ = steps(params_cpu, "cpu", 3)
    ref_state, ref_pred = steps(params_cpu, "cpu", 1, state3)
    out_state, out_pred = steps(params_cuda, "cuda", 1,
                                [{k: v.cuda() for k, v in l.items()} for l in state3])
    pairs = [(out_pred, ref_pred)] + [(o[k], r[k]) for o, r in zip(out_state, ref_state)
                                      for k in "rce"]
    worst, share = 0.0, 0.0
    for a, b in pairs:
        if not (a.shape == b.shape and torch.isfinite(a).all()):
            raise AssertionError(f"{label}: step outputs not finite or of the wrong shape")
        d = (a.cpu().float() - b.float()).abs()
        worst, share = max(worst, d.max().item()), max(share, (d > 0).float().mean().item())
    if not (worst <= STEP_ATOL and share <= STEP_DIFF_SHARE):
        raise AssertionError(f"{label}: one step on the card disagrees with the CPU: max "
                             f"{worst:.3e}, {share:.2%} of a tensor differ")
    log(f"  {label} one step card vs cpu: max abs {worst:.3e}, at most {share:.2%} of a "
        f"tensor's elements differ")


@phase("options")
def options_phase(params, png, card):
    """The predictor's options, the program cache and the sanitizer at the
    main path's shape with the bundled weights (the module docstring's
    list); returns the launches of the runs that drive a path."""
    import copy
    import io

    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.evolution import (
        EvalConfig,
        GenerationEvaluator,
        probe,
    )
    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import load_or_init
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
    from evolutionary_illusion_generator_tpu_torch.structure import StructureType

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    main = dict(config=None, structure=StructureType.Circles, w=160, h=120,
                channels=PROBE_CHANNELS, c_dim=3)
    params_cpu = load_or_init(None, PROBE_CHANNELS, device="cpu")
    for name, opt in OPTIONS:
        int8 = "prednet_int8" in opt
        # s2d and subpixel keep the gate kernel at layer 0; s2d its lifted A
        # and Ahat convs there
        units = (3, 2) if "s2d_l0" in opt else UNITS_PER_STEP
        with _eval_options(**opt):
            counts, recs, _ = run_generations(name, 2, STEPS, kernels=not int8,
                                              pixel="fused_lstm_gates", units=units,
                                              gate_layer=GATE_LAYERS.get(name), **main)
        add(counts)
        log(f"  {name} s/generation (generation 1): {recs[1]['eval_seconds']:.4f} ({card})")
        if int8:  # the codes quantised on the card equal the CPU's
            q_cpu, q_cuda = (model.quantize_params_int8(p) for p in (params_cpu, params))
            for a, b in zip(q_cpu, q_cuda):
                if a.keys() != b.keys() or not all(torch.equal(a[k], b[k].cpu()) for k in a):
                    raise AssertionError("prednet_int8: the card's int8 params differ from the CPU's")
            _step_card_vs_cpu(name, q_cpu, q_cuda)
        else:
            _step_card_vs_cpu(name, params_cpu, params, **opt)

    # the program cache: the main path replayed as a CUDA graph, and eager.
    # run_generations checked each generation's launches against its eager
    # chunks; the wrappers count only what they launch themselves, so the
    # two runs' launches are compared where both ran eagerly, and the
    # profile phase counts a replay's kernels in the trace
    runs = {}
    for on in (True, False):
        with _eval_options(program_cache=on):
            counts, recs, records = run_generations(f"program_cache={on}", PROGRAM_GENERATIONS,
                                                    STEPS, **main)
        add(counts)
        runs[on] = (records, recs)
    (graph, g_recs), (eager, e_recs) = runs[True], runs[False]
    replayed = [gen for gen, r in enumerate(graph) if r["replays"]]
    if any(r["replays"] for r in eager) or PROGRAM_GENERATIONS - 1 not in replayed:
        raise AssertionError(f"program_cache: generations {replayed} replayed with the graph, "
                             f"{[r['replays'] for r in eager]} chunks without")
    for gen, (a, b) in enumerate(zip(graph, eager)):
        for what in ("vectors", "masks", "fitness"):
            if not np.array_equal(a[what], b[what]):
                raise AssertionError(f"program_cache: generation {gen} {what} differ between "
                                     f"the graph replay and the eager pass")
        if gen not in replayed and a["launches"] != b["launches"]:
            raise AssertionError(f"program_cache: generation {gen} launched {a['launches']} "
                                 f"with the graph, {b['launches']} without")
    log(f"  program_cache: {PROGRAM_GENERATIONS} generations, vectors, masks and fitness "
        f"bit-equal with and without the graph; generations {replayed} replayed, the others "
        f"with equal launches")
    for gen in range(1, PROGRAM_GENERATIONS):
        log(f"  program_cache s/generation (generation {gen}): graph "
            f"{g_recs[gen]['eval_seconds']:.4f}, eager {e_recs[gen]['eval_seconds']:.4f} ({card})")

    # the sanitizer: silent on a clean generation, names the kernel on a NaN
    ncfg = preset("circles")
    items = list(Population(ncfg, seed=0).population.items())
    _reset_counts()
    plain = GenerationEvaluator(EvalConfig(), params, ncfg, device="cuda")
    checked = GenerationEvaluator(EvalConfig(debug_nans=True), params, ncfg, device="cuda")
    ref = plain(copy.deepcopy(items))
    t0 = time.time()
    got = checked(copy.deepcopy(items))
    checked_s = time.time() - t0
    if not np.array_equal(ref, got):
        raise AssertionError(f"debug_nans: fitness {got} under the sanitizer, {ref} without")
    # a NaN in layer 2's bias reaches an op the mode sees inside the fused
    # kernel's wrapper (its cast); one in its packed lstm_k_r only the
    # kernel reads, so the wrapper's own check of the kernel's outputs
    # must catch it
    clean = checked.params[2]
    for key, want in (("lstm_b", " inside fused_convlstm_layer_multi"),
                      ("lstm_k_r", "debug_nans: NaN in the output of fused_convlstm_layer_multi")):
        checked.params[2] = dict(clean, **{key: clean[key].clone()})
        checked.params[2][key].view(-1)[0] = float("nan")
        try:
            checked(copy.deepcopy(items))
        except FloatingPointError as err:
            if not (str(err).endswith(want) if key == "lstm_b" else str(err) == want):
                raise AssertionError(f"debug_nans: the NaN in {key} raised {err!r}") from err
            log(f"  debug_nans: the NaN in layer 2's {key}: {err}")
        else:
            raise AssertionError(f"debug_nans: the NaN planted in layer 2's {key} raised nothing")
    checked.params[2] = clean
    log(f"  debug_nans: a clean generation {checked_s:.4f} s, fitness equal to the run "
        f"without it ({card})")
    add(_counts())

    # the probe's --int8 and --s2d on the cli phase's best.png
    for flag, want in (("int8", 0), ("s2d", STEPS)):  # int8: no kernel
        _reset_counts()
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            probe.main(["-i", png, f"--{flag}"])
        main_s = time.time() - t0
        vectors = probe.get_vectors(png, None, PROBE_CHANNELS, **{flag: True})
        counts = _counts()
        expect = dict.fromkeys(counts, 0)
        # two probe rollouts of one image; s2d: the gate kernel (float32 gates,
        # bfloat16 state) and the lifted convs at layer 0
        body = _gate_body(60 * 80, 12, (torch.float32, torch.bfloat16, torch.bfloat16))
        expect.update(_path_launches(2, want, "fused_lstm_gates", (3, 2), compute="float32",
                                     gate_body=body))
        score = float(out.getvalue().split("score", 1)[1].split()[0])
        if counts != expect or not (math.isfinite(score) and np.isfinite(vectors).all()):
            raise AssertionError(f"probe --{flag}: launches {counts}, score {score}")
        add(counts)
        log(f"  probe --{flag}: {len(vectors)} vectors, score {score:.6f}, main {main_s:.4f} s "
            f"({card}); vectors {np.round(vectors[:3], 3).tolist()}...")
    log(f"  options launches {total}")
    return total


@phase("scorers")
def scorers(params, card):
    """One generation of the ``default_color`` shape (CirclesFree, 320x240,
    pop 40, repeat 5) with each scoring back end on the same population:
    the C++ scorer must have been built here (``score_backend="native"``
    raises otherwise); each run's scores are held against float64 numpy
    scores of that run's own vectors."""
    import copy

    import numpy as np

    from evolutionary_illusion_generator_tpu_torch.evolution import (
        EvalConfig,
        GenerationEvaluator,
    )
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
    from evolutionary_illusion_generator_tpu_torch.ops.fitness import native
    from evolutionary_illusion_generator_tpu_torch.ops.fitness.calculate import score_vectors
    from evolutionary_illusion_generator_tpu_torch.structure import StructureType

    cfg = preset("circles").replace(pop_size=40)
    items = list(Population(cfg, seed=0).population.items())
    if not native.is_available():
        raise AssertionError("scorers: the C++ scorer did not build on this machine")
    log(f"  native scorer built: {native.library_path()}")
    _reset_counts()
    runs = {}
    for name, kw in SCORER_BACKENDS:
        ev = GenerationEvaluator(EvalConfig(structure=StructureType.CirclesFree, w=320, h=240,
                                            repeat=5, **kw), params, cfg, device="cuda")
        scores = ev(copy.deepcopy(items))
        res = ev.last_results
        host = np.array([score_vectors(StructureType.CirclesFree, v[m], 320, 240)
                         for v, m in zip(res["vectors"], res["mask"])])
        host = np.where(np.isfinite(host), host, 0.0)  # the evaluator's nan_to_zero
        runs[name] = (scores, host, res["vectors"], dict(ev.last_timings))
    counts = _counts()
    want = dict.fromkeys(counts, 0)
    want.update(_path_launches(len(SCORER_BACKENDS), SCORER_STEPS))
    if counts != want:
        raise AssertionError(f"scorers: kernel launches {counts}, expected {want}")
    scores, host, _, _ = runs["numpy"]
    if not np.array_equal(scores, host):
        raise AssertionError("scorers: numpy backend differs from the numpy scores")
    scores, host, _, _ = runs["native"]
    nd = np.abs(scores - host)
    if not nd.max() <= NATIVE_ATOL:
        raise AssertionError(f"scorers: native scores differ from numpy by {nd.max():.3e}")
    scores, host, _, _ = runs["device"]
    np.testing.assert_allclose(scores, host, rtol=DEVICE_RTOL, atol=DEVICE_ATOL)
    if list(np.argsort(scores, kind="stable")) != list(np.argsort(host, kind="stable")):
        raise AssertionError("scorers: device scores rank the population differently")
    dd = np.abs(scores - host)
    same = all(np.array_equal(runs[n][2], runs["numpy"][2]) for n in runs)
    log(f"  native vs numpy: {int((nd > 0).sum())} of {len(nd)} scores differ, max "
        f"{nd.max():.3e}; device vs float64 host: max {dd.max():.3e}, same ranking; the three "
        f"runs' vectors {'identical' if same else 'differ'}")
    for name, (_, _, _, timings) in runs.items():
        log(f"  scorer {name}: last_timings score {timings['score']:.6f} s, device "
            f"{timings['device']:.4f} s (pop 40, 320x240; {card})")
    return counts


def _npz(path):
    import numpy as np

    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@phase("train")
def train_phase(card):
    """The PredNet trainer on the card (``models/prednet/pretrain.py``):
    ``pretrain.main`` with the colour stack's shipped recipe at full width,
    warm-started from the bundled weights, for TRAIN_STEPS steps with a
    checkpoint every TRAIN_SAVE_EVERY, from torch's default TF32 setting
    (which ``main`` must turn off); then the same recipe killed after its
    first checkpoint and resumed by ``main``, whose weights must equal the
    uninterrupted run's bit for bit; every parameter must have moved from
    the warm start; the first step's loss and params against the port's
    CPU run of the same seed and shape (the second step's, and the card
    with TF32 turned on around each step, logged only); one
    ``data="v2"`` step, the three-argument step.  The trainer runs the
    plain route (``use_pallas=False``), so no kernel is launched: asserts
    the counts are zero.  Logs s/step, data ms per batch and the peak
    device memory."""
    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain as pre
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
        bundled_weights_path,
        params_to_numpy,
    )

    warm = bundled_weights_path((3, 48, 96, 192))
    timings = {"step": [], "data": [], "loss": []}
    make, data = pre.make_train_step, pre.synthetic_cue_batch

    def timed(fn, name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timings[name].append(time.perf_counter() - t0)
            if name == "step":
                timings["loss"].append(float(out[2]))
            return out
        return run

    _reset_counts()
    # torch's default (TF32 convs), which check_device turned off
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        base = TRAIN_RECIPE + ["--init_weights", warm, "--save_every", str(TRAIN_SAVE_EVERY)]
        argv_a = base + ["--steps", str(TRAIN_STEPS), "--out", os.path.join(tmp, "a.npz")]
        argv_b = base + ["--steps", str(TRAIN_STEPS), "--out", os.path.join(tmp, "b.npz")]
        pre.make_train_step = lambda *a, **kw: timed(make(*a, **kw), "step")
        pre.synthetic_cue_batch = timed(data, "data")
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            pre.main(argv_a)
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
        finally:
            pre.make_train_step, pre.synthetic_cue_batch = make, data
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("train: main left TF32 on")
        losses, steps_s, data_s = timings["loss"], timings["step"], timings["data"]
        if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train: losses {losses}")
        a = _npz(os.path.join(tmp, "a.npz"))
        # killed after the first checkpoint, then resumed by main
        args_b = pre._parser().parse_args(argv_b)
        part = pre.part_path(args_b)
        pre.pretrain(checkpoint=part, verbose=False,
                     **dict(pre.pretrain_kwargs(args_b), steps=TRAIN_SAVE_EVERY + 1))
        with np.load(part) as ck:
            at = int(ck["step"])
        if at != TRAIN_SAVE_EVERY:
            raise AssertionError(f"train: checkpoint at step {at}")
        pre.main(argv_b)
        b = _npz(os.path.join(tmp, "b.npz"))
        if os.path.exists(part):
            raise AssertionError("train: main left its part checkpoint")
    if set(a) != set(b) or not all(np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError("train: the resumed run's weights differ from the uninterrupted run's")
    init = {k: torch.from_numpy(v.astype(np.float32)).bfloat16().float().numpy()
            for k, v in _npz(warm).items()}
    moved = {k: float((a[k] != init[k]).mean()) for k in init}
    if set(moved) != set(a) or min(moved.values()) == 0.0:
        raise AssertionError(f"train: parameters that did not move: "
                             f"{[k for k, v in moved.items() if v == 0.0]}")

    # the card against the CPU, and the card with TF32 on around each step
    kw = dict(pre.pretrain_kwargs(pre._parser().parse_args(
        TRAIN_RECIPE + ["--init_weights", warm])), steps=TRAIN_CHECK_STEPS, verbose=False)

    def run(device, tf32=False):
        """Each step's loss and params (JAX layout) from pretrain."""
        steps = []

        def recording(*a, **k):
            step = make(*a, **k)

            def run_step(*sa, **sk):
                flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
                if tf32:
                    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    out = step(*sa, **sk)
                finally:
                    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
                steps.append((float(out[2]), params_to_numpy(out[0])))
                return out
            return run_step

        pre.make_train_step = recording
        try:
            pre.pretrain(**dict(kw, device=device))
        finally:
            pre.make_train_step = make
        return steps

    on_card, on_card_tf32 = run("cuda"), run("cuda", tf32=True)
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.time()
    cpu = run("cpu")
    cpu_s = time.time() - t0

    def gaps(steps):
        """Per step: the relative loss gap to the CPU's, the largest share
        of a tensor's entries that differ (tensors of 100 entries or more),
        the share over all entries, and the largest excess over one ulp
        plus 2 lr a step (inf where a tensor has more differing entries
        than its allowance)."""
        out = []
        for n, ((loss, params), (loss_cpu, params_cpu)) in enumerate(zip(steps, cpu), 1):
            share, n_diff, n_all, excess = 0.0, 0, 0, -math.inf
            for o, c in zip(params, params_cpu):
                for k in c:
                    gap = np.abs(o[k] - c[k])
                    diff = int((gap > 0).sum())
                    n_diff, n_all = n_diff + diff, n_all + gap.size
                    if gap.size >= 100:
                        share = max(share, diff / gap.size)
                    over = diff > max(1.0, TRAIN_FLIP_SHARE * gap.size)
                    excess = max(excess, math.inf if over else float(
                        (gap - 2.0**-7 * np.abs(c[k])).max()) - 2 * kw["lr"] * n)
            out.append((abs(loss - loss_cpu) / abs(loss_cpu), share, n_diff / n_all, excess))
        return out

    card_gaps, tf32_gaps = gaps(on_card), gaps(on_card_tf32)
    loss_gap, _, _, excess = card_gaps[0]
    if on_card[0][0] != losses[0] or not loss_gap <= TRAIN_LOSS_RTOL or excess > 0:
        raise AssertionError(
            f"train: card losses {[s[0] for s in on_card]} (main's first {losses[0]!r}) vs "
            f"CPU {[s[0] for s in cpu]}: per step (loss gap, largest share of entries "
            f"differing, share over all, excess over the flip rule) {card_gaps}")

    # the three-argument step: v2 data, no masks
    _, loss_v2 = pre.pretrain((3, 48, 96, 192), data="v2", steps=1, init_weights=warm,
                              verbose=False, device="cuda")
    if not math.isfinite(loss_v2):
        raise AssertionError(f"train: v2 step loss {loss_v2}")
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"train: the trainer launched kernels {counts}")

    step_ms = [t * 1e3 for t in steps_s]
    data_ms = [t * 1e3 for t in data_s]
    log(f"  recipe: {' '.join(TRAIN_RECIPE)} (warm start {os.path.basename(warm)})")
    log(f"  losses {[round(x, 6) for x in losses]}; resumed at step {at}, weights equal bit "
        f"for bit; share of each tensor's entries moved: min {min(moved.values()):.4f}")
    log(f"  against the CPU ({cpu_s:.1f} s for {TRAIN_CHECK_STEPS} steps): losses card "
        f"{[s[0] for s in on_card]} (TF32 off), TF32 on {[s[0] for s in on_card_tf32]}, "
        f"CPU {[s[0] for s in cpu]}")
    for label, per_step in (("card", card_gaps), ("control, TF32 on", tf32_gaps)):
        for i, (g, share, total, over) in enumerate(per_step):
            log(f"    {label}, step {i + 1}: relative loss gap {g:.3e}; params differ on at "
                f"most {share:.3e} of a tensor's entries, {total:.3e} of all; excess over "
                f"the flip rule {over:.3e}")
    log(f"  s/step {wall / TRAIN_STEPS:.4f} (main's wall over {TRAIN_STEPS} steps, set-up "
        f"included); step ms {', '.join(f'{t:.1f}' for t in step_ms)}; data ms per batch "
        f"{', '.join(f'{t:.1f}' for t in data_ms)} ({args_b.batch} x "
        f"{args_b.frames + args_b.closed_frames} x {args_b.height} x {args_b.width} x 3)")
    log(f"  peak device memory {peak / 2**30:.3f} GiB; v2 step loss {loss_v2:.6f}; "
        f"kernel launches {counts} ({card})")
    torch.cuda.empty_cache()  # the later phases start without the trainer's blocks
    return counts


# the parallel phase: parallel/ on one card, whose mesh repeats cuda:0 (one
# logical shard per entry; the JAX tests' virtual devices): the sharded
# evaluator at the main path's shape for PARALLEL_GENERATIONS generations
# (a warm-up, a graph capture and replays per shard key), the
# data-parallel train step, a spatial rollout at the pop256_v5e8 frame, a
# pipelined rollout, and two processes sharing the card over gloo
PARALLEL_SHARDS = 2
PARALLEL_GENERATIONS = 3
SPATIAL_SHAPE = (2, 960, 1280, 3)  # (B, H, W, C): the pop256_v5e8 frame
PIPELINE_SHAPE = (8, 120, 160, 3)
# Each shard runs the unsharded pass's kernels on fewer rows, and every
# kernel of the rollout sums a pixel in one order whatever the batch, so the
# sharded evaluator's outputs (images, flow frame, vectors, masks) and
# fitness are the unsharded one's bit for bit, as are those of two
# processes each evaluating half a population.  The spatial and pipelined
# rollouts (the plain route: cuDNN's or PyTorch's convs, which follow the
# shape) are held as the reference phase holds card against CPU (one step:
# STEP_ATOL on at most STEP_DIFF_SHARE of the entries; 22 steps in the
# mean).
TWO_PROCESS_TIMEOUT_S = 150
# the rollouts' (repeat, extension): one step, then the flow pair's 22
PARALLEL_STEPS = ((1, 1), (20, 2))
# the two-process run of the train step, the spatial rollout (float and
# int8 params) and the pipelined rollout on cuda:0 over gloo: each process
# holds one entry of the two-entry meshes (the pipeline: two of its four
# stages)
TWO_PROCESS_PATHS_TIMEOUT_S = 300

_TWO_PROCESS_CHILD = """
import hashlib, json, sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from evolutionary_illusion_generator_tpu_torch.evolution import EvalConfig
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import load_or_init
from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
from evolutionary_illusion_generator_tpu_torch.parallel import (
    ShardedGenerationEvaluator, initialize_distributed, make_mesh)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
assert initialize_distributed()  # JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID
mesh = make_mesh(devices=["cuda:0"])
cfg = preset("circles")
items = list(Population(cfg, seed=0).population.items())
ev = ShardedGenerationEvaluator(EvalConfig(program_cache=False), load_or_init(
    None, (3, 48, 96, 192), device="cuda"), cfg, mesh)
scores = ev(items)
rows = {{i: hashlib.sha1(ev.last_results["outputs"].fetch("images_u8", i).tobytes()).hexdigest()
        for i in range(len(items))}}
print(json.dumps({{"rank": dist.get_rank(), "processes": mesh.processes.tolist(),
                  "scores": scores.tolist(), "rows": rows}}))
dist.destroy_process_group()
"""


_PATHS_CHILD = """
import json, sys
sys.path.insert(0, {repo!r})
import chip_smoke
print(json.dumps(chip_smoke.parallel_paths({out_dir!r})))
"""


def _dp_train_kwargs():
    """``pretrain``'s keywords for one data-parallel step of the train
    phase's recipe, warm-started from the bundled colour weights."""
    from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain as pre
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
        bundled_weights_path,
    )

    warm = bundled_weights_path((3, 48, 96, 192))
    return dict(pre.pretrain_kwargs(pre._parser().parse_args(
        TRAIN_RECIPE + ["--init_weights", warm])), steps=1, verbose=False)


def _parallel_inputs():
    """The spatial and the pipelined rollouts' images on the card, 8-bit
    noise from a fixed seed."""
    import torch

    gen = torch.Generator().manual_seed(7)
    return [(torch.rand(shape, generator=gen) * 255).to(torch.uint8).float().div(255).cuda()
            for shape in (SPATIAL_SHAPE, PIPELINE_SHAPE)]


def _digest(tensors):
    """sha1 of the tensors' bytes, in order: equal digests, equal bits."""
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def parallel_paths(out_dir):
    """One process of the two-process run (``_PATHS_CHILD``; the
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    environment): the data-parallel train step, the spatial rollout with
    float and int8 params and the four-stage pipelined rollout, each over
    meshes that span both processes on cuda:0.  Returns the loss, sha1
    digests of the params and frames, seconds and launches; rank 0 also
    writes the frames to ``out_dir``/frames.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain as pre
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
        load_or_init,
        params_to_numpy,
    )
    from evolutionary_illusion_generator_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_mesh_2d,
        make_spatial_rollout,
    )
    from evolutionary_illusion_generator_tpu_torch.parallel.pipeline import (
        make_pp_mesh,
        pipelined_rollout_flow_frames,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not initialize_distributed():
        raise RuntimeError("parallel_paths: no JAX_COORDINATOR_ADDRESS")
    rank = dist.get_rank()
    _reset_counts()
    seconds = {}
    t0 = time.time()
    pt, loss = pre.pretrain(**dict(_dp_train_kwargs(), mesh=make_mesh(devices=["cuda:0"])))
    seconds["train"] = time.time() - t0
    out = {"rank": rank, "loss": repr(loss), "params": _digest(
        torch.from_numpy(a) for layer in params_to_numpy(pt) for _, a in sorted(layer.items()))}
    params = load_or_init(None, (3, 48, 96, 192), device="cuda")
    quantized = model.quantize_params_int8(params)
    spatial_imgs, pipe_imgs = _parallel_inputs()
    mesh2 = make_mesh_2d(1, PARALLEL_SHARDS, devices=["cuda:0"])
    pp = make_pp_mesh(4, devices=["cuda:0"] * 2)
    frames = {}
    for repeat, extension in PARALLEL_STEPS:
        n = repeat + extension
        runs = {
            f"spatial {n}": lambda: make_spatial_rollout(
                mesh2, repeat=repeat, extension=extension)(params, spatial_imgs),
            f"int8 spatial {n}": lambda: make_spatial_rollout(
                mesh2, repeat=repeat, extension=extension)(quantized, spatial_imgs),
            f"pipeline {n}": lambda: pipelined_rollout_flow_frames(
                params, pipe_imgs, pp, repeat=repeat, extension=extension, n_micro=4)}
        for name, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.time()
            with torch.inference_mode():
                frames[name] = [f.cpu() for f in run()]
            seconds[name] = time.time() - t0
    out.update(frames={k: _digest(v) for k, v in frames.items()}, seconds=seconds,
               launches={k: v for k, v in _counts().items() if v})
    if rank == 0:
        np.savez(os.path.join(out_dir, "frames.npz"),
                 **{f"{k}/{i}": f.numpy() for k, v in frames.items() for i, f in enumerate(v)})
    dist.destroy_process_group()
    return out


def _run_two_processes(code, timeout):
    """``python -c code`` as ranks 0 and 1 of a gloo group on this machine,
    both on cuda:0; returns each rank's last line, parsed as JSON.  A rank
    that fails or outlives ``timeout`` seconds fails the phase; both are
    killed either way."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                 JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                 OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2))))
        for rank in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"parallel: a two-process rank failed: {err[-3000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return results


def _held_like_a_step(label, got, want):
    """``got`` against ``want`` by the reference phase's one-step rule;
    returns (max abs, share of entries that differ)."""
    d = (got.float() - want.float()).abs()
    worst, share = d.max().item(), (d > 0).float().mean().item()
    if not (got.shape == want.shape and bool(got.isfinite().all())):
        raise AssertionError(f"parallel: {label} not finite or of the wrong shape")
    if not (worst <= STEP_ATOL and share <= STEP_DIFF_SHARE):
        raise AssertionError(f"parallel: {label} max {worst:.3e}, {share:.2%} differ")
    return worst, share


def _held_bit_equal(label, got, want):
    """``got`` equal to ``want`` bit for bit; returns (0.0, 0.0) as the
    other rules return (max abs, share or mean)."""
    import torch

    if not (got.shape == want.shape and bool(got.isfinite().all()) and torch.equal(got, want)):
        raise AssertionError(f"parallel: {label} not bit-equal")
    return 0.0, 0.0


def _held_in_the_mean(label, got, want):
    d = (got.float() - want.float()).abs()
    if not (got.shape == want.shape and bool(got.isfinite().all())):
        raise AssertionError(f"parallel: {label} not finite or of the wrong shape")
    if not d.mean().item() <= ROLLOUT_MEAN_TOL:
        raise AssertionError(f"parallel: {label} mean {d.mean().item():.3e}")
    return d.max().item(), d.mean().item()


def _true_route_launches(passes, steps, rows=MAIN_BATCH):
    """The launches of ``passes`` chunk (or shard) passes of ``rows`` rows
    (the main path's chunk by default) on the ``use_pallas=True`` route at
    3,48,96,192 and 160x120: each
    layer's gate convs (``convlstm_narrow.gate_convs``: the three wide
    layers' on the wgmma body, the pixel layer's on the mma.sync body) and
    gate kernel (each layer's on its plan's body), and the units as on the
    "fused" route."""
    out = {k: v for k, v in _path_launches(passes, steps).items()
           if not k.startswith(("narrow_convlstm_layer", "fused_convlstm_layer_multi"))}
    n = passes * steps
    out.update({"gate_convs": 4 * n, "gate_convs/wgmma": 3 * n, "gate_convs/mma_sync": n,
                "fused_lstm_gates": 4 * n, "narrow_convlstm_layer": 0,
                "fused_convlstm_layer_multi": 0})
    for H, W, C in TRUE_ROUTE_LAYERS:
        key = f"fused_lstm_gates/{_gate_body(rows * H * W, C)}"
        out[key] = out.get(key, 0) + n
    return out


def _sharded_generations(params, devices, label, use_pallas="fused"):
    """The sharded evaluator (program cache on, and eager) against the
    unsharded one, generation after generation of one population, on the
    predictor's route ``use_pallas``: every output and the fitness
    bit-equal; returns the sharded evaluators' launch counts."""
    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.evolution import (
        EvalConfig,
        GenerationEvaluator,
    )
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
    from evolutionary_illusion_generator_tpu_torch.parallel import (
        ShardedGenerationEvaluator,
        make_mesh,
    )

    cfg = preset("circles")
    mesh = make_mesh(devices=devices)
    n = mesh.size
    single = GenerationEvaluator(EvalConfig(use_pallas=use_pallas), params, cfg, device="cuda")
    graph = ShardedGenerationEvaluator(EvalConfig(use_pallas=use_pallas), params, cfg, mesh)
    eager = ShardedGenerationEvaluator(EvalConfig(program_cache=False, use_pallas=use_pallas),
                                       params, cfg, mesh)
    pop = Population(cfg, seed=0)
    report = []

    def evaluate(items, _cfg):
        row = {}
        want = single(list(items))
        ref = single.last_results
        ref_out = ref["outputs"].to_numpy()
        for name, ev in (("graph", graph), ("eager", eager)):
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.time()
            got = ev(list(items))
            torch.cuda.synchronize()
            row[name + "_s"] = time.time() - t0
            launched = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
            res = ev.last_results
            out = res["outputs"].to_numpy()
            unequal = [k for k in ref_out if not np.array_equal(out[k], ref_out[k])]
            if not np.array_equal(got, want):
                unequal.append("fitness")
            if unequal or out.keys() != ref_out.keys() or not np.isfinite(got).all():
                raise AssertionError(f"parallel ({label}, {name}): {unequal} not bit-equal to the "
                                     f"unsharded evaluator's (fitness max gap "
                                     f"{float(np.abs(got - want).max()):.3e})")
            row[name] = (int(ref["mask"].sum()), launched)
            if name == "eager":
                chunks = len(res["outputs"]._chunks)
                expect = (_path_launches(chunks * n, STEPS) if use_pallas == "fused"
                          else _true_route_launches(chunks * n, STEPS,
                                                    res["outputs"]._shard_rows))
                expect = {k: v for k, v in expect.items() if v}
                if launched != expect:
                    raise AssertionError(f"parallel ({label}): eager launches {launched}, "
                                         f"expected {expect} ({chunks} chunks x {n} shards)")
        for (gid, g), f in zip(items, graph.last_results["scores"]):
            g.fitness = float(f)
        row["pop"] = len(items)
        report.append(row)

    _reset_counts()
    pop.run(evaluate, PARALLEL_GENERATIONS)
    counts = _counts()
    graphs = [k for k, g in graph._programs.graphs.items() if g is not None]
    if not (graph._programs.replays >= n and graphs
            and all(isinstance(k[0], torch.device) for k in graphs)):
        raise AssertionError(f"parallel ({label}): {graph._programs.replays} replays, graph keys "
                             f"{graphs}")
    for gen, row in enumerate(report):
        log(f"  sharded {label}, generation {gen} (pop {row['pop']}): s/generation graph "
            f"{row['graph_s']:.4f}, eager {row['eager_s']:.4f}; images, flow frames, vectors, "
            f"masks and fitness bit-equal to the unsharded (masked corner slots, launches): "
            f"graph {row['graph']}, eager {row['eager']}")
    log(f"  sharded {label}: {graph._programs.replays} graph replays over "
        f"{len(graphs)} captured keys")
    return counts


@phase("parallel")
def parallel_phase(params, card):
    """``parallel/`` on the card, on a mesh that repeats cuda:0: the sharded
    evaluator (counted), the data-parallel train step, the spatial rollout
    (float and int8 params) and the pipelined rollout (the plain route and
    the int8 route: no kernel), and two processes over gloo: the sharded
    evaluator, then the train step and the three rollouts over meshes that
    span both; on real devices too where the machine has two."""
    import hashlib

    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.evolution import (
        EvalConfig,
        GenerationEvaluator,
    )
    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain as pre
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import params_to_numpy
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
    from evolutionary_illusion_generator_tpu_torch.parallel import (
        make_mesh,
        make_mesh_2d,
        make_spatial_rollout,
    )
    from evolutionary_illusion_generator_tpu_torch.parallel.pipeline import (
        make_pp_mesh,
        pipelined_rollout_flow_frames,
    )

    counts = _sharded_generations(params, ["cuda:0"] * PARALLEL_SHARDS,
                                  f"cuda:0 x {PARALLEL_SHARDS}")
    # the True route: its gate convs sum each pixel in one order too
    true = _sharded_generations(params, ["cuda:0"] * PARALLEL_SHARDS,
                                f"cuda:0 x {PARALLEL_SHARDS}, use_pallas=True", use_pallas=True)
    counts = {k: v + true[k] for k, v in counts.items()}
    if torch.cuda.device_count() >= 2:
        more = _sharded_generations(params, [f"cuda:{i}" for i in range(2)], "cuda:0, cuda:1")
        counts = {k: v + more[k] for k, v in counts.items()}
    else:
        log(f"  a run on two real devices was not possible: this machine has "
            f"{torch.cuda.device_count()} CUDA device")

    _reset_counts()
    # the data-parallel train step: the colour recipe, one step
    kw = _dp_train_kwargs()
    t0 = time.time()
    p1, l1 = pre.pretrain(**dict(kw, device="cuda"))
    t1 = time.time()
    pd, ld = pre.pretrain(**dict(kw, mesh=make_mesh(devices=["cuda:0"] * PARALLEL_SHARDS)))
    t2 = time.time()
    gap = abs(ld - l1) / abs(l1)
    excess, share = -math.inf, 0.0
    for o, c in zip(params_to_numpy(pd), params_to_numpy(p1)):
        for k in c:
            g = np.abs(o[k] - c[k])
            diff = int((g > 0).sum())
            share = max(share, diff / g.size)
            over = diff > max(1.0, TRAIN_FLIP_SHARE * g.size)
            excess = max(excess, math.inf if over else
                         float((g - 2.0**-7 * np.abs(c[k])).max()) - 2 * kw["lr"])
    log(f"  data-parallel train step ({PARALLEL_SHARDS} shards of batch "
        f"{kw['batch'] // PARALLEL_SHARDS}): loss {ld!r} vs one device {l1!r} (relative gap "
        f"{gap:.3e}); params differ on at most {share:.3e} of a tensor's entries, excess "
        f"over the flip rule {excess:.3e}; s/step (set-up included) one device "
        f"{t1 - t0:.3f}, sharded {t2 - t1:.3f}")
    if not (gap <= TRAIN_LOSS_RTOL and excess <= 0):
        raise AssertionError("parallel: the data-parallel step disagrees with one device")
    one = {"loss": repr(ld), "params": _digest(
        torch.from_numpy(a) for layer in params_to_numpy(pd) for _, a in sorted(layer.items()))}

    # the spatial rollout at the pop256_v5e8 frame, float and int8 params:
    # one step, then 22, against the unsharded rollout of the same route
    spatial_imgs, pipe_imgs = _parallel_inputs()
    mesh2 = make_mesh_2d(1, PARALLEL_SHARDS, devices=["cuda:0"] * PARALLEL_SHARDS)
    quantized = model.quantize_params_int8(params)
    for label, p in (("spatial", params), ("int8 spatial", quantized)):
        for (repeat, extension), held in zip(PARALLEL_STEPS, (None, _held_in_the_mean)):
            n = repeat + extension
            if held is None:  # one step: float params as a step is held, int8 bit-equal
                held = _held_like_a_step if p is params else _held_bit_equal
            peaks, frames, secs = {}, {}, {}
            for name, run in (
                    ("unsharded", lambda: model.rollout_flow_frames(
                        p, spatial_imgs, repeat=repeat, extension=extension, use_pallas=False)),
                    (label, lambda: make_spatial_rollout(
                        mesh2, repeat=repeat, extension=extension)(p, spatial_imgs))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                with torch.inference_mode():
                    frames[name] = run()
                torch.cuda.synchronize()
                secs[name] = time.time() - t0
                peaks[name] = torch.cuda.max_memory_allocated()
            stats = [held(f"{label} {n} steps, frame {i}", a, b)
                     for i, (a, b) in enumerate(zip(frames[label], frames["unsharded"]))]
            exact = all(torch.equal(a, b) for a, b in zip(frames[label], frames["unsharded"]))
            one[f"{label} {n}"] = [f.cpu() for f in frames[label]]
            log(f"  {label} (pop 1, sp {PARALLEL_SHARDS}) at {SPATIAL_SHAPE}, {repeat}+{extension} "
                f"steps: frames against the unsharded {stats}, bit-equal {exact}; s {secs}; peak "
                f"device memory GiB { {k: round(v / 2**30, 3) for k, v in peaks.items()} }")
            del frames

    # the pipelined rollout: four stages, four microbatches
    pp = make_pp_mesh(4, devices=["cuda:0"] * 4)
    for (repeat, extension), held in zip(PARALLEL_STEPS, (_held_like_a_step, _held_in_the_mean)):
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            got = pipelined_rollout_flow_frames(params, pipe_imgs, pp, repeat=repeat,
                                                extension=extension, n_micro=4)
            torch.cuda.synchronize()
            t1 = time.time()
            want = model.rollout_flow_frames(params, pipe_imgs, repeat=repeat,
                                             extension=extension, use_pallas=False)
            torch.cuda.synchronize()
        stats = [held(f"pipeline {repeat + extension} steps, frame {i}", a, b)
                 for i, (a, b) in enumerate(zip(got, want))]
        one[f"pipeline {repeat + extension}"] = [f.cpu() for f in got]
        log(f"  pipeline (4 stages, 4 microbatches) at {PIPELINE_SHAPE}, {repeat}+{extension} "
            f"steps: frames against the unpipelined {stats}; s pipelined {t1 - t0:.3f}, "
            f"unpipelined {time.time() - t1:.3f}")
    rollout_counts = _counts()
    if any(rollout_counts.values()):
        raise AssertionError(f"parallel: the plain-route rollouts launched {rollout_counts}")

    # two processes on cuda:0 over gloo, each evaluating its half
    cfg = preset("circles")
    items = list(Population(cfg, seed=0).population.items())
    single = GenerationEvaluator(EvalConfig(program_cache=False), params, cfg, device="cuda")
    want = single(list(items))
    hashes = {str(i): hashlib.sha1(single.last_results["outputs"].fetch("images_u8", i)
                                   .tobytes()).hexdigest() for i in range(len(items))}
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    results = _run_two_processes(_TWO_PROCESS_CHILD.format(repo=repo), TWO_PROCESS_TIMEOUT_S)
    fitness = {r["rank"]: r["scores"] for r in results}
    log(f"  two processes on cuda:0 (gloo), {len(items)} genomes: fitness by rank {fitness}, "
        f"single process {want.tolist()}; {time.time() - t0:.1f} s with start-up")
    for r in results:
        if r["processes"] != [0, 1] or r["rows"] != hashes:
            raise AssertionError(f"parallel: rank {r['rank']} mesh {r['processes']}, fetched "
                                 f"rows equal {r['rows'] == hashes}")
        if r["scores"] != want.tolist():
            raise AssertionError(f"parallel: rank {r['rank']} fitness {r['scores']} is not the "
                                 f"single process's {want.tolist()} bit for bit")
    if fitness[0] != fitness[1]:
        raise AssertionError("parallel: the two ranks assigned different fitness")
    # the sharded runs' launches and the single-process reference's
    counts = {k: counts[k] + v for k, v in _counts().items()}

    # two processes on cuda:0 over gloo: the train step, the spatial rollout
    # (float and int8 params) and the pipelined rollout over meshes that span
    # both, against the one-process runs above: the train step and the float
    # spatial rollout bit-equal; int8 and the pipeline one step bit-equal,
    # 22 steps in the mean
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.time()
        results = _run_two_processes(_PATHS_CHILD.format(repo=repo, out_dir=out_dir),
                                     TWO_PROCESS_PATHS_TIMEOUT_S)
        with np.load(os.path.join(out_dir, "frames.npz")) as z:
            theirs = {k: [torch.from_numpy(z[f"{k}/{i}"]) for i in range(2)]
                      for k in results[0]["frames"]}
    log(f"  two processes on cuda:0 (gloo), train step and rollouts: {time.time() - t0:.1f} s "
        f"with start-up; seconds by rank {[r['seconds'] for r in results]}")
    for r in results:
        if r["launches"]:
            raise AssertionError(f"parallel: rank {r['rank']} launched {r['launches']}")
        if (r["loss"], r["params"]) != (one["loss"], one["params"]):
            raise AssertionError(f"parallel: rank {r['rank']} train step loss {r['loss']} "
                                 f"params {r['params']}, one process {one['loss']} "
                                 f"{one['params']}")
        if r["frames"] != results[0]["frames"]:
            raise AssertionError(f"parallel: rank {r['rank']}'s frames are not rank 0's")
    log(f"  two-process train step: loss {results[0]['loss']} and params bit-equal to one "
        f"process's two-shard step on both ranks")
    for name, got in theirs.items():
        exact = all(torch.equal(a, b) for a, b in zip(got, one[name]))
        if name.startswith("spatial") or name.endswith(" 2"):
            if not exact:
                raise AssertionError(f"parallel: two-process {name} is not bit-equal to one "
                                     f"process's")
            stats = "bit-equal"
        else:
            stats = [_held_in_the_mean(f"two-process {name}, frame {i}", a, b)
                     for i, (a, b) in enumerate(zip(got, one[name]))]
        log(f"  two-process {name} steps against one process: {stats}, bit-equal {exact}")
    log(f"  parallel kernel launches {counts} ({card})")
    return counts


@contextlib.contextmanager
def _recorded_sharded_generations(records):
    """Each sharded generation's seconds (CUDA-synchronised), shard passes,
    graph replays and captures, and kernel launches, appended to
    ``records`` by the driver's sharded evaluator."""
    import torch

    from evolutionary_illusion_generator_tpu_torch import parallel
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn

    sharded = parallel.ShardedGenerationEvaluator

    class Recording(sharded):
        def __call__(self, *a, **kw):
            counts, replays = _counts(), self._programs.replays
            captured = cn.narrow_convlstm_layer.captured
            torch.cuda.synchronize()
            t0 = time.time()
            scores = super().__call__(*a, **kw)
            torch.cuda.synchronize()
            res = self.last_results
            records.append(dict(
                seconds=time.time() - t0, fitness=list(map(float, scores)),
                passes=sum(len(c) for c in res["outputs"]._chunks),
                replays=self._programs.replays - replays,
                captures=int(cn.narrow_convlstm_layer.captured != captured),
                launches={k: v - counts[k] for k, v in _counts().items() if v != counts[k]}))
            return scores

    parallel.ShardedGenerationEvaluator = Recording
    try:
        yield
    finally:
        parallel.ShardedGenerationEvaluator = sharded


def _log_plans(B, H, W, channels=(48, 96, 192)):
    """The fused kernel's plan at each fused layer of a (B, H, W) frame."""
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf

    log("  fused kernel plans " + ", ".join(
        f"layer {l} ({B}, {H >> l}, {W >> l}, {C}): {_plan_str(cf.plan(B, H >> l, W >> l, C))}"
        for l, C in enumerate(channels, 1)))


@phase("composition")
def composition_phase(card):
    """``graft_entry.composition`` at the ``pop256_v5e8`` preset's own
    geometry on the card (the fused route, a mesh of cuda:0 x 8): one
    generation, its checkpoint, the resumed generation.  Logs the fused
    kernel's plan at each fused layer, s/generation with the shard
    passes run eagerly, captured and replayed, the peak device memory, the
    launches and the best fitness; fails on a non-finite fitness, a best
    fitness of 0 or launches that are not 22 narrow, 66 fused, 88 Ahat-unit
    and 66 A-unit per eager pass."""
    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.configs import run_preset
    from evolutionary_illusion_generator_tpu_torch.graft_entry import composition

    rp = run_preset("pop256_v5e8")
    n, B, H, W = rp.n_devices, rp.microbatch // rp.n_devices, rp.h, rp.w
    _log_plans(B, H, W)
    records = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out, _recorded_sharded_generations(records):
        pop, pop2 = composition(out, n, ["cuda:0"] * n)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    if len(records) != 2 or len(recs) != 2 or pop2.generation != 2:
        raise AssertionError(f"composition: {len(records)} generations recorded, {len(recs)} "
                             f"in metrics.jsonl, resumed to generation {pop2.generation}")
    for gen, (r, m) in enumerate(zip(records, recs)):
        if not (len(r["fitness"]) == 256 and np.isfinite(r["fitness"]).all()
                and max(r["fitness"]) > 0.0):
            raise AssertionError(f"composition: generation {gen} fitness {r['fitness']}")
        eager = r["passes"] - r["replays"]
        want = {k: v for k, v in _path_launches(eager, STEPS).items() if v}
        if r["launches"] != want:
            raise AssertionError(f"composition: generation {gen} launches {r['launches']}, "
                                 f"expected {want}")
        log(f"  composition generation {m['generation']}: {r['seconds']:.3f} s "
            f"(eval_seconds {m['eval_seconds']:.3f}); {r['passes']} shard passes: "
            f"{eager} eager, {r['replays']} replayed as a CUDA graph ({r['captures']} of them "
            f"its capture); launches {r['launches']}; fitness max {max(r['fitness']):.5f} "
            f"mean {float(np.mean(r['fitness'])):.5f}")
    log(f"  composition: best fitness {pop.best_genome.fitness:.5f} then "
        f"{pop2.best_genome.fitness:.5f}; peak device memory "
        f"{peak / 2**30:.3f} GiB; {time.time() - t0:.1f} s in all; launches {counts} ({card})")
    return counts


# the north star (bench.py:38-47, BASELINE.json "free.txt"): pop 100,
# 640x480 colour, the Free structure, chunks of 25 candidates; four
# generations, so that whole generations replay the captured chunk pass
NORTH_STAR_POP, NORTH_STAR_W, NORTH_STAR_H, NORTH_STAR_CHUNK = 100, 640, 480, 25
NORTH_STAR_GENERATIONS = 4
# the one-step check at the north-star chunk starts from the state after
# this many steps of the rollout on the generation's renders
NORTH_STAR_WARM_STEPS = 3


def _north_star_step(params, imgs):
    """One ConvLSTM step at the north-star chunk, layer by layer as
    ``prednet_step`` runs it on the default route, from the state after
    ``NORTH_STAR_WARM_STEPS`` steps on ``imgs``: each layer's kernel (the
    fused kernel on layers 1-3 at 240x320, 120x160 and 60x80, the narrow
    kernel on layer 0 at 480x640) against its plain version on the card on
    the same inputs, under the kernels phase's rules (the fused kernel's h
    within H_TOL and c within C_TOL, the narrow kernel's by the one-step
    rule); each layer's R_above is the kernel's new R of the layer above.
    Then the bottom-up half: each layer's Ahat unit on its kernel's new R
    and its A, and its A unit on the unit's E, against the plain versions on
    the same inputs (:func:`_unit_err`'s rule); each layer's A is the A
    unit's output of the layer below."""
    import torch

    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn
    from evolutionary_illusion_generator_tpu_torch.ops import prednet_units as pu

    bf16 = torch.bfloat16
    B, H, W, _ = imgs.shape
    channels = [p["ahat_w"].shape[0] for p in params]
    state = model.init_state(B, H, W, channels, dtype=bf16, device="cuda")
    with torch.inference_mode():
        for _ in range(NORTH_STAR_WARM_STEPS):
            state, _ = model.prednet_step(params, state, imgs, compute_dtype=bf16)
        r_above, rows, new_r = None, [], {}
        for l in reversed(range(len(params))):
            p, s = params[l], state[l]
            wks = [p["lstm_k_e"], p["lstm_k_r"]] + ([p["lstm_k_up"]] if r_above is not None
                                                    else [])
            if channels[l] >= model.FUSED_MIN_CHANNELS:
                srcs = [s["e"].to(bf16), s["r"].to(bf16)] + (
                    [model._upsample2(r_above).to(bf16)] if r_above is not None else [])
                out = cf.fused_convlstm_layer_multi(srcs, wks, p["lstm_b"], s["c"])
                ref = cf.convlstm_layer_plain(srcs, wks, p["lstm_b"], s["c"])
                eh = (out[0].float() - ref[0].float()).abs().max().item()
                ec = (out[1].float() - ref[1].float()).abs().max().item()
                ok = out[0].dtype == ref[0].dtype and eh <= H_TOL and ec <= C_TOL
                name, err = "fused_convlstm_layer_multi", f"h {eh:.3e} c {ec:.3e}"
            else:
                srcs = [s["e"], s["r"]] + ([r_above] if r_above is not None else [])
                out = cn.narrow_convlstm_layer(srcs, wks, p["lstm_b"], s["c"],
                                               compute_dtype=bf16)
                ref = cn.narrow_convlstm_layer_plain(srcs, wks, p["lstm_b"], s["c"],
                                                     compute_dtype=bf16)
                e, share, ok = _narrow_err(out, ref)
                name, err = "narrow_convlstm_layer", f"{e:.3e} ({share:.3%} differ)"
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t.float()).all()) for t in out)
            shape = tuple(s["r"].shape)
            rows.append(f"layer {l} {name} {shape}: max abs err {err}")
            if not (ok and finite):
                raise AssertionError(f"north_star: one step, layer {l} {name} at {shape} "
                                     f"against its plain version: {err}, finite {finite}")
            r_above = out[0].to(bf16)
            new_r[l] = r_above
        a = imgs.to(bf16)
        for l, p in enumerate(params):
            conv, v = (model._conv(new_r[l], p["ahat_w"], b, bf16) for b in (None, p["ahat_b"]))
            ahat = v.clamp(0.0, 1.0) if l == 0 else torch.relu(v)
            e, pred = pu.ahat_error_unit(new_r[l], p["ahat_k"], p["ahat_b"], a, layer0=l == 0)
            want = pu.ahat_error_unit_plain(new_r[l], p["ahat_w"], p["ahat_b"], a, layer0=l == 0,
                                            compute_dtype=bf16, state_dtype=bf16)
            checks = [("E", e, want[0], [torch.cat([t.float()] * 2, -1) for t in (conv, ahat, a)])]
            if l == 0:
                checks.append(("prediction", pred, want[1], [conv, ahat]))
            if "a_k" in p:
                a = pu.a_unit(e, p["a_k"], p["a_b"])
                want_a = pu.a_unit_plain(e, p["a_w"], p["a_b"], compute_dtype=bf16)
                pooled = torch.nn.functional.max_pool2d(
                    model._conv(e, p["a_w"], None, bf16).float()
                    .abs().permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
                checks.append(("A of the layer above", a, want_a, [pooled, want_a]))
            torch.cuda.synchronize()
            for what, got, ref, points in checks:
                err, share, ok = _unit_err(got, ref, bf16, *points)
                rows.append(f"layer {l} units, {what} {tuple(got.shape)}: max abs err "
                            f"{err:.3e} ({share:.3%} differ)")
                if not ok:
                    raise AssertionError(f"north_star: one step, layer {l} units, {what} against "
                                         f"the plain version: {err:.3e}, {share:.3%} differ")
    for row in rows:
        log(f"  one step at the chunk ({B}, {H}, {W}), kernel against its plain version: {row}")


@phase("north_star")
def north_star_phase(params, card):
    """The north star on the card: ``GenerationEvaluator`` at pop 100,
    640x480, Free, colour ``3,48,96,192`` (the bundled weights), chunks of
    25, on the default route, for four generations (the first chunk of a
    key runs eagerly, the next is captured as a CUDA graph, the rest
    replay); logs each generation's seconds (CUDA-synchronised),
    ``last_timings``, peak device memory, chunks replayed and launches, and
    the fused kernel's plan per layer.  Then
    ``scripts/phase_bench.py``'s split and ``scripts/rollout_profile.py``'s
    kernel table at one chunk (dense and s2d pixel layer).  Holds finite
    fitness, 22 narrow, 66 fused, 88 Ahat-unit and 66 A-unit launches per
    eager chunk, and one step at the chunk, kernels against their plain
    versions
    (:func:`_north_star_step`).  Returns the launches of the driven paths
    (the generations and the two scripts), not those of the check."""
    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.evolution import (
        EvalConfig,
        GenerationEvaluator,
    )
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
    from evolutionary_illusion_generator_tpu_torch.ops.convlstm_narrow import (
        narrow_convlstm_layer,
    )
    from evolutionary_illusion_generator_tpu_torch.scripts import phase_bench, rollout_profile
    from evolutionary_illusion_generator_tpu_torch.structure import StructureType

    B, H, W = NORTH_STAR_CHUNK, NORTH_STAR_H, NORTH_STAR_W
    _log_plans(B, H, W)
    cfg = preset("free").replace(pop_size=NORTH_STAR_POP)
    ev = GenerationEvaluator(EvalConfig(structure=StructureType.Free, w=W, h=H, c_dim=3,
                                        microbatch=B), params, cfg, device="cuda")
    records = []

    def evaluate(items, _cfg):
        before, replays = _counts(), ev._programs.replays
        captured = narrow_convlstm_layer.captured
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        scores = ev(list(items))
        torch.cuda.synchronize()
        records.append(dict(
            seconds=time.time() - t0, timings=dict(ev.last_timings),
            peak=torch.cuda.max_memory_allocated(), reserved=torch.cuda.max_memory_reserved(),
            fitness=np.asarray(scores),
            chunks=len(ev.last_results["outputs"]._chunks),
            replays=ev._programs.replays - replays,
            captures=int(narrow_convlstm_layer.captured != captured),
            launches={k: v - before[k] for k, v in _counts().items() if v != before[k]}))

    _reset_counts()
    Population(cfg, seed=0).run(evaluate, NORTH_STAR_GENERATIONS)
    for gen, r in enumerate(records):
        eager = r["chunks"] - r["replays"]
        want = _path_launches(eager, STEPS)
        if not (len(r["fitness"]) == NORTH_STAR_POP and np.isfinite(r["fitness"]).all()):
            raise AssertionError(f"north_star: generation {gen} fitness {r['fitness']}")
        if {k: v for k, v in r["launches"].items()} != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"north_star: generation {gen} launches {r['launches']}, "
                                 f"expected {want}")
        log(f"  north_star generation {gen}: {r['seconds']:.4f} s (last_timings "
            f"{ {k: round(v, 4) for k, v in r['timings'].items()} }); {r['chunks']} chunks: "
            f"{eager} eager, {r['replays']} replayed ({r['captures']} of them its capture); "
            f"peak device memory {r['peak'] / 2**30:.3f} GiB allocated, "
            f"{r['reserved'] / 2**30:.3f} GiB reserved (a replay works in the graph's pool, "
            f"which only the reserved memory counts); launches {r['launches']}; "
            f"fitness max {r['fitness'].max():.5f} mean {r['fitness'].mean():.5f}")
    if not any(r["replays"] == r["chunks"] for r in records):
        raise AssertionError("north_star: no generation was replayed whole")
    bench = phase_bench.main([])
    log(f"  phase_bench: {json.dumps(bench)}")
    # the dense and s2d pixel layers on the default route, and the True
    # route (the gate kernel after the gate convs on every layer)
    for s2d, route in (("0", "fused"), ("1", "fused"), ("0", "true")):
        before = _counts()
        prof = rollout_profile.main(["--s2d", s2d, "--use_pallas", route])
        what = f"--s2d {s2d} --use_pallas {route}"
        after = _counts()
        # every gate launch on its layer's plan body: the s2d pixel layer's,
        # or each of the True route's layers'
        layers = NORTH_STAR_GATE_LAYERS[(s2d, route)]
        n = (after["fused_lstm_gates"] - before["fused_lstm_gates"]) // max(1, len(layers))
        want = {}
        for lh, lw, lc in layers:
            key = f"fused_lstm_gates/{_gate_body(B * lh * lw, lc)}"
            want[key] = want.get(key, 0) + n
        ran = {k: v - before[k] for k, v in after.items()
               if k.startswith("fused_lstm_gates/") and v != before[k]}
        if ran != want or (layers and not n):
            raise AssertionError(f"north_star: rollout_profile {what} launched the gate kernel "
                                 f"{ran}, expected {want}")
        log(f"  rollout_profile {what}: steady {prof['steady_s']:.4f} s, busy share "
            f"{prof['busy_share']:.3f}, {prof['launches']} launches; top "
            f"{[(k['name'][:60], k['count'], round(k['ms'], 3)) for k in prof['kernels'][:6]]}")
        log(f"  rollout_profile {what}, device time by wrapper (count, ms): " + ", ".join(
            f"{k} {v['count']} {v['ms']:.3f}" for k, v in prof["wrappers"].items())
            + "; the gate kernel by body: " + ", ".join(
            f"{k} {v['count']} {v['ms']:.3f}" for k, v in prof["gate_bodies"].items()))
        if s2d == "0" and prof["wrappers"]["library convs"]["count"]:
            raise AssertionError(f"north_star: the dense rollout ran library convs "
                                 f"{prof['wrappers']['library convs']}")
    counts = _counts()
    imgs = torch.stack([torch.from_numpy(ev.last_results["outputs"].fetch("images_u8", i))
                        for i in range(B)]).cuda().float().div(255)
    _north_star_step(params, imgs)
    log(f"  north_star launches {counts} ({card})")
    return counts


@phase("profile")
def profile_generation(params):
    """Device time by kernel over one warm main-path generation (the first
    population of the ``circles`` preset, one chunk of 8), from
    torch.profiler; the device busy share is the kernels' summed time over
    the profiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evolutionary_illusion_generator_tpu_torch.evolution import (
        EvalConfig,
        GenerationEvaluator,
    )
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
    from evolutionary_illusion_generator_tpu_torch.utils.profiling import (
        by_wrapper,
        device_events,
        kernel_table,
    )

    cfg = preset("circles")
    items = list(Population(cfg, seed=0).population.items())
    want = {name: n for name, (_, n) in TRACE_KERNELS.items()}
    launched = _path_launches(1, STEPS)  # what the wrappers count: one chunk
    recorded = {k: v for k, v in launched.items() if "/" not in k}  # a graph's, by wrapper
    for label, on in (("CUDA graph replay", True), ("eager", False)):
        evaluator = GenerationEvaluator(EvalConfig(program_cache=on), params, cfg,
                                        device="cuda")
        evaluator(items)  # warm-up: eager
        evaluator(items)  # with the graph: the capture
        torch.cuda.synchronize()
        _reset_counts()
        replays = evaluator._programs.replays
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            evaluator(items)
            torch.cuda.synchronize()
            wall = time.time() - t0
        counts = {k: v for k, v in _counts().items() if v}
        kernels = device_events(prof, torch.device("cuda"))
        lines, totals = kernel_table(kernels, wall, top=12)
        # the path's kernels as the trace saw them run: in the replay they
        # run from the graph, and no wrapper launched them
        ran = {name: sum(n for k, n, _ in kernels if key in k)
               for name, (key, _) in TRACE_KERNELS.items()}
        log(f"  profiled generation ({label}): wall {wall * 1e3:.1f} ms (profiler on), device "
            f"kernels {totals['busy_s'] * 1e3:.1f} ms, busy share {totals['busy_share']:.3f}, "
            f"{totals['launches']} kernel launches; in the trace {ran}, counted by the "
            f"wrappers {counts}")
        if ran != want:
            raise AssertionError(f"profile ({label}): the trace holds {ran}, expected {want}")
        # the dense "fused" route runs no library conv: the A and Ahat convs
        # are the units' kernels
        wrappers = by_wrapper(kernels)
        log(f"    device time by wrapper (count, ms): " + ", ".join(
            f"{k} {v['count']} {v['ms']:.3f}" for k, v in wrappers.items()))
        if wrappers["library convs"]["count"]:
            raise AssertionError(f"profile ({label}): library conv kernels ran: "
                                 f"{wrappers['library convs']}")
        if on:
            graphs = [g for g in evaluator._programs.graphs.values() if g is not None]
            if not (len(graphs) == 1 and evaluator._programs.replays == replays + 1
                    and graphs[0].recorded == recorded and not counts):
                raise AssertionError(
                    f"profile: {len(graphs)} captured graphs, "
                    f"{evaluator._programs.replays - replays} replays, recorded "
                    f"{[g.recorded for g in graphs]}, wrapper launches {counts}; expected one "
                    f"replay of a graph that recorded {recorded} and no wrapper launch")
        elif counts != launched:
            raise AssertionError(f"profile (eager): wrapper launches {counts}, expected "
                                 f"{launched}")
        else:
            # the narrow kernel reads layer 1's R at half resolution: no op of
            # the pass takes the upsample's expanded (B, H/2, 2, W/2, 2, C1)
            # view of it (the replay runs the kernels its capture recorded)
            B, (H, W) = MAIN_BATCH, (120, 160)
            view = [B, H // 2, 2, W // 2, 2, 48]
            with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as shapes:
                evaluator(items)
                torch.cuda.synchronize()
            ups = [e.key for e in shapes.key_averages(group_by_input_shape=True)
                   if view in list(e.input_shapes)]
            if ups:
                raise AssertionError(f"profile (eager): ops on the upsampled layer-1 R {view}: "
                                     f"{ups}")
            log(f"    no op takes the upsampled layer-1 R {view}; narrow kernels a chunk "
                f"{ran['narrow_convlstm_layer/persistent']}, gate kernels "
                f"{ran['fused_lstm_gates']}")
        for line in lines:
            log("    " + line)


@phase("bisect")
def bisect():
    """The port's kernel-bisection ladder at --big, counted; then each rung
    kernel against its plain version on the card, with times."""
    import torch
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_bisect as cb
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
    from evolutionary_illusion_generator_tpu_torch.scripts import kernel_bisect as kb

    _reset_counts()
    kb.main(BISECT_ARGS)
    counts = _counts()
    want = dict.fromkeys(counts, 1 + kb.LOOP_OPS * (1 + kb.REPS))
    # rung B: float32 gates of the library conv, the carried bfloat16 state,
    # float32 h and c, on its plan's body
    B, H, W, Cin, C = kb.BIG_SHAPE
    gate_body = _gate_body(B * H * W, C, (torch.float32, torch.bfloat16, torch.float32))
    for name in want:
        other_gate_body = (name.startswith("fused_lstm_gates/")
                           and name != f"fused_lstm_gates/{gate_body}")
        if other_gate_body or name.split("/")[0] in (
                "fused_convlstm_layer_multi", "narrow_convlstm_layer", "gate_convs",
                *UNIT_WRAPPERS):
            want[name] = 0  # not on the ladder
    if counts != want:
        raise AssertionError(f"bisect: kernel launches {counts}, expected {want}")
    log(f"  bisect launches {counts}")

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(B, H, W, Cin, device="cuda", generator=gen).bfloat16()
    w = torch.randn(3, 3, Cin, 4 * C, device="cuda", generator=gen).mul_(0.05).bfloat16()
    b = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.1).bfloat16()
    c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()
    wk = cf.pack_gate_weight(w)  # the kernels', the plain version's and the yardstick's layout
    stream = torch.cuda.current_stream().cuda_stream
    csrc = "evolutionary_illusion_generator_tpu_torch/csrc/"
    results = {}

    def row(key, err, ms, plain_ms, library_ms, flops, peak, moved, **extra):
        name, line = BISECT_RUNGS[key]
        b_ms, b_by = bound_ms(flops, moved, peak)
        source = csrc + ("bisect_wgmma.cu" if key in WGMMA_RUNGS else "convlstm_bisect.cu")
        results[name] = dict(route="cuda", source=source,
                             replaces=f"scripts/pallas_bisect.py:{line}", max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms, **extra)
        rate = f" ({flops / ms / 1e9:.1f} TFLOP/s)" if peak == PEAK_BF16_FLOPS else ""
        log(f"  {name} ({key}): err {err:.2e} kernel {ms:.4f} ms{rate} plain {plain_ms:.4f} ms "
            f"library {library_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})"
            + "".join(f" {k} {v:.4f} ms" for k, v in extra.items()))

    # A: float32(c_prev) * 2; the yardstick is one torch.mul into a float32 out
    a_out, _ = cb.variant_A(x, w, b, c_prev)
    torch.cuda.synchronize()
    err = (a_out - c_prev.float() * 2).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"variant_A: max abs err {err} (must be exact)")
    out32 = torch.empty_like(a_out)
    # A writes 368 MB, far past the L2: torch.profiler's kernel duration
    # ends while its last dirty lines are still being written back, and
    # falls below the bound.  Back to back (the host enqueues faster than
    # the card runs them), CUDA events take the write-back in: that is ms.
    mul = lambda: torch.mul(c_prev, 2.0, out=out32)  # noqa: E731
    a_call = lambda: cb.variant_A(x, w, b, c_prev)  # noqa: E731
    a_kernel, mul_kernel = device_ms(a_call, 20)[0], device_ms(mul, 20)[0]
    row("A", err, cuda_ms(a_call, 20), cuda_ms(lambda: cb.plain("A", x, w, b, c_prev), 20),
        cuda_ms(mul, 20), float(c_prev.numel()), PEAK_F32_FLOPS, nbytes(c_prev, a_out),
        kernel_ms=a_kernel, library_kernel_ms=mul_kernel)
    r = results["variant_A"]
    log(f"  variant_A {r['ms']:.4f} ms against torch.mul {r['library_ms']:.4f} ms back to back: "
        f"{r['bound_ms'] / r['ms']:.1%} and {r['bound_ms'] / r['library_ms']:.1%} of the "
        f"bound; kernel durations (profiler) {a_kernel:.4f} and {mul_kernel:.4f} ms")
    del a_out, out32
    # A's scalar head and tail: counts that are not a multiple of the vector,
    # views 0-7 elements past an allocation, both state types
    for dt, n, off in itertools.product((torch.float32, torch.bfloat16), (3822, 100003),
                                        range(8)):
        buf = torch.randn(n + off, device="cuda", generator=gen).mul_(4).to(dt)
        small = buf[off:].view(1, 1, n, 1)
        if not torch.equal(cb.launch_a(small, stream), small.float() * 2):
            raise AssertionError(f"variant_A: {dt} n={n} offset {off} not exact")
    log("  variant_A exact at n 3822 and 100003, views 0-7 elements off, both state types")

    # the conv rungs; plain versions and yardstick on the same inputs
    gates_p = cf.gate_conv_plain([x], [wk], b)
    h_p, c_p = cf.lstm_gates_plain(gates_p, c_prev)
    h_p = h_p.to(c_prev.dtype)
    xp = cb.pad_input(x)
    w_cl = cf.unpack_gate_weight(wk).contiguous(memory_format=torch.channels_last)

    def library_gates():  # cuDNN bf16 conv of xp + bias
        return F.conv2d(xp.permute(0, 3, 1, 2), w_cl).permute(0, 2, 3, 1).float() + b.float()

    def library_layer():  # ... + eager gate math
        i, f, o, g = library_gates().split(C, dim=-1)
        cc = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
        return (torch.sigmoid(o) * torch.tanh(cc)).to(c_prev.dtype), cc

    flops = 2.0 * B * H * W * 9 * Cin * 4 * C
    conv_ms = cuda_ms(lambda: F.conv2d(xp.permute(0, 3, 1, 2), w_cl), 5, warmup=1)
    log(f"  cuDNN bf16 conv of xp alone: {conv_ms:.4f} ms ({flops / conv_ms / 1e9:.1f} TFLOP/s); "
        f"the library yardstick of C adds the float32 cast and the bias to it")
    for key in "CDHEIJ":
        rows = BISECT_ROWS if key in kb.ROW_BLOCK_KEYS else None
        xin = cb.prepare(key, x, rows)
        out = cb.launch(key, xin, wk, b, c_prev, rows, stream)
        torch.cuda.synchronize()
        if key == "C":
            err = (out - gates_p).abs().max().item()
            if not err <= BISECT_GATES_TOL:
                raise AssertionError(f"variant_C: gates max abs err {err}")
            plain = lambda: cf.gate_conv_plain([x], [wk], b)  # noqa: E731
            outs, library = (out,), library_gates
        else:
            eh = (out[0].float() - h_p.float()).abs().max().item()
            ec = (out[1] - c_p).abs().max().item()
            if not (eh <= H_TOL and ec <= C_TOL):
                raise AssertionError(f"rung {key}: max abs err h {eh} c {ec}")
            err = max(eh, ec)
            plain = lambda: cb.plain(key, x, w, b, c_prev)  # noqa: E731
            outs, library = out, library_layer
        ms = cuda_ms(lambda: cb.launch(key, xin, wk, b, c_prev, rows, stream), 5, warmup=1)
        glue = f"pad {cuda_ms(lambda: cb.pad_input(x, key in 'IJ'), 5, warmup=1):.4f} ms"
        if key in "HI":
            xpk = cb.pad_input(x, key == "I")
            glue += f", window stack {cuda_ms(lambda: cb.window_stack(xpk, rows), 5, warmup=1):.4f} ms"
            del xpk
        log(f"  rung {key} host glue: {glue}")
        row(key, err, ms, cuda_ms(plain, 3, warmup=1), cuda_ms(library, 5, warmup=1),
            flops, PEAK_BF16_FLOPS,
            nbytes(xin, wk, b, *outs, *(() if key == "C" else (c_prev,))))
        del xin, out, outs
    d_ms = results["variant_D"]["ms"]
    log(f"  the row-block rungs against D's {d_ms:.4f} ms: " + ", ".join(
        f"{key} {ms:.4f} ms ({ms / d_ms - 1:+.1%})"
        for key in "HEIJ" for ms in [results[BISECT_RUNGS[key][0]]["ms"]]))
    check_wgmma_rungs(x, wk, b, c_prev, stream)
    # ladder key F's kernel alone (the fused kernel on the unpadded input,
    # weights packed once), against rung E's kernel above
    out = cf.launch([x], [wk], b, c_prev, stream)
    torch.cuda.synchronize()
    err = max((out[0].float() - h_p.float()).abs().max().item(), (out[1] - c_p).abs().max().item())
    ms = cuda_ms(lambda: cf.launch([x], [wk], b, c_prev, stream), 5, warmup=1)
    tw = cf.tile_width(B, H, W)
    old = cf.Plan("mma_sync", 16, 0, tw, 0)
    ms_old = cuda_ms(lambda: cf.launch([x], [wk], b, c_prev, stream, plan=old), 5, warmup=1)
    log(f"  fused kernel (F) at --big: err {err:.2e} kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), {_plan_str(cf.plan(B, H, W, C))}; its mma_sync body "
        f"{ms_old:.4f} ms ({flops / ms_old / 1e9:.1f} TFLOP/s), tw={tw}")
    return results, counts


def check_wgmma_rungs(x, wk, b, c_prev, stream):
    """The six conv rungs (wgmma, two levels of float32 sums): on two
    images of the --big inputs, the kernel's mean |gates - float64 gates|
    (C) and mean |c - float64 c| (D, and H, E, I and J at rows 48) may be
    no larger than the plain version's; and each against its plain version
    at BISECT_SHAPES, both state types."""
    import torch
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_bisect as cb
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf

    x2, c2 = x[:2].contiguous(), c_prev[:2].contiguous()
    C = c2.shape[-1]
    g64 = (F.conv2d(x2.double().permute(0, 3, 1, 2), cf.unpack_gate_weight(wk).double(), padding=1)
           .permute(0, 2, 3, 1) + b.double())
    i, f, o, g = g64.split(C, dim=-1)
    c64 = torch.sigmoid(f) * c2.double() + torch.sigmoid(i) * torch.tanh(g)
    gates_p = cf.gate_conv_plain([x2], [wk], b)
    c_p = cf.lstm_gates_plain(gates_p, c2)[1]
    for key in WGMMA_RUNGS:
        rows = None if key in "CD" else BISECT_ROWS
        out = cb.launch(key, cb.prepare(key, x2, rows), wk, b, c2, rows, stream)
        torch.cuda.synchronize()
        out, plain, ref, what = ((out, gates_p, g64, "gates") if key == "C"
                                 else (out[1], c_p, c64, "c"))
        drift, drift_p = ((t.double() - ref).abs().mean().item() for t in (out, plain))
        log(f"  rung {key} on 2 images: mean |{what} - {what}_float64| kernel {drift:.3e} "
            f"plain {drift_p:.3e}")
        if not drift <= drift_p:
            raise AssertionError(f"rung {key}: mean |{what} - {what}_float64| {drift:.3e} above "
                                 f"the plain version's {drift_p:.3e}")

    gen = torch.Generator(device="cuda").manual_seed(3)
    for (B, H, W, Cin, C), rows in BISECT_SHAPES:
        x = torch.randn(B, H, W, Cin, device="cuda", generator=gen).bfloat16()
        w = torch.randn(3, 3, Cin, 4 * C, device="cuda", generator=gen).mul_(0.05).bfloat16()
        b = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.1).bfloat16()
        wk, xp = cf.pack_gate_weight(w), cb.pad_input(x)
        errs = []
        for state in (torch.float32, torch.bfloat16):
            c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).to(state)
            gates = cb.launch("C", xp, wk, b, c_prev, None, stream)
            h_p, c_p = cb.plain("D", x, w, b, c_prev)
            torch.cuda.synchronize()
            eg = (gates - cf.gate_conv_plain([x], [wk], b)).abs().max().item()
            if not eg <= BISECT_GATES_TOL:
                raise AssertionError(f"rung C at {(B, H, W, Cin, C)}: max abs err gates {eg}")
            errs.append(eg)
            for key in "DHEIJ":
                r = None if key == "D" else rows
                h, c = cb.launch(key, cb.prepare(key, x, r), wk, b, c_prev, r, stream)
                torch.cuda.synchronize()
                eh = (h.float() - h_p.float()).abs().max().item()
                ec = (c - c_p).abs().max().item()
                if not (h.dtype == h_p.dtype and eh <= H_TOL and ec <= C_TOL):
                    raise AssertionError(f"rung {key} at {(B, H, W, Cin, C)} rows {r} {state}: "
                                         f"max abs err h {eh} c {ec}")
                errs.append(max(eh, ec))
        log(f"  rungs C, D, H, E, I and J at {(B, H, W, Cin, C)} rows {rows}: max abs err "
            f"{max(errs):.2e} (float32 and bfloat16 state)")


def main():
    watchdog = threading.Timer(WATCHDOG_S, lambda: (log("watchdog: time limit"),
                                                    os._exit(3)))
    watchdog.daemon = True
    watchdog.start()
    t0 = time.time()
    card = check_device()
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import load_or_init

    build()
    cuda_tests()
    params = load_or_init(None, (3, 48, 96, 192), device="cuda")
    kernels = check_kernels(params)
    check_reference(params)
    counts = main_path()
    default_color()
    with tempfile.TemporaryDirectory() as keep:
        cli_counts, best_png = cli_run(keep)
        probe_counts = probe_run(best_png, card)
        analysis_counts = analysis_phase(best_png, card)
        options_counts = options_phase(params, best_png, card)
    scorer_counts = scorers(params, card)
    train_counts = train_phase(card)
    parallel_counts = parallel_phase(params, card)
    composition_counts = composition_phase(card)
    north_star_counts = north_star_phase(params, card)
    profile_generation(params)
    bisect_kernels, bisect_counts = bisect()
    kernels.update(bisect_kernels)
    log(f"[total] {time.time() - t0:.1f} s")
    # launches over the driven paths: main_path, cli, probe, analysis, options, scorers,
    # train (none: the trainer runs the plain route), parallel, composition,
    # north_star, then the bisection ladder
    paths = (counts, cli_counts, probe_counts, analysis_counts, options_counts, scorer_counts,
             train_counts, parallel_counts, composition_counts, north_star_counts, bisect_counts)
    rows = [dict(name=name, launches=sum(c.get(name, 0) for c in paths), **r)
            for name, r in kernels.items()]
    for row in rows:  # every path's fused launches took the wgmma body (_counts checks it)
        if row["name"] in ("fused_convlstm_layer_multi", "fused_convlstm_layer"):
            row["bodies"] = {"wgmma": row["launches"], "mma_sync": 0}
        if row["name"] == "gate_convs":  # the gate convs' launches by body
            row["bodies"] = {body: sum(c.get(f"gate_convs/{body}", 0) for c in paths)
                             for body in ("wgmma", "mma_sync")}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    watchdog.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
