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
   plain version and a library yardstick, and its bound; the gate kernel in
   both its contracts (the main path's bfloat16 one and the JAX function's
   float32 one), timed on the device (``device_ms``) beside the host's call
   rate (``call_ms``), at the s2d pixel layer's shape (8, 60, 80, 12), and
   at every type and an odd pixel count on views off alignment; the fused kernel per layer with its TFLOP/s (CUDA events),
   at every tile mapping the wrapper chooses from, and at ragged shapes;
5. reference: the port's rollout on the card against the same rollout on
   the CPU (plain versions) on a small input with the bundled weights;
6. main path: ``neat_illusion`` for two generations at the full width of the
   bundled color predictor (3,48,96,192), 160x120, the ``circles`` preset;
   asserts the kernel launch counts, finite fitness, two generations;
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
   options: the predictor's options at the main path's shape with the
   bundled weights: ``s2d_l0``, ``subpixel_up`` and ``prednet_int8`` each
   through ``neat_illusion`` for two generations (22 gate and 66 fused
   launches a generation, none under int8; finite fitness; s/generation)
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
   three generations (program cache on and off) against the unsharded
   evaluator, with 22 gate and 66 fused launches per shard's eager pass
   (on two real devices too where the machine has them, else one line
   says it could not); one data-parallel step of the train phase's recipe
   on two shards against one device (the train phase's rules); a spatial
   rollout at 1280x960 (sp 2) and a four-stage pipelined rollout at
   160x120 against the unsharded plain rollout (one step tightly, 22 in
   the mean; no kernel launched), with seconds and peak memory; two
   processes on cuda:0 over gloo, each evaluating half a population, whose
   fitness must equal the single-process evaluator's on both ranks;
13. composition: the ``pop256_v5e8`` run preset as it stands (pop 256,
   1280x960, 3,48,96,192, global chunks of 64) through
   ``graft_entry.composition`` on the fused route over a mesh of cuda:0 x
   8: one generation, its checkpoint and the resumed generation; logs the
   fused kernel's strip width at each fused layer, s/generation with its
   eager, captured and replayed shard passes, the peak device memory, the
   launches and the best fitness; fails on a non-finite fitness, a best
   fitness of 0 or launch counts that are not 22 and 66 per eager pass;
14. profile: device time by kernel and the number of kernel launches over
   one warm main-path generation, replayed as a CUDA graph (the default)
   and run eagerly (``program_cache=False``); in both the trace must hold
   22 gate and 66 fused kernels, which in the replay no wrapper launched
   (the graph recorded them at its capture);
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

Then one JSON line with every kernel's numbers (its launches summed over
the main path, cli, probe, options, scorers, train, parallel, composition
and bisect phases), and as the last line
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
GATES_SHAPE = (MAIN_BATCH, 120, 160, 3)  # layer 0: (B, H, W, C)
MULTI_LAYERS = (  # (H, W, C, source channels [E, R, up(R_above)])
    (60, 80, 48, (96, 48, 96)),
    (30, 40, 96, (192, 96, 192)),
    (15, 20, 192, (384, 192)),
)
SINGLE_LAYER = (60, 80, 48, (240,))  # layer 1's concatenated input
# (B, H, W, source channels, C, state dtype name) held against the plain
# version at every tile mapping
RAGGED_CASES = (
    (2, 13, 21, (40,), 24, "float32"),
    (2, 13, 21, (40, 12), 24, "bfloat16"),
    (2, 13, 21, (40, 12, 24), 24, "float32"),
    (2, 13, 21, (12, 40, 24), 24, "bfloat16"),
)
STEPS = 22  # 20 open-loop + 2 closed-loop steps per chunk
# the s2d pixel layer's gate step: C' = 4C = 12 at half the resolution
S2D_GATES_SHAPE = (MAIN_BATCH, 60, 80, 12)

# kernel vs plain version, both at bf16 inputs with float32 sums:
GATES_TOL = 1e-5  # float32 elementwise math, last-ulp differences
# bfloat16 h and c: those differences flip a rounding now and then, by one
# bfloat16 ulp; a wrong rounding mode or a wrong element flips far more
GATES_DIFF_SHARE = 0.01
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

# the cuda-marked tests, run by pytest on the card
CUDA_TESTS = "tests/test_torch_cuda.py"
CUDA_TESTS_TIMEOUT_S = 300
# the cli phase's run: the main path's shape, artifacts and a profiled
# generation 1 (one chunk of 8, so 22 gate and 66 fused launches)
CLI_ARGS = ["-s", "1", "--generations", "2"]
CLI_SHAPE = (120, 160, 3)
OVERLAY_RED = (255, 0, 0)
TRACE_KERNELS = {"fused_lstm_gates": ("lstm_gates_kernel", STEPS),
                 "fused_convlstm_layer_multi": ("convlstm_fused_kernel", STEPS * 3)}
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

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
        log("  device_ms: torch.profiler recorded no device kernel; profiling once more")
    else:
        ms = cuda_ms(fn, iters)
        log(f"  device_ms: torch.profiler recorded no device kernel again; {ms:.4f} ms from "
            f"CUDA events instead")
        return ms, math.nan
    return (sum(e.self_device_time_total for e in kernels) / iters / 1e3,
            sum(e.count for e in kernels) / iters)


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    # float32 convs and matmuls in full float32 wherever the plain versions
    # are compared (cuDNN would otherwise use TF32 for float32 convs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


@phase("build")
def build():
    from evolutionary_illusion_generator_tpu_torch import _build

    _build.library()
    kernel = ""
    for line in _build.build_log().splitlines():
        entry = re.search(r"Compiling entry function .*?(?<=\d)([a-z][a-z_]*_kernel)(I\w*?)EEv", line)
        if entry:  # the kernel's name and its mangled template arguments
            kernel = entry.group(1) + entry.group(2)
        elif "registers" in line or "spill" in line:
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


def _layer_inputs(gen, params, layer, H, W, cins):
    """Sources, kernel weights, bias and c_prev at one layer's shape, with
    the bundled weights of that layer."""
    import torch

    p = params[layer]
    C = p["ahat_w"].shape[0]
    srcs = [torch.rand(MAIN_BATCH, H, W, ci, device="cuda", generator=gen)
            .mul_(2).sub_(1).bfloat16() for ci in cins]
    wks = [p[k] for k in ("lstm_k_e", "lstm_k_r", "lstm_k_up") if k in p]
    if len(cins) == 1:  # the single-source kernel takes the whole gate kernel
        wks = [torch.cat(wks, dim=3).contiguous()]
    c_prev = torch.randn(MAIN_BATCH, H, W, C, device="cuda", generator=gen).bfloat16()
    return srcs, wks, p["lstm_b"], c_prev


def _gate_flops(H, W, cins, C):
    return 2.0 * MAIN_BATCH * H * W * 9 * sum(cins) * 4 * C


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


def check_gates(gen):
    """fused_lstm_gates at layer 0's shape, (8, 120, 160, 3), in the main
    path's contract (bfloat16 gates, state, h and c) and the JAX function's
    (float32 gates, float32 h and c; bfloat16 state), each against its plain
    version, with its device time, call rate and bound, and the eager gate
    math as the yardstick; then every type and C of the tests at an odd
    pixel count and on views off the allocations' alignment.  Returns the
    main-path contract's row with the float32 contract's numbers beside it."""
    import torch

    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates as cg

    B, H, W, C = GATES_SHAPE
    bf16 = torch.bfloat16
    gates32 = torch.randn(B, H, W, 4 * C, device="cuda", generator=gen).mul_(2)
    gates16 = gates32.to(bf16)
    c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).to(bf16)
    rows = {}
    for label, gates, out_dtype in (("f32", gates32, torch.float32), ("main", gates16, bf16)):
        call = lambda: cg.fused_lstm_gates(gates, c_prev, out_dtype=out_dtype)  # noqa: E731
        h, c = call()
        err, ok = _gates_err((h, c), cg.lstm_gates_plain(gates, c_prev, out_dtype=out_dtype))
        if not ok:
            raise AssertionError(f"fused_lstm_gates ({label} contract): max abs err {err}")

        def eager():  # the yardstick: eager torch gate math, cast to out_dtype
            i, f, o, g = gates.split(C, dim=-1)
            cc = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
            return (torch.sigmoid(o) * torch.tanh(cc)).to(out_dtype), cc.to(out_dtype)

        # ~10 float32 operations per element (3 sigmoid, 2 tanh, 3 mul, 1 add)
        b_ms, b_by = bound_ms(10.0 * B * H * W * C, nbytes(gates, c_prev, h, c), PEAK_F32_FLOPS)
        ms, per_call = device_ms(call, 200)
        lib_ms, lib_kernels = device_ms(eager, 200)
        rows[label] = dict(
            max_abs_err=err, ms=ms, call_ms=cuda_ms(call, 200),
            plain_ms=device_ms(lambda: cg.lstm_gates_plain(gates, c_prev, out_dtype=out_dtype),
                               200)[0],
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        log(f"  fused_lstm_gates {label} contract ({gates.dtype} gates, {c_prev.dtype} state, "
            f"{out_dtype} h and c): err {err:.2e} device {ms * 1e3:.2f} us ({per_call:g} "
            f"kernel a call), call rate {rows[label]['call_ms'] * 1e3:.2f} us, bound "
            f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes(gates, c_prev, h, c) / 1e6:.2f} MB); eager "
            f"gate math device {lib_ms * 1e3:.2f} us ({lib_kernels:g} kernels)")

    def float32_route():  # the main path's gates through the float32 contract
        hh, cc = cg.fused_lstm_gates(gates16.float(), c_prev)
        return hh.to(bf16), cc.to(bf16)

    r_ms, r_kernels = device_ms(float32_route, 200)
    log(f"  the same through the float32 contract (float(), kernel, 2 casts): device "
        f"{r_ms * 1e3:.2f} us ({r_kernels:g} kernels a call), call rate "
        f"{cuda_ms(float32_route, 200) * 1e3:.2f} us")

    # every type and C of the tests, an odd pixel count, views off alignment
    def at_odd_offset(t):
        v = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:].view(t.shape)
        return v.copy_(t)

    worst = 0.0
    for Cx in (1, 3, 8, 48):
        for gd, sd, od in itertools.product((torch.float32, bf16), repeat=3):
            gates = torch.randn(1, 7, 9, 4 * Cx, device="cuda", generator=gen).mul_(2).to(gd)
            state = torch.randn(1, 7, 9, Cx, device="cuda", generator=gen).to(sd)
            ref = cg.lstm_gates_plain(gates, state, out_dtype=od)
            for args in ((gates, state), (at_odd_offset(gates), at_odd_offset(state))):
                err, ok = _gates_err(cg.fused_lstm_gates(*args, out_dtype=od), ref)
                if not ok:
                    raise AssertionError(f"fused_lstm_gates C={Cx} {gd} {sd} {od}: err {err}")
                worst = max(worst, err)
    log(f"  fused_lstm_gates at 1x7x9, C 1/3/8/48, every type, aligned and odd views: "
        f"max abs err {worst:.2e}")

    # the s2d pixel layer's gate step: gate-major gates, C' = 12 at 60x80
    B2, H2, W2, C2 = S2D_GATES_SHAPE
    g2 = torch.randn(B2, H2, W2, 4 * C2, device="cuda", generator=gen).mul_(2).to(bf16)
    c2 = torch.randn(B2, H2, W2, C2, device="cuda", generator=gen).to(bf16)
    call = lambda: cg.fused_lstm_gates(g2, c2, out_dtype=bf16)  # noqa: E731
    out = call()
    err, ok = _gates_err(out, cg.lstm_gates_plain(g2, c2, out_dtype=bf16))
    if not ok:
        raise AssertionError(f"fused_lstm_gates at the s2d shape {S2D_GATES_SHAPE}: err {err}")
    moved = nbytes(g2, c2, *out)
    b_ms, b_by = bound_ms(10.0 * B2 * H2 * W2 * C2, moved, PEAK_F32_FLOPS)
    ms, _ = device_ms(call, 200)
    s2d = dict(max_abs_err=err, ms=ms, call_ms=cuda_ms(call, 200),
               plain_ms=device_ms(lambda: cg.lstm_gates_plain(g2, c2, out_dtype=bf16), 200)[0],
               bound_ms=b_ms, bound_by=b_by)
    log(f"  fused_lstm_gates at the s2d shape {S2D_GATES_SHAPE} (main contract): err {err:.2e} "
        f"device {ms * 1e3:.2f} us, call rate {s2d['call_ms'] * 1e3:.2f} us, plain device "
        f"{s2d['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}, "
        f"{moved / 1e6:.2f} MB)")
    return dict(route="cuda",
                source="evolutionary_illusion_generator_tpu_torch/csrc/lstm_gates.cu",
                replaces="evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py:57",
                **rows["main"], f32_contract=rows["f32"], s2d_shape=s2d)


@phase("kernels")
def check_kernels(params):
    import torch
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"fused_lstm_gates": check_gates(gen)}
    stream = torch.cuda.current_stream().cuda_stream

    def check_out(label, out, ref):
        eh = (out[0].float() - ref[0].float()).abs().max().item()
        ec = (out[1] - ref[1]).abs().max().item()
        if not (out[0].dtype == ref[0].dtype and eh <= H_TOL and ec <= C_TOL):
            raise AssertionError(f"{label}: max abs err h {eh} c {ec}")
        return max(eh, ec)

    def conv_case(name, wrapper, shapes, source, replaces):
        err = 0.0
        ms = plain_ms = lib_ms = b_total = ops_total = bytes_total = 0.0
        for layer, (H, W, C, cins) in shapes:
            srcs, wks, b, c_prev = _layer_inputs(gen, params, layer, H, W, cins)
            call = (lambda: wrapper(srcs, wks, b, c_prev)) if len(cins) > 1 else (
                lambda: wrapper(srcs[0], wks[0], b, c_prev))
            h, c = call()
            ref = cf.convlstm_layer_plain(srcs, wks, b, c_prev)
            torch.cuda.synchronize()
            e = check_out(f"{name} layer {layer}", (h, c), ref)
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
            g64 = sum(F.conv2d(x.double().permute(0, 3, 1, 2), cf.unpack_gate_weight(wk).double(),
                               padding=1) for x, wk in zip(srcs, wks))
            i, f, o, g = (g64.permute(0, 2, 3, 1) + b.double()).split(C, dim=-1)
            c64 = torch.sigmoid(f) * c_prev.double() + torch.sigmoid(i) * torch.tanh(g)
            drift, drift_p = ((t.double() - c64).abs().mean().item() for t in (c, ref[1]))
            if not drift <= drift_p:
                raise AssertionError(f"{name} layer {layer}: mean |c - c_float64| {drift:.3e} "
                                     f"above the plain version's {drift_p:.3e}")
            flops = _gate_flops(H, W, cins, C)
            layer_ms, layer_lib = cuda_ms(call, 50), cuda_ms(library, 50)
            ms += layer_ms
            plain_ms += cuda_ms(lambda: cf.convlstm_layer_plain(srcs, wks, b, c_prev), 20)
            lib_ms += layer_lib
            moved = nbytes(*srcs, *wks, b, c_prev, h, c)
            ops_total += flops / PEAK_BF16_FLOPS * 1e3
            bytes_total += moved / PEAK_BYTES_PER_S * 1e3
            b_total += bound_ms(flops, moved)[0]
            log(f"  {name} layer {layer} {MAIN_BATCH}x{H}x{W} C={C} sources {cins}: "
                f"err {e:.2e} kernel {layer_ms:.4f} ms ({flops / layer_ms / 1e9:.1f} TFLOP/s) "
                f"library {layer_lib:.4f} ms; mean |c - c_float64| kernel {drift:.2e} "
                f"plain {drift_p:.2e}")
            # the tile mappings the wrapper chooses from, each checked and timed
            chosen = cf.tile_width(MAIN_BATCH, H, W)
            sweep = []
            for tw in cf.tile_candidates(W):
                check_out(f"{name} layer {layer} tw={tw}",
                          cf.launch(srcs, wks, b, c_prev, stream, tw=tw), ref)
                t = cuda_ms(lambda: cf.launch(srcs, wks, b, c_prev, stream, tw=tw), 50)
                sweep.append(f"tw={tw}{'*' if tw == chosen else ''} {t:.4f} ms "
                             f"({flops / t / 1e9:.1f} TFLOP/s)")
            log("    tiles (* the wrapper's choice): " + ", ".join(sweep))
        results[name] = dict(
            route="cuda", source=source, replaces=replaces, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_total,
            bound_by="operations" if ops_total >= bytes_total else "bytes",
            library_ms=lib_ms,
        )

    # ragged shapes: image edges inside a tile, channel counts not a multiple
    # of 16 (40) or of 8 (12, staged without cp.async), C not a multiple of
    # 16; every tile mapping, both state types, one to three sources
    for B, H, W, cins, C, state in RAGGED_CASES:
        srcs = [torch.randn(B, H, W, ci, device="cuda", generator=gen).bfloat16() for ci in cins]
        wks = [cf.pack_gate_weight(torch.randn(3, 3, ci, 4 * C, device="cuda", generator=gen)
                                   .mul_(0.1)) for ci in cins]
        b = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.1)
        c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).to(getattr(torch, state))
        ref = cf.convlstm_layer_plain(srcs, wks, b, c_prev)
        out = (cf.fused_convlstm_layer_multi(srcs, wks, b, c_prev) if len(cins) > 1
               else cf.fused_convlstm_layer(srcs[0], wks[0], b, c_prev))
        torch.cuda.synchronize()
        e = check_out(f"ragged {B}x{H}x{W} {cins} C={C} {state}", out, ref)
        for tw in cf.tile_candidates(W):
            e = max(e, check_out(f"ragged {B}x{H}x{W} {cins} C={C} {state} tw={tw}",
                                 cf.launch(srcs, wks, b, c_prev, stream, tw=tw), ref))
        log(f"  ragged {B}x{H}x{W} sources {cins} C={C} {state}: err {e:.2e} "
            f"at tw {cf.tile_candidates(W)}")

    fused_src = "evolutionary_illusion_generator_tpu_torch/csrc/convlstm_fused.cu"
    conv_case("fused_convlstm_layer_multi", cf.fused_convlstm_layer_multi,
              [(l + 1, s) for l, s in enumerate(MULTI_LAYERS)], fused_src,
              "evolutionary_illusion_generator_tpu/ops/convlstm_fused_pallas.py:188")
    conv_case("fused_convlstm_layer", cf.fused_convlstm_layer, [(1, SINGLE_LAYER)],
              fused_src, "evolutionary_illusion_generator_tpu/ops/convlstm_fused_pallas.py:74")
    for name, r in results.items():
        log(f"  {name}: err {r['max_abs_err']:.2e} kernel {r['ms']:.4f} ms "
            f"plain {r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms "
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

    out = {
        "fused_lstm_gates": cg.fused_lstm_gates,
        "fused_convlstm_layer_multi": cf.fused_convlstm_layer_multi,
        "fused_convlstm_layer": cf.fused_convlstm_layer,
    }
    for key, (name, _) in BISECT_RUNGS.items():
        out[name] = cb.RUNGS[key]
    return out


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _check_generations(label, generations, steps, records, out, kernels=True):
    """The generation count, finite fitness, and each generation's launch
    counts (of a run that wrote ``out``/metrics.jsonl, its generations in
    ``records``): ``steps`` gate and 3 ``steps`` fused launches for each
    chunk run eagerly, none for a chunk replayed as a CUDA graph (its
    kernels run, but no wrapper launches them) or without ``kernels``."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if not len(recs) == len(records) == generations:
        raise AssertionError(f"{label}: ran {len(recs)} generations ({len(records)} recorded)")
    for gen, r in enumerate(records):
        eager = (r["chunks"] - r["replays"]) if kernels else 0
        want = dict.fromkeys(r["launches"], 0)
        want.update({"fused_lstm_gates": eager * steps,
                     "fused_convlstm_layer_multi": eager * steps * 3})
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


def run_generations(label, generations, steps, kernels=True, **kwargs):
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
        recs = _check_generations(label, generations, steps, records, out, kernels)
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
    want.update({"fused_lstm_gates": PROBE_ROLLOUTS * STEPS,
                 "fused_convlstm_layer_multi": PROBE_ROLLOUTS * STEPS * 3})
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

    total = dict.fromkeys(_wrappers(), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    main = dict(config=None, structure=StructureType.Circles, w=160, h=120,
                channels=PROBE_CHANNELS, c_dim=3)
    params_cpu = load_or_init(None, PROBE_CHANNELS, device="cpu")
    for name, opt in OPTIONS:
        int8 = "prednet_int8" in opt
        with _eval_options(**opt):
            counts, recs, _ = run_generations(name, 2, STEPS, kernels=not int8, **main)
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
    for flag, want in (("int8", 0), ("s2d", STEPS)):
        _reset_counts()
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            probe.main(["-i", png, f"--{flag}"])
        main_s = time.time() - t0
        vectors = probe.get_vectors(png, None, PROBE_CHANNELS, **{flag: True})
        counts = _counts()
        expect = dict.fromkeys(counts, 0)
        expect.update({"fused_lstm_gates": 2 * want, "fused_convlstm_layer_multi": 6 * want})
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
    want.update({"fused_lstm_gates": len(SCORER_BACKENDS) * SCORER_STEPS,
                 "fused_convlstm_layer_multi": len(SCORER_BACKENDS) * SCORER_STEPS * 3})
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
# Each shard runs the unsharded pass's ops on fewer rows, and cuDNN's
# algorithms follow the batch, so a bfloat16 sum may round another way
# (bit-equal at the main path's shape on the H100; at 64x48 a fifth of
# the flow's corner slots changed, tests/test_torch_cuda.py).  The
# rollouts are held as the reference phase
# holds card against CPU (one step: STEP_ATOL on at most STEP_DIFF_SHARE
# of the entries; 22 steps in the mean).  Corners are ranked by response,
# so a flip may swap two near-equal corners' slots: the flow's vectors are
# held slot by slot where both runs hold the same corner (on at least
# SHARD_MATCHED_SHARE of the masked slots), by their displacement
# (SHARD_SHIFT_ATOL px), and the fitness within SHARD_FITNESS_ATOL; whether
# all is bit-equal is logged beside them.
SHARD_MATCHED_SHARE = 0.5
SHARD_SHIFT_ATOL = 0.05
SHARD_FITNESS_ATOL = 0.05
TWO_PROCESS_TIMEOUT_S = 150

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


def _held_in_the_mean(label, got, want):
    d = (got.float() - want.float()).abs()
    if not (got.shape == want.shape and bool(got.isfinite().all())):
        raise AssertionError(f"parallel: {label} not finite or of the wrong shape")
    if not d.mean().item() <= ROLLOUT_MEAN_TOL:
        raise AssertionError(f"parallel: {label} mean {d.mean().item():.3e}")
    return d.max().item(), d.mean().item()


def _sharded_generations(params, devices, label):
    """The sharded evaluator (program cache on, and eager) against the
    unsharded one, generation after generation of one population; returns
    the sharded evaluators' launch counts."""
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
    single = GenerationEvaluator(EvalConfig(), params, cfg, device="cuda")
    graph = ShardedGenerationEvaluator(EvalConfig(), params, cfg, mesh)
    eager = ShardedGenerationEvaluator(EvalConfig(program_cache=False), params, cfg, mesh)
    pop = Population(cfg, seed=0)
    report = []

    def evaluate(items, _cfg):
        row = {}
        want = single(list(items))
        ref = single.last_results
        for name, ev in (("graph", graph), ("eager", eager)):
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.time()
            got = ev(list(items))
            torch.cuda.synchronize()
            row[name + "_s"] = time.time() - t0
            launched = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
            res = ev.last_results
            either = res["mask"] | ref["mask"]
            same = res["mask"] & ref["mask"] & (
                res["vectors"][..., :2] == ref["vectors"][..., :2]).all(-1)
            matched = float(same.sum() / max(either.sum(), 1))
            dv = float(np.abs(res["vectors"][..., 2:] - ref["vectors"][..., 2:])[same]
                       .max(initial=0.0))
            df = float(np.abs(got - want).max())
            if not (matched >= SHARD_MATCHED_SHARE and dv <= SHARD_SHIFT_ATOL
                    and df <= SHARD_FITNESS_ATOL and np.isfinite(got).all()):
                raise AssertionError(f"parallel ({label}, {name}): the same corner in "
                                     f"{matched:.4f} of the slots, displacements {dv:.3e}, "
                                     f"fitness {df:.3e} from the unsharded")
            exact = all(np.array_equal(res[k], ref[k]) for k in ("vectors", "mask"))
            row[name] = (matched, dv, df, exact and bool(np.array_equal(got, want)), launched)
            if name == "eager":
                chunks = len(res["outputs"]._chunks)
                expect = {"fused_lstm_gates": chunks * n * STEPS,
                          "fused_convlstm_layer_multi": chunks * n * 3 * STEPS}
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
            f"{row['graph_s']:.4f}, eager {row['eager_s']:.4f}; against the unsharded "
            f"(share of slots with the same corner, displacement max, fitness max, "
            f"vectors, masks and fitness bit-equal, launches): "
            f"graph {row['graph']}, eager {row['eager']}")
    log(f"  sharded {label}: {graph._programs.replays} graph replays over "
        f"{len(graphs)} captured keys")
    return counts


@phase("parallel")
def parallel_phase(params, card):
    """``parallel/`` on the card, on a mesh that repeats cuda:0: the sharded
    evaluator (counted), the data-parallel train step, the spatial and
    pipelined rollouts (the plain route: no kernel), and two processes over
    gloo; on real devices too where the machine has two."""
    import hashlib
    import socket

    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.evolution import (
        EvalConfig,
        GenerationEvaluator,
    )
    from evolutionary_illusion_generator_tpu_torch.models.prednet import model
    from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain as pre
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
        bundled_weights_path,
        params_to_numpy,
    )
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
    if torch.cuda.device_count() >= 2:
        more = _sharded_generations(params, [f"cuda:{i}" for i in range(2)], "cuda:0, cuda:1")
        counts = {k: v + more[k] for k, v in counts.items()}
    else:
        log(f"  a run on two real devices was not possible: this machine has "
            f"{torch.cuda.device_count()} CUDA device")

    _reset_counts()
    # the data-parallel train step: the colour recipe, one step
    warm = bundled_weights_path((3, 48, 96, 192))
    kw = dict(pre.pretrain_kwargs(pre._parser().parse_args(
        TRAIN_RECIPE + ["--init_weights", warm])), steps=1, verbose=False)
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

    # the spatial rollout at the pop256_v5e8 frame: one step, then 22
    gen = torch.Generator().manual_seed(7)
    B, H, W, C = SPATIAL_SHAPE
    imgs = (torch.rand(B, H, W, C, generator=gen) * 255).to(torch.uint8).float().div(255).cuda()
    mesh2 = make_mesh_2d(1, PARALLEL_SHARDS, devices=["cuda:0"] * PARALLEL_SHARDS)
    for repeat, extension, held in ((1, 1, _held_like_a_step), (20, 2, _held_in_the_mean)):
        peaks, frames, secs = {}, {}, {}
        for name, run in (
                ("unsharded", lambda: model.rollout_flow_frames(
                    params, imgs, repeat=repeat, extension=extension, use_pallas=False)),
                ("spatial", lambda: make_spatial_rollout(
                    mesh2, repeat=repeat, extension=extension)(params, imgs))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with torch.inference_mode():
                frames[name] = run()
            torch.cuda.synchronize()
            secs[name] = time.time() - t0
            peaks[name] = torch.cuda.max_memory_allocated()
        stats = [held(f"spatial {repeat + extension} steps, frame {i}", a, b)
                 for i, (a, b) in enumerate(zip(frames["spatial"], frames["unsharded"]))]
        log(f"  spatial (pop 1, sp {PARALLEL_SHARDS}) at {SPATIAL_SHAPE}, {repeat}+{extension} "
            f"steps: frames against the unsharded {stats}; s {secs}; peak device memory GiB "
            f"{ {k: round(v / 2**30, 3) for k, v in peaks.items()} }")
        del frames
    del imgs

    # the pipelined rollout: four stages, four microbatches
    B, H, W, C = PIPELINE_SHAPE
    imgs = (torch.rand(B, H, W, C, generator=gen) * 255).to(torch.uint8).float().div(255).cuda()
    pp = make_pp_mesh(4, devices=["cuda:0"] * 4)
    for repeat, extension, held in ((1, 1, _held_like_a_step), (20, 2, _held_in_the_mean)):
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            got = pipelined_rollout_flow_frames(params, imgs, pp, repeat=repeat,
                                                extension=extension, n_micro=4)
            torch.cuda.synchronize()
            t1 = time.time()
            want = model.rollout_flow_frames(params, imgs, repeat=repeat, extension=extension,
                                             use_pallas=False)
            torch.cuda.synchronize()
        stats = [held(f"pipeline {repeat + extension} steps, frame {i}", a, b)
                 for i, (a, b) in enumerate(zip(got, want))]
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
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = _TWO_PROCESS_CHILD.format(repo=os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                 JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                 OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2))))
        for rank in range(2)]
    t0 = time.time()
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TWO_PROCESS_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"parallel: a two-process rank failed: {err[-2000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    fitness = {r["rank"]: r["scores"] for r in results}
    log(f"  two processes on cuda:0 (gloo), {len(items)} genomes: fitness by rank {fitness}, "
        f"single process {want.tolist()}; {time.time() - t0:.1f} s with start-up")
    for r in results:
        if r["processes"] != [0, 1] or r["rows"] != hashes:
            raise AssertionError(f"parallel: rank {r['rank']} mesh {r['processes']}, fetched "
                                 f"rows equal {r['rows'] == hashes}")
        if not np.abs(np.array(r["scores"]) - want).max() <= SHARD_FITNESS_ATOL:
            raise AssertionError(f"parallel: rank {r['rank']} fitness {r['scores']} vs {want}")
    if fitness[0] != fitness[1]:
        raise AssertionError("parallel: the two ranks assigned different fitness")
    # the sharded runs' launches and the single-process reference's
    counts = {k: counts[k] + v for k, v in _counts().items()}
    log(f"  parallel kernel launches {counts} ({card})")
    return counts


@contextlib.contextmanager
def _recorded_sharded_generations(records):
    """Each sharded generation's seconds (CUDA-synchronised), shard passes,
    graph replays and captures, and kernel launches, appended to
    ``records`` by the driver's sharded evaluator."""
    import torch

    from evolutionary_illusion_generator_tpu_torch import parallel
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates as cg

    sharded = parallel.ShardedGenerationEvaluator

    class Recording(sharded):
        def __call__(self, *a, **kw):
            counts, replays = _counts(), self._programs.replays
            captured = cg.fused_lstm_gates.captured
            torch.cuda.synchronize()
            t0 = time.time()
            scores = super().__call__(*a, **kw)
            torch.cuda.synchronize()
            res = self.last_results
            records.append(dict(
                seconds=time.time() - t0, fitness=list(map(float, scores)),
                passes=sum(len(c) for c in res["outputs"]._chunks),
                replays=self._programs.replays - replays,
                captures=int(cg.fused_lstm_gates.captured != captured),
                launches={k: v - counts[k] for k, v in _counts().items() if v != counts[k]}))
            return scores

    parallel.ShardedGenerationEvaluator = Recording
    try:
        yield
    finally:
        parallel.ShardedGenerationEvaluator = sharded


@phase("composition")
def composition_phase(card):
    """``graft_entry.composition`` at the ``pop256_v5e8`` preset's own
    geometry on the card (the fused route, a mesh of cuda:0 x 8): one
    generation, its checkpoint, the resumed generation.  Logs the fused
    kernel's strip width at each fused layer, s/generation with the shard
    passes run eagerly, captured and replayed, the peak device memory, the
    launches and the best fitness; fails on a non-finite fitness, a best
    fitness of 0 or launches that are not 22 and 66 per eager pass."""
    import numpy as np
    import torch

    from evolutionary_illusion_generator_tpu_torch.configs import run_preset
    from evolutionary_illusion_generator_tpu_torch.graft_entry import composition
    from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import tile_width

    rp = run_preset("pop256_v5e8")
    n, B, H, W = rp.n_devices, rp.microbatch // rp.n_devices, rp.h, rp.w
    widths = {f"layer {l} ({B}, {H >> l}, {W >> l})": tile_width(B, H >> l, W >> l)
              for l in (1, 2, 3)}
    log(f"  fused kernel strip widths {widths}")
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
        want = {"fused_lstm_gates": eager * STEPS, "fused_convlstm_layer_multi": eager * 3 * STEPS}
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

    cfg = preset("circles")
    items = list(Population(cfg, seed=0).population.items())
    want = {name: n for name, (_, n) in TRACE_KERNELS.items()}
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
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        # the path's kernels as the trace saw them run: in the replay they
        # run from the graph, and no wrapper launched them
        ran = {name: sum(e.count for e in kernels if key in e.key)
               for name, (key, _) in TRACE_KERNELS.items()}
        log(f"  profiled generation ({label}): wall {wall * 1e3:.1f} ms (profiler on), device "
            f"kernels {busy_us / 1e3:.1f} ms, busy share {busy_us / 1e6 / wall:.3f}, "
            f"{sum(e.count for e in kernels)} kernel launches; in the trace {ran}, counted by "
            f"the wrappers {counts}")
        if ran != want:
            raise AssertionError(f"profile ({label}): the trace holds {ran}, expected {want}")
        if on:
            graphs = [g for g in evaluator._programs.graphs.values() if g is not None]
            if not (len(graphs) == 1 and evaluator._programs.replays == replays + 1
                    and graphs[0].recorded == want and not counts):
                raise AssertionError(
                    f"profile: {len(graphs)} captured graphs, "
                    f"{evaluator._programs.replays - replays} replays, recorded "
                    f"{[g.recorded for g in graphs]}, wrapper launches {counts}; expected one "
                    f"replay of a graph that recorded {want} and no wrapper launch")
        elif counts != want:
            raise AssertionError(f"profile (eager): wrapper launches {counts}, expected {want}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


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
    want["fused_convlstm_layer_multi"] = 0
    if counts != want:
        raise AssertionError(f"bisect: kernel launches {counts}, expected {want}")
    log(f"  bisect launches {counts}")

    B, H, W, Cin, C = kb.BIG_SHAPE
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
    log(f"  fused kernel (F) at --big: err {err:.2e} kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), tw={cf.tile_width(B, H, W)}")
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
        options_counts = options_phase(params, best_png, card)
    scorer_counts = scorers(params, card)
    train_counts = train_phase(card)
    parallel_counts = parallel_phase(params, card)
    composition_counts = composition_phase(card)
    profile_generation(params)
    bisect_kernels, bisect_counts = bisect()
    kernels.update(bisect_kernels)
    log(f"[total] {time.time() - t0:.1f} s")
    # launches over the driven paths: main_path, cli, probe, options, scorers,
    # train (none: the trainer runs the plain route), parallel, composition,
    # then the bisection ladder
    paths = (counts, cli_counts, probe_counts, options_counts, scorer_counts, train_counts,
             parallel_counts, composition_counts, bisect_counts)
    rows = [dict(name=name, launches=sum(c[name] for c in paths), **r)
            for name, r in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    watchdog.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
