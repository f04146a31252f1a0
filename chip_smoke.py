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
   rate (``call_ms``), and at every type and an odd pixel count on views off
   alignment; the fused kernel per layer with its TFLOP/s (CUDA events),
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
   the seconds ``save_best_artifacts`` takes a generation;
9. profile: device time by kernel and the number of kernel launches over
   one warm main-path generation;
10. bisect: the kernel-bisection ladder (``scripts/kernel_bisect.py``) at
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
the main path, cli and bisect phases), and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a card or without the port beside it.
"""

import itertools
import json
import math
import os
import re
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
    the work; time that one with :func:`cuda_ms`.
    Returns (ms, kernels launched per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device kernel")
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
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    # float32 convs and matmuls in full float32 wherever the plain versions
    # are compared (cuDNN would otherwise use TF32 for float32 convs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


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
    return dict(route="cuda",
                source="evolutionary_illusion_generator_tpu_torch/csrc/lstm_gates.cu",
                replaces="evolutionary_illusion_generator_tpu/ops/convlstm_pallas.py:57",
                **rows["main"], f32_contract=rows["f32"])


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


def _check_generations(label, generations, steps, counts, out):
    """The launch counts (one chunk per generation), the generation count
    and finite fitness of a run that wrote ``out``/metrics.jsonl."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    want = dict.fromkeys(counts, 0)
    want.update({"fused_lstm_gates": generations * steps,
                 "fused_convlstm_layer_multi": generations * steps * 3})
    if counts != want:
        raise AssertionError(f"{label}: kernel launches {counts}, expected {want}")
    if len(recs) != generations:
        raise AssertionError(f"{label}: ran {len(recs)} generations")
    for r in recs:
        if not all(map(math.isfinite, (r["fitness_mean"], r["fitness_max"],
                                       r["fitness_std"]))):
            raise AssertionError(f"{label}: non-finite fitness {r}")
        log(f"  {label} generation {r['generation']}: pop {r['pop_size']} "
            f"{r['eval_seconds']:.3f} s fitness max {r['fitness_max']:.5f} "
            f"mean {r['fitness_mean']:.5f}")
    log(f"  {label} launches {counts}")
    return recs


def run_generations(label, generations, steps, **kwargs):
    """``neat_illusion`` on the card, without artifacts; checks the launch
    counts, finite fitness and the generation count."""
    from evolutionary_illusion_generator_tpu_torch.evolution import neat_illusion

    with tempfile.TemporaryDirectory() as out:
        _reset_counts()
        pop = neat_illusion(out, None, generations=generations, seed=0,
                            save_artifacts=False, quiet=True, device="cuda", **kwargs)
        counts = _counts()
        recs = _check_generations(label, generations, steps, counts, out)
    if pop.generation != generations:
        raise AssertionError(f"{label}: ran {pop.generation} generations")
    return counts, recs


@phase("main_path")
def main_path():
    from evolutionary_illusion_generator_tpu_torch.structure import StructureType

    counts, recs = run_generations(
        "main", 2, STEPS, config=None, structure=StructureType.Circles, w=160, h=120,
        channels=(3, 48, 96, 192), c_dim=3)
    log(f"  main s/generation (generation 1): {recs[1]['eval_seconds']:.4f}")
    return counts


@phase("default_color")
def default_color():
    from evolutionary_illusion_generator_tpu_torch.neat import preset
    from evolutionary_illusion_generator_tpu_torch.structure import StructureType

    _, recs = run_generations(
        "default_color", 2, 5 + 2, config=preset("circles").replace(pop_size=40),
        structure=StructureType.CirclesFree, w=320, h=240, channels=(3, 48, 96, 192),
        c_dim=3, repeat=5)
    log(f"  default_color s/generation (generation 1): {recs[1]['eval_seconds']:.4f}")


@phase("cli")
def cli_run():
    """``python -m evolutionary_illusion_generator_tpu_torch.cli -s 1
    --generations 2 --profile_dir ...`` in process: the color predictor at
    full width, 160x120, the circles preset, with its artifacts.  The
    driver's evaluator is wrapped to keep the last generation's results and
    its ``save_best_artifacts`` to time it and take its peak device memory
    (the 800x800 poster is 640,000 CPPN points)."""
    import torch

    from evolutionary_illusion_generator_tpu_torch import cli
    from evolutionary_illusion_generator_tpu_torch.evolution import driver
    from evolutionary_illusion_generator_tpu_torch.utils.png import read_png
    from evolutionary_illusion_generator_tpu_torch.utils.profiling import TRACE_FILE

    evaluators, artifact_s = [], []
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

    with tempfile.TemporaryDirectory() as out:
        prof = os.path.join(out, "prof")
        driver.GenerationEvaluator, driver.save_best_artifacts = Recording, timed_save
        try:
            _reset_counts()
            cli.main(["-o", out, *CLI_ARGS, "--profile_dir", prof])
            counts = _counts()
        finally:
            driver.GenerationEvaluator, driver.save_best_artifacts = evaluator, save
        recs = _check_generations("cli", 2, STEPS, counts, out)
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
    log(f"  cli: {len(vectors)} winner vectors; trace of generation 1: {len(kernels)} kernel "
        f"events, {found}")
    log("  cli save_best_artifacts s/generation (device memory above its start): "
        + ", ".join(f"{t:.4f} ({peak / 2**20:.1f} MiB)" for t, peak in artifact_s))
    log(f"  cli s/generation (generation 1): {recs[1]['eval_seconds']:.4f}")
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
    evaluator = GenerationEvaluator(EvalConfig(), params, cfg, device="cuda")
    evaluator(items)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        evaluator(items)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"  profiled generation: wall {wall * 1e3:.1f} ms (profiler on), device "
        f"kernels {busy_us / 1e3:.1f} ms, busy share {busy_us / 1e6 / wall:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches")
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
    check_device()
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
    cli_counts = cli_run()
    profile_generation(params)
    bisect_kernels, bisect_counts = bisect()
    kernels.update(bisect_kernels)
    log(f"[total] {time.time() - t0:.1f} s")
    # launches over the driven paths: main_path, cli, then the bisection ladder
    rows = [dict(name=name, launches=counts[name] + cli_counts[name] + bisect_counts[name], **r)
            for name, r in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    watchdog.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
