"""Where the time of the fused kernel's wgmma body, and of the gate convs'
wgmma body, goes on the card.

Builds variants of ``csrc/convlstm_fused.cu`` (or, with ``--body gates``,
of ``csrc/gate_convs_wgmma.cu``: the ``True`` route's gate convs with the
gates written out), each the kernel with one part taken out by a text
substitution, and times the wgmma body of each on its own plan, with CUDA
events, twice, the second time in the reverse order; beside them the
mma_sync body at its strip width (for the gate convs ``convlstm_narrow``'s
``gate_convs_kernel`` at the strip width it took before the wgmma body,
and cuDNN's split convs, ``model._gate_convs``)::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.fused_breakdown [--body gates]
        [--yardsticks]

The fused kernel at the fused layers of the main path (a chunk of 8 at
160x120) and of the north star (a chunk of 25 at 640x480), on
``ops/convlstm_fused.py::plan``:

===============  ===========================================================
variant          what it changes
===============  ===========================================================
kernel           nothing
no epilogue      returns after the main loop (no gate math, no stores)
no loads         as "no epilogue", and the TMA copies nothing
===============  ===========================================================

The gate convs at the north star's layers 1-3, on
``ops/convlstm_narrow.py::gate_plan``:

===============  ===========================================================
variant          what it changes
===============  ===========================================================
kernel           nothing
no expansion     R_above's coarse box is not expanded into the slab (the
                 products read stale rows)
no epilogue      returns after the main loop (no gates staged or stored)
no loads         as "no epilogue", and the TMA copies nothing and R_above's
                 box is not expanded
no products      as "no loads", and no wgmma is issued (the ring's waits,
                 barriers and per-source roundings remain)
no weight loads  the TMA copies no weight slice (the slabs land)
no slab loads    the TMA copies no slab or coarse box (the weights land)
gates in shared  the running gates in shared memory past the ring instead of
memory           registers, at N <= 128 (``--cg 32`` or ``16``; N 192 keeps
                 them in registers: they do not fit beside a ring of three)
cluster of 4     four blocks share each weight slice (twice the multicast)
ring of 3        three chunks in the ring at N 128 (``--cg 32``), not four
release arrive   the ring's cluster barrier with a release arrival (orders
                 every write of the thread), not a relaxed one
expansion ahead  R_above's next chunk waited for and expanded a chunk ahead,
                 under the products of the chunk before it
trap in the      the ring's waits trap where they wait (a trap beside a group
ring             of products in flight), not after the last product
===============  ===========================================================

``--body gates --yardsticks`` builds no variant and times only the
mma.sync body and cuDNN's split convs, at every layer of the main path's
step and the north star's (``GATE_YARDSTICK_LAYERS``).

``--cg`` times the gate convs at that channel group instead of the plan's.

Only "kernel" and the three designs after "no products" compute the right
result; the others measure a part and
their outputs are garbage.  Every variant builds into a temporary directory
with ``_build``'s flags.  It needs a CUDA card and ``nvcc``; a substitution
that no longer applies to the source raises, so the variants follow the
kernel or fail loudly.  Prints one line a layer and returns
{layer: {variant: ms}}.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _build
from ..ops import convlstm_fused as cf
from ..ops import convlstm_narrow as cn

__all__ = ["VARIANTS", "LAYERS", "GATE_VARIANTS", "GATE_LAYERS", "variant_source",
           "gate_variant_source", "main"]

_SOURCE = Path(_build.__file__).resolve().parent / "csrc" / "convlstm_fused.cu"
_GATE_SOURCE = _SOURCE.with_name("gate_convs_wgmma.cu")
_NO_EPILOGUE = (
    "  if (b >= g.B) return;  // a cluster's padding block\n",
    "  if (b >= g.B || sb[N - 1] != 12345.0f) return;\n",
)
# name -> [(text, replacement), ...], each text found exactly once
VARIANTS = {
    "kernel": [],
    "no epilogue": [_NO_EPILOGUE],
    "no loads": [
        _NO_EPILOGUE,
        ("    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES + g.slab_bytes);\n"
         "    eigen::tma_load_4d(st + T::W_BYTES, mx, bar, k0, x0 - 1, y0 - 1, b);\n"
         "    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += CLUSTER)\n",
         "    eigen::mbar_arrive_expect_tx(bar, 0);\n"
         "    for (int tap = 9; tap < 9; tap += CLUSTER)\n"),
    ],
}
# (label, B, H, W, source channels, C): the fused layers of the main path
# and of the north star, and the north star's layer 1 with its three
# sources in one (the same products over one 240-channel source)
LAYERS = (
    ("main 1", 8, 60, 80, (96, 48, 96), 48),
    ("main 2", 8, 30, 40, (192, 96, 192), 96),
    ("main 3", 8, 15, 20, (384, 192), 192),
    ("north star 1", 25, 240, 320, (96, 48, 96), 48),
    ("north star 1, one source", 25, 240, 320, (240,), 48),
    ("north star 2", 25, 120, 160, (192, 96, 192), 96),
    ("north star 3", 25, 60, 80, (384, 192), 192),
)

_GATE_NO_EPILOGUE = (
    "  if (b >= g.B) return;  // a cluster's padding block\n",
    "  if (b >= g.B || g.bias_bf16 != 12345) return;\n",
)
_GATE_NO_EXPANSION = (
    "      if (kc >= coarse_from) expand(kc % T::STAGES);  // under chunk kc - 1's products\n", "")
_GATE_NO_LOADS = [
    _GATE_NO_EPILOGUE,
    ("    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES + bytes);\n"
     "    eigen::tma_load_4d(dst, mx, bar, k0, xc, yc, b);\n"
     "    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += CLUSTER)\n",
     "    eigen::mbar_arrive_expect_tx(bar, 0);\n"
     "    for (int tap = 9; tap < 9; tap += CLUSTER)\n"),
    _GATE_NO_EXPANSION,
]
# the running gates in shared memory past the ring, [N / 4][NT] bfloat16
# pairs, where they fit beside a ring of three (N <= 128; at N 192 they stay
# in registers)
_GATES_IN_SMEM = [
    ("  static constexpr int SMEM = BARS + 8 * STAGES;\n",
     "  static constexpr int GATES_S = BARS + 8 * STAGES;\n"
     "  static constexpr int SMEM = GATES_S + (N <= 128 ? N * NT : 0);\n"),
    ("  __nv_bfloat162 gates[N / 4];\n",
     "  __nv_bfloat162 gates_r[N <= 128 ? 1 : N / 4];\n"
     "  __nv_bfloat162* gates_s = reinterpret_cast<__nv_bfloat162*>(smem + T::GATES_S) + tid;\n"
     "#define GATE(k) \\\n"
     "  (*(N <= 128 ? &gates_s[(k) * NT] : &gates_r[(k) % (N <= 128 ? 1 : N / 4)]))\n"),
    ("    gates[k] = __floats2bfloat162_rn(b0, b1);\n",
     "    GATE(k) = __floats2bfloat162_rn(b0, b1);\n"),
    ("      const float2 gv = __bfloat1622float2(gates[k]);\n      gates[k] =",
     "      const float2 gv = __bfloat1622float2(GATE(k));\n      GATE(k) ="),
    ("+ cl] = gates[k].x;", "+ cl] = GATE(k).x;"),
    ("+ cl] = gates[k].y;", "+ cl] = GATE(k).y;"),
]
# R_above's next chunk expanded a chunk ahead, under the products before it
_GATE_AHEAD = (
    "      mbar_wait_or_flag(bars + 8 * (kc % T::STAGES), (kc / T::STAGES) & 1, stuck);\n"
    "      if (kc >= coarse_from) expand(kc % T::STAGES);  // under chunk kc - 1's products\n"
    "      products(kc, kc != first);\n",
    "      mbar_wait_or_flag(bars + 8 * (kc % T::STAGES), (kc / T::STAGES) & 1, stuck);\n"
    "      products(kc, kc != first);\n"
    "      if (kc + 1 >= coarse_from && kc + 1 < g.n_chunks) {\n"
    "        mbar_wait_or_flag(bars + 8 * ((kc + 1) % T::STAGES), ((kc + 1) / T::STAGES) & 1,\n"
    "                          stuck);\n"
    "        expand((kc + 1) % T::STAGES);\n"
    "      }\n")
# the ring's waits trap where they wait (common.cuh's mbar_wait_or_trap)
_GATE_TRAP_IN_RING = (
    "      mbar_wait_or_flag(bars + 8 * (kc % T::STAGES), (kc / T::STAGES) & 1, stuck);\n",
    "      eigen::mbar_wait_or_trap(bars + 8 * (kc % T::STAGES), (kc / T::STAGES) & 1);\n")
# the gates-out body's variants, as VARIANTS (each on csrc/gate_convs_wgmma.cu):
# parts taken out, then the designs it was measured against
GATE_VARIANTS = {
    "kernel": [],
    "no expansion": [_GATE_NO_EXPANSION],
    "no epilogue": [_GATE_NO_EPILOGUE],
    "no loads": _GATE_NO_LOADS,
    "no products": _GATE_NO_LOADS + [
        ("      eigen::wgmma_bf16<N>(acc,",
         "      if (g.bias_bf16 == 12345) eigen::wgmma_bf16<N>(acc,"),
    ],
    "no weight loads": [
        ("    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES + bytes);\n",
         "    eigen::mbar_arrive_expect_tx(bar, bytes);\n"),
        ("    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += CLUSTER)\n",
         "    for (int tap = 9; tap < 9; tap += CLUSTER)\n"),
    ],
    "no slab loads": [
        ("    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES + bytes);\n"
         "    eigen::tma_load_4d(dst, mx, bar, k0, xc, yc, b);\n",
         "    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES);\n"),
    ],
    "gates in shared memory": _GATES_IN_SMEM,
    "cluster of 4": [("constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 4;")],
    "ring of 3": [("  static constexpr int STAGES = N == 128 ? 4 : 3;\n",
                   "  static constexpr int STAGES = 3;\n")],
    "release arrive": [("eigen::cluster_arrive_relaxed();", "eigen::cluster_arrive();")],
    "expansion ahead": [_GATE_AHEAD],
    "trap in the ring": [_GATE_TRAP_IN_RING],
}
# (label, B, H, W, C, C_above): the gate convs' wgmma layers of the north
# star (3,48,96,192 at a chunk of 25, 640x480)
GATE_LAYERS = (
    ("north star 1", 25, 240, 320, 48, 96),
    ("north star 2", 25, 120, 160, 96, 192),
    ("north star 3", 25, 60, 80, 192, None),
)
# every layer of the main path's step (a chunk of 8 at 160x120) and the
# north star's: the yardsticks' layers
GATE_YARDSTICK_LAYERS = tuple(
    (f"{label} {l}", B, H >> l, W >> l, C, C_above)
    for label, B, H, W in (("main", 8, 120, 160), ("north star", 25, 480, 640))
    for l, (C, C_above) in enumerate(((3, 48), (48, 96), (96, 192), (192, None))))


def _substituted(source: Path, variants: dict, name: str) -> str:
    text = source.read_text()
    for old, new in variants[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old.strip()[:60]!r} is not in the source once")
        text = text.replace(old, new)
    return text


def variant_source(name: str) -> str:
    """The fused kernel's source with variant ``name``'s substitutions."""
    return _substituted(_SOURCE, VARIANTS, name)


def gate_variant_source(name: str) -> str:
    """The gate convs' wgmma source with variant ``name``'s substitutions."""
    return _substituted(_GATE_SOURCE, GATE_VARIANTS, name)


def _build_all(tmp: Path, variants=VARIANTS, source=variant_source,
               entry_name="eigen_convlstm_fused_wgmma") -> dict:
    """One shared library per variant, all nvcc processes at once."""
    (tmp / "common.cuh").write_text((_SOURCE.parent / "common.cuh").read_text())
    nvcc, procs = _build._find_nvcc(), {}
    for i, name in enumerate(variants):
        src = tmp / f"variant{i}.cu"
        src.write_text(source(name))
        procs[name] = (tmp / f"variant{i}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(tmp / f"variant{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        entry = getattr(lib, entry_name)
        entry.argtypes = _build._SIGNATURES[entry_name]
        entry.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _graph_ms(fn, iters):
    """``fn`` captured once into a CUDA graph (after two eager calls), its
    replays timed with CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _ms(graph.replay, iters)


def _ms(fn, iters):
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _gates(libs, layers=GATE_LAYERS, cg=None) -> dict:
    """The gate convs' variants (``libs``, none for the yardsticks alone) at
    ``layers`` (at channel group ``cg`` in place of the plan's), timed as
    the fused kernel's, beside the mma.sync body and cuDNN's split
    convs."""
    from ..models.prednet import model

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, B, H, W, C, C_above in layers:
        cins = [2 * C, C] + ([C_above] if C_above else [])
        shapes = [(B, H, W, 2 * C), (B, H, W, C)] + ([(B, H // 2, W // 2, C_above)] if C_above
                                                     else [])
        srcs = [torch.rand(s, device="cuda", generator=gen).mul_(2).sub_(1).bfloat16()
                for s in shapes]
        wks = [cf.pack_gate_weight(torch.randn(3, 3, ci, 4 * C, device="cuda", generator=gen)
                                   .div_((9 * sum(cins)) ** 0.5)) for ci in cins]
        bias = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.3).bfloat16()
        gates = torch.empty(B, H, W, 4 * C, device="cuda", dtype=torch.bfloat16)
        p = cn.gate_plan(H, W, C)
        if cg and p.body == "wgmma":
            p = p._replace(cg=cg)
        args = []
        for s in range(cf.MAX_SOURCES):
            args += ([srcs[s].data_ptr(), wks[s].data_ptr(), cins[s]] if s < len(srcs)
                     else [None, None, 0])
        args += [len(srcs), bias.data_ptr(), 1, gates.data_ptr(), B, H, W, C, p.cg, p.tile_h,
                 p.tile_w, p.wg_stride, stream]

        def run(lib):
            if lib.eigen_gate_convs_wgmma(*args) != 0:
                raise RuntimeError(f"{label}: launch failed")

        iters = 10 if B > 8 else 50
        names = list(libs)
        for order in (names, names[::-1]):
            second = {name: _ms(lambda: run(libs[name]), iters) for name in order}
        times = {name: second[name] for name in names}
        # the yardsticks as CUDA graph replays (a call's host work is longer
        # than the main path's kernels); the stream is the capture's
        old = cf.Plan("mma_sync", 32, 0, cf.tile_width(B, H, W), 0)
        times["mma_sync"] = _graph_ms(lambda: cn.launch_gates(
            srcs, wks, bias, torch.bfloat16, torch.cuda.current_stream().cuda_stream, plan=old),
            iters)
        p_conv = {"lstm_w_e": cf.unpack_gate_weight(wks[0]),
                  "lstm_w_r": cf.unpack_gate_weight(wks[1]), "lstm_b": bias}
        if C_above:
            p_conv["lstm_w_up"] = cf.unpack_gate_weight(wks[2])
        times["cuDNN"] = _graph_ms(lambda: model._gate_convs(
            p_conv, {"e": srcs[0], "r": srcs[1]}, srcs[2] if C_above else None, torch.bfloat16,
            False, False), iters)
        flops = 2.0 * B * H * W * 9 * sum(cins) * 4 * C
        planned = f"wgmma cg {p.cg} tile {p.tile_h}x{p.tile_w}" if p.body == "wgmma" else p.body
        print(f"  gate convs {label} ({B}, {H}, {W}) C {C} R_above {C_above}, {planned}: "
              + ", ".join(f"{k} {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)"
                          for k, t in times.items()), flush=True)
        out[label] = times
    return out


def main(argv=None) -> dict:
    """Times every variant at every layer of ``LAYERS`` (``--body gates``:
    ``GATE_LAYERS``) twice, in turns, the second time in the reverse order;
    returns {layer: {variant: ms of the second round, "mma_sync": ms}} (and
    ``"cuDNN"`` for the gate convs)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--body", choices=("fused", "gates"), default="fused")
    ap.add_argument("--yardsticks", action="store_true",
                    help="with --body gates: only the mma.sync body and cuDNN, at every layer")
    ap.add_argument("--cg", type=int, choices=cf.CHANNEL_GROUPS, default=None,
                    help="with --body gates: this channel group in place of the plan's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fused_breakdown needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.body == "gates" and args.yardsticks:
        return _gates({}, GATE_YARDSTICK_LAYERS)
    if args.body == "gates":
        with tempfile.TemporaryDirectory() as tmp:
            return _gates(_build_all(Path(tmp), GATE_VARIANTS, gate_variant_source,
                                     "eigen_gate_convs_wgmma"), cg=args.cg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(Path(tmp))
        for label, B, H, W, cins, C in LAYERS:
            srcs = [torch.rand(B, H, W, ci, device="cuda", generator=gen).mul_(2).sub_(1)
                    .bfloat16() for ci in cins]
            wks = [cf.pack_gate_weight(torch.randn(3, 3, ci, 4 * C, device="cuda", generator=gen)
                                       .mul_(0.03)) for ci in cins]
            bias = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.1)
            c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()
            h, c = torch.empty_like(c_prev), torch.empty(c_prev.shape, device="cuda")
            p = cf.plan_for(srcs, wks, c_prev)
            args = []
            for s in range(cf.MAX_SOURCES):
                args += ([srcs[s].data_ptr(), wks[s].data_ptr(), cins[s]] if s < len(srcs)
                         else [None, None, 0])
            args += [len(srcs), bias.data_ptr(), c_prev.data_ptr(), 1, h.data_ptr(),
                     c.data_ptr(), B, H, W, C, p.cg, p.tile_h, p.tile_w, p.wg_stride, stream]

            def run(lib):
                if lib.eigen_convlstm_fused_wgmma(*args) != 0:
                    raise RuntimeError(f"{label}: launch failed")

            old = cf.Plan("mma_sync", 16, 0, cf.tile_width(B, H, W), 0)
            iters = 50 if B <= 8 else 10
            names = list(libs)
            for order in (names, names[::-1]):
                second = {name: _ms(lambda: run(libs[name]), iters) for name in order}
            times = {name: second[name] for name in names}
            times["mma_sync"] = _ms(lambda: cf.launch(srcs, wks, bias, c_prev, stream, plan=old),
                                    iters)
            flops = 2.0 * B * H * W * 9 * sum(cins) * 4 * C
            print(f"  {label} ({B}, {H}, {W}) C {C}, wgmma cg {p.cg} tile {p.tile_h}x{p.tile_w}: "
                  + ", ".join(f"{k} {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)"
                              for k, t in times.items()), flush=True)
            out[label] = times
    return out


if __name__ == "__main__":
    main()
