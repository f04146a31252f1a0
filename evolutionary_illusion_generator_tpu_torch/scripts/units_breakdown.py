"""Where the time of the A and Ahat units' wgmma and im2col bodies goes on the card.

Builds variants of ``csrc/prednet_units_wgmma.cu``, each the kernels with
one part taken out by a text substitution, and times each unit at the north
star's layers (a chunk of 25 at 640x480, ``3,48,96,192``) on its own plan
(``ops/prednet_units.py::ahat_plan`` / ``a_plan``), with CUDA events, twice,
the second time in the reverse order; beside them the mma.sync body (the
kernel before the wgmma bodies) at its strip width::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.units_breakdown
    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.units_breakdown --plans

===============  ===========================================================
variant          what it changes
===============  ===========================================================
kernel           nothing
no epilogue      returns after the products (no A read, no E, prediction
                 or pooled A written)
no loads         as "no epilogue", and nothing is staged: the TMA copies
                 nothing (wgmma bodies), the halo reads no pixel (im2col)
===============  ===========================================================

The Ahat unit's pixel layer runs on the CUDA cores (``csrc/prednet_units.cu``,
not redesigned): its layers here are 1-3, the A unit's 0-2.  Only "kernel"
computes the right result; the others measure a part and their outputs are
garbage.  Every variant builds into a temporary directory with ``_build``'s
flags.  It needs a CUDA card and ``nvcc``; a substitution that no longer
applies to the source raises, so the variants follow the kernels or fail
loudly.  Prints one line a layer and returns {layer: {variant: ms}}.

``--plans`` times instead every plan of each unit's body at the main
path's (a chunk of 8 at 160x120) and the north star's layers, as CUDA graph
replays: every channel group with a tile of one row of 64 a warpgroup and
run-on tiles 8-62 wide, in clusters of 2 and 4 (wgmma), or every tile
width with grids of 2-8 blocks an SM (im2col); the plan's constants
(``prednet_units.UNIT_BLOCKS_PER_SM``, ``UNIT_CLUSTER``, the im2col grid)
were fitted to it.  Prints the plan's time and the fastest plans.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _build
from ..ops import prednet_units as pu
from ..ops.convlstm_fused import tile_width

__all__ = ["VARIANTS", "LAYERS", "variant_source", "plan_sweep", "main"]

_SOURCE = Path(_build.__file__).resolve().parent / "csrc" / "prednet_units_wgmma.cu"
_NO_EPILOGUE = [
    ("  if (at.b >= g.B) return;  // a cluster's padding block\n",
     "  if (at.b >= g.B || sb[N - 1] != 12345.0f) return;\n"),
    ("  if (at.b >= g.B) return;  // a cluster's padding block (the whole block: no shuffle is "
     "left)\n",
     "  if (at.b >= g.B || sb[N - 1] != 12345.0f) return;\n"),
    ("    pool_out<N>(hp, acc, sb, th, tw, tw_shift - 1, pos, at, g.H, g.W, g.cout, n0, out);\n",
     "    if (sb[N - 1] == 12345.0f)\n"
     "      pool_out<N>(hp, acc, sb, th, tw, tw_shift - 1, pos, at, g.H, g.W, g.cout, n0, out);\n"),
]
# name -> [(text, replacement), ...], each text found exactly once
VARIANTS = {
    "kernel": [],
    "no epilogue": _NO_EPILOGUE,
    "no loads": _NO_EPILOGUE + [
        ("    eigen::mbar_arrive_expect_tx(bar, T::W_BYTES + g.slab_bytes);\n"
         "    eigen::tma_load_4d(st + T::W_BYTES, map_x, bar, k0, at.x0 - 1, at.y0 - 1, at.b);\n"
         "    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += g.cluster)\n",
         "    eigen::mbar_arrive_expect_tx(bar, 0);\n"
         "    for (int tap = 9; tap < 9; tap += g.cluster)\n"),
        ("            inside ? *reinterpret_cast<const unsigned*>(xs + src) : 0u;\n",
         "            0u;\n"),
        ("        halo[dst] = inside ? xs[src] : (unsigned short)0;\n",
         "        halo[dst] = 0;\n"),
    ],
}
# (label, unit, B, H, W, cin, cout): the north star's layers of each unit on
# the new bodies
LAYERS = (
    ("Ahat 1", "ahat", 25, 240, 320, 48, 48),
    ("Ahat 2", "ahat", 25, 120, 160, 96, 96),
    ("Ahat 3", "ahat", 25, 60, 80, 192, 192),
    ("A 0", "a", 25, 480, 640, 6, 48),
    ("A 1", "a", 25, 240, 320, 96, 96),
    ("A 2", "a", 25, 120, 160, 192, 192),
)
_ENTRIES = ("eigen_ahat_error_unit_wgmma", "eigen_a_unit_wgmma", "eigen_a_unit_im2col")


def variant_source(name: str) -> str:
    """The kernels' source with variant ``name``'s substitutions."""
    text = _SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old.strip()[:60]!r} is not in the source once")
        text = text.replace(old, new)
    return text


def _build_all(tmp: Path) -> dict:
    """One shared library per variant, all nvcc processes at once."""
    (tmp / "common.cuh").write_text((_SOURCE.parent / "common.cuh").read_text())
    nvcc, procs = _build._find_nvcc(), {}
    for i, name in enumerate(VARIANTS):
        src = tmp / f"variant{i}.cu"
        src.write_text(variant_source(name))
        procs[name] = (tmp / f"variant{i}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(tmp / f"variant{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry in _ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


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


def main() -> dict:
    """Times every variant at every layer of ``LAYERS`` twice, in turns,
    the second time in the reverse order; returns {layer: {variant: ms of
    the second round, "mma_sync": ms}}."""
    if not torch.cuda.is_available():
        raise RuntimeError("units_breakdown needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = torch.bfloat16
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(Path(tmp))
        for label, unit, B, H, W, cin, cout in LAYERS:
            x = torch.rand(B, H, W, cin, device="cuda", generator=gen).bfloat16()
            k = pu.pack_unit_weight(torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
                                    .div_(3 * cin**0.5))
            b = torch.randn(cout, device="cuda", generator=gen).mul_(0.1).bfloat16()
            if unit == "ahat":
                a = torch.rand(B, H, W, cout, device="cuda", generator=gen).bfloat16()
                e = torch.empty(B, H, W, 2 * cout, dtype=bf16, device="cuda")
                p = pu.ahat_plan(B, H, W, cout)
                args = (x.data_ptr(), k.data_ptr(), cin, cout, b.data_ptr(), 1, a.data_ptr(),
                        e.data_ptr(), None, 0, 1, B, H, W, p.n, p.tile_h, p.tile_w, p.wg_stride,
                        p.cluster, stream)
                entry = "eigen_ahat_error_unit_wgmma"
                old = pu.UnitPlan("mma_sync", tile_w=tile_width(B, H, W))

                def run_old():
                    pu.launch_ahat(x, k, b, a, False, bf16, bf16, stream, old)
            else:
                o = torch.empty(B, H // 2, W // 2, cout, dtype=bf16, device="cuda")
                p = pu.a_plan(B, H, W, cin, cout)
                args = (x.data_ptr(), k.data_ptr(), cin, cout, b.data_ptr(), 1, o.data_ptr(),
                        B, H, W, p.n)
                if p.body == "wgmma":
                    args += (p.tile_h, p.tile_w, p.wg_stride, p.cluster, stream)
                    entry = "eigen_a_unit_wgmma"
                else:
                    args += (p.tile_w, p.blocks, stream)
                    entry = "eigen_a_unit_im2col"
                old = pu.UnitPlan("mma_sync", tile_w=pu.pool_tile_width(H, W))

                def run_old():
                    pu.launch_a(x, k, b, bf16, stream, old)

            def run(lib):
                if getattr(lib, entry)(*args) != 0:
                    raise RuntimeError(f"{label}: launch failed")

            names = list(libs)
            for order in (names, names[::-1]):
                second = {name: _ms(lambda: run(libs[name]), 10) for name in order}
            times = {name: second[name] for name in names}
            times["mma_sync"] = _ms(run_old, 10)
            print(f"  {label} ({B}, {H}, {W}) {cin} -> {cout}, {p.body} n {p.n} tile "
                  f"{p.tile_h}x{p.tile_w}: " + ", ".join(f"{k} {t:.4f} ms"
                                                         for k, t in times.items()), flush=True)
            out[label] = times
    return out


# (label, B, H, W, C, C_above) of plan_sweep: the main path's layers at its
# chunk of 8 and the north star's at its chunk of 25
SWEEP_LAYERS = tuple((f"main {l}", 8, *shape) for l, shape in enumerate(
    ((120, 160, 3, 48), (60, 80, 48, 96), (30, 40, 96, 192), (15, 20, 192, None)))) + tuple(
    (f"north {l}", 25, *shape) for l, shape in enumerate(
        ((480, 640, 3, 48), (240, 320, 48, 96), (120, 160, 96, 192), (60, 80, 192, None))))
SWEEP_WIDTHS = (64, 8, 10, 16, 20, 24, 30, 32, 40, 48, 54, 62)


def _graph_ms(fn, iters):
    """One call of ``fn`` captured as a CUDA graph, replayed ``iters``
    times between CUDA events (after three eager calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _ms(graph.replay, iters)


def plan_sweep() -> dict:
    """Times every plan of each unit's body at :data:`SWEEP_LAYERS`; returns
    {"<layer> <unit>": {plan: ms}}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    out = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def rand(*shape):
        return torch.rand(*shape, device="cuda", generator=gen)

    def weight(cin, cout):
        return pu.pack_unit_weight(torch.randn(3, 3, cin, cout, device="cuda", generator=gen)
                                   .div_(3 * cin**0.5))

    for label, B, H, W, C, C_above in SWEEP_LAYERS:
        r, a = rand(B, H, W, C).bfloat16(), rand(B, H, W, C).bfloat16()
        k, b = weight(C, C), rand(C).mul_(0.1).bfloat16()
        for unit in ("ahat", "a"):
            if unit == "a" and C_above is None:
                continue
            cin, cout = (C, C) if unit == "ahat" else (2 * C, C_above)
            own = pu.ahat_plan(B, H, W, C) if unit == "ahat" else pu.a_plan(B, H, W, cin, cout)
            if own.body == "wgmma":
                tiles = [t for t in pu.unit_tiles(W, unit == "a") if t[1] in SWEEP_WIDTHS]
                plans = [pu.UnitPlan("wgmma", n, *t, cluster=cl) for n, _ in pu._n_groups(cout)
                         for t in tiles for cl in (2, 4)] + [own]
            elif own.body == "im2col":
                plans = [pu.UnitPlan("im2col", own.n, 128 // tw, tw, 0, pu.SMS * per)
                         for tw in pu.IM2COL_TILES for per in (2, 4, 6, 8)] + [own]
            else:
                continue
            if unit == "ahat":
                def call(p):
                    return pu.launch_ahat(r, k, b, a, False, bf16, bf16, stream(), p)
            else:
                e, k2, b2 = rand(B, H, W, cin).bfloat16(), weight(cin, cout), rand(cout).bfloat16()

                def call(p):
                    return pu.launch_a(e, k2, b2, bf16, stream(), p)
            times = {p: _graph_ms(lambda p=p: call(p), 10 if B > 8 else 30) for p in plans}
            best = sorted(times.items(), key=lambda kv: kv[1])[:6]
            print(f"  {label} {unit} ({B}, {H}, {W}) {cin} -> {cout}: plan {tuple(own)} "
                  f"{times[own]:.4f} ms; fastest " + "; ".join(
                      f"{tuple(p)[1:]} {t:.4f}" for p, t in best), flush=True)
            out[f"{label} {unit}"] = times
    return out


if __name__ == "__main__":
    import sys

    if not torch.cuda.is_available():
        raise RuntimeError("units_breakdown needs a CUDA card")
    plan_sweep() if sys.argv[1:] == ["--plans"] else main()
