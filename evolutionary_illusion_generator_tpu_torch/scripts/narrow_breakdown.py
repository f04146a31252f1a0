"""Where the time of the narrow ConvLSTM layer's kernel goes on the card.

Builds variants of the narrow layer's two bodies, each the kernel with one
part taken out by a text substitution, and times each at the narrow shapes
``chip_smoke.py`` checks (the main path's pixel layer, the grayscale
stack's pixel layer and layer 1, a narrow top layer) and at the north
star's pixel layer (25 x 480x640, C 3, R_above 48), each launch replayed
as a CUDA graph between CUDA events (torch.profiler drops some events),
twice, the second time in the reverse order::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.narrow_breakdown
    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.narrow_breakdown --plans

The ``mma_sync`` body (``csrc/convlstm_narrow.cu`` over ``common.cuh``'s
``eigen::igemm::conv3x3``):

===============  ===========================================================
variant          what it changes
===============  ===========================================================
kernel           nothing
weights once     each block stages the weights of its first two chunks
                 only (the ring's two slots), not every chunk's
no epilogue      returns after the products (no gate math, no c_prev read,
                 no h or c written)
no loads         as "no epilogue", and nothing is staged: every cp.async
                 and element copy writes zeros without reading
===============  ===========================================================

The ``persistent`` body (``csrc/convlstm_narrow_hopper.cu``):

===============  ===========================================================
variant          what it changes
===============  ===========================================================
kernel           nothing
no epilogue      no gate math, no c_prev read, no h or c written
no loads         as "no epilogue", and the producer asks the TMA for no
                 tile (the weights stay)
no products      the tiles are staged and written, no mma is issued
===============  ===========================================================

Only "kernel" computes the right result; the others measure a part and
their outputs are garbage.  Every variant builds into a temporary
directory with ``_build``'s flags.  It needs a CUDA card and ``nvcc``; a
substitution that no longer applies to the source raises, so the variants
follow the kernels or fail loudly.  Prints one line a shape and returns
{shape: {"<body> <variant>": ms}}.

``--plans`` times instead every strip width of the ``mma_sync`` body
(``convlstm_fused.tile_candidates`` and odd ones) and every tile width and
count of blocks an SM of the ``persistent`` body at the same shapes, and
prints each body's own plan beside the fastest.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _build
from ..ops import convlstm_narrow as cn
from ..ops.convlstm_fused import pack_gate_weight, tile_candidates

__all__ = ["VARIANTS", "SHAPES", "variant_sources", "plan_sweep", "main"]

_CSRC = Path(_build.__file__).resolve().parent / "csrc"
#: body -> (its source file, its entry)
BODIES = {
    "mma_sync": ("convlstm_narrow.cu", "eigen_convlstm_narrow"),
    "persistent": ("convlstm_narrow_hopper.cu", "eigen_convlstm_narrow_persistent"),
}
_MMA_NO_EPILOGUE = [
    ("convlstm_narrow.cu",
     "  __syncthreads();  // the epilogue reuses the stages\n",
     "  if (gates[0][0][0] != 12345.0f) return;\n"
     "  __syncthreads();  // the epilogue reuses the stages\n"),
]
_PERSISTENT_NO_EPILOGUE = [
    ("convlstm_narrow_hopper.cu",
     "    epilogue(slot, tile, gates);\n",
     "    if (bias_reg[0][0] == 12345.0f) epilogue(slot, tile, gates);\n"),
]
# body -> variant -> [(file, text, replacement), ...], each text found in its
# file exactly once
VARIANTS = {
    "mma_sync": {
        "kernel": [],
        "weights once": [
            ("common.cuh",
             "    for (int i = tid; i < 9 * NOUT * 2; i += NT) {\n",
             "    for (int i = tid; i < (si == 0 && kc < STAGES ? 9 * NOUT * 2 : 0); i += NT) {\n"),
        ],
        "no epilogue": _MMA_NO_EPILOGUE,
        "no loads": _MMA_NO_EPILOGUE + [
            ("common.cuh",
             "        cp_async16(dst, valid ? g : sr.w, valid);\n",
             "        cp_async16(dst, sr.w, false);\n"),
            ("common.cuh",
             "        for (int e = 0; e < 8; ++e) dst[e] = (c < t.C && k + e < sr.cin) ? g[e] : "
             "zero;\n",
             "        for (int e = 0; e < 8; ++e) dst[e] = zero;\n"),
            ("common.cuh",
             "        cp_async16(dst, valid ? g : sr.x, valid);\n",
             "        cp_async16(dst, sr.x, false);\n"),
            ("common.cuh",
             "        for (int e = 0; e < 8; ++e) dst[e] = (inside && k + e < sr.cin) ? g[e] : "
             "zero;\n",
             "        for (int e = 0; e < 8; ++e) dst[e] = zero;\n"),
        ],
    },
    "persistent": {
        "kernel": [],
        "no epilogue": _PERSISTENT_NO_EPILOGUE,
        "no loads": _PERSISTENT_NO_EPILOGUE + [
            ("convlstm_narrow_hopper.cu",
             "        eigen::mbar_arrive_expect_tx(bar, (unsigned)g.stage_tx);\n",
             "        eigen::mbar_arrive_expect_tx(bar, 0u);\n"
             "        if (bar) continue;\n"),
        ],
        "no products": [
            ("convlstm_narrow_hopper.cu",
             "      eigen::mma16816(acc[mt][2 * j], a[mt], b);\n"
             "      eigen::mma16816(acc[mt][2 * j + 1], a[mt], b + 2);\n",
             "      acc[mt][2 * j][0] += __uint_as_float(a[mt][0] ^ b[0]);\n"
             "      acc[mt][2 * j + 1][0] += __uint_as_float(a[mt][1] ^ b[2]);\n"),
        ],
    },
}
#: (label, B, H, W, C, C_above): chip_smoke.py's NARROW_SHAPES and the north
#: star's pixel layer
SHAPES = (
    ("main", 8, 120, 160, 3, 48),
    ("gray_pixel", 8, 120, 160, 1, 16),
    ("gray_layer1", 8, 60, 80, 16, 32),
    ("top", 8, 30, 40, 3, None),
    ("north_star", 25, 480, 640, 3, 48),
)


def variant_sources(body: str, name: str) -> dict:
    """{file name: text} of ``body``'s source and ``common.cuh`` with
    variant ``name``'s substitutions."""
    files = {f: (_CSRC / f).read_text() for f in (BODIES[body][0], "common.cuh")}
    for f, old, new in VARIANTS[body][name]:
        if files[f].count(old) != 1:
            raise ValueError(f"variant {body} {name!r}: {old.strip()[:60]!r} is not in {f} once")
        files[f] = files[f].replace(old, new)
    return files


def _build_all(tmp: Path) -> dict:
    """One shared library per (body, variant), all nvcc processes at once."""
    nvcc, procs = _build._find_nvcc(), {}
    for body, variants in VARIANTS.items():
        for i, name in enumerate(variants):
            d = tmp / f"{body}{i}"
            d.mkdir()
            for f, text in variant_sources(body, name).items():
                (d / f).write_text(text)
            so = d / "variant.so"
            procs[body, name] = (so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(d / BODIES[body][0])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (body, name), (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {body} {name!r}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), BODIES[body][1])
        fn.argtypes = _build._SIGNATURES[BODIES[body][1]]
        fn.restype = ctypes.c_int
        libs[body, name] = fn
    return libs


def _ms(fn, iters):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters):
    """One call of ``fn`` captured as a CUDA graph, replayed ``iters``
    times between CUDA events (after two eager calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _ms(graph.replay, iters)


def _inputs(gen, B, H, W, C, C_above):
    """Sources in [-1, 1], packed weights over the square root of the
    fan-in, bias and c_prev, all on the card in the main path's types."""
    cins = [2 * C, C] + ([C_above] if C_above else [])
    shapes = [(B, H, W, 2 * C), (B, H, W, C)] + ([(B, H // 2, W // 2, C_above)] if C_above
                                                 else [])
    srcs = [torch.rand(s, device="cuda", generator=gen).mul_(2).sub_(1).bfloat16()
            for s in shapes]
    wks = [pack_gate_weight(torch.randn(3, 3, ci, 4 * C, device="cuda", generator=gen)
                            .div_((9 * sum(cins)) ** 0.5)) for ci in cins]
    b = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.3).bfloat16()
    c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()
    return srcs, wks, b, c_prev


def _args(srcs, wks, b, c_prev, h, c, plan):
    """The C entry's arguments for ``plan``'s body but the stream (as
    ``convlstm_narrow.launch``): the caller appends the current stream at
    each call, which a graph capture changes."""
    B, H, W, C = c_prev.shape
    args = []
    for s in range(3):
        args += ([srcs[s].data_ptr(), wks[s].data_ptr(), srcs[s].shape[3]] if s < len(srcs)
                 else [None, None, 0])
    args += [len(srcs), b.data_ptr(), 1, 1, c_prev.data_ptr(), 1, h.data_ptr(), c.data_ptr(),
             B, H, W, C]
    if plan.body == "mma_sync":
        return args + [plan.tile_w]
    return args + [plan.tile_w, plan.blocks]


def main() -> dict:
    """Times every variant of both bodies at every shape of :data:`SHAPES`
    twice, in turns, the second time in the reverse order; returns
    {shape: {"<body> <variant>": ms of the second round}}."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(Path(tmp))
        for label, B, H, W, C, C_above in SHAPES:
            srcs, wks, b, c_prev = _inputs(gen, B, H, W, C, C_above)
            h, c = torch.empty_like(c_prev), torch.empty_like(c_prev)
            plans = {"mma_sync": cn.NarrowPlan("mma_sync", tile_w=cn.tile_width(B, H, W))}
            if cn.narrow_body(C, C_above, torch.bfloat16) == "persistent":
                plans["persistent"] = cn.persistent_plan(B, H, W, C, C_above)
            calls = {}
            for (body, name), fn in libs.items():
                if body not in plans:
                    continue
                args = _args(srcs, wks, b, c_prev, h, c, plans[body])

                def call(fn=fn, args=args, key=f"{body} {name}"):
                    if fn(*args, torch.cuda.current_stream().cuda_stream) != 0:
                        raise RuntimeError(f"{label} {key}: launch failed")
                calls[f"{body} {name}"] = call
            iters = 10 if B > 8 else 50
            names = list(calls)
            for order in (names, names[::-1]):
                second = {name: _graph_ms(calls[name], iters) for name in order}
            times = {name: second[name] for name in names}
            print(f"  {label} ({B}, {H}, {W}) C {C} R_above {C_above}, plans "
                  f"{[tuple(p) for p in plans.values()]}: "
                  + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items()), flush=True)
            out[label] = times
    return out


#: the persistent body's blocks an SM tried by plan_sweep
SWEEP_BLOCKS_PER_SM = (1, 2, 3, 4, 6, 8)


def plan_sweep() -> dict:
    """Times every plan of both bodies at :data:`SHAPES` (CUDA graph
    replays); returns {shape: {plan: ms}}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, B, H, W, C, C_above in SHAPES:
        srcs, wks, b, c_prev = _inputs(gen, B, H, W, C, C_above)
        plans = [cn.NarrowPlan("mma_sync", tile_w=tw)
                 for tw in sorted(set(tile_candidates(W)) | {5, 7, 10, 20})]
        own = [cn.narrow_plan(B, H, W, C, C_above, torch.bfloat16)]
        if own[0].body == "persistent":
            for tw in cn.PERSISTENT_TILES:
                for per in SWEEP_BLOCKS_PER_SM:
                    p = cn.persistent_plan(B, H, W, C, C_above, tile_w=tw, blocks_per_sm=per)
                    if p.smem * per <= cn.SMEM_PER_SM:
                        plans.append(p)
            own.append(cn.NarrowPlan("mma_sync", tile_w=cn.tile_width(B, H, W)))
        iters = 10 if B > 8 else 30
        times = {p: _graph_ms(lambda p=p: cn.launch(
                     srcs, wks, b, c_prev, torch.bfloat16, torch.cuda.current_stream().cuda_stream,
                     plan=p), iters)
                 for p in dict.fromkeys(plans + own)}
        best = sorted(times.items(), key=lambda kv: kv[1])[:6]
        print(f"  {label} ({B}, {H}, {W}) C {C} R_above {C_above}: own plans "
              + "; ".join(f"{tuple(p)} {times[p]:.4f} ms" for p in own) + "; fastest "
              + "; ".join(f"{tuple(p)} {t:.4f}" for p, t in best), flush=True)
        out[label] = times
    return out


if __name__ == "__main__":
    import sys

    if not torch.cuda.is_available():
        raise RuntimeError("narrow_breakdown needs a CUDA card")
    plan_sweep() if sys.argv[1:] == ["--plans"] else main()
