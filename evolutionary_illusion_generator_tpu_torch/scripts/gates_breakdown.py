"""The gate kernel's bodies on the card, beside their bytes and issue bounds.

Times ``fused_lstm_gates``' kernel (``csrc/lstm_gates.cu``) at the shapes
where it runs (:data:`SHAPES`: the main path's pixel layer in both
contracts, its s2d pixel layer and its ``True`` route's layers 1-3, the
``True`` route's four north-star layers and the north star's s2d pixel
layer), every body that takes the shape
(``ops/convlstm_gates.py::body_plans``, the plan's among them), as
CUDA graph replays between CUDA events, beside the eager gate math (the
yardstick: no single PyTorch call computes this function) and two bounds:

- bytes: each input read once and each output written once at 3.35 TB/s;
- issue: the instructions of the loop that holds the gate math, counted in
  the library's SASS (``cuobjdump -sass``) and divided by the elements a
  trip of that loop computes (its ``MUFU.EX2`` over the scalar body's,
  which computes one), times the elements, over 132 SMs x 4 schedulers x
  32 lanes x the SM clock that ``nvidia-smi --query-gpu=clocks.sm`` reports
  while the kernel runs::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.gates_breakdown \\
        [--shapes main,north1] [--iters 20] [--plans] [--against OLD.cu] [--out FILE]

``--against`` builds another source of the kernel with the old C entry (no
body argument: an earlier commit's ``csrc/lstm_gates.cu`` beside its
``common.cuh``), holds every body bit-equal to it at each shape and times
it.  ``--plans`` times, besides, the slab body's slab sizes, rings and
blocks an SM and the vector body's blocks an SM at each shape (what
``ops/convlstm_gates.py``'s constants were set from).  In a tree whose
wrapper has no plan (the kernel before its streaming bodies) it times the
one body there is.  Prints a line a shape and body and one JSON line; needs
a CUDA card, ``nvcc`` and ``cuobjdump``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

from .. import _build
from ..ops import convlstm_gates as cg
from ..utils.profiling import card_line

__all__ = ["SHAPES", "eager", "graph_ms", "inputs", "issue_counts", "measure", "old_library",
           "plan_candidates", "main"]

_BF16, _F32 = torch.bfloat16, torch.float32
#: label -> ((B, H, W, C), (gate, state, out) dtypes)
SHAPES = {
    "main": ((8, 120, 160, 3), (_BF16, _BF16, _BF16)),
    "main_f32": ((8, 120, 160, 3), (_F32, _BF16, _F32)),  # the JAX function's contract
    "s2d": ((8, 60, 80, 12), (_BF16, _BF16, _BF16)),
    # the True route's layers 1-3 at the main path's chunk of 8
    "main1": ((8, 60, 80, 48), (_BF16, _BF16, _BF16)),
    "main2": ((8, 30, 40, 96), (_BF16, _BF16, _BF16)),
    "main3": ((8, 15, 20, 192), (_BF16, _BF16, _BF16)),
    "north0": ((25, 480, 640, 3), (_BF16, _BF16, _BF16)),
    "north1": ((25, 240, 320, 48), (_BF16, _BF16, _BF16)),
    "north2": ((25, 120, 160, 96), (_BF16, _BF16, _BF16)),
    "north3": ((25, 60, 80, 192), (_BF16, _BF16, _BF16)),
    "north_s2d": ((25, 240, 320, 12), (_BF16, _BF16, _BF16)),
}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12
SMS, SCHEDULERS, LANES = 132, 4, 32
_TYPE_NAMES = {"float": _F32, "__nv_bfloat16": _BF16}
_KERNELS = {"lstm_gates_kernel": "scalar", "lstm_gates_vector_kernel": "vector",
            "lstm_gates_slab_kernel": "slab"}


def _ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph(fn):
    """``fn`` after three eager calls, captured once as a CUDA graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def graph_ms(fn, iters: int) -> float:
    """One call of ``fn`` replayed as a CUDA graph ``iters`` times between
    CUDA events: the device's time, without the host's launch cost."""
    graph = _graph(fn)
    return _ms(graph.replay, iters)


def sm_clock_mhz(fn, seconds: float = 0.5) -> float:
    """The SM clock ``nvidia-smi`` reports while ``fn``'s graph replays
    back to back for about ``seconds``."""
    graph = _graph(fn)
    reps = max(10, int(seconds * 1e3 / max(_ms(graph.replay, 5), 1e-3)))
    for _ in range(reps):
        graph.replay()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    torch.cuda.synchronize()
    return float(smi.stdout.split()[0])


def _demangle(names: List[str]) -> List[str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def _functions(sass: str) -> Dict[str, list]:
    """The SASS text of each function: name -> [(address, instruction)],
    labels resolved to the address of the instruction after them."""
    funcs, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, labels, pending = m.group(1), {}, []
            funcs[name] = ([], labels)
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            funcs[name][0].append((addr, m.group(2)))
    return funcs


def _loops(instrs, labels):
    """(start, end) addresses of each backward branch's loop."""
    out = []
    for addr, text in instrs:
        m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b)", text)
        if m:
            target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            if target is not None and target <= addr:
                out.append((target, addr))
    return out


def issue_counts(lib_path: str) -> Dict[tuple, dict]:
    """{(body, gate, state, out dtypes): {"instructions", "ex2",
    "elements", "per_element"}} of each gate-kernel instantiation in the
    library: the loop holding the gate math with the fewest instructions
    an element (its ``MUFU.EX2`` count over the scalar body's, of the same
    types, is the elements a trip; NOPs are not counted)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs = {k: v for k, v in _functions(sass).items() if "lstm_gates" in k}
    loops = {}
    for name, plain in zip(funcs, _demangle(list(funcs))):
        m = re.search(r"(lstm_gates_\w*kernel)<([^>]*)>", plain)
        if not m or m.group(1) not in _KERNELS:
            continue
        types = tuple(_TYPE_NAMES[t.strip()] for t in m.group(2).split(","))
        instrs, labels = funcs[name]
        best = None
        for start, end in _loops(instrs, labels):
            body = [t for a, t in instrs if start <= a <= end and not t.startswith("NOP")]
            ex2 = sum("MUFU.EX2" in t for t in body)
            if ex2 and (best is None or len(body) / ex2 < best[0] / best[1]):
                best = (len(body), ex2)
        if best:
            loops[(_KERNELS[m.group(1)], *types)] = best
    out = {}
    for (body, *types), (n, ex2) in loops.items():
        one = loops.get(("scalar", *types))
        if one is None:
            continue
        elements = ex2 / one[1]
        out[(body, *types)] = dict(instructions=n, ex2=ex2, elements=elements,
                                   per_element=n / elements)
    return out


def _library_path() -> str:
    _build.library()
    return str(_build._lib_dir / _build._LIB_NAME)


def eager(gates, c_prev, out_dtype):
    """The yardstick: the gate math as eager torch ops, cast to
    ``out_dtype``."""
    i, f, o, g = gates.split(c_prev.shape[-1], dim=-1)
    c = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
    return (torch.sigmoid(o) * torch.tanh(c)).to(out_dtype), c.to(out_dtype)


def old_library(source: str) -> ctypes.CDLL:
    """``source`` (a ``lstm_gates.cu`` with the C entry before the body
    argument, beside its ``common.cuh``) built with ``_build``'s flags."""
    src = Path(source).resolve()
    out = Path(tempfile.mkdtemp()) / "libold_gates.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.eigen_lstm_gates.argtypes = (P, I, P, I, P, P, I, LL, I, P)
    lib.eigen_lstm_gates.restype = ctypes.c_int
    return lib


def _call_old(lib, gates, c_prev, od):
    h = torch.empty(c_prev.shape, dtype=od, device=c_prev.device)
    c = torch.empty_like(h)
    bf16 = torch.bfloat16
    rc = lib.eigen_lstm_gates(gates.data_ptr(), int(gates.dtype == bf16), c_prev.data_ptr(),
                              int(c_prev.dtype == bf16), h.data_ptr(), c.data_ptr(),
                              int(od == bf16), c_prev.numel() // c_prev.shape[-1],
                              c_prev.shape[-1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the old gate kernel's launch failed: CUDA error {rc}")
    return h, c


def _has_plans() -> bool:
    return hasattr(cg, "gates_plan")


def _call(gates, c_prev, od, plan):
    stream = torch.cuda.current_stream().cuda_stream
    if plan is None:  # a tree before the plan: its one body
        return cg._launch(gates, c_prev, stream, od)
    return cg._launch(gates, c_prev, stream, od, plan)


def inputs(shape, types, gen):
    """Seeded gates (pre-activations of spread 2) and state on the card."""
    B, H, W, C = shape
    gd, sd, _ = types
    gates = torch.randn(B, H, W, 4 * C, device="cuda", generator=gen).mul_(2).to(gd)
    c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).to(sd)
    return gates, c_prev


def plan_candidates(shape, types):
    """The plans ``--plans`` times at a shape: the vector body (where C is
    a multiple of its width) at 1-8 blocks an SM, the slab body at slabs of
    192, 384 and 768 elements a warp, rings of 2 and 3 and 1-8 blocks an
    SM."""
    B, H, W, C = shape
    npix = B * H * W
    out = []
    if C % cg.vector_width(*types) == 0:
        blocks = -(-npix * C // cg.vector_width(*types) // cg.STREAM_THREADS)
        out += [cg.GatesPlan("vector", grid=min(blocks, cg.SMS * k)) for k in (1, 2, 3, 4, 6, 8)]
    for elems in (192, 384, 768):
        P = -(-(-(-elems // C)) // 16) * 16
        for ring in (2, 3):
            smem = cg.slab_smem(P, C, *types, ring)
            for k in (1, 2, 3, 4, 6, 8):
                if smem <= cg.SMEM_PER_BLOCK and k * (smem + cg.SMEM_RESERVED) <= cg.SMEM_PER_SM:
                    blocks = -(-npix // P // cg.SLAB_WARPS)
                    out.append(cg.GatesPlan("slab", P, ring, min(blocks, cg.SMS * k)))
    return sorted(set(out))


def measure(labels=None, iters: int = 20, plans: bool = False, gen=None,
            against: str = None) -> Dict[str, dict]:
    """Times and bounds of every body that takes the shape at each shape of
    ``labels`` (default every one of :data:`SHAPES`): {label: {"shape",
    "types", "bytes", "bytes_bound_ms", "issue_bound_ms" {body: ms}, "ms"
    {body: ms}, "plan", "eager_ms", "sm_mhz"[, "plans" {plan: ms}]}}.  The
    streaming bodies' h and c are held bit-equal to the scalar body's on
    the way, and with ``against`` (see
    :func:`old_library`) every body's to that build's (timed as
    ``ms["against"]``)."""
    gen = gen or torch.Generator(device="cuda").manual_seed(0)
    counts = issue_counts(_library_path())
    old = old_library(against) if against else None
    out = {}
    for label in labels or SHAPES:
        shape, types = SHAPES[label]
        B, H, W, C = shape
        npix, od = B * H * W, types[2]
        gates, c_prev = inputs(shape, types, gen)
        bodies, plan = {"scalar": None}, ("scalar",)
        if _has_plans():  # every body that takes the shape
            bodies = cg.body_plans(npix, C, *types, True)
            plan = cg.gates_plan(npix, C, *types, True)
        ref = _call(gates, c_prev, od, bodies["scalar"])
        if old is not None:
            want = _call_old(old, gates, c_prev, od)
            if not (torch.equal(want[0], ref[0]) and torch.equal(want[1], ref[1])):
                raise AssertionError(f"gates_breakdown {label}: the scalar body is not "
                                     f"bit-equal to {against}")
        for body, p in bodies.items():
            got = _call(gates, c_prev, od, p)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"gates_breakdown {label}: the {body} body is not "
                                     f"bit-equal to the scalar body")
        nbytes = sum(t.numel() * t.element_size() for t in (gates, c_prev, *ref))
        ms = {body: graph_ms(lambda p=p: _call(gates, c_prev, od, p), iters)
              for body, p in bodies.items()}
        if old is not None:
            ms["against"] = graph_ms(lambda: _call_old(old, gates, c_prev, od), iters)
        mhz = sm_clock_mhz(lambda: _call(gates, c_prev, od, bodies["scalar"]))
        elements = npix * C
        per_element = {body: counts[(body, *types)]["per_element"] for body in bodies
                       if (body, *types) in counts}
        issue = {body: n * elements / (SMS * SCHEDULERS * LANES * mhz * 1e6) * 1e3
                 for body, n in per_element.items()}
        row = dict(shape=list(shape), types=[str(t).split(".")[-1] for t in types],
                   bytes=nbytes, bytes_bound_ms=max(nbytes / PEAK_BYTES_PER_S,
                                                    10.0 * elements / PEAK_F32_FLOPS) * 1e3,
                   issue_bound_ms=issue,
                   per_element=per_element,
                   ms=ms, plan=list(plan),
                   eager_ms=graph_ms(lambda: eager(gates, c_prev, od), max(5, iters // 2)),
                   sm_mhz=mhz)
        if plans and _has_plans():
            row["plans"] = {str(tuple(p)): graph_ms(lambda p=p: _call(gates, c_prev, od, p),
                                                    iters)
                            for p in plan_candidates(shape, types)}
        out[label] = row
        print(f"[gates] {label} {shape} {row['types']}: " + ", ".join(
            f"{b} {t:.5f} ms" for b, t in ms.items()) + f"; eager {row['eager_ms']:.5f}; bytes "
            f"bound {row['bytes_bound_ms']:.5f} ({nbytes / 1e6:.2f} MB); issue bound "
            + ", ".join(f"{b} {t:.5f} ({row['per_element'][b]:.1f} an element)"
                        for b, t in issue.items()) + f"; SM {mhz:.0f} MHz", flush=True)
        if plans and _has_plans():
            best = sorted(row["plans"].items(), key=lambda kv: kv[1])[:5]
            print(f"[gates] {label} plans, fastest: {best}", flush=True)
        del gates, c_prev, ref
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--plans", action="store_true")
    p.add_argument("--against", default=None,
                   help="an earlier lstm_gates.cu (old C entry) to hold every body bit-equal to")
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gates_breakdown needs a CUDA card")
    card = card_line(torch.device("cuda"))
    print(f"[gates] {card}", flush=True)
    rows = measure(args.shapes.split(","), args.iters, args.plans, against=args.against)
    line = {"script": "gates_breakdown", "card": card, "shapes": rows}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f)
    return line


if __name__ == "__main__":
    main()
