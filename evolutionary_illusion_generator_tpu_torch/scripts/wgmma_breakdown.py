"""Where the time of the ladder's six conv rungs goes on the card.

Builds variants of ``csrc/bisect_wgmma.cu``, each the kernel with one part
taken out or changed by a text substitution, and times rungs C, D, H, E, I
and J of each at the ladder's ``--big`` shape (the row-block rungs H, E, I
and J at ``rows`` 48, the card runs' row blocks) with CUDA events, twice,
the second time in the reverse order::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.wgmma_breakdown

=================  ==========================================================
variant            what it changes
=================  ==========================================================
kernel             nothing
cluster 1          every block loads all 9 taps' weights (no sharing)
no epilogue        returns after the totals reach shared memory
no loads           as "no epilogue", and the TMA copies nothing
fast gate math     the fused rungs' gates with ``__expf`` and ``__frcp_rn``
=================  ==========================================================

Only "kernel", "cluster 1" and "fast gate math" compute the right result;
the others measure a part and their outputs are garbage.  Every variant
builds into a temporary directory with ``_build``'s flags.  It needs a
CUDA card and ``nvcc``; a substitution that no longer applies to the
source raises, so the variants follow the kernel or fail loudly.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _build
from ..ops import convlstm_bisect as cb
from ..ops.convlstm_fused import pack_gate_weight
from .kernel_bisect import BIG_SHAPE

__all__ = ["VARIANTS", "variant_source", "main"]

ROWS = 48  # the row blocks of H, E, I and J, as the ladder's card runs take them
RUNGS = "CDHEIJ"

_SOURCE = Path(_build.__file__).resolve().parent / "csrc" / "bisect_wgmma.cu"
_NO_EPILOGUE = (
    "  if (b >= g.B) return;  // a cluster's padding block\n",
    "  if (b >= g.B || ep[tid] != 12345.0f) return;\n",
)
# name -> [(text, replacement), ...], each text found exactly once
VARIANTS = {
    "kernel": [],
    "cluster 1": [("constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;")],
    "no epilogue": [_NO_EPILOGUE],
    "no loads": [
        _NO_EPILOGUE,
        ("    eigen::mbar_arrive_expect_tx(bar, T::STAGE);\n"
         "    eigen::tma_load_4d(st + T::W_BYTES, &map_x, bar, k0, x0, win * g.step + yw, b);\n"
         "    for (int tap = (int)eigen::cluster_rank(); tap < 9; tap += CLUSTER)\n",
         "    eigen::mbar_arrive_expect_tx(bar, 0);\n"
         "    for (int tap = 9; tap < 9; tap += CLUSTER)\n"),
    ],
    "fast gate math": [
        ("      const float cn = eigen::sigmoid(gf) * cp + eigen::sigmoid(gi) * tanhf(gg);\n",
         "      auto sig = [](float v) { return __frcp_rn(1.0f + __expf(-v)); };\n"
         "      auto th = [&](float v) { return 2.0f * sig(2.0f * v) - 1.0f; };\n"
         "      const float cn = sig(gf) * cp + sig(gi) * th(gg);\n"),
        ("eigen::from_float<ST>(eigen::sigmoid(go) * tanhf(cn))",
         "eigen::from_float<ST>(sig(go) * th(cn))"),
    ],
}


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s substitutions."""
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
        for entry in (f"eigen_bisect_{key.lower()}" for key in RUNGS):
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _ms(fn, iters=10):
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
    """Times C, D, H, E, I and J of every variant twice, in turns, the
    second time in the reverse order, so that no rung's time hinges on the
    rung timed before it; returns
    {variant: (C ms, D ms, H ms, E ms, I ms, J ms)} of the second round."""
    if not torch.cuda.is_available():
        raise RuntimeError("wgmma_breakdown needs a CUDA card")
    B, H, W, Cin, C = BIG_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, H, W, Cin, device="cuda", generator=gen).bfloat16()
    w = torch.randn(3, 3, Cin, 4 * C, device="cuda", generator=gen).mul_(0.05).bfloat16()
    bias = torch.randn(4 * C, device="cuda", generator=gen).mul_(0.1)
    c_prev = torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()
    xp, wk = cb.pad_input(x), pack_gate_weight(w)
    xh, xi, xj = (cb.prepare(key, x, ROWS) for key in "HIJ")
    wp = xi.shape[-2]
    gates = torch.empty(B, H, W, 4 * C, device="cuda")
    h, c = torch.empty_like(c_prev), torch.empty(c_prev.shape, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    flops = 2.0 * B * H * W * 9 * Cin * 4 * C
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], f"--big {B}x{H}x{W} Cin {Cin} C {C} rows {ROWS}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(Path(tmp))

        def rung_c(lib):
            return lib.eigen_bisect_c(xp.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                                      gates.data_ptr(), B, H, W, Cin, C, stream)

        def rung_d(lib):
            return lib.eigen_bisect_d(xp.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                                      c_prev.data_ptr(), 1, h.data_ptr(), c.data_ptr(),
                                      B, H, W, Cin, C, stream)

        def rung_h(lib):
            return lib.eigen_bisect_h(xh.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                                      c_prev.data_ptr(), 1, h.data_ptr(), c.data_ptr(),
                                      B, H, W, Cin, C, ROWS, stream)

        def rung_e(lib):
            return lib.eigen_bisect_e(xp.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                                      c_prev.data_ptr(), 1, h.data_ptr(), c.data_ptr(),
                                      B, H, W, Cin, C, ROWS, stream)

        def rung_i(lib):
            return lib.eigen_bisect_i(xi.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                                      c_prev.data_ptr(), 1, h.data_ptr(), c.data_ptr(),
                                      B, H, W, Cin, C, ROWS, wp, stream)

        def rung_j(lib):
            return lib.eigen_bisect_j(xj.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                                      c_prev.data_ptr(), 1, h.data_ptr(), c.data_ptr(),
                                      B, H, W, Cin, C, ROWS, wp, stream)

        rungs = (rung_c, rung_d, rung_h, rung_e, rung_i, rung_j)
        times = {}
        for order in (rungs, rungs[::-1]):
            for name, lib in libs.items():
                for rung in rungs:
                    if rung(lib) != 0:
                        raise RuntimeError(f"variant {name!r}: launch failed")
                ms = {rung: _ms(lambda: rung(lib)) for rung in order}
                times[name] = tuple(ms[rung] for rung in rungs)
                print(f"  {name:15s} " + "  ".join(
                    f"{key} {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)"
                    for key, t in zip(RUNGS, times[name])), flush=True)
    return times


if __name__ == "__main__":
    main()
