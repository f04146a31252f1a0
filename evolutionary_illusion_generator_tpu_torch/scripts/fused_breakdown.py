"""Where the time of the fused kernel's wgmma body goes on the card.

Builds variants of ``csrc/convlstm_fused.cu``, each the kernel with one
part taken out by a text substitution, and times the wgmma body of each at
the fused layers of the main path (a chunk of 8 at 160x120) and of the north
star (a chunk of 25 at 640x480), on its own plan (``ops/convlstm_fused.py::
plan``), with CUDA events, twice, the second time in the reverse order;
beside them the mma_sync body at its strip width::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.fused_breakdown

===============  ===========================================================
variant          what it changes
===============  ===========================================================
kernel           nothing
no epilogue      returns after the main loop (no gate math, no stores)
no loads         as "no epilogue", and the TMA copies nothing
===============  ===========================================================

Only "kernel" computes the right result; the others measure a part and
their outputs are garbage.  Every variant builds into a temporary directory
with ``_build``'s flags.  It needs a CUDA card and ``nvcc``; a substitution
that no longer applies to the source raises, so the variants follow the
kernel or fail loudly.  Prints one line a layer and returns
{layer: {variant: ms}}.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _build
from ..ops import convlstm_fused as cf

__all__ = ["VARIANTS", "LAYERS", "variant_source", "main"]

_SOURCE = Path(_build.__file__).resolve().parent / "csrc" / "convlstm_fused.cu"
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
        entry = lib.eigen_convlstm_fused_wgmma
        entry.argtypes = _build._SIGNATURES["eigen_convlstm_fused_wgmma"]
        entry.restype = ctypes.c_int
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
        raise RuntimeError("fused_breakdown needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
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
