"""What sets the time of ladder rung A's streaming kernel on the card.

Builds variants of rung A's part of ``csrc/convlstm_bisect.cu``, each the
kernel with one choice changed by a text substitution, checks each exactly
against ``float32(c_prev) * 2`` and times it at the ladder's ``--big``
``c_prev`` (bfloat16 (25, 240, 320, 48), 553 MB moved) and at its float32
copy with CUDA events, in turns with one ``torch.mul`` into a float32
output, twice::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.rung_a_breakdown

=======================  ====================================================
variant                  what it changes
=======================  ====================================================
kernel                   nothing
strided stores           bfloat16: each lane stores its own vector's 32 bytes
resident grid            as many blocks as the card holds at once (SMs x
                         occupancy), walking the tiles in turn
cached loads             plain loads instead of ``__ldcs``
cached stores            plain stores instead of ``__stcs``
cached loads and stores  both
unroll 1 / 2 / 8         loads in flight per thread before the first store
=======================  ====================================================

Every variant builds into a temporary directory with ``_build``'s flags.
It needs a CUDA card and ``nvcc``; a substitution that no longer applies to
the source raises, so the variants follow the kernel or fail loudly.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _build
from .kernel_bisect import BIG_SHAPE

__all__ = ["VARIANTS", "variant_source", "main"]

_CSRC = Path(_build.__file__).resolve().parent / "csrc"
_CACHED_LOADS = ("v[u] = k < nvec ? __ldcs(src + k)", "v[u] = k < nvec ? src[k]")
_CACHED_STORES = ("{ __stcs(p, v); }", "{ *p = v; }")
# name -> [(text, replacement), ...], each text found exactly once
VARIANTS = {
    "kernel": [],
    "strided stores": [("const int s = 16 * r + lane / 2;", "const int s = lane;"),
                       ("const unsigned a = lane & 1 ? z : x, b = lane & 1 ? w : y;",
                        "const unsigned a = r ? z : x, b = r ? w : y;"),
                       ("const int j = 32 * r + lane;", "const int j = 2 * lane + r;")],
    "resident grid": [("  if (blocks > kMaxBlocks) blocks = kMaxBlocks;\n",
                       "  int dev = 0, sms = 0, per_sm = 0;\n"
                       "  cudaGetDevice(&dev);\n"
                       "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
                       "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kAThreads, 0);\n"
                       "  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;\n")],
    "cached loads": [_CACHED_LOADS],
    "cached stores": [_CACHED_STORES],
    "cached loads and stores": [_CACHED_LOADS, _CACHED_STORES],
    "unroll 1": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;")],
    "unroll 2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "unroll 8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
}


def variant_source(name: str) -> str:
    """Rung A's kernel and C entry, with variant ``name``'s substitutions,
    as a source of its own."""
    text = (_CSRC / "convlstm_bisect.cu").read_text()
    text = text[text.index("// Rung A, one pass"):]
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name!r}: {old.strip()[:60]!r} is not in the source once")
        text = text.replace(old, new)
    return '#include <cstdint>\n\n#include "common.cuh"\n\nnamespace {\n\n' + text


def _build_all(tmp: Path) -> dict:
    """One shared library per variant, all nvcc processes at once."""
    (tmp / "common.cuh").write_text((_CSRC / "common.cuh").read_text())
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
        lib.eigen_bisect_a.argtypes = _build._SIGNATURES["eigen_bisect_a"]
        lib.eigen_bisect_a.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _ms(fn, iters=20):
    for _ in range(3):
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
    """Times every variant and ``torch.mul`` twice, in turns, on the
    bfloat16 ``c_prev`` and on its float32 copy (the ladder's timed loop
    feeds A's float32 output back in); returns {name: (bfloat16 ms,
    float32 ms)} of the second round."""
    if not torch.cuda.is_available():
        raise RuntimeError("rung_a_breakdown needs a CUDA card")
    B, H, W, _, C = BIG_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()]
    inputs.append(inputs[0].float())
    out = torch.empty(inputs[0].shape, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    moved = [t.numel() * (t.element_size() + 4) for t in inputs]
    print(smi.stdout.strip().splitlines()[0], f"rung A at {tuple(out.shape)}: bfloat16 "
          f"{moved[0] / 1e6:.1f} MB (bound {moved[0] / 3.35e9:.4f} ms), float32 "
          f"{moved[1] / 1e6:.1f} MB (bound {moved[1] / 3.35e9:.4f} ms)", flush=True)

    def launcher(lib, c):
        return lambda: lib.eigen_bisect_a(c.data_ptr(), int(c.dtype == torch.bfloat16),
                                          out.data_ptr(), c.numel(), stream)

    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_all(Path(tmp))
        calls = {name: [launcher(lib, c) for c in inputs] for name, lib in libs.items()}
        for name, pair in calls.items():
            for c, call in zip(inputs, pair):
                out.fill_(float("nan"))
                if call() != 0 or not torch.equal(out, c.float() * 2):
                    raise RuntimeError(f"variant {name!r}: launch failed or result not exact")
        calls["torch.mul"] = [lambda c=c: torch.mul(c, 2.0, out=out) for c in inputs]
        times = {}
        for _ in range(2):
            for name, pair in calls.items():
                times[name] = tuple(_ms(call) for call in pair)
                print(f"  {name:24s} " + "  ".join(
                    f"{dt} {t:.4f} ms ({m / t / 1e6:.0f} GB/s)"
                    for dt, t, m in zip(("bfloat16", "float32"), times[name], moved)), flush=True)
    return times


if __name__ == "__main__":
    main()
