"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with :mod:`ctypes`.  The sources include no
PyTorch headers, so the build takes seconds, not the minutes of
``torch.utils.cpp_extension``.  The library lands in ``.build/<hash>/``
beside this file (listed in ``.gitignore``), keyed by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.

Nothing is built at import: :func:`library` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

__all__ = ["library", "build_log"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
BUILD_ROOT = _HERE / ".build"
_LIB_NAME = "libeigen_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# every pointer and the stream as c_void_p: a bare Python int would be
# passed as a 32-bit C int and cut the address
_SIGNATURES = {
    # ..., npix, C, body, slab_pixels, ring, grid, stream (csrc/lstm_gates.cu)
    "eigen_lstm_gates": (_P, _I, _P, _I, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _P),
    "eigen_convlstm_fused": (
        _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
        _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
    ),
    "eigen_convlstm_fused_wgmma": (
        _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
        _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "eigen_convlstm_narrow": (
        _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
        _P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
    ),
    # the narrow layer's persistent body (csrc/convlstm_narrow_hopper.cu)
    "eigen_convlstm_narrow_persistent": (
        _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
        _P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    # the True route's gate convs (csrc/convlstm_narrow.cu)
    "eigen_gate_convs": (
        _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
        _P, _I, _I, _P, _I, _I, _I, _I, _I, _P,
    ),
    # their wgmma body (csrc/gate_convs_wgmma.cu)
    "eigen_gate_convs_wgmma": (
        _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
        _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # the PredNet units (csrc/prednet_units.cu)
    "eigen_ahat_error_unit": (_P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "eigen_a_unit": (_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    # their wgmma and im2col bodies (csrc/prednet_units_wgmma.cu)
    "eigen_ahat_error_unit_wgmma": (
        _P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "eigen_a_unit_wgmma": (_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "eigen_a_unit_im2col": (_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    # the bisection ladder's rungs: A in csrc/convlstm_bisect.cu, the six
    # conv rungs C, D, H, E, I and J in csrc/bisect_wgmma.cu
    "eigen_bisect_a": (_P, _I, _P, _LL, _P),
    "eigen_bisect_c": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "eigen_bisect_d": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P),
    "eigen_bisect_h": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "eigen_bisect_e": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "eigen_bisect_i": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "eigen_bisect_j": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
_lib_dir: Optional[Path] = None


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels cannot be built"
        )
    return nvcc


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path, sources) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _find_nvcc(), f"{os.getpid()}.tmp"
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in sources]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(src, proc.returncode, log)
              for src, proc, log in zip(sources, procs, logs) if proc.returncode]
    if not failed:
        tmp = out.with_name(f"{out.name}.{tag}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode:
            failed.append(("link", link.returncode, link.stderr))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src}: exit code {rc}\n{log}" for src, rc, log in failed))
    # ptxas -v reports registers, shared memory and spills per kernel
    (out.parent / "build.log").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global _lib, _lib_dir
    if _lib is None:
        sources = sorted(_CSRC.glob("*.cu"))
        headers = sorted(_CSRC.glob("*.cuh"))
        out = BUILD_ROOT / _source_hash(sources + headers) / _LIB_NAME
        if not out.exists():
            _build(out, sources)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib, _lib_dir = lib, out.parent
    return _lib


def build_log() -> str:
    """``nvcc``'s (ptxas) report of the last build, or '' if the library
    was reused from an earlier build in this checkout without a log."""
    if _lib_dir is None:
        return ""
    log = _lib_dir / "build.log"
    return log.read_text() if log.exists() else ""
