"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources go through ONE ``nvcc`` call into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The sources
include no PyTorch headers, so the build takes seconds, not the minutes of
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
_BUILD_ROOT = _HERE / ".build"
_LIB_NAME = "libeigen_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# every pointer and the stream as c_void_p: a bare Python int would be
# passed as a 32-bit C int and cut the address
_SIGNATURES = {
    "eigen_lstm_gates": (_P, _P, _I, _P, _P, _LL, _I, _P),
    "eigen_convlstm_fused": (
        _P, _P, _I, _P, _P, _I, _P, _P, _I, _I,
        _P, _P, _I, _P, _P, _I, _I, _I, _I, _P,
    ),
    # csrc/convlstm_bisect.cu: the bisection ladder's rungs
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
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    # ptxas -v reports registers, shared memory and spills per kernel
    (out.parent / "build.log").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global _lib, _lib_dir
    if _lib is None:
        sources = sorted(_CSRC.glob("*.cu"))
        headers = sorted(_CSRC.glob("*.cuh"))
        out = _BUILD_ROOT / _source_hash(sources + headers) / _LIB_NAME
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
