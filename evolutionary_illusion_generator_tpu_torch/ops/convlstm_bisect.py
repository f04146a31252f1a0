"""The kernel-bisection ladder's rungs: CUDA kernels and plain versions.

The CUDA counterparts of the seven Pallas kernels of the JAX package's
``scripts/pallas_bisect.py`` (the TPU compile-bisection ladder), one wrapper
per rung with the reference's signature ``(x, w, b, c_prev[, rows])``: NHWC
``x`` ``(B, H, W, Cin)``, HWIO ``w`` ``(3, 3, Cin, 4C)``, ``b`` ``(4C,)``,
``c_prev`` ``(B, H, W, C)``.

=====  ==============  ==========================================================
key    wrapper         what the kernel computes
=====  ==============  ==========================================================
A      ``variant_A``   ``float32(c_prev) * 2``, returned as ``(out, out)``
C      ``variant_C``   3x3 SAME conv + bias -> float32 gates (the gate math
                       after it is plain PyTorch, as it is XLA in the reference)
D      ``variant_D``   conv + gates + cell update over ``xp``
H      ``variant_H``   D over row blocks of the window stack ``xh``
E      ``variant_E``   D over row blocks of ``xp``, each read in place
I      ``variant_H2``  H with windows of the aligned width ``Wp``
J      ``variant_E2``  E over ``xp`` padded to the aligned width ``Wp``
=====  ==============  ==========================================================

The kernels are ``csrc/bisect_wgmma.cu`` for the six conv rungs C, D, H,
E, I and J (warpgroup products, ``wgmma``, fed by the TMA; one kernel body
that reads ``xp`` as one window of H rows (C, D) or as H / rows windows
overlapping by two rows (E, J), and ``xh`` as H / rows windows (H, I)) and
``csrc/convlstm_bisect.cu`` for A (a streaming pass over 16-byte vectors);
their notes say what bounds them on the H100 and how a block replaces a
TPU grid step.  The host glue the reference does in XLA stays in PyTorch
here: the zero padding to ``xp``
(:func:`pad_input`, to ``Wp = ceil16(W + 2)`` for I and J) and the
materialised overlapped windows ``xh`` (:func:`window_stack`, H and I);
the weights go to the kernels' layout ``(9, C, 4, Cin)`` by
:func:`.convlstm_fused.pack_gate_weight`, the fused kernel's layout too.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel (counted on the wrapper's ``launches``) or raises.  The
row-block rungs refuse ``H % rows != 0``: the reference's grid
``(B, H // rows)`` leaves the last ``H % rows`` rows of ``h`` and ``c``
unwritten, and the port does not copy that.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import _build
from .convlstm_fused import convlstm_layer_plain, gate_conv_plain, pack_gate_weight
from .convlstm_gates import count_launch, kernel_stream, lstm_gates_plain

__all__ = [
    "aligned_width",
    "pad_input",
    "window_stack",
    "reference",
    "plain",
    "prepare",
    "launch",
    "launch_a",
    "variant_A",
    "variant_C",
    "variant_D",
    "variant_H",
    "variant_E",
    "variant_H2",
    "variant_E2",
    "RUNGS",
]


def aligned_width(W: int) -> int:
    """The reference's aligned padded width for I and J: W + 2 rounded up
    to a multiple of 16."""
    return (W + 2 + 15) // 16 * 16


def pad_input(x: torch.Tensor, aligned: bool = False) -> torch.Tensor:
    """``xp``: ``x`` in bfloat16 with a zero halo of one row above and
    below and one column left, and on the right up to ``W + 2`` pixels, or
    :func:`aligned_width` pixels when ``aligned``: ``(B, H + 2, Wp, Cin)``."""
    W = x.shape[2]
    right = (aligned_width(W) if aligned else W + 2) - W - 1
    return F.pad(x.to(torch.bfloat16), (0, 0, 1, right, 1, 1))


def window_stack(xp: torch.Tensor, rows: int) -> torch.Tensor:
    """``xh``: the overlapped row windows of ``xp``, materialised,
    ``(B, H // rows, rows + 2, Wp, Cin)``; window ``i`` is padded rows
    ``i * rows .. i * rows + rows + 1``."""
    nblk = (xp.shape[1] - 2) // rows
    return torch.stack([xp[:, i * rows : i * rows + rows + 2] for i in range(nblk)], dim=1)


def reference(x, w, b, c_prev):
    """The ladder's plain reference (the JAX script's ``xla_reference``):
    the gate convolution, bias and gate math in float32 from bfloat16 ``x``
    and ``w``.  Returns (h, c), both float32."""
    return lstm_gates_plain(gate_conv_plain([x], [pack_gate_weight(w)], b), c_prev)


class _Rung(NamedTuple):
    entry: str        # C entry in csrc/bisect_wgmma.cu, the kernel of all six conv rungs
    windows: bool     # reads the window stack xh, else the padded input xp
    aligned: bool     # padded width Wp = aligned_width(W), else W + 2
    row_blocks: bool  # the grid walks row blocks of `rows`


_CONV_RUNGS = {
    "C": _Rung("eigen_bisect_c", False, False, False),
    "D": _Rung("eigen_bisect_d", False, False, False),
    "H": _Rung("eigen_bisect_h", True, False, True),
    "E": _Rung("eigen_bisect_e", False, False, True),
    "I": _Rung("eigen_bisect_i", True, True, True),
    "J": _Rung("eigen_bisect_j", False, True, True),
}


def plain(key: str, x, w, b, c_prev):
    """The plain PyTorch version of rung ``key`` (the wrapper's CPU path):
    A -> ``(out, out)``; C -> float32 (h, c) as :func:`reference`; the
    fused rungs -> (h in ``c_prev``'s dtype, c float32)."""
    if key == "A":
        out = c_prev.float() * 2
        return out, out
    if key == "C":
        return reference(x, w, b, c_prev)
    if key not in _CONV_RUNGS:
        raise KeyError(f"no rung {key!r}")
    return convlstm_layer_plain([x], [pack_gate_weight(w)], b, c_prev)


def _check(x, w, b, c_prev, rows: Optional[int]) -> None:
    if x.dim() != 4 or c_prev.dim() != 4 or tuple(x.shape[:3]) != tuple(c_prev.shape[:3]):
        raise ValueError(f"need x (B, H, W, Cin) and c_prev (B, H, W, C), got "
                         f"{tuple(x.shape)} and {tuple(c_prev.shape)}")
    B, H, W, Cin = x.shape
    C = c_prev.shape[3]
    if tuple(w.shape) != (3, 3, Cin, 4 * C):
        raise ValueError(f"w must be HWIO (3, 3, {Cin}, {4 * C}), got {tuple(w.shape)}")
    if tuple(b.shape) != (4 * C,):
        raise ValueError(f"b must be ({4 * C},), got {tuple(b.shape)}")
    if rows is not None:
        if rows <= 0:
            raise ValueError(f"rows must be positive, got {rows}")
        if H % rows:
            raise ValueError(
                f"H={H} is not a multiple of rows={rows}: the reference's grid "
                f"(B, H // rows) leaves the last H % rows = {H % rows} rows of h "
                f"and c unwritten, and the port refuses that shape"
            )
    devices = {t.device for t in (x, w, b, c_prev)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    if c_prev.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {c_prev.device}")


def _check_state(c_prev: torch.Tensor) -> None:
    if c_prev.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"c_prev must be float32 or bfloat16, got {c_prev.dtype}")
    if not c_prev.is_contiguous():
        raise ValueError("c_prev must be contiguous")


def prepare(key: str, x: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """The host glue of conv rung ``key``: ``xp``, or ``xh`` for H and I."""
    rung = _CONV_RUNGS[key]
    xp = pad_input(x, rung.aligned)
    return window_stack(xp, rows) if rung.windows else xp


def launch(key: str, xin: torch.Tensor, wt: torch.Tensor, b: torch.Tensor,
           c_prev: torch.Tensor, rows: Optional[int], stream):
    """Run conv rung ``key``'s kernel on the output of :func:`prepare` and
    the weights ``wt`` of :func:`.convlstm_fused.pack_gate_weight`.  Returns
    the float32 gates ``(B, H, W, 4C)`` for C, else (h in ``c_prev``'s
    dtype, c float32).  Counts nothing: the wrappers do."""
    rung = _CONV_RUNGS[key]
    B, H, W, C = c_prev.shape
    cin = xin.shape[-1]
    want = ((B, H // rows, rows + 2) if rung.windows else (B, H + 2))
    want += (aligned_width(W) if rung.aligned else W + 2, cin)
    if tuple(xin.shape) != want or xin.dtype != torch.bfloat16 or not xin.is_contiguous():
        raise ValueError(f"rung {key} takes a contiguous bfloat16 input {want}, got "
                         f"{xin.dtype} {tuple(xin.shape)}")
    if tuple(wt.shape) != (9, C, 4, cin) or wt.dtype != torch.bfloat16 or not wt.is_contiguous():
        raise ValueError(f"wt must be contiguous bfloat16 (9, {C}, 4, {cin}), got "
                         f"{wt.dtype} {tuple(wt.shape)}")
    if xin.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("the kernels copy 16-byte pieces: xin and wt must be 16-byte aligned")
    _check_state(c_prev)
    bias = b.float().contiguous()
    fn = getattr(_build.library(), rung.entry)
    if key == "C":
        out = torch.empty((B, H, W, 4 * C), dtype=torch.float32, device=c_prev.device)
        rc = fn(xin.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
                B, H, W, cin, C, stream)
    else:
        h = torch.empty_like(c_prev)
        c = torch.empty(c_prev.shape, dtype=torch.float32, device=c_prev.device)
        extra = ([rows] if rung.row_blocks else []) + ([want[-2]] if rung.aligned else [])
        rc = fn(xin.data_ptr(), wt.data_ptr(), bias.data_ptr(), c_prev.data_ptr(),
                int(c_prev.dtype == torch.bfloat16), h.data_ptr(), c.data_ptr(),
                B, H, W, cin, C, *extra, stream)
        out = (h, c)
    if rc != 0:
        raise RuntimeError(f"{rung.entry} kernel launch failed: CUDA error {rc}")
    return out


def _stream(key: str, t: torch.Tensor):
    return kernel_stream(f"variant_{key}", t.device)


def _conv_rung(key, wrapper, x, w, b, c_prev, rows=None):
    _check(x, w, b, c_prev, rows)
    if c_prev.device.type == "cpu":
        return plain(key, x, w, b, c_prev)
    out = launch(key, prepare(key, x, rows), pack_gate_weight(w), b, c_prev, rows,
                 _stream(key, c_prev))
    count_launch(wrapper)
    if key == "C":  # the gate math after the kernel, plain as in the reference
        return lstm_gates_plain(out, c_prev)
    return out


def variant_A(x, w, b, c_prev):
    """``float32(c_prev) * 2`` as ``(out, out)``; ``x``, ``w`` and ``b`` are
    checked and not used, as in the reference."""
    _check(x, w, b, c_prev, None)
    if c_prev.device.type == "cpu":
        return plain("A", x, w, b, c_prev)
    out = launch_a(c_prev, _stream("A", c_prev))
    count_launch(variant_A)
    return out, out


def launch_a(c_prev: torch.Tensor, stream) -> torch.Tensor:
    """Run rung A's kernel: ``float32(c_prev) * 2``.  The output is placed
    as many elements (mod 4) past a 16-byte boundary as ``c_prev`` is, so
    that a view at any element offset streams in 16-byte vectors after the
    kernel's scalar head.  Counts nothing: the wrapper does."""
    _check_state(c_prev)
    off = c_prev.data_ptr() % 16 // c_prev.element_size() % 4
    out = torch.empty(c_prev.numel() + off, dtype=torch.float32,
                      device=c_prev.device)[off:].view(c_prev.shape)
    rc = _build.library().eigen_bisect_a(
        c_prev.data_ptr(), int(c_prev.dtype == torch.bfloat16), out.data_ptr(),
        c_prev.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"eigen_bisect_a kernel launch failed: CUDA error {rc}")
    return out


def variant_C(x, w, b, c_prev):
    """Conv kernel to float32 gates, then the plain gate math: (h, c)
    float32."""
    return _conv_rung("C", variant_C, x, w, b, c_prev)


def variant_D(x, w, b, c_prev):
    """Conv, gates and cell update in one kernel over ``xp``: (h in
    ``c_prev``'s dtype, c float32)."""
    return _conv_rung("D", variant_D, x, w, b, c_prev)


def variant_H(x, w, b, c_prev, rows=32):
    """D over row blocks of the materialised window stack ``xh``."""
    return _conv_rung("H", variant_H, x, w, b, c_prev, rows)


def variant_E(x, w, b, c_prev, rows=32):
    """D over row blocks of ``xp``, each block's rows read from ``xp`` in
    place."""
    return _conv_rung("E", variant_E, x, w, b, c_prev, rows)


def variant_H2(x, w, b, c_prev, rows=32):
    """H with windows of the aligned width ``Wp`` (the ladder's key I)."""
    return _conv_rung("I", variant_H2, x, w, b, c_prev, rows)


def variant_E2(x, w, b, c_prev, rows=32):
    """E over ``xp`` padded to the aligned width ``Wp`` (the ladder's key J)."""
    return _conv_rung("J", variant_E2, x, w, b, c_prev, rows)


# the ladder's keys -> wrappers
RUNGS = {
    "A": variant_A,
    "C": variant_C,
    "D": variant_D,
    "H": variant_H,
    "E": variant_E,
    "I": variant_H2,
    "J": variant_E2,
}
for _fn in RUNGS.values():
    # kernel launches (not plain-version calls), and kernels recorded into
    # a CUDA graph (convlstm_gates.count_launch)
    _fn.launches = _fn.captured = 0
del _fn
