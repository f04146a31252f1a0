"""Narrow ConvLSTM layer update in one kernel: CUDA kernel and plain version.

The narrow layers (``C < FUSED_MIN_CHANNELS``: the pixel layer, and layer 1
of ``1,16,32,64``) of the ``"fused"`` route, which the JAX package runs on
``use_pallas=True``'s math: split gate convs in the compute dtype, then
``ops/convlstm_pallas.py::fused_lstm_gates``.  The port ran them so too (an
upsampled copy of R_above, three cuDNN convs, the bias and two adds, then
:func:`.convlstm_gates.fused_lstm_gates`); ``csrc/convlstm_narrow.cu`` does
the same work in one launch, reading R_above at half resolution where it
lies.  It is this card's redesign of the gate kernel on those layers, not
a port of another TPU kernel: :func:`.convlstm_gates.fused_lstm_gates`
stays the port of ``fused_lstm_gates`` for the routes whose gates arrive
precomputed (the s2d pixel layer, ``use_pallas=True``).

Math, in order: each source's 3x3 SAME conv (bfloat16 sources and weights,
float32 sums) rounded to the compute dtype; E's conv + the bias, + R's,
+ R_above's, each add in the compute dtype; the float32 gate math of
:func:`.convlstm_gates.lstm_gates_plain` on those gates; h and c in the
state dtype.  Weights are the fused kernel's ``(9, C, 4, Cin)`` layout
(``lstm_k_*``, :func:`.convlstm_fused.pack_gate_weight`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import _build
from ..utils import debug_nans
from .convlstm_fused import tile_width, unpack_gate_weight
from .convlstm_gates import count_launch, kernel_stream, lstm_gates_plain, refuse_grad

__all__ = [
    "COMPUTE_DTYPES",
    "MAX_CHANNELS",
    "launch",
    "narrow_convlstm_layer",
    "narrow_convlstm_layer_plain",
]

#: The widest layer the kernel takes (a block holds all 4C gate outputs).
MAX_CHANNELS = 31
#: The compute dtypes the kernel rounds its sums to.
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_STATE_DTYPES = (torch.float32, torch.bfloat16)


def narrow_convlstm_layer_plain(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor],
                                b: torch.Tensor, c_prev: torch.Tensor, *,
                                compute_dtype: torch.dtype):
    """Plain PyTorch version: the split gate convs of the narrow route
    (``models/prednet/model.py``'s ``_conv`` on each source, R_above
    upsampled first, with the OIHW weights unpacked from ``wks``), summed
    in the compute dtype, then :func:`.convlstm_gates.lstm_gates_plain`.
    Returns (h, c) in ``c_prev``'s dtype."""
    # imported here: the model imports this module
    from ..models.prednet.model import _conv, _upsample2

    cd = compute_dtype
    w = [unpack_gate_weight(wk).contiguous() for wk in wks]
    gates = _conv(srcs[0], w[0], b, cd)
    gates = gates + _conv(srcs[1], w[1], None, cd)
    if len(srcs) == 3:
        gates = gates + _conv(_upsample2(srcs[2]), w[2], None, cd)
    return lstm_gates_plain(gates, c_prev, out_dtype=c_prev.dtype)


def _check(srcs, wks, b, c_prev, cd) -> None:
    if not 2 <= len(srcs) <= 3 or len(srcs) != len(wks):
        raise ValueError(f"need E, R and optionally R_above with one weight each, got "
                         f"{len(srcs)} sources and {len(wks)} weights")
    if c_prev.dim() != 4:
        raise ValueError(f"c_prev must be (B, H, W, C), got {tuple(c_prev.shape)}")
    B, H, W, C = c_prev.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"a narrow layer has 1..{MAX_CHANNELS} channels, got {C}")
    if tuple(b.shape) != (4 * C,) or b.dtype not in _STATE_DTYPES:
        raise ValueError(f"bias must be ({4 * C},) float32 or bfloat16, got "
                         f"{tuple(b.shape)} {b.dtype}")
    for i, (x, wk) in enumerate(zip(srcs, wks)):
        at = (B, H // 2, W // 2) if i == 2 else (B, H, W)
        if i == 2 and (H % 2 or W % 2):
            raise ValueError(f"R_above needs an even H and W, got {H}x{W}")
        if x.dim() != 4 or tuple(x.shape[:3]) != at:
            raise ValueError(f"source {i} {tuple(x.shape)} is not {at} + (Cin,)")
        if tuple(wk.shape) != (9, C, 4, x.shape[3]) or wk.dtype != torch.bfloat16:
            raise ValueError(f"weight {tuple(wk.shape)} {wk.dtype} is not the bfloat16 kernel "
                             f"layout (9, {C}, 4, {x.shape[3]})")
    if cd not in COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {cd}")
    if c_prev.dtype not in _STATE_DTYPES:
        raise TypeError(f"c_prev must be float32 or bfloat16, got {c_prev.dtype}")
    devices = {t.device for t in (*srcs, *wks, b, c_prev)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def launch(srcs, wks, b, c_prev, compute_dtype, stream: int, tw: Optional[int] = None):
    """Run ``csrc/convlstm_narrow.cu`` on device tensors with strip width
    ``tw`` (default :func:`.convlstm_fused.tile_width`); returns (h, c) in
    ``c_prev``'s dtype.  Counts nothing: the wrapper does."""
    B, H, W, C = c_prev.shape
    tw = tile_width(B, H, W) if tw is None else tw
    if not 1 <= tw <= W:
        raise ValueError(f"strip width {tw} outside 1..{W}")
    xs = [x.to(torch.bfloat16).contiguous() for x in srcs]
    bias, c_prev = b.contiguous(), c_prev.contiguous()
    if not all(t.is_contiguous() for t in wks):
        raise ValueError("weights must be contiguous")
    h, c = torch.empty_like(c_prev), torch.empty_like(c_prev)
    args = []
    for s in range(3):
        if s < len(xs):
            args += [xs[s].data_ptr(), wks[s].data_ptr(), xs[s].shape[3]]
        else:
            args += [None, None, 0]
    bf16 = torch.bfloat16
    rc = _build.library().eigen_convlstm_narrow(
        *args, len(xs), bias.data_ptr(), int(bias.dtype == bf16), int(compute_dtype == bf16),
        c_prev.data_ptr(), int(c_prev.dtype == bf16), h.data_ptr(), c.data_ptr(),
        B, H, W, C, tw, stream,
    )
    if rc != 0:
        raise RuntimeError(f"convlstm_narrow kernel launch failed: CUDA error {rc}")
    return h, c


def narrow_convlstm_layer(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor],
                          b: torch.Tensor, c_prev: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16):
    """One narrow ConvLSTM layer update; the kernel on CUDA tensors, the
    plain version on CPU tensors.

    Args:
      srcs: E ``(B, H, W, 2C)``, R ``(B, H, W, C)`` and, below the top,
        R_above ``(B, H/2, W/2, C_above)`` as layer ``l + 1`` holds it (not
        upsampled); any float dtype, rounded to bfloat16.
      wks: their gate weights in the kernel layout ``(9, C, 4, Cin)``,
        bfloat16 (``lstm_k_e``, ``lstm_k_r``, ``lstm_k_up``).
      b: ``(4C,)`` bias, float32 or bfloat16, cast to the compute dtype.
      c_prev: ``(B, H, W, C)`` previous cell state, float32 or bfloat16.
      compute_dtype: float32 or bfloat16, the dtype of each source's conv
        and of the gate sums.
    Returns:
      (h, c), both ``(B, H, W, C)`` in ``c_prev``'s dtype.
    Raises:
      RuntimeError: an input requires a gradient in grad mode
        (:func:`.convlstm_gates.refuse_grad`), or the tensors are on a CUDA
        device that is not the current one
        (:func:`.convlstm_gates.kernel_stream`).
    """
    _check(srcs, wks, b, c_prev, compute_dtype)
    refuse_grad("narrow_convlstm_layer", *srcs, *wks, b, c_prev)
    with debug_nans.scope("narrow_convlstm_layer"):
        if c_prev.device.type == "cpu":
            return narrow_convlstm_layer_plain(srcs, wks, b, c_prev, compute_dtype=compute_dtype)
        if c_prev.device.type != "cuda":
            raise ValueError(f"unsupported device {c_prev.device}")
        out = launch(srcs, wks, b, c_prev, compute_dtype,
                     kernel_stream("narrow_convlstm_layer", c_prev.device))
        count_launch(narrow_convlstm_layer)
        debug_nans.check("narrow_convlstm_layer", *out)
        return out


narrow_convlstm_layer.launches = 0  # kernel launches (not plain-version calls)
narrow_convlstm_layer.captured = 0  # kernels recorded into a CUDA graph (count_launch)
