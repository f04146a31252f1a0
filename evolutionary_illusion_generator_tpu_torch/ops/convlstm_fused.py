"""Fused ConvLSTM layer update: CUDA kernel and plain version.

The CUDA counterpart of the JAX package's ``ops/convlstm_fused_pallas.py``:
``fused_convlstm_layer`` (one concatenated source, Pallas body ``_kernel``)
and ``fused_convlstm_layer_multi`` (separate E / R / upsampled-R_above
sources, Pallas body ``_kernel_multi``).  Both wrappers here launch the one
kernel of ``csrc/convlstm_fused.cu``: the 3x3 SAME gate convolution over up
to three sources on the tensor cores, bias, gates and cell update in one
pass, each source read in place.  The wrapper picks the kernel's tile
mapping per layer shape (:func:`tile_width`).

Math (the Pallas kernels' contract): bfloat16 sources and weights, float32
accumulation, float32 gates; ``h`` comes out in ``c_prev``'s dtype and ``c``
in float32.

Weights are taken in the kernel's layout ``(9, C, 4, Cin)`` — tap
``ky * 3 + kx``, channel, gate [i, f, o, g], input channel, so that a chunk
of input channels of one output is contiguous — made once from an HWIO
``(3, 3, Cin, 4C)`` gate kernel by :func:`pack_gate_weight`
(``models/prednet/loader.py`` does so when it loads the weights).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import debug_nans
from .convlstm_gates import count_launch, kernel_stream, lstm_gates_plain, refuse_grad

__all__ = [
    "pack_gate_weight",
    "unpack_gate_weight",
    "tile_candidates",
    "tile_width",
    "launch",
    "fused_convlstm_layer",
    "fused_convlstm_layer_multi",
    "gate_conv_plain",
    "convlstm_layer_plain",
]

MAX_SOURCES = 3


def pack_gate_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO ``(3, 3, Cin, 4C)`` gate kernel (gate-major output channels)
    -> the kernels' bfloat16 ``(9, C, 4, Cin)`` layout."""
    kh, kw, cin, c4 = w_hwio.shape
    if (kh, kw) != (3, 3) or c4 % 4:
        raise ValueError(f"need a (3, 3, Cin, 4C) kernel, got {tuple(w_hwio.shape)}")
    w = w_hwio.to(torch.bfloat16).reshape(3, 3, cin, 4, c4 // 4)  # (ky, kx, ci, gate, c)
    return w.permute(0, 1, 4, 3, 2).reshape(9, c4 // 4, 4, cin).contiguous()


def unpack_gate_weight(wk: torch.Tensor) -> torch.Tensor:
    """Kernel layout ``(9, C, 4, Cin)`` -> OIHW ``(4C, Cin, 3, 3)``."""
    _, C, _, cin = wk.shape
    return wk.reshape(3, 3, C, 4, cin).permute(3, 2, 4, 0, 1).reshape(4 * C, cin, 3, 3)


def gate_conv_plain(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor],
                    b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gate convolution: per-source float32 3x3 SAME
    convolutions of the bfloat16-rounded sources and weights (exact
    products, float32 sums) plus the bias.  Returns (B, H, W, 4C) float32."""
    gates = None
    for x, wk in zip(srcs, wks):
        xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        y = F.conv2d(xb, unpack_gate_weight(wk.to(torch.bfloat16).float()), padding=1)
        gates = y if gates is None else gates + y
    return gates.permute(0, 2, 3, 1) + b.float()


def convlstm_layer_plain(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor],
                         b: torch.Tensor, c_prev: torch.Tensor):
    """Plain PyTorch version: :func:`gate_conv_plain`, then the gate math.
    Returns (h in ``c_prev``'s dtype, c float32)."""
    h, c = lstm_gates_plain(gate_conv_plain(srcs, wks, b), c_prev)
    return h.to(c_prev.dtype), c


def _check(srcs, wks, b, c_prev) -> None:
    if not 1 <= len(srcs) <= MAX_SOURCES or len(srcs) != len(wks):
        raise ValueError(f"need 1..{MAX_SOURCES} sources with one weight each, "
                         f"got {len(srcs)} and {len(wks)}")
    if c_prev.dim() != 4:
        raise ValueError(f"c_prev must be (B, H, W, C), got {tuple(c_prev.shape)}")
    B, H, W, C = c_prev.shape
    if tuple(b.shape) != (4 * C,):
        raise ValueError(f"bias must be ({4 * C},), got {tuple(b.shape)}")
    for x, wk in zip(srcs, wks):
        if x.dim() != 4 or tuple(x.shape[:3]) != (B, H, W):
            raise ValueError(f"source {tuple(x.shape)} does not match c_prev {tuple(c_prev.shape)}")
        if tuple(wk.shape) != (9, C, 4, x.shape[3]):
            raise ValueError(
                f"weight {tuple(wk.shape)} is not the kernel layout "
                f"(9, {C}, 4, {x.shape[3]}) for source {tuple(x.shape)}"
            )
    devices = {t.device for t in (*srcs, *wks, b, c_prev)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


# the kernel's block: TILE_PIXELS output pixels x 16 channels (csrc/convlstm_fused.cu TM)
TILE_PIXELS = 128


def _tiles(B: int, H: int, W: int, tw: int):
    """(blocks per channel group, halo slab pixels) of strip width ``tw``,
    as csrc/convlstm_fused.cu lays them out."""
    tile_rows = TILE_PIXELS // tw if TILE_PIXELS % tw == 0 else (TILE_PIXELS + tw - 2) // tw + 1
    blocks = -(-W // tw) * -(-B * H * tw // TILE_PIXELS)
    return blocks, (tile_rows + 2) * (tw + 2)


def tile_candidates(W: int):
    """Strip widths worth trying at image width ``W``: 4-32 columns, and the
    whole row (the flattened batch) where its halo slab stays small."""
    widths = {tw for tw in (4, 8, 16, 32) if tw <= W}
    if W <= 64:
        widths.add(W)
    return sorted(widths)


def tile_width(B: int, H: int, W: int) -> int:
    """The kernel's strip width for a ``(B, H, W)`` layer: the fewest blocks
    (so the fewest pixels computed past the image edge), then the smallest
    halo slab, then the wider strip."""
    return min(tile_candidates(W), key=lambda tw: (*_tiles(B, H, W, tw), -tw))


def launch(srcs, wks, b, c_prev, stream: int, tw: Optional[int] = None):
    """Run ``csrc/convlstm_fused.cu`` on device tensors with strip width
    ``tw`` (default :func:`tile_width`); returns (h, c).  Counts nothing:
    the wrappers do."""
    for t in (*srcs, *wks):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"sources and weights must be bfloat16, got {t.dtype}")
    if c_prev.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"c_prev must be float32 or bfloat16, got {c_prev.dtype}")
    if not all(t.is_contiguous() for t in (*srcs, *wks, c_prev)):
        raise ValueError("sources, weights and c_prev must be contiguous")
    B, H, W, C = c_prev.shape
    tw = tile_width(B, H, W) if tw is None else tw
    if not 1 <= tw <= W:
        raise ValueError(f"strip width {tw} outside 1..{W}")
    bias = b.float().contiguous()
    h = torch.empty_like(c_prev)
    c = torch.empty(c_prev.shape, dtype=torch.float32, device=c_prev.device)
    args = []
    for s in range(MAX_SOURCES):
        if s < len(srcs):
            args += [srcs[s].data_ptr(), wks[s].data_ptr(), srcs[s].shape[3]]
        else:
            args += [None, None, 0]
    rc = _build.library().eigen_convlstm_fused(
        *args, len(srcs), bias.data_ptr(), c_prev.data_ptr(),
        int(c_prev.dtype == torch.bfloat16), h.data_ptr(), c.data_ptr(),
        B, H, W, C, tw, stream,
    )
    if rc != 0:
        raise RuntimeError(f"convlstm_fused kernel launch failed: CUDA error {rc}")
    return h, c


def _run(srcs, wks, b, c_prev, wrapper):
    """The kernel on CUDA tensors (counted on ``wrapper``,
    :func:`.convlstm_gates.count_launch`), the plain
    version on CPU tensors; either refuses inputs that require a gradient
    in grad mode (:func:`.convlstm_gates.refuse_grad`) and tensors off the
    current CUDA device (:func:`.convlstm_gates.kernel_stream`), and names
    ``wrapper`` in a ``debug_nans`` error (:mod:`..utils.debug_nans`)."""
    _check(srcs, wks, b, c_prev)
    refuse_grad(wrapper.__name__, *srcs, *wks, b, c_prev)
    with debug_nans.scope(wrapper.__name__):
        if c_prev.device.type == "cpu":
            return convlstm_layer_plain(srcs, wks, b, c_prev)
        if c_prev.device.type != "cuda":
            raise ValueError(f"unsupported device {c_prev.device}")
        out = launch(srcs, wks, b, c_prev, kernel_stream(wrapper.__name__, c_prev.device))
        count_launch(wrapper)
        debug_nans.check(wrapper.__name__, *out)
        return out


def fused_convlstm_layer_multi(srcs: Sequence[torch.Tensor],
                               wks: Sequence[torch.Tensor], b: torch.Tensor,
                               c_prev: torch.Tensor):
    """ConvLSTM layer update reading each gate-conv source separately.

    Args:
      srcs: 1..3 NHWC ``(B, H, W, Cin_s)`` bfloat16 sources (E, R,
        upsampled R_above).
      wks: their weight slices in the kernel layout ``(9, C, 4, Cin_s)``.
      b: ``(4C,)`` bias.
      c_prev: ``(B, H, W, C)`` previous cell state, float32 or bfloat16.
    Returns:
      (h, c): h in ``c_prev``'s dtype, c float32, both ``(B, H, W, C)``.
    """
    return _run(srcs, wks, b, c_prev, fused_convlstm_layer_multi)


def fused_convlstm_layer(x: torch.Tensor, wk: torch.Tensor, b: torch.Tensor,
                         c_prev: torch.Tensor):
    """ConvLSTM layer update from one concatenated input ``x``
    ``(B, H, W, Cin)`` with the full gate kernel ``wk`` ``(9, C, 4, Cin)``;
    otherwise as :func:`fused_convlstm_layer_multi`."""
    return _run([x], [wk], b, c_prev, fused_convlstm_layer)


# kernel launches (not plain-version calls), and kernels recorded into a
# CUDA graph (convlstm_gates.count_launch)
for _fn in (fused_convlstm_layer_multi, fused_convlstm_layer):
    _fn.launches = _fn.captured = 0
del _fn
