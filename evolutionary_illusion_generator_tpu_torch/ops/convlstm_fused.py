"""Fused ConvLSTM layer update: CUDA kernel and plain version.

The CUDA counterpart of the JAX package's ``ops/convlstm_fused_pallas.py``:
``fused_convlstm_layer`` (one concatenated source, Pallas body ``_kernel``)
and ``fused_convlstm_layer_multi`` (separate E / R / upsampled-R_above
sources, Pallas body ``_kernel_multi``).  Both wrappers here launch the
kernel of ``csrc/convlstm_fused.cu``: the 3x3 SAME gate convolution over up
to three sources on the tensor cores, bias, gates and cell update in one
pass, each source read in place.

The kernel has two bodies, and the wrapper's host-side :func:`plan` picks
one per launch by shape and alignment:

- ``"wgmma"``: warpgroup products (``wgmma``) fed by the TMA through a ring
  of three chunks, the weights multicast across a cluster of two blocks.  A
  block owns a rectangle of output pixels of one image (:func:`tile_shapes`)
  and ``cg`` of 16, 32 or 48 channels with their four gates (N = 4 cg gate
  outputs, channels past C masked); the plan takes the tile and ``cg`` that
  fill the card's SMs in the fewest waves (:func:`plan`).  It needs every
  source's channel count to be a multiple of 8 and every source and weight
  16-byte aligned (the TMA's 16-byte strides): :func:`tma_ok`.
- ``"mma_sync"``: the launches the TMA cannot address.  ``mma.sync`` from
  ``cp.async`` staging, a block of 128 pixels of a strip ``tw`` columns wide
  (:func:`tile_width`, shared with ``csrc/convlstm_narrow.cu``).

Each wrapper counts its launches per body (``body_launches``) beside
``launches``.

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

import functools
from typing import NamedTuple, Optional, Sequence

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
    "Plan",
    "tile_shapes",
    "tma_ok",
    "plan",
    "plan_for",
    "block_rows",
    "block_origins",
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


# ---- the mma_sync body's tile mapping (eigen::igemm in csrc/common.cuh,
# shared with csrc/convlstm_narrow.cu): TILE_PIXELS output pixels x 16
# channels a block
TILE_PIXELS = 128


def _tiles(B: int, H: int, W: int, tw: int):
    """(blocks per channel group, halo slab pixels) of strip width ``tw``,
    as eigen::igemm lays them out."""
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


# ---- the wgmma body's plan (csrc/convlstm_fused.cu, convlstm_fused_wgmma_kernel)

BODIES = ("wgmma", "mma_sync")
WG_ROWS = 64         # M rows of a warpgroup's products (two warpgroups a block)
SLAB_PIXELS = 264    # slab pixels a ring stage holds (csrc wg::SLAB_PX)
CHANNEL_GROUPS = (16, 32, 48)  # channels a block: N = 64, 128, 192 gate outputs
SMS = 132            # the H100's SMs; the body runs one block an SM
# the plan's cost of a wave of blocks, in gate outputs: the products scale
# with N = 4 cg, the halo slab's staging does not
STAGING_COST = 64


class Plan(NamedTuple):
    """How one launch covers a layer.  ``body`` is ``"wgmma"`` or
    ``"mma_sync"``.  wgmma: a block owns ``tile_h`` x ``tile_w`` output
    pixels of one image and ``cg`` channels, its two warpgroups'
    M rows starting ``wg_stride`` halo-slab positions apart
    (:func:`block_rows`).  mma_sync: ``cg`` is 16, ``tile_w`` the strip
    width :func:`tile_width` and ``tile_h``, ``wg_stride`` are 0."""

    body: str
    cg: int
    tile_h: int
    tile_w: int
    wg_stride: int


@functools.lru_cache(maxsize=None)
def tile_shapes(W: int):
    """The wgmma body's tiles at image width ``W``, as (tile_h, tile_w,
    wg_stride): one image row of 64 pixels a warpgroup (the slab row of 66
    holds its halo); or ``tile_w`` <= 62 columns over ``floor(130 /
    (tile_w + 2))`` rows, the warpgroups' 128 rows running on across the
    slab's rows, so that the last output pixel, slab position
    ``tile_h * (tile_w + 2) - 3``, is M row 127 at most."""
    shapes = [(2, WG_ROWS, WG_ROWS + 2)]
    for tw in range(1, min(W, WG_ROWS - 2) + 1):
        shapes.append(((2 * WG_ROWS + 2) // (tw + 2), tw, WG_ROWS))
    return tuple(shapes)


def _wgmma_cost(B, H, W, C, cg, shape):
    th, tw, _ = shape
    tiles = B * -(-H // th) * -(-W // tw)
    tiles += tiles % 2  # a cluster's padding block
    blocks = tiles * -(-C // cg)
    return (-(-blocks // SMS) * (4 * cg + STAGING_COST), tiles * th * tw, -tw)


def tma_ok(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor]) -> bool:
    """Whether the TMA can address every source and weight: channel counts
    a multiple of 8 (16-byte rows) and 16-byte aligned data."""
    return all(x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0
               for x, wk in zip(srcs, wks))


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, W: int, C: int, tma: bool = True) -> Plan:
    """The launch's plan at layer shape ``(B, H, W, C)``: the wgmma body
    where ``tma`` (:func:`tma_ok`), at the tile and channel group of the
    fewest waves of blocks over the SMs, each wave costing its N plus
    ``STAGING_COST``; then the fewest tile pixels past the image's edges;
    then the wider tile.  Else the mma_sync body at :func:`tile_width`."""
    if not tma:
        return Plan("mma_sync", 16, 0, tile_width(B, H, W), 0)
    cg, shape = min(((cg, s) for cg in CHANNEL_GROUPS for s in tile_shapes(W)),
                    key=lambda cs: _wgmma_cost(B, H, W, C, *cs))
    return Plan("wgmma", cg, shape[0], shape[1], shape[2])


def plan_for(srcs, wks, c_prev) -> Plan:
    """:func:`plan` for these tensors."""
    return plan(*c_prev.shape, tma=tma_ok(srcs, wks))


def block_rows(p: Plan):
    """The wgmma body's 128 M rows of a block as the kernel maps them: row
    m of warpgroup ``m // 64`` is halo-slab position ``(m // 64) *
    wg_stride + m % 64``, that is slab pixel (r, col) = divmod(position,
    tile_w + 2) and output pixel (y0 + r, x0 + col) of the block's tile.
    Returns (position, r, col, computed): ``computed`` marks the rows that
    are output pixels of the tile (col < tile_w, r < tile_h); the kernel
    also masks those past the image's edge."""
    m = torch.arange(2 * WG_ROWS)
    pos = (m // WG_ROWS) * p.wg_stride + m % WG_ROWS
    r, col = pos // (p.tile_w + 2), pos % (p.tile_w + 2)
    return pos, r, col, (col < p.tile_w) & (r < p.tile_h)


def block_origins(p: Plan, B: int, H: int, W: int) -> torch.Tensor:
    """The wgmma body's tiles in block order (``blockIdx.x``; a cluster's
    padding block past them): (b, y0, x0) a row.  The TMA reads a tile's
    slab as the box of (tile_h + 2) x (tile_w + 2) pixels at (y0 - 1, x0 -
    1) of image b, zeros outside the image."""
    tx = -(-W // p.tile_w)
    ty = -(-H // p.tile_h)
    t = torch.arange(B * ty * tx)
    return torch.stack([t // (tx * ty), (t // tx) % ty * p.tile_h, t % tx * p.tile_w], dim=1)


def launch(srcs, wks, b, c_prev, stream: int, plan: Optional[Plan] = None):
    """Run ``csrc/convlstm_fused.cu`` on device tensors at ``plan``
    (default :func:`plan_for`); returns (h, c).  Counts nothing: the
    wrappers do."""
    for t in (*srcs, *wks):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"sources and weights must be bfloat16, got {t.dtype}")
    if c_prev.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"c_prev must be float32 or bfloat16, got {c_prev.dtype}")
    if not all(t.is_contiguous() for t in (*srcs, *wks, c_prev)):
        raise ValueError("sources, weights and c_prev must be contiguous")
    B, H, W, C = c_prev.shape
    plan = plan_for(srcs, wks, c_prev) if plan is None else plan
    if plan.body == "mma_sync" and not 1 <= plan.tile_w <= W:
        raise ValueError(f"strip width {plan.tile_w} outside 1..{W}")
    if plan.body == "wgmma" and not tma_ok(srcs, wks):
        raise ValueError("the wgmma body needs channel counts that are multiples of 8 and "
                         "16-byte aligned sources and weights")
    bias = b.float().contiguous()
    h = torch.empty_like(c_prev)
    c = torch.empty(c_prev.shape, dtype=torch.float32, device=c_prev.device)
    args = []
    for s in range(MAX_SOURCES):
        if s < len(srcs):
            args += [srcs[s].data_ptr(), wks[s].data_ptr(), srcs[s].shape[3]]
        else:
            args += [None, None, 0]
    args += [len(srcs), bias.data_ptr(), c_prev.data_ptr(), int(c_prev.dtype == torch.bfloat16),
             h.data_ptr(), c.data_ptr(), B, H, W, C]
    lib = _build.library()
    if plan.body == "wgmma":
        rc = lib.eigen_convlstm_fused_wgmma(*args, plan.cg, plan.tile_h, plan.tile_w,
                                            plan.wg_stride, stream)
    else:
        rc = lib.eigen_convlstm_fused(*args, plan.tile_w, stream)
    if rc != 0:
        raise RuntimeError(f"convlstm_fused kernel ({plan.body} body) launch failed: "
                           f"CUDA error {rc}")
    return h, c


def _run(srcs, wks, b, c_prev, wrapper):
    """The kernel on CUDA tensors (counted on ``wrapper``,
    :func:`.convlstm_gates.count_launch`, and on its ``body_launches`` by
    the body :func:`plan_for` chose), the plain
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
        p = plan_for(srcs, wks, c_prev)
        out = launch(srcs, wks, b, c_prev, kernel_stream(wrapper.__name__, c_prev.device),
                     plan=p)
        count_launch(wrapper)
        if not torch.cuda.is_current_stream_capturing():
            wrapper.body_launches[p.body] += 1
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
# CUDA graph (convlstm_gates.count_launch); the launches by body
for _fn in (fused_convlstm_layer_multi, fused_convlstm_layer):
    _fn.launches = _fn.captured = 0
    _fn.body_launches = dict.fromkeys(BODIES, 0)
del _fn
