"""Narrow ConvLSTM layer update in one kernel: CUDA kernels and plain version.

The narrow layers (``C < FUSED_MIN_CHANNELS``: the pixel layer, and layer 1
of ``1,16,32,64``) of the ``"fused"`` route, which the JAX package runs on
``use_pallas=True``'s math: split gate convs in the compute dtype, then
``ops/convlstm_pallas.py::fused_lstm_gates``.  The port ran them so too (an
upsampled copy of R_above, three cuDNN convs, the bias and two adds, then
:func:`.convlstm_gates.fused_lstm_gates`); the kernels here do the same
work in one launch, reading R_above at half resolution where it lies.  It
is this card's redesign of the gate kernel on those layers, not a port of
another TPU kernel: :func:`.convlstm_gates.fused_lstm_gates` stays the port
of ``fused_lstm_gates`` for the routes whose gates arrive precomputed (the
s2d pixel layer, ``use_pallas=True``).

Math, in order: each source's 3x3 SAME conv (bfloat16 sources and weights,
float32 sums) rounded to the compute dtype; E's conv + the bias, + R's,
+ R_above's, each add in the compute dtype; the float32 gate math of
:func:`.convlstm_gates.lstm_gates_plain` on those gates; h and c in the
state dtype.  Weights are the fused kernel's ``(9, C, 4, Cin)`` layout
(``lstm_k_*``, :func:`.convlstm_fused.pack_gate_weight`).

Two bodies, picked per launch by :func:`narrow_plan` from the layer's
channels and compute dtype alone, never from the batch (the bodies sum a
pixel's products in different orders, and a shard has a smaller batch):

- ``"persistent"`` (``csrc/convlstm_narrow_hopper.cu``; bfloat16 compute,
  C <= :data:`PACKED_MAX_C`, R_above of channels a multiple of 8: the
  bundled stacks' pixel layers): a grid of :data:`SMS` times the blocks an
  SM holds, each staging the layer's whole weight set once and walking
  tiles of ``128 / tile_w`` x ``tile_w`` pixels of one image through a
  ring of :data:`STAGES` stages the TMA fills; E and R staged as their rows
  and laid out as one K row a pixel (k = tap * Cs + ci), R_above read in
  place from its halo at half resolution;
- ``"mma_sync"`` (``csrc/convlstm_narrow.cu``; float32 compute and every
  other width, layer 1 of ``1,16,32,64`` too: there it measured faster on
  the H100 than the persistent design, whose C 16 weights keep one block
  an SM): ``eigen::igemm::conv3x3`` over strips ``tile_w`` wide.

:func:`gate_convs` is the same split-conv math stopped at the gates, on
any width: the ``True`` route's gate convs on the card (its gates then go
to :func:`.convlstm_gates.fused_lstm_gates`), summed in one order whatever
the batch, as cuDNN's convs were not.  Two bodies, picked by
:func:`gate_plan` from the layer's shape, channels and compute dtype and
whether the TMA can address its sources, never from the batch:

- ``"wgmma"`` (``csrc/gate_convs_wgmma.cu``; bfloat16 compute, C >= 32,
  every source's channels a multiple of 8): the fused kernel's ``wgmma``
  body (a tile of one image and a channel group of 48, 32 or 16 a block,
  a TMA ring of three or four chunks, cluster-multicast weights) with one float32
  chain a source rounded at the source's end, and R_above's coarse box
  expanded 2x in shared memory;
- ``"mma_sync"`` (``csrc/convlstm_narrow.cu``'s ``gate_convs_kernel``):
  float32 compute (its compensated sums), C < 32 (one block holds all 4C
  outputs) and sources the TMA cannot address.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from .. import _build
from ..utils import debug_nans
from .convlstm_fused import (
    CHANNEL_GROUPS,
    SMS,
    TILE_PIXELS,
    Plan,
    tile_shapes,
    tile_width,
    unpack_gate_weight,
)
from .convlstm_gates import count_launch, kernel_stream, lstm_gates_plain, refuse_grad

__all__ = [
    "BODIES",
    "COMPUTE_DTYPES",
    "GATE_BODIES",
    "MAX_CHANNELS",
    "NarrowPlan",
    "chain_float64",
    "coarse_box",
    "gate_body",
    "gate_chain_float64",
    "gate_convs",
    "gate_convs_plain",
    "gate_groups",
    "gate_plan",
    "launch",
    "launch_gates",
    "mma_sync_smem",
    "narrow_body",
    "narrow_convlstm_layer",
    "narrow_convlstm_layer_plain",
    "narrow_plan",
    "persistent_plan",
    "persistent_smem",
]

#: The widest layer the kernels take (a block holds all 4C gate outputs).
MAX_CHANNELS = 31
#: The compute dtypes the kernels round their sums to.
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_STATE_DTYPES = (torch.float32, torch.bfloat16)

BODIES = ("persistent", "mma_sync")
#: The persistent body's widest layer: it stages E (2C channels) and R (C)
#: as rows and builds each pixel's K row from them (9 x 2C <= 64), N = 16
#: gate outputs a block.
PACKED_MAX_C = 3
#: The persistent body's tile widths; a tile is TILE_PIXELS pixels of one
#: image, TILE_PIXELS / tile_w rows (even, so R_above's halo starts on a
#: coarse pixel; at most 32 wide, so E's halo row of (tile_w + 2) 2C
#: elements is one TMA box).
PERSISTENT_TILES = (16, 32)
#: Tile stages in flight in the persistent body's ring.
STAGES = 3
#: Shared memory of an H100 SM, and what the card reserves a block.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448
SMEM_RESERVED = 1024
#: The persistent body's blocks an SM at most (160 threads each: four
#: consumer warps and the producer warp).
MAX_BLOCKS_PER_SM = 4


class NarrowPlan(NamedTuple):
    """How one launch covers a narrow layer.  ``body`` is one of
    :data:`BODIES`.  persistent: tiles ``tile_w`` wide, ``blocks`` blocks
    (a multiple of :data:`SMS`) walking them, ``smem`` bytes of shared
    memory a block.  mma_sync: the strip width ``tile_w``."""

    body: str
    tile_w: int = 0
    blocks: int = 0
    smem: int = 0


def narrow_body(C: int, C_above: Optional[int], compute_dtype: torch.dtype) -> str:
    """The body of a narrow layer, from its channels and compute dtype
    alone: bfloat16 compute at C <= :data:`PACKED_MAX_C` with R_above (if
    any) of channels a multiple of 8 on the persistent body; the rest on
    the mma.sync body (float32 compute keeps its compensated sums)."""
    if (compute_dtype == torch.bfloat16 and C <= PACKED_MAX_C
            and (not C_above or C_above % 8 == 0)):
        return "persistent"
    return "mma_sync"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up(n: int, k: int) -> int:
    return _cdiv(n, k) * k


def persistent_smem(C: int, C_above: Optional[int], tile_w: int,
                    state_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The persistent body's shared memory in bytes, as
    ``csrc/convlstm_narrow_hopper.cu``'s ``make_geometry`` lays it out:
    the weights (16 outputs x the K rows of E, R and R_above, in k16
    planes), :data:`STAGES` tile stages (each the TMA's boxes of E's, R's
    and R_above's halos and c_prev's rows, 128-byte aligned), the K rows of
    E and R (which then hold the epilogue's gates), the warps' output runs,
    and the ring's mbarriers with a zero chunk.  Returns each part and the
    total (``"smem"``)."""
    th = TILE_PIXELS // tile_w
    sb = torch.finfo(state_dtype).bits // 8
    planes = _cdiv(18 * C, 16) + _cdiv(9 * C, 16) + (9 * _cdiv(C_above, 16) if C_above else 0)
    # E and R: (th + 2) rows from element (x0 - 1) cs - (-cs mod 8), where
    # the TMA may start a box (16 bytes)
    boxes = [(th + 2) * _up(-cs % 8 + (tile_w + 2) * cs, 8) * 2 for cs in (2 * C, C)]
    boxes.append((th // 2 + 2) * (tile_w // 2 + 2) * 2 * C_above if C_above else 0)
    boxes.append(th * tile_w * C * sb)  # c_prev
    stage = sum(_up(b, 128) for b in boxes)
    krow = (16 * _cdiv(18 * C, 16) + 16 * _cdiv(9 * C, 16)) * 2 + 16
    seglen = min(tile_w, 32)
    parts = dict(weights=planes * 16 * 32, stage=stage, krows=_up(TILE_PIXELS * krow, 128),
                 out=_up(4 * 2 * (32 // seglen) * _up(seglen * C, 16 // sb) * sb, 128),
                 bars=128)
    parts["smem"] = (parts["weights"] + STAGES * stage + parts["krows"] + parts["out"]
                     + parts["bars"])
    return parts


@functools.lru_cache(maxsize=None)
def persistent_plan(B: int, H: int, W: int, C: int, C_above: Optional[int],
                    state_dtype: torch.dtype = torch.bfloat16, tile_w: Optional[int] = None,
                    blocks_per_sm: Optional[int] = None) -> NarrowPlan:
    """The persistent body's launch: the tile width of
    :data:`PERSISTENT_TILES` with the fewest tiles (the fewest pixels past
    the image's edges), then the narrower (the smaller halo a pixel); as
    many blocks an SM as their shared memory allows, at most
    :data:`MAX_BLOCKS_PER_SM` and no more than the tiles fill, times
    :data:`SMS`.  ``tile_w`` and ``blocks_per_sm`` force a choice
    (``scripts/narrow_breakdown.py --plans``)."""
    def tiles(tw):
        return B * _cdiv(H, TILE_PIXELS // tw) * _cdiv(W, tw)

    if tile_w is None:
        tile_w = min(PERSISTENT_TILES, key=lambda tw: (tiles(tw), tw))
    smem = persistent_smem(C, C_above, tile_w, state_dtype)["smem"]
    if blocks_per_sm is None:
        blocks_per_sm = max(1, min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED),
                                   _cdiv(tiles(tile_w), SMS)))
    return NarrowPlan("persistent", tile_w, SMS * blocks_per_sm, smem)


def mma_sync_smem(C: int, tw: int) -> int:
    """The mma.sync body's shared memory in bytes at strip width ``tw``
    (``common.cuh``'s ``eigen::igemm::smem_bytes``: two stages of the 9
    taps' weight slice and the halo slab, or the epilogue's rows of floats,
    whichever is more)."""
    nout = next(n for n in (16, 32, 64, 128) if 4 * C <= n)
    tile_rows = (TILE_PIXELS // tw if TILE_PIXELS % tw == 0
                 else (TILE_PIXELS + tw - 2) // tw + 1)
    stages = 2 * (2 * (9 * nout * 16 + (tile_rows + 2) * (tw + 2) * 24) + 24)
    return max(stages, TILE_PIXELS * (nout + 4) * 4)


def narrow_plan(B: int, H: int, W: int, C: int, C_above: Optional[int],
                compute_dtype: torch.dtype = torch.bfloat16,
                state_dtype: torch.dtype = torch.bfloat16) -> NarrowPlan:
    """A launch's plan: the body of :func:`narrow_body`, then
    :func:`persistent_plan` or the mma.sync body's strip width
    :func:`.convlstm_fused.tile_width`.  The batch moves only the tiling,
    under which a pixel's sums do not move."""
    if narrow_body(C, C_above, compute_dtype) == "persistent":
        return persistent_plan(B, H, W, C, C_above, state_dtype)
    tw = tile_width(B, H, W)
    return NarrowPlan("mma_sync", tile_w=tw, smem=mma_sync_smem(C, tw))


def gate_chain_float64(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor],
                       b: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16):
    """The split gate convs' chain in float64, rounded to the compute dtype
    at each of its rounding points (each source's conv, E's + the bias,
    + R's, + R_above's), and beside it one ulp at each of those points
    summed (2**-7 of each point's magnitude for bfloat16, 2**-23 for
    float32).  Returns (gates, bound, unrounded gates), gate-major, float64."""
    F = torch.nn.functional
    rb = (lambda t: t.to(compute_dtype).double())
    u = 2.0**-7 if compute_dtype == torch.bfloat16 else 2.0**-23
    xs = [x.to(torch.bfloat16).double() for x in srcs]
    if len(xs) == 3:
        xs[2] = xs[2].repeat_interleave(2, 1).repeat_interleave(2, 2)
    convs = [F.conv2d(x.permute(0, 3, 1, 2), unpack_gate_weight(wk).double(),
                      padding=1).permute(0, 2, 3, 1) for x, wk in zip(xs, wks)]
    bias = b.to(compute_dtype).double()
    g, g_exact, err = bias, bias + 0.0, 0.0
    for conv in convs:
        v = rb(conv)
        g = rb(g + v)
        g_exact = g_exact + conv
        err = err + u * (v.abs() + g.abs())
    return g, err, g_exact


def chain_float64(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor], b: torch.Tensor,
                  c_prev: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The narrow route's chain in float64: :func:`gate_chain_float64`,
    then the gate math in float64; beside it, how far one ulp at each
    rounding point can move h and c (the gates' bound carried through the
    gate math's derivatives, plus one ulp of h's and c's own rounding to the
    state dtype and 1e-6 for the float32 gate math).  Returns h, c, their
    bounds ``dh``, ``dc`` and the unrounded float64 c ``c_exact``."""
    C = c_prev.shape[-1]
    us = 2.0**-7 if c_prev.dtype == torch.bfloat16 else 2.0**-23
    g, err, g_exact = gate_chain_float64(srcs, wks, b, compute_dtype)
    cp = c_prev.double()

    def cell(gates):
        i, f, o, gg = gates.split(C, dim=-1)
        c = torch.sigmoid(f) * cp + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c, (i, f, o, gg)

    h, c, (i, f, o, gg) = cell(g)
    di, df, do, dg = err.split(C, dim=-1)
    ds = (lambda x: torch.sigmoid(x) * (1 - torch.sigmoid(x)))
    dc_pre = (cp.abs() * ds(f) * df + torch.tanh(gg).abs() * ds(i) * di
              + torch.sigmoid(i) * (1 - torch.tanh(gg) ** 2) * dg)
    dh = (torch.tanh(c).abs() * ds(o) * do + torch.sigmoid(o) * (1 - torch.tanh(c) ** 2) * dc_pre
          + us * h.abs() + 1e-6)
    dc = dc_pre + us * c.abs() + 1e-6
    return dict(h=h, c=c, dh=dh, dc=dc, c_exact=cell(g_exact)[1])


def narrow_convlstm_layer_plain(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor],
                                b: torch.Tensor, c_prev: torch.Tensor, *,
                                compute_dtype: torch.dtype):
    """Plain PyTorch version: :func:`gate_convs_plain`, then
    :func:`.convlstm_gates.lstm_gates_plain`.  Returns (h, c) in
    ``c_prev``'s dtype."""
    gates = gate_convs_plain(srcs, wks, b, compute_dtype=compute_dtype)
    return lstm_gates_plain(gates, c_prev, out_dtype=c_prev.dtype)


def gate_convs_plain(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor],
                     b: torch.Tensor, *, compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of :func:`gate_convs`: the split gate convs
    (``models/prednet/model.py``'s ``_conv`` on each source, R_above
    upsampled first, with the OIHW weights unpacked from ``wks``), summed
    in the compute dtype.  Returns the gates ``(B, H, W, 4C)``, gate-major,
    in the compute dtype."""
    # imported here: the model imports this module
    from ..models.prednet.model import _conv, _upsample2

    cd = compute_dtype
    w = [unpack_gate_weight(wk).contiguous() for wk in wks]
    gates = _conv(srcs[0], w[0], b, cd)
    gates = gates + _conv(srcs[1], w[1], None, cd)
    if len(srcs) == 3:
        gates = gates + _conv(_upsample2(srcs[2]), w[2], None, cd)
    return gates


def _check_sources(srcs, wks, b, B, H, W, C, cd) -> None:
    if not 2 <= len(srcs) <= 3 or len(srcs) != len(wks):
        raise ValueError(f"need E, R and optionally R_above with one weight each, got "
                         f"{len(srcs)} sources and {len(wks)} weights")
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
    devices = {t.device for t in (*srcs, *wks, b)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def _check(srcs, wks, b, c_prev, cd) -> None:
    if c_prev.dim() != 4:
        raise ValueError(f"c_prev must be (B, H, W, C), got {tuple(c_prev.shape)}")
    B, H, W, C = c_prev.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"a narrow layer has 1..{MAX_CHANNELS} channels, got {C}")
    if c_prev.dtype not in _STATE_DTYPES:
        raise TypeError(f"c_prev must be float32 or bfloat16, got {c_prev.dtype}")
    if c_prev.device != b.device:
        raise ValueError(f"tensors on several devices: {c_prev.device} and {b.device}")
    _check_sources(srcs, wks, b, B, H, W, C, cd)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (16-byte copies): copied into a
    fresh allocation where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _source_args(srcs, wks):
    xs = [_aligned(x.to(torch.bfloat16)) for x in srcs]
    if not all(t.is_contiguous() for t in wks):
        raise ValueError("weights must be contiguous")
    wks = [_aligned(wk) for wk in wks]
    args = []
    for s in range(3):
        args += ([xs[s].data_ptr(), wks[s].data_ptr(), xs[s].shape[3]] if s < len(xs)
                 else [None, None, 0])
    return xs, args


def launch(srcs, wks, b, c_prev, compute_dtype, stream: int, tw: Optional[int] = None,
           plan: Optional[NarrowPlan] = None):
    """Run the narrow layer's kernel on device tensors at ``plan`` (default
    :func:`narrow_plan`); ``tw`` forces the mma.sync body at that strip
    width.  A plan of another body than the shape's sums in another order.
    Returns (h, c) in ``c_prev``'s dtype.  Counts nothing: the wrapper
    does."""
    B, H, W, C = c_prev.shape
    C_above = srcs[2].shape[3] if len(srcs) == 3 else None
    if tw is not None:
        plan = NarrowPlan("mma_sync", tile_w=tw)
    elif plan is None:
        plan = narrow_plan(B, H, W, C, C_above, compute_dtype, c_prev.dtype)
    if plan.body == "mma_sync" and not 1 <= plan.tile_w <= W:
        raise ValueError(f"strip width {plan.tile_w} outside 1..{W}")
    if plan.body == "persistent" and narrow_body(C, C_above, compute_dtype) != "persistent":
        raise ValueError(f"the persistent body does not take C {C}, R_above {C_above} in "
                         f"{compute_dtype}")
    if plan.body == "persistent" and W * C % 8:
        # the TMA reads rows of a 16-byte multiple: zero columns to a width
        # of a multiple of 8, the SAME padding's own zeros
        Wp = _up(W, 8)

        def pad(t, w):
            return torch.nn.functional.pad(t, (0, 0, 0, w - t.shape[2]))

        srcs = [pad(srcs[0], Wp), pad(srcs[1], Wp)] + [pad(x, Wp // 2) for x in srcs[2:]]
        h, c = launch(srcs, wks, b, pad(c_prev, Wp), compute_dtype, stream, plan=plan)
        return h[:, :, :W].contiguous(), c[:, :, :W].contiguous()
    xs, args = _source_args(srcs, wks)
    bias, c_prev = b.contiguous(), _aligned(c_prev)
    h, c = torch.empty_like(c_prev), torch.empty_like(c_prev)
    bf16 = torch.bfloat16
    lib = _build.library()
    args += [len(xs), bias.data_ptr(), int(bias.dtype == bf16), int(compute_dtype == bf16),
             c_prev.data_ptr(), int(c_prev.dtype == bf16), h.data_ptr(), c.data_ptr(),
             B, H, W, C]
    if plan.body == "persistent":
        rc = lib.eigen_convlstm_narrow_persistent(*args, plan.tile_w, plan.blocks, stream)
    else:
        rc = lib.eigen_convlstm_narrow(*args, plan.tile_w, stream)
    if rc != 0:
        raise RuntimeError(f"convlstm_narrow kernel ({plan.body} body) launch failed: "
                           f"CUDA error {rc}")
    return h, c


def narrow_convlstm_layer(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor],
                          b: torch.Tensor, c_prev: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16):
    """One narrow ConvLSTM layer update; the kernel on CUDA tensors (the
    body of :func:`narrow_plan`), the plain version on CPU tensors.

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
        B, H, W, C = c_prev.shape
        plan = narrow_plan(B, H, W, C, srcs[2].shape[3] if len(srcs) == 3 else None,
                           compute_dtype, c_prev.dtype)
        out = launch(srcs, wks, b, c_prev, compute_dtype,
                     kernel_stream("narrow_convlstm_layer", c_prev.device), plan=plan)
        count_launch(narrow_convlstm_layer)
        if not torch.cuda.is_current_stream_capturing():
            narrow_convlstm_layer.body_launches[plan.body] += 1
        debug_nans.check("narrow_convlstm_layer", *out)
        return out


narrow_convlstm_layer.launches = 0  # kernel launches (not plain-version calls)
narrow_convlstm_layer.captured = 0  # kernels recorded into a CUDA graph (count_launch)
narrow_convlstm_layer.body_launches = dict.fromkeys(BODIES, 0)  # launches by body


# ---- the True route's gate convs ----------------------------------------------


def gate_groups(C: int):
    """The channel groups of :func:`gate_convs`' mma.sync body: all 4C gate
    outputs of a layer of C < 32 in one block (N = 16, 32, 64 or 128), else
    groups of 32 channels (N = 128, the grid's second axis), the last
    masked past C.  Returns (N, [(c0, channels), ...])."""
    if C < 32:
        return next(n for n in (16, 32, 64, 128) if 4 * C <= n), [(0, C)]
    return 128, [(c0, min(32, C - c0)) for c0 in range(0, C, 32)]


GATE_BODIES = ("wgmma", "mma_sync")
#: The narrowest layer of the gate convs' wgmma body: below it one block of
#: the mma.sync body holds all 4C gate outputs (the pixel layers).
GATE_WGMMA_MIN_C = 32
#: R_above's box of coarse pixels a chunk in the wgmma body's shared memory
#: (``csrc/gate_convs_wgmma.cu``'s ``COARSE_PX``): at least
#: :func:`coarse_box`'s pixels for every tile of :func:`.convlstm_fused.tile_shapes`.
COARSE_PIXELS = 104


def gate_body(C: int, compute_dtype: torch.dtype, tma: bool) -> str:
    """The gate convs' body from the layer's channels, the compute dtype and
    whether the TMA can address every source (channels a multiple of 8):
    ``"wgmma"`` in bfloat16 compute at C >= :data:`GATE_WGMMA_MIN_C`, else
    ``"mma_sync"``."""
    if compute_dtype == torch.bfloat16 and C >= GATE_WGMMA_MIN_C and tma:
        return "wgmma"
    return "mma_sync"


def coarse_box(tile_h: int, tile_w: int):
    """R_above's box in coarse pixels (rows, columns) for a ``tile_h x
    tile_w`` tile of the wgmma body: the coarse rows ``(y0 - 1) >> 1 ..
    (y0 + tile_h) >> 1`` its halo reads, whatever the parity of ``y0``, and
    the same along x."""
    return tile_h // 2 + 2, tile_w // 2 + 2


#: The wgmma body's time a block at each channel group, relative: measured
#: on an H100 at the north star's layers 1-3, every group at the same tile
#: (``scripts/fused_breakdown.py --body gates --cg``).  N 128 runs a ring of
#: four chunks and N 64 two blocks an SM, so neither costs in proportion
#: to N against N 192.
GATE_GROUP_COST = {48: 192, 32: 113, 16: 63}


def _gate_cost(H: int, W: int, C: int, cg: int, shape):
    """The wgmma body's cost of one image at channel group ``cg`` and tile
    ``shape``: its blocks, each :data:`GATE_GROUP_COST` (without the waves,
    which follow the batch); then the tile pixels computed past the image's
    edges; then the wider tile."""
    th, tw, _ = shape
    tiles = -(-H // th) * -(-W // tw)
    return tiles * -(-C // cg) * GATE_GROUP_COST[cg], tiles * th * tw, -tw


@functools.lru_cache(maxsize=None)
def gate_plan(H: int, W: int, C: int, compute_dtype: torch.dtype = torch.bfloat16,
              tma: bool = True) -> Plan:
    """The gate convs' launch at a layer of ``H x W`` and C channels: the
    body of :func:`gate_body`; on the wgmma body the channel group and tile
    (:func:`.convlstm_fused.tile_shapes`) of the least :func:`_gate_cost`;
    on the mma.sync body its strip width for one image (``cg`` is then its
    block's channels, :func:`gate_groups`).  Never from the batch: a shard
    of a batch takes the plan of the whole."""
    if gate_body(C, compute_dtype, tma) == "wgmma":
        cg, shape = min(((cg, s) for cg in CHANNEL_GROUPS for s in tile_shapes(W)),
                        key=lambda cs: _gate_cost(H, W, C, *cs))
        return Plan("wgmma", cg, *shape)
    return Plan("mma_sync", gate_groups(C)[0] // 4, 0, tile_width(1, H, W), 0)


def launch_gates(srcs, wks, b, compute_dtype, stream: int, plan: Optional[Plan] = None):
    """Run the gate convs' kernel on device tensors at ``plan`` (default
    :func:`gate_plan`; another plan of the same body sums every pixel in
    the same order).  Returns the gates ``(B, H, W, 4C)`` in the compute
    dtype.  Counts nothing: the wrapper does."""
    B, H, W, C = srcs[1].shape
    xs, args = _source_args(srcs, wks)
    tma = all(x.shape[3] % 8 == 0 for x in xs)
    plan = gate_plan(H, W, C, compute_dtype, tma) if plan is None else plan
    if plan.body == "wgmma" and gate_body(C, compute_dtype, tma) != "wgmma":
        raise ValueError(f"the gate convs' wgmma body does not take C {C}, sources "
                         f"{[x.shape[3] for x in xs]} in {compute_dtype}")
    if plan.body == "mma_sync" and not 1 <= plan.tile_w <= W:
        raise ValueError(f"strip width {plan.tile_w} outside 1..{W}")
    bias = b.contiguous()
    gates = torch.empty(B, H, W, 4 * C, dtype=compute_dtype, device=b.device)
    args += [len(xs), bias.data_ptr(), int(bias.dtype == torch.bfloat16)]
    lib = _build.library()
    if plan.body == "wgmma":
        rc = lib.eigen_gate_convs_wgmma(*args, gates.data_ptr(), B, H, W, C, plan.cg,
                                        plan.tile_h, plan.tile_w, plan.wg_stride, stream)
    else:
        rc = lib.eigen_gate_convs(*args, int(compute_dtype == torch.bfloat16), gates.data_ptr(),
                                  B, H, W, C, plan.tile_w, stream)
    if rc != 0:
        raise RuntimeError(f"gate_convs kernel ({plan.body} body) launch failed: CUDA error {rc}")
    return gates


def gate_convs(srcs: Sequence[torch.Tensor], wks: Sequence[torch.Tensor], b: torch.Tensor, *,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A layer's split gate convs, as the ``True`` route sums them: the
    kernel of :func:`gate_plan`'s body (counted by body on
    ``body_launches``) on CUDA tensors, the plain version
    :func:`gate_convs_plain` on CPU tensors.  Each pixel is summed in one
    order whatever the batch.

    Args:
      srcs: E ``(B, H, W, 2C)``, R ``(B, H, W, C)`` and optionally R_above
        ``(B, H/2, W/2, C_above)`` (not upsampled); rounded to bfloat16.
      wks: their weights in the kernel layout ``(9, C, 4, Cin)``, bfloat16.
      b: ``(4C,)`` bias, float32 or bfloat16, cast to the compute dtype.
      compute_dtype: float32 or bfloat16.
    Returns:
      the gates ``(B, H, W, 4C)``, gate-major ``[i | f | o | g]``, in the
      compute dtype.
    Raises:
      RuntimeError: as :func:`narrow_convlstm_layer`.
    """
    if len(srcs) < 2 or srcs[1].dim() != 4:
        raise ValueError("need E, R and optionally R_above, each (B, H, W, Cin)")
    B, H, W, C = srcs[1].shape
    _check_sources(srcs, wks, b, B, H, W, C, compute_dtype)
    refuse_grad("gate_convs", *srcs, *wks, b)
    with debug_nans.scope("gate_convs"):
        if b.device.type == "cpu":
            return gate_convs_plain(srcs, wks, b, compute_dtype=compute_dtype)
        if b.device.type != "cuda":
            raise ValueError(f"unsupported device {b.device}")
        stream = kernel_stream("gate_convs", b.device)
        plan = gate_plan(H, W, C, compute_dtype, all(x.shape[3] % 8 == 0 for x in srcs))
        gates = launch_gates(srcs, wks, b, compute_dtype, stream, plan=plan)
        count_launch(gate_convs)
        if not torch.cuda.is_current_stream_capturing():
            gate_convs.body_launches[plan.body] += 1
        debug_nans.check("gate_convs", gates)
        return gates


gate_convs.launches = 0
gate_convs.captured = 0
gate_convs.body_launches = dict.fromkeys(GATE_BODIES, 0)  # launches by body
