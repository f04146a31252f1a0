"""The PredNet A and Ahat units as two kernels: CUDA kernels and plain versions.

The bottom-up half of a PredNet step (``models/prednet/model.py``, the JAX
package's ``prednet_step`` after its ConvLSTM updates) is, per layer ``l``::

    Ahat_l  = SatLU(conv(R_l) + b)  at l = 0,  ReLU(conv(R_l) + b) above
    E_l     = [ReLU(Ahat_l - A_l); ReLU(A_l - Ahat_l)]
    A_{l+1} = maxpool2(ReLU(conv(E_l) + b))

XLA fuses each chain in the reference.  The port ran them as a cuDNN conv
and five to seven eager ops each; ``csrc/prednet_units.cu`` runs each chain
as one kernel, :func:`ahat_error_unit` (conv of R, bias, SatLU or ReLU,
both differences and their ReLU, E written as ``[pos; neg]``, and at the
pixel layer the float32 prediction) and :func:`a_unit` (conv of E, bias,
ReLU and the 2x2 max-pool: only the pooled A leaves the block).  They
replace no TPU kernel: the JAX package leaves these ops to XLA.

Their second purpose is a fixed summation order.  cuDNN picks its
algorithm by shape, so a row of a batch of 8 may be summed in another order
than the same row of a batch of 16, and the sharded evaluator's shards
drifted from the unsharded pass by one bfloat16 ulp there.  The kernels sum
every output pixel's products in one order (chunks of 16 input channels,
then the 9 taps, then the 16 products of one ``mma``; at the pixel layer's
Ahat unit, C <= :data:`DIRECT_MAX_C`, one float32 chain in (ky, kx, ci)
order on the CUDA cores), whatever the batch, the tile or the plan.

Each unit has several bodies, and the host's plan (:func:`ahat_plan`,
:func:`a_plan`) picks one per launch from the layer's shape and types
alone, never from the batch, a pointer's alignment or a failure (the
bodies may round a 16-product dot differently, and a shard has the
unsharded pass's H, W and C but a smaller B):

- ``"wgmma"`` (``csrc/prednet_units_wgmma.cu``; bfloat16 compute, input
  channels a multiple of 8): warpgroup products over a TMA-fed halo slab,
  N = every output of the layer (or channel groups of N where that fills
  more SMs), the weights multicast across a cluster of two blocks; a block
  owns a ``tile_h`` x ``tile_w`` rectangle of one image
  (``convlstm_fused.tile_shapes``; even for the A unit's pooling);
- ``"im2col"`` (the same file; the A unit at the pixel layer, bfloat16
  compute, at most :data:`IM2COL_MAX_CIN` input channels): each pixel's
  9 Cin products laid out as one K row of up to 64, summed by four
  ``wgmma`` k16 steps in one accumulator;
- ``"mma_sync"`` (``csrc/prednet_units.cu``; float32 compute, and channel
  counts the TMA cannot address): ``mma.sync`` over 128-pixel strips, Kahan
  sums per tap in float32 compute;
- ``"direct"`` (``csrc/prednet_units.cu``; the Ahat unit at C <=
  :data:`DIRECT_MAX_C`): the CUDA cores, one thread a pixel.

Each wrapper counts its launches per body (``body_launches``) beside
``launches``.

Math, in the order of ``model._conv`` and the ops after it: the 3x3 SAME
conv of bfloat16 inputs and weights with float32 sums, rounded to the
compute dtype (float32 or bfloat16); ``+ b`` in the compute dtype; the
activation; for Ahat, ``ahat - a`` and ``a - ahat`` in the compute dtype,
each through ReLU, written in the state dtype.  Weights are packed once per
params (:func:`pack_unit_weight`, the ``ahat_k`` and ``a_k`` entries of
bfloat16 params) in the ``(9, Cp, Cin)`` layout every body reads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .. import _build
from ..utils import debug_nans
from .convlstm_fused import SMS, TILE_PIXELS, tile_shapes, tile_width
from .convlstm_gates import count_launch, kernel_stream, refuse_grad

__all__ = [
    "BODIES",
    "COMPUTE_DTYPES",
    "DIRECT_MAX_C",
    "IM2COL_MAX_CIN",
    "IM2COL_TILES",
    "POOL_TILES",
    "STATE_DTYPES",
    "UNIT_N",
    "UnitPlan",
    "a_plan",
    "a_unit",
    "a_unit_plain",
    "ahat_error_unit",
    "ahat_error_unit_plain",
    "ahat_plan",
    "launch_a",
    "launch_ahat",
    "pack_unit_weight",
    "pool_tile_width",
    "unit_body",
    "unpack_unit_weight",
]

#: The compute dtypes the kernels round their sums to.
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
#: The state dtypes the Ahat unit writes E in.
STATE_DTYPES = (torch.float32, torch.bfloat16)
#: The Ahat unit at C <= DIRECT_MAX_C (the pixel layer: 3 colour or 1 grey
#: channel) runs on the CUDA cores, one thread a pixel, each sum a float32
#: chain in (ky, kx, ci) order, the order of PyTorch's CPU conv; wider
#: layers take the tensor cores.
DIRECT_MAX_C = 4
#: Strip widths of the A unit's tiles: even, and a tile of TILE_PIXELS
#: pixels holds an even number of whole strip rows, so every 2x2 pooling
#: quad lies inside one tile.
POOL_TILES = (4, 8, 16, 32, 64)


def pack_unit_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO ``(3, 3, Cin, Cout)`` conv kernel -> the kernels' bfloat16
    ``(9, Cp, Cin)`` layout, Cp = Cout rounded up to a multiple of 4 with
    zero rows: the ``(9, Cp / 4, 4, Cin)`` layout ``eigen::igemm`` reads
    gate weights in, output ``n`` at row ``n``."""
    kh, kw, cin, cout = w_hwio.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"need a (3, 3, Cin, Cout) kernel, got {tuple(w_hwio.shape)}")
    w = w_hwio.to(torch.bfloat16).reshape(9, cin, cout).permute(0, 2, 1)
    out = w.new_zeros(9, -(-cout // 4) * 4, cin)
    out[:, :cout] = w
    return out


def unpack_unit_weight(wk: torch.Tensor, cout: int) -> torch.Tensor:
    """Kernel layout ``(9, Cp, Cin)`` -> OIHW ``(Cout, Cin, 3, 3)``,
    contiguous."""
    _, _, cin = wk.shape
    return wk[:, :cout].permute(1, 2, 0).reshape(cout, cin, 3, 3).contiguous()


def pool_tile_width(H: int, W: int) -> int:
    """The A unit's strip width for an ``(H, W)`` image (its tiles do not
    cross images): the fewest blocks, then the smallest halo slab, then the
    wider strip, among :data:`POOL_TILES`."""
    def cost(tw):
        tile_rows = TILE_PIXELS // tw
        blocks = -(-W // tw) * -(-H * tw // TILE_PIXELS)
        return blocks, (tile_rows + 2) * (tw + 2), -tw

    return min((tw for tw in POOL_TILES if tw <= max(W, POOL_TILES[0])), key=cost)


# ---- the plan: which body, at which tiling -------------------------------------

BODIES = ("wgmma", "im2col", "mma_sync", "direct")
#: Outputs a block of the wgmma and im2col bodies (wgmma.m64nNk16): the
#: layer's every output where one N holds them, else channel groups.
UNIT_N = (48, 64, 96, 192)
#: The A unit's im2col body takes E of at most this many channels (9 Cin
#: products <= 64, four k16 steps): the pixel layer's 2 C0.
IM2COL_MAX_CIN = 7
#: The im2col body's tile widths; a tile is 128 pixels, 128 / tile_w rows.
IM2COL_TILES = (16, 32, 64)
#: The im2col body's grid-stride grid: at most this many blocks an SM
#: (about 39 KB of shared memory a block at N 48, so five are resident;
#: eight measured fastest at the north star on the H100,
#: scripts/units_breakdown.py --plans), and at least
#: IM2COL_TILES_PER_BLOCK tiles a block, over which it keeps its weight.
IM2COL_BLOCKS_PER_SM = 8
IM2COL_TILES_PER_BLOCK = 2
#: The wgmma body's blocks resident on an SM at each N (shared memory: a
#: ring of 67, 81, 108 and 192 KB; registers: 57, 73, 105 and 201 a thread,
#: ptxas on the H100).
UNIT_BLOCKS_PER_SM = {48: 3, 64: 2, 96: 2, 192: 1}
#: The blocks of a cluster sharing each weight slice at each N, for the
#: Ahat unit: four at N 48 (2-8% faster than two at the main path's and the
#: north star's layers on the H100, scripts/units_breakdown.py --plans),
#: two at wider N (four gained nothing there).  The A unit takes two at
#: every N: with four, chip_smoke.py timed it slower than the mma.sync body
#: at the main path's layers 1 and 2.
UNIT_CLUSTER = {48: 4, 64: 2, 96: 2, 192: 2}
A_UNIT_CLUSTER = 2
#: The plan's cost of a block, in outputs: its products (N) plus the halo
#: slab's staging (STAGING_COST), which co-resident blocks run side by
#: side, and a part that a block alone cannot overlap (the ring's first
#: load, the epilogue: FIXED_COST), which another block on the SM hides.
#: Fitted to a sweep of every plan at the main path's and the north star's
#: layers on the H100 (scripts/units_breakdown.py --plans: two groups of 96
#: beat one of 192 at north-star layer 2, whose 192-wide block is alone on
#: its SM).
STAGING_COST = 32
FIXED_COST = 192


class UnitPlan(NamedTuple):
    """How one launch of a unit covers its layer.  ``body`` is one of
    :data:`BODIES`.  wgmma: a block owns ``tile_h`` x ``tile_w`` output
    pixels of one image and ``n`` outputs, its two warpgroups' M rows
    ``wg_stride`` halo-slab positions apart (``convlstm_fused.block_rows``),
    ``cluster`` (2 or 4) blocks of neighbouring tiles sharing each weight
    slice.
    im2col: a block walks tiles of ``tile_h`` x ``tile_w`` = 128 pixels,
    ``blocks`` blocks along the tiles, ``n`` outputs.  mma_sync: the strip
    width ``tile_w``.  direct: nothing to choose."""

    body: str
    n: int = 0
    tile_h: int = 0
    tile_w: int = 0
    wg_stride: int = 0
    blocks: int = 0
    cluster: int = 0


def unit_body(unit: str, cin: int, cout: int, compute_dtype: torch.dtype) -> str:
    """The body of ``unit`` (``"ahat"`` or ``"a"``) at a layer, from its
    channels and compute dtype alone (every body writes both state dtypes):
    the Ahat unit at C <= :data:`DIRECT_MAX_C` on the CUDA cores; in
    bfloat16 compute the A unit at Cin <= :data:`IM2COL_MAX_CIN` on the
    im2col body and any unit whose input channels the TMA can address (a
    multiple of 8) on the wgmma body; the rest (float32 compute: Kahan sums
    per tap take 1.5 N registers a thread) on the mma.sync body.  At every
    layer of the main path and the north star the new bodies measured
    faster than the mma.sync body on the H100, so no shape keeps it."""
    if unit not in ("ahat", "a"):
        raise ValueError(f"unit must be 'ahat' or 'a', got {unit!r}")
    if unit == "ahat" and cout <= DIRECT_MAX_C:
        return "direct"
    if compute_dtype == torch.bfloat16:
        if unit == "a" and cin <= IM2COL_MAX_CIN:
            return "im2col"
        if cin % 8 == 0:
            return "wgmma"
    return "mma_sync"


def _n_groups(cout: int):
    """The N of each channel-group count that fits: the fewest columns
    past ``cout`` for 1, 2, 4 ... groups."""
    out = {}
    for n in UNIT_N:
        groups = -(-cout // n)
        if groups not in out or n < out[groups]:
            out[groups] = n
    return sorted((n, g) for g, n in out.items())


@functools.lru_cache(maxsize=None)
def unit_tiles(W: int, pool: bool):
    """The wgmma body's tiles at image width ``W``: ``convlstm_fused``'s
    (:func:`.convlstm_fused.tile_shapes`); for the A unit (``pool``) even
    widths, each taking the even number of rows below its own, so that
    every 2x2 quad lies in one tile."""
    shapes = []
    for th, tw, ws in tile_shapes(W):
        if pool:
            th -= th % 2
            if tw % 2 or th < 2:
                continue
        shapes.append((th, tw, ws))
    return tuple(shapes)


def _wgmma_plan(B, H, W, cout, pool):
    def cost(choice):
        (n, groups), (th, tw, _) = choice
        tiles = B * -(-H // th) * -(-W // tw)
        cluster = A_UNIT_CLUSTER if pool else UNIT_CLUSTER[n]
        tiles = -(-tiles // cluster) * cluster  # a cluster's padding blocks
        k = UNIT_BLOCKS_PER_SM[n]
        wave = max(k * (n + STAGING_COST), n + STAGING_COST + FIXED_COST)
        return (-(-tiles * groups // (SMS * k)) * wave, tiles * th * tw, groups * n, -tw)

    (n, _), (th, tw, ws) = min(((ng, s) for ng in _n_groups(cout) for s in unit_tiles(W, pool)),
                               key=cost)
    return UnitPlan("wgmma", n, th, tw, ws, cluster=A_UNIT_CLUSTER if pool else UNIT_CLUSTER[n])


def _im2col_plan(B, H, W, cout):
    n = min((n for n in UNIT_N if n >= cout), default=UNIT_N[-1])

    def tiles(tw):
        return B * -(-H // (TILE_PIXELS // tw)) * -(-W // tw)

    tw = min(IM2COL_TILES, key=lambda tw: (tiles(tw), abs(tw - 32)))
    return UnitPlan("im2col", n, TILE_PIXELS // tw, tw, 0,
                    max(1, min(tiles(tw) // IM2COL_TILES_PER_BLOCK, SMS * IM2COL_BLOCKS_PER_SM)))


@functools.lru_cache(maxsize=None)
def ahat_plan(B: int, H: int, W: int, C: int,
              compute_dtype: torch.dtype = torch.bfloat16) -> UnitPlan:
    """The Ahat unit's launch at ``(B, H, W, C)``: the body of
    :func:`unit_body`; on the wgmma body the channel groups and tile of the
    fewest waves of blocks over the SMs (:data:`UNIT_BLOCKS_PER_SM` an SM,
    a wave costing its blocks' products and staging side by side, or one
    block's with :data:`FIXED_COST`, whichever is more), then the fewest
    tile pixels past the image's edges; on the mma.sync body the strip width
    :func:`.convlstm_fused.tile_width` (the batch's rows one tiling).  The
    batch moves only the tiling, under which a pixel's sums do not move."""
    body = unit_body("ahat", C, C, compute_dtype)
    if body == "wgmma":
        return _wgmma_plan(B, H, W, C, pool=False)
    if body == "mma_sync":
        return UnitPlan("mma_sync", tile_w=tile_width(B, H, W))
    return UnitPlan(body)


@functools.lru_cache(maxsize=None)
def a_plan(B: int, H: int, W: int, cin: int, cout: int,
           compute_dtype: torch.dtype = torch.bfloat16) -> UnitPlan:
    """The A unit's launch: the body of :func:`unit_body`; wgmma as
    :func:`ahat_plan` over :func:`unit_tiles`' even tiles; im2col the
    :data:`IM2COL_TILES` width of the fewest tiles, then the nearest to 32
    columns, its grid at most :data:`IM2COL_BLOCKS_PER_SM` blocks an SM
    and :data:`IM2COL_TILES_PER_BLOCK` tiles a block;
    mma.sync
    :func:`pool_tile_width` (each image its own tiling)."""
    body = unit_body("a", cin, cout, compute_dtype)
    if body == "wgmma":
        return _wgmma_plan(B, H, W, cout, pool=True)
    if body == "im2col":
        return _im2col_plan(B, H, W, cout)
    return UnitPlan("mma_sync", tile_w=pool_tile_width(H, W))


# ---- plain versions -------------------------------------------------------


def ahat_error_unit_plain(r: torch.Tensor, ahat_w: torch.Tensor, ahat_b: torch.Tensor,
                          a: torch.Tensor, *, layer0: bool, compute_dtype: torch.dtype,
                          state_dtype: torch.dtype, cudnn: bool = True, jnp_clip: bool = False):
    """Plain PyTorch version, and ``prednet_step``'s Ahat and error units on
    the routes without the kernel: ``model._conv`` of R with the OIHW weight
    ``ahat_w`` and ``+ b`` in the compute dtype, SatLU at ``layer0`` else
    ReLU, the concatenated ReLUs of both differences.  ``cudnn`` is
    ``model._conv``'s and ``jnp_clip`` ``model._satlu``'s (the plain route,
    which the trainer differentiates, passes ``cudnn=False, jnp_clip=True``).
    Returns (E in ``state_dtype``, the float32 prediction at ``layer0`` else
    ``None``)."""
    # imported here: the model imports this module
    from ..models.prednet.model import _conv, _satlu

    ahat = _conv(r, ahat_w, ahat_b, compute_dtype, cudnn=cudnn)
    ahat = _satlu(ahat, jnp_clip) if layer0 else torch.relu(ahat)
    e = torch.cat([torch.relu(ahat - a), torch.relu(a - ahat)], dim=-1)
    return e.to(state_dtype), ahat.float() if layer0 else None


def a_unit_plain(e: torch.Tensor, a_w: torch.Tensor, a_b: torch.Tensor, *,
                 compute_dtype: torch.dtype, cudnn: bool = True) -> torch.Tensor:
    """Plain PyTorch version, and ``prednet_step``'s A unit on the routes
    without the kernel: ``maxpool2(relu(model._conv(e, a_w, a_b)))`` with
    the OIHW weight ``a_w`` (``cudnn`` is ``model._conv``'s).  Returns A of
    the layer above, ``(B, H // 2, W // 2, Cout)`` in the compute dtype."""
    from ..models.prednet.model import _conv, _maxpool2

    return _maxpool2(torch.relu(_conv(e, a_w, a_b, compute_dtype, cudnn=cudnn)))


# ---- checks and launches ----------------------------------------------------


def _check_conv(name, x, wk, b, cout, compute_dtype):
    if x.dim() != 4:
        raise ValueError(f"{name}: input must be (B, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    if tuple(b.shape) != (cout,) or b.dtype not in STATE_DTYPES:
        raise ValueError(f"{name}: bias must be ({cout},) float32 or bfloat16, got "
                         f"{tuple(b.shape)} {b.dtype}")
    cp = -(-cout // 4) * 4
    if tuple(wk.shape) != (9, cp, cin) or wk.dtype != torch.bfloat16:
        raise ValueError(f"{name}: weight {tuple(wk.shape)} {wk.dtype} is not the bfloat16 "
                         f"kernel layout (9, {cp}, {cin})")
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{name}: compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")


def _same_device(name, *tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {sorted(map(str, devices))}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the TMA's rule): copied into a
    fresh allocation where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_ahat(r, ahat_k, ahat_b, a, layer0, compute_dtype, state_dtype, stream: int,
                plan: Optional[UnitPlan] = None):
    """Run the Ahat unit's kernel on device tensors at ``plan`` (default
    :func:`ahat_plan`); returns (E, prediction or ``None``).  A plan of
    another body than the shape's sums in another order (``chip_smoke.py``
    times the mma.sync body beside the wgmma body so).  Counts nothing: the
    wrapper does."""
    B, H, W, C = r.shape
    plan = ahat_plan(B, H, W, C, compute_dtype) if plan is None else plan
    if plan.body == "wgmma" and compute_dtype != torch.bfloat16:
        raise ValueError("the wgmma body computes in bfloat16")
    if plan.body == "mma_sync" and not 1 <= plan.tile_w <= W:
        raise ValueError(f"strip width {plan.tile_w} outside 1..{W}")
    x = _aligned(r.to(torch.bfloat16))
    a, bias, wk = _aligned(a), ahat_b.contiguous(), _aligned(ahat_k)
    e = torch.empty(B, H, W, 2 * C, dtype=state_dtype, device=r.device)
    pred = torch.empty(B, H, W, C, device=r.device) if layer0 else None
    bf16 = torch.bfloat16
    lib = _build.library()
    args = (x.data_ptr(), wk.data_ptr(), C, C, bias.data_ptr(), int(bias.dtype == bf16),
            a.data_ptr(), e.data_ptr(), None if pred is None else pred.data_ptr(), int(layer0))
    if plan.body == "wgmma":
        rc = lib.eigen_ahat_error_unit_wgmma(*args, int(state_dtype == bf16), B, H, W, plan.n,
                                             plan.tile_h, plan.tile_w, plan.wg_stride,
                                             plan.cluster, stream)
    else:  # mma_sync and direct: one entry, which takes the direct body at C <= DIRECT_MAX_C
        rc = lib.eigen_ahat_error_unit(*args, int(compute_dtype == bf16),
                                       int(state_dtype == bf16), B, H, W,
                                       plan.tile_w if plan.body == "mma_sync" else 1, stream)
    if rc != 0:
        raise RuntimeError(f"ahat_error_unit kernel ({plan.body} body) launch failed: "
                           f"CUDA error {rc}")
    return e, pred


def launch_a(e, a_k, a_b, compute_dtype, stream: int, plan: Optional[UnitPlan] = None):
    """Run the A unit's kernel on device tensors at ``plan`` (default
    :func:`a_plan`; as :func:`launch_ahat`); returns the pooled A in the
    compute dtype."""
    B, H, W, cin = e.shape
    cout = a_b.shape[0]
    plan = a_plan(B, H, W, cin, cout, compute_dtype) if plan is None else plan
    if plan.body in ("wgmma", "im2col") and compute_dtype != torch.bfloat16:
        raise ValueError(f"the {plan.body} body computes in bfloat16")
    if plan.body == "mma_sync" and (plan.tile_w % 2 or TILE_PIXELS % (2 * plan.tile_w)):
        raise ValueError(f"strip width {plan.tile_w}: the A unit's tiles need an even width "
                         f"whose {TILE_PIXELS}-pixel tiles hold an even number of rows")
    out = torch.empty(B, H // 2, W // 2, cout, dtype=compute_dtype, device=e.device)
    if out.numel() == 0:
        return out
    x = _aligned(e.to(torch.bfloat16))
    bias, wk = a_b.contiguous(), _aligned(a_k)
    lib = _build.library()
    args = (x.data_ptr(), wk.data_ptr(), cin, cout, bias.data_ptr(),
            int(bias.dtype == torch.bfloat16), out.data_ptr())
    if plan.body == "wgmma":
        rc = lib.eigen_a_unit_wgmma(*args, B, H, W, plan.n, plan.tile_h, plan.tile_w,
                                    plan.wg_stride, plan.cluster, stream)
    elif plan.body == "im2col":
        rc = lib.eigen_a_unit_im2col(*args, B, H, W, plan.n, plan.tile_w, plan.blocks, stream)
    else:
        rc = lib.eigen_a_unit(*args, int(compute_dtype == torch.bfloat16), B, H, W, plan.tile_w,
                              stream)
    if rc != 0:
        raise RuntimeError(f"a_unit kernel ({plan.body} body) launch failed: CUDA error {rc}")
    return out


def _counted(wrapper, plan):
    """Counts a launch on ``wrapper`` (:func:`.convlstm_gates.count_launch`)
    and on its ``body_launches`` by ``plan``'s body, outside a capture."""
    count_launch(wrapper)
    if not torch.cuda.is_current_stream_capturing():
        wrapper.body_launches[plan.body] += 1


# ---- wrappers ---------------------------------------------------------------


def ahat_error_unit(r: torch.Tensor, ahat_k: torch.Tensor, ahat_b: torch.Tensor,
                    a: torch.Tensor, *, layer0: bool,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    state_dtype: torch.dtype = torch.bfloat16,
                    ahat_w: Optional[torch.Tensor] = None):
    """The Ahat and error units of one layer; the kernel on CUDA tensors,
    the plain version on CPU tensors.

    Args:
      r: ``(B, H, W, C)`` the layer's new R, any float dtype (rounded to
        bfloat16, as ``model._conv`` rounds it to the weights' dtype).
      ahat_k: the Ahat conv's weight in the kernel layout ``(9, Cp, C)``,
        bfloat16 (:func:`pack_unit_weight`).
      ahat_b: ``(C,)`` bias, float32 or bfloat16, cast to the compute dtype.
      a: ``(B, H, W, C)`` the layer's A (the frame at layer 0) in the
        compute dtype.
      layer0: SatLU (clamp to [0, 1]) and the prediction, else ReLU.
      compute_dtype: float32 or bfloat16.
      state_dtype: float32 or bfloat16, the dtype of E.
      ahat_w: the same weight in OIHW, which the plain version takes
        (unpacked from ``ahat_k`` where it is not given).
    Returns:
      (E ``(B, H, W, 2C)`` ``[pos; neg]`` in ``state_dtype``, the float32
      prediction ``(B, H, W, C)`` at ``layer0`` else ``None``).
    Raises:
      RuntimeError: an input requires a gradient in grad mode, or the
        tensors are on a CUDA device that is not the current one.
    """
    name = "ahat_error_unit"
    _check_conv(name, r, ahat_k, ahat_b, r.shape[-1], compute_dtype)
    if tuple(a.shape) != tuple(r.shape) or a.dtype != compute_dtype:
        raise ValueError(f"{name}: A {tuple(a.shape)} {a.dtype} is not "
                         f"{tuple(r.shape)} {compute_dtype}")
    if state_dtype not in STATE_DTYPES:
        raise TypeError(f"{name}: state_dtype must be float32 or bfloat16, got {state_dtype}")
    _same_device(name, r, ahat_k, ahat_b, a)
    refuse_grad(name, r, ahat_k, ahat_b, a)
    with debug_nans.scope(name):
        if r.device.type == "cpu":
            if ahat_w is None:
                ahat_w = unpack_unit_weight(ahat_k, ahat_b.shape[0])
            return ahat_error_unit_plain(r, ahat_w, ahat_b, a, layer0=layer0,
                                         compute_dtype=compute_dtype, state_dtype=state_dtype)
        if r.device.type != "cuda":
            raise ValueError(f"unsupported device {r.device}")
        B, H, W, C = r.shape
        plan = ahat_plan(B, H, W, C, compute_dtype)
        e, pred = launch_ahat(r, ahat_k, ahat_b, a, layer0, compute_dtype, state_dtype,
                              kernel_stream(name, r.device), plan)
        _counted(ahat_error_unit, plan)
        debug_nans.check(name, e, *(() if pred is None else (pred,)))
        return e, pred


def a_unit(e: torch.Tensor, a_k: torch.Tensor, a_b: torch.Tensor, *,
           compute_dtype: torch.dtype = torch.bfloat16,
           a_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The A unit of one layer: A of the layer above from its E; the kernel
    on CUDA tensors, the plain version on CPU tensors.

    Args:
      e: ``(B, H, W, 2C)`` the layer's E, any float dtype (rounded to
        bfloat16).
      a_k: the A conv's weight in the kernel layout ``(9, Cp, 2C)``,
        bfloat16 (:func:`pack_unit_weight`).
      a_b: ``(Cout,)`` bias, float32 or bfloat16, cast to the compute dtype.
      compute_dtype: float32 or bfloat16, the dtype of the result.
      a_w: the same weight in OIHW, which the plain version takes
        (unpacked from ``a_k`` where it is not given).
    Returns:
      ``(B, H // 2, W // 2, Cout)``: odd H or W are floored, as
      ``F.max_pool2d`` floors them.
    Raises:
      RuntimeError: as :func:`ahat_error_unit`.
    """
    name = "a_unit"
    _check_conv(name, e, a_k, a_b, a_b.shape[0], compute_dtype)
    _same_device(name, e, a_k, a_b)
    refuse_grad(name, e, a_k, a_b)
    with debug_nans.scope(name):
        if e.device.type == "cpu":
            if a_w is None:
                a_w = unpack_unit_weight(a_k, a_b.shape[0])
            return a_unit_plain(e, a_w, a_b, compute_dtype=compute_dtype)
        if e.device.type != "cuda":
            raise ValueError(f"unsupported device {e.device}")
        B, H, W, cin = e.shape
        plan = a_plan(B, H, W, cin, a_b.shape[0], compute_dtype)
        out = launch_a(e, a_k, a_b, compute_dtype, kernel_stream(name, e.device), plan)
        _counted(a_unit, plan)
        debug_nans.check(name, out)
        return out


# kernel launches (not plain-version calls), kernels recorded into a CUDA
# graph (count_launch), and the launches by body
for _fn in (ahat_error_unit, a_unit):
    _fn.launches = _fn.captured = 0
    _fn.body_launches = dict.fromkeys(BODIES, 0)
del _fn
