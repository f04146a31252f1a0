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

Math, in the order of ``model._conv`` and the ops after it: the 3x3 SAME
conv of bfloat16 inputs and weights with float32 sums, rounded to the
compute dtype (float32 or bfloat16); ``+ b`` in the compute dtype; the
activation; for Ahat, ``ahat - a`` and ``a - ahat`` in the compute dtype,
each through ReLU, written in the state dtype.  Weights are packed once per
params (:func:`pack_unit_weight`, the ``ahat_k`` and ``a_k`` entries of
bfloat16 params) in the layout the shared ``eigen::igemm`` loop reads.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..utils import debug_nans
from .convlstm_fused import TILE_PIXELS, tile_width
from .convlstm_gates import count_launch, kernel_stream, refuse_grad

__all__ = [
    "COMPUTE_DTYPES",
    "DIRECT_MAX_C",
    "POOL_TILES",
    "STATE_DTYPES",
    "a_unit",
    "a_unit_plain",
    "ahat_error_unit",
    "ahat_error_unit_plain",
    "launch_a",
    "launch_ahat",
    "pack_unit_weight",
    "pool_tile_width",
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


def launch_ahat(r, ahat_k, ahat_b, a, layer0, compute_dtype, state_dtype, stream: int,
                tw: Optional[int] = None):
    """Run ``csrc/prednet_units.cu``'s Ahat unit on device tensors with strip
    width ``tw`` (default :func:`.convlstm_fused.tile_width`; the batch's
    rows one tiling); returns (E, prediction or ``None``).  Counts nothing:
    the wrapper does."""
    B, H, W, C = r.shape
    tw = tile_width(B, H, W) if tw is None else tw
    if not 1 <= tw <= W:
        raise ValueError(f"strip width {tw} outside 1..{W}")
    x = r.to(torch.bfloat16).contiguous()
    a, bias = a.contiguous(), ahat_b.contiguous()
    e = torch.empty(B, H, W, 2 * C, dtype=state_dtype, device=r.device)
    pred = torch.empty(B, H, W, C, device=r.device) if layer0 else None
    bf16 = torch.bfloat16
    rc = _build.library().eigen_ahat_error_unit(
        x.data_ptr(), ahat_k.contiguous().data_ptr(), C, C, bias.data_ptr(),
        int(bias.dtype == bf16), a.data_ptr(), e.data_ptr(),
        None if pred is None else pred.data_ptr(), int(layer0), int(compute_dtype == bf16),
        int(state_dtype == bf16), B, H, W, tw, stream,
    )
    if rc != 0:
        raise RuntimeError(f"ahat_error_unit kernel launch failed: CUDA error {rc}")
    return e, pred


def launch_a(e, a_k, a_b, compute_dtype, stream: int, tw: Optional[int] = None):
    """Run ``csrc/prednet_units.cu``'s A unit on device tensors with strip
    width ``tw`` (one of :data:`POOL_TILES`, default :func:`pool_tile_width`;
    tiles inside one image); returns the pooled A in the compute dtype."""
    B, H, W, cin = e.shape
    cout = a_b.shape[0]
    tw = pool_tile_width(H, W) if tw is None else tw
    if tw % 2 or TILE_PIXELS % (2 * tw):
        raise ValueError(f"strip width {tw}: the A unit's tiles need an even width whose "
                         f"{TILE_PIXELS}-pixel tiles hold an even number of rows")
    out = torch.empty(B, H // 2, W // 2, cout, dtype=compute_dtype, device=e.device)
    if out.numel() == 0:
        return out
    x = e.to(torch.bfloat16).contiguous()
    bias = a_b.contiguous()
    rc = _build.library().eigen_a_unit(
        x.data_ptr(), a_k.contiguous().data_ptr(), cin, cout, bias.data_ptr(),
        int(bias.dtype == torch.bfloat16), out.data_ptr(),
        int(compute_dtype == torch.bfloat16), B, H, W, tw, stream,
    )
    if rc != 0:
        raise RuntimeError(f"a_unit kernel launch failed: CUDA error {rc}")
    return out


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
        e, pred = launch_ahat(r, ahat_k, ahat_b, a, layer0, compute_dtype, state_dtype,
                              kernel_stream(name, r.device))
        count_launch(ahat_error_unit)
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
        out = launch_a(e, a_k, a_b, compute_dtype, kernel_stream(name, e.device))
        count_launch(a_unit)
        debug_nans.check(name, out)
        return out


ahat_error_unit.launches = 0  # kernel launches (not plain-version calls)
ahat_error_unit.captured = 0  # kernels recorded into a CUDA graph (count_launch)
a_unit.launches = 0
a_unit.captured = 0
