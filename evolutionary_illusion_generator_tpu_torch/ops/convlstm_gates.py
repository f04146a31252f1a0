"""ConvLSTM gate nonlinearities and cell update: CUDA kernel and plain version.

The CUDA counterpart of the JAX package's
``ops/convlstm_pallas.py::fused_lstm_gates`` (Pallas body ``_gates_kernel``).
Gate order [i, f, o, g]:

    c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g),   h = sigmoid(o) * tanh(c)

The kernel is ``csrc/lstm_gates.cu``, with three bodies that compute the
same bits (one float32 function of the five operands, rounded only at the
store), picked per launch by :func:`gates_plan` from the shape, the types
and the pointers' alignment:

- ``"vector"``: C a multiple of :func:`vector_width` and every pointer
  16-byte aligned (the ``True`` route's layers 1-3, C 48, 96 and 192): a
  thread takes that many channels of one pixel straight into registers;
- ``"slab"``: any C and alignment (the pixel layers, C 1 and 3, and the
  s2d pixel layer's 12): each warp stages slabs of pixels in shared memory
  through its own ``cp.async`` ring and stores h and c back as 16-byte
  runs;
- ``"scalar"``: the first body, one thread per (pixel, channel) with a
  64-bit division each; the reference the others are held against on the
  card, and the plan's body where a call is too small for the others'
  ramp (:data:`SCALAR_MAX_ELEMENTS`).

The streaming bodies run a persistent grid of :data:`SMS` times the blocks
an SM holds.  Its public contract is the JAX function's: float32 gates in,
float32 (h, c) out.  It also reads bfloat16 gates and writes h and c in
bfloat16 (``out_dtype``), rounded to nearest even from the same float32
values.  It is the epilogue of the split gate convolutions on the routes
whose gates arrive precomputed (the s2d pixel layer, ``subpixel_up``,
``use_pallas=True``): it takes their bfloat16 sum as it is and writes the
bfloat16 state, so no float32 copy of the gates and no state cast runs
around it.  On the main path's narrow layers
:func:`.convlstm_narrow.narrow_convlstm_layer` does the same math in one
kernel with the convolutions.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch

from .. import _build
from ..utils import debug_nans

__all__ = ["BODIES", "GatesPlan", "body_plans", "count_launch", "fused_lstm_gates",
           "gates_plan", "kernel_stream", "lstm_gates_plain", "refuse_grad", "slab_smem",
           "vector_width"]


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel wrapper would be differentiated: grad mode is on
    and an input requires a gradient.  The kernels have no backward (nor do
    the JAX package's Pallas kernels), and their outputs carry no
    ``grad_fn``, so a loss through them would leave the weights before them
    without a gradient and say nothing.  Checked on every device, the CPU's
    plain versions included, so the CPU tests see what the card does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires a gradient.  Differentiate "
            "prednet_step(..., use_pallas=False), or call the kernel under torch.no_grad()"
        )


def lstm_gates_plain(gates: torch.Tensor, c_prev: torch.Tensor, *,
                     out_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version: the same math in float32.

    Args:
      gates: (B, H, W, 4C) pre-activations, any float dtype.
      c_prev: (B, H, W, C) previous cell state, any float dtype.
      out_dtype: dtype of h and c, cast from the float32 results.
    Returns:
      (h, c), both (B, H, W, C) in ``out_dtype``.
    """
    i, f, o, g = gates.float().split(c_prev.shape[-1], dim=-1)
    c = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h.to(out_dtype), c.to(out_dtype)


_TYPES = (torch.float32, torch.bfloat16)


def _check(gates: torch.Tensor, c_prev: torch.Tensor, out_dtype: torch.dtype) -> None:
    if gates.dim() != 4 or c_prev.dim() != 4:
        raise ValueError(f"need NHWC tensors, got {tuple(gates.shape)} and {tuple(c_prev.shape)}")
    if gates.shape[:3] != c_prev.shape[:3] or gates.shape[3] != 4 * c_prev.shape[3]:
        raise ValueError(
            f"gates {tuple(gates.shape)} do not match c_prev {tuple(c_prev.shape)}"
        )
    if gates.device != c_prev.device:
        raise ValueError(f"gates on {gates.device}, c_prev on {c_prev.device}")
    if out_dtype not in _TYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


BODIES = ("scalar", "vector", "slab")
_BODY_CODES = {body: code for code, body in enumerate(BODIES)}  # the C entry's ``body``
SMS = 132  # the H100's SMs
SMEM_PER_SM = 233472  # an SM's shared memory for blocks (228 KB)
SMEM_RESERVED = 1024  # shared memory the card keeps a block
SMEM_PER_BLOCK = 232448  # a block's shared memory at most (the kernel refuses more)
STREAM_THREADS = 256  # threads a block of the streaming bodies
SLAB_WARPS = STREAM_THREADS // 32  # the slab body's warps a block, each with its own ring
#: The calls at or below this many (pixel, channel) elements take the
#: scalar body, whose single pass ramps faster than a persistent grid: on an
#: H100 the main path's pixel layer (8 x 120 x 160 x 3, 6.45 MB in
#: bfloat16) and its s2d pixel layer took 0.0084-0.0098 ms on the scalar
#: body against 0.0094-0.0138 on the slab body, while at twice the elements
#: (8 x 30 x 40 x 96) the vector body took 0.0081-0.0085 against 0.0098
#: (``scripts/gates_breakdown.py --plans``).
SCALAR_MAX_ELEMENTS = 8 * 120 * 160 * 3
#: The slab body's slab, a warp's, in elements (pixels times C, the pixels
#: rounded up to a multiple of 16 so that every slab starts on the granule
#: the first one starts on), and its ring's stages.
SLAB_ELEMENTS = 384
SLAB_RING = 2
#: Blocks an SM of each streaming body, at most: the grid is :data:`SMS`
#: times this (the slab body's also within :data:`SMEM_PER_SM`), or fewer
#: where the call has fewer blocks of work.
BLOCKS_PER_SM = {"vector": 4, "slab": 4}


class GatesPlan(NamedTuple):
    """How one launch covers the call.  ``body`` is one of :data:`BODIES`;
    the slab body's slabs of ``slab_pixels`` pixels through a ring of
    ``ring`` stages; ``grid`` blocks for the streaming bodies (the scalar
    body sets its own)."""

    body: str
    slab_pixels: int = 0
    ring: int = 0
    grid: int = 0


def vector_width(gate_dtype: torch.dtype, state_dtype: torch.dtype,
                 out_dtype: torch.dtype) -> int:
    """Channels a thread of the vector body takes: 8 where gates, state and
    outputs are all bfloat16 (16 bytes each), else 4 (16 bytes of each
    float32 tensor, 8 of a bfloat16 one)."""
    return 8 if gate_dtype == state_dtype == out_dtype == torch.bfloat16 else 4


def _stage_bytes(nbytes: int) -> int:
    return -(-nbytes // 16) * 16 + 16  # lstm_gates.cu's stage_bytes


def slab_smem(slab_pixels: int, C: int, gate_dtype: torch.dtype, state_dtype: torch.dtype,
              out_dtype: torch.dtype, ring: int) -> int:
    """The slab body's shared memory a block in bytes: for each of its
    :data:`SLAB_WARPS` warps, ``ring`` stages of a slab's gates and state,
    then its h and c, each region 16 bytes longer than its data, which
    lands at the global address's offset in its 16-byte granule."""
    pc = slab_pixels * C
    size = (lambda dt: torch.tensor([], dtype=dt).element_size())
    return SLAB_WARPS * (
        ring * (_stage_bytes(4 * pc * size(gate_dtype)) + _stage_bytes(pc * size(state_dtype)))
        + 2 * _stage_bytes(pc * size(out_dtype)))


#: The bodies in the plan's order of preference, where each takes the call.
PREFERENCE = ("vector", "slab", "scalar")


def body_plans(npix: int, C: int, gate_dtype: torch.dtype = torch.bfloat16,
               state_dtype: torch.dtype = torch.bfloat16, out_dtype: torch.dtype = torch.bfloat16,
               aligned: bool = True) -> Dict[str, GatesPlan]:
    """Every body that takes a call, with its launch: the scalar body
    always; the vector body where C is a multiple of
    :func:`vector_width`, the pointers are aligned and the vectors count
    below 2**31; the slab body with slabs of about :data:`SLAB_ELEMENTS`
    elements a warp, halved until a block's shared memory holds its warps'
    rings (none where not even one pixel's does).  The streaming bodies'
    grid is :data:`SMS` times :data:`BLOCKS_PER_SM`, or the blocks of work
    where there are fewer."""
    out = {"scalar": GatesPlan("scalar")}
    n = npix * C
    V = vector_width(gate_dtype, state_dtype, out_dtype)
    if aligned and C % V == 0 and n // V < 2**31:
        blocks = -(-(n // V) // STREAM_THREADS)
        out["vector"] = GatesPlan("vector", grid=min(blocks, SMS * BLOCKS_PER_SM["vector"]))
    P = -(-(-(-SLAB_ELEMENTS // C)) // 16) * 16
    while P > 1 and slab_smem(P, C, gate_dtype, state_dtype, out_dtype, SLAB_RING) > SMEM_PER_BLOCK:
        P //= 2  # wide C off alignment: smaller slabs, each with its own head and tail
    smem = slab_smem(P, C, gate_dtype, state_dtype, out_dtype, SLAB_RING)
    if smem <= SMEM_PER_BLOCK:
        per_sm = max(1, min(BLOCKS_PER_SM["slab"], SMEM_PER_SM // (smem + SMEM_RESERVED)))
        out["slab"] = GatesPlan("slab", P, SLAB_RING,
                                min(-(-npix // P // SLAB_WARPS), SMS * per_sm))
    return out


@functools.lru_cache(maxsize=None)
def gates_plan(npix: int, C: int, gate_dtype: torch.dtype = torch.bfloat16,
               state_dtype: torch.dtype = torch.bfloat16, out_dtype: torch.dtype = torch.bfloat16,
               aligned: bool = True) -> GatesPlan:
    """A launch's plan from the shape, the types and whether the gates and
    the state start on 16-byte boundaries (h and c are fresh allocations,
    which do): the scalar body up to :data:`SCALAR_MAX_ELEMENTS`, else the
    first body of :data:`PREFERENCE` that takes the call
    (:func:`body_plans`)."""
    if npix * C <= SCALAR_MAX_ELEMENTS:
        return GatesPlan("scalar")
    plans = body_plans(npix, C, gate_dtype, state_dtype, out_dtype, aligned)
    return plans[next(body for body in PREFERENCE if body in plans)]


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(gates: torch.Tensor, c_prev: torch.Tensor, stream: int,
            out_dtype: torch.dtype = torch.float32, plan: Optional[GatesPlan] = None):
    """Run ``csrc/lstm_gates.cu`` on device tensors at ``plan`` (default
    :func:`gates_plan`; every plan computes the same bits); returns (h, c).
    Counts nothing: the wrapper does."""
    for name, t in (("gates", gates), ("c_prev", c_prev)):
        if t.dtype not in _TYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not (gates.is_contiguous() and c_prev.is_contiguous()):
        raise ValueError("gates and c_prev must be contiguous")
    h = torch.empty(c_prev.shape, dtype=out_dtype, device=c_prev.device)
    c = torch.empty_like(h)
    B, H, W, C = c_prev.shape
    if plan is None:
        plan = gates_plan(B * H * W, C, gates.dtype, c_prev.dtype, out_dtype,
                          _aligned(gates, c_prev))
    bf16 = torch.bfloat16
    rc = _build.library().eigen_lstm_gates(
        gates.data_ptr(), int(gates.dtype == bf16), c_prev.data_ptr(), int(c_prev.dtype == bf16),
        h.data_ptr(), c.data_ptr(), int(out_dtype == bf16), B * H * W, C,
        _BODY_CODES[plan.body], plan.slab_pixels, plan.ring, plan.grid, stream,
    )
    if rc != 0:
        raise RuntimeError(f"lstm_gates kernel ({plan.body} body, {plan}) launch failed: "
                           f"CUDA error {rc}")
    return h, c


def kernel_stream(name: str, device: torch.device) -> int:
    """The current stream of ``device``, for a launch of ``name``'s kernel
    on tensors there.  ``cudaLaunchKernel`` and a CUDA-graph capture go to
    the *current* CUDA device, not to the one the tensors are on, so a
    kernel on tensors of another device would read and write them through
    the wrong device's context: raise instead.  Run a shard's pass under
    ``torch.cuda.device(shard_device)``, as the sharded evaluator does."""
    current = torch.cuda.current_device()
    if device.index != current:
        raise RuntimeError(
            f"{name}: tensors on {device}, but the current CUDA device is cuda:{current}; "
            f"call it under torch.cuda.device({device})")
    return torch.cuda.current_stream(device).cuda_stream


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel, on its ``launches``.  While the
    stream is being captured into a CUDA graph the kernel is only recorded
    (it runs at the graph's replays, which count nothing): that goes on
    ``wrapper.captured``."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def fused_lstm_gates(gates: torch.Tensor, c_prev: torch.Tensor, *,
                     out_dtype: torch.dtype = torch.float32):
    """ConvLSTM cell update; the kernel on a CUDA tensor (the body of
    :func:`gates_plan`, counted on ``body_launches``), the plain version on
    a CPU tensor.

    Args:
      gates: (B, H, W, 4C) pre-activations (conv output), float32 or
        bfloat16.
      c_prev: (B, H, W, C) previous cell state, float32 or bfloat16.
      out_dtype: float32 (the JAX function's contract) or bfloat16.
    Returns:
      (h, c), both (B, H, W, C) in ``out_dtype``.
    Raises:
      RuntimeError: an input requires a gradient in grad mode
        (:func:`refuse_grad`), or the tensors are on a CUDA device that is
        not the current one (:func:`kernel_stream`).
    """
    _check(gates, c_prev, out_dtype)
    refuse_grad("fused_lstm_gates", gates, c_prev)
    with debug_nans.scope("fused_lstm_gates"):
        if gates.device.type == "cpu":
            return lstm_gates_plain(gates, c_prev, out_dtype=out_dtype)
        if gates.device.type != "cuda":
            raise ValueError(f"unsupported device {gates.device}")
        B, H, W, C = c_prev.shape
        plan = gates_plan(B * H * W, C, gates.dtype, c_prev.dtype, out_dtype,
                          _aligned(gates, c_prev))
        out = _launch(gates, c_prev, kernel_stream("fused_lstm_gates", gates.device),
                      out_dtype, plan)
        count_launch(fused_lstm_gates)
        if not torch.cuda.is_current_stream_capturing():
            fused_lstm_gates.body_launches[plan.body] += 1
        debug_nans.check("fused_lstm_gates", *out)
        return out


fused_lstm_gates.launches = 0  # kernel launches (not plain-version calls)
fused_lstm_gates.captured = 0  # kernels recorded into a CUDA graph (count_launch)
fused_lstm_gates.body_launches = dict.fromkeys(BODIES, 0)  # launches by body
