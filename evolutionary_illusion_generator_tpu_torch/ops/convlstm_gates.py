"""ConvLSTM gate nonlinearities and cell update: CUDA kernel and plain version.

The CUDA counterpart of the JAX package's
``ops/convlstm_pallas.py::fused_lstm_gates`` (Pallas body ``_gates_kernel``).
Gate order [i, f, o, g]:

    c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g),   h = sigmoid(o) * tanh(c)

The kernel is ``csrc/lstm_gates.cu``.  It is bound by bytes on the H100:
one thread per (pixel, channel) reads each operand once and writes h and c
once (see the note in the source).  Its public contract is the JAX
function's: float32 gates in, float32 (h, c) out.  It also reads bfloat16
gates and writes h and c in bfloat16 (``out_dtype``), rounded to nearest even
from the same float32 values.  It is the epilogue of the split gate
convolutions on the routes whose gates arrive precomputed (the s2d pixel
layer, ``subpixel_up``, ``use_pallas=True``): it takes their bfloat16 sum
as it is and writes the bfloat16 state, so no float32 copy of the gates
and no state cast runs around it.  On the main path's narrow layers
:func:`.convlstm_narrow.narrow_convlstm_layer` does the same math in one
kernel with the convolutions.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils import debug_nans

__all__ = ["count_launch", "fused_lstm_gates", "kernel_stream", "lstm_gates_plain", "refuse_grad"]


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


def _launch(gates: torch.Tensor, c_prev: torch.Tensor, stream: int,
            out_dtype: torch.dtype = torch.float32):
    """Run ``csrc/lstm_gates.cu`` on device tensors; returns (h, c)."""
    for name, t in (("gates", gates), ("c_prev", c_prev)):
        if t.dtype not in _TYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not (gates.is_contiguous() and c_prev.is_contiguous()):
        raise ValueError("gates and c_prev must be contiguous")
    h = torch.empty(c_prev.shape, dtype=out_dtype, device=c_prev.device)
    c = torch.empty_like(h)
    B, H, W, C = c_prev.shape
    bf16 = torch.bfloat16
    rc = _build.library().eigen_lstm_gates(
        gates.data_ptr(), int(gates.dtype == bf16), c_prev.data_ptr(), int(c_prev.dtype == bf16),
        h.data_ptr(), c.data_ptr(), int(out_dtype == bf16), B * H * W, C, stream,
    )
    if rc != 0:
        raise RuntimeError(f"lstm_gates kernel launch failed: CUDA error {rc}")
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
    """ConvLSTM cell update; the kernel on a CUDA tensor, the plain version
    on a CPU tensor.

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
        out = _launch(gates, c_prev, kernel_stream("fused_lstm_gates", gates.device),
                      out_dtype)
        count_launch(fused_lstm_gates)
        debug_nans.check("fused_lstm_gates", *out)
        return out


fused_lstm_gates.launches = 0  # kernel launches (not plain-version calls)
fused_lstm_gates.captured = 0  # kernels recorded into a CUDA graph (count_launch)
