"""PredNet: the predictive-coding ConvLSTM stack, in PyTorch.

The port of the JAX package's ``models/prednet/model.py`` (``init_params``,
``init_state``, ``quantize_params_int8``, ``prednet_step``, ``rollout``,
``rollout_flow_frames``).  Architecture per layer ``l`` (channels
``[c, 48, 96, 192]`` color):

  top-down, l = L-1..0:
    R_l, c_l <- ConvLSTM_l(E_l(t-1), R_l(t-1), upsample2(R_{l+1}(t)))
  bottom-up, l = 0..L-1 with A_0 = input frame:
    Ahat_l = ReLU(conv(R_l))        (SatLU clip to [0,1] at l=0)
    E_l    = concat[ReLU(Ahat_l - A_l), ReLU(A_l - Ahat_l)]
    A_{l+1}= maxpool2(ReLU(conv(E_l)))
  prediction = Ahat_0

Tensors are NHWC at every public function, as in the JAX package; the
``F.conv2d`` calls take ``permute(0, 3, 1, 2)`` views, whose channels-last
strides cuDNN takes as they are.

:func:`prednet_step`'s ``use_pallas`` names the JAX route whose math the
ConvLSTM update computes (:func:`rollout` defaults to ``"fused"``, the
evaluator's route):

* ``"fused"`` (the port's default, the route of the evaluator, the probe
  and the compat shims), on the CUDA kernels:

  - layers with ``C >= 32`` and no peephole (layers 1-3 at
    ``3,48,96,192``): :func:`..ops.convlstm_fused.fused_convlstm_layer_multi`
    over E, R and the upsampled R_above — the JAX ``use_pallas="fused"``
    math: bfloat16 sources and weights, float32 accumulation and gates,
    ``h`` in the state dtype, ``c`` float32 then cast to the state dtype;
  - narrow layers (``C < 32``: layer 0, C = 3 or 1, and layer 1 of
    ``1,16,32,64``) with bfloat16 weights, a float32 or bfloat16 compute
    dtype, no s2d pixel layer and no ``subpixel_up``:
    :func:`..ops.convlstm_narrow.narrow_convlstm_layer`, one kernel over E,
    R and R_above read at half resolution — the JAX ``use_pallas=True``
    math (each source's conv in the compute dtype, their sum in it, float32
    gate math on the gates widened to float32, h and c cast to the state
    dtype);
  - other narrow layers: split ``F.conv2d`` gate convs in the compute
    dtype, then :func:`..ops.convlstm_gates.fused_lstm_gates` on their sum
    as it is, writing h and c in the state dtype — the same math, with the
    widening and the casts inside the gate kernel;
  - the A and Ahat units of every layer but the s2d pixel layer, with
    bfloat16 weights and a float32 or bfloat16 compute dtype:
    :func:`..ops.prednet_units.ahat_error_unit` (the Ahat conv, its
    activation, E and the prediction) and :func:`..ops.prednet_units.a_unit`
    (the A conv, ReLU and the max-pool), each one kernel summing every
    pixel in one order whatever the batch; the same math as the ops they
    replaced (``_conv`` and the ops after it);

* ``True``: split gate convs and the gate kernel on every layer, and the A
  and Ahat units' kernels as on ``"fused"`` (its SatLU is the same
  ``min(max(x, 0), 1)``); with bfloat16 weights, no s2d pixel layer and no
  ``subpixel_up``, the split convs are one kernel that writes the gates,
  :func:`..ops.convlstm_narrow.gate_convs` (each pixel summed in one order
  whatever the batch), the rest cuDNN's;
* ``False`` (the JAX default, which the trainer differentiates): split
  per-source ``F.conv2d`` gate convs in the compute dtype and the plain
  gate math (:func:`_lstm_gates`) in the gates' dtype, on every layer.
  It launches no kernel.

A layer with peepholes takes the plain gate math on every route.  On CUDA
tensors the wrappers launch their kernels; on CPU tensors they run
their plain versions.  No kernel has a backward (the JAX kernels have
no VJP either), so the wrappers refuse, on every device, inputs that
require a gradient while grad mode is on: a loss differentiated through
``"fused"`` or ``True`` raises instead of silently leaving the weights of
those layers without a gradient.  Train on ``use_pallas=False``
(:mod:`.train`).

The JAX package's layout options, off by default:

* ``s2d_l0``: the pixel layer's convs, state, frame and prediction in
  phase-major space-to-depth layout (:func:`_s2d`), with 3x3 kernels
  lifted to that layout (:func:`_s2d_kernel`); A_1 is the max over the
  four phase blocks of the lifted ``a_w`` conv.  Its gates are gate-major
  (:func:`_gate_major`), so the gate step is :func:`fused_lstm_gates` with
  C' = 4C on the ``"fused"`` and ``True`` routes, the plain gate math on
  ``False``.  The lifts are made once per params (:func:`with_layout_weights`);
* ``subpixel_up``: the top-down conv(upsample2(R_above)) of the layers on
  the split-conv route as four parity 2x2 convs at the coarse resolution
  (:func:`_upconv_subpixel`); layers on the fused kernel ignore it, as the
  JAX fused layers do;
* int8 params (:func:`quantize_params_int8`): every conv an int8 x int8
  product with exact int32 sums (:func:`_conv_q`), the plain gate math,
  no kernel; ``use_pallas``, ``subpixel_up`` and ``s2d_l0`` are dropped,
  as in JAX.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.convlstm_fused import fused_convlstm_layer_multi
from ...ops.convlstm_gates import fused_lstm_gates
from ...ops.convlstm_narrow import COMPUTE_DTYPES as NARROW_COMPUTE_DTYPES
from ...ops.convlstm_narrow import gate_convs, narrow_convlstm_layer
from ...ops.prednet_units import COMPUTE_DTYPES as UNIT_COMPUTE_DTYPES
from ...ops.prednet_units import STATE_DTYPES as UNIT_STATE_DTYPES
from ...ops.prednet_units import a_unit, a_unit_plain, ahat_error_unit, ahat_error_unit_plain
from ...utils import prng
from .loader import DERIVED_PREFIXES, PACKED_PREFIXES, PredNetParams, params_from_numpy

__all__ = [
    "FUSED_MIN_CHANNELS",
    "PredNetParams",
    "init_params",
    "init_state",
    "prednet_step",
    "quantize_params_int8",
    "rollout",
    "rollout_flow_frames",
    "with_layout_weights",
]

#: Layers at least this wide take the fused ConvLSTM kernel (the JAX
#: ``use_pallas="fused"`` gate, model.py ``C >= 32``).
FUSED_MIN_CHANNELS = 32


def _conv_init(key, shape) -> np.ndarray:
    """normal / sqrt(fan_in) in float32, the JAX ``_conv_init``."""
    fan_in = shape[0] * shape[1] * shape[2]
    return prng.normal(key, shape) * np.float32(1.0 / np.sqrt(fan_in))


def init_params(key, channels: Sequence[int] = (3, 48, 96, 192), kernel: int = 3,
                dtype=torch.bfloat16, peephole: bool = False, device=None) -> List[dict]:
    """Random PredNet parameters drawn as the JAX ``init_params`` draws
    them from the same key (:mod:`...utils.prng`; a :func:`..utils.prng.PRNGKey`),
    as port params on ``device`` (``None``: the card) through
    :func:`.loader.params_from_numpy`.  ``peephole=True`` adds zero
    per-channel peephole weights (w_ci, w_cf, w_co).  The port's convs are
    3x3 (``kernel=3``), as the CUDA kernels are."""
    if kernel != 3:
        raise ValueError(f"the port's PredNet convs are 3x3, got kernel={kernel}")
    L = len(channels)
    keys = prng.split(key, L * 3)
    layers = []
    for l in range(L):
        C = channels[l]
        in_ch = 3 * C + (channels[l + 1] if l + 1 < L else 0)
        layer = {
            "lstm_w": _conv_init(keys[3 * l], (kernel, kernel, in_ch, 4 * C)),
            "lstm_b": np.zeros(4 * C, np.float32),
            "ahat_w": _conv_init(keys[3 * l + 1], (kernel, kernel, C, C)),
            "ahat_b": np.zeros(C, np.float32),
        }
        if peephole:
            for k in ("w_ci", "w_cf", "w_co"):
                layer[k] = np.zeros(C, np.float32)
        if l + 1 < L:
            layer["a_w"] = _conv_init(keys[3 * l + 2], (kernel, kernel, 2 * C, channels[l + 1]))
            layer["a_b"] = np.zeros(channels[l + 1], np.float32)
        layers.append(layer)
    return params_from_numpy(layers, dtype, device)


# CPU scalars, which binary ops take beside tensors on any device
_ZERO, _ONE = torch.zeros(()), torch.ones(())


def init_state(batch: int, h: int, w: int,
               channels: Sequence[int] = (3, 48, 96, 192),
               dtype=torch.bfloat16, device=None, s2d_l0: bool = False) -> List[dict]:
    """Zero recurrent state: per layer (r, c, e) at 1/2^l resolution.  With
    ``s2d_l0`` the pixel layer's tensors are space-to-depth packed,
    (B, h/2, w/2, 4C)."""
    state = []
    for l, C in enumerate(channels):
        hl, wl = h // (2**l), w // (2**l)
        if l == 0 and s2d_l0:
            hl, wl, C = hl // 2, wl // 2, 4 * C
        state.append({
            "r": torch.zeros(batch, hl, wl, C, dtype=dtype, device=device),
            "c": torch.zeros(batch, hl, wl, C, dtype=dtype, device=device),
            "e": torch.zeros(batch, hl, wl, 2 * C, dtype=dtype, device=device),
        })
    return state


# ---- int8 ---------------------------------------------------------------

_LSTM_SLICES = ("lstm_w_e", "lstm_w_r", "lstm_w_up")


def _int8_scale(w32: torch.Tensor) -> torch.Tensor:
    """max |w| / 127 per output channel of an OIHW float32 kernel, at least
    1e-12.  Divided by a tensor: CUDA takes a division by a Python scalar
    as a product with its reciprocal, which is not the quotient JAX rounds."""
    amax = w32.abs().amax(dim=(1, 2, 3))
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)


def _quantize(w32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(w32 / s[:, None, None, None]), -127, 127).to(torch.int8)


def quantize_params_int8(params: Sequence[dict]) -> List[dict]:
    """Symmetric int8 quantization of every conv weight, per output channel
    (max |w| / 127), as the JAX ``quantize_params_int8``.

    The scale of the gate conv is taken over its whole fused kernel: the
    port's ``lstm_w_e`` / ``_r`` / ``_up`` slices share one ``lstm_w_s``,
    as the JAX slices of one ``lstm_w`` do.  Biases and peepholes keep
    their float dtype; the kernel-layout and derived weights are dropped
    (the int8 route launches no kernel)."""
    qp = []
    for layer in params:
        q = {k: v for k, v in layer.items()
             if not k.startswith(PACKED_PREFIXES + DERIVED_PREFIXES) and k not in _LSTM_SLICES}
        names = [k for k in _LSTM_SLICES if k in layer]
        s = _int8_scale(torch.cat([layer[k].float() for k in names], dim=1))
        for k in names:
            q[k] = _quantize(layer[k].float(), s)
        q["lstm_w_s"] = s
        for k in ("ahat_w", "a_w"):
            if k in layer:
                w32 = layer[k].float()
                q[k + "_s"] = _int8_scale(w32)
                q[k] = _quantize(w32, q[k + "_s"])
        qp.append(q)
    return qp


def _is_quantized(params) -> bool:
    return params[0]["lstm_w_e"].dtype == torch.int8


def _state_dtype(params) -> torch.dtype:
    """The recurrent state's dtype: the weights', or for int8 params the
    biases' (states stay floating point)."""
    w = params[0]["lstm_w_e"]
    return params[0]["lstm_b"].dtype if w.dtype == torch.int8 else w.dtype


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _int8_conv(xq: torch.Tensor, wq: torch.Tensor, pad_h=(1, 1)) -> torch.Tensor:
    """Exact SAME 3x3 conv of int8 NHWC ``xq`` with int8 OIHW ``wq``, int32
    sums: ``torch._int_mm`` on a 9-tap im2col.  K and N are padded with
    zeros to multiples of 8 and M past 16, as the CUDA ``_int_mm`` needs;
    the zeros leave the sums exact.  ``pad_h`` (top, bottom) pads the
    height instead of SAME's one row each (a band with its neighbours' halo
    rows takes 0 where a halo row stands)."""
    cout = wq.shape[0]
    xp = F.pad(xq, (0, 0, 1, 1, *pad_h))
    B, H, W, cin = xp.shape[0], xp.shape[1] - 2, xq.shape[2], xq.shape[3]
    cols = torch.stack([xp[:, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)],
                       dim=3)  # (B, H, W, 9, Cin)
    M, K = B * H * W, 9 * cin
    a = F.pad(cols.reshape(M, K), (0, _ceil8(K) - K, 0, max(M, 17) - M))
    w = F.pad(wq.permute(0, 2, 3, 1).reshape(cout, K), (0, _ceil8(K) - K, 0, _ceil8(cout) - cout))
    return torch._int_mm(a, w.t())[:M, :cout].reshape(B, H, W, cout)


def _activation_max(x):
    """max |x| over H, W and C, one per batch row: (N, 1, 1, 1)."""
    return x.abs().amax(dim=(1, 2, 3), keepdim=True)


def _activation_codes(x, amax=None):
    """The int8 codes of ``x`` and their scale, one per batch row (max |x|
    over H, W, C / 127, so a candidate's codes do not depend on its chunk's
    other rows).  XLA compiles the JAX ``max|x| / 127.0`` into a product
    with the float32 constant 1/127, so the compiled JAX program (the
    evaluator's, the probe's) quantises with that scale; the true quotient
    moves it by an ulp and rounds a few percent of E's codes the other way.
    ``amax`` (:func:`_activation_max` of a larger tensor ``x`` is part of:
    a band's, the whole frame's) replaces ``x``'s own."""
    if amax is None:
        amax = _activation_max(x)
    ascale = torch.clamp_min(amax * torch.full_like(amax, 1 / 127), 1e-12)  # (N, 1, 1, 1)
    return torch.clamp(torch.round(x / ascale), -127, 127).to(torch.int8), ascale


def _conv_q(x, wq, ws, b, out_dtype, amax=None, pad_h=(1, 1)):
    """int8 NHWC conv, the JAX ``_conv_q``: the activations quantised per
    batch row (:func:`_activation_codes`; ``amax`` as there), exact int8 x
    int8 -> int32 sums, dequantised with the per-output-channel weight
    scales ``ws``; ``b`` may be ``None``; ``pad_h`` as :func:`_int8_conv`'s."""
    xq, ascale = _activation_codes(x, amax)
    y = _int8_conv(xq, wq, pad_h).float() * (ascale.float() * ws)
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype)


# ---- convs ----------------------------------------------------------------


@contextlib.contextmanager
def _without_cudnn():
    """cuDNN off for the block, every other cuDNN setting left as it is
    (``torch.backends.cudnn.flags`` would reset them)."""
    cudnn = torch.backends.cudnn
    saved, cudnn.enabled = cudnn.enabled, False
    try:
        yield
    finally:
        cudnn.enabled = saved


def _conv(x, w, b, out_dtype, pad=None, cudnn=True):
    """NHWC conv of ``x`` rounded to the weight dtype, OIHW ``w``, output in
    ``out_dtype`` (the JAX ``_conv``: inputs in the weight dtype, result in
    ``preferred_element_type``).  Where either side is float32 the conv runs
    in float32, so bfloat16 weights with a float32 output keep float32 sums.
    SAME padding for a 3x3 ``w``; ``pad`` is an ``F.pad`` tuple instead.

    ``cudnn=False`` (the plain route's convs): a float32 conv on the card
    runs PyTorch's own CUDA conv, not cuDNN.  cuDNN's heuristics pick its FFT
    algorithm for some float32 shapes of that route (layer 3's Ahat conv at
    120x160, batch 2: an 18.4 GiB workspace and 0.25-0.42 s a call, against
    0.96 ms and 0.18 GiB without cuDNN on an H100).  PyTorch's conv is
    deterministic; the backward of a trained conv is chosen when it runs,
    under the trainer's deterministic cuDNN mode.  The CPU and the bfloat16
    convs are the same either way."""
    x = x.to(w.dtype)
    acc = torch.float32 if torch.float32 in (w.dtype, out_dtype) else w.dtype
    xn = x.permute(0, 3, 1, 2).to(acc)
    off = not cudnn and acc == torch.float32 and xn.is_cuda
    with _without_cudnn() if off else contextlib.nullcontext():
        if pad is None:
            y = F.conv2d(xn, w.to(acc), padding=1)
        else:
            y = F.conv2d(F.pad(xn, pad), w.to(acc))
    y = y.permute(0, 2, 3, 1).to(out_dtype)
    return y if b is None else y + b.to(out_dtype)


def _satlu(x, jnp_clip=False):
    """SatLU, the pixel layer's activation: ``x`` clamped to [0, 1].
    ``jnp_clip``: as ``jnp.clip``, min(max(x, 0), 1), whose gradient splits
    in half at either bound (clamp's would not): the plain route's, which
    the trainer differentiates."""
    return torch.minimum(torch.maximum(x, _ZERO), _ONE) if jnp_clip else x.clamp(0.0, 1.0)


def _upsample2(x):
    """Nearest-neighbour 2x upsample (NHWC)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def _subpixel_taps(w):
    """The four parity 2x2 kernels of :func:`_upconv_subpixel` from an OIHW
    3x3 ``w``: ``(4, Cout, Cin, 2, 2)`` at index ``2 * dy + dx``.  A fine
    output row of parity ``dy`` reads coarse rows ``(i - 1, i)`` with taps
    ``(w0, w1 + w2)`` (dy = 0) or ``(i, i + 1)`` with ``(w0 + w1, w2)``
    (dy = 1), and the same along x; the paired taps are summed in the
    weight dtype, as in JAX."""
    rows = [(w[:, :, 0], w[:, :, 1] + w[:, :, 2]), (w[:, :, 0] + w[:, :, 1], w[:, :, 2])]
    taps = []
    for dy in range(2):
        r0, r1 = rows[dy]
        for dx in range(2):
            if dx == 0:
                k00, k01 = r0[..., 0], r0[..., 1] + r0[..., 2]
                k10, k11 = r1[..., 0], r1[..., 1] + r1[..., 2]
            else:
                k00, k01 = r0[..., 0] + r0[..., 1], r0[..., 2]
                k10, k11 = r1[..., 0] + r1[..., 1], r1[..., 2]
            taps.append(torch.stack([torch.stack([k00, k01], -1),
                                     torch.stack([k10, k11], -1)], -2))
    return torch.stack(taps)


def _upconv_subpixel(x, taps, out_dtype, cudnn=True):
    """conv3x3(upsample2(x)) without the upsampled copy (the JAX
    ``_upconv_subpixel``): four 2x2 convs of the coarse ``x`` with the tap
    pairs of :func:`_subpixel_taps`, interleaved by parity.  Zero SAME
    padding commutes with the upsample; the padding of parity (dy, dx) is
    ``((1 - dy, dy), (1 - dx, dx))``.  ``cudnn`` as :func:`_conv`'s."""
    outs = [_conv(x, taps[2 * dy + dx], None, out_dtype, pad=(1 - dx, dx, 1 - dy, dy),
                  cudnn=cudnn)
            for dy in range(2) for dx in range(2)]
    b, h, w, c = outs[0].shape
    z = torch.stack(outs).reshape(2, 2, b, h, w, c).permute(2, 3, 0, 4, 1, 5)
    return z.reshape(b, 2 * h, 2 * w, c)


# ---- space-to-depth pixel layer (kernels HWIO, as in JAX) ------------------


def _s2d(x):
    """Space-to-depth(2), phase-major: (B, H, W, C) -> (B, H/2, W/2, 4C)
    with channel ``(2*dy + dx) * C + c`` holding pixel ``(2i+dy, 2j+dx, c)``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _d2s(x):
    """Inverse of :func:`_s2d`."""
    b, h2, w2, c4 = x.shape
    x = x.reshape(b, h2, w2, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h2, 2 * w2, c4 // 4)


def _s2d_kernel(w):
    """Lift an HWIO 3x3 SAME kernel to s2d space:
    ``conv(_s2d(x), K) == _s2d(conv(x, w))``.  Output phase ``(dy, dx)``
    tap ``u`` reads row ``2i + dy + u = 2(i + qy) + py``, so lifted tap
    ``qy`` of input phase ``py`` holds ``w[u]`` with ``u = 2 qy + py - dy``
    where that is in -1..1; every other entry is zero."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"need a 3x3 kernel, got {tuple(w.shape)}")
    K = w.new_zeros(3, 3, 4 * cin, 4 * cout)
    for dy, dx, py, px in np.ndindex(2, 2, 2, 2):
        for qy in (-1, 0, 1):
            u = 2 * qy + py - dy
            for qx in (-1, 0, 1):
                v = 2 * qx + px - dx
                if -1 <= u <= 1 and -1 <= v <= 1:
                    pi, po = (2 * py + px) * cin, (2 * dy + dx) * cout
                    K[qy + 1, qx + 1, pi:pi + cin, po:po + cout] = w[u + 1, v + 1]
    return K


def _s2d_kernel_tiled(w):
    """The lifted kernel for an input equal in all four phases (the
    upsampled R_above): its input-phase blocks summed, so
    ``conv(r_above, K) == conv(tile(r_above, 4), _s2d_kernel(w))``.  Summed
    in float32 in phase order and rounded once to the weight dtype, as
    ``jnp.sum`` does."""
    kh, kw, cin, cout = w.shape
    K = _s2d_kernel(w).reshape(kh, kw, 4, cin, 4 * cout).float()
    acc = K[:, :, 0]
    for phase in range(1, 4):
        acc = acc + K[:, :, phase]
    return acc.to(w.dtype)


def _tile4(b):
    """Bias of a phase-major s2d conv: the bias in each phase block."""
    return b.repeat(4)


def _gate_major(K):
    """Output channels of a lifted LSTM kernel from ``[phase][gate][c]`` to
    ``[gate][phase][c]``: split(4) of the gates then gives i/f/o/g with the
    4C phase-major channels of the cell state."""
    kh, kw, cin4, cout4 = K.shape
    C = cout4 // 16
    K = K.reshape(kh, kw, cin4, 4, 4, C).permute(0, 1, 2, 4, 3, 5)
    return K.reshape(kh, kw, cin4, cout4)


def _tile4_gate_major(b):
    """Bias of a gate-major s2d LSTM conv: each gate's block repeated
    across the four phases."""
    C = b.shape[0] // 4
    return b.reshape(4, 1, C).repeat(1, 4, 1).reshape(-1)


def _posneg_major_in(K):
    """Input channels of a lifted kernel from the phase-major error packing
    ``[phase][pos|neg][c]`` (what :func:`_s2d` of the full-resolution
    ``[pos; neg]`` gives) to ``[pos|neg][phase][c]``, what the s2d step's
    ``concat([relu(ahat - a), relu(a - ahat)])`` gives."""
    kh, kw, cin4, cout = K.shape
    c0 = cin4 // 8
    K = K.reshape(kh, kw, 4, 2, c0, cout).permute(0, 1, 3, 2, 4, 5)
    return K.reshape(kh, kw, cin4, cout)


def _hwio(w):
    return w.permute(2, 3, 1, 0)


def _oihw(w):
    return w.permute(3, 2, 0, 1).contiguous()


def _s2d_ok(params, h: int, w: int) -> bool:
    """Whether the s2d pixel layer applies, as in JAX: float weights, even
    sizes, and no spatial peephole at layer 0 (per-channel ones tile)."""
    if _is_quantized(params) or h % 2 or w % 2:
        return False
    w_ci = params[0].get("w_ci")
    return w_ci is None or w_ci.dim() != 3


def _s2d_weights(p) -> dict:
    """Layer 0's lifted weights (OIHW) and biases for the s2d route."""
    out = {
        "s2d_w_e": _oihw(_gate_major(_posneg_major_in(_s2d_kernel(_hwio(p["lstm_w_e"]))))),
        "s2d_w_r": _oihw(_gate_major(_s2d_kernel(_hwio(p["lstm_w_r"])))),
        "s2d_b": _tile4_gate_major(p["lstm_b"]),
        "s2d_ahat_w": _oihw(_s2d_kernel(_hwio(p["ahat_w"]))),
        "s2d_ahat_b": _tile4(p["ahat_b"]),
    }
    if "lstm_w_up" in p:
        out["s2d_w_up"] = _oihw(_gate_major(_s2d_kernel_tiled(_hwio(p["lstm_w_up"]))))
    if "a_w" in p:
        out["s2d_a_w"] = _oihw(_posneg_major_in(_s2d_kernel(_hwio(p["a_w"]))))
        out["s2d_a_b"] = _tile4(p["a_b"])
    return out


def with_layout_weights(params, *, s2d_l0: bool = False,
                        subpixel_up: bool = False) -> List[dict]:
    """``params`` with the weights the layout options derive from them,
    made once instead of every step: layer 0's lifted s2d kernels
    (``s2d_*``) and every layer's subpixel tap pairs (``sub_w_up``).  Int8
    params run neither option and come back as they are."""
    if _is_quantized(params):
        return list(params)
    out = [dict(p) for p in params]
    if s2d_l0 and "s2d_w_r" not in out[0]:
        out[0].update(_s2d_weights(out[0]))
    if subpixel_up:
        for p in out:
            if "lstm_w_up" in p and "sub_w_up" not in p:
                p["sub_w_up"] = _subpixel_taps(p["lstm_w_up"])
    return out


# ---- the step -------------------------------------------------------------


def _maxpool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _lstm_gates(gates, c_prev, peephole=None):
    """Gate math in the gates' dtype (the JAX ``_lstm_gates_jnp``), with the
    optional per-channel or spatial Hadamard peepholes (w_ci, w_cf, w_co)."""
    i, f, o, g = gates.split(gates.shape[-1] // 4, dim=-1)
    cp = c_prev.to(gates.dtype)

    def peep(name):
        w = peephole[name].to(gates.dtype)
        # spatial (H, W, C) peepholes at another resolution fall back to
        # their per-channel mean, as in the JAX package
        if w.dim() == 3 and tuple(w.shape[:2]) != tuple(cp.shape[1:3]):
            w = w.mean(dim=(0, 1))
        return w

    if peephole is not None:
        i = i + peep("w_ci") * cp
        f = f + peep("w_cf") * cp
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    c = f * cp + i * g
    if peephole is not None:
        o = o + peep("w_co") * c
    o = torch.sigmoid(o)
    return o * torch.tanh(c), c


def _gate_convs(p, s, r_above, cd, s2d_here, subpixel_up, cudnn=True):
    """The split gate convs of a layer off the fused kernel: E, R and
    R_above, in the compute dtype; ``cudnn`` as :func:`_conv`'s."""
    if s2d_here:
        gates = _conv(s["e"], p["s2d_w_e"], p["s2d_b"], cd, cudnn=cudnn)
        gates = gates + _conv(s["r"], p["s2d_w_r"], None, cd, cudnn=cudnn)
        if r_above is not None:  # the upsample is folded into the tiled kernel
            gates = gates + _conv(r_above, p["s2d_w_up"], None, cd, cudnn=cudnn)
        return gates
    gates = _conv(s["e"], p["lstm_w_e"], p["lstm_b"], cd, cudnn=cudnn)
    gates = gates + _conv(s["r"], p["lstm_w_r"], None, cd, cudnn=cudnn)
    if r_above is not None:
        if subpixel_up:
            gates = gates + _upconv_subpixel(r_above, p["sub_w_up"], cd, cudnn=cudnn)
        else:
            gates = gates + _conv(_upsample2(r_above), p["lstm_w_up"], None, cd, cudnn=cudnn)
    return gates


def prednet_step(params, state, frame, *, use_pallas: Union[bool, str] = "fused",
                 compute_dtype=torch.float32, subpixel_up: bool = False,
                 s2d_l0: bool = False):
    """One PredNet timestep.

    Args:
      params: from :mod:`.loader`, :func:`init_params` or
        :func:`quantize_params_int8`.
      state: per-layer dicts (r, c, e) from :func:`init_state`.
      frame: (B, H, W, C0) input in [0, 1] (``_s2d``-packed under ``s2d_l0``).
      use_pallas: the route of the ConvLSTM update (module docstring):
        ``"fused"`` (the kernels), ``True`` (the gate kernel on every
        layer) or ``False`` (plain and differentiable).
      compute_dtype: dtype of the split gate convs' outputs and the gate
        sums, the A / Ahat convs and the error units.
      subpixel_up: the split-conv layers' top-down conv as four coarse
        parity convs (:func:`_upconv_subpixel`).
      s2d_l0: the pixel layer in s2d layout.  The caller passes
        ``init_state(..., s2d_l0=True)`` and ``_s2d(frame)`` and gets an
        s2d-packed prediction (:func:`rollout` does both).
      Under ``s2d_l0`` or ``subpixel_up`` the params carry the weights
      :func:`with_layout_weights` derives (made once, not every step;
      :func:`rollout` and the evaluator make them); without them the step
      raises ``KeyError``.
    Returns:
      (new_state, prediction) with prediction (B, H, W, C0) float32
      ((B, H/2, W/2, 4 C0) under ``s2d_l0``).
    """
    if not (isinstance(use_pallas, bool) or use_pallas == "fused"):
        raise ValueError(f"use_pallas must be False, True or 'fused', got {use_pallas!r}")
    quantized = _is_quantized(params)
    if quantized:  # int8 params have their own conv route, as in JAX
        use_pallas, subpixel_up, s2d_l0 = False, False, False
    if s2d_l0 and "s2d_w_r" not in params[0]:
        raise KeyError("s2d_l0 needs layer 0's lifted weights (s2d_*): pass the params "
                       "through with_layout_weights(params, s2d_l0=True) once")
    if subpixel_up and any("lstm_w_up" in p and "sub_w_up" not in p for p in params):
        raise KeyError("subpixel_up needs the tap pairs (sub_w_up): pass the params "
                       "through with_layout_weights(params, subpixel_up=True) once")
    L = len(params)
    dtype = state[0]["r"].dtype
    cd = compute_dtype
    cudnn = use_pallas is not False  # the plain route's float32 convs run without it

    new_state = [dict(s) for s in state]
    r_above: Optional[torch.Tensor] = None
    for l in reversed(range(L)):
        s, p = state[l], params[l]
        s2d_here = s2d_l0 and l == 0
        C = s["r"].shape[-1]  # 4C under s2d: the packed width
        peephole = None
        if "w_ci" in p:
            peephole = {k: p[k] for k in ("w_ci", "w_cf", "w_co")}
            if s2d_here:  # per-channel peepholes tile to the phase-major carry
                peephole = {k: _tile4(v) if v.dim() == 1 else v for k, v in peephole.items()}
        if quantized:
            ws = p["lstm_w_s"]
            gates = _conv_q(s["e"].to(cd), p["lstm_w_e"], ws, p["lstm_b"], cd)
            gates = gates + _conv_q(s["r"].to(cd), p["lstm_w_r"], ws, None, cd)
            if r_above is not None:
                gates = gates + _conv_q(_upsample2(r_above).to(cd), p["lstm_w_up"], ws, None, cd)
            h, c = _lstm_gates(gates, s["c"], peephole)
        elif (use_pallas == "fused" and C >= FUSED_MIN_CHANNELS and peephole is None
              and not s2d_here):
            srcs = [s["e"].to(torch.bfloat16), s["r"].to(torch.bfloat16)]
            wks = [p["lstm_k_e"], p["lstm_k_r"]]
            if r_above is not None:
                srcs.append(_upsample2(r_above).to(torch.bfloat16))
                wks.append(p["lstm_k_up"])
            h, c = fused_convlstm_layer_multi(srcs, wks, p["lstm_b"], s["c"])
        elif (use_pallas == "fused" and peephole is None and not s2d_here and not subpixel_up
              and p["lstm_w_e"].dtype == torch.bfloat16 and cd in NARROW_COMPUTE_DTYPES
              and s["c"].dtype == dtype):
            # a narrow layer: the same math as the split convs + gate kernel
            # below, in one kernel that reads R_above at half resolution
            srcs, wks = [s["e"], s["r"]], [p["lstm_k_e"], p["lstm_k_r"]]
            if r_above is not None:
                srcs.append(r_above)
                wks.append(p["lstm_k_up"])
            h, c = narrow_convlstm_layer(srcs, wks, p["lstm_b"], s["c"], compute_dtype=cd)
        else:
            if (use_pallas is True and peephole is None and not s2d_here and not subpixel_up
                    and p["lstm_w_e"].dtype == torch.bfloat16 and cd in NARROW_COMPUTE_DTYPES):
                # the True route's dense layers: the same split convs, summed
                # in one order whatever the batch (cuDNN's were not)
                srcs, wks = [s["e"], s["r"]], [p["lstm_k_e"], p["lstm_k_r"]]
                if r_above is not None:
                    srcs.append(r_above)
                    wks.append(p["lstm_k_up"])
                gates = gate_convs(srcs, wks, p["lstm_b"], compute_dtype=cd)
            else:
                gates = _gate_convs(p, s, r_above, cd, s2d_here, subpixel_up, cudnn)
            if use_pallas is not False and peephole is None:
                h, c = fused_lstm_gates(gates.contiguous(), s["c"], out_dtype=dtype)
            else:
                h, c = _lstm_gates(gates, s["c"], peephole)
        new_state[l]["r"] = h.to(dtype)
        new_state[l]["c"] = c.to(dtype)
        r_above = new_state[l]["r"]

    a = frame.to(cd)
    prediction = None
    # the A and Ahat units' kernels, on both kernel routes: bfloat16
    # weights, the compute and state dtypes they round to; the s2d pixel
    # layer keeps its lifted convs
    units = (use_pallas is not False and not quantized and cd in UNIT_COMPUTE_DTYPES
             and dtype in UNIT_STATE_DTYPES and params[0]["ahat_w"].dtype == torch.bfloat16)
    for l in range(L):
        p = params[l]
        r = new_state[l]["r"]
        s2d_here = s2d_l0 and l == 0
        if s2d_here or quantized:  # their own convs
            if s2d_here:
                ahat = _conv(r, p["s2d_ahat_w"], p["s2d_ahat_b"], cd, cudnn=cudnn)
            else:
                ahat = _conv_q(r.to(cd), p["ahat_w"], p["ahat_w_s"], p["ahat_b"], cd)
            if l == 0:
                ahat = _satlu(ahat, jnp_clip=use_pallas is False)
                prediction = ahat.float()
            else:
                ahat = torch.relu(ahat)
            # under s2d: [pos (4 C0 phase-major); neg (4 C0)], which the
            # lifted consumers take through _posneg_major_in
            e_cd = torch.cat([torch.relu(ahat - a), torch.relu(a - ahat)], dim=-1)
            e = e_cd.to(dtype)
        else:
            unit = ahat_error_unit if units else ahat_error_unit_plain
            kw = (dict(ahat_w=p["ahat_w"]) if units
                  else dict(cudnn=cudnn, jnp_clip=use_pallas is False))
            e, pred = unit(r, p["ahat_k"] if units else p["ahat_w"], p["ahat_b"], a,
                           layer0=l == 0, compute_dtype=cd, state_dtype=dtype, **kw)
            if l == 0:
                prediction = pred
        new_state[l]["e"] = e
        if l + 1 < L:
            if s2d_here:
                # maxpool2(relu(conv(E0))) is the max over the four phase
                # blocks of the lifted conv, in layer 1's own layout
                c1 = p["a_w"].shape[0]
                r1 = torch.relu(_conv(e, p["s2d_a_w"], p["s2d_a_b"], cd, cudnn=cudnn))
                a = torch.maximum(torch.maximum(r1[..., :c1], r1[..., c1:2 * c1]),
                                  torch.maximum(r1[..., 2 * c1:3 * c1], r1[..., 3 * c1:]))
            elif quantized:
                a = _maxpool2(torch.relu(_conv_q(e_cd, p["a_w"], p["a_w_s"], p["a_b"], cd)))
            elif units:
                a = a_unit(e, p["a_k"], p["a_b"], compute_dtype=cd, a_w=p["a_w"])
            else:
                a = a_unit_plain(e, p["a_w"], p["a_b"], compute_dtype=cd, cudnn=cudnn)
    return new_state, prediction


def rollout(params, images, *, repeat: int = 20, extension: int = 2,
            collect: Tuple[int, ...] = (), use_pallas: Union[bool, str] = "fused",
            compute_dtype=torch.float32, subpixel_up: bool = False,
            s2d_l0: bool = False):
    """The reference's schedule: the image ``repeat`` times (open loop),
    then the model's own prediction fed back for ``extension`` steps.

    Args:
      images: (B, H, W, C0) float in [0, 1], one frame per candidate.
      collect: timesteps whose predictions to return.
      use_pallas, compute_dtype, subpixel_up, s2d_l0: as
        :func:`prednet_step`.  ``s2d_l0`` applies where the JAX gate
        ``_s2d_ok`` lets it (float params, even sizes, no spatial peephole
        at layer 0); the frames are packed once and only the collected
        predictions unpacked.
    Returns:
      dict: {"predictions": {t: (B, H, W, C0) float32}, "final_state": state}
    """
    B, H, W, C0 = images.shape
    channels = [p["ahat_w"].shape[0] for p in params]
    if channels[0] != C0:
        raise ValueError(f"images have {C0} channels, the predictor {channels[0]}")
    s2d_l0 = s2d_l0 and _s2d_ok(params, H, W)
    params = with_layout_weights(params, s2d_l0=s2d_l0, subpixel_up=subpixel_up)
    state = init_state(B, H, W, channels, dtype=_state_dtype(params),
                       device=images.device, s2d_l0=s2d_l0)
    frames = images.float()
    if s2d_l0:
        frames = _s2d(frames)
    unpack = _d2s if s2d_l0 else (lambda x: x)
    pred = frames
    saved = {}
    for t in range(repeat + extension):
        state, pred = prednet_step(
            params, state, frames if t < repeat else pred, use_pallas=use_pallas,
            compute_dtype=compute_dtype, subpixel_up=subpixel_up, s2d_l0=s2d_l0,
        )
        if t in collect:
            saved[t] = unpack(pred)
    return {"predictions": saved, "final_state": state}


def rollout_flow_frames(params, images, *, repeat: int = 20, extension: int = 2,
                        pair: str = "population", use_pallas: Union[bool, str] = "fused",
                        compute_dtype=torch.float32, subpixel_up: bool = False,
                        s2d_l0: bool = False):
    """The two frames the flow stage compares.

    * "population": prediction at t=repeat-1 vs the first extension frame;
    * "probe": the input image itself vs the second extension frame.
    """
    kw = dict(repeat=repeat, extension=extension, use_pallas=use_pallas,
              compute_dtype=compute_dtype, subpixel_up=subpixel_up, s2d_l0=s2d_l0)
    if pair == "population":
        out = rollout(params, images, collect=(repeat - 1, repeat), **kw)
        return out["predictions"][repeat - 1], out["predictions"][repeat]
    if pair == "probe":
        out = rollout(params, images, collect=(repeat + 1,), **kw)
        return images.float(), out["predictions"][repeat + 1]
    raise ValueError(f"unknown pair convention: {pair!r}")
