"""PredNet: the predictive-coding ConvLSTM stack, in PyTorch (dense path).

The port of the JAX package's ``models/prednet/model.py`` (``init_params``,
``init_state``, ``prednet_step``, ``rollout``, ``rollout_flow_frames``).
Architecture per layer ``l`` (channels ``[c, 48, 96, 192]`` color):

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
ConvLSTM update computes (:func:`rollout` and the evaluator always take
``"fused"``):

* ``"fused"`` (the port's default, the route of the evaluator, the probe
  and the compat shims), on the CUDA kernels:

  - layers with ``C >= 32`` and no peephole (layers 1-3 at
    ``3,48,96,192``): :func:`..ops.convlstm_fused.fused_convlstm_layer_multi`
    over E, R and the upsampled R_above — the JAX ``use_pallas="fused"``
    math: bfloat16 sources and weights, float32 accumulation and gates,
    ``h`` in the state dtype, ``c`` float32 then cast to the state dtype;
  - narrow layers (layer 0, C = 3 or 1): split ``F.conv2d`` gate convs in
    the compute dtype, then :func:`..ops.convlstm_gates.fused_lstm_gates`
    on their sum as it is, writing h and c in the state dtype — the JAX
    ``use_pallas=True`` math (float32 gate math on the gates widened to
    float32, h and c then cast to the state dtype), with the widening and
    the casts inside the kernel;

* ``True``: the narrow layers' route on every layer;
* ``False`` (the JAX default, which the trainer differentiates): split
  per-source ``F.conv2d`` gate convs in the compute dtype and the plain
  gate math (:func:`_lstm_gates`) in the gates' dtype, on every layer.
  It launches no kernel.

A layer with peepholes takes the plain gate math on every route.  On CUDA
tensors the two wrappers launch their kernels; on CPU tensors they run
their plain versions.  Neither kernel has a backward (the JAX kernels have
no VJP either), so the wrappers refuse, on every device, inputs that
require a gradient while grad mode is on: a loss differentiated through
``"fused"`` or ``True`` raises instead of silently leaving the weights of
those layers without a gradient.  Train on ``use_pallas=False``
(:mod:`.train`).  The JAX package's TPU layout options (``s2d_l0``,
``subpixel_up``, int8) are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.convlstm_fused import fused_convlstm_layer_multi
from ...ops.convlstm_gates import fused_lstm_gates
from ...utils import prng
from .loader import params_from_numpy

__all__ = [
    "FUSED_MIN_CHANNELS",
    "init_params",
    "init_state",
    "prednet_step",
    "rollout",
    "rollout_flow_frames",
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
               dtype=torch.bfloat16, device=None) -> List[dict]:
    """Zero recurrent state: per layer (r, c, e) at 1/2^l resolution."""
    state = []
    for l, C in enumerate(channels):
        hl, wl = h // (2**l), w // (2**l)
        state.append({
            "r": torch.zeros(batch, hl, wl, C, dtype=dtype, device=device),
            "c": torch.zeros(batch, hl, wl, C, dtype=dtype, device=device),
            "e": torch.zeros(batch, hl, wl, 2 * C, dtype=dtype, device=device),
        })
    return state


def _state_dtype(params) -> torch.dtype:
    return params[0]["lstm_b"].dtype


def _conv(x, w, b, out_dtype):
    """NHWC SAME 3x3 conv of ``x`` rounded to the weight dtype, output in
    ``out_dtype`` (the JAX ``_conv``: inputs in the weight dtype, result in
    ``preferred_element_type``).  Where either side is float32 the conv runs
    in float32, so bfloat16 weights with a float32 output keep float32 sums."""
    x = x.to(w.dtype)
    acc = torch.float32 if torch.float32 in (w.dtype, out_dtype) else w.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2).to(acc), w.to(acc), padding=1)
    y = y.permute(0, 2, 3, 1).to(out_dtype)
    return y if b is None else y + b.to(out_dtype)


def _upsample2(x):
    """Nearest-neighbour 2x upsample (NHWC)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


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


def prednet_step(params, state, frame, *, use_pallas: Union[bool, str] = "fused",
                 compute_dtype=torch.float32):
    """One PredNet timestep.

    Args:
      params: from :mod:`.loader` or :func:`init_params`.
      state: per-layer dicts (r, c, e) from :func:`init_state`.
      frame: (B, H, W, C0) input in [0, 1].
      use_pallas: the route of the ConvLSTM update (module docstring):
        ``"fused"`` (the kernels), ``True`` (the gate kernel on every
        layer) or ``False`` (plain and differentiable).
      compute_dtype: dtype of the split gate convs' outputs and the gate
        sums, the A / Ahat convs and the error units.
    Returns:
      (new_state, prediction) with prediction (B, H, W, C0) float32.
    """
    if not (isinstance(use_pallas, bool) or use_pallas == "fused"):
        raise ValueError(f"use_pallas must be False, True or 'fused', got {use_pallas!r}")
    L = len(params)
    dtype = state[0]["r"].dtype
    cd = compute_dtype

    new_state = [dict(s) for s in state]
    r_above: Optional[torch.Tensor] = None
    for l in reversed(range(L)):
        s, p = state[l], params[l]
        C = s["r"].shape[-1]
        peephole = None
        if "w_ci" in p:
            peephole = {k: p[k] for k in ("w_ci", "w_cf", "w_co")}
        if use_pallas == "fused" and C >= FUSED_MIN_CHANNELS and peephole is None:
            srcs = [s["e"].to(torch.bfloat16), s["r"].to(torch.bfloat16)]
            wks = [p["lstm_k_e"], p["lstm_k_r"]]
            if r_above is not None:
                srcs.append(_upsample2(r_above).to(torch.bfloat16))
                wks.append(p["lstm_k_up"])
            h, c = fused_convlstm_layer_multi(srcs, wks, p["lstm_b"], s["c"])
        else:
            gates = _conv(s["e"], p["lstm_w_e"], p["lstm_b"], cd)
            gates = gates + _conv(s["r"], p["lstm_w_r"], None, cd)
            if r_above is not None:
                gates = gates + _conv(_upsample2(r_above), p["lstm_w_up"], None, cd)
            if use_pallas is not False and peephole is None:
                h, c = fused_lstm_gates(gates.contiguous(), s["c"], out_dtype=dtype)
            else:
                h, c = _lstm_gates(gates, s["c"], peephole)
        new_state[l]["r"] = h.to(dtype)
        new_state[l]["c"] = c.to(dtype)
        r_above = new_state[l]["r"]

    a = frame.to(cd)
    prediction = None
    for l in range(L):
        p = params[l]
        ahat = _conv(new_state[l]["r"], p["ahat_w"], p["ahat_b"], cd)
        if l == 0:  # SatLU at the pixel layer
            if use_pallas is False:
                # as jnp.clip: min(max(x, 0), 1), whose gradient splits in
                # half at either bound (clamp's would not)
                ahat = torch.minimum(torch.maximum(ahat, _ZERO), _ONE)
            else:
                ahat = ahat.clamp(0.0, 1.0)
            prediction = ahat.float()
        else:
            ahat = torch.relu(ahat)
        e = torch.cat([torch.relu(ahat - a), torch.relu(a - ahat)], dim=-1)
        new_state[l]["e"] = e.to(dtype)
        if l + 1 < L:
            a = _maxpool2(torch.relu(_conv(e.to(dtype), p["a_w"], p["a_b"], cd)))
    return new_state, prediction


def rollout(params, images, *, repeat: int = 20, extension: int = 2,
            collect: Tuple[int, ...] = (), compute_dtype=torch.float32):
    """The reference's schedule: the image ``repeat`` times (open loop),
    then the model's own prediction fed back for ``extension`` steps.

    Args:
      images: (B, H, W, C0) float in [0, 1], one frame per candidate.
      collect: timesteps whose predictions to return.
    Returns:
      dict: {"predictions": {t: (B, H, W, C0) float32}, "final_state": state}
    """
    B, H, W, C0 = images.shape
    channels = [p["ahat_w"].shape[0] for p in params]
    if channels[0] != C0:
        raise ValueError(f"images have {C0} channels, the predictor {channels[0]}")
    state = init_state(B, H, W, channels, dtype=_state_dtype(params),
                       device=images.device)
    frames = images.float()
    pred = frames
    saved = {}
    for t in range(repeat + extension):
        state, pred = prednet_step(
            params, state, frames if t < repeat else pred,
            compute_dtype=compute_dtype,
        )
        if t in collect:
            saved[t] = pred
    return {"predictions": saved, "final_state": state}


def rollout_flow_frames(params, images, *, repeat: int = 20, extension: int = 2,
                        pair: str = "population", compute_dtype=torch.float32):
    """The two frames the flow stage compares.

    * "population": prediction at t=repeat-1 vs the first extension frame;
    * "probe": the input image itself vs the second extension frame.
    """
    if pair == "population":
        out = rollout(params, images, repeat=repeat, extension=extension,
                      collect=(repeat - 1, repeat), compute_dtype=compute_dtype)
        return out["predictions"][repeat - 1], out["predictions"][repeat]
    if pair == "probe":
        out = rollout(params, images, repeat=repeat, extension=extension,
                      collect=(repeat + 1,), compute_dtype=compute_dtype)
        return images.float(), out["predictions"][repeat + 1]
    raise ValueError(f"unknown pair convention: {pair!r}")
