"""Pipeline-parallel PredNet rollout: one ConvLSTM layer per mesh entry.

The port's counterpart of the JAX package's ``parallel/pipeline.py``, and,
as there, not a production path: the population axis is embarrassingly
parallel (:mod:`.sharded_evaluator`) and the spatial axis covers the
big-frame configs (:mod:`.spatial`); this is the minimal, correct
implementation of the strategy, so that it exists and can be measured.

* A mesh axis ``pp`` of size L: stage ``s`` holds layer ``s``'s weights and
  recurrent state (R, c, E) for every microbatch, on mesh entry ``s``'s
  device.
* PredNet's timestep is a top-down sweep (R updates, L-1..0) then a
  bottom-up sweep (Ahat and E, 0..L-1): a "V" across stages per frame.
  The population is split into M microbatches streamed through the JAX
  module's skewed wavefront of ticks; at tick k, stage s runs
      down(s, m, t)  at  k = 2*(t*M + m) + (L-1-s)
      up(s, m, t)    at  k = 2*(t*M + m) + L + s
  so each boundary tensor moves one stage per tick: R one stage down after
  a down half-step, pooled A one stage up after an up half-step, copied to
  the neighbour's device at the end of the tick.  Correctness needs
  M >= L (the down(t) after up(t-1) gap), which is enforced.
* The JAX module stores states and messages flat, padded to the largest
  layer's size, because one SPMD program needs one local shape on every
  stage.  Here each stage runs its own code on its own tensors, so every
  stage keeps its layer's true shapes and no padding exists.
* The math is the plain route of
  :func:`..models.prednet.model.prednet_step` (split per-source convs, the
  plain gate math, the JAX pipeline's ``_conv`` and ``_lstm_gates_jnp``):
  no kernel is launched, as the JAX pipeline reaches no Pallas kernel.

The stages run one after another in this process, tick by tick; a mesh
that spans processes is refused (ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.prednet.model import (
    _ONE,
    _ZERO,
    _conv,
    _lstm_gates,
    _maxpool2,
    _upsample2,
)
from .mesh import Mesh, _all_devices, _object_array

__all__ = ["make_pp_mesh", "pipelined_rollout_flow_frames"]

PP_AXIS = "pp"


def make_pp_mesh(n_stages: int, devices=None) -> Mesh:
    """1-D pipeline mesh: stage s = entry s.  ``devices`` as in
    :func:`..parallel.mesh.make_mesh` (repeats allowed)."""
    devs, procs = _all_devices(devices)
    if len(devs) < n_stages:
        raise ValueError(f"need {n_stages} devices, have {len(devs)}")
    return Mesh(_object_array(devs[:n_stages]), (PP_AXIS,), np.asarray(procs[:n_stages]))


def pipelined_rollout_flow_frames(
    params,
    images,
    mesh: Mesh,
    *,
    repeat: int = 20,
    extension: int = 2,
    pair: str = "population",
    n_micro: Optional[int] = None,
    compute_dtype=torch.float32,
):
    """Layer-pipelined equivalent of
    :func:`..models.prednet.model.rollout_flow_frames` on the plain route.

    ``images``: (B, H, W, C0); ``mesh`` must have a ``pp`` axis of size
    L = len(params); ``n_micro`` microbatches (default L, the minimum that
    fills the wavefront) must divide B.  Peephole params are out of scope,
    as in JAX.  Returns the two frames on ``images``' device.
    """
    if pair == "population":
        collect = (repeat - 1, repeat)
    elif pair == "probe":
        collect = (repeat + 1,)
    else:
        raise ValueError(f"unknown pair convention: {pair!r}")

    channels = [p["ahat_w"].shape[0] for p in params]
    L = len(channels)
    if any("w_ci" in p for p in params):
        raise NotImplementedError("peephole params: use the unpipelined rollout")
    if params[0]["lstm_w_e"].dtype == torch.int8:
        raise NotImplementedError("int8 params: use the unpipelined rollout")
    S = mesh.shape.get(PP_AXIS)
    if S != L:
        raise ValueError(f"mesh 'pp' axis size {S} != {L} layers")
    if mesh.spans_processes:
        raise NotImplementedError(
            "pipelined rollout over several processes (ROADMAP.md Queue 1 item 13)")
    B, H, W, C0 = images.shape
    if channels[0] != C0:
        raise ValueError(f"images have {C0} channels, the predictor {channels[0]}")
    M = n_micro or max(L, 2)
    if M < L:
        raise ValueError(f"n_micro {M} < {L} stages (wavefront dependency)")
    if B % M:
        raise ValueError(f"population {B} not divisible into {M} microbatches")
    mb = B // M
    if H % (2 ** (L - 1)) or W % (2 ** (L - 1)):
        raise ValueError(f"{H}x{W} does not halve {L - 1} times")

    cd = compute_dtype
    dtype = params[0]["lstm_w_e"].dtype
    T = repeat + extension
    devs = list(mesh.devices.flat)
    weights = [{k: v.to(devs[l]) for k, v in params[l].items()} for l in range(L)]
    frames32 = images.float()
    frames = [frames32[m * mb:(m + 1) * mb].to(devs[0]) for m in range(M)]

    def zeros(l, c):
        return torch.zeros(mb, H >> l, W >> l, c, dtype=dtype, device=devs[l])

    # stage l's state per microbatch, in its layer's true shapes
    r = [[zeros(l, channels[l]) for _ in range(M)] for l in range(L)]
    c = [[zeros(l, channels[l]) for _ in range(M)] for l in range(L)]
    e = [[zeros(l, 2 * channels[l]) for _ in range(M)] for l in range(L)]
    prev_pred = list(frames)  # stage 0: the last prediction per microbatch
    preds = {t: [None] * M for t in collect}

    def down(l, m, r_above):
        """R and c of layer l for microbatch m (the top-down half-step)."""
        p = weights[l]
        gates = _conv(e[l][m], p["lstm_w_e"], p["lstm_b"], cd, cudnn=False)
        gates = gates + _conv(r[l][m], p["lstm_w_r"], None, cd, cudnn=False)
        if l + 1 < L:
            gates = gates + _conv(_upsample2(r_above), p["lstm_w_up"], None, cd, cudnn=False)
        h, c_new = _lstm_gates(gates, c[l][m])
        r[l][m], c[l][m] = h.to(dtype), c_new.to(dtype)
        return r[l][m]

    def up(l, m, t, a_in):
        """Ahat and E of layer l for microbatch m at step t (the bottom-up
        half-step); returns pooled A for the layer above."""
        p = weights[l]
        ahat = _conv(r[l][m], p["ahat_w"], p["ahat_b"], cd, cudnn=False)
        if l == 0:
            ahat = torch.minimum(torch.maximum(ahat, _ZERO), _ONE)  # SatLU
            pred = ahat.float()
            a = (frames[m] if t < repeat else prev_pred[m]).to(cd)
            prev_pred[m] = pred
            if t in preds:
                preds[t][m] = pred
        else:
            ahat = torch.relu(ahat)
            a = a_in.to(cd)
        err = torch.cat([torch.relu(ahat - a), torch.relu(a - ahat)], dim=-1)
        e[l][m] = err.to(dtype)
        if l + 1 < L:
            return _maxpool2(torch.relu(_conv(err.to(dtype), p["a_w"], p["a_b"], cd, cudnn=False)))
        return None

    r_in = [None] * L  # R from the stage above, arrived this tick
    a_in = [None] * L  # pooled A from the stage below, arrived this tick
    for k in range(2 * T * M + 2 * L - 2):
        r_out = [None] * L
        a_out = [None] * L
        for s in range(L):
            dphase = k - (L - 1 - s)
            if dphase >= 0 and dphase % 2 == 0 and dphase // 2 < T * M:
                r_out[s] = down(s, (dphase // 2) % M, r_in[s])
            uphase = k - (L + s)
            if uphase >= 0 and uphase % 2 == 0 and uphase // 2 < T * M:
                idx = uphase // 2
                a_out[s] = up(s, idx % M, idx // M, a_in[s])
        # boundary hops: R one stage down, pooled A one stage up
        r_in = [r_out[s + 1].to(devs[s]) if s + 1 < L and r_out[s + 1] is not None else None
                for s in range(L)]
        a_in = [a_out[s - 1].to(devs[s]) if s > 0 and a_out[s - 1] is not None else None
                for s in range(L)]

    out = [torch.cat(preds[t]).to(images.device) for t in collect]
    if pair == "population":
        return out[0], out[1]
    return frames32, out[0]
