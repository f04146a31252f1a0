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

The stages run one after another in this process, tick by tick.  A mesh
that spans processes (:func:`.distributed.initialize_distributed`) runs
each stage on its entry's process: a tick's message to a stage of another
process goes as a host copy (:func:`.distributed.exchange`), and stage 0's
frames are gathered to every process, so every process returns them.
Every process passes the same params and images.
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
from .distributed import exchange, gather_entries, process_count, process_index
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
    if mesh.spans_processes and process_count() == 1:
        raise ValueError(f"{mesh} spans processes, but no process group is initialized "
                         f"(parallel.initialize_distributed)")
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
    owners = [int(o) for o in mesh.processes.flat]
    local = [o == process_index() for o in owners]
    weights = [{k: v.to(devs[l]) for k, v in params[l].items()} if local[l] else None
               for l in range(L)]
    frames32 = images.float()
    frames = [frames32[m * mb:(m + 1) * mb].to(devs[0]) for m in range(M)] if local[0] else []

    def zeros(l, c):
        """Stage l's zero state per microbatch, in its layer's true shape;
        only on the stage's own process."""
        if not local[l]:
            return None
        return [torch.zeros(mb, H >> l, W >> l, c, dtype=dtype, device=devs[l])
                for _ in range(M)]

    r = [zeros(l, channels[l]) for l in range(L)]
    c = [zeros(l, channels[l]) for l in range(L)]
    e = [zeros(l, 2 * channels[l]) for l in range(L)]
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

    def runs(phase):
        return phase >= 0 and phase % 2 == 0 and phase // 2 < T * M

    # the messages a stage sends: R (stage s's, to s - 1) and pooled A
    # (stage s's, to s + 1), with their shapes and dtypes
    r_msg = [((mb, H >> s, W >> s, channels[s]), dtype) for s in range(L)]
    a_msg = [((mb, H >> (s + 1), W >> (s + 1), channels[s + 1]), cd) for s in range(L - 1)]
    r_in = [None] * L  # R from the stage above, arrived this tick
    a_in = [None] * L  # pooled A from the stage below, arrived this tick
    for k in range(2 * T * M + 2 * L - 2):
        r_out = [None] * L
        a_out = [None] * L
        for s in range(L):
            if not local[s]:
                continue
            dphase = k - (L - 1 - s)
            if runs(dphase):
                r_out[s] = down(s, (dphase // 2) % M, r_in[s])
            uphase = k - (L + s)
            if runs(uphase):
                idx = uphase // 2
                a_out[s] = up(s, idx % M, idx // M, a_in[s])
        # boundary hops: R one stage down (tag 2 s), pooled A one stage up
        # (tag 2 s + 1), to the receiving stage s; across processes as host
        # copies.  Whether a stage sent this tick is known to every process
        r_in, a_in = [None] * L, [None] * L
        sends, recvs, into = [], [], []
        for s in range(L):
            for src, sent, outs, box, msg, tag in (
                    (s + 1, s + 1 < L and runs(k - (L - 2 - s)), r_out, r_in, r_msg, 2 * s),
                    (s - 1, s > 0 and runs(k - (L + s - 1)), a_out, a_in, a_msg, 2 * s + 1)):
                if not sent or not (local[s] or local[src]):
                    continue
                if local[s] and local[src]:
                    box[s] = outs[src].to(devs[s])
                elif local[src]:
                    sends.append((outs[src], owners[s], tag))
                else:
                    recvs.append((*msg[src], owners[src], tag))
                    into.append((box, s))
        for (box, s), got in zip(into, exchange(sends, recvs)):
            box[s] = got.to(devs[s])

    out = [torch.cat(preds[t]) if local[0] else None for t in collect]
    if mesh.spans_processes:
        out = [gather_entries([x], owners[:1], (B, H, W, C0), torch.float32)[0] for x in out]
    out = [x.to(images.device) for x in out]
    if pair == "population":
        return out[0], out[1]
    return frames32, out[0]
