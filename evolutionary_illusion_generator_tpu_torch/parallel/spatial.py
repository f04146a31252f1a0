"""Spatial (height) sharding of the PredNet rollout.

The port's counterpart of the JAX package's ``parallel/spatial.py``.  The
reference has no attention and its "sequence" is 22 repeated frames, so
the context-parallel analogue is spatial: the image height is split over
the mesh's ``"sp"`` axis, each entry holding a horizontal band of every
candidate's frames and recurrent state, and the batch over ``"pop"``.  It
is meant for the big-frame configs (1280x960), where a device's memory,
not the population, binds.

JAX gets its halo exchanges from the SPMD partitioner.  Here they are
written out: before every 3x3 conv (the gate convs over E, R and
upsample2(R_above), Ahat's over R, A's over E) each band takes one row from
each neighbouring band, copied to its device, and the conv runs with no
height padding but at the image's true top and bottom, so it returns
exactly the band's rows.  Everything else in a step is per pixel (the
gate math, the errors) or stays inside a band (the 2x2 max pool and the
2x upsample, since a band's rows at every level are even: the height must
divide by ``n_sp * 2**(L-1)``).  Per-pixel work runs on each band's own
device.

As in JAX (whose spatial rollout runs ``rollout_flow_frames`` with its
default ``use_pallas=False``), this is the plain route of
:func:`..models.prednet.model.prednet_step` (split per-source convs, the
plain gate math) and launches no kernel.  ``s2d_l0`` composes: the pixel
layer's bands are packed one by one (a band of the packed frame is the
packed band), and its lifted 3x3 convs take the same one-row halo in the
packed rows.  The bands run one after another in this process; a mesh
that spans processes is refused (ROADMAP.md Queue 1 item 13), as are int8
params (their activation scale is one per candidate over the whole frame).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.prednet.model import (
    _ONE,
    _ZERO,
    _conv,
    _d2s,
    _is_quantized,
    _lstm_gates,
    _maxpool2,
    _s2d,
    _s2d_ok,
    _state_dtype,
    _tile4,
    _upsample2,
    init_state,
    with_layout_weights,
)
from .mesh import Mesh, _all_devices, _object_array, replicate

__all__ = ["make_mesh_2d", "make_spatial_rollout"]


def make_mesh_2d(n_pop: int, n_sp: int, devices=None) -> Mesh:
    """(pop, sp) mesh, population-major, so a band's neighbours are the
    next entries of its row.  ``devices`` as in
    :func:`..parallel.mesh.make_mesh` (repeats allowed)."""
    devs, procs = _all_devices(devices)
    if len(devs) < n_pop * n_sp:
        raise ValueError(f"need {n_pop * n_sp} devices, have {len(devs)}")
    n = n_pop * n_sp
    return Mesh(_object_array(devs[:n]).reshape(n_pop, n_sp), ("pop", "sp"),
                np.asarray(procs[:n]).reshape(n_pop, n_sp))


def _halo_conv(xs: List[torch.Tensor], w_key: str, b_key: Optional[str], ps, devs, cd):
    """3x3 SAME conv of the NHWC bands ``xs`` (one image split by height)
    with weight ``w_key`` and bias ``b_key`` of the layer params ``ps[s]``
    on each band's device: each band takes its neighbours' edge rows and is
    padded in height only at the image's top and bottom, so each output is
    exactly its band."""
    out = []
    last = len(xs) - 1
    for s, x in enumerate(xs):
        parts = [x]
        if s > 0:
            parts.insert(0, xs[s - 1][:, -1:].to(devs[s]))
        if s < last:
            parts.append(xs[s + 1][:, :1].to(devs[s]))
        p = ps[s]
        out.append(_conv(torch.cat(parts, dim=1) if len(parts) > 1 else x, p[w_key],
                         None if b_key is None else p[b_key], cd,
                         pad=(1, 1, int(s == 0), int(s == last)), cudnn=False))
    return out


def _band_peephole(p, s: int, rows: int, full_hw, s2d_here: bool, cd):
    """Band ``s``'s peepholes: a spatial one at the layer's resolution is
    cut to the band's rows; one at another resolution becomes its
    per-channel mean, as :func:`..models.prednet.model._lstm_gates` takes
    it over the whole frame."""
    if "w_ci" not in p:
        return None
    out = {}
    for k in ("w_ci", "w_cf", "w_co"):
        w = p[k]
        if w.dim() == 3:
            if tuple(w.shape[:2]) == tuple(full_hw):
                w = w[s * rows:(s + 1) * rows]
            else:
                w = w.to(cd).mean(dim=(0, 1))
        if s2d_here and w.dim() == 1:
            w = _tile4(w)
        out[k] = w
    return out


def _band_step(reps, devs, state, frames, *, cd, s2d_l0: bool, full_hw):
    """One :func:`..models.prednet.model.prednet_step` on the plain route
    over the bands of one batch: ``state[s]`` and ``frames[s]`` are band
    ``s``'s; returns the new bands' state and predictions."""
    n = len(devs)
    L = len(state[0])
    dtype = state[0][0]["r"].dtype
    new = [[dict(layer) for layer in st] for st in state]
    r_above = None
    for l in reversed(range(L)):
        s2d_here = s2d_l0 and l == 0
        pre = "s2d_" if s2d_here else "lstm_"
        ps = [reps[d][l] for d in devs]
        e = [st[l]["e"] for st in state]
        r = [st[l]["r"] for st in state]
        gates = _halo_conv(e, pre + "w_e", "s2d_b" if s2d_here else "lstm_b", ps, devs, cd)
        gates = [g + h for g, h in zip(gates, _halo_conv(r, pre + "w_r", None, ps, devs, cd))]
        if r_above is not None:
            src = r_above if s2d_here else [_upsample2(x) for x in r_above]
            gates = [g + h for g, h in zip(gates, _halo_conv(src, pre + "w_up", None, ps,
                                                             devs, cd))]
        for s in range(n):
            rows = state[s][l]["r"].shape[1]
            hw = (full_hw[0] >> l, full_hw[1] >> l)
            peep = _band_peephole(ps[s], s, rows, hw, s2d_here, cd)
            h, c = _lstm_gates(gates[s], state[s][l]["c"], peep)
            new[s][l]["r"] = h.to(dtype)
            new[s][l]["c"] = c.to(dtype)
        r_above = [new[s][l]["r"] for s in range(n)]

    a = [f.to(cd) for f in frames]
    preds = None
    for l in range(L):
        s2d_here = s2d_l0 and l == 0
        pre = "s2d_" if s2d_here else ""
        ps = [reps[d][l] for d in devs]
        r = [new[s][l]["r"] for s in range(n)]
        ahat = _halo_conv(r, pre + "ahat_w", pre + "ahat_b", ps, devs, cd)
        if l == 0:  # SatLU, as the plain route clips
            ahat = [torch.minimum(torch.maximum(x, _ZERO), _ONE) for x in ahat]
            preds = [x.float() for x in ahat]
        else:
            ahat = [torch.relu(x) for x in ahat]
        e = [torch.cat([torch.relu(x - y), torch.relu(y - x)], dim=-1) for x, y in zip(ahat, a)]
        for s in range(n):
            new[s][l]["e"] = e[s].to(dtype)
        if l + 1 < L:
            conv = _halo_conv([x.to(dtype) for x in e], pre + "a_w", pre + "a_b", ps, devs, cd)
            if s2d_here:  # maxpool2 is the max over the lifted conv's phase blocks
                c1 = ps[0]["a_w"].shape[0]
                a = []
                for y in conv:
                    y = torch.relu(y)
                    a.append(torch.maximum(torch.maximum(y[..., :c1], y[..., c1:2 * c1]),
                                           torch.maximum(y[..., 2 * c1:3 * c1], y[..., 3 * c1:])))
            else:
                a = [_maxpool2(torch.relu(y)) for y in conv]
    return new, preds


def make_spatial_rollout(
    mesh: Mesh,
    *,
    repeat: int = 20,
    extension: int = 2,
    pair: str = "population",
    compute_dtype=None,
    s2d_l0: bool = False,
) -> Callable:
    """Flow-frame rollout (:func:`..models.prednet.model.rollout_flow_frames`)
    with params placed on every entry's device and images split (batch over
    "pop", height over "sp").  Returns ``run(params, images) -> (f0, f1)``,
    the full frames on ``images``' device.

    The image height must divide by ``mesh.shape["sp"] * 2**(L-1)`` so every
    pyramid level splits evenly, and the batch by ``mesh.shape["pop"]``.
    """
    if tuple(mesh.axis_names) != ("pop", "sp"):
        raise ValueError(f"need a (pop, sp) mesh, got axes {mesh.axis_names}")
    if mesh.spans_processes:
        raise NotImplementedError(
            "spatial rollout over several processes (ROADMAP.md Queue 1 item 13)")
    if pair == "population":
        collect = (repeat - 1, repeat)
    elif pair == "probe":
        collect = (repeat + 1,)
    else:
        raise ValueError(f"unknown pair convention: {pair!r}")
    cd = compute_dtype or torch.float32
    n_pop, n_sp = mesh.devices.shape

    def run(params, images):
        if _is_quantized(params):
            raise NotImplementedError("int8 params: use the unsharded rollout")
        B, H, W, C0 = images.shape
        channels = [p["ahat_w"].shape[0] for p in params]
        if channels[0] != C0:
            raise ValueError(f"images have {C0} channels, the predictor {channels[0]}")
        L = len(params)
        if H % (n_sp * 2 ** (L - 1)):
            raise ValueError(f"height {H} does not split into {n_sp} bands of "
                             f"{2 ** (L - 1)}-row blocks (sp {n_sp}, {L} layers)")
        if B % n_pop:
            raise ValueError(f"batch {B} does not divide over {n_pop} pop entries")
        s2d = s2d_l0 and _s2d_ok(params, H, W)
        lifted = with_layout_weights(params, s2d_l0=s2d)
        reps = replicate(lifted, mesh)
        dtype = _state_dtype(lifted)
        bp, rows = B // n_pop, H // n_sp
        frames32 = images.float()
        outs = {t: [] for t in collect}
        for p in range(n_pop):
            devs = list(mesh.devices[p])
            frames = [frames32[p * bp:(p + 1) * bp, s * rows:(s + 1) * rows].to(devs[s])
                      for s in range(n_sp)]
            if s2d:
                frames = [_s2d(f) for f in frames]
            state = [init_state(bp, rows, W, channels, dtype=dtype, device=devs[s], s2d_l0=s2d)
                     for s in range(n_sp)]
            pred = frames
            for t in range(repeat + extension):
                state, pred = _band_step(reps, devs, state, frames if t < repeat else pred,
                                         cd=cd, s2d_l0=s2d, full_hw=(H, W))
                if t in collect:
                    bands = [(_d2s(x) if s2d else x).to(images.device) for x in pred]
                    outs[t].append(torch.cat(bands, dim=1))
        preds = [torch.cat(outs[t], dim=0) for t in collect]
        if pair == "population":
            return preds[0], preds[1]
        return frames32, preds[0]

    return run
