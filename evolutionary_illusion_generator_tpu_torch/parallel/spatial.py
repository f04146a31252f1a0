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
packed rows.  int8 params (:func:`..models.prednet.model.
quantize_params_int8`) run the int8 route, whose activation scale is one
per candidate over the whole frame: each band takes the maximum of every
band's per-row maximum (before the ``* f32(1/127)`` of ``_conv_q``) and
quantises its rows and its halo rows with it, so the codes, and the frames,
are the unsharded rollout's bit for bit.

The bands of one pop row run one after another in this process.  A mesh
that spans processes (:func:`.distributed.initialize_distributed`) runs
each process's own bands: a neighbour's edge row held by another process
comes as a host copy (:func:`.distributed.exchange`), the int8 scale's
maximum is taken over the row's processes (:func:`.distributed.all_max`),
and every process returns the full frames, gathered from the bands'
processes.  Every process passes the same params and images.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..models.prednet.model import (
    _ONE,
    _ZERO,
    _activation_max,
    _conv,
    _conv_q,
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
from .distributed import all_max, exchange, gather_entries, new_group, process_count, process_index
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


class _Row(NamedTuple):
    """One pop row of the mesh: each band's device and process, and the
    process group of the row's processes (``None``: every process, or
    this one alone)."""

    devs: list
    owners: List[int]
    group: object

    def local(self, s: int) -> bool:
        return self.owners[s] == process_index()


def _edges(xs: List[Optional[torch.Tensor]], row: _Row):
    """For each of this process's bands ``s`` (``xs[s]``; ``None`` for
    another process's band): the last row of band ``s - 1`` and the first
    of band ``s + 1`` on band ``s``'s device, ``None`` at the image's top
    and bottom.  A neighbour of another process trades rows by
    :func:`.distributed.exchange`; the message to band ``j`` carries tag
    ``2 j`` (its row above) or ``2 j + 1`` (its row below)."""
    n = len(xs)
    above, below = [None] * n, [None] * n
    sends, recvs, into = [], [], []
    for s, x in enumerate(xs):
        if x is None:
            continue
        shape, dtype = (x.shape[0], 1, *x.shape[2:]), x.dtype
        # (neighbour, its edge row we take, ours it takes, where it goes, tags)
        for nb, edge, mine, box, tag_in, tag_out in (
                (s - 1, slice(-1, None), x[:, :1], above, 2 * s, 2 * (s - 1) + 1),
                (s + 1, slice(0, 1), x[:, -1:], below, 2 * s + 1, 2 * (s + 1))):
            if not 0 <= nb < n:
                continue
            if row.local(nb):
                box[s] = xs[nb][:, edge].to(row.devs[s])
            else:
                sends.append((mine, row.owners[nb], tag_out))
                recvs.append((shape, dtype, row.owners[nb], tag_in))
                into.append((box, s))
    for (box, s), got in zip(into, exchange(sends, recvs)):
        box[s] = got.to(row.devs[s])
    return above, below


def _with_halo(xs, row: _Row):
    """Each local band with its neighbours' edge rows, and the rows of
    SAME padding it still needs at the image's top and bottom."""
    above, below = _edges(xs, row)
    out = []
    for s, x in enumerate(xs):
        if x is None:
            out.append(None)
            continue
        parts = [t for t in (above[s], x, below[s]) if t is not None]
        out.append((torch.cat(parts, dim=1) if len(parts) > 1 else x,
                    (int(above[s] is None), int(below[s] is None))))
    return out


def _halo_conv(xs, w_key: str, b_key: Optional[str], ps, row: _Row, cd):
    """3x3 SAME conv of the NHWC bands ``xs`` (one image split by height;
    ``None`` for another process's band) with weight ``w_key`` and bias
    ``b_key`` of the layer params ``ps[s]`` on each band's device: each
    band takes its neighbours' edge rows and is padded in height only at
    the image's top and bottom, so each output is exactly its band."""
    out = []
    for s, item in enumerate(_with_halo(xs, row)):
        if item is None:
            out.append(None)
            continue
        x, (top, bottom) = item
        p = ps[s]
        out.append(_conv(x, p[w_key], None if b_key is None else p[b_key], cd,
                         pad=(1, 1, top, bottom), cudnn=False))
    return out


def _halo_conv_q(xs, w_key: str, b_key: Optional[str], ps, row: _Row, cd):
    """:func:`_halo_conv` of int8 params (``_conv_q``'s route): every band
    and its halo rows are quantised with the scale of the whole frame, the
    maximum of the bands' per-row maxima (over the row's processes)."""
    maxima = [_activation_max(x) for x in xs if x is not None]
    amax = maxima[0]
    for m in maxima[1:]:
        amax = torch.maximum(amax, m.to(amax.device))
    if any(not row.local(s) for s in range(len(xs))):
        amax = all_max(amax, row.group)
    s_key = "lstm_w_s" if w_key.startswith("lstm_") else w_key + "_s"
    out = []
    for s, item in enumerate(_with_halo(xs, row)):
        if item is None:
            out.append(None)
            continue
        x, pad_h = item
        p = ps[s]
        out.append(_conv_q(x, p[w_key], p[s_key], None if b_key is None else p[b_key], cd,
                           amax=amax.to(x.device), pad_h=pad_h))
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


def _each(fn, *lists):
    """``fn`` over the bands of this process (``None`` for the others)."""
    return [None if xs[0] is None else fn(*xs) for xs in zip(*lists)]


def _band_step(reps, row: _Row, state, frames, *, cd, s2d_l0: bool, full_hw):
    """One :func:`..models.prednet.model.prednet_step` on the plain route
    (or int8 params' route) over the bands of one batch: ``state[s]`` and
    ``frames[s]`` are band ``s``'s, ``None`` for another process's band;
    returns the new bands' state and predictions."""
    n = len(row.devs)
    mine = [s for s in range(n) if row.local(s)]
    L = len(state[mine[0]])
    dtype = state[mine[0]][0]["r"].dtype
    new = [None if st is None else [dict(layer) for layer in st] for st in state]
    quantized = _is_quantized(reps[row.devs[mine[0]]])
    conv = _halo_conv_q if quantized else _halo_conv
    r_above = None
    for l in reversed(range(L)):
        s2d_here = s2d_l0 and l == 0
        pre = "s2d_" if s2d_here else "lstm_"
        ps = [reps[row.devs[s]][l] if row.local(s) else None for s in range(n)]
        e = [None if st is None else st[l]["e"] for st in state]
        r = [None if st is None else st[l]["r"] for st in state]
        if quantized:
            e, r = (_each(lambda x: x.to(cd), xs) for xs in (e, r))
        gates = conv(e, pre + "w_e", "s2d_b" if s2d_here else "lstm_b", ps, row, cd)
        gates = _each(torch.add, gates, conv(r, pre + "w_r", None, ps, row, cd))
        if r_above is not None:
            src = r_above if s2d_here else _each(_upsample2, r_above)
            if quantized:
                src = _each(lambda x: x.to(cd), src)
            gates = _each(torch.add, gates, conv(src, pre + "w_up", None, ps, row, cd))
        for s in mine:
            rows = state[s][l]["r"].shape[1]
            hw = (full_hw[0] >> l, full_hw[1] >> l)
            peep = _band_peephole(ps[s], s, rows, hw, s2d_here, cd)
            h, c = _lstm_gates(gates[s], state[s][l]["c"], peep)
            new[s][l]["r"] = h.to(dtype)
            new[s][l]["c"] = c.to(dtype)
        r_above = [None if st is None else st[l]["r"] for st in new]

    a = _each(lambda f: f.to(cd), frames)
    preds = None
    for l in range(L):
        s2d_here = s2d_l0 and l == 0
        pre = "s2d_" if s2d_here else ""
        ps = [reps[row.devs[s]][l] if row.local(s) else None for s in range(n)]
        r = [None if st is None else st[l]["r"] for st in new]
        if quantized:
            r = _each(lambda x: x.to(cd), r)
        ahat = conv(r, pre + "ahat_w", pre + "ahat_b", ps, row, cd)
        if l == 0:  # SatLU, as the plain route clips
            ahat = _each(lambda x: torch.minimum(torch.maximum(x, _ZERO), _ONE), ahat)
            preds = _each(lambda x: x.float(), ahat)
        else:
            ahat = _each(torch.relu, ahat)
        e = _each(lambda x, y: torch.cat([torch.relu(x - y), torch.relu(y - x)], dim=-1),
                  ahat, a)
        for s in mine:
            new[s][l]["e"] = e[s].to(dtype)
        if l + 1 < L:
            # the int8 route quantises E in the compute dtype, the others
            # take it in the state's
            src = e if quantized else _each(lambda x: x.to(dtype), e)
            out = conv(src, pre + "a_w", pre + "a_b", ps, row, cd)
            if s2d_here:  # maxpool2 is the max over the lifted conv's phase blocks
                c1 = ps[mine[0]]["a_w"].shape[0]

                def pool(y):
                    y = torch.relu(y)
                    return torch.maximum(torch.maximum(y[..., :c1], y[..., c1:2 * c1]),
                                         torch.maximum(y[..., 2 * c1:3 * c1], y[..., 3 * c1:]))
                a = _each(pool, out)
            else:
                a = _each(lambda y: _maxpool2(torch.relu(y)), out)
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
    Over several processes every process calls this and ``run`` alike (the
    module docstring).
    """
    if tuple(mesh.axis_names) != ("pop", "sp"):
        raise ValueError(f"need a (pop, sp) mesh, got axes {mesh.axis_names}")
    if mesh.spans_processes and process_count() == 1:
        raise ValueError(f"{mesh} spans processes, but no process group is initialized "
                         f"(parallel.initialize_distributed)")
    if pair == "population":
        collect = (repeat - 1, repeat)
    elif pair == "probe":
        collect = (repeat + 1,)
    else:
        raise ValueError(f"unknown pair convention: {pair!r}")
    cd = compute_dtype or torch.float32
    n_pop, n_sp = mesh.devices.shape
    # a process group for each row whose bands span some processes but not
    # all (made here, where every process takes part, as new_group needs)
    groups, rows = {}, []
    for p in range(n_pop):
        owners = [int(o) for o in mesh.processes[p]]
        ranks = tuple(sorted(set(owners)))
        if 1 < len(ranks) < process_count() and ranks not in groups:
            groups[ranks] = new_group(ranks)
        rows.append(_Row(list(mesh.devices[p]), owners, groups.get(ranks)))

    def run(params, images):
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
        bp, band = B // n_pop, H // n_sp
        frames32 = images.float()
        # per collected step, each entry's band of the prediction (pop-major)
        outs = {t: [None] * (n_pop * n_sp) for t in collect}
        for p, row in enumerate(rows):
            mine = [s for s in range(n_sp) if row.local(s)]
            if not mine:
                continue
            frames = [frames32[p * bp:(p + 1) * bp, s * band:(s + 1) * band].to(row.devs[s])
                      if s in mine else None for s in range(n_sp)]
            if s2d:
                frames = _each(_s2d, frames)
            state = [init_state(bp, band, W, channels, dtype=dtype, device=row.devs[s],
                                s2d_l0=s2d) if s in mine else None for s in range(n_sp)]
            pred = frames
            for t in range(repeat + extension):
                state, pred = _band_step(reps, row, state, frames if t < repeat else pred,
                                         cd=cd, s2d_l0=s2d, full_hw=(H, W))
                if t in collect:
                    for s in mine:
                        outs[t][p * n_sp + s] = _d2s(pred[s]) if s2d else pred[s]
        if mesh.spans_processes:
            shape = (bp, band, W, C0)
            outs = {t: gather_entries(bands, mesh.processes.flat, shape, torch.float32)
                    for t, bands in outs.items()}
        preds = [torch.cat([torch.cat([b.to(images.device)
                                       for b in outs[t][p * n_sp:(p + 1) * n_sp]], dim=1)
                            for p in range(n_pop)], dim=0) for t in collect]
        if pair == "population":
            return preds[0], preds[1]
        return frames32, preds[0]

    return run
