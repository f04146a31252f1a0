"""Synthetic motion sequences for predictor pretraining, in PyTorch.

The port of the JAX package's ``models/prednet/synthetic_data.py``: the
v2 set (:func:`synthetic_motion_batch`, band-limited random textures
translating at a constant subpixel velocity) and the v3 cue set
(:func:`synthetic_cue_batch`, seven regimes of textures, plain rings and
asymmetric sawtooths whose drift follows their luminance ramp; see the JAX
module for what each regime and option teaches the predictor).

Keys and draws are those of the JAX code, key for key
(:mod:`...utils.prng`, bit-equal to ``jax.random``): ``split(key, batch)``
per sequence, then ``split(k, 5)`` / ``split(k, 9)`` and the ``fold_in``
draws.  The draws are per-sequence scalars and the textures' low-resolution
grids, made on the host for the whole batch at once; the frames are
rendered on ``device`` as tensor ops over ``(batch, T, h, w)`` (the JAX
``vmap``), every regime for every sequence and the sequence's own regime
selected, as the JAX code does.  Sums of products are rounded as PyTorch
rounds them (XLA contracts some into fused multiply-adds), and
``atan2`` / ``sin`` / ``cos`` are other implementations, so the frames
agree with JAX's to float32 rounding except at the rare pixel that sits on
a ring, band or disc edge (``tests/test_torch_synthetic_data.py``).
"""

from __future__ import annotations

import math
import numpy as np
import torch

from ..._device import resolve_device
from ...utils import prng

__all__ = ["synthetic_motion_batch", "synthetic_cue_batch"]

_F32 = np.float32
_TWO_PI = _F32(2 * math.pi)


def _linspace_coords(n_low: int, n_out: int):
    """``jnp.linspace(0, n_low - 1.001, n_out)`` in float32 (``stop *
    (i / div)``, the last point ``stop`` itself), split into the integer
    cell and its fraction."""
    stop = _F32(n_low - 1.001)
    div = n_out - 1
    if div < 1:
        pos = np.zeros(1, _F32)
    else:
        step = (np.arange(div, dtype=_F32) / _F32(div)).astype(_F32)
        pos = np.concatenate([(stop * step).astype(_F32), [stop]]).astype(_F32)
    i0 = np.floor(pos).astype(np.int64)
    return i0, (pos - i0.astype(_F32)).astype(_F32)


def _bilinear(tex, y0, fy, x0, fx):
    """``tex[..., y0, :][..., x0]`` bilinearly blended, in the JAX order
    ``v00 (1-fy)(1-fx) + v01 (1-fy) fx + v10 fy (1-fx) + v11 fy fx``.
    ``tex`` (B, c, Hs, Ws); ``y0`` / ``fy`` (B, T, h) and ``x0`` / ``fx``
    (B, T, w), or without the leading (B, T).  Returns (B, c, T, h, w), or
    (B, c, h, w) for unbatched coordinates."""
    B, c = tex.shape[:2]
    if y0.dim() == 1:
        rows0, rows1 = tex[:, :, y0], tex[:, :, y0 + 1]
        v00, v01 = rows0[..., x0], rows0[..., x0 + 1]
        v10, v11 = rows1[..., x0], rows1[..., x0 + 1]
        fy, fx = fy[:, None], fx[None, :]
    else:
        b = torch.arange(B, device=tex.device)[:, None, None, None, None]
        ch = torch.arange(c, device=tex.device)[None, :, None, None, None]
        yi, xi = y0[:, None, :, :, None], x0[:, None, :, None, :]
        v00, v01 = tex[b, ch, yi, xi], tex[b, ch, yi, xi + 1]
        v10, v11 = tex[b, ch, yi + 1, xi], tex[b, ch, yi + 1, xi + 1]
        fy, fx = fy[:, None, :, :, None], fx[:, None, :, None, :]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def _smooth_frames(k_tex, vel, T, h, w, c, margin, device):
    """(B, T, h, w, c) translating smooth textures: per channel key of
    ``split(k_tex, c)`` a band-limited texture (``_smooth_texture``: a
    uniform low-resolution grid at 1/8 scale, bilinearly upsampled) sampled
    at offset ``margin + vel * t`` (``_sample_shifted``)."""
    hs, ws = h + 2 * margin, w + 2 * margin
    lh, lw = hs // 8 + 2, ws // 8 + 2
    low = prng.uniform(prng.split(k_tex, c), (lh, lw))  # (B, c, lh, lw)
    ty0, tfy = _linspace_coords(lh, hs)
    tx0, tfx = _linspace_coords(lw, ws)
    tex = _bilinear(torch.from_numpy(low).to(device), *(
        torch.from_numpy(a).to(device) for a in (ty0, tfy, tx0, tfx)))
    t = np.arange(T, dtype=_F32)
    dx = vel[:, 0, None] * t  # (B, T)
    dy = vel[:, 1, None] * t
    yy = (np.arange(h, dtype=_F32) + _F32(margin))[None, None, :] + dy[:, :, None]
    xx = (np.arange(w, dtype=_F32) + _F32(margin))[None, None, :] + dx[:, :, None]
    y0, x0 = np.floor(yy), np.floor(xx)
    coords = [y0.astype(np.int64), (yy - y0).astype(_F32), x0.astype(np.int64), (xx - x0).astype(_F32)]
    frames = _bilinear(tex, *(torch.from_numpy(a).to(device) for a in coords))
    return frames.permute(0, 2, 3, 4, 1)  # (B, T, h, w, c)


def synthetic_motion_batch(key, batch, T, h, w, c, max_speed: float = 2.0,
                           static_fraction: float = 0.0, *, device=None):
    """(batch, T, h, w, c) float32 sequences of translating textures on
    ``device`` (``None``: the card).

    ``static_fraction`` of the batch gets zero velocity — repeated static
    frames, the regime the fitness oracle probes."""
    device = resolve_device(device)
    keys = prng.split(prng.split(key, batch), 4)  # (B, 4, 2)
    k_vel, k_chan, k_static = keys[:, 1], keys[:, 2], keys[:, 3]
    margin = int(max_speed * T) + 2
    vel = prng.uniform(k_vel, (2,), -max_speed, max_speed)
    static = prng.uniform(k_static, ()) < _F32(static_fraction)
    vel = np.where(static[:, None], _F32(0.0), vel).astype(_F32)
    return _smooth_frames(k_chan, vel, T, h, w, c, margin, device)


# ---------------------------------------------------------------------------
# v3: appearance->motion cue sequences


def _asym_ramp(ph, rise: float = 0.8):
    """Asymmetric sawtooth on phase: slow rise over ``rise`` of the period,
    sharp fall over the rest."""
    ph = ph - torch.floor(ph)
    return torch.where(ph < rise, ph / rise, (1.0 - ph) / (1.0 - rise))


def _sym_rings(ph, duty):
    """Symmetric square ring profile: bright for ``duty`` of each period."""
    ph = ph - torch.floor(ph)
    return (ph < duty).to(torch.float32)


def _fold_uniform(k, data, lo=0.0, hi=1.0, shape=()):
    return prng.uniform(prng.fold_in(k, data), shape, lo, hi)


def _phase_draws(ks, k_phase, opts):
    """The per-sequence scalars of ``_phase_fields`` and of the cue batch's
    pattern options, as float32 numpy arrays of shape (B,)."""
    o = opts
    d = {}
    u = prng.uniform
    d["cy"] = _F32(o["h"] / 2) + u(ks[:, 0], (), -o["h"] / 8, o["h"] / 8)
    d["cx"] = _F32(o["w"] / 2) + u(ks[:, 1], (), -o["w"] / 8, o["w"] / 8)
    B = ks.shape[0]
    onset = np.zeros(B, _F32)
    gated = False
    if o["onset_range"] is not None:
        lo, hi = o["onset_range"]
        onset = np.floor(u(ks[:, 8], (), float(lo), float(hi) + 1.0))
        gated = True
    elif o["onset_hazard"] > 0.0:
        v = u(ks[:, 8], (), 1e-7, 1.0 - 1e-7)
        onset = np.floor(np.log1p(-v) / np.log1p(-_F32(o["onset_hazard"]))).astype(_F32)
        gated = True
    elif o["max_onset"]:
        onset = np.floor(u(ks[:, 8], (), 0.0, float(o["max_onset"]) + 1.0))
        gated = True
    d["onset"], d["gated"] = onset.astype(_F32), gated
    lo, hi = o["cue_period_range"]
    d["period"] = period = u(ks[:, 2], (), float(lo), float(hi))
    speed = u(ks[:, 3], (), o["speed_range"][0], o["speed_range"][1])
    if o["slow_range"] is not None:
        slow = _fold_uniform(ks[:, 3], 2, o["slow_range"][0], o["slow_range"][1])
        is_slow = _fold_uniform(ks[:, 3], 3) < _F32(o["slow_frac"])
        speed = np.where(is_slow, slow, speed)
    if o["cue_fine_speed_range"] is not None:
        lo, hi = o["cue_fine_speed_range"]
        fine = _fold_uniform(ks[:, 3], 4, lo, hi)
        speed = np.where(period < _F32(o["cue_fine_max_period"]), fine, speed)
    if o["move_prob"] < 1.0:
        mover = _fold_uniform(ks[:, 3], 1) < _F32(o["move_prob"])
        speed = speed * mover.astype(_F32)
    d["speed"] = speed.astype(_F32)
    theta = u(ks[:, 4], (), 0.0, 2 * math.pi)
    d["cos"], d["sin"] = np.cos(theta), np.sin(theta)
    d["n_seg"] = np.floor(u(ks[:, 5], (), 6.0, 20.0))
    d["ring_period"] = u(ks[:, 6], (), 14.0, 34.0)
    d["alternate"] = (u(ks[:, 7], ()) < _F32(0.5)).astype(_F32)
    if o["ring_speed_cue"] and not o["ring_dir_cue"]:
        raise ValueError("ring_speed_cue needs ring_dir_cue (the duty "
                         "margin is the speed cue)")
    if o["ring_dir_cue"]:
        cue_side = np.sign(_fold_uniform(ks[:, 7], 1) - _F32(0.5))
        cue_mag = _fold_uniform(ks[:, 7], 2, 0.08, 0.30)
        d["ring_duty"] = _F32(0.5) + cue_side * cue_mag
    else:
        d["ring_duty"] = np.full(B, 0.5, _F32)
    d["ring_onset_val"] = np.zeros(B, _F32)
    d["ring_clock"] = "raw"
    if o["ring_speed_range"] is not None:
        rs0, rs1 = o["ring_speed_range"]
        ring_speed = _fold_uniform(ks[:, 6], 1, rs0, rs1)
        if o["ring_speed_cue"]:
            cue_frac = np.clip((cue_mag - _F32(0.08)) / _F32(0.22), _F32(0.0), _F32(1.0))
            ring_speed = prng.fma32(_F32(rs1 - rs0), cue_frac, _F32(rs0))
        if o["ring_dir_cue"]:
            ring_dir = cue_side
        else:
            ring_dir = np.sign(_fold_uniform(ks[:, 6], 2) - _F32(0.5))
        d["ring_vel"] = (ring_dir * ring_speed).astype(_F32)
        if o["ring_onset_range"] is not None:
            rlo, rhi = o["ring_onset_range"]
            d["ring_onset_val"] = np.floor(_fold_uniform(ks[:, 8], 3, float(rlo), float(rhi) + 1.0))
            d["ring_clock"] = "own"
        elif o["ring_onset"] and o["onset_range"] is not None:
            d["ring_onset_val"] = d["onset"]
            d["ring_clock"] = "shared"
    d["rise"] = _fold_uniform(k_phase, 9, 0.7, 0.9)
    if o["tang_radial"]:
        d["duty_t"] = _fold_uniform(k_phase, 15, 0.6, 0.85)
    if o["band_prob"] > 0.0:
        kb = prng.fold_in(k_phase, 11)
        d["banded"] = prng.uniform(kb, ()) < _F32(o["band_prob"])
        d["band_duty"] = _fold_uniform(kb, 1, 0.55, 0.85)
    if o["ring_speed_range"] is not None and o["band_prob"] > 0.0 and not o["ring_dir_cue"]:
        d["duty_r"] = _fold_uniform(k_phase, 13, 0.55, 0.85)
    return d


def synthetic_cue_batch(
    key,
    batch,
    T,
    h,
    w,
    c,
    max_speed: float = 2.0,
    regime_probs=(0.15, 0.15, 0.15, 0.14, 0.14, 0.14, 0.13),
    cue_speed_range=(0.5, 2.5),
    max_onset: int = 0,
    move_prob: float = 1.0,
    cue_slow_range=None,
    cue_slow_frac: float = 0.0,
    onset_hazard: float = 0.0,
    ring_speed_range=None,
    band_prob: float = 0.0,
    onset_range=None,
    ring_onset: bool = False,
    ring_dir_cue: bool = False,
    ring_onset_range=None,
    cue_period_range=(12.0, 40.0),
    tang_radial: bool = False,
    tang_uniform: bool = False,
    cue_fine_speed_range=None,
    cue_fine_max_period: float = 12.0,
    ring_speed_cue: bool = False,
    return_regime: bool = False,
    *,
    device=None,
):
    """(batch, T, h, w, c) float32 cue sequences (v3) on ``device``
    (``None``: the card).

    ``return_regime=True`` also returns the per-sequence regime ids
    (batch,) int32 and motion-onset frames (batch,) float32, for masking
    loss terms by regime and by pre-onset frame.

    Regimes (drawn per sequence with ``regime_probs``): 0 smooth texture,
    static; 1 smooth texture, translating; 2 plain symmetric rings (static,
    or fast with ``ring_speed_range``); 3 linear sawtooth, translating
    toward its ramp; 4 tangential sawtooth rings (rotating; with
    ``tang_radial`` contracting, with ``tang_uniform`` at a uniform px/frame
    across radius); 5 radial sawtooth rings, expanding; 6 smooth texture
    masked to the disc, static.  The keywords are the JAX function's.
    """
    device = resolve_device(device)
    keys = prng.split(prng.split(key, batch), 5)  # (B, 5, 2)
    k_reg, k_tex, k_phase, k_col, k_con = (keys[:, i] for i in range(5))
    regime = prng.choice(k_reg, 7, np.asarray(regime_probs, _F32))

    # -- smooth-texture branches ----------------------------------------
    margin = int(max_speed * T) + 2
    vel = _fold_uniform(k_tex, 1, -max_speed, max_speed, (2,))
    vel = (vel * (regime == 1).astype(_F32)[:, None]).astype(_F32)
    smooth = _smooth_frames(k_tex, vel, T, h, w, c, margin, device)  # (B, T, h, w, c)

    # -- analytic phase-field branches ----------------------------------
    opts = dict(h=h, w=w, speed_range=cue_speed_range, max_onset=max_onset,
                move_prob=move_prob, slow_range=cue_slow_range, slow_frac=cue_slow_frac,
                onset_hazard=onset_hazard, ring_speed_range=ring_speed_range,
                onset_range=onset_range, ring_onset=ring_onset, ring_dir_cue=ring_dir_cue,
                ring_onset_range=ring_onset_range, cue_period_range=cue_period_range,
                tang_radial=tang_radial, cue_fine_speed_range=cue_fine_speed_range,
                cue_fine_max_period=cue_fine_max_period, ring_speed_cue=ring_speed_cue,
                band_prob=band_prob)
    d = _phase_draws(prng.split(k_phase, 9), k_phase, opts)

    def s(name):  # a per-sequence scalar as (B, 1, 1, 1)
        return torch.from_numpy(np.asarray(d[name], _F32)).to(device).view(-1, 1, 1, 1)

    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    yc = (yy - s("cy")[:, 0])[:, None]  # (B, 1, h, 1)
    xc = (xx - s("cx")[:, 0])[:, None]  # (B, 1, 1, w)
    r = torch.sqrt(xc**2 + yc**2) + 1e-6  # (B, 1, h, w)
    phi = torch.atan2(yc.expand_as(r), xc.expand_as(r))
    t_raw = torch.arange(T, dtype=torch.float32, device=device)[None, :, None, None]
    t = torch.clamp(t_raw - s("onset"), min=0.0) if d["gated"] else t_raw

    period, speed, n_seg = s("period"), s("speed"), s("n_seg")
    ring_period = s("ring_period")
    ring_idx = torch.floor(r / ring_period)
    alternate = s("alternate") > 0
    ring_sign = torch.where(alternate, 1.0 - 2.0 * torch.remainder(ring_idx, 2.0), 1.0)
    u_linear = (xc * s("cos") + yc * s("sin") - speed * t) / period
    if tang_radial:
        ring_idx_t = torch.floor((r + speed * t) / ring_period)
        ring_sign_t = torch.where(alternate, 1.0 - 2.0 * torch.remainder(ring_idx_t, 2.0), 1.0)
        u_tang = ring_sign_t * phi * n_seg / _TWO_PI
    elif tang_uniform:
        omega_r = speed / torch.clamp(r, min=4.0)
        u_tang = ring_sign * (phi - omega_r * ring_sign * t) * n_seg / _TWO_PI
    else:
        omega = speed / (_F32(0.3) * _F32(min(h, w)))
        u_tang = ring_sign * (phi - omega * ring_sign * t) * n_seg / _TWO_PI
    u_radial = (r - speed * t) / period
    if ring_speed_range is None:
        u_rings = r / ring_period
    else:
        t_ring = {"raw": t_raw, "shared": t,
                  "own": torch.clamp(t_raw - s("ring_onset_val"), min=0.0)}[d["ring_clock"]]
        u_rings = (r - s("ring_vel") * t_ring) / ring_period
    u_ring_mask = (r + speed * t) / ring_period if tang_radial else r / ring_period
    mask_ring = u_ring_mask - torch.floor(u_ring_mask)
    mask_spoke = phi * n_seg / _TWO_PI
    mask_spoke = mask_spoke - torch.floor(mask_spoke)

    rise = s("rise")
    f_tang = _asym_ramp(u_tang, rise)
    f_rad = _asym_ramp(u_radial, rise)
    if tang_radial:
        keep_t = (mask_ring < s("duty_t")).to(torch.float32)
        f_tang = f_tang * keep_t + (1.0 - keep_t)
    if band_prob > 0.0:
        banded = torch.from_numpy(d["banded"]).to(device).view(-1, 1, 1, 1)
        duty = s("band_duty")
        spoke_keep = (mask_spoke < duty).to(torch.float32)
        if not tang_radial:
            ring_keep = (mask_ring < duty).to(torch.float32)
            f_tang = torch.where(banded, f_tang * ring_keep + (1 - ring_keep), f_tang)
        f_rad = torch.where(banded, f_rad * spoke_keep + (1 - spoke_keep), f_rad)
    if ring_speed_range is not None and band_prob > 0.0:
        tri_spoke = 1.0 - torch.abs(2.0 * mask_spoke - 1.0)
        ring_phase = u_rings - torch.floor(u_rings)
        duty_r = s("ring_duty") if ring_dir_cue else s("duty_r")
        keep = (ring_phase < duty_r).to(torch.float32)
        f_rings = tri_spoke * keep + (1.0 - keep)
    else:
        f_rings = _sym_rings(u_rings, s("ring_duty"))
    rmax = _F32(0.48) * _F32(min(h, w))
    disc = ((r > 8.0) & (r < float(rmax))).to(torch.float32)  # (B, 1, h, w)
    f_tang = f_tang * disc + (1 - disc)
    f_rad = f_rad * disc + (1 - disc)
    f_rings = f_rings * disc + (1 - disc)
    reg = torch.from_numpy(regime.astype(np.int64)).to(device).view(-1, 1, 1, 1)
    value = torch.where(reg == 3, _asym_ramp(u_linear, rise),
                        torch.where(reg == 4, f_tang, torch.where(reg == 5, f_rad, f_rings)))
    value = value.expand(batch, T, h, w)

    # colour mapping: per-channel affine ramps
    lo = prng.uniform(k_col, (c,), 0.0, 0.35)
    hi = _fold_uniform(k_col, 1, 0.65, 1.0, (c,))
    lo_t = torch.from_numpy(lo).to(device).view(batch, 1, 1, 1, c)
    hi_t = torch.from_numpy(hi).to(device).view(batch, 1, 1, 1, c)
    patterned = lo_t + (hi_t - lo_t) * value[..., None]  # (B, T, h, w, c)

    disc_c = disc[..., None]  # (B, 1, h, w, 1)
    static_disc = (smooth[:, :1] * disc_c + (1 - disc_c)).expand_as(smooth)
    use_smooth = (reg <= 1).to(torch.float32)[..., None]
    use_disc = (reg == 6).to(torch.float32)[..., None]
    out = use_smooth * smooth + use_disc * static_disc + (1 - use_smooth - use_disc) * patterned
    gain = torch.from_numpy(prng.uniform(k_con, (), 0.7, 1.0)).to(device).view(-1, 1, 1, 1, 1)
    off = torch.from_numpy(_fold_uniform(k_con, 1, 0.0, 0.3)).to(device).view(-1, 1, 1, 1, 1)
    frames = torch.clamp(out * gain + off * (1 - gain), 0.0, 1.0)
    if not return_regime:
        return frames
    eff_onset = np.where(regime == 2, d["ring_onset_val"], d["onset"]).astype(_F32)
    return (frames, torch.from_numpy(regime.astype(np.int32)).to(device),
            torch.from_numpy(eff_onset).to(device))
