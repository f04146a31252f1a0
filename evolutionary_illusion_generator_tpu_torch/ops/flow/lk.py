"""Iterative pyramidal Lucas-Kanade (device, fixed-K corners).

The port of the JAX package's ``ops/flow/lk.py``, batched over a leading
image axis: per pyramid level, coarse to fine, each corner solves the 2x2
normal equations of ``min_d sum_win (I0(p + o) - I1(p + o + d))^2`` with a
fixed window and Newton iterations.  A subpixel-shifted window is a
bilinear mix of four integer-shifted windows, all cut from one
``(win+1, win+1)`` block per corner.

The JAX package cuts windows with ``jax.lax.dynamic_slice``, which first
adds the axis size to a NEGATIVE start (numpy-style) and then CLAMPS the
start into the image; torch indexing does neither, so :func:`_int_windows`
does both itself.  (A window whose start falls just above or left of the
image therefore reads the far edge, in both packages; the in-bounds gate
keeps such windows out of the first Newton solve but not out of later
iterations.)  The normal equations, the Newton steps, the flow state and
the residual gate stay float32.
"""

from __future__ import annotations

import torch

from .pyramid import build_pyramid, edge_pad

__all__ = ["pyramid_lk"]


def _scharr(img):
    """3x3 Scharr derivatives; img (B, H, W)."""
    p = edge_pad(img, 1)
    ix = (
        3.0 * (p[:, :-2, 2:] - p[:, :-2, :-2])
        + 10.0 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2])
        + 3.0 * (p[:, 2:, 2:] - p[:, 2:, :-2])
    ) / 32.0
    iy = (
        3.0 * (p[:, 2:, :-2] - p[:, :-2, :-2])
        + 10.0 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1])
        + 3.0 * (p[:, 2:, 2:] - p[:, :-2, 2:])
    ) / 32.0
    return ix, iy


def _int_windows(img, top_left, win: int):
    """(B, K, win, win) windows at integer [x, y] top-left corners
    ``top_left`` (B, K, 2), starts placed as ``dynamic_slice`` places them:
    a negative start counts from the end, then every start is clamped."""
    B, H, W = img.shape
    offs = torch.arange(win, device=img.device)
    y0, x0 = top_left[..., 1], top_left[..., 0]
    y0 = torch.where(y0 < 0, y0 + H, y0).clamp(0, H - win)
    x0 = torch.where(x0 < 0, x0 + W, x0).clamp(0, W - win)
    rows = (y0[..., None] + offs)[..., :, None]  # (B, K, win, 1)
    cols = (x0[..., None] + offs)[..., None, :]  # (B, K, 1, win)
    bidx = torch.arange(B, device=img.device)[:, None, None, None]
    return img[bidx, rows, cols]


def _subpix_windows(img, top_left_f, win: int):
    """(B, K, win, win) windows at FLOAT top-left corners: bilinear mix of
    the four integer-shifted windows (the offset is uniform across the
    window)."""
    tl0 = torch.floor(top_left_f)
    frac = top_left_f - tl0
    tl0 = tl0.to(torch.int64)
    # mix in the image dtype, as the JAX package does
    fx = frac[..., 0][..., None, None].to(img.dtype)
    fy = frac[..., 1][..., None, None].to(img.dtype)
    big = _int_windows(img, tl0, win + 1)
    w00 = big[..., :win, :win]
    w01 = big[..., :win, 1:]
    w10 = big[..., 1:, :win]
    w11 = big[..., 1:, 1:]
    return (
        w00 * (1 - fx) * (1 - fy)
        + w01 * fx * (1 - fy)
        + w10 * (1 - fx) * fy
        + w11 * fx * fy
    )


def _dot(a, b):
    """Windowed correlation with float32 accumulation."""
    return (a * b).float().sum(dim=(-2, -1))


def _track_level(img0, img1, pos, guess, win, iters, min_eig_threshold):
    """One pyramid level for all corners.

    pos: (B, K, 2) [x, y] corner coords at THIS level; guess: (B, K, 2)
    incoming flow.  Returns (flow, ok, in_bounds).  Corners whose source
    window leaves this level's image keep their incoming guess."""
    H, W = img0.shape[-2:]
    r = win // 2
    ix, iy = _scharr(img0)

    tl0 = pos - r  # float top-left of the I0 window
    in_bounds = (
        (tl0[..., 0] >= 0)
        & (tl0[..., 1] >= 0)
        & (tl0[..., 0] + win < W)
        & (tl0[..., 1] + win < H)
    )
    w_i0 = _subpix_windows(img0, tl0, win)
    w_ix = _subpix_windows(ix, tl0, win)
    w_iy = _subpix_windows(iy, tl0, win)

    gxx = _dot(w_ix, w_ix)
    gxy = _dot(w_ix, w_iy)
    gyy = _dot(w_iy, w_iy)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp_min(tr * tr - 4.0 * det, 0.0)))
    ok = min_eig / (win * win) > min_eig_threshold
    update = (ok & in_bounds)[..., None]
    safe_det = torch.where(det == 0, 1.0, det)
    max_step = float(win)  # a sane Newton step never exceeds the window

    d = guess
    for _ in range(iters):
        w_i1 = _subpix_windows(img1, tl0 + d, win)
        diff = w_i0 - w_i1
        bx = _dot(diff, w_ix)
        by = _dot(diff, w_iy)
        dx = (gyy * bx - gxy * by) / safe_det
        dy = (gxx * by - gxy * bx) / safe_det
        step = torch.clamp(torch.stack([dx, dy], dim=-1), -max_step, max_step)
        d = d + torch.where(update, step, 0.0)
    return d, ok, in_bounds


def pyramid_lk(gray0, gray1, positions, mask, *, levels: int = 3, win: int = 21,
               iters: int = 12, min_eig_threshold: float = 1e-4,
               max_residual: float = 1.0, dtype=torch.float32):
    """Track ``positions`` from gray0 to gray1.

    Args:
      gray0, gray1: (B, H, W) float images in [0, 1].
      positions: (B, K, 2) [x, y] corner coords (full resolution).
      mask: (B, K) validity of each corner.
      dtype: window/gather compute dtype; pyramids are built in float32.
    Returns:
      (flow, ok): flow (B, K, 2) [dx, dy] px; ok (B, K) = mask & trackable &
      still inside the image & window residual below ``max_residual``.
    """
    H, W = gray0.shape[-2:]
    # drop pyramid levels whose image cannot hold a (win+1) slice window
    while levels > 1 and min(H, W) // (2 ** (levels - 1)) < win + 2:
        levels -= 1
    pyr0 = [p.to(dtype) for p in build_pyramid(gray0, levels)]
    pyr1 = [p.to(dtype) for p in build_pyramid(gray1, levels)]

    flow = torch.zeros(positions.shape, dtype=torch.float32, device=positions.device)
    ok = mask
    for lvl in reversed(range(levels)):
        pos_l = positions / 2.0**lvl
        flow, ok_l, in_bounds = _track_level(
            pyr0[lvl], pyr1[lvl], pos_l, flow, win, iters, min_eig_threshold
        )
        if lvl == 0:
            # at full resolution the window must be valid; coarser levels may
            # legitimately lose border corners (the guess passes through)
            ok = ok & ok_l & in_bounds
        else:
            flow = flow * 2.0

    # reject tracks that left the image
    end = positions + flow
    inside = (
        (end[..., 0] >= 0)
        & (end[..., 0] <= W - 1)
        & (end[..., 1] >= 0)
        & (end[..., 1] <= H - 1)
    )

    # forward residual check: mean abs window difference at the solution
    tl = positions - win // 2
    w0 = _subpix_windows(gray0, tl, win)
    w1 = _subpix_windows(gray1, tl + flow, win)
    residual = torch.mean(torch.abs(w0 - w1), dim=(-2, -1))
    return flow, ok & inside & (residual < max_residual)
