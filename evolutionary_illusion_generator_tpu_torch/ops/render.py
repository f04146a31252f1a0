"""Batched CPPN image rendering (device).

The port of the JAX package's ``ops/render.py``: the reference rasterizer
semantics (get_image_from_cppn, generate_illusion.py:372-460) over a
population axis.

* color gradient=1: one output node per channel, masked to ``bg`` where the
  grid's whitespace sentinel ``x_mat == -1`` applies;
* color gradient=0: the first node quantized ``trunc(v*4)`` into the
  {white, R, G, B, black} palette;
* grayscale: single node, rounded when gradient=0.

Node outputs are clipped to [0, 1] BEFORE the mask and the uint8 cast, and
the cast truncates (``.to(torch.uint8)`` rounds toward zero, as the JAX
``astype(uint8)`` does) — the order of the JAX package, so the same float
values give the same bytes.
"""

from __future__ import annotations

import torch

__all__ = ["render_images", "render_equilum_images", "to_unit_float", "hsv_to_rgb"]


def render_images(node_outputs, x_mat, c_dim, bg=1, gradient=1):
    """Render a population of CPPN outputs to uint8 images.

    Args:
      node_outputs: (pop, num_outputs, h*w) float32 node values.
      x_mat: (h, w) grid plane; ``-1`` marks whitespace/background.
      c_dim: 1 (grayscale) or 3 (color).
      bg: background intensity, 1=white 0=black.
      gradient: 1 for continuous values, 0 for quantized palette.

    Returns:
      (pop, h, w, c_dim) uint8.
    """
    h, w = x_mat.shape
    pop = node_outputs.shape[0]
    mask = (x_mat == -1.0)[None, :, :]  # (1, h, w)

    if c_dim > 1:
        if gradient == 1:
            chans = node_outputs[:, :c_dim, :].reshape(pop, c_dim, h, w)
            chans = chans.movedim(1, -1)  # (pop, h, w, c)
            chans = torch.where(mask[..., None], float(bg), chans.clamp(0.0, 1.0))
            return (chans * 255.0).to(torch.uint8)
        # quantized 5-color palette
        v = node_outputs[:, 0, :].reshape(pop, h, w).clamp(0.0, 1.0)
        color = torch.floor(v * 4.0).to(torch.int32)  # 0..4
        # filled on the device, not copied from the host (capturable)
        full = torch.full((), 255, dtype=torch.int32, device=v.device)
        zero = torch.zeros((), dtype=torch.int32, device=v.device)
        r = torch.where((color == 0) | (color == 1), full, zero)
        g = torch.where((color == 0) | (color == 2), full, zero)
        b = torch.where((color == 0) | (color == 3), full, zero)
        img = torch.stack([r, g, b], dim=-1)
        img = torch.where(mask[..., None], bg * 255, img)
        return img.to(torch.uint8)

    v = node_outputs[:, 0, :].reshape(pop, h, w).clamp(0.0, 1.0)
    v = torch.where(mask, float(bg), v)
    if gradient == 0:
        v = torch.round(v)
    return (v * 255.0).to(torch.uint8)[..., None]


def to_unit_float(images_u8, dtype=torch.float32):
    """uint8 images -> [0, 1] floats (the PNG-decode the predictor sees)."""
    return images_u8.to(dtype) / 255.0


def hsv_to_rgb(hsv):
    """Vectorized HSV -> RGB on [0, 1] floats, last axis = (h, s, v)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def select(choices):
        # first matching sextant wins; i is always one of 0..5
        out = choices[-1]
        for k in range(len(choices) - 2, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def render_equilum_images(node_outputs, x_mat, bg=1):
    """Equiluminant (HSV) rasterizer: three output nodes are H, S, V,
    background-masked, then converted to RGB."""
    h, w = x_mat.shape
    pop = node_outputs.shape[0]
    mask = (x_mat == -1.0)[None, :, :, None]
    hsv = node_outputs[:, :3, :].reshape(pop, 3, h, w).movedim(1, -1)
    hsv = torch.where(mask, float(bg), hsv.clamp(0.0, 1.0))
    return (hsv_to_rgb(hsv) * 255.0).to(torch.uint8)
