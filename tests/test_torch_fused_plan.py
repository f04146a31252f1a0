"""The fused kernel's host-side plan and its wgmma body's walk, on the CPU.

``ops/convlstm_fused.py::plan`` picks, per launch, the body of
``csrc/convlstm_fused.cu`` and, for the wgmma body, the tile and channel
group; ``block_rows`` and ``block_origins`` are the kernel's mapping of a
block's 128 M rows and of ``blockIdx.x`` to output pixels.  The card cannot
be asked here, so these tests check that mapping at the shapes the port
runs (every output pixel and channel once, the TMA's boxes and their zero
fill right), and run a torch model of the body's chunk and tap walk — the
halo slab as the TMA fills it, each tap a shifted run of slab rows, two
levels of float32 sums — against the plain version and the JAX package's
Pallas kernel in interpret mode.  ``test_torch_cuda.py`` holds the kernel
itself against the plain version on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.ops.convlstm_fused_pallas import (
    fused_convlstm_layer_multi as jax_fused_multi,
)
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import Plan, pack_gate_weight
from evolutionary_illusion_generator_tpu_torch.scripts import fused_breakdown as fb

torch.set_num_threads(1)

# the emulation and the plain version take the same bfloat16 products and
# sum them in float32 in other orders (as test_torch_kernels.py's CONV_ATOL)
CONV_ATOL = 1e-5
KC = 16  # input channels a chunk

# (B, H, W, C) of the port's fused layers: the main path's chunk of 8 at
# 160x120, the north star's chunk of 25 at 640x480, the composition's shard
# of 8 at 1280x960, the grayscale stack 1,16,32,64 (its C 32 and 64 layers)
# at the main path's frame, and the ragged shape of chip_smoke.py
SHAPES = {
    "main1": (8, 60, 80, 48), "main2": (8, 30, 40, 96), "main3": (8, 15, 20, 192),
    "north1": (25, 240, 320, 48), "north2": (25, 120, 160, 96), "north3": (25, 60, 80, 192),
    "comp1": (8, 480, 640, 48), "comp2": (8, 240, 320, 96), "comp3": (8, 120, 160, 192),
    "gray2": (8, 30, 40, 32), "gray3": (8, 15, 20, 64),
    "ragged": (2, 13, 21, 24),
}


def _coverage(p: Plan, B, H, W, C):
    """How often the kernel writes each (b, y, x), per channel group, and
    the channels the groups write."""
    pos, r, col, computed = cf.block_rows(p)
    org = cf.block_origins(p, B, H, W)
    y = org[:, 1:2] + r
    x = org[:, 2:3] + col
    written = computed & (y < H) & (x < W)
    b = org[:, 0:1].expand_as(y)
    counts = torch.zeros(B * H * W, dtype=torch.int32)
    counts.index_add_(0, ((b * H + y) * W + x)[written],
                      torch.ones(int(written.sum()), dtype=torch.int32))
    groups = -(-C // p.cg)
    channels = [c for g in range(groups) for c in range(g * p.cg, (g + 1) * p.cg) if c < C]
    return counts, channels


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_covers_every_pixel_and_channel_once(shape):
    B, H, W, C = SHAPES[shape]
    p = cf.plan(B, H, W, C)
    assert p.body == "wgmma" and p.cg in cf.CHANNEL_GROUPS
    assert (p.tile_h, p.tile_w, p.wg_stride) in cf.tile_shapes(W)
    counts, channels = _coverage(p, B, H, W, C)
    assert torch.equal(counts, torch.ones_like(counts))
    assert channels == list(range(C))
    # every tile starts inside its image
    org = cf.block_origins(p, B, H, W)
    assert bool(((org[:, 1] < H) & (org[:, 2] < W)).all())


@pytest.mark.parametrize("tile", cf.tile_shapes(70))
def test_tile_shapes_map_rows_into_the_slab(tile):
    """Each tile shape: its M rows are slab positions p = r * slab_w + col,
    every output pixel of the tile is one M row, the box fits the ring
    stage, and so do the rows the nine taps read (p + ky * slab_w + kx)."""
    p = Plan("wgmma", 48, *tile)
    sw = p.tile_w + 2
    pos, r, col, computed = cf.block_rows(p)
    assert torch.equal(pos, r * sw + col)
    got = sorted(zip(r[computed].tolist(), col[computed].tolist()))
    assert got == [(i, j) for i in range(p.tile_h) for j in range(p.tile_w)]
    assert (p.tile_h + 2) * sw <= cf.SLAB_PIXELS
    assert int(pos.max()) + 2 * sw + 2 < cf.SLAB_PIXELS


def test_plan_takes_the_mma_sync_body_where_the_tma_cannot_go():
    assert cf.plan(2, 13, 21, 24, tma=False) == Plan("mma_sync", 16, 0,
                                                     cf.tile_width(2, 13, 21), 0)
    x = torch.zeros(1, 4, 4, 12, dtype=torch.bfloat16)
    w = torch.zeros(9, 4, 4, 12, dtype=torch.bfloat16)
    assert not cf.tma_ok([x], [w])  # 12 channels: 24-byte pixel rows
    x8 = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    w8 = torch.zeros(9, 4, 4, 8, dtype=torch.bfloat16)
    assert cf.tma_ok([x8], [w8])
    off = torch.zeros(x8.numel() + 1, dtype=torch.bfloat16)[1:].view(x8.shape)  # 2 bytes off
    assert not cf.tma_ok([off], [w8])


def test_plan_fills_the_sms_at_the_main_path():
    """The main path's three fused layers at a chunk of 8: layer 1 stages
    each source pixel once (cg 48 at C 48); layer 3 (15 x 20) fits one wave
    of blocks (4 channel groups x 24 tiles of 5 x 20)."""
    assert cf.plan(8, 60, 80, 48) == Plan("wgmma", 48, 3, 40, 64)
    assert cf.plan(8, 15, 20, 192) == Plan("wgmma", 48, 5, 20, 64)
    assert cf.plan(25, 240, 320, 48) == Plan("wgmma", 48, 2, 64, 66)


def emulate(srcs, wks, b, c_prev, p: Plan):
    """A torch model of the wgmma body: per channel group and tile, per
    chunk of 16 channels of one source (the sources in order), the halo
    slab as the TMA fills it (zeros outside the image and past cin; NaN past
    the box, where only rows that are not output pixels read), each tap's
    64 x 16 A rows a warpgroup at slab position wg * wg_stride + m + ky *
    slab_w + kx, the nine products of a chunk summed into fresh float32
    accumulators, then into float32 totals; the epilogue on the rows that
    are output pixels.  Returns (h, c) as the kernel writes them (NaN
    where it writes nothing)."""
    B, H, W, C = c_prev.shape
    sw, th = p.tile_w + 2, p.tile_h
    pos, r, col, computed = cf.block_rows(p)
    org = cf.block_origins(p, B, H, W)
    h_out = torch.full(c_prev.shape, float("nan"), dtype=c_prev.dtype)
    c_out = torch.full(c_prev.shape, float("nan"))
    ty, tx = -(-H // th), -(-W // p.tile_w)
    iy = org[:, 1:2] - 1 + torch.arange(th + 2)          # (tiles, th + 2) image rows
    ix = org[:, 2:3] - 1 + torch.arange(sw)              # (tiles, slab_w) image columns
    for c0 in range(0, C, p.cg):
        N, n_c = 4 * p.cg, min(p.cg, C - c0)
        tot = torch.zeros(len(org), 2 * cf.WG_ROWS, N)
        for x, wk in zip(srcs, wks):
            cin = x.shape[-1]
            # zero padding: one pixel around, and far enough past the last tile
            xp = torch.zeros(B, ty * th + 2, tx * p.tile_w + 2, -(-cin // KC) * KC)
            xp[:, 1:H + 1, 1:W + 1, :cin] = x.float()
            # the weight slice: rows n = 4 (c - c0) + gate, zeros past C and cin
            wt = torch.zeros(9, p.cg, 4, xp.shape[-1])
            wt[:, :n_c, :, :cin] = wk[:, c0:c0 + n_c].float()
            wt = wt.reshape(9, N, -1)
            for k0 in range(0, cin, KC):
                slab = xp[org[:, 0, None, None], iy[:, :, None] + 1, ix[:, None, :] + 1,
                          k0:k0 + KC]                      # (tiles, th + 2, slab_w, 16)
                flat = torch.full((len(org), cf.SLAB_PIXELS, KC), float("nan"))
                flat[:, :(th + 2) * sw] = slab.reshape(len(org), -1, KC)
                acc = torch.zeros_like(tot)
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    a = flat[:, pos + ky * sw + kx]        # (tiles, 128, 16)
                    acc += a @ wt[tap, :, k0:k0 + KC].T
                tot += acc
        gates = tot.view(len(org), -1, p.cg, 4) + torch.stack(
            [torch.cat([b.float()[g * C + c0:g * C + c0 + n_c], torch.zeros(p.cg - n_c)])
             for g in range(4)], dim=-1)
        y = org[:, 1:2] + r
        xx = org[:, 2:3] + col
        ok = computed & (y < H) & (xx < W)
        bb = org[:, 0:1].expand_as(y)
        g = gates[ok][:, :n_c]                             # (pixels, channels, gate)
        cp = c_prev[bb[ok], y[ok], xx[ok], c0:c0 + n_c].float()
        cn = torch.sigmoid(g[..., 1]) * cp + torch.sigmoid(g[..., 0]) * torch.tanh(g[..., 3])
        c_out[bb[ok], y[ok], xx[ok], c0:c0 + n_c] = cn
        h_out[bb[ok], y[ok], xx[ok], c0:c0 + n_c] = (
            torch.sigmoid(g[..., 2]) * torch.tanh(cn)).to(c_prev.dtype)
    return h_out, c_out


def _inputs(seed, B, H, W, cins, C, state=torch.float32):
    rng = np.random.default_rng(seed)
    srcs = [torch.as_tensor(rng.normal(0, 1, (B, H, W, ci)).astype(np.float32)).bfloat16()
            for ci in cins]
    ws = [rng.normal(0, 0.1, (3, 3, ci, 4 * C)).astype(np.float32) for ci in cins]
    b = torch.as_tensor(rng.normal(0, 0.1, 4 * C).astype(np.float32))
    c_prev = torch.as_tensor(rng.normal(0, 1, (B, H, W, C)).astype(np.float32)).to(state)
    return srcs, ws, b, c_prev


# (B, H, W, source channels, C, plan): the plan's own choice and the other
# channel groups and tile shapes, at ragged shapes (tiles past the image's
# edges, C not a multiple of the group, chunks past cin) and a layer's
EMULATED = {
    "ragged_planned": (2, 13, 21, (40, 8, 24), 24, None),
    "ragged_cg32_rows": (2, 13, 21, (40, 8, 24), 24, Plan("wgmma", 32, 2, 64, 66)),
    "ragged_cg48_narrow": (2, 13, 21, (40, 8, 24), 24, Plan("wgmma", 48, 32, 2, 64)),
    "ragged_cg16_wide": (2, 13, 21, (16, 24), 40, Plan("wgmma", 16, 2, 62, 64)),
    "layer3": (2, 15, 20, (64, 32), 48, None),
    "two_rows": (1, 5, 70, (16, 8), 8, Plan("wgmma", 16, 2, 64, 66)),
}


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_walk_matches_plain(case, state):
    B, H, W, cins, C, p = EMULATED[case]
    srcs, ws, b, c_prev = _inputs(17, B, H, W, cins, C, getattr(torch, state))
    wks = [pack_gate_weight(torch.as_tensor(w)) for w in ws]
    p = p or cf.plan(B, H, W, C)
    h, c = emulate(srcs, wks, b, c_prev, p)
    h_p, c_p = cf.convlstm_layer_plain(srcs, wks, b, c_prev)
    assert bool(torch.isfinite(c).all())  # every output written
    # h in bfloat16 state: a last-ulp float32 difference may flip its rounding
    atol = CONV_ATOL if state == "float32" else 2.0**-8
    torch.testing.assert_close(h.float(), h_p.float(), atol=atol, rtol=0)
    torch.testing.assert_close(c, c_p, atol=CONV_ATOL, rtol=0)


def test_emulated_walk_matches_pallas():
    """The wgmma body's walk against the JAX package's
    fused_convlstm_layer_multi (interpret mode), as test_torch_kernels.py
    holds the plain version."""
    B, H, W, cins, C = 2, 16, 12, (16, 8, 24), 8
    srcs, ws, b, c_prev = _inputs(3, B, H, W, cins, C)
    h_j, c_j = jax_fused_multi([jnp.asarray(s.float().numpy()) for s in srcs],
                               [jnp.asarray(w) for w in ws], jnp.asarray(b.numpy()),
                               jnp.asarray(c_prev.numpy()), rows_per_block=8, interpret=True)
    p = cf.plan(B, H, W, C)
    assert p.body == "wgmma"
    h, c = emulate(srcs, [pack_gate_weight(torch.as_tensor(w)) for w in ws], b, c_prev, p)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=CONV_ATOL, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=CONV_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(fb.VARIANTS))
def test_fused_breakdown_variants_apply(name):
    """Each timing variant of the wgmma body still finds its text in
    csrc/convlstm_fused.cu once (the script raises otherwise), and all but
    the kernel itself change it."""
    variant = fb.variant_source(name)
    assert (variant == fb._SOURCE.read_text()) == (name == "kernel")
    assert 'extern "C" int eigen_convlstm_fused_wgmma(' in variant
