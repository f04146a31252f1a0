"""The PredNet A and Ahat units (``ops/prednet_units.py``) against the JAX
package on the CPU, a CPU model of their kernels, and their place in
``prednet_step``.

On the CPU the wrappers run their plain versions (the ops ``prednet_step``
ran before the kernels), so the step stays bit-equal to that route; the
kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here :func:`emulate_ahat`
and :func:`emulate_a` model what ``csrc/prednet_units.cu`` computes: its
tile walk (strips of ``tw`` columns, tiles of 128 pixels, the halo slab with
its zero fill and image-edge rows), its order of sums (chunks of 16 input
channels, then the 9 taps, each tap a product of 16 channels) and its
rounding points (at the pixel layer's Ahat unit one float32 chain a sum, in
(ky, kx, ci) order), and the A unit's pooling from inside one tile.  Inputs and
weights are made by numpy from a seed and handed to both packages.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.models.prednet import model as jm
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, model
from evolutionary_illusion_generator_tpu_torch.ops import prednet_units as pu
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused as cf
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import (
    TILE_PIXELS,
    WG_ROWS,
    tile_width,
)
from evolutionary_illusion_generator_tpu_torch.scripts import units_breakdown as ub

torch.set_num_threads(1)

KC = 16  # input channels a chunk (csrc/common.cuh eigen::igemm::KC)

# The plain versions against the JAX ops, float32 compute: the same float32
# products summed in another order (XLA's against oneDNN's), last-bit
# differences of values up to about 4 (6.0e-7 measured).
F32_ATOL = 1e-5
# bfloat16 compute: such a last-bit difference may round a bfloat16 value the
# other way at any of the rounding points (the conv, + b, each difference),
# one bfloat16 ulp there, at most 2**-7 of that point's magnitude
# (:func:`_ulp_bound`), on at most BF16_DIFF_SHARE of the elements.
BF16_DIFF_SHARE = 0.01
# The emulation against the plain version in float32 compute: compensated
# sums of 16-product dots against oneDNN's float32 conv (3.6e-7 measured).
EMU_F32_ATOL = 1e-5
# The emulation and the plain version against float64 sums (float32 compute
# and state): each within EMU_F64_ATOL (6.6e-7 measured), and the
# emulation's mean error no larger than the plain version's (its
# compensated sums carry little more than each 16-product dot's own
# rounding: 0.24-0.78 times the plain version's measured).
EMU_F64_ATOL = 1e-5


def _rng_inputs(seed, B, H, W, cin, cout, cd, sd):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, H, W, cin)).astype(np.float32)
    a = rng.uniform(0, 1, (B, H, W, cout)).astype(np.float32)
    w = rng.normal(0, 1 / np.sqrt(9 * cin), (3, 3, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    td, ts = getattr(torch, cd), getattr(torch, sd)
    return (torch.from_numpy(x).to(ts), torch.from_numpy(a).to(td),
            pu.pack_unit_weight(torch.from_numpy(w)), torch.from_numpy(b).bfloat16(), w, b)


def _ulp_bound(*points):
    """One bfloat16 ulp at each rounding point: 2**-7 of each magnitude."""
    return sum(2.0**-7 * p.float().abs() for p in points) + 1e-6


def _held(got, want, cd, *points):
    """``got`` against ``want``: within F32_ATOL in float32 compute; in
    bfloat16 compute within one ulp at each rounding point, on at most
    BF16_DIFF_SHARE of the elements."""
    d = (got.float() - want.float()).abs()
    if cd == "float32":
        assert d.max().item() <= F32_ATOL, d.max().item()
        return
    assert bool((d <= _ulp_bound(*points)).all()), d.max().item()
    assert (d > 0).float().mean().item() <= BF16_DIFF_SHARE, (d > 0).float().mean().item()


# ---------------------------------------------------------------------------
# the plain versions against the JAX ops

# (B, H, W, C, layer0): the pixel layer (C 3, and 1 on the grayscale stack),
# a wide layer (C 48), and odd H and W
AHAT_CASES = {
    "pixel": (2, 12, 18, 3, True),
    "gray_pixel": (2, 12, 18, 1, True),
    "wide": (2, 6, 8, 48, False),
    "odd": (3, 7, 9, 12, False),
}


def _jax_ahat(r, w, b, a, layer0, cd, sd):
    jcd = getattr(jnp, cd)
    ahat = jm._conv(jnp.asarray(r.float().numpy(), jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                    jnp.asarray(b, jnp.bfloat16), jcd)
    ahat = jnp.clip(ahat, 0.0, 1.0) if layer0 else jax.nn.relu(ahat)
    aj = jnp.asarray(a.float().numpy(), jcd)
    e = jnp.concatenate([jax.nn.relu(ahat - aj), jax.nn.relu(aj - ahat)], axis=-1)
    conv = jm._conv(jnp.asarray(r.float().numpy(), jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                    jnp.zeros(w.shape[-1], jnp.bfloat16), jcd)
    return (torch.from_numpy(np.asarray(e.astype(getattr(jnp, sd)).astype(jnp.float32))),
            torch.from_numpy(np.asarray(ahat.astype(jnp.float32))),
            torch.from_numpy(np.asarray(conv.astype(jnp.float32))))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(AHAT_CASES))
def test_ahat_plain_matches_jax(case, cd):
    B, H, W, C, layer0 = AHAT_CASES[case]
    r, a, k, bt, w, b = _rng_inputs(len(case), B, H, W, C, C, cd, "bfloat16")
    e, pred = pu.ahat_error_unit(r, k, bt, a, layer0=layer0, compute_dtype=getattr(torch, cd),
                                 state_dtype=torch.bfloat16)
    want_e, want_ahat, conv = _jax_ahat(r, w, b, a, layer0, cd, "bfloat16")
    assert e.dtype == torch.bfloat16 and tuple(e.shape) == (B, H, W, 2 * C)
    both = torch.cat([a.float()] * 2, dim=-1)
    _held(e, want_e, cd, torch.cat([conv] * 2, -1), torch.cat([want_ahat] * 2, -1), both)
    if layer0:
        assert pred.dtype == torch.float32
        _held(pred, want_ahat, cd, conv, want_ahat)
    else:
        assert pred is None


# (B, H, W, C_in, C_out): the pixel layer's E (6 and 2 channels), a wide
# layer, odd H and W (floored, as F.max_pool2d and the JAX reduce_window)
A_CASES = {
    "pixel": (2, 12, 18, 6, 8),
    "gray_pixel": (2, 12, 18, 2, 4),
    "wide": (2, 6, 8, 96, 24),
    "odd": (3, 7, 9, 24, 12),
}


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(A_CASES))
def test_a_plain_matches_jax(case, cd):
    B, H, W, cin, cout = A_CASES[case]
    e, _, k, bt, w, b = _rng_inputs(len(case) + 1, B, H, W, cin, cout, cd, "bfloat16")
    got = pu.a_unit(e, k, bt, compute_dtype=getattr(torch, cd))
    jcd = getattr(jnp, cd)
    ej = jnp.asarray(e.float().numpy(), jnp.bfloat16)
    pre = jm._conv(ej, jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), jcd)
    want = jm._maxpool2(jax.nn.relu(pre))
    conv = jm._conv(ej, jnp.asarray(w, jnp.bfloat16), jnp.zeros(cout, jnp.bfloat16), jcd)
    conv_pool = jm._maxpool2(jnp.abs(conv))
    assert got.dtype == getattr(torch, cd) and tuple(got.shape) == (B, H // 2, W // 2, cout)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    _held(got, want, cd, torch.from_numpy(np.asarray(conv_pool.astype(jnp.float32))), want)


def test_unit_weights_round_trip_from_jax_hwio():
    """``params_from_numpy`` packs the JAX HWIO ``ahat_w`` and ``a_w`` of
    bfloat16 params into the kernels' (9, Cp, Cin) layout: the padded rows
    are zero, unpacking gives the OIHW weights back, and the weights go
    back to the JAX layout unchanged (the packed ones are never saved)."""
    layers = loader.init_params_numpy((3, 8, 12), seed=4)
    params = loader.params_from_numpy(layers, dtype=torch.bfloat16, device="cpu")
    for layer, p in zip(layers, params):
        for key in ("ahat", "a"):
            if f"{key}_w" not in layer:
                assert f"{key}_k" not in p
                continue
            hwio = torch.from_numpy(layer[f"{key}_w"])
            cin, cout = hwio.shape[2:]
            k = p[f"{key}_k"]
            assert k.dtype == torch.bfloat16 and tuple(k.shape) == (9, -(-cout // 4) * 4, cin)
            assert not k[:, cout:].any()
            for t in range(9):  # tap t = 3 ky + kx
                assert torch.equal(k[t, :cout], hwio[t // 3, t % 3].t().bfloat16())
            assert torch.equal(pu.unpack_unit_weight(k, cout), p[f"{key}_w"])
            assert torch.equal(pu.pack_unit_weight(p[f"{key}_w"].permute(2, 3, 1, 0)), k)
    back = loader.params_to_numpy(params)
    assert all(not k.endswith("_k") and not k.startswith("lstm_k_") for l in back for k in l)
    for l0, l1 in zip(layers, back):
        for k in ("ahat_w", "a_w"):
            if k in l0:
                np.testing.assert_array_equal(
                    l1[k], torch.from_numpy(l0[k]).bfloat16().float().numpy())
    # float32 params do not take the units' kernels: nothing packed
    f32 = loader.params_from_numpy(layers, dtype=torch.float32, device="cpu")
    assert not any(k in p for p in f32 for k in ("ahat_k", "a_k"))


# ---------------------------------------------------------------------------
# the kernels' model


def _blocks(rows, W, tw):
    """The tile mapping of eigen::igemm (block_tile): (x0, q0, r0) per
    block, strips of tw columns, tiles of TILE_PIXELS pixels of a strip's
    rows in order."""
    tiles = -(-rows * tw // TILE_PIXELS)
    return [(s * tw, k * TILE_PIXELS, k * TILE_PIXELS // tw)
            for s in range(-(-W // tw)) for k in range(tiles)]


def _tile_rows(tw):
    return TILE_PIXELS // tw if TILE_PIXELS % tw == 0 else (TILE_PIXELS + tw - 2) // tw + 1


def _emulate_conv(x, wk, b, cout, cd, H, tw):
    """The block walk of ``csrc/prednet_units.cu``'s conv over ``x`` (rows,
    W, Cin): the rows of one tiling (the batch's rows, image after image,
    or one image), H the image height.  Per block, the halo slab of rows r0
    - 1 .. and columns x0 - 1 .. x0 + tw (zeros outside the rows, the width
    and past Cin); per pixel, a tap whose row lies outside its own image
    reads zeros; per chunk of 16 channels and per tap, the 16-channel
    products of each output.  bfloat16 compute: a chunk's nine taps chained,
    then added to the float32 total; float32 compute: each tap's sums added
    to the total by compensated (Kahan) summation.  Returns, per block, the
    block's pixel indices and its values as the epilogue reads them
    (round(round(sum) + round(b)) in the compute dtype), and the valid
    pixel mask."""
    rows, W, cin = x.shape
    kc = -(-cin // KC) * KC
    th, sw = _tile_rows(tw), tw + 2
    xp = torch.zeros(rows + th + 2 + TILE_PIXELS, W + tw + 2, kc)
    xp[1:rows + 1, 1:W + 1, :cin] = x.float()
    cp = wk.shape[1]
    wt = torch.zeros(9, cp, kc)
    wt[:, :, :cin] = wk.float()
    rnd = (lambda t: t.to(cd).float())
    bias = torch.zeros(cp)
    bias[:cout] = rnd(b.float())
    m = torch.arange(TILE_PIXELS)
    out = []
    for x0, q0, r0 in _blocks(rows, W, tw):
        q = q0 + m
        row, xin = q // tw, q % tw
        y = row % H
        slab = xp[r0:r0 + th + 2, x0:x0 + sw]  # slab row 0 is row r0 - 1
        tot = torch.zeros(TILE_PIXELS, cp)
        comp = torch.zeros_like(tot)
        for k0 in range(0, kc, KC):
            acc = torch.zeros_like(tot)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                a_rows = slab[row - r0 + ky, xin + kx, k0:k0 + KC].clone()
                off = ((ky == 0) & (y == 0)) | ((ky == 2) & (y == H - 1))
                a_rows[off] = 0.0
                prod = a_rows @ wt[tap, :, k0:k0 + KC].T
                if cd == torch.float32:  # Kahan
                    yk = prod - comp
                    s = tot + yk
                    comp = (s - tot) - yk
                    tot = s
                else:
                    acc = acc + prod
            if cd != torch.float32:
                tot = tot + acc
        vals = rnd(rnd(tot - comp) + bias)
        valid = (row < rows) & (x0 + xin < W)
        out.append((x0, q0, r0, row, x0 + xin, valid, vals[:, :cout]))
    return out


def _emulate_direct(x, wk, b, cd):
    """The pixel layer's Ahat conv on the CUDA cores (C <= DIRECT_MAX_C) over
    ``x`` (B, H, W, C): each output's sum one float32 chain in (ky, kx, ci)
    order, starting from zero, taps outside the image adding nothing (a
    zero); the values round(round(sum) + round(b)) in the compute dtype, as
    one block of every pixel in ``_emulate_conv``'s form."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(B, H, W, C)
    for ky in range(3):
        for kx in range(3):
            for ci in range(C):
                acc = acc + xp[:, ky:ky + H, kx:kx + W, ci:ci + 1] * wk[ky * 3 + kx, :C, ci].float()
    rnd = (lambda t: t.to(cd).float())
    vals = rnd(rnd(acc) + rnd(b.float())).reshape(B * H * W, C)
    q = torch.arange(B * H * W)
    return [(0, 0, 0, q // W, q % W, torch.ones(B * H * W, dtype=torch.bool), vals)]


SLAB_PX = 264  # slab positions a ring stage holds (csrc/prednet_units_wgmma.cu)


def _tile_origins(B, H, W, th, tw):
    """(b, y0, x0) of each tile of a wgmma or im2col plan, in block order."""
    return [(i, y, x) for i in range(B) for y in range(0, H, th) for x in range(0, W, tw)]


def _emulate_wgmma(x, wk, b, cout, plan):
    """The wgmma body's walk over ``x`` (B, H, W, Cin): per tile of one
    image, the halo slab of (tile_h + 2) x (tile_w + 2) pixels at (y0 - 1,
    x0 - 1) with zeros outside the image and past Cin (the TMA's fill), NaN
    past the box (what a stage holds there is stale); the 128 M rows are
    slab positions (``convlstm_fused.block_rows``), a tap the same rows
    shifted by ky * slab_w + kx; per channel group of ``plan.n`` outputs and
    chunk of 16 channels, the 9 taps' 16-channel products chained into fresh
    sums, then added to the float32 total; the values round(round(total) +
    round(b)) in bfloat16.  Returns, per tile, (b, y0, x0, y, x, valid,
    values): the rows' output pixels, whether each is an output pixel of
    the tile inside the image, and their values (128, cout)."""
    B, H, W, cin = x.shape
    kc = -(-cin // KC) * KC
    th, tw, n = plan.tile_h, plan.tile_w, plan.n
    sw = tw + 2
    groups = -(-cout // n)
    xp = torch.zeros(B, H + th + 2, W + tw + 2, kc)
    xp[:, 1:H + 1, 1:W + 1, :cin] = x.float()
    wt = torch.zeros(9, groups * n, kc)
    wt[:, :wk.shape[1], :cin] = wk.float()
    rnd = (lambda t: t.to(torch.bfloat16).float())
    bias = torch.zeros(groups * n)
    bias[:cout] = rnd(b.float())
    pos, r, col, computed = cf.block_rows(plan)
    out = []
    for i, y0, x0 in _tile_origins(B, H, W, th, tw):
        slab = torch.full((SLAB_PX, kc), float("nan"))
        slab[:(th + 2) * sw] = xp[i, y0:y0 + th + 2, x0:x0 + sw].reshape(-1, kc)
        vals = []
        for g in range(groups):
            tot = torch.zeros(2 * WG_ROWS, n)
            for k0 in range(0, kc, KC):
                acc = torch.zeros_like(tot)
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    acc = acc + slab[pos + ky * sw + kx, k0:k0 + KC] @ \
                        wt[tap, g * n:(g + 1) * n, k0:k0 + KC].T
                tot = tot + acc
            vals.append(rnd(rnd(tot) + bias[g * n:(g + 1) * n]))
        y, xx = y0 + r, x0 + col
        out.append((i, y0, x0, y, xx, computed & (y < H) & (xx < W), torch.cat(vals, 1)[:, :cout]))
    return out


def _emulate_im2col(x, wk, b, cout, plan):
    """The A unit's im2col body over ``x`` (B, H, W, Cin <= IM2COL_MAX_CIN):
    per tile of tile_h x tile_w = 128 pixels (M row m = pixel (m / tile_w,
    m % tile_w)), each pixel's K row k = tap * Cin + ci from the zero-padded
    image, zeros to 64; four k16 steps chained in one sum; the values
    round(round(sum) + round(b)) in bfloat16.  Per tile as
    :func:`_emulate_wgmma`."""
    B, H, W, cin = x.shape
    th, tw, n = plan.tile_h, plan.tile_w, plan.n
    groups = -(-cout // n)
    xp = torch.zeros(B, H + th + 2, W + tw + 2, cin)
    xp[:, 1:H + 1, 1:W + 1] = x.float()
    K = 9 * cin
    wt = torch.zeros(groups * n, 64)
    wt[:cout, :K] = wk[:, :cout].float().permute(1, 0, 2).reshape(cout, K)
    rnd = (lambda t: t.to(torch.bfloat16).float())
    bias = torch.zeros(groups * n)
    bias[:cout] = rnd(b.float())
    m = torch.arange(2 * WG_ROWS)
    r, col = m // tw, m % tw
    out = []
    for i, y0, x0 in _tile_origins(B, H, W, th, tw):
        rows = torch.zeros(2 * WG_ROWS, 64)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            rows[:, tap * cin:(tap + 1) * cin] = xp[i, y0 + r + ky, x0 + col + kx]
        acc = torch.zeros(2 * WG_ROWS, groups * n)
        for s in range(4):
            acc = acc + rows[:, 16 * s:16 * s + 16] @ wt[:, 16 * s:16 * s + 16].T
        y, xx = y0 + r, x0 + col
        out.append((i, y0, x0, y, xx, (y < H) & (xx < W), rnd(rnd(acc) + bias)[:, :cout]))
    return out


def emulate_ahat(r, wk, b, a, layer0, cd, sd, plan):
    """What ``ahat_error_unit``'s kernel writes at ``plan``: the wgmma body
    (each image tiled on its own), the mma.sync body at strip width
    ``plan.tile_w`` (the batch's rows one tiling) or the direct body (one
    thread a pixel): E in the state dtype and the prediction, NaN where it
    writes nothing; raises if it writes a pixel twice."""
    B, H, W, C = r.shape
    x = r.to(torch.bfloat16)
    e = torch.full((B, H, W, 2 * C), float("nan"))
    pred = torch.full((B, H, W, C), float("nan"))
    written = torch.zeros(B, H, W, dtype=torch.int64)
    af = a.float()
    rnd = (lambda t: t.to(cd).float())
    if plan.body == "wgmma":
        blocks = [(torch.full_like(y, i), y, xx, valid, v)
                  for i, _, _, y, xx, valid, v in _emulate_wgmma(x, wk, b, C, plan)]
    else:
        rows = (_emulate_direct(x, wk, b, cd) if plan.body == "direct"
                else _emulate_conv(x.reshape(B * H, W, C), wk, b, C, cd, H, plan.tile_w))
        blocks = [(row // H, row % H, col, valid, v) for _, _, _, row, col, valid, v in rows]
    for i, y, xx, valid, v in blocks:
        i, y, xx, v = i[valid], y[valid], xx[valid], v[valid]
        ahat = v.clamp(0.0, 1.0) if layer0 else torch.relu(v)
        av = af[i, y, xx]
        e[i, y, xx] = torch.cat([torch.relu(rnd(ahat - av)), torch.relu(rnd(av - ahat))], -1)
        pred[i, y, xx] = ahat
        written[i, y, xx] += 1
    assert written.max().item() <= 1, "a pixel written twice"
    return e.to(sd), pred if layer0 else None


def _pool_tile(tile_vals, H2, W2, y0, x0):
    """A tile's pooled outputs, as the A unit's epilogue takes them: the
    max of each 2x2 quad of the tile's own values (horizontal pairs first,
    then the two rows), ReLU; (y2, x2, values) inside (H2, W2)."""
    v = tile_vals
    pairs = torch.maximum(v[:, 0::2], v[:, 1::2])
    pooled = torch.relu(torch.maximum(pairs[0::2], pairs[1::2]))
    ph, pw = pooled.shape[:2]
    y2 = (y0 // 2 + torch.arange(ph))[:, None].expand(ph, pw)
    x2 = (x0 // 2 + torch.arange(pw))[None, :].expand(ph, pw)
    ok = (y2 < H2) & (x2 < W2)
    return y2[ok], x2[ok], pooled[ok]


def emulate_a(e, wk, b, cd, plan):
    """What ``a_unit``'s kernel writes at ``plan``: the wgmma or im2col
    body (tiles of one image that start on even rows and columns, each
    tile's epilogue pooling its own 2x2 quads) or the mma.sync body at strip
    width ``plan.tile_w`` (each image its own tiling; quad (pr, pc) is tile
    pixels m, m + 1, m + tw, m + tw + 1 with m = 2 pr tw + 2 pc), writing
    the pooled output where it lies inside (H // 2, W // 2).  NaN where it
    writes nothing; raises if it writes an output twice."""
    B, H, W, cin = e.shape
    cout = b.shape[0]
    H2, W2 = H // 2, W // 2
    out = torch.full((B, H2, W2, cout), float("nan"))
    written = torch.zeros(B, H2, W2, dtype=torch.int64)
    if plan.body in ("wgmma", "im2col"):
        walk = _emulate_wgmma if plan.body == "wgmma" else _emulate_im2col
        th, tw = plan.tile_h, plan.tile_w
        for i, y0, x0, y, xx, _, v in walk(e.to(torch.bfloat16), wk, b, cout, plan):
            tile = torch.full((th, tw, cout), float("nan"))
            mine = (y - y0 < th) & (xx - x0 < tw) & (y >= y0) & (xx >= x0)
            if plan.body == "wgmma":
                _, r, col, computed = cf.block_rows(plan)
                mine = computed
            tile[(y - y0)[mine], (xx - x0)[mine]] = v[mine]
            y2, x2, pooled = _pool_tile(tile, H2, W2, y0, x0)
            out[i, y2, x2] = pooled
            written[i, y2, x2] += 1
        assert written.max().item() <= 1, "a pooled output written twice"
        return out.to(cd)
    tw = plan.tile_w
    half = tw // 2
    quad = torch.arange(TILE_PIXELS // 4)
    pr, pc = quad // half, quad % half
    m = 2 * pr * tw + 2 * pc
    for i in range(B):
        for x0, _, r0, _, _, _, v in _emulate_conv(e[i].to(torch.bfloat16), wk, b, cout, cd, H,
                                                   tw):
            v = torch.relu(v)
            pooled = torch.maximum(torch.maximum(v[m], v[m + 1]),
                                   torch.maximum(v[m + tw], v[m + tw + 1]))
            y2, x2 = r0 // 2 + pr, x0 // 2 + pc
            ok = (y2 < H2) & (x2 < W2)
            out[i, y2[ok], x2[ok]] = pooled[ok]
            written[i, y2[ok], x2[ok]] += 1
    assert written.max().item() <= 1, "a pooled output written twice"
    return out.to(cd)


def _other_plans(plan, unit, W, cout):
    """The plans of ``plan``'s body other than the shape's own, as a forced
    plan or another batch may give them (``tests/test_torch_cuda.py`` runs
    the same on the card): every channel group of the wgmma body at a row
    of 64 a warpgroup and narrow run-on tiles; the im2col body's tile
    widths and grids; the mma.sync body's strip widths."""
    if plan.body == "wgmma":
        tiles = [s for s in pu.unit_tiles(W, unit == "a") if s[1] in (2, 6, 7, 64)]
        return [pu.UnitPlan("wgmma", n, *tile, cluster=c) for n, _ in pu._n_groups(cout)
                for tile in tiles for c in (2, 4)]
    if plan.body == "im2col":
        return [pu.UnitPlan("im2col", plan.n, TILE_PIXELS // tw, tw, 0, blocks)
                for tw in pu.IM2COL_TILES for blocks in (1, 7)]
    if plan.body == "mma_sync":
        widths = pu.POOL_TILES if unit == "a" else (3, 5)
        return [pu.UnitPlan("mma_sync", tile_w=tw) for tw in widths if tw <= W or unit == "a"]
    return []


def _f64_ahat(r, wk, b, a, layer0):
    C = r.shape[-1]
    w = pu.unpack_unit_weight(wk, C).double()
    conv = F.conv2d(r.to(torch.bfloat16).double().permute(0, 3, 1, 2), w, padding=1)
    v = conv.permute(0, 2, 3, 1) + b.double()
    ahat = v.clamp(0.0, 1.0) if layer0 else torch.relu(v)
    return torch.cat([torch.relu(ahat - a.double()), torch.relu(a.double() - ahat)], -1)


def _f64_a(e, wk, b):
    w = pu.unpack_unit_weight(wk, b.shape[0]).double()
    conv = F.conv2d(e.to(torch.bfloat16).double().permute(0, 3, 1, 2), w, padding=1) + \
        b.double()[None, :, None, None]
    return F.max_pool2d(torch.relu(conv), 2, 2).permute(0, 2, 3, 1)


# (B, H, W, C or Cin, C_out): the pixel layer (the direct Ahat body, the
# im2col A body in bfloat16 compute), a layer of 40 channels (three chunks,
# the last ragged; the wgmma bodies in bfloat16 compute), odd H and W (C 12:
# the mma.sync Ahat body); each at the shape's plan and the other plans of
# its body
EMU_CASES = {
    "pixel": (3, 10, 14, 3, 8),
    "wide": (2, 9, 11, 40, 20),
    "odd": (3, 7, 13, 12, 6),
}


@pytest.mark.parametrize("types", ["bf16_bf16", "f32_bf16", "f32_f32"])
@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_emulation_matches_the_plain_versions(case, types):
    """The kernels' model against the plain versions: bit-equal but for
    sums rounded the other way (the held rule: one bfloat16 ulp at each
    rounding point, on at most BF16_DIFF_SHARE of the elements; within
    EMU_F32_ATOL in float32 compute), at the shape's plan and at the other
    plans of its body (channel groups, tiles, strip widths)."""
    B, H, W, C, cout = EMU_CASES[case]
    cd, sd = ("bfloat16" if t == "bf16" else "float32" for t in types.split("_"))
    tcd, tsd = getattr(torch, cd), getattr(torch, sd)
    r, a, k, bt, _, _ = _rng_inputs(7, B, H, W, C, C, cd, sd)
    conv = model._conv(r, pu.unpack_unit_weight(k, C), None, tcd)
    for layer0 in (True, False):
        want_e, want_p = pu.ahat_error_unit_plain(r, pu.unpack_unit_weight(k, C), bt, a,
                                                  layer0=layer0, compute_dtype=tcd,
                                                  state_dtype=tsd)
        v = model._conv(r, pu.unpack_unit_weight(k, C), bt, tcd)
        ahat = v.clamp(0.0, 1.0) if layer0 else torch.relu(v)
        own = pu.ahat_plan(B, H, W, C, tcd)
        for plan in [own] + _other_plans(own, "ahat", W, C):
            e, p = emulate_ahat(r, k, bt, a, layer0, tcd, tsd, plan)
            assert e.dtype == tsd and not torch.isnan(e.float()).any(), plan
            d = (e.float() - want_e.float()).abs()
            dp = (p - want_p).abs() if layer0 else torch.zeros(1)
            if cd == "float32":  # a flip of E's own rounding to a bfloat16 state
                assert bool((d <= EMU_F32_ATOL + (_ulp_bound(want_e) if sd == "bfloat16"
                                                  else 0)).all()), d.max().item()
                assert dp.max().item() <= EMU_F32_ATOL, dp.max().item()
            else:
                pts = [torch.cat([t.float()] * 2, -1) for t in (conv, ahat, a)]
                assert bool((d <= _ulp_bound(*pts)).all()), d.max().item()
                if layer0:
                    assert bool((dp <= _ulp_bound(conv, ahat)).all()), dp.max().item()
            assert (d > 0).float().mean().item() <= (1.0 if sd == cd == "float32"
                                                     else BF16_DIFF_SHARE)
    e = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (B, H, W, 2 * C))
                         .astype(np.float32)).to(tsd)
    w = torch.from_numpy(np.random.default_rng(9).normal(0, 1 / np.sqrt(18 * C),
                                                         (3, 3, 2 * C, cout)).astype(np.float32))
    k2, b2 = pu.pack_unit_weight(w), torch.linspace(-0.1, 0.1, cout).bfloat16()
    want = pu.a_unit_plain(e, pu.unpack_unit_weight(k2, cout), b2, compute_dtype=tcd)
    conv = F.max_pool2d(model._conv(e, pu.unpack_unit_weight(k2, cout), None, tcd)
                        .float().abs().permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    own = pu.a_plan(B, H, W, 2 * C, cout, tcd)
    for plan in [own] + _other_plans(own, "a", W, cout):
        got = emulate_a(e, k2, b2, tcd, plan)
        assert got.dtype == tcd and not torch.isnan(got.float()).any(), plan
        d = (got.float() - want.float()).abs()
        if cd == "float32":
            assert d.max().item() <= EMU_F32_ATOL, (plan, d.max().item())
        else:
            assert bool((d <= _ulp_bound(conv, want)).all()), (plan, d.max().item())
            assert (d > 0).float().mean().item() <= BF16_DIFF_SHARE


@pytest.mark.parametrize("types", ["bf16_bf16", "f32_bf16", "f32_f32"])
@pytest.mark.parametrize("C", [3, 1])
def test_pixel_layer_sums_in_the_cpu_conv_order(C, types):
    """At the pixel layer (C <= DIRECT_MAX_C) the model's Ahat unit sums
    each output in one float32 chain in (ky, kx, ci) order, the order of
    PyTorch's CPU conv at C 3: its E and prediction are the plain version's
    bit for bit, both activations (one thread a pixel: no tile, whatever
    the batch).  So the card's float32 prediction is
    the CPU reference's (the probe test of ``tests/test_torch_cuda.py``
    holds them on the card).  At C 1 the CPU conv takes another path, whose
    float32 sums round the other way on a few entries in 1,000 (0.9% of
    this prediction): held there by the rule of the other emulation tests,
    on at most BF16_DIFF_SHARE of the elements."""
    cd, sd = ("bfloat16" if t == "bf16" else "float32" for t in types.split("_"))
    tcd, tsd = getattr(torch, cd), getattr(torch, sd)
    B, H, W = 2, 12, 18
    r, a, k, bt, _, _ = _rng_inputs(31 + C, B, H, W, C, C, cd, sd)
    for layer0 in (True, False):
        want_e, want_p = pu.ahat_error_unit_plain(r, pu.unpack_unit_weight(k, C), bt, a,
                                                  layer0=layer0, compute_dtype=tcd,
                                                  state_dtype=tsd)
        for n in (B, 1):
            plan = pu.ahat_plan(n, H, W, C, tcd)
            assert plan.body == "direct"
            e, p = emulate_ahat(r, k, bt, a, layer0, tcd, tsd, plan)
            assert e.dtype == tsd
            if C == 3:
                assert torch.equal(e, want_e), layer0
                assert not layer0 or torch.equal(p, want_p)
                continue
            for got, want in ((e, want_e),) + (((p, want_p),) if layer0 else ()):
                d = (got.float() - want.float()).abs()
                tol = EMU_F32_ATOL + (_ulp_bound(want) if want.dtype == torch.bfloat16 else 0)
                assert bool((d <= tol).all()), d.max().item()
                assert (d > 0).float().mean().item() <= BF16_DIFF_SHARE


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_emulation_against_float64_sums(case):
    """Float32 compute and state: the model's E and pooled A within
    EMU_F64_ATOL of float64 sums, and on the mean no further from them than
    the plain version (PyTorch's float32 conv)."""
    B, H, W, C, cout = EMU_CASES[case]
    f32 = torch.float32
    r, a, k, bt, _, _ = _rng_inputs(11, B, H, W, C, C, "float32", "float32")
    ref = _f64_ahat(r, k, bt, a, False)
    got = emulate_ahat(r, k, bt, a, False, f32, f32, pu.ahat_plan(B, H, W, C, f32))[0]
    plain = pu.ahat_error_unit_plain(r, pu.unpack_unit_weight(k, C), bt, a, layer0=False,
                                     compute_dtype=f32, state_dtype=f32)[0]
    errs = [(t.double() - ref).abs() for t in (got, plain)]
    assert errs[0].max().item() <= EMU_F64_ATOL and errs[1].max().item() <= EMU_F64_ATOL
    assert errs[0].mean().item() <= errs[1].mean().item()
    e = torch.from_numpy(np.random.default_rng(12).uniform(0, 1, (B, H, W, 2 * C))
                         .astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(13).normal(0, 1 / np.sqrt(18 * C),
                                                          (3, 3, 2 * C, cout)).astype(np.float32))
    k2, b2 = pu.pack_unit_weight(w), torch.zeros(cout)
    ref = _f64_a(e, k2, b2)
    got = emulate_a(e, k2, b2, f32, pu.a_plan(B, H, W, 2 * C, cout, f32))
    plain = pu.a_unit_plain(e, pu.unpack_unit_weight(k2, cout), b2, compute_dtype=f32)
    errs = [(t.double() - ref).abs() for t in (got, plain)]
    assert errs[0].max().item() <= EMU_F64_ATOL and errs[1].max().item() <= EMU_F64_ATOL
    assert errs[0].mean().item() <= errs[1].mean().item()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_emulated_rows_do_not_follow_the_batch(cd):
    """A pixel's sums do not depend on the batch or the tile it falls in:
    the model on three images of a batch of five, at the other plans of the
    body, is bit-equal to those images of the whole batch (the image-edge
    rows keep a strip tile that crosses images from reading its neighbour;
    the wgmma tiles hold one image).  C 20 takes the mma.sync Ahat body, its
    E of 40 channels the wgmma A body in bfloat16 compute."""
    tcd = getattr(torch, cd)
    B, H, W, C, cout = 5, 9, 11, 20, 12
    r, a, k, bt, _, _ = _rng_inputs(21, B, H, W, C, C, cd, "bfloat16")
    bf16 = torch.bfloat16
    whole, _ = emulate_ahat(r, k, bt, a, False, tcd, bf16, pu.ahat_plan(B, H, W, C, tcd))
    own = pu.ahat_plan(3, H, W, C, tcd)
    for plan in [own] + _other_plans(own, "ahat", W, C):
        part, _ = emulate_ahat(r[1:4], k, bt, a[1:4], False, tcd, bf16, plan)
        assert torch.equal(whole[1:4], part), plan
    k2 = pu.pack_unit_weight(torch.randn(3, 3, 2 * C, cout, generator=torch.Generator()
                                         .manual_seed(2)) / 40)
    b2 = torch.zeros(cout)
    whole_a = emulate_a(whole, k2, b2, tcd, pu.a_plan(B, H, W, 2 * C, cout, tcd))
    own = pu.a_plan(3, H, W, 2 * C, cout, tcd)
    assert own.body == ("wgmma" if cd == "bfloat16" else "mma_sync")
    for plan in [own] + _other_plans(own, "a", W, cout):
        part_a = emulate_a(whole[1:4], k2, b2, tcd, plan)
        assert torch.equal(whole_a[1:4], part_a), plan


def test_every_pooling_quad_lies_inside_one_tile():
    """For every (H, W) up to 70 x 70 and every strip width the A unit's
    plan can pick (its tiles do not cross images): each 2x2 quad of a pooled
    output lies in one tile, and the tiles' epilogues write every pooled
    output exactly once (the index math of ``a_unit_kernel``)."""
    picked = set()
    for W in range(2, 71):
        for H in range(2, 71):
            picked.add(pu.pool_tile_width(H, W))
            for tw in pu.POOL_TILES:
                y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
                tile = (x // tw) * 10**6 + (y * tw + x % tw) // TILE_PIXELS
                q = tile[:H // 2 * 2, :W // 2 * 2]
                quads = q.reshape(H // 2, 2, W // 2, 2).transpose(0, 2, 1, 3).reshape(
                    H // 2, W // 2, 4)
                assert (quads == quads[..., :1]).all(), (H, W, tw)
                count = np.zeros((H // 2, W // 2), int)
                half = tw // 2
                quad = np.arange(TILE_PIXELS // 4)
                for x0, _, r0 in _blocks(H, W, tw):
                    y2, x2 = r0 // 2 + quad // half, x0 // 2 + quad % half
                    ok = (y2 < H // 2) & (x2 < W // 2)
                    np.add.at(count, (y2[ok], x2[ok]), 1)
                assert (count == 1).all(), (H, W, tw)
    assert picked <= set(pu.POOL_TILES) and len(picked) > 1


# ---------------------------------------------------------------------------
# the host's plan

# (H, W, C, C_above or None) of the plan tests: the main path's, the north
# star's and the grayscale stack's layers, and odd shapes (chip_smoke.py's
# UNIT_ODD; C not a multiple of 8; W below a tile; odd H and W)
PLAN_SHAPES = {
    "main0": (120, 160, 3, 48), "main1": (60, 80, 48, 96), "main2": (30, 40, 96, 192),
    "main3": (15, 20, 192, None), "north0": (480, 640, 3, 48), "north1": (240, 320, 48, 96),
    "north2": (120, 160, 96, 192), "north3": (60, 80, 192, None), "gray0": (120, 160, 1, 16),
    "gray1": (60, 80, 16, 32), "gray2": (30, 40, 32, 64), "odd": (13, 21, 12, 20),
    "odd_wide": (7, 9, 24, 12), "narrow": (5, 3, 8, 8),
}
TYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
         (torch.float32, torch.bfloat16), (torch.float32, torch.float32)]


def _plans(H, W, C, C_above, cd, sd, batches):
    """Every plan the wrappers take for these batches, with the other plans
    of each body, per unit."""
    out = {"ahat": set(), "a": set()}
    for B in batches:
        p = pu.ahat_plan(B, H, W, C, cd)
        out["ahat"].update([p] + _other_plans(p, "ahat", W, C))
        if C_above is not None:
            p = pu.a_plan(B, H, W, 2 * C, C_above, cd)
            out["a"].update([p] + _other_plans(p, "a", W, C_above))
    return out


@pytest.mark.parametrize("types", range(len(TYPES)))
def test_unit_body_never_follows_the_batch(types):
    """The body of each unit comes from its channels and compute dtype
    alone: the same for every batch of 1..25 and both state dtypes at every
    plan shape (a shard has the unsharded pass's shape but fewer images, and the
    bodies may round a 16-product dot differently).  In bfloat16 compute
    every layer of C >= 8 of the main path and the north star takes the
    wgmma body (the A unit's pixel layer the im2col body)."""
    cd, sd = TYPES[types]
    for name, (H, W, C, C_above) in PLAN_SHAPES.items():
        body = pu.unit_body("ahat", C, C, cd)
        assert {pu.ahat_plan(B, H, W, C, cd).body for B in range(1, 26)} == {body}, name
        if cd == torch.bfloat16 and name[:4] in ("main", "nort"):
            assert body == ("direct" if C <= pu.DIRECT_MAX_C else "wgmma"), name
        if C_above is None:
            continue
        body = pu.unit_body("a", 2 * C, C_above, cd)
        assert {pu.a_plan(B, H, W, 2 * C, C_above, cd).body for B in range(1, 26)} == {body}
        if cd == torch.bfloat16 and name[:4] in ("main", "nort"):
            assert body == ("im2col" if 2 * C <= pu.IM2COL_MAX_CIN else "wgmma"), name


def _covered(plan, unit, B, H, W):
    """How often each output pixel (B, H, W) is written at ``plan``: the
    wgmma body's computed rows inside the image (block_rows of each tile),
    the im2col body's 128 tile pixels, the mma.sync body's strips over the
    batch's rows (the A unit: one image's), the direct body's one thread a
    pixel."""
    count = np.zeros((B, H, W), int)
    if plan.body == "direct":
        count += 1
    elif plan.body == "mma_sync":
        rows = B * H if unit == "ahat" else H
        for x0, q0, _ in _blocks(rows, W, plan.tile_w):
            q = q0 + np.arange(TILE_PIXELS)
            row, x = q // plan.tile_w, x0 + q % plan.tile_w
            ok = (row < rows) & (x < W)
            flat = count.reshape(-1, W) if unit == "ahat" else count[0]
            np.add.at(flat, (row[ok], x[ok]), 1)
        if unit == "a":
            count[1:] = count[0]
    else:
        if plan.body == "wgmma":
            _, r, col, computed = (t.numpy() for t in cf.block_rows(plan))
            r, col = r[computed], col[computed]
        else:
            m = np.arange(TILE_PIXELS)
            r, col = m // plan.tile_w, m % plan.tile_w
        for _, y0, x0 in _tile_origins(1, H, W, plan.tile_h, plan.tile_w):
            y, x = y0 + r, x0 + col
            ok = (y < H) & (x < W)
            np.add.at(count[0], (y[ok], x[ok]), 1)
        count[1:] = count[0]
    return count


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_unit_plans_cover_every_output_pixel_once(name):
    """Every plan the wrappers take at batches 1, 3, 8 and 25 (and the other
    plans of the same body) computes every output pixel of both units
    exactly once, as the kernels' index math maps blocks to pixels; the
    wgmma plans are tiles the C entries take (a row of 64 a warpgroup, or
    run-on rows whose last pixel is M row 127 at most), of N in UNIT_N."""
    H, W, C, C_above = PLAN_SHAPES[name]
    for cd, sd in TYPES:
        plans = _plans(H, W, C, C_above, cd, sd, (1, 3, 8, 25))
        for unit, ps in plans.items():
            for plan in ps:
                assert (_covered(plan, unit, 2, H, W) == 1).all(), (unit, plan)
                if plan.body == "wgmma":
                    two_rows = (plan.tile_w, plan.wg_stride, plan.tile_h) == (64, 66, 2)
                    run_on = (plan.wg_stride == 64 and plan.tile_w + 2 <= 64
                              and plan.tile_h * (plan.tile_w + 2) <= 130)
                    assert (two_rows or run_on) and plan.n in pu.UNIT_N, plan
                    assert plan.cluster in (2, 4), plan
                    assert (plan.tile_h + 2) * (plan.tile_w + 2) <= SLAB_PX
                if plan.body == "im2col":
                    assert plan.tile_w in pu.IM2COL_TILES and plan.blocks >= 1
                    assert plan.tile_h * plan.tile_w == TILE_PIXELS


def test_every_pooling_quad_lies_in_one_wgmma_tile():
    """For (H, W) up to 70 x 70 and every tile of the A unit's wgmma and
    im2col bodies: the tiles start on even rows and columns and have even
    sides, so each 2x2 quad of a pooled output lies in one tile, and the
    tiles' epilogues (pooled pixel (y0 / 2 + pr, x0 / 2 + pc), pr < tile_h
    / 2, pc < tile_w / 2, inside (H // 2, W // 2)) write every pooled output
    exactly once."""
    for W in range(2, 71, 3):
        tiles = [(th, tw) for th, tw, _ in pu.unit_tiles(W, True)]
        tiles += [(TILE_PIXELS // tw, tw) for tw in pu.IM2COL_TILES]
        for H in range(2, 71, 5):
            y, x = np.meshgrid(np.arange(H // 2 * 2), np.arange(W // 2 * 2), indexing="ij")
            for th, tw in tiles:
                assert th % 2 == 0 and tw % 2 == 0, (th, tw)
                tile = (y // th) * 10**4 + x // tw
                quads = tile.reshape(H // 2, 2, W // 2, 2).transpose(0, 2, 1, 3)
                assert (quads == quads[..., :1, :1]).all(), (H, W, th, tw)
                count = np.zeros((H // 2, W // 2), int)
                pr, pc = np.meshgrid(np.arange(th // 2), np.arange(tw // 2), indexing="ij")
                for _, y0, x0 in _tile_origins(1, H, W, th, tw):
                    y2, x2 = y0 // 2 + pr, x0 // 2 + pc
                    ok = (y2 < H // 2) & (x2 < W // 2)
                    np.add.at(count, (y2[ok], x2[ok]), 1)
                assert (count == 1).all(), (H, W, th, tw)


class _Recorder:
    """A stand-in for the kernels' library: records each entry's name and
    arguments and returns 0 (launched)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("types", range(len(TYPES)))
def test_unaligned_or_odd_shapes_take_the_shape_only_plan(types, monkeypatch):
    """An odd shape goes where its shape sends it, never where a failure
    would: channels the TMA cannot address (not a multiple of 8) take the
    mma.sync body, C <= DIRECT_MAX_C the direct body, float32 compute the
    mma.sync body.  Tensors off their 16-byte alignment are handed to the
    kernel as aligned copies (a stand-in library records the entries and
    their pointers), at the same body and plan as aligned ones."""
    from evolutionary_illusion_generator_tpu_torch import _build

    cd, sd = TYPES[types]
    bf = cd == torch.bfloat16
    assert pu.ahat_plan(3, 13, 21, 12, cd).body == "mma_sync"
    assert pu.ahat_plan(3, 13, 21, 3, cd).body == "direct"
    assert pu.ahat_plan(3, 13, 21, 16, cd).body == ("wgmma" if bf else "mma_sync")
    assert pu.a_plan(3, 13, 21, 6, 8, cd).body == ("im2col" if bf else "mma_sync")
    assert pu.a_plan(3, 13, 21, 12, 8, cd).body == "mma_sync"
    assert pu.a_plan(3, 13, 21, 24, 20, cd).body == ("wgmma" if bf else "mma_sync")
    lib = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: lib)

    def off(t):  # a contiguous view one element past an allocation
        v = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
        return v.copy_(t)

    for C, cin, cout in ((16, 32, 8), (12, 24, 20), (3, 6, 8)):
        r, a, k, b, _, _ = _rng_inputs(5, 2, 9, 11, C, C, "bfloat16" if bf else "float32",
                                       "bfloat16" if sd == torch.bfloat16 else "float32")
        e = torch.rand(2, 9, 11, cin)
        k2 = pu.pack_unit_weight(torch.randn(3, 3, cin, cout))
        b2 = torch.zeros(cout)
        for views in (lambda t: t, off):
            lib.calls.clear()
            pu.launch_ahat(views(r), views(k), b, views(a), False, cd, sd, 0)
            pu.launch_a(views(e), views(k2), b2, cd, 0)
            (ahat_entry, ahat_args), (a_entry, a_args) = lib.calls
            plan = pu.ahat_plan(2, 9, 11, C, cd)
            assert ahat_entry == ("eigen_ahat_error_unit_wgmma" if plan.body == "wgmma"
                                  else "eigen_ahat_error_unit"), (C, plan)
            assert all(ptr % 16 == 0 for ptr in (ahat_args[0], ahat_args[1], ahat_args[6]))
            plan = pu.a_plan(2, 9, 11, cin, cout, cd)
            assert a_entry == {"wgmma": "eigen_a_unit_wgmma", "im2col": "eigen_a_unit_im2col",
                               "mma_sync": "eigen_a_unit"}[plan.body], (cin, plan)
            assert all(ptr % 16 == 0 for ptr in (a_args[0], a_args[1]))
            if plan.body != "mma_sync":
                assert a_args[-6 if plan.body == "wgmma" else -4] == plan.n


@pytest.mark.parametrize("name", list(ub.VARIANTS))
def test_units_breakdown_variants_apply(name):
    """Each timing variant of ``scripts/units_breakdown.py`` still finds its
    text in csrc/prednet_units_wgmma.cu once (the script raises otherwise),
    all but the kernel itself change it, and each layer it times takes a
    body of that file."""
    variant = ub.variant_source(name)
    assert (variant == ub._SOURCE.read_text()) == (name == "kernel")
    for entry in ub._ENTRIES:
        assert f'extern "C" int {entry}(' in variant
    for _, unit, B, H, W, cin, cout in ub.LAYERS:
        plan = pu.ahat_plan(B, H, W, cout) if unit == "ahat" else pu.a_plan(B, H, W, cin, cout)
        assert plan.body in ("wgmma", "im2col"), plan


# ---------------------------------------------------------------------------
# the step


def _params(channels, dtype="bfloat16", seed=3):
    layers = loader.init_params_numpy(channels, seed=seed)
    rng = np.random.default_rng(seed)
    for layer in layers:  # nonzero biases
        for k in layer:
            if k.endswith("_b"):
                layer[k] = rng.normal(0, 0.1, layer[k].shape).astype(np.float32)
    return loader.params_from_numpy(layers, dtype=getattr(torch, dtype), device="cpu")


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("channels", [(3, 8, 16), (1, 16, 32), (3, 48, 96)])
def test_step_on_the_cpu_is_unchanged_by_the_units(channels, cd, monkeypatch):
    """Three steps of the ``"fused"`` route, bfloat16 weights and state,
    from zero state (layer 2 of 3,48,96 on the fused kernel's plain
    version): every state tensor and
    prediction bit-equal to the route without the units (the plain
    versions, which ``prednet_step`` runs where the units do not apply:
    the ops it ran inline before the units)."""
    params = _params(channels)
    img = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (2, 16, 24, channels[0]))
                           .astype(np.float32))
    td = getattr(torch, cd)

    def run():
        state = model.init_state(2, 16, 24, channels, dtype=torch.bfloat16)
        preds = []
        for _ in range(3):
            state, pred = model.prednet_step(params, state, img, compute_dtype=td)
            preds.append(pred)
        return state, preds

    calls = []
    for name in ("ahat_error_unit", "a_unit"):
        fn = getattr(model, name)
        monkeypatch.setattr(model, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    new_state, new_preds = run()
    L = len(channels)
    assert calls.count("ahat_error_unit") == 3 * L and calls.count("a_unit") == 3 * (L - 1)
    monkeypatch.setattr(model, "UNIT_COMPUTE_DTYPES", ())  # the units do not apply
    old_state, old_preds = run()
    assert len(calls) == 3 * (2 * L - 1)
    for a, b in zip(new_preds, old_preds):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for a, b in zip(new_state, old_state):
        for k in "rce":
            assert a[k].dtype == b[k].dtype == torch.bfloat16 and torch.equal(a[k], b[k]), k


def _unit_layers(monkeypatch, params, state, img, **kw):
    """The layers whose Ahat unit took ``ahat_error_unit``, and how many A
    units took ``a_unit``."""
    seen = {"ahat": [], "a": 0}

    def ahat(r, *a, **k):
        seen["ahat"].append(r.shape[-1])
        return pu.ahat_error_unit(r, *a, **k)

    def a_unit(*a, **k):
        seen["a"] += 1
        return pu.a_unit(*a, **k)

    monkeypatch.setattr(model, "ahat_error_unit", ahat)
    monkeypatch.setattr(model, "a_unit", a_unit)
    model.prednet_step(params, state, img, **kw)
    monkeypatch.undo()
    return seen["ahat"], seen["a"]


@pytest.mark.parametrize("option,want", [
    ("default", ([3, 8, 16], 2)),
    ("compute_float32", ([3, 8, 16], 2)),
    ("subpixel_up", ([3, 8, 16], 2)),
    ("s2d_l0", ([8, 16], 1)),
    ("int8", ([], 0)),
    ("float32_weights", ([], 0)),
    ("compute_float16", ([], 0)),
    ("use_pallas_true", ([3, 8, 16], 2)),
    ("use_pallas_false", ([], 0)),
])
def test_dense_fused_layers_take_the_unit_kernels(option, want, monkeypatch):
    """The ``"fused"`` and ``True`` routes send every layer's A and Ahat
    units to the wrappers where the weights are bfloat16 and the compute
    dtype float32 or bfloat16; the s2d pixel layer (its lifted convs), int8
    params, float32 weights and the plain route keep their ops."""
    channels = (3, 8, 16)
    params = _params(channels, "float32" if option == "float32_weights" else "bfloat16")
    dtype = params[0]["lstm_w_e"].dtype
    kw = {"compute_dtype": {"compute_float32": torch.float32,
                            "compute_float16": torch.float16}.get(option, torch.bfloat16)}
    s2d = option == "s2d_l0"
    if option == "int8":
        params = model.quantize_params_int8(params)
        assert not any(k in p for p in params for k in ("ahat_k", "a_k"))
    elif option in ("s2d_l0", "subpixel_up"):
        params = model.with_layout_weights(params, **{option: True})
        kw[option] = True
    elif option.startswith("use_pallas"):
        kw["use_pallas"] = option == "use_pallas_true"
    state = model.init_state(2, 16, 24, channels, dtype=dtype, s2d_l0=s2d)
    img = torch.rand(2, 16, 24, channels[0])
    if s2d:
        img = model._s2d(img)
    assert _unit_layers(monkeypatch, params, state, img, **kw) == want


# ---------------------------------------------------------------------------
# the wrappers


def test_wrappers_check_their_inputs():
    r, a, k, bt, _, _ = _rng_inputs(1, 1, 4, 6, 3, 3, "bfloat16", "bfloat16")
    with pytest.raises(ValueError, match="kernel layout"):  # unpadded rows
        pu.ahat_error_unit(r, k[:, :3].contiguous(), bt, a, layer0=True)
    with pytest.raises(ValueError, match="kernel layout"):
        pu.ahat_error_unit(r, k.float(), bt, a, layer0=True)
    with pytest.raises(ValueError, match="is not"):  # A in another dtype
        pu.ahat_error_unit(r, k, bt, a.float(), layer0=True)
    with pytest.raises(ValueError, match="bias"):
        pu.ahat_error_unit(r, k, bt[:2], a, layer0=True)
    with pytest.raises(TypeError, match="compute_dtype"):
        pu.ahat_error_unit(r, k, bt, a.half(), layer0=True, compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="state_dtype"):
        pu.ahat_error_unit(r, k, bt, a, layer0=True, state_dtype=torch.float16)
    e = torch.zeros(1, 4, 6, 6)
    k2 = pu.pack_unit_weight(torch.zeros(3, 3, 6, 5))
    with pytest.raises(ValueError, match="kernel layout"):  # Cin does not match E
        pu.a_unit(e[..., :4], k2, torch.zeros(5))
    assert tuple(pu.a_unit(e, k2, torch.zeros(5)).shape) == (1, 2, 3, 5)


def test_wrappers_refuse_gradients_and_count_no_cpu_call():
    r, a, k, bt, _, _ = _rng_inputs(2, 1, 4, 6, 3, 3, "float32", "bfloat16")
    b = bt.float().requires_grad_(True)
    e = torch.rand(1, 4, 6, 6)
    k2 = pu.pack_unit_weight(torch.zeros(3, 3, 6, 5))
    n = (pu.ahat_error_unit.launches, pu.a_unit.launches)
    with pytest.raises(RuntimeError, match="has no backward"):
        pu.ahat_error_unit(r, k, b, a, layer0=True, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="has no backward"):
        pu.a_unit(e, k2, torch.zeros(5, requires_grad=True))
    with torch.no_grad():
        out, pred = pu.ahat_error_unit(r, k, b, a, layer0=True, compute_dtype=torch.float32)
    assert out.grad_fn is None and torch.isfinite(pred).all()
    assert (pu.ahat_error_unit.launches, pu.a_unit.launches) == n  # plain versions: no launch
    assert math.isfinite(float(pu.a_unit(e, k2, torch.zeros(5)).sum()))
