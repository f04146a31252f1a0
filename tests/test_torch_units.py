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
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import TILE_PIXELS, tile_width

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


def emulate_ahat(r, wk, b, a, layer0, cd, sd, tw):
    """What ``ahat_error_unit_kernel`` writes at strip width ``tw`` (the
    batch's rows one tiling; one thread a pixel at C <= DIRECT_MAX_C): E in
    the state dtype and the prediction, NaN where it writes nothing."""
    B, H, W, C = r.shape
    x = r.to(torch.bfloat16).reshape(B * H, W, C)
    e = torch.full((B * H, W, 2 * C), float("nan"))
    pred = torch.full((B * H, W, C), float("nan"))
    af = a.float().reshape(B * H, W, C)
    rnd = (lambda t: t.to(cd).float())
    blocks = (_emulate_direct(x.reshape(B, H, W, C), wk, b, cd) if C <= pu.DIRECT_MAX_C
              else _emulate_conv(x, wk, b, C, cd, H, tw))
    for _, _, _, row, col, valid, v in blocks:
        row, col, v = row[valid], col[valid], v[valid]
        ahat = v.clamp(0.0, 1.0) if layer0 else torch.relu(v)
        av = af[row, col]
        e[row, col] = torch.cat([torch.relu(rnd(ahat - av)), torch.relu(rnd(av - ahat))], -1)
        pred[row, col] = ahat
    return (e.reshape(B, H, W, 2 * C).to(sd), pred.reshape(B, H, W, C) if layer0 else None)


def emulate_a(e, wk, b, cd, tw):
    """What ``a_unit_kernel`` writes at strip width ``tw``: each image its
    own tiling; each tile's epilogue takes the max of its own 2x2 quads
    (quad (pr, pc) is tile pixels m, m + 1, m + tw, m + tw + 1 with m = 2 pr
    tw + 2 pc) and writes the pooled output (r0 / 2 + pr, x0 / 2 + pc)
    where it lies inside (H // 2, W // 2).  NaN where it writes nothing;
    raises if it writes an output twice."""
    B, H, W, cin = e.shape
    cout = b.shape[0]
    H2, W2 = H // 2, W // 2
    out = torch.full((B, H2, W2, cout), float("nan"))
    written = torch.zeros(B, H2, W2, dtype=torch.int64)
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


# (B, H, W, C or Cin, C_out): the pixel layer, a layer of 40 channels (three
# chunks, the last ragged), odd H and W; each at the plan's strip widths
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
    EMU_F32_ATOL in float32 compute), at the wrappers' strip width and an
    odd one (Ahat), and at every strip width of the A unit's plan."""
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
        for tw in (tile_width(B, H, W), 3):
            e, p = emulate_ahat(r, k, bt, a, layer0, tcd, tsd, tw)
            assert e.dtype == tsd and not torch.isnan(e.float()).any()
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
    for tw in pu.POOL_TILES:
        got = emulate_a(e, k2, b2, tcd, tw)
        assert got.dtype == tcd and not torch.isnan(got.float()).any(), tw
        d = (got.float() - want.float()).abs()
        if cd == "float32":
            assert d.max().item() <= EMU_F32_ATOL, (tw, d.max().item())
        else:
            assert bool((d <= _ulp_bound(conv, want)).all()), (tw, d.max().item())
            assert (d > 0).float().mean().item() <= BF16_DIFF_SHARE


@pytest.mark.parametrize("types", ["bf16_bf16", "f32_bf16", "f32_f32"])
@pytest.mark.parametrize("C", [3, 1])
def test_pixel_layer_sums_in_the_cpu_conv_order(C, types):
    """At the pixel layer (C <= DIRECT_MAX_C) the model's Ahat unit sums
    each output in one float32 chain in (ky, kx, ci) order, the order of
    PyTorch's CPU conv at C 3: its E and prediction are the plain version's
    bit for bit, both activations, at the wrappers' strip width and an odd
    one (one thread a pixel: no tile).  So the card's float32 prediction is
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
        for tw in (tile_width(B, H, W), 5):
            e, p = emulate_ahat(r, k, bt, a, layer0, tcd, tsd, tw)
            assert e.dtype == tsd
            if C == 3:
                assert torch.equal(e, want_e), (layer0, tw)
                assert not layer0 or torch.equal(p, want_p), tw
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
    got = emulate_ahat(r, k, bt, a, False, f32, f32, tile_width(B, H, W))[0]
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
    got = emulate_a(e, k2, b2, f32, pu.pool_tile_width(H, W))
    plain = pu.a_unit_plain(e, pu.unpack_unit_weight(k2, cout), b2, compute_dtype=f32)
    errs = [(t.double() - ref).abs() for t in (got, plain)]
    assert errs[0].max().item() <= EMU_F64_ATOL and errs[1].max().item() <= EMU_F64_ATOL
    assert errs[0].mean().item() <= errs[1].mean().item()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_emulated_rows_do_not_follow_the_batch(cd):
    """A pixel's sums do not depend on the batch or the tile it falls in:
    the model on three images of a batch of five, at another strip width,
    is bit-equal to those images of the whole batch (the image-edge rows
    keep a tile that crosses images from reading its neighbour)."""
    tcd = getattr(torch, cd)
    B, H, W, C, cout = 5, 9, 11, 20, 12
    r, a, k, bt, _, _ = _rng_inputs(21, B, H, W, C, C, cd, "bfloat16")
    whole, _ = emulate_ahat(r, k, bt, a, False, tcd, torch.bfloat16, tile_width(B, H, W))
    part, _ = emulate_ahat(r[1:4], k, bt, a[1:4], False, tcd, torch.bfloat16, 5)
    assert torch.equal(whole[1:4], part)
    k2 = pu.pack_unit_weight(torch.randn(3, 3, 2 * C, cout, generator=torch.Generator()
                                         .manual_seed(2)) / 40)
    b2 = torch.zeros(cout)
    whole_a = emulate_a(whole, k2, b2, tcd, 8)
    part_a = emulate_a(whole[1:4], k2, b2, tcd, 4)
    assert torch.equal(whole_a[1:4], part_a)


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
    ("use_pallas_true", ([], 0)),
    ("use_pallas_false", ([], 0)),
])
def test_dense_fused_layers_take_the_unit_kernels(option, want, monkeypatch):
    """The ``"fused"`` route sends every layer's A and Ahat units to the
    wrappers where the weights are bfloat16 and the compute dtype float32
    or bfloat16; the s2d pixel layer (its lifted convs), int8 params,
    float32 weights and the other routes keep their ops."""
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
