"""The narrow layer's persistent body and the True route's gate convs on the
CPU: the host plan (the body from channels and dtype, never the batch; a
grid of whole waves of SMs; tiles that cover every pixel once; shared
memory that fits), the packed sources' K rows against a direct im2col, a
CPU model of the body's summation order against the plain version, and the
gate convs against the JAX package.  The kernels run on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); inputs are made by numpy
from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.models.prednet import model as jm
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
from evolutionary_illusion_generator_tpu_torch.models.prednet import model
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import SMS, pack_gate_weight
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import lstm_gates_plain
from evolutionary_illusion_generator_tpu_torch.scripts import narrow_breakdown as nb

torch.set_num_threads(1)


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# models of the persistent body (csrc/convlstm_narrow_hopper.cu): its tile
# walk, its K rows' order and its summation order


def persistent_tiles(plan, B, H, W):
    """The persistent body's tiles as its blocks walk them: for each block
    ``k`` of ``plan.blocks``, the (b, y0, x0) of tiles k, k + blocks, ...
    of the ``tile_h x tile_w`` tiles taken image by image, row by row."""
    tw = plan.tile_w
    th = cn.TILE_PIXELS // tw
    tx, ty = _cdiv(W, tw), _cdiv(H, th)
    tiles = [(t // (tx * ty), t // tx % ty * th, t % tx * tw) for t in range(B * tx * ty)]
    return [tiles[k::plan.blocks] for k in range(plan.blocks)]


def packed_taps(cs: int):
    """The K row of a packed source of ``cs`` channels: for k in
    0 .. 16 ceil(9 cs / 16), (dy, dx, ci) of product k (k = tap * cs + ci,
    tap = 3 dy + dx, the neighbour at (y + dy - 1, x + dx - 1)), or None
    past 9 cs (zeros).  The kernel builds a pixel's K row in this order
    (``build_k_row``), reading (dy, dx, ci) at offset ``dx * cs + ci`` of
    its halo row ``dy``."""
    out = []
    for k in range(16 * _cdiv(9 * cs, 16)):
        tap, ci = divmod(k, cs)
        out.append((tap // 3, tap % 3, ci) if tap < 9 else None)
    return out


def _k_rows(x, packed, coarse):
    """(B, H, W, K) float64: each pixel's K row of source ``x`` in the
    persistent body's order (packed, E and R: :func:`packed_taps`; in
    place, R_above: tap by tap, each tap's channels padded with zeros to a
    multiple of 16); a coarse source is read at ((y + dy - 1) // 2,
    (x + dx - 1) // 2)."""
    if coarse:
        x = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    B, H, W, cs = x.shape
    xp = torch.nn.functional.pad(x.double(), (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]
    if packed:
        rows = torch.cat(taps, -1)
        k = 16 * _cdiv(9 * cs, 16)
    else:
        c16 = 16 * _cdiv(cs, 16)
        rows = torch.cat([torch.nn.functional.pad(t, (0, c16 - cs)) for t in taps], -1)
        k = 9 * c16
    return torch.nn.functional.pad(rows, (0, k - rows.shape[-1]))


def _k_weight(wk, packed):
    """(K, 4C) float64: the packed weight ``(9, C, 4, cs)`` as the B matrix
    of :func:`_k_rows`' order, column n = 4 c + gate."""
    _, C, _, cs = wk.shape
    w = wk.double().permute(0, 3, 1, 2).reshape(9, cs, 4 * C)
    if packed:
        w = w.reshape(9 * cs, 4 * C)
        k = 16 * _cdiv(9 * cs, 16)
    else:
        c16 = 16 * _cdiv(cs, 16)
        w = torch.nn.functional.pad(w, (0, 0, 0, c16 - cs)).reshape(9 * c16, 4 * C)
        k = 9 * c16
    return torch.nn.functional.pad(w, (0, 0, 0, k - w.shape[0]))


def emulate(srcs, wks, b, c_prev):
    """A CPU model of the persistent body (bfloat16 compute): each source's
    products in its K order (:func:`_k_rows`), one float32 running sum
    over its k16 steps (each step's 16 products summed exactly, then added
    in float32, as one ``mma`` accumulates), rounded to bfloat16; E's +
    the bias, + R's, + R_above's, each add rounded; the float32 gate math;
    h and c in ``c_prev``'s dtype.  Returns (h, c, gates), gates gate-major
    ``[i | f | o | g]`` in bfloat16."""
    C = c_prev.shape[-1]
    assert C <= cn.PACKED_MAX_C, C
    gates, bias = None, b.bfloat16().reshape(4, C).t().reshape(-1)  # column n = 4 c + gate
    for i, (x, wk) in enumerate(zip(srcs, wks)):
        rows = _k_rows(x.to(torch.bfloat16), i < 2, i == 2)
        w = _k_weight(wk, i < 2)
        acc = torch.zeros(*rows.shape[:3], 4 * C, dtype=torch.float32)
        for s in range(0, rows.shape[-1], 16):
            acc = acc + (rows[..., s:s + 16] @ w[s:s + 16]).float()
        v = acc.bfloat16()
        gates = (v + bias) if gates is None else gates + v
    # n = 4 c + gate -> gate-major [i | f | o | g]
    gates = gates.reshape(*gates.shape[:3], C, 4).transpose(-1, -2).reshape(gates.shape)
    h, c = lstm_gates_plain(gates, c_prev, out_dtype=c_prev.dtype)
    return h, c, gates

BF16, F32 = torch.bfloat16, torch.float32
# (B, H, W, C, C_above): the bundled stacks' narrow layers at the main
# path's chunk and the north star's pixel layer, then odd shapes (a coarse
# width of 19, R_above of 12 channels, no R_above at an odd H and W)
PLAN_SHAPES = {
    "main": (8, 120, 160, 3, 48),
    "gray_pixel": (8, 120, 160, 1, 16),
    "gray_layer1": (8, 60, 80, 16, 32),
    "top": (8, 30, 40, 3, None),
    "north_star": (25, 480, 640, 3, 48),
    "odd_width": (3, 26, 38, 3, 48),
    "odd_r_above": (2, 14, 22, 16, 12),
    "odd_hw": (2, 9, 13, 1, None),
}


def _inputs(seed, B, H, W, C, C_above, state=BF16):
    rng = np.random.default_rng(seed)
    cins = [2 * C, C] + ([C_above] if C_above else [])
    shapes = [(B, H, W, 2 * C), (B, H, W, C)] + ([(B, H // 2, W // 2, C_above)] if C_above
                                                 else [])
    srcs = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).bfloat16() for s in shapes]
    w = rng.normal(0, 1 / np.sqrt(9 * sum(cins)), (3, 3, sum(cins), 4 * C)).astype(np.float32)
    bounds = np.cumsum([0] + cins)
    wks = [pack_gate_weight(torch.from_numpy(w[:, :, bounds[i]:bounds[i + 1]]))
           for i in range(len(cins))]
    b = rng.normal(0, 0.3, 4 * C).astype(np.float32)
    c_prev = torch.from_numpy(rng.normal(0, 1, (B, H, W, C)).astype(np.float32)).to(state)
    return srcs, wks, torch.from_numpy(b).bfloat16(), c_prev, w, b, cins


# ---------------------------------------------------------------------------
# the host plan


@pytest.mark.parametrize("C,C_above,body", [
    (3, 48, "persistent"), (1, 16, "persistent"), (3, None, "persistent"), (2, 24, "persistent"),
    (1, None, "persistent"), (16, 32, "mma_sync"), (8, 16, "mma_sync"), (3, 12, "mma_sync"),
    (16, 12, "mma_sync"), (31, 12, "mma_sync"), (5, 8, "mma_sync"), (24, 48, "mma_sync"),
])
def test_body_follows_channels_and_dtype_never_the_batch(C, C_above, body):
    """bfloat16 compute at the bundled stacks' pixel layers takes the
    persistent body, layer 1 of 1,16,32,64 (C 16) and float32 compute the
    mma.sync body, and the batch never moves the body."""
    assert cn.narrow_body(C, C_above, BF16) == body
    assert cn.narrow_body(C, C_above, F32) == "mma_sync"
    H, W = 24, 32
    for cd in (BF16, F32):
        for sd in (BF16, F32):
            got = {cn.narrow_plan(B, H, W, C, C_above, cd, sd).body for B in (1, 3, 8, 25)}
            assert got == {cn.narrow_body(C, C_above, cd)}


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_grid_is_whole_waves_of_sms_and_smem_fits(shape):
    B, H, W, C, C_above = PLAN_SHAPES[shape]
    for sd in (BF16, F32):
        p = cn.narrow_plan(B, H, W, C, C_above, BF16, sd)
        assert p.smem <= cn.SMEM_PER_BLOCK
        if p.body == "persistent":
            assert p.blocks % SMS == 0 and p.blocks >= SMS
            per = p.blocks // SMS
            assert per * (p.smem + cn.SMEM_RESERVED) <= cn.SMEM_PER_SM
            assert per <= cn.MAX_BLOCKS_PER_SM


@pytest.mark.parametrize("C,C_above", [(1, 16), (3, 48), (16, 32), (31, 12), (8, 16), (2, 24)])
def test_shared_memory_under_the_block_limit(C, C_above):
    """The plan's shared memory at C 1, 3, 16 and 31 (the mma.sync body)
    in both state types, at every tile width the persistent body may take
    (a width whose layout does not fit is never the plan's)."""
    for sd in (BF16, F32):
        p = cn.narrow_plan(8, 120, 160, C, C_above, BF16, sd)
        assert 0 < p.smem <= cn.SMEM_PER_BLOCK
        if p.body == "mma_sync":
            assert p.smem == cn.mma_sync_smem(C, p.tile_w)
            continue
        parts = cn.persistent_smem(C, C_above, p.tile_w, sd)
        assert parts["smem"] == p.smem == (parts["weights"] + cn.STAGES * parts["stage"]
                                           + parts["krows"] + parts["out"] + parts["bars"])
        assert all(v % 128 == 0 for v in parts.values())  # the TMA's 128-byte alignment
        # the weights resident once: 9 taps x 4C outputs x the sources' channels, padded
        assert parts["weights"] >= 9 * 4 * C * (3 * C + C_above) * 2


@pytest.mark.parametrize("shape", ["main", "top", "odd_width", "odd_hw"])
@pytest.mark.parametrize("tile_w", cn.PERSISTENT_TILES)
def test_tiles_cover_every_pixel_once(shape, tile_w):
    """The persistent body's tiles, as its blocks walk them (a grid of
    whole waves, and an odd grid), cover every output pixel exactly once;
    tiles start on even rows and columns (R_above's coarse halo)."""
    B, H, W, C, C_above = PLAN_SHAPES[shape]
    for blocks in (cn.persistent_plan(B, H, W, C, C_above, tile_w=tile_w).blocks, 7):
        plan = cn.NarrowPlan("persistent", tile_w, blocks)
        seen = np.zeros((B, H, W), np.int64)
        walked = persistent_tiles(plan, B, H, W)
        assert len(walked) == blocks
        th = 128 // tile_w
        for tiles in walked:
            for b, y0, x0 in tiles:
                assert y0 % 2 == 0 and x0 % 2 == 0
                seen[b, y0:y0 + th, x0:x0 + tile_w] += 1
        np.testing.assert_array_equal(seen, 1)


# ---------------------------------------------------------------------------
# the packed sources' K rows


def _im2col(x):
    """(B, H, W, 9 cs): each pixel's 3x3 SAME neighbourhood, tap by tap,
    channels inside a tap."""
    B, H, W, cs = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return np.concatenate([xp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)], -1)


def _staged_k_rows(x, tw):
    """The kernel's K rows of a packed source, index by index as
    ``csrc/convlstm_narrow_hopper.cu`` computes them: each tile's halo as
    the TMA's box of the (B, H, W cs) rows, (128 / tw + 2) rows from
    element (x0 - 1) cs - lead (lead = -cs mod 8: a box starts on 16
    bytes), 8 ceil((lead + (tw + 2) cs) / 8) elements wide, zeros outside
    the tensor (the image's edges); each K row read through
    :func:`packed_taps` at the pixel's left neighbour."""
    B, H, W, cs = x.shape
    rows = x.reshape(B, H, W * cs)
    th = 128 // tw
    lead = -cs % 8
    box = 8 * -(-(lead + (tw + 2) * cs) // 8)
    taps = packed_taps(cs)
    out = np.full((B, H, W, len(taps)), np.nan)
    for b in range(B):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                assert ((x0 - 1) * cs - lead) % 8 == 0  # the box starts on 16 bytes
                halo = np.zeros((th + 2, box))
                for hr in range(th + 2):
                    for i in range(box):
                        y, e = y0 - 1 + hr, (x0 - 1) * cs - lead + i
                        if 0 <= y < H and 0 <= e < W * cs:
                            halo[hr, i] = rows[b, y, e]
                for m in range(128):
                    pr, pc = divmod(m, tw)
                    if y0 + pr >= H or x0 + pc >= W:
                        continue
                    out[b, y0 + pr, x0 + pc] = [
                        halo[pr + t[0], lead + pc * cs + t[1] * cs + t[2]] if t else 0.0
                        for t in taps]
    return out


@pytest.mark.parametrize("cs", [1, 2, 3, 4, 6, 7])
def test_packed_taps_against_a_direct_im2col(cs):
    """The offset table (:func:`packed_taps`), as the
    kernel stages and reads it and as the CPU model lays it out, against a
    direct im2col of a seeded numpy input: K row k = tap * cs + ci, zeros
    to 16 ceil(9 cs / 16)."""
    x = np.random.default_rng(cs).uniform(-1, 1, (2, 7, 21, cs))
    want = _im2col(x)
    k16 = 16 * -(-9 * cs // 16)
    want = np.concatenate([want, np.zeros(want.shape[:3] + (k16 - 9 * cs,))], -1)
    taps = packed_taps(cs)
    assert len(taps) == k16 and taps[9 * cs:] == [None] * (k16 - 9 * cs)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    by_table = np.stack([xp[:, dy:dy + 7, dx:dx + 21, ci] if t else np.zeros((2, 7, 21))
                         for t in taps for dy, dx, ci in [t or (0, 0, 0)]], -1)
    np.testing.assert_array_equal(by_table, want)
    np.testing.assert_array_equal(_k_rows(torch.from_numpy(x), True, False).numpy(), want)
    for tw in cn.PERSISTENT_TILES:
        np.testing.assert_array_equal(_staged_k_rows(x, tw), want)


@pytest.mark.parametrize("cs", [8, 16, 24, 48])
def test_in_place_rows_and_the_coarse_halo(cs):
    """The in-place sources' K order (tap by tap, each tap's channels
    padded to 16) and R_above's coarse halo as the kernel addresses it:
    fine pixel (y0 + pr, x0 + pc) reads tap (dy, dx) at coarse halo row
    ((pr + dy - 1) >> 1) + 1 and column ((pc + dx - 1) >> 1) + 1 of the
    halo from (y0 / 2 - 1, x0 / 2 - 1): the 3x3 conv of the upsampled
    source, against its im2col."""
    rng = np.random.default_rng(cs)
    B, Hc, Wc = 2, 5, 11
    x = rng.uniform(-1, 1, (B, Hc, Wc, cs))
    up = x.repeat(2, 1).repeat(2, 2)
    c16 = 16 * -(-cs // 16)
    want = _im2col(up).reshape(B, 2 * Hc, 2 * Wc, 9, cs)
    want = np.concatenate([want, np.zeros(want.shape[:4] + (c16 - cs,))], -1).reshape(
        B, 2 * Hc, 2 * Wc, -1)
    np.testing.assert_array_equal(_k_rows(torch.from_numpy(x), False, True).numpy(), want)
    for tw in cn.PERSISTENT_TILES:
        th = 128 // tw
        got = np.full_like(want, np.nan)
        for b in range(B):
            for y0 in range(0, 2 * Hc, th):
                for x0 in range(0, 2 * Wc, tw):
                    halo = np.zeros((th // 2 + 2, tw // 2 + 2, c16))
                    for hr in range(th // 2 + 2):
                        for hc in range(tw // 2 + 2):
                            Y, X = y0 // 2 - 1 + hr, x0 // 2 - 1 + hc
                            if 0 <= Y < Hc and 0 <= X < Wc:
                                halo[hr, hc, :cs] = x[b, Y, X]
                    for pr in range(min(th, 2 * Hc - y0)):
                        for pc in range(min(tw, 2 * Wc - x0)):
                            got[b, y0 + pr, x0 + pc] = np.concatenate([
                                halo[((pr + dy - 1) >> 1) + 1, ((pc + dx - 1) >> 1) + 1]
                                for dy in range(3) for dx in range(3)])
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the CPU model of the summation order

# The model (:func:`emulate`: each source's K row, a float32
# running sum over its k16 steps, rounded to bfloat16, the adds rounded)
# and the plain version (oneDNN's float32 convs) sum each source in
# another order: where a sum lies at a bfloat16 rounding boundary the two
# round it apart, one ulp at that point.  Held: both within one ulp at each
# rounding point of the rounded float64 chain
# (:func:`convlstm_narrow.chain_float64`), and apart on at most
# MODEL_DIFF_SHARE of the elements.
MODEL_DIFF_SHARE = 0.01


@pytest.mark.parametrize("C,C_above", [(3, 8), (1, 16), (3, 48), (3, None), (2, 24), (1, None)])
@pytest.mark.parametrize("state", ["bfloat16", "float32"])
def test_emulated_order_against_the_plain_version(C, C_above, state):
    sd = getattr(torch, state)
    srcs, wks, b, c_prev, *_ = _inputs(C + 7, 2, 12, 18, C, C_above, sd)
    h, c, gates = emulate(srcs, wks, b, c_prev)
    ref = cn.narrow_convlstm_layer_plain(srcs, wks, b, c_prev, compute_dtype=BF16)
    chain = cn.chain_float64(srcs, wks, b, c_prev)
    for name, (hh, cc) in (("model", (h, c)), ("plain", ref)):
        assert hh.dtype == cc.dtype == sd
        assert ((hh.double() - chain["h"]).abs() <= chain["dh"]).all(), name
        assert ((cc.double() - chain["c"]).abs() <= chain["dc"]).all(), name
    for got, want in zip((h, c), ref):
        assert ((got.float() - want.float()).abs() > 1e-6).float().mean() <= MODEL_DIFF_SHARE
    plain_gates = cn.gate_convs_plain(srcs, wks, b, compute_dtype=BF16)
    assert gates.dtype == BF16 and gates.shape == plain_gates.shape
    assert (gates != plain_gates).float().mean() <= MODEL_DIFF_SHARE


# ---------------------------------------------------------------------------
# the True route's gate convs

# gate_convs on the CPU is its plain version: the split convs of the True
# route.  Against the JAX composition (``_conv`` per source, the upsampled
# R_above, the sum in the compute dtype): float32, the same float32 convs
# summed in another order (XLA's against oneDNN's), last-bit differences
# of gates up to about 3 (GATES_F32_ATOL); bfloat16, such a difference may
# round a source's sum the other way: one ulp at each rounding point of
# the chain (each source's conv, each partial sum; 2**-7 of the point's
# magnitude, :func:`_gate_points`), on at most GATES_DIFF_SHARE of the
# elements.
GATES_F32_ATOL = 1e-5
GATES_DIFF_SHARE = 0.01


def _gate_points(srcs, wks, b):
    """One bfloat16 ulp at each rounding point of the gates' chain, summed:
    2**-7 of |each source's conv| and |each partial sum|, from float64
    convs rounded as the chain rounds them."""
    xs = [x.double() for x in srcs]
    if len(xs) == 3:
        xs[2] = xs[2].repeat_interleave(2, 1).repeat_interleave(2, 2)
    g, err = b.double(), 0.0
    for x, wk in zip(xs, wks):
        v = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                       cn.unpack_gate_weight(wk).double(),
                                       padding=1).permute(0, 2, 3, 1).bfloat16().double()
        g = (g + v).bfloat16().double()
        err = err + 2.0**-7 * (v.abs() + g.abs())
    return err.numpy()


def _jax_gates(srcs_np, w, b, cins, cd):
    jcd = getattr(jnp, cd)
    wj = jnp.asarray(w, jnp.bfloat16)
    bounds = np.cumsum([0] + cins)
    ws = [wj[:, :, bounds[i]:bounds[i + 1]] for i in range(len(cins))]
    xs = [jnp.asarray(s, jcd) for s in srcs_np]
    gates = jm._conv(xs[0], ws[0], jnp.asarray(b, jnp.bfloat16), jcd)
    gates = gates + jm._conv_nobias(xs[1], ws[1], jcd)
    if len(xs) == 3:
        gates = gates + jm._conv_nobias(jm._upsample2(xs[2]), ws[2], jcd)
    return np.asarray(gates.astype(jnp.float32))


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("C,C_above", [(3, 8), (8, 16), (40, None), (48, 12)])
def test_gate_convs_match_the_jax_split_convs(C, C_above, cd):
    srcs, wks, bt, _, w, b, cins = _inputs(C, 2, 8, 12, C, C_above)
    srcs_np = [s.float().numpy() for s in srcs]
    want = _jax_gates(srcs_np, w, b, cins, cd)
    td = getattr(torch, cd)
    got = cn.gate_convs([s.to(td) for s in srcs], wks, bt, compute_dtype=td)
    assert got.dtype == td and tuple(got.shape) == (2, 8, 12, 4 * C)
    d = np.abs(got.float().numpy() - want)
    if cd == "float32":
        assert d.max() <= GATES_F32_ATOL, d.max()
    else:
        assert (d <= _gate_points(srcs, wks, bt) + 1e-6).all(), d.max()
        assert (d > 0).mean() <= GATES_DIFF_SHARE


@pytest.mark.parametrize("C", [1, 3, 12, 31, 32, 33, 48, 96, 192])
def test_gate_groups_cover_every_output_once(C):
    """The gate convs' launch: one block holds all 4C outputs below 32
    channels (N 16, 32, 64 or 128), else groups of 32 channels (N 128)
    along the grid, the last masked past C."""
    n, groups = cn.gate_groups(C)
    seen = np.zeros(C, np.int64)
    for c0, nc in groups:
        assert 0 < nc <= n // 4
        seen[c0:c0 + nc] += 1
    np.testing.assert_array_equal(seen, 1)
    assert n == (128 if C >= 32 else min(k for k in (16, 32, 64, 128) if 4 * C <= k))
    assert len(groups) == (-(-C // 32) if C >= 32 else 1)


def _params(channels):
    layers = loader.init_params_numpy(channels, seed=3)
    rng = np.random.default_rng(3)
    for layer in layers:  # nonzero biases
        for k in layer:
            if k.endswith("_b"):
                layer[k] = rng.normal(0, 0.1, layer[k].shape).astype(np.float32)
    return loader.params_from_numpy(layers, dtype=BF16, device="cpu")


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
def test_true_route_takes_the_gate_convs_bit_equal(cd, monkeypatch):
    """``use_pallas=True``: each layer's gates from ``gate_convs`` (the
    kernel on the card), then the gate kernel's wrapper; on the CPU three
    steps bit-equal to the split convs of ``model._gate_convs`` they
    replaced."""
    channels = (3, 8, 16)
    params = _params(channels)
    img = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (2, 16, 24, 3))
                           .astype(np.float32))
    td = getattr(torch, cd)
    calls = []
    gate_convs = model.gate_convs

    def spy(srcs, wks, b, **kw):
        calls.append(srcs[1].shape[-1])
        return gate_convs(srcs, wks, b, **kw)

    def run():
        state = model.init_state(2, 16, 24, channels, dtype=BF16)
        out = []
        for _ in range(3):
            state, pred = model.prednet_step(params, state, img, use_pallas=True,
                                             compute_dtype=td)
            out.append(pred)
        return state, out

    monkeypatch.setattr(model, "gate_convs", spy)
    new = run()
    assert calls == [16, 8, 3] * 3
    by_weight = {id(p["lstm_k_e"]): p for p in params}

    def split_convs(srcs, wks, b, compute_dtype):
        r_above = srcs[2] if len(srcs) == 3 else None
        return model._gate_convs(by_weight[id(wks[0])], {"e": srcs[0], "r": srcs[1]}, r_above,
                                 compute_dtype, False, False)

    monkeypatch.setattr(model, "gate_convs", split_convs)
    old = run()
    for a, b in zip(new[1], old[1]):
        assert torch.equal(a, b)
    for a, b in zip(new[0], old[0]):
        for k in "rce":
            assert torch.equal(a[k], b[k]), k


def test_gate_convs_checks_its_inputs_and_refuses_gradients():
    srcs, wks, b, *_ = _inputs(1, 2, 8, 12, 3, 8)
    with pytest.raises(ValueError, match="kernel layout"):
        cn.gate_convs(srcs, [wks[0].float()] + wks[1:], b)
    with pytest.raises(ValueError, match="R_above"):
        cn.gate_convs([x[:, :, :-1] for x in srcs[:2]] + [srcs[2]], wks, b)
    with pytest.raises(TypeError, match="compute_dtype"):
        cn.gate_convs(srcs, wks, b, compute_dtype=torch.float16)
    n = cn.gate_convs.launches
    with pytest.raises(RuntimeError, match="has no backward"):
        cn.gate_convs(srcs, wks, b.float().requires_grad_(True))
    with torch.no_grad():
        gates = cn.gate_convs(srcs, wks, b.float().requires_grad_(True))
    assert gates.grad_fn is None and cn.gate_convs.launches == n


# ---------------------------------------------------------------------------
# scripts/narrow_breakdown.py


@pytest.mark.parametrize("body,name", [(body, name) for body in nb.VARIANTS
                                       for name in nb.VARIANTS[body]])
def test_narrow_breakdown_variants_apply(body, name):
    """Each timing variant still finds its text once in its body's source
    (the script raises otherwise), all but the kernel change it, and the
    entry stays; the pixel layers it times take the persistent body, layer
    1 of 1,16,32,64 the mma.sync body."""
    files = nb.variant_sources(body, name)
    src, entry = nb.BODIES[body]
    same = all(text == (nb._CSRC / f).read_text() for f, text in files.items())
    assert same == (name == "kernel")
    assert f'extern "C" int {entry}(' in files[src]
    for _, B, H, W, C, C_above in nb.SHAPES:
        assert cn.narrow_plan(B, H, W, C, C_above).body == ("persistent" if C <= 3 else "mma_sync")


def test_traces_name_both_bodies_and_the_gate_convs():
    """The profile's wrappers: the narrow layer's persistent and mma.sync
    kernels both count for ``narrow_convlstm_layer``, the gate convs'
    kernel for ``gate_convs``, neither as a library conv."""
    from evolutionary_illusion_generator_tpu_torch.utils.profiling import by_wrapper

    events = [
        ("void (anonymous namespace)::convlstm_narrow_persistent_kernel<3, 16, __nv_bfloat16>"
         "(Params)", 22, 1e3),
        ("void (anonymous namespace)::convlstm_narrow_kernel<16, float, float>(Params)", 2, 1e2),
        ("void (anonymous namespace)::gate_convs_kernel<128, __nv_bfloat16>(Params, "
         "__nv_bfloat16*)", 66, 2e3),
    ]
    got = by_wrapper(events)
    assert got["narrow_convlstm_layer"] == {"count": 24, "ms": 1.1}
    assert got["gate_convs"] == {"count": 66, "ms": 2.0}
    assert got["library convs"]["count"] == 0


def test_shard_divergence_traces_the_gate_convs():
    """``scripts/shard_divergence.py`` records the True route's gate convs
    as a kernel wrapper's op, so a gate conv that followed the batch would
    be named."""
    from evolutionary_illusion_generator_tpu_torch.scripts import shard_divergence

    params = _params((3, 8, 16))
    calls = []
    with torch.inference_mode(), shard_divergence.op_trace(calls):
        model.rollout(params, torch.rand(2, 16, 24, 3), repeat=1, extension=0, use_pallas=True,
                      compute_dtype=BF16)
    ops = [c["op"].split()[0] for c in calls]
    assert ops.count("gate_convs") == 3 and ops.count("fused_lstm_gates") == 3
