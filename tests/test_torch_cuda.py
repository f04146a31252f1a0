"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports only torch, numpy, pytest and the port, so that it runs on the
card's machine, which has no JAX:

    python3 -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

from the repo root (``chip_smoke.py``'s ``cuda_tests`` phase runs it so,
after building the kernels).  The references are the port's plain
versions, which the CPU tests (``test_torch_kernels.py``,
``test_torch_bisect.py``) hold against the JAX package's Pallas kernels.
Inputs come from numpy, made from a seed.
"""

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu_torch.ops import convlstm_bisect as cb
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused, convlstm_gates
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn
from evolutionary_illusion_generator_tpu_torch.ops import prednet_units as pu
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import (
    fused_convlstm_layer,
    fused_convlstm_layer_multi,
    pack_gate_weight,
)
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_narrow import narrow_convlstm_layer
from evolutionary_illusion_generator_tpu_torch.ops.prednet_units import a_unit, ahat_error_unit
from evolutionary_illusion_generator_tpu_torch.scripts import kernel_bisect as kb

# float32 elementwise gate math on both sides: last-ulp differences only.
GATES_ATOL = 1e-6
# h and c rounded to bfloat16: a last-ulp float32 difference can flip the
# rounding by one bfloat16 ulp, at most 2**-7 of the value.
BF16_RTOL = 2.0**-7
# h rounded to bfloat16: one rounding flip is 2**-8 at |h| < 1.
H_ATOL = 1e-2

# (B, H, W, source channels, C): the main path's three layers at a chunk of
# 2, the north star's at one image, then ragged shapes — image edges inside
# a tile, channel counts not a multiple of 16 (40) or of 8 (12: the mma_sync
# body), C not a multiple of 16 — and a first source 2 bytes off its
# alignment ("unaligned": the mma_sync body)
FUSED_CASES = {
    "layer1": (2, 60, 80, (96, 48, 96), 48),
    "layer2": (2, 30, 40, (192, 96, 192), 96),
    "layer3": (2, 15, 20, (384, 192), 192),
    "north1": (1, 240, 320, (96, 48, 96), 48),
    "north2": (1, 120, 160, (192, 96, 192), 96),
    "north3": (1, 60, 80, (384, 192), 192),
    "single": (2, 60, 80, (240,), 48),
    "ragged1": (2, 13, 21, (40,), 24),
    "ragged2": (2, 13, 21, (40, 12), 24),
    "ragged3": (2, 13, 21, (12, 40, 24), 24),
    "ragged4": (2, 13, 21, (40, 8, 24), 24),
    "unaligned": (2, 13, 21, (40, 8, 24), 24),
}

# the ladder's shapes, (B, H, W, Cin, C), rows (test_torch_bisect.py uses them too)
SHAPES = {
    "default": (kb.DEFAULT_SHAPE, 32),
    "ragged": ((2, 16, 20, 24, 8), 8),
    "wide": ((2, 24, 70, 40, 72), 8),
    "odd_rows": ((2, 21, 70, 40, 18), 3),
    "cpasync_windows": ((2, 15, 66, 12, 18), 5),
}
RUNG_KEYS = sorted("ACDHEIJ")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # plain float32 convs in full float32


def _layer_inputs(seed, B, H, W, cins, C):
    rng = np.random.default_rng(seed)
    srcs = [rng.normal(0, 1, (B, H, W, ci)).astype(np.float32) for ci in cins]
    ws = [rng.normal(0, 0.1, (3, 3, ci, 4 * C)).astype(np.float32) for ci in cins]
    b = rng.normal(0, 0.1, 4 * C).astype(np.float32)
    c_prev = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    return srcs, ws, b, c_prev


def _at_odd_offset(t):
    """``t`` copied into a contiguous view that starts one element past an
    allocation, so off every vector boundary."""
    v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return v.copy_(t)


@pytest.mark.cuda
def test_cuda_gates_kernel_matches_plain():
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(0)
    gates = torch.randn(2, 30, 40, 12, device="cuda", generator=g)
    c_prev = torch.randn(2, 30, 40, 3, device="cuda", generator=g).bfloat16()
    n = fused_lstm_gates.launches
    h, c = fused_lstm_gates(gates, c_prev)
    torch.cuda.synchronize()
    assert fused_lstm_gates.launches == n + 1
    h_p, c_p = convlstm_gates.lstm_gates_plain(gates, c_prev)
    torch.testing.assert_close(h, h_p, atol=GATES_ATOL, rtol=0)
    torch.testing.assert_close(c, c_p, atol=GATES_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 3, 8, 48])
def test_cuda_gates_kernel_types_match_plain(C, gate_dtype, out_dtype):
    """Every gate and output type, both state types, at an odd pixel count
    (1 x 7 x 9) and at views off the allocations' alignment."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(C)
    od = getattr(torch, out_dtype)
    for state in (torch.float32, torch.bfloat16):
        gates = torch.randn(1, 7, 9, 4 * C, device="cuda", generator=g).mul_(2).to(
            getattr(torch, gate_dtype))
        c_prev = torch.randn(1, 7, 9, C, device="cuda", generator=g).to(state)
        h_p, c_p = convlstm_gates.lstm_gates_plain(gates, c_prev, out_dtype=od)
        for args in ((gates, c_prev), (_at_odd_offset(gates), _at_odd_offset(c_prev))):
            h, c = fused_lstm_gates(*args, out_dtype=od)
            torch.cuda.synchronize()
            assert h.dtype == c.dtype == od
            rtol = BF16_RTOL if od == torch.bfloat16 else 0
            torch.testing.assert_close(h.float(), h_p.float(), atol=GATES_ATOL, rtol=rtol)
            torch.testing.assert_close(c.float(), c_p.float(), atol=GATES_ATOL, rtol=rtol)


def _gate_plans(npix, C, types, aligned):
    """Plans of the gate kernel's streaming bodies that take the call: each
    body of ``body_plans`` at its own grid and at 1, 2 and 5 blocks; the
    slab body at slabs of 16, 32 and 48 pixels a warp through rings of 2
    and 3 on 1 and 3 blocks, where a block's shared memory holds them."""
    plans = [convlstm_gates.GatesPlan("slab", P, ring, grid)
             for P in (16, 32, 48) for ring in (2, 3) for grid in (1, 3)
             if convlstm_gates.slab_smem(P, C, *types, ring) <= convlstm_gates.SMEM_PER_BLOCK]
    for body, p in convlstm_gates.body_plans(npix, C, *types, aligned).items():
        if body != "scalar":
            plans += [p] + [p._replace(grid=g) for g in (1, 2, 5)]
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 3, 8, 12, 48, 96, 192])
def test_cuda_gates_bodies_bit_equal_to_the_scalar_body(C, gate_dtype, out_dtype, offset):
    """The vector and slab bodies' h and c bit-equal to the scalar body's
    (the first body) at plans of each that take the call, both state
    types,
    odd pixel counts (7 x 9, and 63 x 8 + 5: several slabs a block, so the
    ring wraps) and views ``offset`` elements past an allocation."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(C + offset)
    gd, od = getattr(torch, gate_dtype), getattr(torch, out_dtype)
    stream = torch.cuda.current_stream().cuda_stream
    view = _at_odd_offset if offset else (lambda t: t)
    for state, npix in ((torch.float32, 63), (torch.bfloat16, 63), (torch.bfloat16, 509)):
        gates = view(torch.randn(1, 1, npix, 4 * C, device="cuda", generator=g).mul_(2).to(gd))
        c_prev = view(torch.randn(1, 1, npix, C, device="cuda", generator=g).to(state))
        ref = convlstm_gates._launch(gates, c_prev, stream, od, convlstm_gates.GatesPlan("scalar"))
        for plan in _gate_plans(npix, C, (gd, state, od), offset == 0):
            h, c = convlstm_gates._launch(gates, c_prev, stream, od, plan)
            torch.cuda.synchronize()
            assert torch.equal(h, ref[0]) and torch.equal(c, ref[1]), plan


@pytest.mark.cuda
@pytest.mark.parametrize("C,npix", [(1, 8 * 120 * 160), (3, 8 * 120 * 160), (12, 8 * 60 * 80),
                                    (48, 8 * 60 * 80), (192, 8 * 15 * 20), (24, 8 * 60 * 80)])
def test_cuda_gates_launches_by_body(C, npix):
    """The wrapper takes its plan's body (the main path's layers in bfloat16)
    and counts it on ``body_launches``, beside ``launches``; its h and c
    bit-equal to the scalar body's."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(C)
    gates = torch.randn(1, 1, npix, 4 * C, device="cuda", generator=g).mul_(2).bfloat16()
    c_prev = torch.randn(1, 1, npix, C, device="cuda", generator=g).bfloat16()
    plan = convlstm_gates.gates_plan(npix, C)
    n, bodies = fused_lstm_gates.launches, dict(fused_lstm_gates.body_launches)
    h, c = fused_lstm_gates(gates, c_prev, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_lstm_gates.launches == n + 1
    bodies[plan.body] += 1
    assert fused_lstm_gates.body_launches == bodies
    ref = convlstm_gates._launch(gates, c_prev, torch.cuda.current_stream().cuda_stream,
                                 torch.bfloat16, convlstm_gates.GatesPlan("scalar"))
    assert torch.equal(h, ref[0]) and torch.equal(c, ref[1])


@pytest.mark.cuda
def test_cuda_gates_refuses_a_plan_its_body_does_not_take():
    """No fallback: the vector body at C not a multiple of its width, or on
    a view off its alignment, and a slab plan of a ring of 4, raise."""
    _cuda_or_skip()
    stream = torch.cuda.current_stream().cuda_stream
    gates = torch.randn(1, 1, 63, 48, device="cuda").bfloat16()
    c_prev = torch.randn(1, 1, 63, 12, device="cuda").bfloat16()
    for args, plan in (((gates, c_prev), convlstm_gates.GatesPlan("vector", grid=2)),
                       ((_at_odd_offset(gates[..., :32].contiguous()),
                         _at_odd_offset(c_prev[..., :8].contiguous())),
                        convlstm_gates.GatesPlan("vector", grid=2)),
                       ((gates, c_prev), convlstm_gates.GatesPlan("slab", 16, 4, 1))):
        with pytest.raises(RuntimeError, match="launch failed"):
            convlstm_gates._launch(*args, stream, torch.bfloat16, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_cuda_fused_kernel_matches_plain(case, state):
    _cuda_or_skip()
    B, H, W, cins, C = FUSED_CASES[case]
    srcs, ws, b, c_prev = _layer_inputs(7, B, H, W, cins, C)
    srcs = [torch.as_tensor(s).cuda().bfloat16() for s in srcs]
    if case == "unaligned":
        srcs[0] = _at_odd_offset(srcs[0])
    wks = [pack_gate_weight(torch.as_tensor(w)).cuda() for w in ws]
    b = torch.as_tensor(b).cuda()
    c_prev = torch.as_tensor(c_prev).cuda().to(getattr(torch, state))
    wrapper = fused_convlstm_layer_multi if len(cins) > 1 else fused_convlstm_layer
    n, bodies = wrapper.launches, dict(wrapper.body_launches)
    h, c = (wrapper(srcs, wks, b, c_prev) if len(cins) > 1
            else wrapper(srcs[0], wks[0], b, c_prev))
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1
    # the TMA needs 16-byte rows and 16-byte aligned data, else the mma_sync body
    body = ("wgmma" if case != "unaligned" and all(ci % 8 == 0 for ci in cins)
            else "mma_sync")
    bodies[body] += 1
    assert wrapper.body_launches == bodies
    h_p, c_p = convlstm_fused.convlstm_layer_plain(srcs, wks, b, c_prev)
    assert h.dtype == h_p.dtype
    # h in bfloat16 state: one rounding flip is 2**-8 at |h| < 1
    torch.testing.assert_close(h.float(), h_p.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(c, c_p, atol=1e-4, rtol=0)


# (B, H, W, C, C_above, strip width or None for the wrapper's): the main
# path's pixel layer at a chunk of 2, the grayscale pixel layer and its
# layer 1 (C = 16: 64 gate outputs, two warps across them), a narrow top
# layer (no R_above), and odd widths (a coarse width of 19, odd strips)
NARROW_CASES = {
    "pixel": (2, 120, 160, 3, 48, None),
    "gray_pixel": (2, 120, 160, 1, 16, None),
    "gray_layer1": (2, 60, 80, 16, 32, None),
    "top": (2, 30, 40, 3, None, None),
    "odd_width": (3, 26, 38, 3, 48, 7),
    "wide_narrow": (2, 10, 14, 31, 12, 5),
}
# kernel against the plain version, one step: the same bfloat16 products
# summed in another order, so where the compute dtype is bfloat16 a
# source's conv may round the other way now and then, one ulp of a gate
# (2**-8 relative), which moves h or c by about as much: held by the
# one-step rule of the rollout tests below (STEP_ATOL, on at most
# STEP_DIFF_SHARE of the elements; in a float32 state, the elements off by
# more than float32 sums in another order give, NARROW_F32_ATOL).  In
# float32 compute and state, within NARROW_F32_ATOL.
NARROW_F32_ATOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["bf16_bf16", "f32_bf16", "f32_f32", "bf16_f32"])
@pytest.mark.parametrize("case", sorted(NARROW_CASES))
def test_cuda_narrow_kernel_matches_plain(case, types):
    """One narrow layer step, kernel against plain version (compute dtype,
    state dtype); sources in [-1, 1] as a rollout's are."""
    _cuda_or_skip()
    B, H, W, C, C_above, tw = NARROW_CASES[case]
    cd, sd = (torch.bfloat16 if t == "bf16" else torch.float32 for t in types.split("_"))
    rng = np.random.default_rng(11)
    cins = [2 * C, C] + ([C_above] if C_above else [])
    shapes = [(B, H, W, 2 * C), (B, H, W, C)] + ([(B, H // 2, W // 2, C_above)] if C_above
                                                 else [])
    srcs = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).cuda().bfloat16()
            for s in shapes]
    wks = [pack_gate_weight(torch.from_numpy(  # init_params' scale: over sqrt(fan-in)
        rng.normal(0, 1 / np.sqrt(9 * sum(cins)), (3, 3, ci, 4 * C)).astype(np.float32))).cuda()
        for ci in cins]
    b = torch.from_numpy(rng.normal(0, 0.3, 4 * C).astype(np.float32)).cuda().bfloat16()
    c_prev = torch.from_numpy(rng.normal(0, 1, (B, H, W, C)).astype(np.float32)).cuda().to(sd)
    n = narrow_convlstm_layer.launches
    if tw is None:
        h, c = narrow_convlstm_layer(srcs, wks, b, c_prev, compute_dtype=cd)
        assert narrow_convlstm_layer.launches == n + 1
    else:
        h, c = cn.launch(srcs, wks, b, c_prev, cd, torch.cuda.current_stream().cuda_stream, tw=tw)
    torch.cuda.synchronize()
    ref = cn.narrow_convlstm_layer_plain(srcs, wks, b, c_prev, compute_dtype=cd)
    for got, want in zip((h, c), ref):
        assert got.dtype == want.dtype == sd
        d = (got.float() - want.float()).abs()
        if cd == sd == torch.float32:
            assert d.max().item() <= NARROW_F32_ATOL
        else:
            off = d > (0 if sd == torch.bfloat16 else NARROW_F32_ATOL)
            assert d.max().item() <= STEP_ATOL
            assert off.float().mean().item() <= STEP_DIFF_SHARE


@pytest.mark.cuda
def test_cuda_narrow_kernel_rows_do_not_follow_the_batch():
    """A pixel's sums do not depend on the batch or the tile it falls in:
    the kernel on three rows of a batch of 8, at another strip width, is
    bit-equal to those rows of the whole batch (the sharded evaluator's
    shards run fewer rows)."""
    _cuda_or_skip()
    rng = np.random.default_rng(13)
    B, H, W, C, C_above = 8, 120, 160, 3, 48
    shapes = [(B, H, W, 2 * C), (B, H, W, C), (B, H // 2, W // 2, C_above)]
    srcs = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).cuda().bfloat16()
            for s in shapes]
    wks = [pack_gate_weight(torch.from_numpy(rng.normal(0, 0.05, (3, 3, s[-1], 4 * C))
                                             .astype(np.float32))).cuda() for s in shapes]
    b = torch.zeros(4 * C, device="cuda", dtype=torch.bfloat16)
    c_prev = torch.from_numpy(rng.normal(0, 1, (B, H, W, C)).astype(np.float32)).cuda().bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    # the mma.sync body at its own strip width, then at another (the
    # persistent body's rows: test_cuda_narrow_persistent_rows_do_not_follow_the_batch)
    whole = cn.launch(srcs, wks, b, c_prev, torch.bfloat16, stream, tw=cn.tile_width(B, H, W))
    part = cn.launch([x[2:5].contiguous() for x in srcs], wks, b, c_prev[2:5].contiguous(),
                     torch.bfloat16, stream, tw=5)
    torch.cuda.synchronize()
    for a, p in zip(whole, part):
        assert torch.equal(a[2:5], p)


# The narrow layer's bodies at the shapes chip_smoke.py checks (its
# NARROW_SHAPES and NARROW_ODD: a coarse width of 19, R_above of 12 channels,
# which only the mma.sync body takes, no R_above at an odd H and W) and the
# north star's pixel layer, (B, H, W, C, C_above)
NARROW_BODY_SHAPES = {
    "main": (8, 120, 160, 3, 48),
    "gray_pixel": (8, 120, 160, 1, 16),
    "gray_layer1": (8, 60, 80, 16, 32),
    "top": (8, 30, 40, 3, None),
    "odd_width": (3, 26, 38, 3, 48),
    "odd_r_above": (2, 14, 22, 16, 12),
    "odd_hw": (2, 9, 13, 1, None),
    "north_star": (25, 480, 640, 3, 48),
}


def _narrow_case(seed, B, H, W, C, C_above, state=torch.bfloat16):
    """Sources in [-1, 1] as a rollout's are, weights at init_params' scale,
    bias and c_prev, made by numpy, on the card."""
    rng = np.random.default_rng(seed)
    cins = [2 * C, C] + ([C_above] if C_above else [])
    shapes = [(B, H, W, 2 * C), (B, H, W, C)] + ([(B, H // 2, W // 2, C_above)] if C_above
                                                 else [])
    srcs = [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).cuda().bfloat16()
            for s in shapes]
    wks = [pack_gate_weight(torch.from_numpy(
        rng.normal(0, 1 / np.sqrt(9 * sum(cins)), (3, 3, ci, 4 * C)).astype(np.float32))).cuda()
        for ci in cins]
    b = torch.from_numpy(rng.normal(0, 0.3, 4 * C).astype(np.float32)).cuda().bfloat16()
    c_prev = torch.from_numpy(rng.normal(0, 1, (B, H, W, C)).astype(np.float32)).cuda().to(state)
    return srcs, wks, b, c_prev


@pytest.mark.cuda
@pytest.mark.parametrize("shape,state", [(shape, state) for shape in sorted(NARROW_BODY_SHAPES)
                                         for state in ("bf16", "f32")
                                         if shape != "north_star" or state == "bf16"])
def test_cuda_narrow_bodies_against_the_float64_chain(shape, state):
    """bfloat16 compute: the wrapper launches its plan's body (counted by
    body: the persistent one at the pixel layers), and every body
    that takes the shape (the mma.sync body beside the persistent one) and
    the plain version give h and c within one ulp at each rounding point of
    the rounded float64 chain (``convlstm_narrow.chain_float64``)."""
    _cuda_or_skip()
    B, H, W, C, C_above = NARROW_BODY_SHAPES[shape]
    sd = torch.bfloat16 if state == "bf16" else torch.float32
    srcs, wks, b, c_prev = _narrow_case(23, B, H, W, C, C_above, sd)
    plan = cn.narrow_plan(B, H, W, C, C_above, torch.bfloat16, sd)
    # the pixel layers on the persistent body; C 16 (layer 1 of 1,16,32,64)
    # and R_above of 12 channels on the mma.sync body
    assert plan.body == ("persistent" if C <= 3 and C_above != 12 else "mma_sync"), plan
    before = dict(narrow_convlstm_layer.body_launches)
    outs = {plan.body: narrow_convlstm_layer(srcs, wks, b, c_prev)}
    assert narrow_convlstm_layer.body_launches[plan.body] == before[plan.body] + 1
    stream = torch.cuda.current_stream().cuda_stream
    outs["mma_sync"] = cn.launch(srcs, wks, b, c_prev, torch.bfloat16, stream,
                                 tw=cn.tile_width(B, H, W))
    outs["plain"] = cn.narrow_convlstm_layer_plain(srcs, wks, b, c_prev,
                                                   compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    chain = cn.chain_float64(srcs, wks, b, c_prev)
    for name, (h, c) in outs.items():
        assert h.dtype == c.dtype == sd, name
        for got, want, bound in ((h, chain["h"], chain["dh"]), (c, chain["c"], chain["dc"])):
            off = (got.double() - want).abs() > bound
            assert not off.any(), (name, off.float().mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["main", "gray_pixel", "top", "odd_width", "north_star"])
def test_cuda_narrow_persistent_rows_do_not_follow_the_batch(shape):
    """The persistent body sums a pixel in one order whatever the batch,
    the tile or the grid: a batch of 1 and of 3 of the whole batch's rows,
    at every tile width that fits and other grids, bit-equal to those rows
    of the whole batch at its own plan."""
    _cuda_or_skip()
    B, H, W, C, C_above = NARROW_BODY_SHAPES[shape]
    srcs, wks, b, c_prev = _narrow_case(29, B, H, W, C, C_above)
    stream = torch.cuda.current_stream().cuda_stream
    whole = cn.launch(srcs, wks, b, c_prev, torch.bfloat16, stream)
    own = cn.narrow_plan(B, H, W, C, C_above)
    assert own.body == "persistent"
    for r0, n in ((B - 1, 1), (B // 2 - 1, 3)):
        rows = [x[r0:r0 + n].contiguous() for x in srcs]
        for tw in cn.PERSISTENT_TILES:
            for per in (1, 2):
                p = cn.persistent_plan(n, H, W, C, C_above, tile_w=tw, blocks_per_sm=per)
                if p.smem > cn.SMEM_PER_BLOCK:
                    continue
                part = cn.launch(rows, wks, b, c_prev[r0:r0 + n].contiguous(), torch.bfloat16,
                                 stream, plan=p._replace(blocks=p.blocks // per + 5 * per))
                torch.cuda.synchronize()
                for a, q in zip(whole, part):
                    assert torch.equal(a[r0:r0 + n], q), (r0, n, p)


# the gate convs of the True route at each layer of 3,48,96,192 (a chunk of
# 2 at 160x120): (H, W, C, C_above or None)
GATE_CONV_LAYERS = ((120, 160, 3, 48), (60, 80, 48, 96), (30, 40, 96, 192), (15, 20, 192, None))


@pytest.mark.cuda
@pytest.mark.parametrize("cd", ["bf16", "f32"])
@pytest.mark.parametrize("layer", range(len(GATE_CONV_LAYERS)))
def test_cuda_gate_convs_against_the_split_convs(layer, cd):
    """``convlstm_narrow.gate_convs`` (the True route's gate convs: the
    wgmma body in bfloat16 compute at C >= 32, else the mma.sync body,
    counted by body) against ``model._gate_convs`` (cuDNN's convs, the
    route before it) and the rounded float64 chain.  bfloat16: each within
    one ulp at each rounding point of the chain (2**-7 of each point), so
    the two within two, on at most STEP_DIFF_SHARE of the elements apart;
    float32: within NARROW_F32_ATOL (float32 sums in another order).
    Counted on its wrapper; rows bit-equal for a batch of 1."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.models.prednet import model

    H, W, C, C_above = GATE_CONV_LAYERS[layer]
    ct = torch.bfloat16 if cd == "bf16" else torch.float32
    srcs, wks, b, _ = _narrow_case(31 + layer, 2, H, W, C, C_above)
    p = {"lstm_w_e": convlstm_fused.unpack_gate_weight(wks[0]),
         "lstm_w_r": convlstm_fused.unpack_gate_weight(wks[1]), "lstm_b": b}
    if C_above:
        p["lstm_w_up"] = convlstm_fused.unpack_gate_weight(wks[2])
    n, bodies = cn.gate_convs.launches, dict(cn.gate_convs.body_launches)
    got = cn.gate_convs(srcs, wks, b, compute_dtype=ct)
    assert cn.gate_convs.launches == n + 1
    bodies["wgmma" if ct == torch.bfloat16 and C >= 32 else "mma_sync"] += 1
    assert cn.gate_convs.body_launches == bodies
    want = model._gate_convs(p, {"e": srcs[0], "r": srcs[1]}, srcs[2] if C_above else None, ct,
                             False, False)
    one = cn.gate_convs([x[1:2] for x in srcs], wks, b, compute_dtype=ct)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == ct and got.shape == want.shape
    assert torch.equal(one, got[1:2])
    d = (got.double() - want.double()).abs()
    if ct == torch.float32:
        assert d.max().item() <= NARROW_F32_ATOL
        return
    g, err, _ = cn.gate_chain_float64(srcs, wks, b)
    for out in (got, want):
        assert ((out.double() - g).abs() <= err).all()
    assert (d <= 2 * err).all() and (d > 0).float().mean().item() <= STEP_DIFF_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [1, 2, 3])
def test_cuda_gate_convs_wgmma_rows_do_not_follow_the_batch(layer):
    """The wgmma body sums a pixel in one order whatever the batch, the
    tile, the channel group or the grid: rows of a batch of 1 and of 3 of
    the whole batch of 8, at every channel group and at tiles of other
    shapes (so other grids), bit-equal to those rows of the whole batch at
    its own plan; and every gate within one ulp at each rounding point of
    the float64 chain there."""
    _cuda_or_skip()
    H, W, C, C_above = GATE_CONV_LAYERS[layer]
    srcs, wks, b, _ = _narrow_case(37 + layer, 8, H, W, C, C_above)
    stream = torch.cuda.current_stream().cuda_stream
    own = cn.gate_plan(H, W, C)
    assert own.body == "wgmma"
    whole = cn.launch_gates(srcs, wks, b, torch.bfloat16, stream)
    shapes = convlstm_fused.tile_shapes(W)
    plans = [convlstm_fused.Plan("wgmma", cg, *shape) for cg in convlstm_fused.CHANNEL_GROUPS
             for shape in (shapes[0], shapes[len(shapes) // 2], shapes[-1])]
    for r0, k in ((7, 1), (2, 3)):
        rows = [x[r0:r0 + k].contiguous() for x in srcs]
        for p in plans:
            part = cn.launch_gates(rows, wks, b, torch.bfloat16, stream, plan=p)
            torch.cuda.synchronize()
            assert torch.equal(whole[r0:r0 + k], part), (r0, k, p)
    g, err, _ = cn.gate_chain_float64([x[:2] for x in srcs], wks, b)
    assert ((whole[:2].double() - g).abs() <= err).all()


@pytest.mark.cuda
def test_cuda_gate_convs_take_the_mma_sync_body_where_the_tma_cannot_go():
    """A source whose rows are not 16-byte multiples (R_above of 12
    channels, 24 bytes a pixel) keeps the gate convs on the mma.sync body
    by plan, counted so, within one ulp at each rounding point of the
    float64 chain; a wgmma plan forced on it raises."""
    _cuda_or_skip()
    B, H, W, C, C_above = 2, 14, 22, 40, 12
    srcs, wks, b, _ = _narrow_case(41, B, H, W, C, C_above)
    assert cn.gate_plan(H, W, C, torch.bfloat16, tma=False).body == "mma_sync"
    bodies = dict(cn.gate_convs.body_launches)
    got = cn.gate_convs(srcs, wks, b)
    torch.cuda.synchronize()
    bodies["mma_sync"] += 1
    assert cn.gate_convs.body_launches == bodies
    g, err, _ = cn.gate_chain_float64(srcs, wks, b)
    assert ((got.double() - g).abs() <= err).all()
    with pytest.raises(ValueError, match="wgmma body does not take"):
        cn.launch_gates(srcs, wks, b, torch.bfloat16, torch.cuda.current_stream().cuda_stream,
                        plan=cn.gate_plan(H, W, C))


@pytest.mark.cuda
def test_cuda_fused_kernel_rows_do_not_follow_the_batch():
    """A pixel's sums do not depend on the batch, the tile it falls in or
    its channel group: the fused kernel on three rows of a batch of 8, at
    other tiles and channel groups of the wgmma body, is bit-equal to those
    rows of the whole batch (the sharded evaluator's shards run fewer
    rows)."""
    _cuda_or_skip()
    B, H, W, cins, C = 8, 30, 40, (192, 96, 192), 96
    srcs, ws, b, c_prev = _layer_inputs(19, B, H, W, cins, C)
    srcs = [torch.as_tensor(s).cuda().bfloat16() for s in srcs]
    wks = [pack_gate_weight(torch.as_tensor(w)).cuda() for w in ws]
    b = torch.as_tensor(b).cuda()
    c_prev = torch.as_tensor(c_prev).cuda().bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    whole = fused_convlstm_layer_multi(srcs, wks, b, c_prev)
    own = convlstm_fused.plan_for(srcs, wks, c_prev)
    rows = [x[2:5].contiguous() for x in srcs]
    for tile in ((2, 64, 66), (5, 20, 64), (14, 7, 64)):
        for cg in convlstm_fused.CHANNEL_GROUPS:
            p = convlstm_fused.Plan("wgmma", cg, *tile)
            assert p != own
            part = convlstm_fused.launch(rows, wks, b, c_prev[2:5].contiguous(), stream, plan=p)
            torch.cuda.synchronize()
            for a, q in zip(whole, part):
                assert torch.equal(a[2:5], q), p


# The A and Ahat units, (B, H, W, C, C_above or None): the main path's four
# layers at its chunk of 8, the north star's at one image (and layer 1 at its
# chunk of 25), the grayscale stack's pixel layer, and odd shapes (odd H and
# W, C not a multiple of 4 or of 8); chip_smoke.py's UNIT_LAYERS,
# NORTH_STAR_UNIT_LAYERS and UNIT_ODD
UNIT_CASES = {
    "main0": (8, 120, 160, 3, 48),
    "main1": (8, 60, 80, 48, 96),
    "main2": (8, 30, 40, 96, 192),
    "main3": (8, 15, 20, 192, None),
    "main3_b1": (1, 15, 20, 192, None),
    "north0": (1, 480, 640, 3, 48),
    "north1": (1, 240, 320, 48, 96),
    "north1_b25": (25, 240, 320, 48, 96),
    "north2": (1, 120, 160, 96, 192),
    "north3": (1, 60, 80, 192, None),
    "gray0": (8, 120, 160, 1, 16),
    "odd": (3, 13, 21, 12, 20),
}
UNIT_TYPES = ["bf16_bf16", "bf16_f32", "f32_bf16", "f32_f32"]  # compute, state
# The kernels against their plain versions: the same bfloat16 products
# summed in another order, so a sum may round the other way at any of the
# rounding points (the conv, + b, each difference), one bfloat16 ulp there,
# at most 2**-7 of that point's magnitude, on at most UNIT_DIFF_SHARE of the
# elements (0.02% measured).  cuDNN's bfloat16 conv (the plain version's)
# is itself more than one ulp off the rounded float64 conv on a few
# elements in 100,000 (3.7e-5 at the north star's layer 3 on the H100):
# there, on at most UNIT_BEYOND_SHARE of the elements, the two may part by
# two ulps.  In float32 compute and state within UNIT_F32_ATOL (5e-6
# measured), or one bfloat16 ulp of a bfloat16 E.
UNIT_DIFF_SHARE = 0.01
UNIT_BEYOND_SHARE = 1e-4
UNIT_F32_ATOL = 1e-4


def _types(types):
    return tuple(torch.bfloat16 if t == "bf16" else torch.float32 for t in types.split("_"))


def _unit_inputs(seed, B, H, W, C, C_above, cd, sd):
    """R, A, the packed Ahat weight and bias; E, the packed A weight and
    bias (init_params' scale: normal over the square root of the fan-in)."""
    rng = np.random.default_rng(seed)

    def t(x, dtype):
        return torch.from_numpy(x.astype(np.float32)).cuda().to(dtype)

    r = t(rng.uniform(-1, 1, (B, H, W, C)), sd)
    a = t(rng.uniform(0, 1, (B, H, W, C)), cd)
    k = pu.pack_unit_weight(t(rng.normal(0, 1 / np.sqrt(9 * C), (3, 3, C, C)), torch.float32))
    b = t(rng.normal(0, 0.1, C), torch.bfloat16)
    e = t(rng.uniform(0, 1, (B, H, W, 2 * C)), sd)
    cout = C_above or 8
    k2 = pu.pack_unit_weight(t(rng.normal(0, 1 / np.sqrt(18 * C), (3, 3, 2 * C, cout)),
                               torch.float32))
    b2 = t(rng.normal(0, 0.1, cout), torch.bfloat16)
    return r, a, k, b, e, k2, b2


def _unit_held(got, want, cd, *points):
    assert got.dtype == want.dtype and got.shape == want.shape
    d = (got.float() - want.float()).abs()
    assert not torch.isnan(got.float()).any()
    if cd == torch.float32:
        tol = UNIT_F32_ATOL + (2.0**-7 * want.float().abs() if want.dtype == torch.bfloat16 else 0)
        assert bool((d <= tol).all()), d.max().item()
    else:
        tol = sum(2.0**-7 * p.float().abs() for p in points) + 1e-6
        assert (d > tol).float().mean().item() <= UNIT_BEYOND_SHARE, d.max().item()
        assert bool((d <= 2 * tol).all()), d.max().item()
    assert (d > 0).float().mean().item() <= (1.0 if want.dtype == cd == torch.float32
                                             else UNIT_DIFF_SHARE)


@pytest.mark.cuda
@pytest.mark.parametrize("types", UNIT_TYPES)
@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_cuda_unit_kernels_match_plain(case, types):
    """Each unit's kernel against its plain version (compute dtype, state
    dtype), both activations of the Ahat unit, the prediction, the pooled
    A (odd sizes floored); counted by the wrappers, by the body of the
    shape's plan."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.models.prednet import model

    B, H, W, C, C_above = UNIT_CASES[case]
    cd, sd = _types(types)
    r, a, k, b, e_in, k2, b2 = _unit_inputs(len(case), B, H, W, C, C_above, cd, sd)
    conv = model._conv(r, pu.unpack_unit_weight(k, C), None, cd)
    body = pu.ahat_plan(B, H, W, C, cd).body
    for layer0 in (True, False):
        n, nb = ahat_error_unit.launches, ahat_error_unit.body_launches[body]
        e, pred = ahat_error_unit(r, k, b, a, layer0=layer0, compute_dtype=cd, state_dtype=sd)
        torch.cuda.synchronize()
        assert ahat_error_unit.launches == n + 1
        assert ahat_error_unit.body_launches[body] == nb + 1
        want_e, want_p = pu.ahat_error_unit_plain(r, pu.unpack_unit_weight(k, C), b, a,
                                                  layer0=layer0, compute_dtype=cd, state_dtype=sd)
        v = model._conv(r, pu.unpack_unit_weight(k, C), b, cd)
        ahat = v.clamp(0.0, 1.0) if layer0 else torch.relu(v)
        pts = [torch.cat([t.float()] * 2, -1) for t in (conv, ahat, a)]
        _unit_held(e, want_e, cd, *pts)
        if layer0:
            _unit_held(pred, want_p, cd, conv, ahat)
        else:
            assert pred is None
    body = pu.a_plan(B, H, W, 2 * C, b2.shape[0], cd).body
    n, nb = a_unit.launches, a_unit.body_launches[body]
    got = a_unit(e_in, k2, b2, compute_dtype=cd)
    torch.cuda.synchronize()
    assert a_unit.launches == n + 1 and a_unit.body_launches[body] == nb + 1
    want = pu.a_unit_plain(e_in, pu.unpack_unit_weight(k2, b2.shape[0]), b2, compute_dtype=cd)
    conv = model._conv(e_in, pu.unpack_unit_weight(k2, b2.shape[0]), None, cd).float().abs()
    pooled = torch.nn.functional.max_pool2d(conv.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    _unit_held(got, want, cd, pooled, want)


# every shape of chip_smoke.py's UNIT_LAYERS, NORTH_STAR_UNIT_LAYERS and
# UNIT_ODD, (H, W, C, C_above); the whole batch is 25 images
UNIT_ROW_SHAPES = {
    "main0": (120, 160, 3, 48), "main1": (60, 80, 48, 96), "main2": (30, 40, 96, 192),
    "main3": (15, 20, 192, None), "north0": (480, 640, 3, 48), "north1": (240, 320, 48, 96),
    "north2": (120, 160, 96, 192), "north3": (60, 80, 192, None), "gray0": (120, 160, 1, 16),
    "odd": (13, 21, 12, 20),
}


def _other_plans(plan, unit, W, cout):
    """Plans of ``plan``'s body other than the default, as a forced plan may
    give them: every channel group of the wgmma body with a tile of one
    row of 64 a warpgroup and narrow run-on tiles; the im2col body's tile
    widths and grids; the mma.sync body's strip widths."""
    if plan.body == "wgmma":
        tiles = [s for s in pu.unit_tiles(W, unit == "a") if s[1] in (2, 6, 7, 64)]
        return [pu.UnitPlan("wgmma", n, *tile, cluster=c) for n, _ in pu._n_groups(cout)
                for tile in tiles for c in (2, 4)]
    if plan.body == "im2col":
        return [pu.UnitPlan("im2col", plan.n, 128 // tw, tw, 0, blocks)
                for tw in pu.IM2COL_TILES for blocks in (1, 7, 1000)]
    if plan.body == "mma_sync":
        widths = pu.POOL_TILES if unit == "a" else (3, 5, 8)
        return [pu.UnitPlan("mma_sync", tile_w=tw) for tw in widths if tw <= W or unit == "a"]
    return []


@pytest.mark.cuda
@pytest.mark.parametrize("types", UNIT_TYPES)
@pytest.mark.parametrize("shape", sorted(UNIT_ROW_SHAPES))
def test_cuda_unit_kernels_rows_do_not_follow_the_batch(shape, types):
    """A pixel's sums do not depend on the batch, the tile, the channel
    group or the grid: each unit's kernel on one and on three images of a
    batch of 25, at their own plans and at the other plans of the same body,
    is bit-equal to those images of the whole batch (the sharded
    evaluator's shards run fewer images; cuDNN's convs at these shapes did
    not keep this)."""
    _cuda_or_skip()
    stream = torch.cuda.current_stream().cuda_stream
    cd, sd = _types(types)
    H, W, C, C_above = UNIT_ROW_SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(C)
    B, cout = 25, C_above or 8
    r = torch.rand(B, H, W, C, device="cuda", generator=gen).mul_(2).sub_(1).to(sd)
    a = torch.rand(B, H, W, C, device="cuda", generator=gen).to(cd)
    k = pu.pack_unit_weight(torch.randn(3, 3, C, C, device="cuda", generator=gen) / (3 * C**0.5))
    b = torch.randn(C, device="cuda", generator=gen).mul_(0.1).bfloat16()
    k2 = pu.pack_unit_weight(torch.randn(3, 3, 2 * C, cout, device="cuda", generator=gen)
                             / (3 * (2 * C)**0.5))
    b2 = torch.randn(cout, device="cuda", generator=gen).mul_(0.1).bfloat16()
    whole, _ = pu.launch_ahat(r, k, b, a, False, cd, sd, stream)
    pooled = pu.launch_a(whole, k2, b2, cd, stream)
    for s0, s1 in ((2, 3), (2, 5)):
        rs, as_, es = (t[s0:s1].contiguous() for t in (r, a, whole))
        n = s1 - s0
        own = pu.ahat_plan(n, H, W, C, cd)
        for plan in [own] + _other_plans(own, "ahat", W, C):
            part, _ = pu.launch_ahat(rs, k, b, as_, False, cd, sd, stream, plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(whole[s0:s1], part), plan
        own = pu.a_plan(n, H, W, 2 * C, cout, cd)
        for plan in [own] + _other_plans(own, "a", W, cout):
            part = pu.launch_a(es, k2, b2, cd, stream, plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(pooled[s0:s1], part), plan


@pytest.mark.cuda
def test_cuda_float32_convs_run_without_cudnn(monkeypatch):
    """The plain route's float32 convs (``cudnn=False``) run with cuDNN off
    on the card (its FFT algorithm took an 18.4 GiB workspace at
    1280x960); its bfloat16 convs and the kernel routes' float32 convs
    keep it."""
    _cuda_or_skip()
    import torch.nn.functional as F

    from evolutionary_illusion_generator_tpu_torch.models.prednet import model

    seen = []
    conv2d = F.conv2d

    def spy(x, *a, **k):
        seen.append((x.dtype, torch.backends.cudnn.enabled))
        return conv2d(x, *a, **k)

    monkeypatch.setattr(F, "conv2d", spy)
    x = torch.rand(1, 8, 10, 4, device="cuda")
    w = torch.randn(6, 4, 3, 3, device="cuda")
    y32 = model._conv(x, w, None, torch.float32, cudnn=False)
    y16 = model._conv(x, w.bfloat16(), None, torch.bfloat16, cudnn=False)
    kept = model._conv(x, w, None, torch.float32)
    assert seen == [(torch.float32, False), (torch.bfloat16, True), (torch.float32, True)]
    assert torch.backends.cudnn.enabled
    ref = conv2d(x.cpu().permute(0, 3, 1, 2), w.cpu(), padding=1).permute(0, 2, 3, 1)
    for y in (y32, kept):
        torch.testing.assert_close(y.cpu(), ref, atol=1e-5, rtol=0)
    assert torch.isfinite(y16.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("key", RUNG_KEYS)
def test_cuda_rung_kernel_matches_plain(key, shape):
    _cuda_or_skip()
    dims, rows = SHAPES[shape]
    args = [t.float().cuda().bfloat16() for t in kb.make_inputs(dims, "cpu")]
    kw = {"rows": rows} if key in kb.ROW_BLOCK_KEYS else {}
    n = cb.RUNGS[key].launches
    h, c = cb.RUNGS[key](*args, **kw)
    torch.cuda.synchronize()
    assert cb.RUNGS[key].launches == n + 1
    h_p, c_p = cb.plain(key, *args)
    assert h.dtype == h_p.dtype
    if key == "A":
        assert torch.equal(h, h_p)
    else:
        torch.testing.assert_close(h.float(), h_p.float(), atol=H_ATOL, rtol=0)
        torch.testing.assert_close(c, c_p, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_cuda_rung_a_exact_at_ragged_counts_and_offsets(state, offset):
    """A's kernel at a count that is not a multiple of its vector (3,822
    elements) and on views `offset` elements past an allocation: the scalar
    head and tail around the 16-byte vectors."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(offset)
    x = torch.randn(2, 13, 21, 4, device="cuda", generator=g).bfloat16()
    w = torch.zeros(3, 3, 4, 28, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(28, device="cuda", dtype=torch.bfloat16)
    buf = torch.randn(2 * 13 * 21 * 7 + offset, device="cuda", generator=g).to(getattr(torch, state))
    c_prev = buf[offset:].view(2, 13, 21, 7)
    n = cb.variant_A.launches
    out, _ = cb.variant_A(x, w, b, c_prev)
    torch.cuda.synchronize()
    assert cb.variant_A.launches == n + 1
    assert torch.equal(out, c_prev.float() * 2)


# ---------------------------------------------------------------------------
# the probe and the scorers on the card (the port on the CPU is the
# reference: tests/test_torch_probe.py and tests/test_torch_scoring.py hold
# it against the JAX package)

PROBE_CHANNELS = (3, 48, 96, 192)
# one step from a nonzero state, bfloat16 state: float32 sums in another
# order flip a bfloat16 rounding by one ulp (2**-8 relative) here and there
# (chip_smoke.py's reference phase)
STEP_ATOL, STEP_DIFF_SHARE = 1.6e-2, 0.01
# 22 steps amplify those flips: held in the mean (ROADMAP Queue 3)
ROLLOUT_MEAN_TOL = 2e-2
# float32 device scores against float64 host scores, the same ranking
DEVICE_RTOL, DEVICE_ATOL = 1e-3, 1e-5
# the C++ scorer against numpy: summation order and FMAs (9e-15 measured)
NATIVE_ATOL = 1e-12


def _probe_image(seed=0, h=120, w=160):
    """A smooth textured RGB image in [0, 1], quantised to 8 bits."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (h // 8 + 2, w // 8 + 2, 3))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h).astype(int)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w).astype(int)
    return (np.floor(coarse[ys][:, xs] * 255) / 255).astype(np.float32)


def _populations(seed, pop=40, K=128):
    rng = np.random.default_rng(seed)
    vectors = np.full((pop, K, 4), 1e9)
    mask = np.zeros((pop, K), bool)
    for p in range(pop):
        n = int(rng.integers(0, K + 1)) if p > 1 else (0, K)[p]
        vectors[p, :n, 0] = rng.uniform(0, 160, n)
        vectors[p, :n, 1] = rng.uniform(0, 120, n)
        vectors[p, :n, 2:] = rng.uniform(-0.3, 0.3, (n, 2))
        mask[p, :n] = True
    return vectors, mask


@pytest.mark.cuda
def test_cuda_probe_matches_the_cpu(tmp_path):
    """The probe's rollout at the bundled color predictor's full width,
    160x120: one step from the CPU's state after 3 steps held tightly,
    the 22-step flow pair in the mean; then ``get_vectors`` on the card."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.evolution import probe
    from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, model
    from evolutionary_illusion_generator_tpu_torch.utils.image_io import save_image

    img = torch.from_numpy(_probe_image())[None]
    params = {d: loader.load_or_init(None, PROBE_CHANNELS, device=d) for d in ("cpu", "cuda")}
    with torch.inference_mode():
        state = model.init_state(1, 120, 160, PROBE_CHANNELS)
        for _ in range(3):
            state, _ = model.prednet_step(params["cpu"], state, img)
        ref_state, ref_pred = model.prednet_step(params["cpu"], state, img)
        out_state, out_pred = model.prednet_step(
            params["cuda"], [{k: v.cuda() for k, v in s.items()} for s in state], img.cuda())
        pairs = [(out_pred, ref_pred)] + [(o[k], r[k]) for o, r in zip(out_state, ref_state)
                                          for k in "rce"]
        for a, b in pairs:
            d = (a.cpu().float() - b.float()).abs()
            assert d.max().item() <= STEP_ATOL
            assert (d > 0).float().mean().item() <= STEP_DIFF_SHARE
        frames = {d: model.rollout_flow_frames(params[d], img.to(d), pair="probe")
                  for d in ("cpu", "cuda")}
    assert torch.equal(frames["cuda"][0].cpu(), frames["cpu"][0])
    f1 = frames["cuda"][1].cpu()
    assert torch.isfinite(f1).all()
    assert (f1 - frames["cpu"][1]).abs().mean().item() <= ROLLOUT_MEAN_TOL

    png = str(tmp_path / "in.png")
    save_image(img[0].numpy(), png)
    counted = (narrow_convlstm_layer, fused_lstm_gates, fused_convlstm_layer_multi,
               ahat_error_unit, a_unit)
    n = {w.__name__: w.launches for w in counted}
    vectors = probe.get_vectors(png, None, PROBE_CHANNELS)
    torch.cuda.synchronize()
    assert {w.__name__: w.launches - n[w.__name__] for w in counted} == {
        "narrow_convlstm_layer": 22, "fused_lstm_gates": 0, "fused_convlstm_layer_multi": 66,
        "ahat_error_unit": 88, "a_unit": 66}
    assert vectors.ndim == 2 and vectors.shape[1] == 4 and np.isfinite(vectors).all()


@pytest.mark.cuda
@pytest.mark.parametrize("structure", [0, 1, 2, 3])
def test_cuda_device_scores_match_host(structure):
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.ops.fitness.calculate import score_vectors
    from evolutionary_illusion_generator_tpu_torch.ops.fitness.metrics_torch import (
        score_vectors_torch,
    )

    vectors, mask = _populations(structure)
    dev = score_vectors_torch(structure, torch.from_numpy(vectors).float().cuda(),
                              torch.from_numpy(mask).cuda(), 160, 120)
    torch.cuda.synchronize()
    dev = dev.cpu().numpy().astype(np.float64)
    host = np.array([score_vectors(structure, v[m], 160, 120) for v, m in zip(vectors, mask)])
    np.testing.assert_allclose(dev, host, rtol=DEVICE_RTOL, atol=DEVICE_ATOL)
    assert list(np.argsort(dev, kind="stable")) == list(np.argsort(host, kind="stable"))


@pytest.mark.cuda
def test_cuda_machine_builds_the_native_scorer():
    """The C++ scorer builds on the card's machine (``score_backend="auto"``
    would fall back to numpy without a word otherwise)."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.ops.fitness import native
    from evolutionary_illusion_generator_tpu_torch.ops.fitness.calculate import score_vectors

    assert native.is_available() and native.library_path().exists()
    for structure in range(4):
        vectors, mask = _populations(structure + 10)
        got = native.score_population_native(structure, vectors, mask, 160, 120)
        host = np.array([score_vectors(structure, v[m], 160, 120) for v, m in zip(vectors, mask)])
        np.testing.assert_allclose(got, host, atol=NATIVE_ATOL, rtol=0)


# one tiny pretrain step on the card against the CPU port: float32 master
# weights in both, TF32 off; the frames are made on each device from the
# same key (float32 rounding apart); the summation order differs, so a
# bfloat16 param may round the other way (TRAIN_FLIP_SHARE of them, one
# bfloat16 ulp plus an Adam step of 2 lr)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_FLIP_SHARE = 5e-3
TRAIN_RECIPES = {
    "colour": dict(regime_probs=(0, 0.25, 0.2, 0.15, 0.2, 0.2, 0), ring_speed_range=(1.2, 2.0),
                   onset_range=(3, 5), closed_frames=2, closed_weight=5.0, ring_dir_cue=True,
                   ring_onset_range=(2, 2), ring_mask_prefix=True,
                   cue_speed_range=(0.1, 0.14), cue_period_range=(6.0, 40.0),
                   ring_closed_scale=0.75, cue_motion_weight=0.0625),
    "v2": dict(data="v2"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", sorted(TRAIN_RECIPES))
def test_cuda_train_step_matches_the_cpu(recipe):
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import params_to_numpy
    from evolutionary_illusion_generator_tpu_torch.models.prednet.pretrain import pretrain

    kw = dict(batch=2, T=4, h=16, w=24, steps=1, seed=3, verbose=False,
              **TRAIN_RECIPES[recipe])
    counted = (narrow_convlstm_layer, fused_lstm_gates, fused_convlstm_layer_multi)
    n = [w.launches for w in counted]
    card, loss_card = pretrain((3, 32, 32), device="cuda", **kw)
    torch.cuda.synchronize()
    cpu, loss_cpu = pretrain((3, 32, 32), device="cpu", **kw)
    start, _ = pretrain((3, 32, 32), device="cpu", **dict(kw, steps=0))
    assert [w.launches for w in counted] == n
    assert np.isfinite(loss_card)
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=TRAIN_LOSS_RTOL)
    assert all(v.device.type == "cuda" for layer in card for v in layer.values())
    for o, c, s in zip(params_to_numpy(card), params_to_numpy(cpu), params_to_numpy(start)):
        for k in c:
            gap = np.abs(o[k] - c[k])
            assert (gap > 0).mean() <= TRAIN_FLIP_SHARE, (k, (gap > 0).mean())
            assert (gap <= 2.0**-7 * np.abs(c[k]) + 4e-3).all(), (k, gap.max())
            assert not np.array_equal(o[k], s[k]), k  # every param moved


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["gates", "multi", "single", "narrow", "ahat", "a"])
def test_cuda_wrappers_refuse_gradients(wrapper):
    """On CUDA tensors, too, an input that requires a gradient raises
    before any launch; under no_grad the kernel runs."""
    _cuda_or_skip()
    srcs, ws, b, c_prev = _layer_inputs(5, 1, 6, 10, (16,), 8)
    x = torch.as_tensor(srcs[0]).cuda().bfloat16()
    wk = pack_gate_weight(torch.as_tensor(ws[0])).cuda()
    bt = torch.as_tensor(b).cuda().requires_grad_(True)
    c = torch.as_tensor(c_prev).cuda()
    gates = torch.randn(1, 6, 10, 32, device="cuda", requires_grad=True)
    # the narrow kernel on E = x (16 channels) and R = x's first 8
    r, wr = x[..., :8].contiguous(), wk[..., :8].contiguous()
    # the units: Ahat on R = x's first 8 channels, A on E = x
    w0 = torch.as_tensor(ws[0])
    ka, kb = (pu.pack_unit_weight(w).cuda() for w in (w0[..., :8, :8], w0[..., :8]))
    fn = {"gates": lambda: fused_lstm_gates(gates, c),
          "multi": lambda: fused_convlstm_layer_multi([x], [wk], bt, c),
          "single": lambda: fused_convlstm_layer(x, wk, bt, c),
          "narrow": lambda: narrow_convlstm_layer([x, r], [wk, wr], bt, c),
          "ahat": lambda: ahat_error_unit(r, ka, bt[:8], c, layer0=True,
                                          compute_dtype=torch.float32),
          "a": lambda: (a_unit(x, kb, bt[:8]), None)}[wrapper]
    count = {"gates": fused_lstm_gates, "multi": fused_convlstm_layer_multi,
             "single": fused_convlstm_layer, "narrow": narrow_convlstm_layer,
             "ahat": ahat_error_unit, "a": a_unit}[wrapper]
    n = count.launches
    with pytest.raises(RuntimeError, match="has no backward"):
        fn()
    assert count.launches == n
    with torch.no_grad():
        h, _ = fn()
    torch.cuda.synchronize()
    assert count.launches == n + 1 and h.grad_fn is None and torch.isfinite(h.float()).all()


# ---------------------------------------------------------------------------
# the predictor's options and the program cache on the card


@pytest.mark.cuda
def test_cuda_gates_kernel_at_the_s2d_shape():
    """The gate kernel on the s2d pixel layer's gate-major gates, C' = 4C =
    12 at half the resolution, in the main path's bfloat16 contract."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(12)
    gates = torch.randn(2, 60, 80, 48, device="cuda", generator=g).mul_(2).bfloat16()
    c_prev = torch.randn(2, 60, 80, 12, device="cuda", generator=g).bfloat16()
    n = fused_lstm_gates.launches
    h, c = fused_lstm_gates(gates, c_prev, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_lstm_gates.launches == n + 1
    h_p, c_p = convlstm_gates.lstm_gates_plain(gates, c_prev, out_dtype=torch.bfloat16)
    torch.testing.assert_close(h.float(), h_p.float(), atol=GATES_ATOL, rtol=BF16_RTOL)
    torch.testing.assert_close(c.float(), c_p.float(), atol=GATES_ATOL, rtol=BF16_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 2, 5, 7), (2, 15, 20, 6, 12), (8, 30, 40, 192, 96)])
def test_cuda_int8_conv_exact(shape):
    """``torch._int_mm`` on the zero-padded im2col (K, N to multiples of 8,
    M past 16): exact int32 sums, equal to the CPU's."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.models.prednet import model

    B, H, W, cin, cout = shape
    rng = np.random.default_rng(cin)
    xq = torch.from_numpy(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, cin, 3, 3)).astype(np.int8))
    got = model._int8_conv(xq.cuda(), wq.cuda())
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), model._int8_conv(xq, wq))


@pytest.mark.cuda
def test_cuda_int8_batch_composition_independence():
    """On the card, too, a candidate's int8 rollout is bit-equal alone and
    beside a full-intensity neighbour; the int8 route launches no kernel."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, model

    params = model.quantize_params_int8(loader.load_or_init(None, PROBE_CHANNELS, device="cuda"))
    base = torch.from_numpy(_probe_image())[None].cuda()
    loud = torch.cat([base, torch.ones_like(base)])
    counted = (narrow_convlstm_layer, fused_lstm_gates, fused_convlstm_layer_multi)
    n = [w.launches for w in counted]
    with torch.inference_mode():
        a = model.rollout_flow_frames(params, base, repeat=4, extension=2,
                                      compute_dtype=torch.bfloat16)
        b = model.rollout_flow_frames(params, loud, repeat=4, extension=2,
                                      compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert [w.launches for w in counted] == n
    for u, v in zip(a, b):
        assert torch.isfinite(u).all() and torch.equal(u[0], v[0])


def _graph_evaluators(**kw):
    from evolutionary_illusion_generator_tpu_torch.evolution import EvalConfig, GenerationEvaluator
    from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset

    ncfg = preset("circles").replace(pop_size=12)
    params = loader.load_or_init(None, PROBE_CHANNELS, device="cuda")
    items = list(Population(ncfg, seed=3).population.items())
    evs = [GenerationEvaluator(EvalConfig(microbatch=8, program_cache=on, **kw), params, ncfg,
                               device="cuda") for on in (True, False)]
    return evs, items


def _trace_counts(fn, names):
    """How many times the kernels whose names hold each of ``names`` (a name
    or a tuple of names: any of them) ran in ``fn()``, from torch.profiler's
    device trace."""
    from torch.profiler import ProfilerActivity, profile

    # one cycle; acc_events keeps the profiler from warning that it clears
    # events between cycles
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [(n,) if isinstance(n, str) else n for n in names]
    return [sum(e.count for e in kernels if any(k in e.key for k in keys)) for keys in names]


@pytest.mark.cuda
def test_cuda_graph_replay_equals_the_eager_pass(monkeypatch):
    """Two chunks of 8 a generation (pop 12, microbatch 8), three
    generations: in the first, chunk 1 runs eagerly (the warm-up) and
    chunk 2 is captured and replayed; then both replay.  Every output
    bit-equal to the eager pass and each chunk's outputs its own (no
    aliasing of the graph's buffers).  The wrappers count only what runs
    eagerly; the graph records 22 narrow and 66 fused kernels (no gate
    kernel), and the profiler sees them run once a chunk in a replayed
    generation."""
    _cuda_or_skip()
    monkeypatch.delenv("EIGEN_PROGRAM_CACHE", raising=False)
    (graph, eager), items = _graph_evaluators()
    counted = (narrow_convlstm_layer, fused_convlstm_layer_multi, fused_lstm_gates)
    for gen in range(3):
        launches = []
        replays = graph._programs.replays
        for ev in (graph, eager):
            n = [w.launches for w in counted]
            ev(list(items))
            torch.cuda.synchronize()
            launches.append([w.launches - m for w, m in zip(counted, n)])
        assert launches[1] == [2 * 22, 2 * 66, 0], (gen, launches)
        assert launches[0] == ([22, 66, 0] if gen == 0 else [0, 0, 0]), (gen, launches)
        assert graph._programs.replays - replays == (1 if gen == 0 else 2)
        a = graph.last_results["outputs"]
        ours = a.to_numpy()
        for k, v in eager.last_results["outputs"].to_numpy().items():
            assert np.array_equal(ours[k], v), (gen, k)
        first, second = (c[0]["images_u8"] for c in a._chunks)  # one shard a chunk
        assert first.data_ptr() != second.data_ptr() and not torch.equal(first, second)
        np.testing.assert_array_equal(graph.last_results["scores"], eager.last_results["scores"])
    assert len(graph._programs.graphs) == 1 and not eager._programs.graphs
    (key, captured), = graph._programs.graphs.items()
    assert captured.recorded == {"narrow_convlstm_layer": 22, "fused_convlstm_layer_multi": 66,
                                 "ahat_error_unit": 88, "a_unit": 66}
    n = [w.launches for w in counted]
    from evolutionary_illusion_generator_tpu_torch.utils.profiling import PORT_KERNELS

    ran = _trace_counts(lambda: graph(list(items)),
                        (PORT_KERNELS["narrow_convlstm_layer"], "convlstm_fused_wgmma_kernel",
                         PORT_KERNELS["fused_lstm_gates"], PORT_KERNELS["ahat_error_unit"],
                         PORT_KERNELS["a_unit"]))
    assert ran == [2 * 22, 2 * 66, 0, 2 * 88, 2 * 66] and [w.launches for w in counted] == n


@pytest.mark.cuda
def test_cuda_options_replay_equals_the_eager_pass(monkeypatch):
    """s2d and subpixel (the gate kernel at C' = 12) through the graph,
    bit-equal to their eager passes; int8 captures with no kernel."""
    _cuda_or_skip()
    monkeypatch.delenv("EIGEN_PROGRAM_CACHE", raising=False)
    for opt in (dict(s2d_l0=True), dict(subpixel_up=True), dict(prednet_int8=True)):
        (graph, eager), items = _graph_evaluators(**opt)
        for _ in range(2):
            graph(list(items))
            eager(list(items))
        a = graph.last_results["outputs"].to_numpy()
        for k, v in eager.last_results["outputs"].to_numpy().items():
            assert np.array_equal(a[k], v), (opt, k)
        assert len(graph._programs.graphs) == 1


@pytest.mark.cuda
def test_cuda_debug_nans_names_the_fused_kernel():
    """A NaN planted in layer 2's packed ``lstm_k_r``, which only the fused
    kernel reads: no op the sanitizer mode sees holds it before the launch,
    so the wrapper's own check of the kernel's outputs raises."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, model
    from evolutionary_illusion_generator_tpu_torch.utils import debug_nans

    params = loader.load_or_init(None, PROBE_CHANNELS, device="cuda")
    img = torch.from_numpy(_probe_image())[None].cuda()
    kw = dict(repeat=2, extension=2, compute_dtype=torch.bfloat16)
    with torch.inference_mode(), debug_nans.sanitize():
        model.rollout_flow_frames(params, img, **kw)  # clean: nothing raises
    params[2] = dict(params[2], lstm_k_r=params[2]["lstm_k_r"].clone())
    params[2]["lstm_k_r"].view(-1)[5] = float("nan")
    with torch.inference_mode(), debug_nans.sanitize():
        with pytest.raises(FloatingPointError) as err:
            model.rollout_flow_frames(params, img, **kw)
    assert str(err.value) == "debug_nans: NaN in the output of fused_convlstm_layer_multi"


# ---- parallel/ on one card: a mesh that repeats cuda:0 -------------------------

PARALLEL_CHANNELS = (3, 48, 96)  # a narrow pixel layer and two fused layers
# The predictor's seed: the JAX draw from seed 1 gives live flow at 64x48
# (173 masked corner slots on the CPU); seed 0's gives none, which would
# leave the sharded and unsharded flow nothing to compare.
PARALLEL_SEED = 1
# the sharded evaluator's shapes, (w, h, channels, predictor seed): the
# small stack above, and the main path's (the bundled colour weights)
SHARD_SHAPES = {"64x48": (64, 48, PARALLEL_CHANNELS, PARALLEL_SEED),
                "160x120": (160, 120, (3, 48, 96, 192), 0)}


def _parallel_evaluators(n_shards, shape="64x48", **kw):
    from evolutionary_illusion_generator_tpu_torch.evolution import EvalConfig, GenerationEvaluator
    from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
    from evolutionary_illusion_generator_tpu_torch.parallel import (
        ShardedGenerationEvaluator,
        make_mesh,
    )

    w, h, channels, seed = SHARD_SHAPES[shape]
    ncfg = preset("circles").replace(pop_size=16)
    params = loader.load_or_init(None, channels, seed=seed, device="cuda")
    items = list(Population(ncfg, seed=3).population.items())
    cfg = EvalConfig(w=w, h=h, **kw)
    single = GenerationEvaluator(cfg, params, ncfg, device="cuda")
    sharded = ShardedGenerationEvaluator(cfg, params, ncfg,
                                         make_mesh(devices=["cuda:0"] * n_shards))
    return single, sharded, items


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHARD_SHAPES))
@pytest.mark.parametrize("n_shards", [2, 4])
def test_cuda_sharded_evaluator_on_a_repeated_device(n_shards, shape):
    """The sharded evaluator on ``["cuda:0"] * n`` at 64x48 (3,48,96) and at
    the main path's 160x120 (3,48,96,192): each shard runs the
    kernels on its rows (counted per shard), and its outputs are the
    unsharded evaluator's bit for bit: the images, the flow frame, the
    vectors, the masks and the fitness; and the predictor's two flow frames
    of each shard's rows equal those rows of the whole batch's.  Every
    kernel of the rollout sums a pixel in one order whatever the batch (the
    A and Ahat units' convs were cuDNN's, which did not)."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.models.prednet.model import (
        rollout_flow_frames,
    )
    from evolutionary_illusion_generator_tpu_torch.ops.render import to_unit_float

    single, sharded, items = _parallel_evaluators(n_shards, shape, program_cache=False)
    counted = (narrow_convlstm_layer, fused_convlstm_layer_multi, ahat_error_unit, a_unit)
    L = len(SHARD_SHAPES[shape][2])
    per_step = (1, L - 1, L, L - 1)  # the pixel layer, the fused layers, the units
    n = [w.launches for w in counted]
    want = single(list(items))
    torch.cuda.synchronize()
    m = [w.launches for w in counted]
    got = sharded(list(items))
    torch.cuda.synchronize()
    steps = 22
    assert [b - a for a, b in zip(n, m)] == [steps * k for k in per_step]
    assert [w.launches - b for w, b in zip(counted, m)] == [n_shards * steps * k
                                                            for k in per_step]
    a = single.last_results["outputs"].to_numpy()
    b = sharded.last_results["outputs"].to_numpy()
    assert a.keys() == b.keys() and a["mask"].any()  # live flow to compare
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    # the rollout's frames: each shard's rows against those of the whole batch
    imgs = to_unit_float(torch.from_numpy(a["images_u8"]).cuda())
    kw = dict(repeat=single.cfg.repeat, extension=single.cfg.extension,
              compute_dtype=getattr(torch, single.cfg.prednet_dtype))
    with torch.inference_mode():
        whole = rollout_flow_frames(single.params, imgs, **kw)
        rows = -(-len(imgs) // n_shards)
        for s0 in range(0, len(imgs), rows):
            part = rollout_flow_frames(single.params, imgs[s0:s0 + rows], **kw)
            for f_whole, f_part in zip(whole, part):
                assert torch.equal(f_whole[s0:s0 + rows], f_part), s0
    # outputs stay on the card, one shard per entry
    chunk = sharded.last_results["outputs"]._chunks[0]
    assert len(chunk) == n_shards and all(s["images_u8"].is_cuda for s in chunk)


# The sharded evaluator on each route and option against the unsharded
# pass at the main path's 160x120, 3,48,96,192 (the bundled weights), a
# population of 10 from seed 3 in two shards: the largest fitness gap, as
# scripts/shard_divergence.py measured it on an H100 (NVIDIA H100 80GB
# HBM3, 700 W).  The "fused" route, its s2d pixel layer, the int8 predictor
# and the True route (its gate convs on convlstm_narrow.gate_convs) are
# bit-equal (every op equal over 22 steps).  The plain route's bfloat16
# cuDNN convs round a row by the batch (the first op apart: layer 2's A
# conv), and its fitness moves by up to the bound here.
SHARD_ROUTE_GAPS = {"fused": 0.0, "s2d": 0.0, "int8": 0.0, "true": 0.0, "false": 0.0173}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(SHARD_ROUTE_GAPS))
def test_cuda_sharded_routes_against_the_unsharded_pass(route):
    """``scripts/shard_divergence.py`` at 160x120 on one route or option:
    the sharded evaluator's fitness within the route's measured residual of
    the unsharded evaluator's (bit-equal where it is 0), and no kernel
    wrapper's op follows the batch: only library convs may."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.scripts import shard_divergence

    option = {"true": ["--use_pallas", "true"], "false": ["--use_pallas", "false"],
              "s2d": ["--s2d"], "int8": ["--int8"]}.get(route, [])
    out = shard_divergence.main(["--w", "160", "--h", "120", "--channels", "3,48,96,192",
                                 "--pop", "10", "--shards", "2", "--steps", "2", *option])
    for label, got in out.items():
        assert got["masked"] > 0, label  # live flow to compare
        assert all(op.split()[2] == "conv2d" for op in got["batch_variant_ops"]), got
        if SHARD_ROUTE_GAPS[route] == 0.0:
            assert got["bit_equal"] and got["fitness_gap"] == 0.0, got
        else:
            assert got["fitness_gap"] <= SHARD_ROUTE_GAPS[route], got


@pytest.mark.cuda
def test_cuda_sharded_graph_replays_per_device_key(monkeypatch):
    """With the program cache, the two shards of a chunk share one graph
    (its key holds the device and the shard's shape): shard 1 warms up,
    shard 2 captures, later generations replay; bit-equal to the eager
    sharded pass."""
    _cuda_or_skip()
    monkeypatch.delenv("EIGEN_PROGRAM_CACHE", raising=False)
    _, graph, items = _parallel_evaluators(2)
    _, eager, _ = _parallel_evaluators(2, program_cache=False)
    for gen in range(3):
        graph(list(items))
        eager(list(items))
        a = graph.last_results["outputs"].to_numpy()
        for k, v in eager.last_results["outputs"].to_numpy().items():
            assert np.array_equal(a[k], v), (gen, k)
    (key, captured), = graph._programs.graphs.items()
    assert key[0] == torch.device("cuda", 0) and captured is not None
    assert graph._programs.replays == 1 + 2 + 2


@pytest.mark.cuda
def test_cuda_dp_train_step_on_a_repeated_device():
    """One data-parallel Adam step on ``["cuda:0"] * 2`` against the
    one-device step on the card: the loss at TRAIN_LOSS_RTOL, the params
    by the bfloat16 flip rule of the train test above."""
    _cuda_or_skip()
    from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, train
    from evolutionary_illusion_generator_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.uniform(0, 1, (4, 4, 32, 48, 3)).astype(np.float32)).cuda()
    mask = torch.tensor([1.0, 0.0, 0.75, 1.0], device="cuda")
    params = loader.load_or_init(None, PARALLEL_CHANNELS, seed=PARALLEL_SEED, device="cuda")
    tx = train.adam(2e-3)
    kw = dict(t_open=3, closed_weight=5.0, masked_closed=True, motion_weight=0.5)
    p1, _, l1 = train.make_train_step(tx, **kw)(params, train.init_opt_state(tx, params),
                                                frames, mask)
    pd, _, ld = train.make_train_step(tx, mesh=make_mesh(devices=["cuda:0"] * 2), **kw)(
        params, train.init_opt_state(tx, params), frames, mask)
    np.testing.assert_allclose(ld.item(), l1.item(), rtol=TRAIN_LOSS_RTOL)
    for a, b in zip(pd, p1):
        for k in b:
            x, y = a[k].float(), b[k].float()
            gap = (x - y).abs()
            assert (gap > 0).float().mean().item() <= TRAIN_FLIP_SHARE, k
            assert bool((gap <= 2.0**-7 * y.abs() + 4e-3).all()), (k, gap.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["gates", "multi", "narrow", "ahat", "a"])
def test_cuda_wrappers_refuse_tensors_off_the_current_device(wrapper, monkeypatch):
    """A launch goes to the current device, so a wrapper given tensors of
    another device raises.  One card cannot hold tensors off the current
    device, so the current device is made to read as cuda:1."""
    _cuda_or_skip()
    srcs, ws, b, c_prev = _layer_inputs(9, 1, 6, 8, (16,), 8)
    c = torch.from_numpy(c_prev).cuda()
    if wrapper == "gates":
        call = lambda: fused_lstm_gates(torch.zeros(1, 6, 8, 32, device="cuda"), c)  # noqa: E731
    elif wrapper == "narrow":
        srcs = [torch.zeros(1, 6, 8, ci, device="cuda") for ci in (16, 8)]
        wks = [torch.zeros(9, 8, 4, ci, device="cuda", dtype=torch.bfloat16) for ci in (16, 8)]
        call = lambda: narrow_convlstm_layer(srcs, wks, torch.zeros(32, device="cuda"), c)  # noqa: E731
    elif wrapper == "ahat":
        k = torch.zeros(9, 8, 8, device="cuda", dtype=torch.bfloat16)
        call = lambda: ahat_error_unit(torch.zeros(1, 6, 8, 8, device="cuda"), k,  # noqa: E731
                                       torch.zeros(8, device="cuda"), c, layer0=False,
                                       compute_dtype=torch.float32)
    elif wrapper == "a":
        k = torch.zeros(9, 8, 16, device="cuda", dtype=torch.bfloat16)
        call = lambda: a_unit(torch.zeros(1, 6, 8, 16, device="cuda"), k,  # noqa: E731
                              torch.zeros(8, device="cuda"))
    else:
        x = torch.from_numpy(srcs[0]).cuda().bfloat16()
        wk = pack_gate_weight(torch.from_numpy(ws[0]).cuda())
        call = lambda: fused_convlstm_layer_multi([x], [wk], torch.from_numpy(b).cuda(), c)  # noqa: E731
    call()  # on the current device: runs
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(RuntimeError, match="current CUDA device is cuda:1"):
        call()


@pytest.mark.cuda
def test_cuda_true_route_takes_the_gate_convs():
    """``use_pallas=True`` on the card: every layer's gates from
    ``convlstm_narrow.gate_convs`` (no cuDNN conv of a gate; the two wide
    layers on its wgmma body, the pixel layer on its mma.sync body), then
    the gate kernel, 22 steps of the three layers of 3,48,96."""
    _cuda_or_skip()
    single, _, items = _parallel_evaluators(1, use_pallas=True, program_cache=False)
    counted = (cn.gate_convs, fused_lstm_gates, narrow_convlstm_layer)
    n = [w.launches for w in counted]
    bodies = dict(cn.gate_convs.body_launches)
    scores = single(list(items))
    torch.cuda.synchronize()
    assert [w.launches - m for w, m in zip(counted, n)] == [22 * 3, 22 * 3, 0]
    assert {k: v - bodies[k] for k, v in cn.gate_convs.body_launches.items()} == {
        "wgmma": 22 * 2, "mma_sync": 22}
    assert np.isfinite(scores).all()


@pytest.mark.cuda
@pytest.mark.parametrize("route,per_step", [("fused", (1, 0, 2, 3, 2)), (True, (0, 3, 0, 3, 2)),
                                            (False, (0, 0, 0, 0, 0))])
def test_cuda_use_pallas_routes_launch_counts(route, per_step):
    """``EvalConfig.use_pallas``: per step, "fused" launches the narrow
    kernel on the pixel layer, the fused kernel on the two wide layers and
    the A and Ahat units' kernels on every layer, True the gate kernel on
    all three and the units' kernels on every layer, False none."""
    _cuda_or_skip()
    single, _, items = _parallel_evaluators(1, use_pallas=route, program_cache=False)
    counted = (narrow_convlstm_layer, fused_lstm_gates, fused_convlstm_layer_multi,
               ahat_error_unit, a_unit)
    n = [w.launches for w in counted]
    scores = single(list(items))
    torch.cuda.synchronize()
    assert [w.launches - m for w, m in zip(counted, n)] == [22 * k for k in per_step]
    assert np.isfinite(scores).all()
