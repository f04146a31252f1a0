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
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import (
    fused_convlstm_layer,
    fused_convlstm_layer_multi,
    pack_gate_weight,
)
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates
from evolutionary_illusion_generator_tpu_torch.scripts import kernel_bisect as kb

# float32 elementwise gate math on both sides: last-ulp differences only.
GATES_ATOL = 1e-6
# h and c rounded to bfloat16: a last-ulp float32 difference can flip the
# rounding by one bfloat16 ulp, at most 2**-7 of the value.
BF16_RTOL = 2.0**-7
# h rounded to bfloat16: one rounding flip is 2**-8 at |h| < 1.
H_ATOL = 1e-2

# (B, H, W, source channels, C): the main path's three layers at a chunk of
# 2, then ragged shapes — image edges inside a tile, channel counts not a
# multiple of 16 (40) or of 8 (12), C not a multiple of 16
FUSED_CASES = {
    "layer1": (2, 60, 80, (96, 48, 96), 48),
    "layer2": (2, 30, 40, (192, 96, 192), 96),
    "layer3": (2, 15, 20, (384, 192), 192),
    "single": (2, 60, 80, (240,), 48),
    "ragged1": (2, 13, 21, (40,), 24),
    "ragged2": (2, 13, 21, (40, 12), 24),
    "ragged3": (2, 13, 21, (12, 40, 24), 24),
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


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_cuda_fused_kernel_matches_plain(case, state):
    _cuda_or_skip()
    B, H, W, cins, C = FUSED_CASES[case]
    srcs, ws, b, c_prev = _layer_inputs(7, B, H, W, cins, C)
    srcs = [torch.as_tensor(s).cuda().bfloat16() for s in srcs]
    wks = [pack_gate_weight(torch.as_tensor(w)).cuda() for w in ws]
    b = torch.as_tensor(b).cuda()
    c_prev = torch.as_tensor(c_prev).cuda().to(getattr(torch, state))
    wrapper = fused_convlstm_layer_multi if len(cins) > 1 else fused_convlstm_layer
    n = wrapper.launches
    h, c = (wrapper(srcs, wks, b, c_prev) if len(cins) > 1
            else wrapper(srcs[0], wks[0], b, c_prev))
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1
    h_p, c_p = convlstm_fused.convlstm_layer_plain(srcs, wks, b, c_prev)
    assert h.dtype == h_p.dtype
    # h in bfloat16 state: one rounding flip is 2**-8 at |h| < 1
    torch.testing.assert_close(h.float(), h_p.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(c, c_p, atol=1e-4, rtol=0)


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
