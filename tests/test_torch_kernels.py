"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``evolutionary_illusion_generator_tpu_torch.ops``
runs its plain PyTorch version; the JAX side runs its Pallas kernels in
interpret mode, as ``tests/test_prednet.py`` and
``tests/test_fused_convlstm.py`` do.  Inputs come from numpy, made from a
seed, and both frameworks get the same arrays.  The CUDA kernels are held
against the plain versions on a card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.ops.convlstm_fused_pallas import (
    fused_convlstm_layer as jax_fused_layer,
    fused_convlstm_layer_multi as jax_fused_multi,
)
from evolutionary_illusion_generator_tpu.ops.convlstm_pallas import (
    fused_lstm_gates as jax_fused_gates,
)
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused, convlstm_gates
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import (
    fused_convlstm_layer,
    fused_convlstm_layer_multi,
    pack_gate_weight,
)
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

# Both sides take bfloat16 sources and weights with float32 sums; only the
# order of the float32 sums differs (< 1e-6 measured at these shapes).
CONV_ATOL = 1e-5
# float32 elementwise gate math on both sides: last-ulp differences only.
GATES_ATOL = 1e-6
# h and c rounded to bfloat16: a last-ulp float32 difference can flip the
# rounding by one bfloat16 ulp, at most 2**-7 of the value.
BF16_RTOL = 2.0**-7


def _layer_inputs(seed, B, H, W, cins, C):
    rng = np.random.default_rng(seed)
    srcs = [rng.normal(0, 1, (B, H, W, ci)).astype(np.float32) for ci in cins]
    ws = [rng.normal(0, 0.1, (3, 3, ci, 4 * C)).astype(np.float32) for ci in cins]
    b = rng.normal(0, 0.1, 4 * C).astype(np.float32)
    c_prev = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    return srcs, ws, b, c_prev


def test_gates_match_pallas():
    rng = np.random.default_rng(1)
    gates = rng.normal(0, 2, (2, 8, 16, 4 * 8)).astype(np.float32)
    c_prev = rng.normal(0, 1, (2, 8, 16, 8)).astype(np.float32)
    h_j, c_j = jax_fused_gates(jnp.asarray(gates), jnp.asarray(c_prev), interpret=True)
    h, c = fused_lstm_gates(torch.as_tensor(gates), torch.as_tensor(c_prev))
    assert h.dtype == c.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=GATES_ATOL, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=GATES_ATOL, rtol=0)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_gates_bf16_contract_matches_pallas(C, state):
    """bfloat16 gates in, bfloat16 (h, c) out (the main path's contract)
    against the JAX kernel on the gates widened to float32, its float32
    (h, c) then cast to bfloat16."""
    rng = np.random.default_rng(2 + C)
    gates = torch.as_tensor(rng.normal(0, 2, (2, 5, 7, 4 * C)).astype(np.float32)).bfloat16()
    c_prev = torch.as_tensor(rng.normal(0, 1, (2, 5, 7, C)).astype(np.float32)).to(
        getattr(torch, state))
    c_prev_j = jnp.asarray(c_prev.float().numpy(), getattr(jnp, state))
    h_j, c_j = jax_fused_gates(jnp.asarray(gates.float().numpy()), c_prev_j, interpret=True)
    h, c = fused_lstm_gates(gates, c_prev, out_dtype=torch.bfloat16)
    assert h.dtype == c.dtype == torch.bfloat16
    for got, want in ((h, h_j), (c, c_j)):
        want = torch.as_tensor(np.array(want.astype(jnp.bfloat16).astype(jnp.float32)))
        torch.testing.assert_close(got.float(), want, atol=GATES_ATOL, rtol=BF16_RTOL)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_fused_layer_matches_pallas(state):
    srcs, ws, b, c_prev = _layer_inputs(2, 2, 16, 12, (16, 8, 12), 8)
    x = np.concatenate(srcs, axis=-1)
    w = np.concatenate(ws, axis=2)
    cp_j = jnp.asarray(c_prev, state)
    h_j, c_j = jax_fused_layer(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), cp_j,
                               rows_per_block=8, interpret=True)
    cp_t = torch.as_tensor(np.asarray(cp_j, np.float32)).to(getattr(torch, state))
    h, c = fused_convlstm_layer(torch.as_tensor(x), pack_gate_weight(torch.as_tensor(w)),
                                torch.as_tensor(b), cp_t)
    assert h.dtype == cp_t.dtype and c.dtype == torch.float32
    # h in bfloat16 state: both round the same float32 value to bfloat16
    np.testing.assert_allclose(h.float().numpy(), np.asarray(h_j, np.float32),
                               atol=CONV_ATOL, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=CONV_ATOL, rtol=0)


def test_fused_multi_matches_pallas():
    srcs, ws, b, c_prev = _layer_inputs(3, 2, 16, 12, (16, 8, 12), 8)
    h_j, c_j = jax_fused_multi([jnp.asarray(s) for s in srcs], [jnp.asarray(w) for w in ws],
                               jnp.asarray(b), jnp.asarray(c_prev),
                               rows_per_block=8, interpret=True)
    h, c = fused_convlstm_layer_multi(
        [torch.as_tensor(s).bfloat16() for s in srcs],
        [pack_gate_weight(torch.as_tensor(w)) for w in ws],
        torch.as_tensor(b), torch.as_tensor(c_prev),
    )
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=CONV_ATOL, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=CONV_ATOL, rtol=0)


def test_pack_gate_weight_layout():
    """(9, C, 4, Cin)[ky*3+kx, c, g, ci] == HWIO[ky, kx, ci, g*C + c], and
    unpack_gate_weight gives the OIHW kernel back."""
    rng = np.random.default_rng(4)
    w = rng.normal(0, 1, (3, 3, 5, 4 * 6)).astype(np.float32)
    wk = pack_gate_weight(torch.as_tensor(w))
    assert wk.shape == (9, 6, 4, 5) and wk.dtype == torch.bfloat16 and wk.is_contiguous()
    ref = torch.as_tensor(w).bfloat16()
    for ci, ky, kx, c, g in [(0, 0, 0, 0, 0), (4, 2, 1, 5, 3), (2, 1, 2, 3, 1)]:
        assert wk[ky * 3 + kx, c, g, ci] == ref[ky, kx, ci, g * 6 + c]
    assert torch.equal(convlstm_fused.unpack_gate_weight(wk), ref.permute(3, 2, 0, 1))


@pytest.mark.parametrize("shape,tw", [
    ((8, 60, 80), 16),   # layer 1 of the main path: 8 x 16 tiles, no pixel wasted
    ((8, 30, 40), 8),    # layer 2: 16 x 8 tiles, no pixel wasted
    ((8, 15, 20), 20),   # layer 3: the flattened batch, 19 blocks against 20 at tw=4
    ((25, 240, 320), 16),
    ((1, 13, 21), 8),    # 3 blocks as at tw=21, with the smaller slab
])
def test_tile_width_picks_fewest_blocks(shape, tw):
    """The wrapper's tile mapping: the fewest blocks, then the smallest
    halo slab (chip_smoke.py's tile sweep times every candidate)."""
    assert convlstm_fused.tile_width(*shape) == tw
    assert tw in convlstm_fused.tile_candidates(shape[2])


def test_launch_rejects_a_bad_tile_width():
    srcs, ws, b, c_prev = _layer_inputs(8, 1, 4, 6, (8,), 4)
    args = ([torch.as_tensor(srcs[0]).bfloat16()], [pack_gate_weight(torch.as_tensor(ws[0]))],
            torch.as_tensor(b), torch.as_tensor(c_prev))
    for tw in (0, 7):  # the mma_sync body's strip width
        bad = convlstm_fused.Plan("mma_sync", 16, 0, tw, 0)
        with pytest.raises(ValueError, match="strip width"):
            convlstm_fused.launch(*args, stream=0, plan=bad)


def test_cpu_calls_are_not_launches():
    """On CPU tensors the wrappers run the plain versions and count nothing."""
    before = (fused_lstm_gates.launches, fused_convlstm_layer.launches,
              fused_convlstm_layer_multi.launches)
    fused_lstm_gates(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 2))
    srcs, ws, b, c_prev = _layer_inputs(5, 1, 8, 8, (4,), 4)
    fused_convlstm_layer(torch.as_tensor(srcs[0]), pack_gate_weight(torch.as_tensor(ws[0])),
                         torch.as_tensor(b), torch.as_tensor(c_prev))
    assert (fused_lstm_gates.launches, fused_convlstm_layer.launches,
            fused_convlstm_layer_multi.launches) == before


@pytest.mark.parametrize("bad", ["bias", "weight", "source", "count"])
def test_fused_rejects_bad_shapes(bad):
    srcs, ws, b, c_prev = _layer_inputs(6, 1, 8, 8, (4, 4), 4)
    srcs = [torch.as_tensor(s) for s in srcs]
    wks = [pack_gate_weight(torch.as_tensor(w)) for w in ws]
    b, c_prev = torch.as_tensor(b), torch.as_tensor(c_prev)
    if bad == "bias":
        b = b[:-1]
    elif bad == "weight":
        wks[1] = wks[1][:2]
    elif bad == "source":
        srcs[0] = srcs[0][:, :4]
    else:
        srcs, wks = srcs * 2, wks * 2
    with pytest.raises(ValueError):
        fused_convlstm_layer_multi(srcs, wks, b, c_prev)


def test_gates_reject_mismatched_shapes():
    with pytest.raises(ValueError):
        fused_lstm_gates(torch.zeros(1, 4, 4, 12), torch.zeros(1, 4, 4, 4))


def test_gates_reject_an_unsupported_out_dtype():
    with pytest.raises(TypeError):
        fused_lstm_gates(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 2), out_dtype=torch.float16)
