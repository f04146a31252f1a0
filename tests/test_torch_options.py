"""The predictor's layout options against the JAX package: the s2d pixel
layer, the subpixel top-down conv and the int8 predictor, from their layout
helpers to ``prednet_step``, the rollout and the generation evaluator.

Params are made once in numpy (seeded) and handed to both packages; images
come from numpy too.  JAX runs on the CPU, as its own tests run it.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.evolution.evaluator import (
    EvalConfig as JaxEvalConfig,
    GenerationEvaluator as JaxEvaluator,
)
from evolutionary_illusion_generator_tpu.models.prednet import model as jm
from evolutionary_illusion_generator_tpu.neat import Population as JaxPopulation
from evolutionary_illusion_generator_tpu.neat import preset as jax_preset
from evolutionary_illusion_generator_tpu.ops.flow import FlowConfig as JaxFlowConfig
from evolutionary_illusion_generator_tpu_torch.evolution import EvalConfig, GenerationEvaluator
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
from evolutionary_illusion_generator_tpu_torch.models.prednet import model as tm
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig
from evolutionary_illusion_generator_tpu_torch.structure import StructureType

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

B, H, W = 2, 40, 48
CHANNELS = (3, 8, 16)  # every layer narrow: the "fused" route is the gate kernel's
# The lifted and subpixel convs against the full-resolution conv they
# replace: the same products summed in another order (the JAX tests' bound,
# tests/test_prednet.py).
LIFT_ATOL = 2e-5
# The s2d and subpixel routes against the JAX routes, float32 params and
# compute (the JAX s2d test's bound).  The port's "fused" route takes the
# gate kernel (float32 gate math) where the JAX s2d branch always takes its
# jnp gate math in the compute dtype: at float32 the same math in another
# order; 8e-8 measured.
F32_RTOL, F32_ATOL = 1e-4, 1e-5
# bfloat16 params, state and compute (the JAX tests' bound): at bf16 the
# gate kernel's float32 gate math against the JAX bfloat16 one, and the
# state rounded every step, flip a few bfloat16 roundings; 3.4e-3 measured.
BF16_RTOL, BF16_ATOL = 0.05, 0.02
# int8, one step at float32 from the same state: exact int32 products and
# a bit-equal dequantisation, so only the gate math differs: XLA's float32
# tanh is its own approximation and differs from torch's in the last bits;
# 1.2e-7 measured.
INT8_STEP_ATOL = 1e-6
# int8 over a bfloat16 rollout: such a last-bit difference at a rounding
# boundary of the activation quantisation flips an int8 code, which moves a
# gate by a whole quantisation step, and the recurrence carries it on (the
# same reason the 22-step bf16 rollout is held in the mean, ROADMAP Queue
# 3); mean 7e-5, max 5e-3 measured.
INT8_ROLLOUT_MEAN = 1e-3
# The generation evaluator, float32 predictor on both sides (as
# tests/test_torch_evaluator.py).
FITNESS_ATOL = 1e-3
TINY_FLOW = dict(max_corners=32, win=9, levels=2, iters=6)


def _numpy_params(channels=CHANNELS, seed=3):
    layers = loader.init_params_numpy(channels, seed=seed)
    rng = np.random.default_rng(seed)
    for layer in layers:  # nonzero biases so they are exercised too
        for k in layer:
            if k.endswith("_b"):
                layer[k] = rng.normal(0, 0.1, layer[k].shape).astype(np.float32)
    return layers


def _both(layers, dtype):
    jp = [{k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in l.items()} for l in layers]
    tp = loader.params_from_numpy(layers, dtype=getattr(torch, dtype), device="cpu")
    return jp, tp


def _images(seed=1, shape=(B, H, W, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


# ---------------------------------------------------------------------------
# layout helpers: pure rearrangements, bit-equal


def _kernel(shape, dtype, seed=0):
    w = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return jnp.asarray(w, getattr(jnp, dtype)), torch.from_numpy(w).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape", [
    ("_s2d", (2, 6, 8, 5)),
    ("_d2s", (2, 3, 4, 20)),
    ("_s2d_kernel", (3, 3, 5, 8)),
    ("_s2d_kernel_tiled", (3, 3, 5, 8)),
    ("_gate_major", (3, 3, 20, 32)),
    ("_posneg_major_in", (3, 3, 48, 7)),
    ("_tile4", (12,)),
    ("_tile4_gate_major", (12,)),
])
def test_layout_helper_equals_jax(name, shape, dtype):
    """The s2d layout helpers on the same array: bit-equal (the tiled lift
    sums up to four taps, in float32 and rounded once, as ``jnp.sum``)."""
    ja, ta = _kernel(shape, dtype)
    ref, out = getattr(jm, name)(ja), getattr(tm, name)(ta)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(_np(out), _np(ref))


def test_s2d_round_trip():
    x = torch.from_numpy(_images(3, (2, 8, 12, 5)))
    assert torch.equal(tm._d2s(tm._s2d(x)), x)


def _full_res_conv(x, w_hwio):
    return tm._conv(x, tm._oihw(w_hwio), None, torch.float32)


def test_lifted_kernel_matches_full_res_conv():
    """conv(_s2d(x), _s2d_kernel(w)) == _s2d(conv(x, w))."""
    x = torch.from_numpy(_images(11, (2, 10, 14, 3)))
    _, w = _kernel((3, 3, 3, 7), "float32", seed=12)
    got = _full_res_conv(tm._s2d(x), tm._s2d_kernel(w))
    np.testing.assert_allclose(got.numpy(), tm._s2d(_full_res_conv(x, w)).numpy(),
                               rtol=LIFT_ATOL, atol=LIFT_ATOL)


def test_lifted_tiled_kernel_matches_upsample_conv():
    """conv(x, _s2d_kernel_tiled(w)) == _s2d(conv(upsample2(x), w))."""
    x = torch.from_numpy(_images(13, (2, 6, 9, 4)))
    _, w = _kernel((3, 3, 4, 8), "float32", seed=14)
    got = _full_res_conv(x, tm._s2d_kernel_tiled(w))
    ref = tm._s2d(_full_res_conv(tm._upsample2(x), w))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=LIFT_ATOL, atol=LIFT_ATOL)


def test_upconv_subpixel_matches_jax_and_upsample_conv():
    """The four coarse parity convs against JAX's and against the port's
    conv(upsample2(x)), float32."""
    x = _images(15, (2, 6, 9, 4))
    jw, tw = _kernel((3, 3, 4, 8), "float32", seed=16)
    w = tm._oihw(tw)
    got = tm._upconv_subpixel(torch.from_numpy(x), tm._subpixel_taps(w), torch.float32)
    ref = jm._upconv_subpixel(jnp.asarray(x), jw, jnp.float32)
    dense = tm._conv(tm._upsample2(torch.from_numpy(x)), w, None, torch.float32)
    assert got.shape == (2, 12, 18, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=LIFT_ATOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=LIFT_ATOL)


# ---------------------------------------------------------------------------
# int8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_int8_equals_jax(dtype):
    """The int8 codes and float32 scales of every conv, bit-equal; the gate
    conv's scale is taken over the fused kernel (the three port slices
    together), so each slice carries the JAX scale."""
    jp, tp = _both(_numpy_params(), dtype)
    jq, tq = jm.quantize_params_int8(jp), tm.quantize_params_int8(tp)
    for ref, q in zip(jq, tq):
        assert not any(k.startswith("lstm_k_") for k in q)
        full = torch.cat([q[k] for k in tm._LSTM_SLICES if k in q], dim=1)
        assert full.dtype == torch.int8 and q["lstm_w_s"].dtype == torch.float32
        np.testing.assert_array_equal(full.permute(2, 3, 1, 0).numpy(), np.asarray(ref["lstm_w"]))
        np.testing.assert_array_equal(q["lstm_w_s"].numpy(), np.asarray(ref["lstm_w_s"]))
        for k in ("ahat_w", "a_w"):
            if k in ref:
                np.testing.assert_array_equal(q[k].permute(2, 3, 1, 0).numpy(), np.asarray(ref[k]))
                np.testing.assert_array_equal(q[k + "_s"].numpy(), np.asarray(ref[k + "_s"]))
        for k in ("lstm_b", "ahat_b", "a_b"):
            if k in ref:
                assert q[k].dtype == getattr(torch, dtype)
                np.testing.assert_array_equal(_np(q[k]), _np(ref[k]))


def _jax_activation_codes(x):
    s = jnp.maximum(jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True) / 127.0, 1e-12)
    return jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8)


# the JAX quantiser as the JAX evaluator and probe run it: compiled, where
# XLA multiplies by the constant 1/127 instead of dividing by 127
_jax_codes_compiled = jax.jit(_jax_activation_codes)


@pytest.mark.parametrize("bias", [True, False])
def test_conv_q_matches_jax(bias):
    """The activation codes equal those of the compiled JAX quantiser; the
    outputs agree with the compiled JAX ``_conv_q`` to float32 rounding
    (the int32 sums are exact on both sides; XLA may contract the
    dequantising product and the bias into an FMA).  One row five times
    louder, so the per-row scales differ."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 7, 9, 6)).astype(np.float32)
    x[1] *= 5
    w = rng.normal(0, 0.3, (3, 3, 6, 12)).astype(np.float32)
    b = rng.normal(0, 0.1, 12).astype(np.float32)
    jq = jm.quantize_params_int8([{"lstm_w": jnp.asarray(w), "lstm_b": jnp.asarray(b)}])[0]
    wq = torch.from_numpy(np.array(jq["lstm_w"])).permute(3, 2, 0, 1)
    ws = torch.from_numpy(np.array(jq["lstm_w_s"]))
    np.testing.assert_array_equal(tm._activation_codes(torch.from_numpy(x))[0].numpy(),
                                  np.asarray(_jax_codes_compiled(jnp.asarray(x))))
    got = tm._conv_q(torch.from_numpy(x), wq, ws, torch.from_numpy(b) if bias else None,
                     torch.float32)
    ref = jax.jit(jm._conv_q, static_argnames="out_dtype")(
        jnp.asarray(x), jq["lstm_w"], jq["lstm_w_s"], jnp.asarray(b) if bias else None,
        out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


def test_int8_conv_pads_to_the_cuda_shapes():
    """K = 9 Cin and N padded to multiples of 8, M past 16: the products
    stay exact against a float64 conv of the codes, at M = 4 and odd Cin."""
    rng = np.random.default_rng(2)
    xq = torch.from_numpy(rng.integers(-127, 128, (1, 2, 2, 5)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (7, 5, 3, 3)).astype(np.int8))
    got = tm._int8_conv(xq, wq)
    ref = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), padding=1)
    assert got.dtype == torch.int32
    assert torch.equal(got.double(), ref.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# one step and the rollout against JAX


def _jax_rollout(jp, img, dtype, pair, **opt):
    fn = jax.jit(jm.rollout_flow_frames, static_argnames=(
        "repeat", "extension", "pair", "compute_dtype", "subpixel_up", "s2d_l0"))
    return fn(jp, jnp.asarray(img), repeat=4, extension=2, pair=pair,
              compute_dtype=getattr(jnp, dtype), **opt)


def _assert_close(got, ref, rtol, atol):
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=atol)


@pytest.mark.parametrize("route", ["fused", False])
@pytest.mark.parametrize("opt", ["s2d_l0", "subpixel_up"])
def test_step_matches_jax(opt, route):
    """One float32 step from a nonzero JAX state (its s2d-packed layer 0
    under ``s2d_l0``), prediction and every state tensor."""
    jp, tp = _both(_numpy_params(), "float32")
    img = _images(2)
    s2d = opt == "s2d_l0"
    frame = jm._s2d(jnp.asarray(img)) if s2d else jnp.asarray(img)
    step = jax.jit(jm.prednet_step, static_argnames=("subpixel_up", "s2d_l0"))
    js = jm.init_state(B, H, W, CHANNELS, dtype=jnp.float32, s2d_l0=s2d)
    for _ in range(3):  # past step 1, so c and e are nonzero
        js, _ = step(jp, js, frame, **{opt: True})
    ts = [{k: torch.from_numpy(np.array(v)) for k, v in l.items()} for l in js]
    js, jpred = step(jp, js, frame, **{opt: True})
    tp = tm.with_layout_weights(tp, **{opt: True})
    ts, tpred = tm.prednet_step(tp, ts, torch.from_numpy(np.array(frame)), use_pallas=route,
                                **{opt: True})
    _assert_close([tpred] + [ts[l][k] for l in range(3) for k in "rce"],
                  [jpred] + [js[l][k] for l in range(3) for k in "rce"], F32_RTOL, F32_ATOL)


@pytest.mark.parametrize("opt", ["s2d_l0", "subpixel_up"])
def test_step_without_the_layout_weights_raises(opt):
    """The step does not lift: params without the derived weights raise,
    naming ``with_layout_weights``; int8 params, which drop the option,
    step on."""
    _, tp = _both(_numpy_params(), "float32")
    state = tm.init_state(B, H, W, CHANNELS, device="cpu", s2d_l0=opt == "s2d_l0")
    frame = torch.from_numpy(_images(2))
    if opt == "s2d_l0":
        frame = tm._s2d(frame)
    with pytest.raises(KeyError, match="with_layout_weights"):
        tm.prednet_step(tp, state, frame, **{opt: True})
    tm.prednet_step(tm.with_layout_weights(tp, **{opt: True}), state, frame, **{opt: True})
    tq = tm.quantize_params_int8(tp)
    tm.prednet_step(tq, tm.init_state(B, H, W, CHANNELS, device="cpu"),
                    torch.from_numpy(_images(2)), **{opt: True})


@pytest.mark.parametrize("pair", ["population", "probe"])
@pytest.mark.parametrize("route", ["fused", False])
@pytest.mark.parametrize("opt", ["s2d_l0", "subpixel_up"])
def test_rollout_f32_matches_jax(opt, route, pair):
    jp, tp = _both(_numpy_params(), "float32")
    img = _images(1)
    ref = _jax_rollout(jp, img, "float32", pair, **{opt: True})
    got = tm.rollout_flow_frames(tp, torch.from_numpy(img), repeat=4, extension=2, pair=pair,
                                 use_pallas=route, **{opt: True})
    _assert_close(got, ref, F32_RTOL, F32_ATOL)


@pytest.mark.parametrize("route", ["fused", False])
@pytest.mark.parametrize("opt", ["s2d_l0", "subpixel_up"])
def test_rollout_bf16_matches_jax(opt, route):
    jp, tp = _both(_numpy_params(), "bfloat16")
    img = _images(1)
    ref = _jax_rollout(jp, img, "bfloat16", "population", **{opt: True})
    got = tm.rollout_flow_frames(tp, torch.from_numpy(img), repeat=4, extension=2,
                                 use_pallas=route, compute_dtype=torch.bfloat16, **{opt: True})
    _assert_close(got, ref, BF16_RTOL, BF16_ATOL)


def test_int8_steps_match_jax():
    """Three int8 steps at float32, each from the JAX state before it."""
    jp, tp = _both(_numpy_params(), "float32")
    jq, tq = jm.quantize_params_int8(jp), tm.quantize_params_int8(tp)
    img = _images(2)
    step = jax.jit(jm.prednet_step)
    js = jm.init_state(B, H, W, CHANNELS, dtype=jnp.float32)
    for _ in range(3):
        ts = [{k: torch.from_numpy(np.array(v)) for k, v in l.items()} for l in js]
        js, jpred = step(jq, js, jnp.asarray(img))
        ts, tpred = tm.prednet_step(tq, ts, torch.from_numpy(img))
        _assert_close([tpred] + [ts[l][k] for l in range(3) for k in "rce"],
                      [jpred] + [js[l][k] for l in range(3) for k in "rce"], 0, INT8_STEP_ATOL)


def test_int8_rollout_bf16_matches_jax_in_the_mean():
    jp, tp = _both(_numpy_params(), "bfloat16")
    jq, tq = jm.quantize_params_int8(jp), tm.quantize_params_int8(tp)
    img = _images(1)
    ref = _jax_rollout(jq, img, "bfloat16", "population")
    got = tm.rollout_flow_frames(tq, torch.from_numpy(img), repeat=4, extension=2,
                                 compute_dtype=torch.bfloat16, s2d_l0=True, subpixel_up=True)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert np.abs(g.numpy() - np.asarray(r)).mean() <= INT8_ROLLOUT_MEAN


def test_int8_batch_composition_independence():
    """A candidate's int8 rollout does not depend on its chunk: alone, and
    beside a full-intensity neighbour, bit-equal (the activation scale is
    per batch row)."""
    _, tp = _both(_numpy_params(), "bfloat16")
    tq = tm.quantize_params_int8(tp)
    base = torch.from_numpy(_images(4, (1, H, W, 3)))
    loud = torch.cat([base, torch.ones_like(base)])
    a = tm.rollout_flow_frames(tq, base, repeat=4, extension=2, compute_dtype=torch.bfloat16)
    b = tm.rollout_flow_frames(tq, loud, repeat=4, extension=2, compute_dtype=torch.bfloat16)
    for u, v in zip(a, b):
        assert torch.equal(u[0], v[0])


@pytest.mark.parametrize("case", ["int8", "odd_size"])
def test_s2d_takes_the_dense_route_where_jax_does(case):
    """The ``_s2d_ok`` gate: int8 params and odd sizes (a one-layer stack,
    the only one an odd size fits) run the dense route under
    ``s2d_l0=True``, bit-equal to it."""
    if case == "int8":
        tp = tm.quantize_params_int8(_both(_numpy_params(), "float32")[1])
        shape = (B, H, W, 3)
    else:
        tp = _both(_numpy_params((3,)), "float32")[1]
        shape = (B, 21, 30, 3)
    img = torch.from_numpy(_images(6, shape))
    a = tm.rollout_flow_frames(tp, img, repeat=3, extension=2)
    b = tm.rollout_flow_frames(tp, img, repeat=3, extension=2, s2d_l0=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_layout_weights_are_made_once_and_never_saved(monkeypatch):
    """``with_layout_weights`` lifts layer 0 and makes the tap pairs once;
    a rollout over such params lifts nothing again; the derived weights do
    not reach a saved checkpoint."""
    _, tp = _both(_numpy_params(), "float32")
    lifted = tm.with_layout_weights(tp, s2d_l0=True, subpixel_up=True)
    assert {k for k in lifted[0] if k.startswith("s2d_")} == {
        "s2d_w_e", "s2d_w_r", "s2d_w_up", "s2d_b", "s2d_ahat_w", "s2d_ahat_b", "s2d_a_w",
        "s2d_a_b"}
    assert all(("sub_w_up" in p) == ("lstm_w_up" in p) for p in lifted)
    calls = []
    for name in ("_s2d_weights", "_subpixel_taps"):
        fn = getattr(tm, name)
        monkeypatch.setattr(tm, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    img = torch.from_numpy(_images(7))
    got = tm.rollout_flow_frames(lifted, img, repeat=2, extension=2, s2d_l0=True,
                                 subpixel_up=True)
    assert calls == []
    ref = tm.rollout_flow_frames(tp, img, repeat=2, extension=2, s2d_l0=True, subpixel_up=True)
    assert calls and all(torch.equal(u, v) for u, v in zip(got, ref))
    saved = loader.params_to_numpy(lifted)
    assert [sorted(l) for l in saved] == [sorted(l) for l in loader.params_to_numpy(tp)]


# ---------------------------------------------------------------------------
# the generation evaluator


def _evaluators(opt, **kw):
    layers = _numpy_params(seed=3)
    ncfg = jax_preset("circles").replace(pop_size=6, num_hidden=4, num_outputs=3)
    items = list(JaxPopulation(ncfg, seed=5).population.items())
    base = dict(structure=StructureType.Free, w=64, h=48, c_dim=3, gradient=1, repeat=3,
                extension=2, prednet_dtype="float32")
    ref = JaxEvaluator(
        JaxEvalConfig(flow=JaxFlowConfig(**TINY_FLOW), score_backend="numpy",
                      program_cache=False, **base, **opt),
        [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], ncfg)
    ours = GenerationEvaluator(EvalConfig(flow=FlowConfig(**TINY_FLOW), **base, **opt, **kw),
                               loader.params_from_numpy(layers, torch.float32, "cpu"), ncfg,
                               device="cpu")
    return ref, ours, items


@pytest.mark.parametrize("opt", [dict(s2d_l0=True), dict(subpixel_up=True),
                                 dict(prednet_int8=True)],
                         ids=["s2d_l0", "subpixel_up", "prednet_int8"])
def test_evaluator_option_matches_jax(opt):
    ref_eval, ours_eval, items = _evaluators(opt)
    ref_scores = ref_eval(copy.deepcopy(items))
    scores = ours_eval(copy.deepcopy(items))
    np.testing.assert_allclose(scores, ref_scores, atol=FITNESS_ATOL, rtol=0)
    assert ours_eval.last_results["best_idx"] == ref_eval.last_results["best_idx"]
    if "prednet_int8" in opt:
        assert ours_eval.params[0]["lstm_w_e"].dtype == torch.int8
    if "s2d_l0" in opt:
        assert "s2d_w_r" in ours_eval.params[0]


# The int8 evaluator's rollout (3 + 2 steps at float32, its six rendered
# images), each package free-running: the activation codes of every conv
# input, each side quantising its own state as its _conv_q does.  No code
# may differ at step 0; from step 1 on a last-bit difference of the gate
# math (XLA's tanh against torch's) may flip a code at a rounding boundary
# of the quantisation, and the recurrence carries the flip on.  Measured
# (torch 2.13 and jax 0.9 on the CPU): 1,740 of 3,409,920 codes differ, the
# first 10 at step 1 (4 of them layer 0's new R); the frame of step
# repeat - 1 has 17 of 55,296 entries above 1e-6, max 1.28e-3, mean
# 1.3e-7; that of step repeat max 1.67e-3, mean 6.7e-7.  A collected frame
# is held at INT8_STEP_ATOL only where no code has differed up to its
# step; otherwise as every carried flip is held: in the mean at
# INT8_ROLLOUT_MEAN and in the max at INT8_CARRIED_MAX, three times the
# largest measured (one flipped code moves a gate by a whole quantisation
# step).
INT8_CODES_DIFF_SHARE = 1e-3
INT8_CARRIED_MAX = 5e-3


def test_int8_evaluator_rollout_codes_against_jax():
    _, ours_eval, items = _evaluators(dict(prednet_int8=True))
    ours_eval(copy.deepcopy(items))
    img = ours_eval.last_results["outputs"].to_numpy()["images_u8"][:len(items)] / np.float32(255)
    jq = jm.quantize_params_int8([{k: jnp.asarray(v) for k, v in l.items()}
                                  for l in _numpy_params(seed=3)])
    tq = ours_eval.params
    step = jax.jit(jm.prednet_step)
    n, h, w, _ = img.shape
    js = jm.init_state(n, h, w, CHANNELS, dtype=jnp.float32)
    ts = tm.init_state(n, h, w, CHANNELS, dtype=torch.float32, device="cpu")
    jframe, tframe = jnp.asarray(img), torch.from_numpy(img)
    total, differ, frames = 0, {}, {}
    for t in range(3 + 2):
        jnew, jpred = step(jq, js, jframe)
        tnew, tpred = tm.prednet_step(tq, ts, tframe)
        for l in range(len(CHANNELS)):
            srcs = {"e": (js[l]["e"], ts[l]["e"]), "r": (js[l]["r"], ts[l]["r"]),
                    "r_new": (jnew[l]["r"], tnew[l]["r"])}
            if l + 1 < len(CHANNELS):
                srcs["e_new"] = (jnew[l]["e"], tnew[l]["e"])
                srcs["r_above"] = (jnew[l + 1]["r"], tnew[l + 1]["r"])
            for name, (a, b) in srcs.items():
                ca = np.asarray(_jax_codes_compiled(a))
                cb = tm._activation_codes(b)[0].numpy()
                total += ca.size
                if (ca != cb).any():
                    differ[(t, l, name)] = int((ca != cb).sum())
        js, ts = jnew, tnew
        if t >= 2:
            frames[t] = np.abs(tpred.numpy() - np.asarray(jpred))
            jframe, tframe = jpred, tpred
    assert not any(t == 0 for t, _, _ in differ), differ
    assert sum(differ.values()) <= INT8_CODES_DIFF_SHARE * total, differ
    for t, d in frames.items():
        if not any(s <= t for s, _, _ in differ):
            assert d.max() <= INT8_STEP_ATOL, t
        else:  # a flip carried into this frame
            assert d.mean() <= INT8_ROLLOUT_MEAN and d.max() <= INT8_CARRIED_MAX, (
                t, d.mean(), d.max())


def test_evaluator_s2d_matches_its_dense_route():
    """The port's s2d evaluator against its own dense one, float32: the
    layout changes only the order of the sums (the JAX test_knobs bound)."""
    _, s2d, items = _evaluators(dict(s2d_l0=True))
    _, dense, _ = _evaluators({})
    a, b = s2d(copy.deepcopy(items)), dense(copy.deepcopy(items))
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_evaluator_s2d_default_resolves_off():
    """``s2d_l0=None`` resolves to False off a TPU, as in JAX."""
    _, ours, _ = _evaluators({})
    assert EvalConfig().s2d_l0 is None and ours._s2d_l0 is False
    assert not any(k.startswith("s2d_") for k in ours.params[0])
