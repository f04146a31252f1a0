"""The port's PredNet and weight loader against the JAX package.

Params are made once in numpy (seeded) or read from the bundled NPZ and
handed to both frameworks; images come from numpy too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.models.prednet import loader as jax_loader
from evolutionary_illusion_generator_tpu.models.prednet import model as jm
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, model
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import pack_gate_weight

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

B, H, W = 2, 40, 48

# float32 params and compute: same math, other summation order (1e-7 measured)
F32_ATOL = 1e-4
# bfloat16 params, state and compute.  The narrow layers' gates go through
# the float32 gate kernel in the port and through bfloat16 gate math on the
# JAX default path, and every step rounds states to bfloat16 (2**-8 relative)
# — a handful of rounding flips over the rollout; 2e-3 measured.
BF16_ATOL = 2e-2


def _numpy_params(channels, seed=3):
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


def _images(c0, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (B, H, W, c0)).astype(np.float32)


def test_params_from_numpy_matches_jax_load_params():
    path = loader.bundled_weights_path((3, 48, 96, 192))
    assert path is not None and path == jax_loader.bundled_weights_path((3, 48, 96, 192))
    jp = jax_loader.load_params(path)
    tp = loader.load_params(path, device="cpu")
    assert len(jp) == len(tp) == 4
    for l, (ja, t) in enumerate(zip(jp, tp)):
        C = ja["ahat_w"].shape[2]
        lstm = np.asarray(ja["lstm_w"], np.float32)
        slices = {"e": lstm[:, :, : 2 * C], "r": lstm[:, :, 2 * C : 3 * C]}
        if l < 3:
            slices["up"] = lstm[:, :, 3 * C :]
        else:
            assert "lstm_w_up" not in t and "a_w" not in t
        for name, w in slices.items():
            np.testing.assert_array_equal(
                t[f"lstm_w_{name}"].float().numpy(), w.transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(
                t[f"lstm_k_{name}"].float().numpy(),
                pack_gate_weight(torch.as_tensor(w)).float().numpy())
        for k in ("ahat_w", "a_w"):
            if k in ja:
                np.testing.assert_array_equal(
                    t[k].float().numpy(), np.asarray(ja[k], np.float32).transpose(3, 2, 0, 1))
        for k in ("lstm_b", "ahat_b", "a_b"):
            if k in ja:
                np.testing.assert_array_equal(t[k].float().numpy(), np.asarray(ja[k], np.float32))
        assert all(v.dtype == torch.bfloat16 for v in t.values())


@pytest.mark.parametrize("channels", [(1, 4, 8), (3, 8, 16)])
def test_prednet_step_f32_matches_jax(channels):
    jp, tp = _both(_numpy_params(channels), "float32")
    img = _images(channels[0])
    js = jm.init_state(B, H, W, channels, dtype=jnp.float32)
    ts = model.init_state(B, H, W, channels, dtype=torch.float32)
    jax_step = jax.jit(jm.prednet_step)
    for _ in range(3):  # past step 1, so c and e are nonzero
        js, jpred = jax_step(jp, js, jnp.asarray(img))
        ts, tpred = model.prednet_step(tp, ts, torch.as_tensor(img))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=F32_ATOL, rtol=0)
    for l in range(len(channels)):
        for k in "rce":
            np.testing.assert_allclose(ts[l][k].numpy(), np.asarray(js[l][k]),
                                       atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("pair", ["population", "probe"])
@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL), ("bfloat16", BF16_ATOL)])
def test_rollout_flow_frames_matches_jax(pair, dtype, atol):
    channels = (3, 8, 16)
    jp, tp = _both(_numpy_params(channels), dtype)
    img = _images(channels[0], seed=1)
    jax_frames = jax.jit(jm.rollout_flow_frames,
                         static_argnames=("repeat", "extension", "pair", "compute_dtype"))
    jf = jax_frames(jp, jnp.asarray(img), repeat=4, extension=2, pair=pair,
                    compute_dtype=getattr(jnp, dtype))
    tf = model.rollout_flow_frames(tp, torch.as_tensor(img), repeat=4, extension=2,
                                   pair=pair, compute_dtype=getattr(torch, dtype))
    for a, b in zip(jf, tf):
        assert b.dtype == torch.float32 and b.shape == (B, H, W, 3)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol, rtol=0)


def test_wide_layer_matches_jax_fused_path():
    """A C >= 32 layer takes the fused kernel route: the JAX
    ``use_pallas="fused"`` math (bfloat16 sources and weights, float32
    sums and gates).  Same sums in another order; bf16 state rounding
    flips give the measured 3e-4."""
    channels = (1, 32)
    jp, tp = _both(_numpy_params(channels, seed=1), "bfloat16")
    img = np.random.default_rng(2).uniform(0, 1, (2, 16, 24, 1)).astype(np.float32)
    jax_frames = jax.jit(jm.rollout_flow_frames, static_argnames=(
        "repeat", "extension", "pair", "use_pallas", "compute_dtype"))
    jf = jax_frames(jp, jnp.asarray(img), repeat=3, extension=2, pair="probe",
                    use_pallas="fused", compute_dtype=jnp.bfloat16)
    tf = model.rollout_flow_frames(tp, torch.as_tensor(img), repeat=3, extension=2,
                                   pair="probe", compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(tf[1].numpy(), np.asarray(jf[1]), atol=BF16_ATOL, rtol=0)


# One bf16 step of the wide layers against the JAX default path.  The JAX
# default rounds each source's gate conv to bfloat16 and adds them, and does
# the gate math, in bfloat16; the port sums in float32 and rounds once.
# From the same state that moves a few elements by one or two bfloat16 ulps
# (2**-7 at |x| in [1, 2), 2**-6 at [2, 4)); 1.2e-2 max, 4.5e-4 mean
# measured over four seeds.
WIDE_STEP_ATOL = 2e-2
WIDE_STEP_MEAN = 2e-3


def test_wide_layer_step_matches_jax_default_path():
    """Layer 1 of (3, 48, 96) reads E 96, R 48 and R_above 96 — the main
    path's layer-1 sources — through the fused kernel's route; layer 2
    (C = 96) too.  One step from a state the JAX default path made."""
    channels = (3, 48, 96)
    jp, tp = _both(_numpy_params(channels, seed=2), "bfloat16")
    img = np.random.default_rng(5).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    jax_step = jax.jit(jm.prednet_step, static_argnames=("compute_dtype",))
    js = jm.init_state(2, 16, 24, channels, dtype=jnp.bfloat16)
    for _ in range(3):  # past step 1, so every state is nonzero
        js, _ = jax_step(jp, js, jnp.asarray(img), compute_dtype=jnp.bfloat16)
    ts = [{k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16() for k, v in l.items()}
          for l in js]
    js, jpred = jax_step(jp, js, jnp.asarray(img), compute_dtype=jnp.bfloat16)
    ts, tpred = model.prednet_step(tp, ts, torch.as_tensor(img), compute_dtype=torch.bfloat16)
    pairs = [(tpred, jpred)] + [(ts[l][k], js[l][k]) for l in range(3) for k in "rce"]
    for t, j in pairs:
        d = np.abs(t.float().numpy() - np.asarray(j, np.float32))
        assert d.max() <= WIDE_STEP_ATOL and d.mean() <= WIDE_STEP_MEAN


def test_peephole_layer_keeps_plain_gate_math():
    channels = (1, 4)
    layers = _numpy_params(channels)
    rng = np.random.default_rng(9)
    for layer, C in zip(layers, channels):
        for k in ("w_ci", "w_cf", "w_co"):
            layer[k] = rng.normal(0, 0.5, (C,)).astype(np.float32)
    jp, tp = _both(layers, "float32")
    img = _images(1, seed=3)
    js, ts = jm.init_state(B, H, W, channels, dtype=jnp.float32), model.init_state(
        B, H, W, channels, dtype=torch.float32)
    jax_step = jax.jit(jm.prednet_step)
    for _ in range(2):
        js, jpred = jax_step(jp, js, jnp.asarray(img))
        ts, tpred = model.prednet_step(tp, ts, torch.as_tensor(img))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_narrow_layers_step_equals_the_float32_gate_route(dtype, monkeypatch):
    """The split-conv layers (``use_pallas=True``; on ``"fused"`` the
    narrow layers take ``narrow_convlstm_layer``, tests/test_torch_narrow.py)
    hand the gates to ``fused_lstm_gates`` in the compute dtype and take h
    and c in the state dtype.  One step is bit-equal to the same step on the
    route before: float32 gates, float32 h and c, then cast to the state
    dtype."""
    channels = (3, 8, 16)  # every layer narrow
    td = getattr(torch, dtype)
    tp = loader.params_from_numpy(_numpy_params(channels), dtype=td, device="cpu")
    img = torch.as_tensor(_images(3, seed=5))
    state = model.init_state(B, H, W, channels, dtype=td)
    kw = dict(compute_dtype=td, use_pallas=True)
    for _ in range(2):  # nonzero c and e
        state, _ = model.prednet_step(tp, state, img, **kw)
    new, pred = model.prednet_step(tp, state, img, **kw)
    calls = []

    def float32_route(gates, c_prev, out_dtype):
        calls.append(out_dtype)
        return convlstm_gates.lstm_gates_plain(gates.float(), c_prev)

    monkeypatch.setattr(model, "fused_lstm_gates", float32_route)
    old, pred_old = model.prednet_step(tp, state, img, **kw)
    assert calls == [td] * len(channels)
    assert torch.equal(pred, pred_old)
    for l in range(len(channels)):
        for k in "rce":
            assert new[l][k].dtype == old[l][k].dtype == td
            assert torch.equal(new[l][k], old[l][k]), (l, k)


def test_load_or_init_without_bundled_weights_is_seeded():
    a = loader.load_or_init(None, (1, 4, 8), seed=4, device="cpu")
    b = loader.load_or_init(None, (1, 4, 8), seed=4, device="cpu")
    assert all(torch.equal(a[l][k], b[l][k]) for l in range(3) for k in a[l])
    assert tuple(a[0]["lstm_w_up"].shape) == (4, 4, 3, 3)


def _conv_before(x, w, b, out_dtype, pad=None, cudnn=True):
    """``model._conv`` as it was before the plain route's float32 convs on
    the card were kept off cuDNN (``cudnn`` is taken and ignored)."""
    x = x.to(w.dtype)
    acc = torch.float32 if torch.float32 in (w.dtype, out_dtype) else w.dtype
    xn = x.permute(0, 3, 1, 2).to(acc)
    if pad is None:
        y = torch.nn.functional.conv2d(xn, w.to(acc), padding=1)
    else:
        y = torch.nn.functional.conv2d(torch.nn.functional.pad(xn, pad), w.to(acc))
    y = y.permute(0, 2, 3, 1).to(out_dtype)
    return y if b is None else y + b.to(out_dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_step_on_the_cpu_is_unchanged_by_the_cudnn_rule(dtype, monkeypatch):
    """The plain route's step on the CPU (``use_pallas=False``, the
    trainer's) is bit-equal to the step with the ``_conv`` from before, and
    never turns cuDNN off: only a float32 conv on the card does."""
    td = getattr(torch, dtype)
    channels = (3, 48, 96)
    tp = loader.params_from_numpy(_numpy_params(channels), dtype=td, device="cpu")
    img = torch.as_tensor(_images(3, seed=6))
    state = model.init_state(B, H, W, channels, dtype=td)
    for _ in range(2):
        state, _ = model.prednet_step(tp, state, img, use_pallas=False, compute_dtype=td)

    def no_cudnn_switch():
        raise AssertionError("cuDNN turned off on the CPU")

    monkeypatch.setattr(model, "_without_cudnn", no_cudnn_switch)
    new, pred = model.prednet_step(tp, state, img, use_pallas=False, compute_dtype=td)
    monkeypatch.setattr(model, "_conv", _conv_before)
    old, pred_old = model.prednet_step(tp, state, img, use_pallas=False, compute_dtype=td)
    assert torch.equal(pred, pred_old)
    for a, b in zip(new, old):
        for k in "rce":
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("route", [False, True, "fused"])
def test_only_the_plain_route_takes_its_convs_off_cudnn(route, monkeypatch):
    """``prednet_step`` asks ``_conv`` to leave cuDNN for its float32 convs
    on the plain route (``use_pallas=False``) and on no other: the kernel
    routes' convs are as they were."""
    channels = (3, 48, 96)
    tp = loader.params_from_numpy(_numpy_params(channels), dtype=torch.float32, device="cpu")
    img = torch.as_tensor(_images(3, seed=6))
    state = model.init_state(B, H, W, channels, dtype=torch.float32)
    asked, conv = [], model._conv

    def spy(*a, cudnn=True, **k):
        asked.append(cudnn)
        return conv(*a, cudnn=cudnn, **k)

    monkeypatch.setattr(model, "_conv", spy)
    model.prednet_step(tp, state, img, use_pallas=route)
    assert asked and set(asked) == {route is not False}
