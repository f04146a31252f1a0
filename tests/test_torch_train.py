"""The port's PredNet trainer (``models/prednet/train.py``) against the JAX
package's, and the kernel wrappers' refusal of gradients.

Params are made once in numpy (seeded) and handed to both frameworks;
gradients come back to the JAX layout through ``params_to_numpy``.  Both
sides compute in float32 on the ``use_pallas=False`` route, so losses and
gradients differ only in summation order and FMA contraction: LOSS_RTOL
and GRAD_ATOL (relative to the gradient's largest entry; 3e-7 measured).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.models.prednet import model as jm
from evolutionary_illusion_generator_tpu.models.prednet import train as jt
from evolutionary_illusion_generator_tpu_torch.models.prednet import model, train
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
    init_params_numpy,
    params_from_numpy,
    params_to_numpy,
)
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import (
    fused_convlstm_layer,
    fused_convlstm_layer_multi,
    pack_gate_weight,
)
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates
from evolutionary_illusion_generator_tpu_torch.utils import prng

torch.set_num_threads(1)

B, T, HW, T_OPEN = 3, 6, 16, 4
STACKS = [(1, 4, 8), (3, 4, 8)]
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-5  # times the gradient's largest entry
# Adam's first steps move each weight by about lr whatever the gradient's
# size, so a weight whose float32 gradient is near 0 may step another way
# in the other framework: after a few steps params agree to PARAM_ATOL but
# for at most FLIP_SHARE of them.  With bfloat16 params a float32 master a
# rounding step away from a bfloat16 midpoint may round the other way:
# those flips (one bfloat16 ulp) fall under the same share.
PARAM_ATOL = 1e-5
FLIP_SHARE = 2e-3


def _layers(channels, seed=1):
    layers = init_params_numpy(channels, seed=seed)
    rng = np.random.default_rng(seed)
    for layer in layers:  # nonzero biases, so their gradients are exercised
        for k in layer:
            if k.endswith("_b"):
                layer[k] = rng.normal(0, 0.1, layer[k].shape).astype(np.float32)
    return layers


def _frames(c0, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (B, T, HW, HW, c0)).astype(np.float32)


def _masks():
    closed = np.array([1.0, 0.0, 0.75], np.float32)
    open_ = np.ones((B, T_OPEN), np.float32)
    open_[1, :2] = 0.0
    cue = np.array([1.0, 0.0, 1.0], np.float32)
    return closed, open_, cue


def _jax(layers, dtype=jnp.float32):
    return [{k: jnp.asarray(v, dtype) for k, v in l.items()} for l in layers]


def _ours(layers, dtype=torch.float32):
    return params_from_numpy(layers, dtype, "cpu")


def _seq_kwargs(terms):
    closed, open_, cue = _masks()
    kw = dict(t_open=T_OPEN, closed_weight=5.0 if "closed" in terms else 0.0)
    if "edge" in terms:
        kw["edge_weight"] = 0.3
    if "closed_mask" in terms:
        kw["closed_mask"] = closed
    if "motion" in terms:
        kw.update(motion_weight=0.5, motion_mask=1.0 - closed)
    if "open_mask" in terms:
        kw["open_mask"] = open_
    if "cue" in terms:
        kw.update(cue_motion_weight=0.25, cue_motion_mask=cue)
    return kw


def _grads_close(got, want):
    got = params_to_numpy(got)
    for l, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            w_k = np.asarray(w[k])
            scale = max(float(np.abs(w_k).max()), 1e-12)
            np.testing.assert_allclose(g[k], w_k, atol=GRAD_ATOL * scale, rtol=0,
                                       err_msg=f"layer {l} {k}")


def _value_and_grad(fn, layers, frames, **kw):
    p32 = [{k: v.requires_grad_(True) for k, v in layer.items()}
           for layer in train.trainable(_ours(layers))]
    conv = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    loss = fn(p32, torch.from_numpy(frames), **conv)
    loss.backward()
    return loss.item(), [{k: v.grad for k, v in layer.items()} for layer in p32]


def _jax_value_and_grad(fn, layers, frames, **kw):
    conv = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    loss, grads = jax.value_and_grad(lambda p: fn(p, jnp.asarray(frames), **conv))(_jax(layers))
    return float(loss), grads


@pytest.mark.parametrize("skip_first", [True, False])
@pytest.mark.parametrize("channels", STACKS)
def test_prednet_loss_and_grads_match_jax(channels, skip_first):
    layers, frames = _layers(channels), _frames(channels[0])
    got, g = _value_and_grad(train.prednet_loss, layers, frames, skip_first=skip_first)
    want, wg = _jax_value_and_grad(jt.prednet_loss, layers, frames, skip_first=skip_first)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _grads_close(g, wg)


SEQ_TERMS = {
    "open_only": (),
    "closed": ("closed",),
    "edge": ("edge",),
    "closed_mask": ("closed", "closed_mask"),
    "motion": ("motion", "closed_mask"),
    "open_mask": ("open_mask",),
    "cue": ("cue",),
    "all": ("closed", "edge", "closed_mask", "motion", "open_mask", "cue"),
}


@pytest.mark.parametrize("terms", sorted(SEQ_TERMS))
@pytest.mark.parametrize("channels", STACKS)
def test_prednet_seq_loss_and_grads_match_jax(channels, terms):
    """Each term of the closed-loop loss alone (on the open-loop E-term),
    and all of them together."""
    layers, frames = _layers(channels), _frames(channels[0], seed=1)
    kw = _seq_kwargs(SEQ_TERMS[terms])
    got, g = _value_and_grad(train.prednet_seq_loss, layers, frames, **kw)
    want, wg = _jax_value_and_grad(jt.prednet_seq_loss, layers, frames, **kw)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _grads_close(g, wg)


STEP_KINDS = {  # name -> (make_train_step kwargs, extra step args)
    "open_loop": (dict(), ()),
    "closed": (dict(t_open=T_OPEN, closed_weight=5.0, edge_weight=0.2), ()),
    "masked": (dict(t_open=T_OPEN, closed_weight=5.0, masked_closed=True,
                    motion_weight=0.5), ("closed",)),
    "masked_cue": (dict(t_open=T_OPEN, closed_weight=5.0, masked_closed=True,
                        cue_motion_weight=0.25), ("closed", "cue")),
    "masked_open": (dict(t_open=T_OPEN, closed_weight=5.0, masked_closed=True,
                         masked_open=True), ("closed", "open")),
    "masked_open_cue": (dict(t_open=T_OPEN, closed_weight=5.0, masked_closed=True,
                             masked_open=True, cue_motion_weight=0.0625),
                        ("closed", "open", "cue")),
}


def _params_close(got, want, steps=3, lr=2e-3):
    """Within PARAM_ATOL but for FLIP_SHARE of the entries, and those
    within what ``steps`` opposite Adam steps (2 lr each) and one bfloat16
    ulp can make."""
    got = params_to_numpy(got)
    for l, (g, w) in enumerate(zip(got, want)):
        for k in w:
            w_k = np.asarray(w[k], np.float32)
            gap = np.abs(g[k] - w_k)
            assert (gap > PARAM_ATOL).mean() <= FLIP_SHARE, (l, k, (gap > PARAM_ATOL).mean())
            assert (gap <= steps * 2 * lr + 2**-7 * np.abs(w_k)).all(), (l, k, gap.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(STEP_KINDS))
def test_train_steps_match_jax(kind, dtype):
    """Three steps of each step arity; losses per step and the params after
    them (in the params' dtype, rebuilt from it every step)."""
    kw, extra = STEP_KINDS[kind]
    layers = _layers((3, 4, 8))
    closed, open_, cue = _masks()
    names = {"closed": closed, "open": open_, "cue": cue}
    jstep = jt.make_train_step(optax.adam(2e-3), **kw)
    ostep = train.make_train_step(train.adam(2e-3), **kw)
    jp = _jax(layers, getattr(jnp, dtype))
    op = _ours(layers, getattr(torch, dtype))
    jo = jt.init_opt_state(optax.adam(2e-3), jp)
    oo = train.init_opt_state(train.adam(2e-3), op)
    for i in range(3):
        frames = _frames(3, seed=10 + i)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(frames), *(jnp.asarray(names[n]) for n in extra))
        op, oo, ol = ostep(op, oo, torch.from_numpy(frames),
                           *(torch.from_numpy(names[n]) for n in extra))
        np.testing.assert_allclose(ol.item(), float(jl), rtol=1e-5 if dtype == "float32" else 1e-3)
    assert all(v.dtype == getattr(torch, dtype) for layer in op for k, v in layer.items()
               if not k.startswith("lstm_k_"))
    assert int(oo["count"]) == 3 and int(jo[0].count) == 3
    _params_close(op, jp)
    # the packed kernel weights follow the trained slices
    for layer in op:
        w = layer["lstm_w_e"].permute(2, 3, 1, 0)
        assert torch.equal(layer["lstm_k_e"], pack_gate_weight(w))


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adam(1e-2)
    jstate = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    ours = train.adam(1e-2)
    ostate = ours.init([{k: torch.from_numpy(v) for k, v in params.items()}])
    for _ in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        ju, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate)
        ou, ostate = ours.update([{k: torch.from_numpy(v) for k, v in grads.items()}], ostate)
        for k in shapes:
            np.testing.assert_allclose(ou[0][k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ostate["mu"][0][k].numpy(), np.asarray(jstate[0].mu[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ostate["nu"][0][k].numpy(), np.asarray(jstate[0].nu[k]),
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("kw,match", [
    (dict(closed_weight=1.0), "requires t_open"),
    (dict(closed_weight=1.0, t_open=2, motion_weight=0.5), "motion_weight requires masked_closed"),
    (dict(closed_weight=1.0, t_open=2, cue_motion_weight=0.5),
     "cue_motion_weight requires masked_closed"),
    (dict(masked_closed=True), "masked_closed requires closed_weight"),
    (dict(masked_open=True), "masked_open requires closed_weight"),
    (dict(cue_motion_weight=0.5), "cue_motion_weight requires closed_weight"),
    (dict(closed_weight=1.0, t_open=2, masked_open=True), "masked_open requires masked_closed"),
])
def test_make_train_step_errors_match_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jt.make_train_step(optax.adam(1e-3), **kw)
    with pytest.raises(ValueError, match=match):
        train.make_train_step(train.adam(1e-3), **kw)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", STACKS)
def test_step_routes_match_jax(channels, dtype, use_pallas):
    """``prednet_step(use_pallas=False)`` (the plain route) and ``True``
    (the gate kernel's plain version on every layer) against the JAX route
    of the same name (its Pallas gate kernel in interpret mode) after one
    step (bfloat16: one state rounding, 2**-8 relative)."""
    layers = _layers(channels)
    frame = _frames(channels[0])[:, 0]
    tol = 1e-5 if dtype == "float32" else 2e-2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    js, jpred = jm.prednet_step(_jax(layers, jdt), jm.init_state(B, HW, HW, channels, jdt),
                                jnp.asarray(frame), use_pallas=use_pallas)
    ts, tpred = model.prednet_step(_ours(layers, tdt),
                                   model.init_state(B, HW, HW, channels, tdt, "cpu"),
                                   torch.from_numpy(frame), use_pallas=use_pallas)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=tol)
    for l in range(len(channels)):
        for k in ("r", "c", "e"):
            np.testing.assert_allclose(ts[l][k].float().numpy(),
                                       np.asarray(js[l][k], np.float32), atol=tol)
    with pytest.raises(ValueError, match="use_pallas"):
        model.prednet_step(_ours(layers), model.init_state(B, HW, HW, channels, device="cpu"),
                           torch.from_numpy(frame), use_pallas="s2d")


def test_init_params_match_jax():
    """The same key gives the JAX init's weights bit for bit, at float32
    and at bfloat16."""
    channels = (3, 8, 16)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ours = params_to_numpy(model.init_params(prng.PRNGKey(3), channels, dtype=dtype,
                                                 device="cpu"))
        theirs = jm.init_params(jax.random.PRNGKey(3), channels, dtype=jdt)
        for o, t in zip(ours, theirs):
            assert set(o) == set(t)
            for k in t:
                np.testing.assert_array_equal(o[k], np.asarray(t[k], np.float32))
    peep = model.init_params(prng.PRNGKey(3), channels, peephole=True, device="cpu")
    assert all(float(layer["w_ci"].abs().sum()) == 0 for layer in peep)
    with pytest.raises(ValueError, match="3x3"):
        model.init_params(prng.PRNGKey(3), channels, kernel=5, device="cpu")


def _grad_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 5, 6, generator=g)
    w = torch.randn(3, 3, 6, 8, generator=g) * 0.1
    b = torch.zeros(8)
    c = torch.zeros(1, 4, 5, 2)
    return x, pack_gate_weight(w).float(), b, c


@pytest.mark.parametrize("wrapper", ["gates", "multi", "single"])
def test_kernel_wrappers_refuse_gradients_on_the_cpu(wrapper):
    """The wrappers have no backward: with grad mode on, an input that
    requires a gradient raises (their CPU plain versions included), so a
    loss through them cannot leave weights silently untrained."""
    x, wk, b, c = _grad_inputs()
    wk = wk.bfloat16()

    def call(**grad):
        args = {"x": x.clone(), "wk": wk.clone(), "b": b.clone(), "c": c.clone()}
        for name in grad:
            args[name].requires_grad_(True)
        if wrapper == "gates":
            return fused_lstm_gates(torch.randn(1, 4, 5, 8, requires_grad="x" in grad),
                                    args["c"])
        if wrapper == "multi":
            return fused_convlstm_layer_multi([args["x"]], [args["wk"]], args["b"], args["c"])
        return fused_convlstm_layer(args["x"], args["wk"], args["b"], args["c"])

    names = ("x", "c") if wrapper == "gates" else ("x", "wk", "b", "c")
    for name in names:
        with pytest.raises(RuntimeError, match="has no backward"):
            call(**{name: True})
        with torch.no_grad():
            h, _ = call(**{name: True})
        assert h.grad_fn is None
    h, _ = call()  # nothing requires a gradient
    assert h.grad_fn is None


def test_kernel_route_refuses_a_loss_gradient():
    """A loss through the default ("fused") route raises; the plain route
    gives every weight a gradient, layers 1-2's LSTM weights included."""
    channels = (3, 32, 32)
    layers = _layers(channels)
    frames = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 3, 8, 8, 3))
                              .astype(np.float32))
    params = [{k: v.requires_grad_(True) for k, v in layer.items()}
              for layer in train.trainable(_ours(layers))]
    for l in range(1, 3):
        params[l].update({k: v for k, v in _ours(layers)[l].items() if k.startswith("lstm_k_")})
    state = model.init_state(1, 8, 8, channels, torch.float32, "cpu")
    with pytest.raises(RuntimeError, match="has no backward"):
        model.prednet_step(params, state, frames[:, 0])
    loss = train.prednet_loss([train.trainable([p])[0] for p in params], frames)
    loss.backward()
    for layer in params:
        for k, v in layer.items():
            if not k.startswith("lstm_k_"):
                assert v.grad is not None and float(v.grad.abs().sum()) > 0, k
