"""The narrow ConvLSTM layer in one kernel (``ops/convlstm_narrow.py``)
against the JAX package on the CPU, and its place in ``prednet_step``.

On the CPU the wrapper runs its plain version (the split gate convs and the
gate math of the route before it), so the step stays bit-equal to that
route; the kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Inputs and weights are
made by numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.models.prednet import model as jm
from evolutionary_illusion_generator_tpu.ops.convlstm_pallas import (
    fused_lstm_gates as jax_fused_lstm_gates,
)
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
from evolutionary_illusion_generator_tpu_torch.models.prednet import model
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_narrow as cn
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_fused import pack_gate_weight
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates

torch.set_num_threads(1)

B, H, W = 2, 12, 18
# (C, C_above): the pixel layer under a layer of 8, the grayscale pixel
# layer under 4, and a narrow top layer (no R_above, as layer 2 of 3,8,16)
CASES = {"c3_above8": (3, 8), "c1_above4": (1, 4), "c3_top": (3, None)}
# The plain version against the JAX composition (``_conv`` per source on
# the upsampled R_above, the sum in the compute dtype, then the Pallas gate
# kernel in interpret mode).  float32: the same float32 convs summed in
# another order (XLA's against oneDNN's) and XLA's float32 tanh against
# torch's: last-bit differences of c and h (2.4e-7 measured).
F32_ATOL = 1e-6
# bfloat16 compute and state: such a last-bit difference of a source's
# float32 sum may round its bfloat16 value the other way, one bfloat16 ulp
# (2**-8 relative) of a gate, which moves c or h by up to about that much
# before their own bfloat16 rounding: at most 2**-7 of the value plus
# BF16_ATOL, on at most BF16_DIFF_SHARE of the elements (bit-equal
# measured, torch 2.13 and jax 0.9).
BF16_ATOL = 1e-2
BF16_DIFF_SHARE = 0.01


def _inputs(C, C_above, seed):
    rng = np.random.default_rng(seed)
    cins = [2 * C, C] + ([C_above] if C_above else [])
    shapes = [(B, H, W, 2 * C), (B, H, W, C)] + ([(B, H // 2, W // 2, C_above)] if C_above
                                                 else [])
    srcs = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    w = rng.normal(0, 0.3, (3, 3, sum(cins), 4 * C)).astype(np.float32)
    b = rng.normal(0, 0.3, 4 * C).astype(np.float32)
    c_prev = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    return srcs, w, b, c_prev, cins


def _jax_layer(srcs, w, b, c_prev, cins, cd):
    """The JAX narrow layer on ``use_pallas=True`` (model.py's split convs
    and ``_apply_gates``), state in the compute dtype."""
    jcd = getattr(jnp, cd)
    wj = jnp.asarray(w, jnp.bfloat16)
    bounds = np.cumsum([0] + cins)
    ws = [wj[:, :, bounds[i]:bounds[i + 1]] for i in range(len(cins))]
    xs = [jnp.asarray(s, jcd) for s in srcs]
    gates = jm._conv(xs[0], ws[0], jnp.asarray(b, jnp.bfloat16), jcd)
    gates = gates + jm._conv_nobias(xs[1], ws[1], jcd)
    if len(xs) == 3:
        gates = gates + jm._conv_nobias(jm._upsample2(xs[2]), ws[2], jcd)
    h, c = jax_fused_lstm_gates(gates.astype(jnp.float32), jnp.asarray(c_prev, jcd),
                                interpret=True)
    return np.asarray(h.astype(jcd).astype(jnp.float32)), np.asarray(
        c.astype(jcd).astype(jnp.float32))


def _port_layer_inputs(srcs, w, b, c_prev, cins, cd):
    td = getattr(torch, cd)
    bounds = np.cumsum([0] + cins)
    wks = [pack_gate_weight(torch.from_numpy(w[:, :, bounds[i]:bounds[i + 1]]))
           for i in range(len(cins))]
    xs = [torch.from_numpy(s).to(td) for s in srcs]
    return xs, wks, torch.from_numpy(b).bfloat16(), torch.from_numpy(c_prev).to(td)


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_the_jax_composition(case, cd):
    C, C_above = CASES[case]
    srcs, w, b, c_prev, cins = _inputs(C, C_above, seed=len(case) + C)
    want = _jax_layer(srcs, w, b, c_prev, cins, cd)
    xs, wks, bt, ct = _port_layer_inputs(srcs, w, b, c_prev, cins, cd)
    got = cn.narrow_convlstm_layer(xs, wks, bt, ct, compute_dtype=getattr(torch, cd))
    for g, r in zip(got, want):
        assert g.dtype == ct.dtype and tuple(g.shape) == (B, H, W, C)
        d = np.abs(g.float().numpy() - r)
        if cd == "float32":
            assert d.max() <= F32_ATOL, d.max()
        else:
            assert (d <= 2.0**-7 * np.abs(r) + BF16_ATOL).all(), d.max()
            assert (d > 0).mean() <= BF16_DIFF_SHARE, (d > 0).mean()


# ---------------------------------------------------------------------------
# prednet_step


def _params(channels, dtype, seed=3):
    layers = loader.init_params_numpy(channels, seed=seed)
    rng = np.random.default_rng(seed)
    for layer in layers:  # nonzero biases
        for k in layer:
            if k.endswith("_b"):
                layer[k] = rng.normal(0, 0.1, layer[k].shape).astype(np.float32)
    return loader.params_from_numpy(layers, dtype=getattr(torch, dtype), device="cpu")


def _old_route(params, monkeypatch):
    """``model.narrow_convlstm_layer`` replaced by the route it replaced:
    ``_gate_convs`` with the layer's OIHW weights, then the gate kernel's
    wrapper on the gates as they are, h and c in the state dtype."""
    by_weight = {id(p["lstm_k_e"]): p for p in params}

    def split_convs(srcs, wks, b, c_prev, compute_dtype):
        p = by_weight[id(wks[0])]
        r_above = srcs[2] if len(srcs) == 3 else None
        gates = model._gate_convs(p, {"e": srcs[0], "r": srcs[1]}, r_above, compute_dtype,
                                  False, False)
        return fused_lstm_gates(gates.contiguous(), c_prev, out_dtype=c_prev.dtype)

    monkeypatch.setattr(model, "narrow_convlstm_layer", split_convs)


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("channels", [(3, 8, 16), (1, 16, 32)])
def test_fused_route_step_is_bit_equal_to_the_split_conv_route(channels, cd, monkeypatch):
    """Three steps of the ``"fused"`` route from zero state, bfloat16
    weights and state (layer 2 of 1,16,32 on the fused kernel's plain
    version): every state tensor and prediction bit-equal to the split-conv
    + gate route the narrow layers took before."""
    params = _params(channels, "bfloat16")
    img = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (B, 16, 24, channels[0]))
                           .astype(np.float32))
    td = getattr(torch, cd)

    def run():
        state = model.init_state(B, 16, 24, channels, dtype=torch.bfloat16)
        preds = []
        for _ in range(3):
            state, pred = model.prednet_step(params, state, img, compute_dtype=td)
            preds.append(pred)
        return state, preds

    new_state, new_preds = run()
    _old_route(params, monkeypatch)
    old_state, old_preds = run()
    for a, b in zip(new_preds, old_preds):
        assert torch.equal(a, b)
    for a, b in zip(new_state, old_state):
        for k in "rce":
            assert a[k].dtype == b[k].dtype == torch.bfloat16 and torch.equal(a[k], b[k]), k


def _routes(monkeypatch, params, state, img, **kw):
    """Which wrapper each layer's gate step took: ('narrow' | 'gates' |
    'fused' | None) per layer, top layer first."""
    taken = []

    def spy(name, fn):
        def call(*a, **k):
            taken.append(name)
            return fn(*a, **k)
        return call

    for name, attr in (("narrow", "narrow_convlstm_layer"), ("gates", "fused_lstm_gates"),
                       ("fused", "fused_convlstm_layer_multi")):
        monkeypatch.setattr(model, attr, spy(name, getattr(model, attr)))
    model.prednet_step(params, state, img, **kw)
    monkeypatch.undo()
    return taken


@pytest.mark.parametrize("option,want", [
    ("default", ["narrow", "narrow", "narrow"]),
    ("compute_float32", ["narrow", "narrow", "narrow"]),
    ("grayscale", ["fused", "narrow", "narrow"]),
    ("s2d_l0", ["narrow", "narrow", "gates"]),
    ("subpixel_up", ["gates", "gates", "gates"]),
    ("int8", []),
    ("peephole", []),
    ("float32_weights", ["gates", "gates", "gates"]),
    ("use_pallas_true", ["gates", "gates", "gates"]),
    ("use_pallas_false", []),
])
def test_narrow_layers_take_the_narrow_kernel(option, want, monkeypatch):
    """The ``"fused"`` route sends a narrow layer (C < 32) with bfloat16
    weights to ``narrow_convlstm_layer``; the s2d pixel layer, int8 params,
    ``subpixel_up``, peepholes, float32 weights and the other routes keep
    their own."""
    channels = (1, 16, 32) if option == "grayscale" else (3, 8, 16)
    params = _params(channels, "float32" if option == "float32_weights" else "bfloat16")
    dtype = params[0]["lstm_w_e"].dtype
    kw = {"compute_dtype": torch.float32 if option == "compute_float32" else torch.bfloat16}
    s2d = option == "s2d_l0"
    if option == "int8":
        params = model.quantize_params_int8(params)
        dtype = torch.bfloat16
    elif option == "peephole":
        for p in params:
            for k in ("w_ci", "w_cf", "w_co"):
                p[k] = torch.zeros(p["ahat_w"].shape[0], dtype=dtype)
    elif option in ("s2d_l0", "subpixel_up"):
        params = model.with_layout_weights(params, **{option: True})
        kw[option] = True
    elif option.startswith("use_pallas"):
        kw["use_pallas"] = option == "use_pallas_true"
    state = model.init_state(B, 16, 24, channels, dtype=dtype, s2d_l0=s2d)
    img = torch.rand(B, 16, 24, channels[0])
    if s2d:
        img = model._s2d(img)
    assert _routes(monkeypatch, params, state, img, **kw) == want


def test_wrapper_checks_its_inputs():
    srcs, w, b, c_prev, cins = _inputs(3, 8, seed=1)
    xs, wks, bt, ct = _port_layer_inputs(srcs, w, b, c_prev, cins, "bfloat16")
    with pytest.raises(ValueError, match="R_above"):  # odd width
        cn.narrow_convlstm_layer([x[:, :, :-1] for x in xs[:2]] + [xs[2]], wks, bt,
                                 ct[:, :, :-1])
    with pytest.raises(ValueError, match="is not"):  # R_above upsampled already
        cn.narrow_convlstm_layer(xs[:2] + [model._upsample2(xs[2])], wks, bt, ct)
    with pytest.raises(ValueError, match="kernel layout"):
        cn.narrow_convlstm_layer(xs, [wks[0].float()] + wks[1:], bt, ct)
    with pytest.raises(TypeError, match="compute_dtype"):
        cn.narrow_convlstm_layer(xs, wks, bt, ct, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="channels"):
        cn.narrow_convlstm_layer([torch.zeros(1, 4, 4, 64), torch.zeros(1, 4, 4, 32)],
                                 [torch.zeros(9, 32, 4, 64, dtype=torch.bfloat16),
                                  torch.zeros(9, 32, 4, 32, dtype=torch.bfloat16)],
                                 torch.zeros(128), torch.zeros(1, 4, 4, 32))


def test_wrapper_refuses_gradients_and_counts_no_cpu_call():
    srcs, w, b, c_prev, cins = _inputs(1, 4, seed=2)
    xs, wks, bt, ct = _port_layer_inputs(srcs, w, b, c_prev, cins, "float32")
    n = cn.narrow_convlstm_layer.launches
    with pytest.raises(RuntimeError, match="has no backward"):
        cn.narrow_convlstm_layer(xs, wks, bt.float().requires_grad_(True), ct)
    with torch.no_grad():
        h, c = cn.narrow_convlstm_layer(xs, wks, bt.float().requires_grad_(True), ct)
    assert h.grad_fn is None and torch.isfinite(c).all()
    assert cn.narrow_convlstm_layer.launches == n  # the plain version is no launch
