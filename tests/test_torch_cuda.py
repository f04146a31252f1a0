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
    n = {w.__name__: w.launches for w in (fused_lstm_gates, fused_convlstm_layer_multi)}
    vectors = probe.get_vectors(png, None, PROBE_CHANNELS)
    torch.cuda.synchronize()
    assert fused_lstm_gates.launches == n["fused_lstm_gates"] + 22
    assert fused_convlstm_layer_multi.launches == n["fused_convlstm_layer_multi"] + 66
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
    n = fused_lstm_gates.launches, fused_convlstm_layer_multi.launches
    card, loss_card = pretrain((3, 32, 32), device="cuda", **kw)
    torch.cuda.synchronize()
    cpu, loss_cpu = pretrain((3, 32, 32), device="cpu", **kw)
    start, _ = pretrain((3, 32, 32), device="cpu", **dict(kw, steps=0))
    assert (fused_lstm_gates.launches, fused_convlstm_layer_multi.launches) == n
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
@pytest.mark.parametrize("wrapper", ["gates", "multi", "single"])
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
    fn = {"gates": lambda: fused_lstm_gates(gates, c),
          "multi": lambda: fused_convlstm_layer_multi([x], [wk], bt, c),
          "single": lambda: fused_convlstm_layer(x, wk, bt, c)}[wrapper]
    count = {"gates": fused_lstm_gates, "multi": fused_convlstm_layer_multi,
             "single": fused_convlstm_layer}[wrapper]
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
    n = (fused_lstm_gates.launches, fused_convlstm_layer_multi.launches)
    with torch.inference_mode():
        a = model.rollout_flow_frames(params, base, repeat=4, extension=2,
                                      compute_dtype=torch.bfloat16)
        b = model.rollout_flow_frames(params, loud, repeat=4, extension=2,
                                      compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (fused_lstm_gates.launches, fused_convlstm_layer_multi.launches) == n
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
    """How many times each kernel whose name holds one of ``names`` ran in
    ``fn()``, from torch.profiler's device trace."""
    from torch.profiler import ProfilerActivity, profile

    # one cycle; acc_events keeps the profiler from warning that it clears
    # events between cycles
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return [sum(e.count for e in kernels if name in e.key) for name in names]


@pytest.mark.cuda
def test_cuda_graph_replay_equals_the_eager_pass(monkeypatch):
    """Two chunks of 8 a generation (pop 12, microbatch 8), three
    generations: in the first, chunk 1 runs eagerly (the warm-up) and
    chunk 2 is captured and replayed; then both replay.  Every output
    bit-equal to the eager pass and each chunk's outputs its own (no
    aliasing of the graph's buffers).  The wrappers count only what runs
    eagerly; the graph records 22 gate and 66 fused kernels, and the
    profiler sees them run once a chunk in a replayed generation."""
    _cuda_or_skip()
    monkeypatch.delenv("EIGEN_PROGRAM_CACHE", raising=False)
    (graph, eager), items = _graph_evaluators()
    counted = (fused_lstm_gates, fused_convlstm_layer_multi)
    for gen in range(3):
        launches = []
        replays = graph._programs.replays
        for ev in (graph, eager):
            n = [w.launches for w in counted]
            ev(list(items))
            torch.cuda.synchronize()
            launches.append([w.launches - m for w, m in zip(counted, n)])
        assert launches[1] == [2 * 22, 2 * 66], (gen, launches)
        assert launches[0] == ([22, 66] if gen == 0 else [0, 0]), (gen, launches)
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
    assert captured.recorded == {"fused_lstm_gates": 22, "fused_convlstm_layer_multi": 66}
    n = [w.launches for w in counted]
    ran = _trace_counts(lambda: graph(list(items)), ("lstm_gates_kernel", "convlstm_fused_kernel"))
    assert ran == [2 * 22, 2 * 66] and [w.launches for w in counted] == n


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
# A shard runs the unsharded pass's ops on fewer rows, and cuDNN's
# algorithms follow the batch, so a bfloat16 sum of the rollout may round
# another way.  Corners are ranked by response, so such a flip may swap
# near-equal corners' slots (at 64x48, channels 3,48,96, on the H100: 79%
# of the masked slots hold the same corner in both runs, and their
# displacements agree within 2e-3 px; bit-equal at the main path's shape,
# chip_smoke.py's parallel phase).  Vectors are held slot by slot where
# both runs hold the same corner (on at least SHARD_MATCHED_SHARE of the
# slots), by their displacement; the fitness within SHARD_FITNESS_ATOL.
SHARD_MATCHED_SHARE = 0.5
SHARD_SHIFT_ATOL = 0.05
SHARD_FITNESS_ATOL = 0.05


def _flow_gap(a, b):
    """(share of the slots masked in either run where both hold the same
    corner, largest displacement gap over those slots) between two
    evaluators' outputs; there must be such slots."""
    either = a["mask"] | b["mask"]
    assert either.any(), "no flow to compare: every corner slot is masked out"
    same = a["mask"] & b["mask"] & (a["vectors"][..., :2] == b["vectors"][..., :2]).all(-1)
    shift = np.abs(a["vectors"][..., 2:] - b["vectors"][..., 2:])[same]
    return same.sum() / max(either.sum(), 1), float(shift.max(initial=0.0))


def _parallel_evaluators(n_shards, **kw):
    from evolutionary_illusion_generator_tpu_torch.evolution import EvalConfig, GenerationEvaluator
    from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
    from evolutionary_illusion_generator_tpu_torch.parallel import (
        ShardedGenerationEvaluator,
        make_mesh,
    )

    ncfg = preset("circles").replace(pop_size=16)
    params = loader.load_or_init(None, PARALLEL_CHANNELS, seed=PARALLEL_SEED, device="cuda")
    items = list(Population(ncfg, seed=3).population.items())
    cfg = EvalConfig(w=64, h=48, **kw)
    single = GenerationEvaluator(cfg, params, ncfg, device="cuda")
    sharded = ShardedGenerationEvaluator(cfg, params, ncfg,
                                         make_mesh(devices=["cuda:0"] * n_shards))
    return single, sharded, items


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4])
def test_cuda_sharded_evaluator_on_a_repeated_device(n_shards):
    """The sharded evaluator on ``["cuda:0"] * n``: each shard runs the
    kernels on its rows (counted per shard), and the outputs are the
    unsharded evaluator's: images bit-equal; the predictor's frames and
    flow are held as chip_smoke.py's parallel phase holds them (the
    fused kernel's tiles and cuDNN's algorithms follow the batch)."""
    _cuda_or_skip()
    single, sharded, items = _parallel_evaluators(n_shards, program_cache=False)
    counted = (fused_lstm_gates, fused_convlstm_layer_multi)
    n = [w.launches for w in counted]
    want = single(list(items))
    torch.cuda.synchronize()
    m = [w.launches for w in counted]
    got = sharded(list(items))
    torch.cuda.synchronize()
    steps = 22
    assert [b - a for a, b in zip(n, m)] == [steps, 2 * steps]
    assert [w.launches - b for w, b in zip(counted, m)] == [n_shards * steps,
                                                            n_shards * 2 * steps]
    a = single.last_results["outputs"].to_numpy()
    b = sharded.last_results["outputs"].to_numpy()
    np.testing.assert_array_equal(b["images_u8"], a["images_u8"])
    matched, shift = _flow_gap(a, b)
    gap = float(np.abs(got - want).max())
    assert (matched >= SHARD_MATCHED_SHARE and shift <= SHARD_SHIFT_ATOL
            and gap <= SHARD_FITNESS_ATOL and np.isfinite(got).all()), (matched, shift, gap)
    # outputs stay on the card, one shard per entry
    chunk = sharded.last_results["outputs"]._chunks[0]
    assert len(chunk) == n_shards and all(s["images_u8"].is_cuda for s in chunk)


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
@pytest.mark.parametrize("wrapper", ["gates", "multi"])
def test_cuda_wrappers_refuse_tensors_off_the_current_device(wrapper, monkeypatch):
    """A launch goes to the current device, so a wrapper given tensors of
    another device raises.  One card cannot hold tensors off the current
    device, so the current device is made to read as cuda:1."""
    _cuda_or_skip()
    srcs, ws, b, c_prev = _layer_inputs(9, 1, 6, 8, (16,), 8)
    c = torch.from_numpy(c_prev).cuda()
    if wrapper == "gates":
        call = lambda: fused_lstm_gates(torch.zeros(1, 6, 8, 32, device="cuda"), c)  # noqa: E731
    else:
        x = torch.from_numpy(srcs[0]).cuda().bfloat16()
        wk = pack_gate_weight(torch.from_numpy(ws[0]).cuda())
        call = lambda: fused_convlstm_layer_multi([x], [wk], torch.from_numpy(b).cuda(), c)  # noqa: E731
    call()  # on the current device: runs
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(RuntimeError, match="current CUDA device is cuda:1"):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("route,per_step", [("fused", (1, 2)), (True, (3, 0)), (False, (0, 0))])
def test_cuda_use_pallas_routes_launch_counts(route, per_step):
    """``EvalConfig.use_pallas``: per step, "fused" launches the gate kernel
    on the pixel layer and the fused kernel on the two wide layers, True
    the gate kernel on all three, False none."""
    _cuda_or_skip()
    single, _, items = _parallel_evaluators(1, use_pallas=route, program_cache=False)
    counted = (fused_lstm_gates, fused_convlstm_layer_multi)
    n = [w.launches for w in counted]
    scores = single(list(items))
    torch.cuda.synchronize()
    assert [w.launches - m for w, m in zip(counted, n)] == [22 * k for k in per_step]
    assert np.isfinite(scores).all()
