"""The port's kernel-bisection ladder against the JAX package's.

Each rung of ``scripts/pallas_bisect.py`` runs its Pallas kernel in TPU
interpret mode on the CPU; the port's wrapper in
``evolutionary_illusion_generator_tpu_torch.ops.convlstm_bisect`` runs its
plain version on CPU tensors.  Both get the same numpy arrays (bfloat16
values, made from a seed) at the ladder's default shape, at a ragged one
(W not a multiple of the 16-pixel tile, Cin not a multiple of 16), at a
wide one (W not a multiple of the 64-pixel row tile of rungs C, D, H and I,
Cin not a multiple of 16, 4C = 288 above the 192 gate outputs of one of
their blocks), at one of odd row blocks (rows 3, 7 windows: the wgmma
body's row pairs straddle the windows) and at one of odd row blocks with
a Cin that is not a multiple of 8 (rows 5, 3 windows, Cin 12: the wgmma
body's cp.async main loop crosses windows, which overlap inside ``xp`` for
E and J).  The ``cuda`` tests hold each CUDA kernel against its plain
version on a card, at every shape, and skip without one.  One test reads
``csrc/``: the six conv rungs are one wgmma kernel, and no ``mma.sync``
conv body is left in the ladder.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from evolutionary_illusion_generator_tpu_torch.ops import convlstm_bisect as cb
from evolutionary_illusion_generator_tpu_torch.ops import convlstm_fused
from evolutionary_illusion_generator_tpu_torch.scripts import kernel_bisect as kb
from evolutionary_illusion_generator_tpu_torch.scripts import rung_a_breakdown as ab
from evolutionary_illusion_generator_tpu_torch.scripts import wgmma_breakdown as wb

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "pallas_bisect", Path(__file__).resolve().parents[1] / "scripts" / "pallas_bisect.py")
pb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pb)

# (B, H, W, Cin, C), rows
SHAPES = {
    "default": (kb.DEFAULT_SHAPE, 32),
    "ragged": ((2, 16, 20, 24, 8), 8),
    "wide": ((2, 24, 70, 40, 72), 8),
    "odd_rows": ((2, 21, 70, 40, 18), 3),
    "cpasync_windows": ((2, 15, 66, 12, 18), 5),
}
JAX_RUNGS = {"A": pb.variant_A, "C": pb.variant_C, "D": pb.variant_D, "H": pb.variant_H,
             "E": pb.variant_E, "I": pb.variant_H2, "J": pb.variant_E2}
# Both sides sum bfloat16 products in float32; only the order differs.
F32_ATOL = 1e-5
# h rounded to bfloat16: one rounding flip is 2**-8 at |h| < 1.
H_ATOL = 1e-2


def _inputs(shape):
    """The ladder's inputs as float32 numpy arrays of bfloat16 values."""
    return [t.float().numpy() for t in kb.make_inputs(shape, "cpu")]


def _jax(arrays):
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("key", sorted(JAX_RUNGS))
def test_rung_matches_pallas(key, shape):
    dims, rows = SHAPES[shape]
    arrays = _inputs(dims)
    kw = {"rows": rows} if key in kb.ROW_BLOCK_KEYS else {}
    with pltpu.force_tpu_interpret_mode():
        h_j, c_j = JAX_RUNGS[key](*_jax(arrays), **kw)
    h, c = cb.RUNGS[key](*_torch(arrays), **kw)
    assert h.shape == c.shape == tuple(dims[:3]) + (dims[4],)
    assert str(h.dtype).split(".")[-1] == str(h_j.dtype)
    assert c.dtype == torch.float32 and str(c_j.dtype) == "float32"
    if key == "A":
        assert np.array_equal(h.numpy(), np.asarray(h_j)) and np.array_equal(c.numpy(), np.asarray(c_j))
    else:
        _close(h, h_j, F32_ATOL if key == "C" else H_ATOL)
        _close(c, c_j, F32_ATOL)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_rung_a_exact_at_a_ragged_count(state):
    """A on 105 elements (not a multiple of the kernel's 8- or 4-element
    vectors), both state types, exactly as the Pallas rung."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (1, 3, 5, 4)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 4, 28)).astype(np.float32)
    b = rng.normal(0, 0.1, 28).astype(np.float32)
    c_prev = torch.from_numpy(rng.normal(0, 4, (1, 3, 5, 7)).astype(np.float32)).to(
        getattr(torch, state))
    c_j = jnp.asarray(c_prev.float().numpy(), getattr(jnp, state))
    with pltpu.force_tpu_interpret_mode():
        out_j, _ = JAX_RUNGS["A"](*_jax([x, w, b]), c_j)
    out, same = cb.variant_A(*_torch([x, w, b]), c_prev)
    assert out is same and out.dtype == torch.float32 and out.numel() % 8
    assert np.array_equal(out.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("key", ["B", "F", "X"])
def test_ladder_keys_match_xla_reference(key, shape):
    """The port's B, F and X against the JAX script's ``xla_reference``."""
    arrays = _inputs(SHAPES[shape][0])
    h_j, c_j = pb.xla_reference(*_jax(arrays))
    h, c = kb.VARIANTS[key](*_torch(arrays))
    _close(h, h_j, H_ATOL if key == "F" else F32_ATOL)
    _close(c, c_j, F32_ATOL)


def test_inputs_match_the_reference_script():
    """``make_inputs`` draws what ``pallas_bisect.main`` draws, bit for bit."""
    B, H, W, Cin, C = kb.DEFAULT_SHAPE
    rng = np.random.default_rng(0)
    want = [jnp.asarray(rng.normal(0, 1, (B, H, W, Cin)), jnp.bfloat16),
            jnp.asarray(rng.normal(0, 0.05, (3, 3, Cin, 4 * C)), jnp.bfloat16),
            jnp.asarray(rng.normal(0, 0.1, (4 * C,)), jnp.bfloat16),
            jnp.asarray(rng.normal(0, 1, (B, H, W, C)), jnp.bfloat16)]
    for got, ref in zip(kb.make_inputs(kb.DEFAULT_SHAPE, "cpu"), want):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("aligned", [False, True])
def test_glue_matches_the_reference(aligned):
    """``pad_input`` and ``window_stack`` build the reference's ``xp`` and
    ``xh`` (the ``jnp.pad`` and ``jnp.stack`` of variants E/H and E2/H2)."""
    (B, H, W, Cin, C), rows = SHAPES["ragged"]
    x = _inputs((B, H, W, Cin, C))[0]
    wp = ((W + 2 + 15) // 16) * 16 if aligned else W + 2
    xp_j = jnp.pad(jnp.asarray(x, jnp.bfloat16), ((0, 0), (1, 1), (1, wp - W - 1), (0, 0)))
    xh_j = jnp.stack([xp_j[:, i * rows: i * rows + rows + 2] for i in range(H // rows)], axis=1)
    xp = cb.pad_input(torch.from_numpy(x), aligned)
    xh = cb.window_stack(xp, rows)
    assert xp.dtype == xh.dtype == torch.bfloat16
    assert np.array_equal(xp.float().numpy(), np.asarray(xp_j, np.float32))
    assert np.array_equal(xh.float().numpy(), np.asarray(xh_j, np.float32))


def test_pack_rung_weight_layout():
    """The rung kernels take the fused kernel's layout from the one packer:
    (9, C, 4, Cin)[ky*3+kx, c, g, ci] == HWIO[ky, kx, ci, g*C + c]; a
    weight in another layout is refused."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(0, 1, (3, 3, 7, 4 * 3)).astype(np.float32))
    wt = cb.pack_gate_weight(w)
    assert cb.pack_gate_weight is convlstm_fused.pack_gate_weight
    assert wt.shape == (9, 3, 4, 7) and wt.dtype == torch.bfloat16 and wt.is_contiguous()
    ref = w.bfloat16()
    for ci, ky, kx, c, g in [(0, 0, 0, 0, 0), (6, 2, 1, 2, 3), (3, 1, 2, 1, 1)]:
        assert wt[ky * 3 + kx, c, g, ci] == ref[ky, kx, ci, g * 3 + c]
    x = torch.zeros(1, 4, 4, 7)
    c_prev = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match=r"\(9, 3, 4, 7\)"):
        cb.launch("D", cb.prepare("D", x), wt.reshape(7, 9, 3, 4), torch.zeros(12), c_prev,
                  None, 0)


@pytest.mark.parametrize("key", list(kb.ROW_BLOCK_KEYS))
def test_rows_must_divide_h(key):
    """The reference leaves the last H % rows rows unwritten (NaN in
    interpret mode); the port refuses the shape instead."""
    (dims, _) = SHAPES["ragged"]
    args = _torch(_inputs(dims))
    with pytest.raises(ValueError, match="unwritten"):
        cb.RUNGS[key](*args, rows=6)
    with pytest.raises(ValueError, match="positive"):
        cb.RUNGS[key](*args, rows=0)


def test_cpu_calls_are_not_launches():
    args = _torch(_inputs(SHAPES["ragged"][0]))
    before = {k: fn.launches for k, fn in cb.RUNGS.items()}
    for key, fn in cb.RUNGS.items():
        fn(*args, **({"rows": 8} if key in kb.ROW_BLOCK_KEYS else {}))
    assert {k: fn.launches for k, fn in cb.RUNGS.items()} == before


@pytest.mark.parametrize("bad", ["weight", "bias", "state"])
def test_rungs_reject_bad_shapes(bad):
    x, w, b, c_prev = _torch(_inputs(SHAPES["ragged"][0]))
    if bad == "weight":
        w = w[:, :, :-1]
    elif bad == "bias":
        b = b[:-1]
    else:
        c_prev = c_prev[:, :-1]
    for fn in cb.RUNGS.values():
        with pytest.raises(ValueError):
            fn(x, w, b, c_prev)


@pytest.fixture
def small_ladder(monkeypatch):
    """The ladder at the ragged shape with one timed loop, so a CPU run is
    quick."""
    monkeypatch.setattr(kb, "DEFAULT_SHAPE", SHAPES["ragged"][0])
    monkeypatch.setattr(kb, "REPS", 1)


def test_ladder_runs_every_rung_on_the_cpu(small_ladder, capsys):
    results = kb.main(["--device", "cpu", "--rows", "8", "--variants", "ABCDHEIJFX"])
    assert list(results) == list("ABCDHEIJFX")
    for key, r in results.items():
        assert r["ok"] and r["ms"] > 0 and r["err"] <= kb.H_TOL, (key, r)
    assert results["A"]["err"] == 0.0
    out = capsys.readouterr().out
    assert out.count("] ok build=") == 10 and "FAILED" not in out


def test_ladder_fails_on_a_bad_rung(small_ladder, monkeypatch, capsys):
    def wrong(x, w, b, c_prev):
        h, c = cb.variant_D(x, w, b, c_prev)
        return h + 0.5, c

    monkeypatch.setitem(kb.VARIANTS, "D", wrong)
    with pytest.raises(RuntimeError, match="rungs failed: DH"):
        kb.main(["--device", "cpu", "--rows", "6", "--variants", "XDH"])
    out = capsys.readouterr().out
    assert "[X] ok" in out and "[D] FAILED" in out and "[H] FAILED" in out


def test_ladder_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kb.main([])


def test_conv_rungs_are_one_wgmma_kernel():
    """Each conv rung's C entry is defined in csrc/bisect_wgmma.cu and in no
    other source, and rung A's file holds no mma.sync conv body."""
    csrc = Path(cb.__file__).resolve().parents[1] / "csrc"
    sources = {p.name: p.read_text() for p in csrc.glob("*.cu*")}
    for key in "CDHEIJ":
        entry = f'extern "C" int eigen_bisect_{key.lower()}('
        assert [n for n, text in sources.items() if entry in text] == ["bisect_wgmma.cu"], key
        assert cb._CONV_RUNGS[key].entry == f"eigen_bisect_{key.lower()}"
    rung_a = sources["convlstm_bisect.cu"]
    assert 'extern "C" int eigen_bisect_a(' in rung_a
    assert "mma16816" not in rung_a and "bisect_conv_kernel" not in rung_a
    assert rung_a.count('extern "C"') == 1


@pytest.mark.parametrize("name", list(wb.VARIANTS))
def test_wgmma_breakdown_variants_apply(name):
    """Each timing variant of the six conv rungs still finds its text in
    csrc/bisect_wgmma.cu once (the script raises otherwise), and all but
    the kernel itself change it."""
    source = wb._SOURCE.read_text()
    variant = wb.variant_source(name)
    assert (variant == source) == (name == "kernel")


@pytest.mark.parametrize("name", list(ab.VARIANTS))
def test_rung_a_breakdown_variants_apply(name):
    """Each timing variant of rung A still finds its text in
    csrc/convlstm_bisect.cu once (the script raises otherwise), all but the
    kernel itself change it, and each is a source of its own with the C
    entry."""
    variant = ab.variant_source(name)
    assert (variant == ab.variant_source("kernel")) == (name == "kernel")
    assert 'extern "C" int eigen_bisect_a(' in variant and "eigen_bisect_e" not in variant


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # plain float32 convs in full float32


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("key", sorted(JAX_RUNGS))
def test_cuda_rung_kernel_matches_plain(key, shape):
    _cuda_or_skip()
    dims, rows = SHAPES[shape]
    args = [t.cuda() for t in _torch(_inputs(dims))]
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
