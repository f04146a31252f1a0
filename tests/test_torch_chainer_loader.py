"""The port's Chainer ``.model`` importer, ``save_params`` and
``load_or_init`` routing against the JAX package's loader.

The snapshots are synthetic: the fixture builders of
``tests/test_chainer_loader.py`` (``chainer.serializers.save_npz`` layout,
OIHW links, seeded with numpy) and its exporter of native params into that
layout, applied to the bundled grayscale weights.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.models.prednet import loader as jax_loader
from evolutionary_illusion_generator_tpu_torch import cli
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, model
from test_chainer_loader import (
    CHANNELS,
    H,
    W,
    export_chainer_arrays,
    make_chainer_fixture,
    oracle_rollout,
    save_fixture,
)

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

BW = (1, 16, 32, 64)
# float32 params and state: the port's plain convolutions against the
# oracle's loops (the JAX test holds its own model to the oracle at 2e-5)
ORACLE_ATOL = 2e-5
# detect_half_order's reconstruction errors: the port's wide layers sum
# bfloat16 sources in float32 (the fused route), the JAX default sums
# float32 ones (1.0e-4 relative measured)
ERR_RTOL = 1e-3


def _same(ours, ref):
    """Per layer, the same keys and bit-equal float32 arrays."""
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            b_k = np.asarray(b[k], np.float32) if not torch.is_tensor(b[k]) else b[k].numpy()
            assert a[k].dtype == np.float32 and a[k].shape == b_k.shape, k
            np.testing.assert_array_equal(a[k], b_k, err_msg=k)


def _save(tmp_path, name, arrays):
    """A ``.model`` file (an NPZ under another suffix), as Chainer writes."""
    path = str(tmp_path / name)
    np.savez(path + ".npz", **arrays)
    os.rename(path + ".npz", path)
    return path


@pytest.mark.parametrize("half_order", ["ahat-a", "a-ahat"])
@pytest.mark.parametrize("prefix", ["", "predictor/", "updater/model:main/predictor/"])
@pytest.mark.parametrize("peephole", [True, False])
def test_import_is_bit_equal_to_jax(tmp_path, peephole, prefix, half_order):
    """Key patterns, prefix stripping, OIHW -> HWIO, the (i, f, o, c)
    re-stack, the half swap and the (H, W, C) peepholes: the numpy params
    equal the JAX importer's float32 ones bit for bit, and the port params
    made from them read back to the same arrays."""
    path, _ = save_fixture(tmp_path, peephole=peephole, prefix=prefix)
    ours = loader.chainer_params_numpy(path, CHANNELS, half_order)
    _same(ours, jax_loader.load_chainer_model(path, CHANNELS, dtype=jnp.float32,
                                              half_order=half_order))
    params = loader.load_chainer_model(path, CHANNELS, torch.float32, half_order, "cpu")
    _same(loader.params_to_numpy(params), ours)
    assert ("w_ci" in params[0]) == peephole


def test_bare_single_source_links_equal_jax(tmp_path):
    """Un-numbered ``Wx{g}`` links over the concatenated [E, up(R)] input."""
    arrays = make_chainer_fixture(peephole=False)
    bare = {}
    for k, v in arrays.items():
        if "/Wx" in k and k[-3] == "0":  # ConvLSTM{l}/Wx{g}0/W|b
            l, g = k.split("/")[0], k.split("/")[1][2]
            above = arrays.get(f"{l}/Wx{g}1/W") if k.endswith("/W") else None
            bare[f"{l}/Wx{g}/{k[-1]}"] = v if above is None else np.concatenate([v, above], 1)
        elif "/Wx" not in k:
            bare[k] = v
    path = _save(tmp_path, "bare.model", bare)
    _same(loader.chainer_params_numpy(path, CHANNELS),
          jax_loader.load_chainer_model(path, CHANNELS, dtype=jnp.float32))


@pytest.mark.parametrize("peephole", [True, False])
def test_imported_params_match_the_numpy_oracle(tmp_path, peephole):
    """The port's ``prednet_step`` on the imported params (float32) equals
    the per-gate Chainer math of the JAX test's oracle, step for step; with
    peepholes every layer takes the plain gate math."""
    path, arrays = save_fixture(tmp_path, peephole=peephole)
    params = loader.load_chainer_model(path, CHANNELS, torch.float32, device="cpu")
    frame = np.random.default_rng(42).uniform(0, 1, (H, W, CHANNELS[0])).astype(np.float32)
    state = model.init_state(1, H, W, CHANNELS, dtype=torch.float32)
    want = oracle_rollout(arrays, CHANNELS, frame, 3, peephole=peephole)
    with torch.inference_mode():
        for t in range(3):
            state, pred = model.prednet_step(params, state, torch.from_numpy(frame)[None])
            np.testing.assert_allclose(pred[0].numpy(), want[t], atol=ORACLE_ATOL,
                                       err_msg=f"step {t}")


def test_half_order_auto_matches_jax(tmp_path):
    """A snapshot exported from the bundled grayscale weights in each half
    convention: ``detect_half_order`` decides as the JAX one does, with the
    same errors within the float32/bfloat16 sums' difference, and
    ``half_order="auto"`` imports the native weights back either way."""
    params = jax_loader.load_params(jax_loader.bundled_weights_path(BW), dtype=jnp.float32)
    native = [{k: np.asarray(v, np.float32) for k, v in layer.items()} for layer in params]
    for flip, want in ((False, "ahat-a"), (True, "a-ahat")):
        path = _save(tmp_path, f"flip{flip}.model",
                     export_chainer_arrays(params, BW, swap_e_halves=flip))
        best, errs = loader.detect_half_order(path, BW, device="cpu")
        ref_best, ref_errs = jax_loader.detect_half_order(path, BW)
        assert best == ref_best == want
        for order in errs:
            assert errs[order] == pytest.approx(ref_errs[order], rel=ERR_RTOL)
        auto = loader.load_chainer_model(path, BW, torch.float32, "auto", "cpu")
        _same(loader.params_to_numpy(auto), native)
        if flip:  # read in the wrong order, the snapshot is not the weights
            wrong = loader.chainer_params_numpy(path, BW, "ahat-a")
            assert not np.array_equal(wrong[0]["lstm_w"], native[0]["lstm_w"])


def test_errors_name_what_is_wrong(tmp_path):
    arrays = make_chainer_fixture()
    del arrays["ConvP1/W"]
    broken = _save(tmp_path, "broken.model", arrays)
    with pytest.raises(ValueError, match="p1"):
        loader.chainer_params_numpy(broken, CHANNELS)
    path, _ = save_fixture(tmp_path)
    with pytest.raises(ValueError, match="does not match channels"):
        loader.chainer_params_numpy(path, (3, 48))
    junk = str(tmp_path / "junk.npz")
    np.savez(junk, foo=np.zeros(3))
    with pytest.raises(ValueError, match="neither"):
        loader.chainer_params_numpy(junk, CHANNELS)
    with pytest.raises(ValueError, match="half_order"):
        loader.load_chainer_model(path, CHANNELS, half_order="sideways", device="cpu")
    partial = make_chainer_fixture()
    del partial["ConvLSTM0/Wco/W"]
    with pytest.raises(ValueError, match="partial peephole"):
        loader.chainer_params_numpy(_save(tmp_path, "partial.model", partial), CHANNELS)
    for bad in (broken, junk):  # the JAX importer refuses the same files
        with pytest.raises(ValueError):
            jax_loader.load_chainer_model(bad, CHANNELS)


def test_load_or_init_routes_as_jax(tmp_path):
    """Native NPZ first, a Chainer snapshot on its ValueError, else the
    bundled weights, else seeded params; a missing file raises."""
    chainer, _ = save_fixture(tmp_path)
    routed = loader.load_or_init(chainer, CHANNELS, dtype=torch.float32, device="cpu")
    _same(loader.params_to_numpy(routed),
          jax_loader.load_or_init(chainer, list(CHANNELS), dtype=jnp.float32))
    native = str(tmp_path / "native.npz")
    loader.save_params(routed, native)
    _same(loader.params_to_numpy(loader.load_or_init(native, CHANNELS, dtype=torch.float32,
                                                     device="cpu")),
          loader.params_to_numpy(routed))
    bundled = loader.load_or_init(None, BW, dtype=torch.float32, device="cpu")
    _same(loader.params_to_numpy(bundled),
          jax_loader.load_params(jax_loader.bundled_weights_path(BW), dtype=jnp.float32))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        seeded = loader.load_or_init(None, (1, 4, 8), seed=2, dtype=dtype, device="cpu")
        _same(loader.params_to_numpy(seeded),
              jax_loader.load_or_init(None, [1, 4, 8], seed=2, dtype=jdt))
    with pytest.raises(FileNotFoundError):
        loader.load_or_init(str(tmp_path / "none.model"), CHANNELS, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_save_params_writes_what_jax_reads(tmp_path, dtype):
    """``save_params`` writes the JAX layout (HWIO ``l{i}/{name}`` keys) at
    ``dtype``, atomically: the JAX ``load_params`` reads the same arrays
    and no temporary file is left."""
    path, _ = save_fixture(tmp_path)
    params = loader.load_chainer_model(path, CHANNELS, torch.float32, device="cpu")
    out = str(tmp_path / "sub" / "saved.npz")
    loader.save_params(params, out, dtype=dtype)
    assert os.listdir(tmp_path / "sub") == ["saved.npz"]
    assert {np.load(out)[k].dtype for k in np.load(out).files} == {np.dtype(dtype)}
    want = [{k: v.astype(dtype).astype(np.float32) for k, v in layer.items()}
            for layer in loader.params_to_numpy(params)]
    _same(want, jax_loader.load_params(out, dtype=jnp.float32))


def test_cli_takes_a_chainer_snapshot(tmp_path):
    """``--model <.model> --chainer_half_order auto`` runs a generation on
    the CPU with the imported predictor."""
    ch = (3, 4, 8)
    arrays = make_chainer_fixture(channels=ch, peephole=False)
    path = _save(tmp_path, "snap.model", arrays)
    out = tmp_path / "out"
    assert cli.main(["-o", str(out), "-s", "1", "-ch", "3,4,8", "-m", path, "--generations", "1",
                     "--chainer_half_order", "auto", "--device", "cpu"]) == 0
    assert (out / "metrics.jsonl").exists() and (out / "best.png").exists()
