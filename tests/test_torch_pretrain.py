"""The port's ``pretrain`` and its command line against the JAX package's.

Both run from the same seed at a tiny shape: the same keys, frames, initial
weights and Adam steps, float32 master weights and bfloat16 params.  The
losses of each step are recorded by wrapping ``make_train_step`` in both
modules.  Float32 sums in another order (and FMA contraction) can round a
bfloat16 param the other way now and then: params are equal but for
FLIP_SHARE of their entries, which are one bfloat16 ulp off plus what the
steps after the flip made of it (STEP_LR each).
"""

import argparse
import hashlib

import numpy as np
import pytest
import torch

import jax

from evolutionary_illusion_generator_tpu.models.prednet import pretrain as jpre
from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain as pre
from evolutionary_illusion_generator_tpu_torch.models.prednet import train
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
    init_params_numpy,
    params_from_numpy,
    params_to_numpy,
    save_params,
)

torch.set_num_threads(1)

CH = (3, 4, 8)
SHAPE = dict(batch=3, T=4, h=16, w=16)
LOSS_RTOL = 1e-5
FLIP_SHARE = 2e-3
STEP_LR = 2e-3
# the colour stack's shipped recipe (weights/README.md), shrunk in time
RECIPE = dict(regime_probs=(0, 0.25, 0.2, 0.15, 0.2, 0.2, 0), ring_speed_range=(1.2, 2.0),
              onset_range=(3, 5), closed_frames=2, closed_weight=5.0, ring_dir_cue=True,
              ring_onset_range=(2, 2), ring_mask_prefix=True, cue_speed_range=(0.1, 0.14),
              cue_period_range=(6.0, 40.0), ring_closed_scale=0.75, cue_motion_weight=0.0625)
RECIPES = {
    "colour": RECIPE,
    "v2_open_loop": dict(data="v2"),
    "rings_hinge": dict(closed_frames=2, closed_weight=5.0, ring_motion_weight=0.5,
                        ring_speed_range=(1.0, 2.0), edge_weight=0.1, band_prob=0.5),
}


def _record(monkeypatch, module):
    """Wrap ``module.make_train_step`` so each step's loss is kept."""
    losses = []
    make = module.make_train_step

    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            out = step(*args)
            losses.append(float(out[2]))
            return out
        return run

    monkeypatch.setattr(module, "make_train_step", wrapped)
    return losses


def _params_close(ours, theirs, steps):
    ours = params_to_numpy(ours)
    for l, (o, t) in enumerate(zip(ours, theirs)):
        assert set(o) == set(t)
        for k in t:
            t_k = np.asarray(t[k], np.float32)
            gap = np.abs(o[k] - t_k)
            assert (gap > 0).mean() <= FLIP_SHARE, (l, k, (gap > 0).mean())
            assert (gap <= 2**-7 * np.abs(t_k) + 2 * STEP_LR * steps).all(), (l, k, gap.max())


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_pretrain_matches_jax_step_by_step(recipe, monkeypatch):
    kw = dict(SHAPE, steps=3, seed=5, verbose=False, **RECIPES[recipe])
    jl = _record(monkeypatch, jpre)
    ol = _record(monkeypatch, pre)
    jp, jloss = jpre.pretrain(CH, **kw)
    op, oloss = pre.pretrain(CH, device="cpu", **kw)
    assert len(ol) == len(jl) == 3 and all(np.isfinite(ol))
    np.testing.assert_allclose(ol, jl, rtol=LOSS_RTOL)
    assert oloss == ol[-1]
    assert all(v.dtype == torch.bfloat16 for layer in op for v in layer.values())
    _params_close(op, jp, steps=3)


def test_checkpoint_resume_is_bitwise(tmp_path):
    kw = dict(SHAPE, steps=5, seed=2, verbose=False, device="cpu", **RECIPE)
    full, loss_full = pre.pretrain(CH, **kw)
    ck = str(tmp_path / "ck.npz")
    pre.pretrain(CH, checkpoint=ck, save_every=2, **dict(kw, steps=3))  # "killed" after step 2
    data = np.load(ck)
    assert int(data["step"]) == 2 and data["key"].dtype == np.uint32
    resumed, loss_res = pre.pretrain(CH, checkpoint=ck, save_every=2, **kw)
    assert loss_res == loss_full
    for a, b in zip(full, resumed):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_checkpoint_names_and_leaves_are_the_jax_checkpoints(tmp_path):
    """The port's checkpoint holds the JAX checkpoint's entries: the JAX
    loader restores it onto its own model and optimizer state, equal."""
    import optax

    from evolutionary_illusion_generator_tpu.models.prednet import model as jm
    from evolutionary_illusion_generator_tpu.models.prednet import train as jt

    params = params_from_numpy(init_params_numpy(CH, seed=4), torch.bfloat16, "cpu")
    tx = train.adam(1e-3)
    step = train.make_train_step(tx)
    frames = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 3, 16, 16, 3))
                              .astype(np.float32))
    params, opt, _ = step(params, train.init_opt_state(tx, params), frames)
    ck = str(tmp_path / "ck.npz")
    pre._ckpt_save(ck, params, opt, np.array([1, 2], np.uint32), 7)
    jparams = jm.init_params(jax.random.PRNGKey(0), CH)
    jopt = jt.init_opt_state(optax.adam(1e-3), jparams)
    jp, jo, key, at = jpre._ckpt_load(ck, jparams, jopt)
    assert at == 7 and list(np.asarray(key)) == [1, 2]
    for o, t in zip(params_to_numpy(params), jp):
        for k in t:
            np.testing.assert_array_equal(o[k], np.asarray(t[k], np.float32))
    assert int(jo[0].count) == 1
    for o, t in zip(params_to_numpy(opt["mu"]), jo[0].mu):
        for k in t:
            np.testing.assert_array_equal(o[k], np.asarray(t[k]))
    for o, t in zip(params_to_numpy(opt["nu"]), jo[0].nu):
        for k in t:
            np.testing.assert_array_equal(o[k], np.asarray(t[k]))


def test_stale_checkpoint_is_ignored(tmp_path, capsys):
    kw = dict(SHAPE, steps=2, seed=3, device="cpu", **RECIPE)
    ck = str(tmp_path / "ck.npz")
    pre.pretrain((3, 4, 6), checkpoint=ck, save_every=1, verbose=False,
                 **dict(kw, steps=2))  # another stack leaves a checkpoint at step 1
    fresh, loss_fresh = pre.pretrain(CH, verbose=False, **kw)
    again, loss_again = pre.pretrain(CH, checkpoint=ck, save_every=0, verbose=True, **kw)
    assert "ignoring stale checkpoint" in capsys.readouterr().out
    assert loss_again == loss_fresh
    for a, b in zip(fresh, again):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_init_weights_warm_start_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "warm.npz")
    save_params(params_from_numpy(init_params_numpy(CH, seed=9), torch.float32, "cpu"), path,
                dtype=np.float16)
    kw = dict(SHAPE, steps=2, seed=1, verbose=False, init_weights=path, **RECIPE)
    jl = _record(monkeypatch, jpre)
    ol = _record(monkeypatch, pre)
    jp, _ = jpre.pretrain(CH, **kw)
    op, _ = pre.pretrain(CH, device="cpu", **kw)
    np.testing.assert_allclose(ol, jl, rtol=LOSS_RTOL)
    _params_close(op, jp, steps=2)
    save_params(params_from_numpy(init_params_numpy((3, 4), seed=9), torch.float32, "cpu"), path)
    with pytest.raises(ValueError, match="2 layers, expected 3"):
        pre.pretrain(CH, device="cpu", **kw)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(data="v2", closed_frames=2, closed_exclude_rings=True), ValueError, "need the v3"),
    (dict(ring_mask_prefix=True), ValueError, "ring_mask_prefix needs"),
    (dict(tang_radial=True, tang_uniform=True), ValueError, "pick one"),
    (dict(data="v4"), ValueError, "unknown data set"),
])
def test_pretrain_errors(kw, exc, match):
    with pytest.raises(exc, match=match):
        pre.pretrain(CH, steps=1, verbose=False, device="cpu", **dict(SHAPE, **kw))


def _parsers(monkeypatch):
    """The JAX and the port ``main``'s parsers, taken at ``parse_args``."""
    found = []

    class Got(Exception):
        pass

    def grab(self, args=None, namespace=None):
        found.append((self, argparse.ArgumentParser.parse_known_args(self, args)[0]))
        raise Got

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for main in (jpre.main, pre.main):
        with pytest.raises(Got):
            main(["--channels", "3,48,96,192", "--ring_dir_cue", "--cue_speed", "0.1,0.14"])
    monkeypatch.undo()
    return found


def test_main_flags_and_defaults_match_jax(monkeypatch):
    (jp, jargs), (op, oargs) = _parsers(monkeypatch)
    jacts = {a.dest: a for a in jp._actions}
    oacts = {a.dest: a for a in op._actions}
    assert set(oacts) - set(jacts) == {"device"}
    assert set(jacts) <= set(oacts) and len(jacts) == 40  # 39 flags and -h
    for dest, a in jacts.items():
        b = oacts[dest]
        for field in ("option_strings", "default", "type", "choices", "const", "nargs",
                      "required", "help"):
            assert getattr(a, field) == getattr(b, field), (dest, field)
        assert type(a) is type(b), dest
    assert oacts["device"].default is None
    # the part file's recipe tag is the JAX one for the same flags
    recipe = {k: v for k, v in sorted(vars(jargs).items()) if k not in ("out", "save_every")}
    tag = hashlib.sha256(repr(recipe).encode()).hexdigest()[:10]
    assert pre.part_path(oargs) == f"prednet_3_48_96_192.npz.part-{tag}.npz"
    oargs.device = "cpu"
    assert pre.part_path(oargs) == f"prednet_3_48_96_192.npz.part-{tag}.npz"
    oargs.save_every = 0
    assert pre.part_path(oargs) is None


def test_main_trains_and_writes_the_weights_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--channels", "1,4,8", "--steps", "3", "--batch", "2", "--frames", "3",
            "--height", "16", "--width", "16", "--save_every", "2", "--device", "cpu",
            "--closed_frames", "1", "--closed_exclude_rings", "--ring_speed", "1.0,2.0"]
    assert pre.main(argv) == 0
    out = tmp_path / "prednet_1_4_8.npz"
    assert out.exists() and not list(tmp_path.glob("*.part-*"))
    data = np.load(out)
    assert {"l0/lstm_w", "l2/ahat_w"} <= set(data.files)
    assert data["l0/lstm_w"].dtype == np.float32 and data["l0/lstm_w"].shape == (3, 3, 7, 4)
    args = pre._parser().parse_args(argv)
    kw = pre.pretrain_kwargs(args)
    assert kw["ring_speed_range"] == (1.0, 2.0) and kw["closed_exclude_rings"]
    params, _ = pre.pretrain(verbose=False, **kw)
    for o, t in zip(params_to_numpy(params), [
            {k[3:]: data[k] for k in data.files if k.startswith(f"l{l}/")} for l in range(3)]):
        for k in t:
            np.testing.assert_array_equal(o[k], t[k])
