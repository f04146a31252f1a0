"""The port's synthetic pretraining data against the JAX package's, from
the same key: v2 translating textures and the v3 cue regimes, each regime
forced in turn through a one-hot ``regime_probs`` and under each option
group ``pretrain`` passes.

Regime ids and onsets must be equal (they come from bit-equal draws).  The
frames go through float32 bilinear, ``sin``/``atan2`` and ``floor`` math
that the two frameworks round differently (XLA contracts some products
into FMAs), so they are held to FRAME_ATOL; a pixel whose phase sits on a
ring, band or disc edge may flip, so at most FLIP_SHARE of them may be
further off (none did at these sizes: the largest gap was 8.5e-6).
"""

import numpy as np
import pytest
import torch

import jax

from evolutionary_illusion_generator_tpu.models.prednet import synthetic_data as jsd
from evolutionary_illusion_generator_tpu_torch.models.prednet import synthetic_data as sd
from evolutionary_illusion_generator_tpu_torch.utils import prng

torch.set_num_threads(1)

B, T, H, W = 4, 6, 24, 32
FRAME_ATOL = 2e-5
FLIP_SHARE = 1e-3
MIX = (0.15, 0.15, 0.15, 0.14, 0.14, 0.14, 0.13)

# the option groups pretrain passes (the recipes of weights/README.md)
OPTIONS = {
    "default": {},
    "onsets": dict(onset_range=(2, 4), max_onset=2),
    "hazard_slow": dict(onset_hazard=0.2, cue_slow_range=(0.1, 0.2), cue_slow_frac=0.5,
                        move_prob=0.6),
    "ring_cues": dict(ring_speed_range=(1.2, 2.0), ring_dir_cue=True, ring_onset_range=(3, 3),
                      onset_range=(2, 4), ring_speed_cue=True),
    "ring_onset": dict(ring_speed_range=(1.2, 2.0), ring_onset=True, onset_range=(1, 3)),
    "tang_radial_bands": dict(tang_radial=True, band_prob=0.6, ring_speed_range=(1.0, 2.0)),
    "tang_uniform_bands": dict(tang_uniform=True, band_prob=0.6, ring_speed_range=(1.0, 2.0),
                               ring_dir_cue=True),
    "fine_speeds": dict(cue_fine_speed_range=(0.5, 0.6), cue_fine_max_period=14.0,
                        cue_period_range=(6.0, 40.0), cue_speed_range=(0.1, 0.14)),
}


def _close(ours, theirs):
    theirs = np.asarray(theirs)
    ours = ours.numpy()
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    off = np.abs(ours - theirs) > FRAME_ATOL
    assert off.mean() <= FLIP_SHARE, (off.mean(), np.abs(ours - theirs).max())


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("static_fraction", [0.0, 0.5])
def test_motion_batch_matches_jax(c, static_fraction):
    theirs = jsd.synthetic_motion_batch(jax.random.PRNGKey(4), B, T, H, W, c,
                                        static_fraction=static_fraction)
    ours = sd.synthetic_motion_batch(prng.PRNGKey(4), B, T, H, W, c,
                                     static_fraction=static_fraction, device="cpu")
    _close(ours, theirs)
    assert 0.0 <= ours.min() and ours.max() <= 1.0


@pytest.mark.parametrize("regime", list(range(7)) + ["mix"])
@pytest.mark.parametrize("group", sorted(OPTIONS))
def test_cue_batch_matches_jax(group, regime):
    probs = MIX if regime == "mix" else tuple(float(i == regime) for i in range(7))
    kw = dict(OPTIONS[group], regime_probs=probs)
    seed = sorted(OPTIONS).index(group)
    for c in (1, 3):
        frames_j, reg_j, onset_j = jsd.synthetic_cue_batch(
            jax.random.PRNGKey(seed), B, T, H, W, c, return_regime=True, **kw)
        frames, reg, onset = sd.synthetic_cue_batch(
            prng.PRNGKey(seed), B, T, H, W, c, return_regime=True, device="cpu", **kw)
        assert reg.dtype == torch.int32 and onset.dtype == torch.float32
        np.testing.assert_array_equal(reg.numpy(), np.asarray(reg_j))
        np.testing.assert_array_equal(onset.numpy(), np.asarray(onset_j))
        if regime != "mix":
            assert (reg.numpy() == regime).all()
        _close(frames, frames_j)


def test_cue_batch_without_regimes_and_errors():
    key = prng.PRNGKey(2)
    frames = sd.synthetic_cue_batch(key, B, T, H, W, 3, device="cpu")
    again, _, _ = sd.synthetic_cue_batch(key, B, T, H, W, 3, return_regime=True, device="cpu")
    assert torch.equal(frames, again)
    with pytest.raises(ValueError, match="ring_speed_cue needs ring_dir_cue"):
        sd.synthetic_cue_batch(key, B, T, H, W, 1, ring_speed_range=(1.0, 2.0),
                               ring_speed_cue=True, device="cpu")
