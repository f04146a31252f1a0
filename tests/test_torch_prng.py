"""The port's threefry generator (``utils/prng.py``) against ``jax.random``.

``PRNGKey``, ``split``, ``fold_in``, ``uniform`` and ``choice(p=)`` must be
bit-equal over many keys; ``normal`` goes through ``erfinv``, whose
``log1p`` is numpy's in the port and XLA's in JAX, and is held to
NORMAL_MAXULP float32 ulps (3 measured over 4M draws).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu_torch.utils import prng

NORMAL_MAXULP = 4
SEEDS = (0, 1, 7, 42, 123456, 2**31 - 1)


def _keys(n=64, seed=5):
    """n keys, drawn by both generators from one seed."""
    ours = prng.split(prng.PRNGKey(seed), n)
    theirs = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    np.testing.assert_array_equal(ours, theirs)
    return ours


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_and_fold_in_are_bit_equal(seed):
    ours, theirs = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    assert ours.dtype == np.uint32 and ours.shape == (2,)
    for n in (1, 2, 5, 9, 33):
        np.testing.assert_array_equal(prng.split(ours, n), np.asarray(jax.random.split(theirs, n)))
    for data in (0, 1, 2, 3, 9, 11, 15, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(ours, data),
                                      np.asarray(jax.random.fold_in(theirs, data)))


def test_stacked_keys_split_and_fold_in_per_key():
    keys = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(jnp.asarray(keys)))
    np.testing.assert_array_equal(prng.split(keys, 5), want)
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 3))(jnp.asarray(keys)))
    np.testing.assert_array_equal(prng.fold_in(keys, 3), want)
    nested = prng.split(keys.reshape(8, 8, 2), 4)
    assert nested.shape == (8, 8, 4, 2)
    np.testing.assert_array_equal(nested.reshape(64, 4, 2), prng.split(keys, 4))


@pytest.mark.parametrize("shape,lo,hi", [
    ((), 0.0, 1.0),
    ((), -120 / 8, 120 / 8),
    ((2,), -2.0, 2.0),
    ((3,), 0.65, 1.0),
    ((1,), 0.0, 0.35),
    ((7, 9), 0.0, 1.0),
    ((32, 41), 0.0, 1.0),
    ((), 1e-7, 1.0 - 1e-7),
    ((), 0.0, 2 * np.pi),
    ((), 9.0, 12.0),
])
def test_uniform_is_bit_equal(shape, lo, hi):
    keys = _keys()
    ours = prng.uniform(keys, shape, lo, hi)
    theirs = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape, minval=lo, maxval=hi))(
        jnp.asarray(keys)))
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (64, *shape)
    np.testing.assert_array_equal(ours.view(np.uint32), theirs.view(np.uint32))
    assert (ours >= np.float32(lo)).all() and (ours < np.float32(hi)).all()
    one = prng.uniform(keys[3], shape, lo, hi)  # a single key
    np.testing.assert_array_equal(one, ours[3])


@pytest.mark.parametrize("trial", range(6))
def test_choice_is_bit_equal(trial):
    rng = np.random.default_rng(trial)
    p = rng.uniform(0, 1, 7).astype(np.float32)
    p[rng.integers(0, 7)] = 0.0
    if trial == 0:
        p = np.asarray((0.15, 0.15, 0.15, 0.14, 0.14, 0.14, 0.13), np.float32)
    elif trial == 1:
        p = np.asarray((0, 0.25, 0.2, 0.15, 0.2, 0.2, 0), np.float32)
    keys = _keys(256, seed=trial)
    ours = prng.choice(keys, 7, p)
    theirs = np.asarray(jax.vmap(lambda k: jax.random.choice(k, 7, p=jnp.asarray(p)))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(ours, theirs)
    assert set(np.flatnonzero(p == 0)).isdisjoint(ours)


def test_choice_one_hot_and_bad_p():
    keys = _keys(32)
    for i in range(7):
        p = np.eye(7, dtype=np.float32)[i]
        assert (prng.choice(keys, 7, p) == i).all()
    with pytest.raises(ValueError, match="shape"):
        prng.choice(keys, 7, np.ones(6))


@pytest.mark.parametrize("shape", [(1000,), (3, 3, 24, 32)])
def test_normal_within_a_few_ulps(shape):
    key = prng.PRNGKey(11)
    ours = prng.normal(key, shape)
    theirs = np.asarray(jax.random.normal(jax.random.PRNGKey(11), shape))
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_max_ulp(ours, theirs, maxulp=NORMAL_MAXULP)
    assert 0.9 < ours.std() < 1.1 and abs(ours.mean()) < 0.1
