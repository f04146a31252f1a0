"""The port's sparse flow (corners, pyramidal LK, masks) against the JAX
package on the same frame pairs, made from a seed with numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.ops.flow import api as jax_api
from evolutionary_illusion_generator_tpu.ops.flow import lk as jax_lk
from evolutionary_illusion_generator_tpu_torch.ops.flow import api, lk

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

TINY_FLOW = dict(max_corners=32, win=9, levels=2, iters=6)
# Identical corner positions and masks; the flow differs by float32
# summation order in the window sums, amplified by the Newton solve
# (1.5e-5 px measured at the default config).
FLOW_ATOL = 1e-3


def _texture(rng, h, w):
    """Smooth random texture: bilinear upsampling of coarse noise."""
    c = rng.uniform(0, 1, (h // 6 + 2, w // 6 + 2))
    ys = np.linspace(0, c.shape[0] - 1.001, h)
    xs = np.linspace(0, c.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None]
    return (c[y0][:, x0] * (1 - fy) * (1 - fx) + c[y0 + 1][:, x0] * fy * (1 - fx)
            + c[y0][:, x0 + 1] * (1 - fy) * fx
            + c[y0 + 1][:, x0 + 1] * fy * fx).astype(np.float32)


def _frame_pairs(h, w, seed):
    rng = np.random.default_rng(seed)
    f0 = np.stack([np.stack([_texture(rng, h, w)] * 3, -1) for _ in range(3)])
    f1 = np.roll(f0, 1, axis=2) * 0.98 + 0.01  # one pixel right, dimmed
    return f0, f1


@pytest.mark.parametrize("shape,cfg", [((40, 48), TINY_FLOW), ((120, 160), {})])
def test_batched_flow_matches_jax(shape, cfg):
    f0, f1 = _frame_pairs(*shape, seed=0)
    jax_flow = jax.jit(jax_api.batched_flow, static_argnums=2)
    jv, jm = jax_flow(jnp.asarray(f0), jnp.asarray(f1), jax_api.FlowConfig(**cfg))
    tv, tm = api.batched_flow(torch.as_tensor(f0), torch.as_tensor(f1), api.FlowConfig(**cfg))
    jv, jm, tv, tm = np.asarray(jv), np.asarray(jm), tv.numpy(), tm.numpy()
    np.testing.assert_array_equal(tv[..., :2], jv[..., :2])  # corner positions
    np.testing.assert_array_equal(tm, jm)
    assert tm.sum() > 0
    np.testing.assert_allclose(tv[..., 2:][tm], jv[..., 2:][jm], atol=FLOW_ATOL, rtol=0)


def test_windows_place_starts_like_dynamic_slice():
    """dynamic_slice counts a negative start from the end, then clamps."""
    img = np.arange(30 * 40, dtype=np.float32).reshape(30, 40)
    tl = np.array([[5, -1], [5, 0], [-2, 3], [35, 3], [-50, -50]], np.int32)
    ref = np.asarray(jax_lk._int_windows(jnp.asarray(img), jnp.asarray(tl), 4))
    ours = lk._int_windows(torch.as_tensor(img)[None], torch.as_tensor(tl)[None].long(), 4)
    np.testing.assert_array_equal(ours[0].numpy(), ref)


def test_flat_frames_have_no_corners():
    f0 = np.full((2, 40, 48, 3), 0.5, np.float32)
    vec, mask = api.batched_flow(torch.as_tensor(f0), torch.as_tensor(f0),
                                 api.FlowConfig(**TINY_FLOW))
    assert vec.shape == (2, 32, 4) and not mask.any()
