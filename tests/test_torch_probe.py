"""The port's single-image probe and its LANCZOS resampler against Pillow
and the JAX package.

Inputs are the committed ``gallery/`` PNGs or images made from a numpy
seed; where a channel stack has no bundled weights, the same numpy weights
go to both packages through one NPZ file.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.evolution import probe as jax_probe
from evolutionary_illusion_generator_tpu.models.prednet import loader as jax_loader
from evolutionary_illusion_generator_tpu.models.prednet import model as jax_model
from evolutionary_illusion_generator_tpu.ops.fitness import calculate_fitness as jax_fitness
from evolutionary_illusion_generator_tpu.ops.flow import api as jax_flow
from evolutionary_illusion_generator_tpu.utils import image_io as jax_io
from evolutionary_illusion_generator_tpu_torch.evolution import probe
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, model
from evolutionary_illusion_generator_tpu_torch.ops.fitness.metrics_np import swarm_score
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig, flow_vectors, to_gray
from evolutionary_illusion_generator_tpu_torch.utils import image_io
from evolutionary_illusion_generator_tpu_torch.utils.resample import lanczos_resize

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GALLERY = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "gallery").glob("**/*.png"))
SMALL = (3, 4, 8)
# a small flow stage (its JAX program compiles in seconds) that still finds
# 18 vectors on the small probe's image
PROBE_FLOW = dict(max_corners=32, levels=2, iters=6)
# Identical corners and masks; the flow differs by float32 summation order
# (as tests/test_torch_flow.py; 1.7e-5 px measured here)
FLOW_ATOL = 1e-3
# 22 bfloat16 steps of the bundled color predictor, the port's fused
# layers against the JAX default's split convolutions: a rounding flip
# grows step after step, so the frame is held in the mean (ROADMAP Queue
# 3; chip_smoke.py's ROLLOUT_MEAN_TOL), the vectors by count and by score.
ROLLOUT_MEAN_TOL = 2e-2  # 0.0098 measured on circles_color/best.png
COUNT_RTOL = 0.1  # 113 and 113 vectors measured
SWARM_ATOL = 1e-2  # 0.4019 against 0.4026 measured


def write_npz(path, channels, seed=3):
    """Seeded numpy params as a native NPZ checkpoint, read by both
    packages."""
    layers = loader.init_params_numpy(channels, seed=seed)
    np.savez(path, **{f"l{l}/{k}": v for l, layer in enumerate(layers)
                      for k, v in layer.items()})
    return str(path)


def texture_png(path, w, h, seed):
    """A smooth textured RGB image (corners to track), written as a PNG."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (h // 8 + 2, w // 8 + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None]
    tex = (coarse[y0][:, x0] * (1 - fy) * (1 - fx) + coarse[y0 + 1][:, x0] * fy * (1 - fx)
           + coarse[y0][:, x0 + 1] * (1 - fy) * fx + coarse[y0 + 1][:, x0 + 1] * fy * fx)
    img = np.stack([tex, tex[::-1], tex[:, ::-1]], axis=-1)
    jax_io.save_image(img, str(path))
    return str(path)


# ---------------------------------------------------------------------------
# LANCZOS


@pytest.mark.parametrize("shape,size", [
    ((37, 29, 3), (160, 120)),  # up, both axes
    ((120, 160, 3), (13, 9)),  # down, both axes
    ((480, 640), (160, 120)),  # L, down by 4
    ((7, 5), (61, 3)),  # L, up one axis and down the other
    ((50, 3, 3), (50, 50)),  # up, odd sizes
    ((33, 21, 3), (21, 40)),  # the height only
    ((31, 17, 3), (40, 31)),  # the width only
    ((120, 160, 3), (160, 120)),  # the same size: a copy
    ((1, 1), (5, 4)),
])
def test_lanczos_equals_pillow(shape, size):
    rng = np.random.default_rng(sum(shape) + sum(size))
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(Image.fromarray(arr).resize(size, Image.LANCZOS))
    out = lanczos_resize(arr, size)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    if size == shape[1::-1]:
        assert out is not arr and not np.shares_memory(out, arr)


@pytest.mark.parametrize("path", GALLERY)
def test_lanczos_equals_pillow_on_the_gallery(path):
    """Every gallery PNG (160x120, 640x480 and 800x800, L and RGB) in both
    modes, to the probe's 160x120 and to an odd size.  The files are decoded
    by Pillow here: the port's reader is held equal to it on the same files
    in tests/test_torch_image_io.py."""
    img = Image.open(REPO / path)
    for mode in ("L", "RGB"):
        src = img.convert(mode)
        for size in ((160, 120), (97, 61)):
            np.testing.assert_array_equal(lanczos_resize(np.asarray(src), size),
                                          np.asarray(src.resize(size, Image.LANCZOS)))


def test_load_image_resize_equals_jax():
    """``load_image(size=...)``: read, convert, then resize, as the JAX
    (Pillow) function does, on an L and an RGB file from 640x480 and
    160x120."""
    for path in ("gallery/free_big_640/best.png", "gallery/circles_bw/best.png"):
        for c_dim in (1, 3):
            ours = image_io.load_image(str(REPO / path), size=(160, 120), c_dim=c_dim)
            ref = jax_io.load_image(str(REPO / path), size=(160, 120), c_dim=c_dim)
            assert ours.dtype == ref.dtype and ours.shape == ref.shape
            np.testing.assert_array_equal(ours, ref)


def test_lanczos_refuses_bad_input():
    with pytest.raises(ValueError, match="uint8"):
        lanczos_resize(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError, match="positive"):
        lanczos_resize(np.zeros((4, 4), np.uint8), (0, 2))


@pytest.mark.parametrize("shape", [(100, 300, 3), (300, 100, 3), (77, 77, 3), (120, 160, 3)],
                         ids=["landscape", "portrait", "square", "exact"])
def test_pad_to_size_equals_jax(shape):
    arr = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    ours = probe.pad_to_size(arr, 160, 120)
    ref = np.asarray(jax_probe.pad_to_size(Image.fromarray(arr), 160, 120))
    assert ours.dtype == np.uint8 and ours.shape == (120, 160, 3)
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="uint8"):
        probe.pad_to_size(arr[..., 0], 160, 120)


# ---------------------------------------------------------------------------
# the probe


def test_get_vectors_and_score_image_match_jax(tmp_path):
    """A small stack, the JAX probe's own test shape (64x48, 4 + 2 steps):
    the same corners and masks after the PNG quantisation, flows within the
    flow stage's float32 tolerance, and the score of both vector sets."""
    png = texture_png(tmp_path / "in.png", 64, 48, seed=3)
    npz = write_npz(tmp_path / "m.npz", SMALL)
    kw = dict(repeat=3, extension=2)
    ours = probe.get_vectors(png, npz, SMALL, 64, 48, device="cpu", flow=FlowConfig(**PROBE_FLOW),
                             **kw)
    ref = jax_probe.get_vectors(png, npz, SMALL, 64, 48, flow=jax_flow.FlowConfig(**PROBE_FLOW),
                                **kw)
    assert ours.shape == ref.shape and len(ours) > 0
    np.testing.assert_array_equal(ours[:, :2], ref[:, :2])
    np.testing.assert_allclose(ours[:, 2:], ref[:, 2:], atol=FLOW_ATOL, rtol=0)
    for structure in (1, 2):
        score = probe.score_image(png, structure, npz, SMALL, 64, 48, device="cpu",
                                  flow=FlowConfig(**PROBE_FLOW), **kw)
        assert score == pytest.approx(jax_fitness(structure, ref, png, 64, 48), abs=FLOW_ATOL)


def test_probe_at_the_bundled_color_predictor_matches_jax():
    """3,48,96,192 on a gallery image at 160x120, 20 + 2 steps: the input
    frame equal, the second extension frame in the mean, and the probe's
    vectors against those the port's flow stage finds on the JAX frames (the
    flow stage itself is held against JAX in tests/test_torch_flow.py), by
    count and swarm score."""
    path = str(REPO / "gallery/circles_color/best.png")
    img = image_io.load_image(path, size=(160, 120))
    params = loader.load_or_init(None, (3, 48, 96, 192), device="cpu")
    with torch.inference_mode():
        f0, f1 = model.rollout_flow_frames(params, torch.from_numpy(img)[None], pair="probe")
    jf0, jf1 = jax_model.rollout_flow_frames(
        jax_loader.load_or_init(None, [3, 48, 96, 192]), jnp.asarray(img)[None], pair="probe")
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    assert np.abs(f1.numpy() - np.asarray(jf1)).mean() <= ROLLOUT_MEAN_TOL

    def vectors(frame0, frame1):
        q0, q1 = (torch.from_numpy(probe._png_quantize(f)) for f in (frame0, frame1))
        vec, mask = flow_vectors(to_gray(q0), to_gray(q1))
        return vec[0][mask[0]].numpy()

    ours = vectors(f0.numpy(), f1.numpy())
    ref = vectors(np.asarray(jf0), np.asarray(jf1))
    assert abs(len(ours) - len(ref)) <= COUNT_RTOL * len(ref) and len(ref) > 24
    assert swarm_score(ours) == pytest.approx(swarm_score(ref), abs=SWARM_ATOL)


def test_png_quantize_equals_jax():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (3, 40, 50, 3)).astype(np.float32)
    x[0, 0, :4, 0] = [1 / 255, 254 / 255, 0.5, 1.0]
    np.testing.assert_array_equal(probe._png_quantize(x), jax_probe._png_quantize(x))


# int8 only: the probe's float32 rollout is not reset to one state a step,
# so a last-bit difference of the gate math (XLA's tanh against torch's) at
# a rounding boundary of the activation quantisation flips an int8 code and
# the recurrence carries it on (tests/test_torch_options.py counts them on
# the evaluator's rollout).  The corners and masks are the same; the flows
# 2.4e-3 px apart at most and the swarm score 2.2e-5 (measured here).
INT8_FLOW_ATOL = 5e-3
INT8_SWARM_ATOL = 1e-4


@pytest.mark.parametrize("flag", ["int8", "s2d"])
def test_get_vectors_runs_the_ported_layouts(flag, tmp_path, capsys):
    """``int8=True`` / ``s2d=True`` (``--int8`` / ``--s2d``) against the JAX
    probe with the same option on the small stack: the same corners and
    masks, the flows within the flow stage's tolerance for s2d (as the
    dense probe) and within INT8_FLOW_ATOL for int8, whose swarm score is
    held too.  ``main`` prints
    the score of the same vectors."""
    png = texture_png(tmp_path / "in.png", 64, 48, seed=3)
    npz = write_npz(tmp_path / "m.npz", SMALL)
    kw = dict(repeat=3, extension=2, **{flag: True})
    ours = probe.get_vectors(png, npz, SMALL, 64, 48, device="cpu", flow=FlowConfig(**PROBE_FLOW),
                             **kw)
    ref = jax_probe.get_vectors(png, npz, SMALL, 64, 48, flow=jax_flow.FlowConfig(**PROBE_FLOW),
                                **kw)
    assert len(ours) > 0 and np.isfinite(ours).all()
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours[:, :2], ref[:, :2])
    np.testing.assert_allclose(ours[:, 2:], ref[:, 2:], rtol=0,
                               atol=FLOW_ATOL if flag == "s2d" else INT8_FLOW_ATOL)
    if flag == "int8":
        assert swarm_score(ours) == pytest.approx(swarm_score(ref), abs=INT8_SWARM_ATOL)
    png160 = texture_png(tmp_path / "in160.png", 160, 120, seed=3)
    assert probe.main(["-i", png160, "-m", npz, "-ch", "3,4,8", f"--{flag}", "--device",
                       "cpu"]) == 0
    vectors = probe.get_vectors(png160, npz, SMALL, device="cpu", **{flag: True})
    assert capsys.readouterr().out.split("\n")[0] == f"score {swarm_score(vectors)}"


def test_probe_main_prints_score_and_fitness(tmp_path, capsys):
    """``python -m ...evolution.probe -i <png> -s 1 --device cpu`` prints
    what the JAX probe prints: ``score`` (the swarm score) and
    ``fitness``, from the same vectors as ``get_vectors``."""
    png = texture_png(tmp_path / "in.png", 160, 120, seed=3)
    npz = write_npz(tmp_path / "m.npz", SMALL)
    assert probe.main(["-i", png, "-s", "1", "-m", npz, "-ch", "3,4,8", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.split("\n")
    vectors = probe.get_vectors(png, npz, SMALL, device="cpu")
    assert len(vectors) > 0
    assert lines[0] == f"score {swarm_score(vectors)}"
    assert lines[1] == f"fitness {jax_fitness(1, vectors, png, 160, 120)}"


def test_probe_main_flags_match_jax(monkeypatch):
    """The JAX probe's flags with their short forms and defaults, plus
    ``--device``."""
    import argparse

    def flags(main_fn):
        seen = {}

        def capture(self, argv=None, namespace=None):
            seen.update({a.dest: (tuple(a.option_strings), a.default) for a in self._actions
                         if a.dest != "help"})
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            main_fn([])
        return seen

    ours, ref = flags(probe.main), flags(jax_probe.main)
    assert ours.pop("device") == (("--device",), "")
    assert ours == ref


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    """The port's quickstart (``python -m ...examples.quickstart out
    --device cpu``): evolve, write the artifacts, probe ``best.png``; one
    generation here."""
    from evolutionary_illusion_generator_tpu_torch.examples import quickstart

    out = tmp_path / "qs"
    assert quickstart.main([str(out), "--generations", "1", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "best fitness after 1 generations:" in printed
    score = float(printed.split("probe re-score of best.png:")[1].split()[0])
    assert np.isfinite(score) and score >= 0.0
    assert {"best.png", "metrics.jsonl", "neat-checkpoint-1"} <= set(p.name for p in out.iterdir())
