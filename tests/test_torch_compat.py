"""The port's reference call-contract shims (``compat.py``) and the flow
file interface against the JAX package's, and the port's probe against its
own file bus.

The predictor's weights are seeded numpy arrays in one NPZ file that both
packages read; images are made from a numpy seed.
"""

import os
from random import Random

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu import compat as jax_compat
from evolutionary_illusion_generator_tpu.neat import Genome as JaxGenome
from evolutionary_illusion_generator_tpu.neat import preset as jax_preset
from evolutionary_illusion_generator_tpu.ops.flow import FlowConfig as JaxFlowConfig
from evolutionary_illusion_generator_tpu_torch import compat
from evolutionary_illusion_generator_tpu_torch.evolution import probe
from evolutionary_illusion_generator_tpu_torch.neat import Genome, preset
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig, lucas_kanade
from evolutionary_illusion_generator_tpu_torch.utils.image_io import (
    draw_flow_overlay,
    load_image,
    save_image,
)
from evolutionary_illusion_generator_tpu_torch.utils.png import read_png
from test_torch_probe import PROBE_FLOW, SMALL, texture_png, write_npz

# pytest must not collect the shims as tests
compat.test_prednet.__test__ = False
jax_compat.test_prednet.__test__ = False

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

# Predictions written to uint8: last-bit float32 differences between the
# two packages cross a truncation boundary now and then (one pixel of 1,152
# off by one measured); as the render tests hold uint8 images.
PNG_SHARE = 0.01
# Identical corners and masks; flows within the flow stage's float32
# tolerance (tests/test_torch_flow.py)
FLOW_ATOL = 1e-3
# create_cppn: float32 node values through another framework's sigmoid,
# tanh, sin and exp (1.5e-6 measured)
CPPN_ATOL = 1e-5


def _run_both(tmp_path, seq, size, **kw):
    """test_prednet of both packages with the same NPZ model; returns the
    two output directories."""
    npz = write_npz(tmp_path / "m.npz", SMALL)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    compat.test_prednet(npz, [seq], size, SMALL, output_dir=ours, device="cpu", **kw)
    jax_compat.test_prednet(npz, [seq], size, SMALL, output_dir=ref, **kw)
    return ours, ref


@pytest.mark.parametrize("skip", [1, 2])
def test_test_prednet_matches_jax_file_by_file(tmp_path, skip):
    """Two candidates of the reference's population call (5 inputs and 2
    extension steps each): the same file names, and each PNG equal within
    the uint8 truncation tolerance."""
    w, h, repeat = 32, 24, 5
    pngs = []
    for i in range(2):
        pngs.append(str(tmp_path / f"cand{i}.png"))
        texture_png(pngs[-1], w, h, seed=10 * skip + i)
    seq = [pngs[0]] * repeat + [pngs[1]] * repeat
    ours, ref = _run_both(tmp_path, seq, [w, h], skip_save_frames=skip, extension_start=repeat,
                          extension_duration=2, reset_at=repeat + 2)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(ref))
    n_pred = 2 * -(-repeat // skip)
    assert [n for n in names if not n.endswith("_extended.png")] == [
        f"{i:010d}.png" for i in range(n_pred)]
    assert [n for n in names if n.endswith("_extended.png")] == [
        f"{i:010d}_extended.png" for i in (5, 6, 10, 11)]
    for name in names:
        a, mode = read_png(os.path.join(ours, name))
        b, ref_mode = read_png(os.path.join(ref, name))
        assert mode == ref_mode == "RGB" and a.shape == b.shape == (h, w, 3)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= PNG_SHARE, name


def test_test_prednet_refuses_what_the_reference_does_not_do(tmp_path):
    png = texture_png(tmp_path / "in.png", 16, 16, seed=0)
    kw = dict(output_dir=str(tmp_path / "out"), device="cpu")
    with pytest.raises(NotImplementedError, match="reset_at"):
        compat.test_prednet("", [[png] * 4], [16, 16], SMALL, extension_start=4, reset_at=3, **kw)
    with pytest.raises(ValueError, match="divisible"):
        compat.test_prednet("", [[png] * 5], [16, 16], SMALL, extension_start=4, **kw)
    assert not os.path.exists(kw["output_dir"])


def test_lucas_kanade_matches_jax(tmp_path):
    """The same PNG pair through both file interfaces: the same corners and
    masks, flows within float32 tolerance; the overlay is the port's
    rasterizer on the returned vectors."""
    p0 = texture_png(tmp_path / "a.png", 64, 48, seed=4)
    img = load_image(p0)
    p1 = str(tmp_path / "b.png")
    save_image(np.roll(img, 1, axis=1) * 0.98 + 0.01, p1)  # one pixel right, dimmed
    overlay = str(tmp_path / "flow.png")
    ours = lucas_kanade(p0, p1, str(tmp_path), save=True, save_name=overlay,
                        cfg=FlowConfig(**PROBE_FLOW), device="cpu")
    ref = jax_compat.lucas_kanade(p0, p1, str(tmp_path), cfg=JaxFlowConfig(**PROBE_FLOW))
    ov, rv = np.asarray(ours["vectors"]), np.asarray(ref["vectors"])
    assert set(ours) == {"vectors"} and ov.shape == rv.shape and len(ov) > 0
    np.testing.assert_array_equal(ov[:, :2], rv[:, :2])
    np.testing.assert_allclose(ov[:, 2:], rv[:, 2:], atol=FLOW_ATOL, rtol=0)
    np.testing.assert_array_equal(read_png(overlay)[0], draw_flow_overlay(img, ov))
    assert compat.lucas_kanade is lucas_kanade


def test_probe_matches_its_own_file_bus_exactly(tmp_path):
    """The port's probe (input image against the second extension frame)
    equals ``test_prednet`` writing PNGs and ``lucas_kanade`` reading them,
    vector for vector: the probe's PNG quantisation closes the 8-bit gap
    between the two buses (the JAX package's tests/test_compat.py
    identity)."""
    w, h, repeat, ext = 64, 48, 3, 2
    png = texture_png(tmp_path / "in.png", w, h, seed=3)
    npz = write_npz(tmp_path / "m.npz", SMALL)
    out = str(tmp_path / "pred")
    compat.test_prednet(npz, [[png] * repeat], [w, h], SMALL, output_dir=out,
                        extension_start=repeat, extension_duration=ext, device="cpu")
    res = lucas_kanade(png, os.path.join(out, f"{repeat + 1:010d}_extended.png"),
                       cfg=FlowConfig(**PROBE_FLOW), device="cpu")
    file_vectors = np.asarray(res["vectors"], np.float32).reshape(-1, 4)
    probe_vectors = probe.get_vectors(png, npz, SMALL, w, h, repeat=repeat, extension=ext,
                                      flow=FlowConfig(**PROBE_FLOW), device="cpu")
    assert probe_vectors.shape == file_vectors.shape and len(probe_vectors) > 0
    np.testing.assert_array_equal(probe_vectors, file_vectors)


@pytest.mark.parametrize("preset_name,mutations", [("circles", 5), ("circles_bw", 0),
                                                    ("bands", 12)])
def test_create_cppn_matches_jax(preset_name, mutations):
    """One callable per output, each equal to the JAX shim's node values on
    the same genome (built from the same seed by both NEAT copies)."""
    genomes = []
    for pkg_preset, pkg_genome in ((preset, Genome), (jax_preset, JaxGenome)):
        cfg = pkg_preset(preset_name)
        g = pkg_genome.new(1, cfg, Random(3))
        rng = Random(4)
        for _ in range(mutations):
            g.mutate(cfg, rng)
        genomes.append((g, cfg))
    (g, cfg), (jg, jcfg) = genomes
    x = np.linspace(-1, 1, 12).reshape(3, 4)
    y = np.linspace(1, -1, 12).reshape(3, 4)
    nodes = compat.create_cppn(g, cfg, leaf_names=["x", "y"], out_names=[], device="cpu")
    ref = jax_compat.create_cppn(jg, jcfg, leaf_names=["x", "y"], out_names=[])
    assert len(nodes) == len(ref) == cfg.num_outputs
    for node, ref_node in zip(nodes, ref):
        out = node(x=x, y=y)
        assert out.shape == (3, 4) and out.dtype == np.float32
        np.testing.assert_allclose(out, np.asarray(ref_node(x=x, y=y)), atol=CPPN_ATOL, rtol=0)
    with pytest.raises(ValueError, match="leaves"):
        compat.create_cppn(g, cfg, leaf_names=["x"], device="cpu")
