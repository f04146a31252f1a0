"""The port's ``probe_rated`` with ``--int8``, ``--s2d`` and ``--lk_bf16``
against the JAX package's script with the same option, on the stand-in
rated directory of ``tests/test_torch_rated_scripts.py`` (its fixtures and
rules; a file of its own so that its JAX programs compile in another test
worker)."""

import os

import pytest
import torch

from evolutionary_illusion_generator_tpu.ops.flow import api as jax_flow
from evolutionary_illusion_generator_tpu_torch.evolution.probe import get_vectors
from evolutionary_illusion_generator_tpu_torch.scripts import probe_rated
from evolutionary_illusion_generator_tpu_torch.utils.png import read_png
from test_torch_probe import COUNT_RTOL, SWARM_ATOL
from test_torch_rated_scripts import (  # noqa: F401  (fixtures)
    BW,
    COLOR,
    LK_BF16_FLOW_ATOL,
    RATED_FLOW_ATOL,
    _held_like_the_probe,
    _port_on_jax_vectors,
    jax_vectors,
    rated,
    stand_in_modules,
)

torch.set_num_threads(1)


# each option on the stack it is run on here (a JAX program each):
# ``--int8`` and ``--lk_bf16`` the grayscale stack, ``--s2d`` the colour one
OPTIONS = {"int8": "bw", "s2d": "color", "lk_bf16": "bw"}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_probe_rated_options_equal_jax(option, rated, stand_in_modules, monkeypatch, capsys):
    """``--int8``, ``--s2d`` and ``--lk_bf16`` go through to the probe (and
    its flow stage) as the JAX script's do: on the JAX probe's vectors of
    each option the same table, on the port's own the probe's rules."""
    (jax_mod, port), jax_vectors = stand_in_modules["probe_rated"]
    args = ["--model_bw", rated["bw"], "--model_color", rated["color"], f"--{option}",
            "--only", OPTIONS[option]]
    jax_mod.main(args)
    ref = capsys.readouterr().out
    own = port.main(args + ["--device", "cpu"])
    capsys.readouterr()
    with monkeypatch.context() as m:
        _port_on_jax_vectors(m, port, jax_vectors)
        ref_doc = port.main(args + ["--device", "cpu"])
    assert capsys.readouterr().out == ref
    assert list(own["results"]) == list(ref_doc["results"])
    kw = {"int8": option == "int8", "s2d": option == "s2d"}
    lk = "bfloat16" if option == "lk_bf16" else "float32"
    for name, rel, _, _ in probe_rated.IMAGES:
        if name not in own["results"]:
            continue
        path = os.path.join(rated["dir"], rel)
        channels, model = ((BW, rated["bw"]) if read_png(path)[1] == "L"
                           else (COLOR, rated["color"]))
        ours = get_vectors(path, model, channels, device="cpu", flow=port.FlowConfig(lk_dtype=lk),
                           **kw)
        _held_like_the_probe(ours, jax_vectors(path, model, channels,
                                               flow=jax_flow.FlowConfig(lk_dtype=lk), **kw),
                             LK_BF16_FLOW_ATOL if option == "lk_bf16" else RATED_FLOW_ATOL)
        got, want = own["results"][name], ref_doc["results"][name]
        assert abs(got["n_vectors"] - want["n_vectors"]) <= COUNT_RTOL * want["n_vectors"]
        assert got["ours"] == pytest.approx(want["ours"], abs=SWARM_ATOL)
