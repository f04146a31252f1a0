"""The port's command-line interface against the JAX package's, and one
run of it end to end on the CPU."""

import json
import os

import pytest
import torch

from evolutionary_illusion_generator_tpu import cli as jax_cli
from evolutionary_illusion_generator_tpu_torch import cli

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)


def _flags(parser):
    """dest -> (option strings, default, choices, action) of every argument
    but --help."""
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """Every dest, short and long flag, default, choice and action of the
    JAX CLI; ``--device`` is the only addition."""
    ours, ref = _flags(cli.build_parser()), _flags(jax_cli.build_parser())
    assert ours.pop("device") == (("--device",), "", None, "_StoreAction")
    assert ours == ref


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.main(["-o", str(out), "-s", "1", "-ch", "3,8,16", "--generations", "2",
                     "--use_pallas", "--device", "cpu"]) == 0
    assert "<auto-selected preset>" in capsys.readouterr().out
    for name in ("best.png", "best_flow.png", "best_black_bg.png", "enhanced.png",
                 "neat-checkpoint-2"):
        assert (out / name).exists(), name
    with open(out / "metrics.jsonl") as f:
        assert [json.loads(line)["generation"] for line in f] == [0, 1]


@pytest.mark.parametrize("argv,exc,match", [
    # the 8-device preset on the CPU's one device: make_mesh's error
    pytest.param(["--preset", "pop256_v5e8"], ValueError, "need 8 devices, have 1",
                 id="argv0-Parallel"),
])
def test_cli_refuses_what_is_not_ported(argv, exc, match, tmp_path):
    with pytest.raises(exc, match=match):
        cli.main(["-o", str(tmp_path), "--device", "cpu", *argv])
    assert not os.listdir(tmp_path)  # refused before anything ran


@pytest.mark.parametrize("argv,kwargs", [
    (["--score_on_device"], dict(score_on_device=True)),
    (["--chainer_half_order", "a-ahat"], dict(chainer_half_order="a-ahat")),
    (["--chainer_half_order", "auto"], dict(chainer_half_order="auto")),
    (["--debug_nans"], dict(debug_nans=True)),
    (["--use_pallas"], dict(use_pallas=True)),
    ([], dict(use_pallas="fused")),  # the port's default route: its kernels
])
def test_cli_passes_the_ported_flags(argv, kwargs, monkeypatch):
    """The flags the port now implements reach ``neat_illusion`` as the
    JAX CLI passes them (each runs on the CPU in tests/test_torch_scoring.py,
    tests/test_torch_chainer_loader.py and tests/test_torch_debug_nans.py)."""
    seen = {}
    monkeypatch.setattr(cli, "neat_illusion", lambda *a, **kw: seen.update(kw))
    assert cli.main(["--device", "cpu", *argv]) == 0
    assert {k: seen[k] for k in kwargs} == kwargs


def test_string_to_intarray_matches_jax():
    assert cli.string_to_intarray("3,48,96,192") == jax_cli.string_to_intarray("3,48,96,192")
