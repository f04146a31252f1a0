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


@pytest.mark.parametrize("argv,match", [
    (["--score_on_device"], "Device scoring"),
    (["--debug_nans"], "debug_nans"),
    (["--chainer_half_order", "a-ahat"], "compat shims"),
    (["--chainer_half_order", "auto"], "compat shims"),
    (["--preset", "pop256_v5e8"], "Parallel"),
])
def test_cli_refuses_what_is_not_ported(argv, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["-o", str(tmp_path), "--device", "cpu", *argv])
    assert not os.listdir(tmp_path)  # refused before anything ran


def test_string_to_intarray_matches_jax():
    assert cli.string_to_intarray("3,48,96,192") == jax_cli.string_to_intarray("3,48,96,192")
