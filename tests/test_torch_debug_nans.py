"""The sanitizer mode ``debug_nans`` (``utils/debug_nans.py``, the port's
counterpart of ``jax_debug_nans``): a NaN planted in a weight raises at
the first op it reaches, naming the op (and the kernel wrapper it is
inside); a clean run is the same with and without it; the evaluator, the
driver and the CLI take it."""

import copy
import os

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu_torch import cli
from evolutionary_illusion_generator_tpu_torch.evolution import (
    EvalConfig,
    GenerationEvaluator,
    neat_illusion,
)
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
from evolutionary_illusion_generator_tpu_torch.models.prednet import model as tm
from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig
from evolutionary_illusion_generator_tpu_torch.structure import StructureType
from evolutionary_illusion_generator_tpu_torch.utils import debug_nans

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

TINY_FLOW = dict(max_corners=32, win=9, levels=2, iters=6)
NAN = float("nan")


def _params(channels, seed=1):
    return loader.params_from_numpy(loader.init_params_numpy(channels, seed=seed),
                                    torch.float32, "cpu")


def _rollout(params, channels, **kw):
    img = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (2, 16, 24, channels[0])).astype(np.float32))
    with torch.inference_mode():
        return tm.rollout_flow_frames(params, img, repeat=2, extension=2, **kw)


@pytest.mark.parametrize("channels,layer,key,where", [
    ((3, 8, 16), 0, "lstm_w_e", "aten."),  # layer 0: the split gate convs
    ((3, 8, 16), 2, "ahat_w", "aten."),
    ((1, 32), 1, "lstm_k_e", "inside fused_convlstm_layer_multi"),  # the fused route's plain version
    ((1, 32), 1, "lstm_b", "inside fused_convlstm_layer_multi"),
])
def test_planted_nan_raises_naming_the_op(channels, layer, key, where):
    params = _params(channels)
    _rollout(params, channels)  # clean: nothing raises
    params[layer][key].view(-1)[3] = NAN
    with pytest.raises(FloatingPointError, match="NaN in the output of aten") as err:
        with debug_nans.sanitize():
            _rollout(params, channels)
    assert where in str(err.value)
    out = _rollout(params, channels)  # without the mode the NaN just flows on
    assert torch.isnan(out[1]).any()


def test_planted_nan_in_the_gates_names_the_gate_kernel():
    gates = torch.zeros(1, 2, 3, 12)
    gates[0, 1, 2, 5] = NAN
    with pytest.raises(FloatingPointError, match="inside fused_lstm_gates"):
        with debug_nans.sanitize():
            fused_lstm_gates(gates, torch.zeros(1, 2, 3, 3))


def test_only_nan_raises():
    """-inf (the corner detector's mask value) and inf pass; 0/0 raises;
    outside the mode nothing is checked, and ``check`` does nothing."""
    with debug_nans.sanitize():
        assert debug_nans.active()
        torch.full((3,), -float("inf")) - 1.0
        torch.ones(3) / torch.zeros(3)
        with pytest.raises(FloatingPointError, match="aten.div"):
            torch.zeros(3) / torch.zeros(3)
    assert not debug_nans.active()
    nan = torch.zeros(3) / torch.zeros(3)
    debug_nans.check("a kernel", nan)
    with debug_nans.sanitize(), pytest.raises(FloatingPointError, match="of a kernel"):
        debug_nans.check("a kernel", nan)


def _evaluator(channels=(3, 8, 16), **kw):
    ncfg = preset("circles").replace(pop_size=6, num_hidden=4)
    cfg = EvalConfig(structure=StructureType.Circles, w=64, h=48, repeat=3, extension=2,
                     flow=FlowConfig(**TINY_FLOW), **kw)
    return GenerationEvaluator(cfg, _params(channels), ncfg, device="cpu"), ncfg


@pytest.mark.parametrize("opt", [{}, dict(s2d_l0=True, subpixel_up=True), dict(prednet_int8=True)],
                         ids=["default", "s2d_subpixel", "int8"])
def test_clean_generation_is_the_same_under_the_sanitizer(opt):
    plain, ncfg = _evaluator(**opt)
    checked, _ = _evaluator(debug_nans=True, **opt)
    items = list(Population(ncfg, seed=5).population.items())
    a = plain(copy.deepcopy(items))
    b = checked(copy.deepcopy(items))
    np.testing.assert_array_equal(a, b)
    ref, out = plain.last_results["outputs"].to_numpy(), checked.last_results["outputs"].to_numpy()
    assert ref.keys() == out.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


def test_evaluator_raises_on_a_planted_nan():
    ev, ncfg = _evaluator(debug_nans=True)
    ev.params[1]["lstm_b"][0] = NAN
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        ev(list(Population(ncfg, seed=5).population.items()))


def _nan_model(path):
    layers = loader.init_params_numpy((1, 4, 8), seed=2)
    layers[1]["lstm_w"][0, 0, 0, 0] = np.nan
    np.savez(path, **{f"l{l}/{k}": v for l, layer in enumerate(layers) for k, v in layer.items()})
    return str(path)


def test_driver_and_cli_pass_debug_nans(tmp_path):
    """``neat_illusion(debug_nans=True)`` and ``--debug_nans`` run the
    generation under the sanitizer: a predictor with a NaN weight raises,
    and runs to its end without it (NaN frames give no corners to track)."""
    model = _nan_model(tmp_path / "nan.npz")
    cfg = preset("circles_bw").replace(pop_size=4, num_hidden=4, min_species_size=4, elitism=2)
    kw = dict(w=48, h=40, channels=(1, 4, 8), c_dim=1, gradient=0, generations=1,
              flow=FlowConfig(**TINY_FLOW), quiet=True, save_artifacts=False, device="cpu")
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        neat_illusion(str(tmp_path / "a"), model, cfg, StructureType.Circles, debug_nans=True,
                      **kw)
    pop = neat_illusion(str(tmp_path / "b"), model, cfg, StructureType.Circles, **kw)
    assert pop.generation == 1
    argv = ["-o", str(tmp_path / "c"), "-s", "1", "-c", "1", "-ch", "1,4,8", "--generations",
            "1", "-m", model, "--device", "cpu"]
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        cli.main(argv + ["--debug_nans"])
    assert not os.path.exists(tmp_path / "c" / "metrics.jsonl")
