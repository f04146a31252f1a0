"""The program cache (``utils/program_cache.py``: the chunk pass captured
as a CUDA graph per program key) where it can run here, on the CPU: it
has no effect there, its key changes with each of its parts, it drops the
graphs of keys that can no longer occur, and the environment knob and
``debug_nans`` turn it off.  Its capture and replay on the card are held
in tests/test_torch_cuda.py."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu_torch.evolution import EvalConfig, GenerationEvaluator
from evolutionary_illusion_generator_tpu_torch.evolution.evaluator import wants_program_cache
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig
from evolutionary_illusion_generator_tpu_torch.structure import StructureType
from evolutionary_illusion_generator_tpu_torch.utils import program_cache
from evolutionary_illusion_generator_tpu_torch.utils.program_cache import ProgramCache

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

TINY_FLOW = dict(max_corners=32, win=9, levels=2, iters=6)


def _evaluator(**kw):
    ncfg = preset("circles").replace(pop_size=6, num_hidden=4)
    params = loader.params_from_numpy(loader.init_params_numpy((3, 8, 16), seed=1),
                                      torch.float32, "cpu")
    cfg = EvalConfig(structure=StructureType.Circles, w=64, h=48, repeat=3, extension=2,
                     flow=FlowConfig(**TINY_FLOW), **kw)
    return GenerationEvaluator(cfg, params, ncfg, device="cpu"), ncfg


def test_no_effect_on_the_cpu():
    """On the CPU the pass runs eagerly with the cache on: bit-equal to the
    run with it off, over two generations, with no graph kept."""
    on, ncfg = _evaluator()
    off, _ = _evaluator(program_cache=False)
    assert EvalConfig().program_cache is True and not on._programs.enabled
    items = list(Population(ncfg, seed=5).population.items())
    for _ in range(2):
        np.testing.assert_array_equal(on(copy.deepcopy(items)), off(copy.deepcopy(items)))
        a, b = on.last_results["outputs"].to_numpy(), off.last_results["outputs"].to_numpy()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert on._programs.graphs == {}


def test_the_key_changes_with_each_part():
    """Pop bucket, level bucket, width bucket and activation set: changing
    any one gives another key."""
    ev, _ = _evaluator()
    base = ev.program_key(8)
    keys = {base, ev.program_key(16)}
    ev._levels *= 2
    keys.add(ev.program_key(8))
    ev._levels //= 2
    ev._width *= 2
    keys.add(ev.program_key(8))
    ev._width //= 2
    ev._act_set = (0, 3)
    keys.add(ev.program_key(8))
    ev._act_set = ()
    assert ev.program_key(8) == base
    assert len(keys) == 5


def test_keys_that_cannot_occur_are_dropped():
    """The first call of a key runs eagerly and marks it warm; a key that
    ``live`` rejects (a smaller bucket) is dropped on the next call."""
    calls = []
    cache = ProgramCache(lambda x: calls.append(x) or {"y": x["x"] + 1}, enabled=True)
    out = cache.run("a", lambda k: True, {"x": torch.ones(2)})
    assert torch.equal(out["y"], torch.full((2,), 2.0)) and list(cache.graphs) == ["a"]
    cache.run("b", lambda k: k != "a", {"x": torch.ones(2)})
    assert list(cache.graphs) == ["b"] and len(calls) == 2
    assert cache.replays == 0
    off = ProgramCache(lambda x: calls.append(x) or x, enabled=False)
    for _ in range(3):
        off.run("a", lambda k: True, {"x": torch.ones(2)})
    assert off.graphs == {} and len(calls) == 5


@pytest.mark.parametrize("cfg,env,want", [
    (dict(), None, True),
    (dict(program_cache=False), None, False),
    (dict(debug_nans=True), None, False),
    (dict(), "0", False),
    (dict(), "1", True),
])
def test_the_cache_switch(cfg, env, want, monkeypatch):
    """``program_cache``, ``debug_nans`` and ``EIGEN_PROGRAM_CACHE=0`` (the
    JAX knob's name) decide whether the card would capture."""
    if env is None:
        monkeypatch.delenv("EIGEN_PROGRAM_CACHE", raising=False)
    else:
        monkeypatch.setenv("EIGEN_PROGRAM_CACHE", env)
    assert wants_program_cache(dataclasses.replace(EvalConfig(), **cfg)) is want
    assert program_cache.program_cache_enabled() is (env != "0")


def test_counted_wrappers_cover_every_kernel():
    """Every wrapper with a launch counter also counts the kernels a
    capture records, and is one the graph looks at."""
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_bisect, convlstm_fused
    from evolutionary_illusion_generator_tpu_torch.ops import convlstm_gates

    wrappers = program_cache.counted_wrappers()
    assert all(hasattr(w, "launches") and hasattr(w, "captured") for w in wrappers)
    for module in (convlstm_gates, convlstm_fused, convlstm_bisect):
        counted = [v for v in vars(module).values() if hasattr(v, "launches")]
        assert counted and all(any(v is w for w in wrappers) for v in counted)
