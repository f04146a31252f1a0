"""Rules of the PyTorch port: it imports no JAX, nothing of the JAX
package, no Pillow and no OpenCV, and its entry points never fall back to
the CPU on their own."""

import subprocess
import sys
from pathlib import Path

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
from evolutionary_illusion_generator_tpu_torch.neat import preset
from evolutionary_illusion_generator_tpu_torch.structure import StructureType

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "evolutionary_illusion_generator_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
# any `import jax`, `import PIL` or `import cv2` now raises ImportError: the
# card's machine has none of them
for blocked in ("jax", "PIL", "cv2"):
    sys.modules[blocked] = None
sys.path.insert(0, {repo!r})
import evolutionary_illusion_generator_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "evolutionary_illusion_generator_tpu"
                or m.startswith("evolutionary_illusion_generator_tpu."))
assert not leaked, leaked
assert all(sys.modules[m] is None for m in ("jax", "PIL", "cv2"))
print(len(names))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """... and no Pillow or OpenCV either."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr
    # every module and subpackage of the port was imported
    n_files = len([p for p in PORT.rglob("*.py") if p != PORT / "__init__.py"])
    assert int(proc.stdout.split()[-1]) == n_files


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    cfg = preset("circles")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        neat_illusion(str(tmp_path), None, cfg, StructureType.Circles, channels=(3, 4),
                      generations=1, save_artifacts=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-o", str(tmp_path / "cli"), "-s", "1", "-ch", "3,4", "--generations", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader.load_or_init(None, (1, 4, 8))
    params = loader.load_or_init(None, (1, 4, 8), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEvaluator(EvalConfig(c_dim=1), params, cfg)
    # asked for, the CPU works
    GenerationEvaluator(EvalConfig(c_dim=1), params, cfg, device="cpu")


def test_cuda_tensors_without_a_card_are_not_run_on_the_cpu(no_card):
    """The wrappers decide by the tensor's device; only a CPU tensor takes
    the plain version (a meta tensor stands in for a foreign device)."""
    from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates

    with pytest.raises(ValueError, match="unsupported device"):
        fused_lstm_gates(torch.zeros(1, 2, 2, 8, device="meta"),
                         torch.zeros(1, 2, 2, 2, device="meta"))
    h, c = fused_lstm_gates(torch.zeros(1, 2, 2, 8), torch.zeros(1, 2, 2, 2))
    np.testing.assert_allclose(c.numpy(), 0.0)
