"""Rules of the PyTorch port: it imports no JAX, nothing of the JAX
package, no Pillow and no OpenCV, and its entry points never fall back to
the CPU on their own."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu_torch import cli, compat
from evolutionary_illusion_generator_tpu_torch.evolution import (
    EvalConfig,
    GenerationEvaluator,
    neat_illusion,
    probe,
)
from evolutionary_illusion_generator_tpu_torch.examples import multichip, quickstart
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader, pretrain
from evolutionary_illusion_generator_tpu_torch.neat import preset
from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import kernel_stream
from evolutionary_illusion_generator_tpu_torch.parallel import make_mesh, make_mesh_2d
from evolutionary_illusion_generator_tpu_torch.parallel.pipeline import make_pp_mesh
from evolutionary_illusion_generator_tpu_torch.scripts import phase_bench, rollout_profile
from evolutionary_illusion_generator_tpu_torch.structure import StructureType
from evolutionary_illusion_generator_tpu_torch.utils.image_io import save_image

# pytest must not collect the shim as a test
compat.test_prednet.__test__ = False

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "evolutionary_illusion_generator_tpu_torch"
JAX_PKG = REPO / "evolutionary_illusion_generator_tpu"

#: JAX modules whose port has another file name.
RENAMED = {
    "ops/convlstm_pallas.py": "ops/convlstm_gates.py",
    "ops/convlstm_fused_pallas.py": "ops/convlstm_fused.py",
    "ops/fitness/metrics_jax.py": "ops/fitness/metrics_torch.py",
}
#: Public names of the JAX package the port leaves out on purpose, each
#: with the (file, name) of what stands in its place in the port.
DELIBERATE_GAPS = {
    ("ops/convlstm_fused_pallas.py", "pick_rows"): ("ops/convlstm_fused.py", "plan"),
    ("ops/fitness/metrics_jax.py", "score_vectors_jax"):
        ("ops/fitness/metrics_torch.py", "score_vectors_torch"),
    # the compiled-program cache: the evaluator's CUDA graphs
    ("utils/program_cache.py", "cached_program"): ("utils/program_cache.py", "ProgramCache"),
    ("utils/program_cache.py", "program_cache_dir"): ("utils/program_cache.py", "ProgramCache"),
    # XLA's compilation cache: the kernels' build directory (.build/)
    ("utils/compilation_cache.py", "enable_compilation_cache"): ("_build.py", "library"),
}

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
    png = str(tmp_path / "in.png")
    save_image(np.zeros((8, 8, 3), np.uint8), png)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main(["-i", png, "-s", "1", "-ch", "3,4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compat.test_prednet("", [[png] * 2], [8, 8], (3, 4), output_dir=str(tmp_path / "p"),
                            extension_start=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compat.lucas_kanade(png, png)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([str(tmp_path / "qs")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain.main(["--channels", "1,4,8", "--steps", "1", "--out", str(tmp_path / "w.npz")])
    tiny = ["--pop", "2", "--width", "32", "--height", "24", "--channels", "3,4,8"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        phase_bench.main(tiny)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rollout_profile.main(tiny)
    assert not (tmp_path / "p").exists() and not (tmp_path / "qs").exists()
    assert not (tmp_path / "w.npz").exists()
    params = loader.load_or_init(None, (1, 4, 8), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEvaluator(EvalConfig(c_dim=1), params, cfg)
    # asked for, the CPU works
    GenerationEvaluator(EvalConfig(c_dim=1), params, cfg, device="cpu")


#: the ports of the repo-root analysis and gallery scripts (``scripts/``)
ANALYSIS_SCRIPTS = ("compare_probes", "period_response", "drift_diag", "probe_rated",
                    "probe_breakdown", "field_anatomy", "cache_probe_vectors", "make_gallery",
                    "speciation_analysis")
#: those that touch the device, with arguments that would run them
DEVICE_SCRIPTS = {
    "period_response": ["--channels", "1,4,8"],
    "drift_diag": ["--channels", "1,4,8"],
    "probe_rated": [],
    "probe_breakdown": [],
    "field_anatomy": [],
    "cache_probe_vectors": ["--out", "{tmp}/c.npz", "--floors", "{tmp}/f.json"],
    "make_gallery": ["circles_bw"],
}


def test_analysis_scripts_are_ported_without_jax_or_pillow():
    """Each repo-root script has its module in the port's ``scripts/``;
    the import-all test above imports each with jax, Pillow and the JAX
    package blocked, and none names them in its source."""
    for name in ANALYSIS_SCRIPTS:
        assert (REPO / "scripts" / f"{name}.py").exists(), name
        tree = ast.parse((PORT / "scripts" / f"{name}.py").read_text())
        imported = {a.name.split(".")[0] for node in ast.walk(tree)
                    if isinstance(node, ast.Import) for a in node.names}
        imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                     if isinstance(node, ast.ImportFrom) and node.module and not node.level}
        assert not imported & {"jax", "PIL", "cv2", "evolutionary_illusion_generator_tpu"}, name


@pytest.mark.parametrize("name", sorted(DEVICE_SCRIPTS))
def test_analysis_scripts_raise_without_a_card(name, no_card, tmp_path, monkeypatch):
    """Without ``--device cpu`` they need the card, and raise before they
    read or write anything."""
    import importlib

    mod = importlib.import_module(f"evolutionary_illusion_generator_tpu_torch.scripts.{name}")
    monkeypatch.setattr(mod, "RATED_DIR", str(tmp_path / "missing"), raising=False)
    monkeypatch.setattr(mod, "GALLERY", str(tmp_path / "gallery"), raising=False)
    argv = [a.format(tmp=tmp_path) for a in DEVICE_SCRIPTS[name]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
    assert list(tmp_path.iterdir()) == []


def test_parallel_entry_points_raise_without_a_card(no_card, tmp_path):
    """A mesh takes every CUDA device unless it is given devices: without a
    card it raises as the other entry points do, and never becomes a CPU
    mesh on its own."""
    for make in (make_mesh, lambda: make_mesh_2d(1, 1), lambda: make_pp_mesh(1),
                 lambda: make_mesh(devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        neat_illusion(str(tmp_path), None, preset("circles"), StructureType.Circles,
                      channels=(3, 4), generations=1, n_devices=2, save_artifacts=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multichip.main(["--tiny", "--output_dir", str(tmp_path / "mc")])
    assert not (tmp_path / "mc").exists()
    # asked for, a CPU mesh works
    assert make_mesh(devices=["cpu"] * 2).size == 2


def test_kernel_stream_refuses_tensors_off_the_current_device(monkeypatch):
    """A launch goes to the current CUDA device whatever its tensors'
    device; the wrappers' stream lookup refuses tensors elsewhere (mocked
    here: no card; tests/test_torch_cuda.py shows it through a wrapper)."""
    import inspect

    from evolutionary_illusion_generator_tpu_torch.ops import (
        convlstm_fused,
        convlstm_narrow,
        prednet_units,
    )
    from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 1234})())
    with pytest.raises(RuntimeError, match="current CUDA device is cuda:0"):
        kernel_stream("fused_lstm_gates", torch.device("cuda", 1))
    assert kernel_stream("fused_lstm_gates", torch.device("cuda", 0)) == 1234
    # every wrapper of the main path takes its stream from kernel_stream,
    # under its own name
    for wrapper, where in ((fused_lstm_gates, fused_lstm_gates),
                           (convlstm_narrow.narrow_convlstm_layer,
                            convlstm_narrow.narrow_convlstm_layer),
                           (convlstm_fused.fused_convlstm_layer_multi, convlstm_fused._run),
                           (prednet_units.ahat_error_unit, prednet_units.ahat_error_unit),
                           (prednet_units.a_unit, prednet_units.a_unit)):
        name = wrapper.__name__
        assert "kernel_stream(" in inspect.getsource(where), name
        with pytest.raises(RuntimeError, match=f"{name}: tensors on cuda:1"):
            kernel_stream(name, torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert kernel_stream("fused_lstm_gates", torch.device("cuda", 1)) == 1234


def test_cuda_tensors_without_a_card_are_not_run_on_the_cpu(no_card):
    """The wrappers decide by the tensor's device; only a CPU tensor takes
    the plain version (a meta tensor stands in for a foreign device)."""
    from evolutionary_illusion_generator_tpu_torch.ops.convlstm_gates import fused_lstm_gates

    with pytest.raises(ValueError, match="unsupported device"):
        fused_lstm_gates(torch.zeros(1, 2, 2, 8, device="meta"),
                         torch.zeros(1, 2, 2, 2, device="meta"))
    h, c = fused_lstm_gates(torch.zeros(1, 2, 2, 8), torch.zeros(1, 2, 2, 2))
    np.testing.assert_allclose(c.numpy(), 0.0)


def _public_names(path: Path) -> set:
    """``__all__`` where the module has one, else the public functions,
    classes and assignments it defines itself (not the names it imports)."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _defines(path: Path, name: str) -> bool:
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name == name:
                return True
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == name for t in node.targets):
                return True
    return False


def test_port_exports_every_public_name_of_the_jax_package():
    """Each JAX module's public names (parsed, not imported: no jax needed)
    are in its port's, but for the written deliberate gaps; each gap's
    counterpart exists in the port, and no gap is listed that the port
    now provides."""
    missing, provided = [], []
    for jax_file in sorted(JAX_PKG.rglob("*.py")):
        rel = jax_file.relative_to(JAX_PKG).as_posix()
        port_file = PORT / RENAMED.get(rel, rel)
        ours = _public_names(port_file) if port_file.exists() else set()
        for name in sorted(_public_names(jax_file)):
            gap = DELIBERATE_GAPS.get((rel, name))
            if name not in ours and gap is None:
                missing.append(f"{rel}::{name}")
            elif name in ours and gap is not None:
                provided.append(f"{rel}::{name}")
    assert not missing, f"the port lacks {missing}"
    assert not provided, f"listed as gaps but ported: {provided}"
    for (rel, name), (port_rel, port_name) in DELIBERATE_GAPS.items():
        assert name in _public_names(JAX_PKG / rel), (rel, name)
        assert _defines(PORT / port_rel, port_name), (port_rel, port_name)


def test_analysis_re_exports_load_ratings_on_first_use():
    """``analysis`` exports the JAX package's seven names but imports
    ``ratings`` (pandas, scipy) only when one of them is first read."""
    pytest.importorskip("pandas")
    pytest.importorskip("scipy")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import evolutionary_illusion_generator_tpu_torch.analysis as a\n"
        "mod = 'evolutionary_illusion_generator_tpu_torch.analysis.ratings'\n"
        "assert mod not in sys.modules and 'pandas' not in sys.modules\n"
        "assert set(a.__all__) <= set(dir(a))\n"
        "f = a.summarize\n"
        "assert mod in sys.modules and f is sys.modules[mod].summarize\n"
        "assert [getattr(a, n) is getattr(sys.modules[mod], n) for n in a.__all__].count(True) == 7\n"
        "try:\n"
        "    a.not_a_name\n"
        "except AttributeError:\n"
        "    print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO))
    assert proc.returncode == 0 and proc.stdout.split() == ["ok"], proc.stderr
