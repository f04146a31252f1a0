"""The port's rated-probe tools (``probe_rated``, ``probe_breakdown``,
``field_anatomy``, ``cache_probe_vectors``) against the JAX package's
``scripts/`` of the same name, on the CPU.

The rated stimuli are not in the repository, so both packages read the same
stand-ins: a directory in the reference's layout made from the committed
``gallery/*/best.png`` (mode L and RGB, one 640x480 for the resize) and a
uniform grey control, which finds no corner and so scores exactly 0.0, as
the reference's control must.  Both modules' ``RATED_DIR``, ``BW`` and
``COLOR`` point at the stand-ins and at narrow stacks (``1,4,8``,
``3,4,8``) whose seeded weights go in through ``--model_bw`` /
``--model_color``.

Each tool is held in two parts.  Its arithmetic: given the JAX probe's own
vectors, the port's script prints what the JAX script prints, byte for
byte (and writes the same JSON / cache).  Its pipeline: on its own vectors
(the port's probe), counts and scores within the probe's rules of
``tests/test_torch_probe.py``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu.evolution import probe as jax_probe
from evolutionary_illusion_generator_tpu.models.prednet import loader as jax_loader
from evolutionary_illusion_generator_tpu.ops.flow import api as jax_flow
from evolutionary_illusion_generator_tpu_torch.evolution.probe import get_vectors
from evolutionary_illusion_generator_tpu_torch.models.prednet import loader
from evolutionary_illusion_generator_tpu_torch.scripts import (
    cache_probe_vectors,
    compare_probes,
    field_anatomy,
    probe_breakdown,
    probe_rated,
)
from evolutionary_illusion_generator_tpu_torch.utils.png import convert, read_png, write_png
from test_torch_probe import COUNT_RTOL, REPO, SWARM_ATOL, write_npz
from test_torch_scripts import _jax_script

torch.set_num_threads(1)

#: where the JAX scripts look for the stimuli (``drift_diag.py`` names it
#: inside its main)
REFERENCE_DIR = _jax_script("probe_rated").RATED_DIR
#: stand-in file -> (gallery run whose best.png it is, mode)
STAND_INS = {
    "rotate_01/small.png": ("circles_bw", "L"),
    "rotate_02/small.png": ("circles_bw_deep", "L"),
    "expand_01/small.png": ("circles_color", "L"),
    "expand_02/small.png": ("free_color", "L"),
    "color_01_expand/small.png": ("circles_color", "RGB"),
    "color_02_expand/small.png": ("circles_free", "RGB"),
    "manyfish/manyfish-small.png": ("free_big_640", "RGB"),
}
BW, COLOR = (1, 4, 8), (3, 4, 8)
# the seeded stacks' flows: 22 float32 steps of the port's plain layers
# against XLA's convs, whose predictions LK tracks badly (flows of up to
# 30 px); the corners are the same, the flows 2.0e-3 px apart at most at
# 1,4,8 and 1.1e-2 at 3,4,8, relatively 0.5% (measured on these
# stand-ins), past FLOW_ATOL
RATED_FLOW_ATOL = 2e-2
# ``--lk_bf16``: the LK windows' gathers and products in bfloat16 (8 bits
# of mantissa) on the same seeded stacks: 4.8e-2 px measured
LK_BF16_FLOW_ATOL = 1e-1


def stand_ins(out_dir):
    """The rated directory's layout under ``out_dir``; returns its path."""
    for rel, (run, mode) in STAND_INS.items():
        img, src = read_png(str(REPO / "gallery" / run / "best.png"))
        os.makedirs(os.path.join(out_dir, os.path.dirname(rel)), exist_ok=True)
        write_png(os.path.join(out_dir, rel), convert(img, src, mode))
    os.makedirs(os.path.join(out_dir, "control"), exist_ok=True)
    write_png(os.path.join(out_dir, "control", "small.png"), np.full((120, 160), 128, np.uint8))
    return str(out_dir)


@pytest.fixture(scope="module")
def rated(tmp_path_factory):
    root = tmp_path_factory.mktemp("rated")
    return {"dir": stand_ins(root / "EIGEN-images"),
            "bw": write_npz(root / "bw.npz", BW), "color": write_npz(root / "color.npz", COLOR)}


@pytest.fixture(scope="module")
def jax_vectors():
    """The JAX probe's ``get_vectors``, memoised for the module: every
    JAX script of a test file and the port's scripts on JAX vectors read
    the same sets."""
    memo = {}
    get = jax_probe.get_vectors

    def vectors(path, model, channels, w=160, h=120, **kw):
        key = (path, model, tuple(channels), w, h, bool(kw.get("int8")), bool(kw.get("s2d")),
               getattr(kw.get("flow"), "lk_dtype", "float32"))
        if key not in memo:
            memo[key] = get(path, model, channels, w, h, **kw)
        return memo[key].copy()

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_probe, "get_vectors", vectors)
        yield vectors


@pytest.fixture
def stand_in_modules(rated, jax_vectors, monkeypatch):
    """Both packages' rated tools pointed at the stand-ins and the narrow
    stacks, by script name: ((JAX module, port module), the JAX probe's
    memoised vectors)."""
    mods = {}
    for name, port in (("probe_rated", probe_rated), ("probe_breakdown", probe_breakdown),
                       ("field_anatomy", field_anatomy),
                       ("cache_probe_vectors", cache_probe_vectors)):
        jax_mod = _jax_script(name)
        for mod in (jax_mod, port):
            monkeypatch.setattr(mod, "RATED_DIR", rated["dir"])
            monkeypatch.setattr(mod, "BW", BW)
            monkeypatch.setattr(mod, "COLOR", COLOR)
        mods[name] = ((jax_mod, port), jax_vectors)
    return mods


def _port_on_jax_vectors(monkeypatch, port, jax_vectors):
    """The port's script reads the JAX probe's vectors."""
    def vectors(path, model, channels, w=160, h=120, *, device, flow=None, **kw):
        if flow is not None:
            kw["flow"] = jax_flow.FlowConfig(**vars(flow))
        return jax_vectors(path, model, channels, w, h, **kw)

    monkeypatch.setattr(port, "get_vectors", vectors)


def _by_corner(v):
    return v[np.lexsort((v[:, 0], v[:, 1]))]


def _held_like_the_probe(ours, ref, atol=RATED_FLOW_ATOL):
    """The port's vector set against the JAX probe's: by count, and where
    the counts agree, the same corners and flows within RATED_FLOW_ATOL.
    Corners of equal response may come in another order (the stand-ins
    converted to L have ties), so the sets are compared corner by
    corner."""
    assert abs(len(ours) - len(ref)) <= COUNT_RTOL * len(ref)
    if len(ours) == len(ref):
        ours, ref = _by_corner(ours), _by_corner(ref)
        np.testing.assert_array_equal(ours[:, :2], ref[:, :2])
        np.testing.assert_allclose(ours[:, 2:], ref[:, 2:], atol=atol, rtol=0)


def test_stand_ins_have_the_reference_layout(rated):
    modes = {rel: read_png(os.path.join(rated["dir"], rel))[1]
             for rel in (*STAND_INS, "control/small.png")}
    assert modes == {**{rel: mode for rel, (_, mode) in STAND_INS.items()},
                     "control/small.png": "L"}
    assert [rel for _, rel, _, _ in probe_rated.IMAGES] == [*STAND_INS, "control/small.png"]


def test_probe_rated_equals_jax(rated, stand_in_modules, monkeypatch, tmp_path, capsys):
    """The eight stand-ins: the table, the summary and ``--json`` byte-equal
    on the JAX probe's vectors; the port's own probe within the probe's
    rules; ``compare_probes`` on the two JSONs."""
    (jax_mod, port), jax_vectors = stand_in_modules["probe_rated"]
    args = ["--model_bw", rated["bw"], "--model_color", rated["color"]]
    ref_json, arith_json, own_json = (str(tmp_path / f"{n}.json") for n in ("ref", "on", "own"))
    assert jax_mod.main(args + ["--json", ref_json]) == 0
    ref = capsys.readouterr().out
    own = port.main(args + ["--json", own_json, "--device", "cpu"])
    own_out = capsys.readouterr().out
    with monkeypatch.context() as m:
        _port_on_jax_vectors(m, port, jax_vectors)
        port.main(args + ["--json", arith_json, "--device", "cpu"])
    assert capsys.readouterr().out == ref
    with open(ref_json) as f, open(arith_json) as g:
        assert f.read() == g.read()

    with open(ref_json) as f:
        ref_doc = json.load(f)
    with open(own_json) as f:
        assert json.load(f) == json.loads(json.dumps(own))
    assert len(own_out.splitlines()) == len(ref.splitlines())
    assert own["results"]["control"] == ref_doc["results"]["control"]
    assert ref_doc["results"]["control"]["n_vectors"] == 0
    for name, row in own["results"].items():
        want = ref_doc["results"][name]
        assert {k: row[k] for k in ("published", "structure", "channels")} == \
            {k: want[k] for k in ("published", "structure", "channels")}
        assert abs(row["n_vectors"] - want["n_vectors"]) <= COUNT_RTOL * want["n_vectors"]
        assert row["ours"] == pytest.approx(want["ours"], abs=SWARM_ATOL)
    for name, rel, _, _ in probe_rated.IMAGES:
        path = os.path.join(rated["dir"], rel)
        channels, model = ((BW, rated["bw"]) if read_png(path)[1] == "L"
                           else (COLOR, rated["color"]))
        _held_like_the_probe(get_vectors(path, model, channels, device="cpu"),
                             jax_vectors(path, model, channels))

    jax_cp = _jax_script("compare_probes")
    assert compare_probes.main([ref_json, own_json]) == 0
    ours = capsys.readouterr().out
    jax_cp.main([ref_json, own_json])
    assert ours == capsys.readouterr().out


def test_probe_rated_only_selects_by_stack(rated, stand_in_modules, monkeypatch, capsys):
    (jax_mod, port), jax_vectors = stand_in_modules["probe_rated"]
    _port_on_jax_vectors(monkeypatch, port, jax_vectors)
    args = ["--model_bw", rated["bw"], "--model_color", rated["color"]]
    for only in ("bw", "color,control", "manyfish,rotate_02"):
        jax_mod.main(args + ["--only", only])
        ref = capsys.readouterr().out
        got = port.main(args + ["--only", only, "--device", "cpu"])
        assert capsys.readouterr().out == ref
        assert ("control" in got["results"]) == ("control" in only or only == "bw")
    for fn in (jax_mod.main, lambda a: port.main(a + ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="unknown entries"):
            fn(args + ["--only", "rotate_03"])


@pytest.mark.parametrize("name", ["probe_breakdown", "field_anatomy"])
def test_breakdown_and_anatomy_equal_jax(name, rated, stand_in_modules, monkeypatch, capsys):
    """On the JAX probe's vectors the port prints the JAX script's lines
    byte for byte (``field_anatomy`` with ``--color``, and ``--only`` and
    ``--bands``); on its own, the same lines for the same images."""
    (jax_mod, port), jax_vectors = stand_in_modules[name]
    base = ["--model_bw", rated["bw"], "--model_color", rated["color"]]
    variants = [base] if name == "probe_breakdown" else [
        base + ["--color"], base + ["--color", "--only", "expand", "--bands", "3"]]
    for args in variants:
        jax_mod.main(args)
        ref = capsys.readouterr().out
        own = port.main(args + ["--device", "cpu"])
        own_out = capsys.readouterr().out
        with monkeypatch.context() as m:
            _port_on_jax_vectors(m, port, jax_vectors)
            port.main(args + ["--device", "cpu"])
        assert capsys.readouterr().out == ref
        labels = [line.split(":")[0].split()[0] for line in ref.splitlines()
                  if line and not line.startswith(" ")]
        assert labels == [line.split(":")[0].split()[0] for line in own_out.splitlines()
                          if line and not line.startswith(" ")]
        assert len(own) == (8 if name == "probe_breakdown" else len(labels))


def test_cache_probe_vectors_equals_jax(rated, stand_in_modules, monkeypatch, tmp_path, capsys):
    """``main`` on the stand-ins with the seeded narrow stacks standing as
    the bundled ones (``bundled_weights_path`` of both packages names their
    files): on the JAX probe's vectors the same cache, floors and output;
    on the port's own, the same keys, hashes and metadata and each vector
    set within the probe's rules."""
    (jax_mod, port), jax_vectors = stand_in_modules["cache_probe_vectors"]
    files = {BW: rated["bw"], COLOR: rated["color"]}
    for mod in (loader, jax_loader, port):
        monkeypatch.setattr(mod, "bundled_weights_path", lambda ch: files.get(tuple(ch)))
    floors = {"margin": 0.005, "floors": {}, "aggregates": {}}

    def run(fn, tag, extra=()):
        out, fl = tmp_path / f"{tag}.npz", tmp_path / f"{tag}.json"
        fl.write_text(json.dumps(floors))
        fn(["--out", str(out), "--floors", str(fl), *extra])
        return np.load(out), json.loads(fl.read_text()), capsys.readouterr().out

    ref, ref_floors, ref_out = run(jax_mod.main, "ref")
    own, own_floors, _ = run(port.main, "own", ["--device", "cpu"])
    with monkeypatch.context() as m:
        _port_on_jax_vectors(m, port, jax_vectors)
        on, on_floors, on_out = run(port.main, "on", ["--device", "cpu"])
    assert on_out.replace("on.", "ref.") == ref_out and on_floors == ref_floors
    assert sorted(on.files) == sorted(ref.files) == sorted(own.files)
    for key in ref.files:
        np.testing.assert_array_equal(on[key], ref[key])
    assert "sha/1_4_8" in ref.files and "sha/3_4_8" in ref.files
    assert np.array_equal(ref["meta/control"], [1, 0.0, 0.0]) and ref["vec/control"].size == 0
    for key in ref.files:
        if key.startswith("vec/"):
            _held_like_the_probe(own[key], ref[key])
        elif key.startswith("meta/"):
            np.testing.assert_array_equal(own[key][:2], ref[key][:2])
            assert own[key][2] == pytest.approx(ref[key][2], abs=SWARM_ATOL)
        else:
            np.testing.assert_array_equal(own[key], ref[key])
    for part in ("floors", "aggregates"):
        assert own_floors[part] == pytest.approx(ref_floors[part], abs=SWARM_ATOL)


@pytest.fixture
def committed_guard():
    """The committed ordering guard stays byte-equal."""
    paths = [REPO / "gallery" / "probe_vectors.npz", REPO / "gallery" / "ordering_floors.json"]
    before = [p.read_bytes() for p in paths]
    yield
    assert [p.read_bytes() for p in paths] == before


def _fake_probe(monkeypatch, scores):
    """``cache_probe_vectors``'s probe and scorer replaced: every image
    gets one vector, and the score ``scores[name]``."""
    names = {os.path.join(cache_probe_vectors.RATED_DIR, rel): name
             for name, rel, _, _ in cache_probe_vectors.IMAGES}
    monkeypatch.setattr(cache_probe_vectors, "get_vectors",
                        lambda path, *a, **kw: np.full((1, 4), len(names[path]), np.float32))
    order = iter(name for name, _, _, _ in cache_probe_vectors.IMAGES)
    monkeypatch.setattr(cache_probe_vectors, "score_vectors",
                        lambda structure, vec, w, h: scores[next(order)])


@pytest.mark.parametrize("case", ["control_not_zero", "regression", "aggregate_regression",
                                  "allowed_regression"])
def test_cache_probe_vectors_refuses_regressions(case, rated, monkeypatch, tmp_path,
                                                 committed_guard, capsys):
    """A control that does not score exactly 0.0, and an image below its
    floor without ``--allow_regression``, are refused before anything is
    written; ``--allow_regression`` lowers the per-image floor but not an
    aggregate one; the committed guard files never change."""
    monkeypatch.setattr(cache_probe_vectors, "RATED_DIR", rated["dir"])
    scores = {name: 0.6 for name, _, _, _ in cache_probe_vectors.IMAGES}
    scores["control"] = 0.0
    floors = {"margin": 0.005, "floors": {"rotate_01": 0.5}, "aggregates": {}}
    extra = []
    if case == "control_not_zero":
        scores["control"] = 0.25
    elif case in ("regression", "allowed_regression"):
        scores["rotate_01"] = 0.4
        extra = ["--allow_regression"] if case == "allowed_regression" else []
    else:
        floors["aggregates"] = {"circles_avg": 0.7}
        extra = ["--allow_regression"]
    _fake_probe(monkeypatch, scores)
    out, fl = tmp_path / "c.npz", tmp_path / "floors.json"
    fl.write_text(json.dumps(floors))
    argv = ["--out", str(out), "--floors", str(fl), "--device", "cpu", *extra]
    if case == "allowed_regression":
        assert cache_probe_vectors.main(argv)["rotate_01"] == 0.4
        assert json.loads(fl.read_text())["floors"]["rotate_01"] == 0.395
        assert out.exists()
        return
    want = {"control_not_zero": "control scores 0.250", "regression": "regressed cache",
            "aggregate_regression": "aggregate floor"}[case]
    with pytest.raises(SystemExit, match=want):
        cache_probe_vectors.main(argv)
    assert not out.exists() and json.loads(fl.read_text()) == floors


def test_cache_probe_vectors_needs_out_and_floors(rated, monkeypatch, tmp_path, capsys,
                                                  committed_guard):
    """Neither path has a default: the committed guard is never written by
    a run that was not told to."""
    monkeypatch.setattr(cache_probe_vectors, "RATED_DIR", rated["dir"])
    _fake_probe(monkeypatch, {name: 0.0 for name, _, _, _ in cache_probe_vectors.IMAGES})
    fl = tmp_path / "floors.json"
    shutil.copy(REPO / "gallery" / "ordering_floors.json", fl)
    for argv in ([], ["--out", str(tmp_path / "c.npz")], ["--floors", str(fl)]):
        with pytest.raises(SystemExit) as err:
            cache_probe_vectors.main(argv + ["--device", "cpu"])
        assert err.value.code == 2
    assert "required" in capsys.readouterr().err

