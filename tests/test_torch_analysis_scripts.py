"""The port's analysis scripts that need no rated stimuli
(``evolutionary_illusion_generator_tpu_torch/scripts/``: ``compare_probes``,
``period_response``, ``drift_diag``, ``speciation_analysis``,
``make_gallery``'s run table, ``cache_probe_vectors``'s floors) against the
JAX package's ``scripts/`` of the same name, on the same inputs, on the CPU.

The predictor scripts are held in two parts: their arithmetic on the JAX
package's own flow vectors prints the JAX script's lines, and their own
rollout and flow stage stay within the probe's rules of
``tests/test_torch_probe.py`` (frames in the mean, vectors by count: on
symmetric rings the corner responses tie to the last bits, so the two flow
stages may keep another set of equally strong corners at the cap of 128).
"""

import dataclasses
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.evolution import probe as jax_probe
from evolutionary_illusion_generator_tpu.models.prednet import loader as jax_loader
from evolutionary_illusion_generator_tpu.models.prednet import model as jax_model
from evolutionary_illusion_generator_tpu.models.prednet import synthetic_data as jax_synth
from evolutionary_illusion_generator_tpu.ops.flow import api as jax_flow
from evolutionary_illusion_generator_tpu.ops.flow import pyramid as jax_pyramid
from evolutionary_illusion_generator_tpu.utils import image_io as jax_io
from evolutionary_illusion_generator_tpu import structure as jax_structure
from evolutionary_illusion_generator_tpu_torch.ops.flow.api import batched_flow
from evolutionary_illusion_generator_tpu_torch.scripts import (
    cache_probe_vectors,
    compare_probes,
    drift_diag,
    make_gallery,
    period_response,
    speciation_analysis,
)
from test_torch_probe import COUNT_RTOL, ROLLOUT_MEAN_TOL, REPO
from test_torch_rated_scripts import REFERENCE_DIR, stand_ins
from test_torch_scripts import _jax_script
from test_torch_synthetic_data import FLIP_SHARE, FRAME_ATOL

torch.set_num_threads(1)

# each pair's second file is `results`-keyed where the first is
# `scores`-keyed (rated_probe_v5), and the band probes hold one stack's rows
PROBE_PAIRS = [
    ("rated_probe_v5.json", "rated_probe_v9.json"),
    ("rated_probe_v4.json", "rated_probe_v6.json", "rated_probe_v9color.json"),
    ("probe_bw_v7band.json", "probe_color_v7band.json"),
    ("rated_probe_v9r_t3b.json", "probe_s2d_gate.json", "probe_lk_bf16_gate.json"),
    ("probe_v9soup.json", "rated_probe_v5.json"),
]
# three periods of the nine: the same rings and table, a third of the CPU
PERIODS = "4,12,36"


def _stdout(fn, *args, **kwargs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = fn(*args, **kwargs)
    return buf.getvalue(), got


def _floats(line):
    return [float(t) for t in line.split() if t.lstrip("+-").replace(".", "", 1).isdigit()
            or t.lstrip("+-") in ("nan", "inf")]


# ---------------------------------------------------------------------------
# compare_probes


@pytest.mark.parametrize("names", PROBE_PAIRS, ids=lambda n: "+".join(x[:-5] for x in n))
def test_compare_probes_prints_the_jax_table(names):
    paths = [str(REPO / "gallery" / n) for n in names]
    ref, rc = _stdout(_jax_script("compare_probes").main, paths)
    ours, got = _stdout(compare_probes.main, paths)
    assert rc == got == 0
    assert ours == ref and len(ours.splitlines()) > 8


def test_compare_probes_refuses_what_the_jax_script_refuses(tmp_path):
    jax_cp = _jax_script("compare_probes")
    one = [str(REPO / "gallery" / "rated_probe_v5.json")]
    for fn in (jax_cp.main, compare_probes.main):
        with pytest.raises(SystemExit) as err:
            fn(one)
        assert "Compare rated-probe JSONs" in str(err.value)
    bad = tmp_path / "bad.json"
    bad.write_text('{"other": {}}')
    msgs = []
    for fn in (jax_cp.main, compare_probes.main):
        with pytest.raises(SystemExit) as err:
            fn(one + [str(bad)])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == f"{bad}: neither 'scores' nor 'results' key"


# ---------------------------------------------------------------------------
# period_response


def test_period_response_matches_jax():
    """The bundled grayscale predictor at full width (the script's
    default), three of the nine periods: the rings bit-equal, the bfloat16
    rollout's frames in the mean, the table's lines from the JAX vectors
    equal to the JAX script's, and the port's own vectors by count."""
    jax_out, rc = _stdout(_jax_script("period_response").main, ["--periods", PERIODS])
    assert rc == 0
    ours_out, ours = _stdout(period_response.main, ["--periods", PERIODS, "--device", "cpu"])
    periods = [float(p) for p in PERIODS.split(",")]

    # the rings, as the JAX script makes them
    h, w = 120, 160
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    r = np.hypot(yy - h / 2, xx - w / 2) + 1e-6
    ref_rings = np.stack([np.asarray(jax_synth._asym_ramp(jnp.asarray(r / per)), np.float32)
                          for per in periods])[..., None]
    rings = period_response.rings(periods)
    assert rings.dtype == ref_rings.dtype
    np.testing.assert_array_equal(rings, ref_rings)

    jf0, jf1 = jax_model.rollout_flow_frames(
        jax_loader.load_or_init(None, (1, 16, 32, 64)), jnp.asarray(ref_rings), repeat=20,
        extension=2, pair="population", compute_dtype=jnp.bfloat16)
    jf0, jf1 = np.array(jf0, np.float32), np.array(jf1, np.float32)
    f0, f1 = ours["frames"]
    for a, b in ((f0, jf0), (f1, jf1)):
        assert a.shape == b.shape == (3, h, w, 1)
        assert np.abs(a - b).mean() <= ROLLOUT_MEAN_TOL

    # the table's arithmetic: on the JAX flow stage's vectors of the JAX
    # frames, the JAX script's printed lines
    vecs, mask = jax_flow.batched_flow(jnp.asarray(jf0), jnp.asarray(jf1), jax_flow.FlowConfig())
    vecs, mask = np.asarray(vecs, np.float64), np.asarray(mask)
    rows = period_response.table_rows(vecs, mask, periods)
    assert [period_response.format_row(row) for row in rows] == jax_out.splitlines()[1:]
    # the port's flow stage on the JAX frames: the same vectors by the
    # probe's rules; the port's own rollout: counts within COUNT_RTOL
    with torch.inference_mode():
        pv, pm = batched_flow(torch.from_numpy(jf0), torch.from_numpy(jf1))
    on_jax = period_response.table_rows(pv.numpy(), pm.numpy(), periods)
    for row, ref, got in zip(on_jax, rows, ours["rows"]):
        assert row["n"] == ref["n"] > 0
        assert abs(got["n"] - ref["n"]) <= COUNT_RTOL * ref["n"]
    ours_lines = ours_out.splitlines()
    assert ours_lines[0] == jax_out.splitlines()[0]
    assert ours_lines[1:] == [period_response.format_row(row) for row in ours["rows"]]


# ---------------------------------------------------------------------------
# drift_diag


def test_drift_diag_matches_jax(tmp_path, monkeypatch):
    """The bundled grayscale predictor at full width on the five inputs: the
    stand-in stimuli bit-equal, the synthetic cue frames under the rules of
    ``tests/test_torch_synthetic_data.py`` (their float32 phase math rounds
    apart: 1.4e-6 at most on 6% of the pixels, measured here), the
    statistics of the JAX vectors equal to the JAX script's printed row,
    the second extension frame (``|pred-img|``) in the mean and the port's
    own vectors by count."""
    rated = stand_ins(tmp_path / "rated")
    monkeypatch.setattr(drift_diag, "RATED_DIR", rated)
    load = jax_io.load_image
    # the JAX script names the reference's directory inside main
    monkeypatch.setattr(jax_io, "load_image",
                        lambda path, **kw: load(path.replace(REFERENCE_DIR, rated), **kw))
    monkeypatch.setattr(sys, "argv", ["drift_diag.py"])
    jax_dd = _jax_script("drift_diag")
    jax_out, _ = _stdout(jax_dd.main)
    ours_out, ours = _stdout(drift_diag.main, ["--device", "cpu"])

    inputs = drift_diag.inputs(1)
    params = jax_loader.load_or_init(None, [1, 16, 32, 64])
    jax_lines = {line.split()[0]: line for line in jax_out.splitlines()[1:]}
    assert list(jax_lines) == list(inputs) == list(ours)
    assert ours_out.splitlines()[0] == jax_out.splitlines()[0]
    jax_inputs = {}  # as the JAX script makes them
    for reg, name in ((4, "synth_tangential"), (5, "synth_radial"), (2, "synth_rings")):
        probs = [0.0] * 7
        probs[reg] = 1.0
        seq = jax_synth.synthetic_cue_batch(jax_dd.jax.random.PRNGKey(11), 1, 1, 120, 160, 1,
                                            regime_probs=tuple(probs))
        jax_inputs[name] = np.asarray(seq[0, 0])
        far = np.abs(inputs[name] - jax_inputs[name]) > FRAME_ATOL
        assert far.mean() <= FLIP_SHARE, name
    for name in ("rotate_01", "control"):
        jax_inputs[name] = load(os.path.join(rated, name, "small.png"), size=(160, 120), c_dim=1)
        np.testing.assert_array_equal(inputs[name], jax_inputs[name])

    for name, img in jax_inputs.items():
        jf0, jf1 = jax_model.rollout_flow_frames(params, jnp.asarray(img)[None], repeat=20,
                                                 extension=2, pair="probe")
        jf0, jf1 = np.array(jf0[0]), np.array(jf1[0])
        # the JAX script's vectors of its frames
        a, b = (jnp.asarray(jax_probe._png_quantize(f)) for f in (jf0, jf1))
        vec, mask = jax_flow.flow_vectors(jax_pyramid.to_gray(a), jax_pyramid.to_gray(b),
                                          jax_flow.FlowConfig())
        ref_v = np.asarray(vec)[np.asarray(mask)]
        stats = drift_diag.field_stats(ref_v)
        row = drift_diag.flow_row(jf0, jf1, torch.device("cpu"))
        got = ours[name]
        if name == "control":  # uniform: no corner
            assert stats is None and row is None and got is None
            assert jax_lines[name].split() == [name, "-"]
            continue
        # the row's arithmetic on the JAX vectors: the JAX script's line,
        # but for the drift column, which the port's rollout gives
        line = ours_out.splitlines()[1 + list(inputs).index(name)]
        assert jax_lines[name].split()[:4] == (f"{name:18s} {stats[0]:8.4f} {stats[1]:8.4f} "
                                               f"{stats[2]:8.4f}").split()
        assert line.split()[0] == name and int(line.split()[-1]) == got[4]
        # the port's flow stage on the JAX frames, and the port's rollout
        assert row[3] == stats[3] and abs(got[4] - stats[3]) <= COUNT_RTOL * stats[3]
        assert abs(got[3] - _floats(jax_lines[name])[3]) <= ROLLOUT_MEAN_TOL
    assert ours["control"] is None


# ---------------------------------------------------------------------------
# speciation_analysis


def test_speciation_checkpoint_anatomy_equals_jax():
    """The deep run's four checkpoints (written by the JAX package) read
    into the port's classes: the same distances, to the printed digit."""
    ref, _ = _stdout(_jax_script("speciation_analysis").checkpoint_anatomy)
    ours, _ = _stdout(speciation_analysis.checkpoint_anatomy)
    assert ours == ref and ref.count("gen ") == 4 and "missing" not in ref


@pytest.mark.parametrize("generations,seeds", [(3, (101, 202)), (6, (5, 7))])
def test_speciation_isolated_lineages_equal_jax(generations, seeds):
    ref, _ = _stdout(_jax_script("speciation_analysis").isolated_lineages, generations, seeds)
    ours, _ = _stdout(speciation_analysis.isolated_lineages, generations, seeds)
    assert ours == ref and f"gen {generations}," in ref


def test_speciation_reads_checkpoints_without_the_jax_package():
    """The checkpoints name the JAX package's classes; the port's reader
    maps them onto its own and imports nothing of the JAX package."""
    code = (
        "import sys\n"
        "for blocked in ('jax', 'PIL', 'cv2', 'evolutionary_illusion_generator_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from evolutionary_illusion_generator_tpu_torch.scripts import speciation_analysis as s\n"
        "s.checkpoint_anatomy()\n"
        "pop = s._restore(s.DEEP_RUN + '/neat-checkpoint-25')\n"
        "print(type(pop.config).__module__, pop.generation)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith(
        "evolutionary_illusion_generator_tpu_torch.neat.config ")


# ---------------------------------------------------------------------------
# make_gallery


def test_make_gallery_list_and_runs_equal_jax():
    jax_mg = _jax_script("make_gallery")
    ref, rc = _stdout(jax_mg.main, ["--list"])
    ours, got = _stdout(make_gallery.main, ["--list"])
    assert rc == 0 and got == {} and ours == ref
    assert make_gallery.RUN_NAMES == jax_mg.RUN_NAMES
    assert (make_gallery.BW, make_gallery.COLOR) == (jax_mg.BW, jax_mg.COLOR)
    ref_runs, runs = jax_mg._runs(), make_gallery._runs()
    assert list(runs) == list(ref_runs)
    for name, (kwargs, desc) in runs.items():
        ref_kwargs, ref_desc = ref_runs[name]
        assert desc == ref_desc and set(kwargs) == set(ref_kwargs), name
        for key, value in kwargs.items():
            ref_value = ref_kwargs[key]
            if key == "config":
                assert dataclasses.asdict(value) == dataclasses.asdict(ref_value), name
            elif key == "structure":
                assert isinstance(ref_value, jax_structure.StructureType)
                assert (value.name, int(value)) == (ref_value.name, int(ref_value)), name
            else:
                assert value == ref_value, (name, key)
    # the port's gallery is its own, never the committed one
    assert os.path.basename(make_gallery.GALLERY) == "gallery_torch"
    assert os.path.dirname(make_gallery.GALLERY) == str(REPO)


def test_make_gallery_list_imports_no_torch():
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from evolutionary_illusion_generator_tpu_torch.scripts import make_gallery\n"
        "make_gallery.main(['--list'])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert tuple(proc.stdout.split()) == make_gallery.RUN_NAMES


# ---------------------------------------------------------------------------
# cache_probe_vectors: the floors


_OLD = {"rotate_01": 0.407, "manyfish": 0.561}
_SCORES = {"rotate_01": 0.50, "rotate_02": 0.50, "expand_01": 0.50, "expand_02": 0.50,
           "color_01_expand": 0.50, "color_02_expand": 0.50, "manyfish": 0.60, "control": 0.0}
_HIGH = {"circles_avg": 0.52, "manyfish": 0.62}
_NOTES = "## Round-5 promotion\ntrade X for Y because measured Z\n"
# every case of tests/test_promote_weights.py's TestRatchetFloors and
# TestAggregateFloors: (function, args, kwargs)
FLOOR_CASES = {
    "floors_only_move_up": ("ratchet_floors", (_OLD, {"rotate_01": 0.650, "manyfish": 0.620},
                                               0.005), {}),
    "regression_held": ("ratchet_floors", (_OLD, {"rotate_01": 0.314, "manyfish": 0.620},
                                           0.005), {}),
    "allow_regression_lowers": ("ratchet_floors", (_OLD, {"rotate_01": 0.314,
                                                          "manyfish": 0.620}, 0.005),
                                {"allow_regression": True}),
    "new_image_floor": ("ratchet_floors", ({}, {"expand_01": 0.402}, 0.005), {}),
    "control_excluded": ("ratchet_floors", ({}, {"control": 0.0}, 0.005), {}),
    "gain_within_margin": ("ratchet_floors", ({"rotate_01": 0.407}, {"rotate_01": 0.408},
                                              0.005), {}),
    "aggregates_ratchet_up": ("check_aggregates", ({"circles_avg": 0.45, "manyfish": 0.55},
                                                   _SCORES, 0.005), {}),
    "lowering_refused": ("check_aggregates", (_HIGH, _SCORES, 0.005), {}),
    "rationale_not_in_notes": ("check_aggregates", (_HIGH, _SCORES, 0.005),
                               {"rationale": "trade X for Y", "notes_text": "unrelated prose"}),
    "committed_rationale_lowers": ("check_aggregates", (_HIGH, _SCORES, 0.005),
                                   {"rationale": "trade X for Y because measured Z",
                                    "notes_text": _NOTES}),
}


@pytest.mark.parametrize("case", sorted(FLOOR_CASES))
def test_floors_equal_jax(case):
    name, args, kwargs = FLOOR_CASES[case]
    ref = getattr(_jax_script("cache_probe_vectors"), name)(*args, **kwargs)
    assert getattr(cache_probe_vectors, name)(*args, **kwargs) == ref


def test_sha256_file_equals_jax():
    path = jax_loader.bundled_weights_path([1, 16, 32, 64])
    assert (cache_probe_vectors.sha256_file(path)
            == _jax_script("cache_probe_vectors").sha256_file(path))


def test_make_gallery_run_writes_the_artifact_contract(tmp_path, monkeypatch, capsys):
    """One run, cut to two generations of pop 6 on a narrow stack, into a
    ``GALLERY`` in ``tmp_path``: the run's directory emptied first, the
    artifact contract written, and the README table printed."""
    runs = make_gallery._runs()
    kwargs, desc = runs["circles_bw"]
    kwargs = dict(kwargs, config=kwargs["config"].replace(pop_size=6), channels=[1, 4, 8],
                  generations=2, checkpoint_every=1)
    monkeypatch.setattr(make_gallery, "_runs", lambda: {**runs, "circles_bw": (kwargs, desc)})
    monkeypatch.setattr(make_gallery, "GALLERY", str(tmp_path))
    (tmp_path / "circles_bw").mkdir()
    (tmp_path / "circles_bw" / "stale.txt").write_text("from an earlier run")
    got = make_gallery.main(["circles_bw", "--device", "cpu"])
    run = tmp_path / "circles_bw"
    assert {p.name for p in run.iterdir()} >= {
        "best.png", "best_flow.png", "best_black_bg.png", "enhanced.png", "metrics.jsonl",
        "neat-checkpoint-1", "neat-checkpoint-2"}
    assert not (run / "stale.txt").exists()
    assert got == {"circles_bw": make_gallery.best_fitness(str(run))}
    assert np.isfinite(got["circles_bw"])
    table = capsys.readouterr().out.splitlines()[-3:]
    assert table == ["| Run | Structure | Color | Best fitness |", "|---|---|---|---|",
                     f"| `circles_bw` | {desc} | {got['circles_bw']:.3f} |"]
    with pytest.raises(SystemExit, match="unknown runs"):
        make_gallery.main(["circles_grey", "--device", "cpu"])


# ---------------------------------------------------------------------------
# chip_smoke.py's analysis phase: what it can check on the CPU


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32])
def test_chip_smoke_stack_launches_agree_with_the_main_path(compute):
    """``_stack_launches`` (the analysis phase's expected launches, from the
    model's routing and the host plans) gives the main path's counts of
    ``_path_launches`` at the colour stack, and at the grayscale stack the
    narrow kernel on layers 0-1 (persistent at C 1 in bfloat16) and the
    fused kernel on layers 2-3."""
    import chip_smoke

    name = "bfloat16" if compute == torch.bfloat16 else "float32"
    assert (chip_smoke._stack_launches((3, 48, 96, 192), 22, compute)
            == chip_smoke._path_launches(1, 22, compute=name))
    bw = chip_smoke._stack_launches(chip_smoke.ANALYSIS_CHANNELS, 22, compute)
    assert (bw["narrow_convlstm_layer"], bw["fused_convlstm_layer_multi"]) == (44, 44)
    assert (bw["ahat_error_unit"], bw["a_unit"]) == (88, 66)
    persistent = 22 if compute == torch.bfloat16 else 0
    assert bw.get("narrow_convlstm_layer/persistent", 0) == persistent
    assert bw["narrow_convlstm_layer/mma_sync"] == 44 - persistent


def test_chip_smoke_stand_ins_have_the_reference_layout(tmp_path):
    import chip_smoke
    from evolutionary_illusion_generator_tpu_torch.utils.png import read_png

    periods = sorted({src for src, _ in chip_smoke.STAND_INS.values()
                      if isinstance(src, float)})
    rings = dict(zip(periods, period_response.rings(periods)))
    out = chip_smoke._stand_ins(str(tmp_path), str(REPO / "gallery/circles_color/best.png"),
                                rings)
    for _, rel, _, _ in cache_probe_vectors.IMAGES:
        img, mode = read_png(os.path.join(out, rel))
        assert mode == chip_smoke.STAND_INS[rel][1] and img.shape[:2] == (120, 160), rel
    control, _ = read_png(os.path.join(out, "control/small.png"))
    assert (control == 128).all()
