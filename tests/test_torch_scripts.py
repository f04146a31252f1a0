"""The port's scripts (``evolutionary_illusion_generator_tpu_torch/scripts/``)
on the CPU: ``phase_bench`` and ``rollout_profile`` at a tiny chunk (pop 2,
32x24, ``3,4,8``), whose JSON line must parse and hold every named field;
``ckpt_to_weights`` and ``swa_weights`` against the JAX package's scripts of
the same name on the same files, array for array.
"""

import importlib.util
import json
import math
import sys

import numpy as np
import pytest
import torch

from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
    init_params_numpy,
    params_from_numpy,
    save_params,
)
from evolutionary_illusion_generator_tpu_torch.scripts import (
    ckpt_to_weights,
    phase_bench,
    rollout_profile,
    shard_divergence,
    swa_weights,
)
from evolutionary_illusion_generator_tpu_torch.utils.profiling import PORT_KERNELS, by_wrapper
from test_torch_parallel import REPO

torch.set_num_threads(1)

TINY = ["--pop", "2", "--width", "32", "--height", "24", "--channels", "3,4,8",
        "--device", "cpu"]


def _jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_phase_bench_prints_every_phase(capsys):
    got = phase_bench.main(TINY + ["--reps", "1"])
    line = _json_line(capsys)
    assert line == json.loads(json.dumps(got))
    assert line["script"] == "phase_bench" and line["card"] == "cpu"
    assert (line["pop"], line["width"], line["height"]) == (2, 32, 24)
    assert line["graph"] is False  # no CUDA graph on the CPU
    for k in phase_bench.FIELDS:
        assert isinstance(line[k], float) and math.isfinite(line[k]), k
        assert k == "other_s" or line[k] >= 0.0, k
    parts = ("pack_s", "copy_in_s", "replay_s", "copy_out_s", "score_s", "other_s")
    assert math.isclose(sum(line[k] for k in parts), line["full_replay_s"], rel_tol=1e-9)


@pytest.mark.parametrize("s2d", ["0", "1"])
def test_rollout_profile_prints_its_table(s2d, capsys):
    got = rollout_profile.main(TINY + ["--s2d", s2d, "--repeat", "4"])
    line = _json_line(capsys)
    assert line == json.loads(json.dumps(got))
    assert line["script"] == "rollout_profile" and line["s2d"] == (s2d == "1")
    for k in ("first_s", "steady_s", "busy_s", "wall_s", "busy_share"):
        assert isinstance(line[k], float) and line[k] > 0.0, k
    assert len(line["all_s"]) == 3 and line["steady_s"] == sorted(line["all_s"])[1]
    assert 0.0 < line["busy_share"] <= 1.0 and line["launches"] > 0
    rows = line["kernels"]
    assert 0 < len(rows) <= rollout_profile.TOP
    assert all(set(r) == {"name", "count", "ms", "share"} for r in rows)
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows), reverse=True)
    assert sum(r["share"] for r in rows) <= 1.0 + 1e-9
    assert set(line["wrappers"]) == set(PORT_KERNELS) | {"library convs"}


@pytest.mark.parametrize("option,op", [([], "ahat_error_unit"),
                                       (["--use_pallas", "true"], "fused_lstm_gates"),
                                       (["--use_pallas", "false"], "conv2d"),
                                       (["--s2d"], "fused_lstm_gates"),
                                       (["--int8"], "_conv_q")])
def test_shard_divergence_takes_the_evaluator_options(option, op):
    """``shard_divergence.py`` on the CPU at a tiny shape with each route and
    option: the summary names them, and the traced ops are the route's (the
    True route's gate kernel and units, the plain route's convs only, the
    s2d pixel layer's gate kernel, the int8 convs); the CPU's plain versions
    sum a row in one order whatever the batch, so every op is equal."""
    out = shard_divergence.main(["--device", "cpu", "--w", "32", "--h", "24", "--channels",
                                 "3,4,8", "--pop", "4", "--steps", "2", *option])
    route = option[1] if option[:1] == ["--use_pallas"] else "fused"
    for label in ("default", "pinned"):
        got = out[label]
        assert (got["route"], got["s2d"], got["int8"]) == (route, "--s2d" in option,
                                                           "--int8" in option)
        assert got["ops"] > 0 and got["ops_equal"] == got["ops"] and got["bit_equal"]
    calls = []
    params = shard_divergence._evaluators(shard_divergence.argparse.Namespace(
        channels=(3, 4, 8), params_seed=1, pop=4, seed=3, w=32, h=24, shards=2,
        use_pallas=route, s2d="--s2d" in option, int8="--int8" in option),
        torch.device("cpu"))[1].params
    with torch.inference_mode(), shard_divergence.op_trace(calls):
        from evolutionary_illusion_generator_tpu_torch.models.prednet import model
        model.rollout(params, torch.rand(2, 24, 32, 3), repeat=1, extension=0,
                      use_pallas=shard_divergence.ROUTES[route], s2d_l0="--s2d" in option,
                      compute_dtype=torch.bfloat16)
    ops = {c["op"].split()[0] for c in calls}
    assert op in ops, ops
    if route == "false":
        assert ops == {"conv2d"}, ops


def test_by_wrapper_counts_every_body_of_the_units():
    """The units' wgmma, im2col, mma.sync and direct kernels all count for
    their wrappers, and the im2col kernel's name is not taken for a library
    conv's."""
    events = [
        ("void (anonymous namespace)::ahat_error_unit_wgmma_kernel<192, __nv_bfloat16>()", 44,
         1e3),
        ("void (anonymous namespace)::ahat_error_unit_kernel_direct<3, float, float>()", 22, 1e2),
        ("void (anonymous namespace)::ahat_error_unit_kernel<64, float, float>(P)", 2, 1e1),
        ("void (anonymous namespace)::a_unit_wgmma_kernel<96>(CUtensorMap_st)", 44, 2e3),
        ("void (anonymous namespace)::a_unit_im2col_kernel<48>(Geometry)", 22, 3e2),
        ("void (anonymous namespace)::a_unit_kernel<64, float>(AParams)", 1, 1e1),
        ("void at::native::im2col_kernel<float>()", 3, 1.0),
    ]
    got = by_wrapper(events)
    assert got["ahat_error_unit"]["count"] == 68 and math.isclose(got["ahat_error_unit"]["ms"],
                                                                  1.11)
    assert got["a_unit"]["count"] == 67 and math.isclose(got["a_unit"]["ms"], 2.31)
    assert got["library convs"]["count"] == 3
    assert got["library convs"]["names"] == [events[-1][0]]


def test_by_wrapper_sums_the_kernels_of_each_wrapper():
    """A trace's kernels summed by the wrapper that launches them; library
    conv kernels apart (with their names), cuBLAS's GEMMs and elementwise
    kernels in neither."""
    events = [
        ("void (anonymous namespace)::a_unit_kernel<64, __nv_bfloat16>(AParams)", 66, 2723.0),
        ("void (anonymous namespace)::ahat_error_unit_kernel<16, float, float>(P)", 22, 513.0),
        ("void (anonymous namespace)::ahat_error_unit_kernel<64, float, float>(P)", 66, 2372.0),
        ("void (anonymous namespace)::wg::convlstm_fused_wgmma_kernel<192, float>()", 66, 8e3),
        ("void (anonymous namespace)::convlstm_fused_kernel<float>(Params)", 3, 30.0),
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 88, 67.0),
        ("void cudnn::cnn::conv2d_grouped_direct_kernel<false>()", 22, 19.0),
        ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 5, 4.0),
        ("void at::native::vectorized_elementwise_kernel<8>()", 330, 34.0),
    ]
    got = by_wrapper(events)
    assert set(got) == set(PORT_KERNELS) | {"library convs"}
    assert (got["a_unit"]["count"], got["a_unit"]["ms"]) == (66, 2.723)
    assert got["ahat_error_unit"]["count"] == 88 and math.isclose(got["ahat_error_unit"]["ms"],
                                                                  2.885)
    assert got["fused_convlstm_layer_multi"] == {"count": 66, "ms": 8.0}
    assert got["narrow_convlstm_layer"] == got["fused_lstm_gates"] == {"count": 0, "ms": 0.0}
    lib = got["library convs"]
    assert lib["count"] == 110 and math.isclose(lib["ms"], 0.086)
    assert lib["names"] == [events[5][0], events[6][0]]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_npz(a, b):
    a, b = _npz(a), _npz(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_ckpt_to_weights_matches_the_jax_script(tmp_path):
    """A checkpoint that the port's ``pretrain`` writes (a tiny CPU run),
    converted by both scripts: the same ``save_params`` file."""
    ckpt = str(tmp_path / "run.part-a.npz")
    pretrain.pretrain((3, 4, 8), steps=3, batch=2, T=3, h=16, w=16, verbose=False,
                      checkpoint=ckpt, save_every=2, device="cpu")
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    ckpt_to_weights.main([ckpt, ours])
    _jax_script("ckpt_to_weights").main(["ckpt_to_weights.py", ckpt, theirs])
    _assert_same_npz(ours, theirs)
    assert len(_npz(ours)) == 16  # lstm_w, lstm_b, ahat_w, ahat_b (, a_w, a_b) a layer
    with pytest.raises(SystemExit, match="not a pretrain checkpoint"):
        ckpt_to_weights.main([ours, str(tmp_path / "again.npz")])


def test_swa_weights_matches_the_jax_script(tmp_path, monkeypatch):
    ins = []
    for seed in range(3):
        path = str(tmp_path / f"snap{seed}.npz")
        save_params(params_from_numpy(init_params_numpy((3, 4, 8), seed=seed), torch.float32,
                                      "cpu"), path, dtype=np.float16)
        ins.append(path)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    swa_weights.main([ours] + ins)
    monkeypatch.setattr(sys, "argv", ["swa_weights.py", theirs] + ins)
    _jax_script("swa_weights").main()
    _assert_same_npz(ours, theirs)
    with pytest.raises(SystemExit, match="at least two"):
        swa_weights.main([ours, ins[0]])
