"""The port's ``parallel/`` paths across processes on the CPU: the
data-parallel train step, the spatial rollout (float and int8 params) and
the pipelined rollout, each run by two ``gloo`` processes that hold one
entry of a two-entry CPU mesh (the pipeline's three stages: stage 0 on rank
0, stages 1 and 2 on rank 1), held bit for bit against one process over
the same entries (``tests/torch_process_paths.py``: ``3,4,8``, 32x32, pop
4, 4+2 steps, 2 train steps).  Then the int8 spatial rollout within one
process: bit-equal to the port's unsharded int8 rollout, and against the
JAX ``make_spatial_rollout`` on the virtual CPU mesh with
``quantize_params_int8`` params, as the int8 rollout is held against JAX
(``tests/test_torch_options.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_process_paths as paths
from evolutionary_illusion_generator_tpu.models.prednet import model as jm
from evolutionary_illusion_generator_tpu.parallel import spatial as jax_spatial
from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain, train
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
    init_params_numpy,
    params_from_numpy,
)
from evolutionary_illusion_generator_tpu_torch.models.prednet.model import (
    quantize_params_int8,
    rollout_flow_frames,
)
from evolutionary_illusion_generator_tpu_torch.parallel import make_mesh_2d, make_spatial_rollout
from evolutionary_illusion_generator_tpu_torch.parallel.mesh import Mesh
from evolutionary_illusion_generator_tpu_torch.parallel.pipeline import (
    pipelined_rollout_flow_frames,
)
from test_torch_options import INT8_CARRIED_MAX, INT8_ROLLOUT_MEAN
from test_torch_parallel import REPO, run_two_processes

torch.set_num_threads(1)

CHILD_TIMEOUT_S = 180

_CHILD = """
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import numpy as np, torch
torch.set_num_threads(1)
import torch_process_paths as paths
from evolutionary_illusion_generator_tpu_torch.parallel import initialize_distributed
from evolutionary_illusion_generator_tpu_torch.parallel.distributed import process_index
import torch.distributed as dist

assert initialize_distributed()  # from the JAX_* environment
rank = process_index()
out = paths.run_all(rank)
path = {out_dir!r} + f"/rank{{rank}}.npz"
np.savez(path, **{{f"{{name}}/{{k}}": v for name, d in out.items() for k, v in d.items()}})
dist.destroy_process_group()
print('{{"rank": %d, "path": "%s"}}' % (rank, path))
"""


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """Both ranks' outputs of every path, from one two-process run."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    code = _CHILD.format(repo=str(REPO), tests=str(REPO / "tests"), out_dir=out_dir)
    results = run_two_processes(code, timeout=CHILD_TIMEOUT_S, env={"OMP_NUM_THREADS": "1"})
    assert [r["rank"] for r in results] == [0, 1]
    ranks = []
    for r in results:
        with np.load(r["path"]) as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


@pytest.fixture(scope="module")
def one_process_run():
    return paths.run_all()


@pytest.mark.parametrize("path", paths.PATHS)
def test_two_processes_equal_one_process(path, two_process_run, one_process_run):
    """Every rank returns what one process over the same mesh entries
    returns, bit for bit: the train step's losses and params (every entry's
    float32 gradients and loss gathered and added in entry order), the
    rollouts' full frames (halo rows and stage messages as host copies;
    the int8 scale's maximum over both processes' bands)."""
    want = one_process_run[path]
    for rank, got in enumerate(two_process_run):
        mine = {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith(path + "/")}
        assert sorted(mine) == sorted(want), (rank, path)
        for k, v in want.items():
            np.testing.assert_array_equal(mine[k], v, err_msg=f"rank {rank} {path} {k}")
            assert np.isfinite(v).all()


def _process_mesh(axes, shape):
    """A mesh whose entries claim two processes, in a run that has none."""
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device("cpu")] * devs.size
    return Mesh(devs.reshape(shape), axes, np.arange(devs.size).reshape(shape) % 2)


@pytest.mark.parametrize("path", ["train_step", "pretrain", "spatial", "pipeline"])
def test_a_mesh_across_processes_needs_a_process_group(path):
    """A mesh that names two processes in a run without a process group
    fails at once, naming the call that makes one."""
    match = "no process group is initialized"
    p, imgs = paths.params(), paths.images()
    with pytest.raises(ValueError, match=match):
        if path == "train_step":
            train.make_train_step(train.adam(1e-3), mesh=_process_mesh(("pop",), (2,)))
        elif path == "pretrain":
            pretrain.pretrain(paths.CHANNELS, steps=1, batch=2, T=3, h=16, w=16,
                              verbose=False, mesh=_process_mesh(("pop",), (2,)))
        elif path == "spatial":
            make_spatial_rollout(_process_mesh(("pop", "sp"), (1, 2)))
        else:
            pipelined_rollout_flow_frames(p, imgs, _process_mesh(("pp",), (3,)), n_micro=4)


# ---- int8 params in the spatial rollout, one process -------------------------


def _int8_inputs():
    layers = init_params_numpy(paths.CHANNELS, seed=0)
    params = quantize_params_int8(params_from_numpy(layers, torch.float32, "cpu"))
    return layers, params, paths.images()


@pytest.mark.parametrize("pop_sp", [(1, 2), (2, 2)])
def test_int8_spatial_rollout_equals_the_unsharded_int8_rollout(pop_sp):
    """Each band quantises its rows and its halo rows with the whole
    frame's scale (the maximum of the bands' per-row maxima), so the codes
    are the unsharded rollout's, the int32 sums exact, and the frames equal
    bit for bit."""
    _, params, imgs = _int8_inputs()
    mesh = make_mesh_2d(*pop_sp, devices=["cpu"] * 4)
    for pair in ("population", "probe"):
        got = make_spatial_rollout(mesh, repeat=paths.REPEAT, extension=paths.EXTENSION,
                                   pair=pair)(params, imgs)
        want = rollout_flow_frames(params, imgs, repeat=paths.REPEAT, extension=paths.EXTENSION,
                                   pair=pair, use_pallas=False)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all() and torch.equal(g, w), pair


@pytest.mark.parametrize("pop_sp", [(1, 2), (2, 2)])
def test_int8_spatial_rollout_matches_jax(pop_sp):
    """Against JAX's ``make_spatial_rollout`` on the virtual CPU mesh with
    the JAX ``quantize_params_int8`` params (codes and scales bit-equal to
    the port's): a last-bit difference of the gate math may flip a code
    from the second step on and the recurrence carries it, so the frames
    are held as the int8 rollout's carried flips are, in the mean
    (``INT8_ROLLOUT_MEAN``) and the max (``INT8_CARRIED_MAX``)."""
    layers, params, imgs = _int8_inputs()
    got = make_spatial_rollout(make_mesh_2d(*pop_sp, devices=["cpu"] * 4), repeat=paths.REPEAT,
                               extension=paths.EXTENSION)(params, imgs)
    jq = jm.quantize_params_int8([{k: jnp.asarray(v) for k, v in l.items()} for l in layers])
    jmesh = jax_spatial.make_mesh_2d(*pop_sp)
    want = jax_spatial.make_spatial_rollout(jmesh, repeat=paths.REPEAT,
                                            extension=paths.EXTENSION)(
        jq, jax.device_put(jnp.asarray(imgs.numpy()), NamedSharding(jmesh, P("pop", "sp"))))
    for g, w in zip(got, want):
        d = np.abs(g.numpy() - np.asarray(w))
        assert np.isfinite(g.numpy()).all()
        assert d.mean() <= INT8_ROLLOUT_MEAN and d.max() <= INT8_CARRIED_MAX, (d.mean(), d.max())
