"""The paths of the port's ``parallel/`` that span processes, at a small
size, run the same way in each process of a two-process run and in one
process over a mesh of the same entries (``tests/test_torch_processes.py``).

Imports torch, numpy and the port only (no JAX), so the child processes
start quickly.  Inputs come from fixed seeds; each path's outputs are
returned as float32 numpy arrays keyed by name.
"""

import numpy as np
import torch

from evolutionary_illusion_generator_tpu_torch.models.prednet import train
from evolutionary_illusion_generator_tpu_torch.models.prednet.model import (
    init_params,
    quantize_params_int8,
)
from evolutionary_illusion_generator_tpu_torch.parallel import (
    make_mesh,
    make_mesh_2d,
    make_spatial_rollout,
)
from evolutionary_illusion_generator_tpu_torch.parallel.pipeline import (
    make_pp_mesh,
    pipelined_rollout_flow_frames,
)
from evolutionary_illusion_generator_tpu_torch.utils import prng

CHANNELS = (3, 4, 8)
POP, HW = 4, 32
REPEAT, EXTENSION = 4, 2
# the train step: a closed-loop masked step (whole-batch mask sums), 2 steps
TRAIN_KW = dict(t_open=3, closed_weight=5.0, masked_closed=True, motion_weight=0.5)
TRAIN_B, TRAIN_T, TRAIN_STEPS, LR = 4, 5, 2, 2e-3
PATHS = ("train", "spatial", "int8_spatial", "pipeline")


def params(dtype=torch.bfloat16):
    return init_params(prng.PRNGKey(0), CHANNELS, dtype=dtype, device="cpu")


def images():
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.uniform(0, 1, (POP, HW, HW, CHANNELS[0])).astype(np.float32))


def train_inputs():
    rng = np.random.default_rng(2)
    frames = rng.uniform(0, 1, (TRAIN_B, TRAIN_T, HW, HW, CHANNELS[0])).astype(np.float32)
    closed = np.array([1, 0, 0.5, 1], np.float32)
    return torch.from_numpy(frames), torch.from_numpy(closed)


def _np(x):
    return x.detach().float().numpy()


def run_train(mesh):
    tx = train.adam(LR)
    p = params()
    opt = train.init_opt_state(tx, p)
    step = train.make_train_step(tx, mesh=mesh, **TRAIN_KW)
    frames, closed = train_inputs()
    out = {}
    for i in range(TRAIN_STEPS):
        p, opt, loss = step(p, opt, frames, closed)
        out[f"loss{i}"] = _np(loss)
    for l, layer in enumerate(train.trainable(p)):
        for k, v in layer.items():
            out[f"l{l}/{k}"] = _np(v)
    return out


def run_spatial(mesh, int8=False):
    p = quantize_params_int8(params(torch.float32)) if int8 else params()
    f0, f1 = make_spatial_rollout(mesh, repeat=REPEAT, extension=EXTENSION)(p, images())
    return {"f0": _np(f0), "f1": _np(f1)}


def run_pipeline(mesh):
    f0, f1 = pipelined_rollout_flow_frames(params(), images(), mesh, repeat=REPEAT,
                                           extension=EXTENSION, n_micro=POP)
    return {"f0": _np(f0), "f1": _np(f1)}


def run_all(rank=None):
    """Every path's outputs.  ``rank`` ``None``: one process over meshes of
    two entries (three stages for the pipeline); 0 or 1: this process's
    part of the same meshes in a two-process run (rank 0 holds one entry of
    each; for the pipeline rank 1 holds stages 1 and 2)."""
    two = ["cpu"] if rank is not None else ["cpu"] * 2
    stages = ["cpu"] * (3 if rank is None else 1 + rank)
    return {
        "train": run_train(make_mesh(devices=two)),
        "spatial": run_spatial(make_mesh_2d(1, 2, devices=two)),
        "int8_spatial": run_spatial(make_mesh_2d(1, 2, devices=two), int8=True),
        "pipeline": run_pipeline(make_pp_mesh(3, devices=stages)),
    }
