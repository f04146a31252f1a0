"""Where a shard's pass leaves the unsharded pass's rows.

The sharded evaluator runs the unsharded chunk pass on fewer rows.  This
script names the op whose output moves with the batch: it runs the
predictor's steps on a population's images (the evaluator's own renders)
once on the whole population and once on its first shard's rows, records
every conv (``F.conv2d``) and every kernel wrapper call in order, and
reports per call whether the shard's inputs and output equal the same rows
of the unsharded call.  The first call whose inputs agree and whose output
does not is the op that follows the batch.  It then runs the unsharded and
the sharded evaluator on the population and reports how far their flow and
fitness are apart.  Both with cuDNN as the evaluator leaves it and pinned
as the trainer pins it (``deterministic=True``, ``benchmark=False``)::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.shard_divergence

(the defaults are the card test's case: 64x48, channels 3,48,96 drawn from
seed 1, pop 16, two shards, the ``"fused"`` route).  ``--use_pallas
{fused,true,false}`` takes another route of ``EvalConfig.use_pallas``,
``--s2d`` the s2d pixel layer and ``--int8`` the int8 predictor, as the
evaluator runs them.  ``--device cpu`` runs it on the CPU at any size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["cudnn_pinned", "op_trace", "first_divergence", "main"]


@contextlib.contextmanager
def cudnn_pinned(on: bool = True):
    """cuDNN in the trainer's mode (``deterministic=True``,
    ``benchmark=False``) inside the block where ``on``."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    if on:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


@contextlib.contextmanager
def op_trace(calls: List[dict]):
    """Appends ``{"op", "inputs", "output"}`` for every ``F.conv2d``,
    kernel wrapper call (the ConvLSTM kernels, the True route's gate convs
    and the A and Ahat units) and
    int8 conv (``model._conv_q``) ``prednet_step`` makes inside the block."""
    from ..models.prednet import model

    def tensors(xs):
        out = []
        for x in xs:
            if torch.is_tensor(x):
                out.append(x.detach().clone())
            elif isinstance(x, (list, tuple)):
                out.extend(tensors(x))
        return out

    def recorded(name, fn):
        def call(*args, **kwargs):
            res = fn(*args, **kwargs)
            first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
            op = f"{name} x{tuple(first.shape[1:])}"
            if name == "conv2d":
                op = f"conv2d x{tuple(args[0].shape[1:])} w{tuple(args[1].shape)}"
            calls.append({"op": op, "inputs": tensors(args),
                          "output": tensors(res if isinstance(res, tuple) else (res,))})
            return res
        return call

    names = ("fused_lstm_gates", "narrow_convlstm_layer", "gate_convs",
             "fused_convlstm_layer_multi", "ahat_error_unit", "a_unit", "_conv_q")
    saved = F.conv2d, [getattr(model, name) for name in names]
    F.conv2d = recorded("conv2d", saved[0])
    for name, fn in zip(names, saved[1]):
        setattr(model, name, recorded(name, fn))
    try:
        yield calls
    finally:
        F.conv2d = saved[0]
        for name, fn in zip(names, saved[1]):
            setattr(model, name, fn)


def _rows_equal(whole: List[torch.Tensor], part: List[torch.Tensor], n: int):
    """(all equal, max abs gap) of ``part`` against the first ``n`` rows
    of ``whole``; tensors whose leading axis is not the batch (weights)
    are compared whole."""
    equal, gap = True, 0.0
    for w, p in zip(whole, part):
        ref = w[:n] if w.shape[0] != p.shape[0] else w
        if ref.shape != p.shape:
            return False, float("inf")
        d = (ref.float() - p.float()).abs()
        gap = max(gap, d.max().item() if d.numel() else 0.0)
        equal = equal and bool(torch.equal(ref, p))
    return equal, gap


def first_divergence(params, images, n_shard: int, steps: int, **rollout_kw):
    """Run ``steps`` predictor steps (``model.rollout``'s open loop, so its
    options apply as the evaluator applies them) on ``images`` and on its
    first ``n_shard`` rows under :func:`op_trace`; returns one row per call
    ``(step, op, inputs equal, output equal, output gap)``."""
    from ..models.prednet import model

    traces = []
    step = model.prednet_step
    for batch in (images, images[:n_shard]):
        calls: List[dict] = []

        def tagged(*args, _calls=calls, **kwargs):
            start = len(_calls)
            out = step(*args, **kwargs)
            for c in _calls[start:]:
                c["step"] = tagged.t
            tagged.t += 1
            return out

        tagged.t = 0
        model.prednet_step = tagged
        try:
            with torch.inference_mode(), op_trace(calls):
                model.rollout(params, batch, repeat=steps, extension=0, **rollout_kw)
        finally:
            model.prednet_step = step
        traces.append(calls)
    rows = []
    for whole, part in zip(*traces):
        in_eq, _ = _rows_equal(whole["inputs"], part["inputs"], n_shard)
        out_eq, gap = _rows_equal(whole["output"], part["output"], n_shard)
        rows.append((whole["step"], whole["op"], in_eq, out_eq, gap))
    return rows


#: ``--use_pallas`` -> ``EvalConfig.use_pallas``
ROUTES = {"fused": "fused", "true": True, "false": False}


def _evaluators(args, device):
    from ..evolution import EvalConfig, GenerationEvaluator
    from ..models.prednet.loader import load_or_init
    from ..neat import Population, preset
    from ..parallel import ShardedGenerationEvaluator, make_mesh

    ncfg = preset("circles").replace(pop_size=args.pop)
    params = load_or_init(None, args.channels, seed=args.params_seed, device=device)
    items = list(Population(ncfg, seed=args.seed).population.items())
    cfg = EvalConfig(w=args.w, h=args.h, program_cache=False, use_pallas=ROUTES[args.use_pallas],
                     s2d_l0=args.s2d, prednet_int8=args.int8)
    single = GenerationEvaluator(cfg, params, ncfg, device=device)
    sharded = ShardedGenerationEvaluator(cfg, params, ncfg,
                                         make_mesh(devices=[device] * args.shards))
    return items, single, sharded


def _flow_gap(a, b):
    either = a["mask"] | b["mask"]
    same = a["mask"] & b["mask"] & (a["vectors"][..., :2] == b["vectors"][..., :2]).all(-1)
    shift = np.abs(a["vectors"][..., 2:] - b["vectors"][..., 2:])[same]
    return float(same.sum() / max(either.sum(), 1)), float(shift.max(initial=0.0))


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--channels", default="3,48,96")
    p.add_argument("--w", type=int, default=64)
    p.add_argument("--h", type=int, default=48)
    p.add_argument("--pop", type=int, default=16)
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--seed", type=int, default=3, help="the population's seed")
    p.add_argument("--params_seed", type=int, default=1,
                   help="the predictor's seed (1: live flow at the defaults; 0 gives none)")
    p.add_argument("--use_pallas", choices=sorted(ROUTES), default="fused",
                   help="the predictor's route (EvalConfig.use_pallas)")
    p.add_argument("--s2d", action="store_true", help="the s2d pixel layer (EvalConfig.s2d_l0)")
    p.add_argument("--int8", action="store_true",
                   help="the int8 predictor (EvalConfig.prednet_int8)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    args.channels = tuple(int(c) for c in args.channels.split(","))
    device = torch.device(args.device)
    if device.type == "cuda":  # as the driver runs: float32 convs in full float32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    items, single, sharded = _evaluators(args, device)
    single(list(items))
    images = single.last_results["outputs"].to_numpy()["images_u8"]
    frames = torch.from_numpy(images).to(device).float().div(255.0)
    n_shard = -(-len(frames) // args.shards)
    summary = {}
    for pinned in (False, True):
        label = "pinned" if pinned else "default"
        with cudnn_pinned(pinned):
            # the evaluator's own params: int8-quantized and with the layout
            # weights its options take
            rows = first_divergence(single.params, frames, n_shard, args.steps,
                                    compute_dtype=getattr(torch, single.cfg.prednet_dtype),
                                    use_pallas=single.cfg.use_pallas,
                                    subpixel_up=single.cfg.subpixel_up, s2d_l0=args.s2d)
            t0 = time.time()
            want = single(list(items))
            t1 = time.time()
            got = sharded(list(items))
            t2 = time.time()
        moved = [r for r in rows if r[2] and not r[3]]
        a = single.last_results["outputs"].to_numpy()
        b = sharded.last_results["outputs"].to_numpy()
        matched, shift = _flow_gap(a, b)
        summary[label] = {
            "route": args.use_pallas, "s2d": args.s2d, "int8": args.int8,
            "masked": int((a["mask"] | b["mask"]).sum()),
            "ops": len(rows),
            "ops_equal": sum(r[3] for r in rows),
            "batch_variant_ops": [f"step {s} {op}: gap {g:.3e}" for s, op, _, _, g in moved],
            "unequal_ops": [f"step {s} {op}: gap {g:.3e}" for s, op, _, o, g in rows if not o],
            "first_unequal": next((f"step {s} {op} (inputs equal {i})" for s, op, i, o, _ in rows
                                   if not o), None),
            "matched_share": matched, "shift_max": shift,
            "fitness_gap": float(np.abs(got - want).max()),
            "bit_equal": bool(all(np.array_equal(a[k], b[k]) for k in ("vectors", "mask"))
                              and np.array_equal(got, want)),
            "s_single": t1 - t0, "s_sharded": t2 - t1,
        }
        print(f"[shard_divergence] {label}: " + json.dumps(summary[label]), flush=True)
    return summary


if __name__ == "__main__":
    main()
