"""Predictor pretraining on synthetic motion, in PyTorch.

The port of the JAX package's ``models/prednet/pretrain.py``: trains a
PredNet on the synthetic sequences of :mod:`.synthetic_data` with the
losses and Adam step of :mod:`.train`, from the same seed, keys and
recipes (the bundled weights' recipes are listed in the JAX package's
``models/prednet/weights/README.md``).  It runs on the card unless asked
for the CPU:

    python -m evolutionary_illusion_generator_tpu_torch.models.prednet.pretrain \\
        --channels 1,16,32,64 --steps 300 --out prednet_bw.npz [--device cpu]

Checkpoints hold the step, the data key, the params in the JAX layout at
float32 (lossless from bfloat16) and the Adam state leaves in the order of
the JAX package's optimizer tree, under the JAX checkpoint's names; the
part file's name hashes the recipe's flags but ``--out``,
``--save_every`` and ``--device``, so one recipe resumes on either device.
The JAX ``main`` turns on its persistent compilation cache first
(``utils/compilation_cache.py``); the port's counterpart is the persistent
``.build/`` of its kernels (``_build.py``), and the trainer launches none.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..._device import resolve_device
from ...utils import prng
from .loader import load_params, params_from_numpy, params_to_numpy, save_params
from .model import init_params
from .synthetic_data import synthetic_cue_batch, synthetic_motion_batch
from .train import adam, init_opt_state, make_train_step, trainable

__all__ = ["pretrain", "main", "pretrain_kwargs", "part_path"]


def _opt_leaves(opt_state) -> list:
    """The Adam state as the JAX optimizer tree's leaves: count, then mu
    and nu, each per layer in sorted JAX-layout names."""
    leaves = [opt_state["count"].cpu().numpy()]
    for moments in (opt_state["mu"], opt_state["nu"]):
        for layer in params_to_numpy(moments):
            leaves += [layer[name] for name in sorted(layer)]
    return leaves


def _ckpt_save(path, params, opt_state, key, step) -> None:
    """Atomic training checkpoint at an iteration boundary: enough for a
    bitwise-identical resume (the train step rebuilds its float32 master
    from the stored params every step, so no state is hidden)."""
    flat = {"step": np.asarray(step), "key": np.asarray(key)}
    for l, layer in enumerate(params_to_numpy(params)):
        for name, arr in layer.items():
            flat[f"p/l{l}/{name}"] = arr.astype(np.float32)
    for i, leaf in enumerate(_opt_leaves(opt_state)):
        flat[f"o/{i}"] = leaf
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _ckpt_load(path, params, opt_state):
    """Restore (params, opt_state, key, step) saved by :func:`_ckpt_save`,
    in the dtype and on the device of ``params``.

    Raises (KeyError / ValueError) on any mismatch with the current model:
    callers take that as a stale checkpoint and start fresh."""
    data = np.load(path)
    device = params[0]["lstm_b"].device
    want = params_to_numpy(params)
    layers = []
    for l, layer in enumerate(want):
        got = {}
        for name, arr in layer.items():
            stored = data[f"p/l{l}/{name}"]
            if stored.shape != arr.shape:
                raise ValueError(f"param l{l}/{name} shape {stored.shape} != {arr.shape}")
            got[name] = stored
        layers.append(got)
    new_params = params_from_numpy(layers, params[0]["lstm_b"].dtype, device)
    leaves = _opt_leaves(opt_state)
    stored = [data[f"o/{i}"] for i in range(len(leaves))]
    for i, (s, leaf) in enumerate(zip(stored, leaves)):
        if s.shape != leaf.shape:
            raise ValueError(f"opt-state leaf {i} shape {s.shape} != {leaf.shape}")
    it = iter(stored[1:])
    moments = []
    for _ in range(2):
        moments.append(trainable(params_from_numpy(
            [{name: next(it) for name in sorted(layer)} for layer in want],
            torch.float32, device)))
    new_opt = {"count": torch.as_tensor(stored[0], dtype=torch.int32, device=device),
               "mu": moments[0], "nu": moments[1]}
    return new_params, new_opt, np.asarray(data["key"], np.uint32), int(data["step"])


def pretrain(
    channels: Sequence[int],
    *,
    steps: int = 300,
    batch: int = 8,
    T: int = 10,
    h: int = 120,
    w: int = 160,
    lr: float = 2e-3,
    seed: int = 0,
    mesh=None,
    log_every: int = 25,
    verbose: bool = True,
    max_speed: float = 1.0,
    static_fraction: float = 0.5,
    data: str = "v3",
    regime_probs=None,
    cue_speed_range=(0.5, 2.5),
    max_onset: int = 0,
    move_prob: float = 1.0,
    cue_slow_range=None,
    cue_slow_frac: float = 0.0,
    onset_hazard: float = 0.0,
    ring_speed_range=None,
    band_prob: float = 0.0,
    onset_range=None,
    closed_frames: int = 0,
    closed_weight: float = 0.0,
    edge_weight: float = 0.0,
    ring_onset: bool = False,
    closed_exclude_rings: bool = False,
    ring_motion_weight: float = 0.0,
    ring_dir_cue: bool = False,
    ring_onset_range=None,
    ring_mask_prefix: bool = False,
    ring_closed_scale: float = 1.0,
    cue_period_range=None,
    tang_radial: bool = False,
    tang_uniform: bool = False,
    cue_fine_speed_range=None,
    cue_fine_max_period: float = 12.0,
    ring_speed_cue: bool = False,
    cue_motion_weight: float = 0.0,
    checkpoint: Optional[str] = None,
    save_every: int = 0,
    init_weights: Optional[str] = None,
    device=None,
):
    """Train a PredNet on synthetic motion on ``device`` (``None``: the
    card); returns (params, final_loss).

    The JAX function's keywords, defaults and errors.  ``data="v3"``
    trains on :func:`.synthetic_data.synthetic_cue_batch`, ``"v2"`` on
    :func:`.synthetic_data.synthetic_motion_batch`.  ``closed_frames > 0``
    extends each sequence by that many closed-loop supervised frames;
    ``closed_exclude_rings``, ``ring_mask_prefix`` and
    ``cue_motion_weight`` mask the loss by regime and onset (see the JAX
    function).  ``init_weights`` warm-starts from a ``save_params`` NPZ
    (the optimizer starts fresh; the data still follow ``seed``).
    ``checkpoint`` / ``save_every`` write a resumable checkpoint every
    ``save_every`` steps and resume from it.  ``mesh``
    (:func:`..parallel.mesh.make_mesh`, over one process or several)
    trains data-parallel, the batch split over its entries
    (:func:`.train.make_train_step`); the params live on ``device``, by
    default this process's first device of the mesh.  Over several
    processes every process draws the same batches and takes the same
    step.  On the card it
    turns TF32 off for float32
    convolutions and matmuls, as the evolution driver does, and leaves it
    off.
    """
    if device is None and mesh is not None:
        device = mesh.local_devices()[0]
    device = resolve_device(device)
    if device.type == "cuda":
        # float32 convolutions and matmuls in full float32 (cuDNN would
        # take TF32 for convolutions by default), so the card trains the
        # float32 master as the CPU and the JAX reference compute it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    key = prng.PRNGKey(seed)
    params = init_params(key, channels, device=device)
    if init_weights:
        loaded = load_params(init_weights, dtype=params[0]["lstm_b"].dtype, device=device)
        if len(loaded) != len(params):
            raise ValueError(
                f"--init_weights {init_weights}: {len(loaded)} layers, "
                f"expected {len(params)} for channels {channels}"
            )
        for l, (got, tmpl) in enumerate(zip(loaded, params)):
            if set(got) != set(tmpl) or any(got[k].shape != tmpl[k].shape for k in tmpl):
                raise ValueError(
                    f"--init_weights {init_weights}: layer {l} does not match "
                    f"channels {channels}"
                )
        params = loaded
    tx = adam(lr)
    opt_state = init_opt_state(tx, params)
    T_total = T + closed_frames
    if ring_motion_weight > 0.0:
        closed_exclude_rings = True  # the hinge replaces the ring L1
    masked = bool(closed_frames) and (
        closed_exclude_rings or ring_mask_prefix or cue_motion_weight > 0.0
    )
    if masked and data != "v3":
        raise ValueError("regime-masked losses need the v3 regime data")
    if ring_mask_prefix and not (
        closed_frames and (ring_onset_range or ring_onset)
    ):
        raise ValueError(
            "ring_mask_prefix needs closed_frames and a ring onset window"
        )
    if tang_radial and tang_uniform:
        raise ValueError(
            "tang_radial and tang_uniform both rewrite the wedge-ring "
            "class's motion — pick one"
        )
    step_fn = make_train_step(
        tx, mesh=mesh, t_open=T if closed_frames else None,
        closed_weight=closed_weight if closed_frames else 0.0,
        edge_weight=edge_weight, masked_closed=masked,
        motion_weight=ring_motion_weight,
        masked_open=ring_mask_prefix,
        cue_motion_weight=cue_motion_weight,
    )
    if data == "v3":
        kwargs = {"cue_speed_range": tuple(cue_speed_range),
                  "max_onset": max_onset, "move_prob": move_prob,
                  "ring_onset": ring_onset,
                  "ring_dir_cue": ring_dir_cue,
                  "tang_radial": tang_radial,
                  "tang_uniform": tang_uniform,
                  "ring_speed_cue": ring_speed_cue}
        if cue_fine_speed_range is not None:
            kwargs["cue_fine_speed_range"] = tuple(cue_fine_speed_range)
            kwargs["cue_fine_max_period"] = cue_fine_max_period
        if ring_onset_range is not None:
            kwargs["ring_onset_range"] = tuple(ring_onset_range)
        if cue_period_range is not None:
            kwargs["cue_period_range"] = tuple(cue_period_range)
        if onset_range is not None:
            kwargs["onset_range"] = tuple(onset_range)
        if cue_slow_range is not None:
            kwargs["cue_slow_range"] = tuple(cue_slow_range)
            kwargs["cue_slow_frac"] = cue_slow_frac
        if onset_hazard > 0.0:
            kwargs["onset_hazard"] = onset_hazard
        if ring_speed_range is not None:
            kwargs["ring_speed_range"] = tuple(ring_speed_range)
        if band_prob > 0.0:
            kwargs["band_prob"] = band_prob
        if regime_probs is not None:
            kwargs["regime_probs"] = tuple(regime_probs)

        def data_fn(k):
            return synthetic_cue_batch(k, batch, T_total, h, w, channels[0],
                                       max_speed=max_speed, return_regime=masked,
                                       device=device, **kwargs)
    elif data == "v2":
        def data_fn(k):
            return synthetic_motion_batch(k, batch, T_total, h, w, channels[0],
                                          max_speed=max_speed,
                                          static_fraction=static_fraction, device=device)
    else:
        raise ValueError(f"unknown data set {data!r}")

    start = 0
    if checkpoint and os.path.exists(checkpoint):
        try:
            params, opt_state, key, start = _ckpt_load(checkpoint, params, opt_state)
            if verbose:
                print(f"[pretrain] resumed {checkpoint} at step {start}", flush=True)
        except Exception as e:  # stale/mismatched checkpoint: start fresh
            if verbose:
                print(f"[pretrain] ignoring stale checkpoint ({e})", flush=True)
            start = 0
    loss = None
    t0 = time.time()
    for i in range(start, steps):
        # checkpoint at the iteration boundary (key not yet split, so a
        # resumed run replays the identical data stream)
        if checkpoint and save_every and i > start and i % save_every == 0:
            _ckpt_save(checkpoint, params, opt_state, key, i)
        key, k = prng.split(key)
        if masked:
            frames, regimes, onsets = data_fn(k)
            cue_mask = (((regimes >= 3) & (regimes <= 5)).to(torch.float32)
                        if cue_motion_weight > 0.0 else None)
            if closed_exclude_rings:
                # rings open-loop only (their closed term is the hinge)
                mask = (regimes != 2).to(torch.float32)
            else:
                # rings closed-L1-supervised like the cues, scaled by
                # ring_closed_scale
                mask = torch.where(regimes == 2, ring_closed_scale, 1.0).to(torch.float32)
            if ring_mask_prefix:
                t_idx = torch.arange(T, dtype=torch.float32, device=device)[None, :]
                prefix = (t_idx < onsets[:, None]) & (regimes == 2)[:, None]
                open_mask = 1.0 - prefix.to(torch.float32)
                step_args = (params, opt_state, frames, mask, open_mask)
            else:
                step_args = (params, opt_state, frames, mask)
            if cue_mask is not None:
                step_args = step_args + (cue_mask,)
            params, opt_state, loss = step_fn(*step_args)
        else:
            frames = data_fn(k)
            params, opt_state, loss = step_fn(params, opt_state, frames)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(
                f"[pretrain] step {i:4d} loss {float(loss):.5f} "
                f"({time.time() - t0:.1f}s)",
                flush=True,
            )
    return params, (float(loss) if loss is not None else float("nan"))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pretrain a stand-in predictor")
    p.add_argument("--channels", default="1,16,32,64")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", default="v3", choices=("v2", "v3"))
    p.add_argument("--cue_speed", default="0.5,2.5",
                   help="min,max cue drift speed in px/frame (v3 data)")
    p.add_argument("--max_onset", type=int, default=0,
                   help="cue patterns hold static up to this many frames "
                        "before motion starts (v3 data)")
    p.add_argument("--move_prob", type=float, default=1.0,
                   help="fraction of sawtooth sequences that move; the "
                        "rest stay static — dials the predicted illusory "
                        "drift to p*speed (v3 data)")
    p.add_argument("--cue_slow", default="",
                   help="min,max of the slow cue-speed mode; with "
                        "--slow_frac makes the speed distribution bimodal "
                        "(v3 data)")
    p.add_argument("--slow_frac", type=float, default=0.0,
                   help="fraction of sawtooth sequences drawn from the "
                        "slow speed mode")
    p.add_argument("--onset_hazard", type=float, default=0.0,
                   help="per-frame geometric probability that a static "
                        "sawtooth starts moving; memoryless, so the "
                        "static-history drift prediction is p*E[speed] "
                        "at any history length (v3 data)")
    p.add_argument("--ring_speed", default="",
                   help="min,max radial speed for plain rings; makes the "
                        "control-like regime move fast in a random "
                        "direction instead of staying static (v4 data)")
    p.add_argument("--band_prob", type=float, default=0.0,
                   help="fraction of sawtooth sequences rendered as "
                        "banded wedge rings / spoke segments (the rated-"
                        "stimulus look) instead of dense ramps (v4 data)")
    p.add_argument("--onset_range", default="",
                   help="lo,hi integer window: sawtooth patterns hold "
                        "static for a uniform prefix in [lo,hi] frames, "
                        "then drift — pair with --closed_frames so the "
                        "window straddles the open/closed boundary (v5)")
    p.add_argument("--closed_frames", type=int, default=0,
                   help="supervise this many extra CLOSED-loop frames per "
                        "sequence (the probe regime; prednet_seq_loss)")
    p.add_argument("--closed_weight", type=float, default=5.0,
                   help="weight of the closed-loop L1 pixel term")
    p.add_argument("--edge_weight", type=float, default=0.0,
                   help="extra L1 on spatial finite differences of the "
                        "closed-loop predictions (ramp-edge sharpening)")
    p.add_argument("--ring_onset", action="store_true",
                   help="onset-gate the plain-ring regime's clock too "
                        "(v5b experiment; default: rings always move)")
    p.add_argument("--closed_exclude_rings", action="store_true",
                   help="mask the closed-loop loss off the plain-ring "
                        "regime (keeps the fast-drift control-zero "
                        "mechanism; see prednet_seq_loss)")
    p.add_argument("--ring_motion_weight", type=float, default=0.0,
                   help="closed-loop motion-energy hinge on ring "
                        "sequences: predicted temporal change must not "
                        "fall below the target's (anti-blur; implies "
                        "--closed_exclude_rings)")
    p.add_argument("--ring_dir_cue", action="store_true",
                   help="tie the ring drift direction to the ring duty "
                        "cycle (duty > 0.5 expands, < 0.5 contracts): "
                        "removes the direction ambiguity that makes blur "
                        "the optimal static-ring-history prediction (v5e)")
    p.add_argument("--ring_onset_range", default="",
                   help="lo,hi integer window: RING sequences hold static "
                        "for a uniform prefix then drift fast — their own "
                        "window, shorter than --onset_range, so the "
                        "post-onset frames are graded open-loop (v5e)")
    p.add_argument("--ring_mask_prefix", action="store_true",
                   help="exclude ring static-prefix frames from the "
                        "open-loop E-loss so the onset curriculum never "
                        "teaches 'copy static rings' (v5e; needs "
                        "--ring_onset_range and --closed_frames)")
    p.add_argument("--ring_closed_scale", type=float, default=1.0,
                   help="relative weight of ring sequences in the closed "
                        "L1 (v5h: decouple ring anti-contraction from cue "
                        "coherence; needs --ring_dir_cue and no "
                        "--closed_exclude_rings)")
    p.add_argument("--regime_probs", default="",
                   help="7 comma-separated regime probabilities "
                        "(texture-static, texture-moving, plain-rings, "
                        "linear-sawtooth, tangential, radial, disc-static)")
    p.add_argument("--cue_period", default="",
                   help="min,max sawtooth spatial period in px (default "
                        "12,40).  The rated stimuli's wedge structure is "
                        "radius-proportional down to ~4-8 px near the "
                        "centre; lowering the minimum puts those fine "
                        "scales in distribution (v6 fidelity series)")
    p.add_argument("--tang_radial", action="store_true",
                   help="wedge-ring (tangential) class keeps its angular-"
                        "asymmetric look but contracts radially instead of "
                        "rotating (v6d series).  Measured rationale: the "
                        "rated rotate stimuli alternate wedge chirality "
                        "per ring, so a faithful tangential response caps "
                        "rotation_symmetry_score at 0.5, while a uniform "
                        "radial response scores ~1.0 — the looming bias a "
                        "natural-video predictor actually has")
    p.add_argument("--tang_uniform", action="store_true",
                   help="wedge-ring (tangential) class rotates "
                        "differentially at a uniform px/frame across "
                        "radius instead of rigidly at constant omega "
                        "(whose inner rings move at omega*r — the "
                        "measured sub-noise inner-band tail capping the "
                        "rotate scores, BENCH_NOTES v6e).  Mutually "
                        "exclusive with --tang_radial")
    p.add_argument("--cue_speed_fine", default="",
                   help="min,max drift speed for FINE-period sawtooths "
                        "(period < --cue_fine_max_period): a separate, "
                        "faster band lifting the fine-scale response above "
                        "the ~0.1 px LK noise cap — the measured weak-tail "
                        "magnitude lever (v7 series; BENCH_NOTES round-4 "
                        "cached-vector anatomy)")
    p.add_argument("--cue_fine_max_period", type=float, default=12.0,
                   help="period threshold (px) below which --cue_speed_fine "
                        "applies")
    p.add_argument("--ring_speed_cue", action="store_true",
                   help="ring speed determined by the duty-cue magnitude "
                        "(|duty-0.5| maps linearly onto --ring_speed): the "
                        "whole ring continuation becomes a deterministic "
                        "function of appearance, so the L1-optimal static-"
                        "history prediction stays the fast-moving "
                        "continuation at ANY training budget — control-zero "
                        "as a trained property, not a stopping-time "
                        "artifact (v7 series; needs --ring_dir_cue)")
    p.add_argument("--cue_motion_weight", type=float, default=0.0,
                   help="pixelwise closed-loop amplitude hinge on cue "
                        "sequences: predicted temporal change may not fall "
                        "below the target's at ANY pixel — makes the "
                        "spatially-localized weak response (the rated "
                        "stimuli's sub-noise centre band) carry loss "
                        "(v7 series; needs --closed_frames)")
    p.add_argument("--save_every", type=int, default=2000,
                   help="write a resumable training checkpoint "
                        "(<out>.part.npz) every N steps; a restarted run "
                        "picks it up and replays bitwise-identically "
                        "(stall-watchdog restarts lose <=N steps). "
                        "0 disables")
    p.add_argument("--init_weights", default="",
                   help="warm-start params from a save_params npz "
                        "(sequential fine-tune; optimizer state fresh). "
                        "The data stream still follows --seed")
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="device to train on (default: the card; 'cpu' for the CPU)")
    return p


def _floats(text):
    return tuple(float(x) for x in text.split(",")) if text else None


def _ints(text):
    return tuple(int(x) for x in text.split(",")) if text else None


def pretrain_kwargs(args: argparse.Namespace) -> dict:
    """:func:`pretrain`'s arguments for parsed command-line flags (all but
    ``checkpoint``)."""
    return dict(
        channels=[int(x) for x in args.channels.split(",")],
        steps=args.steps, batch=args.batch, T=args.frames, h=args.height, w=args.width,
        lr=args.lr, seed=args.seed, data=args.data,
        cue_speed_range=_floats(args.cue_speed), max_onset=args.max_onset,
        move_prob=args.move_prob, cue_slow_range=_floats(args.cue_slow),
        cue_slow_frac=args.slow_frac, onset_hazard=args.onset_hazard,
        ring_speed_range=_floats(args.ring_speed), regime_probs=_floats(args.regime_probs),
        band_prob=args.band_prob, onset_range=_ints(args.onset_range),
        closed_frames=args.closed_frames, closed_weight=args.closed_weight,
        edge_weight=args.edge_weight, ring_onset=args.ring_onset,
        closed_exclude_rings=args.closed_exclude_rings,
        ring_motion_weight=args.ring_motion_weight, ring_dir_cue=args.ring_dir_cue,
        ring_onset_range=_ints(args.ring_onset_range),
        ring_mask_prefix=args.ring_mask_prefix, ring_closed_scale=args.ring_closed_scale,
        cue_period_range=_floats(args.cue_period), tang_radial=args.tang_radial,
        tang_uniform=args.tang_uniform, cue_fine_speed_range=_floats(args.cue_speed_fine),
        cue_fine_max_period=args.cue_fine_max_period, ring_speed_cue=args.ring_speed_cue,
        cue_motion_weight=args.cue_motion_weight, save_every=args.save_every,
        init_weights=args.init_weights or None, device=args.device,
    )


def _out_path(args: argparse.Namespace) -> str:
    channels = [int(x) for x in args.channels.split(",")]
    return args.out or f"prednet_{'_'.join(map(str, channels))}.npz"


def part_path(args: argparse.Namespace) -> Optional[str]:
    """The resumable checkpoint ``main`` writes for these flags, or None
    with ``--save_every 0``: ``<out>.part-<tag>.npz``, the tag a hash of
    every flag but ``--out``, ``--save_every`` and ``--device`` (the JAX
    package's tag for the same flags)."""
    if not args.save_every:
        return None
    recipe = {k: v for k, v in sorted(vars(args).items())
              if k not in ("out", "save_every", "device")}
    tag = hashlib.sha256(repr(recipe).encode()).hexdigest()[:10]
    return f"{_out_path(args)}.part-{tag}.npz"


def main(argv: Optional[list] = None) -> int:
    args = _parser().parse_args(argv)
    resolve_device(args.device)
    out = _out_path(args)
    ckpt = part_path(args)
    params, loss = pretrain(checkpoint=ckpt, **pretrain_kwargs(args))
    save_params(params, out)
    if ckpt and os.path.exists(ckpt):
        os.remove(ckpt)
    print(f"[pretrain] saved {out} (final loss {loss:.5f})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
