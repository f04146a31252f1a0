"""Command-line interface of the port.

The JAX package's ``cli.py`` flag for flag: the reference's 9 flags
(``--model --output_dir --structure --config --checkpoint --size
--color_space --channels --gradient``) with the same defaults and the same
small=160x120 / big=640x480 size presets, the extra knobs and the run
presets, with the same names, short forms and defaults; plus ``--device``
(empty = the card; ``cpu`` must be asked for).  The flags whose values the
port does not implement yet are refused by ``neat_illusion``.

Run as ``python -m evolutionary_illusion_generator_tpu_torch.cli [...]``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .evolution.driver import neat_illusion
from .structure import StructureType

__all__ = ["main", "build_parser", "string_to_intarray"]


def string_to_intarray(string_input: str) -> List[int]:
    """'3,48,96,192' -> [3, 48, 96, 192]."""
    return [int(x) for x in string_input.split(",")]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="generate illusions (PyTorch/CUDA)")
    parser.add_argument("--model", "-m", default="", help=".npz predictor weights (empty = bundled stand-in)")
    parser.add_argument("--output_dir", "-o", default=".", help="path of output directory")
    parser.add_argument(
        "--structure", "-s", default=0, type=int,
        help="Type of illusion. 0: Bands; 1: Circles; 2: Free form; 3: CirclesFree",
    )
    parser.add_argument("--config", "-cfg", default="", help="NEAT config file path or preset name")
    parser.add_argument("--checkpoint", "-cp", help="path of checkpoint to restore")
    parser.add_argument("--size", "-wh", default="small", help="big or small (640x480 / 160x120)")
    parser.add_argument("--color_space", "-c", default=3, type=int, help="1 for greyscale, 3 for rgb")
    parser.add_argument("--channels", "-ch", default="3,48,96,192", help="channels per predictor layer")
    parser.add_argument("--gradient", "-g", default=1, type=int, help="1 to use gradients, 0 for pure colors")
    # extensions of the JAX package
    parser.add_argument("--generations", default=100, type=int, help="max generations per run")
    parser.add_argument("--seed", default=0, type=int, help="run RNG seed")
    parser.add_argument("--checkpoint_every", default=1, type=int, help="checkpoint cadence (reference: 100)")
    parser.add_argument("--score_on_device", action="store_true", help="score fitness on the device (not ported yet)")
    parser.add_argument("--use_pallas", action="store_true", help="accepted, no effect: the port always runs its CUDA kernels")
    parser.add_argument("--microbatch", default=0, type=int, help="population microbatch size (memory bound)")
    parser.add_argument("--preset", default="", help="named run preset; overrides size/structure flags")
    parser.add_argument("--profile_dir", default="", help="write a torch.profiler trace of generation 1 here")
    parser.add_argument("--equilum", action="store_true", help="equiluminant (HSV) rendering")
    parser.add_argument("--pertype_count", default=1, type=int, help="renders per genome, fitness = mean over renders")
    parser.add_argument("--tensorboard", action="store_true", help="write TensorBoard scalars to <output_dir>/tensorboard beside metrics.jsonl")
    parser.add_argument("--chainer_half_order", default="ahat-a", choices=("ahat-a", "a-ahat", "auto"), help="E-unit half convention of an imported Chainer .model snapshot (only ahat-a: the importer is not ported yet)")
    parser.add_argument("--debug_nans", action="store_true", help="sanitizer mode (not ported yet)")
    # the port's own
    parser.add_argument("--device", default="", help="torch device (empty = the CUDA card; 'cpu' must be asked for)")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    common = dict(
        generations=args.generations,
        seed=args.seed,
        score_on_device=args.score_on_device,
        use_pallas=args.use_pallas,
        profile_dir=args.profile_dir or None,
        equilum=args.equilum,
        pertype_count=args.pertype_count,
        tensorboard=args.tensorboard,
        chainer_half_order=args.chainer_half_order,
        debug_nans=args.debug_nans,
        device=args.device or None,
    )

    if args.preset:
        from .configs import run_preset

        rp = run_preset(args.preset)
        kwargs = rp.driver_kwargs()
        kwargs["checkpoint"] = args.checkpoint
        print("run preset", rp.name)
        neat_illusion(
            args.output_dir,
            args.model or None,
            n_devices=rp.n_devices,
            **kwargs,
            **common,
        )
        return 0

    w, h = (640, 480) if args.size == "big" else (160, 120)
    config = args.config if args.config else None

    print("config", config if config else "<auto-selected preset>")
    print("gradient", args.gradient)
    neat_illusion(
        args.output_dir,
        args.model or None,
        config,
        StructureType(args.structure),
        w,
        h,
        string_to_intarray(args.channels),
        args.color_space,
        args.checkpoint,
        args.gradient,
        microbatch=args.microbatch,
        checkpoint_every=args.checkpoint_every,
        **common,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
