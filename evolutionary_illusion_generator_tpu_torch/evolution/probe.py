"""Single-image probes.

The port of the JAX package's ``evolution/probe.py``:

* ``get_vectors(image_path, model_name, channels, w, h)``: the reference's
  single-image pipeline: the image 20 times and 2 closed-loop extension
  frames through the predictor, then flow between the INPUT image and the
  second extension frame (the probe's flow pair);
* the ``test.py`` CLI probe: image -> vectors -> swarm score on stdout;
* the notebook's single-image scoring: LANCZOS resize and white padding to
  the target size (``pad_to_size``), then ``calculate_fitness``.

Entry points run on the card unless ``device="cpu"`` (``--device cpu``) is
asked for.  Run as
``python -m evolutionary_illusion_generator_tpu_torch.evolution.probe``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..models.prednet.loader import load_or_init
from ..models.prednet.model import quantize_params_int8, rollout_flow_frames
from ..ops.fitness.calculate import calculate_fitness
from ..ops.fitness.metrics_np import swarm_score
from ..ops.flow.api import FlowConfig, flow_vectors
from ..ops.flow.pyramid import to_gray
from ..structure import StructureType
from ..utils.image_io import load_image
from ..utils.resample import lanczos_resize

__all__ = ["get_vectors", "score_image", "pad_to_size", "main"]


def _png_quantize(x: np.ndarray) -> np.ndarray:
    """The reference's PNG bus numerics: uint8 truncation on save, then /255
    on load.  On the host, in numpy, as the file bus divides: CUDA divides
    a tensor by a scalar as a product with its reciprocal, which is not
    always the correctly rounded quotient ``k / 255`` that a PNG read
    gives."""
    x = np.asarray(x, np.float32)
    return np.floor(np.clip(x, 0.0, 1.0) * 255.0).astype(np.float32) / 255.0


def get_vectors(
    image_path: str,
    model_name: Optional[str],
    channels: Sequence[int] = (3, 48, 96, 192),
    w: int = 160,
    h: int = 120,
    *,
    repeat: int = 20,
    extension: int = 2,
    flow: FlowConfig = FlowConfig(),
    seed: int = 0,
    quantize: bool = True,
    int8: bool = False,
    s2d: bool = False,
    device=None,
) -> np.ndarray:
    """Flow vectors for one image through the probe pipeline, on ``device``.

    ``quantize=True`` (default) puts both flow frames through the uint8 PNG
    round trip before the flow stage, as the reference computes flow between
    files on disk; with it this function equals the ``compat.test_prednet``
    + ``lucas_kanade`` file bus.  ``int8=True`` runs the predictor on its
    int8-quantized weights (``quantize_params_int8``), ``s2d=True`` its
    pixel layer in space-to-depth layout (``s2d_l0``), as the JAX probe does.

    Returns an (N, 4) numpy array of [x, y, dx, dy] rows (empty when nothing
    was trackable).
    """
    device = resolve_device(device)
    params = load_or_init(model_name, list(channels), seed=seed, device=device)
    if int8:
        params = quantize_params_int8(params)
    img = load_image(image_path, size=(w, h), c_dim=channels[0])
    with torch.inference_mode():
        f0, f1 = rollout_flow_frames(params, torch.from_numpy(img)[None].to(device),
                                     repeat=repeat, extension=extension, pair="probe",
                                     s2d_l0=s2d)
        if quantize:
            f0, f1 = (torch.from_numpy(_png_quantize(f.cpu().numpy())).to(device)
                      for f in (f0, f1))
        vec, mask = flow_vectors(to_gray(f0), to_gray(f1), flow)
    return vec[0][mask[0]].cpu().numpy()


def pad_to_size(image: np.ndarray, w: int = 160, h: int = 120) -> np.ndarray:
    """LANCZOS resize keeping the aspect ratio, then white padding to
    exactly (w, h): the notebook's preprocessing.  Takes and returns an
    (H, W, 3) uint8 array."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"pad_to_size takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    ih, iw = image.shape[:2]
    scale = min(w / iw, h / ih)
    nw, nh = int(round(iw * scale)), int(round(ih * scale))
    canvas = np.full((h, w, 3), 255, np.uint8)
    x0, y0 = (w - nw) // 2, (h - nh) // 2
    canvas[y0:y0 + nh, x0:x0 + nw] = lanczos_resize(image, (nw, nh))
    return canvas


def score_image(
    image_path: str,
    structure: int = StructureType.Circles,
    model_name: Optional[str] = None,
    channels: Sequence[int] = (3, 48, 96, 192),
    w: int = 160,
    h: int = 120,
    **kwargs,
) -> float:
    """The notebook's single-image score: :func:`get_vectors` (``kwargs``
    go to it, ``device`` among them), then ``calculate_fitness``."""
    vectors = get_vectors(image_path, model_name, channels, w, h, **kwargs)
    if vectors.size == 0:
        return 0.0
    return calculate_fitness(structure, vectors, image_path, w, h)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="single-image probe")
    parser.add_argument("--model", "-m", default="", help=".model/.npz file")
    parser.add_argument("--input_image", "-i", default="")
    parser.add_argument("--structure", "-s", type=int, default=None,
                        help="also print the structure fitness score")
    parser.add_argument("--channels", "-ch", default="3,48,96,192",
                        help="predictor channel stack (extension; the "
                        "reference's test.py is fixed to the color stack)")
    parser.add_argument("--int8", action="store_true",
                        help="int8-quantized predictor convs (extension)")
    parser.add_argument("--s2d", action="store_true",
                        help="space-to-depth pixel layer (extension)")
    parser.add_argument("--device", default="",
                        help="torch device (empty = the CUDA card; 'cpu' must be asked for)")
    args = parser.parse_args(argv)

    channels = tuple(int(x) for x in args.channels.split(","))
    vectors = get_vectors(args.input_image, args.model or None, channels,
                          int8=args.int8, s2d=args.s2d, device=args.device or None)
    if vectors.size == 0:
        print("score", 0.0)
        return 0
    print("score", swarm_score(vectors))
    if args.structure is not None:
        print("fitness", calculate_fitness(args.structure, vectors, args.input_image, 160, 120))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
