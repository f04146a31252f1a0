"""The reference's call contracts, as shims.

The port of the JAX package's ``compat.py``: drop-in signatures for the
three external APIs the reference imports from its submodules, so that
code written against the reference runs unchanged:

* ``test_prednet(...)``: chainer_prednet's file-bus runner.  It reads a
  flat list of frame paths, rolls the predictor over windows of
  ``extension_start`` frames with closed-loop "extension" steps after each
  window, and writes ``%010d.png`` / ``%010d_extended.png`` into
  ``output_dir``;
* ``lucas_kanade(...)``: re-exported from :mod:`.ops.flow.api`;
* ``create_cppn(genome, config, leaf_names, out_names)``: pytorch_neat's
  CPPN builder, one callable per output node, ``node_fn(x=arr, y=arr) ->
  arr``.

These keep the reference's file system data plane; the evolution package
bypasses it.  Each runs on ``device`` (``None`` = the card; ``"cpu"`` must
be asked for).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .models.cppn import evaluate_cppn_levels, pack_population_levels
from .models.prednet.loader import load_or_init
from .models.prednet.model import init_state, prednet_step
from .neat.config import NeatConfig
from .neat.genome import Genome
from .ops.flow.api import lucas_kanade  # noqa: F401  (re-export)
from .utils.image_io import load_image, save_image

__all__ = ["test_prednet", "lucas_kanade", "create_cppn"]


def test_prednet(
    initmodel: str,
    sequence_list: Sequence[Sequence[str]],
    size: Sequence[int],
    channels: Sequence[int],
    gpu: int = 0,
    output_dir: str = "prediction/",
    skip_save_frames: int = 1,
    extension_start: int = 20,
    extension_duration: int = 2,
    reset_at: Optional[int] = None,
    verbose: int = 0,
    c_dim: Optional[int] = None,
    *,
    device=None,
) -> None:
    """File-bus predictor runner with the reference's contract.

    Frames are taken in windows of ``extension_start`` inputs; after each
    window the model runs ``extension_duration`` closed-loop steps; the
    state resets every ``reset_at`` frames.  The reference passes
    ``extension_start + extension_duration``, which isolates the windows,
    so all windows run as one batch; any other ``reset_at`` raises
    ``NotImplementedError``.

    Writes, per global input index g, ``%010d.png`` (the model's prediction
    while it sees input g, numbered consecutively when ``skip_save_frames >
    1``), and per extension step j of the window starting at input w,
    ``%010d_extended.png`` with index w + extension_start + j.  ``gpu``
    and ``verbose`` are accepted for signature parity.
    """
    del gpu, verbose
    w, h = int(size[0]), int(size[1])
    c_dim = int(c_dim if c_dim is not None else channels[0])
    if reset_at is None:
        reset_at = extension_start + extension_duration
    if reset_at != extension_start + extension_duration:
        raise NotImplementedError(
            "shim supports the reference schedule "
            "(reset_at == extension_start + extension_duration)")
    paths = list(sequence_list[0])
    T = extension_start
    if len(paths) % T != 0:
        raise ValueError(f"sequence length {len(paths)} not divisible by "
                         f"extension_start {T}")
    n_win = len(paths) // T
    device = resolve_device(device)

    params = load_or_init(initmodel or None, list(channels), device=device)
    frames = np.stack([load_image(p, size=(w, h), c_dim=c_dim) for p in paths])
    frames = torch.from_numpy(frames.reshape(n_win, T, h, w, c_dim)).to(device)
    with torch.inference_mode():
        state = init_state(n_win, h, w, list(channels), dtype=params[0]["lstm_b"].dtype,
                           device=device)
        preds = []
        for t in range(T):
            state, pred = prednet_step(params, state, frames[:, t])
            preds.append(pred)
        ext = []
        for _ in range(extension_duration):
            state, pred = prednet_step(params, state, pred)
            ext.append(pred)
        preds = torch.stack(preds, dim=1).cpu().numpy()  # (n_win, T, h, w, c)
        ext = torch.stack(ext, dim=1).cpu().numpy() if ext else None

    os.makedirs(output_dir, exist_ok=True)
    saved = 0
    for win in range(n_win):
        for t in range(T):
            if t % skip_save_frames == 0:
                save_image(preds[win, t], os.path.join(output_dir, f"{saved:010d}.png"))
                saved += 1
        for j in range(extension_duration):
            idx = win * T + T + j
            save_image(ext[win, j], os.path.join(output_dir, f"{idx:010d}_extended.png"))


def create_cppn(
    genome: Genome,
    config: NeatConfig,
    leaf_names: Sequence[str] = ("x", "y"),
    out_names: Sequence[str] = (),
    *,
    device=None,
):
    """pytorch_neat-style CPPN builder.

    Returns one callable per genome output; each takes the leaf planes as
    keyword arrays (``node(x=..., y=...)``) and returns the node's values
    as a numpy array of the leaves' shape, computed on ``device``.
    """
    del out_names  # the reference passes [] too
    if len(leaf_names) != config.num_inputs:
        raise ValueError(f"{len(leaf_names)} leaves for {config.num_inputs}-input genome")
    device = resolve_device(device)
    packed = {k: torch.as_tensor(v).to(device)
              for k, v in pack_population_levels([genome], config).items()}

    def make_node(idx: int):
        def node_fn(**leaves):
            flat = torch.stack([
                torch.as_tensor(np.asarray(leaves[n], np.float32).reshape(-1)) for n in leaf_names
            ]).to(device)
            with torch.inference_mode():
                out = evaluate_cppn_levels(packed["weights"], packed["bias"], packed["response"],
                                           packed["act_id"], packed["out_slot"], flat)
            shape = np.shape(list(leaves.values())[0])
            return out[0, idx].cpu().numpy().reshape(shape)

        return node_fn

    return [make_node(i) for i in range(config.num_outputs)]
