"""PredNet weight IO for the port.

The JAX package stores PredNet weights as NPZ files with ``l{i}/{name}``
keys in HWIO layout (float16 for the bundled stand-ins).  The port reads the
same files — the bundled ones from the JAX package's weights directory, as
data, by path — and converts them with :func:`params_from_numpy`.

Port params are a list of per-layer dicts of tensors:

* ``lstm_w_e`` / ``lstm_w_r`` / ``lstm_w_up`` — the gate conv split at its
  input slices ``[E 2C | R C | R_above C_{l+1}]``, OIHW, for the split
  ``F.conv2d`` path of narrow layers (``lstm_w_up`` below the top only);
* ``lstm_k_e`` / ``lstm_k_r`` / ``lstm_k_up`` — the same slices in the fused
  CUDA kernel's bfloat16 ``(Cin, 9, C, 4)`` layout
  (:func:`..ops.convlstm_fused.pack_gate_weight`);
* ``lstm_b``, ``ahat_w`` (OIHW) / ``ahat_b``, ``a_w`` (OIHW) / ``a_b``
  (below the top), and the peepholes ``w_ci`` / ``w_cf`` / ``w_co`` where
  the source has them.

The Chainer ``.model`` importer of the JAX loader is not ported yet.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..._device import resolve_device
from ...ops.convlstm_fused import pack_gate_weight

__all__ = [
    "WEIGHTS_DIR",
    "bundled_weights_path",
    "init_params_numpy",
    "load_or_init",
    "load_params",
    "params_from_numpy",
]

#: The JAX package's bundled weights, read as data (not imported).
WEIGHTS_DIR = (
    Path(__file__).resolve().parents[3]
    / "evolutionary_illusion_generator_tpu" / "models" / "prednet" / "weights"
)

_CONV_KEYS = ("ahat_w", "a_w")
_PEEPHOLE_KEYS = ("w_ci", "w_cf", "w_co")


def _oihw(w_hwio: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))).to(
        device=device, dtype=dtype
    )


def params_from_numpy(layers: Sequence[dict], dtype=torch.bfloat16,
                      device=None) -> List[dict]:
    """JAX-layout params (per-layer dicts of HWIO numpy arrays, any float
    dtype including ``ml_dtypes.bfloat16``) -> port params on ``device``
    (``None`` means the card)."""
    device = resolve_device(device)
    params = []
    for layer in layers:
        arrs = {k: np.asarray(v, dtype=np.float32) for k, v in layer.items()}
        C = arrs["ahat_w"].shape[2]
        lstm = arrs["lstm_w"]
        slices = {"e": lstm[:, :, : 2 * C], "r": lstm[:, :, 2 * C : 3 * C]}
        if lstm.shape[2] > 3 * C:
            slices["up"] = lstm[:, :, 3 * C :]
        p = {}
        for name, w in slices.items():
            p[f"lstm_w_{name}"] = _oihw(w, dtype, device)
            p[f"lstm_k_{name}"] = pack_gate_weight(torch.from_numpy(w)).to(device)
        p["lstm_b"] = torch.from_numpy(arrs["lstm_b"]).to(device=device, dtype=dtype)
        for k in _CONV_KEYS:
            if k in arrs:
                p[k] = _oihw(arrs[k], dtype, device)
                bk = k[:-1] + "b"
                p[bk] = torch.from_numpy(arrs[bk]).to(device=device, dtype=dtype)
        for k in _PEEPHOLE_KEYS:
            if k in arrs:
                p[k] = torch.from_numpy(arrs[k]).to(device=device, dtype=dtype)
        params.append(p)
    return params


def _read_npz(path) -> List[dict]:
    data = np.load(path)
    layers: dict = {}
    for key in data.files:
        m = re.match(r"l(\d+)/(.+)", key)
        if not m:
            raise ValueError(f"not a native PredNet checkpoint (key {key!r})")
        layers.setdefault(int(m.group(1)), {})[m.group(2)] = data[key]
    return [layers[l] for l in sorted(layers)]


def load_params(path, dtype=torch.bfloat16, device=None) -> List[dict]:
    """Load a native ``l{i}/{name}`` NPZ checkpoint."""
    return params_from_numpy(_read_npz(path), dtype, device)


def bundled_weights_path(channels: Sequence[int]) -> Optional[str]:
    """Path of the bundled stand-in weights for a channel stack, or None."""
    name = f"prednet_{'_'.join(str(c) for c in channels)}.npz"
    path = WEIGHTS_DIR / name
    return str(path) if path.exists() else None


def init_params_numpy(channels: Sequence[int] = (3, 48, 96, 192), seed: int = 0,
                      kernel: int = 3) -> List[dict]:
    """Seeded random params in the JAX layout (HWIO float32 numpy).

    The same shapes and scaling as the JAX ``init_params``
    (normal / sqrt(fan_in) weights, zero biases), drawn from numpy: the two
    frameworks' generators give different numbers for one seed, so tests
    hand these arrays to both."""
    rng = np.random.default_rng(seed)
    L = len(channels)

    def conv(cin, cout):
        fan_in = kernel * kernel * cin
        w = rng.standard_normal((kernel, kernel, cin, cout)) / np.sqrt(fan_in)
        return w.astype(np.float32)

    layers = []
    for l, C in enumerate(channels):
        in_ch = 3 * C + (channels[l + 1] if l + 1 < L else 0)
        layer = {
            "lstm_w": conv(in_ch, 4 * C),
            "lstm_b": np.zeros(4 * C, np.float32),
            "ahat_w": conv(C, C),
            "ahat_b": np.zeros(C, np.float32),
        }
        if l + 1 < L:
            layer["a_w"] = conv(2 * C, channels[l + 1])
            layer["a_b"] = np.zeros(channels[l + 1], np.float32)
        layers.append(layer)
    return layers


def load_or_init(path: Optional[str], channels: Sequence[int], seed: int = 0,
                 dtype=torch.bfloat16, device=None) -> List[dict]:
    """Load a native NPZ model file if given; else the bundled stand-in
    weights for this channel stack if shipped; else seeded random params
    (:func:`init_params_numpy`)."""
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return load_params(path, dtype, device)
    bundled = bundled_weights_path(channels)
    if bundled:
        return load_params(bundled, dtype, device)
    return params_from_numpy(init_params_numpy(channels, seed), dtype, device)
