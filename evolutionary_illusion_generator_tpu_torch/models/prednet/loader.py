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

The reference's published predictors are Chainer ``.model`` NPZ snapshots;
:func:`load_chainer_model` imports them as the JAX loader does, building
the JAX layout in numpy and handing it to :func:`params_from_numpy`, the
one place that makes port params.  A Chainer snapshot carries spatial
``(H, W, C)`` peepholes on every layer, and a layer with peepholes takes
the plain gate math in ``prednet_step``, never a kernel: the JAX package
keeps such layers off its Pallas kernels too (its ``_apply_gates`` and the
fused route's ``peephole is None`` condition), and has no peephole kernel.
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
from ...utils import prng

__all__ = [
    "PredNetParams",
    "WEIGHTS_DIR",
    "bundled_weights_path",
    "chainer_params_numpy",
    "detect_half_order",
    "init_params_numpy",
    "load_chainer_model",
    "load_or_init",
    "load_params",
    "params_from_numpy",
    "params_to_numpy",
    "save_params",
]

#: Params are lists of per-layer dicts of tensors (the JAX package's alias).
PredNetParams = List[dict]

#: The JAX package's bundled weights, read as data (not imported).
WEIGHTS_DIR = (
    Path(__file__).resolve().parents[3]
    / "evolutionary_illusion_generator_tpu" / "models" / "prednet" / "weights"
)

_CONV_KEYS = ("ahat_w", "a_w")
#: Prefixes of the weights ``model.with_layout_weights`` derives from a
#: layer's own (lifted s2d kernels, subpixel tap pairs); never saved.
DERIVED_PREFIXES = ("s2d_", "sub_")
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


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_numpy(params: Sequence[dict]) -> List[dict]:
    """Port params -> the JAX layout (per-layer dicts of HWIO float32
    numpy arrays), the inverse of :func:`params_from_numpy`."""
    layers = []
    for p in params:
        slices = [p[f"lstm_w_{n}"] for n in ("e", "r", "up") if f"lstm_w_{n}" in p]
        layer = {"lstm_w": np.concatenate([_numpy(w).transpose(2, 3, 1, 0) for w in slices],
                                          axis=2)}
        for k, v in p.items():
            if not k.startswith(("lstm_w_", "lstm_k_") + DERIVED_PREFIXES):
                layer[k] = np.ascontiguousarray(
                    _numpy(v).transpose(2, 3, 1, 0) if k in _CONV_KEYS else _numpy(v))
        layers.append(layer)
    return layers


def save_params(params, path: str, dtype=np.float32) -> None:
    """Write port params as a native ``l{i}/{name}`` NPZ checkpoint in the
    JAX layout (HWIO), which both packages read; ``dtype=np.float16``
    halves the file.  Written atomically (a temporary file, then
    ``os.replace``), so a reader polling ``path`` never sees half a
    file."""
    flat = {f"l{l}/{name}": arr.astype(dtype)
            for l, layer in enumerate(params_to_numpy(params))
            for name, arr in layer.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


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


_HALF_ORDERS = ("ahat-a", "a-ahat")
_PAT_LSTM = re.compile(r"(?i)(?:^|/)conv_?lstm_?(\d+)/(w[xhc][ifco]\d*)/(W|b)$")
_PAT_P = re.compile(r"(?i)(?:^|/)conv_?p_?(\d+)/(W|b)$")
_PAT_A = re.compile(r"(?i)(?:^|/)conv_?a_?(\d+)/(W|b)$")


def _swap_e_halves(w: np.ndarray, C: int) -> np.ndarray:
    """Swap the first two C-channel input blocks of an HWIO conv weight."""
    return np.concatenate([w[:, :, C:2 * C], w[:, :, :C], w[:, :, 2 * C:]], axis=2)


def chainer_params_numpy(path: str, channels: Sequence[int],
                         half_order: str = "ahat-a") -> List[dict]:
    """A Chainer PredNet NPZ snapshot (or a native checkpoint) -> params in
    the JAX layout, per-layer dicts of HWIO float32 numpy arrays.

    The JAX ``load_chainer_model``'s import, step for step:

    * links ``ConvLSTM{l}/Wx{g}{n}/W|b`` (gate g in i, f, c, o; source
      n = 0 for E_l, 2C channels, and n = 1 below the top for the upsampled
      R_{l+1}), ``ConvLSTM{l}/Wh{g}/W`` (on R_l, no bias),
      ``ConvLSTM{l}/Wc{g}/W`` (spatial peepholes, g in i, f, o),
      ``ConvP{l}/W|b`` (Ahat) and ``ConvA{l}/W|b`` (A, l < L-1), matched
      case-insensitively after any trainer prefix (``predictor/``,
      ``updater/model:main/``, ...); un-numbered ``Wx{g}`` links over the
      concatenated input are taken too;
    * OIHW -> HWIO; one (k, k, 2C + C + C_above, 4C) gate conv per layer,
      input slices [E_l, R_l, up(R_{l+1})], gate order (i, f, o, c), the
      ``Wx*0`` and ``Wx*1`` biases summed;
    * ``half_order="a-ahat"``: the snapshot was trained with E =
      [ReLU(A - Ahat), ReLU(Ahat - A)], so the E halves of the gate conv and
      of ``ConvA`` are swapped into this package's order;
    * peepholes (batch, C, H, W) -> (H, W, C), all three or none.

    Raises ``ValueError`` naming the first missing link, a shape that does
    not fit ``channels``, or a file that holds no PredNet links.
    """
    if half_order not in _HALF_ORDERS:
        raise ValueError(
            f"half_order must be 'ahat-a', 'a-ahat' or 'auto', got {half_order!r}")
    data = np.load(path, allow_pickle=False)
    keys = sorted(data.files)
    if keys and all(re.match(r"l\d+/", k) for k in keys):
        return _read_npz(path)

    index = {}
    for k in keys:
        m = _PAT_LSTM.search(k)
        if m:
            index[("lstm", int(m.group(1)), m.group(2).lower(), m.group(3))] = k
            continue
        for kind, pat in (("p", _PAT_P), ("a", _PAT_A)):
            m = pat.search(k)
            if m:
                index[(kind, int(m.group(1)), "", m.group(2))] = k
                break
    if not index:
        raise ValueError(
            f"{path!r} is neither a native PredNet checkpoint nor a Chainer "
            f"PredNet snapshot (no ConvLSTM*/ConvP*/ConvA* links); keys: {keys[:20]}...")

    def to_hwio(w):
        return np.transpose(np.asarray(w, np.float32), (2, 3, 1, 0))

    def get(kind, l, link="", param="W", required=True):
        key = index.get((kind, l, link, param))
        if key is None:
            if required:
                raise ValueError(
                    f"Chainer PredNet snapshot {path!r} is missing "
                    f"{kind}{l}/{link or ''}/{param} for channel stack {list(channels)}; "
                    f"found links: {sorted(set(i[:3] for i in index))[:30]}")
            return None
        return np.asarray(data[key], np.float32)

    L = len(channels)
    layers = []
    for l in range(L):
        C = channels[l]
        c_above = channels[l + 1] if l + 1 < L else 0
        wxi0 = get("lstm", l, "wxi0", "W", required=False)
        bare = wxi0 is None  # un-numbered Wx* convs over the concatenated input
        if bare:
            wxi0 = get("lstm", l, "wxi", "W")
        kh, kw = wxi0.shape[2], wxi0.shape[3]
        lstm_w = np.zeros((kh, kw, 3 * C + c_above, 4 * C), np.float32)
        lstm_b = np.zeros((4 * C,), np.float32)
        for gi, g in enumerate(("i", "f", "o", "c")):
            sl = slice(gi * C, (gi + 1) * C)
            if bare:
                wx = to_hwio(get("lstm", l, f"wx{g}", "W"))
                if wx.shape[2] not in (2 * C, 2 * C + c_above):
                    raise ValueError(f"ConvLSTM{l}/Wx{g} input width {wx.shape[2]} does "
                                     f"not match channels {list(channels)}")
                lstm_w[:, :, :2 * C, sl] = wx[:, :, :2 * C]
                if wx.shape[2] == 2 * C + c_above and c_above:
                    lstm_w[:, :, 3 * C:, sl] = wx[:, :, 2 * C:]
                b = get("lstm", l, f"wx{g}", "b", required=False)
            else:
                wx0 = to_hwio(get("lstm", l, f"wx{g}0", "W"))
                if wx0.shape != (kh, kw, 2 * C, C):
                    raise ValueError(
                        f"ConvLSTM{l}/Wx{g}0 shape {wx0.shape[::-1]} does not match "
                        f"channels {list(channels)} (expected in={2 * C}, out={C})")
                lstm_w[:, :, :2 * C, sl] = wx0
                b = get("lstm", l, f"wx{g}0", "b", required=False)
                if c_above:
                    lstm_w[:, :, 3 * C:, sl] = to_hwio(get("lstm", l, f"wx{g}1", "W"))
                    b1 = get("lstm", l, f"wx{g}1", "b", required=False)
                    if b1 is not None:
                        lstm_b[sl] += b1
            if b is not None:
                lstm_b[sl] += b
            wh = get("lstm", l, f"wh{g}", "W", required=False)
            if wh is not None:
                lstm_w[:, :, 2 * C:3 * C, sl] = to_hwio(wh)
        if half_order == "a-ahat":
            lstm_w = _swap_e_halves(lstm_w, C)
        layer = {"lstm_w": lstm_w, "lstm_b": lstm_b}

        peeps = {}
        for g, name in (("i", "w_ci"), ("f", "w_cf"), ("o", "w_co")):
            wc = get("lstm", l, f"wc{g}", "W", required=False)
            if wc is not None:
                wc = wc.reshape(wc.shape[-3:])  # drop the batch axis
                peeps[name] = np.ascontiguousarray(np.transpose(wc, (1, 2, 0)))
        if peeps and len(peeps) != 3:
            raise ValueError(f"ConvLSTM{l} has a partial peephole set {sorted(peeps)}; "
                             f"expected Wci/Wcf/Wco")
        layer.update(peeps)

        ahat_w = get("p", l)
        if ahat_w.shape[:2] != (C, C):
            raise ValueError(f"ConvP{l} shape {ahat_w.shape} does not match channels "
                             f"{list(channels)} (expected out=in={C})")
        layer["ahat_w"] = to_hwio(ahat_w)
        ahat_b = get("p", l, "", "b", required=False)
        layer["ahat_b"] = ahat_b if ahat_b is not None else np.zeros((C,), np.float32)
        if c_above:
            a_w = get("a", l)
            if a_w.shape[:2] != (c_above, 2 * C):
                raise ValueError(f"ConvA{l} shape {a_w.shape} does not match channels "
                                 f"{list(channels)} (expected in={2 * C}, out={c_above})")
            a_w = to_hwio(a_w)
            layer["a_w"] = _swap_e_halves(a_w, C) if half_order == "a-ahat" else a_w
            a_b = get("a", l, "", "b", required=False)
            layer["a_b"] = a_b if a_b is not None else np.zeros((c_above,), np.float32)
        layers.append(layer)
    return layers


def load_chainer_model(path: str, channels: Sequence[int], dtype=torch.bfloat16,
                       half_order: str = "ahat-a", device=None) -> List[dict]:
    """Import a Chainer PredNet NPZ snapshot as port params on ``device``
    (:func:`chainer_params_numpy`, then :func:`params_from_numpy`).

    ``half_order`` is the E-unit half convention of the snapshot:
    ``"ahat-a"`` (this package's, imported as it is), ``"a-ahat"`` (the E
    halves swapped on import) or ``"auto"`` (:func:`detect_half_order`
    decides)."""
    if half_order == "auto":
        half_order, _ = detect_half_order(path, channels, device=device)
    return params_from_numpy(chainer_params_numpy(path, channels, half_order), dtype, device)


def detect_half_order(path: str, channels: Sequence[int], device=None):
    """Decide a Chainer snapshot's E-unit half order by experiment, as the
    JAX function does: import it both ways (float32) and run six open-loop
    steps of the port's ``rollout`` on ``device`` over a static test frame
    (a smooth gradient plus rings).  A trained predictor reconstructs the
    frame far worse with its E halves scrambled.  Returns ``(best_order,
    {order: mean_abs_error})``; errors within 2% keep ``"ahat-a"``."""
    from .model import rollout

    device = resolve_device(device)
    c0, L = channels[0], len(channels)
    h = w = max(8 * (2 ** max(L - 1, 0)), 32)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    rr = np.hypot(yy - 0.5, xx - 0.5)
    img = 0.5 + 0.25 * np.sin(2 * np.pi * 5 * rr) + 0.25 * (xx - 0.5)
    frame = np.clip(img, 0.0, 1.0).astype(np.float32)
    frame = np.repeat(frame[..., None], c0, axis=-1)[None]
    frame_t = torch.from_numpy(frame).to(device)

    errs = {}
    for order in _HALF_ORDERS:
        params = load_chainer_model(path, channels, torch.float32, order, device)
        with torch.inference_mode():
            out = rollout(params, frame_t, repeat=6, extension=0, collect=(5,))
        pred = out["predictions"][5].cpu().numpy()
        errs[order] = float(np.mean(np.abs(pred - frame)))
    best = min(errs, key=errs.get)
    if errs[best] > 0.98 * errs["ahat-a"]:
        best = "ahat-a"
    return best, errs


def bundled_weights_path(channels: Sequence[int]) -> Optional[str]:
    """Path of the bundled stand-in weights for a channel stack, or None."""
    name = f"prednet_{'_'.join(str(c) for c in channels)}.npz"
    path = WEIGHTS_DIR / name
    return str(path) if path.exists() else None


def init_params_numpy(channels: Sequence[int] = (3, 48, 96, 192), seed: int = 0,
                      kernel: int = 3) -> List[dict]:
    """Seeded random params in the JAX layout (HWIO float32 numpy).

    The same shapes and scaling as the JAX ``init_params``
    (normal / sqrt(fan_in) weights, zero biases), drawn from numpy's
    generator: a fixture that tests hand to both packages.  The port's own
    seeded params (:func:`load_or_init`) are JAX's draw."""
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
                 dtype=torch.bfloat16, half_order: str = "ahat-a",
                 device=None) -> List[dict]:
    """Load a model file if given: a native NPZ checkpoint, else (on its
    ``ValueError``) a Chainer snapshot imported with ``half_order``; without
    one, the bundled stand-in weights for this channel stack if shipped;
    else seeded random params drawn as the JAX ``load_or_init`` draws them
    (:func:`.model.init_params` from ``PRNGKey(seed)``)."""
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        try:
            return load_params(path, dtype, device)
        except ValueError:
            return load_chainer_model(path, channels, dtype, half_order, device)
    bundled = bundled_weights_path(channels)
    if bundled:
        return load_params(bundled, dtype, device)
    from .model import init_params  # model imports this module
    return init_params(prng.PRNGKey(seed), channels, dtype=dtype, device=device)
