"""The kernel-bisection ladder on the card.

The port's counterpart of the JAX package's ``scripts/pallas_bisect.py``:
the same conv + gates function of one ConvLSTM layer computed several ways,
each run once against the plain reference and then timed::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.kernel_bisect \\
        [--variants ABXCDHEF] [--big] [--rows 32] [--device cpu]

  A  elementwise kernel, c_prev * 2                   (sanity)
  B  F.conv2d + the gates kernel (ops/convlstm_gates)
  C  conv kernel to gates, then plain gate math       (the 9 shifted dots; wgmma)
  D  C + fused gate math in the same kernel (wgmma)
  H  D over row blocks of a materialised window stack (wgmma)
  E  D over row blocks of the padded input, read in place (wgmma)
  I  H with windows of the aligned width ceil16(W + 2) (wgmma)
  J  E with the padded width ceil16(W + 2) (wgmma)
  F  the main path's fused kernel (ops/convlstm_fused)
  X  the plain PyTorch reference

``--big`` is the north-star layer-1 shape (B=25, 240x320, Cin=240, C=48);
the default is B=4, 64x128, Cin=64, C=16.  The inputs come from
``np.random.default_rng(0)`` in the reference script's order, so both
ladders see the same arrays.  A rung fails when it raises or its h differs
from X's by more than ``H_TOL`` (A: when it is not exactly 2 * c_prev); the
run then raises after the last rung, so the command exits non-zero.
Without ``--device cpu`` it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time
import traceback

import numpy as np
import torch

from .._device import resolve_device
from ..ops import convlstm_bisect as cb
from ..ops.convlstm_fused import fused_convlstm_layer, gate_conv_plain, pack_gate_weight
from ..ops.convlstm_gates import fused_lstm_gates

__all__ = ["VARIANTS", "make_inputs", "run_variant", "main"]

BIG_SHAPE = (25, 240, 320, 240, 48)  # B, H, W, Cin, C
DEFAULT_SHAPE = (4, 64, 128, 64, 16)
# h against X: the fused rungs round h to bfloat16, one ulp is 2**-8 at |h| < 1
H_TOL = 1e-2
LOOP_OPS = 10  # ops per timed loop, each feeding its c back as c_prev
REPS = 5       # timed loops per rung


def variant_B(x, w, b, c_prev):
    """The library conv (float32 of the bfloat16 values: exact products,
    TF32 or not) and the gates kernel: (h, c) float32."""
    return fused_lstm_gates(gate_conv_plain([x], [pack_gate_weight(w)], b), c_prev)


def variant_F(x, w, b, c_prev):
    """The main path's fused conv + gates kernel: (h in ``c_prev``'s
    dtype, c float32)."""
    return fused_convlstm_layer(x.to(torch.bfloat16), pack_gate_weight(w), b, c_prev)


VARIANTS = {
    "A": cb.variant_A,
    "B": variant_B,
    "C": cb.variant_C,
    "D": cb.variant_D,
    "H": cb.variant_H,
    "E": cb.variant_E,
    "I": cb.variant_H2,
    "J": cb.variant_E2,
    "F": variant_F,
    "X": cb.reference,
}
ROW_BLOCK_KEYS = "HEIJ"


def make_inputs(shape, device):
    """``(x, w, b, c_prev)`` in bfloat16 from ``np.random.default_rng(0)``,
    drawn in the reference script's order."""
    B, H, W, Cin, C = shape
    rng = np.random.default_rng(0)
    draws = [(0, 1, (B, H, W, Cin)), (0, 0.05, (3, 3, Cin, 4 * C)),
             (0, 0.1, (4 * C,)), (0, 1, (B, H, W, C))]
    return [torch.from_numpy(rng.normal(*d)).to(torch.bfloat16).to(device) for d in draws]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_loop(fn, args, device):
    """Mean ms per op over REPS loops of LOOP_OPS ops after one warm loop:
    CUDA events on the card, the host clock on the CPU."""
    x, w, b, c_prev = args

    def loop():
        carry = c_prev
        for _ in range(LOOP_OPS):
            _, c = fn(x, w, b, carry)
            carry = c.to(c_prev.dtype)

    loop()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(REPS):
            loop()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / (REPS * LOOP_OPS)
    t0 = time.perf_counter()
    for _ in range(REPS):
        loop()
    return (time.perf_counter() - t0) * 1e3 / (REPS * LOOP_OPS)


def run_variant(name, fn, args, want, device):
    """One rung: first call (with the kernels' build, if it is the first),
    check, timing.  Returns a dict with ``ok``, ``build_s``, ``err`` and
    ``ms`` (None where the rung failed before)."""
    res = dict(ok=False, build_s=None, err=None, ms=None)
    t0 = time.time()
    try:
        h = fn(*args)[0]
        _sync(device)
    except Exception:  # noqa: BLE001 -- the ladder reports every rung
        print(f"[{name}] FAILED")
        traceback.print_exc(limit=3)
        return res
    res["build_s"] = time.time() - t0
    ref = args[3].float() * 2 if name == "A" else want
    err = (h.float() - ref).abs().max().item() if torch.isfinite(h).all() else float("inf")
    res["err"] = err
    if not (err == 0.0 if name == "A" else err <= H_TOL):
        print(f"[{name}] FAILED: max|dh|={err:.2e}")
        return res
    res["ms"] = _time_loop(fn, args, device)
    res["ok"] = True
    print(f"[{name}] ok build={res['build_s']:.1f}s max|dh|={err:.2e} "
          f"time/op={res['ms']:.3f} ms", flush=True)
    return res


def main(argv=None):
    """Run the ladder; returns ``{key: result}`` (see :func:`run_variant`;
    B's also its gate kernel launches by body, ``"bodies"``) and raises
    ``RuntimeError`` after the last rung if any rung failed."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default="ABXCDHEF",
                   help=f"rung keys to run, any of {''.join(VARIANTS)}")
    p.add_argument("--big", action="store_true",
                   help="north-star layer-1 shape (B=25, 240x320, Cin=240, C=48)")
    p.add_argument("--rows", type=int, default=32,
                   help="row-block height of H, E, I and J; must divide H")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain versions; default: the CUDA card")
    args = p.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        p.error(f"unknown variants {unknown}; choose from {''.join(VARIANTS)}")

    device = resolve_device(args.device)
    shape = BIG_SHAPE if args.big else DEFAULT_SHAPE
    inputs = make_inputs(shape, device)
    B, H, W, Cin, C = shape
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={device} ({name}) shape B{B} {H}x{W} Cin{Cin} C{C} rows={args.rows}",
          flush=True)

    want = cb.reference(*inputs)[0]
    results = {}
    for key in args.variants:
        fn = VARIANTS[key]
        if key in ROW_BLOCK_KEYS:
            fn = lambda x, w, b, c, _fn=fn: _fn(x, w, b, c, rows=args.rows)  # noqa: E731
        before = dict(fused_lstm_gates.body_launches)
        results[key] = run_variant(key, fn, inputs, want, device)
        if key == "B":  # the gate kernel's launches by body (none on the CPU)
            results[key]["bodies"] = {b: n - before[b] for b, n in
                                      fused_lstm_gates.body_launches.items() if n != before[b]}
            print(f"[B] gate kernel launches by body {results[key]['bodies']}", flush=True)
    failed = [k for k, r in results.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"rungs failed: {''.join(failed)}")
    return results


if __name__ == "__main__":
    main()
