"""PredNet training (predictive-coding objective), in PyTorch.

The port of the JAX package's ``models/prednet/train.py``: the Lotter
E-activity objective (:func:`prednet_loss`), its closed-loop extension with
the ring, edge and cue terms (:func:`prednet_seq_loss`), and an Adam train
step (:func:`make_train_step`) with the JAX step's arities and errors.

The losses run ``prednet_step(use_pallas=False)``: split per-source convs
and the plain gate math, which autograd differentiates (the JAX trainer
differentiates the same route; its Pallas kernels have no VJP, and the
port's kernel wrappers refuse a gradient).  No CUDA kernel of the port
runs here.

Each step rebuilds a float32 master from the stored params (bfloat16 in
``pretrain``), takes the loss and its gradients in float32, applies
optax's Adam to the master and casts the result back to the params'
dtype, as the JAX step does.  The optimizer state lives on that float32
master.  Nothing else persists between steps: an update smaller than the
params' rounding is lost, as in JAX, which a torch optimizer keeping its
own float32 master would not do.

Port params carry the fused kernel's packed gate weights (``lstm_k_*``)
beside the trained OIHW slices (``lstm_w_*``), and bfloat16 params the A
and Ahat units' (``ahat_k``, ``a_k``); they are not trained, and the step
packs them anew from the updated weights, so the params it returns run on
the kernel route too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..._device import device_context
from ...ops.convlstm_fused import pack_gate_weight
from ...parallel.distributed import gather_entries, process_count, sum_in_order
from ...parallel.mesh import replicate, shard_leading
from .loader import PACKED_PREFIXES, pack_unit_weights
from .model import init_state, prednet_step

__all__ = [
    "Adam",
    "adam",
    "prednet_loss",
    "prednet_seq_loss",
    "make_train_step",
    "init_opt_state",
    "trainable",
    "whole_batch",
]

_PACKED = "lstm_k_"  # the gate conv's packed slices


def trainable(params) -> list:
    """The trained leaves of port params: every entry but the packed
    kernel weights, per layer."""
    return [{k: v for k, v in layer.items() if not k.startswith(PACKED_PREFIXES)}
            for layer in params]


def _layer_weights(L, layer_weights, device):
    if layer_weights is None:
        layer_weights = [1.0] + [0.1] * (L - 1)
    return torch.tensor(layer_weights, dtype=torch.float32, device=device)


def _channels(params):
    return [p["ahat_w"].shape[0] for p in params]


def prednet_loss(params, frames, *, layer_weights: Optional[Sequence[float]] = None,
                 skip_first: bool = True, whole: Optional[dict] = None):
    """Mean weighted E-unit activity over a (B, T, H, W, C0) frame sequence
    in [0, 1].

    ``layer_weights`` defaults to Lotter's [1, 0.1, 0.1, ...]; the first
    timestep is excluded (zero-state prediction is uninformative).
    ``whole`` (:func:`whole_batch`) makes ``frames`` one shard of a larger
    batch: the result is then this shard's part of the whole batch's loss,
    and the shards' parts add up to it."""
    B, T, H, W, C0 = frames.shape
    L = len(params)
    lw = _layer_weights(L, layer_weights, frames.device)
    state = init_state(B, H, W, _channels(params), dtype=params[0]["lstm_b"].dtype,
                       device=frames.device)
    losses = []
    for t in range(T):
        state, _ = prednet_step(params, state, frames[:, t], use_pallas=False)
        errs = torch.stack([state[l]["e"].float().mean() for l in range(L)])
        losses.append((errs * lw).sum())
    start = 1 if skip_first else 0
    loss = torch.stack(losses[start:]).mean()
    if whole is not None:  # the per-step means are over this shard's B
        loss = loss * (B / whole["batch"])
    return loss


def _spatial_grads(x):
    """Finite-difference spatial gradients of (B, H, W, C) images."""
    return x[:, 1:] - x[:, :-1], x[:, :, 1:] - x[:, :, :-1]


def _seq_mean(x):  # (B, ...) -> (B,)
    return x.flatten(1).mean(dim=1)


def _norm_weights(mask, B, device, total=None):
    """Per-sequence weights: ``mask`` (``None``: all 1) over its sum, or
    over ``total``, the sum over the whole batch of which this is a shard."""
    m = (torch.ones(B, dtype=torch.float32, device=device) if mask is None
         else mask.to(torch.float32))
    return m / torch.clamp(m.sum() if total is None else total, min=1e-6)


def whole_batch(B: int, closed_mask=None, open_mask=None, cue_motion_mask=None,
                device=None) -> dict:
    """The sums over a whole batch that normalise the losses, for computing
    them shard by shard (the ``whole`` argument of :func:`prednet_loss`
    and :func:`prednet_seq_loss`): the batch size, and the sums of the
    closed mask (all 1 without one), of its complement (the motion hinge's
    mask), of the open mask past the zero-state step, and of the cue mask.
    float32 0-dim tensors on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    m = torch.ones(B, **f32) if closed_mask is None else closed_mask.to(**f32)
    out = {"batch": torch.tensor(float(B), **f32), "closed": m.sum(), "motion": (1.0 - m).sum()}
    if open_mask is not None:
        out["open"] = open_mask.to(**f32)[:, 1:].sum()
    if cue_motion_mask is not None:
        out["cue"] = cue_motion_mask.to(**f32).sum()
    return out


def prednet_seq_loss(params, frames, *, t_open: int, closed_weight: float = 5.0,
                     edge_weight: float = 0.0,
                     layer_weights: Optional[Sequence[float]] = None,
                     closed_mask=None, motion_weight: float = 0.0, motion_mask=None,
                     open_mask=None, cue_motion_weight: float = 0.0,
                     cue_motion_mask=None, whole: Optional[dict] = None):
    """Open-loop E-loss on ``frames[:, :t_open]``, then the model's own
    prediction fed back for the remaining ``T - t_open`` frames, each
    closed-loop prediction paying ``closed_weight`` times an L1 pixel loss
    against the true continuation (plus ``edge_weight`` times the L1 of its
    spatial finite differences).

    Args (the JAX function's; see its docstring for the measured rationale
    of each term):
      closed_mask: (B,) per-sequence weights of the closed term,
        normalised by their sum (``None``: all 1).
      motion_weight / motion_mask: the closed-loop motion-energy hinge
        ``relu(mean|d target| - mean|d pred|)`` per step on the masked
        sequences.
      open_mask: (B, t_open) weights of the open-loop E-term per sequence
        and frame (the zero-state frame is never graded).
      cue_motion_weight / cue_motion_mask: the PIXELWISE closed-loop
        amplitude hinge ``relu(|d target| - |d pred|)``, averaged per
        sequence after the relu.
      whole: :func:`whole_batch` of the batch of which ``frames`` (and the
        masks) are a shard: every term is then normalised by the whole
        batch's sums, so the result is this shard's part of the whole
        batch's loss, and the shards' parts add up to it.
    """
    B, T, H, W, C0 = frames.shape
    L = len(params)
    device = frames.device
    lw = _layer_weights(L, layer_weights, device)
    state = init_state(B, H, W, _channels(params), dtype=params[0]["lstm_b"].dtype,
                       device=device)

    open_losses = []
    pred = torch.zeros(B, H, W, C0, dtype=torch.float32, device=device)
    for t in range(t_open):
        state, pred = prednet_step(params, state, frames[:, t], use_pallas=False)
        errs = torch.stack([state[l]["e"].float().mean(dim=(1, 2, 3)) for l in range(L)])
        open_losses.append((errs * lw[:, None]).sum(dim=0))  # (B,)
    open_losses = torch.stack(open_losses)  # (t_open, B)
    whole = whole or {}
    if open_mask is None:
        open_loss = open_losses[1:].mean()  # skip the zero-state step
        if whole:
            open_loss = open_loss * (B / whole["batch"])
    else:
        om = open_mask.to(torch.float32).t().clone()  # (t_open, B)
        om[0] = 0.0  # zero-state step never graded
        open_loss = (open_losses * om).sum() / torch.clamp(whole.get("open", om.sum()), min=1e-6)

    wseq = _norm_weights(closed_mask, B, device,
                         whole.get("batch" if closed_mask is None else "closed"))
    if motion_weight > 0.0:
        wmot = _norm_weights(motion_mask, B, device,
                             whole.get("batch" if motion_mask is None else "motion"))
    if cue_motion_weight > 0.0:
        wcue = _norm_weights(cue_motion_mask, B, device,
                             whole.get("batch" if cue_motion_mask is None else "cue"))

    def _wmean(x):  # (B, ...) -> masked scalar mean over sequences
        return (_seq_mean(x) * wseq).sum()

    closed = 0.0
    motion = 0.0
    cue_motion = 0.0
    prev_pred = pred
    prev_target = frames[:, t_open - 1].to(torch.float32)
    for t in range(t_open, T):
        state, pred = prednet_step(params, state, pred, use_pallas=False)
        target = frames[:, t].to(torch.float32)
        closed = closed + _wmean(torch.abs(pred - target))
        if edge_weight > 0.0:
            py, px = _spatial_grads(pred)
            ty, tx = _spatial_grads(target)
            closed = closed + edge_weight * (_wmean(torch.abs(py - ty))
                                             + _wmean(torch.abs(px - tx)))
        if motion_weight > 0.0:
            dt_target = _seq_mean(torch.abs(target - prev_target))
            dt_pred = _seq_mean(torch.abs(pred - prev_pred))
            motion = motion + (torch.relu(dt_target - dt_pred) * wmot).sum()
        if cue_motion_weight > 0.0:
            # relu before any spatial averaging: the strong outer response
            # cannot pay for the weak centre band
            gap = torch.relu(torch.abs(target - prev_target) - torch.abs(pred - prev_pred))
            cue_motion = cue_motion + (_seq_mean(gap) * wcue).sum()
        prev_pred, prev_target = pred, target
    n_closed = max(T - t_open, 1)
    loss = open_loss + closed_weight * (closed / n_closed)
    if motion_weight > 0.0:
        loss = loss + motion_weight * motion / n_closed
    if cue_motion_weight > 0.0:
        loss = loss + cue_motion_weight * cue_motion / n_closed
    return loss


class Adam(NamedTuple):
    """optax's ``adam``: ``scale_by_adam(b1, b2, eps, eps_root)`` then
    ``scale(-learning_rate)``, on float32 leaves."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params32):
        """State over float32 trained leaves: count (int32 0), mu, nu, on
        the leaves' device."""
        def zeros():
            return [{k: torch.zeros_like(v, dtype=torch.float32) for k, v in layer.items()}
                    for layer in params32]

        device = next(iter(params32[0].values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    def update(self, grads, state):
        """(updates, new_state): optax's moment updates, bias correction by
        ``1 - b ** count`` in float32, and ``mu_hat / (sqrt(nu_hat +
        eps_root) + eps)`` scaled by ``-learning_rate``."""
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** count.to(f32)
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** count.to(f32)
        mu, nu, updates = [], [], []
        for g_l, m_l, v_l in zip(grads, state["mu"], state["nu"]):
            m_new, v_new, u_new = {}, {}, {}
            for k, g in g_l.items():
                m = m_new[k] = (1 - b1) * g + b1 * m_l[k]
                v = v_new[k] = (1 - b2) * (g * g) + b2 * v_l[k]
                m_hat, v_hat = m / bc1, v / bc2
                u_new[k] = -self.learning_rate * (
                    m_hat / (torch.sqrt(v_hat + self.eps_root) + self.eps))
            mu.append(m_new)
            nu.append(v_new)
            updates.append(u_new)
        return updates, {"count": count, "mu": mu, "nu": nu}


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Adam:
    """The port's counterpart of ``optax.adam``."""
    return Adam(learning_rate, b1, b2, eps, eps_root)


def _master(params):
    """float32 copies of the trained leaves that require a gradient (the
    params themselves are left as they are)."""
    return [{k: v.detach().to(torch.float32).requires_grad_(True) for k, v in layer.items()}
            for layer in trainable(params)]


def init_opt_state(tx: Adam, params):
    """Optimizer state over the float32 master copy of ``params``."""
    return tx.init(trainable(params))


def _repack(layer: dict) -> dict:
    """The kernels' packed weights from the OIHW ones: the fused kernel's
    gate slices, and the A and Ahat units' (bfloat16 params)."""
    for name in ("e", "r", "up"):
        w = layer.get(f"lstm_w_{name}")
        if w is not None:
            layer[_PACKED + name] = pack_gate_weight(w.permute(2, 3, 1, 0))
    return pack_unit_weights(layer)


def _gather_parts(parts, mesh, leaves, home):
    """Every entry's float32 loss and gradients (``parts``: this process's
    entries', ``None`` for the others') on every process, on ``home``: each
    entry's flattened into one vector, gathered, and cut back."""
    sizes = [1] + [v.numel() for v in leaves]
    flat = [None if p is None else torch.cat([x.reshape(-1) for x in p]) for p in parts]
    out = []
    for vec in gather_entries(flat, mesh.processes.flat, (sum(sizes),), torch.float32):
        pieces = vec.to(home).split(sizes)
        out.append([pieces[0].reshape(())]
                   + [x.reshape(v.shape) for x, v in zip(pieces[1:], leaves)])
    return out


def make_train_step(tx: Adam, *, mesh=None, t_open: Optional[int] = None,
                    closed_weight: float = 0.0, edge_weight: float = 0.0,
                    masked_closed: bool = False, motion_weight: float = 0.0,
                    masked_open: bool = False, cue_motion_weight: float = 0.0):
    """A train step ``(params, opt_state, frames, ...) -> (params,
    opt_state, loss)``, with the JAX step's arguments:

    * ``closed_weight > 0`` supervises the frames past ``t_open`` closed
      loop (:func:`prednet_seq_loss`), else the open-loop E-objective
      (:func:`prednet_loss`);
    * ``masked_closed`` adds a (B,) per-sequence weight of the closed term;
      with ``motion_weight > 0`` its complement takes the motion hinge;
    * ``masked_open`` then adds a (B, t_open) open-loop frame weight;
    * ``cue_motion_weight > 0`` adds a final (B,) cue-regime indicator for
      the pixelwise hinge.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`; the JAX data-parallel
    step) splits the batch axis of ``frames`` and the masks over its
    entries and runs each shard's loss and gradients on its entry's
    device, from float32 params placed on each device: each shard's loss
    is its part of the whole batch's (:func:`whole_batch` normalises it),
    so the shards' float32 gradients add up, in entry order on the params'
    device, to the whole batch's, and one Adam step on the float32 master
    gives the update of the whole batch.  A mesh that spans processes
    (:func:`..parallel.distributed.initialize_distributed`) takes the whole
    batch on every process, as the sharded evaluator takes every genome;
    each process runs its own entries' shards, gathers every entry's
    gradients and loss (:func:`..parallel.distributed.gather_entries`) and
    adds them in entry order, so every process takes the same step, bit
    for bit that of one process running all the entries.  The step runs in
    deterministic cuDNN mode, so a resumed run repeats an uninterrupted one
    bit for bit on the card as well.
    """
    if mesh is not None and mesh.spans_processes and process_count() == 1:
        raise ValueError(f"{mesh} spans processes, but no process group is initialized "
                         f"(parallel.initialize_distributed)")
    if closed_weight > 0.0:
        if t_open is None:
            raise ValueError("closed_weight > 0 requires t_open")
        if motion_weight > 0.0 and not masked_closed:
            raise ValueError("motion_weight requires masked_closed")
        if cue_motion_weight > 0.0 and not masked_closed:
            raise ValueError("cue_motion_weight requires masked_closed")

        def loss_fn(p, f, m=None, om=None, cm=None, whole=None):
            return prednet_seq_loss(
                p, f, t_open=t_open, closed_weight=closed_weight,
                edge_weight=edge_weight, closed_mask=m, motion_weight=motion_weight,
                motion_mask=(None if m is None or motion_weight <= 0.0 else 1.0 - m),
                open_mask=om, cue_motion_weight=cue_motion_weight, cue_motion_mask=cm,
                whole=whole)
    else:
        if masked_closed:
            raise ValueError("masked_closed requires closed_weight > 0")
        if masked_open:
            raise ValueError("masked_open requires closed_weight > 0")
        if cue_motion_weight > 0.0:
            raise ValueError("cue_motion_weight requires closed_weight > 0")
        loss_fn = prednet_loss

    def _loss(p, frames, mask, open_mask, cue_mask, whole=None):
        kw = {} if whole is None else {"whole": whole}
        if mask is None and open_mask is None and cue_mask is None:
            return loss_fn(p, frames, **kw)
        return loss_fn(p, frames, mask, open_mask, cue_mask, **kw)

    def _grads(params32, leaves, frames, mask, open_mask, cue_mask):
        """(loss, flat float32 gradients) of the whole batch."""
        with torch.enable_grad():
            if mesh is None:
                loss = _loss(params32, frames, mask, open_mask, cue_mask)
                # a leaf the loss does not reach raises here
                return loss, torch.autograd.grad(loss, leaves)
            home = frames.device
            whole = whole_batch(frames.shape[0], mask, open_mask, cue_mask, device=home)
            shards = [shard_leading(x, mesh) if x is not None else [None] * mesh.size
                      for x in (frames, mask, open_mask, cue_mask)]
            placed = replicate(params32, mesh)  # differentiable copies
            parts = []  # per entry: its loss, then its gradients
            for i, dev in enumerate(mesh.devices.flat):
                if not mesh.is_local(i):
                    parts.append(None)
                    continue
                with device_context(dev):
                    part = _loss(placed[dev], *(x[i] for x in shards),
                                 whole={k: v.to(dev) for k, v in whole.items()})
                    g = torch.autograd.grad(part, leaves)
                parts.append([part.to(home), *g])
            if mesh.spans_processes:
                parts = _gather_parts(parts, mesh, leaves, home)
            loss = sum_in_order([p[0] for p in parts])
            grads = [sum_in_order([p[j] for p in parts]) for j in range(1, len(leaves) + 1)]
            return loss, grads

    def _update(params, opt_state, frames, mask, open_mask, cue_mask):
        cudnn = torch.backends.cudnn
        saved = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            params32 = _master(params)
            leaves = [v for layer in params32 for v in layer.values()]
            loss, flat = _grads(params32, leaves, frames, mask, open_mask, cue_mask)
        finally:
            cudnn.deterministic, cudnn.benchmark = saved
        flat = iter(flat)
        grads = [{k: next(flat) for k in layer} for layer in params32]
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state)
            new = []
            for old, p32, u in zip(params, params32, updates):
                layer = {k: (p32[k] + u[k]).to(old[k].dtype) for k in p32}
                new.append(_repack(layer) if any(k.startswith(_PACKED) for k in old)
                           else layer)
        return new, opt_state, loss.detach()

    has_cue = cue_motion_weight > 0.0
    if masked_open:
        if not masked_closed:
            raise ValueError("masked_open requires masked_closed")
        if has_cue:
            return lambda p, o, f, m, om, cm: _update(p, o, f, m, om, cm)
        return lambda p, o, f, m, om: _update(p, o, f, m, om, None)
    if masked_closed:
        if has_cue:
            return lambda p, o, f, m, cm: _update(p, o, f, m, None, cm)
        return lambda p, o, f, m: _update(p, o, f, m, None, None)
    return lambda p, o, f: _update(p, o, f, None, None, None)
