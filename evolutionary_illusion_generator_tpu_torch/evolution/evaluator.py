"""The generation evaluator: one device pass per population chunk.

The port of the JAX package's ``evolution/evaluator.py``:

    packed genomes ──cppn levels──> images ──PredNet rollout──> flow frames
                  ──corners+LK──> (pop, K, 4) vectors + masks

Only the (small) vector sets come back to the host, where scoring runs in
float64 (``score_backend``: the C++ batch scorer, or numpy with the
reference's exact math), or the scores are computed on the device with
``score_on_device=True`` (:mod:`..ops.fitness.metrics_torch`, float32).  The
population is chunked at the host level (``_bucket``, minimum 8) and the
genomes are packed into grow-only (levels x width) CPPN buckets and a
grow-only activation set, as in the JAX package.  On the card the chunk
pass of each bucket key is captured once as a CUDA graph and replayed
(``program_cache``, :mod:`..utils.program_cache`); ``debug_nans`` runs it
eagerly under the NaN sanitizer (:mod:`..utils.debug_nans`).
"""

from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import indexed_device, resolve_device
from ..models.cppn import (
    ACTIVATIONS,
    genome_depth,
    make_population_eval,
    pack_population_levels,
    population_act_set,
    required_nodes,
)
from ..models.prednet.model import (
    quantize_params_int8,
    rollout_flow_frames,
    with_layout_weights,
)
from ..neat.config import NeatConfig
from ..neat.genome import Genome
from ..ops.fitness import native
from ..ops.fitness.calculate import score_vectors
from ..ops.fitness.metrics_torch import score_vectors_torch
from ..ops.flow.api import FlowConfig, batched_flow
from ..ops.grids import GRID_SCALING, create_grid
from ..ops.render import render_equilum_images, render_images, to_unit_float
from ..structure import StructureType
from ..utils import debug_nans as sanitizer
from ..utils.program_cache import ProgramCache, program_cache_enabled

__all__ = ["EvalConfig", "GenerationEvaluator", "GenerationOutputs"]


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class EvalConfig:
    """Configuration of the generation's device pass: every field of the
    JAX package's ``EvalConfig``, with the same names, and the same
    defaults but for ``use_pallas``."""

    structure: StructureType = StructureType.Circles
    w: int = 160
    h: int = 120
    c_dim: int = 3
    gradient: int = 1
    bg: int = 1
    # equiluminant (HSV) rendering; needs c_dim=3
    equilum: bool = False
    repeat: int = 20  # open-loop presentations
    extension: int = 2  # closed-loop frames
    # renders per genome; a genome's fitness is the mean over its renders
    pertype_count: int = 1
    flow: FlowConfig = field(default_factory=FlowConfig)
    # score on the device (float32) instead of pulling the vectors to the
    # host for float64 scoring
    score_on_device: bool = False
    # host scoring backend: "auto" (C++ if buildable, else numpy),
    # "native" (C++, raises if it cannot be built) or "numpy"
    score_backend: str = "auto"
    # replace non-finite fitness scores with 0 (with a warning)
    nan_to_zero: bool = True
    # Sanitizer mode: raise FloatingPointError at the first op of the
    # device pass that makes a NaN, naming it (utils/debug_nans.py, the
    # counterpart of jax_debug_nans).  A device sync per op: debugging only.
    debug_nans: bool = False
    # The predictor's route (models/prednet/model.py::prednet_step), with
    # the JAX values: "fused" (the fused ConvLSTM kernel on layers of 32
    # channels or more, the gate kernel on the narrow ones), True (the
    # gate kernel after split gate convs on every layer) or False (split
    # convs and the plain gate math, no kernel).  The one default that
    # differs from the JAX field's (False): the JAX default is the TPU's
    # XLA path, while the port's main path is its kernels, so following it
    # would leave every entry point running no kernel.
    use_pallas: Union[bool, str] = "fused"
    # Top-down conv(upsample2(R_above)) of the split-conv layers as four
    # parity 2x2 convs at the coarse resolution
    # (models/prednet/model.py::_upconv_subpixel): 4/9 the FLOPs of that
    # conv and no upsampled intermediate, at bf16-rounding-level drift.
    subpixel_up: bool = False
    # Pixel-layer convs/states in space-to-depth layout (models/prednet/
    # model.py::_s2d_kernel): 4x channels at 1/4 the spatial size.  Same
    # math up to accumulation-order rounding.  ``None`` (default) resolves
    # to True on TPU backends and False elsewhere, so False on the card.
    s2d_l0: Optional[bool] = None
    # predictor compute dtype ("bfloat16" | "float32")
    prednet_dtype: str = "bfloat16"
    # int8-quantize the frozen predictor's conv weights (per-output-channel
    # scales) with a dynamic per-row activation scale
    # (models/prednet/model.py::quantize_params_int8); quantization noise
    # perturbs the drift signal the fitness reads, so it is opt-in.
    prednet_int8: bool = False
    # population chunk bound (memory); 0 = whole population at once
    microbatch: int = 0
    # CPPN level bucket (grow-only): levels x width node slots
    cppn_levels: int = 8
    cppn_width: int = 16
    # "population": only the activations present so far (grow-only);
    # "all": the full 7-function stack
    cppn_act_mode: str = "population"
    # The program cache: on the card each bucket key's chunk pass is
    # captured once as a CUDA graph and replayed (utils/program_cache.py);
    # no effect on the CPU, off under debug_nans or EIGEN_PROGRAM_CACHE=0.
    program_cache: bool = True


def wants_program_cache(cfg: EvalConfig) -> bool:
    """Whether ``cfg`` asks for the CUDA-graph program cache: its
    ``program_cache``, unless ``debug_nans`` (the sanitizer must see every
    op, as the JAX cache steps aside for ``jax_debug_nans``) or the
    environment sets ``EIGEN_PROGRAM_CACHE=0``."""
    return cfg.program_cache and not cfg.debug_nans and program_cache_enabled()


class GenerationOutputs:
    """Results of one generation's device pass.

    ``chunks`` holds, per population chunk, one dict of device tensors per
    shard of ``shard_rows`` rows (one shard of the whole chunk on a single
    device; one per mesh entry, on its device, under
    :class:`..parallel.sharded_evaluator.ShardedGenerationEvaluator`).
    The small per-candidate data (flow vectors, masks, device scores) is
    copied to the host on demand in one go; bulky tensors (rendered images,
    the first flow frame) stay on the device and are fetched row by row.
    """

    SMALL = ("vectors", "mask", "scores")

    def __init__(self, chunks, chunk_size: int, n: int,
                 shard_rows: Optional[int] = None) -> None:
        self._chunks = chunks  # [chunk][shard] -> dict of device tensors
        self._chunk_size = chunk_size
        self._shard_rows = shard_rows or chunk_size
        self._n = n

    def __len__(self) -> int:
        return self._n

    def _pieces(self, keys):
        """Host copies of ``keys`` of every shard, in population order."""
        return [{k: shard[k].cpu().numpy() for k in keys}
                for chunk in self._chunks for shard in chunk]

    def _host(self, keys) -> Dict[str, np.ndarray]:
        # each piece to the host first: the shards may live on several devices
        pieces = self._pieces(list(keys))
        return {k: np.concatenate([p[k] for p in pieces])[: self._n] for k in keys}

    def _keys(self):
        return list(self._chunks[0][0].keys())

    def small(self) -> Dict[str, np.ndarray]:
        """Host copies of the small outputs, truncated to the population."""
        return self._host([k for k in self.SMALL if k in self._keys()])

    def _locate(self, i: int):
        if not 0 <= i < self._n:
            raise IndexError(i)
        c, r = divmod(i, self._chunk_size)
        s, r = divmod(r, self._shard_rows)
        return c, s, r

    def fetch(self, key: str, i: int) -> np.ndarray:
        """Host copy of one candidate's row of a bulky output."""
        c, s, r = self._locate(i)
        return self._chunks[c][s][key][r].cpu().numpy()

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Full host copy of everything (tests / debugging)."""
        return self._host(self._keys())


class GenerationEvaluator:
    """Evaluates NEAT populations; assigns ``genome.fitness`` in place.

    ``device=None`` means the card; without one this raises unless the
    caller passes ``device="cpu"``.
    """

    def __init__(self, cfg: EvalConfig, params, neat_cfg: NeatConfig,
                 device=None) -> None:
        if cfg.equilum and cfg.c_dim != 3:
            raise ValueError("equiluminant rendering needs c_dim=3 (H,S,V nodes)")
        self.cfg = cfg
        self.device = resolve_device(device)
        # the backend-dependent default, resolved once (part of the program
        # key): the card is not a TPU
        self._s2d_l0 = False if cfg.s2d_l0 is None else cfg.s2d_l0
        params = [{k: v.to(self.device) for k, v in layer.items()} for layer in params]
        if cfg.prednet_int8:
            params = quantize_params_int8(params)
        # the layout options' weights, lifted once here and not every step
        self.params = with_layout_weights(params, s2d_l0=self._s2d_l0,
                                          subpixel_up=cfg.subpixel_up)
        self.neat_cfg = neat_cfg
        grid = create_grid(cfg.structure, cfg.w, cfg.h, GRID_SCALING)
        x_mat = torch.as_tensor(grid["x_mat"], dtype=torch.float32)
        y_mat = torch.as_tensor(grid["y_mat"], dtype=torch.float32)
        self._x_mat = x_mat.to(self.device)
        self._grid_flat = torch.stack([x_mat.reshape(-1), y_mat.reshape(-1)]).to(
            self.device
        )
        # what the chunk pass reads, by the device its input is on (the
        # sharded evaluator adds a copy per device of its mesh)
        self._replicas = {indexed_device(self.device): self._frozen()}
        self._levels = cfg.cppn_levels
        self._width = cfg.cppn_width
        while self._levels * self._width < (
            neat_cfg.num_inputs + neat_cfg.num_outputs + neat_cfg.num_hidden
        ):
            self._width *= 2
        self._pop_min = 8
        # grow-only activation set (global ids); () = none seen yet
        self._act_set: tuple = (
            tuple(range(len(ACTIVATIONS))) if cfg.cppn_act_mode == "all" else ()
        )
        self._programs = ProgramCache(
            self._eval_chunk, enabled=self.device.type == "cuda" and wants_program_cache(cfg))
        self.last_timings: Dict[str, float] = {}
        self.last_results: Dict[str, object] = {}

    # ------------------------------------------------------------------

    def _frozen(self) -> Dict[str, object]:
        """The tensors every chunk pass reads: the lifted params and the
        coordinate grid."""
        return {"params": self.params, "x_mat": self._x_mat, "grid_flat": self._grid_flat}

    @torch.inference_mode()
    def _eval_chunk(self, chunk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The per-candidate pipeline for one population chunk (or shard),
        on the params and grid of the device its input is on."""
        cfg = self.cfg
        frozen = self._replicas[chunk["weights"].device]
        outs = make_population_eval(self._act_set or None)(
            chunk["weights"], chunk["bias"], chunk["response"],
            chunk["act_id"], chunk["out_slot"], frozen["grid_flat"],
        )  # (chunk, O, P)
        if cfg.equilum:
            imgs_u8 = render_equilum_images(outs, frozen["x_mat"], bg=cfg.bg)
        else:
            imgs_u8 = render_images(outs, frozen["x_mat"], cfg.c_dim, bg=cfg.bg,
                                    gradient=cfg.gradient)
        f0, f1 = rollout_flow_frames(
            frozen["params"], to_unit_float(imgs_u8), repeat=cfg.repeat,
            extension=cfg.extension, pair="population", use_pallas=cfg.use_pallas,
            compute_dtype=getattr(torch, cfg.prednet_dtype),
            subpixel_up=cfg.subpixel_up, s2d_l0=self._s2d_l0,
        )
        vectors, vmask = batched_flow(f0, f1, cfg.flow)
        out = {
            "images_u8": imgs_u8,
            "vectors": vectors,
            "mask": vmask,
            # the base of the winner's overlay artifact, kept as uint8
            "flow_frame0": (f0.clamp(0.0, 1.0) * 255.0).to(torch.uint8),
        }
        if cfg.score_on_device:
            out["scores"] = score_vectors_torch(cfg.structure, vectors, vmask, cfg.w, cfg.h)
        return out

    def program_key(self, chunk: int) -> tuple:
        """The chunk pass's key in the program cache: the pop bucket, the
        level and width buckets and the activation set.  The cache is this
        evaluator's own, so the other parts of the JAX key (the class, the
        config, the resolved ``s2d_l0``) cannot change inside it."""
        return (chunk, self._levels, self._width, self._act_set)

    def evaluate_images(self, genomes: List[Genome]) -> GenerationOutputs:
        """Run the device pass over host-level chunks of the population.

        Bulky per-candidate tensors (images) stay on the device; callers
        fetch single rows (e.g. the winner's) on demand."""
        n = len(genomes)
        # grow the level bucket first if any genome outgrew it (capacity or
        # depth); buckets only ever expand
        need_nodes = max(len(required_nodes(g, self.neat_cfg)) for g in genomes)
        need_depth = max(genome_depth(g, self.neat_cfg) for g in genomes)
        while self._levels * self._width < need_nodes:
            self._width *= 2
        while self._levels < need_depth:
            self._levels *= 2
        if len(self._act_set) < len(ACTIVATIONS):
            needed = population_act_set(genomes, self.neat_cfg)
            if not needed <= set(self._act_set):
                self._act_set = tuple(sorted(set(self._act_set) | needed))

        mb = self.cfg.microbatch
        chunk = min(mb, _bucket(n, self._pop_min)) if mb else _bucket(n, self._pop_min)
        packed = pack_population_levels(
            genomes, self.neat_cfg, self._levels, self._width,
            act_set=self._act_set or None,
        )
        # the packer may have grown the bucket further
        _, self._levels, self._width, _ = packed["weights"].shape
        padded = -(-n // chunk) * chunk
        if n < padded:
            pad = padded - n
            packed = {
                k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                for k, v in packed.items()
            }
        key = self.program_key(chunk)
        pieces = []
        with sanitizer.sanitize() if self.cfg.debug_nans else contextlib.nullcontext():
            for start in range(0, padded, chunk):
                part = {k: v[start : start + chunk] for k, v in packed.items()}
                pieces.append(self._run_chunk(key, part))
        return self._outputs(pieces, chunk, n)

    @staticmethod
    def _live(key: tuple):
        """Whether a program key can still occur beside ``key``: the
        buckets only grow, so one of another level/width bucket or
        activation set (its last three parts) is gone."""
        return lambda k: k[-3:] == key[-3:]

    def _run_chunk(self, key: tuple, part: Dict[str, np.ndarray]) -> List[Dict[str, torch.Tensor]]:
        """One chunk's pass on this evaluator's device: a list of one shard."""
        inputs = {k: torch.as_tensor(v).to(self.device) for k, v in part.items()}
        return [self._programs.run(key, self._live(key), inputs)]

    def _outputs(self, pieces, chunk: int, n: int) -> GenerationOutputs:
        return GenerationOutputs(pieces, chunk, n)

    def _score_host(self, vectors: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Float64 host scoring: the C++ batch scorer when ``score_backend``
        allows it and it builds, else numpy."""
        backend = self.cfg.score_backend
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown score_backend {backend!r}")
        if backend in ("auto", "native"):
            if native.is_available():
                return native.score_population_native(
                    int(self.cfg.structure), vectors, mask, self.cfg.w, self.cfg.h)
            if backend == "native":
                raise RuntimeError("native fitness scorer unavailable (no g++?)")
        scores = np.zeros(len(vectors))
        for i in range(len(vectors)):
            scores[i] = score_vectors(self.cfg.structure, vectors[i][mask[i]],
                                      self.cfg.w, self.cfg.h)
        return scores

    def __call__(self, population: List[Tuple[int, Genome]], neat_cfg=None):
        """Fitness-function interface for :class:`..neat.Population`."""
        cfg = self.cfg
        pertype = max(1, cfg.pertype_count)
        genomes = [g for _, g in population for _ in range(pertype)]
        t0 = time.time()
        outputs = self.evaluate_images(genomes)
        small = outputs.small()  # vectors, masks (, scores): ~KBs; waits for the device
        t1 = time.time()

        if cfg.score_on_device:
            scores = small["scores"].astype(np.float64)
        else:
            scores = self._score_host(small["vectors"], small["mask"])
        if cfg.nan_to_zero:
            bad = ~np.isfinite(scores)
            if bad.any():
                warnings.warn(
                    f"{int(bad.sum())} non-finite fitness scores zeroed "
                    f"(zero-norm flow vectors); set nan_to_zero=False for "
                    f"reference NaN propagation"
                )
                scores = np.where(bad, 0.0, scores)
        # per-genome fitness = mean over the pertype_count renders
        per_render = scores.reshape(len(population), pertype)
        scores = per_render.mean(axis=1)
        t2 = time.time()

        best_idx = 0
        best_score = 0.0
        for i, (gid, genome) in enumerate(population):
            genome.fitness = float(scores[i])
            # reference tie-break: >= lets later candidates win
            if scores[i] >= best_score:
                best_idx = i
                best_score = float(scores[i])

        self.last_timings = {"device": t1 - t0, "score": t2 - t1}
        self.last_results = {
            "best_idx": best_idx,
            "best_score": best_score,
            # device-output row of the winner's best render
            "best_row": best_idx * pertype + int(np.argmax(per_render[best_idx])),
            "outputs": outputs,
            "vectors": small["vectors"],
            "mask": small["mask"],
            "scores": scores,
        }
        return scores
