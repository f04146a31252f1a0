"""The generation evaluator: one device pass per population chunk.

The port of the JAX package's ``evolution/evaluator.py``:

    packed genomes ──cppn levels──> images ──PredNet rollout──> flow frames
                  ──corners+LK──> (pop, K, 4) vectors + masks

Only the (small) vector sets come back to the host, where scoring runs in
exact float64 numpy (bit-compatible rankings with the reference).  The
population is chunked at the host level (``_bucket``, minimum 8) and the
genomes are packed into grow-only (levels x width) CPPN buckets and a
grow-only activation set, as in the JAX package.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.cppn import (
    ACTIVATIONS,
    genome_depth,
    make_population_eval,
    pack_population_levels,
    population_act_set,
    required_nodes,
)
from ..models.prednet.model import rollout_flow_frames
from ..neat.config import NeatConfig
from ..neat.genome import Genome
from ..ops.fitness.calculate import score_vectors
from ..ops.flow.api import FlowConfig, batched_flow
from ..ops.grids import GRID_SCALING, create_grid
from ..ops.render import render_equilum_images, render_images, to_unit_float
from ..structure import StructureType

__all__ = ["EvalConfig", "GenerationEvaluator", "GenerationOutputs"]


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class EvalConfig:
    """Configuration of the generation's device pass: the fields of the
    JAX package's ``EvalConfig`` that the port implements, with the same
    names and defaults."""

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
    # replace non-finite fitness scores with 0 (with a warning)
    nan_to_zero: bool = True
    # predictor compute dtype ("bfloat16" | "float32")
    prednet_dtype: str = "bfloat16"
    # population chunk bound (memory); 0 = whole population at once
    microbatch: int = 0
    # CPPN level bucket (grow-only): levels x width node slots
    cppn_levels: int = 8
    cppn_width: int = 16
    # "population": only the activations present so far (grow-only);
    # "all": the full 7-function stack
    cppn_act_mode: str = "population"


class GenerationOutputs:
    """Results of one generation's device pass.

    The small per-candidate data (flow vectors, masks) is copied to the host
    on demand in one go; bulky tensors (rendered images, the first flow
    frame) stay on the device and are fetched row by row.
    """

    SMALL = ("vectors", "mask")

    def __init__(self, chunks, chunk_size: int, n: int) -> None:
        self._chunks = chunks  # list of dicts of device tensors
        self._chunk_size = chunk_size
        self._n = n

    def __len__(self) -> int:
        return self._n

    def _host(self, keys) -> Dict[str, np.ndarray]:
        return {
            k: torch.cat([c[k] for c in self._chunks])[: self._n].cpu().numpy()
            for k in keys
        }

    def small(self) -> Dict[str, np.ndarray]:
        """Host copies of the small outputs, truncated to the population."""
        return self._host(self.SMALL)

    def fetch(self, key: str, i: int) -> np.ndarray:
        """Host copy of one candidate's row of a bulky output."""
        if not 0 <= i < self._n:
            raise IndexError(i)
        c, r = divmod(i, self._chunk_size)
        return self._chunks[c][key][r].cpu().numpy()

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Full host copy of everything (tests / debugging)."""
        return self._host(self._chunks[0].keys())


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
        self.params = [{k: v.to(self.device) for k, v in layer.items()}
                       for layer in params]
        self.neat_cfg = neat_cfg
        grid = create_grid(cfg.structure, cfg.w, cfg.h, GRID_SCALING)
        x_mat = torch.as_tensor(grid["x_mat"], dtype=torch.float32)
        y_mat = torch.as_tensor(grid["y_mat"], dtype=torch.float32)
        self._x_mat = x_mat.to(self.device)
        self._grid_flat = torch.stack([x_mat.reshape(-1), y_mat.reshape(-1)]).to(
            self.device
        )
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
        self.last_timings: Dict[str, float] = {}
        self.last_results: Dict[str, object] = {}

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _eval_chunk(self, chunk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The per-candidate pipeline for one population chunk."""
        cfg = self.cfg
        outs = make_population_eval(self._act_set or None)(
            chunk["weights"], chunk["bias"], chunk["response"],
            chunk["act_id"], chunk["out_slot"], self._grid_flat,
        )  # (chunk, O, P)
        if cfg.equilum:
            imgs_u8 = render_equilum_images(outs, self._x_mat, bg=cfg.bg)
        else:
            imgs_u8 = render_images(outs, self._x_mat, cfg.c_dim, bg=cfg.bg,
                                    gradient=cfg.gradient)
        f0, f1 = rollout_flow_frames(
            self.params, to_unit_float(imgs_u8), repeat=cfg.repeat,
            extension=cfg.extension, pair="population",
            compute_dtype=getattr(torch, cfg.prednet_dtype),
        )
        vectors, vmask = batched_flow(f0, f1, cfg.flow)
        return {
            "images_u8": imgs_u8,
            "vectors": vectors,
            "mask": vmask,
            # the base of the winner's overlay artifact, kept as uint8
            "flow_frame0": (f0.clamp(0.0, 1.0) * 255.0).to(torch.uint8),
        }

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
        pieces = []
        for start in range(0, padded, chunk):
            part = {
                k: torch.as_tensor(v[start : start + chunk]).to(self.device)
                for k, v in packed.items()
            }
            pieces.append(self._eval_chunk(part))
        return GenerationOutputs(pieces, chunk, n)

    def _score_host(self, vectors: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Exact float64 host scoring (numpy)."""
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
        small = outputs.small()  # vectors + masks: ~KBs; waits for the device
        t1 = time.time()

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
