"""Named run presets — the BASELINE.json benchmark config points.

Each preset bundles the full kwargs of
:func:`~evolutionary_illusion_generator_tpu_torch.evolution.driver.neat_illusion`
for one of the five driver-provided scale points (BASELINE.json "configs"):

  1. circles_bw_small — grayscale circles 160x120, pop 24 (CPU-runnable)
  2. default_color    — color CPPN 320x240, pop 40, 5-frame rollout
  3. bands            — band-structured CPPN with the structure mask grid
  4. free_big         — unconstrained color 640x480, pop 100
  5. pop256_v5e8      — 1280x960, pop 256, population sharded over 8 chips,
                        per-generation checkpointing
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .neat.config import NeatConfig, preset as neat_preset
from .structure import StructureType

__all__ = ["RunPreset", "run_preset", "RUN_PRESET_NAMES"]


@dataclass(frozen=True)
class RunPreset:
    name: str
    structure: StructureType
    w: int
    h: int
    c_dim: int
    gradient: int
    channels: Tuple[int, ...]
    neat: NeatConfig
    repeat: int = 20
    microbatch: int = 0
    n_devices: Optional[int] = None  # None = single chip
    checkpoint_every: int = 1

    def driver_kwargs(self) -> dict:
        """kwargs for ``neat_illusion`` (minus output_dir/model)."""
        return dict(
            config=self.neat,
            structure=self.structure,
            w=self.w,
            h=self.h,
            channels=list(self.channels),
            c_dim=self.c_dim,
            gradient=self.gradient,
            repeat=self.repeat,
            microbatch=self.microbatch,
            checkpoint_every=self.checkpoint_every,
        )


def _presets():
    return {
        "circles_bw_small": RunPreset(
            name="circles_bw_small",
            structure=StructureType.Circles,
            w=160,
            h=120,
            c_dim=1,
            gradient=0,
            channels=(1, 16, 32, 64),
            neat=neat_preset("circles_bw").replace(pop_size=24),
        ),
        "default_color": RunPreset(
            name="default_color",
            structure=StructureType.CirclesFree,
            w=320,
            h=240,
            c_dim=3,
            gradient=1,
            channels=(3, 48, 96, 192),
            neat=neat_preset("circles").replace(pop_size=40),
            repeat=5,
        ),
        "bands": RunPreset(
            name="bands",
            structure=StructureType.Bands,
            w=160,
            h=120,
            c_dim=3,
            gradient=1,
            channels=(3, 48, 96, 192),
            # bands.txt declares 6 outputs (stale remnant); the renderer
            # consumes the first c_dim — keep 3 so color rendering is sound
            neat=neat_preset("bands").replace(num_outputs=3),
        ),
        "free_big": RunPreset(
            name="free_big",
            structure=StructureType.Free,
            w=640,
            h=480,
            c_dim=3,
            gradient=1,
            channels=(3, 48, 96, 192),
            neat=neat_preset("free").replace(pop_size=100, num_outputs=3),
            microbatch=32,
        ),
        "pop256_v5e8": RunPreset(
            name="pop256_v5e8",
            structure=StructureType.Free,
            w=1280,
            h=960,
            c_dim=3,
            gradient=1,
            channels=(3, 48, 96, 192),
            neat=neat_preset("free").replace(pop_size=256, num_outputs=3),
            microbatch=64,  # global chunk; 64/8 chips = 8 candidates per chip
            n_devices=8,
            checkpoint_every=1,
        ),
    }


RUN_PRESET_NAMES = tuple(_presets())


def run_preset(name: str) -> RunPreset:
    try:
        return _presets()[name]
    except KeyError:
        raise ValueError(f"unknown run preset {name!r}; choose {RUN_PRESET_NAMES}")
