"""Illusion structure families.

API-parity with the reference enum (generate_illusion.py:25-29, duplicated in
fitness_calculator.py:10-14): Bands=0, Circles=1, Free=2, CirclesFree=3.
"""

from enum import IntEnum


class StructureType(IntEnum):
    """The four illusion structure families the generator can evolve."""

    Bands = 0
    Circles = 1
    Free = 2
    CirclesFree = 3


__all__ = ["StructureType"]
