"""Native batch fitness scorer (C++ via ctypes)."""

from .native import is_available, library_path, score_population_native

__all__ = ["is_available", "library_path", "score_population_native"]
