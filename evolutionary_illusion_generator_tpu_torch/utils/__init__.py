"""Utilities: PNG I/O without Pillow, image IO, flow overlays, timing and profiling."""
