"""Tensor ops: grids, rendering, optical flow, fitness metrics, CUDA kernel wrappers."""
