"""On-device sparse optical flow: Shi-Tomasi corners and pyramidal
Lucas-Kanade as fixed-K masked tensors, batched over the population, and
the reference's file interface ``lucas_kanade``."""

from .api import FlowConfig, batched_flow, flow_vectors, lucas_kanade
from .corners import shi_tomasi_corners
from .lk import pyramid_lk
from .pyramid import build_pyramid, to_gray

__all__ = [
    "FlowConfig",
    "batched_flow",
    "flow_vectors",
    "lucas_kanade",
    "shi_tomasi_corners",
    "pyramid_lk",
    "build_pyramid",
    "to_gray",
]
