"""PredNet predictive-coding ConvLSTM stack (PyTorch, CUDA kernels)."""

from .loader import (
    bundled_weights_path,
    init_params_numpy,
    load_or_init,
    load_params,
    params_from_numpy,
)
from .model import (
    init_params,
    init_state,
    prednet_step,
    quantize_params_int8,
    rollout,
    rollout_flow_frames,
)

__all__ = [
    "bundled_weights_path",
    "init_params_numpy",
    "load_or_init",
    "load_params",
    "params_from_numpy",
    "init_params",
    "init_state",
    "prednet_step",
    "quantize_params_int8",
    "rollout",
    "rollout_flow_frames",
]
