"""HRFuser on PyTorch and CUDA: the eval-inference port of `hrfuser_tpu`.

Mirrors the JAX package's layout (`ops/`, `layers/`, `models/`, `apis/`,
`configs/`, `utils/`). The three TPU Pallas kernels on the inference path
are hand-written CUDA C++ for Hopper (`csrc/`), each with a plain PyTorch
twin that runs on CPU tensors. Imports torch and numpy only.
"""

from hrfuser_tpu_torch.apis.inference import Detector, init_detector
from hrfuser_tpu_torch.configs import get_config

__all__ = ['Detector', 'init_detector', 'get_config']
