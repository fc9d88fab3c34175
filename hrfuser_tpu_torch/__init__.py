"""HRFuser on PyTorch and CUDA: the port of `hrfuser_tpu` (eval, serving
and training).

Mirrors the JAX package's layout (`ops/`, `layers/`, `models/`, `apis/`,
`configs/`, `data/`, `evaluation/`, `utils/`, `tools/`). The TPU Pallas
kernels are hand-written CUDA C++ for Hopper (`csrc/`), each with a plain
PyTorch twin that runs on CPU tensors. Imports torch and numpy only.
"""

from hrfuser_tpu_torch.apis.inference import (Detector, inference_detector,
                                              init_detector)
from hrfuser_tpu_torch.configs import get_config, get_experiment
from hrfuser_tpu_torch.version import __version__  # noqa: F401

__all__ = ['Detector', 'init_detector', 'inference_detector', 'get_config',
           'get_experiment']
