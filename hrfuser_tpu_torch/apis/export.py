"""Model export: `predict` as a `torch.export` program.

Counterpart of the JAX package's `tools/export_model.py`, which
serializes the jitted `predict` (backbone + RPN decode + NMS + cascade
head) with `jax.export` as StableHLO with the weights baked in. Here
`torch.export` traces the port's `predict` into an `ExportedProgram`,
saved with `torch.export.save` (`.pt2`):

- inputs `(img, *mod_imgs)`: float32 NHWC [B, H, W, C_k] at static
  shapes, preprocessed (normalized, padded to /32) as `Detector` takes
  them; the program casts them to the detector's dtype. The output is
  `Detections`, registered for serialization as
  `hrfuser_tpu_torch.Detections`.
- kernels A, B and C and the NMS keep loop enter the graph as the
  registered ops `hrfuser::window_attention`, `hrfuser::cross_ffn`,
  `hrfuser::roi_align` and `hrfuser::greedy_keep`: the loaded program
  launches the same kernels, counted as eager calls are.
- weights: one eager call right before tracing folds them
  (`layers/common.cached`); the folded and bf16-packed tensors enter the
  program as constants. The model is held outside the traced module, so
  the raw parameters, which the graph no longer reads, stay out of it.

The program runs on the device it was exported on. It calls the
`hrfuser::*` ops, so loading it (`torch.export.load`) needs
`import hrfuser_tpu_torch` first: unlike the JAX package's StableHLO
artifact, it is not self-contained.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from hrfuser_tpu_torch.apis.inference import Detector
from hrfuser_tpu_torch.configs import DataCfg
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import predict


def default_img_hw(data: DataCfg) -> Tuple[int, int]:
    """The config's resize target `img_scale` (w, h) as (H, W) rounded up
    to /32 (the JAX tool's default, `tools/export_model.py:50-54`)."""
    w, h = data.img_scale
    return -(-h // 32) * 32, -(-w // 32) * 32


def input_shapes(detector: Detector, batch: int,
                 img_hw: Tuple[int, int]) -> List[Tuple[int, ...]]:
    """Shapes of `(img, *mod_imgs)`: the camera and one stream per fused
    modality at its channel count."""
    h, w = img_hw
    bb = detector.cfg.backbone
    return [(batch, h, w, 3)] + [
        (batch, h, w, c)
        for c in bb.mod_in_channels[:bb.num_fused_modalities]]


def predict_inputs(detector: Detector, shapes: Sequence[Tuple[int, ...]],
                   generator: Optional[torch.Generator] = None
                   ) -> List[torch.Tensor]:
    """float32 inputs on the detector's device: zeros, or N(0, 1) drawn on
    the CPU from `generator`."""
    if generator is None:
        return [torch.zeros(s, device=detector.device) for s in shapes]
    return [torch.randn(s, generator=generator).to(detector.device)
            for s in shapes]


class PredictModule(nn.Module):
    """`predict` of a detector on float32 `(img, *mod_imgs)`, cast to its
    dtype. The model is not a submodule: an export lifts only the tensors
    the graph reads."""

    def __init__(self, detector: Detector):
        super().__init__()
        self.run = functools.partial(predict, detector.model)
        self.dtype = detector.dtype

    def forward(self, img: torch.Tensor, *mod_imgs: torch.Tensor):
        return self.run(img.to(self.dtype),
                        [m.to(self.dtype) for m in mod_imgs])


def export_predict(detector: Detector, batch: int = 1,
                   img_hw: Optional[Tuple[int, int]] = None
                   ) -> torch.export.ExportedProgram:
    """Trace `predict` of an eval `detector` at a static batch and (H, W)
    (default: `default_img_hw`) on its device and dtype.

    One eager call on zeros runs first, so every fold the trace reads is
    stored (`cached` raises under the tracer otherwise); its kernel
    launches count as any eager call's.
    """
    if detector.model.training:
        raise ValueError('export_predict: the model is in training mode; '
                         'export traces the eval route')
    shapes = input_shapes(detector, batch,
                          img_hw or default_img_hw(detector.data))
    inputs = tuple(predict_inputs(detector, shapes))
    fn = PredictModule(detector)
    with torch.no_grad():
        fn(*inputs)
        program = torch.export.export(fn, inputs, strict=False)
    # a saved program would carry the zero inputs too (71 MB at batch 8,
    # 384x640); it needs none to run
    program.example_inputs = None
    return program
