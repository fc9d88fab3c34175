"""Model and data presets for the configurations the port runs.

Copies of `hrfuser_tpu/configs/presets.py:64-77,90-141,187-198,238-252,
319-325,361-371`: the eval fields of `DetectorCfg` (see `hr_config.py`)
and the whole `DataCfg`. `get_config(name)` gives the model half,
`get_experiment(name)` both halves. `tests/test_torch_configs.py` holds
each equal, field for field, to `hrfuser_tpu.configs.get_config(name)`'s
`.model` and `.data`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from hrfuser_tpu_torch.models.backbones.hr_config import (FusionCfg,
                                                          HRBackboneCfg,
                                                          StageCfg)
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (DetectorCfg,
                                                             RPNTestCfg)
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import RoIHeadCfg


NUSCENES_CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
                    'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
                    'barrier')


@dataclasses.dataclass(frozen=True)
class DataCfg:
    dataset: str                             # 'nuscenes' | 'stf'
    classes: Tuple[str, ...]
    img_scale: Tuple[int, int]               # (w, h) target resize
    pad_divisor: int = 32
    modalities: Tuple[str, ...] = ()         # ordered extra streams
    modality_drop_p: Tuple[float, ...] = ()
    flip_ratio: float = 0.5
    # STF-only deterministic crops: ((h, w, off_h, off_w), ...)
    crops: Tuple[Tuple[int, int, int, int], ...] = ()
    eval_on_crop: Optional[Tuple[int, int, int, int]] = None
    # restrict metric computation to a label subset (reference
    # `evaluation_ids`, `mmdet/datasets/coco.py:485-486`); None = all
    evaluation_class_ids: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class Experiment:
    """The model and data halves of a config (the JAX `ExperimentCfg`
    without its training schedule and optimizer)."""
    name: str
    model: DetectorCfg
    data: DataCfg


def _nus_data(modalities=('lidar', 'radar')) -> DataCfg:
    return DataCfg(dataset='nuscenes', classes=NUSCENES_CLASSES,
                   img_scale=(640, 360),
                   modalities=tuple(modalities),
                   modality_drop_p=(0.2,) * (len(modalities) + 1)
                   if modalities else ())


def hrfuser_backbone(channels: Tuple[int, ...] = (18, 36, 72, 144),
                     heads: Tuple[int, ...] = (1, 2, 4, 8),
                     stage3_modules: int = 3, lidar_c_modules: int = 3,
                     num_modalities: int = 2,
                     mod_in_channels: Tuple[int, ...] = (3, 3)
                     ) -> HRBackboneCfg:
    """HRFormer camera trunk (window 7, mlp ratio 4) with lidar/radar
    streams and MWCA fusion banks before stages 2-4."""
    def stage(n, nm):
        return StageCfg(num_modules=nm, num_branches=n, block='HRFORMER',
                        num_blocks=(2,) * n, num_channels=channels[:n],
                        num_heads=heads[:n], window_sizes=(7,) * n,
                        mlp_ratios=(4,) * n)

    def fusion(n):
        return FusionCfg(num_branches=n, num_channels=channels[:n],
                         num_heads=heads[:n], window_sizes=(7,) * n,
                         mlp_ratios=(4,) * n)

    return HRBackboneCfg(
        stage1=StageCfg(1, 1, 'BOTTLENECK', (2,), (64,)),
        stage2=stage(2, 1), stage3=stage(3, stage3_modules),
        stage4=stage(4, 2),
        stage_a=StageCfg(1, 1, 'BOTTLENECK', (2,), (64,)),
        stage_b=stage(1, 1), stage_c=stage(1, lidar_c_modules),
        fusion_a=fusion(2), fusion_b=fusion(3), fusion_c=fusion(4),
        num_fused_modalities=num_modalities,
        mod_in_channels=tuple(mod_in_channels))


def detector(backbone: HRBackboneCfg, num_classes: int) -> DetectorCfg:
    return DetectorCfg(backbone=backbone,
                       roi=RoIHeadCfg(num_classes=num_classes),
                       rpn_test=RPNTestCfg())


def _tiny_fusion() -> DetectorCfg:
    """Miniature fusion model for fast unit tests (not a reference config)."""
    model = detector(hrfuser_backbone(channels=(8, 16, 24, 32),
                                      heads=(1, 2, 2, 4)), num_classes=4)
    return dataclasses.replace(
        model,
        roi=dataclasses.replace(model.roi, fc_out_channels=64,
                                max_per_img=20),
        rpn_test=dataclasses.replace(model.rpn_test, nms_pre=200,
                                     max_per_img=100),
        neck_out_channels=32)


def _hrfuser_t_nus() -> DetectorCfg:
    return detector(hrfuser_backbone(), num_classes=10)


def _hrfuser_b_nus() -> DetectorCfg:
    """HRFuser-B: the same architecture at widths 78-624, head dim 39
    (`drop_path_rate` is train-only and not carried)."""
    return detector(hrfuser_backbone(channels=(78, 156, 312, 624),
                                     heads=(2, 4, 8, 16), stage3_modules=4,
                                     lidar_c_modules=4), num_classes=10)


_REGISTRY: Dict[str, Callable[[], DetectorCfg]] = {
    'tiny_fusion_test': _tiny_fusion,
    'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion': _hrfuser_t_nus,
    'cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_fusion': _hrfuser_b_nus,
}


def get_config(name: str) -> DetectorCfg:
    """The `DetectorCfg` of a config name."""
    if name not in _REGISTRY:
        raise KeyError(f'unknown config {name!r}; known: {sorted(_REGISTRY)}')
    return _REGISTRY[name]()


def get_experiment(name: str) -> Experiment:
    """The model and data configs of a config name (every registered name
    is a nuScenes camera + lidar + radar config)."""
    return Experiment(name=name, model=get_config(name), data=_nus_data())
