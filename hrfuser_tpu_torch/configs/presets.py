"""Model and data presets for the configurations the port runs.

Copies of `hrfuser_tpu/configs/presets.py:40-252,301-416`: `DetectorCfg`
(see `hr_config.py`), `DataCfg`, `ScheduleCfg` and `OptimCfg`.
`get_config(name)` gives the model half, `get_experiment(name)` all
four. As in the JAX package, every name has a `_bn` alias (one device
computes the same batch statistics with BN and SyncBN) and a `.py` path
resolves to its file name. `tests/test_torch_configs.py` holds each
equal, field for field, to `hrfuser_tpu.configs.get_config(name)`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from hrfuser_tpu_torch.models.backbones.hr_config import (
    FusionCfg, HRBackboneCfg, StageCfg, apply_stochastic_depth)
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (DetectorCfg,
                                                             RPNTestCfg)
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import RoIHeadCfg


NUSCENES_CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
                    'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
                    'barrier')
STF_CLASSES = ('Pedestrian', 'Cyclist', 'Car')


@dataclasses.dataclass(frozen=True)
class OptimCfg:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    # parameter-name substrings excluded from weight decay (the reference
    # decays biases of conv/fc, so 'bias' is NOT excluded; custom_keys at
    # `cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion.py:43-48`)
    no_decay_keys: Tuple[str, ...] = ('relative_position_bias_table', 'norm',
                                     'bn')


@dataclasses.dataclass(frozen=True)
class ScheduleCfg:
    max_epochs: int = 12
    lr_steps: Tuple[int, ...] = (8, 11)
    warmup_iters: int = 500
    warmup_ratio: float = 1e-3
    samples_per_device: int = 3


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
    """A config's model, data, schedule and optimizer (the JAX
    `ExperimentCfg`)."""
    name: str
    model: DetectorCfg
    data: DataCfg
    schedule: ScheduleCfg = ScheduleCfg()
    optim: OptimCfg = OptimCfg()


def _nus_data(modalities=('lidar', 'radar')) -> DataCfg:
    return DataCfg(dataset='nuscenes', classes=NUSCENES_CLASSES,
                   img_scale=(640, 360),
                   modalities=tuple(modalities),
                   modality_drop_p=(0.2,) * (len(modalities) + 1)
                   if modalities else ())


def _stf_data(modalities=('lidar', 'radar', 'gated')) -> DataCfg:
    # Crop(768,1280)@(202,280) -> Resize -> Crop(384,1248)@(192,16);
    # eval GT crop (384,1248)@(394,296) (`kitti_detection_2d_c1248_*`).
    return DataCfg(dataset='stf', classes=STF_CLASSES,
                   img_scale=(1248, 384),
                   modalities=tuple(modalities),
                   modality_drop_p=(0.5,) * (len(modalities) + 1)
                   if modalities else (),
                   crops=((768, 1280, 202, 280), (384, 1248, 192, 16)),
                   eval_on_crop=(384, 1248, 394, 296))


def _hrformer_stages(channels: Tuple[int, ...], heads: Tuple[int, ...],
                     stage3_modules: int) -> Dict[str, StageCfg]:
    """Camera trunk stages shared by all configs (window 7, mlp ratio 4)."""
    def stage(n, nm):
        return StageCfg(num_modules=nm, num_branches=n, block='HRFORMER',
                        num_blocks=(2,) * n, num_channels=channels[:n],
                        num_heads=heads[:n], window_sizes=(7,) * n,
                        mlp_ratios=(4,) * n)
    return dict(
        stage1=StageCfg(1, 1, 'BOTTLENECK', (2,), (64,)),
        stage2=stage(2, 1),
        stage3=stage(3, stage3_modules),
        stage4=stage(4, 2),
    )


def hrformer_backbone(channels: Tuple[int, ...] = (18, 36, 72, 144),
                      heads: Tuple[int, ...] = (1, 2, 4, 8),
                      stage3_modules: int = 3,
                      drop_path_rate: float = 0.0) -> HRBackboneCfg:
    """Camera-only HRFormer trunk: no modality streams, no fusion banks."""
    return apply_stochastic_depth(HRBackboneCfg(
        drop_path_rate=drop_path_rate,
        **_hrformer_stages(channels, heads, stage3_modules)))


def hrfuser_backbone(channels: Tuple[int, ...] = (18, 36, 72, 144),
                     heads: Tuple[int, ...] = (1, 2, 4, 8),
                     stage3_modules: int = 3, lidar_c_modules: int = 3,
                     num_modalities: int = 2,
                     mod_in_channels: Tuple[int, ...] = (3, 3),
                     drop_path_rate: float = 0.0,
                     fusion_drop_path: float = 0.2,
                     proj_drop_rate: float = 0.1) -> HRBackboneCfg:
    """HRFormer camera trunk (window 7, mlp ratio 4) with one stream per
    extra modality and MWCA fusion banks before stages 2-4."""
    def mod_stage(nm):
        return StageCfg(num_modules=nm, num_branches=1, block='HRFORMER',
                        num_blocks=(2,), num_channels=(channels[0],),
                        num_heads=(heads[0],), window_sizes=(7,),
                        mlp_ratios=(4,))

    def fusion(n):
        return FusionCfg(num_branches=n, num_channels=channels[:n],
                         num_heads=heads[:n], window_sizes=(7,) * n,
                         mlp_ratios=(4,) * n, drop_path=fusion_drop_path,
                         proj_drop_rate=proj_drop_rate)

    return apply_stochastic_depth(HRBackboneCfg(
        stage_a=StageCfg(1, 1, 'BOTTLENECK', (2,), (64,)),
        stage_b=mod_stage(1), stage_c=mod_stage(lidar_c_modules),
        fusion_a=fusion(2), fusion_b=fusion(3), fusion_c=fusion(4),
        num_fused_modalities=num_modalities,
        mod_in_channels=tuple(mod_in_channels),
        drop_path_rate=drop_path_rate,
        **_hrformer_stages(channels, heads, stage3_modules)))


def hrfuser_hrnet_backbone(channels: Tuple[int, ...] = (18, 36, 72, 144),
                           heads: Tuple[int, ...] = (1, 2, 4, 8),
                           num_modalities: int = 2,
                           mod_in_channels: Tuple[int, ...] = (3, 3),
                           blocks_per_branch: int = 4,
                           stage_modules: Tuple[int, ...] = (1, 4, 3),
                           fusion_drop_path: float = 0.2,
                           proj_drop_rate: float = 0.1) -> HRBackboneCfg:
    """HRNet-based HRFuser (`HRFuserHRNetBased`,
    `hrfuser_hrnet_based.py:24-314`): a BASIC-block conv trunk and
    modality streams with nearest-upsample conv fuse, and the same MWCA
    fusion banks as the HRFormer-based variant. Defaults are HRNet-W18's
    stage table."""
    def cam_stage(n_br, nm):
        return StageCfg(num_modules=nm, num_branches=n_br, block='BASIC',
                        num_blocks=(blocks_per_branch,) * n_br,
                        num_channels=channels[:n_br])

    def mod_stage(nm):
        return StageCfg(num_modules=nm, num_branches=1, block='BASIC',
                        num_blocks=(blocks_per_branch,),
                        num_channels=(channels[0],))

    def fusion(n):
        return FusionCfg(num_branches=n, num_channels=channels[:n],
                         num_heads=heads[:n], window_sizes=(7,) * n,
                         mlp_ratios=(4,) * n, drop_path=fusion_drop_path,
                         proj_drop_rate=proj_drop_rate)

    return HRBackboneCfg(
        stage1=StageCfg(1, 1, 'BOTTLENECK', (4,), (64,)),
        stage2=cam_stage(2, stage_modules[0]),
        stage3=cam_stage(3, stage_modules[1]),
        stage4=cam_stage(4, stage_modules[2]),
        stage_a=StageCfg(1, 1, 'BOTTLENECK', (4,), (64,)),
        stage_b=mod_stage(1), stage_c=mod_stage(1),
        fusion_a=fusion(2), fusion_b=fusion(3), fusion_c=fusion(4),
        num_fused_modalities=num_modalities,
        mod_in_channels=tuple(mod_in_channels))


def without_drops(model: DetectorCfg) -> DetectorCfg:
    """`model` with drop path and `proj_drop` off (deterministic training,
    for parity checks)."""
    bb = model.backbone
    fusions = {f: dataclasses.replace(getattr(bb, f), drop_path=0.0,
                                      proj_drop_rate=0.0)
               for f in ('fusion_a', 'fusion_b', 'fusion_c', 'fusion_d')
               if getattr(bb, f) is not None}
    return dataclasses.replace(model, backbone=apply_stochastic_depth(
        dataclasses.replace(bb, drop_path_rate=0.0, **fusions)))


def detector(backbone: HRBackboneCfg, num_classes: int) -> DetectorCfg:
    return DetectorCfg(backbone=backbone,
                       roi=RoIHeadCfg(num_classes=num_classes),
                       rpn_test=RPNTestCfg())


def _tiny(backbone: HRBackboneCfg) -> DetectorCfg:
    """Miniature model for fast unit tests (not a reference config)."""
    model = detector(backbone, num_classes=4)
    return dataclasses.replace(
        model,
        roi=dataclasses.replace(model.roi, fc_out_channels=64,
                                max_per_img=20),
        rpn_test=dataclasses.replace(model.rpn_test, nms_pre=200,
                                     max_per_img=100),
        neck_out_channels=32)


_TINY = dict(channels=(8, 16, 24, 32), heads=(1, 2, 2, 4))
_B = dict(channels=(78, 156, 312, 624), heads=(2, 4, 8, 16),
          stage3_modules=4, drop_path_rate=0.4)
_STF_SCHEDULE = dict(max_epochs=60, lr_steps=(40, 50))


def _micro_fusion() -> DetectorCfg:
    """The smallest fusion model that runs every train-step path (two
    modalities, MWCA fusion before every stage, the 3-stage cascade): the
    data-parallel dry run's model
    (`hrfuser_tpu/configs/presets.py:255-298`). One module of one block a
    stage; not a reference config."""
    ch, heads = (8, 16, 24, 32), (1, 1, 1, 1)

    def cam_stage(n):
        return StageCfg(num_modules=1, num_branches=n, block='HRFORMER',
                        num_blocks=(1,) * n, num_channels=ch[:n],
                        num_heads=heads[:n], window_sizes=(7,) * n,
                        mlp_ratios=(2,) * n)

    def mod_stage():
        return StageCfg(num_modules=1, num_branches=1, block='HRFORMER',
                        num_blocks=(1,), num_channels=(ch[0],),
                        num_heads=(1,), window_sizes=(7,), mlp_ratios=(2,))

    def fusion(n):
        return FusionCfg(num_branches=n, num_channels=ch[:n],
                         num_heads=heads[:n], window_sizes=(7,) * n,
                         mlp_ratios=(2,) * n)

    model = detector(HRBackboneCfg(
        stage1=StageCfg(1, 1, 'BOTTLENECK', (1,), (16,)),
        stage2=cam_stage(2), stage3=cam_stage(3), stage4=cam_stage(4),
        stage_a=StageCfg(1, 1, 'BOTTLENECK', (1,), (16,)),
        stage_b=mod_stage(), stage_c=mod_stage(),
        fusion_a=fusion(2), fusion_b=fusion(3), fusion_c=fusion(4),
        num_fused_modalities=2, mod_in_channels=(3, 3)), num_classes=4)
    return dataclasses.replace(
        model,
        roi=dataclasses.replace(model.roi, fc_out_channels=32,
                                max_per_img=8),
        rpn_test=dataclasses.replace(model.rpn_test, nms_pre=64,
                                     max_per_img=32),
        neck_out_channels=32)


# name -> (model, data, schedule, optimizer)
_REGISTRY: Dict[str, Callable[[], Tuple[DetectorCfg, DataCfg, ScheduleCfg,
                                        OptimCfg]]] = {
    'tiny_fusion_test': lambda: (
        _tiny(hrfuser_backbone(**_TINY)), _nus_data(),
        ScheduleCfg(samples_per_device=2), OptimCfg()),
    'micro_fusion_dryrun': lambda: (
        _micro_fusion(), _nus_data(), ScheduleCfg(samples_per_device=1),
        OptimCfg()),
    'tiny_camera_test': lambda: (
        _tiny(hrformer_backbone(**_TINY)), _nus_data(modalities=()),
        ScheduleCfg(samples_per_device=2), OptimCfg()),
    'cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion': lambda: (
        detector(hrfuser_backbone(), num_classes=10), _nus_data(),
        ScheduleCfg(samples_per_device=3), OptimCfg(lr=3e-4)),
    'tiny_hrnet_fusion_test': lambda: (
        _tiny(hrfuser_hrnet_backbone(**_TINY, blocks_per_branch=1,
                                     stage_modules=(1, 1, 1))),
        _nus_data(), ScheduleCfg(samples_per_device=2), OptimCfg()),
    'cascade_rcnn_hrfuser_hrnet_w18_1x_nus_r640_l_r_fusion': lambda: (
        detector(hrfuser_hrnet_backbone(), num_classes=10), _nus_data(),
        ScheduleCfg(samples_per_device=3), OptimCfg(lr=3e-4)),
    'cascade_rcnn_hrfuser_b_1x_nus_r640_l_r_fusion': lambda: (
        detector(hrfuser_backbone(**_B, lidar_c_modules=4), num_classes=10),
        _nus_data(), ScheduleCfg(samples_per_device=2), OptimCfg(lr=3e-4)),
    'cascade_rcnn_hrfuser_t_1x_stf_r1248_4mod': lambda: (
        detector(hrfuser_backbone(num_modalities=3,
                                  mod_in_channels=(3, 2, 1)), num_classes=3),
        _stf_data(), ScheduleCfg(samples_per_device=3, **_STF_SCHEDULE),
        OptimCfg(lr=1e-3)),
    'cascade_rcnn_hrformer_t_1x_nus_r640': lambda: (
        detector(hrformer_backbone(), num_classes=10),
        _nus_data(modalities=()), ScheduleCfg(samples_per_device=6),
        OptimCfg(lr=1e-3)),
    'cascade_rcnn_hrformer_b_1x_nus_r640': lambda: (
        detector(hrformer_backbone(**_B), num_classes=10),
        _nus_data(modalities=()), ScheduleCfg(samples_per_device=2),
        OptimCfg(lr=1e-3)),
    'cascade_rcnn_hrformer_t_1x_stf_c1248': lambda: (
        detector(hrformer_backbone(), num_classes=3),
        _stf_data(modalities=()),
        ScheduleCfg(samples_per_device=3, **_STF_SCHEDULE),
        OptimCfg(lr=1e-3)),
}


def _lookup(name: str):
    """(name as asked, its registry entry): a `.py` path gives its file
    name, and a `_bn` suffix names the same config."""
    if name.endswith('.py'):
        name = name.rsplit('/', 1)[-1][:-3]
    entry = _REGISTRY.get(name[:-3] if name.endswith('_bn') else name)
    if entry is None:
        raise KeyError(f'unknown config {name!r}; known: {list_configs()}')
    return name, entry


def list_configs():
    """Every accepted name, `_bn` aliases included, sorted."""
    return sorted([*_REGISTRY, *(n + '_bn' for n in _REGISTRY)])


def get_config(name: str) -> DetectorCfg:
    """The `DetectorCfg` of a config name."""
    return get_experiment(name).model


def get_experiment(name: str) -> Experiment:
    """The model, data, schedule and optimizer configs of a config name,
    named as asked."""
    name, build = _lookup(name)
    return Experiment(name, *build())
