"""Typed configuration for the HRNet/HRFormer/HRFuser backbone family.

Copy of `hrfuser_tpu.models.backbones.hr_config`: the stage and fusion
dataclasses, the stochastic depth schedule (`apply_stochastic_depth`)
and the parser of a reference-style `extra` dict
(`backbone_cfg_from_extra`). `remat` rematerialises each HRModule and
fusion block in a training backward (`torch.utils.checkpoint`,
`layers/common.remat`); the TPU routing knobs (`cf_layout`,
`chain_kernel`) are left out. `tests/test_torch_configs.py` holds every
remaining field equal to the JAX original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class StageCfg:
    """One HR stage (or modality stage): `num_modules` HRModules."""
    num_modules: int
    num_branches: int
    block: str                               # BOTTLENECK | BASIC | HRFORMER
    num_blocks: Tuple[int, ...]
    num_channels: Tuple[int, ...]
    num_heads: Tuple[int, ...] = ()
    window_sizes: Tuple[int, ...] = ()
    mlp_ratios: Tuple[int, ...] = ()
    drop_path_rates: Tuple[float, ...] = (0.0,)

    @property
    def expansion(self) -> int:
        return 4 if self.block == 'BOTTLENECK' else 1

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(c * self.expansion for c in self.num_channels)


@dataclasses.dataclass(frozen=True)
class FusionCfg:
    """One MWCA fusion bank (one HRFuserFusionBlock per camera branch)."""
    num_branches: int
    num_channels: Tuple[int, ...]
    num_heads: Tuple[int, ...]
    window_sizes: Tuple[int, ...]
    mlp_ratios: Tuple[int, ...]
    drop_path: float = 0.0
    proj_drop_rate: float = 0.0


@dataclasses.dataclass(frozen=True)
class HRBackboneCfg:
    """Full backbone: 4 camera stages, optional modality streams and
    fusions; `stage_d` / `fusion_d` add the pre-neck fusion."""
    stage1: StageCfg
    stage2: StageCfg
    stage3: StageCfg
    stage4: StageCfg
    stage_a: Optional[StageCfg] = None
    stage_b: Optional[StageCfg] = None
    stage_c: Optional[StageCfg] = None
    stage_d: Optional[StageCfg] = None
    fusion_a: Optional[FusionCfg] = None
    fusion_b: Optional[FusionCfg] = None
    fusion_c: Optional[FusionCfg] = None
    fusion_d: Optional[FusionCfg] = None
    num_fused_modalities: int = 0
    mod_in_channels: Tuple[int, ...] = ()
    drop_path_rate: float = 0.0
    # rematerialise each HRModule / fusion block in the backward of a
    # training step: their activations are recomputed, not kept
    remat: bool = False

    @property
    def pre_neck_fusion(self) -> bool:
        return self.stage_d is not None

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return self.stage4.out_channels


def _with_drop_paths(stage: StageCfg, rates) -> StageCfg:
    return dataclasses.replace(stage, drop_path_rates=tuple(float(r)
                                                            for r in rates))


def apply_stochastic_depth(cfg: HRBackboneCfg) -> HRBackboneCfg:
    """Spread `drop_path_rate` linearly over the block positions of stages
    2-4 (`hrfuser_tpu/models/backbones/hr_config.py:106-132`, the
    reference `hrformer.py:666-678`); modality stages B, C and D reuse
    the rates of camera stages 2, 3 and 4."""
    stages = [cfg.stage2, cfg.stage3, cfg.stage4]
    depths = [s.num_blocks[0] * s.num_modules for s in stages]
    dpr = list(np.linspace(0, cfg.drop_path_rate, sum(depths)))
    s2 = _with_drop_paths(cfg.stage2, dpr[:depths[0]])
    s3 = _with_drop_paths(cfg.stage3, dpr[depths[0]:depths[0] + depths[1]])
    s4 = _with_drop_paths(cfg.stage4, dpr[depths[0] + depths[1]:])
    updates = dict(stage2=s2, stage3=s3, stage4=s4)
    if cfg.stage_b is not None:
        updates['stage_b'] = _with_drop_paths(cfg.stage_b, s2.drop_path_rates)
    if cfg.stage_c is not None:
        updates['stage_c'] = _with_drop_paths(cfg.stage_c, s3.drop_path_rates)
    if cfg.stage_d is not None:
        updates['stage_d'] = _with_drop_paths(cfg.stage_d, s4.drop_path_rates)
    return dataclasses.replace(cfg, **updates)


def stage_from_dict(d: dict) -> StageCfg:
    """A stage of a reference `extra` dict (`HRFORMERBLOCK` is
    `HRFORMER`)."""
    return StageCfg(
        num_modules=d['num_modules'],
        num_branches=d['num_branches'],
        block='HRFORMER' if d['block'] in ('HRFORMER', 'HRFORMERBLOCK')
        else d['block'],
        num_blocks=tuple(d['num_blocks']),
        num_channels=tuple(d['num_channels']),
        num_heads=tuple(d.get('num_heads', ())),
        window_sizes=tuple(d.get('window_sizes', ())),
        mlp_ratios=tuple(d.get('mlp_ratios', ())),
    )


def fusion_from_dict(d: dict) -> FusionCfg:
    """A fusion bank (`ModFusion*`) of a reference `extra` dict."""
    return FusionCfg(
        num_branches=d['num_branches'],
        num_channels=tuple(d['num_channels']),
        num_heads=tuple(d['num_heads']),
        window_sizes=tuple(d['window_sizes']),
        mlp_ratios=tuple(d['mlp_ratios']),
        drop_path=d.get('drop_path', 0.0),
        proj_drop_rate=d.get('proj_drop_rate', 0.0),
    )


_STAGES = (('LidarStageA', 'stage_a'), ('LidarStageB', 'stage_b'),
           ('LidarStageC', 'stage_c'), ('LidarStageD', 'stage_d'))
_FUSIONS = (('ModFusionA', 'fusion_a'), ('ModFusionB', 'fusion_b'),
            ('ModFusionC', 'fusion_c'), ('ModFusionD', 'fusion_d'))


def backbone_cfg_from_extra(extra: dict, num_fused_modalities: int = 0,
                            mod_in_channels=(), drop_path_rate: float = 0.0
                            ) -> HRBackboneCfg:
    """An `HRBackboneCfg` from a reference-style `extra` dict
    (`hrfuser_tpu/models/backbones/hr_config.py:158-183`); a
    `LidarStageD` and `ModFusionD` turn on the pre-neck fusion."""
    kw = dict(
        stage1=stage_from_dict(extra['stage1']),
        stage2=stage_from_dict(extra['stage2']),
        stage3=stage_from_dict(extra['stage3']),
        stage4=stage_from_dict(extra['stage4']),
        num_fused_modalities=num_fused_modalities,
        mod_in_channels=tuple(mod_in_channels),
        drop_path_rate=drop_path_rate,
    )
    for src, dst in _STAGES:
        if extra.get(src):
            kw[dst] = stage_from_dict(extra[src])
    for src, dst in _FUSIONS:
        if extra.get(src):
            kw[dst] = fusion_from_dict(extra[src])
    return apply_stochastic_depth(HRBackboneCfg(**kw))
