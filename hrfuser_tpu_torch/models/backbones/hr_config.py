"""Typed configuration for the HRFormer/HRFuser backbone.

Copy of `hrfuser_tpu.models.backbones.hr_config` with the stochastic
depth schedule (`apply_stochastic_depth`). The TPU routing knobs
(`remat`, `cf_layout`, `chain_kernel`) and the pre-neck fusion stage
no preset sets (`stage_d`, `fusion_d`) are left out;
`tests/test_torch_configs.py` holds every remaining field equal to the
JAX original.
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
    block: str                               # BOTTLENECK | HRFORMER
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
    """HRFuser backbone: 4 camera stages, modality streams and fusions."""
    stage1: StageCfg
    stage2: StageCfg
    stage3: StageCfg
    stage4: StageCfg
    stage_a: Optional[StageCfg] = None
    stage_b: Optional[StageCfg] = None
    stage_c: Optional[StageCfg] = None
    fusion_a: Optional[FusionCfg] = None
    fusion_b: Optional[FusionCfg] = None
    fusion_c: Optional[FusionCfg] = None
    num_fused_modalities: int = 0
    mod_in_channels: Tuple[int, ...] = ()
    drop_path_rate: float = 0.0

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return self.stage4.out_channels


def _with_drop_paths(stage: StageCfg, rates) -> StageCfg:
    return dataclasses.replace(stage, drop_path_rates=tuple(float(r)
                                                            for r in rates))


def apply_stochastic_depth(cfg: HRBackboneCfg) -> HRBackboneCfg:
    """Spread `drop_path_rate` linearly over the block positions of stages
    2-4 (`hrfuser_tpu/models/backbones/hr_config.py:106-131`, the
    reference `hrformer.py:666-678`); modality stages B and C reuse the
    rates of camera stages 2 and 3."""
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
    return dataclasses.replace(cfg, **updates)
