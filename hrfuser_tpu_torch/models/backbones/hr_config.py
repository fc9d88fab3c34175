"""Typed configuration for the HRFormer/HRFuser backbone.

Copy of `hrfuser_tpu.models.backbones.hr_config` restricted to the fields
eval inference reads. Training-only fields (drop-path rates) and the TPU
routing knobs (`remat`, `cf_layout`, `chain_kernel`) are left out;
`tests/test_torch_configs.py` holds every remaining field equal to the
JAX original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return self.stage4.out_channels
