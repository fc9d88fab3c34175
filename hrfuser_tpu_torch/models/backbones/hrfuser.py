"""HRFuser multi-modal fusion backbone, NHWC.

Counterpart of `hrfuser_tpu.models.backbones.hrfuser`: the reference's
`HRFuserHRFormerBased` (`mmdet/models/backbones/hrfuser_hrformer_based.py:
331-628`) and, through the stages' block types, `HRFuserHRNetBased`
(`hrfuser_hrnet_based.py:24-314`). The camera follows the HRFormer or
HRNet trunk; each extra modality gets its own stem + Bottleneck stage A,
then stays a single stride-4 branch through stages B/C (HRFormer blocks
or BASIC residual blocks). Before every camera stage each modality is
transitioned to every camera branch's width and fused into the camera
feature by an `HRFuserFusionBlock`; modality stages consume the branch-0
transitioned feature. With `cfg.pre_neck_fusion`, a modality stage D,
its transition and fusion bank D run on the stage-4 outputs, then a ReLU
(`hrfuser_tpu/models/backbones/hrfuser.py:261-274`). Parameter names are
the reference's. In training the fusion blocks and HRFormer stages run
their blocks' eager forward instead of the eval chains (the JAX
`resolve_chain(mode, train=True) -> False`); with `cfg.remat` each
HRModule and fusion block of a training step is rematerialised in the
backward (`hrfuser.py:75-76`, `hr_modules.py:250-252`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from hrfuser_tpu_torch.layers.attention import HRFuserFusionBlock
from hrfuser_tpu_torch.layers.common import conv3x3, remat, res_layer
from hrfuser_tpu_torch.models.backbones.hr_config import (FusionCfg,
                                                          HRBackboneCfg,
                                                          StageCfg)
from hrfuser_tpu_torch.models.backbones.hr_modules import (HRStage,
                                                           Transition)
from hrfuser_tpu_torch.models.backbones.hrformer import stem
from hrfuser_tpu_torch.ops.chain import fusion_chain, hrformer_chain

Tensor = torch.Tensor


class FusionBank(nn.ModuleList):
    """One `HRFuserFusionBlock` per camera branch, each run in eval as one
    `fusion_chain` (`hrfuser_tpu/models/backbones/hrfuser.py:53-74`)."""

    def __init__(self, fusion: FusionCfg, num_modalities: int,
                 remat: bool = False):
        super().__init__([
            HRFuserFusionBlock(fusion.num_channels[i], fusion.num_heads[i],
                               num_modalities, fusion.window_sizes[i],
                               fusion.mlp_ratios[i], fusion.drop_path,
                               fusion.proj_drop_rate)
            for i in range(fusion.num_branches)])
        self.remat = remat

    def forward(self, xs: List[Tensor], mods: List[List[Tensor]]
                ) -> List[Tensor]:
        if self.training:
            return [remat(blk, x, ms) if self.remat else blk(x, ms)
                    for blk, x, ms in zip(self, xs, mods)]
        return [fusion_chain(x, mods[i], self[i].folded(),
                             self[i].num_heads) for i, x in enumerate(xs)]


class ModalityStage(nn.ModuleList):
    """A single-branch stage per modality. An HRFormer stage has no fuse
    layers, so in eval the whole stage is a block chain: all its
    modules' blocks of all modalities run as one `hrformer_chain`
    (`hrfuser.py:123-145`), stage D too (JAX runs D's blocks unchained,
    `hrfuser.py:262`; the math is the same). A conv stage runs each
    modality's `HRStage` (`hrfuser.py:146-152`)."""

    def __init__(self, stage: StageCfg, num_modalities: int,
                 remat: bool = False):
        if stage.num_branches != 1:
            raise ValueError(f'a modality stage has one branch, not '
                             f'{stage.num_branches}')
        super().__init__([HRStage(stage, remat)
                          for _ in range(num_modalities)])
        self.former = stage.block == 'HRFORMER'
        self.num_heads = stage.num_heads[0] if self.former else None

    def forward(self, feats: List[Tensor]) -> List[Tensor]:
        if self.training or not self.former:
            return [stage([f])[0] for stage, f in zip(self, feats)]
        blocks = [blk for per_mod in self for module in per_mod
                  for blk in module.branch_blocks(0)]
        y = hrformer_chain(torch.cat(feats), blocks, self.num_heads,
                           n_streams=len(self))
        return list(y.chunk(len(self)))


class ModalityTransition(nn.ModuleList):
    """Per-modality `Transition` (`_make_mod_transition_layer`)."""

    def __init__(self, in_channels, out_channels, num_modalities: int):
        super().__init__([Transition(in_channels, out_channels)
                          for _ in range(num_modalities)])

    def forward(self, feats: List[Tensor]) -> List[List[Tensor]]:
        """out[i][k] = modality k at camera branch i."""
        per_mod = [t([f]) for t, f in zip(self, feats, strict=True)]
        return [list(branch) for branch in zip(*per_mod)]


class HRFuserBackbone(nn.Module):
    def __init__(self, cfg: HRBackboneCfg):
        super().__init__()
        self.cfg = cfg
        nm = cfg.num_fused_modalities
        # camera stem + stage 1
        self.conv1 = conv3x3(3, 64, 2)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = res_layer(cfg.stage1.block, 64,
                                cfg.stage1.num_channels[0],
                                cfg.stage1.num_blocks[0])
        # modality stems + stage A
        self.conv_a = nn.ModuleList([conv3x3(c, 64, 2)
                                     for c in cfg.mod_in_channels[:nm]])
        self.norm_a = nn.ModuleList([nn.BatchNorm2d(64) for _ in range(nm)])
        self.conv_b = nn.ModuleList([conv3x3(64, 64, 2) for _ in range(nm)])
        self.norm_b = nn.ModuleList([nn.BatchNorm2d(64) for _ in range(nm)])
        self.layer_a = nn.ModuleList([
            res_layer(cfg.stage_a.block, 64, cfg.stage_a.num_channels[0],
                      cfg.stage_a.num_blocks[0]) for _ in range(nm)])
        # camera transitions + stages
        self.transition1 = Transition(cfg.stage1.out_channels,
                                      cfg.stage2.out_channels)
        self.transition2 = Transition(cfg.stage2.out_channels,
                                      cfg.stage3.out_channels)
        self.transition3 = Transition(cfg.stage3.out_channels,
                                      cfg.stage4.out_channels)
        self.stage2 = HRStage(cfg.stage2, cfg.remat)
        self.stage3 = HRStage(cfg.stage3, cfg.remat)
        self.stage4 = HRStage(cfg.stage4, cfg.remat)
        # modality transitions, stages and fusion banks
        self.transition_a = ModalityTransition(
            cfg.stage_a.out_channels, cfg.fusion_a.num_channels, nm)
        self.transition_b = ModalityTransition(
            cfg.stage_b.out_channels, cfg.fusion_b.num_channels, nm)
        self.transition_c = ModalityTransition(
            cfg.stage_c.out_channels, cfg.fusion_c.num_channels, nm)
        self.stage_b = ModalityStage(cfg.stage_b, nm, cfg.remat)
        self.stage_c = ModalityStage(cfg.stage_c, nm, cfg.remat)
        self.fusion_a = FusionBank(cfg.fusion_a, nm, cfg.remat)
        self.fusion_b = FusionBank(cfg.fusion_b, nm, cfg.remat)
        self.fusion_c = FusionBank(cfg.fusion_c, nm, cfg.remat)
        if cfg.pre_neck_fusion:
            self.stage_d = ModalityStage(cfg.stage_d, nm, cfg.remat)
            self.transition_d = ModalityTransition(
                cfg.stage_d.out_channels, cfg.fusion_d.num_channels, nm)
            self.fusion_d = FusionBank(cfg.fusion_d, nm, cfg.remat)

    def unused_parameters(self) -> List[nn.Parameter]:
        """The reference's BatchNorms beside the stage-2 transition convs
        of existing branches, which `forward` never reads (it runs the
        conv only, `conv_only_on_existing`); JAX's tree has none."""
        n = len(self.cfg.stage1.out_channels)
        return [p for m in list(self.transition1)[:n]
                if isinstance(m, nn.Sequential)
                for p in m[1].parameters()]

    def forward(self, x: Tensor, x_mods: List[Tensor]) -> List[Tensor]:
        """x: [B, H, W, 3]; x_mods: per-modality [B, H, W, C_k]. Returns
        one NHWC map per camera branch (strides 4, 8, 16, 32)."""
        nm = self.cfg.num_fused_modalities
        if len(x_mods) != nm:
            raise ValueError(f'expected {nm} modality inputs, '
                             f'got {len(x_mods)}')
        x = self.layer1(stem(x, self.conv1, self.bn1, self.conv2, self.bn2))
        mods = [self.layer_a[k](stem(m, self.conv_a[k], self.norm_a[k],
                                     self.conv_b[k], self.norm_b[k]))
                for k, m in enumerate(x_mods)]

        # stage 2 (+ fusion A, modality stage B)
        xs = self.transition1([x], conv_only_on_existing=True)
        m_br = self.transition_a(mods)
        ys = self.stage2(self.fusion_a(xs, m_br))
        mods = self.stage_b(m_br[0])

        # stage 3 (+ fusion B, modality stage C)
        xs = self.transition2(ys)
        m_br = self.transition_b(mods)
        ys = self.stage3(self.fusion_b(xs, m_br))
        mods = self.stage_c(m_br[0])

        # stage 4 (+ fusion C)
        xs = self.transition3(ys)
        m_br = self.transition_c(mods)
        ys = self.stage4(self.fusion_c(xs, m_br))
        if not self.cfg.pre_neck_fusion:
            return ys

        # modality stage D + pre-neck fusion
        m_br = self.transition_d(self.stage_d(m_br[0]))
        return [F.relu(y) for y in self.fusion_d(ys, m_br)]
