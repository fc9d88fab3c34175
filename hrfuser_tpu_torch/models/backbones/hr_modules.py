"""HR multi-branch modules and transitions (NHWC).

Counterpart of `hrfuser_tpu.models.backbones.hr_modules`: `HRModule`
(`mmdet/models/backbones/hrnet.py:14-207`) of HRFormer blocks with
depthwise-separable fuse downsampling (`hrformer.py:524-561`) or of
BASIC / BOTTLENECK residual blocks with HRNet's conv fuse paths, and
`_make_transition_layer` (`hrnet.py:422-463`). Containers subclass
`nn.ModuleList` so the parameter names are the reference's.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hrfuser_tpu_torch.layers.attention import HRFormerBlock
from hrfuser_tpu_torch.layers.common import (bilinear_resize, conv3x3,
                                             nearest_up, remat, res_layer,
                                             run_seq)
from hrfuser_tpu_torch.models.backbones.hr_config import StageCfg
from hrfuser_tpu_torch.ops.chain import hrformer_chain

Tensor = torch.Tensor


def _conv_bn_relu(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(conv3x3(cin, cout, stride), nn.BatchNorm2d(cout),
                         nn.ReLU())


class Transition(nn.ModuleList):
    """Between-stage branch adaptation (`hrnet.py:422-463`).

    Existing branches: 3x3 conv+BN+ReLU on a channel change, identity
    otherwise. New branches: a chain of stride-2 3x3 conv+BN+ReLU on the
    last input branch. Like the JAX `Transition`, every non-identity
    path reads the last input branch.
    """

    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int]):
        pre = len(in_channels)
        mods = []
        for i, oc in enumerate(out_channels):
            if i < pre:
                mods.append(_conv_bn_relu(in_channels[i], oc, 1)
                            if oc != in_channels[i] else nn.Identity())
                continue
            steps, cin = [], in_channels[-1]
            for j in range(i + 1 - pre):
                ch = oc if j == i - pre else in_channels[-1]
                steps.append(_conv_bn_relu(cin, ch, 2))
                cin = ch
            mods.append(nn.Sequential(*steps))
        super().__init__(mods)

    def forward(self, xs: List[Tensor],
                conv_only_on_existing: bool = False) -> List[Tensor]:
        """`conv_only_on_existing` is the HRFuser stage-2 quirk
        (`hrfuser_hrformer_based.py:553`, `transition1[i][0]`): existing
        branches run only the conv, new ones only the first step."""
        out = []
        for i, m in enumerate(self):
            if isinstance(m, nn.Identity):
                out.append(xs[i])
            elif conv_only_on_existing:
                out.append(run_seq(m[0], xs[-1]))
            else:
                out.append(run_seq(m, xs[-1]))
        return out


class FuseUp(nn.Sequential):
    """Fuse path j > i (`FuseUp`, `hr_modules.py:75-96`): 1x1 conv + BN,
    then to the target size. HRFormer modules resize bilinearly
    (`hrnet.py:199-203`); HRNet's conv modules upsample nearest by
    `factor` (`hrnet.py:146`) and resize bilinearly only if the size
    still differs. The reference's parameter-free `nn.Upsample` at index
    2 of this Sequential leaves no name in the state dict, so the
    upsample is done here, in `forward`."""

    def __init__(self, cin: int, cout: int, factor: int, nearest: bool):
        super().__init__(nn.Conv2d(cin, cout, 1, bias=False),
                         nn.BatchNorm2d(cout))
        self.factor, self.nearest = factor, nearest

    def forward(self, x: Tensor, out_hw) -> Tensor:
        x = run_seq(self, x)
        if self.nearest:
            x = nearest_up(x, self.factor)
            if tuple(x.shape[1:3]) == tuple(out_hw):
                return x
        return bilinear_resize(x, out_hw)


def fuse_down(cin: int, cout: int, steps: int, former: bool
              ) -> nn.Sequential:
    """Fuse path j < i: `steps` stride-2 steps, ReLU on all but the last.
    HRFormer: depthwise 3x3 + BN, 1x1 + BN (`hrformer.py:524-557`);
    HRNet: 3x3 + BN (`hrnet.py:150-177`). Every step but the last keeps
    the source width."""
    seq = []
    for k in range(steps):
        last = k == steps - 1
        ch = cout if last else cin
        if former:
            sub = [conv3x3(cin, cin, 2, groups=cin), nn.BatchNorm2d(cin),
                   nn.Conv2d(cin, ch, 1, bias=False), nn.BatchNorm2d(ch)]
        else:
            sub = [conv3x3(cin, ch, 2), nn.BatchNorm2d(ch)]
        if not last:
            sub.append(nn.ReLU())
        seq.append(nn.Sequential(*sub))
    return nn.Sequential(*seq)


class HRModule(nn.Module):
    """One multi-resolution exchange module.

    HRFormer branches: in eval each branch's block pair runs as one
    `hrformer_chain` (`hrfuser_tpu/models/backbones/hr_modules.py:
    168-183`); in training the blocks run their eager forward, as JAX's
    `resolve_chain(mode, train=True)` routes them. Block j of module m
    takes drop-path rate `drop_path_rates[m * num_blocks[0] + j]` (the
    last rate past the end, `hr_modules.py:195-198`). BASIC / BOTTLENECK
    branches: one `res_layer` each (`hr_modules.py:200-203`).

    Then the all-to-all fuse, summed and ReLU'd: up-paths `FuseUp`,
    down-paths stride-2 chains (`fuse_down`).
    """

    def __init__(self, stage: StageCfg, module_index: int = 0):
        super().__init__()
        nb = stage.num_branches
        out = stage.out_channels
        self.former = stage.block == 'HRFORMER'
        self.num_heads = stage.num_heads
        if self.former:
            rates = stage.drop_path_rates
            base = module_index * stage.num_blocks[0]
            self.branches = nn.ModuleList([
                nn.Sequential(*[HRFormerBlock(
                    out[i], stage.num_heads[i], stage.window_sizes[i],
                    stage.mlp_ratios[i],
                    drop_path=rates[min(base + j, len(rates) - 1)])
                    for j in range(stage.num_blocks[i])])
                for i in range(nb)])
        else:
            self.branches = nn.ModuleList([
                res_layer(stage.block, out[i], stage.num_channels[i],
                          stage.num_blocks[i]) for i in range(nb)])
        if nb == 1:
            self.fuse_layers = None
            return
        fuse = []
        for i in range(nb):
            row = []
            for j in range(nb):
                if j == i:
                    row.append(nn.Identity())
                elif j > i:
                    row.append(FuseUp(out[j], out[i], 2 ** (j - i),
                                      nearest=not self.former))
                else:
                    row.append(fuse_down(out[j], out[i], i - j,
                                         self.former))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def branch_blocks(self, i: int):
        """Folded eval weights of HRFormer branch i's blocks, in order."""
        return [blk.folded() for blk in self.branches[i]]

    def forward(self, xs: List[Tensor]) -> List[Tensor]:
        if self.training or not self.former:
            feats = [branch(x) for branch, x in zip(self.branches, xs)]
        else:
            feats = [hrformer_chain(x, self.branch_blocks(i),
                                    self.num_heads[i])
                     for i, x in enumerate(xs)]
        if self.fuse_layers is None:
            return feats
        outs = []
        for i, row in enumerate(self.fuse_layers):
            y = feats[i]
            for j, path in enumerate(row):
                if j == i:
                    continue
                y = y + (path(feats[j], feats[i].shape[1:3]) if j > i
                         else run_seq(path, feats[j]))
            outs.append(F.relu(y))
        return outs


class HRStage(nn.ModuleList):
    """`num_modules` HRModules in sequence (`HRNet._make_stage`); with
    `remat`, each module of a training step is rematerialised in the
    backward (`hr_modules.py:250-252`)."""

    def __init__(self, stage: StageCfg, remat: bool = False):
        super().__init__([HRModule(stage, m)
                          for m in range(stage.num_modules)])
        self.remat = remat

    def forward(self, xs: List[Tensor]) -> List[Tensor]:
        for m in self:
            xs = remat(m, xs) if self.remat else m(xs)
        return xs
