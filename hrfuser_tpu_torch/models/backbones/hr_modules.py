"""HR multi-branch modules and transitions (NHWC).

Counterpart of `hrfuser_tpu.models.backbones.hr_modules` for the HRFormer
block type: `HRModule` (`mmdet/models/backbones/hrnet.py:14-207`) with
depthwise-separable fuse downsampling (`hrformer.py:524-561`), and
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


class HRModule(nn.Module):
    """One multi-resolution exchange module of HRFormer blocks.

    In eval each branch's block pair runs as one `hrformer_chain`
    (`hrfuser_tpu/models/backbones/hr_modules.py:168-183`); in training
    the blocks run their eager forward, as JAX's `resolve_chain(mode,
    train=True)` routes them. Then the all-to-all fuse: up-paths 1x1+BN
    and a bilinear resize, down-paths depthwise-separable stride-2
    chains, summed and ReLU'd. Block j of module m takes drop-path rate
    `drop_path_rates[m * num_blocks[0] + j]` (the last rate past the end,
    `hr_modules.py:195-198`).
    """

    def __init__(self, stage: StageCfg, module_index: int = 0):
        super().__init__()
        assert stage.block == 'HRFORMER', stage.block
        nb = stage.num_branches
        out = stage.out_channels
        self.num_heads = stage.num_heads
        rates = stage.drop_path_rates
        base = module_index * stage.num_blocks[0]
        self.branches = nn.ModuleList([
            nn.Sequential(*[HRFormerBlock(
                out[i], stage.num_heads[i], stage.window_sizes[i],
                stage.mlp_ratios[i],
                drop_path=rates[min(base + j, len(rates) - 1)])
                for j in range(stage.num_blocks[i])])
            for i in range(nb)])
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
                    row.append(nn.Sequential(
                        nn.Conv2d(out[j], out[i], 1, bias=False),
                        nn.BatchNorm2d(out[i])))
                else:
                    steps = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        ch = out[i] if last else out[j]
                        sub = [conv3x3(out[j], out[j], 2, groups=out[j]),
                               nn.BatchNorm2d(out[j]),
                               nn.Conv2d(out[j], ch, 1, bias=False),
                               nn.BatchNorm2d(ch)]
                        if not last:
                            sub.append(nn.ReLU())
                        steps.append(nn.Sequential(*sub))
                    row.append(nn.Sequential(*steps))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def branch_blocks(self, i: int):
        """Folded eval weights of branch i's blocks, in order."""
        return [blk.folded() for blk in self.branches[i]]

    def forward(self, xs: List[Tensor]) -> List[Tensor]:
        if self.training:
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
                t = run_seq(path, feats[j])
                if j > i:
                    t = bilinear_resize(t, feats[i].shape[1:3])
                y = y + t
            outs.append(F.relu(y))
        return outs


class HRStage(nn.ModuleList):
    """`num_modules` HRModules in sequence (`HRNet._make_stage`)."""

    def __init__(self, stage: StageCfg):
        super().__init__([HRModule(stage, m)
                          for m in range(stage.num_modules)])

    def forward(self, xs: List[Tensor]) -> List[Tensor]:
        for m in self:
            xs = m(xs)
        return xs
