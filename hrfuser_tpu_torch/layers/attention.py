"""Window attention blocks: LSA, MWCA, CrossFFN, HRFormer/fusion blocks.

Counterpart of `hrfuser_tpu.layers.attention`, with the reference
parameter names (`mmdet/models/backbones/hrformer.py:18-386`,
`hrfuser_hrformer_based.py:21-326`): WindowMSA has a fused qkv
projection, WindowMCA split q/k/v ones.

The `forward` of these modules is the eager (unfolded) computation on
NHWC maps. In eval it is the plain version of kernels A and B, which the
backbone does not call: it runs each block's `folded()` weights through
`ops.chain.hrformer_chain` / `fusion_chain`, which route to the kernels
on CUDA tensors. In training it is the route the backbone takes, as the
JAX package's blocks train without their Pallas chains
(`hrfuser_tpu/ops/pallas_chain.py:84-94`): drop path on each residual
branch, `proj_drop` dropout after the fusion blocks' attention
projections (the HRFormer blocks have none) and batch-statistics
BatchNorm in the CrossFFN
(`hrfuser_tpu/layers/attention.py:133-318`).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from hrfuser_tpu_torch.layers.common import (DropPath, Dropout, LayerNorm,
                                             cached, run_seq)
from hrfuser_tpu_torch.ops.chain import fold_fusion_block, fold_hrformer_block
from hrfuser_tpu_torch.ops.window import (rpe_bias, window_partition,
                                          window_reverse)

Tensor = torch.Tensor


def _attend(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
            num_heads: int) -> Tensor:
    """Windowed MHA core, [B_, N, C] each -> [B_, N, C]."""
    b, n, c = q.shape
    d = c // num_heads

    def heads(t):
        return t.reshape(b, n, num_heads, d).transpose(1, 2)

    attn = (heads(q) * d ** -0.5) @ heads(k).transpose(-1, -2) + bias[None]
    out = torch.softmax(attn, -1) @ heads(v)
    return out.transpose(1, 2).reshape(b, n, c)


class WindowMSA(nn.Module):
    """Fused-qkv window self-attention with RPE (`hrformer.py:18-131`)."""

    def __init__(self, c: int, num_heads: int, ws: int):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = nn.Linear(c, 3 * c)
        self.out_proj = nn.Linear(c, c)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))

    def forward(self, x: Tensor) -> Tensor:              # [B_, N, C]
        q, k, v = self.qkv(x).chunk(3, -1)
        bias = rpe_bias(self.relative_position_bias_table, self.ws)
        return self.out_proj(_attend(q, k, v, bias, self.num_heads))


class WindowMCA(nn.Module):
    """Split-projection window cross-attention
    (`hrfuser_hrformer_based.py:21-151`)."""

    def __init__(self, c: int, num_heads: int, ws: int,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)
        self.proj_drop = Dropout(proj_drop)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))

    def forward(self, xw: Tensor, zw: Tensor) -> Tensor:
        bias = rpe_bias(self.relative_position_bias_table, self.ws)
        out = _attend(self.q_proj(xw), self.k_proj(zw), self.v_proj(zw),
                      bias, self.num_heads)
        return self.proj_drop(self.out_proj(out))


class LocalWindowSelfAttention(nn.Module):
    """LSA: centre-padded window partition around WindowMSA (NHWC io)."""

    def __init__(self, c: int, num_heads: int, ws: int):
        super().__init__()
        self.attn = WindowMSA(c, num_heads, ws)

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, _ = x.shape
        ws = self.attn.ws
        return window_reverse(self.attn(window_partition(x, ws)), b, h, w, ws)


class MultiWindowCrossAttention(nn.Module):
    """MWCA: q windows from the camera, k/v windows from a modality."""

    def __init__(self, c: int, num_heads: int, ws: int,
                 proj_drop: float = 0.0):
        super().__init__()
        self.attn = WindowMCA(c, num_heads, ws, proj_drop)

    def forward(self, x: Tensor, z: Tensor) -> Tensor:
        b, h, w, _ = x.shape
        ws = self.attn.ws
        out = self.attn(window_partition(x, ws), window_partition(z, ws))
        return window_reverse(out, b, h, w, ws)


class CrossFFN(nn.Module):
    """1x1 -> BN -> GELU -> dw3x3 -> BN -> GELU -> 1x1 -> BN -> GELU
    (`hrformer.py:239-295`), reference Sequential indices."""

    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Conv2d(c, hidden, 1), nn.BatchNorm2d(hidden), nn.GELU(),
            nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden),
            nn.BatchNorm2d(hidden), nn.GELU(),
            nn.Conv2d(hidden, c, 1), nn.BatchNorm2d(c), nn.GELU())

    def forward(self, x: Tensor) -> Tensor:              # NHWC
        if self.training:
            return run_seq(self.layers, x)
        return self.layers(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class HRFormerBlock(nn.Module):
    """LN -> LSA -> drop path -> +residual; LN -> CrossFFN -> drop path
    -> +residual."""

    def __init__(self, c: int, num_heads: int, ws: int = 7,
                 mlp_ratio: int = 4, drop_path: float = 0.0):
        super().__init__()
        self.num_heads, self.window_size = num_heads, ws
        self.norm1 = LayerNorm(c, eps=1e-6)
        self.attn = LocalWindowSelfAttention(c, num_heads, ws)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(c, eps=1e-6)
        self.ffn = CrossFFN(c, int(c * mlp_ratio))
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.drop_path1(self.attn(self.norm1(x)))
        return x + self.drop_path2(self.ffn(self.norm2(x)))

    def folded(self):
        """Eval weights for `ops.chain` (`fold_hrformer_block`), cached."""
        return cached(self, 'folded', lambda: fold_hrformer_block(self),
                      list(self.parameters()) + list(self.buffers()))


class HRFuserFusionBlock(nn.Module):
    """MWCA fusion of M modality streams into the camera stream
    (`hrfuser_hrformer_based.py:305-317`):

        x_tmp = x
        for k: x = x + z_k + DropPath_k(MWCA_k(LN1_k(x_tmp), LN2_k(z_k)))
        x = x + DropPath(CrossFFN(LN3(x)))
    """

    def __init__(self, c: int, num_heads: int, num_modalities: int,
                 ws: int = 7, mlp_ratio: int = 4, drop_path: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads, self.window_size = num_heads, ws
        self.norm1 = nn.ModuleList(
            [LayerNorm(c, eps=1e-6) for _ in range(num_modalities)])
        self.norm2 = nn.ModuleList(
            [LayerNorm(c, eps=1e-6) for _ in range(num_modalities)])
        self.attn = nn.ModuleList(
            [MultiWindowCrossAttention(c, num_heads, ws, proj_drop)
             for _ in range(num_modalities)])
        self.drop_path = nn.ModuleList(
            [DropPath(drop_path) for _ in range(num_modalities)])
        self.norm3 = LayerNorm(c, eps=1e-6)
        self.ffn = CrossFFN(c, int(c * mlp_ratio))
        self.drop_path_ffn = DropPath(drop_path)

    def forward(self, x: Tensor, mods: List[Tensor]) -> Tensor:
        x_tmp = x
        for k, z in enumerate(mods):
            a = self.attn[k](self.norm1[k](x_tmp), self.norm2[k](z))
            x = x + z + self.drop_path[k](a)
        return x + self.drop_path_ffn(self.ffn(self.norm3(x)))

    def folded(self):
        """Eval weights for `ops.chain` (`fold_fusion_block`), cached."""
        return cached(self, 'folded', lambda: fold_fusion_block(self),
                      list(self.parameters()) + list(self.buffers()))
