"""HRFormer and HRFuser fusion block chains, eval, on NHWC tensors.

Counterpart of `hrfuser_tpu/ops/pallas_chain.py`. A block is two halves:

  * the window-attention half, served by kernel A (`csrc/
    window_attention.cu`) through `window_self_attention` (HRFormerBlock:
    `x + Wo . MHSA(LN1 x)`) and `window_cross_attention` (one modality of
    an HRFuserFusionBlock: `acc + z + Wo . MHCA(LN1 x_frozen, LN2 z)`);
  * the CrossFFN half, served by kernel B (`csrc/cross_ffn.cu`) through
    `cross_ffn` (`x + CrossFFN(LN x)`).

`hrformer_chain` and `fusion_chain` run whole chains through them.

The kernels are reached only through two registered ops,
`hrfuser::window_attention` (A) and `hrfuser::cross_ffn` (B)
(`torch.library.custom_op`): on a CPU tensor an op runs its plain
PyTorch twin (`*_plain`, float32 math, output in the input's dtype), on
a CUDA tensor it launches its kernel or raises, and its fake
implementation gives a tracer (`torch.export`) the output's shape, dtype
and contiguous layout. An op takes the folded weights as tensors and the
name of the entry whose `<wrapper>.launches` its CUDA implementation
bumps (`counts_launches`), so an exported program's launches count as
eager ones do. `launch_window_attention` and `launch_cross_ffn` validate
and launch without counting; the other ops modules' entries
(`ops/block.py`, `ops/window_attention.py`) call the same ops and keep
their own counts. `attention_plan` / `ffn_plan` report the shared-memory
plan each kernel's host code picks for a width, and raise with the byte
count when none fits.

The kernels take weights folded for eval (`fold_hrformer_block`,
`fold_fusion_block`): the BatchNorms folded into the CrossFFN convs with
their running statistics (as `pallas_chain.py:760-772` does), and the
attention scale d^-0.5 folded into Wq / bq (`pallas_chain.py:740-753,
587-598`). Folded tensors are float32 and contiguous; q, k and v weights
are one [C, 3C] matrix in both modes. Folding also packs the projection
weights once as bf16 in the layout the kernels' tensor-core plan reads
(`pack_attention`, `pack_cross_ffn`: keys ending in `_p`), used for
bfloat16 activations.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hrfuser_tpu_torch.layers.common import fold_bn, layer_norm
from hrfuser_tpu_torch.ops.window import (center_pad_shape, rpe_bias,
                                          window_partition, window_reverse)
from hrfuser_tpu_torch.utils import cuda_build

Tensor = torch.Tensor
Folded = Dict[str, Tensor]

_ACT_DTYPES = (torch.float32, torch.bfloat16)
SMEM_MAX = 232448            # shared memory an H100 block may use, bytes


# ---------------------------------------------------------------------------
# weight folding
# ---------------------------------------------------------------------------

def _ln(norm: nn.LayerNorm) -> Tensor:
    return torch.stack([norm.weight, norm.bias]).float().contiguous()


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pad_bf16(w: Tensor, rows: int, cols: int) -> Tensor:
    """`w` [r, c] zero-padded to [rows, cols], bf16, contiguous."""
    out = w.new_zeros((rows, cols), dtype=torch.bfloat16)
    out[:w.shape[0], :w.shape[1]] = w
    return out


def pack_attention(p: Folded, num_heads: int) -> Folded:
    """`p` with kernel A's tensor-core weights added, bf16 [N][K] (the
    folded weight transposed, K contiguous), zero-padded:

      wqkv_p [heads * 3 * dp, KP]  rows of head h: q_h | k_h | v_h, each
                                   its d rows then zeros up to dp
      wo_p   [round64(C), KP]      Wo^T

    with d = C / heads, dp = round16(d) (39 -> 48, as the TPU stackers pad
    odd head dims), KP = round64(C)."""
    wqkv = p['wqkv']
    c = wqkv.shape[0]
    d = c // num_heads
    dp, kp = _round_up(d, 16), _round_up(c, 64)
    w = wqkv.t().reshape(3, num_heads, d, c).transpose(0, 1)
    heads = wqkv.new_zeros((num_heads, 3, dp, c))
    heads[:, :, :d] = w
    return dict(p, wqkv_p=_pad_bf16(heads.reshape(-1, c),
                                    num_heads * 3 * dp, kp),
                wo_p=_pad_bf16(p['wo'].t(), _round_up(c, 64), kp))


def pack_cross_ffn(p: Folded) -> Folded:
    """`p` with kernel B's tensor-core weights added, bf16, zero-padded:
    w1_p [round64(4C), round64(C)] = W1^T, w2_p [round64(C), round64(4C)]
    = W2^T."""
    c, ch = p['w1'].shape
    cp, chp = _round_up(c, 64), _round_up(ch, 64)
    return dict(p, w1_p=_pad_bf16(p['w1'].t(), chp, cp),
                w2_p=_pad_bf16(p['w2'].t(), cp, chp))


def _fold_attention(lnq: Tensor, lnkv: Tensor, w: Tensor, b: Tensor,
                    out_proj: nn.Linear, table: Tensor, num_heads: int,
                    ws: int) -> Folded:
    """w, b: q | k | v projections stacked in torch Linear layout,
    [3C, C] and [3C]."""
    c = out_proj.weight.shape[0]
    scale = torch.ones(3 * c, device=w.device)
    scale[:c] = (c // num_heads) ** -0.5
    return pack_attention(dict(
        lnq=lnq, lnkv=lnkv,
        wqkv=(w.float() * scale[:, None]).t().contiguous(),
        bqkv=(b.float() * scale).contiguous(),
        wo=out_proj.weight.float().t().contiguous(),
        bo=out_proj.bias.detach().float().contiguous(),
        bias=rpe_bias(table.float(), ws).contiguous()), num_heads)


def fold_cross_ffn(norm: nn.LayerNorm, layers: nn.Sequential) -> Folded:
    """CrossFFN Sequential (0 fc1, 1 bn, 3 dw3x3, 4 bn, 6 fc2, 7 bn) with
    the BNs folded into the convs."""
    fc1, dw, fc2 = layers[0], layers[3], layers[6]
    s1, t1 = fold_bn(layers[1])
    s2, t2 = fold_bn(layers[4])
    s3, t3 = fold_bn(layers[7])
    ch = fc1.weight.shape[0]
    return pack_cross_ffn(dict(
        ln=_ln(norm),
        w1=(fc1.weight[:, :, 0, 0].float().t() * s1[None, :]).contiguous(),
        b1=(fc1.bias.float() * s1 + t1).contiguous(),
        wdw=(dw.weight.float().reshape(ch, 9) * s2[:, None]).contiguous(),
        bdw=(dw.bias.float() * s2 + t2).contiguous(),
        w2=(fc2.weight[:, :, 0, 0].float().t() * s3[None, :]).contiguous(),
        b2=(fc2.bias.float() * s3 + t3).contiguous()))


def fold_hrformer_block(blk) -> Dict[str, Folded]:
    """Eval weights of one `layers.attention.HRFormerBlock`."""
    a = blk.attn.attn
    ln1 = _ln(blk.norm1)
    attn = _fold_attention(ln1, ln1, a.qkv.weight, a.qkv.bias, a.out_proj,
                           a.relative_position_bias_table, blk.num_heads,
                           blk.window_size)
    return dict(attn=attn, ffn=fold_cross_ffn(blk.norm2, blk.ffn.layers))


def fold_fusion_block(blk) -> Dict[str, object]:
    """Eval weights of one `layers.attention.HRFuserFusionBlock`."""
    attn = []
    for k, mwca in enumerate(blk.attn):
        a = mwca.attn
        projs = (a.q_proj, a.k_proj, a.v_proj)
        attn.append(_fold_attention(
            _ln(blk.norm1[k]), _ln(blk.norm2[k]),
            torch.cat([m.weight for m in projs]),
            torch.cat([m.bias for m in projs]), a.out_proj,
            a.relative_position_bias_table, blk.num_heads, blk.window_size))
    return dict(attn=attn, ffn=fold_cross_ffn(blk.norm3, blk.ffn.layers))


# ---------------------------------------------------------------------------
# plain twins (float32 math, output in the activations' dtype)
# ---------------------------------------------------------------------------

def _crop(t: Optional[Tensor], pads: Tuple[int, int], hw: Tuple[int, int]
          ) -> Optional[Tensor]:
    (pt, pl), (h, w) = pads, hw
    return None if t is None else t[:, pt:pt + h, pl:pl + w]


def window_attention_plain(res: Optional[Tensor], q_src: Tensor, p: Folded,
                           num_heads: int, kv_src: Optional[Tensor] = None,
                           z: Optional[Tensor] = None,
                           padded_hw: Optional[Tuple[int, int]] = None,
                           ln: bool = True) -> Tensor:
    """`[res] [+ z] + Wo . MHA(q = LN_q(q_src), kv = LN_kv(kv_src))` over
    centre-padded windows; `kv_src=None` is self-attention on q_src. All
    maps NHWC [B, H, W, C]. `padded_hw=(H, W)`: the maps are centre-padded
    slabs of a real H x W map, whose ring tokens get `[res] [+ z]`.
    `ln=False` skips both LNs (pre-normed windows)."""
    ws = int(round(p['bias'].shape[-1] ** 0.5))
    dtype = q_src.dtype
    if padded_hw is not None:
        h, w = padded_hw
        pt, _, pl, _ = center_pad_shape(h, w, ws, ws)
        pads = (pt, pl)
        inner = window_attention_plain(
            _crop(res, pads, padded_hw), _crop(q_src, pads, padded_hw), p,
            num_heads, _crop(kv_src, pads, padded_hw),
            _crop(z, pads, padded_hw), ln=ln)
        if z is None:
            out = q_src.new_zeros(q_src.shape) if res is None else res.clone()
        else:
            out = ((0 if res is None else res.float()) + z.float()).to(dtype)
        _crop(out, pads, padded_hw).copy_(inner)
        return out
    b, h, w, c = q_src.shape

    def norm(t, key):
        return layer_norm(t, p[key][0], p[key][1]) if ln else t.float()

    qw = window_partition(norm(q_src, 'lnq'), ws)
    kvw = qw if kv_src is None else window_partition(norm(kv_src, 'lnkv'),
                                                     ws)
    wq, wk, wv = p['wqkv'].split(c, 1)
    bq, bk, bv = p['bqkv'].split(c)
    nw, n, _ = qw.shape
    d = c // num_heads

    def heads(t):
        return t.reshape(nw, n, num_heads, d).transpose(1, 2)

    q, k, v = heads(qw @ wq + bq), heads(kvw @ wk + bk), heads(kvw @ wv + bv)
    attn = torch.softmax(q @ k.transpose(-1, -2) + p['bias'][None], -1)
    o = (attn @ v).transpose(1, 2).reshape(nw, n, c)
    y = window_reverse(o @ p['wo'] + p['bo'], b, h, w, ws)
    if res is None and z is None:
        return y.to(dtype)
    out = res.float() if res is not None else z.float()
    if res is not None and z is not None:
        out = out + z.float()
    return (out + y).to(dtype)


def cross_ffn_plain(x: Tensor, p: Folded) -> Tensor:
    """`x + GELU(fc2'(GELU(dw3x3'(GELU(fc1'(LN x))))))`, BNs folded."""
    h = F.gelu(layer_norm(x, p['ln'][0], p['ln'][1]) @ p['w1'] + p['b1'])
    ch = h.shape[-1]
    h = F.conv2d(h.permute(0, 3, 1, 2), p['wdw'].reshape(ch, 1, 3, 3),
                 p['bdw'], padding=1, groups=ch).permute(0, 2, 3, 1)
    h = F.gelu(F.gelu(h) @ p['w2'] + p['b2'])
    return (x.float() + h).to(x.dtype)


# ---------------------------------------------------------------------------
# launchers (validate, launch, count nothing)
# ---------------------------------------------------------------------------

def check_device(x: Tensor) -> None:
    """The kernels' ops serve CPU tensors (plain twin) and CUDA tensors
    (kernel); raises for any other device."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')


def on_cpu(x: Tensor) -> bool:
    """True for a CPU tensor (take the twin), False for a CUDA tensor
    (launch the kernel); raises for any other device. For wrappers that
    route by hand (`data/jpeg.py`); kernels A, B and C route through
    their ops' dispatch."""
    check_device(x)
    return x.device.type == 'cpu'


def _check_act(name: str, t: Tensor, like: Tensor) -> None:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f'{name}: {t.device}/{t.dtype}, expected '
                         f'{like.device}/{like.dtype}')
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected '
                         f'{tuple(like.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be a contiguous NHWC tensor')


def _check_params(p: Folded, shapes: Dict[str, tuple], device) -> None:
    """Folded weights are float32; the packed ones (`*_p`) bf16 and
    16-byte aligned, as the kernels' cp.async copies read them."""
    for key, shape in shapes.items():
        t = p.get(key)
        if t is None:
            raise ValueError(f'folded weight {key!r} missing: fold with '
                             f'fold_hrformer_block / fold_fusion_block')
        packed = key.endswith('_p')
        dtype = torch.bfloat16 if packed else torch.float32
        if (t.device != device or t.dtype != dtype
                or not t.is_contiguous() or tuple(t.shape) != shape
                or (packed and t.data_ptr() % 16)):
            raise ValueError(f'folded weight {key!r}: {t.device}/{t.dtype} '
                             f'{tuple(t.shape)}, expected {device}/{dtype} '
                             f'{shape} contiguous'
                             + (' and 16-byte aligned' if packed else ''))


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def attention_plan(c: int, num_heads: int, cross: bool,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[str, int, int]:
    """Kernel A's plan for a width and activation dtype: ('mma',
    'resident' or 'streamed', channels staged per pass, bytes of shared
    memory). 'mma' (tensor cores) serves bfloat16 wherever it fits.
    Raises `ValueError` with the byte count when no plan fits a block."""
    chunk, resident, mma = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    nbytes = cuda_build.lib().hrf_window_attention_plan(
        c, num_heads, int(cross), int(dtype == torch.bfloat16),
        ctypes.byref(chunk), ctypes.byref(resident), ctypes.byref(mma))
    if chunk.value == 0:
        raise ValueError(
            f'window attention kernel: C={c} with {num_heads} heads '
            f'({"cross" if cross else "self"} mode) needs {nbytes} B of '
            f'shared memory per block; an H100 block has {SMEM_MAX} B')
    kind = ('mma' if mma.value else
            'resident' if resident.value else 'streamed')
    return kind, chunk.value, nbytes


@functools.lru_cache(maxsize=None)
def ffn_plan(c: int, hidden: int, dtype: torch.dtype = torch.float32
             ) -> Tuple[str, int, int, int]:
    """Kernel B's plan: ('mma' or 'scalar', tile rows, hidden channels per
    chunk, bytes of its largest launch). 'mma' (tensor cores, two launches
    through a bf16 scratch of GELU(fc1)) serves bfloat16 wherever it fits.
    Raises `ValueError` with the byte count when no plan fits a block."""
    th, kh, mma = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    nbytes = cuda_build.lib().hrf_cross_ffn_plan(
        c, hidden, int(dtype == torch.bfloat16), ctypes.byref(th),
        ctypes.byref(kh), ctypes.byref(mma))
    if th.value == 0:
        raise ValueError(
            f'cross_ffn kernel: C={c} with {hidden} hidden channels needs '
            f'{nbytes} B of shared memory per block at its smallest tile; '
            f'the plan allows 204800 B')
    return ('mma' if mma.value else 'scalar'), th.value, kh.value, nbytes


def launch_window_attention(q_src: Tensor, kv_src: Optional[Tensor],
                            res: Optional[Tensor], z: Optional[Tensor],
                            p: Folded, num_heads: int,
                            padded_hw: Optional[Tuple[int, int]] = None,
                            ln: bool = True) -> Tensor:
    """Launch kernel A on NHWC token maps shaped like `q_src`:

        out = [res] [+ z] + Wo . MHA(LN_q q_src, LN_kv kv_src) + bo

    Self mode when `kv_src` is None (kv = q_src, LN_kv = LN_q), else cross
    mode. `padded_hw=(H, W)`: the maps are centre-padded slabs of a real
    H x W map, and the ring tokens get `[res] [+ z]`. `ln=False` skips
    both LNs (pre-normed windows). Validates and raises; counts nothing
    (`hrfuser::window_attention` counts its launches).
    """
    if q_src.dtype not in _ACT_DTYPES or q_src.dim() != 4:
        raise ValueError(f'window attention: NHWC float32/bfloat16 tensor '
                         f'expected, got {q_src.dtype} {tuple(q_src.shape)}')
    b, hs, ws_, c = q_src.shape
    if c % num_heads:
        raise ValueError(f'window attention: C={c} not divisible by '
                         f'{num_heads} heads')
    h, w = (hs, ws_) if padded_hw is None else padded_hw
    if padded_hw is not None and (hs, ws_) != (-(-h // 7) * 7,
                                               -(-w // 7) * 7):
        raise ValueError(f'window attention: slab {hs}x{ws_} is not the '
                         f'centre-padded frame of {h}x{w}')
    if p['bias'].shape[-1] != 49:
        raise ValueError(f'window attention kernel: windows of '
                         f'{p["bias"].shape[-1]} tokens; only 7x7 is '
                         f'supported')
    cross = kv_src is not None
    for name, t in (('q_src', q_src), ('kv_src', kv_src), ('res', res),
                    ('z', z)):
        if t is not None:
            _check_act(name, t, q_src)
    shapes = dict(wqkv=(c, 3 * c), bqkv=(3 * c,), wo=(c, c), bo=(c,),
                  bias=(num_heads, 49, 49))
    if ln:
        shapes.update(lnq=(2, c), lnkv=(2, c))
    mma = attention_plan(c, num_heads, cross, q_src.dtype)[0] == 'mma'
    packed = obuf = None
    if mma:
        kp, dp = _round_up(c, 64), _round_up(c // num_heads, 16)
        shapes.update(wqkv_p=(num_heads * 3 * dp, kp),
                      wo_p=(_round_up(c, 64), kp))
        nwin = -(-hs // 7) * -(-ws_ // 7)
        obuf = torch.empty((b * nwin * 49, _round_up(c, 8)),
                           dtype=torch.bfloat16, device=q_src.device)
    _check_params(p, shapes, q_src.device)
    if mma:
        packed = (p['wqkv_p'].data_ptr(), p['wo_p'].data_ptr())
    kv = kv_src if cross else q_src
    out = torch.empty_like(q_src)
    cuda_build.check(cuda_build.lib().hrf_window_attention(
        _ptr(res), q_src.data_ptr(), kv.data_ptr(), _ptr(z),
        out.data_ptr(), p['lnq'].data_ptr() if ln else None,
        p['lnkv'].data_ptr() if ln else None, p['wqkv'].data_ptr(),
        p['bqkv'].data_ptr(), p['wo'].data_ptr(), p['bo'].data_ptr(),
        p['bias'].data_ptr(), *(packed or (None, None)), _ptr(obuf), b, h,
        w, c, num_heads, int(padded_hw is not None), int(cross),
        int(q_src.dtype == torch.bfloat16), _stream(q_src)),
        'hrf_window_attention')
    return out


def launch_cross_ffn(x: Tensor, p: Folded) -> Tensor:
    """Launch kernel B on NHWC `x`; validates and raises, counts nothing
    (`hrfuser::cross_ffn` counts its launches)."""
    if x.dtype not in _ACT_DTYPES or x.dim() != 4:
        raise ValueError(f'cross_ffn: NHWC float32/bfloat16 tensor '
                         f'expected, got {x.dtype} {tuple(x.shape)}')
    _check_act('x', x, x)
    b, h, w, c = x.shape
    ch = p['w1'].shape[1]
    shapes = dict(ln=(2, c), w1=(c, ch), b1=(ch,), wdw=(ch, 9), bdw=(ch,),
                  w2=(ch, c), b2=(c,))
    mma = ffn_plan(c, ch, x.dtype)[0] == 'mma'
    hbuf = None
    if mma:
        cp, chp = _round_up(c, 64), _round_up(ch, 64)
        shapes.update(w1_p=(chp, cp), w2_p=(cp, chp))
        hbuf = torch.empty((b * h * w, chp), dtype=torch.bfloat16,
                           device=x.device)
    _check_params(p, shapes, x.device)
    out = torch.empty_like(x)
    cuda_build.check(cuda_build.lib().hrf_cross_ffn(
        x.data_ptr(), out.data_ptr(), p['ln'].data_ptr(), p['w1'].data_ptr(),
        p['b1'].data_ptr(), p['wdw'].data_ptr(), p['bdw'].data_ptr(),
        p['w2'].data_ptr(), p['b2'].data_ptr(),
        p['w1_p'].data_ptr() if mma else None,
        p['w2_p'].data_ptr() if mma else None, _ptr(hbuf), b, h, w, c, ch,
        int(x.dtype == torch.bfloat16), _stream(x)), 'hrf_cross_ffn')
    return out


# ---------------------------------------------------------------------------
# registered ops: the only way to kernels A and B
# ---------------------------------------------------------------------------

# entry name -> the public wrapper whose `launches` the ops' CUDA
# implementations bump (`counts_launches`)
COUNTERS: Dict[str, Callable] = {}


def counts_launches(entry: str):
    """Decorator: the wrapper's `launches` counts the CUDA launches that
    ops called with `entry` make (eager or from an exported program)."""
    def register(fn):
        fn.launches = 0
        COUNTERS[entry] = fn
        return fn
    return register


def count_launch(entry: str) -> None:
    COUNTERS[entry].launches += 1


_ATTN_KEYS = ('lnq', 'lnkv', 'wqkv', 'bqkv', 'wo', 'bo', 'bias', 'wqkv_p',
              'wo_p')
_FFN_KEYS = ('ln', 'w1', 'b1', 'wdw', 'bdw', 'w2', 'b2', 'w1_p', 'w2_p')


def _folded(keys: Sequence[str], tensors: Sequence[Optional[Tensor]]
            ) -> Folded:
    return {k: t for k, t in zip(keys, tensors, strict=True)
            if t is not None}


@torch.library.custom_op('hrfuser::window_attention', mutates_args=(),
                         device_types='cuda')
def window_attention_op(
        q_src: Tensor, kv_src: Optional[Tensor], res: Optional[Tensor],
        z: Optional[Tensor], lnq: Optional[Tensor], lnkv: Optional[Tensor],
        wqkv: Tensor, bqkv: Tensor, wo: Tensor, bo: Tensor, bias: Tensor,
        wqkv_p: Optional[Tensor], wo_p: Optional[Tensor], num_heads: int,
        padded_h: int, padded_w: int, entry: str) -> Tensor:
    """Kernel A (`launch_window_attention`): the folded weights as
    tensors (`lnq` None: no LN; `lnkv` None: LN_kv = LN_q), `padded_h`
    0 for unpadded maps; one launch counted under `entry`."""
    p = _folded(_ATTN_KEYS, (lnq, lnq if lnkv is None else lnkv, wqkv, bqkv,
                             wo, bo, bias, wqkv_p, wo_p))
    out = launch_window_attention(
        q_src, kv_src, res, z, p, num_heads,
        (padded_h, padded_w) if padded_h else None, ln=lnq is not None)
    count_launch(entry)
    return out


@window_attention_op.register_kernel('cpu')
def _window_attention_cpu(q_src, kv_src, res, z, lnq, lnkv, wqkv, bqkv, wo,
                          bo, bias, wqkv_p, wo_p, num_heads, padded_h,
                          padded_w, entry):
    del entry
    p = _folded(_ATTN_KEYS, (lnq, lnkv, wqkv, bqkv, wo, bo, bias, wqkv_p,
                             wo_p))
    return window_attention_plain(
        res, q_src, p, num_heads, kv_src, z,
        (padded_h, padded_w) if padded_h else None,
        ln=lnq is not None).contiguous()


@window_attention_op.register_fake
def _window_attention_fake(q_src, *args):
    return torch.empty_like(q_src, memory_format=torch.contiguous_format)


@torch.library.custom_op('hrfuser::cross_ffn', mutates_args=(),
                         device_types='cuda')
def cross_ffn_op(x: Tensor, ln: Tensor, w1: Tensor, b1: Tensor, wdw: Tensor,
                 bdw: Tensor, w2: Tensor, b2: Tensor,
                 w1_p: Optional[Tensor], w2_p: Optional[Tensor],
                 entry: str) -> Tensor:
    """Kernel B (`launch_cross_ffn`) on the folded weights as tensors; one
    launch counted under `entry`."""
    out = launch_cross_ffn(x, _folded(_FFN_KEYS, (ln, w1, b1, wdw, bdw, w2,
                                                  b2, w1_p, w2_p)))
    count_launch(entry)
    return out


@cross_ffn_op.register_kernel('cpu')
def _cross_ffn_cpu(x, ln, w1, b1, wdw, bdw, w2, b2, w1_p, w2_p, entry):
    del entry
    p = _folded(_FFN_KEYS, (ln, w1, b1, wdw, bdw, w2, b2, w1_p, w2_p))
    return cross_ffn_plain(x, p).contiguous()


@cross_ffn_op.register_fake
def _cross_ffn_fake(x, *args):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def window_attention(q_src: Tensor, kv_src: Optional[Tensor],
                     res: Optional[Tensor], z: Optional[Tensor], p: Folded,
                     num_heads: int, entry: str,
                     padded_hw: Optional[Tuple[int, int]] = None,
                     ln: bool = True) -> Tensor:
    """`hrfuser::window_attention` on a `Folded` dict: the plain twin for
    CPU tensors, kernel A for CUDA tensors (counted under `entry`).
    `kv_src=None` is self mode; arguments as `launch_window_attention`."""
    check_device(q_src)
    ph, pw = padded_hw or (0, 0)
    return window_attention_op(
        q_src, kv_src, res, z, p['lnq'] if ln else None,
        p['lnkv'] if ln and kv_src is not None else None, p['wqkv'],
        p['bqkv'], p['wo'], p['bo'], p['bias'], p.get('wqkv_p'),
        p.get('wo_p'), num_heads, ph, pw, entry)


def ffn(x: Tensor, p: Folded, entry: str) -> Tensor:
    """`hrfuser::cross_ffn` on a `Folded` dict: the plain twin for CPU
    tensors, kernel B for CUDA tensors (counted under `entry`)."""
    check_device(x)
    return cross_ffn_op(x, *(p.get(k) for k in _FFN_KEYS), entry)


# ---------------------------------------------------------------------------
# the model path's wrappers
# ---------------------------------------------------------------------------

@counts_launches('window_self_attention')
def window_self_attention(x: Tensor, p: Folded, num_heads: int) -> Tensor:
    """HRFormerBlock attention half: `x + Wo . MHSA(LN1 x)` (kernel A)."""
    return window_attention(x, None, x, None, p, num_heads,
                            'window_self_attention')


@counts_launches('window_cross_attention')
def window_cross_attention(acc: Tensor, x: Tensor, z: Tensor, p: Folded,
                           num_heads: int) -> Tensor:
    """One fusion-block modality: `acc + z + Wo . MHCA(q = LN1 x,
    kv = LN2 z)` with x the frozen camera feature (kernel A)."""
    return window_attention(x, z, acc, z, p, num_heads,
                            'window_cross_attention')


@counts_launches('cross_ffn')
def cross_ffn(x: Tensor, p: Folded) -> Tensor:
    """CrossFFN half: `x + CrossFFN(LN x)` (kernel B)."""
    return ffn(x, p, 'cross_ffn')


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------

def hrformer_chain(x: Tensor, blocks: Sequence[Dict[str, Folded]],
                   num_heads: int, n_streams: int = 1) -> Tensor:
    """Run chains of eval HRFormerBlocks on NHWC `x`.

    x: [S*B, H, W, C], `n_streams` independent streams stacked stream-
    major on the batch axis; `blocks`: flat stream-major list of S*L
    folded blocks (`fold_hrformer_block`), each stream running its own L.
    """
    num_blocks = len(blocks) // n_streams
    if num_blocks * n_streams != len(blocks) or x.shape[0] % n_streams:
        raise ValueError(f'{len(blocks)} blocks / batch {x.shape[0]} do not '
                         f'split into {n_streams} streams')
    outs = []
    for s, xs in enumerate(x.chunk(n_streams)):
        xs = xs.contiguous()
        for blk in blocks[s * num_blocks:(s + 1) * num_blocks]:
            xs = window_self_attention(xs, blk['attn'], num_heads)
            xs = cross_ffn(xs, blk['ffn'])
        outs.append(xs)
    return outs[0] if n_streams == 1 else torch.cat(outs)


def fusion_chain(x: Tensor, mods: List[Tensor], block: Dict[str, object],
                 num_heads: int) -> Tensor:
    """One eval HRFuserFusionBlock on NHWC maps: every modality queries
    the frozen `x`; then `x += CrossFFN(LN3 x)`."""
    frozen = x.contiguous()
    out = frozen
    for z, p in zip(mods, block['attn'], strict=True):
        out = window_cross_attention(out, frozen, z.contiguous(), p,
                                     num_heads)
    return cross_ffn(out, block['ffn'])
