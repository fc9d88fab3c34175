"""JAX variables -> port `state_dict` (reference parameter names).

`state_dict_from_jax(variables, cfg)` takes the JAX package's
`{'params', 'batch_stats'}` tree (leaves convertible with `np.asarray`)
and returns the state dict of `CascadeRCNN(cfg)`. It is the inverse of
`hrfuser_tpu.utils.pth_convert.convert_state_dict`: conv kernels HWIO ->
OIHW, depthwise [kh, kw, 1, C] -> [C, 1, kh, kw], dense [in, out] ->
[out, in]. The HRFuser stage-2 transition applies only its conv
(`trans{i}_conv` in the JAX tree); the port keeps the reference's unused
BatchNorm beside it, which gets identity statistics here.

`hrformer_block_state_dict` and `fusion_block_state_dict` do the same for
one block: a flax `HRFormerBlock` / `HRFuserFusionBlock`'s own variables
to the state dict of the port's `layers.attention` block.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor


class _Emitter:
    def __init__(self, variables):
        self.params = variables['params']
        self.stats = variables.get('batch_stats', {})
        self.sd: Dict[str, Tensor] = {}

    @staticmethod
    def _get(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    def has(self, path) -> bool:
        try:
            self._get(self.params, path)
        except KeyError:
            return False
        return True

    def put(self, name: str, value) -> None:
        self.sd[name] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(value, np.float32)))

    def conv(self, name: str, path) -> None:
        p = self._get(self.params, path)
        self.put(f'{name}.weight', np.transpose(np.asarray(p['kernel']),
                                                (3, 2, 0, 1)))
        if 'bias' in p:
            self.put(f'{name}.bias', p['bias'])

    def bn(self, name: str, path=None) -> None:
        """BatchNorm buffers; `path=None` emits identity statistics."""
        if path is None:
            c = self.sd[name.rsplit('.', 1)[0] + '.0.weight'].shape[0]
            vals = dict(weight=np.ones(c), bias=np.zeros(c),
                        running_mean=np.zeros(c), running_var=np.ones(c))
        else:
            p = self._get(self.params, path + ('bn',))
            s = self._get(self.stats, path + ('bn',))
            vals = dict(weight=p['scale'], bias=p['bias'],
                        running_mean=s['mean'], running_var=s['var'])
        for k, v in vals.items():
            self.put(f'{name}.{k}', v)
        self.sd[f'{name}.num_batches_tracked'] = torch.tensor(0)

    def convnorm(self, conv: str, bn: str, path) -> None:
        self.conv(conv, path + ('conv',))
        self.bn(bn, path + ('norm',))

    def linear(self, name: str, path) -> None:
        p = self._get(self.params, path)
        self.put(f'{name}.weight', np.asarray(p['kernel']).T)
        self.put(f'{name}.bias', p['bias'])

    def ln(self, name: str, path) -> None:
        p = self._get(self.params, path)
        self.put(f'{name}.weight', p['scale'])
        self.put(f'{name}.bias', p['bias'])

    # ---- composite modules ------------------------------------------------

    def res_layer(self, tp: str, path, num_blocks: int) -> None:
        for i in range(num_blocks):
            bp = path + (f'block{i}',)
            for j in (1, 2, 3):
                self.convnorm(f'{tp}.{i}.conv{j}', f'{tp}.{i}.bn{j}',
                              bp + (f'conv{j}',))
            if self.has(bp + ('downsample',)):
                self.convnorm(f'{tp}.{i}.downsample.0',
                              f'{tp}.{i}.downsample.1', bp + ('downsample',))

    def cross_ffn(self, tp: str, path) -> None:
        for idx, name in ((0, 'fc1'), (3, 'dw'), (6, 'fc2')):
            self.conv(f'{tp}.layers.{idx}', path + (name,))
        for idx, name in ((1, 'norm1'), (4, 'norm2'), (7, 'norm3')):
            self.bn(f'{tp}.layers.{idx}', path + (name,))

    def hrformer_block(self, tp: str, path) -> None:
        self.ln(f'{tp}.norm1', path + ('norm1',))
        self.ln(f'{tp}.norm2', path + ('norm2',))
        self.linear(f'{tp}.attn.attn.qkv', path + ('attn', 'qkv'))
        self.linear(f'{tp}.attn.attn.out_proj', path + ('attn', 'out_proj'))
        self.put(f'{tp}.attn.attn.relative_position_bias_table',
                 self._get(self.params, path + (
                     'attn', 'rpe', 'relative_position_bias_table')))
        self.cross_ffn(f'{tp}.ffn', path + ('ffn',))

    def fusion_block(self, tp: str, path, num_modalities: int) -> None:
        for k in range(num_modalities):
            self.ln(f'{tp}.norm1.{k}', path + (f'norm1_{k}',))
            self.ln(f'{tp}.norm2.{k}', path + (f'norm2_{k}',))
            for proj in ('q_proj', 'k_proj', 'v_proj', 'out_proj'):
                self.linear(f'{tp}.attn.{k}.attn.{proj}',
                            path + (f'attn_{k}', proj))
            self.put(f'{tp}.attn.{k}.attn.relative_position_bias_table',
                     self._get(self.params, path + (
                         f'attn_{k}', 'rpe', 'relative_position_bias_table')))
        self.ln(f'{tp}.norm3', path + ('norm3',))
        self.cross_ffn(f'{tp}.ffn', path + ('ffn',))

    def transition(self, tp: str, path, in_channels, out_channels) -> None:
        pre = len(in_channels)
        for i, oc in enumerate(out_channels):
            if i < pre:
                if oc == in_channels[i]:
                    continue
                if self.has(path + (f'trans{i}',)):
                    self.convnorm(f'{tp}.{i}.0', f'{tp}.{i}.1',
                                  path + (f'trans{i}',))
                else:                            # stage-2 conv-only quirk
                    self.conv(f'{tp}.{i}.0', path + (f'trans{i}_conv',))
                    self.bn(f'{tp}.{i}.1')
                continue
            for j in range(i + 1 - pre):
                self.convnorm(f'{tp}.{i}.{j}.0', f'{tp}.{i}.{j}.1',
                              path + (f'trans{i}_step{j}',))

    def hr_module(self, tp: str, path, stage) -> None:
        nb = stage.num_branches
        for i in range(nb):
            for j in range(stage.num_blocks[i]):
                self.hrformer_block(f'{tp}.branches.{i}.{j}',
                                    path + (f'branch{i}_block{j}',))
        if nb == 1:
            return
        for i in range(nb):
            for j in range(nb):
                base = f'{tp}.fuse_layers.{i}.{j}'
                fp = path + (f'fuse{i}_{j}',)
                if j > i:
                    self.convnorm(f'{base}.0', f'{base}.1', fp + ('proj',))
                for k in range(i - j):
                    self.convnorm(f'{base}.{k}.0', f'{base}.{k}.1',
                                  fp + (f'step{k}_dw',))
                    self.convnorm(f'{base}.{k}.2', f'{base}.{k}.3',
                                  fp + (f'step{k}_pw',))


def _block(variables, emit) -> Dict[str, Tensor]:
    e = _Emitter(variables)
    emit(e)
    return {k[1:]: v for k, v in e.sd.items()}      # drop the empty prefix


def hrformer_block_state_dict(variables) -> Dict[str, Tensor]:
    """State dict of the port's `HRFormerBlock` from the variables
    (`{'params', 'batch_stats'}`) of one flax `HRFormerBlock`."""
    return _block(variables, lambda e: e.hrformer_block('', ()))


def fusion_block_state_dict(variables, num_modalities: int
                            ) -> Dict[str, Tensor]:
    """State dict of the port's `HRFuserFusionBlock` from the variables of
    one flax `HRFuserFusionBlock` with `num_modalities` streams."""
    return _block(variables,
                  lambda e: e.fusion_block('', (), num_modalities))


def state_dict_from_jax(variables, cfg) -> Dict[str, Tensor]:
    """The port `CascadeRCNN(cfg)` state dict of a JAX variables tree."""
    e = _Emitter(variables)
    bb = cfg.backbone
    B = ('backbone',)
    e.convnorm('backbone.conv1', 'backbone.bn1', B + ('stem', 'conv1'))
    e.convnorm('backbone.conv2', 'backbone.bn2', B + ('stem', 'conv2'))
    e.res_layer('backbone.layer1', B + ('layer1',), bb.stage1.num_blocks[0])
    e.transition('backbone.transition1', B + ('transition1',),
                 bb.stage1.out_channels, bb.stage2.out_channels)
    e.transition('backbone.transition2', B + ('transition2',),
                 bb.stage2.out_channels, bb.stage3.out_channels)
    e.transition('backbone.transition3', B + ('transition3',),
                 bb.stage3.out_channels, bb.stage4.out_channels)
    for sname in ('stage2', 'stage3', 'stage4'):
        stage = getattr(bb, sname)
        for m in range(stage.num_modules):
            e.hr_module(f'backbone.{sname}.{m}', B + (sname, f'module{m}'),
                        stage)

    nm = bb.num_fused_modalities
    for k in range(nm):
        e.convnorm(f'backbone.conv_a.{k}', f'backbone.norm_a.{k}',
                   B + (f'stem_mod{k}', 'conv1'))
        e.convnorm(f'backbone.conv_b.{k}', f'backbone.norm_b.{k}',
                   B + (f'stem_mod{k}', 'conv2'))
        e.res_layer(f'backbone.layer_a.{k}', B + (f'layer_a{k}',),
                    bb.stage_a.num_blocks[0])
    for name, in_ch, fus in (('transition_a', bb.stage_a.out_channels,
                              bb.fusion_a),
                             ('transition_b', bb.stage_b.out_channels,
                              bb.fusion_b),
                             ('transition_c', bb.stage_c.out_channels,
                              bb.fusion_c)):
        for k in range(nm):
            e.transition(f'backbone.{name}.{k}', B + (name, f'mod{k}'),
                         in_ch, fus.num_channels)
    for name in ('stage_b', 'stage_c'):
        stage = getattr(bb, name)
        for k in range(nm):
            for m in range(stage.num_modules):
                e.hr_module(f'backbone.{name}.{k}.{m}',
                            B + (name, f'mod{k}', f'module{m}'), stage)
    for name in ('fusion_a', 'fusion_b', 'fusion_c'):
        for i in range(getattr(bb, name).num_branches):
            e.fusion_block(f'backbone.{name}.{i}', B + (name, f'branch{i}'),
                           nm)

    e.conv('neck.reduction_conv.conv', ('neck', 'reduction_conv'))
    i = 0
    while e.has(('neck', f'fpn_conv{i}')):
        e.conv(f'neck.fpn_convs.{i}.conv', ('neck', f'fpn_conv{i}'))
        i += 1
    for name in ('rpn_conv', 'rpn_cls', 'rpn_reg'):
        e.conv(f'rpn_head.{name}', ('rpn_head', name))
    for i in range(cfg.roi.num_stages):
        base, p = f'roi_head.bbox_head.{i}', ('roi_head', f'bbox_head{i}')
        e.linear(f'{base}.shared_fcs.0', p + ('shared_fc0',))
        e.linear(f'{base}.shared_fcs.1', p + ('shared_fc1',))
        e.linear(f'{base}.fc_cls', p + ('fc_cls',))
        e.linear(f'{base}.fc_reg', p + ('fc_reg',))
    return e.sd
