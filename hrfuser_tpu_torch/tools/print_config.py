"""Print a fully-resolved experiment config.

Port of `tools/print_config.py` (the reference's
`tools/misc/print_config.py`) on the port's config copies
(`configs/presets.py`): the config's dataclasses as an indented tree, or
as JSON with `--json`; `--list` (or no name) lists every accepted name.

The JAX configs also hold TPU routing knobs that the port's copies leave
out (`models/backbones/hr_config.py`): every preset gives each one the
same value, so `JAX_ONLY` prints them, with those values, where the JAX
tree has them, and the output is the JAX tool's byte for byte. They
select nothing in the port.

    python -m hrfuser_tpu_torch.tools.print_config \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion [--json]
    python -m hrfuser_tpu_torch.tools.print_config --list
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from hrfuser_tpu_torch.configs import get_experiment, list_configs

# dataclass name -> ((field, ((JAX-only field, its value), ...)), ...):
# the JAX-only fields that follow `field` in the JAX dataclass
JAX_ONLY = {
    'HRBackboneCfg': (('remat', (('cf_layout', 'auto'),
                                 ('chain_kernel', 'auto'))),),
    'RoIHeadCfg': (('pool_method', (('pool_method_eval', 'pallas'),
                                    ('pallas_variant', 'v7'))),),
    'Experiment': (('optim', (('seed', 0),)),),
}


def to_tree(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        after = dict(JAX_ONLY.get(type(obj).__name__, ()))
        tree = {}
        for f in dataclasses.fields(obj):
            tree[f.name] = to_tree(getattr(obj, f.name))
            tree.update(after.get(f.name, ()))
        return tree
    if isinstance(obj, dict):
        return {k: to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_tree(v) for v in obj]
    return obj


def render(node, indent=0):
    pad = '  ' * indent
    lines = []
    if isinstance(node, dict):
        for k, v in node.items():
            if isinstance(v, (dict, list)) and v and \
                    any(isinstance(x, (dict, list))
                        for x in (v.values() if isinstance(v, dict) else v)):
                lines.append(f'{pad}{k}:')
                lines.extend(render(v, indent + 1))
            else:
                lines.append(f'{pad}{k}: {v}')
    elif isinstance(node, list):
        for i, v in enumerate(node):
            lines.append(f'{pad}[{i}]:')
            lines.extend(render(v, indent + 1))
    else:
        lines.append(f'{pad}{node}')
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('config', nargs='?', default=None)
    ap.add_argument('--json', action='store_true')
    ap.add_argument('--list', action='store_true',
                    help='list all registered config names')
    args = ap.parse_args(argv)

    if args.list or not args.config:
        for name in list_configs():
            print(name)
        return

    tree = to_tree(get_experiment(args.config))
    if args.json:
        print(json.dumps(tree, indent=2, default=str))
    else:
        print('\n'.join(render(tree)))


if __name__ == '__main__':
    main()
