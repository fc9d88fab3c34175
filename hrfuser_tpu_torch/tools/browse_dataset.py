"""Pipeline visualization tool.

Port of `tools/browse_dataset.py` (the reference's
`tools/misc/browse_dataset.py` / `browse_dataset_nus_vis.py`): runs the
training pipeline on dataset samples and writes composites of the
de-normalized camera image with its ground-truth boxes, above one
heatmap per sensor modality, as `sample_{i}.jpg`. Sample i draws its
augmentations from `np.random.default_rng(i)`, as in JAX; the drawing
and the JPEG's pixels run on the card (`utils/visualization.py`,
`data/jpeg.py`), the bytes equal to what `cv2.imwrite` writes for the
same composite.

    python -m hrfuser_tpu_torch.tools.browse_dataset \\
        cascade_rcnn_hrfuser_t_1x_nus_r640_l_r_fusion \\
        --data-root data/nuscenes --out-dir vis/ --num 10 [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description='Browse the train pipeline')
    ap.add_argument('config')
    ap.add_argument('--data-root', required=True)
    ap.add_argument('--out-dir', default='vis')
    ap.add_argument('--num', type=int, default=10)
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def composite(out: dict, data, norm: dict, device) -> torch.Tensor:
    """One pipeline output -> the browse composite, uint8 BGR on
    `device`: the camera image with its gt boxes, then each modality's
    heatmap, stacked along the rows."""
    from hrfuser_tpu_torch.utils.visualization import (
        denormalize_image, draw_detections, sensor_image_to_heatmap)
    img = denormalize_image(out['img'], **norm['img'], device=device)
    v = out['gt_valid']
    img = draw_detections(img, out['gt_boxes'][v], out['gt_labels'][v],
                          class_names=data.classes, device=device)
    panels = [img] + [sensor_image_to_heatmap(out[f'{m}_img'],
                                              device=device)
                      for m in data.modalities]
    return torch.cat(panels, 0)


def main(argv=None):
    args = parse_args(argv)
    from hrfuser_tpu_torch.configs import get_experiment
    from hrfuser_tpu_torch.data import norms
    from hrfuser_tpu_torch.data.datasets import build_dataset
    from hrfuser_tpu_torch.data.loader import build_pipeline
    from hrfuser_tpu_torch.data.pipelines.loading import imwrite
    from hrfuser_tpu_torch.tools import resolve_device

    device = resolve_device(args.device)
    data = get_experiment(args.config).data
    dataset = build_dataset(data, args.data_root, 'train')
    norm = norms.STF if data.dataset == 'stf' else norms.NUS
    pipe = build_pipeline(data, train=True, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for i in range(min(args.num, len(dataset))):
        res = dataset.sample(i)
        res['rng'] = np.random.default_rng(i)
        path = os.path.join(args.out_dir, f'sample_{i}.jpg')
        imwrite(path, composite(pipe(res), data, norm, device))
        written.append(path)
        print(f'[browse] sample_{i}.jpg')
    return written


if __name__ == '__main__':
    main()
