"""The port's datasets, and the split files the test and train CLIs read.

`SPLITS[split][data.dataset]` names the annotation files the converters
write under a `--data-root` (`tools/test.py:98-140` and
`tools/train.py:138-210` of the JAX package): the nuScenes COCO jsons,
and STF's pickles (four weather splits for test).
"""

from __future__ import annotations

SPLITS = {
    'train': {'nuscenes': ['nuscenes_infos_train_mono3d.coco.json'],
              'stf': ['dense_infos_train.pkl']},
    'val': {'nuscenes': ['nuscenes_infos_val_mono3d.coco.json'],
            'stf': ['dense_infos_val.pkl']},
    'test': {'nuscenes': ['nuscenes_infos_val_mono3d.coco.json'],
             'stf': ['dense_infos_test_clear.pkl', 'dense_infos_light_fog.pkl',
                     'dense_infos_dense_fog.pkl', 'dense_infos_snow.pkl']},
}


def build_dataset(data, data_root: str, split: str):
    """The config's dataset over `split` ('train', 'val' or 'test') under
    `data_root`; every split but 'train' in test mode."""
    ann_files = SPLITS[split][data.dataset]
    test_mode = split != 'train'
    if data.dataset == 'stf':
        from hrfuser_tpu_torch.data.datasets.kitti2d import Kitti2DDataset
        return Kitti2DDataset(ann_files, data.classes, data_root=data_root,
                              test_mode=test_mode)
    from hrfuser_tpu_torch.data.datasets.coco import CocoFusionDataset
    (ann_file,) = ann_files
    return CocoFusionDataset(ann_file, data.classes, data_root=data_root,
                             test_mode=test_mode)
