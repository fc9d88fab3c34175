"""Per-sensor normalization constants (from the reference dataset configs).

nuScenes: `configs/_base_/datasets/nuscenes_detection_r640_clr_fusion.py`
STF:      `configs/_base_/datasets/kitti_detection_2d_c1248_clrg_fusion.py`

A verbatim copy of `hrfuser_tpu/data/norms.py`: the port imports nothing of
the JAX package. `tests/test_torch_device_pipeline.py` holds the two equal.
"""

NUS = dict(
    img=dict(mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375),
             to_rgb=True),
    lidar=dict(mean=(0.23277158, 0.31501067, -0.00012928071),
               std=(2.5538357826888602, 3.7345728854535643,
                    0.2815488539921788), to_rgb=False),
    radar=dict(mean=(0.19778967, 0.03477772, 0.0025186215),
               std=(3.219927182957935, 0.7240392925308506,
                    0.11561270078715341), to_rgb=False),
)

STF = dict(
    img=dict(mean=(95.07200648, 91.35659045, 87.7264499),
             std=(42.78716034, 42.98587388, 43.82545466), to_rgb=True),
    lidar=dict(mean=(0.014311949, 0.39251423, 3.4071422),
               std=(0.17276553984335935, 3.76054903771461,
                    26.008978714330535), to_rgb=False),
    radar=dict(mean=(3.4423912, 0.021001821),
               std=(19.330362993097626, 0.7612592077132296), to_rgb=False),
    gated=dict(mean=(181.74427536,), std=(185.49071888,), to_rgb=False),
)
