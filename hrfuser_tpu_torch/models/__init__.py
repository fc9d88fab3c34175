from hrfuser_tpu_torch.models.backbones.hr_config import (
    HRBackboneCfg, backbone_cfg_from_extra)
from hrfuser_tpu_torch.models.detectors.cascade_rcnn import (CascadeRCNN,
                                                             DetectorCfg,
                                                             RPNTestCfg,
                                                             predict)
from hrfuser_tpu_torch.models.detectors.tta import (predict_aug_test_flip,
                                                    predict_tta_flip)
from hrfuser_tpu_torch.models.roi_heads.cascade_roi_head import (
    Detections, RoIHeadCfg)

__all__ = ['HRBackboneCfg', 'backbone_cfg_from_extra', 'CascadeRCNN',
           'DetectorCfg', 'RPNTestCfg', 'predict', 'predict_aug_test_flip',
           'predict_tta_flip', 'Detections', 'RoIHeadCfg']
