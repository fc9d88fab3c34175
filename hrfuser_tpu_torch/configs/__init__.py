from hrfuser_tpu_torch.configs.presets import (DataCfg, Experiment,
                                              get_config, get_experiment)

__all__ = ['DataCfg', 'Experiment', 'get_config', 'get_experiment']
