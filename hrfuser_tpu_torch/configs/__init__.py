from hrfuser_tpu_torch.configs.presets import (DataCfg, Experiment, OptimCfg,
                                              ScheduleCfg, get_config,
                                              get_experiment, list_configs)

__all__ = ['DataCfg', 'Experiment', 'OptimCfg', 'ScheduleCfg', 'get_config',
           'get_experiment', 'list_configs']
