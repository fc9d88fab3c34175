from hrfuser_tpu_torch.configs.presets import get_config

__all__ = ['get_config']
