"""The port's ops; importing the package registers the FLOP formulas of
its `hrfuser::` ops (`flops.py`)."""

from hrfuser_tpu_torch.ops import flops  # noqa: F401
