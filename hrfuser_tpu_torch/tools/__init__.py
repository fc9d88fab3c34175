"""Command-line entry points of the port."""

import torch


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`; asking for CUDA where there is none
    raises (an entry point never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device}: no CUDA device is available; '
                           f'pass --device cpu to run on the CPU')
    return device
