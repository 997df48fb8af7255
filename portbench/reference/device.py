"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def check_module_device(module: torch.nn.Module, device: torch.device,
                        what: str) -> None:
    """Raise unless every parameter of ``module`` lies on ``device``."""
    for name, p in module.named_parameters():
        if p.device.type != device.type or (
                device.index is not None and p.device.index != device.index):
            raise ValueError(
                f"{what} parameter {name!r} is on {p.device}, but the entry "
                f"point runs on {device}; move the module with .to(device)")
