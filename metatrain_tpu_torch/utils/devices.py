"""The device of an entry point: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``"auto"`` is the first CUDA device. ``"auto"`` or a CUDA device
    without a card raises rather than run on the CPU unasked."""
    if isinstance(name, torch.device):
        name = str(name)
    if name == "auto" or str(name).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'device "{name}" runs on a CUDA device and none was found; '
                'pass device: "cpu" (--device cpu) to run on the CPU'
            )
        return torch.device("cuda", 0) if name == "auto" else torch.device(name)
    return torch.device(name)
