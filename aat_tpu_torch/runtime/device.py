"""Where the port's entry points run: the card unless the caller asks for
the CPU. The model builder (``models/build``) and the pipeline command
lines (``scripts/``) resolve their ``device`` argument here."""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` or ``cuda:0``; a CUDA device that is not there raises."""
    device = torch.device(device if device is not None else "cuda:0")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f'{device} requested but no CUDA device is available; '
                           'pass device="cpu" to run the plain versions')
    return device
