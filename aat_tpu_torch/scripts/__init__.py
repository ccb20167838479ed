"""The offline discrete-token pipeline's command lines (counterparts of
``scripts/segment_embeddings.py``, ``scripts/mean_segment_embeddings.py``
and ``scripts/quantize_embeddings.py``), run as
``python -m aat_tpu_torch.scripts.<name>``. They default to ``cuda:0`` and
raise without a GPU; ``main(argv, device="cpu")`` runs the plain versions."""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` or ``cuda:0``; a CUDA device that is not there raises."""
    device = torch.device(device if device is not None else "cuda:0")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested but no CUDA device is available; "
                           "pass device='cpu' to run the plain versions")
    return device
