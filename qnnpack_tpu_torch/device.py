"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when a GPU is asked for and absent.

    Entry points default to the GPU and run on the CPU only when the caller
    passes device="cpu" - there is no silent fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qnnpack_tpu_torch: no CUDA GPU is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev
