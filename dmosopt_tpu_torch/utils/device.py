"""Device selection for the port's entry points.

The JAX package runs wherever JAX's default backend is. The port runs on
a CUDA device unless the caller names another: ``device=None`` means
``"cuda"``, and with no CUDA device that is an error, never a silent
fall-back to the CPU. Tests and CPU runs pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else -> ``torch.device(device)``.
    A CUDA device, named or by default, raises when none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dmosopt_tpu_torch runs on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU"
        )
    return dev
