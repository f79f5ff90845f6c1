"""Device resolution for the port's entry points.

Every solver entry point takes ``device=`` and defaults to ``"cuda"``: the
port is written for the GPU, and the CPU is a choice the caller makes (the
tests do, to compare with the JAX reference).  A machine without CUDA
raises here instead of carrying on silently on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve", "is_cuda"]


def resolve(device: "str | torch.device") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for but
    absent, or when the device is neither CUDA nor the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: expected cuda or cpu")
    return dev


def is_cuda(device: "str | torch.device") -> bool:
    return torch.device(device).type == "cuda"
