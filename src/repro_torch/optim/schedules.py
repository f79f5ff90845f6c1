"""LR schedules (pure functions of the step counter).

The port of ``repro/optim/schedules.py``: float32 tensors on the step's
device (the CPU for a Python int).
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(step, peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, lr: float) -> torch.Tensor:
    dev = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), lr, dtype=torch.float32, device=dev)
