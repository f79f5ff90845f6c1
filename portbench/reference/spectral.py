"""Plain lambda_2 of a topology's Laplacian by block power iteration.

The program's stated method, written from its definition in plain PyTorch:
power iteration on ``B = c I - L`` (``c = 2 max degree + 1``) with a block
of ``block`` vectors drawn by ``torch.randn`` from a CPU generator seeded
``seed``; each step deflates the all-ones vector, re-orthonormalises by QR
and applies ``B``; after ``iters`` steps one more application gives the
Rayleigh quotients, and lambda_2 is ``c`` minus the largest, clipped at 0.

``control=True`` computes in float32 with every matrix product through
TF32 operands (the control of the benchmark's check); otherwise float64.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.mw import to_tf32

__all__ = ["lambda2_reference"]


def lambda2_reference(adj, iters: int, block: int, seed: int,
                      control: bool = False, device="cpu") -> float:
    dtype = torch.float32 if control else torch.float64
    dev = torch.device(device)
    a = torch.as_tensor(np.asarray(adj), dtype=dtype, device=dev)
    n = a.shape[0]
    deg = a.sum(dim=1)
    c = 2.0 * float(deg.max()) + 1.0
    ones = torch.full((n, 1), 1.0 / np.sqrt(n), dtype=dtype, device=dev)
    gen = torch.Generator().manual_seed(int(seed))
    v = torch.randn((n, block), generator=gen, dtype=torch.float32)
    v = v.to(dtype=dtype, device=dev)

    def mm(x, y):
        return to_tf32(x) @ to_tf32(y) if control else x @ y

    def apply_b(v):
        v = v - mm(ones, mm(ones.T, v))
        q, _ = torch.linalg.qr(v)
        return q, c * q - deg[:, None] * q + mm(a, q)

    for _ in range(iters):
        _, v = apply_b(v)
    q, w = apply_b(v)
    lam_b = torch.diagonal(mm(q.T, w))
    return max(c - float(lam_b.max()), 0.0)
