"""Henon-Heiles' plain reference: the Taylor coefficients of ``x' = px,
y' = py, px' = -x - 2 x y, py' = -y - (x^2 - y^2)`` by their recurrences,
in torch, and its conserved energy ``(px^2 + py^2 + x^2 + y^2) / 2 +
x^2 y - y^3 / 3``.  Order by order, ``x y``, ``x^2`` and ``y^2`` are Cauchy
products, and each coefficient ``k + 1`` is its derivative's coefficient
``k`` over ``k + 1``.  Nothing here comes from the program.
"""

from __future__ import annotations

import torch

class System:
    """The equations for lanes of ``(B, 4)`` states ``x y px py``."""

    dim = 4

    def __init__(self, cfg, dtype, device):
        self._a = torch.tensor([0, 0, 1], device=device)
        self._b = torch.tensor([1, 0, 1], device=device)

    def jet(self, x: torch.Tensor, K: int) -> torch.Tensor:
        """``(K+1, B, 4)`` normalised Taylor coefficients through ``x``."""
        X = x.new_zeros((K + 1,) + x.shape)
        X[0] = x
        for k in range(K):
            h = X[:k + 1]
            xy, xx, yy = (h[:, :, self._a] * h.flip(0)[:, :, self._b]).sum(
                0).unbind(1)
            q = X[k]
            X[k + 1] = torch.stack([q[:, 2], q[:, 3], -q[:, 0] - 2.0 * xy,
                                    -q[:, 1] - (xx - yy)], 1) / (k + 1)
        return X

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """``(B,)`` energies of ``(B, 4)`` states."""
        q, y = x[:, 0], x[:, 1]
        return 0.5 * (x * x).sum(1) + q * q * y - y ** 3 / 3.0


def make(cfg, dtype=torch.float64, device="cpu") -> System:
    return System(cfg, dtype, device)


def flops_per_step(cfg, K: int) -> int:
    """The fewest floating-point operations one lane-step of order ``K``
    takes on these equations, counted as ``outer_ss6.flops_per_step``
    counts: per order ``k``, ``2 k + 1`` for ``x y``, ``k + 1`` for each
    square, 4 for the right-hand sides and 4 divisions; then three norms
    and Horner's rule."""
    return sum(4 * k + 11 for k in range(K)) + 3 * 4 + 2 * K * 4
