"""The outer Solar System's plain reference: the Taylor coefficients of
Newton's N-body equations by their recurrences, in torch, from
``outer_ss6.json``'s bodies, masses and G, and their conserved energy.

For bodies ``i < j`` with ``d = r_j - r_i``, ``s = |d|^2`` and
``p = s^(-3/2)``, body ``i`` accelerates by ``G m_j d p`` and body ``j``
by ``-G m_i d p``.  Order by order, ``s`` is a Cauchy square, ``p``
follows the power rule ``k s_0 p_k = sum_{j<k} (a (k - j) - j) s_{k-j}
p_j`` with ``a = -3/2``, ``d p`` is a Cauchy product, and the state's
coefficient ``k + 1`` is its derivative's coefficient ``k`` over
``k + 1``.  Nothing here comes from the program: the same equations,
written out once more.
"""

from __future__ import annotations

import itertools

import torch


class System:
    """The equations for lanes of ``(B, 6 n)`` states, body by body
    ``x y z vx vy vz``."""

    def __init__(self, cfg, dtype, device):
        n = cfg["bodies"]
        pairs = list(itertools.combinations(range(n), 2))
        self.n, self.dim = n, 6 * n
        self.I = torch.tensor([i for i, _ in pairs], device=device)
        self.J = torch.tensor([j for _, j in pairs], device=device)
        # pair p adds G m_j d p to body I[p] and -G m_i d p to body J[p]
        M = torch.zeros((n, len(pairs)), dtype=torch.float64)
        G, m = cfg["G"], cfg["masses"]
        for p, (i, j) in enumerate(pairs):
            M[i, p] = G * m[j]
            M[j, p] = -G * m[i]
        self.M = M.to(dtype=dtype, device=device)
        self.m = torch.tensor(m, dtype=dtype, device=device)
        self.Gmm = torch.tensor([G * m[i] * m[j] for i, j in pairs],
                                dtype=dtype, device=device)

    def jet(self, x: torch.Tensor, K: int) -> torch.Tensor:
        """``(K+1, B, 6 n)`` normalised Taylor coefficients through ``x``."""
        B, n, P = x.shape[0], self.n, self.I.numel()
        X = x.new_zeros((K + 1, B, n, 6))
        X[0] = x.reshape(B, n, 6)
        D = x.new_zeros((K + 1, B, P, 3))
        S = x.new_zeros((K + 1, B, P))
        Pw = x.new_zeros((K + 1, B, P))
        for k in range(K):
            r = X[k, :, :, :3]
            D[k] = r[:, self.J] - r[:, self.I]
            S[k] = (D[:k + 1] * D[:k + 1].flip(0)).sum((0, 3))
            if k == 0:
                Pw[0] = S[0] ** -1.5
            else:
                j = torch.arange(k, dtype=x.dtype, device=x.device)
                w = (-1.5 * (k - j) - j)[:, None, None]
                Pw[k] = (w * S[1:k + 1].flip(0) * Pw[:k]).sum(0) / (k * S[0])
            Q = (D[:k + 1] * Pw[:k + 1, :, :, None].flip(0)).sum(0)
            X[k + 1, :, :, :3] = X[k, :, :, 3:] / (k + 1)
            X[k + 1, :, :, 3:] = torch.einsum("np,bpc->bnc", self.M, Q) \
                / (k + 1)
        return X.reshape(K + 1, B, 6 * n)

    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """``(B,)`` energies of ``(B, 6 n)`` states: the bodies' kinetic
        energies less ``G m_i m_j / |r_j - r_i|`` over the pairs."""
        b = x.reshape(x.shape[0], self.n, 6)
        r, v = b[:, :, :3], b[:, :, 3:]
        d = (r[:, self.J] - r[:, self.I]).norm(dim=2)
        return 0.5 * (self.m * (v * v).sum(2)).sum(1) \
            - (self.Gmm / d).sum(1)


def make(cfg, dtype=torch.float64, device="cpu") -> System:
    return System(cfg, dtype, device)


def flops_per_step(cfg, K: int) -> int:
    """The fewest floating-point operations one lane-step of order ``K``
    takes on these equations: the recurrences above counted term by
    term, with a Cauchy square at ``k + 1`` operations (its symmetry
    halves the products), a power of order 0 and each division counted as
    one operation, and constants that depend on ``k`` alone not counted;
    then the step size (three norms) and the new state by Horner's rule.
    Per pair and order ``k``: 3 differences, ``3 (k + 1) + 2`` for ``s``,
    ``3 k`` for ``p`` (1 at order 0), ``3 (2 k + 1)`` for ``d p``, 6
    products by ``G m`` and 6 sums into the accelerations."""
    n = cfg["bodies"]
    P = n * (n - 1) // 2
    dim = 6 * n
    jet = sum(P * (3 + 3 * (k + 1) + 2 + max(3 * k, 1) + 3 * (2 * k + 1)
                   + 12) + dim for k in range(K))
    return jet + 3 * dim + 2 * K * dim
