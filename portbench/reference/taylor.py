"""A plain Taylor integrator in torch: the benchmark's reference stepper.

It imports torch and nothing of the program under test.  A system hands
it ``jet(x (B, n), K) -> (K+1, B, n)``, the normalised Taylor
coefficients of its solution through ``x`` up to order ``K``, computed
by the system's own recurrences (``reference/<config>.py``).  Everything
else is written out here from the method's published description
(Jorba and Zou, "A software package for the numerical integration of ODEs
by means of high-order Taylor methods", 2005, section 3.2; heyoka's
``taylor_determine_h``):

- the order from the tolerance, ``K = max(2, ceil(-ln(tol) / 2 + 1))``;
- the step ``h = rho / e^2 * exp(-0.7 / (K - 1))`` with
  ``rho = min((m / |c_K|)^(1/K), (m / |c_{K-1}|)^(1/(K-1)))``, the norms
  the largest magnitudes over the state's components and ``m`` the
  largest magnitude of order 0, or 1 where that is larger;
- the new state by Horner's rule (the program may sum with compensation;
  the reference does not);
- the last step of a span clipped to land on its end.

The dtype is the caller's: float64 for the reference, float32 for the
control that puts it in the program's place at a lower precision.
"""

from __future__ import annotations

import math

import torch

def order_from_tol(tol: float) -> int:
    """Jorba's order for the tolerance ``tol``."""
    return max(2, math.ceil(-math.log(tol) / 2.0 + 1.0))


def step_size(c: torch.Tensor, K: int) -> torch.Tensor:
    """Each lane's step from its coefficients ``c (K+1, B, n)``."""
    a = c.abs().amax(-1)
    m = torch.clamp(a[0], min=1.0)
    rho = torch.minimum((m / a[K]) ** (1.0 / K),
                        (m / a[K - 1]) ** (1.0 / (K - 1)))
    return rho * (math.exp(-0.7 / (K - 1)) / (math.e * math.e))


def horner(c: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``sum_k c[k] tau^k`` for ``c (K+1, B, ...)`` and ``tau`` of shape
    ``(B,)`` broadcast over the trailing axes of ``c[k]``."""
    t = tau.reshape(tau.shape + (1,) * (c.dim() - 1 - tau.dim()))
    res = c[-1]
    for k in range(c.shape[0] - 2, -1, -1):
        res = c[k] + res * t
    return res


def propagate(jet, x: torch.Tensor, duration: float, K: int):
    """Integrate every lane of ``x (B, n)`` over ``duration`` (> 0), each
    with its own steps.  Returns ``(x_end (B, n), steps (B,))``."""
    x = x.clone()
    B = x.shape[0]
    tau = torch.zeros(B, dtype=x.dtype, device=x.device)
    steps = torch.zeros(B, dtype=torch.int64, device=x.device)
    active = torch.ones(B, dtype=torch.bool, device=x.device)
    while True:
        idx = active.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        c = jet(x[idx], K)
        h = step_size(c, K)
        t0 = tau[idx]
        rem = duration - t0
        last = h >= rem
        h = torch.where(last, rem, h)
        x[idx] = horner(c, h)
        tau[idx] = torch.where(last, torch.full_like(t0, duration), t0 + h)
        steps[idx] += 1
        active[idx[last]] = False
    return x, steps
