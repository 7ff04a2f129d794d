"""Double-length arithmetic on pairs of tensors of one dtype: f64 pairs
("double-double") for a float64 integrator, f32 pairs for a float32 one,
as the JAX f32 batch keeps ``dtime``.

The counterpart of ``heyoka_tpu.dfloat`` (reference: heyoka's dfloat,
``src/detail/dfloat.cpp``): error-free two-sum accumulation of the
integrator time, so that accuracy holds over very many steps.  Works on
torch tensors of either dtype and Python floats alike; the sums keep
their operands' dtype.
"""

from __future__ import annotations


def two_sum(a, b):
    """Knuth two-sum: s + err == a + b exactly."""
    s = a + b
    v = s - a
    err = (a - (s - v)) + (b - v)
    return s, err


def quick_two_sum(a, b):
    """Dekker fast two-sum; requires |a| >= |b| (or a == 0)."""
    s = a + b
    err = b - (s - a)
    return s, err


def dd_add_d(hi, lo, x):
    """(hi, lo) + x with renormalization; returns (hi', lo')."""
    s, e = two_sum(hi, x)
    e = e + lo
    return quick_two_sum(s, e)


def dd_add_dd(ahi, alo, bhi, blo):
    """(ahi, alo) + (bhi, blo); returns (hi', lo')."""
    s, e = two_sum(ahi, bhi)
    e = e + alo + blo
    return quick_two_sum(s, e)


def dd_normalize(hi, lo):
    """(hi, lo) renormalized so that hi = fl(hi + lo) (heyoka
    ``set_dtime``)."""
    return quick_two_sum(hi, lo)
