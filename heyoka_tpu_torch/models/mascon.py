"""Mascon model, copied from ``heyoka_tpu.models.mascon``: motion around a
rotating non-uniform body described by point masses (reference:
``src/model/mascon.cpp`` — fixed_centres + rotating)."""

from __future__ import annotations

from .fixed_centres import (
    fixed_centres,
    fixed_centres_energy,
    fixed_centres_potential,
)
from .rotating import rotating, rotating_potential


def mascon(*, Gconst=1.0, masses=(), positions=(), omega=()):
    fc = fixed_centres(Gconst=Gconst, masses=masses, positions=positions)
    rot = rotating(omega=omega)
    out = list(fc[:3])
    for (v, a_fc), (_, a_rot) in zip(fc[3:], rot[3:]):
        out.append((v, a_fc + a_rot))
    return out


def mascon_potential(*, Gconst=1.0, masses=(), positions=(), omega=()):
    return fixed_centres_potential(
        Gconst=Gconst, masses=masses, positions=positions
    ) + rotating_potential(omega=omega)


def mascon_energy(*, Gconst=1.0, masses=(), positions=(), omega=()):
    return fixed_centres_energy(
        Gconst=Gconst, masses=masses, positions=positions
    ) + rotating_potential(omega=omega)
