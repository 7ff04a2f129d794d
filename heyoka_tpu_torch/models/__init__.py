"""Model library of the port: the models of the slices ported so far."""

from .nbody import nbody, nbody_energy, nbody_potential  # noqa: F401
from .fixed_centres import (  # noqa: F401
    fixed_centres,
    fixed_centres_energy,
    fixed_centres_potential,
)
from .rotating import rotating, rotating_energy, rotating_potential  # noqa: F401
from .mascon import mascon, mascon_energy, mascon_potential  # noqa: F401
from .pendulum import pendulum, pendulum_energy  # noqa: F401
from .cr3bp import cr3bp, cr3bp_jacobi, pcr3bp  # noqa: F401
from .ffnn import ffnn, ffnn_par_count  # noqa: F401
