"""Model library of the port: the models of the slices ported so far (the
ephemeris models ``vsop2013``, ``elp2000`` and ``iau2006`` since ROADMAP
A.14)."""

from .nbody import (  # noqa: F401
    nbody,
    nbody_energy,
    nbody_potential,
    np1body,
    np1body_energy,
    np1body_potential,
)
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
from .kepler import (  # noqa: F401
    kepler_to_cartesian,
    cartesian_to_kepler,
    lagrange_prop,
)
from .sh_gravity import (  # noqa: F401
    sh_gravity_pot,
    sh_gravity_acc,
    egm2008_pot,
    egm2008_acc,
    get_egm2008_mu,
    get_egm2008_a,
    get_egm2008_CS,
)
from .sgp4 import (  # noqa: F401
    sgp4,
    gpe_is_deep_space,
    SGP4Propagator,
    sgp4_propagator,
)
from .cart2geo import cart2geo, geo2cart  # noqa: F401
from .time_conversions import delta_tt_tai, delta_tdb_tt  # noqa: F401
from .thermonets import nrlmsise00_tn, jb08_tn  # noqa: F401
from .iau2006 import iau2006  # noqa: F401
from .elp2000 import (  # noqa: F401
    elp2000_spherical,
    elp2000_cartesian,
    elp2000_cartesian_e2000,
    elp2000_cartesian_fk5,
    get_elp2000_mus,
)
from .vsop2013 import (  # noqa: F401
    vsop2013_elliptic,
    vsop2013_cartesian,
    vsop2013_cartesian_icrf,
    get_vsop2013_mus,
)
