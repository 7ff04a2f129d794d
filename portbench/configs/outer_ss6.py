"""The outer Solar System as the program under test is given it: the
port's ``models.nbody`` over ``outer_ss6.json``'s bodies, masses and G."""


def system(ht, cfg):
    """The equations in the port's expressions."""
    return ht.models.nbody(cfg["bodies"], masses=cfg["masses"],
                           Gconst=cfg["G"])
