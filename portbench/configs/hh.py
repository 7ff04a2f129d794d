"""Henon-Heiles as the program under test is given it: the equations of
``hh.json`` in the port's expressions."""


def system(ht, cfg):
    """The equations in the port's expressions."""
    x, y, px, py = ht.make_vars(*cfg["variables"])
    return [(x, px), (y, py), (px, -x - 2.0 * x * y),
            (py, -y - (x * x - y * y))]
