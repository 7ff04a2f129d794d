"""Packaged data of the port: byte-identical copies of ``heyoka_tpu/data``'s
EGM2008 coefficients (``egm2008.npz``), thermoNET weights
(``nrlmsise00_tn.npz``, ``jb08_tn.npz``), ephemeris series tables
(``vsop2013_p9.npz``, ``elp2000.npz``, ``iau2006.npz``) and the builtin
Earth-orientation and space-weather snapshots (``eop_builtin.npz``,
``sw_builtin.npz``).

The JAX models read these through ``importlib.resources`` of
``heyoka_tpu.data``, which imports the JAX package; the port reads its
own copies by path, relative to this file."""

from __future__ import annotations

from pathlib import Path

DATA_DIR = Path(__file__).resolve().parent


def data_path(name: str) -> Path:
    """The path of the packaged data file ``name`` (e.g. ``"egm2008.npz"``)."""
    p = DATA_DIR / name
    if not p.is_file():
        raise FileNotFoundError(
            f"no packaged data file {name!r} in {DATA_DIR}")
    return p
