"""Serialization, and the kernel library's cache.

The counterpart of ``heyoka_tpu/s11n.py`` (reference: heyoka's
Boost.Serialization of every object, ``include/heyoka/s11n.hpp``, and its
managed compiled-code cache, ``src/llvm_state_cache.cpp``).

Every object of the port pickles (integrators with their lanes, cfuncs,
expressions, datasets), so :func:`save`, :func:`load`, :func:`dumps` and
:func:`loads` are pickle's, as in the JAX package.

The compiled code the port keeps is its CUDA kernel library
(``_build``): one shared library a hash of the kernels' sources and
flags, ``libhy_kernels_<hash>.so``, with the compilers' output beside it
(``.log``).  A cache entry is such a library together with its log.  The
JAX package's cache API manages JAX's persistent compilation cache; here
it manages the library's directory:

- :func:`enable_compilation_cache` moves the build directory to ``path``
  (default ``$HEYOKA_TPU_CACHE_DIR``, else
  ``$XDG_CACHE_HOME/heyoka_tpu_torch/kernels``, ``~/.cache`` without
  ``XDG_CACHE_HOME``), caps it at ``max_size`` bytes and trims it.  Until
  the call the library lives in ``build/heyoka_tpu_torch`` of the
  checkout;
- :func:`cache_entries`, :func:`cache_size`, :func:`cache_path`,
  :func:`get_cache_limit`/:func:`set_cache_limit`;
- :func:`trim_cache` evicts the least recently used entries (by access
  time: ``_build.load`` marks each use) down to the cap, never the
  library this process has loaded; :func:`clear_cache` down to 0;
- :func:`pack_cache` writes the entries to a ``.tar.gz`` and
  :func:`unpack_cache` restores them into a directory, so that a machine
  with the same sources loads the kernels without ``nvcc``.

The host libraries of ``backend="native"`` (:mod:`.native`,
:mod:`.native_cg`) live in ``native/`` under the same directory and are
not entries: compiled with ``-march=native`` for the CPU that built
them, they are no use to another host, so :func:`pack_cache` leaves them
out and :func:`trim_cache` never deletes them, as the JAX package's
cache API leaves its native libraries alone.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from pathlib import Path

from . import _build

__all__ = [
    "save", "load", "dumps", "loads",
    "enable_compilation_cache",
    "cache_path", "cache_size", "cache_entries",
    "get_cache_limit", "set_cache_limit",
    "trim_cache", "clear_cache", "pack_cache", "unpack_cache",
]


def save(obj, file) -> None:
    """Pickle ``obj`` (integrator, cfunc, expression, dataset, ...) to a
    file object or path."""
    if isinstance(file, (str, bytes)):
        with open(file, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    else:
        pickle.dump(obj, file, protocol=pickle.HIGHEST_PROTOCOL)


def load(file):
    if isinstance(file, (str, bytes)):
        with open(file, "rb") as f:
            return pickle.load(f)
    return pickle.load(file)


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads(data: bytes):
    return pickle.loads(data)


# ---------------------------------------------------------------------------
# the kernel library's cache
# ---------------------------------------------------------------------------

#: the reference's default cap of its disk cache (20 GB)
_DEFAULT_CACHE_LIMIT = 20 * 1024**3
_cache_limit: int = _DEFAULT_CACHE_LIMIT


def _default_cache_dir() -> str:
    """``$HEYOKA_TPU_CACHE_DIR``, else ``$XDG_CACHE_HOME`` (or
    ``~/.cache``) ``/heyoka_tpu_torch/kernels``: the reference's
    relocation order (``llvm_state_cache.cpp:322-343``)."""
    env = os.environ.get("HEYOKA_TPU_CACHE_DIR")
    if env:
        return env
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "heyoka_tpu_torch", "kernels")


def enable_compilation_cache(path: str | None = None,
                             max_size: int | None = None) -> str:
    """Build and load the kernel library in ``path`` from now on (default
    :func:`_default_cache_dir`), cap the directory at ``max_size`` bytes
    (default 20 GB) and trim it; returns the directory.  A library this
    process has already loaded stays loaded."""
    global _cache_limit
    path = _default_cache_dir() if path is None else str(path)
    if max_size is not None:
        _cache_limit = int(max_size)
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)
    trim_cache()
    return path


def cache_path() -> str:
    """The kernel library's directory (``build/heyoka_tpu_torch`` of the
    checkout until :func:`enable_compilation_cache`)."""
    return str(_build.build_dir())


def _entries(path: Path) -> list:
    """``(last_use, bytes, library path)`` of every entry in ``path``: a
    built library and its ``.log``; the use is the library's access
    time."""
    out = []
    for lib in path.glob(f"{_build.LIB_PREFIX}*.so"):
        try:
            st = lib.stat()
        except OSError:
            continue
        log = lib.with_suffix(".log")
        size = st.st_size + (log.stat().st_size if log.exists() else 0)
        out.append((st.st_atime, size, str(lib)))
    return out


def cache_entries() -> list:
    """``(last_use_ts, size_bytes, path)`` per entry (the library's path),
    least recently used first."""
    return sorted(_entries(_build.build_dir()))


def cache_size() -> int:
    """Bytes of every entry, the libraries and their logs."""
    return sum(sz for _, sz, _ in cache_entries())


def get_cache_limit() -> int:
    return _cache_limit


def set_cache_limit(nbytes: int) -> None:
    """Set the cap (bytes) and trim to it (the reference's
    ``llvm_state::set_memcache_limit``)."""
    global _cache_limit
    _cache_limit = int(nbytes)
    trim_cache()


def trim_cache(limit: int | None = None) -> int:
    """Evict the least recently used entries until the cache holds at most
    ``limit`` bytes (default: the cap), each library with its log, never
    the library this process has loaded.  Returns the bytes evicted."""
    limit = _cache_limit if limit is None else int(limit)
    ents = cache_entries()
    total = sum(sz for _, sz, _ in ents)
    loaded = _build.loaded_path()
    evicted = 0
    for _, sz, p in ents:
        if total <= limit:
            break
        lib = Path(p)
        if loaded is not None and lib.resolve() == loaded.resolve():
            continue
        try:
            lib.unlink()
        except OSError:
            continue
        lib.with_suffix(".log").unlink(missing_ok=True)
        total -= sz
        evicted += sz
    return evicted


def clear_cache() -> int:
    """Remove every entry but the loaded library; returns bytes
    removed."""
    return trim_cache(0)


def pack_cache(archive: str) -> int:
    """Pack every entry (each library and its log) into the ``.tar.gz``
    ``archive``; returns the number of entries."""
    ents = cache_entries()
    with tarfile.open(archive, "w:gz") as tf:
        for _, _, p in ents:
            lib = Path(p)
            tf.add(lib, arcname=lib.name)
            if lib.with_suffix(".log").exists():
                tf.add(lib.with_suffix(".log"), arcname=lib.stem + ".log")
    return len(ents)


def unpack_cache(archive: str, path: str | None = None) -> int:
    """Unpack a :func:`pack_cache` archive into ``path`` (default: the
    cache's directory), keeping the entries there and overwriting those of
    the same name; returns the number of libraries restored.  Only plain
    files at the archive's top level are taken."""
    dest = cache_path() if path is None else str(path)
    os.makedirs(dest, exist_ok=True)
    n = 0
    with tarfile.open(archive, "r:gz") as tf:
        for m in tf.getmembers():
            if not m.isfile() or "/" in m.name or m.name.startswith("."):
                continue
            tf.extract(m, dest, filter="data")
            n += m.name.endswith(".so")
    return n
