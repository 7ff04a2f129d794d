"""The port's ``s11n``: the pickle round trips of
``tests/test_s11n_gp_callback.py`` on the port's objects (CPU), and the
cache API of ``tests/test_cache_mgmt.py`` over the kernel library's
directory, on a fake cache of ``libhy_kernels_<hash>.so``/``.log`` pairs
(an entry is a library with its log; the LRU key is the library's access
time; the loaded library is never evicted).  Pickled integrators continue
bit for bit like the originals."""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import _build, s11n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the fake entries, least recently used first: (hash, library bytes, log
#: bytes)
ENTRIES = [("aaaa", 100, 10), ("bbbb", 200, 20), ("cccc", 300, 30)]


def _lib(d, h):
    return d / f"{_build.LIB_PREFIX}{h}.so"


@pytest.fixture
def fake_cache(tmp_path, monkeypatch):
    d = tmp_path / "kernels"
    d.mkdir()
    now = time.time()
    for i, (h, n_so, n_log) in enumerate(ENTRIES):
        _lib(d, h).write_bytes(b"x" * n_so)
        _lib(d, h).with_suffix(".log").write_bytes(b"l" * n_log)
        # access times spaced 100 s apart, the mtimes in the other order
        os.utime(_lib(d, h), (now - 300 + 100 * i, now - 100 * i))
    # files that are no entry: another cache's, a build's leftovers
    (d / "jit_x-1-cache").write_bytes(b"j" * 50)
    (d / f"{_build.LIB_PREFIX}dddd.so.123.tmp").write_bytes(b"t" * 5)
    monkeypatch.setattr(_build, "_build_dir", d)
    monkeypatch.setattr(_build, "_loaded", None)
    monkeypatch.setattr(s11n, "_cache_limit", s11n._DEFAULT_CACHE_LIMIT)
    return d


def _names(d):
    return sorted(p.name for p in d.iterdir())


def test_cache_size_and_entries(fake_cache):
    assert s11n.cache_path() == str(fake_cache)
    assert s11n.cache_size() == 660
    ents = s11n.cache_entries()
    assert [os.path.basename(p) for _, _, p in ents] == [
        _lib(fake_cache, h).name for h, _, _ in ENTRIES]  # LRU first
    assert [sz for _, sz, _ in ents] == [110, 220, 330]


def test_trim_evicts_lru_first(fake_cache):
    # the two oldest (110 + 220) bring 660 to 330 <= 450; one is not
    # enough (550 > 450); each goes with its log, other files stay
    assert s11n.trim_cache(450) == 330
    assert _names(fake_cache) == sorted([
        _lib(fake_cache, "cccc").name, f"{_build.LIB_PREFIX}cccc.log",
        "jit_x-1-cache", f"{_build.LIB_PREFIX}dddd.so.123.tmp"])


def test_trim_keeps_the_loaded_library(fake_cache, monkeypatch):
    monkeypatch.setattr(_build, "_loaded", _lib(fake_cache, "aaaa"))
    assert s11n.trim_cache(400) == 220 + 330
    assert _lib(fake_cache, "aaaa").exists()
    assert not _lib(fake_cache, "bbbb").exists()
    assert s11n.clear_cache() == 0
    assert [os.path.basename(p) for _, _, p in s11n.cache_entries()] == [
        _lib(fake_cache, "aaaa").name]


def test_set_cache_limit_trims(fake_cache):
    s11n.set_cache_limit(600)
    assert s11n.get_cache_limit() == 600
    assert s11n.cache_size() == 550
    assert not _lib(fake_cache, "aaaa").exists()


def test_clear_cache(fake_cache):
    assert s11n.clear_cache() == 660
    assert s11n.cache_entries() == []


def test_pack_unpack_roundtrip(fake_cache, tmp_path):
    art = str(tmp_path / "seed.tar.gz")
    assert s11n.pack_cache(art) == 3
    dest = tmp_path / "cold"
    assert s11n.unpack_cache(art, str(dest)) == 3
    assert _names(dest) == sorted(
        n for h, _, _ in ENTRIES
        for n in (_lib(dest, h).name, f"{_build.LIB_PREFIX}{h}.log"))
    assert _lib(dest, "cccc").stat().st_size == 300


def test_default_dir_env_relocation(monkeypatch, tmp_path):
    monkeypatch.setenv("HEYOKA_TPU_CACHE_DIR", str(tmp_path / "reloc"))
    assert s11n._default_cache_dir() == str(tmp_path / "reloc")
    monkeypatch.delenv("HEYOKA_TPU_CACHE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert s11n._default_cache_dir() == str(
        tmp_path / "xdg" / "heyoka_tpu_torch" / "kernels")


def test_enable_compilation_cache_moves_the_library(fake_cache, tmp_path,
                                                    monkeypatch):
    # the in-checkout build directory is the default; the call moves the
    # library's path (same name: the hash of the sources) and trims
    monkeypatch.setattr(_build, "_build_dir", _build.DEFAULT_BUILD_DIR)
    assert _build.library_path().parent == _build.DEFAULT_BUILD_DIR
    name = _build.library_path().name
    monkeypatch.setenv("HEYOKA_TPU_CACHE_DIR", str(fake_cache))
    assert s11n.enable_compilation_cache(max_size=600) == str(fake_cache)
    assert _build.library_path() == fake_cache / name
    assert s11n.get_cache_limit() == 600 and s11n.cache_size() == 550
    other = tmp_path / "other"
    assert s11n.enable_compilation_cache(other) == str(other)
    assert other.is_dir() and s11n.cache_entries() == []


def test_expression_pickle():
    x, v = ht.make_vars("x", "v")
    e = ht.sin(x) * ht.par[0] + ht.time * v ** 2.5
    e2 = ht.s11n.loads(ht.s11n.dumps(e))
    assert e2 == e and hash(e2) == hash(e)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_integrator_pickle_midflight(dtype):
    tol = 1e-12 if dtype == np.float64 else 1e-6
    ta = ht.taylor_adaptive(ht.models.pendulum(), [0.05, 0.025], tol=tol,
                            dtype=dtype, device="cpu")
    ta.propagate_until(3.7)
    ta2 = ht.s11n.loads(ht.s11n.dumps(ta))
    assert ta2.time == ta.time and ta2.order == ta.order
    assert ta2.dtype == ta.dtype == dtype
    np.testing.assert_array_equal(ta2.state, ta.state)
    np.testing.assert_array_equal(ta2.tc, ta.tc)
    ta.propagate_until(8.0)
    ta2.propagate_until(8.0)
    np.testing.assert_array_equal(ta.state, ta2.state)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_integrator_pickle(dtype, tmp_path):
    rng = np.random.default_rng(0)
    states = 0.05 + 0.01 * rng.standard_normal((4, 2))
    tab = ht.taylor_adaptive_batch(ht.models.pendulum(), states,
                                   tol=1e-12 if dtype == np.float64
                                   else 1e-6, dtype=dtype, device="cpu")
    tab.propagate_until(2.0)
    p = tmp_path / "tab.pkl"
    ht.s11n.save(tab, str(p))
    tab2 = ht.s11n.load(str(p))
    assert tab2.dtype == dtype and tab2.dtime[0].dtype == dtype
    np.testing.assert_array_equal(tab2.state, tab.state)
    np.testing.assert_array_equal(tab2.time, tab.time)
    tab.propagate_until(4.0)
    tab2.propagate_until(4.0)
    np.testing.assert_array_equal(tab2.state, tab.state)


def test_cfunc_pickle_fresh_process(tmp_path):
    # a dataset op rehydrates in a process that never built the EOPData
    cf = ht.make_cfunc([ht.models.pm_x() * 2.0], vars=[], device="cpu")
    want = float(cf(np.zeros(0), time=0.2)[0])
    p = tmp_path / "cf.pkl"
    with open(p, "wb") as f:
        ht.s11n.save(cf, f)
    code = ("import numpy as np, heyoka_tpu_torch as ht\n"
            f"cf = ht.s11n.load({str(p)!r})\n"
            "print(repr(float(cf(np.zeros(0), time=0.2)[0])))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert float(r.stdout.strip()) == want


def test_continuous_output_pickle():
    ta = ht.taylor_adaptive(ht.models.pendulum(), [0.05, 0.025], tol=1e-12,
                            device="cpu")
    *_, co = ta.propagate_until(12.0, c_output=True)
    co2 = pickle.loads(ht.s11n.dumps(co))
    ts = np.linspace(0.5, 11.5, 13)
    np.testing.assert_array_equal(co(ts), co2(ts))


def _te_cb(tb, d_sgn, lane):
    return True


def test_batch_integrator_pickle_with_events():
    rng = np.random.default_rng(1)
    v = ht.make_vars("v")
    states = 0.05 + 0.01 * rng.standard_normal((4, 2))
    tab = ht.taylor_adaptive_batch(
        ht.models.pendulum(), states, tol=1e-12, device="cpu",
        t_events=[ht.t_event(v, callback=_te_cb, cooldown=0.5)])
    tab.propagate_until(10.0)
    tab2 = ht.s11n.loads(ht.s11n.dumps(tab))
    np.testing.assert_array_equal(tab2.state, tab.state)
    np.testing.assert_array_equal(tab2.time, tab.time)
    np.testing.assert_array_equal(tab2.te_cooldowns, tab.te_cooldowns)
    tab.propagate_until(12.0)
    tab2.propagate_until(12.0)
    np.testing.assert_allclose(tab2.state, tab.state, rtol=0, atol=1e-13)
