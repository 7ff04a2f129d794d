"""Test configuration of the benchmark's own tests (``portbench/tests``).

Registers the ``gpu`` marker, as ``tests/conftest.py`` does for
``tests/``: a test that needs a CUDA device carries it and decides inside
itself, never at import, whether there is one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (a run of the benchmark on the card); "
        "skips without one",
    )
