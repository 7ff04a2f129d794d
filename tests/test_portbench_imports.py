from portbench.tests.test_portbench_imports import *  # noqa: F401,F403
