from portbench.tests.test_portbench_check import *  # noqa: F401,F403
