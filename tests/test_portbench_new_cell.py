from portbench.tests.test_portbench_new_cell import *  # noqa: F401,F403
