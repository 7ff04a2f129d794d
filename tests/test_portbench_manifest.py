from portbench.tests.test_portbench_manifest import *  # noqa: F401,F403
