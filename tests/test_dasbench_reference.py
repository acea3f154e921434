"""The benchmark's CPU tests of ``dasbench/tests/test_bench_reference.py``,
collected here so that Tier-1 runs them (one module a file, which the
workers spread)."""

from dasbench.tests.test_bench_reference import *  # noqa: F401,F403
