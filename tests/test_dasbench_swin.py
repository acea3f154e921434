"""The benchmark's CPU tests of ``dasbench/tests/test_bench_swin.py``,
collected here so that Tier-1 runs them (one module a file, which the
workers spread)."""

from dasbench.tests.test_bench_swin import *  # noqa: F401,F403
