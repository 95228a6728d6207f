"""A pytest plugin that keeps a test process under the kernel's cap on
memory mappings (``vm.max_map_count``, 65,530 by default).

Every compiled XLA CPU program holds memory mappings of its own, and a
process that passes the cap crashes inside XLA's compiler.  Under
``pytest -n --dist load`` a worker may be handed a whole file's tests
in one chunk: ``tests/test_simulate.py`` run alone in one process
passes 62,000 mappings by its 31st test and aborts there.  After each
test, where JAX is loaded and the process holds more than half the cap,
this plugin drops every compiled JAX program (the next call of a jitted
function compiles it again), so no test starts near the cap.

A test module loads it for the whole process with

    pytest_plugins = ("xla_map_guard",)

and every worker process imports every test module while it collects.
"""

import gc
import sys

import pytest

SHARE = 0.5  # of the cap, past which the compiled programs are dropped


def map_cap():
    """The kernel's cap on one process's mappings, or None unreadable."""
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


def map_count():
    """The mappings this process holds, or None where unreadable."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return None


def release_if_near_cap(cap=None, count=None):
    """Drop every compiled JAX program where the process holds more than
    ``SHARE`` of the cap; returns whether it did."""
    jax = sys.modules.get("jax")
    cap = map_cap() if cap is None else cap
    count = map_count() if count is None else count
    if jax is None or cap is None or count is None or count <= SHARE * cap:
        return False
    jax.clear_caches()
    gc.collect()
    return True


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    release_if_near_cap()
