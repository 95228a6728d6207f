"""A module fixture for the port's test files that compile JAX programs.

Every compiled XLA CPU program holds memory mappings of its own, and a
process may hold at most ``vm.max_map_count`` of them (65,530 by
default).  Under ``pytest -n`` one worker process runs many test files
in turn, so a file that compiles many programs leaves its mappings to
the files after it: ``tests/test_simulate.py`` alone reaches 62,469
after 30 of its tests, and a worker that runs its later tests after
such a file crashes inside XLA's compiler when the limit is reached.
A file imports the fixture by name to free its programs when it ends:

    from torch_jax_release import release_compiled_programs  # noqa: F401
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def release_compiled_programs():
    """Drop every compiled JAX program when the module's tests end (the
    next call of a jitted function compiles it again)."""
    yield
    import jax
    jax.clear_caches()
