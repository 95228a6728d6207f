"""The map guard (tests/xla_map_guard.py) that keeps a test process under
the kernel's cap on memory mappings: this module loads it for the whole
process, and these tests check that it is loaded, that it drops the
compiled JAX programs past its share of the cap and not below it, and
that dropping them gives the mappings back."""

import jax
import jax.numpy as jnp
import pytest

pytest_plugins = ("xla_map_guard",)


@pytest.fixture
def G(request):
    """The guard as the process loaded it."""
    guard = request.config.pluginmanager.get_plugin("xla_map_guard")
    assert guard is not None
    return guard


def test_guard_is_a_plugin_of_the_process(G):
    assert callable(G.pytest_runtest_teardown)


def test_cap_and_count_are_read(G):
    cap, count = G.map_cap(), G.map_count()
    if cap is None or count is None:
        pytest.skip("no /proc on this system")
    assert 0 < count < cap


@pytest.mark.parametrize("count,released", [(10, False), (50, False),
                                            (51, True), (99, True)])
def test_release_only_past_the_share(G, count, released):
    f = jax.jit(lambda x: x * 3.0 + 1.0)
    f(jnp.ones(4)).block_until_ready()
    assert f._cache_size() == 1
    assert G.release_if_near_cap(cap=100, count=count) is released
    assert f._cache_size() == (0 if released else 1)
    assert float(f(jnp.ones(4))[0]) == 4.0


def test_release_gives_the_mappings_back(G):
    before = G.map_count()
    if before is None:
        pytest.skip("no /proc on this system")
    fs = [jax.jit(lambda x, i=i: jnp.sin(x * i) @ x.T + i)
          for i in range(1, 41)]
    for f in fs:
        f(jnp.ones((8, 8))).block_until_ready()
    grown = G.map_count()
    assert G.release_if_near_cap(cap=1, count=grown)
    after = G.map_count()
    # 40 programs hold about 12 mappings each on the CPU; most go back
    assert grown - after > (grown - before) // 2
