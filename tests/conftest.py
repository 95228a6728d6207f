import os
import sys
import types

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke
# tests and benches must see the real single CPU device (dry-run only).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# ``hypothesis`` is optional: offline environments must still collect and
# run the tier-1 suite.  When it is missing we install a no-op stand-in
# module whose ``@given`` skips the property tests (everything else runs).
try:
    from hypothesis import settings

    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")
except ImportError:  # offline: stub out the API surface the tests use
    import pytest

    def _given(*_a, **_k):
        def deco(fn):
            # zero-arg wrapper: hypothesis-provided params must NOT look
            # like pytest fixtures, so don't preserve the signature
            def wrapper():
                pytest.skip("hypothesis not installed")
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    class _Anything:
        """Stands in for ``hypothesis.strategies``: every attribute is a
        callable returning None (strategies are only consumed by @given,
        which skips before the test body runs)."""

        def __getattr__(self, name):
            return lambda *a, **k: None

    class _Settings:
        def __init__(self, *a, **k):
            pass

        def __call__(self, fn):
            return fn

        @staticmethod
        def register_profile(*a, **k):
            pass

        @staticmethod
        def load_profile(*a, **k):
            pass

    _fake = types.ModuleType("hypothesis")
    _fake.given = _given
    _fake.settings = _Settings
    _fake.strategies = _Anything()
    sys.modules["hypothesis"] = _fake
    sys.modules["hypothesis.strategies"] = _fake.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips with a reason without one)")
