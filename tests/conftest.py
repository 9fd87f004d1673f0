import sys
import types

import jax
import pytest

# Smoke tests and benches run on the single real CPU device; ONLY the
# dry-run subprocess sets --xla_force_host_platform_device_count=512.

jax.config.update("jax_threefry_partitionable", True)

# ---------------------------------------------------------------------------
# Graceful degrade when `hypothesis` is absent (see requirements-dev.txt):
# install a stub module whose @given marks the test skipped, so the suite
# still collects and the non-property-based tests run.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    def _given(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (pip install -r "
                       "requirements-dev.txt)")(fn)
        return deco

    def _settings(*_a, **_k):
        def deco(fn):
            return fn
        return deco

    class _Strategy:
        """Stand-in accepted anywhere a strategy is built/combined."""
        def __call__(self, *a, **k):
            return self

        def __getattr__(self, name):
            return self

    _st = types.ModuleType("hypothesis.strategies")
    _st.__getattr__ = lambda name: _Strategy()

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA CUDA card; skips without one")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
