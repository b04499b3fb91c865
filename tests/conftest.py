"""Shared fixtures.  NOTE: no XLA_FLAGS here by design — smoke tests and
benches must see the real single CPU device; only launch/dryrun.py forces
the 512-device host platform (and only in its own process)."""

import jax
import pytest


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
