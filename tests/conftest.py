"""Shared fixtures. NOTE: never set xla_force_host_platform_device_count
here — smoke tests and benches must see the 1 real CPU device; only
``repro.launch.dryrun`` (its own process) requests 512 placeholders.
"""
import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (and triton); skips elsewhere")


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture()
def rng():
    """Per-test-seeded numpy Generator: every RNG-dependent test draws from
    its own fixed stream, so failures reproduce regardless of which other
    tests ran (no shared global numpy state)."""
    return np.random.default_rng(0)
