"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches see
the real (single-CPU) device; only repro.launch.dryrun fakes 512 devices."""
import sys

try:
    import hypothesis  # noqa: F401  (real package wins when installed)
except ModuleNotFoundError:
    from repro.testing import hypothesis_stub

    sys.modules["hypothesis"] = hypothesis_stub
    sys.modules["hypothesis.strategies"] = hypothesis_stub.strategies

import jax
import numpy as np
import pytest

from repro.config import get_config
from repro.models.api import build_model


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs a CUDA card; skips (inside the test) without "
        "one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


_MODEL_CACHE = {}


def reduced_model(arch_id: str):
    """Session-cached reduced model + params (init is the slow part)."""
    if arch_id not in _MODEL_CACHE:
        cfg = get_config(arch_id).reduced()
        model = build_model(cfg)
        params = model.init(jax.random.key(0))
        _MODEL_CACHE[arch_id] = (model, params)
    return _MODEL_CACHE[arch_id]
