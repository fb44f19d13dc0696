"""Test harness config: CPU-only JAX with a virtual 8-device mesh.

Tests must not require an accelerator (SURVEY.md §4.2): decoders are checked
against the plain-numpy reference (ref_decoders.py) on the CPU, distributed
tests fake an 8-device mesh there. XLA_FLAGS is set before backend init and
jax_platforms is forced to the CPU at import, whatever the machine has.
The GPU path is exercised by chip_smoke.py.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: statistical BER tests (minutes)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m"):
        return
    skip_slow = pytest.mark.skip(reason="slow; run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def mackay_graph():
    from ecc_ldpc_tpu.codes import mackay_1008
    from ecc_ldpc_tpu.graph import compile_graph

    spec = mackay_1008()
    return spec, compile_graph(spec)
