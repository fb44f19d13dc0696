"""Multi-host rendezvous smoke (SURVEY.md §4.2 item 4: num_processes=1)."""
import subprocess
import sys
from pathlib import Path

import pytest


@pytest.mark.slow
def test_distributed_initialize_single_process():
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');\n"
        "from ecc_ldpc_tpu.dist import maybe_init_distributed\n"
        "maybe_init_distributed(coordinator='127.0.0.1:29519',"
        " num_processes=1, process_id=0)\n"
        "assert jax.process_count() == 1\n"
        "print('OK')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=Path(__file__).resolve().parents[2],
    )
    assert "OK" in out.stdout, out.stderr[-500:]
