"""chip_smoke.py on the CPU: it refuses to run without a GPU (exit code
non-zero, no result line), and its phases run end to end at tiny sizes —
the rehearsal of the chip run (phase 5 on four virtual CPU devices)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return out.returncode != 0 and not any(
        line.startswith("{") and '"ok"' in line for line in lines)


def test_refuses_without_gpu():
    out = _run(ROOT, ROOT / "chip_smoke.py")
    assert _no_result(out), out.stdout
    assert "needs a GPU" in out.stdout


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert _no_result(out), out.stdout


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke  # the repository root is on sys.path (conftest.py)

    return chip_smoke


def test_phase_main_path_tiny(smoke, capsys):
    smoke.phase_main_path(
        golden_path=ROOT / "curves" / "mackay1008_tpu_golden.json",
        batch=256, prod_code="wimax/576/12",
        prod_decoder="layered/norm:0.8125/10;retry=layered/spa/20",
        prod_batch=64, prod_batches=1, prod_ebn0=2.0)
    out = capsys.readouterr().out
    assert "golden gate vs mackay1008_tpu_golden.json: FER pass, BER pass" \
        in out
    assert "syndrome zero on" in out


def test_phase_parity_tiny(smoke, capsys):
    smoke.phase_parity(code="wimax/576/12", batch=16, ebn0=2.5, iters=8,
                       small_code="mackay1008", small_batch=64)
    assert capsys.readouterr().out.count("hard decisions differ on 0") == 3


def test_phase_times_tiny(smoke, capsys):
    smoke.phase_times(
        legs=[("wimax/576/12", "layered/norm:0.8125/5/noet", 32, 2.5)],
        small_batch=32, iters=5, crc_k=64, enc_batch=32)
    out = capsys.readouterr().out
    assert "Mbit/s" in out and "CRC-24A" in out


def test_phase_four_on_virtual_devices(smoke, capsys):
    assert len(jax.devices()) >= 4  # conftest: 8 virtual CPU devices
    smoke.phase_four(code="wimax/576/12", decoder="layered/norm:0.8125/8/noet",
                     ebn0=(2.0, 2.5), batch=32, gp_batch=16, iters=8)
    out = capsys.readouterr().out
    assert "mesh 4x1" in out and "mesh 2x2" in out


def test_compare_tolerance(smoke):
    """Parity tolerance: hard decisions must match on frames both sides
    report ok; ok/iterations may differ on at most 1% of frames."""
    import numpy as np

    from ecc_ldpc_tpu.decode.types import DecodeResult

    B = 200
    bits = np.zeros((B, 8), np.uint8)
    ok = np.ones(B, bool)
    iters = np.full(B, 3, np.int32)
    a = DecodeResult(bits=bits, ok=ok, iterations=iters)
    two = iters.copy()
    two[:2] = 4
    smoke.compare(a, DecodeResult(bits=bits, ok=ok, iterations=two), "2/200")
    three = iters.copy()
    three[:3] = 4
    with pytest.raises(smoke.PhaseFailed):
        smoke.compare(a, DecodeResult(bits=bits, ok=ok, iterations=three),
                      "3/200")
    flipped = bits.copy()
    flipped[5, 0] = 1
    with pytest.raises(smoke.PhaseFailed):
        smoke.compare(a, DecodeResult(bits=flipped, ok=ok, iterations=iters),
                      "bits")
