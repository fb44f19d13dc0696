"""Report formats + curve-parity CLI (SURVEY.md §2.2 C23, §5.5)."""
import json

import pytest

from ecc_ldpc_tpu.cli.main import main
from ecc_ldpc_tpu.sim.runner import PointResult
from ecc_ldpc_tpu.sim.report import results_to_csv, save_results


def _pt(ebn0, errs, frames=1000):
    return PointResult("c", "d", ebn0, frames=frames, frame_errors=errs,
                       bit_errors=errs * 3, message_bits_per_frame=100)


def test_csv_output(tmp_path):
    res = [_pt(1.0, 50), _pt(2.0, 5)]
    text = results_to_csv(res)
    lines = text.strip().splitlines()
    assert lines[0].startswith("code,decoder,ebn0_db")
    assert len(lines) == 3
    p = tmp_path / "out.csv"
    save_results(res, str(p))
    assert p.read_text() == text


def test_point_result_json_roundtrip():
    r = _pt(1.5, 42)
    r2 = PointResult.from_json(r.to_json())
    assert r2.ebn0_db == 1.5 and r2.frame_errors == 42
    assert abs(r2.fer - r.fer) < 1e-12


def test_compare_command(tmp_path, capsys):
    a = [_pt(1.0, 50), _pt(2.0, 10)]
    b = [_pt(1.0, 55), _pt(2.0, 12)]
    c = [_pt(1.0, 500), _pt(2.0, 10)]
    for name, res in [("a", a), ("b", b), ("c", c)]:
        save_results(res, str(tmp_path / f"{name}.json"))
    rc = main(["compare", str(tmp_path / "a.json"), str(tmp_path / "b.json")])
    assert rc == 0
    assert "YES" in capsys.readouterr().out
    rc = main(["compare", str(tmp_path / "a.json"), str(tmp_path / "c.json")])
    assert rc == 1


def _gp(ebn0, frames, frame_errors, bit_errors, k=100):
    from ecc_ldpc_tpu.sim.runner import PointResult

    return PointResult(code="c", decoder="d", ebn0_db=ebn0, frames=frames,
                       frame_errors=frame_errors, bit_errors=bit_errors,
                       message_bits_per_frame=k)


@pytest.mark.parametrize("measured,golden,passes", [
    # same FER and BER: pass
    ((1.0, 4096, 400, 4000), (1.0, 16384, 1600, 16000), True),
    # FER CIs disjoint near saturation but within the 0.8-1.25x band
    ((1.0, 4096, 2580, 90000), (1.0, 16384, 11140, 360000), True),
    # FER twice the golden's at a waterfall point: fail
    ((1.0, 4096, 800, 8000), (1.0, 16384, 1600, 16000), False),
    # FER equal, BER 1.8x: outside the CI, inside the 2x band: pass
    ((1.0, 4096, 400, 7200), (1.0, 16384, 1600, 16000), True),
    # FER equal, BER 3x: fail
    ((1.0, 4096, 400, 12000), (1.0, 16384, 1600, 16000), False),
])
def test_golden_gate_rule(measured, golden, passes):
    from ecc_ldpc_tpu.sim.report import golden_gate

    ok, report = golden_gate([_gp(*measured)], [_gp(*golden)])
    assert ok is passes, report
    assert "1.0 dB" in report
