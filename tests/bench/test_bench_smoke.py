"""Benchmark harness smoke tests on CPU (SURVEY.md §4.2 item 6):
end-to-end runs with a tiny code, asserting only that numbers come out —
a CPU run gives no device time, so no timing is compared here."""
import json
from types import SimpleNamespace

import pytest

from ecc_ldpc_tpu.bench.throughput import (
    PEAKS, device_peaks, matmul_roofline_mbps, roofline_mbps, run_benchmark,
)
from ecc_ldpc_tpu.bench.scaling import run_scaling


def test_run_benchmark_smoke():
    r = run_benchmark(
        code="gallager/48/3/6/s5", decoder="minsum/5/noet", batch=32, tries=1
    )
    assert r.throughput_mbps > 0
    assert r.iters == 5 and r.n == 48
    line = json.loads(r.json_line())
    assert line["metric"] == "decoded_throughput"
    assert line["unit"] == "Mbit/s/chip"
    assert "vs_baseline" not in line
    assert line["device"] == {"platform": "cpu", "kind": "cpu",
                              "count": line["device"]["count"],
                              "name_power_limit": None}
    # no published peaks for a CPU: the ceiling is null, never a default
    assert line["roofline_mbps"] is None and line["compile_s"] > 0


def test_benchmark_layered_smoke():
    r = run_benchmark(
        code="80211n/648/12", decoder="layered/norm:0.8125/5/noet",
        batch=32, tries=1,
    )
    assert r.throughput_mbps > 0 and r.k == 324


def test_roofline_formula():
    # doubling iterations halves the memory-bound throughput
    a = roofline_mbps(1000, 500, 25, 3.35e12)
    b = roofline_mbps(1000, 500, 50, 3.35e12)
    assert abs(a / b - 2.0) < 1e-9
    # the flagship bound quoted in PERF.md: ~1.19 Gbit/s at 3.35 TB/s
    assert 1150 < roofline_mbps(227160, 32400, 25, 3.35e12) < 1230
    c = matmul_roofline_mbps(1008, 504, 6, 504, 25, 989e12)
    assert abs(c / matmul_roofline_mbps(1008, 504, 6, 504, 50, 989e12)
               - 2.0) < 1e-9


@pytest.mark.parametrize("kind,hbm,flops", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, 989e12),
    ("NVIDIA H100 PCIe", 2.0e12, 756e12),
])
def test_peak_table_known_gpus(kind, hbm, flops):
    p = device_peaks(SimpleNamespace(platform="gpu", device_kind=kind))
    assert (p.hbm_bytes_per_s, p.bf16_flops) == (hbm, flops)
    assert "data sheet" in p.source and p is PEAKS[kind]


def test_peak_table_unknown_gpu_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(SimpleNamespace(platform="gpu",
                                     device_kind="NVIDIA Imaginary GPU"))


def test_peak_table_cpu_is_none():
    assert device_peaks(SimpleNamespace(platform="cpu", device_kind="cpu")) \
        is None


def test_scaling_smoke():
    rows = run_scaling(
        code="gallager/48/3/6/s5", decoder="minsum/5/noet",
        batch_per_device=16, device_counts=[1, 2], tries=1,
    )
    assert rows[0]["devices"] == 1 and rows[0]["efficiency"] == 1.0
    assert rows[1]["devices"] == 2 and rows[1]["mbps"] > 0


def test_pipeline_bench_smoke():
    from ecc_ldpc_tpu.bench.pipeline import run_pipeline_benchmark

    r = run_pipeline_benchmark(
        code="80211n/648/12", decoder="layered/norm:0.8125/5/noet",
        batch=32, tries=1,
    )
    assert r.encode_mbps > 0 and r.pipeline_mbps > 0
    assert 0.0 <= r.decode_share <= 1.0


def test_ab_compare_smoke():
    from ecc_ldpc_tpu.bench.ab import ab_compare

    r = ab_compare(
        [("80211n/648/12", "layered/norm:0.8125/5/noet"),
         ("80211n/648/12", "layered/norm:0.8125/10/noet")],
        batch=32, chain=2, reps=2,
    )
    assert len(r.mbps) == 2 and all(m > 0 for m in r.mbps)
    assert r.ratios[0] == 1.0 and r.ratios[1] > 0
