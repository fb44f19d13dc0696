"""Density-evolution threshold tests (codes/threshold.py).

Anchored on published DE thresholds: (3,6)-regular ~1.11 dB (GA-DE reads
a few hundredths high), 802.11n R=1/2 ~0.62 dB. Family-level checks pin
monotonicity in rate and the theory-vs-simulation ordering (measured
waterfalls sit above the asymptotic threshold).
"""
import numpy as np
import pytest

from ecc_ldpc_tpu.codes import get_code
from ecc_ldpc_tpu.codes.threshold import (
    de_converges,
    de_threshold_ebn0,
    phi,
    phi_inv,
    protograph,
)


def test_phi_properties():
    x = np.asarray([1e-6, 0.1, 1.0, 5.0, 14.0, 14.8, 50.0, 300.0])
    y = phi(x)
    assert np.all(np.diff(y) < 0)  # strictly decreasing across the seam
    assert np.all((y > 0) & (y <= 1))
    assert phi(np.asarray([0.0]))[0] == 1.0
    # inverse round-trip across both branches (Chung's fit saturates to 1
    # below x ~ 0.03, so the inverse is only meaningful above that)
    np.testing.assert_allclose(phi_inv(y[1:]), x[1:], rtol=2e-3)


def test_regular_36_threshold_anchor():
    """(3,6)-regular ensemble: exact DE gives ~1.11 dB; GA-DE is known to
    read within a few hundredths. Pin a tight band around it."""
    th = de_threshold_ebn0(get_code("mackay1008"))
    assert 1.05 < th < 1.25


def test_80211n_half_rate_anchor():
    """802.11n R=1/2 protograph threshold is published at ~0.62 dB."""
    th = de_threshold_ebn0(get_code("80211n/1944/12"))
    assert 0.45 < th < 0.80


def test_thresholds_monotonic_in_rate():
    ths = [de_threshold_ebn0(get_code(f"80211n/1944/{r}"))
           for r in ("12", "23", "34", "56")]
    assert all(a < b for a, b in zip(ths, ths[1:]))


def test_dvbs2_family_sane():
    th12 = de_threshold_ebn0(get_code("dvbs2/64800/12"))
    th34 = de_threshold_ebn0(get_code("dvbs2/64800/34"))
    assert 0.4 < th12 < 1.1  # real standard: ~0.8 dB
    assert th12 < th34 < 2.5
    # the measured golden waterfall must sit ABOVE the asymptotic
    # threshold (finite length costs SNR, never gains)
    import json, pathlib

    curve = json.loads(
        (pathlib.Path(__file__).parents[2]
         / "curves/dvbs2_64800_12_tpu_golden.json").read_text()
    )
    points = curve["points"] if isinstance(curve, dict) else curve
    decoded = [p["ebn0_db"] for p in points if p.get("fer", 1.0) < 1e-2]
    assert decoded and min(decoded) > th12


def test_punctured_nr_converges():
    """5G NR's 2Zc systematic puncture: DE must still converge (punctured
    protograph columns carry zero channel mean) at base-graph rates."""
    th1 = de_threshold_ebn0(get_code("nr5g/bg1/384"))
    th2 = de_threshold_ebn0(get_code("nr5g/bg2/384"))
    assert -1.0 < th2 < th1 < 1.0  # lower-rate BG2 sits below BG1


def test_de_converges_fixed_point_detection():
    """Well below threshold DE must stop early at a finite fixed point,
    far faster than the iteration cap."""
    g = protograph(get_code("mackay1008"))
    assert not de_converges(g, 0.2, 0.5, max_iters=2000)
    assert de_converges(g, 3.0, 0.5)


def test_bec_threshold_exact_anchor():
    """(3,6) regular over the BEC: the exact BP threshold is the known
    constant ~0.42944 — no Gaussian approximation involved, so the band
    is tight."""
    from ecc_ldpc_tpu.codes.threshold import bec_threshold

    eps = bec_threshold(get_code("mackay1008"))
    assert abs(eps - 0.42944) < 2e-3


def test_bec_thresholds_below_capacity():
    from ecc_ldpc_tpu.codes.threshold import bec_threshold

    for name in ("80211n/1944/12", "nr5g/bg2/384"):
        spec = get_code(name)
        eps = bec_threshold(spec)
        cap = 1.0 - spec.rate
        assert 0.5 * cap < eps < cap  # decodes well but below capacity
