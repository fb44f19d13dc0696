"""Golden-curve regression gate (VERDICT r1 item 4): re-measure each
family at its deep golden points and require the golden-gate rule of
sim/report.golden_gate — the reference's overlapping-BER-curves
validation as an automated test (SURVEY.md §1.1, sim/report.curves_overlap).

The goldens (curves/*_golden.json) carry >= 16384 frames per point (up
to 400 frame errors), so their CIs are tight enough that a ~1.5x FER
regression at a waterfall point fails the gate. The re-measure arm runs
on CPU in the slow tier with a smaller budget — its wider CI is what the
overlap test correctly accounts for. Points whose golden FER is below
what the CPU budget can resolve (few expected errors) are skipped by
the min-FER filter, not silently compared against nothing.
"""
import json
from pathlib import Path

import pytest

from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec, run_sweep
from ecc_ldpc_tpu.sim.report import GOLDEN_MIN_FER, golden_gate
from ecc_ldpc_tpu.sim.runner import PointResult

pytestmark = pytest.mark.slow

_CURVES = Path(__file__).parents[2] / "curves"

# re-measure the waterfall points the CPU budget can resolve: golden
# FER >= GOLDEN_MIN_FER
_GOLDENS = [
    "80211n_1944_12_tpu_golden.json",
    "wimax_2304_12_tpu_golden.json",
    "wimax_2304_56_tpu_golden.json",     # r3: recalled high-rate tables
    "nr5g_bg1_384_tpu_golden.json",
    "nr5g_bg2_384_tpu_golden.json",
    "dvbs2_16200_12_tpu_golden.json",
    "dvbs2_64800_12_tpu_golden.json",    # r3: the flagship itself
    "mackay1008_tpu_golden.json",        # r3: config-1 class, spa/50
    # r4: the APSK modem layer under the gate (16APSK standard mapping,
    # 32APSK surrogate — PointResult carries the channel spec)
    "dvbs2_16200_12_apsk16_tpu_golden.json",
    "dvbs2_16200_12_apsk32_tpu_golden.json",
    "8023an_tpu_golden.json",            # r4: RS-LDPC family (flooding)
    "8023an_layered_tpu_golden.json",    # r5: xor-QC layered production path
]
_MAX_POINTS = 2      # the two lowest-SNR resolvable points per family


def _load(path: Path):
    return [PointResult.from_json(d) for d in json.loads(path.read_text())]


@pytest.mark.parametrize("fname", _GOLDENS)
def test_family_matches_golden(fname):
    path = _CURVES / fname
    if not path.exists():
        pytest.skip(f"{fname}: golden not generated yet (gen_goldens.py)")
    golden = _load(path)
    pts = [r for r in golden if r.fer >= GOLDEN_MIN_FER][:_MAX_POINTS]
    if not pts:
        pytest.skip(f"{fname}: no point with FER >= {GOLDEN_MIN_FER}")
    code, decoder = pts[0].code, pts[0].decoder
    res = run_sweep(SweepSpec(
        code=code, decoder=decoder, channel=pts[0].channel or "bpsk",
        ebn0_db=tuple(r.ebn0_db for r in pts),
        batch=512, seed=77,
        stopping=StoppingRule(min_frame_errors=80, max_frames=4096),
    ))
    passed, report = golden_gate(res, pts)
    assert passed, f"{code} diverged from golden: {report}"
