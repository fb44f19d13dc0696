"""On-device tail-regression validation (VERDICT r2 item 6).

Both round-1 early-termination bugs lived at FER <= 1e-3 — invisible to
the CPU golden gate, whose budget resolves only the top of the waterfall.
This script re-measures ON DEVICE:

  1. every golden point the CPU gate can NOT see (golden FER < 2e-2,
     down to what ~65k frames resolves), for each family in the gate;
  2. the deep-tail scan points (curves/dvbs2_64800_12_deep_tpu.json,
     layered 50-iter, FER down to ~1e-4);

and CI-compares against the stored curves: FER must overlap Wilson CIs
(pointwise), BER must overlap or sit within a 2x band (the stored BER CI
is binomial-over-bits and ignores frame clustering; see
tests/ber/test_golden_gate.py). Writes a JSON report and exits nonzero
on any divergence. Run before each round snapshot:

  python experiments/validate_tail.py [out.json]
"""
import json
import sys
import time
from pathlib import Path

CURVES = Path(__file__).parents[1] / "curves"

# golden files to tail-validate: (file, re-measure frame budget) — the
# deep-tail scan gets the full golden-sized budget (its points sit at
# FER ~1e-4 and early termination makes deep frames cheap on device)
FILES = [
    ("80211n_1944_12_tpu_golden.json", 65_536),
    ("wimax_2304_12_tpu_golden.json", 65_536),
    ("wimax_2304_56_tpu_golden.json", 65_536),
    ("nr5g_bg1_384_tpu_golden.json", 65_536),
    ("nr5g_bg2_384_tpu_golden.json", 65_536),
    ("dvbs2_16200_12_tpu_golden.json", 65_536),
    ("dvbs2_64800_12_tpu_golden.json", 65_536),
    ("mackay1008_tpu_golden.json", 65_536),
    ("dvbs2_16200_12_apsk16_tpu_golden.json", 65_536),  # APSK16 channel
    ("dvbs2_16200_12_apsk32_tpu_golden.json", 65_536),  # APSK32 channel
    ("8023an_tpu_golden.json", 65_536),  # r4: RS-LDPC family (flooding)
    ("8023an_layered_tpu_golden.json", 65_536),  # r5: xor-QC layered tier
    ("dvbs2_64800_12_deep_tpu.json", 131_072),  # 50-iter deep-tail scan
]


def main() -> int:
    out_path = sys.argv[1] if len(sys.argv) > 1 else "VALIDATION.json"
    only = sys.argv[2] if len(sys.argv) > 2 else None  # substring filter
    from ecc_ldpc_tpu.compile_cache import enable_compile_cache
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec, curves_overlap, run_sweep
    from ecc_ldpc_tpu.sim.runner import PointResult

    enable_compile_cache()

    report = {"files": {}, "ok": True}
    for fname, max_frames in FILES:
        if only and only not in fname:
            continue
        golden = [PointResult.from_json(d)
                  for d in json.loads((CURVES / fname).read_text())]
        # the CPU gate covers the first 2 points with FER >= 2e-2; the
        # device budget takes everything it can resolve BELOW that
        # (>= ~15 expected errors in max_frames), plus one overlapping
        # point as a cross-check
        min_resolvable = 15 / max_frames
        tail = [r for r in golden if min_resolvable <= r.fer < 2e-2]
        anchor = [r for r in golden if r.fer >= 2e-2][-1:]
        pts = anchor + tail
        if not pts:
            report["files"][fname] = {"skipped": "no resolvable points"}
            continue
        code, decoder = pts[0].code, pts[0].decoder
        t0 = time.time()
        res = run_sweep(SweepSpec(
            code=code, decoder=decoder,
            ebn0_db=tuple(r.ebn0_db for r in pts),
            channel=getattr(pts[0], "channel", "bpsk"),
            batch=1024, seed=909,
            stopping=StoppingRule(min_frame_errors=100,
                                  max_frames=max_frames),
        ))
        fer_ok = curves_overlap(res, pts, metric="fer")
        ber_ok = curves_overlap(res, pts, metric="ber") or all(
            0.5 <= (m.ber / r.ber) <= 2.0
            for m, r in zip(res, pts) if r.ber > 0 and m.ber > 0
        )
        entry = {
            "code": code, "decoder": decoder,
            "points": [
                {
                    "ebn0_db": r.ebn0_db,
                    "golden_fer": r.fer, "got_fer": m.fer,
                    "golden_fer_ci": list(r.fer_ci),
                    "got_fer_ci": list(m.fer_ci),
                    "golden_ber": r.ber, "got_ber": m.ber,
                    "frames": m.frames,
                }
                for m, r in zip(res, pts)
            ],
            "fer_ok": bool(fer_ok), "ber_ok": bool(ber_ok),
            "wall_s": round(time.time() - t0, 1),
        }
        report["files"][fname] = entry
        report["ok"] &= bool(fer_ok and ber_ok)
        status = "ok" if fer_ok and ber_ok else "DIVERGED"
        print(f"{fname}: {len(pts)} pts, {entry['wall_s']}s -> {status}",
              flush=True)
    Path(out_path).write_text(json.dumps(report, indent=1))
    print(f"report -> {out_path}; ok={report['ok']}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
