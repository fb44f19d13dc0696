"""Regenerate deep per-family golden curves on the device (VERDICT r1
item 4): >= 16384 frames at EVERY point (vs the old 256-frame points
whose CIs were too wide to catch a 1.5x FER regression), up to 400 frame
errors per point for ~10% CI half-width in the waterfall.

Also regenerates the 802.11n/WiMAX goldens for the RECALLED standard
tables (the r1 curves were measured on surrogate tables — different
codes).

Run: python experiments/gen_goldens.py [out_dir]
"""
import sys
import time

CONFIGS = [
    # (out_name, code, decoder, ebn0 grid[, channel]) — grids put >= 2
    # points in FER [2e-2, 0.9] (the gate's usable band) and stop before
    # the deep-zero region so no 131k-frame point buys zero regression
    # power (VERDICT r2 weak item 7)
    ("80211n_1944_12_tpu_golden", "80211n/1944/12",
     "layered/norm:0.8125/25", (1.0, 1.25, 1.5, 1.75, 2.0)),
    ("wimax_2304_12_tpu_golden", "wimax/2304/12",
     "layered/norm:0.8125/25", (1.0, 1.25, 1.5, 1.75, 2.0)),
    # rate 5/6: covers the round-3 recalled high-rate tables (r2 item 1)
    ("wimax_2304_56_tpu_golden", "wimax/2304/56",
     "layered/norm:0.8125/25", (3.0, 3.25, 3.5, 3.75)),
    # NR grids re-centered per recall round: BG2 connectivity r3; BG1
    # extension rows r4 (waterfall moved 0.6 -> ~1.0 dB at layered-25 —
    # the recalled graph's heavier extension rows converge slower at a
    # fixed 25 iterations; measured in experiments/probe_r4.py runs)
    ("nr5g_bg1_384_tpu_golden", "nr5g/bg1/384",
     "layered/norm:0.8125/25", (0.8, 0.9, 1.0, 1.1, 1.2)),
    ("nr5g_bg2_384_tpu_golden", "nr5g/bg2/384",
     "layered/norm:0.8125/25", (0.3, 0.45, 0.6, 0.75, 0.9)),
    ("dvbs2_16200_12_tpu_golden", "dvbs2/16200/12",
     "layered/norm:0.8125/25", (0.8, 1.0, 1.2, 1.4, 1.6)),
    # the flagship itself under the gate (VERDICT r2 item 2)
    ("dvbs2_64800_12_tpu_golden", "dvbs2/64800/12",
     "layered/norm:0.8125/25", (0.95, 1.0, 1.05, 1.1, 1.2)),
    ("mackay1008_tpu_golden", "mackay1008",
     "spa/50", (1.0, 1.5, 2.0, 2.5)),
    # r4: 802.3an flooding min-sum (r5 route: XLA xor roll-form flooding
    # — same algorithm the old xla-mm incidence tier ran, new addressing)
    ("8023an_tpu_golden", "8023an",
     "minsum/norm:0.8125/25", (3.2, 3.4, 3.6, 3.8, 4.0)),
    # r5: 802.3an PRODUCTION path — layered on the xor-perm QC tier
    # (layered-25 converges like flooding-50, so the grid sits ~0.2 dB
    # left of the flooding one)
    ("8023an_layered_tpu_golden", "8023an",
     "layered/norm:0.8125/25", (3.0, 3.2, 3.4, 3.6, 3.8)),
    # APSK channels on the short DVB-S2 frame. The 16APSK grid is for the
    # STANDARD EN 302 307 mapping (recalled r4) — ~0.4 dB right of the old
    # quasi-Gray surrogate on this code: the two mappings are
    # GMI-identical, but their per-bit reliability PERMUTATION lands
    # strong/weak LLRs on different interleaver columns (see chan/modem).
    ("dvbs2_16200_12_apsk16_tpu_golden", "dvbs2/16200/12",
     "layered/norm:0.8125/25", (3.4, 3.6, 3.8, 4.0, 4.2), "apsk16:r56:il"),
    # 32APSK incl. the >=131k-frame 6.8 dB point that settles the r3
    # floor-vs-rolloff question (VERDICT r3 item 3)
    ("dvbs2_16200_12_apsk32_tpu_golden", "dvbs2/16200/12",
     "layered/norm:0.8125/25", (5.2, 5.6, 6.0, 6.4, 6.8), "apsk32:r34:il"),
]


def main() -> int:
    args = [a for a in sys.argv[1:]]
    out_dir = "curves"
    if args and not any(args[0] == c[0] for c in CONFIGS):
        out_dir = args.pop(0)
    only = set(args)  # config names; empty = all
    from ecc_ldpc_tpu.compile_cache import enable_compile_cache
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec, run_sweep
    from ecc_ldpc_tpu.sim.report import format_table, save_results

    enable_compile_cache()

    stopping = StoppingRule(
        min_frame_errors=400, max_frames=131_072, min_frames=16_384
    )
    for cfg in CONFIGS:
        name, code, decoder, grid = cfg[:4]
        channel = cfg[4] if len(cfg) > 4 else "bpsk"
        if only and name not in only:
            continue
        t0 = time.time()
        res = run_sweep(SweepSpec(
            code=code, decoder=decoder, ebn0_db=grid, batch=1024,
            seed=20260819, stopping=stopping, channel=channel,
        ))
        path = f"{out_dir}/{name}.json"
        save_results(res, path)
        print(f"{code}: {time.time()-t0:.0f}s -> {path}", flush=True)
        print(format_table(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
