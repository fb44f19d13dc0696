"""Per-family decoded-throughput sweep: every shipped code family through
its default decode path (SURVEY.md §2.2 C24 breadth companion to the
flagship bench.py number).

Run on the GPU:
  python -m ecc_ldpc_tpu.bench.families

Prints one JSON line per config and a markdown summary table; optionally
writes the JSON rows to a file with --out. The decoder column is the
25-iteration fixed-count normalized min-sum of the primary metric
(BASELINE.json:2); layered schedule for QC families, flooding for the
unstructured MacKay code.
"""
from __future__ import annotations

import argparse
import json
import sys

from .throughput import run_benchmark

# (code, decoder, batch, ebn0_db) — ebn0 chosen near each family's
# operating point so decoded frames are realistic noisy frames.
DEFAULT_CONFIGS = [
    ("mackay1008", "minsum/norm:0.8125/25/noet", 2048, 2.5),
    # xor-perm QC structure (r5): layered static-perm tier, like the
    # other standards families — replaced the incidence-matmul route
    # whose n*edges cost model was 12x mackay's per bit (97 Mbit/s)
    ("8023an", "layered/norm:0.8125/25/noet", 2048, 4.0),
    ("80211n/648/12", "layered/norm:0.8125/25/noet", 2048, 2.5),
    ("80211n/1296/12", "layered/norm:0.8125/25/noet", 2048, 2.2),
    ("80211n/1944/12", "layered/norm:0.8125/25/noet", 2048, 2.0),
    ("80211n/1944/56", "layered/norm:0.8125/25/noet", 2048, 4.0),
    ("wimax/576/12", "layered/norm:0.8125/25/noet", 2048, 2.5),
    ("wimax/2304/56", "layered/norm:0.8125/25/noet", 1024, 4.0),
    ("dvbs2/16200/12", "layered/norm:0.8125/25/noet", 1024, 1.5),
    ("dvbs2/64800/12", "layered/norm:0.8125/25/noet", 1024, 1.5),
    ("dvbs2/64800/34", "layered/norm:0.8125/25/noet", 1024, 3.0),
    ("nr5g/bg1/384", "layered/norm:0.8125/25/noet", 512, 2.0),
    ("nr5g/bg2/384", "layered/norm:0.8125/25/noet", 512, 2.5),
    # rate-matched (n_tx) specs: inert extension rows truncated, decode
    # work scales with the transmitted length (codes/nr5g.py)
    ("nr5g/bg1/384/8448/12672", "layered/norm:0.8125/25/noet", 1024, 3.0),
    ("nr5g/bg2/384/3840/7680", "layered/norm:0.8125/25/noet", 1024, 2.5),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", help="write JSON rows to this file")
    ap.add_argument("--only", help="substring filter on code names")
    args = ap.parse_args(argv)

    from ..compile_cache import enable_compile_cache

    enable_compile_cache()
    rows, failed = [], []
    for code, decoder, batch, ebn0 in DEFAULT_CONFIGS:
        if args.only and args.only not in code:
            continue
        try:
            r = run_benchmark(code=code, decoder=decoder, batch=batch,
                              ebn0_db=ebn0)
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            print(f"# {code}: FAILED {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            failed.append(code)
            continue
        print(r.json_line(), flush=True)
        rows.append(r)

    print("\n| code | n | k | Mbit/s/chip | ms/frame-batch | batch |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r.code} | {r.n} | {r.k} | {r.throughput_mbps:.0f} "
              f"| {r.wall_s_per_batch*1e3:.1f} | {r.batch} |")

    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(r.json_line() + "\n")
    return 1 if failed or not rows else 0


if __name__ == "__main__":
    sys.exit(main())
