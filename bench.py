"""Round benchmark: prints ONE JSON line with decoded throughput.

Primary metric (BASELINE.json:2): decoded Mbit/s per device, min-sum, 25
iterations. The headline is DVB-S2 n=64800 RATE-1/2 at fixed 25-iteration
layered min-sum, batch 4096 — the hardest info-bits-per-edge configuration
of the flagship code. The same line carries `r34_mbps` (rate 3/4, a
standard broadcast operating point) and `prod_r12_mbps` (early termination
+ the shipped learned schedule at the 2.5 dB operating point), and `legs`
with each leg's compile seconds and warm step time. `device` names the
platform, device_kind and device count as JAX reports them and, on a GPU,
the card's name and power limit.

Every leg must run: a failing leg raises, and the script exits non-zero
without printing the line.

  python bench.py
"""
from __future__ import annotations

import json
import sys

# (code, decoder, batch, ebn0_db) of the headline, r34 and production legs
LEGS = (
    ("dvbs2/64800/12", "layered/norm:0.8125/25/noet", 4096, 1.5),
    ("dvbs2/64800/34", "layered/norm:0.8125/25/noet", 2048, 3.0),
    ("dvbs2/64800/12", "layered/sched:dvbs2_64800_12_T25_op2", 2048, 2.5),
)


def main() -> int:
    from ecc_ldpc_tpu.bench.throughput import run_benchmark
    from ecc_ldpc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    head, r34, prod = (
        run_benchmark(code=c, decoder=d, batch=b, ebn0_db=e)
        for c, d, b, e in LEGS
    )
    line = json.loads(head.json_line())
    line["r34_mbps"] = round(r34.throughput_mbps, 3)
    line["prod_r12_mbps"] = round(prod.throughput_mbps, 3)
    line["legs"] = [
        {"code": r.code, "decoder": r.decoder, "batch": r.batch,
         "mbps": r.throughput_mbps, "compile_s": r.compile_s,
         "wall_s_per_batch": r.wall_s_per_batch, "mean_iters": r.mean_iters}
        for r in (head, r34, prod)
    ]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
