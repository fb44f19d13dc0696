"""WiMAX table-recall validation census (VERDICT r2 item 1).

Per rate table, prints the evidence the recall claim rests on:
  - structural skeleton: special parity column (paired first/last entries,
    one middle entry) + shift-0 staircase;
  - row-degree and info-column-degree profiles (compared to the published
    802.16e profiles);
  - lifted 4-cycle census at the definition Z0=96 and at every standard-
    scaled Z in 24..96 step 4 (floor rule; 2/3A uses mod);
  - chain conflicts (equal shifts in one column at nearby rows — closes a
    short bit-level cycle through the shift-0 staircase);
  - G·H^T = 0 through the structured encoder at min/mid/max n.

Run (from the repository root): PYTHONPATH=. python experiments/wimax_census.py
"""
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import importlib

# the package re-exports the wimax() function under the submodule's name,
# so a plain `import ... as wx` would bind the function
wx = importlib.import_module("ecc_ldpc_tpu.codes.wimax")
from ecc_ldpc_tpu.codes.girth import block_4cycle_violations, chain_conflicts
from ecc_ldpc_tpu.encode.structured import DualDiagonalEncoder

# published structural profiles (802.16e-2005 §8.4.9.2.5)
EXPECTED = {
    "12": dict(rows={6, 7}, info_cols={3, 6}),
    "23A": dict(rows={10}, info_cols={3, 6}),
    "23B": dict(rows={10, 11}, info_cols={4}),
    "34A": dict(rows={14, 15}, info_cols={4}),
    "34B": dict(rows={14, 15}, info_cols={3, 6}),
    "56": dict(rows={20}, info_cols={3, 4}),
}


def census(rate: str) -> bool:
    mb, _, rule = wx.RATES[rate]
    base, provenance = wx._base_table(rate)
    kb = wx.BLOCK_COLS - mb
    ok = True

    # skeleton
    pcol = base[:, kb]
    rows = np.flatnonzero(pcol >= 0)
    skel = (
        len(rows) == 3 and rows[0] == 0 and rows[-1] == mb - 1
        and pcol[rows[0]] == pcol[rows[-1]]
    )
    stair = all(
        list(np.flatnonzero(base[:, kb + 1 + d] >= 0)) == [d, d + 1]
        and base[d, kb + 1 + d] == 0 and base[d + 1, kb + 1 + d] == 0
        for d in range(mb - 1)
    )
    special = tuple(int(pcol[r]) for r in rows) if len(rows) == 3 else None
    ok &= skel and stair

    # degree profiles
    row_deg = sorted(set(int(x) for x in (base >= 0).sum(axis=1)))
    col_deg = sorted(set(int(x) for x in (base[:, :kb] >= 0).sum(axis=0)))
    exp = EXPECTED[rate]
    deg_ok = set(row_deg) <= exp["rows"] and set(col_deg) <= exp["info_cols"]
    ok &= deg_ok

    # girth census across the standard scaling sweep
    viol_by_z = {}
    for Z in range(24, 97, 4):
        scaled = wx._scale(base, Z, rule)
        viol_by_z[Z] = len(block_4cycle_violations(scaled, Z))
    chains = len(chain_conflicts(wx._scale(base, 96, rule), kb, 8))

    # encoder self-check (G·H^T = 0) at three sizes
    enc_ok = True
    for n in (576, 1344, 2304):
        try:
            DualDiagonalEncoder(wx.wimax(n, rate), validate=True)
        except Exception as e:  # noqa: BLE001
            enc_ok = False
            print(f"  ENCODER FAIL n={n}: {e}")
    ok &= enc_ok

    total4 = sum(viol_by_z.values())
    nz = {z: v for z, v in viol_by_z.items() if v}
    print(f"rate {rate:4s} [{provenance}]  skeleton={'ok' if skel and stair else 'BAD'}"
          f" special={special}  rows={row_deg} cols={col_deg}"
          f" ({'ok' if deg_ok else 'MISMATCH'})")
    print(f"  4-cycles: Z0=96 -> {viol_by_z[96]};  sweep total {total4}"
          f" nonzero={nz if nz else '{}'};  chain conflicts@96: {chains};"
          f"  encoder: {'ok' if enc_ok else 'FAIL'}")
    # the recall claim needs a clean Z0 (standard tables are 4-cycle-free
    # at their definition Z); scaled-Z cycles can be the standard's own
    ok &= viol_by_z[96] == 0
    return ok


if __name__ == "__main__":
    rates = sys.argv[1:] or list(wx.RATES)
    results = {r: census(r) for r in rates}
    print("summary:", results)
    sys.exit(0 if all(results.values()) else 1)
