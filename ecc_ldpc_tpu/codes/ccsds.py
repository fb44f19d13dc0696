"""CCSDS 131.0-B AR4JA LDPC codes (deep-space telemetry standard).

Beyond the five contract families (SURVEY.md §CONTRACT): the CCSDS
deep-space codes — rates 1/2, 2/3, 4/5 at information block lengths
k ∈ {1024, 4096, 16384} (nine configurations).

Structure — exact, per the published AR4JA protograph family
(accumulate-repeat-4-jagged-accumulate; Divsalar/Dolinar/Jones, adopted
by CCSDS 131.0-B): 3 check types and 5 + 2j variable types for
j ∈ {0, 1, 3} extension column pairs:

              v0  v1  v2  v3 | pairs (x2 per rate step) | vP
    check 0 [  .   .   1   . |  .   .                   |  2 ]
    check 1 [  1   1   .   1 |  3   1                   |  3 ]
    check 2 [  1   2   .   2 |  1   3                   |  1 ]

(entries = parallel-edge multiplicities; v2 is the degree-1 node, vP the
degree-6 jagged-accumulator state). The lifting size is M = k/(2(1+j));
n = (5+2j)M of which the last M columns (vP) are NEVER TRANSMITTED →
rate (1+j)/(2+j) over n_tx = (4+2j)M bits. H is full rank (3M), so
k = n - rank as required; rank is pinned by tests at small M.

SURROGATE LABEL (SURVEY.md §7.2 item 4): the standard lifts this
protograph with specific theta_k/phi_k(j, M) permutations that are NOT
circulants and cannot be reproduced from memory. The lifting here is
circulant, machine-optimized to zero lifted 4-cycles per (rate, M)
(codes/girth.optimize_edge_shifts, deterministic from `seed`).
Protograph, multiplicities, rates, puncturing, and block sizes match the
standard exactly; only the permutation choice is surrogate.

The multi-edge cells mean the QC structure is a QCMultiCode; the roll
decode tiers (flooding minsum/spa/minstar and both layered tiers via
their 2-roll accumulate paths) serve it unchanged. Encoding uses the
dense systematic generator (no dual-diagonal/staircase skeleton); all
nine configurations including k=16384 encode — the 24576x40960 r=1/2
generator takes a one-time ~260 s GF(2) elimination + G.H^T=0 check on
the host and is then content-addressed-cached under
~/.cache/ecc_ldpc_tpu/ (encode/dense.py DenseEncoder.build).

Spec strings: ccsds/<k>/<rate>[/s<seed>] — e.g. ccsds/1024/12,
ccsds/4096/45. Punctured-node LLRs are zeroed by chan.make_channel like
5G NR's 2Zc puncture.
"""
from __future__ import annotations

import numpy as np

from .girth import edge_4cycle_count, optimize_edge_shifts
from .qc import QCMultiCode, expand_qc_multi
from .spec import CodeSpec

_RATE_J = {"12": 0, "23": 1, "45": 3}
_STANDARD_K = (1024, 4096, 16384)


def ar4ja_edges(j: int):
    """(block_row, block_col) edge list with multiplicity for j ext pairs.

    Column order: v0..v3, then the j extension pairs, then vP (punctured)
    last — so punctured_cols is always the final lifted block.
    """
    edges = []

    def add(r, c, mult=1):
        edges.extend([(r, c)] * mult)

    add(1, 0), add(2, 0)
    add(1, 1), add(2, 1, 2)
    add(0, 2)
    add(1, 3), add(2, 3, 2)
    for p in range(j):
        a, b = 4 + 2 * p, 5 + 2 * p
        add(1, a, 3), add(2, a, 1)
        add(1, b, 1), add(2, b, 3)
    vp = 4 + 2 * j
    add(0, vp, 2), add(1, vp, 3), add(2, vp, 1)
    br = np.asarray([e[0] for e in edges], np.int32)
    bc = np.asarray([e[1] for e in edges], np.int32)
    return br, bc


def ar4ja(k: int | None = None, rate: str = "12", *, M: int | None = None,
          seed: int = 0) -> CodeSpec:
    """Build an AR4JA CodeSpec from (k, rate) or an explicit lifting M."""
    if rate not in _RATE_J:
        raise ValueError(f"AR4JA rate must be one of {sorted(_RATE_J)}, got {rate!r}")
    j = _RATE_J[rate]
    if M is None:
        if k is None:
            raise ValueError("give k or M")
        M, rem = divmod(int(k), 2 * (1 + j))
        if rem:
            raise ValueError(f"k={k} not divisible by 2(1+j)={2 * (1 + j)}")
        if k not in _STANDARD_K:
            # the construction works at any lifting, but CCSDS 131.0-B only
            # defines k in _STANDARD_K — warn so e.g. ccsds/2048/12 is not
            # mistaken for a standard configuration (explicit M= callers
            # are research/test use and stay silent)
            import warnings

            warnings.warn(
                f"k={k} is not a CCSDS 131.0-B block length {_STANDARD_K}; "
                "building a non-standard AR4JA code with the same protograph",
                stacklevel=2,
            )
    M = int(M)
    k = 2 * (1 + j) * M
    if M < 8:
        # smaller liftings leave the shift optimizer too little room for
        # the multi-edge cells; the standard's M are powers of two >= 128
        raise ValueError(f"lifting M={M} must be at least 8")
    br, bc = ar4ja_edges(j)
    sh = optimize_edge_shifts(br, bc, M, seed=seed)
    # zero lifted 4-cycles from M=32 up (measured; every standard M is
    # >= 128). Tiny-M residuals are pigeonhole-unavoidable at rate 4/5
    # (two 18-edge check rows over Z=16), as in 5G NR's smallest liftings.
    if M >= 32:
        residual = int(edge_4cycle_count(br, bc, sh, M))
        if residual:
            # survives `python -O` (a bare assert would not); a user seed
            # that leaves the optimizer stuck must fail loudly, not build
            # a short-cycle-ridden code under the ccsds/ name
            raise ValueError(
                f"AR4JA shift optimizer left {residual} lifted 4-cycles at "
                f"M={M}, seed={seed}; pick another /s<seed>"
            )
    nb = 5 + 2 * j
    qcm = QCMultiCode(Z=M, mb=3, nb=nb, br=br, bc=bc, sh=sh)
    name = f"ccsds/{k}/{rate}" + (f"/s{seed}" if seed else "")
    return expand_qc_multi(
        qcm, name=name, k=k,
        punctured_cols=tuple(range((nb - 1) * M, nb * M)),
    )
