"""Degenerate-graph coverage for the layered tier: multi-edge (intra-layer
duplicate column) protographs must take the accumulate ("classic") path,
and degree-1 block-rows the capped magnitude branch without producing
NaN/inf — both checked against the plain-numpy reference.

These graphs are NOT producible from a QCCode base matrix (one shift per
cell), so they are built directly via graph.qc_graph_from_block_edges.
"""
import jax
import numpy as np
import pytest

import ref_decoders as ref
from ecc_ldpc_tpu.decode.xla.layered import make_layered_decoder
from ecc_ldpc_tpu.graph import qc_graph_from_block_edges


def _rand_llr(B, n, seed=0, scale=2.0):
    key = jax.random.key(seed)
    return scale * jax.random.normal(key, (B, n), jax.numpy.float32)


def assert_same(res, want):
    for got, w in zip((res.bits, res.ok, res.iterations), want):
        np.testing.assert_array_equal(np.asarray(got), w)


@pytest.fixture(scope="module")
def dup_graph():
    """Z=16, 3 block-rows x 6 block-cols; row 0 touches column 1 twice
    (parallel edges with different shifts) -> intra_layer_dup_free False."""
    br = [0, 0, 0, 0, 1, 1, 1, 2, 2, 2]
    bc = [0, 1, 1, 2, 1, 3, 4, 2, 4, 5]
    sh = [3, 5, 9, 0, 7, 2, 11, 1, 6, 4]
    g = qc_graph_from_block_edges(16, 3, 6, br, bc, sh, k=3 * 16, name="dup")
    assert not g.intra_layer_dup_free
    return g


@pytest.fixture(scope="module")
def deg1_graph():
    """Z=16 graph with a degree-1 block-row (row 2) -> min2 is +inf at that
    check, so the magnitude must come from the capped branch."""
    br = [0, 0, 0, 1, 1, 1, 2]
    bc = [0, 1, 2, 1, 3, 4, 5]
    sh = [3, 5, 0, 7, 2, 11, 9]
    g = qc_graph_from_block_edges(16, 3, 6, br, bc, sh, k=3 * 16, name="deg1")
    assert g.intra_layer_dup_free
    assert min(len(g.layer_edges(i)) for i in range(g.mb)) == 1
    return g


@pytest.mark.parametrize("early_term", [True, False])
def test_dup_graph_matches_reference(dup_graph, early_term):
    llr = _rand_llr(32, dup_graph.n, seed=4)
    a = make_layered_decoder(dup_graph, alpha=0.8125, max_iters=8,
                             early_term=early_term)(llr)
    assert_same(a, ref.layered_qc(dup_graph, np.asarray(llr), alpha=0.8125,
                                  max_iters=8, early_term=early_term))


def test_dup_graph_bitxor_degrades_identically(dup_graph):
    """sign_mode='bitxor' silently degrades to 'count' on dup graphs, so
    explicit 'bitxor' and 'count' requests give identical bits."""
    llr = _rand_llr(32, dup_graph.n, seed=8)
    a = make_layered_decoder(dup_graph, alpha=0.8125, max_iters=8,
                             sign_mode="bitxor")(llr)
    b = make_layered_decoder(dup_graph, alpha=0.8125, max_iters=8,
                             sign_mode="count")(llr)
    assert np.array_equal(np.asarray(a.bits), np.asarray(b.bits))
    assert_same(a, ref.layered_qc(dup_graph, np.asarray(llr), alpha=0.8125,
                                  max_iters=8, sign_mode="count"))


@pytest.mark.parametrize("early_term", [True, False])
def test_deg1_graph_matches_reference(deg1_graph, early_term):
    """alpha-scaled offset-free min-sum on a degree-1-row graph: the
    magnitude at the lone edge is cap(min2)=cap(inf); an uncapped inf*alpha
    would corrupt the posteriors (visible as NaN or bit divergence)."""
    llr = _rand_llr(32, deg1_graph.n, seed=6)
    a = make_layered_decoder(deg1_graph, alpha=0.8125, max_iters=8,
                             early_term=early_term)(llr)
    assert_same(a, ref.layered_qc(deg1_graph, np.asarray(llr), alpha=0.8125,
                                  max_iters=8, early_term=early_term))
