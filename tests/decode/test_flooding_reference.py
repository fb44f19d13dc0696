"""Flooding tiers against the plain-numpy reference (tests/ref_decoders.py):
the roll-form QC tier (decode/xla/flooding_qc.py) and the gather tier on
expanded graphs (decode/xla/flooding.py), with equal hard decisions, ok
flags and iteration counts on the CPU. The incidence-matmul tier
(decode/xla/dense_mm.py) sums the VN accumulate in another order, so it is
held to the reference's decisions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ref_decoders as ref
from ecc_ldpc_tpu.chan import awgn_llr
from ecc_ldpc_tpu.codes import gallager_36, get_code, mackay_1008
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode, expand_qc
from ecc_ldpc_tpu.decode import make_decoder
from ecc_ldpc_tpu.decode.xla.flooding_qc import decode_flooding_qc
from ecc_ldpc_tpu.encode import DenseEncoder
from ecc_ldpc_tpu.encode.structured import DualDiagonalEncoder
from ecc_ldpc_tpu.graph import compile_graph
from ecc_ldpc_tpu.graph.qc import compile_qc_graph


def assert_same(res, want):
    for got, w in zip((res.bits, res.ok, res.iterations), want):
        np.testing.assert_array_equal(np.asarray(got), w)


@pytest.fixture(scope="module")
def z16():
    base = surrogate_base(mb=4, nb=12, Z=16, seed=99)
    spec = expand_qc(QCCode(Z=16, base=base), name="test.z16f", k=8 * 16)
    return spec, compile_qc_graph(spec), DualDiagonalEncoder(spec)


def _tx(spec, enc, B, ebn0, seed=0):
    key = jax.random.key(seed)
    msg = jax.random.bernoulli(key, 0.5, (B, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    return cw, awgn_llr(jax.random.fold_in(key, 1), cw, ebn0, spec.rate)


@pytest.mark.parametrize("early_term", [True, False])
def test_flooding_qc_matches_reference(z16, early_term):
    spec, qg, enc = z16
    _, llr = _tx(spec, enc, 48, 3.0)
    a = jax.jit(lambda l: decode_flooding_qc(
        qg, l, alpha=0.8125, max_iters=12, early_term=early_term))(llr)
    assert_same(a, ref.flooding_qc(qg, np.asarray(llr), alpha=0.8125,
                                   max_iters=12, early_term=early_term))


def test_flooding_qc_agrees_with_gather_oracle(z16):
    """Same algorithm as the expanded-graph flooding decoder: identical
    decisions on converged frames (sum order differs -> compare ok set)."""
    spec, qg, enc = z16
    _, llr = _tx(spec, enc, 64, 3.0, seed=4)
    a = jax.jit(lambda l: decode_flooding_qc(
        qg, l, alpha=0.8125, max_iters=20))(llr)
    g = compile_graph(spec)
    b = make_decoder(g, "minsum", alpha=0.8125, max_iters=20, backend="xla")(llr)
    ok = np.asarray(a.ok) & np.asarray(b.ok)
    assert ok.mean() > 0.9
    assert np.array_equal(np.asarray(a.bits)[ok], np.asarray(b.bits)[ok])
    # same convergence profile
    assert abs(np.asarray(a.iterations)[ok].mean()
               - np.asarray(b.iterations)[ok].mean()) <= 1.25  # on-the-fly lag


@pytest.fixture(scope="module")
def small():
    spec = gallager_36(96, seed=4)
    return spec, compile_graph(spec), DenseEncoder.build(spec)


@pytest.mark.parametrize("kind,alpha,beta", [
    ("minsum", 1.0, 0.0),
    ("minsum", 0.8125, 0.0),
    ("minsum", 1.0, 0.15),
    ("spa", 1.0, 0.0),
])
def test_gather_tier_matches_reference(small, kind, alpha, beta):
    spec, graph, enc = small
    _, llr = _tx(spec, enc, 32, 2.5)
    want = ref.flooding(graph, np.asarray(llr), kind=kind, alpha=alpha,
                        beta=beta, max_iters=15)
    a = make_decoder(graph, kind, alpha=alpha, beta=beta, max_iters=15)(llr)
    assert_same(a, want)
    b = make_decoder(graph, kind, alpha=alpha, beta=beta, max_iters=15,
                     backend="xla-mm")(llr)
    assert_same(b, want)


def test_fixed_vs_early_term(small):
    spec, graph, enc = small
    _, llr = _tx(spec, enc, 32, 2.5, seed=7)
    a = make_decoder(graph, "minsum", max_iters=15, early_term=True)(llr)
    b = make_decoder(graph, "minsum", max_iters=15, early_term=False)(llr)
    # fixed-iteration mode is PURE (no freeze — benchmark semantics):
    # converged frames keep iterating, which is sign-stable, so bits/ok
    # agree; iterations report the fixed count
    assert np.array_equal(np.asarray(a.bits), np.asarray(b.bits))
    assert np.array_equal(np.asarray(a.ok), np.asarray(b.ok))
    assert np.all(np.asarray(b.iterations) == 15)
    assert_same(b, ref.flooding(graph, np.asarray(llr), max_iters=15,
                                early_term=False))


@pytest.mark.parametrize("B,ebn0,iters,seed", [(77, 3.0, 10, 3),
                                               (256, 2.0, 8, 9)])
def test_batch_shapes_match_reference(small, B, ebn0, iters, seed):
    """A batch of odd size and a large one: no padding, no batch
    interaction."""
    spec, graph, enc = small
    _, llr = _tx(spec, enc, B, ebn0, seed=seed)
    res = make_decoder(graph, "minsum", max_iters=iters)(llr)
    assert res.bits.shape == (B, spec.n)
    assert_same(res, ref.flooding(graph, np.asarray(llr), max_iters=iters))


def test_mackay1008_matches_reference():
    spec = mackay_1008()
    graph = compile_graph(spec)
    _, llr = _tx(spec, DenseEncoder.build(spec), 64, 2.0, seed=1)
    res = make_decoder(graph, "minsum", alpha=0.8125, max_iters=25)(llr)
    assert_same(res, ref.flooding(graph, np.asarray(llr), alpha=0.8125,
                                  max_iters=25))


@pytest.mark.parametrize("kind", ["minsum", "spa"])
def test_irregular_rows_match_reference(kind):
    """Irregular row degrees (802.11n expanded: rows of degree 7 AND 8):
    padded slots must act like absent edges — a regular-code fixture
    never exercises this."""
    spec = get_code("80211n/648/12")
    graph = compile_graph(spec)  # expanded unstructured view
    key = jax.random.key(21)
    # all-zero codeword is valid; noisy LLRs around it
    llr = awgn_llr(key, jnp.zeros((48, spec.n), jnp.uint8), 2.0, spec.rate)
    alpha = 0.8125 if kind == "minsum" else 1.0
    res = make_decoder(graph, kind, alpha=alpha, max_iters=12,
                       backend="xla")(llr)
    assert_same(res, ref.flooding(graph, np.asarray(llr), kind=kind,
                                  alpha=alpha, max_iters=12))
