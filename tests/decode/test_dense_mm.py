"""Incidence-matmul decoder must match the gather-form oracle bit-exactly
on CPU (same schedule, same CN op; only benign f32 summation-order changes).
This is the oracle-twin methodology of SURVEY.md §4.2 item 3 applied to the
incidence-matmul tier."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecc_ldpc_tpu.chan import awgn_llr
from ecc_ldpc_tpu.codes import gallager_36
from ecc_ldpc_tpu.decode import make_decoder
from ecc_ldpc_tpu.decode.xla import dense_mm
from ecc_ldpc_tpu.encode import DenseEncoder
from ecc_ldpc_tpu.graph import compile_graph


@pytest.fixture(scope="module")
def code():
    spec = gallager_36(120, seed=11)
    return spec, compile_graph(spec), DenseEncoder.build(spec)


@pytest.mark.parametrize("kind", ["spa", "minsum"])
@pytest.mark.parametrize("early_term", [True, False])
def test_mm_matches_gather(code, kind, early_term):
    spec, graph, enc = code
    key = jax.random.key(5)
    msg = jax.random.bernoulli(key, 0.5, (64, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    llr = awgn_llr(key, cw, 2.5, spec.rate)
    a = make_decoder(graph, kind, max_iters=20, early_term=early_term, backend="xla")(llr)
    b = make_decoder(graph, kind, max_iters=20, early_term=early_term, backend="xla-mm")(llr)
    assert np.array_equal(np.asarray(a.bits), np.asarray(b.bits))
    assert np.array_equal(np.asarray(a.ok), np.asarray(b.ok))
    assert np.array_equal(np.asarray(a.iterations), np.asarray(b.iterations))


def test_incidence_operators_shape(code):
    spec, graph, _ = code
    ops = dense_mm.IncidenceOperators.build(graph)
    assert ops.S.shape == (graph.n, graph.m * graph.dc_max)
    assert float(ops.S.sum()) == graph.num_edges
    assert float(ops.H.sum()) == graph.num_edges


def test_supports_gate():
    big = type("G", (), {"n": 70000, "m": 35000, "dc_max": 8})
    assert not dense_mm.supports(big)
