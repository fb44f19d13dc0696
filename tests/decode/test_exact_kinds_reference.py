"""Exact-BP kinds (VERDICT r1 item 5): spa/minstar in the layered and
flooding QC tiers against the plain-numpy reference (tests/ref_decoders.py),
which follows each tier's op order: layered spa sums log|tanh| in edge
order and takes log1p(t) - log1p(-t); flooding spa takes 2 atanh(t);
minstar runs box-plus forward/backward scans. Transcendentals may differ
from numpy in the last ulp, which must not move a decision here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ref_decoders as ref
from ecc_ldpc_tpu.chan import awgn_llr
from ecc_ldpc_tpu.codes import get_code
from ecc_ldpc_tpu.decode.xla.flooding_qc import decode_flooding_qc
from ecc_ldpc_tpu.decode.xla.layered import decode_layered
from ecc_ldpc_tpu.encode.structured import build_encoder
from ecc_ldpc_tpu.graph.qc import compile_qc_graph


def assert_same(res, want):
    for got, w in zip((res.bits, res.ok, res.iterations), want):
        np.testing.assert_array_equal(np.asarray(got), w)


@pytest.fixture(scope="module")
def wimax_case():
    spec = get_code("wimax/576/12")  # Z=24, dup-free
    graph = compile_qc_graph(spec)
    enc = build_encoder(spec)
    key = jax.random.key(42)
    msg = jax.random.bernoulli(key, 0.5, (16, spec.k)).astype(jnp.uint8)
    llr = awgn_llr(jax.random.fold_in(key, 1), enc(msg), 2.2, spec.rate)
    return spec, graph, llr


@pytest.mark.parametrize("kind", ["spa", "minstar"])
@pytest.mark.parametrize("early_term", [True, False])
def test_layered_exact_kind_matches_reference(wimax_case, kind, early_term):
    spec, graph, llr = wimax_case
    got = jax.jit(lambda l: decode_layered(
        graph, l, cn=kind, max_iters=8, early_term=early_term))(llr)
    assert_same(got, ref.layered_qc(graph, np.asarray(llr), cn=kind,
                                    max_iters=8, early_term=early_term))
    # at 2.2 dB with 8 iterations some frames decode, some don't — both
    # outcomes must be present or the parity assertions are weak
    assert 0 < np.asarray(got.ok).sum() <= len(np.asarray(got.ok))


@pytest.mark.parametrize("kind", ["spa", "minstar"])
def test_flooding_exact_kind_matches_reference(wimax_case, kind):
    spec, graph, llr = wimax_case
    got = jax.jit(lambda l: decode_flooding_qc(
        graph, l, kind=kind, max_iters=8, early_term=True))(llr)
    assert_same(got, ref.flooding_qc(graph, np.asarray(llr), kind=kind,
                                     max_iters=8, early_term=True))


def test_layered_exact_kinds_beat_minsum_fer(wimax_case):
    """Exact BP (spa) should decode at least as many frames as plain
    min-sum at equal iterations (statistical, fixed seed)."""
    spec, graph, _ = wimax_case
    enc = build_encoder(spec)
    key = jax.random.key(7)
    msg = jax.random.bernoulli(key, 0.5, (128, spec.k)).astype(jnp.uint8)
    llr = awgn_llr(jax.random.fold_in(key, 2), enc(msg), 2.0, spec.rate)
    ms = decode_layered(graph, llr, cn="minsum", max_iters=10)
    sp = decode_layered(graph, llr, cn="spa", max_iters=10)
    assert np.asarray(sp.ok).sum() >= np.asarray(ms.ok).sum()


def test_layered_spec_strings():
    from ecc_ldpc_tpu.decode.api import parse_decoder_spec

    kw = parse_decoder_spec("layered/spa/25")
    assert kw == {"kind": "layered", "cn": "spa", "max_iters": 25}
    kw = parse_decoder_spec("layered/minstar/10/noet")
    assert kw["cn"] == "minstar" and kw["early_term"] is False
    with pytest.raises(KeyError, match="cn="):
        from ecc_ldpc_tpu.decode import make_decoder

        make_decoder(
            compile_qc_graph(get_code("wimax/576/12")), "minsum", cn="spa",
        )


@pytest.fixture(scope="module")
def ccsds_case():
    """Multi-edge protograph (intra-layer duplicate block-columns) — the
    classic-exact sweep's reason to exist (VERDICT r2 item 7)."""
    spec = get_code("ccsds/1024/12")
    graph = compile_qc_graph(spec)
    key = jax.random.key(5)
    # random LLRs around a noisy all-zero codeword keep both decode
    # outcomes present without needing the AR4JA encoder here
    llr = 2.0 + 1.8 * jax.random.normal(key, (16, spec.n), jnp.float32)
    return spec, graph, llr


@pytest.mark.parametrize("kind", ["spa", "minstar"])
@pytest.mark.parametrize("early_term", [True, False])
def test_layered_exact_kind_multiedge_matches_reference(ccsds_case, kind,
                                                        early_term):
    """Exact BP on a DUP graph: the accumulate path, with minstar's
    posterior deltas applied in the backward order of its scan."""
    spec, graph, llr = ccsds_case
    got = jax.jit(lambda l: decode_layered(
        graph, l, cn=kind, max_iters=6, early_term=early_term))(llr)
    assert_same(got, ref.layered_qc(graph, np.asarray(llr), cn=kind,
                                    max_iters=6, early_term=early_term))
    # the parity must be exercised by a mixed population
    assert 0 < np.asarray(got.ok).sum() < len(np.asarray(got.ok))
