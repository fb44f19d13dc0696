"""Graph-parallel (edge-sharded) decode tests on a virtual CPU mesh
(SURVEY.md §4.2 item 4b)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecc_ldpc_tpu.chan import awgn_llr
from ecc_ldpc_tpu.codes import gallager_36
from ecc_ldpc_tpu.decode import make_decoder
from ecc_ldpc_tpu.dist.graph_parallel import make_graph_parallel_decoder, shard_graph
from ecc_ldpc_tpu.encode import DenseEncoder
from ecc_ldpc_tpu.graph import compile_graph

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


@pytest.fixture(scope="module")
def code():
    spec = gallager_36(96, seed=8)
    return spec, DenseEncoder.build(spec)


def _mesh(D):
    return jax.make_mesh((D,), ("graph",), devices=jax.devices()[:D])


def test_shard_graph_covers_all_checks(code):
    spec, _ = code
    sg = shard_graph(spec, 4)
    assert sg.cn_mask.sum() == spec.num_edges
    g = compile_graph(spec)
    stacked = sg.cn_vn.reshape(-1, sg.dc_max)[: g.m]
    assert np.array_equal(stacked, np.asarray(g.cn_vn))


def test_graph_parallel_decodes(code):
    spec, enc = code
    dec = make_graph_parallel_decoder(spec, _mesh(4), max_iters=20,
                                      kind="minsum", alpha=0.8125)
    key = jax.random.key(0)
    msg = jax.random.bernoulli(key, 0.5, (16, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    # noiseless
    llr0 = (1.0 - 2.0 * cw.astype(jnp.float32)) * 8.0
    r0 = dec(llr0)
    assert np.all(np.asarray(r0.ok))
    assert np.array_equal(np.asarray(r0.bits), np.asarray(cw))
    assert np.asarray(r0.iterations).max() == 0
    # AWGN: matches the single-device flooding decoder on ok frames
    llr = awgn_llr(jax.random.fold_in(key, 1), cw, 3.0, spec.rate)
    r = dec(llr)
    single = make_decoder(compile_graph(spec), "minsum", alpha=0.8125,
                          max_iters=20, backend="xla")(llr)
    ok = np.asarray(r.ok) & np.asarray(single.ok)
    assert ok.mean() > 0.8
    assert np.array_equal(np.asarray(r.bits)[ok], np.asarray(single.bits)[ok])
    assert spec.check_syndrome(np.asarray(r.bits)[np.asarray(r.ok)])


def test_graph_parallel_shard_count_invariant(code):
    """Decoded bits agree across shard counts (f32 reduction order can
    differ; require agreement on syndrome-ok frames, which is exact)."""
    spec, enc = code
    key = jax.random.key(5)
    msg = jax.random.bernoulli(key, 0.5, (16, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    llr = awgn_llr(jax.random.fold_in(key, 2), cw, 3.5, spec.rate)
    outs = []
    for D in (2, 4, 8):
        r = make_graph_parallel_decoder(spec, _mesh(D), max_iters=15,
                                        kind="minsum", alpha=0.8125)(llr)
        outs.append((np.asarray(r.bits), np.asarray(r.ok)))
    ok = outs[0][1] & outs[1][1] & outs[2][1]
    assert ok.mean() > 0.8
    for bits, _ in outs[1:]:
        assert np.array_equal(outs[0][0][ok], bits[ok])


# --- Z-sharded QC tier (VERDICT r1 item 3) ----------------------------------

from ecc_ldpc_tpu.codes import get_code
from ecc_ldpc_tpu.decode.xla.flooding_qc import decode_flooding_qc
from ecc_ldpc_tpu.dist.graph_parallel import make_qc_graph_parallel_decoder
from ecc_ldpc_tpu.encode.structured import build_encoder
from ecc_ldpc_tpu.graph.qc import compile_qc_graph


@pytest.fixture(scope="module")
def qc_code():
    spec = get_code("wimax/576/12")  # Z=24: divides 2, 4, 8
    return spec, build_encoder(spec)


@pytest.mark.parametrize("kind", ["minsum", "spa"])
def test_qc_zsharded_bit_identical(qc_code, kind):
    """The GSPMD Z-sharded decode is BIT-identical to the unsharded
    roll-form decoder for every shard count (partitioning changes layout,
    not arithmetic)."""
    spec, enc = qc_code
    graph = compile_qc_graph(spec)
    key = jax.random.key(3)
    msg = jax.random.bernoulli(key, 0.5, (8, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    llr = awgn_llr(jax.random.fold_in(key, 7), cw, 2.0, spec.rate)
    ref = decode_flooding_qc(graph, llr, kind=kind, alpha=0.9, max_iters=12)
    for D in (2, 4, 8):
        dec = make_qc_graph_parallel_decoder(
            spec, _mesh(D), kind=kind, alpha=0.9, max_iters=12
        )
        r = dec(llr)
        assert np.array_equal(np.asarray(r.bits), np.asarray(ref.bits)), D
        assert np.array_equal(np.asarray(r.ok), np.asarray(ref.ok)), D
        assert np.array_equal(
            np.asarray(r.iterations), np.asarray(ref.iterations)
        ), D


def test_qc_zsharded_noiseless_and_errors(qc_code):
    spec, enc = qc_code
    dec = make_qc_graph_parallel_decoder(spec, _mesh(8), max_iters=15,
                                         alpha=0.8125)
    key = jax.random.key(11)
    msg = jax.random.bernoulli(key, 0.5, (8, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    llr0 = (1.0 - 2.0 * cw.astype(jnp.float32)) * 8.0
    r0 = dec(llr0)
    assert np.all(np.asarray(r0.ok))
    assert np.array_equal(np.asarray(r0.bits), np.asarray(cw))
    assert np.asarray(r0.iterations).max() == 0
    assert spec.check_syndrome(np.asarray(r0.bits))


def test_qc_zsharded_rejects_indivisible():
    spec = get_code("80211n/648/12")  # Z=27: does not divide 8
    with pytest.raises(ValueError, match="divide"):
        make_qc_graph_parallel_decoder(spec, _mesh(8))


def test_qc_zsharded_flagship_64800_bit_identical():
    """THE flagship (dvbs2/64800, Z=360) decodes under the graph mesh,
    bit-identical to the unsharded roll decoder (VERDICT r4 item 6: the
    n=64800 axis is the stated motivation for graph-parallel mode).
    Minimal shapes — 2 iterations, one frame — keep this a compile-and-
    compare pin, not a throughput run."""
    spec = get_code("dvbs2/64800/12")
    graph = compile_qc_graph(spec)
    enc = build_encoder(spec)
    key = jax.random.key(21)
    msg = jax.random.bernoulli(key, 0.5, (1, spec.k)).astype(jnp.uint8)
    llr = awgn_llr(jax.random.fold_in(key, 1), enc(msg), 1.2, spec.rate)
    ref = decode_flooding_qc(graph, llr, kind="minsum", alpha=0.8125,
                             max_iters=2)
    dec = make_qc_graph_parallel_decoder(spec, _mesh(8), kind="minsum",
                                         alpha=0.8125, max_iters=2)
    r = dec(llr)
    assert np.array_equal(np.asarray(r.bits), np.asarray(ref.bits))
    assert np.array_equal(np.asarray(r.ok), np.asarray(ref.ok))
    assert np.array_equal(np.asarray(r.iterations), np.asarray(ref.iterations))
