"""XOR-permutation QC machinery (codes/qc.py QCXorCode + graph/qc.py
xor_perm): the block-permutation family serving IEEE 802.3an on the
layered/flooding QC tiers (r5; VERDICT r4 next-round item 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecc_ldpc_tpu.codes.qc import QCXorCode, expand_qc_xor
from ecc_ldpc_tpu.graph.qc import compile_qc_graph, xor_perm


def test_xor_perm_matches_indexing():
    rng = np.random.default_rng(0)
    for Z in (8, 16, 64):
        x = rng.standard_normal((Z, 3)).astype(np.float32)
        for s in [0, 1, Z // 2, Z - 1, 5 % Z]:
            got = np.asarray(xor_perm(jnp.asarray(x), s))
            np.testing.assert_array_equal(got, x[np.arange(Z) ^ s], str((Z, s)))


def test_xor_perm_is_involution():
    x = jnp.asarray(np.random.default_rng(1).standard_normal((32, 4)), jnp.float32)
    for s in (3, 17, 31):
        np.testing.assert_array_equal(
            np.asarray(xor_perm(xor_perm(x, s), s)), np.asarray(x)
        )


def test_xor_perm_rejects_bad_shapes():
    x = jnp.zeros((12, 2))
    with pytest.raises(ValueError):
        xor_perm(x, 3)  # Z not a power of two
    with pytest.raises(ValueError):
        xor_perm(jnp.zeros((16, 2)), 16)  # s out of range


def test_expansion_matches_brute_force():
    """Lifted H[bi*Z + r, bj*Z + (r^s)] = 1, zero blocks skipped."""
    Z = 8
    base = np.array([[0, 3, -1], [5, -1, 7]], np.int32)
    spec = expand_qc_xor(QCXorCode(Z=Z, base=base), name="toy")
    H = spec.dense()
    want = np.zeros((2 * Z, 3 * Z), np.uint8)
    for bi in range(2):
        for bj in range(3):
            s = base[bi, bj]
            if s < 0:
                continue
            for r in range(Z):
                want[bi * Z + r, bj * Z + (r ^ s)] = 1
    np.testing.assert_array_equal(H, want)


def test_qcxor_validation():
    with pytest.raises(ValueError):
        QCXorCode(Z=12, base=np.zeros((2, 2), np.int32))  # not a power of two
    with pytest.raises(ValueError):
        QCXorCode(Z=8, base=np.full((2, 2), 8, np.int32))  # shift >= Z


def _toy_graph():
    # a small (3,6)-ish xor-lifted code with full rank
    rng = np.random.default_rng(7)
    Z = 16
    base = rng.integers(0, Z, size=(4, 8)).astype(np.int32)
    spec = expand_qc_xor(QCXorCode(Z=Z, base=base), name="toyxor")
    return spec, compile_qc_graph(spec)


def test_flooding_qc_xor_matches_gather_oracle():
    """The xor roll-form flooding decoder must agree with the expanded
    gather-form oracle (same algorithm, different addressing)."""
    from ecc_ldpc_tpu.decode import get_decoder
    from ecc_ldpc_tpu.graph import compile_graph

    spec, qg = _toy_graph()
    eg = compile_graph(spec)
    key = jax.random.key(3)
    llr = jax.random.normal(key, (64, spec.n)) * 2.0 + 1.0
    for kind in ("minsum/norm:0.8125/10", "spa/10"):
        ref = get_decoder(eg, kind, backend="xla")(llr)
        got = get_decoder(qg, kind, backend="xla")(llr)
        # summation order differs between forms; decisions should still
        # coincide on all but borderline frames — require exact match here
        # (toy size, moderate LLRs make ties vanishingly unlikely)
        assert (np.asarray(got.bits) == np.asarray(ref.bits)).mean() > 0.999, kind
        np.testing.assert_array_equal(np.asarray(got.ok), np.asarray(ref.ok))


def test_layered_qc_xor_noiseless_and_syndrome():
    from ecc_ldpc_tpu.decode import get_decoder

    spec, qg = _toy_graph()
    dec = get_decoder(qg, "layered/norm:0.8125/25")
    # all-zero codeword, strong LLRs: converge in 0 iterations
    llr = jnp.full((8, spec.n), 20.0)
    res = dec(llr)
    assert np.asarray(res.ok).all()
    assert (np.asarray(res.iterations) == 0).all()
    # noisy decode: every ok frame's bits satisfy H
    key = jax.random.key(11)
    llr = 4.0 + jax.random.normal(key, (64, spec.n)) * 3.0
    res = dec(llr)
    bits = np.asarray(res.bits)
    for i in np.flatnonzero(np.asarray(res.ok))[:16]:
        assert spec.check_syndrome(bits[i])


def test_auto_route_serves_xor_graphs_with_every_kind():
    """The auto route decodes xor graphs through the XLA tiers with every
    soft kind: noiseless input converges in 0 iterations."""
    from ecc_ldpc_tpu.decode import make_decoder

    spec, qg = _toy_graph()
    llr = jnp.full((4, spec.n), 12.0)
    for kind in ("layered", "minsum", "spa", "minstar"):
        res = make_decoder(qg, kind, max_iters=5)(llr)
        assert np.asarray(res.ok).all(), kind
        assert (np.asarray(res.iterations) == 0).all(), kind


def test_graph_parallel_rejects_xor():
    from ecc_ldpc_tpu.dist.graph_parallel import make_qc_graph_parallel_decoder

    _, qg = _toy_graph()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("graph",))
    with pytest.raises(ValueError, match="perm"):
        make_qc_graph_parallel_decoder(qg, mesh)
