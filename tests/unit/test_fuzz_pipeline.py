"""Randomized end-to-end pipeline fuzz: arbitrary QC shapes through
build -> encode -> channel -> decode (QC and expanded views), checking
structural invariants and the plain-numpy reference rather than golden
values. Catches shape bugs the per-family tests (which use standard
geometries) can miss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ref_decoders as ref
from ecc_ldpc_tpu.chan import awgn_llr
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode, expand_qc
from ecc_ldpc_tpu.decode import make_decoder
from ecc_ldpc_tpu.decode.xla.layered import make_layered_decoder
from ecc_ldpc_tpu.encode.structured import DualDiagonalEncoder
from ecc_ldpc_tpu.graph import compile_graph, compile_qc_graph

CASES = [
    # (mb, nb, Z, seed) — odd/even Z, tall and wide protographs. The
    # largest shape (Z=27 wide) runs in the slow tier; Z=9/21 keep odd-Z
    # coverage in the fast tier.
    (3, 8, 9, 101),
    pytest.param(4, 16, 27, 202, marks=pytest.mark.slow),
    (6, 12, 16, 303),
    (4, 10, 21, 404),
]


@pytest.mark.parametrize("mb,nb,Z,seed", CASES)
def test_fuzz_pipeline(mb, nb, Z, seed):
    base = surrogate_base(mb, nb, Z, seed=seed)
    spec = expand_qc(QCCode(Z=Z, base=base), name=f"fuzz{seed}",
                     k=(nb - mb) * Z)
    qg = compile_qc_graph(spec)
    g = compile_graph(spec)
    enc = DualDiagonalEncoder(spec)

    key = jax.random.key(seed)
    B = 24
    msg = jax.random.bernoulli(key, 0.5, (B, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    # encoder invariant
    assert spec.check_syndrome(np.asarray(cw[0]))

    # noiseless decode: 0 iterations, exact bits — every decode kind
    llr0 = (1.0 - 2.0 * cw.astype(jnp.float32)) * 8.0
    for kind in ("minsum", "spa", "minstar", "layered"):
        res = make_decoder(qg, kind=kind, max_iters=6)(llr0)
        assert np.asarray(res.iterations).max() == 0, kind
        assert np.array_equal(np.asarray(res.bits), np.asarray(cw)), kind
    # expanded-graph tier agrees too
    res = make_decoder(g, kind="minsum", backend="xla", max_iters=6)(llr0)
    assert np.array_equal(np.asarray(res.bits), np.asarray(cw))

    # noisy batch: the layered tier equals the plain-numpy reference
    llr = awgn_llr(jax.random.fold_in(key, 1), cw, 3.0, spec.rate)
    a = make_layered_decoder(qg, alpha=0.8125, max_iters=8)(llr)
    bits, ok, iters = ref.layered_qc(qg, np.asarray(llr), alpha=0.8125,
                                     max_iters=8)
    assert np.array_equal(np.asarray(a.bits), bits)
    assert np.array_equal(np.asarray(a.ok), ok)
    assert np.array_equal(np.asarray(a.iterations), iters)
