"""XLA layered tier (decode/xla/layered.py) against the plain-numpy
reference (tests/ref_decoders.py): equal hard decisions, ok flags and
iteration counts on the CPU, across schedules, sign modes, lifting sizes
and batch shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ref_decoders as ref
from ecc_ldpc_tpu.chan import awgn_llr
from ecc_ldpc_tpu.codes.ieee80211n import surrogate_base
from ecc_ldpc_tpu.codes.qc import QCCode, expand_qc
from ecc_ldpc_tpu.decode.xla.layered import make_layered_decoder
from ecc_ldpc_tpu.encode.structured import DualDiagonalEncoder
from ecc_ldpc_tpu.graph.qc import compile_qc_graph


@pytest.fixture(scope="module")
def z16_code():
    base = surrogate_base(mb=4, nb=12, Z=16, seed=99)
    spec = expand_qc(QCCode(Z=16, base=base), name="test.z16", k=8 * 16)
    return spec, compile_qc_graph(spec), DualDiagonalEncoder(spec)


def _tx(spec, enc, B, ebn0, seed=0):
    key = jax.random.key(seed)
    msg = jax.random.bernoulli(key, 0.5, (B, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    return cw, awgn_llr(jax.random.fold_in(key, 1), cw, ebn0, spec.rate)


def assert_same(res, want):
    bits, ok, iters = want
    np.testing.assert_array_equal(np.asarray(res.bits), bits)
    np.testing.assert_array_equal(np.asarray(res.ok), ok)
    np.testing.assert_array_equal(np.asarray(res.iterations), iters)


def test_layered_fixed_mode_matches_reference(z16_code):
    """Pure fixed-iteration mode: max_iters sweeps, no freeze."""
    spec, qg, enc = z16_code
    _, llr = _tx(spec, enc, 32, 3.0)
    a = make_layered_decoder(qg, alpha=0.8125, max_iters=8,
                             early_term=False)(llr)
    assert_same(a, ref.layered_qc(qg, np.asarray(llr), alpha=0.8125,
                                  max_iters=8, early_term=False))
    assert np.all(np.asarray(a.iterations) == 8)


def test_fixed_vs_early_term_consistency(z16_code):
    """Fixed mode has no freeze, so bits can differ on unconverged frames,
    but both modes must agree on frames both converged AND report the
    same ok truthfully."""
    spec, qg, enc = z16_code
    _, llr = _tx(spec, enc, 32, 4.0, seed=11)
    a = make_layered_decoder(qg, alpha=0.8125, max_iters=12,
                             early_term=True)(llr)
    b = make_layered_decoder(qg, alpha=0.8125, max_iters=12,
                             early_term=False)(llr)
    ok = np.asarray(a.ok) & np.asarray(b.ok)
    assert ok.mean() > 0.8
    assert np.array_equal(np.asarray(a.bits)[ok], np.asarray(b.bits)[ok])


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.8125, 0.0), (1.0, 0.1)])
def test_layered_matches_reference(z16_code, alpha, beta):
    spec, qg, enc = z16_code
    _, llr = _tx(spec, enc, 32, 3.0)
    a = make_layered_decoder(qg, alpha=alpha, beta=beta, max_iters=12)(llr)
    assert_same(a, ref.layered_qc(qg, np.asarray(llr), alpha=alpha,
                                  beta=beta, max_iters=12))


def test_layered_batch_split_and_odd_batch(z16_code):
    """A batch of 50 (no power of two) decodes as its two slices would:
    frames never interact, whatever the batch shape."""
    spec, qg, enc = z16_code
    _, llr = _tx(spec, enc, 50, 2.5, seed=3)
    dec = make_layered_decoder(qg, alpha=0.8125, max_iters=10)
    whole = dec(llr)
    assert_same(whole, ref.layered_qc(qg, np.asarray(llr), alpha=0.8125,
                                      max_iters=10))
    parts = [dec(llr[:32]), dec(llr[32:])]
    for field in ("bits", "ok", "iterations"):
        np.testing.assert_array_equal(
            np.asarray(getattr(whole, field)),
            np.concatenate([np.asarray(getattr(p, field)) for p in parts]))


@pytest.mark.parametrize("sign_mode", ["count", "bitxor"])
def test_sign_modes_match_reference(z16_code, sign_mode):
    """The two sign semantics differ only on the sign of exact-zero
    messages (-0.0); each must match its reference."""
    spec, qg, enc = z16_code
    _, llr = _tx(spec, enc, 32, 3.0, seed=21)
    a = make_layered_decoder(qg, alpha=0.8125, max_iters=10,
                             sign_mode=sign_mode)(llr)
    assert_same(a, ref.layered_qc(qg, np.asarray(llr), alpha=0.8125,
                                  max_iters=10, sign_mode=sign_mode))


@pytest.mark.parametrize("early_term", [True, False])
def test_per_iteration_schedule_matches_reference(z16_code, early_term):
    """Learned NOMS schedules: per-iteration alpha_t/beta_t arrays."""
    spec, qg, enc = z16_code
    _, llr = _tx(spec, enc, 32, 3.0, seed=13)
    T = 8
    key = jax.random.key(2)
    alphas = jax.random.uniform(key, (T,), minval=0.6, maxval=1.1)
    betas = jax.random.uniform(jax.random.fold_in(key, 1), (T,),
                               minval=0.0, maxval=0.25)
    a = make_layered_decoder(qg, alpha=alphas, beta=betas, max_iters=T,
                             early_term=early_term)(llr)
    assert_same(a, ref.layered_qc(
        qg, np.asarray(llr), alpha=np.asarray(alphas),
        beta=np.asarray(betas), max_iters=T, early_term=early_term))
    # and the schedule is actually in effect: constant-(alpha,beta) arrays
    # reproduce the scalar decoder exactly
    c = make_layered_decoder(qg, alpha=jnp.full((T,), 0.8125),
                             beta=jnp.zeros((T,)), max_iters=T,
                             early_term=early_term)(llr)
    d = make_layered_decoder(qg, alpha=0.8125, max_iters=T,
                             early_term=early_term)(llr)
    assert np.array_equal(np.asarray(c.bits), np.asarray(d.bits))


@pytest.mark.parametrize("Z,seed", [(27, 1), (54, 1), (27, 2), (16, 2)])
def test_lifting_sizes_match_reference(Z, seed):
    """Lifting sizes that are not multiples of 8 (the 802.11n Z=27/54) and
    a power of two, over a batch of odd size, in both modes."""
    base = surrogate_base(mb=4, nb=12, Z=Z, seed=seed)
    spec = expand_qc(QCCode(Z=Z, base=base), name=f"t{Z}", k=8 * Z)
    qg = compile_qc_graph(spec)
    _, llr = _tx(spec, DualDiagonalEncoder(spec), 8 * 3 + 5, 3.0, seed=5)
    for et in (True, False):
        a = make_layered_decoder(qg, alpha=0.8125, max_iters=6,
                                 early_term=et)(llr)
        assert_same(a, ref.layered_qc(qg, np.asarray(llr), alpha=0.8125,
                                      max_iters=6, early_term=et))
