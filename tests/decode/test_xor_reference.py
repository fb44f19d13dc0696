"""xor-permutation QC graphs (802.3an style, perm='xor') on the XLA tiers
against the plain-numpy reference: layered (sign_mode='bitxor') and
flooding schedules, plus the default route on the real family."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ref_decoders as ref
from ecc_ldpc_tpu.codes import get_code
from ecc_ldpc_tpu.codes.qc import QCXorCode, expand_qc_xor
from ecc_ldpc_tpu.decode import get_decoder, make_decoder
from ecc_ldpc_tpu.decode.xla.flooding_qc import decode_flooding_qc
from ecc_ldpc_tpu.decode.xla.layered import make_layered_decoder
from ecc_ldpc_tpu.graph.qc import compile_qc_graph


def assert_same(res, want):
    for got, w in zip((res.bits, res.ok, res.iterations), want):
        np.testing.assert_array_equal(np.asarray(got), w)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(3)
    Z = 16
    base = rng.integers(0, Z, size=(4, 8)).astype(np.int32)
    spec = expand_qc_xor(QCXorCode(Z=Z, base=base), name="toyxor16")
    return spec, compile_qc_graph(spec)


@pytest.mark.parametrize("early_term", [True, False])
def test_layered_matches_reference(toy, early_term):
    spec, g = toy
    key = jax.random.key(7)
    # all-zero codeword + AWGN at a mixed-convergence operating point so
    # the freeze path sees converged, converging, and stuck lanes
    llr = 2.2 + 2.0 * jax.random.normal(key, (96, spec.n))
    res = make_layered_decoder(g, alpha=0.8125, max_iters=12,
                               early_term=early_term)(llr)
    assert_same(res, ref.layered_qc(g, np.asarray(llr), alpha=0.8125,
                                    max_iters=12, early_term=early_term))
    its = np.asarray(res.iterations)
    assert np.asarray(res.ok).any() and its.max() > 1
    if early_term:
        assert its.min() < its.max()  # freeze path took effect


def test_batch_split(toy):
    """Frames never interact: a batch of 256 decodes as its two halves."""
    spec, g = toy
    key = jax.random.key(9)
    llr = 2.5 + 1.5 * jax.random.normal(key, (256, spec.n))
    dec = make_layered_decoder(g, alpha=0.8125, max_iters=8)
    whole = dec(llr)
    parts = [dec(llr[i:i + 128]) for i in (0, 128)]
    for field in ("bits", "ok", "iterations"):
        np.testing.assert_array_equal(
            np.asarray(getattr(whole, field)),
            np.concatenate([np.asarray(getattr(p, field)) for p in parts]))


def test_8023an_default_route_noiseless():
    """The default route decodes noiseless input in 0 iterations on the
    real family."""
    spec = get_code("8023an")
    g = compile_qc_graph(spec)
    dec = get_decoder(g, "layered/norm:0.8125/25")
    res = dec(jnp.full((8, spec.n), 17.0))
    assert np.asarray(res.ok).all()
    assert (np.asarray(res.iterations) == 0).all()


def test_schedules_and_kinds_on_xor_graphs(toy):
    """The XLA tiers serve every check-node rule and per-iteration
    schedules on xor graphs; the removed kernel backend is refused."""
    spec, g = toy
    llr = 2.2 + 2.0 * jax.random.normal(jax.random.key(4), (16, spec.n))
    T = 6
    alphas = np.linspace(0.7, 1.0, T).astype(np.float32)
    res = make_layered_decoder(g, alpha=alphas, max_iters=T)(llr)
    assert_same(res, ref.layered_qc(g, np.asarray(llr), alpha=alphas,
                                    max_iters=T))
    res = get_decoder(g, f"layered/spa/{T}")(llr)
    assert_same(res, ref.layered_qc(g, np.asarray(llr), cn="spa",
                                    max_iters=T))
    with pytest.raises(ValueError, match="backend"):
        get_decoder(g, "layered/norm:0.8125/25", backend="pallas")


@pytest.mark.parametrize("early_term", [True, False])
def test_flooding_schedule_matches_reference(toy, early_term):
    """Flooding on xor graphs: count sign semantics, stale totals,
    pre-sweep-verified freeze."""
    spec, g = toy
    key = jax.random.key(13)
    llr = 2.2 + 2.0 * jax.random.normal(key, (96, spec.n))
    res = jax.jit(lambda l: decode_flooding_qc(
        g, l, kind="minsum", alpha=0.8125, max_iters=12,
        early_term=early_term))(llr)
    assert_same(res, ref.flooding_qc(g, np.asarray(llr), alpha=0.8125,
                                     max_iters=12, early_term=early_term))


def test_flooding_default_route_noiseless(toy):
    """kind='minsum' on an xor graph routes to the roll-form flooding
    tier, which decodes noiseless input in 0 iterations."""
    spec, g = toy
    dec = make_decoder(g, "minsum", alpha=0.8125, max_iters=6)
    res = dec(jnp.full((8, spec.n), 15.0))
    assert np.asarray(res.ok).all()
    assert (np.asarray(res.iterations) == 0).all()
