"""Learned min-sum (NOMS): twin parity, gradient flow, measured BER gain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecc_ldpc_tpu.chan import awgn_llr
from ecc_ldpc_tpu.codes import get_code
from ecc_ldpc_tpu.decode.xla.layered import make_layered_decoder
from ecc_ldpc_tpu.encode.structured import build_encoder
from ecc_ldpc_tpu.graph import compile_qc_graph
from ecc_ldpc_tpu.learn import NomsParams, train_noms, unrolled_posteriors


@pytest.fixture(scope="module")
def code():
    spec = get_code("80211n/648/12")
    return spec, compile_qc_graph(spec), build_encoder(spec)


def _tx(spec, enc, B, ebn0, seed=0):
    key = jax.random.key(seed)
    msg = jax.random.bernoulli(key, 0.5, (B, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    return cw, awgn_llr(jax.random.fold_in(key, 1), cw, ebn0, spec.rate)


def test_training_twin_matches_production_decoder(code):
    """unrolled_posteriors' final hard decisions == decode_layered with
    the same per-iteration schedule (fixed iterations, count signs)."""
    spec, qg, enc = code
    cw, llr = _tx(spec, enc, 32, 2.0, seed=4)
    T = 6
    key = jax.random.key(0)
    alphas = jax.random.uniform(key, (T,), minval=0.6, maxval=1.1)
    betas = jax.random.uniform(jax.random.fold_in(key, 1), (T,),
                               minval=0.0, maxval=0.3)
    post = unrolled_posteriors(qg, llr, alphas, betas)
    bits_twin = (np.asarray(post[-1]) < 0).astype(np.uint8)
    res = make_layered_decoder(
        qg, alpha=alphas, beta=betas, max_iters=T, early_term=False,
        sign_mode="count",
    )(llr)
    assert np.array_equal(bits_twin, np.asarray(res.bits))


def test_shipped_schedule_loads_and_decodes():
    """The packaged dvbs2/64800 schedule loads and drives the layered
    decoder (tiny batch; full-scale numbers recorded in the JSON)."""
    from ecc_ldpc_tpu.learn import list_schedules, load_schedule

    assert "dvbs2_64800_12_T25" in list_schedules()
    p = load_schedule("dvbs2_64800_12_T25")
    assert p.iters == 25
    assert np.all(np.asarray(p.alphas) > 0.5)
    # drive the schedule arrays through the layered decoder on a SMALL
    # code (a 64800-scale CPU compile took ~95 s of the fast suite; the
    # schedule/decoder pairing at full scale is pinned by the FER numbers
    # in the schedule JSON and tests/ber)
    spec = get_code("80211n/648/12")
    qg = compile_qc_graph(spec)
    dec = make_layered_decoder(qg, alpha=p.alphas[:3], beta=p.betas[:3],
                               max_iters=3, early_term=False,
                               sign_mode="count")
    llr = jnp.ones((2, spec.n), jnp.float32) * 5.0
    res = dec(llr)
    assert np.all(np.asarray(res.bits) == 0)


def test_schedule_decoder_spec_string():
    """'sched:NAME' decoder-spec component loads the shipped schedule."""
    from ecc_ldpc_tpu.decode.api import parse_decoder_spec

    kw = parse_decoder_spec("layered/sched:dvbs2_64800_12_T25")
    assert kw["max_iters"] == 25 and len(kw["alpha"]) == 25
    kw = parse_decoder_spec("layered/sched:dvbs2_64800_12_T25/20")
    assert kw["max_iters"] == 20 and len(kw["alpha"]) == 20
    with pytest.raises(ValueError):
        parse_decoder_spec("layered/sched:dvbs2_64800_12_T25/30")


def test_training_reduces_loss(code):
    params, losses = train_noms(
        "80211n/648/12", iters=5, steps=16, batch=32, seed=1,
        ebn0_range=(1.5, 2.5),
    )
    assert params.iters == 5
    # adam on a noisy objective: compare first-5 vs last-5 means
    assert losses[-5:].mean() < losses[:5].mean()
    assert np.all(np.asarray(params.alphas) >= 0.5)
    assert np.all(np.asarray(params.betas) >= 0.0)


@pytest.mark.slow
def test_learned_schedule_beats_plain_minsum(code):
    """Train from plain min-sum (alpha=1, beta=0); the learned schedule
    must cut frame errors vs plain min-sum at the same iteration budget
    on held-out noise (the NOMS result; generous margin)."""
    spec, qg, enc = code
    T = 8
    params, _ = train_noms(
        "80211n/648/12", iters=T, steps=150, batch=64, seed=3,
        ebn0_range=(1.5, 3.0),
    )
    cw, llr = _tx(spec, enc, 1024, 2.2, seed=99)  # held-out seed
    plain = make_layered_decoder(qg, alpha=1.0, beta=0.0, max_iters=T,
                                 early_term=False)(llr)
    learned = make_layered_decoder(qg, alpha=params.alphas,
                                   beta=params.betas, max_iters=T,
                                   early_term=False, sign_mode="count")(llr)
    cw = np.asarray(cw)
    fe_plain = int((np.asarray(plain.bits) != cw).any(axis=1).sum())
    fe_learned = int((np.asarray(learned.bits) != cw).any(axis=1).sum())
    assert fe_learned < fe_plain, (fe_learned, fe_plain)
