"""Roll-form exact-BP decoders (spa / minstar) on QC graphs — the
gather-free flooding sum-product tier of the QC families.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecc_ldpc_tpu.chan import awgn_llr
from ecc_ldpc_tpu.codes import get_code
from ecc_ldpc_tpu.decode import make_decoder
from ecc_ldpc_tpu.encode.structured import build_encoder
from ecc_ldpc_tpu.graph import compile_graph, compile_qc_graph


@pytest.fixture(scope="module")
def code():
    spec = get_code("80211n/648/12")
    return spec, compile_qc_graph(spec), build_encoder(spec)


def _tx(spec, enc, B, ebn0, seed=0):
    key = jax.random.key(seed)
    msg = jax.random.bernoulli(key, 0.5, (B, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    return cw, awgn_llr(jax.random.fold_in(key, 1), cw, ebn0, spec.rate)


@pytest.mark.parametrize("kind", ["spa", "minstar"])
def test_noiseless_converges_immediately(code, kind):
    spec, qg, enc = code
    cw, _ = _tx(spec, enc, 8, 2.0)
    llr = (1.0 - 2.0 * cw.astype(jnp.float32)) * 8.0
    res = make_decoder(qg, kind=kind, max_iters=10)(llr)
    assert np.all(np.asarray(res.ok))
    assert np.asarray(res.iterations).max() == 0
    assert np.array_equal(np.asarray(res.bits), np.asarray(cw))


@pytest.mark.parametrize("kind", ["spa", "minstar"])
def test_single_flip_corrected(code, kind):
    spec, qg, enc = code
    cw, _ = _tx(spec, enc, 4, 2.0, seed=5)
    llr = (1.0 - 2.0 * cw.astype(jnp.float32)) * 6.0
    llr = llr.at[:, 17].multiply(-1.0)
    res = make_decoder(qg, kind=kind, max_iters=10)(llr)
    assert np.all(np.asarray(res.ok))
    assert np.array_equal(np.asarray(res.bits), np.asarray(cw))


def test_spa_minstar_agree(code):
    """spa and minstar are the same math in different numerics — decoded
    bits must agree on every frame both mark ok."""
    spec, qg, enc = code
    cw, llr = _tx(spec, enc, 64, 2.5, seed=9)
    a = make_decoder(qg, kind="spa", max_iters=20)(llr)
    b = make_decoder(qg, kind="minstar", max_iters=20)(llr)
    both = np.asarray(a.ok) & np.asarray(b.ok)
    assert both.mean() > 0.7
    assert np.array_equal(np.asarray(a.bits)[both], np.asarray(b.bits)[both])


def test_qc_spa_matches_gather_spa_decisions(code):
    """Roll-form SPA and expanded-graph gather SPA differ only in
    summation order: on frames both converge, they decode to the same
    codeword."""
    spec, qg, enc = code
    g = compile_graph(spec)
    cw, llr = _tx(spec, enc, 64, 2.5, seed=3)
    a = make_decoder(qg, kind="spa", max_iters=20)(llr)
    b = make_decoder(g, kind="spa", backend="xla", max_iters=20)(llr)
    both = np.asarray(a.ok) & np.asarray(b.ok)
    assert both.mean() > 0.7
    assert np.array_equal(np.asarray(a.bits)[both], np.asarray(b.bits)[both])


def test_spa_beats_minsum_at_fixed_seed(code):
    """Exact BP must not lose to plain min-sum (alpha=1, beta=0) on the
    same noise realization — generous margin, statistical."""
    spec, qg, enc = code
    cw, llr = _tx(spec, enc, 256, 2.0, seed=7)
    spa = make_decoder(qg, kind="spa", max_iters=25)(llr)
    ms = make_decoder(qg, kind="minsum", max_iters=25)(llr)
    cw = np.asarray(cw)
    fe_spa = int((np.asarray(spa.bits) != cw).any(axis=1).sum())
    fe_ms = int((np.asarray(ms.bits) != cw).any(axis=1).sum())
    assert fe_spa <= fe_ms + 2, (fe_spa, fe_ms)


def test_sweep_runs_spa_on_qc_code():
    """The Monte-Carlo runner routes QC codes through the QC block view
    for spa (the roll form)."""
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec, run_sweep

    res = run_sweep(SweepSpec(
        code="80211n/648/12", decoder="spa/15",
        ebn0_db=(2.5,), batch=64,
        stopping=StoppingRule(min_frame_errors=2, max_frames=128),
    ))
    assert res[0].frames >= 64 and res[0].mean_iters > 0


@pytest.mark.parametrize("kind", ["minsum", "spa"])
def test_early_terminated_frames_satisfy_syndrome(code, kind):
    """Freeze-on-verified-state: a frame that terminated early must hold
    a valid codeword (the pre-sweep state that passed the syndrome), not
    the state one sweep later."""
    spec, qg, enc = code
    cw, llr = _tx(spec, enc, 512, 1.8, seed=23)
    res = make_decoder(qg, kind=kind, max_iters=12)(llr)
    it = np.asarray(res.iterations)
    ok = np.asarray(res.ok)
    early = it < 12
    assert early.any()
    assert np.all(ok[early]), kind
