"""Hard-decision bit-flip decoder tests (decode/xla/bitflip.py).

Same oracle discipline as the BP tiers: the QC roll form and the
incidence-matmul form must agree bit-exactly (their arithmetic is
integer-valued in f32), anchored by noiseless/single-flip closed cases
and statistical behavior on BSC/AWGN fronts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecc_ldpc_tpu.chan.modem import bsc_llr, hard_bpsk_awgn_llr
from ecc_ldpc_tpu.codes import get_code
from ecc_ldpc_tpu.decode import get_decoder
from ecc_ldpc_tpu.decode.api import choose_graph
from ecc_ldpc_tpu.decode.xla.bitflip import make_bitflip_decoder
from ecc_ldpc_tpu.encode.structured import build_encoder
from ecc_ldpc_tpu.graph import compile_graph, compile_qc_graph


def _qc_code():
    return get_code("80211n/648/12")


def _coded_frames(spec, batch, seed=0):
    enc = build_encoder(spec)
    key = jax.random.key(seed)
    msg = jax.random.bernoulli(key, 0.5, (batch, spec.k)).astype(jnp.uint8)
    return msg, enc(msg), enc


@pytest.mark.parametrize("variant", ["maj", "gdbf"])
def test_noiseless_converges_in_zero_iters(variant):
    spec = _qc_code()
    msg, cw, enc = _coded_frames(spec, 4)
    llr = 8.0 * (1.0 - 2.0 * cw.astype(jnp.float32))
    dec = make_bitflip_decoder(compile_qc_graph(spec), variant=variant)
    res = dec(llr)
    assert bool(jnp.all(res.ok))
    assert int(res.iterations.max()) == 0
    np.testing.assert_array_equal(np.asarray(res.bits), np.asarray(cw))


@pytest.mark.parametrize("variant", ["maj", "gdbf"])
def test_single_flip_corrected(variant):
    spec = _qc_code()
    msg, cw, enc = _coded_frames(spec, 2)
    llr = 4.0 * (1.0 - 2.0 * cw.astype(jnp.float32))
    flip_pos = 17
    llr = llr.at[:, flip_pos].multiply(-1.0)
    dec = make_bitflip_decoder(compile_qc_graph(spec), variant=variant)
    res = dec(llr)
    assert bool(jnp.all(res.ok))
    np.testing.assert_array_equal(np.asarray(res.bits), np.asarray(cw))
    assert int(res.iterations.max()) >= 1


def test_qc_and_incidence_forms_bit_identical_majority():
    """Roll form vs matmul form, majority variant: same bits/ok/iterations
    (every quantity is a small integer, exact in f32 either way)."""
    spec = _qc_code()
    msg, cw, enc = _coded_frames(spec, 32, seed=3)
    key = jax.random.key(4)
    llr = hard_bpsk_awgn_llr(key, cw, 4.5, spec.rate)
    dq = make_bitflip_decoder(compile_qc_graph(spec), variant="maj",
                              max_iters=30)
    dm = make_bitflip_decoder(compile_graph(spec), variant="maj",
                              max_iters=30)
    rq, rm = dq(llr), dm(llr)
    np.testing.assert_array_equal(np.asarray(rq.bits), np.asarray(rm.bits))
    np.testing.assert_array_equal(np.asarray(rq.ok), np.asarray(rm.ok))
    np.testing.assert_array_equal(
        np.asarray(rq.iterations), np.asarray(rm.iterations))


def test_qc_and_incidence_forms_agree_gdbf():
    """GDBF's metric mixes real-valued channel terms, so summation order
    (sequential rolls vs matmul) shifts near-threshold flips by ulps and
    trajectories may diverge per frame — forms must still agree on the
    overwhelming majority of frames."""
    spec = _qc_code()
    msg, cw, enc = _coded_frames(spec, 128, seed=3)
    key = jax.random.key(4)
    llr = hard_bpsk_awgn_llr(key, cw, 4.5, spec.rate)
    dq = make_bitflip_decoder(compile_qc_graph(spec), variant="gdbf",
                              max_iters=30)
    dm = make_bitflip_decoder(compile_graph(spec), variant="gdbf",
                              max_iters=30)
    rq, rm = dq(llr), dm(llr)
    agree = float(np.mean(np.asarray(rq.ok) == np.asarray(rm.ok)))
    assert agree >= 0.95


def test_ok_implies_true_syndrome():
    spec = _qc_code()
    msg, cw, enc = _coded_frames(spec, 64, seed=5)
    llr = bsc_llr(jax.random.key(6), cw, 0.03)
    dec = make_bitflip_decoder(compile_qc_graph(spec), variant="maj",
                               max_iters=20)
    res = dec(llr)
    bits = np.asarray(res.bits)
    ok = np.asarray(res.ok)
    assert ok.any() and not ok.all()  # p=3% leaves both classes populated
    for b in range(bits.shape[0]):
        if ok[b]:
            assert spec.check_syndrome(bits[b])


def test_gdbf_beats_majority_on_awgn():
    """Soft metric must help: GDBF corrects more AWGN frames than majority
    BF at equal iterations (fixed seed, statistical margin)."""
    spec = _qc_code()
    msg, cw, enc = _coded_frames(spec, 256, seed=7)
    from ecc_ldpc_tpu.chan.awgn import awgn_llr

    llr = awgn_llr(jax.random.key(8), cw, 4.0, spec.rate)
    g = compile_qc_graph(spec)
    fe_maj = 256 - int(jnp.sum(
        make_bitflip_decoder(g, variant="maj", max_iters=30)(llr).ok))
    fe_gdbf = 256 - int(jnp.sum(
        make_bitflip_decoder(g, variant="gdbf", max_iters=30)(llr).ok))
    assert fe_gdbf < fe_maj


def test_spec_string_dispatch():
    spec = _qc_code()
    g = choose_graph(spec, "gdbf/theta:-0.5/40")
    from ecc_ldpc_tpu.graph.qc import QCGraph

    assert isinstance(g, QCGraph)  # QC codes route to the roll form
    dec = get_decoder(g, "gdbf/theta:-0.5/40")
    msg, cw, enc = _coded_frames(spec, 4)
    llr = 5.0 * (1.0 - 2.0 * cw.astype(jnp.float32))
    assert bool(jnp.all(dec(llr).ok))

    dec2 = get_decoder(compile_graph(get_code("mackay1008")), "bitflip/30")
    spec2 = get_code("mackay1008")
    msg2, cw2, _ = _coded_frames(spec2, 2)
    llr2 = 5.0 * (1.0 - 2.0 * cw2.astype(jnp.float32))
    assert bool(jnp.all(dec2(llr2).ok))

    with pytest.raises(ValueError, match="backend"):
        get_decoder(g, "bitflip/30", backend="pallas")


def test_sweep_runner_integration():
    """End-to-end: BSC sweep with the majority decoder through SweepSpec."""
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec
    from ecc_ldpc_tpu.sim.runner import run_sweep

    res = run_sweep(SweepSpec(
        code="80211n/648/12", decoder="bitflip/20", channel="bsc:0.01",
        ebn0_db=(0.0,), batch=64,
        stopping=StoppingRule(min_frame_errors=1, max_frames=64),
    ))
    assert res[0].frames == 64
    assert res[0].fer < 1.0  # p=1% BSC: majority BF repairs most frames
