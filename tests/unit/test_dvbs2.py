"""DVB-S2 family construction tests (SURVEY.md §4.2 item 1, config 4)."""
import numpy as np
import pytest

from ecc_ldpc_tpu.codes import dvbs2
from ecc_ldpc_tpu.codes.dvbs2 import RATES
from ecc_ldpc_tpu.encode.structured import DualDiagonalEncoder, build_encoder
from ecc_ldpc_tpu.graph.qc import compile_qc_graph


@pytest.mark.parametrize("rate", sorted(RATES))
def test_normal_frame_family(rate):
    spec = dvbs2(64800, rate)
    assert spec.n == 64800
    assert spec.qc.Z == 360 and spec.qc.nb == 180
    # dual-diagonal encoder validates G·H^T = 0 on construction
    enc = DualDiagonalEncoder(spec)
    assert enc.k == spec.k
    # rate within a block of nominal
    assert abs(spec.rate - RATES[rate]) < 1 / 90


def test_short_frame():
    spec = dvbs2(16200, "12")
    assert spec.n == 16200 and spec.qc.nb == 45
    DualDiagonalEncoder(spec)


def test_degree_profile_r12():
    """r=1/2 normal frame: 36 high-degree (8) block-cols, 54 degree-3,
    90 dual-diagonal parity (no degree-1 columns) — the standard's info
    profile with the floor-free parity structure (see codes/dvbs2.py)."""
    spec = dvbs2(64800, "12")
    base = spec.qc.base
    kb = 90
    info_w = (base[:, :kb] >= 0).sum(axis=0)
    assert (info_w == 8).sum() == 36
    assert (info_w == 3).sum() == 54
    par_w = (base[:, kb:] >= 0).sum(axis=0)
    assert par_w[0] == 3 and (par_w[1:] == 2).all()
    assert par_w.min() >= 2  # no weak degree-1 columns
    # block-edge count matches the real standard's ballpark
    assert 600 <= spec.qc.base[spec.qc.base >= 0].size <= 660


def test_encoder_roundtrip_device():
    import jax
    import jax.numpy as jnp

    spec = dvbs2(16200, "23")
    enc = build_encoder(spec)
    assert isinstance(enc, DualDiagonalEncoder)
    key = jax.random.key(0)
    msg = jax.random.bernoulli(key, 0.5, (4, spec.k)).astype(jnp.uint8)
    cw = enc(msg)
    assert spec.check_syndrome(np.asarray(cw))
    assert np.array_equal(np.asarray(enc.extract_message(cw)), np.asarray(msg))
    # device encode == numpy encode
    assert np.array_equal(np.asarray(cw), enc.encode_numpy(np.asarray(msg)))


def test_bad_args():
    with pytest.raises(ValueError):
        dvbs2(32400, "12")
    with pytest.raises(ValueError):
        dvbs2(64800, "11")


@pytest.mark.parametrize("rate", ["12", "34", "910"])
def test_layered_tier_takes_the_set_form(rate):
    """The standard tables put one shift per base cell, so every layer is
    duplicate-free and the layered tier uses its one-roll set-form
    update; each block-row meets each block-column at most once."""
    g = compile_qc_graph(dvbs2(64800, rate))
    assert g.intra_layer_dup_free
    assert sorted(g.layer_order) == list(range(g.mb))
