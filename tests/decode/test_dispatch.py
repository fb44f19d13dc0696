"""Decoder dispatch (decode/api.py): one auto rule on every platform —
the XLA tiers — and a clear error for backends that do not exist."""
from unittest import mock

import jax
import pytest

from ecc_ldpc_tpu import codes, decode
from ecc_ldpc_tpu.graph import compile_graph, compile_qc_graph


@pytest.fixture(scope="module")
def plain_graph():
    return compile_graph(codes.get_code("mackay1008"))


def test_layered_rejects_non_qc_graph(plain_graph):
    with pytest.raises(TypeError, match="QCGraph"):
        decode.make_decoder(plain_graph, kind="layered")


@pytest.mark.parametrize("kind", ["layered", "minsum", "spa", "bitflip"])
def test_pallas_backend_rejected(kind):
    g = compile_qc_graph(codes.get_code("wimax/576/12"))
    with pytest.raises(ValueError, match="'pallas'.*XLA tiers"):
        decode.make_decoder(g, kind=kind, backend="pallas")


def test_pallas_spec_token_rejected():
    from ecc_ldpc_tpu.decode.api import parse_decoder_spec

    with pytest.raises(ValueError, match="pallas"):
        parse_decoder_spec("layered/norm:0.8125/25/pallas")
    assert parse_decoder_spec("minsum/25/xla-mm")["backend"] == "xla-mm"


@pytest.mark.parametrize("code,kind", [
    ("wimax/576/12", "layered"),
    ("wimax/576/12", "minsum"),
    ("wimax/576/12", "spa"),
    ("mackay1008", "minsum"),
    ("gallager/9000/3/6", "minstar"),
])
def test_auto_route_ignores_the_platform(code, kind):
    """The auto rule never asks which platform it is on, so it routes the
    same on every one (a large unstructured minstar graph included)."""
    from ecc_ldpc_tpu.decode.api import choose_graph

    g = choose_graph(codes.get_code(code), f"{kind}/5")
    with mock.patch.object(jax, "default_backend",
                           side_effect=AssertionError("platform consulted")):
        dec = decode.make_decoder(g, kind=kind, max_iters=5, backend="auto")
    assert callable(dec)


def test_auto_cpu_still_routes_everything(plain_graph):
    dec = decode.make_decoder(plain_graph, kind="minstar", backend="auto")
    assert callable(dec)


def test_choose_graph_routing():
    """The shared routing rule honors explicit backend overrides that only
    exist on the expanded graph, and keeps QC codes on the QC view
    otherwise (the gather-free roll tiers)."""
    from ecc_ldpc_tpu.decode.api import choose_graph
    from ecc_ldpc_tpu.graph import CompiledGraph, QCGraph

    spec = codes.get_code("80211n/648/12")
    assert isinstance(choose_graph(spec, "minsum/10"), QCGraph)
    assert isinstance(choose_graph(spec, "spa/10"), QCGraph)
    assert isinstance(choose_graph(spec, "layered/10"), QCGraph)
    assert type(choose_graph(spec, "minsum/10", backend="xla-mm")) \
        is CompiledGraph
    plain = codes.get_code("mackay1008")
    assert type(choose_graph(plain, "minsum/10")) is CompiledGraph


def test_sched_spec_guards():
    from ecc_ldpc_tpu.decode.api import parse_decoder_spec

    with pytest.raises(ValueError, match="layered"):
        parse_decoder_spec("minsum/sched:dvbs2_64800_12_T25")
    with pytest.raises(ValueError, match="mixes"):
        parse_decoder_spec("layered/norm:0.9/sched:dvbs2_64800_12_T25")


def test_backend_override_through_sweep():
    """--backend xla-mm on a QC code must route the expanded graph (was an
    AttributeError crash when the QC view was forced)."""
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec, run_sweep

    res = run_sweep(SweepSpec(
        code="80211n/648/12", decoder="minsum/8", backend="xla-mm",
        ebn0_db=(3.0,), batch=32,
        stopping=StoppingRule(min_frame_errors=1, max_frames=32),
    ))
    assert res[0].frames >= 32


def test_ecc_facade_routes_qc_spa():
    """build_ecc uses the shared routing: spa on a QC code decodes
    end-to-end through the roll form."""
    import numpy as np
    import jax.numpy as jnp

    from ecc_ldpc_tpu import build_ecc

    ecc = build_ecc("80211n/648/12", "spa/8")
    msg = jnp.zeros((4, ecc.k), jnp.uint8)
    cw = ecc.encode(msg)
    llr = (1.0 - 2.0 * cw.astype(jnp.float32)) * 8.0
    res = ecc.decode(llr)
    assert np.all(np.asarray(res.ok))
