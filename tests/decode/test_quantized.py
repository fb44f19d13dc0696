"""Fixed-point quantization emulation tests (decode/xla/layered.py quant).

Hardware-decoder literature anchor: 5-6 bit uniform message quantization
costs essentially nothing vs floating point for normalized min-sum, 3-4
bits degrade visibly. The tests pin the grid property, spec parsing, and
that monotone degradation ordering at a fixed operating point.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ecc_ldpc_tpu.decode.api import get_decoder, parse_decoder_spec
from ecc_ldpc_tpu.decode.xla.layered import quantize
from ecc_ldpc_tpu.ecc import build_ecc


def test_quantizer_grid_and_signbit():
    x = jnp.asarray([-3.9, -0.2, -0.0, 0.0, 0.1, 0.6, 97.0])
    q = quantize(x, 4, 0.5)
    lim = 7 * 0.5
    assert np.all(np.abs(np.asarray(q)) <= lim + 1e-9)
    steps = np.asarray(q) / 0.5
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-6)
    # sign bits survive (the -0.0 and the rounds-to-zero -0.2 case)
    assert np.signbit(np.asarray(q))[:3].all()


def test_spec_parsing():
    kw = parse_decoder_spec("layered/norm:0.8125/q:5:0.5/25")
    assert kw["quant"] == (5, 0.5)
    assert kw["alpha"] == 0.8125 and kw["max_iters"] == 25
    with pytest.raises(ValueError):
        parse_decoder_spec("layered/q:1:0.5/25")  # bits out of range

    from ecc_ldpc_tpu.codes import get_code
    from ecc_ldpc_tpu.graph import compile_qc_graph

    g = compile_qc_graph(get_code("80211n/648/12"))
    with pytest.raises(KeyError):
        get_decoder(g, "minsum/q:5:0.5/25")  # layered-tier option only
    with pytest.raises(ValueError, match="backend"):
        get_decoder(g, "layered/q:5:0.5/25", backend="pallas")


def _fer(dec_spec, ebn0=2.4, batch=256):
    # n=648 at a matched operating point: same ordering property as the
    # n=1944 original at ~6x less fast-suite time
    ecc = build_ecc("80211n/648/12", dec_spec)
    key = jax.random.key(0)
    km, kc = jax.random.split(key)
    msg = jax.random.bernoulli(km, 0.5, (batch, ecc.k)).astype(jnp.uint8)
    cw = ecc.encode(msg)
    out = ecc.decode(ecc.transmit(kc, cw, ebn0))
    return float(jnp.mean(~out.ok))


def test_quantized_fer_ordering():
    """6-bit/0.25 sits near float; 3-bit/1.0 is clearly broken; ordering
    is monotone at a fixed seed/operating point."""
    f_float = _fer("layered/norm:0.8125/25")
    f_q6 = _fer("layered/norm:0.8125/q:6:0.25/25")
    f_q3 = _fer("layered/norm:0.8125/q:3:1.0/25")
    assert f_q6 <= 4 * max(f_float, 1e-3)  # near-float (small-sample slack)
    assert f_q3 > 10 * f_q6  # 3-bit collapses
