"""BPSK over AWGN, and the LLR front-end (SURVEY.md §2.1 R2, §2.2 C9).

Conventions (matching the reference's MATLAB-derived channel model):
  bit 0 -> +1, bit 1 -> -1          (BPSK map x = 1 - 2b)
  sigma^2 = 1 / (2 * R * 10^(EbN0_dB/10))   noise variance per dimension
  LLR = 2*y / sigma^2               (positive LLR => bit 0 more likely)

All functions are pure jnp and shard trivially over batch; PRNG keys are
expected to already be folded per (host, step, snr-point) by the caller
(dist/montecarlo.py) so noise streams are mesh-shape-invariant.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def bpsk(bits: jax.Array) -> jax.Array:
    """{0,1} -> {+1.0, -1.0}."""
    return 1.0 - 2.0 * bits.astype(jnp.float32)


def noise_sigma(ebn0_db, rate):
    """AWGN sigma for a given Eb/N0 (dB) and code rate."""
    ebn0 = 10.0 ** (jnp.asarray(ebn0_db, jnp.float32) / 10.0)
    return jax.lax.rsqrt(2.0 * rate * ebn0)


def awgn_llr(key: jax.Array, bits: jax.Array, ebn0_db, rate) -> jax.Array:
    """Transmit `bits` over BPSK/AWGN; return channel LLRs (same shape)."""
    sigma = noise_sigma(ebn0_db, rate)
    y = bpsk(bits) + sigma * jax.random.normal(key, bits.shape, jnp.float32)
    return llr_from_channel(y, sigma)


def llr_from_channel(y: jax.Array, sigma) -> jax.Array:
    return 2.0 * y / (sigma * sigma)


def make_channel(spec):
    """Channel function honoring a code's punctured/shortened positions
    (5G NR rate matching, SURVEY.md §2.2 C7): punctured bits are never
    transmitted (LLR 0 at the receiver), shortened/filler bits are known
    zeros (large positive LLR). Returns f(key, cw, ebn0_db) -> llr.

    Eb/N0 is referenced to spec.rate = k / transmitted bits, matching the
    reference's sigma convention applied to the transmitted stream.
    """
    import numpy as _np

    # Elementwise mask arithmetic, NOT fancy-index .at[].set: the masks are
    # constants, so the channel stays one fused elementwise kernel with no
    # scatter.
    keep = _np.ones(spec.n, dtype=_np.float32)
    add = _np.zeros(spec.n, dtype=_np.float32)
    punct = _np.asarray(spec.punctured_cols, dtype=_np.int64)
    short = _np.asarray(spec.shortened_cols, dtype=_np.int64)
    keep[punct] = 0.0
    keep[short] = 0.0
    add[short] = 60.0
    rate = spec.rate
    masked = len(punct) or len(short)

    def channel(key, cw, ebn0_db):
        llr = awgn_llr(key, cw, ebn0_db, rate)
        if masked:
            llr = llr * keep + add
        return llr

    return channel


def q_function(x):
    """Gaussian tail Q(x) = P(N(0,1) > x)."""
    return 0.5 * jax.scipy.special.erfc(jnp.asarray(x) / jnp.sqrt(2.0))


def uncoded_bpsk_ber(ebn0_db):
    """Closed-form uncoded BPSK BER = Q(sqrt(2*Eb/N0)) — the theory anchor
    the reference's uncoded-BPSK baseline curves follow (SURVEY.md §2.1 R3)."""
    ebn0 = 10.0 ** (jnp.asarray(ebn0_db, jnp.float32) / 10.0)
    return q_function(jnp.sqrt(2.0 * ebn0))
