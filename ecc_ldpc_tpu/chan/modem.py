"""Channel-spec registry: BPSK/AWGN, hard-decision, BSC, and Gray M-QAM.

The reference's channel model is BPSK over AWGN with soft LLR output
(SURVEY.md §2.1 R2); this module generalizes the transmit step into a
compact channel-spec string surface, mirroring the decoder-spec strings:

  bpsk            soft-decision BPSK over AWGN (default; chan/awgn.py)
  hard            hard-decision BPSK over AWGN: the receiver quantizes to
                  one bit; LLR = sign * log((1-p)/p) with the crossover
                  p = Q(sqrt(2*R*Eb/N0)) implied by the operating point
  bsc:P           binary symmetric channel with a FIXED crossover P —
                  ignores the sweep's Eb/N0 axis (useful for hard-decision
                  decoder studies at a pinned flip rate)
  qpsk            Gray QPSK over complex AWGN (== qam4)
  8psk            Gray 8PSK over complex AWGN — DVB-S2's primary
                  modulation; exact bit LLRs from the joint 2-D metric
  qam16, qam64,   Gray square M-QAM over complex AWGN, exact bit LLRs
  qam256          (per-dimension computation, see below)
  apsk16[:gG]     DVB-S2 16APSK (4+12 rings) / 32APSK (4+12+16 rings)
  apsk32[:gG:gG]  over complex AWGN, exact joint-2D bit LLRs. Ring-ratio
                  gamma defaults to the standard's rate-3/4 values
                  (16APSK 2.85; 32APSK 2.84/5.27) and is settable per
                  spec (':g2.70'); ring GEOMETRY is the standard's
                  [recalled HIGH for 16APSK, MEDIUM for the 32APSK outer
                  ring offset]. BIT LABELING provenance (VERDICT r3 item
                  6, recall attempted rounds 4 AND 5): 16APSK uses the
                  STANDARD mapping of EN 302 307 Figure 10 [recalled
                  HIGH — structural anchors in _APSK16_STD_LABELS'
                  comment]; 32APSK's 5-bit labeling figure did NOT clear
                  the reliable-recall bar in either attempt. The round-5
                  attempt re-ran the method that cracked 16APSK (lock
                  joint structural anchors first — ring-membership bit
                  pattern, reflection-symmetry bit assignments,
                  per-ring cyclic-Gray property — then fill per-point
                  labels against them): for 32APSK NONE of the anchors
                  could be recalled with confidence (the 4+12+16 split
                  admits no exact ring-membership bit pair, and which
                  single bit, if any, marks the 16-point outer ring
                  could not be pinned), so no candidate table could be
                  validated rather than constructed. CLOSED as a
                  permanent limitation: the labeling remains a
                  deterministic quasi-Gray SURROGATE (swap-descent
                  minimization of distance-weighted Hamming cost,
                  seeded) — the same principle the standard's mapping
                  was designed on. Append ':il' to any
                  multi-bit/symbol spec for the DVB-S2 block bit
                  interleaver (write column-wise, read row-wise;
                  EN 302 307 §5.3.3, sans the 8PSK-rate-3/5 special
                  column order).

Implementation notes:
  * The QAM mapper avoids gathers entirely: bit-to-level lookup is a sum
    of compare-masked constants over the <=16 levels of one dimension,
    all elementwise work that fuses into one kernel.
  * The demapper computes EXACT log-likelihood ratios, not max-log: Gray
    square QAM factorizes into two independent Gray-PAM dimensions (I
    carries the first b/2 bits of each symbol, Q the rest), so the exact
    per-bit LLR needs only a logsumexp over the L = sqrt(M) levels of one
    dimension — a short Python loop of jnp.logaddexp accumulations, no
    [.., M] intermediate ever materializes.

Energy/noise conventions (consistent with chan/awgn.py's BPSK special
case): constellations are normalized to unit average symbol energy
(Es = 1); with b bits/symbol and code rate R, Es/N0 = b*R*(Eb/N0), so the
per-dimension noise sigma^2 = 1/(2*b*R*10^(EbN0_dB/10)). For b=1 (BPSK)
this reduces to the existing sigma = 1/sqrt(2*R*EbN0).

Bit-to-symbol assignment: transmitted bits map to symbols in order —
symbol s carries bits [s*b, s*b + b); within a symbol the first b/2 bits
drive the I level and the last b/2 the Q level, each Gray-coded with the
MSB first. Requires n divisible by b.
"""
from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .awgn import awgn_llr, make_channel, q_function


# ---------------------------------------------------------------------------
# Gray PAM tables (host-side, tiny)
# ---------------------------------------------------------------------------


def _gray(i: int) -> int:
    return i ^ (i >> 1)


def pam_tables(bits_per_dim: int):
    """Gray-PAM constellation tables for one dimension.

    Returns (levels[L], bit_table[L, bd], level_by_bitint[2**bd]) where
    levels are UNSCALED odd integers (-L+1, ..., L-1), bit_table[i, j] is
    bit j (MSB first) of level i's Gray label, and level_by_bitint[v] is
    the unscaled level whose Gray label has integer value v.
    """
    L = 1 << bits_per_dim
    levels = np.arange(L, dtype=np.float64) * 2.0 - (L - 1)
    labels = np.asarray([_gray(i) for i in range(L)], dtype=np.int64)
    bit_table = np.zeros((L, bits_per_dim), dtype=np.int64)
    for i in range(L):
        for j in range(bits_per_dim):
            bit_table[i, j] = (labels[i] >> (bits_per_dim - 1 - j)) & 1
    level_by_bitint = np.zeros(L, dtype=np.float64)
    level_by_bitint[labels] = levels
    return levels, bit_table, level_by_bitint


def qam_unit_scale(M: int) -> float:
    """Per-level scale d such that the square-M-QAM constellation
    {(a_i*d, a_q*d)} with odd-integer a has unit average symbol energy:
    Es = 2 * d^2 * (L^2 - 1) / 3 = 1 for L = sqrt(M) levels/dimension."""
    L = int(round(math.sqrt(M)))
    return math.sqrt(3.0 / (2.0 * (L * L - 1)))


# ---------------------------------------------------------------------------
# Gray square M-QAM over complex AWGN
# ---------------------------------------------------------------------------


def qam_modulate(bits: jax.Array, M: int):
    """bits [..., n] in {0,1} -> (xi, xq) real symbol streams [..., n/b].

    Gather-free: the Gray bit-int -> level lookup is a compare-mask sum
    over the L <= 16 levels of one dimension.
    """
    b = int(round(math.log2(M)))
    bd = b // 2
    if 1 << b != M or b % 2:
        raise ValueError(f"M={M} is not an even power of 2 (square QAM)")
    n = bits.shape[-1]
    if n % b:
        raise ValueError(f"codeword length {n} not divisible by {b} bits/symbol")
    d = qam_unit_scale(M)
    _, _, lut = pam_tables(bd)
    sym = bits.reshape(*bits.shape[:-1], n // b, b).astype(jnp.int32)

    def map_dim(dim_bits):  # [..., n_sym, bd] -> [..., n_sym]
        v = jnp.zeros(dim_bits.shape[:-1], jnp.int32)
        for j in range(bd):
            v = v + dim_bits[..., j] * (1 << (bd - 1 - j))
        x = jnp.zeros(v.shape, jnp.float32)
        for k in range(1 << bd):
            x = x + jnp.float32(lut[k] * d) * (v == k)
        return x

    return map_dim(sym[..., :bd]), map_dim(sym[..., bd:])


def pam_bit_llrs(y: jax.Array, bits_per_dim: int, scale: float, sigma):
    """Exact per-bit LLRs for one Gray-PAM dimension.

    y: [..., n_sym] received values; returns [..., n_sym, bits_per_dim]
    with the framework's sign convention (positive LLR => bit 0).
    Accumulates logsumexp level-by-level so no [..., L] tensor is built.
    """
    levels, bit_table, _ = pam_tables(bits_per_dim)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    neg_inf = jnp.float32(-1e30)
    acc0 = [jnp.full(y.shape, neg_inf) for _ in range(bits_per_dim)]
    acc1 = [jnp.full(y.shape, neg_inf) for _ in range(bits_per_dim)]
    for i in range(len(levels)):
        dist = y - jnp.float32(levels[i] * scale)
        metric = -(dist * dist) * inv2s2
        for j in range(bits_per_dim):
            if bit_table[i, j] == 0:
                acc0[j] = jnp.logaddexp(acc0[j], metric)
            else:
                acc1[j] = jnp.logaddexp(acc1[j], metric)
    return jnp.stack([a0 - a1 for a0, a1 in zip(acc0, acc1)], axis=-1)


def qam_awgn_llr(key: jax.Array, bits: jax.Array, ebn0_db, rate,
                 M: int) -> jax.Array:
    """Transmit `bits` as Gray M-QAM over complex AWGN; return bit LLRs
    (same shape as `bits`). Exact demapping (see module docstring)."""
    b = int(round(math.log2(M)))
    bd = b // 2
    xi, xq = qam_modulate(bits, M)
    ebn0 = 10.0 ** (jnp.asarray(ebn0_db, jnp.float32) / 10.0)
    sigma = jax.lax.rsqrt(2.0 * b * rate * ebn0)  # per-dimension
    ki, kq = jax.random.split(key)
    yi = xi + sigma * jax.random.normal(ki, xi.shape, jnp.float32)
    yq = xq + sigma * jax.random.normal(kq, xq.shape, jnp.float32)
    d = qam_unit_scale(M)
    li = pam_bit_llrs(yi, bd, d, sigma)  # [..., n_sym, bd]
    lq = pam_bit_llrs(yq, bd, d, sigma)
    llr = jnp.concatenate([li, lq], axis=-1)  # [..., n_sym, b]
    return llr.reshape(*bits.shape)


# ---------------------------------------------------------------------------
# Gray 8PSK over complex AWGN (DVB-S2's primary modulation)
# ---------------------------------------------------------------------------
#
# A PSK ring does not factorize into independent I/Q dimensions, so the
# exact bit LLRs need the joint 2-D metric — still just a Python loop of
# logaddexp accumulations over the M=8 points (no [.., M] intermediate).
# Unit symbol energy holds by construction (points on the unit circle).
# The bit mapping is Gray around the ring (adjacent symbols differ in one
# bit), the standard BICM choice; DVB-S2's published 8PSK mapping is also
# Gray up to a rotation/relabeling that AWGN performance is invariant to.


def psk_tables(bits_per_sym: int):
    """Gray-PSK tables: (xi[M], xq[M], bit_table[M, b], xi_by_bitint[M],
    xq_by_bitint[M]); point i sits at angle 2*pi*i/M and carries Gray
    label gray(i), MSB first."""
    M = 1 << bits_per_sym
    ang = 2.0 * np.pi * np.arange(M) / M
    xi, xq = np.cos(ang), np.sin(ang)
    labels = np.asarray([_gray(i) for i in range(M)], dtype=np.int64)
    bit_table = np.zeros((M, bits_per_sym), dtype=np.int64)
    for i in range(M):
        for j in range(bits_per_sym):
            bit_table[i, j] = (labels[i] >> (bits_per_sym - 1 - j)) & 1
    xi_by_bitint = np.zeros(M)
    xq_by_bitint = np.zeros(M)
    xi_by_bitint[labels] = xi
    xq_by_bitint[labels] = xq
    return xi, xq, bit_table, xi_by_bitint, xq_by_bitint


def psk_modulate(bits: jax.Array, M: int):
    """bits [..., n] -> (xi, xq) [..., n/b]; gather-free compare-mask map."""
    b = int(round(math.log2(M)))
    if 1 << b != M:
        raise ValueError(f"M={M} is not a power of 2")
    n = bits.shape[-1]
    if n % b:
        raise ValueError(f"codeword length {n} not divisible by {b} bits/symbol")
    _, _, _, lut_i, lut_q = psk_tables(b)
    sym = bits.reshape(*bits.shape[:-1], n // b, b).astype(jnp.int32)
    v = jnp.zeros(sym.shape[:-1], jnp.int32)
    for j in range(b):
        v = v + sym[..., j] * (1 << (b - 1 - j))
    xi = jnp.zeros(v.shape, jnp.float32)
    xq = jnp.zeros(v.shape, jnp.float32)
    for k in range(M):
        sel = v == k
        xi = xi + jnp.float32(lut_i[k]) * sel
        xq = xq + jnp.float32(lut_q[k]) * sel
    return xi, xq


def psk_bit_llrs(yi: jax.Array, yq: jax.Array, bits_per_sym: int, sigma):
    """Exact per-bit LLRs for Gray PSK from the joint 2-D metric.

    Returns [..., n_sym, bits_per_sym], positive LLR => bit 0."""
    xi, xq, bit_table, _, _ = psk_tables(bits_per_sym)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    neg_inf = jnp.float32(-1e30)
    acc0 = [jnp.full(yi.shape, neg_inf) for _ in range(bits_per_sym)]
    acc1 = [jnp.full(yi.shape, neg_inf) for _ in range(bits_per_sym)]
    for i in range(len(xi)):
        di = yi - jnp.float32(xi[i])
        dq = yq - jnp.float32(xq[i])
        metric = -(di * di + dq * dq) * inv2s2
        for j in range(bits_per_sym):
            if bit_table[i, j] == 0:
                acc0[j] = jnp.logaddexp(acc0[j], metric)
            else:
                acc1[j] = jnp.logaddexp(acc1[j], metric)
    return jnp.stack([a0 - a1 for a0, a1 in zip(acc0, acc1)], axis=-1)


def psk_awgn_llr(key: jax.Array, bits: jax.Array, ebn0_db, rate,
                 M: int) -> jax.Array:
    """Transmit `bits` as Gray M-PSK over complex AWGN; exact bit LLRs."""
    b = int(round(math.log2(M)))
    xi, xq = psk_modulate(bits, M)
    ebn0 = 10.0 ** (jnp.asarray(ebn0_db, jnp.float32) / 10.0)
    sigma = jax.lax.rsqrt(2.0 * b * rate * ebn0)  # per-dimension
    ki, kq = jax.random.split(key)
    yi = xi + sigma * jax.random.normal(ki, xi.shape, jnp.float32)
    yq = xq + sigma * jax.random.normal(kq, xq.shape, jnp.float32)
    llr = psk_bit_llrs(yi, yq, b, sigma)  # [..., n_sym, b]
    return llr.reshape(*bits.shape)


# ---------------------------------------------------------------------------
# DVB-S2 APSK (EN 302 307 §5.4.3/§5.4.4): 16APSK = 4+12, 32APSK = 4+12+16
# ---------------------------------------------------------------------------

# Standard ring-ratio tables per LDPC code rate [recalled MEDIUM-HIGH]:
APSK16_GAMMA = {"23": 3.15, "34": 2.85, "45": 2.75, "56": 2.70,
                "89": 2.60, "910": 2.57}
APSK32_GAMMA = {"34": (2.84, 5.27), "45": (2.72, 4.87), "56": (2.64, 4.64),
                "89": (2.54, 4.33), "910": (2.53, 4.30)}


def _quasi_gray_labels(xi, xq, bits: int, seed: int = 5, restarts: int = 8):
    """Deterministic quasi-Gray labeling: minimize sum over point pairs of
    exp(-d^2) * Hamming(label_i, label_j) by pairwise-swap descent from
    seeded random starts. A surrogate for the standard's (quasi-Gray)
    mapping figure; see module docstring."""
    M = len(xi)
    d2 = (xi[:, None] - xi[None, :]) ** 2 + (xq[:, None] - xq[None, :]) ** 2
    w = np.exp(-d2)
    np.fill_diagonal(w, 0.0)
    pop = np.arange(M)
    hamming = np.zeros((M, M))
    for a in range(M):
        for b in range(M):
            hamming[a, b] = bin(a ^ b).count("1")

    def cost(lab):
        return float(np.sum(w * hamming[np.ix_(lab, lab)]))

    rng = np.random.default_rng(seed)
    best_lab, best_c = None, np.inf
    for _ in range(restarts):
        lab = rng.permutation(pop)
        c = cost(lab)
        improved = True
        while improved:
            improved = False
            for i in range(M):
                for j in range(i + 1, M):
                    lab[i], lab[j] = lab[j], lab[i]
                    c2 = cost(lab)
                    if c2 < c - 1e-12:
                        c = c2
                        improved = True
                    else:
                        lab[i], lab[j] = lab[j], lab[i]
        if c < best_c:
            best_c, best_lab = c, lab.copy()
    return best_lab


def apsk_rings(M: int, gamma):
    """(radii per ring, angles per ring) for unit-mean-energy DVB-S2 APSK."""
    if M == 16:
        g = float(gamma[0]) if isinstance(gamma, (tuple, list)) else float(gamma)
        r1 = math.sqrt(16.0 / (4.0 + 12.0 * g * g))
        rings = [(r1, 4, math.pi / 4), (g * r1, 12, math.pi / 12)]
    elif M == 32:
        g1, g2 = (float(gamma[0]), float(gamma[1]))
        r1 = math.sqrt(32.0 / (4.0 + 12.0 * g1 * g1 + 16.0 * g2 * g2))
        rings = [(r1, 4, math.pi / 4), (g1 * r1, 12, math.pi / 12),
                 (g2 * r1, 16, 0.0)]
    else:
        raise ValueError(f"APSK supports M in (16, 32), not {M}")
    return rings


# EN 302 307 §5.4.3 Figure 10: the standard 16APSK bit mapping
# [recalled HIGH]. Point order matches apsk_rings/apsk_tables generation:
# indices 0-3 = inner ring at 45/135/225/315 deg, 4-15 = outer ring at
# 15/45/75/.../345 deg. Labels (MSB-first integers):
#   inner: 1100, 1110, 1111, 1101   outer: 0100 0000 1000 1010 0010 0110
#                                          0111 0011 1011 1001 0001 0101
# Joint structural anchors a confabulated table would be unlikely to hit
# (pinned in tests/unit/test_modem.py): a permutation of 0..15; BOTH
# rings cyclically Gray (every adjacent pair differs in exactly one bit);
# bit y4 (LSB) flips under Q-axis reflection (theta -> -theta) and bit y3
# under I-axis reflection (theta -> pi - theta) for every point; the MSB
# pair is 11 exactly on the inner ring.
_APSK16_STD_LABELS = (12, 14, 15, 13, 4, 0, 8, 10, 2, 6, 7, 3, 11, 9, 1, 5)

_APSK_CACHE = {}


def apsk_tables(M: int, gamma):
    """(xi[M], xq[M], bit_table[M, b], lut_i[M], lut_q[M]) — point lists
    plus label->point luts (lut[label] = coordinate), cached per gamma."""
    gkey = tuple(gamma) if isinstance(gamma, (tuple, list)) else (float(gamma),)
    key = (M, gkey)
    if key in _APSK_CACHE:
        return _APSK_CACHE[key]
    xs, ys = [], []
    for r, cnt, off in apsk_rings(M, gamma):
        for k in range(cnt):
            ang = off + 2.0 * math.pi * k / cnt
            xs.append(r * math.cos(ang))
            ys.append(r * math.sin(ang))
    xi = np.asarray(xs)
    xq = np.asarray(ys)
    b = int(round(math.log2(M)))
    # 16APSK: standard mapping (recalled); 32APSK: quasi-Gray surrogate
    # (module docstring provenance)
    labels = (
        np.asarray(_APSK16_STD_LABELS)
        if M == 16
        else _quasi_gray_labels(xi, xq, b)
    )
    bit_table = np.zeros((M, b), dtype=np.int64)
    for i in range(M):
        for j in range(b):
            bit_table[i, j] = (labels[i] >> (b - 1 - j)) & 1
    lut_i = np.zeros(M)
    lut_q = np.zeros(M)
    lut_i[labels] = xi
    lut_q[labels] = xq
    out = (xi, xq, bit_table, lut_i, lut_q)
    _APSK_CACHE[key] = out
    return out


def apsk_modulate(bits: jax.Array, M: int, gamma):
    """bits [..., n] -> (xi, xq) [..., n/b]; gather-free compare-mask map."""
    b = int(round(math.log2(M)))
    n = bits.shape[-1]
    if n % b:
        raise ValueError(f"codeword length {n} not divisible by {b} bits/symbol")
    _, _, _, lut_i, lut_q = apsk_tables(M, gamma)
    sym = bits.reshape(*bits.shape[:-1], n // b, b).astype(jnp.int32)
    v = jnp.zeros(sym.shape[:-1], jnp.int32)
    for j in range(b):
        v = v + sym[..., j] * (1 << (b - 1 - j))
    xi = jnp.zeros(v.shape, jnp.float32)
    xq = jnp.zeros(v.shape, jnp.float32)
    for k in range(M):
        sel = v == k
        xi = xi + jnp.float32(lut_i[k]) * sel
        xq = xq + jnp.float32(lut_q[k]) * sel
    return xi, xq


def const_bit_llrs(yi, yq, xi, xq, bit_table, sigma):
    """Exact per-bit LLRs from the joint 2-D metric for ANY constellation
    point list (the 8PSK demapper's accumulation generalized)."""
    bits_per_sym = bit_table.shape[1]
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    neg_inf = jnp.float32(-1e30)
    acc0 = [jnp.full(yi.shape, neg_inf) for _ in range(bits_per_sym)]
    acc1 = [jnp.full(yi.shape, neg_inf) for _ in range(bits_per_sym)]
    for i in range(len(xi)):
        di = yi - jnp.float32(xi[i])
        dq = yq - jnp.float32(xq[i])
        metric = -(di * di + dq * dq) * inv2s2
        for j in range(bits_per_sym):
            if bit_table[i, j] == 0:
                acc0[j] = jnp.logaddexp(acc0[j], metric)
            else:
                acc1[j] = jnp.logaddexp(acc1[j], metric)
    return jnp.stack([a0 - a1 for a0, a1 in zip(acc0, acc1)], axis=-1)


def apsk_awgn_llr(key: jax.Array, bits: jax.Array, ebn0_db, rate,
                  M: int, gamma) -> jax.Array:
    """Transmit `bits` as DVB-S2 M-APSK over complex AWGN; exact bit LLRs."""
    b = int(round(math.log2(M)))
    xi_t, xq_t, bit_table, _, _ = apsk_tables(M, gamma)
    xi, xq = apsk_modulate(bits, M, gamma)
    ebn0 = 10.0 ** (jnp.asarray(ebn0_db, jnp.float32) / 10.0)
    sigma = jax.lax.rsqrt(2.0 * b * rate * ebn0)  # per-dimension
    ki, kq = jax.random.split(key)
    yi = xi + sigma * jax.random.normal(ki, xi.shape, jnp.float32)
    yq = xq + sigma * jax.random.normal(kq, xq.shape, jnp.float32)
    llr = const_bit_llrs(yi, yq, xi_t, xq_t, bit_table, sigma)
    return llr.reshape(*bits.shape)


# ---------------------------------------------------------------------------
# DVB-S2 block bit interleaver (EN 302 307 §5.3.3)
# ---------------------------------------------------------------------------


def interleave_tx(cw: jax.Array, b: int) -> jax.Array:
    """Codeword -> transmitted bit order: write column-wise into b columns
    of n/b rows, read row-wise. Pure reshape/transpose (gather-free)."""
    n = cw.shape[-1]
    rows = n // b
    return cw.reshape(*cw.shape[:-1], b, rows).swapaxes(-1, -2).reshape(
        *cw.shape[:-1], n)


def deinterleave_llr(llr_tx: jax.Array, b: int) -> jax.Array:
    """Inverse map on received LLRs: transmitted order -> codeword order."""
    n = llr_tx.shape[-1]
    rows = n // b
    return llr_tx.reshape(*llr_tx.shape[:-1], rows, b).swapaxes(-1, -2).reshape(
        *llr_tx.shape[:-1], n)


def uncoded_8psk_ber_approx(ebn0_db):
    """Gray 8PSK uncoded BER, nearest-neighbor approximation:
    Pb ~ (2/3) Q(sqrt(6 Eb/N0) sin(pi/8)) — tight above ~6 dB."""
    g = 10.0 ** (jnp.asarray(ebn0_db, jnp.float32) / 10.0)
    return (2.0 / 3.0) * q_function(jnp.sqrt(6.0 * g) * jnp.sin(jnp.pi / 8.0))


# ---------------------------------------------------------------------------
# Hard-decision channels
# ---------------------------------------------------------------------------


def bsc_llr(key: jax.Array, bits: jax.Array, p) -> jax.Array:
    """Binary symmetric channel with crossover p; LLR = +/-log((1-p)/p)."""
    p = jnp.asarray(p, jnp.float32)
    flips = jax.random.bernoulli(key, p, bits.shape)
    received = jnp.logical_xor(bits.astype(jnp.bool_), flips)
    mag = jnp.log1p(-p) - jnp.log(p)
    return jnp.where(received, -mag, mag).astype(jnp.float32)


def rayleigh_bpsk_llr(key: jax.Array, bits: jax.Array, ebn0_db,
                      rate) -> jax.Array:
    """Coherent BPSK over i.i.d. Rayleigh fading: y = h*x + n with
    h ~ Rayleigh(E[h^2]=1) known at the receiver; LLR = 2*h*y/sigma^2.

    Per-bit-independent fading == the perfectly-interleaved (BICM) model,
    so no interleaver stage is needed or provided. Closed-form uncoded
    anchor: Pb = (1 - sqrt(g/(1+g)))/2 for g = Eb/N0
    (uncoded_rayleigh_ber below)."""
    from .awgn import bpsk, llr_from_channel, noise_sigma

    sigma = noise_sigma(ebn0_db, rate)
    kh, kn = jax.random.split(key)
    # |CN(0,1)| is Rayleigh with E[h^2]=1
    h = jnp.abs(jax.random.normal(kh, bits.shape, jnp.complex64))
    y = h * bpsk(bits) + sigma * jax.random.normal(kn, bits.shape, jnp.float32)
    return h * llr_from_channel(y, sigma)


def uncoded_rayleigh_ber(ebn0_db):
    """Closed-form uncoded coherent-BPSK BER over Rayleigh fading."""
    g = 10.0 ** (jnp.asarray(ebn0_db, jnp.float32) / 10.0)
    return 0.5 * (1.0 - jnp.sqrt(g / (1.0 + g)))


_ERASURE_KNOWN_LLR = 60.0


def bec_llr(key: jax.Array, bits: jax.Array, eps) -> jax.Array:
    """Binary erasure channel: each bit is erased (LLR 0) with probability
    eps, otherwise known exactly (LLR +/-60). BP decoders handle this
    directly — message magnitudes stay in {0, 60}-ish and BP degenerates
    to the classic peeling decoder's fixed point."""
    eps = jnp.asarray(eps, jnp.float32)
    erased = jax.random.bernoulli(key, eps, bits.shape)
    sign = 1.0 - 2.0 * bits.astype(jnp.float32)
    return jnp.where(erased, 0.0, sign * _ERASURE_KNOWN_LLR)


def hard_bpsk_awgn_llr(key: jax.Array, bits: jax.Array, ebn0_db,
                       rate) -> jax.Array:
    """Hard-decision BPSK over AWGN: the demodulator keeps only the sign.

    Equivalent to a BSC with p = Q(sqrt(2*R*Eb/N0)); the LLR magnitude is
    log((1-p)/p) at that implied crossover, so soft decoders consume it
    directly (all magnitudes equal => min-sum behaves as pure
    hard-decision message passing with channel votes)."""
    soft = awgn_llr(key, bits, ebn0_db, rate)
    ebn0 = 10.0 ** (jnp.asarray(ebn0_db, jnp.float32) / 10.0)
    p = q_function(jnp.sqrt(2.0 * rate * ebn0))
    mag = jnp.log1p(-p) - jnp.log(p)
    return jnp.sign(soft) * mag


# ---------------------------------------------------------------------------
# Channel-spec strings
# ---------------------------------------------------------------------------

_QAM_NAMES = {"qpsk": 4, "qam4": 4, "qam16": 16, "qam64": 64, "qam256": 256}


def parse_channel_spec(spec: str) -> dict:
    """'bpsk' | 'hard' | 'bsc:P' | 'qpsk' | 'qamM' -> build kwargs."""
    s = spec.strip().lower()
    if s in ("bpsk", "awgn", "bpsk-awgn"):
        return {"kind": "bpsk"}
    if s in ("hard", "bpsk-hard"):
        return {"kind": "hard"}
    if s in ("rayleigh", "bpsk-rayleigh"):
        return {"kind": "rayleigh"}
    if s.startswith("bsc:"):
        p = float(s[4:])
        if not 0.0 < p < 0.5:
            raise ValueError(f"BSC crossover must be in (0, 0.5), got {p}")
        return {"kind": "bsc", "p": p}
    if s.startswith("bec:"):
        eps = float(s[4:])
        if not 0.0 < eps < 1.0:
            raise ValueError(f"BEC erasure prob must be in (0, 1), got {eps}")
        return {"kind": "bec", "eps": eps}
    il = False
    if s.endswith(":il"):
        il, s = True, s[:-3]

    def _with_il(d):  # keep bare specs' dicts unchanged (il only if set)
        if il:
            d["il"] = True
        return d

    if s in _QAM_NAMES:
        return _with_il({"kind": "qam", "M": _QAM_NAMES[s]})
    if s in ("8psk", "psk8"):
        return _with_il({"kind": "psk", "M": 8})
    if s.startswith("apsk16") or s.startswith("apsk32"):
        M = int(s[4:6])
        parts = s[6:].split(":") if len(s) > 6 else []
        gs = []
        for p in parts:
            if not p:
                continue
            if p.startswith("g"):
                gs.append(float(p[1:]))
            elif p.startswith("r"):
                tab = APSK16_GAMMA if M == 16 else APSK32_GAMMA
                if p[1:] not in tab:
                    raise ValueError(
                        f"unknown APSK rate key {p!r}; one of "
                        f"{sorted(tab)}")
                g = tab[p[1:]]
                gs = list(g) if isinstance(g, tuple) else [g]
            else:
                raise ValueError(f"bad APSK option {p!r} in {spec!r}")
        if not gs:
            gs = [APSK16_GAMMA["34"]] if M == 16 else list(APSK32_GAMMA["34"])
        if M == 32 and len(gs) != 2:
            raise ValueError("apsk32 needs two ring ratios (':gG1:gG2')")
        gamma = gs[0] if M == 16 else (gs[0], gs[1])
        return _with_il({"kind": "apsk", "M": M, "gamma": gamma})
    raise ValueError(
        f"unknown channel spec {spec!r} — one of bpsk, hard, rayleigh, "
        f"bsc:P, bec:EPS, qpsk, 8psk, qam16, qam64, qam256, "
        f"apsk16[:rRATE|:gG][:il], apsk32[:rRATE|:gG:gG][:il]"
    )


def build_channel(code_spec, channel: str = "bpsk") -> Callable:
    """Channel function f(key, codeword_bits, ebn0_db) -> llr for a code.

    The default 'bpsk' path is chan.awgn.make_channel (honors the code's
    punctured/shortened positions). 'hard'/'bsc' apply the same masking.
    QAM channels are gated to codes without puncture/shorten structure:
    untransmitted bits inside a symbol would change the symbol grid."""
    kw = parse_channel_spec(channel)
    kind = kw["kind"]
    if kind == "bpsk":
        return make_channel(code_spec)

    punct = np.asarray(code_spec.punctured_cols, dtype=np.int64)
    short = np.asarray(code_spec.shortened_cols, dtype=np.int64)
    masked = len(punct) or len(short)
    rate = code_spec.rate

    if kind in ("qam", "psk", "apsk"):
        M = kw["M"]
        b = int(round(math.log2(M)))
        if masked:
            raise NotImplementedError(
                f"{channel!r} on {code_spec.name!r}: symbol mapping over "
                f"punctured/shortened codes is not supported (the symbol "
                f"grid would straddle untransmitted bits) — use 'bpsk' "
                f"or 'hard'"
            )
        if code_spec.n % b:
            raise ValueError(
                f"{channel!r} needs n divisible by {b} bits/symbol; "
                f"{code_spec.name!r} has n={code_spec.n}"
            )
        if kind == "qam":
            def tx(key, cw, ebn0_db):
                return qam_awgn_llr(key, cw, ebn0_db, rate, M)
        elif kind == "psk":
            def tx(key, cw, ebn0_db):
                return psk_awgn_llr(key, cw, ebn0_db, rate, M)
        else:
            gamma = kw["gamma"]

            def tx(key, cw, ebn0_db):
                return apsk_awgn_llr(key, cw, ebn0_db, rate, M, gamma)
        if kw.get("il"):
            def tx_il(key, cw, ebn0_db, _tx=tx):
                return deinterleave_llr(
                    _tx(key, interleave_tx(cw, b), ebn0_db), b)
            return tx_il
        return tx

    # hard-output channels share the soft path's mask discipline:
    # elementwise mask arithmetic, never scatter (see chan.awgn.make_channel)
    keep = np.ones(code_spec.n, dtype=np.float32)
    add = np.zeros(code_spec.n, dtype=np.float32)
    keep[punct] = 0.0
    keep[short] = 0.0
    add[short] = 60.0

    if kind == "bsc":
        p = kw["p"]

        def channel_bsc(key, cw, ebn0_db):
            del ebn0_db  # fixed crossover by construction
            llr = bsc_llr(key, cw, p)
            return llr * keep + add if masked else llr

        return channel_bsc

    if kind == "bec":
        eps = kw["eps"]

        def channel_bec(key, cw, ebn0_db):
            del ebn0_db  # fixed erasure probability by construction
            llr = bec_llr(key, cw, eps)
            return llr * keep + add if masked else llr

        return channel_bec

    if kind == "rayleigh":
        def channel_ray(key, cw, ebn0_db):
            llr = rayleigh_bpsk_llr(key, cw, ebn0_db, rate)
            return llr * keep + add if masked else llr

        return channel_ray

    def channel_hard(key, cw, ebn0_db):
        llr = hard_bpsk_awgn_llr(key, cw, ebn0_db, rate)
        return llr * keep + add if masked else llr

    return channel_hard
