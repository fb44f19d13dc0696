"""CRC attach/check as GF(2) matrix ops (5G NR transport-block realism).

5G NR attaches a CRC to every transport block / code block before LDPC
encoding (38.212 §5.1: CRC24A on the transport block, CRC24B on code
blocks, CRC16/11/6 for small blocks and polar control — the LDPC-relevant
ones are 24A/24B). The receiver validates decoded payloads with the CRC,
which (a) catches the rare undetected-error frames whose wrong codeword
still satisfies every parity check, and (b) is the production
early-termination/ARQ signal.

Batched form: CRC is linear over GF(2), so the whole computation is one
[r, k] 0/1 matrix applied as an integer matmul + mod 2 — batched over
frames, no bit-serial loop on device. The matrix is built host-side
by running the bit-serial reference CRC on unit vectors (and that
reference implementation doubles as the test oracle).

Polynomials (3GPP 38.212 §5.1, MSB-first, implicit leading x^r term):
  24A: x^24 + x^23 + x^18 + x^17 + x^14 + x^11 + x^10 + x^7 + x^6
       + x^5 + x^4 + x^3 + x + 1                        (0x864CFB)
  24B: x^24 + x^23 + x^6 + x^5 + x + 1                  (0x800063)
  16:  x^16 + x^12 + x^5 + 1                            (0x1021)
  11:  x^11 + x^10 + x^9 + x^5 + 1                      (0x621)
  6:   x^6 + x^5 + 1                                    (0x21)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

POLYNOMIALS = {
    "24a": (24, 0x864CFB),
    "24b": (24, 0x800063),
    "16": (16, 0x1021),
    "11": (11, 0x621),
    "6": (6, 0x21),
}


def crc_bits_ref(bits, name: str) -> np.ndarray:
    """Bit-serial reference CRC (the oracle): long division of
    bits(x) * x^r by g(x) over GF(2). bits: 1-D 0/1 array, MSB-first."""
    r, poly = POLYNOMIALS[name]
    reg = 0
    top = 1 << r
    for b in np.asarray(bits, dtype=np.int64):
        reg = (reg << 1) | int(b)
        if reg & top:
            reg ^= top | poly
    for _ in range(r):
        reg <<= 1
        if reg & top:
            reg ^= top | poly
    return np.asarray([(reg >> (r - 1 - i)) & 1 for i in range(r)],
                      dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def crc_matrix(name: str, k: int) -> np.ndarray:
    """[r, k] GF(2) matrix M with crc(m) = M @ m mod 2 (CRC is linear).

    Built column-by-column from the reference CRC of unit vectors, but
    incrementally: the CRC register state after j leading zeros is
    shift-invariant, so each column is the reference CRC of a length-
    (k-j) unit-impulse prefix — computed in O(k*r) total via the
    observation crc(e_j in length k) = crc(e_0 in length k-j)."""
    r, _ = POLYNOMIALS[name]
    M = np.zeros((r, k), dtype=np.uint8)
    # crc of the impulse at position j equals the impulse at position 0
    # of a message of length k - j; compute all suffix lengths in one
    # backward register recursion
    reg_bits = crc_bits_ref(np.asarray([1], dtype=np.int64), name)
    M[:, k - 1] = reg_bits
    poly = POLYNOMIALS[name][1]
    reg = 0
    for i in range(r):
        reg = (reg << 1) | int(reg_bits[i])
    top = 1 << r
    for j in range(k - 2, -1, -1):
        reg <<= 1  # one more trailing zero in the message
        if reg & top:
            reg ^= top | poly
        M[:, j] = [(reg >> (r - 1 - i)) & 1 for i in range(r)]
    return M


def make_crc(name: str, k: int):
    """(attach, check) jnp functions for k-bit payloads.

    attach: [B, k] -> [B, k+r] (payload ++ CRC); check: [B, k+r] -> [B]
    bool. Integer matmul + mod 2; callers that jit at large k pass the
    matrix as a jit argument (a closed-over array is embedded as a
    constant in the lowered module); these helpers close over it for
    interactive use."""
    r, _ = POLYNOMIALS[name]
    M = jnp.asarray(crc_matrix(name, k).T, jnp.int32)  # [k, r]

    def attach(msg):
        crc = (msg.astype(jnp.int32) @ M) % 2
        return jnp.concatenate([msg, crc.astype(msg.dtype)], axis=-1)

    def check(msg_crc):
        crc = (msg_crc[..., :k].astype(jnp.int32) @ M) % 2
        return jnp.all(crc.astype(jnp.uint8) == msg_crc[..., k:], axis=-1)

    return attach, check


def with_crc(ecc, name: str = "24b"):
    """Wrap an ECC facade (ecc.build_ecc product) so messages carry a CRC:
    the payload shrinks by r bits, encode attaches, decode additionally
    validates — DecodeResult.ok becomes (syndrome ok) AND (CRC ok),
    catching undetected-error frames a parity check alone would pass."""
    import dataclasses as _dc

    from ..decode.types import DecodeResult

    r, _ = POLYNOMIALS[name]
    k_payload = ecc.k - r
    if k_payload <= 0:
        raise ValueError(f"code k={ecc.k} too small for CRC{name}")
    attach, check = make_crc(name, k_payload)

    wrapped = _dc.replace(ecc) if _dc.is_dataclass(ecc) else ecc
    inner_decode = ecc.decode
    inner_encode = ecc.encode
    inner_extract = ecc.extract_message

    def encode(payload):
        return inner_encode(attach(payload))

    def decode(llr):
        res = inner_decode(llr)
        msg_crc = inner_extract(res.bits)
        return DecodeResult(
            bits=res.bits, ok=res.ok & check(msg_crc),
            iterations=res.iterations,
        )

    def extract_payload(codeword_bits):
        return inner_extract(codeword_bits)[..., :k_payload]

    wrapped.encode = encode
    wrapped.decode = decode
    wrapped.extract_payload = extract_payload
    wrapped.k_payload = k_payload
    return wrapped
