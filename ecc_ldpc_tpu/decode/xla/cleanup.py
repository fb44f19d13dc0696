"""Post-decode bit-flip cleanup for QC graphs (roll form, gather-free).

The deep-FER tail of min-sum/BP on these codes is dominated by frames
stuck with one (sometimes two) wrong bits whose neighborhood checks are
all unsatisfied — measured on dvbs2/64800 at 1.35-1.8 dB
(curves/dvbs2_64800_12_deep_tpu.json; every deep failure was a
1-3-bit frame). The classic hardware remedy is a Gallager-B-style
cleanup after BP: flip every variable ALL of whose checks are
unsatisfied (for an isolated wrong bit that is exactly the stuck bit;
a correct bit can only have all checks unsatisfied if every neighbor
check holds another error, which the round then also repairs or leaves
detected). Pure rolls + elementwise math over [nb, Z, B] slabs — same
layout as the decoders, a couple of block-edge passes per round.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ...graph.qc import QCGraph


def bitflip_cleanup(graph: QCGraph, bits: jax.Array, rounds: int = 2):
    """bits [B, n] uint8 -> (bits, ok [B] bool). Flips variables whose
    unsatisfied-check count equals their degree, `rounds` times, then
    reports the true syndrome."""
    B = bits.shape[0]
    Z, nb, mb = graph.Z, graph.nb, graph.mb
    edges = [(int(r), int(c), int(s)) for r, c, s in
             zip(graph.be_row_np, graph.be_col_np, graph.be_shift_np)]
    col_deg = np.zeros(nb, np.int32)
    for _, c, _ in edges:
        col_deg[c] += 1

    x = bits.T.astype(jnp.float32).reshape(nb, Z, B)

    def one_round(x):
        # per block-row parity slabs (check-aligned)
        par = []
        for i in range(mb):
            acc = 0.0
            for r, c, s in edges:
                if r == i:
                    acc = acc + graph.to_check(x[c], s)
            par.append(acc - 2.0 * jnp.floor(acc * 0.5))  # [Z, B]
        # per-variable unsatisfied-neighbor count (variable-aligned)
        cnt = [jnp.zeros((Z, B), jnp.float32) for _ in range(nb)]
        for r, c, s in edges:
            cnt[c] = cnt[c] + graph.to_var(par[r], s)
        newx = []
        for j in range(nb):
            if col_deg[j] >= 2:
                flip = (cnt[j] >= float(col_deg[j])).astype(jnp.float32)
            else:
                flip = 0.0  # degree-1 (e.g. NR extension parity): ambiguous
            newx.append(jnp.abs(x[j] - flip))  # XOR on {0,1} floats
        return jnp.stack(newx)

    for _ in range(rounds):
        x = one_round(x)
    # true syndrome of the final bits
    fail = jnp.zeros((B,), jnp.float32)
    for i in range(mb):
        acc = 0.0
        for r, c, s in edges:
            if r == i:
                acc = acc + graph.to_check(x[c], s)
        par = acc - 2.0 * jnp.floor(acc * 0.5)
        fail = jnp.maximum(fail, jnp.max(par, axis=0))
    out_bits = x.reshape(nb * Z, B).T.astype(jnp.uint8)
    return out_bits, fail < 0.5


def with_cleanup(decode_fn, graph: QCGraph, rounds: int = 2):
    """Wrap decode(llr)->DecodeResult with a cleanup pass: frames the
    decoder already validated are passed through untouched (flip masks
    are empty when no check fails), failed frames get the repair."""
    from ..types import DecodeResult

    def decode(llr):
        res = decode_fn(llr)
        bits, ok = bitflip_cleanup(graph, res.bits, rounds=rounds)
        return DecodeResult(bits=bits, ok=ok, iterations=res.iterations)

    return decode
