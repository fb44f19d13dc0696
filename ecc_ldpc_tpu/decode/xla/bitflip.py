"""Hard-decision bit-flipping decoders: majority BF and GDBF.

The reference's decoder ladder is soft-decision BP (SURVEY.md §2.1 R6-R8);
this module adds the classic hard-decision tier below it — the decoders a
user reaches for on hard-output channels (chan/modem.py 'hard'/'bsc:P')
or when per-iteration cost must be minimal:

  * 'bitflip' — parallel majority bit flipping (Gallager's BF): each
    iteration flips every variable whose unsatisfied-check count exceeds
    half its degree. Consumes only LLR signs.
  * 'gdbf' — multi-bit gradient-descent bit flipping (Wadayama et al.'s
    objective): the inversion metric E_k = w*x~_k*y_k + sum_{i in N(k)}
    s~_i combines the channel agreement term with bipolar check
    satisfactions; all variables with E_k < theta flip. The channel
    weight w auto-normalizes per frame (w = 1/mean|llr|) so the metric
    matches the unit-energy-BPSK formulation no matter the LLR scale the
    channel front produced.

Two forms, same split as the BP tiers:
  * QC graphs: circulant rolls + elementwise math over [nb, Z, B] slabs
    (zero gathers), any code size.
  * Unstructured graphs: syndrome and unsatisfied-counts as dense
    incidence matmuls (H @ x, H^T @ s), gated to small codes like
    decode/xla/dense_mm.py.

Early termination is exact by construction: the state IS the hard
decision, so a zero syndrome of the current bits is the true codeword
condition (no layered-snapshot subtlety — compare docs/DESIGN.md §4).
Both forms share iteration/freeze semantics; the majority variant is
bit-identical across forms (integer-valued parities/counts are exact in
f32), GDBF agrees statistically (its metric mixes real-valued channel
terms, so summation order can move near-threshold flips).

Applicability note (measured): bit flipping suits regular/high-column-
degree codes (802.11n at 4-5 dB hard-decision works well). On codes
dominated by degree-2 variables — the DVB-S2 IRA staircase — both
variants stall against the parity chain and only converge at very high
SNR (~9 dB on dvbs2/16200 r=1/2 hard channel); use BP tiers there.
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ...graph.compile import CompiledGraph
from ...graph.qc import QCGraph
from ..types import DecodeResult


def _mod2(x):
    return x - 2.0 * jnp.floor(x * 0.5)


# ---------------------------------------------------------------------------
# QC roll form
# ---------------------------------------------------------------------------


def decode_bitflip_qc(
    graph: QCGraph,
    llr: jax.Array,
    *,
    variant: str = "maj",
    theta: float = 0.0,
    max_iters: int = 50,
    early_term: bool = True,
) -> DecodeResult:
    """llr f32 [B, n] -> DecodeResult. variant: 'maj' | 'gdbf'."""
    B = llr.shape[0]
    Z, nb = graph.Z, graph.nb
    llr3 = llr.T.astype(jnp.float32).reshape(nb, Z, B)
    rows = [graph.layer_edges(i) for i in graph.layer_order]
    col_deg = np.zeros(nb, np.int32)
    for edges in rows:
        for e, col, s in edges:
            col_deg[col] += 1

    x0 = (llr3 < 0).astype(jnp.float32)  # current hard bits, {0,1} slabs

    def parities(x):
        out = []
        for edges in rows:
            acc = 0.0
            for e, col, s in edges:
                acc = acc + graph.to_check(x[col], s)
            out.append(_mod2(acc))  # [Z, B]
        return out

    def syndrome_fail(x):
        fail = jnp.zeros((B,), jnp.float32)
        for par in parities(x):
            fail = jnp.maximum(fail, jnp.max(par, axis=0))
        return fail > 0.5

    if variant == "gdbf":
        # per-frame channel weight: metric in unit-energy-BPSK units
        w = 1.0 / jnp.maximum(jnp.mean(jnp.abs(llr3), axis=(0, 1)), 1e-9)

    def sweep(x):
        par = parities(x)
        if variant == "maj":
            cnt = [jnp.zeros((Z, B), jnp.float32) for _ in range(nb)]
            for ri, edges in enumerate(rows):
                for e, col, s in edges:
                    cnt[col] = cnt[col] + graph.to_var(par[ri], s)
            flips = [
                (2.0 * cnt[j] > float(col_deg[j])).astype(jnp.float32)
                if col_deg[j] else jnp.zeros((Z, B), jnp.float32)
                for j in range(nb)
            ]
        elif variant == "gdbf":
            xb = 1.0 - 2.0 * x  # bipolar estimate
            E = [xb[j] * (w * llr3[j]) for j in range(nb)]
            for ri, edges in enumerate(rows):
                sat = 1.0 - 2.0 * par[ri]
                for e, col, s in edges:
                    E[col] = E[col] + graph.to_var(sat, s)
            flips = [(E[j] < theta).astype(jnp.float32) for j in range(nb)]
        else:
            raise KeyError(f"unknown bit-flip variant {variant!r}")
        return jnp.abs(x - jnp.stack(flips))  # XOR on {0,1} floats

    done0 = (~syndrome_fail(x0) if early_term
             else jnp.zeros_like(x0[0, 0], dtype=bool))
    iters0 = (x0[0, 0] * 0).astype(jnp.int32)

    def body(state):
        x, done, iters = state
        newx = sweep(x)
        x = jnp.where(done[None, None, :], x, newx)
        iters = jnp.where(done, iters, iters + 1)
        done = done | ~syndrome_fail(x)
        return x, done, iters

    if early_term:
        def cond(state):
            _, done, iters = state
            return (iters.max() < max_iters) & ~jnp.all(done)

        x, done, iters = jax.lax.while_loop(cond, body, (x0, done0, iters0))
        ok = done
    else:
        x, _, iters = jax.lax.fori_loop(
            0, max_iters, lambda _, s: body(s), (x0, done0, iters0)
        )
        ok = ~syndrome_fail(x)

    bits = x.reshape(nb * Z, B).T.astype(jnp.uint8)
    return DecodeResult(bits=bits, ok=ok, iterations=iters)


# ---------------------------------------------------------------------------
# Incidence-matmul form (unstructured codes; gated like dense_mm)
# ---------------------------------------------------------------------------


def decode_bitflip_mm(
    graph: CompiledGraph,
    H: jax.Array,
    llr: jax.Array,
    *,
    variant: str = "maj",
    theta: float = 0.0,
    max_iters: int = 50,
    early_term: bool = True,
) -> DecodeResult:
    """H: dense f32 [m, n] parity-check operator (IncidenceOperators.H)."""
    llr_t = llr.T.astype(jnp.float32)  # [n, B]
    B = llr_t.shape[1]
    deg = jnp.sum(graph.vn_mask.astype(jnp.float32), axis=1)[:, None]

    # every operand is 0/1 or +-1 and every sum a small integer, so the
    # default precision (TF32 on a GPU) is exact here
    mm = functools.partial(
        jax.lax.dot_general,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )

    def parity(x):
        return _mod2(mm(H, x))  # [m, B]

    def syndrome_fail(x):
        return jnp.any(parity(x) > 0.5, axis=0)

    if variant == "gdbf":
        w = 1.0 / jnp.maximum(jnp.mean(jnp.abs(llr_t), axis=0), 1e-9)

    def sweep(x):
        par = parity(x)
        if variant == "maj":
            cnt = mm(H.T, par)  # unsatisfied-check count per variable
            flip = (2.0 * cnt > deg).astype(jnp.float32)
        elif variant == "gdbf":
            xb = 1.0 - 2.0 * x
            E = xb * (w * llr_t) + mm(H.T, 1.0 - 2.0 * par)
            flip = (E < theta).astype(jnp.float32)
        else:
            raise KeyError(f"unknown bit-flip variant {variant!r}")
        return jnp.abs(x - flip)

    x0 = (llr_t < 0).astype(jnp.float32)
    done0 = (~syndrome_fail(x0) if early_term
             else jnp.zeros_like(x0[0], dtype=bool))
    iters0 = (x0[0] * 0).astype(jnp.int32)

    def body(state):
        x, done, iters = state
        newx = sweep(x)
        x = jnp.where(done[None, :], x, newx)
        iters = jnp.where(done, iters, iters + 1)
        done = done | ~syndrome_fail(x)
        return x, done, iters

    if early_term:
        def cond(state):
            _, done, iters = state
            return (iters.max() < max_iters) & ~jnp.all(done)

        x, done, iters = jax.lax.while_loop(cond, body, (x0, done0, iters0))
        ok = done
    else:
        x, _, iters = jax.lax.fori_loop(
            0, max_iters, lambda _, s: body(s), (x0, done0, iters0)
        )
        ok = ~syndrome_fail(x)

    return DecodeResult(bits=x.T.astype(jnp.uint8), ok=ok, iterations=iters)


def make_bitflip_decoder(
    graph,
    *,
    variant: str = "maj",
    theta: float = 0.0,
    max_iters: int = 50,
    early_term: bool = True,
    jit: bool = True,
) -> Callable[[jax.Array], DecodeResult]:
    """Build decode(llr[B, n]) -> DecodeResult on either graph form."""
    if isinstance(graph, QCGraph):
        def decode(llr):
            return decode_bitflip_qc(
                graph, llr, variant=variant, theta=theta,
                max_iters=max_iters, early_term=early_term,
            )

        return jax.jit(decode) if jit else decode

    from .dense_mm import IncidenceOperators, supports

    if not supports(graph):
        raise NotImplementedError(
            f"bit-flip on an unstructured graph needs the dense incidence "
            f"operator (n={graph.n} too large) — compile QC codes with "
            f"compile_qc_graph for the roll form"
        )
    H = IncidenceOperators.build(graph).H

    # H as a jit ARGUMENT, not a closure capture (a closed-over array is
    # embedded as a constant in the lowered module)
    def decode_impl(H, llr):
        return decode_bitflip_mm(
            graph, H, llr, variant=variant, theta=theta,
            max_iters=max_iters, early_term=early_term,
        )

    impl = jax.jit(decode_impl) if jit else decode_impl
    return lambda llr: impl(H, llr)
