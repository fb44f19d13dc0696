"""Flooding BP with VN accumulation as incidence-matrix matmuls.

A reformulation of decode/xla/flooding.py: the variable-node accumulate (a
segmented sum over edges) and the edge re-expansion (a gather) become two
dense 0/1 incidence-matrix matmuls — no gather/scatter ops anywhere in the
hot loop. The gather tier (decode/xla/flooding.py) is the default route and
this form's oracle; which of the two is faster on small codes is measured
by chip_smoke.py (PERF.md).

  total = llr + S @ C_flat         S: [n, m*dc]  (edge-of-var incidence)
  V_flat = S^T @ total - C_flat    (broadcast totals back to edges)
  parity = (H @ hard) mod 2        (syndrome as matmul)

Memory is O(n * E) for S, so this tier is gated to n*E <= ~2^28 (n~4k for
(3,6) codes); the long-block families (DVB-S2, 5G NR) decode via their QC
structure (decode/xla/layered.py) instead.

Bit-compatibility: identical message schedule and CN op as flooding.py; the
only arithmetic difference is summation order in the VN accumulate (matmul
vs masked tree-sum), i.e. f32 rounding-level differences only. That holds
because the soft products run at Precision.HIGHEST: at the default
precision a GPU rounds f32 operands to TF32 (10-bit mantissa), which
truncates the soft messages. The syndrome product multiplies 0/1 values,
exact at any precision.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...graph.compile import CompiledGraph
from ..types import DecodeResult


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IncidenceOperators:
    """Dense 0/1 operators derived from a CompiledGraph."""

    S: jax.Array  # f32 [n, m*dc]   S[v, e] = 1 iff edge e touches variable v
    H: jax.Array  # f32 [m, n]      dense parity-check matrix

    @staticmethod
    def build(graph: CompiledGraph) -> "IncidenceOperators":
        m, n, dc = graph.m, graph.n, graph.dc_max
        cn_vn = np.asarray(graph.cn_vn)
        cn_mask = np.asarray(graph.cn_mask)
        S = np.zeros((n, m * dc), dtype=np.float32)
        H = np.zeros((m, n), dtype=np.float32)
        for i in range(m):
            for j in range(dc):
                if cn_mask[i, j]:
                    v = cn_vn[i, j]
                    S[v, i * dc + j] = 1.0
                    H[i, v] = 1.0
        return IncidenceOperators(S=jnp.asarray(S), H=jnp.asarray(H))


def _mm(A, x, precision=jax.lax.Precision.HIGHEST):
    return jax.lax.dot_general(
        A, x, dimension_numbers=(((1,), (0,)), ((), ())),
        precision=precision, preferred_element_type=jnp.float32,
    )


def decode_flooding_mm(
    graph: CompiledGraph,
    ops: IncidenceOperators,
    llr: jax.Array,
    *,
    cn_op,
    max_iters: int = 25,
    early_term: bool = True,
) -> DecodeResult:
    """Decode a batch. llr: float32 [B, n]. Returns DecodeResult ([B, n])."""
    llr_t = llr.T.astype(jnp.float32)  # [n, B]
    B = llr_t.shape[1]
    m, dc = graph.m, graph.dc_max
    mask3 = graph.cn_mask[:, :, None]
    St = ops.S.T

    def syndrome_fail(total):
        hard = (total < 0).astype(jnp.float32)  # [n, B]
        cnt = _mm(ops.H, hard, jax.lax.Precision.DEFAULT)  # 0/1: exact
        par = cnt - 2.0 * jnp.floor(cnt * 0.5)  # cnt mod 2, exact in f32
        return jnp.any(par > 0.5, axis=0)

    V0 = jnp.where(mask3, _mm(St, llr_t).reshape(m, dc, B), 0.0)
    total0 = llr_t
    done0 = ~syndrome_fail(total0)
    # see flooding.py: keep the carry's varying-axes type tied to the data
    iters0 = (llr_t[0] * 0).astype(jnp.int32)

    def body(state):
        V, total, done, iters = state
        C = cn_op(V, mask3)  # [m, dc, B]
        Cflat = C.reshape(m * dc, B)
        new_total = llr_t + _mm(ops.S, Cflat)
        newV = jnp.where(mask3, _mm(St, new_total).reshape(m, dc, B) - C, 0.0)
        fail = syndrome_fail(new_total)
        V = jnp.where(done[None, None, :], V, newV)
        total = jnp.where(done[None, :], total, new_total)
        iters = jnp.where(done, iters, iters + 1)
        done = done | ~fail
        return V, total, done, iters

    if early_term:
        state = (V0, total0, done0, iters0)

        def cond(state):
            _, _, done, iters = state
            return (iters.max() < max_iters) & ~jnp.all(done)

        _, total, done, iters = jax.lax.while_loop(cond, body, state)
    else:
        # pure fixed-iteration mode (benchmark semantics): no
        # per-iteration syndrome, no freeze; truthful syndrome over the
        # emitted bits at the end
        def pure_body(_, s):
            V, total = s
            C = cn_op(V, mask3)
            Cflat = C.reshape(m * dc, B)
            new_total = llr_t + _mm(ops.S, Cflat)
            newV = jnp.where(
                mask3, _mm(St, new_total).reshape(m, dc, B) - C, 0.0
            )
            return newV, new_total

        _, total = jax.lax.fori_loop(0, max_iters, pure_body, (V0, total0))
        done = ~syndrome_fail(total)
        iters = iters0 + max_iters

    bits = (total < 0).astype(jnp.uint8).T
    return DecodeResult(bits=bits, ok=done, iterations=iters)


# Gate: S is [n, m*dc] f32; cap its footprint at ~1 GB.
MAX_DENSE_CELLS = 1 << 28


def supports(graph: CompiledGraph) -> bool:
    return graph.n * graph.m * graph.dc_max <= MAX_DENSE_CELLS
