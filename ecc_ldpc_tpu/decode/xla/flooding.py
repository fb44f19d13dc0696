"""Flooding-schedule BP decode, pure jnp (SURVEY.md §2.2 C12/C13).

The functional equivalent of the reference's MATLAB-ported flooding decoder
(SURVEY.md §3.1 hot loop): per iteration, every check node fires, then every
variable node accumulates; hard decisions are syndrome-checked for early
termination. Formulation:

  - messages live in the padded check view [m, dc, B], batch on lanes;
  - the VN accumulate is a row-gather of check messages into the padded
    variable view [n, dv, B] followed by a masked sum — no scatter anywhere;
  - early termination under jit is a per-codeword done mask that freezes
    converged lanes, plus a batch-wide while_loop exit when all lanes are
    done (no data-dependent shapes; SURVEY.md §7.2 item 3).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ...graph.compile import CompiledGraph
from ..types import DecodeResult


def _syndrome_fail(graph: CompiledGraph, hard_bits):
    """hard_bits [n, B] int32 -> fail [B] bool (True if any check unsatisfied)."""
    at_checks = hard_bits[graph.cn_vn]  # [m, dc, B]
    par = jnp.sum(jnp.where(graph.cn_mask[:, :, None], at_checks, 0), axis=1) & 1
    return jnp.any(par != 0, axis=0)


def decode_flooding(
    graph: CompiledGraph,
    llr: jax.Array,
    *,
    cn_op,
    max_iters: int = 25,
    early_term: bool = True,
) -> DecodeResult:
    """Decode a batch. llr: float32 [B, n]. Returns DecodeResult ([B, n])."""
    llr_t = llr.T.astype(jnp.float32)  # [n, B] — batch on lanes
    B = llr_t.shape[1]
    mask3 = graph.cn_mask[:, :, None]

    # Iteration state.
    V0 = jnp.where(mask3, llr_t[graph.cn_vn], 0.0)  # v->c msgs [m, dc, B]
    total0 = llr_t
    hard0 = (total0 < 0).astype(jnp.int32)
    done0 = ~_syndrome_fail(graph, hard0)
    # derive from llr (not a fresh constant) so the carry picks up the same
    # varying-manual-axes type as the data when run inside shard_map
    iters0 = (llr_t[0] * 0).astype(jnp.int32)

    def body(state):
        V, total, done, iters = state
        C = cn_op(V, mask3)  # [m, dc, B]
        # VN accumulate: gather check messages into the variable view.
        Cv = C.reshape(graph.m * graph.dc_max, B)[graph.vn_edge]  # [n, dv, B]
        new_total = llr_t + jnp.sum(
            jnp.where(graph.vn_mask[:, :, None], Cv, 0.0), axis=1
        )
        newV = jnp.where(mask3, new_total[graph.cn_vn] - C, 0.0)
        hard = (new_total < 0).astype(jnp.int32)
        fail = _syndrome_fail(graph, hard)
        # Freeze lanes that were already done before this iteration.
        keep = done[None, None, :]
        V = jnp.where(keep, V, newV)
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
        # PURE fixed-iteration mode (the benchmark configuration: exactly
        # max_iters flooding iterations, BASELINE.json:2) — no
        # per-iteration syndrome, no freeze; truthful syndrome at the
        # end. Same semantics as every other tier's noet path
        # (flooding_qc, dense_mm, layered).
        def pure_body(_, s):
            V, total = s
            C = cn_op(V, mask3)
            Cv = C.reshape(graph.m * graph.dc_max, B)[graph.vn_edge]
            new_total = llr_t + jnp.sum(
                jnp.where(graph.vn_mask[:, :, None], Cv, 0.0), axis=1
            )
            newV = jnp.where(mask3, new_total[graph.cn_vn] - C, 0.0)
            return newV, new_total

        _, total = jax.lax.fori_loop(0, max_iters, pure_body, (V0, total0))
        done = ~_syndrome_fail(graph, (total < 0).astype(jnp.int32))
        iters = iters0 + max_iters

    bits = (total < 0).astype(jnp.uint8).T  # [B, n]
    return DecodeResult(bits=bits, ok=done, iterations=iters)
