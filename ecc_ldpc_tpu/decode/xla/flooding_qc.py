"""Flooding BP over QC graphs, pure jnp — roll-based decoders for min-sum,
exact sum-product (tanh rule), and minstar (SURVEY.md §2.2 C12/C13 in QC
form).

Same algorithms as decode/xla/flooding.py on the expanded graph, but with
the QC layout's arithmetic order (per-row reductions in degree-group
order, posterior accumulation by rolled check messages): rolls and
elementwise math only, no gathers — this is how flooding runs on the
device for the large QC families. BER curves coincide with the gather-form decoders
statistically (summation order differs).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ...graph.qc import QCGraph
from ..types import DecodeResult

_MAG_CAP = 1e12
# tanh(x/2) saturates to 1.0 in f32 near x=18; clip keeps arctanh finite.
_TANH_CLIP = 1.0 - 1e-7


def _cn_minsum_qc(V, alpha: float, beta: float):
    """Leave-one-out two-min CN update over axis 0 of [d, Z, B]."""
    neg = (V < 0).astype(jnp.float32)
    cnt = jnp.sum(neg, axis=0, keepdims=True)
    sgn_prod = 1.0 - 2.0 * (cnt - 2.0 * jnp.floor(cnt * 0.5))
    a = jnp.abs(V)
    min1 = jnp.min(a, axis=0, keepdims=True)
    is_min = a == min1
    count_min = jnp.sum(is_min.astype(jnp.float32), axis=0, keepdims=True)
    min2 = jnp.min(jnp.where(is_min, jnp.inf, a), axis=0, keepdims=True)
    mag = jnp.where(is_min & (count_min == 1.0), min2, min1)
    mag = jnp.minimum(mag, _MAG_CAP)
    mag = jnp.maximum(alpha * mag - beta, 0.0)
    sv = jnp.where(V < 0, -1.0, 1.0)
    return (sgn_prod * sv) * mag


def _cn_spa_qc(V, alpha: float, beta: float):
    """Exact sum-product (tanh rule) over axis 0, leave-one-out via
    log|tanh| sums — the roll-form twin of cn_ops.cn_spa."""
    a = jnp.abs(V)
    lt = jnp.log(jnp.tanh(jnp.clip(a, 1e-10, 40.0) * 0.5))
    loo = jnp.sum(lt, axis=0, keepdims=True) - lt
    t = jnp.clip(jnp.exp(loo), None, _TANH_CLIP)
    mag = 2.0 * jnp.arctanh(t)
    neg = (V < 0).astype(jnp.float32)
    cnt = jnp.sum(neg, axis=0, keepdims=True)
    sgn_prod = 1.0 - 2.0 * (cnt - 2.0 * jnp.floor(cnt * 0.5))
    sv = jnp.where(V < 0, -1.0, 1.0)
    return (sgn_prod * sv) * mag


def _boxplus(x, y):
    mag = jnp.minimum(jnp.abs(x), jnp.abs(y))
    sgn = jnp.where((x < 0) ^ (y < 0), -1.0, 1.0)
    corr = jnp.log1p(jnp.exp(-jnp.abs(x + y))) - jnp.log1p(
        jnp.exp(-jnp.abs(x - y))
    )
    return sgn * mag + corr


def _cn_minstar_qc(V, alpha: float, beta: float):
    """Exact sum-product via box-plus forward/backward scans over axis 0
    — the roll-form twin of cn_ops.cn_minstar."""
    d = V.shape[0]
    big = 1e9  # identity element: boxplus(big, x) ~= x
    fwd = [V[0]]
    for j in range(1, d):
        fwd.append(_boxplus(fwd[-1], V[j]))
    bwd = [V[d - 1]]
    for j in range(d - 2, -1, -1):
        bwd.insert(0, _boxplus(bwd[0], V[j]))
    outs = []
    for j in range(d):
        if j == 0:
            outs.append(bwd[1] if d > 1 else jnp.full_like(V[0], big))
        elif j == d - 1:
            outs.append(fwd[d - 2])
        else:
            outs.append(_boxplus(fwd[j - 1], bwd[j + 1]))
    return jnp.clip(jnp.stack(outs), -_MAG_CAP, _MAG_CAP)


_CN_QC = {"minsum": _cn_minsum_qc, "spa": _cn_spa_qc, "minstar": _cn_minstar_qc}


def decode_flooding_qc(
    graph: QCGraph,
    llr: jax.Array,
    *,
    kind: str = "minsum",
    alpha: float = 1.0,
    beta: float = 0.0,
    max_iters: int = 25,
    early_term: bool = True,
    constrain=None,
) -> DecodeResult:
    """llr: f32 [B, n] -> DecodeResult. kind: 'minsum' | 'spa' | 'minstar'.

    constrain: optional fn applied to every [*, Z, B] decode-state array
    (llr/total/C) — dist.graph_parallel passes a sharding constraint that
    partitions the circulant axis over a 'graph' mesh axis, turning this
    decoder into the edge-sharded (sequence-parallel analog) tier: the
    program is rolls + elementwise math + reductions, so GSPMD inserts
    the boundary collectives itself and the arithmetic is unchanged
    (bit-identical to the unsharded decode).
    """
    cn_op = _CN_QC[kind]
    B = llr.shape[0]
    Z, nb = graph.Z, graph.nb
    if constrain is None:
        constrain = lambda x: x  # noqa: E731
    llr3 = constrain(llr.T.astype(jnp.float32).reshape(nb, Z, B))
    total0 = llr3
    # zeros_like keeps the data's varying mesh axes under shard_map
    C0 = constrain(jnp.zeros_like(llr3, shape=(graph.num_block_edges, Z, B)))

    rows = [graph.layer_edges(i) for i in graph.layer_order]

    def syndrome_fail(total):
        fail = jnp.zeros((B,), jnp.float32)
        for edges in rows:
            acc = 0.0
            for e, col, s in edges:
                acc = acc + (graph.to_check(total[col], s) < 0).astype(jnp.float32)
            par = acc - 2.0 * jnp.floor(acc * 0.5)
            fail = jnp.maximum(fail, jnp.max(par, axis=0))
        return fail > 0.5

    def sweep(total, C, track=True):
        """One flooding iteration: CN from fixed totals, then posterior
        rebuild. Returns (new_total, newC, onfly_fail)."""
        acc = llr3
        newC = C
        fail = jnp.zeros((B,), jnp.float32)
        for edges in rows:
            rolled = [graph.to_check(total[col], s) for e, col, s in edges]
            if track:
                hacc = 0.0
                for r in rolled:
                    hacc = hacc + (r < 0).astype(jnp.float32)
                par = hacc - 2.0 * jnp.floor(hacc * 0.5)
                fail = jnp.maximum(fail, jnp.max(par, axis=0))
            V = jnp.stack([r - C[e] for r, (e, col, s) in zip(rolled, edges)])
            Cnew = cn_op(V, alpha, beta)
            for j, (e, col, s) in enumerate(edges):
                acc = acc.at[col].add(graph.to_var(Cnew[j], s))
                newC = newC.at[e].set(Cnew[j])
        return constrain(acc), constrain(newC), fail > 0.5

    if early_term:
        done0 = ~syndrome_fail(total0)
        iters0 = (total0[0, 0] * 0).astype(jnp.int32)

        def body(state):
            total, C, done, iters = state
            new_total, newC, fail = sweep(total, C)
            # `fail` is the parity of the PRE-sweep posteriors (flooding
            # reads stale totals all sweep), so a frame that passes must
            # FREEZE THE PRE-SWEEP STATE — advancing it one more sweep
            # discards the verified state and was a measured detected-
            # failure floor (the extra sweep can flip a bit out of the
            # codeword; fixed-iteration mode decoded those frames).
            done_new = done | ~fail
            total = jnp.where(done_new[None, None, :], total, new_total)
            C = jnp.where(done[None, None, :], C, newC)
            iters = jnp.where(done_new, iters, iters + 1)
            return total, C, done_new, iters

        def cond(state):
            _, _, done, iters = state
            return (iters.max() < max_iters) & ~jnp.all(done)

        total, _, done, iters = jax.lax.while_loop(
            cond, body, (total0, C0, done0, iters0)
        )
    else:
        def pure_body(_, st):
            total, C = st
            total, C, _ = sweep(total, C, track=False)
            return total, C

        total, _ = jax.lax.fori_loop(0, max_iters, pure_body, (total0, C0))
        iters = jnp.full((B,), max_iters, jnp.int32) + (total0[0, 0] * 0).astype(jnp.int32)

    bits = (total.reshape(nb * Z, B) < 0).astype(jnp.uint8).T
    ok = ~syndrome_fail(total)
    return DecodeResult(bits=bits, ok=ok, iterations=iters)
