"""Layered (row-block) min-sum decoding for QC codes, pure jnp
(SURVEY.md §2.2 C14; config 3, BASELINE.json:9).

The layered schedule sweeps block-rows sequentially within an iteration,
using freshly-updated posteriors immediately — it converges in roughly half
the iterations of flooding, which is why the standards families (802.11n /
WiMAX / DVB-S2 / 5G NR) are decoded this way. The reference's QC "arraylet"
tier (SURVEY.md §2.1 R8) is its structured analog.

Form: message slabs are [Z, batch] (batch last); circulant addressing is
jnp.roll along the Z axis with *static* shifts unrolled at trace time from
the base matrix — zero gathers. This tier is both the oracle and the GPU
path; tests/ref_decoders.py pins it bit for bit on the CPU.

State per decode: total [nb, Z, B] posteriors, C [BE, Z, B] check-aligned
check-to-variable messages.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ...graph.qc import QCGraph
from ..types import DecodeResult

_MAG_CAP = 1e12


def quantize(x, bits: int, step: float):
    """Symmetric uniform mid-tread quantizer: round(x/step) clipped to
    +/-(2^(bits-1)-1) levels — the fixed-point message grid of a hardware
    decoder. Keeps -0.0's sign (relevant under sign_mode='bitxor')."""
    lim = float((1 << (bits - 1)) - 1)
    q = jnp.clip(jnp.round(x / step), -lim, lim) * step
    # jnp.round(-0.4/step)*step can produce +0.0 where x was negative;
    # reapply the sign so signbit semantics survive quantization
    return jnp.where(jnp.signbit(x), -jnp.abs(q), jnp.abs(q))


def _cn_minsum_axis0(V, alpha: float, beta: float, signbit: bool = False):
    """Leave-one-out two-min CN update over axis 0 of [d, Z, B].

    signbit=True uses IEEE sign-bit semantics (-0.0 is negative) — the
    float-level form of an integer XOR of the messages' sign bits."""
    if signbit:
        negb = jnp.signbit(V)
    else:
        negb = V < 0
    s = jnp.where(negb, -1.0, 1.0)
    cnt = jnp.sum(negb.astype(jnp.float32), axis=0, keepdims=True)
    sgn_prod = 1.0 - 2.0 * (cnt - 2.0 * jnp.floor(cnt * 0.5))
    a = jnp.abs(V)
    min1 = jnp.min(a, axis=0, keepdims=True)
    is_min = a == min1
    count_min = jnp.sum(is_min.astype(jnp.float32), axis=0, keepdims=True)
    min2 = jnp.min(jnp.where(is_min, jnp.inf, a), axis=0, keepdims=True)
    mag = jnp.where(is_min & (count_min == 1.0), min2, min1)
    mag = jnp.minimum(mag, _MAG_CAP)
    mag = jnp.maximum(alpha * mag - beta, 0.0)
    return (sgn_prod * s) * mag


def _cn_spa_seq(V, signbit: bool = False):
    """Exact sum-product (tanh rule) over axis 0 of [d, Z, B], leave-one-out
    via a SEQUENTIAL log|tanh| accumulation in edge order (the op order
    tests/ref_decoders.py follows), unlike flooding_qc._cn_spa_qc's
    jnp.sum. Magnitude uses 2*arctanh(t) = log1p(t) - log1p(-t)."""
    a = jnp.abs(V)
    lt = jnp.log(jnp.tanh(jnp.clip(a, 1e-10, 40.0) * 0.5))
    ltacc = lt[0]
    for j in range(1, V.shape[0]):
        ltacc = ltacc + lt[j]
    loo = ltacc[None] - lt
    t = jnp.minimum(jnp.exp(loo), _SPA_TANH_CLIP)
    mag = jnp.log1p(t) - jnp.log1p(-t)
    negb = jnp.signbit(V) if signbit else V < 0
    cnt = jnp.sum(negb.astype(jnp.float32), axis=0, keepdims=True)
    sgn_prod = 1.0 - 2.0 * (cnt - 2.0 * jnp.floor(cnt * 0.5))
    sv = jnp.where(negb, -1.0, 1.0)
    return (sgn_prod * sv) * mag


_SPA_TANH_CLIP = 1.0 - 1e-7  # keep arctanh finite (twin of flooding_qc)


def _cn_for(kind: str):
    """CN update for the layered sweep; alpha/beta apply to minsum only
    (spa/minstar are exact BP — no normalization)."""
    if kind == "minsum":
        return None  # caller uses _cn_minsum_axis0 with alpha/beta
    if kind == "spa":
        return _cn_spa_seq
    if kind == "minstar":
        from .flooding_qc import _cn_minstar_qc

        return lambda V, signbit=False: _cn_minstar_qc(V, 1.0, 0.0)
    raise KeyError(f"layered cn must be minsum/spa/minstar, got {kind!r}")


def _syndrome_fail(graph: QCGraph, total):
    """fail [B]: any unsatisfied check, via static rolls."""
    hard = (total < 0).astype(jnp.float32)  # [nb, Z, B]
    fails = []
    for i in range(graph.mb):
        acc = 0.0
        for e, col, s in graph.layer_edges(i):
            acc = acc + graph.to_check(hard[col], s)
        par = acc - 2.0 * jnp.floor(acc * 0.5)
        fails.append(jnp.max(par, axis=0))  # [Z? no: [B]] -- max over Z
    return jnp.max(jnp.stack(fails), axis=0) > 0.5  # [B]


def decode_layered(
    graph: QCGraph,
    llr: jax.Array,
    *,
    alpha=1.0,
    beta=0.0,
    max_iters: int = 25,
    early_term: bool = True,
    sign_mode: str = "bitxor",
    quant=None,
    cn: str = "minsum",
) -> DecodeResult:
    """llr: f32 [B, n] -> DecodeResult. One iteration = one full sweep of
    all mb layers. cn selects the check-node rule: 'minsum' (alpha/beta
    normalized/offset), or the exact-BP forms 'spa' (tanh rule) /
    'minstar' (box-plus) — layered schedules of the oracle-grade
    algorithms (VERDICT r1 item 5). sign_mode='bitxor' selects IEEE
    signbit sign semantics; graphs with intra-layer duplicate columns
    (the accumulate path) always count negatives.

    alpha/beta may be scalars or per-iteration arrays of length
    max_iters (learned NOMS schedules, see learn/noms.py); iteration t
    uses alpha[t], beta[t].

    quant=(bits, step) emulates a fixed-point hardware decoder: channel
    LLRs and check messages live on a (bits)-bit uniform grid of the
    given step (narrow message RAM), while posterior accumulation stays
    wide (f32 stands in for the wider APP accumulator). Spec string form
    'layered/q:5:0.5/25'."""
    B = llr.shape[0]
    Z, nb = graph.Z, graph.nb
    dup_free = graph.intra_layer_dup_free
    cn_exact = _cn_for(cn)  # None for minsum
    if not dup_free:
        sign_mode = "count"  # the accumulate path counts negatives
    alphas = jnp.broadcast_to(jnp.asarray(alpha, jnp.float32), (max_iters,))
    betas = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (max_iters,))
    total0 = llr.T.astype(jnp.float32).reshape(nb, Z, B)
    if quant is not None:
        total0 = quantize(total0, *quant)
    # zeros_like keeps the data's varying mesh axes under shard_map
    C0 = jnp.zeros_like(total0, shape=(graph.num_block_edges, Z, B))
    done0 = ~_syndrome_fail(graph, total0)
    iters0 = (total0[0, 0] * 0).astype(jnp.int32)  # varying-axes-safe zero

    def sweep(total, C, alpha, beta, track=True):
        """One layered iteration. Also accumulates the ON-THE-FLY syndrome:
        each layer's parity evaluated on the posteriors as that layer is
        processed (the standard hardware early-termination criterion —
        costs nothing extra vs. a separate post-sweep syndrome pass), AND
        a hard-decision FLIP flag. Because layers see different posterior
        snapshots, all parities can pass while the state is still moving —
        freezing such a frame was a measured ~3e-4 detected-failure floor
        on DVB-S2 (frames fixed-iteration mode decodes fine). Convergence
        therefore additionally requires zero sign flips during the sweep:
        then every layer's parity was evaluated on the final hard-decision
        vector, making pass-with-no-flips an EXACT syndrome."""
        fail = jnp.zeros((total.shape[-1],), jnp.float32)
        flip = jnp.zeros((total.shape[-1],), jnp.bool_)
        for i in graph.layer_order:
            edges = graph.layer_edges(i)
            rolled = [graph.to_check(total[col], s) for e, col, s in edges]
            if track:
                acc = 0.0
                for r in rolled:
                    acc = acc + (r < 0).astype(jnp.float32)
                par = acc - 2.0 * jnp.floor(acc * 0.5)
                fail = jnp.maximum(fail, jnp.max(par, axis=0))
            # extrinsic inputs, check-aligned
            Vt = jnp.stack(
                [r - C[e] for r, (e, col, s) in zip(rolled, edges)]
            )  # [d, Z, B]
            if cn_exact is None:
                Cnew = _cn_minsum_axis0(Vt, alpha, beta,
                                        signbit=sign_mode == "bitxor")
            else:
                Cnew = cn_exact(Vt, signbit=sign_mode == "bitxor")
            if quant is not None:
                Cnew = quantize(Cnew, *quant)
            # posterior update. Dup-free graphs use the set form
            # `extrinsic + Cnew`; graphs with intra-layer duplicate
            # columns must ACCUMULATE via the delta-add form. All indices
            # static => dynamic_update_slice, never scatter.
            # multi-edge graphs + minstar: posterior deltas for duplicate
            # columns accumulate BACKWARD, the order of the running
            # box-plus suffix (f32 adds don't commute; the golden curves
            # and tests/ref_decoders.py follow this order). All other
            # paths touch each column once per layer (dup-free) or
            # accumulate forward.
            jorder = range(len(edges))
            if cn == "minstar" and not dup_free:
                jorder = range(len(edges) - 1, -1, -1)
            for j in jorder:
                e, col, s = edges[j]
                if dup_free:
                    new_aligned = Vt[j] + Cnew[j]
                    if track:
                        # signbit compare: -0.0 counts as negative
                        flip = flip | jnp.any(
                            jnp.signbit(new_aligned)
                            != jnp.signbit(rolled[j]),
                            axis=0,
                        )
                    total = total.at[col].set(graph.to_var(new_aligned, s))
                else:
                    old = total[col]
                    total = total.at[col].add(
                        graph.to_var(Cnew[j] - C[e], s)
                    )
                    if track:
                        flip = flip | jnp.any(
                            jnp.signbit(total[col]) != jnp.signbit(old),
                            axis=0,
                        )
                C = C.at[e].set(Cnew[j])
        return total, C, (fail > 0.5) | flip

    def body(state):
        total, C, done, iters, t = state
        new_total, newC, fail = sweep(total, C, alphas[t], betas[t])
        keep = done[None, None, :]  # [1,1,B] broadcasts over both states
        total = jnp.where(keep, total, new_total)
        C = jnp.where(keep, C, newC)
        iters = jnp.where(done, iters, iters + 1)
        done = done | ~fail
        return total, C, done, iters, t + 1

    if early_term:
        state = (total0, C0, done0, iters0, jnp.zeros((), jnp.int32))

        def cond(state):
            _, _, done, _, t = state
            return (t < max_iters) & ~jnp.all(done)

        total, _, done, iters, _ = jax.lax.while_loop(cond, body, state)
    else:
        # pure fixed-iteration mode (the benchmark configuration): no
        # freeze, no per-iteration syndrome — literally max_iters sweeps.
        def pure_body(t, st):
            total, C = st
            total, C, _ = sweep(total, C, alphas[t], betas[t], track=False)
            return total, C

        total, _ = jax.lax.fori_loop(0, max_iters, pure_body, (total0, C0))
        iters = jnp.full((B,), max_iters, jnp.int32) + iters0
    bits = (total.reshape(nb * Z, B) < 0).astype(jnp.uint8).T
    # `done` tracks the on-the-fly criterion (freeze/iteration accounting);
    # ok reports the true posterior syndrome of the emitted bits.
    ok = ~_syndrome_fail(graph, total)
    return DecodeResult(bits=bits, ok=ok, iterations=iters)


def make_layered_decoder(
    graph,
    *,
    alpha=1.0,   # scalar or per-iteration [max_iters] array
    beta=0.0,    # scalar or per-iteration [max_iters] array
    max_iters: int = 25,
    early_term: bool = True,
    jit: bool = True,
    sign_mode: str = "bitxor",
    quant=None,
    cn: str = "minsum",
):
    from ...graph.qc import QCGraph as _QC

    if not isinstance(graph, _QC):
        raise TypeError(
            "layered decoding needs a QCGraph (compile with graph.qc."
            "compile_qc_graph on a QC code)"
        )

    def decode(llr):
        return decode_layered(
            graph, llr, alpha=alpha, beta=beta, max_iters=max_iters,
            early_term=early_term, sign_mode=sign_mode, quant=quant, cn=cn,
        )

    return jax.jit(decode) if jit else decode
