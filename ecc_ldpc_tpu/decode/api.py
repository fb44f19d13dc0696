"""Decoder construction + compact decoder-spec strings.

The reference selects decoder variants with slash-separated strings inside
its code specs ("ldpc/<variant>/<iters>/<matrix>", SURVEY.md §2.1 R11). The
equivalent here is a decoder-spec string, e.g.:

  spa/25                    flooding sum-product, 25 iters
  minsum/25                 plain min-sum
  minsum/norm:0.8125/25     normalized min-sum, alpha=0.8125
  minsum/offset:0.15/25     offset min-sum, beta=0.15
  layered/norm:0.8125/25    layered schedule (QC codes; later milestone)
  bitflip/50                parallel majority bit flipping (hard decision)
  gdbf/theta:-0.5/50        gradient-descent bit flipping (soft metric)

Suffix flags: append '/noet' to disable syndrome early termination (the
fixed-iteration benchmark mode), '/xla-mm' to select the incidence-matmul
flooding form on an expanded graph.
"""
from __future__ import annotations

import functools
from typing import Callable

import jax

from ..graph.compile import CompiledGraph
from .types import DecodeResult
from .xla.cn_ops import cn_minsum, cn_spa
from .xla.flooding import decode_flooding


def make_decoder(
    graph: CompiledGraph,
    kind: str = "minsum",
    *,
    alpha: float = 1.0,
    beta: float = 0.0,
    theta: float = 0.0,
    quant=None,
    max_iters: int = 25,
    early_term: bool = True,
    backend: str = "auto",
    jit: bool = True,
    cleanup: bool = False,
    cn: str = "minsum",
) -> Callable[[jax.Array], DecodeResult]:
    """Build `decode(llr[B, n]) -> DecodeResult` for one graph.

    cleanup=True (QC graphs) appends a Gallager-B-style bit-flip pass
    that repairs the stuck-few-bits frames dominating the deep FER tail
    (decode/xla/cleanup.py)."""
    from ..graph.qc import QCGraph

    if cleanup:
        if not isinstance(graph, QCGraph):
            raise TypeError("cleanup=True needs a QCGraph (roll form)")
        from .xla.cleanup import with_cleanup

        inner = make_decoder(
            graph, kind, alpha=alpha, beta=beta, theta=theta, quant=quant,
            max_iters=max_iters, early_term=early_term, backend=backend,
            jit=False, cn=cn,
        )
        decode = with_cleanup(inner, graph)
        return jax.jit(decode) if jit else decode

    if cn != "minsum" and kind != "layered":
        raise KeyError(
            f"cn={cn!r} selects the layered sweep's check-node rule; for "
            f"flooding use kind='spa'/'minstar' directly"
        )
    if backend == "auto":
        # one rule on every platform: the XLA tiers (the roll/layered forms
        # on QC graphs, the gather form on expanded graphs)
        backend = "xla"
    if backend not in ("xla", "xla-mm"):
        raise ValueError(
            f"unknown backend {backend!r}: the decoders are the XLA tiers "
            f"— use 'auto' (or 'xla'), or 'xla-mm' for the incidence-"
            f"matmul flooding form"
        )
    if quant is not None:
        # fixed-point message emulation lives in the layered XLA tier
        if kind != "layered":
            raise KeyError(
                f"quant=(bits, step) is a layered-decoder option "
                f"(got kind={kind!r})"
            )
        backend = "xla"

    if kind in ("bitflip", "gdbf"):
        # hard-decision tier (decode/xla/bitflip.py): rolls on QC graphs,
        # incidence matmuls on small unstructured ones — one form per
        # graph type, so there is no backend split to route
        from .xla.bitflip import make_bitflip_decoder

        return make_bitflip_decoder(
            graph, variant="maj" if kind == "bitflip" else "gdbf",
            theta=theta, max_iters=max_iters, early_term=early_term, jit=jit,
        )

    if backend == "xla-mm":
        from .xla import dense_mm

        if kind == "spa":
            cn_op = cn_spa
        elif kind == "minsum":
            cn_op = functools.partial(cn_minsum, alpha=alpha, beta=beta)
        else:
            raise KeyError(f"xla-mm backend supports spa/minsum, not {kind!r}")
        ops = dense_mm.IncidenceOperators.build(graph)

        # ops must be an ARGUMENT of the jitted fn, not a closure capture —
        # closed-over arrays embed as giant inline constants in the lowered
        # module (27 MB of MLIR for n=1008), which bloats every compile.
        def decode_mm_impl(ops, llr):
            return dense_mm.decode_flooding_mm(
                graph, ops, llr, cn_op=cn_op, max_iters=max_iters,
                early_term=early_term,
            )

        impl = jax.jit(decode_mm_impl) if jit else decode_mm_impl
        return lambda llr: impl(ops, llr)
    if kind in ("minsum", "spa", "minstar") and isinstance(graph, QCGraph):
        # roll-form flooding (QC layout): min-sum and the exact-BP forms
        # spa/minstar, all gather-free
        from .xla.flooding_qc import decode_flooding_qc

        def decode_qc(llr):
            return decode_flooding_qc(
                graph, llr, kind=kind, alpha=alpha, beta=beta,
                max_iters=max_iters, early_term=early_term,
            )

        return jax.jit(decode_qc) if jit else decode_qc
    if isinstance(graph, QCGraph) and kind != "layered":
        raise KeyError(
            f"unknown decoder kind {kind!r} for a QCGraph — one of "
            f"'minsum', 'spa', 'minstar', 'layered', 'bitflip', 'gdbf'"
        )
    if kind == "spa":
        cn_op = cn_spa
    elif kind == "minstar":
        from .xla.cn_ops import cn_minstar

        cn_op = cn_minstar
    elif kind == "minsum":
        cn_op = functools.partial(cn_minsum, alpha=alpha, beta=beta)
    elif kind == "layered":
        from .xla.layered import make_layered_decoder

        return make_layered_decoder(
            graph, alpha=alpha, beta=beta, max_iters=max_iters,
            early_term=early_term, jit=jit, quant=quant, cn=cn,
        )
    else:
        raise KeyError(f"unknown decoder kind {kind!r}")

    def decode(llr):
        return decode_flooding(
            graph, llr, cn_op=cn_op, max_iters=max_iters, early_term=early_term
        )

    return jax.jit(decode) if jit else decode


def parse_decoder_spec(spec: str) -> dict:
    """Parse a compact decoder-spec string into make_decoder kwargs.

    'sched:NAME' loads a shipped learned schedule (learn/schedules/) as
    per-iteration alpha/beta arrays, e.g.
    'layered/sched:dvbs2_64800_12_T25'; an explicit iteration count may
    truncate it ('.../20' uses the first 20 iterations).

    A ';retry=FALLBACK' suffix is handled by get_decoder; here it is
    stripped so informational callers (graph choice, bench metadata)
    see the PRIMARY's kwargs."""
    parts = spec.split(";retry=")[0].split("/")
    kind = parts[0]
    kw: dict = {"kind": kind}
    sched = None
    for p in parts[1:]:
        if p.startswith("norm:"):
            kw["alpha"] = float(p[5:])
        elif p.startswith("offset:"):
            kw["beta"] = float(p[7:])
        elif p.startswith("theta:"):
            kw["theta"] = float(p[6:])  # gdbf flip threshold
        elif p.startswith("q:"):
            bits_s, step_s = p[2:].split(":")
            bits = int(bits_s)
            if not 2 <= bits <= 16:
                raise ValueError(f"quantizer bits out of range in {p!r}")
            kw["quant"] = (bits, float(step_s))  # fixed-point emulation
        elif p.startswith("sched:"):
            sched = p[6:]
        elif p in ("spa", "minstar", "minsum") and kind == "layered":
            kw["cn"] = p  # layered sweep with an exact-BP check-node rule
        elif p == "noet":
            kw["early_term"] = False
        elif p == "cleanup":
            kw["cleanup"] = True
        elif p in ("xla", "xla-mm", "auto"):
            kw["backend"] = p
        elif p.isdigit():
            kw["max_iters"] = int(p)
        else:
            raise ValueError(f"bad decoder-spec component {p!r} in {spec!r}")
    if sched is not None:
        from ..learn import load_schedule

        if kind != "layered":
            raise ValueError(
                f"sched: applies to layered decoding only (got {kind!r}) — "
                f"shipped schedules are trained on the layered sweep"
            )
        if "alpha" in kw or "beta" in kw:
            raise ValueError(
                "decoder spec mixes norm:/offset: with sched: — a schedule "
                "already fixes per-iteration alpha/beta"
            )
        ps = load_schedule(sched)
        T = kw.setdefault("max_iters", ps.iters)
        if T > ps.iters:
            raise ValueError(
                f"schedule {sched!r} has {ps.iters} iterations, "
                f"spec asks for {T}"
            )
        kw["alpha"] = ps.alphas[:T]
        kw["beta"] = ps.betas[:T]
    return kw


def get_decoder(graph: CompiledGraph, spec: str, **overrides):
    """Build a decoder from a spec string.

    'PRIMARY;retry=FALLBACK' (e.g. 'layered/norm:0.8125/50;retry=spa/50')
    wraps the primary in decoder-diversity retry (with_retry): frames the
    primary fails are re-decoded by the fallback ON THE SAME compiled
    graph. The wrapper is HOST-LEVEL by design (boolean gather between two
    jitted decoders) — it cannot be jitted; the sim runner detects the
    `host_level` flag and runs its staged step (the floor program's
    winning remedy, docs/DESIGN.md §4.6)."""
    if ";retry=" in spec:
        primary_spec, fb_spec = spec.split(";retry=", 1)
        # the sub-decoders are always jitted — the host-level wrapper is
        # the only eager layer (callers' jit=False means "don't jit the
        # decode entry point", which the wrapper already satisfies)
        sub = dict(overrides, jit=True)
        primary = get_decoder(graph, primary_spec, **sub)
        fallback = get_decoder(graph, fb_spec, **sub)
        dec = with_retry(primary, fallback)
        dec.host_level = True
        return dec
    kw = parse_decoder_spec(spec)
    kw.update(overrides)
    return make_decoder(graph, **kw)


def with_retry(primary, fallback, retry_batch: int = 32):
    """Production wrapper: decode with `primary`; frames it fails
    (ok=False) are re-decoded with `fallback` and replaced where the
    fallback succeeds.

    Why this works: the deep FER tail of layered min-sum is dominated by
    small trapping sets (one degree-3 bit plus a staircase accumulator
    run, 3 unsatisfied checks — microscoped on dvbs2/64800 at 1.35 dB),
    and a decoder with different dynamics escapes them: spa/50 recovered
    10/10 collected failures. Host-level gather/scatter between two
    jitted decoders (at tail FERs the fallback runs on a tiny fraction
    of frames), so use it OUTSIDE jit — for jitted pipelines, run the
    sweep with the primary and re-decode failures offline.

    Failed frames are gathered into fixed `retry_batch`-sized buckets so
    the fallback compiles once (a data-dependent batch would recompile
    per distinct failure count). Only the per-frame ok flags cross to the
    host; the bits/iters patching is a jitted on-device row scatter, so
    the full [B, n] bits tensor (66 MB at n=64800) never leaves the
    device."""
    import numpy as np
    import jax.numpy as jnp

    @jax.jit
    def _combine(bits, ok, iters, idx, rbits, rok, riters):
        # idx may repeat (bucket padding duplicates bad[0]); every
        # duplicate carries identical retry output, so .set is race-free
        bits = bits.at[idx].set(rbits)
        new_iters = iters.at[idx].set(jnp.take(iters, idx) + riters)
        return bits, ok.at[idx].set(rok), new_iters

    def decode(llr):
        res = primary(llr)
        ok = np.asarray(res.ok)
        bad = np.flatnonzero(~ok)
        if len(bad) == 0:
            return res
        pad = int(np.ceil(len(bad) / retry_batch)) * retry_batch
        sel = jnp.asarray(np.concatenate([bad, np.full(pad - len(bad),
                                                       bad[0])]))
        retry = fallback(jnp.take(llr, sel, axis=0))
        bits, okj, iters = _combine(
            res.bits, res.ok, res.iterations, sel,
            retry.bits, retry.ok, retry.iterations,
        )
        return DecodeResult(bits=bits, ok=okj, iterations=iters)

    return decode


def choose_graph(code_spec, decoder_spec: str, backend: str | None = None):
    """Compile the graph view a decoder spec needs — THE routing rule,
    shared by the sim runner, the ECC facade, and the bench harnesses.

    QC codes decode through the QC block view for every kind the roll
    tiers serve (layered REQUIRES it; minsum/spa/minstar/bitflip/gdbf run
    gather-free there). The only explicit override that needs the
    expanded graph is 'xla-mm' (incidence matmuls). Non-QC codes always
    use the expanded graph. A ';retry=' suffix shares the primary's graph
    (get_decoder builds the fallback on the same view)."""
    from ..graph import compile_graph, compile_qc_graph

    decoder_spec = decoder_spec.split(";retry=")[0]
    kind = parse_decoder_spec(decoder_spec)["kind"]
    if kind == "layered":
        return compile_qc_graph(code_spec)  # raises clearly on non-QC codes
    if code_spec.qc is None or kind not in (
        "minsum", "spa", "minstar", "bitflip", "gdbf"
    ):
        return compile_graph(code_spec)
    if backend == "xla-mm":
        return compile_graph(code_spec)
    return compile_qc_graph(code_spec)
