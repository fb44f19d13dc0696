"""Graph-parallel (edge-sharded) decode — the sequence-parallel analog
(SURVEY.md §2.2 C21, §5.7 mode 2).

One codeword's Tanner graph is partitioned across devices: each device owns
a contiguous block of checks and their edges, computes local CN updates,
and the variable-node accumulate becomes a psum over the 'graph' mesh axis
(XLA lowers it to an NCCL all-reduce across GPUs — SURVEY.md §5.8). This
is the capability that would cover codes larger than one chip's working
set; for codes that fit (all standards families), the batch-parallel mode
is throughput-optimal (zero cross-chip traffic in the hot loop) and remains
the production path — SURVEY.md §5.7 explains the trade.

TWO TIERS (VERDICT r1 item 3):

1. make_qc_graph_parallel_decoder — the production form for QC codes
   (every standards family). The circulant (Z) axis of all decode
   state [*, Z, B] is partitioned over the 'graph' mesh axis with GSPMD
   sharding constraints on the roll-form flooding program
   (decode/xla/flooding_qc.py) — rolls + elementwise math + reductions
   only, NO gathers and NO scatter-add, so XLA inserts the boundary
   collective-permutes for the rolls itself (the idiomatic
   sequence-parallel recipe: annotate shardings, let the compiler place
   collectives). Each device owns a true Z-slice of every VN and CN
   block: n/D variable nodes and m/D checks per device. Arithmetic is
   UNCHANGED by partitioning (slice/roll layout changes only), so results
   are bit-identical to the single-device roll decoder for any D.

2. make_graph_parallel_decoder — the generic check-sharded form for
   unstructured codes. Its local VN update is a scatter-add followed by
   a psum of the full [n, B] totals; QC codes should use tier 1, which
   exchanges only roll boundaries.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.spec import CodeSpec
from ..decode.types import DecodeResult
from ..decode.xla.cn_ops import cn_minsum, cn_spa
from ..graph.compile import CompiledGraph, compile_graph

P = jax.sharding.PartitionSpec


def make_qc_graph_parallel_decoder(
    spec_or_graph,
    mesh: jax.sharding.Mesh,
    axis: str = "graph",
    *,
    kind: str = "minsum",
    alpha: float = 1.0,
    beta: float = 0.0,
    max_iters: int = 25,
    early_term: bool = True,
    jit: bool = True,
) -> Callable:
    """decode(llr [B, n]) -> DecodeResult with the circulant axis sharded.

    Graph-parallel decode for QC codes (module docstring tier 1):
    the roll-form flooding decoder under a GSPMD constraint that partitions
    the Z axis of llr/total/C over mesh[axis]. kind: minsum|spa|minstar.
    Requires Z % mesh.shape[axis] == 0. Bit-identical to the unsharded
    decode_flooding_qc for any device count (tests/dist/).
    """
    from ..decode.xla.flooding_qc import decode_flooding_qc
    from ..graph.qc import QCGraph, compile_qc_graph

    graph = (
        spec_or_graph if isinstance(spec_or_graph, QCGraph)
        else compile_qc_graph(spec_or_graph)
    )
    D = mesh.shape[axis]
    if graph.Z % D:
        raise ValueError(
            f"Z={graph.Z} does not divide over {D} devices on '{axis}'"
        )
    if graph.perm != "roll":
        raise ValueError(
            f"graph-parallel Z-sharding assumes circulant blocks; "
            f"{graph.name} lifts with perm={graph.perm!r} (xor-perm codes "
            f"are small — use the batch-parallel mode)"
        )
    # with_sharding_constraint requires Auto mesh axes; jax.make_mesh
    # defaults to Explicit ones — rebuild over the same devices
    mesh = jax.sharding.Mesh(mesh.devices, mesh.axis_names)
    zshard = jax.sharding.NamedSharding(mesh, P(None, axis, None))

    def constrain(x):
        return jax.lax.with_sharding_constraint(x, zshard)

    def decode(llr):
        return decode_flooding_qc(
            graph, llr, kind=kind, alpha=alpha, beta=beta,
            max_iters=max_iters, early_term=early_term, constrain=constrain,
        )

    return jax.jit(decode) if jit else decode


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Per-device check-shard subgraphs, stacked on a leading axis."""

    n: int
    m: int
    num_shards: int
    dc_max: int
    cn_vn: np.ndarray  # int32 [D, m_shard, dc_max]
    cn_mask: np.ndarray  # bool [D, m_shard, dc_max]


def shard_graph(spec: CodeSpec, num_shards: int) -> ShardedGraph:
    g = compile_graph(spec)
    m_shard = -(-g.m // num_shards)
    cn_vn = np.zeros((num_shards, m_shard, g.dc_max), np.int32)
    cn_mask = np.zeros((num_shards, m_shard, g.dc_max), bool)
    gv = np.asarray(g.cn_vn)
    gm = np.asarray(g.cn_mask)
    for d in range(num_shards):
        lo = d * m_shard
        hi = min(lo + m_shard, g.m)
        cn_vn[d, : hi - lo] = gv[lo:hi]
        cn_mask[d, : hi - lo] = gm[lo:hi]
    return ShardedGraph(
        n=g.n, m=g.m, num_shards=num_shards, dc_max=g.dc_max,
        cn_vn=cn_vn, cn_mask=cn_mask,
    )


def make_graph_parallel_decoder(
    spec: CodeSpec,
    mesh: jax.sharding.Mesh,
    axis: str = "graph",
    *,
    kind: str = "minsum",
    alpha: float = 1.0,
    beta: float = 0.0,
    max_iters: int = 25,
) -> Callable:
    """decode(llr [B, n]) -> DecodeResult, graph sharded over mesh[axis].

    llr is replicated; each device owns a check shard; counters/totals are
    psum-reduced. Fixed-iteration schedule with per-lane freeze (identical
    results to the single-device flooding decoder with early_term=True).
    """
    D = mesh.shape[axis]
    sg = shard_graph(spec, D)
    if kind == "spa":
        cn_op = cn_spa
    else:
        cn_op = functools.partial(cn_minsum, alpha=alpha, beta=beta)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(), P(), P()),
    )
    def decode_sharded(cn_vn_d, cn_mask_d, llr):
        cn_vn = cn_vn_d[0]  # [m_shard, dc] local shard
        mask3 = cn_mask_d[0][:, :, None]
        llr_t = llr.T.astype(jnp.float32)  # [n, B] replicated
        B = llr_t.shape[1]

        def syndrome_fail(total):
            hard = (total < 0).astype(jnp.int32)
            par = jnp.sum(jnp.where(mask3, hard[cn_vn], 0), axis=1) & 1
            local = jnp.any(par != 0, axis=0)
            return jax.lax.psum(local.astype(jnp.int32), axis) > 0

        V0 = jnp.where(mask3, llr_t[cn_vn], 0.0)
        total0 = llr_t
        done0 = ~syndrome_fail(total0)
        iters0 = (llr_t[0] * 0).astype(jnp.int32)

        def body(_, state):
            V, total, done, iters = state
            C = cn_op(V, mask3)  # local CN update
            # local partial VN accumulate, then all-reduce over shards:
            # scatter-add of local check messages into the full [n, B]
            partial = jnp.zeros((sg.n, B), jnp.float32)
            Cflat = jnp.where(mask3, C, 0.0).reshape(-1, B)
            partial = partial.at[cn_vn.reshape(-1)].add(Cflat)
            new_total = llr_t + jax.lax.psum(partial, axis)
            newV = jnp.where(mask3, new_total[cn_vn] - C, 0.0)
            fail = syndrome_fail(new_total)
            keep = done[None, None, :]
            V = jnp.where(keep, V, newV)
            total = jnp.where(done[None, :], total, new_total)
            iters = jnp.where(done, iters, iters + 1)
            done = done | ~fail
            return V, total, done, iters

        _, total, done, iters = jax.lax.fori_loop(
            0, max_iters, body, (V0, total0, done0, iters0)
        )
        bits = (total < 0).astype(jnp.uint8).T
        return bits, done, iters

    cn_vn = jnp.asarray(sg.cn_vn)
    cn_mask = jnp.asarray(sg.cn_mask)

    @jax.jit
    def decode(llr):
        bits, ok, iters = decode_sharded(cn_vn, cn_mask, llr)
        return DecodeResult(bits=bits, ok=ok, iterations=iters)

    return decode
