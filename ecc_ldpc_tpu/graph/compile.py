"""Compile a CodeSpec's H matrix into device-ready index tensors.

The reference's decoders walk H's sparse structure directly in Haskell
(SURVEY.md §2.1 R6-R8); on an accelerator the graph must instead become
*static index tensors* so message passing is expressible as batched
row-gathers with the last axis carrying the codeword batch (SURVEY.md §2.2
C8).

Layout: the padded check-side view [m, dc_max] is the canonical edge space —
edge (i, j) is slot j of check i, flat id i*dc_max + j. Messages live as
[m, dc_max, B] arrays (batch-last so lanes = batch). The variable-side view
[n, dv_max] holds flat ids into that edge space, giving the VN-side gather.
Padding slots point at flat id 0 and are neutralized by masks.

All tensors are small relative to message state (indices are shared across the
whole batch) and are donated to jit as regular array arguments; CompiledGraph
is a registered pytree so decoders take it as a first-class argument.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np

from ..codes.spec import CodeSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CompiledGraph:
    """Device-ready LDPC graph. Fields ending in _np stay host-side."""

    # static metadata
    n: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    k: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))
    dc_max: int = dataclasses.field(metadata=dict(static=True))
    dv_max: int = dataclasses.field(metadata=dict(static=True))
    name: str = dataclasses.field(metadata=dict(static=True))

    # data (jnp arrays once moved to device; numpy on host)
    cn_vn: jax.Array  # int32 [m, dc_max]  variable id per check slot
    cn_mask: jax.Array  # bool [m, dc_max]
    vn_edge: jax.Array  # int32 [n, dv_max] flat edge id (i*dc_max+j)
    vn_mask: jax.Array  # bool [n, dv_max]

    @property
    def rate(self) -> float:
        return self.k / self.n


def compile_graph(spec: CodeSpec) -> CompiledGraph:
    m, n = spec.m, spec.n
    dc_max = int(spec.row_deg.max())
    dv_max = int(spec.col_deg.max())

    cn_vn = np.zeros((m, dc_max), dtype=np.int32)
    cn_mask = np.zeros((m, dc_max), dtype=bool)
    for i, cols in enumerate(spec.row_cols):
        cn_vn[i, : len(cols)] = cols
        cn_mask[i, : len(cols)] = True

    # Variable-side: flat edge ids. Build by walking rows once.
    vn_edge = np.zeros((n, dv_max), dtype=np.int32)
    vn_mask = np.zeros((n, dv_max), dtype=bool)
    fill = np.zeros(n, dtype=np.int32)
    for i, cols in enumerate(spec.row_cols):
        for j, c in enumerate(cols):
            c = int(c)
            vn_edge[c, fill[c]] = i * dc_max + j
            vn_mask[c, fill[c]] = True
            fill[c] += 1
    assert np.array_equal(fill, spec.col_deg)

    return CompiledGraph(
        n=n,
        m=m,
        k=spec.k,
        num_edges=spec.num_edges,
        dc_max=dc_max,
        dv_max=dv_max,
        name=spec.name,
        cn_vn=cn_vn,
        cn_mask=cn_mask,
        vn_edge=vn_edge,
        vn_mask=vn_mask,
    )
