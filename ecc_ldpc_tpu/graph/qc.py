"""Compiled quasi-cyclic graph: block-edge lists for roll-based decoders.

The structured representation of QC-LDPC codes (SURVEY.md §2.2 C8/C18): a
message slab for one Z x Z circulant block is laid out [Z, batch] with Z on
the leading axis and batch on the trailing one, so applying the circulant
permutation P^s is a jnp.roll along axis 0 with a static shift unrolled at
trace time. No gather/scatter exists anywhere in the QC decode path.

Alignment convention: a slab associated with block-edge e is CHECK-aligned
(indexed by the check's row r inside the block-row). Check r connects to
variable (r + shift) % Z, so:
  variable-aligned view = roll(check_aligned, +shift)
  check-aligned view    = roll(variable_aligned, -shift)
with roll(x, s)[i] = x[(i - s) % Z] (np.roll semantics).

Block-permutation families (perm="xor"): IEEE 802.3an's RS-based H is six
64-row blocks where check r connects variable r XOR s (codes/ieee8023an.py)
— GF(2)-additive permutations, not circulants. The same [Z, batch] slab
layout serves them with the roll replaced by xor_perm (reshape + flip on
the bit axes of s — one XLA reverse op, still gather-free).
XOR perms are involutions, so both alignment directions apply the SAME
permutation. QCGraph.perm selects the block-permutation kind; the XLA
tiers consume it through to_check_align/to_var_align below.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.qc import QCCode
from ..codes.spec import CodeSpec


def xor_perm(x: jax.Array, s: int) -> jax.Array:
    """y[i] = x[i ^ s] along axis 0 (static s; axis length a power of two).

    Realized as reshape to (2,)*b + flip of the bit-axes set in s + reshape
    back: flipping bit-axis a maps index bit -> 1-bit, so the composite is
    exactly XOR-by-s. One XLA reverse op — no gather, no dynamic slices."""
    if s == 0:
        return x
    Z = x.shape[0]
    b = Z.bit_length() - 1
    if (1 << b) != Z or not 0 < s < Z:
        raise ValueError(f"xor_perm needs power-of-two axis, 0<=s<Z (Z={Z}, s={s})")
    xr = x.reshape((2,) * b + x.shape[1:])
    axes = tuple(a for a in range(b) if (s >> (b - 1 - a)) & 1)
    return jnp.flip(xr, axis=axes).reshape(x.shape)


def to_check_align(x: jax.Array, s: int, perm: str) -> jax.Array:
    """Variable-aligned -> check-aligned view of a [Z, ...] slab."""
    if perm == "xor":
        return xor_perm(x, int(s))
    return jnp.roll(x, -int(s), axis=0)


def to_var_align(x: jax.Array, s: int, perm: str) -> jax.Array:
    """Check-aligned -> variable-aligned view of a [Z, ...] slab."""
    if perm == "xor":
        return xor_perm(x, int(s))
    return jnp.roll(x, int(s), axis=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QCGraph:
    """QC graph as static block-edge triples: every field is trace-time
    data that the decoders unroll into static rolls."""

    Z: int = dataclasses.field(metadata=dict(static=True))
    mb: int = dataclasses.field(metadata=dict(static=True))
    nb: int = dataclasses.field(metadata=dict(static=True))
    num_block_edges: int = dataclasses.field(metadata=dict(static=True))
    k: int = dataclasses.field(metadata=dict(static=True))
    name: str = dataclasses.field(metadata=dict(static=True))
    # block-permutation kind: "roll" (circulant P^s) or "xor" (a -> a^s);
    # the XLA tiers route every alignment change through to_check_align/
    # to_var_align
    perm: str = dataclasses.field(metadata=dict(static=True))
    be_row_np: tuple = dataclasses.field(metadata=dict(static=True))
    be_col_np: tuple = dataclasses.field(metadata=dict(static=True))
    be_shift_np: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    def to_check(self, x: jax.Array, s: int) -> jax.Array:
        """Variable-aligned -> check-aligned [Z, ...] slab view."""
        return to_check_align(x, s, self.perm)

    def to_var(self, x: jax.Array, s: int) -> jax.Array:
        """Check-aligned -> variable-aligned [Z, ...] slab view."""
        return to_var_align(x, s, self.perm)

    def layer_edges(self, i: int):
        """Host-side (edge_id, col, shift) triples of block-row i."""
        out = []
        for e in range(self.num_block_edges):
            if self.be_row_np[e] == i:
                out.append((e, self.be_col_np[e], self.be_shift_np[e]))
        return out

    @property
    def layer_order(self):
        """Canonical layered processing order: block-rows stably sorted by
        degree. Any fixed row order is a valid layered schedule; this one
        is what the golden curves (curves/) were measured with, so the
        layered and flooding-QC tiers keep it."""
        degs = [len(self.layer_edges(i)) for i in range(self.mb)]
        return tuple(sorted(range(self.mb), key=lambda i: degs[i]))

    @property
    def intra_layer_dup_free(self) -> bool:
        """True when no block-row touches the same block-column twice.

        Gates the alignment-carrying ("delta shift") layered update used by
        the layered tier: posteriors are stored in the rotation of the last
        layer that touched them and written back as `slab + Cnew` (one roll
        per edge-visit instead of two). With a duplicate column inside one
        layer the second write would clobber the first's message update, so
        such graphs take the 2-roll delta-add path instead. Standard QC
        tables (802.11n/WiMAX/DVB-S2/5G NR) have one shift per base cell,
        hence no duplicates."""
        for i in range(self.mb):
            cols = [c for _, c, _ in self.layer_edges(i)]
            if len(cols) != len(set(cols)):
                return False
        return True


def qc_graph_from_block_edges(
    Z: int, mb: int, nb: int, br, bc, sh, *, k: int, name: str = "qc",
    perm: str = "roll",
) -> QCGraph:
    """Build a QCGraph from explicit (block_row, block_col, shift) triples.

    Unlike compile_qc_graph (whose QCCode base matrix holds one shift per
    cell), this admits PARALLEL block-edges — multi-edge protographs, where
    a block-row touches the same block-column through two different
    circulants. Such graphs have intra_layer_dup_free == False and route
    the layered tier onto its accumulate ("classic" 2-roll) path."""
    br = np.asarray(br, np.int32)
    bc = np.asarray(bc, np.int32)
    sh = np.asarray(sh, np.int32)
    BE = len(br)
    if perm not in ("roll", "xor"):
        raise ValueError(f"perm must be 'roll' or 'xor', got {perm!r}")
    if perm == "xor" and Z & (Z - 1):
        raise ValueError(f"xor-perm blocks need power-of-two Z, got {Z}")
    if np.any(sh < 0) or np.any(sh >= Z):
        raise ValueError("shifts must lie in [0, Z)")
    if len(bc) != BE or len(sh) != BE:
        raise ValueError("br, bc, sh must have equal length")
    if BE and (br.min() < 0 or br.max() >= mb):
        raise ValueError(f"block rows must lie in [0, {mb})")
    if BE and (bc.min() < 0 or bc.max() >= nb):
        raise ValueError(f"block cols must lie in [0, {nb})")
    return QCGraph(
        Z=Z, mb=mb, nb=nb, num_block_edges=BE, k=k, name=name, perm=perm,
        be_row_np=tuple(int(x) for x in br),
        be_col_np=tuple(int(x) for x in bc),
        be_shift_np=tuple(int(x) for x in sh),
    )


def compile_qc_graph(spec: CodeSpec) -> QCGraph:
    qc: QCCode = spec.qc
    if qc is None:
        raise ValueError(f"code {spec.name!r} has no QC structure")
    br, bc, sh = qc.block_edges()
    return qc_graph_from_block_edges(
        qc.Z, qc.mb, qc.nb, br, bc, sh, k=spec.k, name=spec.name,
        perm=getattr(qc, "perm", "roll"),
    )
