"""Dense-generator GF(2) encoding as an int8 matmul (SURVEY.md §2.2 C10).

Host side derives a systematic generator from H by GF(2) elimination; device
side encodes batches as one int8 matmul with int32 accumulation followed by
mod-2 — the matmul formulation of the reference's G-multiply encode
(SURVEY.md §2.1 R6). Intended for small/medium n; the standards families use
encode/structured.py instead.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.spec import CodeSpec
from .gf2 import gf2_matmul, gf2_row_reduce


def systematic_generator(spec: CodeSpec, max_cells: int = 64_000_000):
    """Derive (G, info_cols) from H.

    G: uint8 [k, n] with G @ H^T = 0 (mod 2), in ORIGINAL column order.
    info_cols: the k codeword positions that carry the message systematically
    (codeword[info_cols] == message for msg @ G).
    """
    H = spec.dense(max_cells=max_cells)
    R, pivot_cols = gf2_row_reduce(H)
    rank = len(pivot_cols)
    k = spec.n - rank
    info_cols = np.setdiff1d(np.arange(spec.n), pivot_cols)
    assert len(info_cols) == k
    # R restricted to pivot rows: R[r, pivot_cols] = I. For a codeword c:
    # 0 = R c = c[pivot_cols] + R[:, info_cols] c[info_cols]
    # => c[pivot_cols] = R[:rank, info_cols] @ msg, c[info_cols] = msg.
    G = np.zeros((k, spec.n), dtype=np.uint8)
    G[np.arange(k), info_cols] = 1
    G[:, pivot_cols[:rank]] = R[:rank][:, info_cols].T
    assert not np.any(gf2_matmul(G, H.T)), "G @ H^T != 0"
    return G, info_cols.astype(np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseEncoder:
    """Batched device encoder: bits [..., k] -> codeword [..., n]."""

    G: jax.Array  # int8 [k, n]
    info_cols: jax.Array  # int32 [k]

    # Reached only when no structured encoder matched (encode.build_encoder
    # tries those first), so a deliberate budget above CCSDS k=16384 r=1/2
    # (24576 x 40960 ~ 1.0e9 cells, generator build ~260 s host-side,
    # cached below) while still refusing DVB-S2-normal-frame accidents.
    LARGE_CELLS = 1_200_000_000

    @staticmethod
    def build(spec: CodeSpec, cache: bool = True) -> "DenseEncoder":
        """Build (or load from the host cache) the systematic generator.

        Large codes (> the spec.dense default, e.g. CCSDS k=16384) pay a
        multi-minute one-time GF(2) elimination + G.H^T=0 verification;
        the resulting G is content-addressed by a hash of H's sparsity
        pattern and cached under ~/.cache/ecc_ldpc_tpu/, so subsequent
        processes load it in seconds. cache=False forces a rebuild."""
        import hashlib
        import os

        big = spec.n * spec.m > 64_000_000
        path = None
        if cache and big:
            h = hashlib.sha256()
            h.update(np.int64([spec.m, spec.n]).tobytes())
            for r in spec.row_cols:
                h.update(np.asarray(r, np.int32).tobytes())
            cdir = os.path.join(
                os.path.expanduser("~"), ".cache", "ecc_ldpc_tpu")
            path = os.path.join(cdir, f"G_{h.hexdigest()[:24]}.npz")
            if os.path.exists(path):
                z = np.load(path)
                G = np.unpackbits(
                    z["G_packed"], axis=1, count=int(z["n"]))
                return DenseEncoder(G=jnp.asarray(G, jnp.int8),
                                    info_cols=jnp.asarray(z["info_cols"]))
        G, info_cols = systematic_generator(
            spec, max_cells=DenseEncoder.LARGE_CELLS if big else 64_000_000)
        if path is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}.npz"
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, G_packed=np.packbits(G, axis=1), n=np.int64(spec.n),
                    info_cols=info_cols)
            os.replace(tmp, path)
        return DenseEncoder(G=jnp.asarray(G, jnp.int8), info_cols=jnp.asarray(info_cols))

    @property
    def k(self) -> int:
        return self.G.shape[0]

    @property
    def n(self) -> int:
        return self.G.shape[1]

    def __call__(self, msg_bits: jax.Array) -> jax.Array:
        acc = jax.lax.dot_general(
            msg_bits.astype(jnp.int8),
            self.G,
            dimension_numbers=(((msg_bits.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return (acc & 1).astype(jnp.uint8)

    def extract_message(self, codeword_bits: jax.Array) -> jax.Array:
        """codeword [..., n] -> message [..., k] (systematic positions)."""
        return jnp.take(codeword_bits, self.info_cols, axis=-1)
