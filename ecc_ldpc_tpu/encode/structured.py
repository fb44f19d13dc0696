"""Structured QC encoders: dual-diagonal back-substitution in O(n)
(SURVEY.md §2.2 C11).

For base matrices of the 802.11n/WiMAX shape H = [Hi | Hp], where Hp has a
special first parity column with entries (x, y, x) at rows (0, rx, mb-1)
and a shift-0 double-diagonal staircase, the parity blocks follow from the
info blocks without any generator matrix:

  s_i   = sum_j P^{a_ij} u_j                 (block syndromes of the info part)
  P^y p_0 = sum_i s_i                         (rows telescope: staircase
                                               cancels pairwise; the special
                                               column's two P^x add to zero,
                                               leaving P^y p_0)
  p_1   = s_0 + P^{x} p_0
  p_{d+1} = p_d + s_d + [P^{y} p_0 if d == rx]   (back-substitution)

Most standard tables use (x, 0, x) with x >= 1; WiMAX rate 3/4B is the
(0, y, 0) case — the paired entries cancel regardless of their value, so
any x works, and a nonzero middle shift y just makes p_0 a rotation of
the row-sum (802.16e §8.4.9.2.2's h_b(kb) column convention).

All block ops are jnp.roll along the Z axis with static shifts — the
encoder is a short unrolled roll/XOR chain, matmul-free and gather-free,
batched over frames on the last axis. Works for ANY Z and any table
with this skeleton (recalled standard tables and surrogates alike);
correctness is asserted against H at build time for a random batch.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codes.spec import CodeSpec


@dataclasses.dataclass(frozen=True)
class DualDiagonalPlan:
    """Host-side encode plan extracted from a QC base matrix."""

    Z: int
    mb: int
    kb: int
    special_shift: int  # x in the (x, y, x) special column
    special_mid_row: int  # rx
    info_edges: tuple  # tuple of (block_row, block_col, shift)
    special_mid_shift: int = 0  # y (0 for 802.11n and most WiMAX tables)

    @staticmethod
    def from_spec(spec: CodeSpec) -> "DualDiagonalPlan":
        qc = spec.qc
        if qc is None:
            raise ValueError(f"{spec.name}: not a QC code")
        base = getattr(qc, "base", None)
        if base is None:  # multi-edge QCMultiCode: no structured skeleton
            raise ValueError(f"{spec.name}: multi-edge QC, no base matrix")
        mb, nb = base.shape
        kb = nb - mb
        pcol = base[:, kb]
        rows = np.flatnonzero(pcol >= 0)
        if len(rows) != 3 or rows[0] != 0 or rows[-1] != mb - 1:
            raise ValueError(f"{spec.name}: no (x,y,x) special parity column")
        x0, xm, x2 = pcol[rows[0]], pcol[rows[1]], pcol[rows[2]]
        if x0 != x2:
            raise ValueError(
                f"{spec.name}: special column is ({x0},{xm},{x2}), not "
                f"(x,y,x) — the paired first/last entries must be equal"
            )
        # staircase check
        for d in range(mb - 1):
            col = base[:, kb + 1 + d]
            nz = np.flatnonzero(col >= 0)
            if not (len(nz) == 2 and list(nz) == [d, d + 1] and col[d] == 0 and col[d + 1] == 0):
                raise ValueError(f"{spec.name}: parity column {kb+1+d} is not staircase")
        info_edges = tuple(
            (int(i), int(j), int(base[i, j]))
            for i in range(mb)
            for j in range(kb)
            if base[i, j] >= 0
        )
        return DualDiagonalPlan(
            Z=qc.Z, mb=mb, kb=kb, special_shift=int(x0),
            special_mid_row=int(rows[1]), info_edges=info_edges,
            special_mid_shift=int(xm),
        )


class DualDiagonalEncoder:
    """Batched device encoder: msg [B, kb*Z] -> codeword [B, nb*Z]."""

    def __init__(self, spec: CodeSpec, validate: bool = True):
        self.plan = DualDiagonalPlan.from_spec(spec)
        self.spec = spec
        self.k = self.plan.kb * self.plan.Z
        self.n = (self.plan.kb + self.plan.mb) * self.plan.Z
        self._encode = jax.jit(self._encode_impl)
        if validate:
            # validate with the host-side NumPy twin (no device compile in
            # the constructor — unnecessary for a structural self-check)
            rng = np.random.default_rng(0)
            msg = rng.integers(0, 2, (4, self.k), dtype=np.uint8)
            cw = self.encode_numpy(msg)
            if not spec.check_syndrome(cw):
                raise AssertionError(f"{spec.name}: structured encode violates H")

    def __call__(self, msg_bits: jax.Array) -> jax.Array:
        return self._encode(msg_bits)

    def extract_message(self, codeword_bits: jax.Array) -> jax.Array:
        return codeword_bits[..., : self.k]

    def encode_numpy(self, msg_bits: np.ndarray) -> np.ndarray:
        """Host-side NumPy twin of _encode_impl (validation / tests)."""
        p = self.plan
        B = msg_bits.shape[0]
        u = msg_bits.T.astype(np.uint8).reshape(p.kb, p.Z, B)
        s = np.zeros((p.mb, p.Z, B), np.uint8)
        for i, j, sh in p.info_edges:
            s[i] ^= np.roll(u[j], -sh, axis=0)
        # P^y p0 = sum(s)  =>  p0 = roll(sum, +y)  (y = 0 for most tables)
        p0 = np.roll(s.sum(axis=0) % 2, p.special_mid_shift, axis=0)
        p0_mid = np.roll(p0, -p.special_mid_shift, axis=0)  # P^y p0
        parity = [p0.astype(np.uint8)]
        prev = s[0] ^ np.roll(p0, -p.special_shift, axis=0)
        parity.append(prev.astype(np.uint8))
        for d in range(1, p.mb - 1):
            nxt = prev ^ s[d]
            if d == p.special_mid_row:
                nxt = nxt ^ p0_mid
            parity.append(nxt.astype(np.uint8))
            prev = nxt
        par = np.stack(parity).reshape(p.mb * p.Z, B)
        return np.concatenate([msg_bits.T.astype(np.uint8), par]).T

    def _encode_impl(self, msg_bits):
        p = self.plan
        B = msg_bits.shape[0]
        u = msg_bits.T.astype(jnp.uint8).reshape(p.kb, p.Z, B)
        s = [jnp.zeros((p.Z, B), jnp.uint8) for _ in range(p.mb)]
        for i, j, sh in p.info_edges:
            # check r of block-row i sees variable (r + sh) % Z: the check-
            # aligned view of slab u_j is roll(u_j, -sh)
            s[i] = s[i] ^ jnp.roll(u[j], -sh, axis=0)
        p0 = s[0]
        for i in range(1, p.mb):
            p0 = p0 ^ s[i]
        # P^y p0 = sum(s)  =>  p0 = roll(sum, +y)  (y = 0 for most tables)
        p0 = jnp.roll(p0, p.special_mid_shift, axis=0)
        p0_mid = jnp.roll(p0, -p.special_mid_shift, axis=0)  # P^y p_0
        parity = [p0]
        # row 0: s_0 + P^x p_0 + p_1 = 0
        prev = s[0] ^ jnp.roll(p0, -p.special_shift, axis=0)
        parity.append(prev)
        for d in range(1, p.mb - 1):
            nxt = prev ^ s[d]
            if d == p.special_mid_row:
                nxt = nxt ^ p0_mid
            parity.append(nxt)
            prev = nxt
        par = jnp.stack(parity).reshape(p.mb * p.Z, B)
        return jnp.concatenate([msg_bits.T.astype(jnp.uint8), par]).T


class StaircaseEncoder:
    """IRA/accumulator encoder for QC staircase parity (DVB-S2 shape):
    parity block-col d hits block-rows d and d+1 with shift 0 (last col only
    row mb-1). Then p_0 = s_0 and p_d = p_{d-1} ^ s_d — an O(n) accumulator,
    mirroring the standard's bit-level accumulator (ETSI EN 302 307 §5.3.2).
    """

    def __init__(self, spec: CodeSpec, validate: bool = True):
        qc = spec.qc
        if qc is None:
            raise ValueError(f"{spec.name}: not a QC code")
        base = getattr(qc, "base", None)
        if base is None:  # multi-edge QCMultiCode: no structured skeleton
            raise ValueError(f"{spec.name}: multi-edge QC, no base matrix")
        mb, nb = base.shape
        kb = nb - mb
        for d in range(mb):
            col = base[:, kb + d]
            nz = np.flatnonzero(col >= 0)
            want = [d, d + 1] if d < mb - 1 else [mb - 1]
            if list(nz) != want or any(col[nz] != 0):
                raise ValueError(f"{spec.name}: parity col {kb+d} not staircase")
        self.spec = spec
        self.Z, self.mb, self.kb = qc.Z, mb, kb
        self.k = kb * qc.Z
        self.n = nb * qc.Z
        self.info_edges = tuple(
            (int(i), int(j), int(base[i, j]))
            for i in range(mb) for j in range(kb) if base[i, j] >= 0
        )
        self._encode = jax.jit(self._encode_impl)
        if validate:
            rng = np.random.default_rng(0)
            msg = rng.integers(0, 2, (2, self.k), dtype=np.uint8)
            if not spec.check_syndrome(self.encode_numpy(msg)):
                raise AssertionError(f"{spec.name}: staircase encode violates H")

    def __call__(self, msg_bits):
        return self._encode(msg_bits)

    def extract_message(self, codeword_bits):
        return codeword_bits[..., : self.k]

    def _syndromes_numpy(self, u):
        s = np.zeros((self.mb, self.Z, u.shape[-1]), np.uint8)
        for i, j, sh in self.info_edges:
            s[i] ^= np.roll(u[j], -sh, axis=0)
        return s

    def encode_numpy(self, msg_bits: np.ndarray) -> np.ndarray:
        B = msg_bits.shape[0]
        u = msg_bits.T.astype(np.uint8).reshape(self.kb, self.Z, B)
        s = self._syndromes_numpy(u)
        p = np.zeros_like(s)
        p[0] = s[0]
        for d in range(1, self.mb):
            p[d] = p[d - 1] ^ s[d]
        par = p.reshape(self.mb * self.Z, B)
        return np.concatenate([msg_bits.T.astype(np.uint8), par]).T

    def _encode_impl(self, msg_bits):
        B = msg_bits.shape[0]
        u = msg_bits.T.astype(jnp.uint8).reshape(self.kb, self.Z, B)
        s = [jnp.zeros((self.Z, B), jnp.uint8) for _ in range(self.mb)]
        for i, j, sh in self.info_edges:
            s[i] = s[i] ^ jnp.roll(u[j], -sh, axis=0)
        parity = [s[0]]
        for d in range(1, self.mb):
            parity.append(parity[-1] ^ s[d])
        par = jnp.stack(parity).reshape(self.mb * self.Z, B)
        return jnp.concatenate([msg_bits.T.astype(jnp.uint8), par]).T


class NRCoreExtensionEncoder:
    """5G NR encoder (38.212 shape): solve the 4-row dual-diagonal core
    parity, then extension parities drop out directly (their columns are
    degree-1 identities). O(n), roll/XOR only. Handles filler bits: the
    message is k bits, the info-section tail (shortened_cols) is zero.
    """

    def __init__(self, spec: CodeSpec, validate: bool = True):
        qc = spec.qc
        if qc is None:
            raise ValueError(f"{spec.name}: not a QC code")
        base = getattr(qc, "base", None)
        if base is None:  # multi-edge QCMultiCode: no structured skeleton
            raise ValueError(f"{spec.name}: multi-edge QC, no base matrix")
        mb, nb = base.shape
        # infer kb: parity section = 4 core + (mb-4) identity columns
        kb = nb - mb
        if mb < 5:
            raise ValueError(f"{spec.name}: too few rows for NR structure")
        # Core structure is defined by rows 0..3 only; extension rows may
        # also touch the core-parity columns (as in the real BGs) — those
        # entries are ordinary row_edges handled after the core solve.
        core = base[:4]
        col = core[:, kb]
        nz = np.flatnonzero(col >= 0)
        # special column at rows (0, rm, 3): BG1 has rm=1, BG2 rm=2
        # (38.212 Tables 5.3.2-2/-3). Paired first/last shifts (x, _, x)
        # cancel in the 4-row sum, leaving P^y p0 = sum(s) with y the
        # mid-row shift.
        if not (len(nz) == 3 and nz[0] == 0 and nz[2] == 3
                and col[nz[0]] == col[nz[2]]):
            raise ValueError(f"{spec.name}: no NR core special column")
        self._mid_row = int(nz[1])
        self._mid_shift = int(col[nz[1]])
        self._special_shift = int(col[0])
        for d, rows in [(1, [0, 1]), (2, [1, 2]), (3, [2, 3])]:
            c = core[:, kb + d]
            nz = np.flatnonzero(c >= 0)
            if not (list(nz) == rows and not c[nz].any()):
                raise ValueError(f"{spec.name}: core col {d} not staircase")
        for r in range(4, mb):
            c = base[:, kb + 4 + (r - 4)]
            nz = np.flatnonzero(c >= 0)
            if not (list(nz) == [r] and c[r] == 0):
                raise ValueError(f"{spec.name}: extension col for row {r} missing")
        self.spec = spec
        self.Z, self.mb, self.kb = qc.Z, mb, kb
        self.k = spec.k
        self.n = nb * qc.Z
        self.k_full = kb * qc.Z
        # per-row entries over info + core-parity columns (j < kb+4)
        self.row_edges = tuple(
            tuple((int(j), int(base[i, j])) for j in range(kb + 4)
                  if base[i, j] >= 0 and not (i < 4 and j >= kb))
            for i in range(mb)
        )
        self._encode = jax.jit(self._encode_impl)
        if validate:
            rng = np.random.default_rng(0)
            msg = rng.integers(0, 2, (2, self.k), dtype=np.uint8)
            cw = self.encode_numpy(msg)
            if not spec.check_syndrome(cw):
                raise AssertionError(f"{spec.name}: NR encode violates H")

    def __call__(self, msg_bits):
        return self._encode(msg_bits)

    def extract_message(self, codeword_bits):
        return codeword_bits[..., : self.k]

    def _solve(self, u, roll, zeros, stack):
        """Shared core/extension solve; u: [kb+4 blocks grow] slabs list."""
        Z, kb = self.Z, self.kb
        s = [zeros() for _ in range(self.mb)]
        for i in range(4):
            for j, sh in self.row_edges[i]:
                s[i] = s[i] ^ roll(u[j], -sh)
        # 4-row sum: staircase pairs cancel, the (x,_,x) special pair
        # cancels, leaving P^y p0 = s0+s1+s2+s3
        ssum = s[0] ^ s[1] ^ s[2] ^ s[3]
        p0 = roll(ssum, self._mid_shift)
        p1 = s[0] ^ roll(p0, -self._special_shift)
        p2 = s[1] ^ p1 ^ (ssum if self._mid_row == 1 else zeros())
        p3 = s[2] ^ p2 ^ (ssum if self._mid_row == 2 else zeros())
        core = [p0, p1, p2, p3]
        cols = u + core
        ext = []
        for r in range(4, self.mb):
            sr = zeros()
            for j, sh in self.row_edges[r]:
                sr = sr ^ roll(cols[j], -sh)
            ext.append(sr)
        return stack(core + ext)

    def encode_numpy(self, msg_bits: np.ndarray) -> np.ndarray:
        B = msg_bits.shape[0]
        full = np.zeros((B, self.k_full), np.uint8)
        full[:, : self.k] = msg_bits
        u = [full.T[j * self.Z : (j + 1) * self.Z] for j in range(self.kb)]
        par = self._solve(
            u, lambda x, s: np.roll(x, s, axis=0),
            lambda: np.zeros((self.Z, B), np.uint8),
            lambda slabs: np.concatenate(slabs, axis=0),
        )
        return np.concatenate([full.T, par]).T

    def _encode_impl(self, msg_bits):
        B = msg_bits.shape[0]
        full = jnp.zeros((B, self.k_full), jnp.uint8)
        full = full.at[:, : self.k].set(msg_bits.astype(jnp.uint8))
        u = [full.T[j * self.Z : (j + 1) * self.Z] for j in range(self.kb)]
        par = self._solve(
            u, lambda x, s: jnp.roll(x, s, axis=0),
            lambda: jnp.zeros((self.Z, B), jnp.uint8),
            lambda slabs: jnp.concatenate(slabs, axis=0),
        )
        return jnp.concatenate([full.T, par]).T


def build_encoder(spec: CodeSpec):
    """Pick the right encoder for a code: structured when the QC skeleton
    allows it (dual-diagonal, staircase, or NR core+extension), dense
    generator otherwise. Tail-shortened codes (codes/puncture.shorten) get
    the mother encoder wrapped with zero-fill."""
    enc = None
    if spec.qc is not None:
        for cls in (DualDiagonalEncoder, StaircaseEncoder, NRCoreExtensionEncoder):
            try:
                enc = cls(spec)
                break
            except ValueError:
                pass
    if enc is None:
        from .dense import DenseEncoder

        enc = DenseEncoder.build(spec)
    enc_k = enc.k
    if enc_k != spec.k and spec.shortened_cols:
        tail = tuple(range(spec.k, enc_k))
        if tuple(spec.shortened_cols[-len(tail):]) == tail:
            from ..codes.puncture import ShortenedEncoder

            return ShortenedEncoder(enc, spec)
    return enc
