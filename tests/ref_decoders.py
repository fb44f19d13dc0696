"""Plain-numpy reference decoders: the XLA tiers' algorithms written out
loop by loop in float32, independent of the code under test.

Each mirrors one tier's operation order (which f32 sums run first, which
sign convention, which freeze rule), so that on the CPU the tier must give
the same hard decisions, ok flags and iteration counts:

  layered_qc(graph, llr, ...)    decode/xla/layered.py    (QCGraph)
  flooding_qc(graph, llr, ...)   decode/xla/flooding_qc.py (QCGraph)
  flooding(graph, llr, ...)      decode/xla/flooding.py   (CompiledGraph)

All take llr [B, n] and return (bits uint8 [B, n], ok bool [B],
iterations int32 [B]).
"""
from __future__ import annotations

import numpy as np

F = np.float32
MAG_CAP = F(1e12)
TANH_CLIP = F(1.0 - 1e-7)
BIG = F(1e9)  # box-plus identity


# --- block permutations ----------------------------------------------------

def _perm_index(Z, s, perm, to_var):
    i = np.arange(Z)
    if perm == "xor":
        return i ^ s
    return (i - s) % Z if to_var else (i + s) % Z


def to_check(x, s, Z, perm):
    """Variable-aligned -> check-aligned view of a [Z, B] slab."""
    return x[_perm_index(Z, s, perm, to_var=False)]


def to_var(x, s, Z, perm):
    """Check-aligned -> variable-aligned view of a [Z, B] slab."""
    return x[_perm_index(Z, s, perm, to_var=True)]


# --- check-node rules over axis 0 of [d, Z, B] -----------------------------

def _sign_product(neg):
    cnt = neg.sum(axis=0, keepdims=True)
    return np.where(cnt % 2 == 1, F(-1), F(1)), np.where(neg, F(-1), F(1))


def cn_minsum(V, alpha, beta, signbit=False):
    """Leave-one-out two-min rule; ties at the minimum keep min1."""
    prod, s = _sign_product(np.signbit(V) if signbit else V < 0)
    a = np.abs(V)
    min1 = a.min(axis=0, keepdims=True)
    is_min = a == min1
    count_min = is_min.sum(axis=0, keepdims=True)
    min2 = np.where(is_min, F(np.inf), a).min(axis=0, keepdims=True)
    mag = np.where(is_min & (count_min == 1), min2, min1)
    mag = np.minimum(mag, MAG_CAP)
    mag = np.maximum(F(alpha) * mag - F(beta), F(0))
    return (prod * s) * mag


def _log_tanh(V):
    a = np.abs(V)
    return np.log(np.tanh(np.clip(a, F(1e-10), F(40.0)) * F(0.5)))


def cn_spa_seq(V, signbit=False):
    """Tanh rule, log|tanh| summed in edge order; 2 atanh(t) as
    log1p(t) - log1p(-t) (the layered tier's form)."""
    lt = _log_tanh(V)
    acc = lt[0]
    for j in range(1, len(V)):
        acc = acc + lt[j]
    t = np.minimum(np.exp(acc[None] - lt), TANH_CLIP)
    mag = np.log1p(t) - np.log1p(-t)
    prod, s = _sign_product(np.signbit(V) if signbit else V < 0)
    return (prod * s) * mag


def cn_spa_sum(V):
    """Tanh rule with 2 atanh(t) (the flooding QC tier's form)."""
    lt = _log_tanh(V)
    acc = lt[0]
    for j in range(1, len(V)):
        acc = acc + lt[j]
    t = np.minimum(np.exp(acc[None] - lt), TANH_CLIP)
    mag = F(2.0) * np.arctanh(t)
    prod, s = _sign_product(V < 0)
    return (prod * s) * mag


def boxplus(x, y):
    mag = np.minimum(np.abs(x), np.abs(y))
    sgn = np.where((x < 0) ^ (y < 0), F(-1), F(1))
    corr = (np.log1p(np.exp(-np.abs(x + y)))
            - np.log1p(np.exp(-np.abs(x - y))))
    return sgn * mag + corr


def cn_minstar(V):
    """Box-plus forward/backward scans, leave-one-out."""
    d = len(V)
    fwd = [V[0]]
    for j in range(1, d):
        fwd.append(boxplus(fwd[-1], V[j]))
    bwd = [V[d - 1]]
    for j in range(d - 2, -1, -1):
        bwd.insert(0, boxplus(bwd[0], V[j]))
    outs = []
    for j in range(d):
        if j == 0:
            outs.append(bwd[1] if d > 1 else np.full_like(V[0], BIG))
        elif j == d - 1:
            outs.append(fwd[d - 2])
        else:
            outs.append(boxplus(fwd[j - 1], bwd[j + 1]))
    return np.clip(np.stack(outs), -MAG_CAP, MAG_CAP)


# --- QC graphs -------------------------------------------------------------

def _qc_syndrome_fail(graph, total):
    hard = (total < 0).astype(F)
    fail = np.zeros(total.shape[-1], bool)
    for i in range(graph.mb):
        acc = np.zeros_like(hard[0])
        for e, col, s in graph.layer_edges(i):
            acc = acc + to_check(hard[col], s, graph.Z, graph.perm)
        fail |= (acc % 2 > 0.5).any(axis=0)
    return fail


def _qc_out(graph, total, iters):
    B = total.shape[-1]
    bits = (total.reshape(graph.n, B) < 0).astype(np.uint8).T
    return bits, ~_qc_syndrome_fail(graph, total), iters.astype(np.int32)


def layered_qc(graph, llr, *, alpha=1.0, beta=0.0, max_iters=25,
               early_term=True, sign_mode="bitxor", cn="minsum"):
    """Layered sweep in graph.layer_order with the on-the-fly syndrome +
    zero-sign-flip freeze criterion."""
    Z, nb, perm = graph.Z, graph.nb, graph.perm
    B = llr.shape[0]
    dup_free = graph.intra_layer_dup_free
    signbit = sign_mode == "bitxor" and dup_free
    alphas = np.broadcast_to(np.asarray(alpha, F), (max_iters,))
    betas = np.broadcast_to(np.asarray(beta, F), (max_iters,))
    layers = [graph.layer_edges(i) for i in graph.layer_order]

    def sweep(total, C, t):
        total, C = total.copy(), C.copy()
        fail = np.zeros(B, bool)
        flip = np.zeros(B, bool)
        for edges in layers:
            rolled = [to_check(total[col], s, Z, perm) for _, col, s in edges]
            acc = np.zeros_like(rolled[0])
            for r in rolled:
                acc = acc + (r < 0).astype(F)
            fail |= (acc % 2 > 0.5).any(axis=0)
            Vt = np.stack([r - C[e] for r, (e, _, _) in zip(rolled, edges)])
            if cn == "minsum":
                Cnew = cn_minsum(Vt, alphas[t], betas[t], signbit)
            elif cn == "spa":
                Cnew = cn_spa_seq(Vt, signbit)
            else:
                Cnew = cn_minstar(Vt)
            order = range(len(edges))
            if cn == "minstar" and not dup_free:
                order = reversed(order)
            for j in order:
                e, col, s = edges[j]
                if dup_free:
                    new = Vt[j] + Cnew[j]
                    flip |= (np.signbit(new) != np.signbit(rolled[j])).any(0)
                    total[col] = to_var(new, s, Z, perm)
                else:
                    old = total[col].copy()  # a basic index is a view
                    total[col] = old + to_var(Cnew[j] - C[e], s, Z, perm)
                    flip |= (np.signbit(total[col]) != np.signbit(old)).any(0)
                C[e] = Cnew[j]
        return total, C, fail | flip

    total = np.asarray(llr, F).T.reshape(nb, Z, B).copy()
    C = np.zeros((graph.num_block_edges, Z, B), F)
    if not early_term:
        for t in range(max_iters):
            total, C, _ = sweep(total, C, t)
        return _qc_out(graph, total, np.full(B, max_iters))
    done = ~_qc_syndrome_fail(graph, total)
    iters = np.zeros(B, np.int32)
    t = 0
    while t < max_iters and not done.all():
        new_total, new_C, fail = sweep(total, C, t)
        total = np.where(done[None, None], total, new_total)
        C = np.where(done[None, None], C, new_C)
        iters = np.where(done, iters, iters + 1)
        done = done | ~fail
        t += 1
    return _qc_out(graph, total, iters)


def flooding_qc(graph, llr, *, kind="minsum", alpha=1.0, beta=0.0,
                max_iters=25, early_term=True):
    """Flooding on the QC view: CN from stale totals, posteriors rebuilt
    as llr + rolled messages; a frame whose PRE-sweep parity passes is
    frozen at its pre-sweep state."""
    Z, nb, perm = graph.Z, graph.nb, graph.perm
    B = llr.shape[0]
    layers = [graph.layer_edges(i) for i in graph.layer_order]
    llr3 = np.asarray(llr, F).T.reshape(nb, Z, B).copy()

    def sweep(total, C):
        acc, newC = llr3.copy(), C.copy()
        fail = np.zeros(B, bool)
        for edges in layers:
            rolled = [to_check(total[col], s, Z, perm) for _, col, s in edges]
            h = np.zeros_like(rolled[0])
            for r in rolled:
                h = h + (r < 0).astype(F)
            fail |= (h % 2 > 0.5).any(axis=0)
            V = np.stack([r - C[e] for r, (e, _, _) in zip(rolled, edges)])
            if kind == "minsum":
                Cnew = cn_minsum(V, alpha, beta)
            elif kind == "spa":
                Cnew = cn_spa_sum(V)
            else:
                Cnew = cn_minstar(V)
            for j, (e, col, s) in enumerate(edges):
                acc[col] = acc[col] + to_var(Cnew[j], s, Z, perm)
                newC[e] = Cnew[j]
        return acc, newC, fail

    total = llr3.copy()
    C = np.zeros((graph.num_block_edges, Z, B), F)
    if not early_term:
        for _ in range(max_iters):
            total, C, _ = sweep(total, C)
        return _qc_out(graph, total, np.full(B, max_iters))
    done = ~_qc_syndrome_fail(graph, total)
    iters = np.zeros(B, np.int32)
    while iters.max() < max_iters and not done.all():
        new_total, new_C, fail = sweep(total, C)
        done_new = done | ~fail
        total = np.where(done_new[None, None], total, new_total)
        C = np.where(done[None, None], C, new_C)
        iters = np.where(done_new, iters, iters + 1)
        done = done_new
    return _qc_out(graph, total, iters)


# --- expanded (unstructured) graphs ----------------------------------------

def _gather_cn(kind, V, mask, alpha, beta):
    """CN rules of decode/xla/cn_ops.py over [m, dc, B] (slot axis 1)."""
    if kind == "minsum":
        s = np.where(mask, np.where(V < 0, F(-1), F(1)), F(1))
        a = np.where(mask, np.abs(V), F(np.inf))
        prod = np.prod(s, axis=1, keepdims=True)
        min1 = a.min(axis=1, keepdims=True)
        first = np.argmin(a, axis=1)  # ties: the first minimum is excluded
        onehot = np.arange(a.shape[1])[None, :, None] == first[:, None, :]
        min2 = np.where(onehot, F(np.inf), a).min(axis=1, keepdims=True)
        mag = np.minimum(np.where(onehot, min2, min1), MAG_CAP)
        mag = np.maximum(F(alpha) * mag - F(beta), F(0))
        return np.where(mask, (prod * s) * mag, F(0))
    if kind == "spa":
        s = np.where(mask, np.where(V < 0, F(-1), F(1)), F(1))
        a = np.where(mask, np.abs(V), F(np.inf))
        lt = np.where(mask, np.log(np.tanh(
            np.clip(a, F(1e-10), F(40.0)) * F(0.5))), F(0))
        acc = lt[:, 0]
        for j in range(1, lt.shape[1]):
            acc = acc + lt[:, j]
        t = np.minimum(np.exp(acc[:, None] - lt), TANH_CLIP)
        mag = F(2.0) * np.arctanh(t)
        return np.where(mask, (np.prod(s, axis=1, keepdims=True) * s) * mag,
                        F(0))
    Vm = np.where(mask, V, BIG)
    out = cn_minstar(np.moveaxis(Vm, 1, 0))
    return np.where(mask, np.moveaxis(out, 0, 1), F(0))


def flooding(graph, llr, *, kind="minsum", alpha=1.0, beta=0.0,
             max_iters=25, early_term=True):
    """Flooding on the expanded graph: messages in the padded check view
    [m, dc, B], VN sums in slot order over the padded variable view."""
    cn_vn = np.asarray(graph.cn_vn)
    mask = np.asarray(graph.cn_mask)[:, :, None]
    vn_edge = np.asarray(graph.vn_edge)
    vn_mask = np.asarray(graph.vn_mask)[:, :, None]
    m, dc = cn_vn.shape
    llr_t = np.asarray(llr, F).T.copy()
    B = llr_t.shape[1]

    def syndrome_fail(total):
        hard = (total < 0).astype(np.int32)
        par = np.where(mask, hard[cn_vn], 0).sum(axis=1) & 1
        return (par != 0).any(axis=0)

    def step(V):
        C = _gather_cn(kind, V, mask, alpha, beta)
        Cv = np.where(vn_mask, C.reshape(m * dc, B)[vn_edge], F(0))
        acc = Cv[:, 0]
        for j in range(1, Cv.shape[1]):
            acc = acc + Cv[:, j]
        total = llr_t + acc
        return np.where(mask, total[cn_vn] - C, F(0)), total

    V = np.where(mask, llr_t[cn_vn], F(0))
    total = llr_t.copy()
    if not early_term:
        for _ in range(max_iters):
            V, total = step(V)
        bits = (total < 0).astype(np.uint8).T
        return bits, ~syndrome_fail(total), np.full(B, max_iters, np.int32)
    done = ~syndrome_fail(total)
    iters = np.zeros(B, np.int32)
    while iters.max() < max_iters and not done.all():
        new_V, new_total = step(V)
        fail = syndrome_fail(new_total)
        V = np.where(done[None, None], V, new_V)
        total = np.where(done[None], total, new_total)
        iters = np.where(done, iters, iters + 1)
        done = done | ~fail
    return (total < 0).astype(np.uint8).T, done, iters
