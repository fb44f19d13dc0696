"""Check-node update rules over the padded [m, dc_max, B] message layout.

Each op maps variable-to-check messages V (masked) to check-to-variable
messages C with the leave-one-out semantics of BP: C[i,j] aggregates V[i,k]
for all k != j in check i. These are the functional equivalents of the
reference's tanh
sum-product (its MATLAB-ported Reference tier) and its "eliminate tanh"
min-sum tier (SURVEY.md §2.1 R6, R8).

Shapes: V [m, dc, B] float32; mask [m, dc, 1] bool. Padded slots produce 0.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Magnitude cap: keeps padded-slot +inf out of arithmetic (inf - inf = nan in
# the VN update) without affecting real LLRs, which stay far below this.
_MAG_CAP = 1e12
# tanh(x/2) saturates to 1.0 in f32 near x=18; clip keeps arctanh finite.
_TANH_CLIP = 1.0 - 1e-7


def _signs(V, mask):
    s = jnp.where(V < 0, -1.0, 1.0)
    return jnp.where(mask, s, 1.0)


def cn_minsum(V, mask, *, alpha: float = 1.0, beta: float = 0.0):
    """Two-min + sign-product CN update; alpha scales (normalized min-sum),
    beta subtracts (offset min-sum), both applied to the leave-one-out min."""
    s = _signs(V, mask)
    a = jnp.where(mask, jnp.abs(V), jnp.inf)
    sgn_prod = jnp.prod(s, axis=1, keepdims=True)
    min1 = jnp.min(a, axis=1, keepdims=True)
    # exclude exactly one occurrence of the minimum (ties: the first)
    idx = jnp.argmin(a, axis=1)  # [m, B]
    onehot = jax.nn.one_hot(idx, a.shape[1], axis=1, dtype=jnp.bool_)
    min2 = jnp.min(jnp.where(onehot, jnp.inf, a), axis=1, keepdims=True)
    mag = jnp.where(onehot, min2, min1)
    mag = jnp.minimum(mag, _MAG_CAP)
    mag = jnp.maximum(alpha * mag - beta, 0.0)
    C = (sgn_prod * s) * mag
    return jnp.where(mask, C, 0.0)


def cn_spa(V, mask):
    """Exact sum-product (tanh rule), leave-one-out via log|tanh| sums."""
    s = _signs(V, mask)
    a = jnp.where(mask, jnp.abs(V), jnp.inf)
    # log(tanh(a/2)) in [-inf, 0); clip a away from 0 to keep it finite.
    lt = jnp.log(jnp.tanh(jnp.clip(a, 1e-10, 40.0) * 0.5))
    lt = jnp.where(mask, lt, 0.0)
    loo = jnp.sum(lt, axis=1, keepdims=True) - lt
    t = jnp.clip(jnp.exp(loo), None, _TANH_CLIP)
    mag = 2.0 * jnp.arctanh(t)
    sgn_prod = jnp.prod(s, axis=1, keepdims=True)
    C = (sgn_prod * s) * mag
    return jnp.where(mask, C, 0.0)


def _boxplus(x, y):
    """Exact pairwise box-plus (minstar): sign(x)sign(y)min(|x|,|y|) plus the
    dual log-correction terms — the Jacobian form of the tanh rule."""
    mag = jnp.minimum(jnp.abs(x), jnp.abs(y))
    sgn = jnp.where((x < 0) ^ (y < 0), -1.0, 1.0)
    corr = jnp.log1p(jnp.exp(-jnp.abs(x + y))) - jnp.log1p(
        jnp.exp(-jnp.abs(x - y))
    )
    return sgn * mag + corr


def cn_minstar(V, mask):
    """Exact sum-product via minstar (box-plus) forward/backward prefix
    scans — numerically equivalent to cn_spa up to fp rounding; the form
    optimized decoders approximate by dropping the correction terms
    (which recovers plain min-sum)."""
    dc = V.shape[1]
    big = 1e9  # identity element: boxplus(big, x) ~= x
    Vm = jnp.where(mask, V, big)
    fwd = [Vm[:, 0]]
    for j in range(1, dc):
        fwd.append(_boxplus(fwd[-1], Vm[:, j]))
    bwd = [Vm[:, dc - 1]]
    for j in range(dc - 2, -1, -1):
        bwd.insert(0, _boxplus(bwd[0], Vm[:, j]))
    outs = []
    for j in range(dc):
        if j == 0:
            outs.append(bwd[1] if dc > 1 else jnp.full_like(Vm[:, 0], big))
        elif j == dc - 1:
            outs.append(fwd[dc - 2])
        else:
            outs.append(_boxplus(fwd[j - 1], bwd[j + 1]))
    C = jnp.stack(outs, axis=1)
    return jnp.where(mask, jnp.clip(C, -_MAG_CAP, _MAG_CAP), 0.0)


def get_cn_op(kind: str, **params):
    """Resolve a CN-op name: 'spa', 'minstar', 'minsum', 'norm-minsum',
    'offset-minsum'."""
    if kind == "minstar":
        return cn_minstar
    if kind == "spa":
        return cn_spa
    if kind == "minsum":
        return functools.partial(cn_minsum, **params)
    if kind == "norm-minsum":
        return functools.partial(cn_minsum, alpha=params.get("alpha", 0.8125))
    if kind == "offset-minsum":
        return functools.partial(cn_minsum, beta=params.get("beta", 0.15))
    raise KeyError(f"unknown CN op {kind!r}")
