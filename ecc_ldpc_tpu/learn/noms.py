"""Learned per-iteration normalized/offset min-sum (neural min-sum).

The technique of arXiv 1701.05931 (Neural Offset Min-Sum, one of the
driver-retrieved pattern papers, PAPERS.md) restated in JAX: the
layered min-sum decoder is an unrolled differentiable computation in JAX,
so the per-iteration normalization alpha_t and offset beta_t are just
parameters — train them by gradient descent through the decoder itself
(optax.adam on a soft-BER loss), no separate "neural network" machinery.

The trained schedule runs in PRODUCTION through the stock XLA layered
decoder, which accepts per-iteration alpha/beta arrays
(decode/xla/layered.py). `unrolled_posteriors` here is the
training twin of that decoder: same sweep order, same CN rule, but it
returns every iteration's soft posteriors for the multi-loss — a parity
test pins its hard decisions to decode_layered's (tests/learn/).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.qc import QCGraph

_MAG_CAP = 1e12


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NomsParams:
    """Per-iteration min-sum parameters (both length-T f32 arrays)."""

    alphas: jax.Array
    betas: jax.Array

    @property
    def iters(self) -> int:
        return len(self.alphas)


def _cn_minsum_soft(V, alpha, beta):
    """Leave-one-out two-min CN update over axis 0 of [d, Z, B], written
    with the same ops as the inference tier; min/where are differentiable
    a.e., which is all gradient training needs."""
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


def unrolled_posteriors(graph: QCGraph, llr, alphas, betas,
                        *, remat: bool = True):
    """Differentiable unrolled layered decode: llr [B, n] -> posteriors
    [T, B, n] (iteration t's post-sweep totals). Mirrors
    decode/xla/layered.py's dup-free sweep with sign_mode='count'.

    Iterations run under lax.scan with jax.checkpoint (remat=True): the
    backward pass stores only per-iteration boundary state and recomputes
    layer internals — what makes training through 25 iterations of
    n=64800 fit in HBM, and keeps the lowered module one-iteration-sized."""
    B = llr.shape[0]
    Z, nb = graph.Z, graph.nb
    total0 = llr.T.astype(jnp.float32).reshape(nb, Z, B)
    C0 = jnp.zeros((graph.num_block_edges, Z, B), jnp.float32)

    def one_iter(carry, ab_t):
        total, C = carry
        a_t, b_t = ab_t
        for i in graph.layer_order:
            edges = graph.layer_edges(i)
            rolled = [graph.to_check(total[col], s) for e, col, s in edges]
            Vt = jnp.stack([r - C[e] for r, (e, col, s) in zip(rolled, edges)])
            Cnew = _cn_minsum_soft(Vt, a_t, b_t)
            for j, (e, col, s) in enumerate(edges):
                total = total.at[col].set(graph.to_var(Vt[j] + Cnew[j], s))
                C = C.at[e].set(Cnew[j])
        return (total, C), total.reshape(nb * Z, B).T

    body = jax.checkpoint(one_iter) if remat else one_iter
    ab = jnp.stack([jnp.asarray(alphas, jnp.float32),
                    jnp.asarray(betas, jnp.float32)], axis=1)  # [T, 2]
    _, outs = jax.lax.scan(body, (total0, C0), ab)
    return outs  # [T, B, n]


def soft_ber_loss(posteriors, cw):
    """Multi-loss over iterations: mean softplus(-(1-2c)·total) — the
    binary cross-entropy of P(bit=1)=sigmoid(-total) against the
    transmitted codeword, summed over every unrolled iteration so early
    iterations receive gradient too (the NOMS paper's multiloss)."""
    sgn = 1.0 - 2.0 * cw.astype(jnp.float32)  # [B, n]
    return jnp.mean(jax.nn.softplus(-sgn[None] * posteriors))


def train_noms(
    code: str = "80211n/648/12",
    *,
    iters: int = 10,
    ebn0_range: tuple = (1.0, 3.0),
    steps: int = 200,
    batch: int = 64,
    lr: float = 2e-2,
    seed: int = 0,
    learn_alpha: bool = True,
    learn_beta: bool = True,
    init_alpha: float = 1.0,
    init_beta: float = 0.0,
):
    """Train per-iteration (alpha_t, beta_t) for `code`'s layered min-sum.

    Returns (NomsParams, losses). Parameters are clipped to the sane
    decoder region after every step (alpha in [0.5, 1.25], beta >= 0).
    Runs on whatever backend JAX is on (CPU for tests, GPU for speed).
    """
    import optax

    from ..chan.awgn import awgn_llr
    from ..codes import get_code
    from ..encode.structured import build_encoder
    from ..graph.qc import compile_qc_graph

    spec = get_code(code)
    graph = compile_qc_graph(spec)
    enc = build_encoder(spec)
    k, rate = spec.k, spec.rate

    params = NomsParams(
        alphas=jnp.full((iters,), float(init_alpha), jnp.float32),
        betas=jnp.full((iters,), float(init_beta), jnp.float32),
    )
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    lo, hi = ebn0_range

    def batch_loss(params, key):
        kmsg, kchan, ksnr = jax.random.split(key, 3)
        msg = jax.random.bernoulli(kmsg, 0.5, (batch, k)).astype(jnp.uint8)
        cw = enc(msg)
        ebn0 = jax.random.uniform(ksnr, (), minval=lo, maxval=hi)
        llr = awgn_llr(kchan, cw, ebn0, rate)
        post = unrolled_posteriors(graph, llr, params.alphas, params.betas)
        return soft_ber_loss(post, cw)

    @jax.jit
    def step(params, opt_state, key):
        loss, grads = jax.value_and_grad(batch_loss)(params, key)
        if not learn_alpha:
            grads = dataclasses.replace(grads, alphas=grads.alphas * 0)
        if not learn_beta:
            grads = dataclasses.replace(grads, betas=grads.betas * 0)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        params = NomsParams(
            alphas=jnp.clip(params.alphas, 0.5, 1.25),
            betas=jnp.maximum(params.betas, 0.0),
        )
        return params, opt_state, loss

    key = jax.random.key(seed)
    losses = []
    for s in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.fold_in(key, s))
        losses.append(float(loss))
    return params, np.asarray(losses)


def load_schedule(name: str) -> NomsParams:
    """Load a trained schedule: a shipped name (files in learn/schedules/,
    e.g. 'dvbs2_64800_12_T25') or a path to a schedule JSON (anything
    containing '/' or ending in '.json', e.g. from `ecc-sim learn --out`).
    Schedules are CODE-SPECIFIC — cross-length transfer was measured to
    fail (a schedule trained on dvbs2/16200 degrades dvbs2/64800) — and
    beta-bearing schedules are SNR-BAND-specific, because the offset is
    absolute while LLR scale grows with SNR; each file records its
    trained ebn0_range_db and the measured numbers."""
    import json
    import pathlib

    if "/" in name or name.endswith(".json"):
        path = pathlib.Path(name)
    else:
        path = pathlib.Path(__file__).parent / "schedules" / f"{name}.json"
    with open(path) as f:
        d = json.load(f)
    return NomsParams(
        alphas=jnp.asarray(d["alphas"], jnp.float32),
        betas=jnp.asarray(d["betas"], jnp.float32),
    )


def list_schedules() -> list:
    import pathlib

    p = pathlib.Path(__file__).parent / "schedules"
    return sorted(f.stem for f in p.glob("*.json"))
