"""Interleaved A/B throughput comparison — the only valid way to compare.

Absolute device timings drift between runs and machines (clocks under a
power limit, neighbours on a shared host, which card a run lands on), so
"A measured yesterday vs B measured today" is noise. Valid comparisons
interleave A and B in ONE process, alternating timing rounds so drift
hits both arms equally, and report the ratio. This module packages that
discipline.
"""
from __future__ import annotations

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class ABResult:
    labels: list
    mbps: list  # per-arm median throughput
    ratios: list  # per-arm throughput relative to arm 0
    reps: int

    def json_line(self) -> str:
        return json.dumps({
            "metric": "ab_compare",
            "arms": [
                {"label": l, "mbps": round(m, 3), "vs_arm0": round(r, 4)}
                for l, m, r in zip(self.labels, self.mbps, self.ratios)
            ],
            "reps": self.reps,
        })


def _build_arm(code: str, decoder: str, batch: int, ebn0_db: float,
               chain: int):
    from ..chan.modem import build_channel
    from ..codes import get_code
    from ..decode import get_decoder
    from ..decode.api import choose_graph
    from ..encode.structured import build_encoder

    spec = get_code(code)
    dec = get_decoder(choose_graph(spec, decoder), decoder, jit=False)
    enc = build_encoder(spec)
    channel = build_channel(spec)
    key = jax.random.key(0)
    msg = jax.random.bernoulli(key, 0.5, (batch, spec.k)).astype(jnp.uint8)
    llr = channel(jax.random.fold_in(key, 1), enc(msg), ebn0_db)

    @jax.jit
    def run(llr):
        def body(_, l):
            res = dec(l)
            return l + 1e-9 * res.bits.astype(jnp.float32)
        out = jax.lax.fori_loop(0, chain, body, llr)
        return jnp.sum(out[:, 0])

    bits_per_call = batch * spec.k * chain
    return run, llr, bits_per_call


def ab_compare(arms, *, batch: int = 1024, ebn0_db: float = 2.5,
               chain: int = 10, reps: int = 5) -> ABResult:
    """arms: [(code, decoder), ...]. Builds and warms every arm first,
    then runs `reps` interleaved timing rounds (arm order fixed within a
    round so each rep samples the same drift window for all arms)."""
    built = []
    for code, decoder in arms:
        run, llr, bits = _build_arm(code, decoder, batch, ebn0_db, chain)
        jax.block_until_ready(run(llr))  # compile + warm
        built.append((run, llr, bits))
    times = [[] for _ in arms]
    for _ in range(reps):
        for i, (run, llr, _) in enumerate(built):
            t0 = time.perf_counter()
            jax.block_until_ready(run(llr))
            times[i].append(time.perf_counter() - t0)
    mbps = [b / float(np.median(t)) / 1e6
            for (_, _, b), t in zip(built, times)]
    return ABResult(
        labels=[f"{c}|{d}" for c, d in arms],
        mbps=mbps,
        ratios=[m / mbps[0] for m in mbps],
        reps=reps,
    )
