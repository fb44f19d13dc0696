"""Decoded-bits/s scaling study: 1 device -> 1 host -> N hosts
(BASELINE.json:5 "scaling efficiency"; SURVEY.md §2.2 C24).

Batch-parallel scaling: codeword batches sharded over the 'batch' mesh axis
(zero cross-device traffic in the decode hot loop — SURVEY.md §5.7 mode 1),
decoder replicated per shard via shard_map. Efficiency(d) =
throughput(d) / (d * throughput(1)); ideal is 1.0 because decode is
embarrassingly batch-parallel — measured numbers expose runtime/dispatch
overheads only.

Usage: python -m ecc_ldpc_tpu.bench.scaling [--code ...] [--decoder ...]
Across hosts, launch one process per host (jax.distributed auto-init
under a cluster manager) and the study spans all global devices.
"""
from __future__ import annotations

import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

P = jax.sharding.PartitionSpec


def sharded_decoder(dec, mesh):
    """Wrap a per-shard decode callable for a batch-sharded mesh."""
    from ..decode.types import DecodeResult

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P("batch"),
        out_specs=DecodeResult(
            bits=P("batch"), ok=P("batch"), iterations=P("batch")
        ),
    )
    def decode(llr):
        return dec(llr)

    return decode


def run_scaling(
    code: str = "mackay1008",
    decoder: str = "minsum/norm:0.8125/25/noet",
    batch_per_device: int = 256,
    device_counts=None,
    tries: int = 3,
):
    from ..codes import get_code
    from ..decode import get_decoder
    from ..decode.api import choose_graph

    spec = get_code(code)
    graph = choose_graph(spec, decoder)
    devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    results = []
    base = None
    for d in device_counts:
        mesh = jax.sharding.Mesh(np.asarray(devices[:d]).reshape(d), ("batch",))
        dec = get_decoder(graph, decoder, jit=False)
        sdec = sharded_decoder(dec, mesh)
        B = batch_per_device * d
        llr = jax.device_put(
            jax.random.normal(jax.random.key(0), (B, spec.n)) * 3,
            jax.sharding.NamedSharding(mesh, P("batch")),
        )
        # the same timing as the headline bench (throughput.time_compiled)
        from .throughput import time_compiled

        _, wall, _ = time_compiled(sdec, llr, tries=tries)
        thr = B * spec.k / wall / 1e6
        if base is None:
            base = thr
        results.append(dict(
            devices=d, batch=B, wall_s=wall, mbps=round(thr, 2),
            efficiency=round(thr / (base * d), 4),
        ))
    return results


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--code", default="mackay1008")
    p.add_argument("--decoder", default="minsum/norm:0.8125/25/noet")
    p.add_argument("--batch-per-device", type=int, default=256)
    args = p.parse_args(argv)
    for row in run_scaling(args.code, args.decoder, args.batch_per_device):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
