"""Encoder and full-pipeline throughput (the numbers around the decoder).

The headline metric is decoded Mbit/s/chip (bench/throughput.py); a
production system also needs to know what the O(n) structured encoders
and the complete encode -> channel -> decode step sustain, since a slow
front-end would cap the pipeline no matter how fast the decoder is.
Timing matches bench/throughput.py: each step is compiled ahead of time,
then timed call by call with block_until_ready (time_compiled).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp

from .throughput import device_info, time_compiled


@dataclasses.dataclass
class PipelineBenchResult:
    encode_mbps: float  # info bits through the encoder
    pipeline_mbps: float  # info bits through encode+channel+decode
    decode_share: float  # fraction of pipeline time in the decoder
    code: str
    decoder: str
    batch: int
    device: dict

    def json_line(self) -> str:
        return json.dumps({
            "metric": "pipeline_throughput",
            "encode_mbps": round(self.encode_mbps, 1),
            "pipeline_mbps": round(self.pipeline_mbps, 3),
            "decode_share": round(self.decode_share, 4),
            "code": self.code,
            "decoder": self.decoder,
            "batch": self.batch,
            "device": self.device,
        })


def run_pipeline_benchmark(
    code: str = "dvbs2/64800/12",
    decoder: str = "layered/norm:0.8125/25/noet",
    batch: int = 1024,
    ebn0_db: float = 2.5,
    tries: int = 3,
) -> PipelineBenchResult:
    from ..chan.awgn import make_channel
    from ..codes import get_code
    from ..decode import get_decoder
    from ..decode.api import choose_graph
    from ..encode.structured import build_encoder

    spec = get_code(code)
    enc = build_encoder(spec)
    channel = make_channel(spec)
    dec = get_decoder(choose_graph(spec, decoder), decoder, jit=False)
    key = jax.random.key(0)
    msg = jax.random.bernoulli(key, 0.5, (batch, spec.k)).astype(jnp.uint8)

    def encode_step(msg):
        return enc(msg)

    def pipeline_step(msg):
        cw = enc(msg)
        llr = channel(jax.random.fold_in(key, 1), cw, ebn0_db)
        return enc.extract_message(dec(llr).bits)

    _, t_enc, _ = time_compiled(encode_step, msg, tries=tries)
    _, t_pipe, _ = time_compiled(pipeline_step, msg, tries=tries)
    bits = batch * spec.k
    return PipelineBenchResult(
        encode_mbps=bits / t_enc / 1e6,
        pipeline_mbps=bits / t_pipe / 1e6,
        decode_share=max(0.0, (t_pipe - t_enc) / t_pipe),
        code=code,
        decoder=decoder,
        batch=batch,
        device=device_info(),
    )
