"""Decoded-throughput benchmark: Mbit/s per device at fixed-iteration min-sum.

The primary metric (BASELINE.json:2): decoded Mbit/s per device, min-sum,
25 iterations. The decoder is compiled ahead of time (compile seconds are
set-up time, reported apart), then timed call by call with
block_until_ready, median of tries. Each result names the device it ran
on; a memory- or compute-bound ceiling for the decoder's form is computed
from the published peaks of that device (PEAKS), and is null on the CPU,
which has no entry.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    hbm_bytes_per_s: float
    bf16_flops: float  # dense tensor-core rate, no sparsity
    source: str


# Published peaks keyed by jax.devices()[0].device_kind. A GPU missing here
# is an error (device_peaks), never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        hbm_bytes_per_s=3.35e12, bf16_flops=989e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, H100 SXM (700 W)",
    ),
    "NVIDIA H100 PCIe": DevicePeaks(
        hbm_bytes_per_s=2.0e12, bf16_flops=756e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, H100 PCIe (350 W)",
    ),
}


def device_peaks(device=None) -> Optional[DevicePeaks]:
    """Peaks of `device` (default: the first device); None on the CPU."""
    device = device if device is not None else jax.devices()[0]
    if device.platform == "cpu":
        return None
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device.device_kind!r}: "
            f"add it to bench.throughput.PEAKS with its source"
        ) from None


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, e.g.
    'NVIDIA H100 80GB HBM3, 700.00 W'. A card below its maximum power
    limit runs slower under load, so every GPU number is reported beside
    this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it, plus the
    card's name and power limit on a GPU (None elsewhere)."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "name_power_limit": (
            gpu_name_and_power_limit() if d.platform == "gpu" else None
        ),
    }


@dataclasses.dataclass
class BenchResult:
    throughput_mbps: float
    code: str
    decoder: str
    batch: int
    iters: int
    k: int
    n: int
    num_edges: int
    wall_s_per_batch: float
    compile_s: float
    mean_iters: float
    roofline_mbps: Optional[float]
    roofline_form: str
    device: dict

    def json_line(self) -> str:
        return json.dumps(
            {
                "metric": "decoded_throughput",
                "value": round(self.throughput_mbps, 3),
                "unit": "Mbit/s/chip",
                "code": self.code,
                "decoder": self.decoder,
                "batch": self.batch,
                "iters": self.iters,
                "k_bits_per_frame": self.k,
                "wall_s_per_batch": self.wall_s_per_batch,
                "compile_s": self.compile_s,
                "mean_iters": self.mean_iters,
                "roofline_mbps": (None if self.roofline_mbps is None
                                  else round(self.roofline_mbps, 1)),
                "roofline_form": self.roofline_form,
                "device": self.device,
            }
        )


def roofline_mbps(num_edges: int, k: int, iters: int,
                  hbm_bytes_per_s: float, msg_bytes: int = 4) -> float:
    """Memory-bound ceiling of a decoder whose messages round-trip device
    memory every iteration: per frame per iteration ~4 touches of E
    messages (CN read+write, VN read+write). It is the bar for the roll and
    layered tiers; a kernel that keeps posteriors and messages on chip
    (shared memory, L2) can beat it, which is what it measures."""
    bytes_per_frame = 4.0 * num_edges * msg_bytes * iters
    frames_per_s = hbm_bytes_per_s / bytes_per_frame
    return frames_per_s * k / 1e6


def matmul_roofline_mbps(n: int, m: int, dc_max: int, k: int, iters: int,
                         flops: float) -> float:
    """Compute-bound ceiling of the incidence-matmul form
    (decode/xla/dense_mm.py): per iteration St@x [m*dc, n]@[n, B], S@C
    back, and the H@bits syndrome, at `flops` with zero fixed cost."""
    flops_per_frame = 2.0 * (2 * m * dc_max * n + m * n) * iters
    return flops / flops_per_frame * k / 1e6


def time_compiled(fn, *args, tries: int = 5) -> tuple:
    """(compile_s, step_s): ahead-of-time compile of jax.jit(fn) for
    `args`, then the median over `tries` warm calls, each ended by
    block_until_ready. Returns the compiled callable third."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))  # first run: allocation, autotune
    times = []
    for _ in range(tries):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return compile_s, float(np.median(times)), compiled


def run_benchmark(
    code: str = "mackay1008",
    decoder: str = "minsum/norm:0.8125/25/noet",
    batch: int = 1024,
    ebn0_db: float = 2.5,
    tries: int = 5,
    backend: Optional[str] = None,
    profile_dir: Optional[str] = None,
) -> BenchResult:
    from ..codes import get_code
    from ..decode import get_decoder
    from ..decode.api import choose_graph, parse_decoder_spec
    from ..encode.structured import build_encoder

    spec = get_code(code)
    kw = parse_decoder_spec(decoder)
    graph = choose_graph(spec, decoder, backend=backend)
    dec = get_decoder(graph, decoder, backend=backend or "auto", jit=False)
    iters = kw.get("max_iters", 25)
    peaks = device_peaks()  # fails early on a GPU missing from PEAKS

    # Realistic operating-point LLRs (the metric decodes real noisy frames).
    # Channel is puncture/shorten-aware (make_channel) so rate-matched
    # codes see their true receiver-side LLR pattern. Families without a
    # shipped encoder (ccsds k=16384: dense-H guard) use the all-zero
    # codeword — valid for any linear code and, by the channel's sign
    # symmetry, decode-cost-identical to a random codeword.
    from ..chan.awgn import make_channel

    key = jax.random.key(0)
    try:
        enc = build_encoder(spec)
    except ValueError:
        enc = None  # no shipped encoder for this family (dense-H guard)
    if enc is None:
        cw = jnp.zeros((batch, spec.n), jnp.uint8)
    else:
        msg = jax.random.bernoulli(key, 0.5, (batch, spec.k)).astype(jnp.uint8)
        cw = enc(msg)
    llr = make_channel(spec)(jax.random.fold_in(key, 1), cw, ebn0_db)

    compile_s, wall, compiled = time_compiled(dec, llr, tries=tries)
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
        jax.block_until_ready(compiled(llr))
        jax.profiler.stop_trace()

    res = compiled(llr)
    mean_iters = float(jnp.mean(res.iterations))
    mbps = batch * spec.k / wall / 1e6
    if backend == "xla-mm":
        form = "matmul-incidence"
        roof = (None if peaks is None else matmul_roofline_mbps(
            spec.n, spec.m, graph.dc_max, spec.k, iters, peaks.bf16_flops))
    else:
        form = "hbm-gather"
        roof = (None if peaks is None else roofline_mbps(
            spec.num_edges, spec.k, iters, peaks.hbm_bytes_per_s))
    return BenchResult(
        throughput_mbps=mbps,
        code=code,
        decoder=decoder,
        batch=batch,
        iters=iters,
        k=spec.k,
        n=spec.n,
        num_edges=spec.num_edges,
        wall_s_per_batch=wall,
        compile_s=compile_s,
        mean_iters=mean_iters,
        roofline_mbps=roof,
        roofline_form=form,
        device=device_info(),
    )
