"""Smoke test of the decode path on NVIDIA GPUs, through the entry points a
user calls, at the widths the benchmark uses.

  python chip_smoke.py          phases 1-4 on one GPU
  python chip_smoke.py --four   phases 1 and 5 on four GPUs

1. Device: JAX's devices, and the card's name and power limit.
2. Main path: run_sweep of dvbs2/64800/12, layered min-sum, batch 4096, at
   the golden curve's resolvable points (FER >= 2e-2), held to the golden
   gate (sim/report.golden_gate); then the production spec with retry
   through build_ecc, checking the syndrome of every frame reported ok.
3. Parity with the plain reference: the same decoder on the GPU and on
   this process's CPU device (dvbs2/64800/12, and the gather tier on
   mackay1008), and the gather tier against the incidence-matmul tier.
   Hard decisions must be equal on every frame both sides report ok, and
   at most 1% of frames may differ in ok/iterations: the GPU contracts
   multiply-adds and orders reductions differently, which can push a
   marginal frame across the iteration cap.
4. Times: bench.py's three legs (decode Mbit/s, compile seconds, warm step
   time), gather vs incidence-matmul on mackay1008, the int8 encoder and
   the int32 CRC matmul, each beside the card's name and power limit.
5. (--four) run_sweep_sharded on 4x1 and 2x2 batch x snr meshes, whose
   counters must equal a one-card run, and the Z-sharded graph-parallel
   decoder against one card under the tolerance of phase 3.

Progress goes to earlier lines. The last line is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}, printed
only when every phase passed. When JAX finds no GPU, or any phase fails,
the script exits non-zero without it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FLAGSHIP = "dvbs2/64800/12"
FLAGSHIP_GOLDEN = ROOT / "curves" / "dvbs2_64800_12_tpu_golden.json"
PROD_DECODER = "layered/sched:dvbs2_64800_12_T25_op2;retry=layered/spa/50"
PARITY_TOL = 0.01  # share of frames that may differ in ok/iterations


class PhaseFailed(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def compare(a, b, label: str) -> None:
    """Phase-3 tolerance between two DecodeResults of the same LLRs."""
    ok_a, ok_b = np.asarray(a.ok), np.asarray(b.ok)
    it_a, it_b = np.asarray(a.iterations), np.asarray(b.iterations)
    both = ok_a & ok_b
    bits_diff = int(np.any(
        np.asarray(a.bits)[both] != np.asarray(b.bits)[both], axis=1).sum())
    n_diff = int(np.sum((ok_a != ok_b) | (it_a != it_b)))
    limit = PARITY_TOL * len(ok_a)
    log(f"  {label}: {len(ok_a)} frames, ok {int(ok_a.sum())} vs "
        f"{int(ok_b.sum())}; hard decisions differ on {bits_diff} of "
        f"{int(both.sum())} frames both report ok; ok/iterations differ "
        f"on {n_diff} frames (limit {limit:g})")
    check(bits_diff == 0 and n_diff <= limit, f"{label}: parity failed")


def _syndrome_ok(graph, bits):
    """[B] bool: H @ bits == 0, by gathers over the expanded graph — a
    check independent of the roll-form syndrome inside the decoders."""
    import jax.numpy as jnp

    at = bits[:, graph.cn_vn].astype(jnp.int32)  # [B, m, dc]
    par = jnp.sum(jnp.where(graph.cn_mask, at, 0), axis=-1) & 1
    return ~jnp.any(par != 0, axis=-1)


def _llr(ecc_or_spec, batch: int, ebn0_db: float, seed: int):
    """(msg, llr) for `batch` random frames through the code's channel."""
    import jax
    import jax.numpy as jnp

    from ecc_ldpc_tpu.chan.awgn import make_channel
    from ecc_ldpc_tpu.encode.structured import build_encoder

    enc = build_encoder(ecc_or_spec)
    key = jax.random.key(seed)
    msg = jax.random.bernoulli(
        key, 0.5, (batch, ecc_or_spec.k)).astype(jnp.uint8)
    llr = make_channel(ecc_or_spec)(jax.random.fold_in(key, 1), enc(msg),
                                    ebn0_db)
    return msg, llr


def phase_device(count: int) -> dict:
    import jax

    from ecc_ldpc_tpu.bench.throughput import device_info

    info = device_info()
    log(f"[1] devices: {jax.devices()}")
    log(f"    device_kind: {info['kind']}")
    log(f"    nvidia-smi name, power.limit: {info['name_power_limit']}")
    check(info["count"] >= count, f"needs {count} devices, JAX found "
          f"{info['count']}")
    return info


def phase_main_path(golden_path=FLAGSHIP_GOLDEN, batch=4096,
                    prod_code=FLAGSHIP, prod_decoder=PROD_DECODER,
                    prod_batch=2048, prod_batches=3, prod_ebn0=2.5) -> None:
    import jax
    import jax.numpy as jnp

    from ecc_ldpc_tpu import build_ecc
    from ecc_ldpc_tpu.graph import compile_graph
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec, format_table
    from ecc_ldpc_tpu.sim.report import GOLDEN_MIN_FER, golden_gate
    from ecc_ldpc_tpu.sim.runner import PointResult, run_sweep

    golden = [PointResult.from_json(d)
              for d in json.loads(Path(golden_path).read_text())]
    pts = [r for r in golden if r.fer >= GOLDEN_MIN_FER]
    code, decoder = pts[0].code, pts[0].decoder
    t0 = time.perf_counter()
    res = run_sweep(SweepSpec(
        code=code, decoder=decoder, ebn0_db=tuple(r.ebn0_db for r in pts),
        batch=batch, seed=77,
        stopping=StoppingRule(min_frame_errors=80, max_frames=batch),
    ))
    log(f"[2] run_sweep {code} {decoder} batch {batch} "
        f"({time.perf_counter() - t0:.1f} s with compilation)")
    log(format_table(res))
    passed, report = golden_gate(res, pts)
    log(f"    golden gate vs {Path(golden_path).name}: {report}")
    check(passed, "golden gate failed")

    t0 = time.perf_counter()
    ecc = build_ecc(prod_code, prod_decoder)
    graph = compile_graph(ecc.spec)
    syndrome_ok = jax.jit(_syndrome_ok)
    for b in range(prod_batches):
        msg, llr = _llr(ecc.spec, prod_batch, prod_ebn0, seed=100 + b)
        out = ecc.decode(llr)
        ok = np.asarray(out.ok)
        syn = np.asarray(syndrome_ok(graph, out.bits))
        wrong = np.asarray(jnp.any(ecc.extract_message(out.bits) != msg,
                                   axis=1))
        log(f"    {prod_code} {prod_decoder} batch {b}: {int(ok.sum())}/"
            f"{prod_batch} ok, syndrome zero on {int(syn[ok].sum())} of "
            f"them, {int(wrong.sum())} frames with message errors, mean "
            f"iterations {float(np.mean(np.asarray(out.iterations))):.2f}")
        check(np.all(syn[ok]), "a frame reported ok fails the syndrome")
    log(f"    production spec: {time.perf_counter() - t0:.1f} s "
        f"with compilation")


def phase_parity(code=FLAGSHIP, batch=64, ebn0=1.5, iters=25,
                 small_code="mackay1008", small_batch=1024,
                 small_ebn0=2.0) -> None:
    import jax

    from ecc_ldpc_tpu.codes import get_code
    from ecc_ldpc_tpu.decode import make_decoder
    from ecc_ldpc_tpu.graph import compile_graph, compile_qc_graph

    acc, cpu = jax.devices()[0], jax.devices("cpu")[0]
    t0 = time.perf_counter()
    spec = get_code(code)
    dec = make_decoder(compile_qc_graph(spec), "layered", alpha=0.8125,
                       max_iters=iters, early_term=False)
    _, llr = _llr(spec, batch, ebn0, seed=7)
    llr = np.asarray(llr)
    compare(dec(jax.device_put(llr, acc)), dec(jax.device_put(llr, cpu)),
            f"[3] {code} layered/norm:0.8125/{iters}/noet, "
            f"{acc.platform} vs cpu")

    spec = get_code(small_code)
    graph = compile_graph(spec)
    gather = make_decoder(graph, "minsum", alpha=0.8125, max_iters=iters)
    dense = make_decoder(graph, "minsum", alpha=0.8125, max_iters=iters,
                         backend="xla-mm")
    _, llr = _llr(spec, small_batch, small_ebn0, seed=8)
    llr = np.asarray(llr)
    ref = gather(jax.device_put(llr, acc))
    compare(ref, gather(jax.device_put(llr, cpu)),
            f"    {small_code} gather tier minsum/norm:0.8125/{iters}, "
            f"{acc.platform} vs cpu")
    compare(ref, dense(jax.device_put(llr, acc)),
            f"    {small_code} gather tier vs incidence-matmul tier "
            f"(soft products at Precision.HIGHEST), {acc.platform}")
    log(f"    parity: {time.perf_counter() - t0:.1f} s with compilation")


def phase_times(legs=None, small_code="mackay1008", small_batch=2048,
                iters=25, crc_k=8424, enc_batch=4096) -> None:
    import jax
    import jax.numpy as jnp

    from ecc_ldpc_tpu.bench.throughput import (
        device_info, device_peaks, run_benchmark, time_compiled,
    )
    from ecc_ldpc_tpu.codes import get_code
    from ecc_ldpc_tpu.codes.crc import make_crc
    from ecc_ldpc_tpu.decode.xla import dense_mm
    from ecc_ldpc_tpu.decode.xla.cn_ops import cn_minsum
    from ecc_ldpc_tpu.decode.xla.flooding import decode_flooding
    from ecc_ldpc_tpu.encode import DenseEncoder
    from ecc_ldpc_tpu.graph import compile_graph

    if legs is None:
        from bench import LEGS as legs
    card = device_info()["name_power_limit"]
    peaks = device_peaks()
    log(f"[4] times on {card}; peaks: {peaks}")
    for code, decoder, batch, ebn0 in legs:
        r = run_benchmark(code=code, decoder=decoder, batch=batch,
                          ebn0_db=ebn0)
        log(f"    {code} {decoder} batch {batch}: {r.throughput_mbps:.1f} "
            f"Mbit/s, compile {r.compile_s:.1f} s, warm step "
            f"{r.wall_s_per_batch * 1e3:.2f} ms, mean iterations "
            f"{r.mean_iters:.2f}, ceiling ({r.roofline_form}) "
            f"{r.roofline_mbps} Mbit/s [{card}]")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"    peak device memory after the legs: "
        f"{stats.get('peak_bytes_in_use')} bytes")

    spec = get_code(small_code)
    graph = compile_graph(spec)
    _, llr = _llr(spec, small_batch, 2.5, seed=9)
    cn_op = lambda V, mask: cn_minsum(V, mask, alpha=0.8125)  # noqa: E731
    ops = dense_mm.IncidenceOperators.build(graph)

    def gather(llr):
        return decode_flooding(graph, llr, cn_op=cn_op, max_iters=iters,
                               early_term=False)

    def dense(ops, llr):
        return dense_mm.decode_flooding_mm(graph, ops, llr, cn_op=cn_op,
                                           max_iters=iters, early_term=False)

    for label, fn, args in (("gather tier", gather, (llr,)),
                            ("incidence-matmul tier", dense, (ops, llr))):
        c, w, _ = time_compiled(fn, *args)
        log(f"    {small_code} minsum/norm:0.8125/{iters}/noet batch "
            f"{small_batch}, {label}: {small_batch * spec.k / w / 1e6:.1f} "
            f"Mbit/s, compile {c:.1f} s, warm step {w * 1e3:.3f} ms "
            f"[{card}]")

    enc = DenseEncoder.build(spec)
    msg = jnp.ones((enc_batch, spec.k), jnp.uint8)
    c, w, _ = time_compiled(DenseEncoder.__call__, enc, msg)
    log(f"    int8 x int8 -> int32 encoder ({small_code}, batch "
        f"{enc_batch}): compile {c:.1f} s, warm step {w * 1e3:.3f} ms "
        f"[{card}]")
    attach, crc_check = make_crc("24a", crc_k)
    payload = jnp.ones((enc_batch, crc_k), jnp.uint8)
    c, w, _ = time_compiled(attach, payload)
    c2, w2, _ = time_compiled(crc_check, attach(payload))
    check(bool(jnp.all(crc_check(attach(payload)))), "CRC check failed")
    log(f"    int32 CRC-24A matmul (k={crc_k}, batch {enc_batch}): attach "
        f"compile {c:.1f} s, warm {w * 1e3:.3f} ms; check compile "
        f"{c2:.1f} s, warm {w2 * 1e3:.3f} ms [{card}]")


def phase_four(code=FLAGSHIP, decoder="layered/norm:0.8125/25/noet",
               ebn0=(1.0, 1.05), batch=512, gp_batch=64, gp_ebn0=1.5,
               iters=25, devices=None) -> None:
    # fixed-iteration decoders: their loop bodies carry no per-iteration
    # syndrome, which keeps the five compilations of this phase short
    import jax

    from ecc_ldpc_tpu.codes import get_code
    from ecc_ldpc_tpu.decode import make_decoder
    from ecc_ldpc_tpu.dist import MeshSpec, make_mesh
    from ecc_ldpc_tpu.dist.graph_parallel import (
        make_qc_graph_parallel_decoder,
    )
    from ecc_ldpc_tpu.graph import compile_qc_graph
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec
    from ecc_ldpc_tpu.sim.runner import run_sweep_sharded

    devices = devices if devices is not None else jax.devices()[:4]
    sweep = SweepSpec(code=code, decoder=decoder, ebn0_db=tuple(ebn0),
                      batch=batch, seed=3,
                      stopping=StoppingRule(min_frame_errors=1 << 30,
                                            max_frames=2 * batch))

    def counters(pts):
        return [(p.ebn0_db, p.frames, p.bit_errors, p.frame_errors,
                 p.iters_sum) for p in pts]

    t0 = time.perf_counter()
    one = run_sweep_sharded(sweep, make_mesh(MeshSpec(batch=1, snr=1),
                                             devices=devices[:1]))
    log(f"[5] {code} {decoder}, {2 * batch} frames per point, one card: "
        f"(ebn0, frames, bit_errors, frame_errors, iters_sum) = "
        f"{counters(one)}; bit_errors_sq {[p.bit_errors_sq for p in one]} "
        f"({time.perf_counter() - t0:.1f} s)")
    for b, s in ((4, 1), (2, 2)):
        t0 = time.perf_counter()
        got = run_sweep_sharded(sweep, make_mesh(MeshSpec(batch=b, snr=s),
                                                 devices=devices))
        log(f"    mesh {b}x{s}: {counters(got)}; bit_errors_sq "
            f"{[p.bit_errors_sq for p in got]} "
            f"({time.perf_counter() - t0:.1f} s)")
        check(counters(got) == counters(one),
              f"mesh {b}x{s} counters differ from one card")
        # sums of squared per-frame errors are f32 and psum-ordered by the
        # mesh: equal up to float rounding, not bit for bit
        check(np.allclose([p.bit_errors_sq for p in got],
                          [p.bit_errors_sq for p in one], rtol=1e-6),
              f"mesh {b}x{s} bit_errors_sq differs from one card")

    t0 = time.perf_counter()
    spec = get_code(code)
    gmesh = jax.make_mesh((len(devices),), ("graph",), devices=devices)
    sharded = make_qc_graph_parallel_decoder(
        spec, gmesh, kind="minsum", alpha=0.8125, max_iters=iters,
        early_term=False)
    single = make_decoder(compile_qc_graph(spec), "minsum", alpha=0.8125,
                          max_iters=iters, early_term=False)
    _, llr = _llr(spec, gp_batch, gp_ebn0, seed=11)
    llr = np.asarray(llr)
    compare(sharded(llr), single(jax.device_put(llr, devices[0])),
            f"    graph-parallel Z-sharded minsum/norm:0.8125/{iters}/noet over "
            f"{len(devices)} devices vs one device")
    log(f"    graph-parallel: {time.perf_counter() - t0:.1f} s "
        f"with compilation")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase (sharded sweep and "
                         "graph-parallel decode)")
    args = ap.parse_args(argv)

    import jax

    from ecc_ldpc_tpu.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"chip_smoke: needs a GPU; JAX found {dev.platform} devices")
        return 1
    log(f"compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()
    info = phase_device(4 if args.four else 1)
    if args.four:
        phase_four()
    else:
        phase_main_path()
        phase_parity()
        phase_times()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
