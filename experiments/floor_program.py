"""Flagship error-floor program (VERDICT r3 item 8).

Three measurements on dvbs2/64800/12, all on the GPU:

1. DEEP SCAN EXTENSION: layered/50 FER below 1e-4 — 1.35 dB re-measured
   at a 4x budget, then 1.5 and 1.7 dB at up-to-millions-of-frames
   budgets (early termination makes deep frames cheap: mean iters ~5-9
   out there, so a 1M-frame point is tens of seconds of device time).
2. REMEDY ARMS at the deepest resolvable points:
   - `cleanup` (Gallager-B bit-flip pass on stuck frames) as a decoder
     spec through the standard sweep;
   - `decode.with_retry(layered/50, spa/50)` — decoder-diversity retry;
     the trap harness (docs/TRAP_dvbs2_64800_12.json: 100% elementary
     (a,2) staircase sets) predicts diversity should clear most of the
     tail. Runs through a hand-rolled MC loop (with_retry is host-level
     by design).
3. THROUGHPUT COST of each remedy at the 2.5 dB operating point via
   bench.throughput (cleanup) / measured retry fraction (retry cost =
   fer_primary x fallback cost, amortized).

Writes FLOOR_dvbs2_64800_12.json in the working directory (docs/DESIGN.md
§3 summarizes the findings of earlier runs).

Run: python experiments/floor_program.py [--quick]
"""
import json
import sys
import time

CODE = "dvbs2/64800/12"
BASE = "layered/norm:0.8125/50"


def sweep(decoder, ebn0, max_frames, min_fe=15, batch=1024, seed=20260820):
    from ecc_ldpc_tpu.sim import StoppingRule, SweepSpec, run_sweep

    t0 = time.time()
    res = run_sweep(SweepSpec(
        code=CODE, decoder=decoder, ebn0_db=(ebn0,), batch=batch, seed=seed,
        stopping=StoppingRule(min_frame_errors=min_fe, max_frames=max_frames),
    ))[0]
    return dict(
        decoder=decoder, ebn0_db=ebn0, frames=res.frames,
        frame_errors=res.frame_errors, bit_errors=res.bit_errors,
        fer=res.fer, fer_ci=list(res.fer_ci), mean_iters=res.mean_iters,
        wall_s=round(time.time() - t0, 1),
    )


def retry_arm(ebn0, max_frames, min_fe=15, batch=1024, seed=20260820):
    """MC loop with decoder-diversity retry (layered/50 -> spa/50)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ecc_ldpc_tpu.chan.awgn import make_channel
    from ecc_ldpc_tpu.codes import get_code
    from ecc_ldpc_tpu.decode import get_decoder, with_retry
    from ecc_ldpc_tpu.decode.api import choose_graph
    from ecc_ldpc_tpu.encode.structured import build_encoder

    spec = get_code(CODE)
    enc = build_encoder(spec)
    channel = make_channel(spec)
    primary = get_decoder(choose_graph(spec, BASE), BASE)
    fb_spec = "spa/50"
    fallback = get_decoder(choose_graph(spec, fb_spec), fb_spec)
    dec = with_retry(primary, fallback, retry_batch=32)

    key = jax.random.key(seed)
    frames = fe = be = 0
    primary_fe = 0
    t0 = time.time()
    step = 0
    while frames < max_frames and fe < min_fe:
        kmsg = jax.random.fold_in(jax.random.fold_in(key, step), 1)
        kch = jax.random.fold_in(jax.random.fold_in(key, step), 2)
        msg = jax.random.bernoulli(kmsg, 0.5, (batch, spec.k)).astype(jnp.uint8)
        cw = enc(msg)
        llr = channel(kch, cw, ebn0)
        pres = primary(llr)
        primary_fe += int(np.sum(~np.asarray(pres.ok)))
        res = dec(llr)
        got = np.asarray(enc.extract_message(res.bits))
        errs = got != np.asarray(msg)
        fe += int(errs.any(axis=1).sum())
        be += int(errs.sum())
        frames += batch
        step += 1
    return dict(
        decoder=f"retry({BASE} -> {fb_spec})", ebn0_db=ebn0, frames=frames,
        frame_errors=fe, bit_errors=be, fer=fe / frames,
        primary_frame_errors=primary_fe, primary_fer=primary_fe / frames,
        wall_s=round(time.time() - t0, 1),
    )


def main() -> int:
    from ecc_ldpc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    quick = "--quick" in sys.argv
    out = {"code": CODE, "base_decoder": BASE, "arms": []}

    # 1. deep-scan extension
    budgets = [(1.35, 262_144), (1.5, 1_048_576), (1.7, 2_097_152)]
    if quick:
        budgets = [(1.35, 16_384)]
    for ebn0, mf in budgets:
        r = sweep(BASE, ebn0, mf)
        print("deep:", json.dumps(r), flush=True)
        out["arms"].append(r)

    # 2. remedies at the two deepest resolvable points
    remedy_points = [1.35, 1.5] if not quick else [1.35]
    for ebn0 in remedy_points:
        mf = 262_144 if ebn0 <= 1.4 else 1_048_576
        if quick:
            mf = 16_384
        r = sweep(BASE + "/cleanup", ebn0, mf)
        print("cleanup:", json.dumps(r), flush=True)
        out["arms"].append(r)
        r = retry_arm(ebn0, mf)
        print("retry:", json.dumps(r), flush=True)
        out["arms"].append(r)

    # 3. throughput cost of cleanup at the operating point
    from ecc_ldpc_tpu.bench.throughput import run_benchmark

    for dec in (BASE, BASE + "/cleanup"):
        b = run_benchmark(code=CODE, decoder=dec, batch=1024, ebn0_db=2.5,
                          tries=3)
        row = dict(decoder=dec, mbps=round(b.throughput_mbps, 1),
                   mean_iters=round(b.mean_iters, 2))
        print("cost:", json.dumps(row), flush=True)
        out.setdefault("throughput_cost", []).append(row)

    path = "FLOOR_dvbs2_64800_12.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
