"""Monte-Carlo sweep driver (SURVEY.md §2.2 C22, §3.2).

Mirrors the reference's main loop (SURVEY.md §3.1): for each (code, decoder,
Eb/N0) grid point, run batched frames until the stopping rule fires, tallying
message-bit errors and frame errors. Device-first shape: the whole
encode->channel->decode->tally step is ONE jitted function with Eb/N0 as a
traced scalar (one compilation covers every grid point), and batches are
large so device time dominates dispatch.

PRNG discipline (SURVEY.md §5.2): every batch's key is
fold_in(fold_in(fold_in(root, point_index), step_index), host) — streams are
disjoint across grid points, steps, and hosts, and resume continues the
stream exactly where it stopped.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..chan.modem import build_channel
from ..codes import get_code
from ..decode import get_decoder
from ..encode import DenseEncoder
from ..graph import compile_graph
from .stopping import StoppingRule, wilson_interval


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One sweep = a grid of (code x decoder x Eb/N0)."""

    code: str
    decoder: str
    ebn0_db: tuple
    batch: int = 256
    seed: int = 0
    stopping: StoppingRule = StoppingRule()
    backend: Optional[str] = None  # decoder backend override
    channel: str = "bpsk"  # channel-spec string (chan/modem.py)
    # fused_step=True compiles encode+channel+decode+tally as ONE module
    # (fewest dispatches). Some big structured codes (5G NR) can make that
    # monolithic module far slower to compile than its stages alone;
    # staged mode jits the stages separately at the cost of a few extra
    # dispatches per step.
    fused_step: bool = True

    def point_key(self, ebn0: float) -> str:
        base = f"{self.code}|{self.decoder}|{ebn0:g}"
        # default channel keeps the legacy key so old resume states load
        return base if self.channel == "bpsk" else f"{base}|{self.channel}"


@dataclasses.dataclass
class PointResult:
    code: str
    decoder: str
    ebn0_db: float
    channel: str = "bpsk"  # channel-spec string the point was measured over
    frames: int = 0
    bit_errors: int = 0
    frame_errors: int = 0
    iters_sum: int = 0
    steps: int = 0
    message_bits_per_frame: int = 0
    wall_s: float = 0.0
    # sum over frames of (per-frame bit errors)^2 — carried as float
    # because int32 overflows at ~2 heavy frames of a 32k-bit code;
    # CIs only need ~1% accuracy. 0.0 on curves recorded before 2026-08-20
    # (ber_ci then falls back to the mean-burst design effect).
    bit_errors_sq: float = 0.0

    @property
    def ber(self) -> float:
        bits = self.frames * self.message_bits_per_frame
        return self.bit_errors / bits if bits else 0.0

    @property
    def fer(self) -> float:
        return self.frame_errors / self.frames if self.frames else 0.0

    @property
    def fer_ci(self):
        return wilson_interval(self.frame_errors, self.frames)

    @property
    def ber_ci(self):
        """Cluster-corrected Wilson interval on BER.

        Bit errors are NOT independent Bernoulli trials — they arrive in
        bursts of ~10-1000 inside errored frames, so a plain Wilson
        interval on (bit_errors, total_bits) is narrower than the truth
        by ~sqrt(burst size) and two runs of the SAME decoder routinely
        fail to overlap (found by the golden-curve gate, 2026-08-19).
        Standard cluster-sampling correction: the number of independent
        error events is the errored-FRAME count, so the effective trial
        count is total_bits / D for a design effect D. With the per-frame
        squared-weight sum tracked (bit_errors_sq, runs after 2026-08-20)
        D = sum(w^2)/sum(w) — the weighted mean burst size, which is what
        the ratio-estimator variance Var(sum w)/ (n K)^2 ~ E[w^2]/(n K^2)
        demands. Equal bursts of size b give D = b (the old mean-burst
        formula); heavy-tailed weights (measured on dvbs2/16200 over
        apsk32 at 5.6 dB: 437 errored frames = 418 frames of <=5 bits +
        9 frames of 51-666 bits carrying 80% of the bit errors) give
        D ~ 400 vs mean 8 — the old CI was ~7x too narrow there and two
        same-decoder runs routinely failed to overlap. Wilson(x_eff,
        bits/D) with x_eff = sum(w)^2/sum(w^2) (the effective number of
        independent error events) keeps the point estimate at ber.
        Old curves without bit_errors_sq fall back to D = mean burst."""
        bits = self.frames * self.message_bits_per_frame
        if not bits:
            return (0.0, 1.0)
        if self.bit_errors == 0 or self.frame_errors == 0:
            return wilson_interval(self.bit_errors, bits)
        if self.bit_errors_sq > 0:
            design = self.bit_errors_sq / self.bit_errors
            x_eff = self.bit_errors**2 / self.bit_errors_sq
        else:
            design = self.bit_errors / self.frame_errors
            x_eff = self.frame_errors
        return wilson_interval(x_eff, max(round(bits / design), 1))

    @property
    def mean_iters(self) -> float:
        return self.iters_sum / self.frames if self.frames else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(ber=self.ber, fer=self.fer, mean_iters=self.mean_iters,
                 ber_ci=self.ber_ci, fer_ci=self.fer_ci)
        return d

    @staticmethod
    def from_json(d: dict) -> "PointResult":
        fields = {f.name for f in dataclasses.fields(PointResult)}
        return PointResult(**{k: v for k, v in d.items() if k in fields})


class Pipeline:
    """encode -> channel -> decode -> tally for one (code, decoder) pair.

    step(key, ebn0_db) -> (bit_errors, frame_errors, iters_sum,
    bit_errors_sq) — jitted once. bit_errors_sq is f32 (see PointResult).
    """

    def __init__(self, k: int, rate: float, step_fn: Callable, batch: int):
        self.k = k
        self.rate = rate
        self.step = step_fn
        self.batch = batch

    @staticmethod
    def build(spec: SweepSpec) -> "Pipeline":
        if spec.code.startswith("bpsk"):
            return _bpsk_pipeline(spec)
        return _ldpc_pipeline(spec)


def _graph_for(code, decoder_spec: str, backend=None):
    from ..decode.api import choose_graph

    return choose_graph(code, decoder_spec, backend=backend)


def _ldpc_pipeline(spec: SweepSpec) -> Pipeline:
    from ..encode.structured import build_encoder

    code = get_code(spec.code)
    graph = _graph_for(code, spec.decoder, backend=spec.backend)
    enc = build_encoder(code)
    overrides = {"backend": spec.backend} if spec.backend else {}
    dec = get_decoder(graph, spec.decoder, jit=False, **overrides)
    B, k, rate = spec.batch, code.k, code.rate
    # honors punctured/shortened positions; channel-spec strings select
    # hard-decision / BSC / QAM fronts (chan/modem.py)
    channel = build_channel(code, spec.channel)

    def step_body(key, ebn0_db):
        kmsg, kchan = jax.random.split(key)
        msg = jax.random.bernoulli(kmsg, 0.5, (B, k)).astype(jnp.uint8)
        cw = enc(msg)
        llr = channel(kchan, cw, ebn0_db)
        res = dec(llr)
        msg_hat = enc.extract_message(res.bits)
        diff = msg_hat != msg
        w = jnp.sum(diff, axis=1, dtype=jnp.int32)
        return (
            jnp.sum(w),
            jnp.sum(jnp.any(diff, axis=1), dtype=jnp.int32),
            jnp.sum(res.iterations, dtype=jnp.int32),
            jnp.sum(jnp.square(w.astype(jnp.float32))),
        )

    if getattr(dec, "host_level", False):
        # retry-wrapped decoders (';retry=' specs) gather failed frames on
        # the host between two jitted decoders — the decode stage cannot be
        # traced, so the step is forced staged with the decode un-jitted
        # (its primary/fallback are jitted internally)
        tx = jax.jit(lambda key, ebn0_db: _staged_tx(enc, channel, B, k, key, ebn0_db))
        tally = jax.jit(lambda msg, res: _staged_tally(enc, msg, res))

        def step(key, ebn0_db):
            msg, llr = tx(key, ebn0_db)
            res = dec(llr)
            return tally(msg, res)
    elif spec.fused_step:
        step = jax.jit(step_body)
    else:
        tx = jax.jit(lambda key, ebn0_db: _staged_tx(enc, channel, B, k, key, ebn0_db))
        jdec = jax.jit(dec)
        tally = jax.jit(lambda msg, res: _staged_tally(enc, msg, res))

        def step(key, ebn0_db):
            msg, llr = tx(key, ebn0_db)
            res = jdec(llr)
            return tally(msg, res)

    return Pipeline(k=k, rate=rate, step_fn=step, batch=B)


def _staged_tx(enc, channel, B, k, key, ebn0_db):
    kmsg, kchan = jax.random.split(key)
    msg = jax.random.bernoulli(kmsg, 0.5, (B, k)).astype(jnp.uint8)
    cw = enc(msg)
    return msg, channel(kchan, cw, ebn0_db)


def _staged_tally(enc, msg, res):
    msg_hat = enc.extract_message(res.bits)
    diff = msg_hat != msg
    w = jnp.sum(diff, axis=1, dtype=jnp.int32)
    return (
        jnp.sum(w),
        jnp.sum(jnp.any(diff, axis=1), dtype=jnp.int32),
        jnp.sum(res.iterations, dtype=jnp.int32),
        jnp.sum(jnp.square(w.astype(jnp.float32))),
    )


def _bpsk_pipeline(spec: SweepSpec) -> Pipeline:
    """Uncoded baseline (reference's ECC.BPSK, SURVEY.md §2.1 R3).

    Code string: "bpsk" or "bpsk/<n>"; rate 1, decode = hard decision.
    Honors the sweep's channel spec, so uncoded QAM/BSC theory anchors
    run through the same surface (e.g. --code bpsk/1008 --channel qam16).
    """
    from ..codes.spec import CodeSpec

    parts = spec.code.split("/")
    n = int(parts[1]) if len(parts) > 1 else 1024
    B = spec.batch
    # rate-1 "code" with an empty parity set, purely to carry (n, rate=1)
    # through the channel-spec builder
    identity = CodeSpec(name="uncoded", n=n, m=0, row_cols=(), k=n)
    channel = build_channel(identity, spec.channel)

    @jax.jit
    def step(key, ebn0_db):
        kmsg, kchan = jax.random.split(key)
        msg = jax.random.bernoulli(kmsg, 0.5, (B, n)).astype(jnp.uint8)
        llr = channel(kchan, msg, ebn0_db)
        hard = (llr < 0).astype(jnp.uint8)
        diff = hard != msg
        w = jnp.sum(diff, axis=1, dtype=jnp.int32)
        return (
            jnp.sum(w),
            jnp.sum(jnp.any(diff, axis=1), dtype=jnp.int32),
            jnp.zeros((), jnp.int32),
            jnp.sum(jnp.square(w.astype(jnp.float32))),
        )

    return Pipeline(k=n, rate=1.0, step_fn=step, batch=B)


def run_sweep(
    spec: SweepSpec,
    *,
    resume_path: Optional[str] = None,
    progress: Optional[Callable[[PointResult], None]] = None,
    host_index: int = 0,
) -> list:
    """Run every grid point to its stopping rule. Returns [PointResult].

    If resume_path is given, counters are flushed there after every stopping
    -rule evaluation and reloaded on restart (SURVEY.md §5.3/§5.4: the
    Monte-Carlo state is a tiny counter pytree; recovery = reload + continue
    the PRNG stream at the recorded step).
    """
    pipeline = Pipeline.build(spec)
    state = _load_state(resume_path)
    root = jax.random.fold_in(jax.random.key(spec.seed), host_index)
    results = []
    for pi, ebn0 in enumerate(spec.ebn0_db):
        pr = PointResult(
            code=spec.code, decoder=spec.decoder, ebn0_db=float(ebn0),
            channel=spec.channel, message_bits_per_frame=pipeline.k,
        )
        saved = state.get(spec.point_key(ebn0))
        if saved:
            for f in ("frames", "bit_errors", "frame_errors", "iters_sum",
                      "steps", "wall_s", "bit_errors_sq"):
                # .get: resume states written before bit_errors_sq existed
                setattr(pr, f, saved.get(f, getattr(pr, f)))
        point_key = jax.random.fold_in(root, pi)
        while not spec.stopping.done(pr.frame_errors, pr.frames):
            t0 = time.perf_counter()
            key = jax.random.fold_in(point_key, pr.steps)
            be, fe, it, be2 = pipeline.step(key, jnp.float32(ebn0))
            be, fe, it, be2 = int(be), int(fe), int(it), float(be2)
            pr.wall_s += time.perf_counter() - t0
            pr.frames += pipeline.batch
            pr.bit_errors += be
            pr.frame_errors += fe
            pr.iters_sum += it
            pr.bit_errors_sq += be2
            pr.steps += 1
            if resume_path:
                state[spec.point_key(ebn0)] = {
                    f: getattr(pr, f)
                    for f in ("frames", "bit_errors", "frame_errors",
                              "iters_sum", "steps", "wall_s",
                              "bit_errors_sq")
                }
                _save_state(resume_path, state)
        if progress:
            progress(pr)
        results.append(pr)
    return results


def run_sweep_sharded(
    spec: SweepSpec,
    mesh,
    *,
    resume_path: Optional[str] = None,
    progress: Optional[Callable[[PointResult], None]] = None,
) -> list:
    """Sharded sweep (config 5, BASELINE.json:11): the whole Eb/N0 grid
    advances together — codewords sharded over the 'batch' mesh axis, grid
    points over 'snr', counters psum-reduced across devices. Running "finished"
    points costs nothing extra (their devices would otherwise idle), so the
    loop continues until EVERY point satisfies the stopping rule.

    Counters are bit-identical to run_sweep-with-the-same-frame-count on
    any mesh shape (per-frame PRNG keyed on global indices; tests/dist/).
    """
    from ..dist.montecarlo import make_sharded_step
    from ..encode.structured import build_encoder

    code = get_code(spec.code)
    graph = _graph_for(code, spec.decoder, backend=spec.backend)
    enc = build_encoder(code)
    overrides = {"backend": spec.backend} if spec.backend else {}
    dec = get_decoder(graph, spec.decoder, jit=False, **overrides)
    if getattr(dec, "host_level", False):
        raise ValueError(
            "';retry=' decoders are host-level and cannot run inside the "
            "sharded step — sweep with the primary, re-decode failures "
            "with run_sweep (its staged step supports retry), or offline"
        )

    n_batch = mesh.shape["batch"]
    n_snr = mesh.shape["snr"]
    if len(spec.ebn0_db) % n_snr:
        raise ValueError(
            f"{len(spec.ebn0_db)} grid points do not divide over snr={n_snr}"
        )
    if spec.batch % n_batch:
        raise ValueError(f"batch {spec.batch} does not divide over {n_batch}")
    import numpy as _np

    # non-default channel specs route through chan.modem (per-frame vmap);
    # the default keeps the legacy in-step mask path (bit-identical history)
    channel_fn = (
        build_channel(code, spec.channel) if spec.channel != "bpsk" else None
    )
    step = jax.jit(make_sharded_step(
        enc, dec, code.rate, code.k, mesh, spec.batch // n_batch,
        punct=_np.asarray(code.punctured_cols, _np.int32),
        short=_np.asarray(code.shortened_cols, _np.int32),
        channel_fn=channel_fn,
    ))

    state = _load_state(resume_path)
    results = [
        PointResult(code=spec.code, decoder=spec.decoder, ebn0_db=float(e),
                    channel=spec.channel, message_bits_per_frame=code.k)
        for e in spec.ebn0_db
    ]
    for pr, e in zip(results, spec.ebn0_db):
        saved = state.get(spec.point_key(e))
        if saved:
            for f in ("frames", "bit_errors", "frame_errors", "iters_sum",
                      "steps", "wall_s", "bit_errors_sq"):
                setattr(pr, f, saved.get(f, getattr(pr, f)))
    root = jax.random.key(spec.seed)
    grid = jnp.asarray(spec.ebn0_db, jnp.float32)
    step_idx = min(pr.steps for pr in results)
    while not all(
        spec.stopping.done(pr.frame_errors, pr.frames) for pr in results
    ):
        t0 = time.perf_counter()
        be, fe, it, be2 = step(root, grid, jnp.int32(step_idx))
        be, fe, it, be2 = (np.asarray(be), np.asarray(fe), np.asarray(it),
                           np.asarray(be2))
        dt = time.perf_counter() - t0
        for i, pr in enumerate(results):
            if pr.steps > step_idx:  # already counted (resume overlap)
                continue
            pr.frames += spec.batch
            pr.bit_errors += int(be[i])
            pr.frame_errors += int(fe[i])
            pr.iters_sum += int(it[i])
            pr.bit_errors_sq += float(be2[i])
            pr.steps += 1
            # every point advances concurrently on its own mesh shard, so
            # the wall time THIS point experienced is the full step dt (the
            # per-point frames/wall_s throughput is then its true concurrent
            # rate; summing wall_s over points intentionally exceeds the
            # sweep wall-clock). Dividing dt evenly misattributed time in
            # mixed-convergence sweeps (VERDICT r1 weak item 8).
            pr.wall_s += dt
        step_idx += 1
        if resume_path:
            for pr, e in zip(results, spec.ebn0_db):
                state[spec.point_key(e)] = {
                    f: getattr(pr, f)
                    for f in ("frames", "bit_errors", "frame_errors",
                              "iters_sum", "steps", "wall_s",
                              "bit_errors_sq")
                }
            _save_state(resume_path, state)
    if progress:
        for pr in results:
            progress(pr)
    return results


def _load_state(path) -> dict:
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _save_state(path, state) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)
