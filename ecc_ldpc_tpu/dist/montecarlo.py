"""Pod-sharded Monte-Carlo step: batch + Eb/N0 sharding, psum counters.

Implements the mandated distribution scheme (BASELINE.json:5): huge codeword
batches sharded over a 'batch' mesh axis, Eb/N0 grid points sharded over an
'snr' axis, frame/bit-error counters reduced with psum (NCCL all-reduce on GPUs).

PRNG discipline (SURVEY.md §5.2, §7.2 item 6): every frame's randomness is
derived as fold_in(fold_in(fold_in(root, point_global_idx), FRAME_TAG),
frame_global_idx) — a function of *global* indices only, so the simulated
noise (and therefore every BER number) is bit-identical for any mesh shape
with the same total batch, including single-device runs. That property is
what lets a 1-chip run validate a pod run (tests/dist/).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..chan import awgn_llr

P = jax.sharding.PartitionSpec

_FRAME_TAG = 0x5EED


def per_frame_keys(point_key: jax.Array, frame_start, batch: int) -> jax.Array:
    """Disjoint per-frame key stream, indexed by global frame id."""
    base = jax.random.fold_in(point_key, _FRAME_TAG)
    idx = frame_start + jnp.arange(batch)
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(idx)


def _point_counters(
    enc, dec, rate, k, batch, point_key, frame_start, ebn0_db,
    punct=None, short=None, channel_fn=None,
):
    """Counters for `batch` frames of one grid point on one device.

    channel_fn, when given, replaces the default BPSK/AWGN(+mask) front:
    it is applied per frame under vmap as channel_fn(key, cw_row, ebn0_db)
    (any chan.modem.build_channel product qualifies — they are elementwise
    /reshape-only, so per-row application is exact)."""
    keys = per_frame_keys(point_key, frame_start, batch)
    kmsg = jax.vmap(lambda kk: jax.random.fold_in(kk, 0))(keys)
    kchan = jax.vmap(lambda kk: jax.random.fold_in(kk, 1))(keys)
    msg = jax.vmap(
        lambda kk: jax.random.bernoulli(kk, 0.5, (k,)).astype(jnp.uint8)
    )(kmsg)
    cw = enc(msg)
    if channel_fn is not None:
        llr = jax.vmap(lambda kk, c: channel_fn(kk, c, ebn0_db))(kchan, cw)
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
    llr = jax.vmap(lambda kk, c: awgn_llr(kk, c, ebn0_db, rate))(kchan, cw)
    # elementwise masks, never scatter (see chan.make_channel)
    if punct is not None and len(punct):
        import numpy as _np

        keep = _np.ones(llr.shape[-1], _np.float32)
        keep[_np.asarray(punct, _np.int64)] = 0.0
        add = _np.zeros(llr.shape[-1], _np.float32)
        if short is not None and len(short):
            keep[_np.asarray(short, _np.int64)] = 0.0
            add[_np.asarray(short, _np.int64)] = 60.0
        llr = llr * keep + add
    elif short is not None and len(short):
        import numpy as _np

        keep = _np.ones(llr.shape[-1], _np.float32)
        keep[_np.asarray(short, _np.int64)] = 0.0
        add = _np.zeros(llr.shape[-1], _np.float32)
        add[_np.asarray(short, _np.int64)] = 60.0
        llr = llr * keep + add
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


def make_sharded_step(
    enc,
    dec: Callable,
    rate: float,
    k: int,
    mesh: jax.sharding.Mesh,
    batch_per_device: int,
    punct=None,
    short=None,
    channel_fn=None,
) -> Callable:
    """Build step(root_key, ebn0_grid, step_index) -> (bit_errs, frame_errs,
    iters_sum, bit_errs_sq), the first three int32 [n_snr_points] and the
    last f32 [n_snr_points] (sum over frames of squared per-frame bit
    errors, for burst-variance-aware BER CIs — see PointResult.ber_ci).

    ebn0_grid: f32 [n_points]; must divide evenly over the 'snr' mesh axis.
    Per call, every grid point sees batch_per_device * mesh['batch'] frames.
    dec must be an unjitted decode callable (llr [B, n] -> DecodeResult).
    """
    n_batch_shards = mesh.shape["batch"]
    n_snr_shards = mesh.shape["snr"]
    total_batch = batch_per_device * n_batch_shards

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P("snr"), P()),
        out_specs=(P(), P(), P(), P()),
    )
    def step(root_key, ebn0_shard, step_index):
        snr_shard = jax.lax.axis_index("snr")
        batch_shard = jax.lax.axis_index("batch")
        s_local = ebn0_shard.shape[0]

        def one_point(p):
            point_global = snr_shard * s_local + p
            point_key = jax.random.fold_in(
                jax.random.fold_in(root_key, point_global), step_index
            )
            frame_start = (
                step_index * total_batch + batch_shard * batch_per_device
            )
            be, fe, it, be2 = _point_counters(
                enc, dec, rate, k, batch_per_device,
                point_key, frame_start, ebn0_shard[p],
                punct=punct, short=short, channel_fn=channel_fn,
            )
            return jnp.stack([be, fe, it]), be2

        local, local2 = jax.lax.map(one_point, jnp.arange(s_local))
        # place this shard's points in the full grid and psum over both
        # axes: the batch shards add up, the snr shards fill disjoint
        # slots. The counters come out REPLICATED — in a multi-process
        # mesh an snr-sharded output is not fully addressable from any one
        # host and np.asarray would raise; they are a few numbers each.
        start = snr_shard * s_local
        full = jax.lax.dynamic_update_slice(
            jnp.zeros((n_snr_shards * s_local, 3), local.dtype), local,
            (start, 0))
        full2 = jax.lax.dynamic_update_slice(
            jnp.zeros((n_snr_shards * s_local,), local2.dtype), local2,
            (start,))
        full = jax.lax.psum(full, ("batch", "snr"))    # int32
        full2 = jax.lax.psum(full2, ("batch", "snr"))  # f32
        return full[:, 0], full[:, 1], full[:, 2], full2

    return step


def sharded_sweep_counters(
    enc, dec, rate, k, mesh, batch_per_device, ebn0_grid, *, seed=0, steps=1
):
    """Run `steps` sharded step calls and accumulate counters (helper for
    tests and quick sweeps; the full stopping-rule driver is sim/runner.py)."""
    step = jax.jit(make_sharded_step(enc, dec, rate, k, mesh, batch_per_device))
    root = jax.random.key(seed)
    grid = jnp.asarray(ebn0_grid, jnp.float32)
    be = jnp.zeros(grid.shape, jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
    fe = jnp.zeros_like(be)
    it = jnp.zeros_like(be)
    be2 = jnp.zeros(grid.shape, jnp.float32)
    for s in range(steps):
        b, f, i, b2 = step(root, grid, jnp.int32(s))
        be, fe, it, be2 = be + b, fe + f, it + i, be2 + b2
    frames = steps * batch_per_device * mesh.shape["batch"]
    return be, fe, it, be2, frames
