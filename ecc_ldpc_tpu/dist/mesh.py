"""Device mesh construction, single chip -> multi-host pod slice.

The reference is single-process (SURVEY.md §5.8); this layer is the mandated
new capability (BASELINE.json:5): codeword batches and Eb/N0 grid points
sharded over chips. Axes:

  'batch' — data-parallel codeword axis (primary; SURVEY.md §2.2 DP)
  'snr'   — Eb/N0 grid axis (SURVEY.md §2.2 grid-parallel)

Collectives go over NVLink/NCCL between the GPUs of a host and over the
network across hosts, placed automatically by XLA; no transport code
exists anywhere in this framework (§5.8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How to lay devices onto ('batch', 'snr')."""

    batch: int = -1  # -1: all remaining devices
    snr: int = 1

    def resolve(self, n_devices: int) -> tuple:
        snr = self.snr
        batch = self.batch if self.batch != -1 else n_devices // snr
        if batch * snr != n_devices:
            raise ValueError(
                f"mesh {batch}x{snr} != {n_devices} devices; adjust MeshSpec"
            )
        return batch, snr


def make_mesh(
    spec: MeshSpec = MeshSpec(), devices: Optional[list] = None
) -> jax.sharding.Mesh:
    devices = devices if devices is not None else jax.devices()
    b, s = spec.resolve(len(devices))
    arr = np.asarray(devices).reshape(b, s)
    return jax.sharding.Mesh(arr, ("batch", "snr"))


def maybe_init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host rendezvous (SURVEY.md §3.5). Under a cluster manager
    that JAX detects (SLURM, Open MPI, ...) jax.distributed.initialize()
    finds its peers itself; explicit args are for manual launches. No-op
    when already initialized or when running single-process — including
    a plain one-host launch, where JAX finds no cluster and asks for a
    coordinator address."""
    if num_processes is not None and num_processes <= 1 and coordinator is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        msg = str(e).lower()
        if "already" in msg:
            return
        if coordinator is None and "coordinator_address" in msg:
            return  # no cluster detected: single-process run
        raise
