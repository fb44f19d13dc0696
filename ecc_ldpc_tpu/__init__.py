"""ecc_ldpc_tpu — an LDPC codec + Monte-Carlo BER framework in JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of the reference
simulator `ku-fpg/ecc-ldpc` (a Haskell Monte-Carlo ECC simulator: ECC
abstraction, LDPC codec tiers, BER sweeps with confidence intervals).

Layering (see SURVEY.md §1.3):
  codes/    host-side code construction & loading (alist, QC tables, standards)
  graph/    H-matrix -> device-ready compiled graphs (edge lists, QC blocks)
  chan/     BPSK + AWGN + LLR (pure jnp)
  encode/   GF(2) encoders (dense-G int8 matmul; structured back-substitution)
  decode/   decoders: xla/ tiers (pure jnp), the oracle and the GPU path
  dist/     mesh + sharding: batch/EbN0 sharded Monte-Carlo, psum counters
  sim/      Monte-Carlo harness: sweeps, stopping rules, BER/FER reports
  bench/    throughput + roofline + profiling
  cli/      `ecc-sim`-style CLI with reference-style compact code/decoder specs

The reference's correctness methodology — every optimized decoder tier is
validated by BER-curve parity against a slow oracle tier — is carried over:
plain-numpy reference decoders (tests/ref_decoders.py) pin the XLA tiers
bit for bit on the CPU, golden curves (curves/) pin their FER on the GPU,
and statistical BER tests pin the waterfall against theory.
"""

__version__ = "0.1.0"

# Top-level convenience API (the reference's ECC-record workflow):
#   from ecc_ldpc_tpu import build_ecc
#   ecc = build_ecc("dvbs2/64800/12", "layered/norm:0.8125/25")
from .ecc import ECC, build_ecc  # noqa: E402
from .codes import get_code, list_codes  # noqa: E402

__all__ = ["ECC", "build_ecc", "get_code", "list_codes", "__version__"]
