"""LDPC decoders.

`xla/` holds the pure-jnp tiers, one per schedule and graph form
(SURVEY.md §2.1 R6-R8, R10): they are both the correctness reference (like
the reference's MATLAB-ported "Reference" decoder) and what runs on the
GPU. A hand-written GPU kernel joins them only where a device trace shows
XLA far from its bound, validated bit-exactly against `xla/`.

Decoders are composed from a schedule (flooding / layered) and a check-node
update rule (spa-tanh / min-sum with normalization alpha or offset beta) the
way the reference's "Model" tier decomposes its decoders (R7).
"""

from .types import DecodeResult
from .api import choose_graph, get_decoder, make_decoder, with_retry

__all__ = [
    "DecodeResult",
    "choose_graph",
    "get_decoder",
    "make_decoder",
    "with_retry",
]
