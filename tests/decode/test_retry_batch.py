"""Stored trapping-set failure batch regression (r5, VERDICT r4 item 3b).

tests/data/trap_batch_dvbs2_64800_12.npz holds real channel LLR rows
harvested by experiments/floor_r5.py for which layered/50 min-sum fails
on the XLA f32 tier (filtered at harvest time so the failure reproduces
on the CPU). This pins:

  * the failure mode itself — layered/50 must KEEP failing these frames
    (if a refactor silently changes decoder dynamics, this trips);
  * the remedy — the ';retry=spa/50' production wrapper must recover
    every frame to the exact transmitted codeword.
"""
import os

import numpy as np
import pytest

_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                     "trap_batch_dvbs2_64800_12.npz")

pytestmark = pytest.mark.skipif(
    not os.path.exists(_PATH),
    reason="failure batch not harvested yet (experiments/floor_r5.py)",
)


@pytest.fixture(scope="module")
def batch():
    d = np.load(_PATH)
    # 4 of the 8 stored frames: spa/50 on n=64800 costs ~45 s/frame on
    # the CPU tier, and 4 recovered trapping frames pin the contract as
    # well as 8 (the full batch is exercised on device by floor_r5.py)
    return d["llr"][:4].astype(np.float32), d["cw"][:4].astype(np.uint8)


def test_primary_still_fails_and_retry_recovers(batch):
    import jax.numpy as jnp

    from ecc_ldpc_tpu.codes import get_code
    from ecc_ldpc_tpu.decode import get_decoder
    from ecc_ldpc_tpu.decode.api import choose_graph

    llr, cw = batch
    spec = get_code("dvbs2/64800/12")
    graph = choose_graph(spec, "layered/norm:0.8125/50")
    primary = get_decoder(graph, "layered/norm:0.8125/50")
    pres = primary(jnp.asarray(llr))
    assert not np.asarray(pres.ok).any(), (
        "stored trapping-set frames now decode under the primary — "
        "decoder dynamics changed; re-harvest the batch (floor_r5.py) "
        "and re-measure the floor artifact before trusting this change"
    )
    retry = get_decoder(graph, "layered/norm:0.8125/50;retry=spa/50")
    res = retry(jnp.asarray(llr))
    assert np.asarray(res.ok).all()
    assert np.array_equal(np.asarray(res.bits), cw)
