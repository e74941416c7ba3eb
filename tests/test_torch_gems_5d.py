"""The five dimensions at once against the JAX package, CPU
(``tests/test_pipeline.py:505-548``'s config): the D2 fused-halo ResNet-v2
depth 20 @32 with its front on vertical 2 tiles, split 3 (2 pipeline
stages), ``data_parallel`` 2, ``local_dp`` 2 and GEMS (``times`` 1), batch 8
a chunk in one micro-batch, on 8 ranks: the port's ``GemsMasterTrainer`` in
float64 in an 8-rank gloo world against the JAX ``GemsMasterTrainer`` in
float64 with ``f64_moments`` (the helpers of ``tests/test_torch_sp_lp.py``),
two steps, at the ResNet tolerances of ``tests/test_pipeline.py:53-54``
(loss rtol 1e-5, accuracy 1e-6, params rtol 2e-4 / atol 1e-5).
"""

import numpy as np
import pytest
import torch

from test_torch_sp_lp import assert_matches_jax, jax_run, run_world

torch.set_num_threads(1)

CASE = "five_d"
SPEC = (("resnet_v2_d2", 20), 32,
        dict(batch_size=8, parts=1, split_size=3, spatial_size=1, num_spatial_parts=2,
             slice_method="vertical", data_parallel=2, local_dp=2, times=1, halo_d2=True,
             fused_layers=2), "gpipe", "gems")


@pytest.fixture(scope="module")
def runs():
    want = jax_run(CASE, SPEC)
    got = run_world([(CASE, (SPEC, want["init"]))], size=8)
    return want, got[CASE]


def test_five_d_matches_jax(runs):
    want, got = runs
    jtr = want["trainer"]
    assert (jtr.S, jtr.chunks, jtr.mb_back) == (2, 2, 2)
    assert np.isfinite(got["loss"]).all()
    assert_matches_jax(got, want, SPEC, CASE)


def test_five_d_layout(runs):
    """Rank 0's groups: its tile pair, its pipe pair and its replica group
    (every ``d, i, j`` of pipe coordinate 0) in the JAX mesh's order."""
    _, got = runs
    tiles, pipe, replica = got["groups"]
    mesh = np.arange(8).reshape(2, 2, 1, 2)
    assert list(tiles) == mesh[0, 0].ravel().tolist()
    assert pipe == mesh[0, :, 0, 0].tolist()
    assert replica == mesh[:, 0].ravel().tolist()
