"""The port's SP+LP pipeline with the other spatial models against the JAX
``PipelineTrainer``, CPU, with the helpers of ``tests/test_torch_sp_lp.py``
(JAX in float64 with ``f64_moments``; the port in float64 in one 4-rank
gloo world; vertical 2 tiles, split 3, parts 2, two steps):

- AmoebaNet-D 3L/32F @64 batch 4 (the JAX test's batch), whose stage wires
  are ``(concat, skip)`` tuples,
  at the AmoebaNet tolerances of ``tests/test_pipeline.py:584-602`` (loss
  rtol 2e-4, params rtol 2e-2 / atol 1e-4);
- a D2 front: ``get_resnet_v2_d2`` depth 20, ``fused_layers`` 2, @64, with
  ``balance=(4, 2, 2)`` (four D1 cells in the front) and the D2 cell list's
  ``num_spatial_cells`` given to both trainers (``pipeline.py:242-252``),
  at the ResNet tolerances (loss 1e-5, params 2e-4 / 1e-5);

and each one's ``halo_shift_count`` and wire shapes equal to JAX's.
"""

import numpy as np
import pytest
import torch

from test_torch_sp_lp import assert_matches_jax, jax_run, run_world

torch.set_num_threads(1)

_V2 = dict(batch_size=2, parts=2, split_size=3, spatial_size=1, num_spatial_parts=2,
           slice_method="vertical")
CASES = {
    "amoebanet": (("amoebanet", 3), 64, dict(_V2, batch_size=4), "gpipe", "pipeline"),
    "resnet_v2_d2": (("resnet_v2_d2", 20), 64, dict(_V2, balance=(4, 2, 2)), "gpipe",
                     "pipeline"),
}


@pytest.fixture(scope="module")
def runs():
    want = {case: jax_run(case, spec) for case, spec in CASES.items()}
    got = run_world([(case, (spec, want[case]["init"], None, None))
                     for case, spec in CASES.items()])
    return {"jax": want, "port": got}


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_sp_lp_matches_jax(case, runs):
    assert_matches_jax(runs["port"][case], runs["jax"][case], CASES[case], case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_halo_shift_count_and_wires_match_jax(case, runs):
    got, want = runs["port"][case], runs["jax"][case]
    jtr = want["trainer"]
    assert got["halo_shifts"] == want["halo_shifts"] > 0
    front = jtr.front_out_shape
    fronts = [front] if isinstance(front[0], int) else list(front)
    assert [tuple(w) for w in got["front_wire"]] == [(b, c, h, w) for b, h, w, c in fronts]
    jw = [[(s[0], s[3], s[1], s[2]) for s in m.shapes] for m in jtr.wire_metas]
    assert [[tuple(s) for s in w] for w in got["wires"]] == jw


def test_d2_front_is_the_d2_cell_list(runs):
    """The D2 front's length is the D2 builder's, not the D1 stage bound."""
    jtr = runs["jax"]["resnet_v2_d2"]["trainer"]
    assert jtr.n_spatial_cells != 4
    assert np.isfinite(runs["port"]["resnet_v2_d2"]["loss"]).all()
