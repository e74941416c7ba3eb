"""The port's ``GemsMasterTrainer`` behind a spatial front against the JAX
package's, CPU, with the helpers of ``tests/test_torch_sp_lp.py`` (JAX in
float64 with ``f64_moments``; the port in float64 in one 4-rank gloo
world), ResNet-v1 @32, ``times`` 1, two steps:

- SP+GEMS: vertical 2 tiles, split 3 (2 pipeline stages), depth 14, batch 2
  a chunk in 2 micro-batches: the mirrored chunk's joined micro-batches go
  to pipe coordinate 1, where its stage 0 runs, and their gradients come
  back from there;
- LOCAL_DP_LP+GEMS: square 4 tiles, split 2 (one pipeline stage, which
  mirrors itself), depth 8, batch 4, ``local_dp`` 4
  (``tests/test_pipeline.py:276-294``'s config);

each against the JAX run at the ResNet tolerances of
``tests/test_pipeline.py:53-54`` (loss rtol 1e-5, accuracy 1e-6, params
rtol 2e-4 / atol 1e-5), and each step's wire and mirror transfers summed
over the world (each pipe group's ``chunks·2·parts·(S-1) + 4·(S//2)``).
"""

import pytest
import torch

from test_torch_sp_lp import assert_matches_jax, chunks_of, jax_run, run_world

torch.set_num_threads(1)

CASES = {
    "sp_gems": (("resnet_v1", 14), 32,
                dict(batch_size=2, parts=2, split_size=3, spatial_size=1, num_spatial_parts=2,
                     slice_method="vertical", times=1), "gpipe", "gems"),
    "local_dp_gems": (("resnet_v1", 8), 32,
                      dict(batch_size=4, parts=1, split_size=2, spatial_size=1,
                           num_spatial_parts=4, slice_method="square", local_dp=4, times=1),
                      "gpipe", "gems"),
}


@pytest.fixture(scope="module")
def runs():
    want = {case: jax_run(case, spec) for case, spec in CASES.items()}
    got = run_world([(case, (spec, want[case]["init"])) for case, spec in CASES.items()])
    return {"jax": want, "port": got}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_gems_matches_jax(case, runs):
    assert_matches_jax(runs["port"][case], runs["jax"][case], CASES[case], case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_gems_transfers(case, runs):
    from mpi4dl_tpu_torch.config import ParallelConfig

    spec = CASES[case]
    cfg = ParallelConfig(image_size=spec[1], **spec[2])
    S = cfg.lp_stages
    per_group = chunks_of(spec) * 2 * cfg.parts * (S - 1) + 4 * (S // 2)
    got = runs["port"][case]
    assert got["permute_count"] == per_group
    assert got["transfers"] == [per_group * cfg.num_devices // S] * 2
