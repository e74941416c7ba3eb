"""The port's ``GemsMasterTrainer`` on AmoebaNet-D 3L/32F @64 against the
JAX package's, CPU, with the helpers of ``tests/test_torch_gems.py`` (JAX
in float64 with ``f64_moments``; the port in float64 in a 2-rank gloo
world): split 2, batch 4 a chunk in 2 micro-batches, ``times`` 1, two
steps. Its stage wire is the ``(concat, skip)`` tuple
(``tests/test_pipeline.py:605-613``); the tolerances are that test's (loss
rtol 2e-4, accuracy 1e-6, params rtol 2e-2 / atol 1e-4). A GEMS step with
float64 parameters equals the port's ``Trainer(grad_accum=4)``'s at 1e-9
relative per leaf, atol 1e-12, and the transfers of a step are counted.
"""

import pytest
import torch

from test_torch_gems import assert_equals_trainer, assert_lp_matches_jax, assert_transfers
from test_torch_gems import gems_runs

torch.set_num_threads(1)

CASE = "amoebanet"
SPEC = (("amoebanet", 3), 64, dict(batch_size=4, parts=2, split_size=2, times=1), "gpipe",
        "gems")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return gems_runs({CASE: SPEC}, tmp_path_factory)


def test_gems_tuple_wires_match_jax(runs):
    got = runs["port"][CASE]
    assert [len(shapes) for shapes in got["wires"]] == [2]  # (concat, skip)
    assert_lp_matches_jax(got, runs["jax"][CASE], SPEC, CASE)


def test_gems_equals_trainer_grad_accum(runs):
    assert_equals_trainer(runs["port"][f"{CASE}_trainer"], CASE)


def test_transfers(runs):
    assert_transfers(runs["port"][CASE], SPEC)
