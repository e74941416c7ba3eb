"""The port's data-parallel layouts and skewed SP against the JAX package,
CPU, with the helpers and tolerances of ``tests/test_torch_sp_lp.py``
(JAX in float64 with ``f64_moments``; the port in float64 in one 4-rank
gloo world):

- LOCAL_DP_LP: square 4 tiles, split 2, ``local_dp`` 4, batch 8 (each tile
  rank pipelines a quarter of the micro-batch), against the JAX
  ``PipelineTrainer`` and against the JAX golden of
  ``tests/test_pipeline.py``, ``_local_dp_golden_step`` (front BN over the
  micro-batch, back BN over each slice);
- DP+LP: ``data_parallel`` 2, split 2, no front (``tests/test_pipeline.py:
  114-124``), and with a front: vertical 2 tiles, split 2, 2 replicas;
- SP+DP on the ``Trainer``: vertical 2 tiles, ``data_parallel`` 2 (the JAX
  ``Trainer``; BN statistics per tile grid, gradients over the world), and
  DP alone on the ``Trainer`` (4 replicas, ``train.py:873-893``); then the
  SP+DP trainer's BN calibration and eval with JAX's trained params against
  the JAX spatial calibration and eval (``evaluate.py:341-368``: moments
  averaged and metrics summed over ``(data, tile_h, tile_w)``) on the same
  params and batches, float64 both: every statistic within 1e-9 of its
  leaf's largest, the loss within the layout's loss rtol 1e-5 (JAX's
  cross-entropy runs in f32, ``train.py:177-179``), the accuracy and count
  equal;
- skewed SP ``(4, 2)`` (``tests/test_pipeline.py:297-333``: every spatial
  stage on the finest grid), and the refusal of an increasing list;

ResNet-v1 @32, two steps each, loss rtol 1e-5, params rtol 2e-4 / atol
1e-5.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mpi4dl_tpu_torch.config import ParallelConfig
from test_torch_sp_lp import (
    RESNET_TOL,
    assert_matches_jax,
    assert_params_close,
    batches,
    eval_batches,
    f64_moments,
    jax_run,
    run_world,
)

torch.set_num_threads(1)

_SQ4 = dict(num_spatial_parts=4, slice_method="square")
CASES = {
    "local_dp": (("resnet_v1", 8), 32,
                 dict(batch_size=8, parts=1, split_size=2, spatial_size=1, local_dp=4, **_SQ4),
                 "gpipe", "pipeline"),
    "dp_lp": (("resnet_v1", 8), 32,
              dict(batch_size=8, parts=2, split_size=2, data_parallel=2), "gpipe", "pipeline"),
    "sp_lp_dp": (("resnet_v1", 8), 32,
                 dict(batch_size=4, parts=2, split_size=2, spatial_size=1, num_spatial_parts=2,
                      slice_method="vertical", data_parallel=2), "gpipe", "pipeline"),
    "sp_dp_trainer": (("resnet_v1", 8, 3), 32,
                      dict(batch_size=4, split_size=1, spatial_size=1, num_spatial_parts=2,
                           slice_method="vertical", data_parallel=2), "gpipe", "trainer"),
    "dp_trainer": (("resnet_v1", 8, 0), 32,
                   dict(batch_size=4, split_size=1, data_parallel=4), "gpipe", "trainer"),
    "skewed": (("resnet_v1", 14), 32,
               dict(batch_size=2, parts=2, split_size=3, spatial_size=2,
                    num_spatial_parts=(4, 2), slice_method="square"), "gpipe", "pipeline"),
}


def _jax_pipeline_tests():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_pipeline.py")
    spec = importlib.util.spec_from_file_location("_jax_pipeline_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _local_dp_golden(run, spec):
    """Loss and ``(front, stacked)`` params per step of JAX's LOCAL_DP_LP
    golden from the JAX run's init."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu.ops import layers as jax_layers
    from mpi4dl_tpu.train import TrainState

    tr, cfg = run["trainer"], spec[2]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "_bn_moments_plain", f64_moments)
        step = _jax_pipeline_tests()._local_dp_golden_step(
            tr.plain_cells, tr.n_spatial_cells, cfg["parts"], cfg["local_dp"])
        cells = tr.unstack_params(jax.tree.map(jnp.asarray, run["init"]))
        state = TrainState(params=cells, opt_state=tr.tx.init(cells),
                           step=jnp.zeros((), jnp.int32))
        loss, params = [], []
        for x, y in batches(cfg["batch_size"], spec[1]):
            state, m = step(state, jnp.asarray(x), jnp.asarray(y))
            loss.append(float(m["loss"]))
            params.append(_stacked_layout(tr, jax.tree.map(np.asarray, state.params)))
    return loss, params


def _stacked_layout(tr, cells):
    """Per-cell JAX params in the trainer's ``(front_flat, stacked)`` layout."""
    n = tr.n_spatial_cells
    front = np.asarray(tr.front_meta.flatten(cells[:n]))
    flats, i = [], n
    for meta, st in zip(tr.param_metas, tr.stages):
        flats.append(np.asarray(meta.flatten(cells[i:i + len(st)])))
        i += len(st)
    stacked = np.zeros((tr.S, tr.max_p), np.float32)
    for d, offs in enumerate(tr._chunk_offsets):
        row = np.concatenate([flats[k] for k, _, _ in offs])
        stacked[d, :row.size] = row
    return front, stacked


# Float64 against float64: the SP+DP calibration's tolerance.
EVAL_STAT_TOL = 1e-9


def _jax_spatial_eval(run, spec):
    """The JAX spatial calibration and eval of the run's trainer with its
    last params: ``(statistics, metrics)``."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import evaluate as jax_eval
    from mpi4dl_tpu.ops import layers as jax_layers

    tr, cal_test = run["trainer"], eval_batches(spec)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "_bn_moments_plain", f64_moments)
        params = jax.tree.map(jnp.asarray, run["params"][-1])
        stats = jax.tree.map(np.asarray,
                             jax_eval.spatial_collect_batch_stats(tr, params, cal_test[0]))
        return stats, jax_eval.spatial_evaluate(tr, params, stats, cal_test[1])


def _stat_errors(got, want, path=""):
    """(normalised max |err|, path) of every leaf of one cell's statistics."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    out = []
    for k in want:
        if isinstance(want[k], dict) or hasattr(want[k], "items"):
            out += _stat_errors(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
            assert g.shape == w.shape, (path, k, g.shape, w.shape)
            out.append((float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)), f"{path}/{k}"))
    return out


@pytest.fixture(scope="module")
def runs():
    want = {case: jax_run(case, spec) for case, spec in CASES.items()}
    jobs = [(case, (spec, want[case]["init"], None, None,
                    want[case]["params"][-1] if case == "sp_dp_trainer" else None))
            for case, spec in CASES.items()]
    got = run_world(jobs)
    return {"jax": want, "port": got,
            "jax_eval": _jax_spatial_eval(want["sp_dp_trainer"], CASES["sp_dp_trainer"])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_jax(case, runs):
    assert_matches_jax(runs["port"][case], runs["jax"][case], CASES[case], case)


def test_local_dp_matches_the_jax_golden(runs):
    """LOCAL_DP_LP against ``_local_dp_golden_step`` (JAX's own golden of
    the layout)."""
    loss, params = _local_dp_golden(runs["jax"]["local_dp"], CASES["local_dp"])
    got = runs["port"]["local_dp"]
    np.testing.assert_allclose(got["loss"], loss, rtol=RESNET_TOL[0])
    for step, (g, w) in enumerate(zip(got["params"], params)):
        assert_params_close(g, w, RESNET_TOL, f"local_dp golden step {step}")


def test_local_dp_back_runs_a_slice(runs):
    """Under LOCAL_DP_LP the back stages' wires carry ``mb_back`` = 2 rows,
    JAX's ``mb_back``."""
    assert runs["jax"]["local_dp"]["trainer"].mb_back == 2
    assert [w[0] for w in runs["port"]["local_dp"]["front_wire"]] == [2]


def test_sp_dp_eval_matches_jax(runs):
    """BN calibration and eval on the SP+DP world (each replica its rows,
    moments averaged over the world, metrics summed over it) against the
    JAX ``Trainer``'s spatial calibration and eval, JAX's trained params in
    both."""
    (stats, got), _ = runs["port"]["sp_dp_trainer"]["eval"]
    want_stats, want = runs["jax_eval"]
    assert len(stats) == len(want_stats)
    for i, (g, w) in enumerate(zip(stats, want_stats)):
        worst = max(_stat_errors(g, w, str(i)), default=(0.0, ""))
        assert worst[0] <= EVAL_STAT_TOL, worst
    assert got["count"] == want["count"] == 8
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RESNET_TOL[0])


def test_sp_dp_eval_matches_the_plain_model(runs):
    """The same calibration and eval equal the plain model's with the same
    params, calibrated on each replica's rows and evaluated on the whole
    batches."""
    (_, got), want = runs["port"]["sp_dp_trainer"]["eval"]
    assert got["count"] == want["count"] == 8
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-9)
    assert got["accuracy"] == want["accuracy"]


def test_skewed_sp_runs_on_the_finest_grid(runs):
    cfg = ParallelConfig(image_size=32, **CASES["skewed"][2])
    assert (cfg.spatial_parts, cfg.tile_shape, cfg.num_devices) == (4, (2, 2), 4)
    assert runs["port"]["skewed"]["groups"][0] == (0, 1, 2, 3)


@pytest.mark.parametrize("parts", [(2, 4), (4, 8), (4, 2, 1)])
def test_skewed_sp_refusals_match_jax(parts):
    """An increasing list, or one with neither one entry nor spatial_size
    entries, is refused by both configs."""
    from mpi4dl_tpu.config import ParallelConfig as JaxConfig

    kw = dict(batch_size=2, parts=1, split_size=3, spatial_size=2, slice_method="square",
              image_size=32)
    with pytest.raises(ValueError):
        JaxConfig(num_spatial_parts=parts, **kw)
    with pytest.raises(ValueError):
        ParallelConfig(num_spatial_parts=parts, **kw)
