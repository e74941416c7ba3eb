"""The port's GEMS-MASTER pipeline pair (``parallel.pipeline.GemsMasterTrainer``)
and the mirror placement (``PipelineTrainer(mirror=True)``) against the JAX
package, CPU, with the helpers of ``tests/test_torch_sp_lp.py`` (JAX in
float64 with ``f64_moments`` on the suite's virtual CPU devices, its init
``(front_flat, stacked)`` loaded through ``weights.from_jax_pipeline_params``;
the port in float64 in a gloo world of 2 ranks and one of 3). Two steps, lr
0.001, parts 2, batch 4 a chunk, the same numpy-seeded batches of
``2·times·4`` rows:

- ResNet-v1 depth 8 @32, split 2, ``times`` 1 and 2
  (``tests/test_pipeline.py:418-431``'s case);
- ResNet-v1 depth 14 @32, split 3 (odd ``S``: the middle rank mirrors
  itself and sends nothing);
- the mirror placement alone (ResNet-v1 depth 8, split 2), against JAX's and
  equal to the port's normal placement on the same weights (loss rtol
  1e-12, params per leaf rtol 1e-9 / atol 1e-12);

at the tolerances of ``tests/test_pipeline.py:53-54`` (loss rtol 1e-5,
accuracy 1e-6, params rtol 2e-4 / atol 1e-5). Also: every GEMS layout's
first step equal to the port's ``Trainer(grad_accum=chunks·parts)``'s on the
``chunks·4`` rows from the same weights, both with float64 parameters (the
loss and every leaf of the updated params at 1e-9 relative, atol 1e-12; the
owner adds the copy's summed gradients to its own, so the sums associate
otherwise than the Trainer's, which f32 gradients would show), the wire and mirror transfers of a step
(``chunks·2·parts·(S-1)`` stage wires and ``4·(S//2)`` mirror sends, summed
over the ranks), the mirror exchange's bytes, the stacked layout of the
mirror placement (row ``d`` holds stage ``S-1-d``), checkpoints across
packages (a JAX GEMS checkpoint after step 0 restores into the port exactly
and the next loss is within 1e-5; the port's into JAX likewise), and the
refusal of a batch that is not ``2·times·4`` rows.
``tests/test_torch_gems_amoebanet.py`` holds AmoebaNet-D's GEMS run with
this file's helpers.
"""

import numpy as np
import pytest
import torch

from test_torch_sp_lp import (
    batches,
    chunks_of,
    f64_moments,
    jax_run,
    replicated,
    run_case,
    tolerances,
)

from mpi4dl_tpu_torch.config import ParallelConfig
from mpi4dl_tpu_torch.parallel import multihost

torch.set_num_threads(1)

LR = 0.001
ACC_RTOL = 1e-6
TRAINER_RTOL, TRAINER_ATOL = 1e-9, 1e-12  # float64 against float64
EQUAL_RTOL = 1e-12  # the mirror placement's loss against the normal one's
CKPT_LOSS_RTOL = 1e-5

_LP = dict(batch_size=4, parts=2)
# case -> (model, image size, config, schedule, trainer kind)
CASES = {
    "resnet_t1": (("resnet_v1", 8), 32, dict(_LP, split_size=2, times=1), "gpipe", "gems"),
    "resnet_t2": (("resnet_v1", 8), 32, dict(_LP, split_size=2, times=2), "gpipe", "gems"),
    "resnet_s3": (("resnet_v1", 14), 32, dict(_LP, split_size=3, times=1), "gpipe", "gems"),
    "mirror": (("resnet_v1", 8), 32, dict(_LP, split_size=2), "gpipe", "mirror"),
}
GEMS_CASES = sorted(c for c, spec in CASES.items() if spec[4] == "gems")
CKPT_CASE = "resnet_t1"
# The port's normal placement on the mirror run's weights.
NORMAL = (("resnet_v1", 8), 32, dict(_LP, split_size=2), "gpipe", "pipeline")


def _layout(spec, mirror=False):
    """(the port's plain model, cells of each stage, stages of each rank)."""
    from mpi4dl_tpu_torch.parallel.pipeline import stages_of_device, virtual_stage_cells
    from test_torch_sp_lp import port_model

    model, _ = port_model(spec, 0, None)
    S = spec[2]["split_size"]
    return (model, virtual_stage_cells(len(model), S),
            [stages_of_device(d, S, mirror=mirror) for d in range(S)])


def _restack(init, spec, mirror_from, mirror_to):
    """JAX's ``(front, stacked)`` of one placement in the other's layout."""
    from mpi4dl_tpu_torch.weights import stack_pipeline, unstack_pipeline

    model, stages, src = _layout(spec, mirror_from)
    _, _, dst = _layout(spec, mirror_to)
    values = unstack_pipeline(init[1], model, stages, src)
    return init[0], stack_pipeline(values, model, stages, dst)


def _cells64(cells) -> dict:
    return {i: {n: p.detach().numpy().copy() for n, p in cell.named_parameters()}
            for i, cell in cells}


def _trainer_check(rank, spec, init):
    """One GEMS step and one ``Trainer(grad_accum=chunks·parts)`` step (rank
    0, on the whole ``chunks·batch`` rows) from the JAX init, both with
    float64 parameters. Rank 0 returns both losses and updated cells
    (``{cell: {name: array}}``, GEMS's gathered from every rank's stage)."""
    import copy

    import torch.distributed as dist

    from mpi4dl_tpu_torch.parallel.pipeline import GemsMasterTrainer
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import from_jax_pipeline_params

    model, stages, placement = _layout(spec)
    from_jax_pipeline_params(init, model, stages, placement)
    model.double()
    start = copy.deepcopy(model.state_dict())
    cfg = ParallelConfig(image_size=spec[1], **spec[2])
    tr = GemsMasterTrainer(model, cfg, learning_rate=LR, device="cpu")
    x, y = batches(tr.chunks * cfg.batch_size, spec[1])[0]
    loss = float(tr.train_step(x, y)["loss"])
    own = [None] * dist.get_world_size()
    dist.all_gather_object(own, _cells64((i, model[i]) for k in tr.hosted
                                         for i in tr.stages[k]))
    out = None
    if rank == 0:
        model.load_state_dict(start)
        ref = Trainer(model, ParallelConfig(batch_size=tr.chunks * cfg.batch_size,
                                            image_size=cfg.image_size),
                      learning_rate=LR, device="cpu", grad_accum=tr.chunks * cfg.parts)
        out = {"loss": loss, "cells": {i: c for part in own for i, c in part.items()},
               "trainer_loss": float(ref.train_step(x, y)["loss"]),
               "trainer_cells": _cells64(enumerate(ref.model))}
    dist.barrier()
    return out


def _refusal(spec):
    """A GEMS trainer given one chunk's rows: the message every rank raises
    (None if it does not)."""
    import torch.distributed as dist

    from mpi4dl_tpu_torch.parallel.pipeline import GemsMasterTrainer
    from test_torch_sp_lp import port_model

    cfg = ParallelConfig(image_size=spec[1], **spec[2])
    tr = GemsMasterTrainer(port_model(spec, 0, None)[0], cfg, device="cpu")
    x, y = batches(cfg.batch_size, spec[1])[0]
    try:
        tr.train_step(x, y)
    except ValueError as e:
        msg = str(e)
    else:
        msg = None
    dist.barrier()
    return msg


def _world(rank, world_size, jobs, ckpt_case):
    out = {}
    for case, args in jobs:
        out[case] = run_case(rank, case, *args)
        spec, init = args[0], args[1]
        if spec[4] == "gems":
            out[f"{case}_trainer"] = _trainer_check(rank, spec, init)
        if case == ckpt_case:
            out["refusal"] = _refusal(spec)
    return out


def gems_runs(cases, tmp_path_factory, ckpt_case=None, extra=()):
    """The JAX runs of ``cases`` (``ckpt_case``'s with a checkpoint after
    step 0) and the port's, one gloo world for each split size (``extra``
    jobs ``(case, (spec, init))`` in the 2-rank world), each GEMS case with
    its ``Trainer(grad_accum)`` step under ``<case>_trainer``."""
    jax_ckpt = str(tmp_path_factory.mktemp("jax_gems_ckpt"))
    port_ckpt = str(tmp_path_factory.mktemp("port_gems_ckpt"))
    want = {case: jax_run(case, spec, jax_ckpt if case == ckpt_case else None)
            for case, spec in cases.items()}
    got = {}
    for size in sorted({spec[2]["split_size"] for spec in cases.values()}):
        jobs = [(case, (spec, want[case]["init"], jax_ckpt if case == ckpt_case else None,
                        port_ckpt if case == ckpt_case else None))
                for case, spec in cases.items() if spec[2]["split_size"] == size]
        if size == 2:
            jobs += [(case, job(want)) for case, job in extra]
        got.update(multihost.spawn(_world, size, args=(jobs, ckpt_case), timeout=600)[0])
    return {"jax": want, "port": got, "port_ckpt": port_ckpt}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # The normal placement on the mirror run's weights.
    normal = ("normal", lambda want: (NORMAL, _restack(want["mirror"]["init"], NORMAL, True,
                                                       False)))
    return gems_runs(CASES, tmp_path_factory, CKPT_CASE, extra=[normal])


def assert_stacked_close(got, want, spec, rtol, atol, what):
    """Every cell of two stacked arrays of ``spec``'s layout, per leaf."""
    from mpi4dl_tpu_torch.weights import unstack_pipeline

    model, stages, placement = _layout(spec, spec[4] == "mirror")
    for i, (g, w) in enumerate(zip(unstack_pipeline(got, model, stages, placement),
                                   unstack_pipeline(want, model, stages, placement))):
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=rtol, atol=atol,
                                       err_msg=f"{what}: cell {i} {k}")


def assert_lp_matches_jax(got, want, spec, case):
    loss_rtol, rtol, atol = tolerances(spec)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol, err_msg=case)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=ACC_RTOL, err_msg=case)
    for step, ((gf, gs), (wf, ws)) in enumerate(zip(got["params"], want["params"])):
        assert gf.size == np.asarray(wf).size == 0  # no front
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=rtol, atol=atol,
                                   err_msg=f"{case} step {step}")


def assert_equals_trainer(check, case):
    """:func:`_trainer_check`'s GEMS step against the Trainer's: the loss
    and every leaf of every cell."""
    np.testing.assert_allclose(check["loss"], check["trainer_loss"], rtol=TRAINER_RTOL)
    want = check["trainer_cells"]
    assert sorted(check["cells"]) == sorted(want)
    for i, cell in want.items():
        for k, w in cell.items():
            np.testing.assert_allclose(check["cells"][i][k], w, rtol=TRAINER_RTOL,
                                       atol=TRAINER_ATOL,
                                       err_msg=f"{case} against Trainer(grad_accum): cell {i} {k}")


def assert_transfers(got, spec):
    """Each micro-batch of each chunk crosses ``S-1`` boundaries each way;
    every rank but a middle one sends its stage's parameters and its copy's
    gradients once a step (summed over one pipe group: the LP world)."""
    S, parts = spec[2]["split_size"], spec[2]["parts"]
    mirror_sends = 4 * (S // 2) if spec[4] == "gems" else 0
    want = chunks_of(spec) * 2 * parts * (S - 1) + mirror_sends
    assert got["permute_count"] == want
    assert got["transfers"] == [want] * 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_gems_matches_jax(case, runs):
    assert_lp_matches_jax(runs["port"][case], runs["jax"][case], CASES[case], case)


@pytest.mark.parametrize("case", GEMS_CASES)
def test_gems_equals_trainer_grad_accum(case, runs):
    """GEMS's step is ``Trainer(grad_accum=chunks·parts)``'s on the same
    rows: the mirrored chunks' gradients reach their owner whole."""
    assert_equals_trainer(runs["port"][f"{case}_trainer"], case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_transfers(case, runs):
    assert_transfers(runs["port"][case], CASES[case])


def test_mirror_exchange_bytes(runs):
    """Rank 0 of split 2 sends stage 0's parameters and its copy's (stage
    1's) gradients a step, packed in f32 (the parameters' dtype)."""
    from mpi4dl_tpu_torch.weights import cells_size

    model, stages, _ = _layout(CASES[CKPT_CASE])
    n = [cells_size(model[i] for i in st) for st in stages]
    assert runs["port"][CKPT_CASE]["mirror_bytes"] == 4 * (n[0] + n[1])


def test_mirror_equals_normal_placement(runs):
    """The mirror placement's step is the normal placement's on the same
    weights (row ``d`` of its layout holds stage ``S-1-d``)."""
    mirror, normal = runs["port"]["mirror"], runs["port"]["normal"]
    np.testing.assert_allclose(mirror["loss"], normal["loss"], rtol=EQUAL_RTOL)
    np.testing.assert_allclose(mirror["acc"], normal["acc"], rtol=0)
    flipped = _restack((None, mirror["params"][-1][1]), NORMAL, True, False)[1]
    assert_stacked_close(flipped, normal["params"][-1][1], NORMAL, TRAINER_RTOL,
                          TRAINER_ATOL, "mirror against the normal placement")


def test_mirror_layout_matches_jax(runs):
    """The mirror placement's stacked layout is JAX's: row ``d`` holds stage
    ``S-1-d``."""
    from mpi4dl_tpu_torch.weights import pipeline_layout

    jtr = runs["jax"]["mirror"]["trainer"]
    model, stages, placement = _layout(CASES["mirror"], mirror=True)
    assert placement == [[1], [0]]
    assert pipeline_layout(model, stages, placement) == (jtr._chunk_offsets, jtr.max_p)


def test_batch_of_one_chunk_is_refused(runs):
    msg = runs["port"]["refusal"]
    assert msg is not None and "2 chunks of batch 4" in msg


def test_jax_checkpoint_restores_into_the_port(runs):
    """The JAX GEMS checkpoint after step 0 restores into the port's
    ``GemsMasterTrainer`` exactly (rows, momentum, step), and the next
    step's loss is JAX's."""
    want = runs["jax"][CKPT_CASE]["after_first"]
    front, stacked, front_m, stacked_m, step = runs["port"][CKPT_CASE]["restored"]
    assert step == 1
    np.testing.assert_array_equal(stacked, want.params[1])
    np.testing.assert_array_equal(stacked_m, want.opt_state[0].trace[1])
    assert front.size == front_m.size == 0
    np.testing.assert_allclose(runs["port"][CKPT_CASE]["restored_loss"],
                               runs["jax"][CKPT_CASE]["loss"][1], rtol=CKPT_LOSS_RTOL)


def test_port_checkpoint_restores_into_jax(runs):
    """The port's GEMS checkpoint (rank 0 writes, after step 0) restores into
    the JAX ``GemsMasterTrainer``'s TrainState exactly; JAX's next step
    gives the port's loss."""
    import jax
    import jax.numpy as jnp

    from mpi4dl_tpu import checkpoint as jax_ckpt
    from mpi4dl_tpu.ops import layers as jax_layers
    from mpi4dl_tpu.train import TrainState

    run, got, spec = runs["jax"][CKPT_CASE], runs["port"][CKPT_CASE], CASES[CKPT_CASE]
    tr = run["trainer"]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "_bn_moments_plain", f64_moments)
        params = jax.tree.map(jnp.asarray, run["init"])
        target = TrainState(params=params, opt_state=tr.tx.init(params),
                            step=jnp.zeros((), jnp.int32))
        state = jax_ckpt.restore_checkpoint(runs["port_ckpt"], target)
        assert int(state.step) == 1
        np.testing.assert_array_equal(np.asarray(state.params[1]), got["params"][0][1])
        np.testing.assert_array_equal(np.asarray(state.opt_state[0].trace[1]),
                                      got["saved_momentum"][1])
        x, y = batches(chunks_of(spec) * spec[2]["batch_size"], spec[1])[1]
        state = replicated(jax.tree.map(jnp.asarray, state), tr.mesh)
        _, m = tr.train_step(state, *tr.shard_batch(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(m["loss"]), got["loss"][1], rtol=CKPT_LOSS_RTOL)
