"""The SP twins (``mpi4dl_tpu_torch.benchmarks.spatial_parallelism``) at tiny
sizes on the CPU (ResNet with ``MPI4DL_TPU_RESNET_N=2``, ResNet-20;
AmoebaNet-D 3L/32F @64): each layout trains 2 steps and prints the
reference's closing ``Mean ... img/s Median ... img/s`` line. The layouts:
SP+LP (vertical 2 tiles, split 3, parts 2) of both models, with an eval
through the pipeline; LOCAL_DP_LP (square 4, split 2, ``--local-DP 4``);
the D2 front (``--halo-D2 --fused-layers 2``); skewed SP
(``--num-spatial-parts 4,2``, split 3, spatial 2) with an eval; a resumed
SP+LP checkpoint. ``--split-size 1 --spatial-size 1`` makes every cell
spatial, which the port's ``Trainer`` refuses.

ResNet's SP+LP case runs as the user runs it, ``python -m ...`` with
``--device cpu``, which spawns its own 4 gloo ranks. Every other run shares
one 4-rank gloo world (started while that subprocess runs): each rank
parses the case's flags with the twins' parser and runs the twins' rank
body (``benchmarks.common._run``, what each spawned rank of ``main`` runs),
rank 0's output captured."""

import contextlib
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from mpi4dl_tpu_torch.parallel import multihost

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"MPI4DL_TPU_RESNET_N": "2", "OMP_NUM_THREADS": "1"}
_COMMON = ["--precision", "fp32", "--verbose", "--device", "cpu", "--max-steps", "2"]
_SPLP = ["--batch-size", "2", "--parts", "2", "--split-size", "3", "--spatial-size", "1",
         "--num-spatial-parts", "2", "--slice-method", "vertical"]
CASES = {
    "resnet_sp_lp": ("resnet", [*_SPLP, "--image-size", "32", "--eval-batches", "1"]),
    "amoebanet_sp_lp": ("amoebanet", [*_SPLP, "--image-size", "64", "--num-layers", "3",
                                      "--num-filters", "32"]),
    "resnet_local_dp": ("resnet", ["--batch-size", "4", "--parts", "1", "--split-size", "2",
                                   "--spatial-size", "1", "--num-spatial-parts", "4",
                                   "--slice-method", "square", "--local-DP", "4",
                                   "--image-size", "32"]),
    "resnet_d2": ("resnet", ["--batch-size", "2", "--parts", "2", "--split-size", "2",
                             "--spatial-size", "1", "--num-spatial-parts", "4", "--halo-D2",
                             "--fused-layers", "2", "--image-size", "64"]),
    "resnet_skewed": ("resnet", ["--batch-size", "2", "--parts", "2", "--split-size", "3",
                                 "--spatial-size", "2", "--num-spatial-parts", "4,2",
                                 "--image-size", "32", "--eval-batches", "1"]),
}
SUBPROCESS_CASE = "resnet_sp_lp"
_CKPT = [*_SPLP, "--image-size", "32", "--precision", "fp32", "--verbose", "--device", "cpu"]
_ALL_SPATIAL = ["--batch-size", "2", "--split-size", "1", "--spatial-size", "1",
                "--num-spatial-parts", "4", "--image-size", "32", *_COMMON]
MEAN = re.compile(r"^benchmark_(resnet|amoebanet)_sp: Mean [0-9.]+ img/s Median [0-9.]+ img/s$",
                  re.M)


def _twin_rank(rank, world, jobs):
    """Each job ``(key, model, argv)`` through the twins' rank body in turn;
    rank 0 returns ``{key: (stdout, ValueError message or None)}`` and, after
    each job, the listing of its ``--checkpoint-dir`` under ``(key, "ls")``."""
    from mpi4dl_tpu_torch.benchmarks import common
    from mpi4dl_tpu_torch.parser import get_parser

    torch.set_num_threads(1)
    out = {}
    for key, model, argv in jobs:
        buf, err = io.StringIO(), None
        with contextlib.redirect_stdout(buf):
            try:
                common._run(get_parser().parse_args(argv), model, f"benchmark_{model}_sp",
                            spatial=True)
            except ValueError as e:  # every rank refuses alike
                err = str(e)
        out[key] = (buf.getvalue(), err)
        if "--checkpoint-dir" in argv:
            out[key, "ls"] = sorted(os.listdir(argv[argv.index("--checkpoint-dir") + 1]))
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("sp_ckpt") / "ck")
    model, argv = CASES[SUBPROCESS_CASE]
    proc = subprocess.Popen(
        [sys.executable, "-m",
         f"mpi4dl_tpu_torch.benchmarks.spatial_parallelism.benchmark_{model}_sp",
         *argv, *_COMMON],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, **ENV), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        jobs = [(case, m, [*a, *_COMMON]) for case, (m, a) in CASES.items()
                if case != SUBPROCESS_CASE]
        jobs += [("ckpt_first", "resnet", [*_CKPT, "--checkpoint-dir", ckpt, "--max-steps", "2"]),
                 ("ckpt_resumed", "resnet",
                  [*_CKPT, "--checkpoint-dir", ckpt, "--max-steps", "3", "--resume"]),
                 ("all_spatial", "resnet", _ALL_SPATIAL)]
        out = multihost.spawn(_twin_rank, 4, args=(jobs,), env=ENV, timeout=600)[0]
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        proc.kill()
        proc.wait()
    out[SUBPROCESS_CASE] = (stdout, None)
    return {"runs": out, "subprocess": (proc.returncode, stdout, stderr)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_twin_runs_and_prints_mean_median(case, outputs):
    _, argv = CASES[case]
    stdout, err = outputs["runs"][case]
    assert err is None, err
    if case == SUBPROCESS_CASE:
        code, _, stderr = outputs["subprocess"]
        assert code == 0, stderr[-3000:]
        assert "4 ranks on the CPU (gloo)" in stdout
    losses = re.findall(r"^epoch 0 step \d: loss ([0-9.]+) acc", stdout, re.M)
    assert len(losses) == 2, stdout
    assert MEAN.search(stdout), stdout
    if "--eval-batches" in argv:
        b = argv[argv.index("--batch-size") + 1]
        assert re.search(rf"^eval \(1 cal / 1 test batches, {b} images\): loss", stdout,
                         re.M), stdout


def test_sp_lp_checkpoint_resumes(outputs):
    runs = outputs["runs"]
    first, err = runs["ckpt_first"]
    assert err is None, err
    assert MEAN.search(first), first
    assert runs["ckpt_first", "ls"] == ["step_00000002"]
    again, err = runs["ckpt_resumed"]
    assert err is None, err
    assert "resumed from step 2" in again
    assert re.findall(r"^epoch 0 step (\d):", again, re.M) == ["2"]


def test_every_cell_spatial_is_refused(outputs):
    """``--split-size 1 --spatial-size 1`` puts every cell, the head too, on
    the tiles: the ``Trainer`` branch refuses it."""
    _, err = outputs["runs"]["all_spatial"]
    assert err is not None and "num_spatial_cells must leave the head unsplit" in err
