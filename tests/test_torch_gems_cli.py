"""The four GEMS twins (``mpi4dl_tpu_torch.benchmarks.gems_master_model`` and
``gems_master_with_spatial_parallelism``) through their own CLI, as
subprocesses with ``--device cpu`` at tiny sizes (ResNet with
``MPI4DL_TPU_RESNET_N=2``, AmoebaNet-D 3L/16F), ``--times 2`` and
``--enable-master-comm-opt``: each spawns its gloo ranks (split 2 on 2 ranks;
vertical 2 tiles x split 3 on 4), trains 2 steps of ``2·2·2`` images,
prints the note that the pairwise exchange is implied, each step's img/s
and the reference's closing ``Mean ... img/s Median ... img/s`` line (no MFU
on the CPU). Each rank's ``MPI4DL_TPU_RUN_REPORT`` record counts 8 images a
step and the bytes of its mirror exchanges (every layout here has 2 pipe
coordinates, so every rank has a partner).
"""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COMMON = ["--batch-size", "2", "--parts", "2", "--times", "2", "--enable-master-comm-opt",
           "--max-steps", "2", "--precision", "fp32", "--verbose", "--device", "cpu"]
_SP = ["--split-size", "3", "--spatial-size", "1", "--num-spatial-parts", "2",
       "--slice-method", "vertical"]
_AMOEBA = ["--num-layers", "3", "--num-filters", "16", "--image-size", "64"]
# twin module -> (flags, ranks)
CASES = {
    "gems_master_model.benchmark_resnet_gems_master":
        (["--split-size", "2", "--image-size", "32"], 2),
    "gems_master_model.benchmark_amoebanet_gems_master": (["--split-size", "2", *_AMOEBA], 2),
    "gems_master_with_spatial_parallelism.benchmark_resnet_gems_master_with_sp":
        ([*_SP, "--image-size", "32"], 4),
    "gems_master_with_spatial_parallelism.benchmark_amoebanet_gems_master_with_sp":
        ([*_SP, *_AMOEBA], 4),
}


@pytest.mark.parametrize("twin", sorted(CASES))
def test_gems_twin_runs_and_prints_mean_median(twin, tmp_path):
    flags, ranks = CASES[twin]
    env = dict(os.environ, PYTHONPATH=REPO, MPI4DL_TPU_RESNET_N="2", OMP_NUM_THREADS="1",
               MPI4DL_TPU_RUN_REPORT=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", f"mpi4dl_tpu_torch.benchmarks.{twin}",
                          *_COMMON, *flags], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    tag = twin.split(".")[-1]
    assert f"{tag}: {ranks} ranks on the CPU (gloo)" in out.stdout
    assert "note: --enable-master-comm-opt is implied" in out.stdout
    steps = re.findall(r"^epoch 0 step \d: loss ([0-9.]+) acc [0-9.]+ \(([0-9.]+) img/s\)$",
                       out.stdout, re.M)
    assert len(steps) == 2, out.stdout
    assert re.search(rf"^{tag}: Mean [0-9.]+ img/s Median [0-9.]+ img/s$", out.stdout, re.M), \
        out.stdout
    for r in range(ranks):
        with open(tmp_path / f"rank{r}.json") as f:
            report = json.load(f)
        assert report["images"] == 8 and report["transport"] == "gloo"
        assert report["mirror_bytes"] > 0  # every rank has a partner: 2 pipe coordinates


def _twins_in_turn(rank, world, ports, reports):
    """In one rank of a spawned gloo world: end the world's group, then run
    the ResNet LP GEMS twin and the ResNet LP twin under 1F1B, one after the
    other in this process, through their ``main`` as ranks a launcher
    started (``RANK``, ``WORLD_SIZE``, ``MASTER_PORT``). Returns per run
    (exit code, standard output, seconds of ``main``, whether a process
    group is left)."""
    import contextlib
    import io
    import time

    import torch
    import torch.distributed as dist

    from mpi4dl_tpu_torch.benchmarks.gems_master_model import benchmark_resnet_gems_master
    from mpi4dl_tpu_torch.benchmarks.layer_parallelism import benchmark_resnet_lp

    torch.set_num_threads(1)
    dist.destroy_process_group()
    runs = [(benchmark_resnet_gems_master.main, ["--times", "1"], {}),
            (benchmark_resnet_lp.main, ["--parts", "4", "--batch-size", "4"],
             {"MPI4DL_TPU_PIPELINE_SCHEDULE": "1f1b"})]
    out = []
    for (main, flags, env), port, report in zip(runs, ports, reports):
        os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          MPI4DL_TPU_RUN_REPORT=report, MPI4DL_TPU_RESNET_N="2")
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = main(["--batch-size", "2", "--parts", "2", "--split-size", "2",
                       "--image-size", "32", "--max-steps", "2", "--precision", "fp32",
                       "--device", "cpu", *flags])
        out.append((rc, buf.getvalue(), time.monotonic() - t0, dist.is_initialized()))
    return out


def test_launched_twins_run_in_turn_in_one_process(tmp_path):
    """Under a launcher, a twin joins a process group of its own and leaves
    it, so one process runs several twins in turn; each run report's set-up
    counts from its ``main``'s call, not from the process's start."""
    import socket

    from mpi4dl_tpu_torch.parallel import multihost

    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    reports = [str(tmp_path / "gems"), str(tmp_path / "lp")]
    ranks = multihost.spawn(_twins_in_turn, 2, args=(ports, reports), timeout=240)
    for rank, runs in enumerate(ranks):
        for (rc, stdout, seconds, left), report, tag in zip(
                runs, reports, ("benchmark_resnet_gems_master", "benchmark_resnet_lp")):
            assert rc == 0 and not left
            assert bool(re.search(rf"^{tag}: Mean [0-9.]+ img/s Median", stdout, re.M)) == (
                rank == 0), stdout
            with open(os.path.join(report, f"rank{rank}.json")) as f:
                record = json.load(f)
            assert record["counted_steps"] == 1 and 0 < record["setup_s"] < seconds
    with open(os.path.join(reports[0], "rank0.json")) as f:
        assert json.load(f)["images"] == 4
