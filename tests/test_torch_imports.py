"""The port stands alone: importing every module of ``mpi4dl_tpu_torch`` and
``chip_smoke`` loads no ``jax`` and nothing of ``mpi4dl_tpu``, nor
``msgpack`` or ``flax`` (the card has neither: the checkpoint codec is the
port's own), and entry points never fall back to the CPU quietly."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


LP_TWINS = ("benchmarks.layer_parallelism.benchmark_resnet_lp",
            "benchmarks.layer_parallelism.benchmark_amoebanet_lp")
SP_TWINS = ("benchmarks.spatial_parallelism.benchmark_resnet_sp",
            "benchmarks.spatial_parallelism.benchmark_amoebanet_sp")
GEMS_TWINS = ("benchmarks.gems_master_model.benchmark_resnet_gems_master",
              "benchmarks.gems_master_model.benchmark_amoebanet_gems_master",
              "benchmarks.gems_master_with_spatial_parallelism.benchmark_resnet_gems_master_with_sp",
              "benchmarks.gems_master_with_spatial_parallelism."
              "benchmark_amoebanet_gems_master_with_sp")
HALO_TWINS = tuple(f"benchmarks.communication.halo.benchmark_sp_halo_exchange{s}"
                   for s in ("", "_with_compute", "_with_compute_val", "_conv"))
SERVE_MODULES = ("serve", "serve.batching", "serve.scheduler", "serve.engine", "serve.sharded",
                 "serve.loadgen", "serve.tiled", "serve.__main__", "benchmarks.serving",
                 "benchmarks.serving.loadgen", "fleet", "fleet.errors",
                 "tenancy", "tenancy.model", "telemetry", "telemetry.registry",
                 "telemetry.catalog", "telemetry.spans", "telemetry.slo", "telemetry.canary",
                 "telemetry.tail", "telemetry.coldstart", "telemetry.memory",
                 "telemetry.windows", "telemetry.alerts", "telemetry.autoscale",
                 "telemetry.export")
PORT_MODULES = sorted(
    _module_name(p) for p in (REPO / "mpi4dl_tpu_torch").rglob("*.py")
)


def test_port_modules_listed():
    assert "mpi4dl_tpu_torch.ops.pool_kernel" in PORT_MODULES
    assert "mpi4dl_tpu_torch.ops.dot1x1_kernel" in PORT_MODULES
    assert "mpi4dl_tpu_torch.ops.wgrad_kernel" in PORT_MODULES
    assert "mpi4dl_tpu_torch.models.resnet" in PORT_MODULES
    assert "mpi4dl_tpu_torch.train" in PORT_MODULES
    assert "mpi4dl_tpu_torch.parallel.multihost" in PORT_MODULES
    assert "mpi4dl_tpu_torch.parallel.halo" in PORT_MODULES
    assert "mpi4dl_tpu_torch.ops.halo_kernel" in PORT_MODULES
    assert "mpi4dl_tpu_torch.flops" in PORT_MODULES
    for name in ("evaluate", "checkpoint", "serialization", "data", "native",
                 "convergence_run", "parser", "parallel.partition", "parallel.pipeline",
                 "benchmarks.common", *LP_TWINS, *SP_TWINS, *GEMS_TWINS, *HALO_TWINS,
                 "benchmarks.communication.halo.halo_common", "elastic", "profile_step",
                 "profiling", "telemetry.jsonl", "telemetry.health", "telemetry.flight",
                 *SERVE_MODULES):
        assert f"mpi4dl_tpu_torch.{name}" in PORT_MODULES


def test_no_jax_and_no_jax_package_loaded():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack', 'mpi4dl_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_trainer_without_device_raises_without_cuda(monkeypatch):
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.ops.layers import Dense
    from mpi4dl_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = torch.nn.Sequential(Dense(12, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, ParallelConfig(batch_size=2, image_size=2))
    # Asked for explicitly, the CPU is fine.
    Trainer(model, ParallelConfig(batch_size=2, image_size=2), device="cpu")


def _refuses_without_cuda(twin):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", f"mpi4dl_tpu_torch.{twin}", "--max-steps", "1"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 2, out.stderr[-2000:]
    assert "CUDA is not available; pass --device cpu" in out.stderr
    assert "Mean" not in out.stdout and "ranks" not in out.stdout


@pytest.mark.parametrize("twin", LP_TWINS)
def test_lp_twins_without_device_refuse_without_cuda(twin):
    """The LP twins run on the card unless ``--device cpu`` is given: without
    a card they exit 2 before any rank starts, and train nothing."""
    _refuses_without_cuda(twin)


@pytest.mark.parametrize("twin", SP_TWINS)
def test_sp_twins_without_device_refuse_without_cuda(twin):
    """The SP twins, likewise."""
    _refuses_without_cuda(twin)


@pytest.mark.parametrize("twin", GEMS_TWINS)
def test_gems_twins_without_device_refuse_without_cuda(twin):
    """The GEMS twins, likewise."""
    _refuses_without_cuda(twin)


@pytest.mark.parametrize("twin", HALO_TWINS)
def test_halo_twins_without_device_refuse_without_cuda(twin):
    """The halo twins, likewise: without a card and without ``--device cpu``
    they exit 2 before any rank starts."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", f"mpi4dl_tpu_torch.{twin}"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "CUDA is not available; pass --device cpu --impl plain" in out.stderr
    assert "ranks" not in out.stdout and "PASSED" not in out.stdout


def test_serving_from_a_checkpoint_refuses_without_cuda(monkeypatch, tmp_path):
    """``ServingEngine.from_checkpoint`` builds on the card unless asked for
    the CPU: without a card it raises before it captures anything."""
    from mpi4dl_tpu_torch.checkpoint import model_metadata, save_checkpoint
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.serve import ServingEngine
    from mpi4dl_tpu_torch.train import Trainer

    trainer = Trainer(get_resnet_v2(11, 10, pool_kernel=2), ParallelConfig(
        batch_size=1, image_size=8), device="cpu")
    save_checkpoint(str(tmp_path), trainer, metadata=model_metadata(
        "resnet_v2", 8, depth=11, num_classes=10, pool_kernel=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine.from_checkpoint(str(tmp_path))
