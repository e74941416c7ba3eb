"""``python -m mpi4dl_tpu_torch.serve`` (``mpi4dl_tpu_torch/serve/__main__.py``)
against ``python -m mpi4dl_tpu.serve``'s ``main``, CPU.

Each case runs the port's ``main(["--device", "cpu", ...])`` and the JAX
``main`` on the same small flags and holds the reports to the same keys
(the report's, the load's, the serial baseline's, the SLO verdict's, the
tiled block's) and the same counts: the default synthetic engine with the
SLO flags, ``--metrics-port 0`` and a JSONL log; ``--ckpt`` (one checkpoint
that the port writes in the JAX format, served by both); ``--tiled`` (the
geometry equal); ``--mesh 2x2`` (4 gloo ranks in the port, the rank-0
report alone). Also: the flags of ROADMAP item 10 reach the model build
(``--trace-dir`` with ``--attribution-every`` is refused before it), the CLI raises without ``--device cpu``
where there is no card, and ``python -m mpi4dl_tpu_torch.serve --device cpu
--requests 16`` (and the ``benchmarks/serving/loadgen.py`` twin) prints one
JSON last line with the JAX report's keys.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi4dl_tpu.serve.__main__ import main as jax_main
from mpi4dl_tpu_torch.serve import __main__ as cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ``mpi4dl_tpu/serve/__main__.py``'s report keys with a serial baseline.
BASE_KEYS = {"model", "buckets", "mesh", "serial", "loadgen", "speedup_vs_serial"}


def _last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def _both(capsys, flags, port_flags=(), jax_flags=()):
    """(JAX report, port report) of the same flags."""
    assert jax_main([*jax_flags, *flags]) == 0
    want = _last_json(capsys.readouterr().out)
    assert cli.main(["--device", "cpu", *port_flags, *flags]) == 0
    got = _last_json(capsys.readouterr().out)
    return want, got


def _same_shape(want, got):
    assert set(got) == set(want)
    for key in ("serial", "loadgen", "slo", "tiled"):
        if key in want:
            assert set(got[key]) == set(want[key]), key
    for key in ("latency_s", "client_overhead_s"):
        assert set(got["loadgen"][key]) == set(want["loadgen"][key]), key
    for key in ("model", "buckets", "mesh"):
        assert got[key] == want[key], key
    assert got["loadgen"]["served"] == want["loadgen"]["served"] == got["loadgen"]["offered"]


def test_default_engine_with_slo_and_metrics(capsys, tmp_path):
    from mpi4dl_tpu_torch import telemetry

    flags = ["--image-size", "16", "--depth", "11", "--max-batch", "4", "--requests", "24",
             "--concurrency", "8", "--serial", "8", "--metrics-port", "0",
             "--slo-availability", "99.9", "--slo-latency-ms", "2500", "--slo-interval", "0.2"]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    want, got = _both(capsys, flags, ["--telemetry-dir", str(port_dir)],
                      ["--telemetry-dir", str(jax_dir)])
    _same_shape(want, got)
    assert set(got) == BASE_KEYS | {"metrics_port", "slo"}
    assert isinstance(got["metrics_port"], int) and got["metrics_port"] > 0
    assert got["loadgen"]["engine"]["queue_depth"] == 0
    assert got["slo"] == {
        "ok": True, "alerts_fired": {},
        "slos": {name: {"objective": want["slo"]["slos"][name]["objective"], "sli": 1.0,
                        "budget_remaining": 1.0} for name in ("availability", "latency")}}
    assert got["slo"] == want["slo"]
    assert got["loadgen"]["client_overhead_s"]["p50"] >= 0
    (log,) = port_dir.iterdir()
    events = telemetry.read_events(str(log))
    served = [e for e in events if e["kind"] == "span" and e["name"] == "serve.request"
              and e["attrs"]["outcome"] == "served"]
    assert len(served) == 24
    client = [e for e in events if e["kind"] == "span" and e["name"] == "client.request"]
    assert {e["trace_id"] for e in client} >= {e["trace_id"] for e in served}


def test_checkpoint_served_by_both(capsys, tmp_path):
    from mpi4dl_tpu_torch import evaluate
    from mpi4dl_tpu_torch.checkpoint import model_metadata, save_checkpoint
    from mpi4dl_tpu_torch.config import ParallelConfig
    from mpi4dl_tpu_torch.models.resnet import get_resnet_v2
    from mpi4dl_tpu_torch.train import Trainer
    from mpi4dl_tpu_torch.weights import init

    size = 16
    model = init(get_resnet_v2(11, 10, pool_kernel=size // 4), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    stats = evaluate.collect_batch_stats(
        model, [rng.standard_normal((4, size, size, 3)).astype(np.float32)])
    trainer = Trainer(model, ParallelConfig(batch_size=1, image_size=size), device="cpu")
    save_checkpoint(str(tmp_path), trainer, batch_stats=stats, metadata=model_metadata(
        "resnet_v2", size, depth=11, num_classes=10, pool_kernel=size // 4))
    want, got = _both(capsys, ["--ckpt", str(tmp_path), "--max-batch", "2", "--requests", "8",
                               "--concurrency", "4", "--serial", "2"])
    _same_shape(want, got)
    assert set(got) == BASE_KEYS and got["model"] == "checkpoint:" + str(tmp_path)


def test_tiled(capsys, tmp_path):
    flags = ["--tiled", "48x48", "--tile", "16", "--requests", "3", "--concurrency", "2",
             "--serial", "0", "--deadline-ms", "120000"]
    out = tmp_path / "tiled.json"
    want, got = _both(capsys, flags, ["--json", str(out)])
    assert set(got) == set(want) == {"model", "buckets", "mesh", "loadgen", "tiled", "slo"}
    _same_shape(want, got)
    assert json.loads(out.read_text()) == got
    geometry = ("image", "tile", "margin", "stride", "window", "grid", "tiles_per_request",
                "feature_hw", "feature_channels", "requests", "tiles_total")
    assert {k: got["tiled"][k] for k in geometry} == {k: want["tiled"][k] for k in geometry}
    assert got["tiled"]["grid"] == [3, 3] and got["tiled"]["tiles_total"] == 27
    assert list(got["slo"]["slos"]) == list(want["slo"]["slos"]) == ["latency_tiled"]
    assert got["buckets"] == [1]
    with pytest.raises(SystemExit, match="square"):
        cli.main(["--device", "cpu", "--tiled", "48x32"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["--device", "cpu", "--tiled", "48x48", "--mesh", "2x2"])


def test_mesh_2x2_over_gloo(capsys):
    """The port spawns 4 gloo ranks: rank 0 serves and returns the report,
    the followers print nothing and end when it stops."""
    flags = ["--mesh", "2x2", "--image-size", "16", "--max-batch", "2", "--requests", "8",
             "--concurrency", "4", "--serial", "2"]
    want, got = _both(capsys, flags)
    _same_shape(want, got)
    assert got["mesh"] == [2, 2] and got["buckets"] == [1, 2]
    assert got["loadgen"]["engine"]["mesh"] == [2, 2]


@pytest.mark.parametrize("flags", [["--lint"], ["--trace-dir", "/nonexistent"],
                                   ["--attribution-every", "4"]])
def test_item_10_flags_refused_before_any_model(capsys, monkeypatch, flags):
    """Item 10's flags are ported: each alone reaches the model build. Only
    ``--trace-dir`` with ``--attribution-every`` is refused, before any
    model (the profiler is process-wide)."""
    def built(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(cli, "_engine", built)
    with pytest.raises(AssertionError, match="a model was built"):
        cli.main(["--device", "cpu", *flags])
    other = {"--trace-dir": ["--attribution-every", "4"],
             "--attribution-every": ["--trace-dir", "/nonexistent"]}.get(flags[0])
    if other is not None:
        with pytest.raises(SystemExit) as exc:
            cli.main(["--device", "cpu", *flags, *other])
        assert exc.value.code == 2
        assert "exclude each other" in capsys.readouterr().err


def test_raises_without_a_card_unless_cpu(monkeypatch):
    def built(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(cli, "_engine", built)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--requests", "4"])


@pytest.mark.parametrize("module", ["mpi4dl_tpu_torch.serve",
                                    "mpi4dl_tpu_torch.benchmarks.serving.loadgen"])
def test_module_prints_one_report_line(module):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", module, "--device", "cpu", "--requests", "16",
                          "--image-size", "16", "--serial", "4"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    rep = json.loads(lines[-1])
    assert sum(ln.startswith("{") for ln in lines) == 1
    assert set(rep) == BASE_KEYS and rep["loadgen"]["served"] == 16
