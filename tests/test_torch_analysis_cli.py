"""``python -m mpi4dl_tpu_torch.analyze`` (``analysis/cli.py``), the serve
CLI's ``--lint`` / ``--trace-dir`` / ``--attribution-every`` and the
bench's ``hlo`` / ``attribution`` keys, CPU:

- the lint CLI as a subprocess on the 2x2 spatial ResNet-v1 (4 gloo rank
  processes) and in process on one device: exit 0, the JSON report with
  the JAX ``Report``'s keys, the permutes in the halo window; the JAX CLI's
  pure-JSON subcommands exit 2 naming part 2 of the item;
- the serve CLI with ``--lint --trace-dir``: the JAX report's ``lint`` and
  ``attribution`` blocks (``mpi4dl_tpu/serve/__main__.py:518-569``), and
  with ``--attribution-every`` the sampled block;
- ``python -m mpi4dl_tpu_torch.bench --device cpu`` with the A/B extras
  off: the result line's ``hlo`` and ``attribution`` with the JAX entry's
  keys (``bench.py:1506-1522``, ``:1551-1566``), less the cost model's
  (part 2 of the item).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from mpi4dl_tpu.analysis.report import Report as JaxReport
from mpi4dl_tpu_torch.analysis import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT_KEYS = {f.name for f in dataclasses.fields(JaxReport)} | {"ok"}


def _env(**extra):
    base = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    return dict(base, PYTHONPATH=REPO + os.pathsep + base.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1", **extra)


def test_lint_cli_spatial_subprocess(tmp_path):
    path = tmp_path / "r.json"
    out = subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.analyze", "--device", "cpu",
                          "--size", "32", "--batch", "2", "--json", str(path)],
                         env=_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(path.read_text())
    assert REPORT_KEYS <= set(rep)
    assert rep["ok"] and rep["findings"] == [] and rep["max_severity"] is None
    n = rep["config"]["halo_shifts"]
    assert rep["config"]["tile_shape"] == [2, 2] and n > 0
    assert n <= rep["inventory"]["collective-permute"] <= 2 * n
    assert out.stdout.splitlines()[0].startswith("hlolint train_step: ")


def test_lint_cli_one_device_in_process(tmp_path, capsys):
    path = tmp_path / "r.json"
    rc = cli.main(["--device", "cpu", "--dp", "1", "--spatial-parts", "0", "--size", "32",
                   "--batch", "2", "--json", str(path)])
    assert rc == 0
    rep = json.loads(path.read_text())
    assert REPORT_KEYS <= set(rep) and rep["ok"]
    assert rep["overlap"]["n_collectives"] == 0 and rep["memory"] is None  # no peak on the CPU
    assert rep["config"]["key"] == "resnet_d8_32px_bs2_dp1_none_cpu"
    assert "0 collectives" in capsys.readouterr().out


# The JAX CLI's subcommands that the analyzers' second part ported.
PART_2 = ("bench-history", "trace-export", "tail", "incident", "costmodel", "coldstart",
          "numerics", "memory-plan")


@pytest.mark.parametrize("sub", PART_2)
def test_part_2_subcommands_exit_naming_the_item(sub, capsys):
    """Each subcommand reaches its own module: ``--help`` exits 0 with the
    subcommand's usage, and nothing says it is not ported."""
    assert "PART_2" not in vars(cli)
    with pytest.raises(SystemExit) as exc:
        cli.main([sub, "--help"])
    assert exc.value.code == 0
    out = capsys.readouterr()
    assert "not ported" not in out.out + out.err
    assert f"usage: python -m mpi4dl_tpu_torch.analyze {sub}" in out.out


def test_serve_cli_lint_and_trace_dir(tmp_path, capsys):
    from mpi4dl_tpu_torch.serve import __main__ as serve_cli

    base = ["--device", "cpu", "--image-size", "16", "--depth", "11", "--max-batch", "2",
            "--requests", "6", "--concurrency", "2", "--serial", "0"]
    rc = serve_cli.main([*base, "--lint", "--trace-dir", str(tmp_path / "tr")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert set(got["lint"]) == {"ok", "summary", "findings"} and got["lint"]["ok"]
    assert set(got["attribution"]) == {"n_steps", "per_step_mean", "range", "collective"}
    assert got["attribution"]["n_steps"] >= 1
    assert got["attribution"]["collective"]["verdict"] == "no-collectives"
    rc = serve_cli.main([*base, "--attribution-every", "1", "--attribution-min-interval", "0"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and got["attribution_sampled"]["program"] == "serve_sampled"


def test_bench_result_line_has_hlo_and_attribution():
    off = {k: "0" for k in ("BENCH_SERVING", "BENCH_TILED", "BENCH_FLEET", "BENCH_INCIDENT",
                            "BENCH_MULTITENANT", "BENCH_NUMERICS", "BENCH_SP_OVERLAP",
                            "BENCH_SERVING_SHARDED", "BENCH_PIPELINE", "BENCH_COLDSTART")}
    out = subprocess.run([sys.executable, "-m", "mpi4dl_tpu_torch.bench", "--device", "cpu"],
                         env=_env(BENCH_MODEL="resnet", BENCH_IMAGE_SIZE="32", BENCH_STEPS="1",
                                  **off),
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    records = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(records) == 3  # the headline, + hlo, + attribution
    last = records[-1]
    assert set(last["hlo"]) == {"costmodel", "inventory", "total_collective_bytes",
                                "bytes_by_op", "async_pairs", "zero_overlap",
                                "min_compute_between", "peak_hbm_bytes", "findings"}
    assert last["hlo"]["inventory"] == {} and last["hlo"]["findings"] == []
    assert set(last["hlo"]["costmodel"]) == {"cpu", "nvlink"}
    assert set(last["attribution"]) == {"n_steps", "per_step_mean", "overlap", "conv_impl",
                                        "crosscheck", "costmodel"}
    assert all(r["telemetry"]["kind"] == "metrics" for r in records)
    assert last["attribution"]["n_steps"] == 2 and last["attribution"]["crosscheck"] == []
