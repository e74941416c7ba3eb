"""The repo's hygiene lint (``scripts/selflint.py``) over the port:
``time.monotonic`` in comparisons, metrics through ``telemetry.declare``,
named or daemon threads. ``scripts/selflint.py`` scans only the JAX
package, ``scripts/`` and ``bench.py``; this holds every ``.py`` file of
``mpi4dl_tpu_torch/`` and ``chip_smoke.py`` to the same rules, through the
script's own ``lint_file`` (imported by path; nothing in ``scripts/``
changes).
"""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The twins of the two files ``selflint.ALLOWLIST`` exempts from
# ``uncataloged-metric``: the telemetry internals that implement
# ``declare`` call the registry's constructors themselves.
PORT_ALLOWLIST = {
    "uncataloged-metric": {
        "mpi4dl_tpu_torch/telemetry/catalog.py",
        "mpi4dl_tpu_torch/telemetry/federation.py",
    },
}

SEEDED = '''

def _seeded_violations(deadline):
    import threading
    import time

    if time.time() > deadline:
        return None
    t = threading.Thread(target=print)
    t.start()
    return t
'''


@pytest.fixture(scope="module")
def selflint():
    spec = importlib.util.spec_from_file_location(
        "selflint_for_the_port", os.path.join(REPO, "scripts", "selflint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_sources() -> "list[str]":
    """Every ``.py`` file of the port, and ``chip_smoke.py``, relative."""
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, "mpi4dl_tpu_torch")):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.relpath(os.path.join(dirpath, f), REPO).replace(os.sep, "/")
                for f in sorted(filenames) if f.endswith(".py")]
    return out + ["chip_smoke.py"]


def scan(selflint, path: str, rel: str) -> "list[dict]":
    """``selflint.lint_file`` with the port's allowlist in place of the
    JAX package's."""
    return [f for f in selflint.lint_file(path, rel)
            if f["path"] not in PORT_ALLOWLIST.get(f["rule"], ())]


def test_allowlist_mirrors_the_jax_one(selflint):
    assert set(selflint.ALLOWLIST) >= set(PORT_ALLOWLIST)
    for rule, paths in selflint.ALLOWLIST.items():
        want = {p.replace("mpi4dl_tpu/", "mpi4dl_tpu_torch/", 1) for p in paths}
        assert PORT_ALLOWLIST.get(rule, set()) == want, rule
        for p in PORT_ALLOWLIST.get(rule, ()):
            assert os.path.isfile(os.path.join(REPO, p)), p


def test_port_lints_clean(selflint):
    files = port_sources()
    assert len(files) > 100 and "mpi4dl_tpu_torch/serve/engine.py" in files
    findings = [f for rel in files for f in scan(selflint, os.path.join(REPO, rel), rel)]
    assert findings == [], "\n".join(f"{f['path']}:{f['line']}: {f['rule']}: {f['message']}"
                                     for f in findings)
    # The allowlisted twins do call the constructors: the exemption is used.
    raw = [f for rel in sorted(PORT_ALLOWLIST["uncataloged-metric"])
           for f in selflint.lint_file(os.path.join(REPO, rel), rel)]
    assert {f["path"] for f in raw} == PORT_ALLOWLIST["uncataloged-metric"]
    assert {f["rule"] for f in raw} == {"uncataloged-metric"}


@pytest.mark.parametrize("rel", ["mpi4dl_tpu_torch/serve/loadgen.py",
                                 "mpi4dl_tpu_torch/telemetry/catalog.py", "chip_smoke.py"])
def test_seeded_violations_are_flagged(selflint, tmp_path, rel):
    """A copy of a port file with a ``time.time()`` comparison and an
    unnamed ``threading.Thread`` appended: the same scan flags both, also
    in a file the allowlist exempts from another rule."""
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    copy = tmp_path / os.path.basename(rel)
    copy.write_text(src + SEEDED)
    assert scan(selflint, os.path.join(REPO, rel), rel) == []
    found = scan(selflint, str(copy), rel)
    n_lines = src.count("\n")
    assert sorted(f["rule"] for f in found) == ["unnamed-thread", "wallclock-compare"]
    assert all(f["line"] > n_lines and f["path"] == rel for f in found)
