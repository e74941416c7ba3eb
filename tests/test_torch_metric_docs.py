"""The port's metric catalog has its own docs pin: the table under "The
port's metric catalog" in ``docs/PORT.md`` lists exactly the metrics of
``mpi4dl_tpu_torch/telemetry/catalog.py``, with their types and labels (the
pattern of ``tests/test_telemetry.py:493``, over the port's document)."""

import os
import re

import pytest

from mpi4dl_tpu_torch.telemetry.catalog import CATALOG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DOC_ROW = re.compile(r"^\|\s*`([a-z_][a-z0-9_]*)`\s*\|([^|]+)\|([^|]+)\|")
SECTION = "## The port's metric catalog"


def _docs_catalog() -> dict:
    """``{name: (type, labels)}`` of the section's table rows."""
    out, inside = {}, False
    with open(os.path.join(REPO, "docs", "PORT.md")) as f:
        for line in f:
            if line.startswith("## "):
                inside = line.strip() == SECTION
                continue
            m = _DOC_ROW.match(line.strip()) if inside else None
            if m:
                assert m.group(1) not in out, f"{m.group(1)} listed twice"
                out[m.group(1)] = (m.group(2).strip(),
                                   tuple(re.findall(r"`([a-z_]+)`", m.group(3))))
    return out


def test_docs_metric_table_matches_the_port_catalog():
    docs = _docs_catalog()
    assert set(docs) == set(CATALOG), (
        f"docs-only: {sorted(set(docs) - set(CATALOG))}, "
        f"catalog-only: {sorted(set(CATALOG) - set(docs))}")


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_docs_row_has_the_catalog_type_and_labels(name):
    spec = CATALOG[name]
    assert _docs_catalog()[name] == (spec.type, tuple(spec.labels))
