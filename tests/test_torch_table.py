"""``python -m repro_torch table`` against the reference table path, the
no-CUDA refusal, and the port's import boundary."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.api.schema import validate_artifact  # noqa: E402
from repro.core import trace as ref_trace  # noqa: E402
from repro.core.calibration import aggregate_rows  # noqa: E402
from repro.core.presets import CONFIGS  # noqa: E402
from repro.core.simulator import simulate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CAP = "200"


def _run_cli(args, tmp_path, **env):
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable, "-m", "repro_torch", *args],
                          capture_output=True, text=True, env=e,
                          cwd=tmp_path, timeout=600)


@pytest.fixture(scope="module")
def smoke_table(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("table")
    out = tmp / "table.json"
    r = _run_cli(["table", "--smoke", "--device", "cpu", "--out", str(out)],
                 tmp, REPRO_TRACE_CAP=CAP)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text()), r.stdout


@pytest.fixture(scope="module")
def reference_rows():
    old = os.environ.get("REPRO_TRACE_CAP")
    os.environ["REPRO_TRACE_CAP"] = CAP
    try:
        traces = [gen(0.02) for gen in ref_trace.WORKLOADS.values()]
    finally:
        if old is None:
            del os.environ["REPRO_TRACE_CAP"]
        else:
            os.environ["REPRO_TRACE_CAP"] = old
    return {sp.name: [simulate(sp, tr, engine="soa").row() for tr in traces]
            for sp in CONFIGS}


def test_rows_equal_reference(smoke_table, reference_rows):
    art, _ = smoke_table
    want = [row for sp in CONFIGS for row in reference_rows[sp.name]]
    assert art["rows"] == want


def test_aggregates_equal_reference(smoke_table, reference_rows):
    art, stdout = smoke_table
    for name, rows in reference_rows.items():
        want = {k: v for k, v in aggregate_rows(rows).items()
                if k != "per_workload"}
        assert art["result"]["aggregates"][name] == want
    assert "monotone trend" in stdout and "tensor_aware" in stdout


def test_artifact_is_a_reference_table_artifact(smoke_table):
    art, _ = smoke_table
    validate_artifact(art)
    assert art["provenance"]["engine"] == "torch"
    assert art["provenance"]["device"] == "cpu"


def test_default_device_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_cli(["table", "--smoke"], tmp_path, REPRO_TRACE_CAP="50")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)
