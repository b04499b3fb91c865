"""The committed paper-scale golden rows (what ``chip_smoke.py`` holds
the card's table to) are the reference SoA engine's rows at scale 1.0."""

import json
import os
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import trace as ref_trace
from repro.core.presets import CONFIGS
from repro.core.simulator import simulate

GOLDEN = (Path(__file__).resolve().parents[1]
          / "src" / "repro_torch" / "data" / "table_scale1.json")

#: sized for the compiled SoA kernel, as tests/test_trend.py
pytestmark = pytest.mark.skipif(
    os.environ.get("REPRO_SIM_NATIVE") == "0",
    reason="full-scale run needs the compiled SoA kernel for time")


@pytest.fixture(scope="module")
def traces():
    return [gen(1.0) for gen in ref_trace.WORKLOADS.values()]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_golden_rows_equal_soa_at_scale_1(traces, i):
    golden = json.loads(GOLDEN.read_text())
    n = len(traces)
    want = [simulate(CONFIGS[i], tr, engine="soa").row() for tr in traces]
    assert golden[i * n:(i + 1) * n] == want
