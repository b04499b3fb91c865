"""The port's own copies of the jax-free modules agree with the
reference: params and presets, traces, the knob lowering, Metrics, and
the lane descriptor layout of the step kernel."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import native as ref_native  # noqa: E402
from repro.core import presets as ref_presets  # noqa: E402
from repro.core import trace as ref_trace  # noqa: E402
from repro_torch.core import engine_torch, pack  # noqa: E402
from repro_torch.core import presets as presets  # noqa: E402
from repro_torch.core import trace as trace  # noqa: E402
from repro_torch.core.params import from_reference  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.mark.parametrize("name", list(ref_presets.PRESETS))
def test_from_reference_equals_every_preset(name):
    ref_sp = ref_presets.PRESETS[name]
    sp = from_reference(dataclasses.asdict(ref_sp))
    assert sp == presets.PRESETS[name]
    assert dataclasses.asdict(sp) == dataclasses.asdict(ref_sp)
    assert ref_presets.PAPER_TABLE[name] == presets.PAPER_TABLE[name]


@pytest.mark.parametrize("wl", list(ref_trace.WORKLOADS))
def test_traces_identical(wl):
    want = ref_trace.WORKLOADS[wl](scale=0.05)
    got = trace.WORKLOADS[wl](scale=0.05)
    assert got["name"] == want["name"]
    assert got["meta"] == want["meta"]
    for k in ("core", "pc", "addr", "write", "tensor", "reuse"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", list(ref_presets.PRESETS))
@pytest.mark.parametrize("nten", [5, 6])
def test_pack_config_equals_reference(name, nten):
    ci, cd = pack.pack_config_sp(presets.PRESETS[name], nten)
    rci, rcd = ref_native.pack_config_sp(ref_presets.PRESETS[name], nten)
    np.testing.assert_array_equal(ci, rci)
    np.testing.assert_array_equal(cd, rcd)


@pytest.fixture(scope="module")
def lane_outputs():
    tr = trace.WORKLOADS["rnn"](scale=0.012)
    sub = dict(tr)
    for k in ("core", "pc", "addr", "write", "tensor", "reuse"):
        sub[k] = tr[k][:400]
    return sub, engine_torch.run_batch(list(presets.CONFIGS), sub,
                                       device="cpu")


@pytest.mark.parametrize("i", range(4))
def test_metrics_from_outputs_equals_reference(lane_outputs, i):
    pytest.importorskip("jax")
    from repro.core import engine_jax
    sub, outs = lane_outputs
    oi, od = outs[i]
    got = engine_torch.metrics_from_outputs(presets.CONFIGS[i], sub, oi, od)
    want = engine_jax.metrics_from_outputs(ref_presets.CONFIGS[i], sub,
                                           oi, od)
    assert got.row() == want.row()


def _struct_fields(src: str, name: str):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    out = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.match(r"(?:const\s+)?(\w+)\s+(.*)", decl, re.S)
        typ, names = m.group(1), m.group(2)
        for nm in names.split(","):
            nm = nm.strip().lstrip("*").strip()
            arr = re.match(r"(\w+)\[(\d+)\]", nm)
            out.append((typ, nm) if not arr
                       else (typ, arr.group(1), int(arr.group(2))))
    return out


def test_lane_descriptor_matches_cuda_struct():
    """DESC_FIELDS is the LaneDesc struct of sim_step.cu, slot by slot."""
    from repro_torch.kernels.sim_step import DESC_FIELDS
    src = (SRC / "csrc" / "sim_step.cu").read_text()
    sub = {"CacheLv": ["l1", "l2", "l3"], "Chan": ["d", "h"]}
    names = []
    for f in _struct_fields(src, "LaneDesc"):
        typ, nm = f[0], f[1]
        if typ in sub:
            for pre in sub[typ][:f[2]]:
                names += [f"{pre}.{g[1]}" for g in _struct_fields(src, typ)]
        elif typ == "LDict":
            names += [f"{nm}.{g[1]}" for g in _struct_fields(src, typ)]
        else:
            names.append(nm)
    assert names == [n for n, _ in DESC_FIELDS]

