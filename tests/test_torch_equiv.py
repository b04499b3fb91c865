"""Port's engine vs the reference SoA engine: identical Metrics rows on
every preset × workload prefix and on an off-preset point."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import trace as ref_trace  # noqa: E402
from repro.core.params import HybridMemParams, TensorPolicyParams  # noqa: E402
from repro.core.presets import CONFIGS, TENSOR_AWARE  # noqa: E402
from repro.core.simulator import simulate  # noqa: E402
from repro_torch.core import engine_torch  # noqa: E402
from repro_torch.core.params import from_reference  # noqa: E402

N = 400


@pytest.fixture(scope="module")
def prefixes():
    out = {}
    for wl, gen in ref_trace.WORKLOADS.items():
        tr = gen(scale=0.012)
        sub = dict(tr)
        for k in ("core", "pc", "addr", "write", "tensor", "reuse"):
            sub[k] = tr[k][:N]
        out[wl] = sub
    return out


def _check(ref_sp, tr):
    sp = from_reference(dataclasses.asdict(ref_sp))
    oi, od = engine_torch.run_single(sp, tr, device="cpu")
    got = engine_torch.metrics_from_outputs(sp, tr, oi, od)
    want = simulate(ref_sp, tr, engine="soa")
    assert got.row() == want.row()


@pytest.mark.parametrize("wl", list(ref_trace.WORKLOADS))
@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_metrics_equal_soa(prefixes, wl, i):
    _check(CONFIGS[i], prefixes[wl])


def test_off_preset_point_equal_soa():
    """Tensor-aware at every level with a tiny shadow and fast decay,
    and a hybrid memory that promotes quickly: the rare paths run."""
    ta = TensorPolicyParams(sample=2, shadow_max=16, decay_fills=64,
                            prefetch_rank=3.5, stream_rank=1.5)
    sp = dataclasses.replace(
        TENSOR_AWARE, name="off",
        l1=dataclasses.replace(TENSOR_AWARE.l1, policy="tensor_aware", ta=ta),
        l2=dataclasses.replace(TENSOR_AWARE.l2, policy="tensor_aware", ta=ta),
        l3=dataclasses.replace(TENSOR_AWARE.l3, ta=ta),
        hybrid=HybridMemParams(enabled=True, hot_threshold=3, window=128,
                               migration_cost_cycles=300))
    full = ref_trace.WORKLOADS["rnn"](scale=0.012)
    tr = dict(full)
    for k in ("core", "pc", "addr", "write", "tensor", "reuse"):
        tr[k] = full[k][:1500]
    _check(sp, tr)
