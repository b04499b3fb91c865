"""The port's batched engine (plain step on CPU lanes) against the JAX
engine it ports: identical oi/od export vectors per shape bucket, batch
== single including mixed buckets, overflow raises.  The step kernel
is held against the plain step in test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import presets as ref_presets  # noqa: E402
from repro.core import trace as ref_trace  # noqa: E402
from repro_torch.core import engine_torch  # noqa: E402
from repro_torch.core import presets  # noqa: E402
from repro_torch.core import trace  # noqa: E402

N = 700  # trace prefix: evictions, coherence, prefetch issue


def _prefix(tr, n=N):
    sub = dict(tr)
    for k in ("core", "pc", "addr", "write", "tensor", "reuse"):
        sub[k] = tr[k][:n]
    return sub


@pytest.fixture(scope="module")
def cnn_prefix():
    return _prefix(ref_trace.WORKLOADS["cnn"](scale=0.012))


@pytest.fixture
def engine_jax(monkeypatch):
    """engine_jax with x64 switched on the way jax 0.9 spells it (the
    reference's own ``_x64`` calls a removed API)."""
    from repro.core import engine_jax as ej
    monkeypatch.setattr(ej, "_x64", lambda: jax.enable_x64(True))
    return ej


@pytest.mark.parametrize("name", ["baseline", "shared_l3"])
def test_run_batch_equals_engine_jax(engine_jax, cnn_prefix, name):
    """One preset per shape bucket (the prefetching buckets are in
    test_torch_engine_ml.py): every export counter equal."""
    (want_oi, want_od), = engine_jax.run_batch([ref_presets.PRESETS[name]],
                                               cnn_prefix)
    (oi, od), = engine_torch.run_batch([presets.PRESETS[name]], cnn_prefix,
                                       device="cpu")
    np.testing.assert_array_equal(oi, want_oi)
    np.testing.assert_array_equal(od, want_od)
    assert engine_torch.last_run_stats["tag_probe_main_path_probes"] > 0
    assert engine_torch.last_run_stats["sim_step_launches"] == 0


def test_batch_equals_single_mixed_buckets(cnn_prefix):
    """Lanes of different shape buckets and scalar knobs in one batch
    come back in input order, each equal to its single-lane run."""
    sps = [presets.BASELINE, presets.SHARED_L3,
           dataclasses.replace(presets.BASELINE, name="b19",
                               l2=dataclasses.replace(presets.BASELINE.l2,
                                                      hit_latency=19))]
    batch = engine_torch.run_batch(sps, cnn_prefix, device="cpu")
    assert len(batch) == len(sps)
    for sp, (oi, od) in zip(sps, batch):
        oi1, od1 = engine_torch.run_single(sp, cnn_prefix, device="cpu")
        np.testing.assert_array_equal(oi, oi1)
        np.testing.assert_array_equal(od, od1)
    assert not np.array_equal(batch[0][1], batch[2][1])


def test_lanes_on_different_traces_in_one_run():
    """run_cells mixes traces (the paper table's 12 cells): each lane
    equals its own single run."""
    trs = [_prefix(trace.WORKLOADS[wl](scale=0.012), 300)
           for wl in ("rnn", "transformer")]
    cells = [(presets.PREFETCH, trs[0]), (presets.SHARED_L3, trs[1])]
    outs = engine_torch.run_cells(cells, device="cpu")
    for (sp, tr), (oi, od) in zip(cells, outs):
        oi1, od1 = engine_torch.run_single(sp, tr, device="cpu")
        np.testing.assert_array_equal(oi, oi1)
        np.testing.assert_array_equal(od, od1)


def test_trace_windows_continue_from_state(cnn_prefix):
    """A lane whose columns are a window of its trace runs that window
    from the state it holds (how the card is checked on the last
    accesses of paper-scale traces): head then tail equals one run."""
    from repro_torch.kernels.sim_step import sim_step
    want_oi, want_od = engine_torch.run_single(presets.PREFETCH, cnn_prefix,
                                               device="cpu")
    lane, = engine_torch.build_lanes([(presets.PREFETCH, cnn_prefix)],
                                     torch.device("cpu"))
    for window in (slice(0, 450), slice(450, None)):
        sim_step([dataclasses.replace(
            lane, xs={k: v[window] for k, v in lane.xs.items()})])
    oi, od, flags, _ = engine_torch.export(lane.S, lane.st)
    assert flags == 0
    np.testing.assert_array_equal(oi, want_oi)
    np.testing.assert_array_equal(od, want_od)


def test_table_overflow_raises(monkeypatch, cnn_prefix):
    """A markov table with no free slot overflows on the first insert:
    the run raises instead of diverging."""
    init_state = engine_torch.init_state

    def full_markov_table(S, prep, device):
        st = init_state(S, prep, device)
        st["mk1"].fill_(1 << 40)          # occupied by a foreign key
        return st

    monkeypatch.setattr(engine_torch, "init_state", full_markov_table)
    with pytest.raises(engine_torch.TorchEngineOverflow,
                       match="markov table"):
        engine_torch.run_single(presets.PREFETCH, cnn_prefix, device="cpu")


def test_default_device_without_cuda_raises(cnn_prefix):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(engine_torch.TorchEngineError, match="no CUDA device"):
        engine_torch.run_single(presets.BASELINE, cnn_prefix)


def test_unsupported_config_raises(cnn_prefix):
    sp = dataclasses.replace(presets.BASELINE, n_cores=8)
    with pytest.raises(engine_torch.TorchEngineUnsupported):
        engine_torch.run_single(sp, cnn_prefix, device="cpu")
