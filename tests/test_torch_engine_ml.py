"""The port's engine against the JAX engine on the prefetching shape
buckets (stride + ML prefetch, hybrid memory, tensor-aware L3), whose
XLA compile dominates: one bucket per test, a file of their own so the
two compiles run on separate workers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import presets as ref_presets  # noqa: E402
from repro.core import trace as ref_trace  # noqa: E402
from repro_torch.core import engine_torch  # noqa: E402
from repro_torch.core import presets  # noqa: E402

N = 700


@pytest.fixture(scope="module")
def rnn_prefix():
    tr = ref_trace.WORKLOADS["rnn"](scale=0.012)
    sub = dict(tr)
    for k in ("core", "pc", "addr", "write", "tensor", "reuse"):
        sub[k] = tr[k][:N]
    return sub


@pytest.mark.parametrize("name", ["prefetch", "tensor_aware"])
def test_run_batch_equals_engine_jax(monkeypatch, rnn_prefix, name):
    """Every export counter equal to the JAX engine's (its single-lane
    program: the same step, a third less XLA compile than the vmapped
    one)."""
    from repro.core import engine_jax
    monkeypatch.setattr(engine_jax, "_x64", lambda: jax.enable_x64(True))
    want_oi, want_od = engine_jax.run_single(ref_presets.PRESETS[name],
                                             rnn_prefix)
    (oi, od), = engine_torch.run_batch([presets.PRESETS[name]], rnn_prefix,
                                       device="cpu")
    np.testing.assert_array_equal(oi, want_oi)
    np.testing.assert_array_equal(od, want_od)
    assert oi[74:79].sum() > 0            # the stride prefetcher issued
