"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one; the
file imports neither jax nor the reference package, so it runs on the
GPU machine as ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine_torch, presets, trace  # noqa: E402
from repro_torch.kernels.sim_step import sim_step  # noqa: E402
from repro_torch.kernels.tag_probe import tag_probe, tag_probe_plain  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _probe_rows(B, A, seed, device):
    rng = np.random.default_rng(seed)
    valid = rng.random((B, A)) < 0.85
    valid[: B // 3] = True
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        rng.integers(0, 6, (B, A)), valid,
        rng.integers(0, 4, (B, A)).astype(np.float64),
        rng.integers(0, 5, (B, A)), rng.integers(0, 6, B))]


@pytest.mark.parametrize("B,A", [(4099, 8), (4099, 16), (33, 32), (7, 3)])
def test_tag_probe_kernel_equals_plain(cuda, B, A):
    args = _probe_rows(B, A, B + A, cuda)
    launches = tag_probe.launches
    got = tag_probe(*args)
    assert tag_probe.launches == launches + 1
    assert torch.equal(got, tag_probe_plain(*args))


def test_tag_probe_kernel_refuses_what_it_does_not_take(cuda):
    args = _probe_rows(16, 8, 0, cuda)
    args[0] = args[0].to(torch.int32)
    with pytest.raises(ValueError, match="tag_probe kernel takes"):
        tag_probe(*args)


def test_step_kernel_equals_plain_step(cuda):
    tr = trace.WORKLOADS["transformer"](scale=0.012)
    for k in ("core", "pc", "addr", "write", "tensor", "reuse"):
        tr[k] = tr[k][:600]
    cells = [(sp, tr) for sp in presets.CONFIGS]
    launches = sim_step.launches
    got = engine_torch.run_cells(cells, device="cuda")
    assert sim_step.launches == launches + 1
    probes = engine_torch.last_run_stats["tag_probe_main_path_probes"]
    want = engine_torch.run_cells(cells, device="cpu")
    assert probes == engine_torch.last_run_stats["tag_probe_main_path_probes"]
    for (oi, od), (oi2, od2) in zip(got, want):
        np.testing.assert_array_equal(oi, oi2)
        np.testing.assert_array_equal(od, od2)
