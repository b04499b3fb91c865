"""Port's tag-probe kernel: its plain version against the Pallas kernel
(interpret mode) and the sequential oracle, exact.  The CUDA kernel is
held against the plain version in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.tag_probe import tag_probe as pallas_tag_probe  # noqa: E402
from repro_torch.kernels.tag_probe import (tag_probe,  # noqa: E402
                                           tag_probe_plain)


def _random_sets(seed, B, A):
    """Set snapshots with duplicate tags, invalid ways and tied stamps."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 7, (B, A), dtype=np.int32),
            (rng.random((B, A)) < 0.7).astype(np.int32),
            rng.integers(0, 4, (B, A), dtype=np.int32),
            rng.integers(0, 1 << 20, (B, A), dtype=np.int32),
            rng.integers(0, 7, B, dtype=np.int32))


@pytest.mark.parametrize("B,A", [(7, 8), (256, 16), (1000, 4)])
def test_plain_matches_pallas_kernel_and_oracle(B, A):
    arrays = _random_sets(B * 31 + A, B, A)
    want_kernel = np.asarray(
        pallas_tag_probe(*map(jnp.asarray, arrays), interpret=True))
    want_oracle = np.asarray(ref.tag_probe_ref(*map(jnp.asarray, arrays)))
    got = tag_probe(*map(torch.from_numpy, arrays))   # CPU → plain
    assert got.shape == (B, 3) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(got.numpy(), want_oracle)


@pytest.mark.parametrize("row,want", [(0, [1, 2, 0]), (1, [0, 1, 1]),
                                      (2, [0, 0, 0])])
def test_tie_breaks(row, want):
    """All-tied stamps: the victim is the first lowest-sequence way; a
    hit wins over eviction; an empty set fills its first free way."""
    tags = torch.tensor([[5, 6, 7, 8], [5, 6, 7, 8], [0, 0, 0, 0]])
    valid = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0]])
    last = torch.zeros((3, 4), dtype=torch.float64)
    seq = torch.tensor([[9, 3, 3, 7], [9, 3, 3, 7], [0, 0, 0, 0]])
    query = torch.tensor([7, 4, 4])
    out = tag_probe(tags, valid, last, seq, query)
    assert out[row].tolist() == want


def test_masked_last_selects_within_bucket():
    """The step masks ``last`` to +inf outside the lowest-utility bucket:
    the victim is the stalest way among the finite stamps."""
    tags = torch.tensor([[1, 2, 3, 4]])
    valid = torch.ones((1, 4), dtype=torch.bool)
    last = torch.tensor([[0.0, float("inf"), 5.0, float("inf")]])
    seq = torch.tensor([[3, 0, 1, 2]])
    out = tag_probe_plain(tags, valid, last, seq, torch.tensor([9]))
    assert out[0].tolist() == [0, 0, 1]
