"""Tag-store probe: tag compare + LRU victim select per set.

Port of the Pallas kernel ``_tag_probe_kernel``
(``repro/kernels/tag_probe.py``).  For each of B set rows of A ways:
``hit`` is set when a valid way holds the query tag and ``way`` is then
the first such way; otherwise ``way`` is the LRU victim when the set is
full (lowest ``last``, ties by lowest ``seq``, then lowest index) or the
first free way; ``evict`` = no hit and the set is full.

On the card ``tag_probe`` launches ``csrc/tag_probe.cu``, whose probe
routine (``csrc/tag_probe.cuh``) is the same one every cache probe and
insert of the step kernel calls.  On CPU tensors it runs
``tag_probe_plain``, the torch formulation of the Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch


def tag_probe_plain(tags: torch.Tensor, valid: torch.Tensor,
                    last: torch.Tensor, seq: torch.Tensor,
                    query: torch.Tensor) -> torch.Tensor:
    """(B, A) tags/valid/last/seq and (B,) query → (B, 3) int32."""
    A = tags.shape[1]
    vld = valid != 0
    m = vld & (tags == query[:, None])
    hit = m.any(dim=1)
    hitw = m.to(torch.int8).argmax(dim=1)
    freew = (~vld).to(torch.int8).argmax(dim=1)
    full = vld.sum(dim=1) >= A
    stale = last == last.min(dim=1, keepdim=True).values
    big = torch.iinfo(torch.int64).max
    vicw = torch.where(stale, seq.to(torch.int64),
                       torch.full_like(seq, big, dtype=torch.int64)
                       ).argmin(dim=1)
    way = torch.where(hit, hitw, torch.where(full, vicw, freew))
    evict = ~hit & full
    return torch.stack([hit.to(torch.int32), way.to(torch.int32),
                        evict.to(torch.int32)], dim=1)


def tag_probe(tags: torch.Tensor, valid: torch.Tensor, last: torch.Tensor,
              seq: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Probe B sets of A ways: ``[hit, way, evict]`` per row, (B, 3) int32.

    CUDA inputs: tags/seq/query int64, valid bool, last float64, all
    contiguous, A <= 32.  CPU inputs take the plain version.
    """
    if tags.device.type == "cpu":
        return tag_probe_plain(tags, valid, last, seq, query)
    from repro_torch.kernels import _lib
    B, A = tags.shape
    want = ((tags, torch.int64, (B, A)), (valid, torch.bool, (B, A)),
            (last, torch.float64, (B, A)), (seq, torch.int64, (B, A)),
            (query, torch.int64, (B,)))
    for t, dtype, shape in want:
        if (t.device != tags.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"tag_probe kernel takes contiguous {dtype} {shape} on "
                f"{tags.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if not 1 <= A <= 32:
        raise ValueError(f"tag_probe kernel takes 1..32 ways, got {A}")
    out = torch.empty((B, 3), dtype=torch.int32, device=tags.device)
    if B == 0:
        return out
    lib = _lib.load("tag_probe")
    err = lib.tag_probe_launch(
        tags.data_ptr(), valid.data_ptr(), last.data_ptr(), seq.data_ptr(),
        query.data_ptr(), out.data_ptr(), ctypes.c_int64(B), A,
        torch.cuda.current_stream(tags.device).cuda_stream)
    _lib.check(err, "tag_probe")
    tag_probe.launches += 1
    return out


tag_probe.launches = 0
