"""Sequential person merge (kernel ``csrc/merge.cu``).

Counterpart of the JAX package's ``ops/pallas_merge.py`` and of its XLA
twin ``decode/device.py::_merge_loop_xla``. Per image, a loop over the
``n_valid`` pre-compacted connections: each extends, merges or opens a
row of a ``[cap, 20]`` person table (cols 0-17 flat peak ids, col 18 the
score sum, col 19 the part count). The wrapper calls the custom op
``ekpose::merge_people`` (the twin on the CPU, the kernel on CUDA), whose
fake gives the shapes alone: the twin's host read of ``n_valid.max()``
stays out of an exported graph.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torch_ekpose_tpu_torch.ops import _build

__all__ = ["MAX_CAP", "check_cap", "merge_people", "merge_people_torch",
           "smem_bytes"]

_N_PARTS = 18
#: connections ``ekp_merge_people`` stages in shared memory at a time
#: (``kChunk`` in ``csrc/merge.cu``)
CHUNK = 1024


def smem_bytes(cap: int) -> int:
    """Dynamic shared memory of one ``ekp_merge_people`` block: eight
    staged words per connection of a chunk, and the column-major
    ``[20, cap | 1]`` float32 table (an odd column length)."""
    return 4 * (8 * CHUNK + 20 * (cap | 1))


#: largest person table whose block fits the opt-in shared memory (2495
#: rows on Hopper)
MAX_CAP = max(c for c in range(1, 4096)
              if smem_bytes(c) <= _build.SMEM_OPTIN)


def check_cap(cap: int) -> None:
    """Raise unless the CUDA kernel takes a table of ``cap`` rows."""
    if not 0 < cap <= MAX_CAP:
        raise ValueError(
            f"merge_people: cap = {cap} needs {smem_bytes(cap)} bytes of "
            f"shared memory; the CUDA kernel takes 1 <= cap <= {MAX_CAP} "
            f"({_build.SMEM_OPTIN} bytes)")


def merge_people_torch(
    pair, p1, p2, cid1, cid2, score, n_valid, peak_score, cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin, lock-step over the batch like the vmapped XLA
    loop. Connection arrays are [B, n_slots]; returns (subset [B, cap, 20]
    f32, active [B, cap] bool). Reads ``n_valid.max()`` on the host."""
    b, n_slots = pair.shape
    dev = pair.device
    subset = torch.full((b, cap, 20), -1.0, dtype=torch.float32, device=dev)
    active = torch.zeros((b, cap), dtype=torch.bool, device=dev)
    n_rows = torch.zeros(b, dtype=torch.int64, device=dev)
    bi = torch.arange(b, device=dev)
    rows = torch.arange(cap, device=dev)
    cols = torch.arange(20, device=dev)
    steps = min(int(n_valid.max()), n_slots) if b else 0
    for s in range(steps):
        live = s < n_valid
        pr, a, bb = pair[:, s], p1[:, s].long(), p2[:, s].long()
        c1 = cid1[:, s].float()
        c2 = cid2[:, s].float()
        sc = score[:, s]
        sc1 = peak_score[bi, cid1[:, s].long().clamp(min=0)]
        sc2 = peak_score[bi, cid2[:, s].long().clamp(min=0)]

        vals1 = subset[bi[:, None], rows[None, :], a[:, None]]   # [B, cap]
        vals2 = subset[bi[:, None], rows[None, :], bb[:, None]]
        match = active & ((vals1 == c1[:, None]) | (vals2 == c2[:, None]))
        found = match.sum(1)
        cum = match.cumsum(1)
        # lowest matching rows (argmax returns the first maximum)
        m1 = (match & (cum == 1)).to(torch.uint8).argmax(1)
        m2 = (match & (cum == 2)).to(torch.uint8).argmax(1)
        row1, row2 = subset[bi, m1], subset[bi, m2]               # [B, 20]

        col1 = cols[None, :] == a[:, None]
        col2 = cols[None, :] == bb[:, None]
        # set_p2: row[p2] = cid2; score += peak2 + conn; count += 1
        p2row = torch.where(col2, c2[:, None], row1)
        p2row[:, 18] = row1[:, 18] + (sc2 + sc)
        p2row[:, 19] = row1[:, 19] + 1.0
        changed = row1[bi, bb] != c2
        p2row_guarded = torch.where(changed[:, None], p2row, row1)

        overlap = ((row1[:, :_N_PARTS] > 0) & (row2[:, :_N_PARTS] > 0)).any(1)
        merged = torch.empty_like(row1)
        merged[:, :_N_PARTS] = row1[:, :_N_PARTS] + (row2[:, :_N_PARTS] + 1.0)
        merged[:, 18] = row1[:, 18] + (row2[:, 18] + sc)
        merged[:, 19] = row1[:, 19] + row2[:, 19]
        f2row = torch.where(overlap[:, None], p2row, merged)

        is_f1 = live & (found == 1)
        is_f2 = live & (found == 2)
        can_new = live & (found == 0) & (pr < _N_PARTS) & (n_rows < cap)
        fresh = torch.where(col1, c1[:, None], torch.full_like(row1, -1.0))
        fresh = torch.where(col2, c2[:, None], fresh)
        fresh[:, 18] = (sc1 + sc2) + sc
        fresh[:, 19] = 2.0
        slot = n_rows.clamp(max=cap - 1)

        row1_final = torch.where(
            is_f1[:, None], p2row_guarded,
            torch.where(is_f2[:, None], f2row, row1),
        )
        write1 = (rows[None, :] == m1[:, None]) & (is_f1 | is_f2)[:, None]
        subset = torch.where(write1[..., None], row1_final[:, None], subset)
        write_new = (rows[None, :] == slot[:, None]) & can_new[:, None]
        subset = torch.where(write_new[..., None], fresh[:, None], subset)
        deact2 = (rows[None, :] == m2[:, None]) & (is_f2 & ~overlap)[:, None]
        active = (active & ~deact2) | write_new
        n_rows = n_rows + can_new.long()
    return subset, active


def merge_people(
    pair, p1, p2, cid1, cid2, score, n_valid, peak_score, cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Person merge for a batch, one image per block on the card.

    ``pair``/``p1``/``p2``/``cid1``/``cid2`` int32 and ``score`` float32
    are [B, n_slots], compacted valid-first; ``n_valid`` int32 [B] bounds
    each image's loop; ``peak_score`` float32 [B, 18*K]. Returns
    (subset [B, cap, 20] f32, active [B, cap] bool).

    Calls the custom op ``ekpose::merge_people``: a CPU tensor takes the
    twin; a CUDA tensor launches ``ekp_merge_people`` (cap <=
    :data:`MAX_CAP`).
    """
    if pair.device.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_people: unsupported device {pair.device}")
    return torch.ops.ekpose.merge_people(
        pair, p1, p2, cid1, cid2, score, n_valid, peak_score, int(cap))


@torch.library.custom_op("ekpose::merge_people", mutates_args=(),
                         device_types="cpu")
def _merge_op(pair: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
              cid1: torch.Tensor, cid2: torch.Tensor, score: torch.Tensor,
              n_valid: torch.Tensor, peak_score: torch.Tensor,
              cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return merge_people_torch(
        pair, p1, p2, cid1, cid2, score, n_valid, peak_score, cap)


@_merge_op.register_fake
def _merge_fake(pair, p1, p2, cid1, cid2, score, n_valid, peak_score, cap):
    b = pair.shape[0]
    return (pair.new_empty((b, cap, 20), dtype=torch.float32),
            pair.new_empty((b, cap), dtype=torch.bool))


@_merge_op.register_kernel("cuda")
def _merge_cuda(pair, p1, p2, cid1, cid2, score, n_valid, peak_score,
                cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b, n_slots = pair.shape
    ints = [t.contiguous() for t in (pair, p1, p2, cid1, cid2)]
    score, n_valid, peak_score = (
        score.contiguous(), n_valid.contiguous(), peak_score.contiguous()
    )
    for t in (*ints, score, n_valid, peak_score):
        if t.device != pair.device:
            raise ValueError("merge_people: inputs on different devices")
    if (any(t.dtype != torch.int32 or t.shape != (b, n_slots) for t in ints)
            or score.dtype != torch.float32 or score.shape != (b, n_slots)
            or n_valid.dtype != torch.int32 or n_valid.shape != (b,)
            or peak_score.dtype != torch.float32 or peak_score.dim() != 2
            or peak_score.shape[0] != b):
        raise ValueError(
            "merge_people: expected int32 [B, n] connections, float32 "
            "[B, n] scores, int32 [B] n_valid and float32 [B, m] peak "
            "scores"
        )
    check_cap(cap)
    subset = torch.empty((b, cap, 20), dtype=torch.float32, device=pair.device)
    active = torch.empty((b, cap), dtype=torch.bool, device=pair.device)
    with torch.cuda.device(pair.device):
        err = _build.lib().ekp_merge_people(
            *(_build.ptr(t) for t in ints), _build.ptr(score),
            _build.ptr(n_valid), _build.ptr(peak_score), _build.ptr(subset),
            _build.ptr(active), b, n_slots, peak_score.shape[1], cap,
            _build.stream_of(pair),
        )
    _build.check(err, "ekp_merge_people")
    merge_people.launches += 1
    return subset, active


#: launches of the CUDA kernel since the count was last set to 0
merge_people.launches = 0
