"""Sample compaction for network evaluation (counterpart of
laenerf_tpu/ops/compaction.py).

`packed_sample_indices` packs the valid samples of an [N, S] grid in
row-major (ray, slot) order, at most m_cap of them; samples past the
capacity are dropped, which truncates a per-ray suffix. The train path
keeps its samples packed and composites them so; the inference rounds
evaluate the packed samples and `scatter_back` the results to [N, S] at
`sample_destinations`, one cumulative sum of the valid mask. The JAX package
builds the same indices and destinations without scatters (TPU scatters
are slow); here `nonzero` does it.
"""

import torch

from ..utils.timers import count


def packed_sample_indices(valid, m_cap: int):
    """The flat (ray, slot) indices [M] of the first M = min(n_valid,
    m_cap) valid samples of valid [N, S] (or [N * S]) in row-major order.
    Ray r's samples are a run of it, the first clamp(m_cap - start_r, 0,
    n_r) of its n_r. One host wait (`nonzero`'s size), counted in
    sync.compact_nonzero."""
    count("sync.compact_nonzero")
    return torch.nonzero(valid.reshape(-1)).squeeze(1)[:m_cap]


def sample_destinations(valid, m_cap: int):
    """Each slot's row [N, S] int64 in the packed buffer of
    packed_sample_indices(valid, m_cap): a valid sample's rank among the
    valid samples (one cumulative sum), m_cap for invalid and dropped
    samples."""
    rank = torch.cumsum(valid.reshape(-1).to(torch.int64), dim=0) - 1
    keep = valid.reshape(-1) & (rank < m_cap)
    return torch.where(keep, rank, m_cap).reshape(valid.shape)


def scatter_back(vals, dest, shape, fill=0.0):
    """Scatter compacted values [M, ...] back to a padded [N, S, ...] grid.

    dest [N, S]: each slot's row of vals (sample_destinations); entries
    >= M read `fill`.
    """
    N, S = shape
    m = vals.shape[0]
    trailing = vals.shape[1:]
    # dumpster row absorbs dropped and invalid slots (dest >= m)
    padded = torch.cat(
        [vals, torch.full((1,) + trailing, fill, dtype=vals.dtype,
                          device=vals.device)], dim=0)
    out = padded[torch.clamp(dest.reshape(-1), max=m)]
    return out.reshape((N, S) + trailing)
