"""Sample compaction for network evaluation (counterpart of
laenerf_tpu/ops/compaction.py).

compact -> evaluate the MLP on the valid samples -> scatter_back to [N, S].
Samples are packed in row-major (ray, slot) order into a buffer of capacity
m_cap; samples past the capacity are dropped, which truncates a per-ray
suffix. The JAX package builds the inverse map without scatters (TPU
scatters are slow); here `nonzero` does it, with the same destinations.
"""

import torch


def compact_samples(valid, m_cap: int):
    """Gather/scatter indexing for compaction.

    Args:
      valid: [N, S] bool.
      m_cap: capacity of the compacted buffer.
    Returns:
      gather_idx: [m_cap] int64 flat indices into [N*S] (0 past the valid
        rows, masked by gather_mask).
      gather_mask: [m_cap] bool, True where the row holds a real sample.
      dest: [N, S] int64 row of each sample in the compacted buffer (m_cap
        for dropped and invalid samples).
    """
    flat = valid.reshape(-1)
    pos = torch.cumsum(flat.to(torch.int64), dim=0) - 1
    keep = flat & (pos < m_cap)
    dest = torch.where(keep, pos, m_cap).reshape(valid.shape)
    src = torch.nonzero(flat).squeeze(1)[:m_cap]
    gather_idx = torch.zeros((m_cap,), dtype=torch.int64, device=valid.device)
    gather_idx[:src.shape[0]] = src
    gather_mask = (torch.arange(m_cap, device=valid.device)
                   < src.shape[0])
    return gather_idx, gather_mask, dest


def gather_flat(x, gather_idx):
    """Gather rows of a flattened [N*S, ...] array into [M, ...]."""
    return x[gather_idx]


def _scatter_back_impl(vals, dest, shape, fill):
    N, S = shape
    m = vals.shape[0]
    trailing = vals.shape[1:]
    # dumpster row absorbs dropped and invalid slots (dest >= m)
    padded = torch.cat(
        [vals, torch.full((1,) + trailing, fill, dtype=vals.dtype,
                          device=vals.device)], dim=0)
    out = padded[torch.clamp(dest.reshape(-1), max=m)]
    return out.reshape((N, S) + trailing)


class _ScatterBackBij(torch.autograd.Function):
    """scatter_back whose vals-gradient is one gather at gather_idx: dest is
    injective on real samples, so autograd's [N*S]-row index_add is not
    needed."""

    @staticmethod
    def forward(ctx, vals, dest, gather_idx, gather_mask, shape, fill):
        ctx.save_for_backward(gather_idx, gather_mask)
        return _scatter_back_impl(vals, dest, shape, fill)

    @staticmethod
    def backward(ctx, g):
        gather_idx, gather_mask = ctx.saved_tensors
        trailing = g.shape[2:]
        gv = g.reshape((-1,) + trailing)[gather_idx]
        mask = gather_mask.reshape((-1,) + (1,) * len(trailing))
        return torch.where(mask, gv, 0.0), None, None, None, None, None


def scatter_back(vals, dest, shape, fill=0.0, gather_idx=None,
                 gather_mask=None):
    """Scatter compacted values [M, ...] back to a padded [N, S, ...] grid.

    dest comes from compact_samples; entries >= M read `fill`. When the
    matching gather_idx/gather_mask (first M rows) are given, the gradient
    to vals is a gather instead of a scatter-add.
    """
    if gather_idx is not None and gather_mask is not None:
        return _ScatterBackBij.apply(vals, dest, gather_idx, gather_mask,
                                     tuple(shape), fill)
    return _scatter_back_impl(vals, dest, tuple(shape), fill)
