"""Multi-resolution hash grid encoding, octo layout (counterpart of
laenerf_tpu/ops/hashgrid.py).

`HashGridSpec` is copied verbatim from the JAX package so level scales,
resolutions and table sizes agree to the last bit. The encode follows the
JAX package's octo path (`_encode_octo`): every level indexes its cell's base
corner as idx = (x + sy*y + sz*z) mod size with uint32 wrap-around, and the
8 corners sit at (idx + offset_c) mod size, offset_c in corner order
c = dx + 2*dy + 4*dz. Hashed levels use large odd strides (a linear lattice
hash), dense levels their exact strides.

The 8 corner rows are gathered straight from the [T, C] table, which is
rounded to bf16 first when `gather_dtype == "bf16"`; interpolation runs in
f32. The backward forms one row w_c * grad_out per (sample, level, corner),
rounds it to bf16 and adds it into the [T, C] f32 table gradient with the
scatter-add kernel K1 (ops/scatter_add.py) — in one pass what the JAX package
does as a scatter into its [size, 8C] view plus a fold.

The generic xor-hash path (`_corner_indices`, used by the 2-D background
grid and the TV loss) is not ported yet.
"""

import dataclasses
import math
from typing import Tuple

import torch

from .scatter_add import scatter_add_rows

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of a multi-resolution grid encoder."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    gridtype: str = "hash"  # "hash" | "tiled"
    align_corners: bool = False
    interpolation: str = "linear"  # "linear" | "smoothstep"
    # all 8 cell corners addressed from one base row by the additive layout;
    # the only layout the port implements
    octo_gather: bool = True
    # dtype the table is rounded to before the gather; interpolation is f32
    gather_dtype: str = "f32"  # "f32" | "bf16"

    @staticmethod
    def create(desired_resolution=None, **kwargs) -> "HashGridSpec":
        """Build a spec, optionally deriving per_level_scale from the desired
        finest resolution."""
        spec = HashGridSpec(**kwargs)
        if desired_resolution is not None:
            s = math.exp2(
                math.log2(desired_resolution / spec.base_resolution)
                / (spec.num_levels - 1)
            )
            spec = dataclasses.replace(spec, per_level_scale=s)
        return spec

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def level_scales(self) -> Tuple[float, ...]:
        s = math.log2(self.per_level_scale)
        return tuple(
            math.exp2(l * s) * self.base_resolution - 1.0
            for l in range(self.num_levels)
        )

    @property
    def level_resolutions(self) -> Tuple[int, ...]:
        return tuple(int(math.ceil(sc)) + 1 for sc in self.level_scales)

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        """Number of table rows per level (padded to a multiple of 8)."""
        max_params = 2 ** self.log2_hashmap_size
        sizes = []
        for l in range(self.num_levels):
            res = int(math.ceil(self.base_resolution * self.per_level_scale ** l))
            n = min(max_params, (res if self.align_corners else res + 1) ** self.input_dim)
            sizes.append(int(math.ceil(n / 8) * 8))
        return tuple(sizes)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        offs, o = [], 0
        for s in self.level_sizes:
            offs.append(o)
            o += s
        return tuple(offs)

    @property
    def table_rows(self) -> int:
        return sum(self.level_sizes)


def hashgrid_init(spec: HashGridSpec, *, device, generator=None):
    """Embedding table U(-1e-4, 1e-4), [table_rows, level_dim] f32."""
    t = torch.empty((spec.table_rows, spec.level_dim), dtype=torch.float32,
                    device=device)
    return t.uniform_(-1e-4, 1e-4, generator=generator)


def _octo_strides(spec: HashGridSpec, level: int):
    """Per-level (sy, sz) row strides of the additive octo layout: dense
    levels keep x-major strides (1, base, base^2); hashed levels use large
    odd strides mod the power-of-two level size."""
    D = spec.input_dim
    res = spec.level_resolutions[level]
    size = spec.level_sizes[level]
    stride_base = res if spec.align_corners else res + 1
    if stride_base ** D <= size or spec.gridtype != "hash":
        return stride_base, stride_base * stride_base
    if size & (size - 1):
        raise ValueError("the octo layout needs power-of-two hashed level "
                         "sizes")
    return int(_PRIMES[1] % size) | 1, int(_PRIMES[2] % size) | 1


def _octo_corner_offsets(spec: HashGridSpec, level: int):
    """Row offsets of the 8 cell corners relative to the (0,0,0) corner,
    in corner order c = dx + 2*dy + 4*dz."""
    sy, sz = _octo_strides(spec, level)
    size = spec.level_sizes[level]
    return [((c & 1) + sy * ((c >> 1) & 1) + sz * ((c >> 2) & 1)) % size
            for c in range(8)]


def _octo_base_indices(spec: HashGridSpec, pos_grid):
    """LOCAL row of each level's (0,0,0) corner, [B, L] int64.

    pos_grid: [B, L, 3] floored float grid coordinates. Emulates the JAX
    package's int32 -> uint32 cast and uint32 wrap-around with int64 masked
    to 32 bits: each coordinate is < 2^32 and each stride < 2^31, so every
    product fits in int64 before the mask.
    """
    dev = pos_grid.device
    L = spec.num_levels
    strides = torch.tensor([_octo_strides(spec, l) for l in range(L)],
                           dtype=torch.int64, device=dev)  # [L, 2]
    sizes = torch.tensor(spec.level_sizes, dtype=torch.int64, device=dev)
    c = pos_grid.to(torch.int32).to(torch.int64) & _U32  # [B, L, 3]
    idx = (c[..., 0]
           + ((c[..., 1] * strides[:, 0]) & _U32)
           + ((c[..., 2] * strides[:, 1]) & _U32)) & _U32
    return idx % sizes


def _octo_corners(spec: HashGridSpec, u):
    """Global corner rows [B, L, 8] int32 and trilinear weights [B, L, 8]
    f32 for normalized positions u [B, 3]."""
    dev = u.device
    L = spec.num_levels
    scales = torch.tensor(spec.level_scales, dtype=torch.float32, device=dev)
    pos = (u[:, None, :] * scales[None, :, None]
           + (0.0 if spec.align_corners else 0.5))  # [B, L, 3]
    pos_grid = torch.floor(pos)
    frac = pos - pos_grid
    if spec.interpolation == "smoothstep":
        frac = frac * frac * (3.0 - 2.0 * frac)

    base = _octo_base_indices(spec, pos_grid)  # [B, L]
    offs = torch.tensor([_octo_corner_offsets(spec, l) for l in range(L)],
                        dtype=torch.int64, device=dev)  # [L, 8]
    sizes = torch.tensor(spec.level_sizes, dtype=torch.int64, device=dev)
    level_off = torch.tensor(spec.level_offsets, dtype=torch.int64,
                             device=dev)
    idx = ((base[:, :, None] + offs[None]) % sizes[None, :, None]
           + level_off[None, :, None]).to(torch.int32)  # [B, L, 8]

    # w[c] = prod_d (frac_d if bit d of c else 1 - frac_d)
    f01 = torch.stack([1.0 - frac, frac], dim=-1)  # [B, L, 3, 2]
    bits = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                        dtype=torch.int64, device=dev)  # [8, 3]
    w = (f01[:, :, 0, bits[:, 0]] * f01[:, :, 1, bits[:, 1]]
         * f01[:, :, 2, bits[:, 2]])  # [B, L, 8]
    return idx, w


class _HashGridGather(torch.autograd.Function):
    """Gather + interpolate with the K1 scatter-add backward.

    forward(table, gather_table, idx, w, keep) -> [B, L, C]; only `table`
    receives a gradient. `gather_table` is the table as gathered (bf16 when
    gather_dtype is "bf16").
    """

    @staticmethod
    def forward(ctx, table, gather_table, idx, w, keep):
        B, L, _ = idx.shape
        C = gather_table.shape[1]
        vals = gather_table[idx.reshape(-1).long()].to(torch.float32)
        out = torch.sum(w[..., None] * vals.reshape(B, L, 8, C), dim=2)
        out = torch.where(keep[:, None, None], out, 0.0)
        ctx.save_for_backward(idx, w, keep)
        ctx.table_rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad_out):
        idx, w, keep = ctx.saved_tensors
        g = torch.where(keep[:, None, None], grad_out.to(torch.float32), 0.0)
        C = g.shape[-1]
        rows = (w[..., None] * g[:, :, None, :]).to(torch.bfloat16)
        grad = scatter_add_rows(idx.reshape(-1), rows.reshape(-1, C),
                                ctx.table_rows, precision="bf16")
        return grad, None, None, None, None


def hashgrid_encode(table, x, spec: HashGridSpec, bound: float = 1.0,
                    gather_table=None):
    """Encode positions with the multi-resolution grid.

    Args:
      table: [table_rows, level_dim] f32 embedding table.
      x: [..., 3] positions in [-bound, bound]; outside it they encode to 0.
        No gradient flows to x (the train path marches without gradients).
      spec: grid configuration (octo layout, 3-D).
      bound: half side length of the domain.
      gather_table: optional table already rounded to spec.gather_dtype, so
        per-chunk render calls skip the rounding (Trainer.render_image
        rounds once per frame).
    Returns:
      [..., num_levels * level_dim] f32 features.
    """
    if not spec.octo_gather or spec.input_dim != 3:
        raise NotImplementedError(
            "only the 3-D octo layout is ported; the generic xor-hash path "
            "is not")
    if x.requires_grad:
        raise NotImplementedError(
            "hashgrid_encode: gradients with respect to x are not ported")
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    prefix = x.shape[:-1]
    u = (x.reshape(-1, D).to(torch.float32) + bound) / (2.0 * bound)
    keep = ~torch.any((u < 0.0) | (u > 1.0), dim=-1)
    idx, w = _octo_corners(spec, u)
    if gather_table is None:
        gather_table = (table.detach().to(torch.bfloat16)
                        if spec.gather_dtype == "bf16" else table.detach())
    out = _HashGridGather.apply(table, gather_table, idx, w, keep)
    return out.reshape(prefix + (L * C,))
