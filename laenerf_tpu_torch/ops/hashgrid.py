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

The generic path (`_corner_indices`, the JAX package's get_grid_index
rule: a dense strided index while the stride fits the level, the xor-
multiply `_fast_hash` on hashed levels that overflow it, modulo the level
size) serves every other spec: the 2-D background grid, 3-D grids without
the octo layout and the TV loss. It gathers the 2^D corner rows of each
(sample, level) from the table (rounded to bf16 when `gather_dtype ==
"bf16"`) and its backward adds the rows w_c * grad_out, a 1-D idx of
B * L * 2^D rows as the JAX package's `_gather_rows` passes it, with K1.
"""

import dataclasses
import math
from typing import Tuple

import torch

from ..utils.timers import count
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


def _mul_u32(c, k: int):
    """(c * k) mod 2^32 for int64 c in [0, 2^32) and a constant k < 2^32,
    in 16-bit halves of k so no product leaves int64."""
    lo, hi = k & 0xFFFF, k >> 16
    return (c * lo + (((c * hi) & 0xFFFF) << 16)) & _U32


def _fast_hash(c):
    """XOR-multiply hash over the last axis of uint32 coordinates (int64
    [..., D] in [0, 2^32)) -> int64 [...] in [0, 2^32)."""
    out = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for d in range(c.shape[-1]):
        out = out ^ _mul_u32(c[..., d], _PRIMES[d])
    return out


def _corner_indices(spec: HashGridSpec, level: int, c):
    """Global table rows of integer corner coordinates c (int64 [..., D],
    the int32 -> uint32 cast already applied) at one level: the dense
    strided index while the running stride fits the level, fast_hash on
    hashed levels that overflow it, modulo the level size."""
    D = spec.input_dim
    res = spec.level_resolutions[level]
    size = spec.level_sizes[level]
    stride_base = res if spec.align_corners else res + 1
    index = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    stride, overflowed = 1, False
    for d in range(D):
        if stride <= size:
            index = (index + _mul_u32(c[..., d], stride)) & _U32
        stride *= stride_base
        overflowed = overflowed or stride > size
    if spec.gridtype == "hash" and overflowed:
        index = _fast_hash(c)
    return index % size + spec.level_offsets[level]


def _as_u32(c):
    """int32 coordinates -> the JAX package's int32 -> uint32 cast, as
    int64 values in [0, 2^32)."""
    return c.to(torch.int64) & _U32


def _generic_corners(spec: HashGridSpec, u):
    """Corner rows [B, L * 2^D] int32 and weights [B, L * 2^D] f32 of
    normalized positions u [B, D], level-major, corner bit d the offset
    along dimension d."""
    D, L = spec.input_dim, spec.num_levels
    n = 1 << D
    count("sync.hashgrid_consts")
    bits = torch.tensor([[(k >> d) & 1 for d in range(D)] for k in range(n)],
                        dtype=torch.int64, device=u.device)  # [2^D, D]
    idx, w = [], []
    for level in range(L):
        pos = u * spec.level_scales[level] + (0.0 if spec.align_corners
                                              else 0.5)
        pos_grid = torch.floor(pos)
        frac = pos - pos_grid
        if spec.interpolation == "smoothstep":
            frac = frac * frac * (3.0 - 2.0 * frac)
        cc = (pos_grid.to(torch.int32)[:, None, :]
              + bits[None].to(torch.int32))  # [B, 2^D, D] int32
        idx.append(_corner_indices(spec, level, _as_u32(cc)))
        f = torch.where(bits[None].bool(), frac[:, None, :],
                        1.0 - frac[:, None, :])  # [B, 2^D, D]
        wl = f[..., 0]
        for d in range(1, D):
            wl = wl * f[..., d]
        w.append(wl)
    return (torch.cat(idx, dim=1).to(torch.int32), torch.cat(w, dim=1))


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
    count("sync.hashgrid_consts", 2)  # strides and sizes below
    strides = torch.tensor([_octo_strides(spec, l) for l in range(L)],
                           dtype=torch.int64, device=dev)  # [L, 2]
    sizes = torch.tensor(spec.level_sizes, dtype=torch.int64, device=dev)
    c = _as_u32(pos_grid.to(torch.int32))  # [B, L, 3]
    idx = (c[..., 0]
           + ((c[..., 1] * strides[:, 0]) & _U32)
           + ((c[..., 2] * strides[:, 1]) & _U32)) & _U32
    return idx % sizes


def _octo_corners(spec: HashGridSpec, u):
    """Global corner rows [B, L, 8] int32 and trilinear weights [B, L, 8]
    f32 for normalized positions u [B, 3]."""
    dev = u.device
    L = spec.num_levels
    # scales, offs, sizes, level_off and bits below
    count("sync.hashgrid_consts", 5)
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

    forward(table, gather_table, idx, w, keep, layout) -> [B, L, C]; idx
    and w are [B, L, K] (K corners of each level's cell). `gather_table` is
    the table as gathered (bf16 when gather_dtype is "bf16"). layout
    "octo": the backward passes K1 the corner rows as [samples, L * K] and
    rounds them to bf16; "generic": as one 1-D idx [B * L * K], rounded to
    bf16 only with a bf16 gather.

    `table` and `w` receive gradients. w's is the sum over channels of
    grad_out times the gathered rows (as gathered, in f32), zero where keep
    is false, as JAX differentiates the interpolation; only when w needs
    it is gather_table kept and gathered again in the backward, so the
    train path (no gradient to x) keeps and gathers nothing more.
    """

    @staticmethod
    def forward(ctx, table, gather_table, idx, w, keep, layout):
        B, L, K = idx.shape
        C = gather_table.shape[1]
        vals = gather_table[idx.reshape(-1).long()].to(torch.float32)
        out = torch.sum(w[..., None] * vals.reshape(B, L, K, C), dim=2)
        out = torch.where(keep[:, None, None], out, 0.0)
        ctx.save_for_backward(idx, w, keep, *(
            (gather_table,) if ctx.needs_input_grad[3] else ()))
        ctx.table_rows = table.shape[0]
        ctx.layout = layout
        ctx.precision = ("bf16" if layout == "octo"
                         or gather_table.dtype == torch.bfloat16 else "f32")
        return out

    @staticmethod
    def backward(ctx, grad_out):
        idx, w, keep, *gather_table = ctx.saved_tensors
        g = torch.where(keep[:, None, None], grad_out.to(torch.float32), 0.0)
        C = g.shape[-1]
        B, L, K = idx.shape
        grad_w = None
        if ctx.needs_input_grad[3]:
            vals = gather_table[0][idx.reshape(-1).long()].to(torch.float32)
            grad_w = torch.sum(g[:, :, None, :] * vals.reshape(B, L, K, C),
                               dim=-1)
        if not ctx.needs_input_grad[0]:
            return None, None, None, grad_w, None, None
        rows = w[..., None] * g[:, :, None, :]
        if ctx.precision == "bf16":
            rows = rows.to(torch.bfloat16)
        if ctx.layout == "octo":
            # [samples, levels x corners]: consecutive samples of a ray
            # often share a coarse level's corner row, and K1 sums such
            # runs first
            idx, rows = idx.reshape(B, L * K), rows.reshape(B, L * K, C)
        else:
            idx, rows = idx.reshape(-1), rows.reshape(-1, C)
        grad = scatter_add_rows(idx, rows, ctx.table_rows,
                                precision=ctx.precision)
        return grad, None, None, grad_w, None, None


def hashgrid_encode(table, x, spec: HashGridSpec, bound: float = 1.0,
                    gather_table=None):
    """Encode positions with the multi-resolution grid.

    Args:
      table: [table_rows, level_dim] f32 embedding table.
      x: [..., input_dim] positions in [-bound, bound]; outside it they
        encode to 0. With x.requires_grad the gradient flows to x through
        the interpolation weights (floor's is zero, as in JAX), and is 0
        outside the bound.
      spec: grid configuration (the octo layout for a 3-D octo spec, the
        generic one otherwise).
      bound: half side length of the domain.
      gather_table: optional table already rounded to spec.gather_dtype, so
        per-chunk render calls skip the rounding (Trainer.render_image
        rounds once per frame).
    Returns:
      [..., num_levels * level_dim] f32 features.
    """
    D, L, C = spec.input_dim, spec.num_levels, spec.level_dim
    prefix = x.shape[:-1]
    u = (x.reshape(-1, D).to(torch.float32) + bound) / (2.0 * bound)
    keep = ~torch.any((u < 0.0) | (u > 1.0), dim=-1)
    if spec.octo_gather and D == 3:
        layout = "octo"
        idx, w = _octo_corners(spec, u)
    else:
        layout = "generic"
        idx, w = _generic_corners(spec, u)
        idx, w = idx.reshape(-1, L, 1 << D), w.reshape(-1, L, 1 << D)
    if gather_table is None:
        gather_table = (table.detach().to(torch.bfloat16)
                        if spec.gather_dtype == "bf16" else table.detach())
    out = _HashGridGather.apply(table, gather_table, idx, w, keep, layout)
    return out.reshape(prefix + (L * C,))


def hashgrid_tv_loss(table, spec: HashGridSpec, inputs=None, *,
                     n_points: int = 65536, bound: float = 1.0,
                     generator=None):
    """Total-variation regulariser on the grid: for each point and level,
    the squared difference between the anchor corner's row and each +1
    neighbour's, summed over channels, averaged over points, summed over
    dimensions and averaged over levels. The points are `inputs` [..., D]
    in [-bound, bound], else n_points uniform ones drawn from `generator`.
    Differentiable in table (a plain row gather)."""
    D = spec.input_dim
    if inputs is None:
        u = torch.rand((n_points, D), generator=generator,
                       device=table.device)
    else:
        u = (inputs.reshape(-1, D).to(torch.float32) + bound) / (2.0 * bound)
    loss = 0.0
    for level in range(spec.num_levels):
        pos = u * spec.level_scales[level] + (0.0 if spec.align_corners
                                              else 0.5)
        anchor = torch.floor(pos).to(torch.int32)
        v0 = table[_corner_indices(spec, level, _as_u32(anchor))]
        for d in range(D):
            nb = anchor.clone()
            nb[:, d] += 1
            v1 = table[_corner_indices(spec, level, _as_u32(nb))]
            loss = loss + torch.mean(torch.sum((v0 - v1) ** 2, dim=-1))
    return loss / spec.num_levels
