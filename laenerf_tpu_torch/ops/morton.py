"""Morton (Z-order) encoding and occupancy-bitfield packing (counterpart of
laenerf_tpu/ops/morton.py; the reference's raymarching.cu:57-82 morton3D
and its inverse, :268-300 packbits).

The JAX package computes in uint32. torch's uint32 has only partial
bitwise support, so the codes are computed in int64 with every product and
shift masked to 32 bits: each value stays below 2^32 and each constant
below 2^17, so no product leaves int64, and the results equal the uint32
ones. The marching path indexes the unpacked uint8 occupancy grid
directly; morton order and the packed bitfield serve the reference's
storage layout and compact serialisation of grids.
"""

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of v so there are 2 zeros between each bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords):
    """Interleave 3D integer coords (each < 1024) into morton codes.

    Args:
      coords: [..., 3] integer grid coordinates (int32 values; negative
        ones wrap as the uint32 cast does).
    Returns:
      [...] int64 morton codes, the values of the JAX package's uint32.
    """
    c = coords.to(torch.int64) & _U32
    xx = _expand_bits(c[..., 0])
    yy = _expand_bits(c[..., 1])
    zz = _expand_bits(c[..., 2])
    return (xx | (yy << 1) | (zz << 2)) & _U32


def _compact_bits(x):
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(codes):
    """Invert morton codes (integer values of uint32 codes) back to
    [..., 3] int32 coordinates."""
    c = codes.to(torch.int64) & _U32
    return torch.stack([_compact_bits(c), _compact_bits(c >> 1),
                        _compact_bits(c >> 2)], dim=-1).to(torch.int32)


def _shifts(device):
    return torch.arange(8, dtype=torch.uint8, device=device)


def packbits(grid, thresh):
    """Pack a density grid into a bitfield, 8 cells per byte: bit i of byte
    b is set when grid[..., b*8 + i] > thresh.

    Args:
      grid: [..., N] float density values, N divisible by 8.
      thresh: scalar threshold.
    Returns:
      [..., N // 8] uint8 bitfield.
    """
    occ = (grid > thresh).to(torch.uint8)
    occ = occ.reshape(grid.shape[:-1] + (grid.shape[-1] // 8, 8))
    return torch.sum(occ << _shifts(grid.device), dim=-1).to(torch.uint8)


def unpackbits(bitfield):
    """Inverse of packbits: [..., N//8] uint8 -> [..., N] uint8 in {0,1}."""
    bits = (bitfield[..., None] >> _shifts(bitfield.device)) & 1
    return bits.reshape(bitfield.shape[:-1] + (bitfield.shape[-1] * 8,))
