"""Plain PyTorch building blocks of the references: the multi-resolution
hash grid (octo layout), the bias-free MLP, real spherical harmonics,
Adam, and the rounding that a configuration states.

Nothing here imports the program. The grid's index arithmetic and the SH
constants are frozen copies of the published Instant-NGP encoding as the
program lays it out (`laenerf_tpu_torch/ops/hashgrid.py`, `ops/sh.py`);
the gather, interpolation and backward are written out plainly, and the
table gradient is summed with `index_add_` in float64.

`Rounding` says where a computation is rounded and to what: "bf16" is what
the configurations state (table rows and MLP inputs, weights and outputs
rounded to bfloat16, products summed in float32, each backward row of the
table rounded to bfloat16), "fp8" the control (the same points rounded to
float8 e4m3 with a per-tensor scale, the precision a later change would
be tempted to take).
"""

import dataclasses
import math

import torch
import torch.nn.functional as F

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
FP8_MAX = 448.0


def no_tf32():
    """float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(x, precision: str):
    """x rounded to `precision` and returned as float32."""
    if precision == "f32":
        return x.float()
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        amax = x.detach().abs().amax().float()
        scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
        return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"unknown precision {precision!r}")


class _Round(torch.autograd.Function):
    """Rounds the forward value; passes the gradient rounded the same way
    (a bf16 tensor's gradient is bf16)."""

    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return round_to(x, precision)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.precision), None


def rnd(x, precision):
    return _Round.apply(x, precision)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The 3-D hash grid: num_levels levels of level_dim channels from
    base_resolution to desired_resolution, at most 2^log2_hashmap_size
    rows a level."""

    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: float = 2048.0

    @property
    def per_level_scale(self):
        return math.exp2(math.log2(self.desired_resolution
                                   / self.base_resolution)
                         / (self.num_levels - 1))

    @property
    def level_scales(self):
        s = math.log2(self.per_level_scale)
        return tuple(math.exp2(l * s) * self.base_resolution - 1.0
                     for l in range(self.num_levels))

    @property
    def level_resolutions(self):
        return tuple(int(math.ceil(sc)) + 1 for sc in self.level_scales)

    @property
    def level_sizes(self):
        max_params = 2 ** self.log2_hashmap_size
        out = []
        for l in range(self.num_levels):
            res = int(math.ceil(self.base_resolution
                                * self.per_level_scale ** l))
            n = min(max_params, (res + 1) ** 3)
            out.append(int(math.ceil(n / 8) * 8))
        return tuple(out)

    @property
    def level_offsets(self):
        offs, o = [], 0
        for s in self.level_sizes:
            offs.append(o)
            o += s
        return tuple(offs)

    @property
    def table_rows(self):
        return sum(self.level_sizes)

    @property
    def output_dim(self):
        return self.num_levels * self.level_dim


def grid_spec(cfg) -> GridSpec:
    """The grid a configuration's keys describe."""
    return GridSpec(cfg["num_levels"], cfg["level_dim"],
                    cfg["base_resolution"], cfg["log2_hashmap_size"],
                    cfg["desired_resolution"])


def _strides(spec: GridSpec, level):
    res = spec.level_resolutions[level]
    size = spec.level_sizes[level]
    base = res + 1
    if base ** 3 <= size:
        return base, base * base
    return int(_PRIMES[1] % size) | 1, int(_PRIMES[2] % size) | 1


def grid_corners(spec: GridSpec, u):
    """Table rows [B, L, 8] (int64) of the 8 cell corners at each level and
    their trilinear weights [B, L, 8], for positions u [B, 3] in [0, 1]."""
    dev = u.device
    L = spec.num_levels
    idx, w = [], []
    bits = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                        dtype=torch.int64, device=dev)
    for l in range(L):
        pos = u * spec.level_scales[l] + 0.5
        cell = torch.floor(pos)
        frac = pos - cell
        c = cell.to(torch.int32).to(torch.int64) & _U32
        sy, sz = _strides(spec, l)
        size = spec.level_sizes[l]
        base = (c[:, 0] + ((c[:, 1] * sy) & _U32)
                + ((c[:, 2] * sz) & _U32)) & _U32
        offs = torch.tensor([((k & 1) + sy * ((k >> 1) & 1)
                              + sz * ((k >> 2) & 1)) % size
                             for k in range(8)], dtype=torch.int64, device=dev)
        idx.append((base[:, None] % size + offs[None]) % size
                   + spec.level_offsets[l])
        f = torch.where(bits[None].bool(), frac[:, None, :],
                        1.0 - frac[:, None, :])
        w.append(f[..., 0] * f[..., 1] * f[..., 2])
    return torch.stack(idx, 1), torch.stack(w, 1)


class _GridGather(torch.autograd.Function):
    """out[b, l] = sum_c w[b, l, c] * round(table)[idx[b, l, c]]; the
    table's gradient adds round(w * g) into each corner row, summed in
    float64."""

    @staticmethod
    def forward(ctx, table, idx, w, precision):
        B, L, K = idx.shape
        C = table.shape[1]
        rows = round_to(table.detach(), precision)[idx.reshape(-1)]
        ctx.save_for_backward(idx, w)
        ctx.precision = precision
        ctx.shape = table.shape
        return torch.sum(w[..., None] * rows.reshape(B, L, K, C), dim=2)

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        C = g.shape[-1]
        rows = round_to(w[..., None] * g[:, :, None, :].float(),
                        ctx.precision)
        grad = torch.zeros(ctx.shape, dtype=torch.float64, device=g.device)
        grad.index_add_(0, idx.reshape(-1), rows.reshape(-1, C).double())
        return grad.float(), None, None, None


def grid_encode(table, x, spec: GridSpec, bound: float, precision: str):
    """Features [B, L * C] of positions x [B, 3] in [-bound, bound]; 0 for a
    position outside it."""
    u = (x.float() + bound) / (2.0 * bound)
    keep = ~torch.any((u < 0.0) | (u > 1.0), dim=-1)
    idx, w = grid_corners(spec, u)
    w = torch.where(keep[:, None, None], w, 0.0)
    out = _GridGather.apply(table, idx, w, precision)
    return out.reshape(x.shape[0], -1)


def mlp(weights, x, precision: str):
    """Bias-free MLP, ReLU between layers: inputs, weights and each layer's
    output rounded to `precision`, products summed in float32."""
    h = rnd(x, precision)
    for i, wt in enumerate(weights):
        h = rnd(F.linear(h, rnd(wt, precision)), precision)
        if i != len(weights) - 1:
            h = torch.relu(h)
    return h


def sh_encode(d, degree: int):
    """Real SH basis (instant-ngp convention) of unit directions, degree
    3 or 4: [B, degree**2]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814),
           -0.48860251190291987 * y, 0.48860251190291987 * z,
           -0.48860251190291987 * x,
           1.0925484305920792 * xy, -1.0925484305920792 * yz,
           0.94617469575755997 * z2 - 0.31539156525251999,
           -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2)]
    if degree >= 4:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    if degree not in (3, 4):
        raise ValueError("the references carry SH degrees 3 and 4")
    return torch.stack(out, dim=-1)


class Adam:
    """Adam as Kingma and Ba state it, with bias correction; `lr` may
    differ per parameter."""

    def __init__(self, params, lrs, betas, eps):
        self.params = params
        self.lrs = lrs
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr_scale=1.0):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v, lr in zip(self.params, grads, self.m, self.v,
                                  self.lrs):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(m, denom, value=-lr * lr_scale / c1)
