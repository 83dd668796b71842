"""Tests of the port's CUDA kernels against their plain PyTorch versions, on
the card. They skip without an NVIDIA GPU: a CUDA kernel has no CPU mode.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: the scatter-adds (K1, K5, K6) at relative 1e-5 of the max (f32
atomics sum in another order on every run); the gathers and the construct
probes (K7) exactly (they move values, count, or sum terms that add
exactly); the march (K8) bit for bit on its valid slots (it rounds each
operation as the plain loop's separate kernels do); the packed composite
(K9) against its plain version on the card at 1e-5 of the largest output,
and its sigma gradients at 1e-5 of the terms they are the difference of
(a warp scan and the suffix form round otherwise than cumsum and autograd);
the distill render on the card against the CPU at 2e-3 absolute
(bf16 network, as the port against JAX).
"""

import numpy as np
import pytest
import torch

import _composite_cases
import _march_cases
import _worklist_cases
from laenerf_tpu_torch.ops import composite
from laenerf_tpu_torch.ops import construct_probes as cp
from laenerf_tpu_torch.ops.gather import (grid_probe, grid_probe_plain,
                                          take_lanes, take_lanes_plain,
                                          take_rows, take_rows_plain)
from laenerf_tpu_torch.ops import raymarch
from laenerf_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode
from laenerf_tpu_torch.ops.scatter_add import (RUN_SPAN, scatter_add_rows,
                                               scatter_add_rows_plain)
from laenerf_tpu_torch.ops.sorted_scatter import (build_worklist, sort_stage,
                                                  tile_scatter,
                                                  tile_scatter_plain,
                                                  work_sizes,
                                                  worklist_scatter,
                                                  worklist_scatter_plain)
from laenerf_tpu_torch.perf import bisect_mosaic

REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _rel_err(got, ref):
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-12)).item()


def _uniform(seed, Q, T, C):
    rng = np.random.RandomState(seed)
    return rng.randint(0, T, Q).astype(np.int32), rng.randn(Q, C), T


CASES = {
    "uniform": lambda: _uniform(0, 10000, 5000, 8),
    "all_one_row": lambda: (np.full(8192, 17, np.int32), np.ones((8192, 4)),
                            4096),
    "clustered": lambda: ((5000 + np.random.RandomState(1).randint(
        0, 300, 20000)).astype(np.int32),
        np.random.RandomState(2).randn(20000, 8), 40000),
    "block_straddle": lambda: (np.concatenate(
        [np.full(2047, 2047), np.full(2049, 2048),
         np.full(2048, 4095)]).astype(np.int32), np.ones((6144, 2)), 6144),
    "tiny_table": lambda: _uniform(2, 3000, 100, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_add_kernel_matches_plain(cuda, case, precision):
    idx, g, T = CASES[case]()
    i = torch.from_numpy(idx).to(cuda)
    gg = torch.tensor(g, dtype=torch.float32, device=cuda)
    before = scatter_add_rows.launches
    got = scatter_add_rows(i, gg, T, precision=precision)
    ref = scatter_add_rows_plain(i, gg, T, precision=precision)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    assert _rel_err(got, ref) < REL_TOL


@pytest.mark.cuda
def test_scatter_add_kernel_edges(cuda):
    empty = scatter_add_rows(torch.zeros(0, dtype=torch.int32, device=cuda),
                             torch.zeros((0, 4), device=cuda), 100)
    assert empty.shape == (100, 4) and not empty.any()
    idx = torch.tensor([0, 5, -1, 7, 3], dtype=torch.int32, device=cuda)
    g = torch.ones((5, 2), device=cuda)
    got = scatter_add_rows(idx, g, 6, precision="f32")
    assert got.sum().item() == 6.0  # rows -1 and 7 are dropped
    with pytest.raises(TypeError):
        scatter_add_rows(idx.long(), g, 6)
    with pytest.raises(ValueError):
        scatter_add_rows(idx, g.t(), 6)  # shape [2, 5]


def _k1_layout(rng, layout, C, dtype, dev):
    """(idx, g) on the card for one layout: "1d" Q rows, Q off the 32-row
    split; "2d" [S, P] with runs of one row down each column, S off the
    span and P off 32 columns; "2d_view" the same as contiguous views 4
    bytes into their storage (g's rows then off 16 bytes)."""
    S, P, T = 3 * RUN_SPAN + 5, 40, 700
    idx = np.repeat(rng.randint(-3, T + 3, (S // 4 + 1, P)), 4, axis=0)[:S]
    idx[rng.rand(S, P) < 0.2] = rng.randint(0, T)  # runs cut short
    g = rng.randn(S, P, C)
    if layout == "1d":
        idx, g = idx.reshape(-1)[:-13], g.reshape(-1, C)[:-13]
    if layout != "2d_view":
        return (torch.from_numpy(idx.astype(np.int32)).to(dev),
                torch.tensor(g, dtype=dtype, device=dev), T)
    k = 4 // torch.tensor([], dtype=dtype).element_size()
    flat_i = torch.zeros(idx.size + 1, dtype=torch.int32, device=dev)
    flat_i[1:] = torch.from_numpy(idx.astype(np.int32).reshape(-1))
    flat_g = torch.zeros(g.size + k, dtype=dtype, device=dev)
    flat_g[k:] = torch.tensor(g.reshape(-1), dtype=dtype)
    return flat_i[1:].view(S, P), flat_g[k:].view(S, P, C), T


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["1d", "2d", "2d_view"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8, 12])
def test_scatter_add_kernel_widths_and_layouts(cuda, C, dtype, layout):
    """K1's float4 / float2 / scalar REDs (C 1-12, views whose rows leave
    16 bytes) and its run merge down the columns of a 2-D idx, with
    out-of-range rows inside runs, against the plain version."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    idx, g, T = _k1_layout(np.random.RandomState(C), layout, C, tdt, cuda)
    assert idx.is_contiguous() and g.is_contiguous()
    for precision in ("f32", "bf16"):
        before = scatter_add_rows.launches
        got = scatter_add_rows(idx, g, T, precision=precision)
        ref = scatter_add_rows_plain(idx, g, T, precision=precision)
        torch.cuda.synchronize()
        assert scatter_add_rows.launches == before + 1
        assert got.shape == (T, C)
        assert _rel_err(got, ref) < REL_TOL, precision
    before = scatter_add_rows.launches
    for shape in ((0,), (0, 40)):
        empty = scatter_add_rows(
            torch.zeros(shape, dtype=torch.int32, device=cuda),
            torch.zeros(shape + (C,), dtype=tdt, device=cuda), 100)
        assert empty.shape == (100, C) and not empty.any()
    assert scatter_add_rows.launches == before  # Q == 0 launches nothing


@pytest.mark.cuda
def test_hashgrid_backward_on_card_matches_cpu(cuda):
    """The encoder backward through K1 against the same backward on the
    CPU, where the plain scatter-add runs."""
    spec = HashGridSpec(num_levels=4, level_dim=4, log2_hashmap_size=14,
                        gather_dtype="bf16")
    gen = torch.Generator().manual_seed(0)
    table = torch.rand((spec.table_rows, spec.level_dim), generator=gen) - 0.5
    x = torch.rand((2048, 3), generator=gen) * 2.2 - 1.1
    cot = torch.randn((2048, spec.output_dim), generator=gen)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        t = table.to(dev).requires_grad_(True)
        (hashgrid_encode(t, x.to(dev), spec) * cot.to(dev)).sum().backward()
        grads.append(t.grad.cpu())
    assert _rel_err(grads[0], grads[1]) < REL_TOL


@pytest.mark.cuda
def test_scatter_add_kernel_at_the_laenerf_backward_shape(cuda):
    """K1 at the LAENeRF encoder backward's shape: [n, 16 levels x 8
    corners] idx and C = 2 bf16 rows into the 6,119,864-row table of the
    recolor path's 16-level C = 2 lg19 grid (the float2 RED path)."""
    from laenerf_tpu_torch.editing import LAENeRFConfig
    from laenerf_tpu_torch.ops.hashgrid import _octo_corners

    spec = LAENeRFConfig().grid_spec
    assert spec.table_rows == 6119864 and spec.level_dim == 2
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = 4096
    idx, w = _octo_corners(spec, torch.rand((n, 3), generator=gen,
                                            device=cuda))
    grad = torch.randn((n, spec.num_levels, 2), generator=gen, device=cuda)
    rows = (w[..., None] * grad[:, :, None, :]).to(torch.bfloat16)
    idx, rows = idx.reshape(n, -1), rows.reshape(n, -1, 2)
    assert idx.shape == (n, 128)
    before = scatter_add_rows.launches
    got = scatter_add_rows(idx, rows, spec.table_rows)
    ref = scatter_add_rows_plain(idx, rows, spec.table_rows)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    assert _rel_err(got, ref) < REL_TOL


def _blob(H=32, seed=0):
    rng = np.random.RandomState(seed)
    occ = (rng.rand(1, H, H, H) > 0.8).astype(np.uint8)
    occ[:, H // 4:3 * H // 4, H // 4:3 * H // 4, H // 3:2 * H // 3] = 1
    return occ


@pytest.mark.cuda
@pytest.mark.parametrize("grow", [False, True])
def test_render_rays_distill_on_card_matches_cpu(cuda, grow):
    """The distill render on the card (its backward-free forward: the
    march, the bf16 network and the compositing) against the port on the
    CPU, at 2e-3 as the port against JAX."""
    from laenerf_tpu_torch.models import NeRFConfig, RenderConfig, nerf_init
    from laenerf_tpu_torch.models.renderer import render_rays_distill
    from laenerf_tpu_torch.train.trainer import configure_matmul_precision

    configure_matmul_precision()
    cfg = NeRFConfig(num_levels=4, log2_hashmap_size=12)
    rcfg = RenderConfig(grid_size=32, max_steps=128, march_iters=128,
                        infer_chunk_events=8, density_scale=5.0)
    net = nerf_init(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        net.encoder.uniform_(-0.5, 0.5,
                             generator=torch.Generator().manual_seed(5))
    occ = _blob()
    edit = np.zeros_like(occ)
    edit[:, :16] = occ[:, :16]
    rng = np.random.RandomState(6)
    d = rng.uniform(-0.5, 0.5, (512, 3)) - np.array([0.2, -0.3, -2.5])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.array([0.2, -0.3, -2.5]), d.shape)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        out = render_rays_distill(
            net.to(dev), torch.tensor(occ, device=dev),
            torch.tensor(edit, device=dev),
            torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev),
            render_cfg=rcfg, grow_grid=grow)
        outs.append({k: v.cpu() for k, v in out.items()})
    assert float(outs[1]["weights_edit"].max()) > 0.5
    for k in ("image", "depth", "weights", "weights_edit", "x_term"):
        torch.testing.assert_close(outs[0][k], outs[1][k], atol=2e-3,
                                   rtol=0, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("vgg19", (10, 12, 14)),
                                         ("vgg16", (11, 13, 15, 29))])
def test_vgg_features_on_card_match_cpu(cuda, arch, layers):
    """The VGG stacks in f32 on the card (TF32 off) against the CPU: the
    same seeded random filters, features within 1e-4 of the CPU's max."""
    from laenerf_tpu_torch.editing.vgg import vgg_features, vgg_init

    x = torch.tensor(np.random.RandomState(7).randn(1, 3, 64, 80),
                     dtype=torch.float32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        with pytest.warns(UserWarning, match="random filters"):
            params, kinds, _ = vgg_init(arch, device=dev)
        outs.append([f.cpu() for f in vgg_features(params, kinds, x.to(dev),
                                                   layers)])
    assert not torch.backends.cudnn.allow_tf32
    for g, r in zip(*outs):
        assert _rel_err(g, r) < 1e-4


@pytest.mark.cuda
def test_style_step_on_card_matches_cpu(cuda):
    """One LAENeRF step with the Gram term past warm-up on the card (K1 in
    the encoder's backward) against the same step on the CPU: the loss at
    1e-3 relative, the encoder gradient at 1e-2 of its max (bf16 MLPs)."""
    from laenerf_tpu_torch.editing import (LAENeRFConfig, StyleLossWeights,
                                           StyleNetwork, laenerf_init,
                                           laenerf_train_step,
                                           make_style_optimizer)

    cfg = LAENeRFConfig(num_levels=4, log2_hashmap_size=12,
                        num_palette_bases=4)
    rng = np.random.RandomState(8)
    Hs = Ws = 32
    n, n_pad = 300, 1024
    inds = np.full(n_pad, Hs * Ws, np.int32)
    inds[:n] = np.sort(rng.choice(np.array(
        [r * Ws + c for r in range(6, 26) for c in range(8, 28)]), n,
        replace=False))
    valid = np.arange(n_pad) < n
    d = rng.randn(n_pad, 3)
    batch = {"valid": valid, "inds": inds,
             "x_term": rng.uniform(-0.6, 0.6, (n_pad, 3)) * valid[:, None],
             "dirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
             "targets": rng.rand(n_pad, 3) * valid[:, None],
             "tv_h": rng.rand(15, 16), "tv_v": rng.rand(16, 15)}
    style_img = rng.rand(3, 40, 48)
    weights = StyleLossWeights(style_weight=5e4, tv_weight=1e-2,
                               tv_depth_guide=True, warmup_iterations=0)
    state = None
    losses, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        model, active = laenerf_init(cfg, device=dev,
                                     generator=torch.Generator(
                                         device=dev).manual_seed(9))
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        with pytest.warns(UserWarning, match="random filters"):
            sn = StyleNetwork(style_img, size=24, seed=3, device=dev)
        tb = {k: torch.as_tensor(v, device=dev) if k in ("valid", "inds")
              else torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in batch.items()}
        before = scatter_add_rows.launches
        aux = laenerf_train_step(
            model, make_style_optimizer(model), active, tb, weights=weights,
            H=Hs, W=Ws, crop_h=16, crop_w=16, past_warmup=True,
            crop_origin=(6, 8), style_network=sn, gram_targets=sn.targets,
            crop_size=24)
        if dev == cuda:
            assert scatter_add_rows.launches == before + 1
        losses.append(float(aux["loss"]))
        grads.append(model.encoder.grad.cpu())
    assert abs(losses[0] - losses[1]) <= 1e-3 * abs(losses[1]), losses
    assert _rel_err(grads[0], grads[1]) < 1e-2


GATHER_DTYPES = {"f32": torch.float32, "i32": torch.int32, "i8": torch.int8}


def _gather_table(rng, shape, dtype, dev):
    if dtype == torch.float32:
        return torch.tensor(rng.randn(*shape), dtype=dtype, device=dev)
    return torch.tensor(rng.randint(-128, 128, shape), dtype=dtype,
                        device=dev)


def _idx(rng, high, shape, dev):
    return torch.tensor(rng.randint(0, high, shape), dtype=torch.int32,
                        device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 8, 17, 128, 200])
@pytest.mark.parametrize("dtype", sorted(GATHER_DTYPES))
def test_take_rows_kernel_matches_plain(cuda, dtype, W):
    """K2 at widths on and off its 16-byte chunks (W % V != 0: the scalar
    path), with rows also as a contiguous view 4 bytes into its storage
    (the scalar path at any W) and, at W = 128, more query rows than one
    wave of the card holds (each thread walks rows)."""
    rng = np.random.RandomState(W)
    R = 1000
    tbl = _gather_table(rng, (R, W), GATHER_DTYPES[dtype], cuda)
    cases = [(3000, False), (3000, True)] + [(40000, False)] * (W == 128)
    for Q, view in cases:
        rows = _idx(rng, R, (Q * W + view,), cuda)[int(view):].view(Q, W)
        assert rows.storage_offset() == int(view)
        before = take_rows.launches
        got = take_rows(tbl, rows)
        torch.cuda.synchronize()
        assert take_rows.launches == before + 1
        assert torch.equal(got, take_rows_plain(tbl, rows))


def _take_lanes_matches(tbl, idx):
    """One K3 launch, equal to its plain version and to torch.gather."""
    before = take_lanes.launches
    got = take_lanes(tbl, idx)
    torch.cuda.synchronize()
    assert take_lanes.launches == before + 1
    assert got.shape == (tbl.shape[0], idx.shape[1])
    assert torch.equal(got, take_lanes_plain(tbl, idx))
    assert torch.equal(got, torch.gather(
        tbl, 1, idx.long().expand(tbl.shape[0], -1)))


# (R, N, L): N in {1, 15, 16, 17, 777, 16384} by R in {1, 3, 64}, rows
# that start off 16-byte boundaries (N % V != 0) taking the scalar path and
# the rest the 16-byte chunks; then more chunks than one wave of the card
# holds (601 rows of 16,384), so each thread walks several rows
TAKE_LANES_SHAPES = [(R, N, 1500)
                     for N in (1, 15, 16, 17, 777, 16384)
                     for R in (1, 3, 64)] + [(64, 777, 5000),
                                            (601, 16384, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", sorted(GATHER_DTYPES))
def test_take_lanes_kernel_matches_plain(cuda, dtype, broadcast):
    rng = np.random.RandomState(1)
    for R, N, L in TAKE_LANES_SHAPES:
        tbl = _gather_table(rng, (R, L), GATHER_DTYPES[dtype], cuda)
        _take_lanes_matches(tbl, _idx(rng, L, (1 if broadcast else R, N),
                                      cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", sorted(GATHER_DTYPES))
def test_take_lanes_on_offset_views(cuda, dtype, broadcast):
    """K3 on idx and tbl that are contiguous views 4 bytes into their
    storage (idx off a 16-byte boundary: the scalar path), at N = 16, 777
    and 16384."""
    rng = np.random.RandomState(5)
    tdt = GATHER_DTYPES[dtype]
    k = 4 // torch.tensor([], dtype=tdt).element_size()
    for N in (16, 777, 16384):
        R, L = 5, 2000
        tbl = _gather_table(rng, (R * L + k,), tdt, cuda)[k:].view(R, L)
        rows = 1 if broadcast else R
        idx = _idx(rng, L, (rows * N + 1,), cuda)[1:].view(rows, N)
        assert tbl.storage_offset() == k and idx.storage_offset() == 1
        _take_lanes_matches(tbl, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3, 4, 16, 17, 128])
@pytest.mark.parametrize("pair", ["f32_f32", "i32_i32", "i8_i8", "i8_i32"])
def test_grid_probe_kernel_matches_plain(cuda, pair, lanes):
    """K4 at lane counts on and off the output's 16-byte chunks (lanes % V
    != 0: the scalar path), with row and col also as contiguous views 4
    bytes into their storage."""
    din, dout = (GATHER_DTYPES[p] for p in pair.split("_"))
    rng = np.random.RandomState(2)
    grid = _gather_table(rng, (4096, 96), din, cuda)
    for view in (False, True):
        j = int(view)
        row = _idx(rng, 4096, (5000 + j,), cuda)[j:]
        col = _idx(rng, 96, (5000 + j,), cuda)[j:]
        assert row.storage_offset() == col.storage_offset() == j
        before = grid_probe.launches
        got = grid_probe(grid, row, col, lanes=lanes, out_dtype=dout)
        torch.cuda.synchronize()
        assert grid_probe.launches == before + 1
        assert got.shape == (5000, lanes) and got.dtype == dout
        assert torch.equal(got, grid_probe_plain(grid, row, col, lanes, dout))


@pytest.mark.cuda
def test_gather_kernels_reject_what_they_do_not_take(cuda):
    tbl = torch.zeros((16, 8), device=cuda)
    rows = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # int64 index
        take_rows(tbl, rows.long())
    with pytest.raises(TypeError):  # float64 table
        take_rows(tbl.double(), rows)
    with pytest.raises(ValueError):  # non-contiguous table
        take_rows(torch.zeros((8, 16), device=cuda).t(), rows)
    with pytest.raises(ValueError):  # CPU index, CUDA table
        take_rows(tbl, rows.cpu())
    idx = torch.zeros((16, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # non-contiguous index
        take_lanes(tbl, torch.zeros((4, 16), dtype=torch.int32,
                                    device=cuda).t())
    with pytest.raises(ValueError):  # CPU index, CUDA table
        take_lanes(tbl, idx.cpu())
    q = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # CPU col, CUDA grid
        grid_probe(tbl, q, q.cpu())
    with pytest.raises(TypeError):  # an f32 grid cannot be written as int32
        grid_probe(tbl, q, q, out_dtype=torch.int32)
    empty = take_rows(tbl, torch.zeros((0, 8), dtype=torch.int32,
                                       device=cuda))
    assert empty.shape == (0, 8)


def _clustered_with_strays():
    rng = np.random.RandomState(3)
    idx = np.concatenate([5000 + rng.randint(0, 300, 20000),
                          rng.randint(0, 40000, 5000),
                          [-1, -7, 40960, 50000, 1 << 30]]).astype(np.int32)
    return idx, rng.randn(idx.shape[0], 8), 40000


SORTED_CASES = {
    "uniform": lambda: _uniform(4, 100000, 50000, 8),
    "clustered_out_of_range": _clustered_with_strays,
    "all_one_row": lambda: (np.full(8192, 17, np.int32),
                            np.random.RandomState(5).randn(8192, 8), 4096),
    "q0": lambda: (np.zeros(0, np.int32), np.zeros((0, 8)), 4096),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1024, 2048, 8192])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SORTED_CASES))
def test_sorted_scatter_kernels_match_plain(cuda, case, dtype, tile):
    """K5 and K6 on sorted updates and their work list, against their plain
    versions; rows below 0 or past the tiles are dropped. Neither kernel
    keeps a tile in shared memory, so 8,192-row tiles (a [tile, 8] f32 tile
    would be 256 KB) are taken too."""
    idx, g, T = SORTED_CASES[case]()
    rows = torch.tensor(g, dtype=torch.float32, device=cuda).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    sizes = work_sizes(idx.shape[0], T, tile, tile)
    qs, gs, lo = sort_stage(torch.from_numpy(idx).to(cuda), rows, tile,
                            sizes.n_tiles)
    before = tile_scatter.launches, worklist_scatter.launches
    got5 = tile_scatter(qs, gs, lo, tile)
    wt, wb, _, wreal = build_worklist(lo, tile, sizes.w_cap, sizes.q_blks)
    got6 = worklist_scatter(qs, gs, wt, wb, wreal, tile, tile, sizes.n_tiles)
    ref5 = tile_scatter_plain(qs, gs, lo, tile)
    ref6 = worklist_scatter_plain(qs, gs, wt, wb, wreal, tile, tile,
                                  sizes.n_tiles)
    torch.cuda.synchronize()
    # K5 has nothing to launch without updates (its output is the zero-fill)
    assert (tile_scatter.launches, worklist_scatter.launches) == (
        before[0] + (idx.shape[0] > 0), before[1] + 1)
    assert got5.shape == got6.shape == (sizes.t_pad, 8)
    assert torch.equal(ref5, ref6) or _rel_err(ref5, ref6) < REL_TOL
    assert _rel_err(got5, ref5) < REL_TOL
    assert _rel_err(got6, ref6) < REL_TOL
    if case == "q0":
        assert not got5.any() and not got6.any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [None, 1, 2])
def test_construct_probes_match_plain(cuda, seed):
    """K7: all eight constructs on the script's inputs and random ones."""
    for label, _, fn, args in bisect_mosaic.cases(cuda, seed):
        before = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, label
        assert torch.equal(got, cp.PLAIN[fn](*args)), label


def _onehot_case(case):
    """(local int32, g with small integer values, tile): an int case is
    C = case at tile 32, its sums of many columns on one row exact in any
    order; a named case is an edge of the kernel's window bucketing (its
    32-row windows, 1,024-column scan chunks and 64-wide channel chunks)."""
    if isinstance(case, int):
        rng = np.random.RandomState(case)
        local = rng.randint(-4, 40, (3, 64)).astype(np.int32)
        local[1] = 7  # every column of tile 1 on row 7
        return local, rng.randint(-8, 9, (3, 64, case)), 32
    rng = np.random.RandomState(len(case))
    n, maxu, tile, C = {"one_row_c128": (3, 1024, 1024, 128),
                        "empty_windows": (3, 256, 128, 16),
                        "maxu_2048_tile_64": (2, 2048, 64, 8),
                        "c16": (4, 512, 256, 16),
                        "tile_32": (5, 96, 32, 128),
                        "maxu_1552": (3, 1552, 128, 80)}[case]
    local = rng.randint(-8, tile + 8, (n, maxu))
    if case == "one_row_c128":
        local[:] = [[0], [517], [1023]]  # every column of a tile on one row
    if case == "empty_windows":
        # tile 0 leaves windows 0 and 2 empty; tile 1 lies wholly outside
        local[0] = rng.choice(np.r_[32:64, 96:128], maxu)
        local[1] = rng.choice([-1, tile, 5000, -2 ** 31, 2 ** 31 - 1], maxu)
    g = rng.randint(-8, 9, (n, maxu, C))
    return local.astype(np.int32), g, tile


@pytest.mark.cuda
@pytest.mark.parametrize("case", [8, 16, 128, "one_row_c128",
                                  "empty_windows", "maxu_2048_tile_64",
                                  "c16", "tile_32", "maxu_1552"])
def test_onehot_dot_sums_repeated_rows(cuda, case):
    """Many one-hot columns on one row, and columns outside the tile, with
    small integer rows (their sums are exact in any order); whole tiles on
    one row, empty windows, tiles wholly outside, more columns than one scan
    chunk (and not a multiple of it), C = 16 and C = 80 (a narrower last
    channel chunk), tile = 32. Exact, one launch a call."""
    local, g, tile = _onehot_case(case)
    lt = torch.from_numpy(local).to(cuda)
    gt = torch.tensor(g, dtype=torch.bfloat16, device=cuda)
    before = cp.onehot_dot.launches
    got = cp.onehot_dot(lt, gt, tile)
    torch.cuda.synchronize()
    assert cp.onehot_dot.launches == before + 1
    assert torch.equal(got, cp.onehot_dot_plain(lt, gt, tile))


K5_CHUNK = 2048  # updates a K5 block takes (csrc/sorted_scatter.cu kChunk)


def _k5_rows(case, rng):
    """(rows [Q] int32, unsorted, T, tile, C) of a K5 edge case."""
    if case == "heavy_tile":
        # 100,000 updates on 3 rows of tile 7: its slab spans ~50 blocks
        heavy = 7 * 1024 + rng.choice([0, 500, 1023], 100000)
        return np.concatenate([heavy, rng.randint(0, 200000, 60000)]), \
            200000, 1024, 8
    if case.startswith("chunk"):
        # a run boundary at exactly K5_CHUNK + o, and a run of 700 updates
        # across the second block boundary
        o = {"chunk-1": -1, "chunk": 0, "chunk+1": 1}[case]
        head = np.repeat(np.arange(K5_CHUNK), 3)[:K5_CHUNK + o]
        mid = np.full(2 * K5_CHUNK - 350 - head.shape[0], 9000)
        return np.concatenate([head, mid, np.full(700, 9001),
                               9002 + rng.randint(0, 3000, 2000)]), \
            12288, 1024, 8
    C = int(case[1:])  # "c<C>": many short runs and some long ones
    rows = np.concatenate([rng.randint(0, 30000, 20000),
                           np.repeat(rng.randint(0, 30000, 8), 300)])
    return rows, 30000, 512, C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["heavy_tile", "chunk-1", "chunk",
                                  "chunk+1", "c1", "c3", "c8", "c16", "c56"])
def test_tile_scatter_matches_plain(cuda, case, dtype):
    """K5 on a heavy tile whose slab spans many blocks, run boundaries at
    exactly one block's end and a run across the next, and C = 1, 3 (no
    16-byte loads), 8, 16 and 56 (several channel groups); one launch a
    call."""
    rng = np.random.RandomState(len(case))
    rows, T, tile, C = _k5_rows(case, rng)
    g = torch.tensor(rng.randn(rows.shape[0], C), dtype=torch.float32,
                     device=cuda).to(torch.float32 if dtype == "f32"
                                     else torch.bfloat16)
    n_tiles = -(-T // tile)
    qs, gs, lo = sort_stage(torch.from_numpy(rows.astype(np.int32)).to(cuda),
                            g, tile, n_tiles)
    before = tile_scatter.launches
    got = tile_scatter(qs, gs, lo, tile)
    torch.cuda.synchronize()
    assert tile_scatter.launches == before + 1
    assert got.shape == (n_tiles * tile, C)
    assert _rel_err(got, tile_scatter_plain(qs, gs, lo, tile)) < REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_tile_scatter_on_misaligned_views(cuda, offset, dtype):
    """Contiguous views whose rows start `offset` elements into their
    storage, so 16-byte loads are ruled out (narrower ones where the offset
    allows); also qs and lo views."""
    rng = np.random.RandomState(offset)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    rows = np.sort(np.concatenate([rng.randint(0, 20000, 30000),
                                   np.full(900, 4321)])).astype(np.int32)
    Q, C, tile = rows.shape[0], 8, 1024
    flat = torch.tensor(rng.randn(Q * C + offset), dtype=torch.float32,
                        device=cuda).to(tdt)
    gs = flat[offset:].view(Q, C)
    qs = torch.from_numpy(np.concatenate([[0], rows]).astype(np.int32)).to(
        cuda)[1:]
    lo = sort_stage(qs, gs, tile, 20)[2]
    lo = torch.cat([lo[:1], lo])[1:]
    assert gs.is_contiguous() and gs.storage_offset() == offset
    before = tile_scatter.launches
    got = tile_scatter(qs, gs, lo, tile)
    torch.cuda.synchronize()
    assert tile_scatter.launches == before + 1
    assert _rel_err(got, tile_scatter_plain(qs, gs, lo, tile)) < REL_TOL


@pytest.mark.cuda
def test_tile_scatter_drops_rows_outside_their_tile(cuda):
    """The CPU case of tests/test_torch_sorted_scatter.py on the card: a
    hand-made lo puts row 40 in tile 0's slab, where it is dropped, as are
    rows below 0 and past the table; Q = 0 launches nothing."""
    qs = torch.tensor([-3, 0, 5, 40, 63, 64, 90], dtype=torch.int32,
                      device=cuda)
    g = torch.arange(14, dtype=torch.float32, device=cuda).reshape(7, 2)
    lo = torch.tensor([1, 4, 5], dtype=torch.int32, device=cuda)
    ref = torch.zeros((64, 2), device=cuda)
    ref[0], ref[5], ref[63] = g[1], g[2], g[4]
    before = tile_scatter.launches
    got = tile_scatter(qs, g, lo, 32)
    torch.cuda.synchronize()
    assert tile_scatter.launches == before + 1
    assert torch.equal(got, ref)
    assert torch.equal(tile_scatter_plain(qs, g, lo, 32), ref)
    empty = tile_scatter(qs[:0], g[:0], torch.zeros(3, dtype=torch.int32,
                                                    device=cuda), 32)
    torch.cuda.synchronize()
    assert tile_scatter.launches == before + 1
    assert empty.shape == (64, 2) and not empty.any()


def _tensors(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _worklist_matches_plain(qs, gs, wt, wb, wreal, tile, maxu, n_tiles):
    before = worklist_scatter.launches
    got = worklist_scatter(qs, gs, wt, wb, wreal, tile, maxu, n_tiles)
    ref = worklist_scatter_plain(qs, gs, wt, wb, wreal, tile, maxu, n_tiles)
    torch.cuda.synchronize()
    assert worklist_scatter.launches == before + 1
    assert got.shape == (n_tiles * tile, gs.shape[1])
    assert ref.abs().max() > 0
    assert _rel_err(got, ref) < REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_worklist_cases.WORKLIST_CASES))
def test_worklist_scatter_on_hand_made_lists(cuda, case, dtype):
    """K6 on the hand-made work lists of tests/_worklist_cases.py (a
    duplicated item adds twice, unsorted qs, a block past Q, items with
    wreal == 0 or wt outside the tiles, a slab over three blocks, one row
    over whole blocks), at 300-update blocks, against its plain version."""
    qs, g, wt, wb, wreal, tile, maxu, n_tiles = \
        _worklist_cases.worklist_case(case)
    qs, wt, wb, wreal = _tensors(cuda, qs, wt, wb, wreal)
    gs = torch.tensor(g, dtype=torch.float32, device=cuda).to(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    _worklist_matches_plain(qs, gs, wt, wb, wreal, tile, maxu, n_tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["offset1", "offset2", "offset4", "c3",
                                    "c12", "c20"])
def test_worklist_scatter_on_views_and_widths(cuda, layout, dtype):
    """K6 on contiguous views whose rows start 1, 2 or 4 elements into
    their storage (narrower loads, or none 16 bytes wide), and at C = 3, 12
    and 20 (several channel groups, a partial last one), with a duplicated
    item in the list."""
    rng = np.random.RandomState(len(layout))
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    offset = int(layout[6:]) if layout.startswith("offset") else 0
    C = 8 if offset else int(layout[1:])
    rows = np.sort(np.concatenate([rng.randint(0, 20000, 30000),
                                   np.full(900, 4321)])).astype(np.int32)
    Q, tile, maxu = rows.shape[0], 1024, 1024
    flat = torch.tensor(rng.randn(Q * C + offset), dtype=torch.float32,
                        device=cuda).to(tdt)
    gs = flat[offset:].view(Q, C)
    assert gs.is_contiguous() and gs.storage_offset() == offset
    qs = torch.from_numpy(rows).to(cuda)
    sizes = work_sizes(Q, 20000, tile, maxu)
    lo = sort_stage(qs, gs, tile, sizes.n_tiles)[2]
    wt, wb, _, wreal = build_worklist(lo, maxu, sizes.w_cap, sizes.q_blks)
    wt, wb, wreal = (torch.cat([a, a[4:5]]) for a in (wt, wb, wreal))
    _worklist_matches_plain(qs, gs, wt, wb, wreal, tile, maxu, sizes.n_tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,C,n_tiles", [(100, 4, 5), (300, 12, 3),
                                            (1000, 8, 1), (1, 4, 7)])
def test_row_copies_match_plain(cuda, tile, C, n_tiles):
    """K7 k2 and k3, which copy a tile in 2 KB slices, one block each: tiles
    of 1,600 B (one short slice), 14,400 B (seven and a short one), 32,000 B
    in a single tile and 16 B; k3 at offsets 0 and R - tile among random
    ones. Equal to the plain versions and to repeat / index_select."""
    rng = np.random.RandomState(tile)
    R = 3 * tile + 5
    g = torch.tensor(rng.randn(R, C), dtype=torch.float32, device=cuda)
    lo = rng.randint(0, R - tile + 1, n_tiles)
    lo[0], lo[-1] = (0, R - tile) if n_tiles > 1 else (R - tile,) * 2
    lo = torch.from_numpy(lo.astype(np.int32)).to(cuda)
    before = cp.static_copy.launches, cp.dynamic_copy.launches
    got2 = cp.static_copy(g, n_tiles, tile)
    got3 = cp.dynamic_copy(g, lo, n_tiles, tile)
    torch.cuda.synchronize()
    assert (cp.static_copy.launches, cp.dynamic_copy.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got2, cp.static_copy_plain(g, n_tiles, tile))
    assert torch.equal(got2, g[:tile].repeat(n_tiles, 1))
    rows = (lo.long()[:, None] + torch.arange(tile, device=cuda)).reshape(-1)
    assert torch.equal(got3, cp.dynamic_copy_plain(g, lo, n_tiles, tile))
    assert torch.equal(got3, torch.index_select(g, 0, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("tile,C,n_tiles", [(100, 4, 5), (300, 12, 3),
                                            (1000, 8, 1), (1, 1, 7),
                                            (1024, 8, 8)])
def test_copy_1d_matches_plain(cuda, tile, C, n_tiles):
    """K7 k4, one block per 64 rows of a tile, each a bulk load of its
    16-byte window of q: tiles of 2, 5 and 16 slices with a short last one,
    16 whole slices, and one row; C = 1, 4, 8, 12; offsets 0, len(q) - tile
    and 1, 2, 3 mod 4 (bisect_mosaic.edge_offsets), each taken by some
    tile. Equal to the plain version and to torch.take."""
    rng = np.random.RandomState(tile + C)
    n_q = 4 * ((3 * tile + 8) // 4)
    q = torch.tensor(rng.randint(-2 ** 31, 2 ** 31 - 1, n_q),
                     dtype=torch.int32, device=cuda)
    for lo_np in bisect_mosaic.edge_offsets(tile, n_tiles, n_q):
        lo = torch.from_numpy(lo_np).to(cuda)
        before = cp.copy_1d.launches
        got = cp.copy_1d(q, lo, n_tiles, tile, C)
        torch.cuda.synchronize()
        assert cp.copy_1d.launches == before + 1
        assert torch.equal(got, cp.copy_1d_plain(q, lo, n_tiles, tile, C))
        rows = (lo[:n_tiles].long()[:, None]
                + torch.arange(tile, device=cuda)).reshape(-1)
        assert torch.equal(got, torch.take(q, rows[:, None].expand(-1, C))
                           .float())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("tile", [1, 100, 1024])
def test_prefetch_write_matches_plain(cuda, tile, C):
    """K7 k1, one block per (tile, 2 KB slice) with float4 stores: tiles of
    4 B to 32 KB whose starts leave 16 bytes (tile * C % 4 != 0), so each
    has a scalar head and tail. Equal to the plain version and to
    repeat_interleave."""
    rng = np.random.RandomState(tile + C)
    n_tiles = 7
    lo = torch.tensor(rng.randint(-2 ** 24, 2 ** 24, n_tiles + 2),
                      dtype=torch.int32, device=cuda)
    before = cp.prefetch_write.launches
    got = cp.prefetch_write(lo, n_tiles, tile, C)
    torch.cuda.synchronize()
    assert cp.prefetch_write.launches == before + 1
    assert torch.equal(got, cp.prefetch_write_plain(lo, n_tiles, tile, C))
    lib = torch.repeat_interleave(lo[:n_tiles, None].expand(n_tiles, C),
                                  tile, dim=0)
    assert torch.equal(got, lib.float())


FILL_SHAPES = [(tile, C, 7) for tile in (1, 100, 1024)
               for C in (1, 3, 8, 128)] + [(1024, 8, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,C,n_tiles", FILL_SHAPES)
def test_dynamic_loop_matches_plain(cuda, tile, C, n_tiles):
    """K7 k5 on k1's fill body, one block per (tile, 2 KB slice), each
    thread running the loop of lo[k] trips once: trips -5, 0, 1, 3, 199 and
    4,096 among random ones in [-5, 200), tiles of 4 B to 512 KB whose starts
    leave 16 bytes where tile * C % 4 != 0, and 300 tiles of 32 KB (4,800
    blocks, more than a wave). Equal to the plain version."""
    rng = np.random.RandomState(tile + C + n_tiles)
    lo = rng.randint(-5, 200, n_tiles + 2)
    lo[:6] = (-5, 0, 1, 3, 199, 4096)
    lo = torch.from_numpy(rng.permutation(lo[:n_tiles]).astype(np.int32))
    lo = lo.to(cuda)
    before = cp.dynamic_loop.launches
    got = cp.dynamic_loop(lo, n_tiles, tile, C)
    torch.cuda.synchronize()
    assert cp.dynamic_loop.launches == before + 1
    assert torch.equal(got, cp.dynamic_loop_plain(lo, n_tiles, tile, C))


@pytest.mark.cuda
@pytest.mark.parametrize("tile,C,n_tiles", FILL_SHAPES)
def test_iota_rows_matches_plain(cuda, tile, C, n_tiles):
    """K7 k7: the fill body where C % 4 == 0 (a float4 in one row), one
    float a thread otherwise; tiles of one row to 1,024 rows, C of 1 to 128,
    and 300 tiles (4,800 blocks, more than a wave). Equal to the plain
    version and to arange(tile) repeated."""
    before = cp.iota_rows.launches
    got = cp.iota_rows(n_tiles, tile, C, device=cuda)
    torch.cuda.synchronize()
    assert cp.iota_rows.launches == before + 1
    assert torch.equal(got, cp.iota_rows_plain(n_tiles, tile, C, cuda))
    rows = torch.arange(tile, device=cuda, dtype=torch.float32)
    assert torch.equal(got, rows.repeat(n_tiles)[:, None].expand(-1, C))


@pytest.mark.cuda
def test_scatter_add_kernel_at_the_cli_backward_shape(cuda):
    """K1 at the CLI's NeRF backward: [n, 16 levels x 8 corners] idx and
    C = 2 bf16 rows into the 6,328,848-row table of the CLI's default
    16-level C = 2 lg19 grid at bound 2 (level resolutions up to 4,097),
    at the train step's full eval capacity (4,096 rays x 32 samples). The
    error is held to REL_TOL of the largest sum of magnitudes into one row
    (a NeRF's gradients of both signs cancel inside a row)."""
    from laenerf_tpu_torch.models import NeRFConfig
    from laenerf_tpu_torch.ops.hashgrid import _octo_corners

    spec = NeRFConfig(bound=2.0).grid_spec
    assert spec.table_rows == 6328848 and spec.level_dim == 2
    gen = torch.Generator(device=cuda).manual_seed(4)
    n = 4096 * 32
    idx, w = _octo_corners(spec, torch.rand((n, 3), generator=gen,
                                            device=cuda))
    grad = torch.randn((n, spec.num_levels, 2), generator=gen, device=cuda)
    rows = (w[..., None] * grad[:, :, None, :]).to(torch.bfloat16)
    idx, rows = idx.reshape(n, -1), rows.reshape(n, -1, 2)
    assert idx.shape == (n, 128)
    before = scatter_add_rows.launches
    got = scatter_add_rows(idx, rows, spec.table_rows)
    ref = scatter_add_rows_plain(idx, rows, spec.table_rows)
    mags = scatter_add_rows_plain(idx, rows.abs(), spec.table_rows)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    assert ((got - ref).abs().max() / mags.max()).item() < REL_TOL


@pytest.mark.cuda
def test_cli_steps_at_default_width_on_card(cuda, tmp_path):
    """A few -m nerf --error_map steps of the CLI at its default width (the
    16-level C = 2 lg19 grid, 2 cascades at bound 2, 1024 march events) on
    a small colmap scene on the card: every step launches K1, the losses
    are finite, the error map moves and a checkpoint is written."""
    import json

    from PIL import Image

    from laenerf_tpu_torch.data import generate_synthetic_scene, provider
    from laenerf_tpu_torch.pipeline import cli
    from laenerf_tpu_torch.train import Trainer

    src, scene = tmp_path / "blender", tmp_path / "colmap"
    generate_synthetic_scene(str(src), n_train=4, n_val=0, n_test=0, H=32,
                             W=32, device=cuda)
    (scene / "images").mkdir(parents=True)
    tf = json.loads((src / "transforms_train.json").read_text())
    frames = []
    for i, fr in enumerate(tf["frames"]):
        rgba = np.asarray(Image.open(src / (fr["file_path"] + ".png")),
                          np.float32) / 255.0
        rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        name = f"images/frame_{i:03d}.png"
        Image.fromarray((rgb * 255).astype(np.uint8)).save(scene / name)
        frames.append({"file_path": name,
                       "transform_matrix": fr["transform_matrix"]})
    (scene / "transforms.json").write_text(json.dumps(
        {"camera_angle_x": tf["camera_angle_x"], "frames": frames}))

    steps, losses, k1, maps = 6, [], [], []
    real_step = Trainer.train_one_batch
    real_update = provider.NeRFDataset.update_error_map

    def step(self, batch, has_alpha, **kw):
        before = scatter_add_rows.launches
        aux = real_step(self, batch, has_alpha, **kw)
        losses.append(float(aux["loss"]))
        k1.append(scatter_add_rows.launches - before)
        return aux

    def update(self, *a):
        real_update(self, *a)
        maps.append(self.error_map)

    Trainer.train_one_batch, provider.NeRFDataset.update_error_map = \
        step, update
    try:
        cli.main([str(scene), "--workspace", str(tmp_path / "ws"),
                  "--iters", str(steps), "--bound", "2", "--bg_radius", "0",
                  "--dt_gamma", "0", "--num_rays", "1024", "--error_map"])
    finally:
        Trainer.train_one_batch = real_step
        provider.NeRFDataset.update_error_map = real_update
    assert len(losses) == steps and np.isfinite(losses).all()
    assert min(k1) >= 1
    assert len(maps) == steps and (maps[-1] != 1.0).any()
    assert list((tmp_path / "ws" / "checkpoints").glob("*.npz"))


@pytest.mark.cuda
def test_clip_tower_card_vs_cpu(cuda):
    """ViT-B/16 at its published width: the similarity loss and the image
    gradient on the card within 1e-5 / 1e-4 of the CPU's (f32, no TF32)."""
    from laenerf_tpu_torch.models import clip_vit
    from laenerf_tpu_torch.train.trainer import configure_matmul_precision

    configure_matmul_precision()
    tower = clip_vit.clip_vision_init(seed=1, device="cpu")
    card = clip_vit.CLIPVision(device=cuda)
    card.load_state_dict(tower.state_dict())
    g = torch.Generator().manual_seed(2)
    img = torch.rand((2, 48, 48, 3), generator=g)
    tz = torch.randn((512,), generator=g)
    out = []
    for model, dev in ((card, cuda), (tower, torch.device("cpu"))):
        x = img.to(dev).requires_grad_(True)
        loss = clip_vit.clip_similarity_loss(model, x, tz.to(dev))
        loss.backward()
        out.append((loss.item(), x.grad.cpu()))
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    assert _rel_err(out[0][1], out[1][1]) < 1e-4


@pytest.mark.cuda
def test_clip_step_card_vs_cpu(cuda):
    """One train_step_clip on a small NeRF from the same parameters and
    noises: the loss within 1e-3 and each parameter's gradient within 2e-2
    of its largest element (bf16 network), on the card against the CPU."""
    from laenerf_tpu_torch.models import NeRFConfig, RenderConfig, nerf_init
    from laenerf_tpu_torch.models import clip_vit
    from laenerf_tpu_torch.train.trainer import (configure_matmul_precision,
                                                 make_optimizer,
                                                 train_step_clip)

    configure_matmul_precision()
    mcfg = NeRFConfig(num_levels=4, log2_hashmap_size=12)
    rcfg = RenderConfig(grid_size=32, max_steps=128, march_iters=128,
                        m_cap_per_ray=96)
    g = torch.Generator().manual_seed(3)
    net0 = nerf_init(mcfg, device="cpu", generator=g)
    tower = clip_vit.clip_vision_init(seed=1, device="cpu")
    tz = torch.randn((512,), generator=g)
    noises = torch.rand((32 * 32,), generator=g)
    occ = torch.ones((1, 32, 32, 32), dtype=torch.uint8)
    pose = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.0],
                         [0, 0, 0, 1.0]])
    intr = torch.tensor([32.0, 32.0, 16.0, 16.0])
    res = []
    for dev in (cuda, torch.device("cpu")):
        net = nerf_init(mcfg, device=dev)
        net.load_state_dict(net0.state_dict())
        ema = nerf_init(mcfg, device=dev).requires_grad_(False)
        model = clip_vit.CLIPVision(device=dev)
        model.load_state_dict(tower.state_dict())
        opt, sched = make_optimizer(net.parameters(), 1e-2, 100)
        aux = train_step_clip(net, ema, opt, sched, occ.to(dev), model,
                              tz.to(dev), pose.to(dev), intr.to(dev),
                              render_cfg=rcfg, ema_decay=0.95, H=32, W=32,
                              noises=noises.to(dev))
        res.append((aux["loss"].item(), {n: p.grad.cpu() for n, p in
                                         net.named_parameters()}))
    assert abs(res[0][0] - res[1][0]) <= 1e-3 * abs(res[1][0])
    for name, ref in res[1][1].items():
        assert _rel_err(res[0][1][name], ref) < 2e-2, name


@pytest.mark.cuda
def test_background_encoder_backward_through_k1(cuda):
    """The 2-D background grid's backward launches K1 on a 1-D idx of
    B * 4 levels * 4 corners f32 rows, within 1e-5 of its plain version."""
    from laenerf_tpu_torch.models import NeRFConfig

    spec = NeRFConfig(bg_radius=4.0).bg_grid_spec
    g = torch.Generator().manual_seed(4)
    table = torch.rand((spec.table_rows, 2), generator=g) - 0.5
    x = torch.rand((4096, 2), generator=g) * 2 - 1
    cot = torch.randn((4096, spec.output_dim), generator=g)
    grads = []
    before = scatter_add_rows.launches
    for dev in (cuda, torch.device("cpu")):
        tt = table.to(dev).requires_grad_(True)
        (hashgrid_encode(tt, x.to(dev), spec) * cot.to(dev)).sum().backward()
        grads.append(tt.grad.cpu())
    assert scatter_add_rows.launches == before + 1
    assert _rel_err(grads[0], grads[1]) < REL_TOL


MARCH_CASES = {c[0]: c for c in _march_cases.kernel_cases()}
MARCH_CASES["ngp_blender"] = None  # built in the test: 2 M cells


def _march_inputs(name, dev):
    case = MARCH_CASES[name] or _march_cases.ngp_blender_case()
    _, kw, occ, ro, rd, noises = case
    cfg = raymarch.MarchConfig(**kw)
    b = cfg.bound
    ro, rd = torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)
    aabb = torch.tensor([-b] * 3 + [b] * 3, device=dev)
    nears, fars = raymarch.near_far_from_aabb(ro, rd, aabb)
    return (ro, rd, torch.from_numpy(occ).to(dev), nears, fars,
            torch.from_numpy(noises).to(dev), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MARCH_CASES))
def test_march_kernel_matches_plain(cuda, name):
    """K8 against its plain loop on the card: valid, n_samples and t0
    equal; ts and dts bit-equal where valid is set and finite elsewhere
    (but on rays whose t went NaN, in either); one launch a call."""
    args = _march_inputs(name, cuda)
    before = raymarch.march_rays_train.launches
    got = raymarch.march_rays_train(*args)
    ref = raymarch.march_rays_train_plain(*args)
    torch.cuda.synchronize()
    assert raymarch.march_rays_train.launches == before + 1
    v = ref["valid"]
    for k in ("valid", "n_samples", "t0"):
        assert torch.equal(got[k], ref[k]), k
    nan_rays = (torch.isnan(ref["ts"]) | torch.isnan(got["ts"])).any(
        dim=1, keepdim=True)
    for k in ("ts", "dts"):
        assert got[k].shape == ref[k].shape
        assert torch.equal(got[k].view(torch.int32)[v],
                           ref[k].view(torch.int32)[v]), k
        assert torch.isfinite(got[k])[~v & ~nan_rays].all(), k
    if name.startswith("zero_dir"):  # a cell centre's 0 * inf reached t
        assert bool(nan_rays.any())
    if name == "zero_dir_corner":  # NaN rays sample the corner cell
        assert bool((v & nan_rays).any())
        assert int(v[:, -32:].sum()) == 0  # the loop stopped before S
    if name not in ("empty", "miss"):
        assert int(v.sum()) > 0


@pytest.mark.cuda
def test_march_kernel_host_waits(cuda):
    """With the tracer off a K8 march makes no host wait; recording, it
    waits once (sync.march_events, never sync.march_alive) and counts the
    events and slots the plain loop counts."""
    from laenerf_tpu_torch.utils import timers

    args = _march_inputs("ngp_blender", cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        raymarch.march_rays_train(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    recs = []
    for march in (raymarch.march_rays_train, raymarch.march_rays_train_plain):
        timers.start()
        try:
            march(*args)
        finally:
            recs.append(timers.stop())
    got, ref = (r["counters"] for r in recs)
    assert got["sync.march_events"] == 1 and "sync.march_alive" not in got
    assert ref["sync.march_alive"] > 0
    for k in ("march.events", "march.slots"):
        assert got[k] == ref[k], k
    assert {s["name"] for s in recs[0]["spans"]} == {"march.skip_field",
                                                     "march.kernel"}


COMPOSITE_CASES = _composite_cases.composite_cases()
K9_LAUNCHES = (composite.composite_rays_train_packed,
               composite.composite_rays_train_packed_backward)


def _k9_launches():
    return tuple(f.launches for f in K9_LAUNCHES)


def _k9_matches_plain(case, which, dev, before):
    got, gs, gc, scale = _composite_cases.run_packed(
        composite.composite_rays_train_packed, case, which, dev)
    ref, rs, rc, _ = _composite_cases.run_packed(
        composite.composite_rays_train_packed_plain, case, which, dev)
    torch.cuda.synchronize()
    assert _k9_launches() == (before[0] + 1, before[1] + 1)
    _k9_close(got, gs, gc, ref, rs, rc, scale)
    return ref, rc


def _k9_close(got, gs, gc, ref, rs, rc, scale):
    """K9's outputs and rgb gradients within 1e-5 of the plain version's
    largest, its sigma gradients within 1e-5 of `scale`."""
    for g, r, name in zip(got, ref, _composite_cases.OUTPUTS):
        assert _rel_err(g, r) < 1e-5, name
    assert _rel_err(gc, rc) < 1e-5
    assert float((gs - rs).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["all", "image", "depth", "weights_sum"])
@pytest.mark.parametrize("case", sorted(COMPOSITE_CASES))
def test_composite_packed_kernel_matches_plain(cuda, case, which):
    """K9 forward and backward against its plain version on the card (the
    same expf), from each output alone and all three: early stops, empty
    rays, rays the capacity cuts (to nothing too), single samples, runs
    across warp rounds, the threshold met exactly; one launch of each."""
    ref, rc = _k9_matches_plain(COMPOSITE_CASES[case], which, cuda,
                                _k9_launches())
    if case == "exact_thresh" and which in ("all", "image"):
        assert bool((rc[6] != 0).all()) and bool((rc[7] == 0).all())


def _lego_class_samples(dev, m_cap=262144):
    """The NeRF cell's shape: 8,192 rays of one camera marched (K8) over a
    128^3 lego-class occupancy at 1,024 events, the first m_cap samples
    packed, the scene's density and colour at them."""
    from laenerf_tpu_torch.ops.compaction import packed_sample_indices
    from nerfbench.scenes import lego_class

    pa = lego_class.prim_arrays(lego_class.lego_class_scene(), dev)
    H = 128
    c = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5) * 2 / H - 1
    cells = torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1)
    sig_cells = lego_class._eval_scene(pa, cells.reshape(-1, 3))[0]
    occ = (sig_cells > 0).to(torch.uint8).reshape(1, H, H, H)
    ro, rd, noises = _march_cases.camera_rays(0, 8192, 1.0)
    ro, rd = torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)
    cfg = raymarch.MarchConfig(bound=1.0, grid_size=H, max_steps=1024,
                               march_iters=1024)
    aabb = torch.tensor([-1.0] * 3 + [1.0] * 3, device=dev)
    nears, fars = raymarch.near_far_from_aabb(ro, rd, aabb)
    march = raymarch.march_rays_train(ro, rd, occ, nears, fars,
                                      torch.from_numpy(noises).to(dev), cfg)
    idx = packed_sample_indices(march["valid"], m_cap)
    ray = idx // cfg.march_iters
    ts = march["ts"].reshape(-1)[idx]
    dts = march["dts"].reshape(-1)[idx]
    sig, rgb = lego_class._eval_scene(pa, ro[ray] + ts[:, None] * rd[ray])
    counts = march["n_samples"]
    return (sig, rgb, dts, ts, torch.cumsum(counts, 0), counts,
            march["t0"]), ray


@pytest.mark.cuda
def test_composite_packed_kernel_at_the_ngp_shape(cuda):
    """K9 against its plain version at the NeRF cell's shape (8,192 rays,
    262,144 samples of capacity) on a lego-class scene, the gradients from
    all three outputs, at the tolerances of the small cases."""
    args, ray = _lego_class_samples(cuda)
    sig, rgb, dts, ts, ends, counts, t0 = args
    assert int(counts.max()) > 32 and sig.shape[0] > 50000
    cots = [c.to(cuda) for c in _composite_cases.cotangents(8192, "all")]
    res = []
    for fn in (composite.composite_rays_train_packed,
               composite.composite_rays_train_packed_plain):
        s = sig.clone().requires_grad_(True)
        c = rgb.clone().requires_grad_(True)
        outs = fn(s, c, *args[2:], 1e-4)
        sum((o * g).sum() for o, g in zip(outs, cots)).backward()
        res.append(([o.detach() for o in outs], s.grad, c.grad))
    assert float(res[1][0][0].max()) > 0.99  # rays stop inside the scene
    scale = _composite_cases.sigma_grad_scale(ts, dts, rgb, ray, t0, "all")
    _k9_close(*res[0], *res[1], scale)


@pytest.mark.cuda
def test_composite_packed_kernel_host_waits(cuda):
    """K9's forward and backward make no host wait."""
    case = COMPOSITE_CASES["ragged"]
    sig, rgb, dts, ts, valid, t0 = (torch.from_numpy(a).to(cuda) for a in
                                    case[:6])
    (s, c, d, t), ends, counts, _ = _composite_cases.packed(
        sig, rgb, dts, ts, valid, None)
    s.requires_grad_(True)
    c.requires_grad_(True)
    cots = [g.to(cuda) for g in _composite_cases.cotangents(len(t0), "all")]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = composite.composite_rays_train_packed(s, c, d, t, ends,
                                                     counts, t0, 1e-4)
        sum((o * g).sum() for o, g in zip(outs, cots)).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert s.grad is not None and c.grad is not None


@pytest.mark.cuda
def test_train_step_through_k9_card_vs_cpu(cuda):
    """One train_step on a small NeRF from the same parameters, batch and
    noises: K9's forward and backward launch once each on the card, and
    the loss (within 1e-3) and every parameter's gradient (within 2e-2 of
    its largest element: bf16 network) match the CPU's plain path."""
    from laenerf_tpu_torch.models import NeRFConfig, RenderConfig, nerf_init
    from laenerf_tpu_torch.train.trainer import (configure_matmul_precision,
                                                 make_optimizer, train_step)

    configure_matmul_precision()
    mcfg = NeRFConfig(num_levels=4, log2_hashmap_size=12)
    rcfg = RenderConfig(grid_size=32, max_steps=128, march_iters=128,
                        m_cap_per_ray=16)
    g = torch.Generator().manual_seed(6)
    net0 = nerf_init(mcfg, device="cpu", generator=g)
    N = 2048
    inds = torch.randint(0, 64 * 64, (N,), generator=g)
    pixels = torch.rand((N, 4), generator=g)
    bg = torch.rand((N, 3), generator=g)
    noises = torch.rand((N,), generator=g)
    occ = torch.ones((1, 32, 32, 32), dtype=torch.uint8)
    pose = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.0],
                         [0, 0, 0, 1.0]])
    intr = torch.tensor([64.0, 64.0, 32.0, 32.0])
    res = []
    for dev in (cuda, torch.device("cpu")):
        net = nerf_init(mcfg, device=dev)
        net.load_state_dict(net0.state_dict())
        ema = nerf_init(mcfg, device=dev).requires_grad_(False)
        opt, sched = make_optimizer(net.parameters(), 1e-2, 100)
        before = _k9_launches()
        aux = train_step(net, ema, opt, sched, occ.to(dev), pose.to(dev),
                         intr.to(dev), inds.to(dev), pixels.to(dev),
                         render_cfg=rcfg, ema_decay=0.95, has_alpha=True,
                         bg_white=False, H=64, W=64, bg=bg.to(dev),
                         noises=noises.to(dev))
        launched = tuple(a - b for a, b in zip(_k9_launches(), before))
        res.append((aux["loss"].item(), launched,
                    {n: p.grad.cpu() for n, p in net.named_parameters()}))
    assert res[0][1] == (1, 1) and res[1][1] == (0, 0)
    assert abs(res[0][0] - res[1][0]) <= 1e-3 * abs(res[1][0])
    for name, ref in res[1][2].items():
        assert _rel_err(res[0][2][name], ref) < 2e-2, name
