"""Parity of the port's leaf ops (laenerf_tpu_torch/ops, data/rays.py) with
the JAX package on the same numpy inputs.

Tolerances: float32 elementwise math at 1e-5 (reassociation only); the skip
field exactly; the march by its exact-agreement rate of (ts, valid) over
all sample slots, which must be >= 99.9% (a float reassociation may move an
event by one lattice step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laenerf_tpu.data import rays as jrays
from laenerf_tpu.ops import activation as jact
from laenerf_tpu.ops import compaction as jcomp
from laenerf_tpu.ops import composite as jcompo
from laenerf_tpu.ops import raymarch as jmarch
from laenerf_tpu.ops import sh as jsh
from laenerf_tpu_torch.data import rays as trays
from laenerf_tpu_torch.ops import activation as tact
from laenerf_tpu_torch.ops import compaction as tcomp
from laenerf_tpu_torch.ops import composite as tcompo
from laenerf_tpu_torch.ops import raymarch as tmarch
from laenerf_tpu_torch.ops import sh as tsh

import _composite_cases
from _march_cases import blob_grid, march_cases


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_trunc_exp_value_and_grad():
    x = np.linspace(-20.0, 20.0, 41).astype(np.float32)
    g = np.random.RandomState(0).rand(41).astype(np.float32)
    y_j, vjp = jax.vjp(jact.trunc_exp, jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    y_t = tact.trunc_exp(xt)
    y_t.backward(_t(g))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode(degree):
    d = np.random.RandomState(degree).randn(64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jsh.sh_encode(jnp.asarray(d), degree))
    got = tsh.sh_encode(_t(d), degree).numpy()
    assert got.shape == (64, tsh.sh_output_dim(degree)) == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_get_rays_and_tile_order():
    rng = np.random.RandomState(1)
    H, W = 30, 40
    pose = np.eye(4, dtype=np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    pose[:3, :3] = q.astype(np.float32)
    pose[:3, 3] = rng.randn(3).astype(np.float32)
    intr = np.array([35.0, 36.0, 20.0, 15.0], np.float32)
    inds = rng.randint(0, H * W, 257).astype(np.int32)
    ro_j, rd_j = jrays.get_rays(jnp.asarray(pose), jnp.asarray(intr),
                                jnp.asarray(inds), H, W)
    ro_t, rd_t = trays.get_rays(_t(pose), _t(intr), _t(inds, torch.int64),
                                H, W)
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), rtol=1e-6)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=1e-5,
                               atol=1e-6)
    po_j, pd_j = jrays.pixel_rays(jnp.asarray(pose), jnp.asarray(intr), H, W)
    po_t, pd_t = trays.pixel_rays(_t(pose), _t(intr), H, W)
    np.testing.assert_allclose(pd_t.numpy(), np.asarray(pd_j), rtol=1e-5,
                               atol=1e-6)
    for h, w, tile in [(30, 40, 16), (800, 800, 128), (7, 5, 4)]:
        o_j, i_j = jrays.tile_raster_order(h, w, tile)
        o_t, i_t = trays.tile_raster_order(h, w, tile)
        np.testing.assert_array_equal(o_t, o_j)
        np.testing.assert_array_equal(i_t, i_j)


def test_near_far_from_aabb_edge_cases():
    rng = np.random.RandomState(2)
    ro = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    rd = rng.randn(64, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro[0], rd[0] = [0.0, 0.0, -3.0], [0.0, 0.0, 1.0]  # zero components
    ro[1], rd[1] = [0.5, 0.0, -3.0], [0.0, 0.0, 1.0]
    ro[2], rd[2] = [0.0, 5.0, -3.0], [0.0, 0.0, 1.0]  # misses the box
    ro[3], rd[3] = [0.1, 0.2, 0.3], [1.0, 0.0, 0.0]  # starts inside
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    n_j, f_j = jmarch.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                         jnp.asarray(aabb))
    n_t, f_t = tmarch.near_far_from_aabb(_t(ro), _t(rd), _t(aabb))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6)
    big = np.finfo(np.float32).max
    assert n_t[2].item() == big and f_t[2].item() == big
    assert n_t[0].item() == pytest.approx(2.0) and f_t[0].item() == \
        pytest.approx(4.0)


@pytest.mark.parametrize("cas,bound,H", [(1, 1.0, 32), (2, 2.0, 16),
                                         (2, 1.5, 16)])
def test_build_skip_field_exact(cas, bound, H):
    occ = blob_grid(3, cas, H)
    ref = np.asarray(jmarch.build_skip_field(jnp.asarray(occ), bound=bound))
    got = tmarch.build_skip_field(_t(occ), bound=bound).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)
    if cas > 1 and bound == 2.0:
        np.testing.assert_array_equal(
            tmarch._cross_level_blocked(_t(occ).to(torch.int8)).numpy(),
            np.asarray(jmarch._cross_level_blocked(
                jnp.asarray(occ, jnp.int8))))


@pytest.mark.parametrize("fixture", march_cases(), ids=lambda f: f[0])
def test_march_rays_train_agreement(fixture):
    name, kw, occ, ro, rd, noises = fixture
    cfg, tcfg = jmarch.MarchConfig(**kw), tmarch.MarchConfig(**kw)
    b = cfg.bound
    aabb = np.array([-b, -b, -b, b, b, b], np.float32)
    n_j, f_j = jmarch.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                         jnp.asarray(aabb))
    ref = jmarch.march_rays_train(jnp.asarray(ro), jnp.asarray(rd),
                                  jnp.asarray(occ), n_j, f_j,
                                  jnp.asarray(noises), cfg)
    n_t, f_t = tmarch.near_far_from_aabb(_t(ro), _t(rd), _t(aabb))
    got = tmarch.march_rays_train(_t(ro), _t(rd), _t(occ), n_t, f_t,
                                  _t(noises), tcfg)
    ts_j, v_j = np.asarray(ref["ts"]), np.asarray(ref["valid"])
    ts_t, v_t = got["ts"].numpy(), got["valid"].numpy()
    assert ts_t.shape == ts_j.shape
    agree = np.mean((ts_t == ts_j) & (v_t == v_j))
    print(f"march {name}: exact (ts, valid) agreement {agree:.6f}")
    assert agree >= 0.999
    np.testing.assert_allclose(got["t0"].numpy(), np.asarray(ref["t0"]),
                               rtol=1e-6)
    if name == "full":
        assert int(got["n_samples"][0]) > 0
    if name in ("empty", "miss"):
        assert int(got["n_samples"][0]) == 0
    pos_j = jmarch.sample_positions(jnp.asarray(ro), jnp.asarray(rd),
                                    ref["ts"], b)
    pos_t = tmarch.sample_positions(_t(ro)[:, None], _t(rd)[:, None],
                                    got["ts"], b)
    np.testing.assert_allclose(pos_t.numpy()[v_t & v_j],
                               np.asarray(pos_j)[v_t & v_j], rtol=1e-5,
                               atol=1e-5)


def test_render_train_ignores_invalid_slots(monkeypatch):
    """Nothing downstream of the train march reads ts or dts where valid is
    false (K8 leaves each ray's last t and dt there, the plain loop zeros
    after its last block): other finite values there leave
    render_rays_train's image, depth and weights_sum and the network's
    gradients bit for bit as they were, with the eval capacity cutting
    rays short. A march on the CPU launches no kernel."""
    from laenerf_tpu_torch.models import NeRFConfig, RenderConfig
    from laenerf_tpu_torch.models import renderer
    from laenerf_tpu_torch.models.nerf import NeRFNetwork

    _, kw, occ, ro, rd, noises = march_cases()[4]  # blobs
    net = NeRFNetwork(NeRFConfig(bound=1.0, num_levels=4,
                                 log2_hashmap_size=12), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    # 4 samples a ray of capacity, under the ~5.3 the rays hold
    rcfg = RenderConfig(**kw, m_cap_per_ray=4)
    real = tmarch.march_rays_train

    def scrambled(*a, **k):
        out = real(*a, **k)
        g = torch.Generator().manual_seed(1)
        bad = ~out["valid"]
        out["ts"] = torch.where(bad, 50 * torch.rand(bad.shape, generator=g),
                                out["ts"])
        out["dts"] = torch.where(bad, 2 * torch.rand(bad.shape, generator=g),
                                 out["dts"])
        return out

    def run():
        net.zero_grad(set_to_none=True)
        out = renderer.render_rays_train(net, _t(occ), _t(ro), _t(rd),
                                         render_cfg=rcfg, noises=_t(noises))
        (out["image"].sum() + out["depth"].sum()
         + out["weights_sum"].sum()).backward()
        return out, {n: p.grad.clone() for n, p in net.named_parameters()}

    launches = tmarch.march_rays_train.launches
    ref, ref_grads = run()
    monkeypatch.setattr(renderer, "march_rays_train", scrambled)
    got, grads = run()
    assert tmarch.march_rays_train.launches == launches
    assert not bool(ref["ray_ok"].all())  # the capacity cut some rays
    for k in ("image", "depth", "weights_sum"):
        assert torch.equal(got[k], ref[k]), k
    assert grads.keys() == ref_grads.keys()
    for n, g in ref_grads.items():
        assert torch.equal(grads[n], g), n


@pytest.mark.parametrize("m_cap", [40, 16])  # 16 < n_valid: overflow
def test_compact_and_scatter_back(m_cap):
    """packed_sample_indices, sample_destinations and scatter_back (and its
    gradient to the values) against JAX's compact_samples, gather_flat
    and scatter_back."""
    rng = np.random.RandomState(8)
    N, S = 8, 9
    valid = rng.rand(N, S) > 0.45
    vals = rng.randn(N * S, 4).astype(np.float32)
    gi_j, gm_j, dest_j = jcomp.compact_samples(jnp.asarray(valid), m_cap)
    m = np.asarray(gm_j)
    idx = tcomp.packed_sample_indices(_t(valid), m_cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(gi_j)[m])
    dest_t = tcomp.sample_destinations(_t(valid), m_cap)
    np.testing.assert_array_equal(dest_t.numpy(), np.asarray(dest_j))

    comp_j = jcomp.gather_flat(jnp.asarray(vals), gi_j)
    comp_t = _t(vals)[idx]
    n = int(m.sum())
    np.testing.assert_array_equal(comp_t.numpy(), np.asarray(comp_j)[:n])
    cot = rng.randn(N, S, 4).astype(np.float32)

    def loss_j(v):
        return jnp.sum(jcomp.scatter_back(v, dest_j, (N, S), gather_idx=gi_j,
                                          gather_mask=gm_j) * cot)

    back_j = jcomp.scatter_back(comp_j, dest_j, (N, S))
    g_j = np.asarray(jax.grad(loss_j)(comp_j))
    v = comp_t.clone().requires_grad_(True)
    back_t = tcomp.scatter_back(v, dest_t, (N, S))
    (back_t * _t(cot)).sum().backward()
    np.testing.assert_array_equal(back_t.detach().numpy(),
                                  np.asarray(back_j))
    np.testing.assert_array_equal(v.grad.numpy(), g_j[:n])


def _composite_inputs(seed, N=6, S=24):
    rng = np.random.RandomState(seed)
    dts = rng.uniform(0.01, 0.08, (N, S)).astype(np.float32)
    t0 = rng.uniform(1.5, 2.5, N).astype(np.float32)
    ts = (t0[:, None] + np.cumsum(dts, axis=1) - dts).astype(np.float32)
    sig = rng.uniform(0, 60, (N, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    valid = rng.rand(N, S) > 0.2
    valid[1, 10:] = False
    valid[2] = False
    return sig, rgb, dts, ts, valid, t0


def test_composite_rays_train_values_and_grads():
    sig, rgb, dts, ts, valid, t0 = _composite_inputs(9)
    rng = np.random.RandomState(10)
    c_ws, c_d = rng.randn(sig.shape[0]).astype(np.float32), \
        rng.randn(sig.shape[0]).astype(np.float32)
    c_img = rng.randn(sig.shape[0], 3).astype(np.float32)

    def loss_j(s, r):
        ws, d, img = jcompo.composite_rays_train(
            s, r, jnp.asarray(dts), jnp.asarray(ts), jnp.asarray(valid),
            jnp.asarray(t0))
        return (jnp.sum(ws * c_ws) + jnp.sum(d * c_d)
                + jnp.sum(img * c_img)), (ws, d, img)

    (_, outs_j), (gs_j, gr_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(sig),
                                              jnp.asarray(rgb))
    s_t, r_t = _t(sig).requires_grad_(True), _t(rgb).requires_grad_(True)
    ws, d, img = tcompo.composite_rays_train(s_t, r_t, _t(dts), _t(ts),
                                             _t(valid), _t(t0))
    ((ws * _t(c_ws)).sum() + (d * _t(c_d)).sum()
     + (img * _t(c_img)).sum()).backward()
    for got, ref in zip((ws, d, img), outs_j):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(gs_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r_t.grad.numpy(), np.asarray(gr_j),
                               rtol=1e-5, atol=1e-6)


def test_composite_chunk():
    sig, rgb, dts, ts, valid, t0 = _composite_inputs(11)
    N, K = sig.shape[0], 8
    carry_j = {"T": jnp.ones(N), "ws": jnp.zeros(N), "depth": jnp.zeros(N),
               "rgb": jnp.zeros((N, 3))}
    carry_t = {k: torch.tensor(np.asarray(v)) for k, v in carry_j.items()}
    for c in range(sig.shape[1] // K):
        sl = slice(c * K, (c + 1) * K)
        args = (sig[:, sl], rgb[:, sl], dts[:, sl], ts[:, sl], valid[:, sl],
                t0)
        carry_j = jcompo.composite_chunk(carry_j,
                                         *[jnp.asarray(a) for a in args])
        carry_t = tcompo.composite_chunk(carry_t, *[_t(a) for a in args])
    for k in carry_j:
        np.testing.assert_allclose(carry_t[k].numpy(),
                                   np.asarray(carry_j[k]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("which", ["all", "image", "depth", "weights_sum"])
@pytest.mark.parametrize("case", sorted(_composite_cases.composite_cases()))
def test_composite_packed_plain_matches_padded(case, which):
    """The packed composite's plain version (K9's CPU twin) against
    composite_rays_train over the padded grid with the samples past the
    capacity masked out: outputs, and the gradients to the packed sigmas and
    rgbs from each output alone and from all three."""
    c = _composite_cases.composite_cases()[case]
    ref, rs, rc = _composite_cases.run_padded(c, which, "cpu")
    got, gs, gc, _ = _composite_cases.run_packed(
        tcompo.composite_rays_train_packed, c, which, "cpu")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-7)
    for g, r in ((gs, rs), (gc, rc)):
        scale = float(r.abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-6 * scale)
    if case == "exact_thresh" and which in ("all", "image"):
        # ray 0: the sample at the threshold is kept, the next is not
        assert bool((gc[6] != 0).all()) and bool((gc[7] == 0).all())
    if case in ("cut", "single"):
        assert int(c[4].sum()) > c[6]  # the capacity cut samples
    assert int(c[4].sum()) == 0 or float(ref[0].max()) > 0


def _render_train_padded(renderer, net, occ, ro, rd, rcfg, noises, bg):
    """render_rays_train as it composited before the packed path: samples
    scattered back to the padded [N, S] grid, composite_rays_train over the
    evaluated ones."""
    from laenerf_tpu_torch.models.nerf import nerf_forward

    N, S, cfg = ro.shape[0], rcfg.march_iters, rcfg.march_cfg
    aabb = torch.tensor([-cfg.bound] * 3 + [cfg.bound] * 3)
    nears, _ = tmarch.near_far_from_aabb(ro, rd, aabb, rcfg.min_near)
    fars = tmarch.near_far_from_aabb(ro, rd, aabb, rcfg.min_near)[1]
    with torch.no_grad():
        march = tmarch.march_rays_train(ro, rd, occ, nears, fars, noises, cfg)
    ts, dts, valid = march["ts"], march["dts"], march["valid"]
    xyz = tmarch.sample_positions(ro[:, None], rd[:, None], ts,
                                  cfg.bound).reshape(-1, 3)
    dirs = rd[:, None, :].expand(N, S, 3).reshape(-1, 3)
    m_cap = renderer.train_capacity(N, rcfg)
    idx = tcomp.packed_sample_indices(valid, m_cap)
    dest = tcomp.sample_destinations(valid, m_cap)
    sig, rgb = nerf_forward(net, xyz[idx], dirs[idx])
    both = tcomp.scatter_back(torch.cat([sig[:, None], rgb], dim=1), dest,
                              (N, S))
    ws, depth, image = tcompo.composite_rays_train(
        both[..., 0], both[..., 1:], dts, ts, valid & (dest < m_cap),
        march["t0"], rcfg.t_thresh)
    return {"image": image + (1.0 - ws)[:, None] * bg, "depth": depth,
            "weights_sum": ws,
            "ray_ok": ~torch.any(valid & (dest >= m_cap), dim=1)}


@pytest.mark.parametrize("m_cap_per_ray", [64, 4])  # 4: the capacity cuts
def test_render_train_packed_matches_padded(m_cap_per_ray):
    """render_rays_train on the packed path against the padded path it
    replaced, on the CPU: image, depth, weights_sum and ray_ok, and every
    parameter's gradient from all three outputs."""
    from laenerf_tpu_torch.models import NeRFConfig, RenderConfig
    from laenerf_tpu_torch.models import renderer
    from laenerf_tpu_torch.models.nerf import NeRFNetwork

    _, kw, occ, ro, rd, noises = march_cases()[4]  # blobs
    net = NeRFNetwork(NeRFConfig(bound=1.0, num_levels=4,
                                 log2_hashmap_size=12), device="cpu",
                      generator=torch.Generator().manual_seed(3))
    rcfg = RenderConfig(**kw, m_cap_per_ray=m_cap_per_ray)
    bg = torch.rand((ro.shape[0], 3),
                    generator=torch.Generator().manual_seed(4))
    cot = torch.randn((ro.shape[0], 5),
                      generator=torch.Generator().manual_seed(5))

    def run(render):
        net.zero_grad(set_to_none=True)
        out = render()
        ((out["image"] * cot[:, :3]).sum() + (out["depth"] * cot[:, 3]).sum()
         + (out["weights_sum"] * cot[:, 4]).sum()).backward()
        return out, {n: p.grad.clone() for n, p in net.named_parameters()}

    got, grads = run(lambda: renderer.render_rays_train(
        net, _t(occ), _t(ro), _t(rd), render_cfg=rcfg, bg_color=bg,
        noises=_t(noises)))
    ref, ref_grads = run(lambda: _render_train_padded(
        renderer, net, _t(occ), _t(ro), _t(rd), rcfg, _t(noises), bg))
    assert torch.equal(got["ray_ok"], ref["ray_ok"])
    assert bool(ref["ray_ok"].all()) == (m_cap_per_ray == 64)
    assert float(ref["weights_sum"].detach().max()) > 0.1
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   ref[k].detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert grads.keys() == ref_grads.keys()
    for n, g in ref_grads.items():
        scale = float(g.abs().max())
        assert scale > 0, n
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=n)
