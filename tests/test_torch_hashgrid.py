"""Parity of the port's octo hash-grid encoder (laenerf_tpu_torch/ops/
hashgrid.py) with the JAX package's, on two grids: MODEL_CFG's of
tests/test_model_render.py (every level hashed, 4,096 rows each) and a grid
whose levels are all dense (as in tests/test_hashgrid.py).

Tolerances: the forward at 1e-5 (same bf16-rounded table, f32 weights). The
table gradient at 1.5e-2 relative to its max: both sides round each
(sample, level, corner) row w_c * grad_out to bf16 and accumulate in f32,
but JAX also rounds each row of its [size, 8C] view gradient to bf16 before
folding it onto the table, and the port (which has no view) does not.
The gradient to the positions at 1e-5 relative to its max (the same
gathered rows and f32 weights on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laenerf_tpu.models.nerf import NeRFConfig as JNeRFConfig
from laenerf_tpu.ops import hashgrid as jhg
from laenerf_tpu_torch.ops import hashgrid as thg


def _spec_pair(name, gather_dtype):
    if name == "hashed":
        js = JNeRFConfig(bound=1.0, num_levels=4,
                         log2_hashmap_size=12).grid_spec
    else:
        js = jhg.HashGridSpec.create(desired_resolution=16, num_levels=3,
                                     level_dim=2, base_resolution=4,
                                     log2_hashmap_size=19, octo_gather=True)
    js = dataclasses.replace(js, gather_dtype=gather_dtype)
    fields = {f.name: getattr(js, f.name)
              for f in dataclasses.fields(thg.HashGridSpec)}
    return js, thg.HashGridSpec(**fields)


def _inputs(js, seed, n=384):
    rng = np.random.RandomState(seed)
    table = rng.uniform(-1, 1, (js.table_rows, js.level_dim)).astype(
        np.float32)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    x[:8] *= 1.3  # some points outside [-1, 1] encode to zero
    cot = rng.randn(n, js.output_dim).astype(np.float32)
    return table, x, cot


GRIDS = [("hashed", "bf16"), ("hashed", "f32"), ("dense", "bf16"),
         ("dense", "f32")]


@pytest.mark.parametrize("grid,gather_dtype", GRIDS)
def test_spec_math_identical(grid, gather_dtype):
    js, ts = _spec_pair(grid, gather_dtype)
    for prop in ("level_scales", "level_resolutions", "level_sizes",
                 "level_offsets", "table_rows", "output_dim"):
        assert getattr(ts, prop) == getattr(js, prop), prop
    if grid == "hashed":
        assert set(js.level_sizes) == {4096}
    else:
        res = js.level_resolutions
        assert all((r + 1) ** 3 <= s for r, s in zip(res, js.level_sizes))
    for level in range(js.num_levels):
        assert thg._octo_strides(ts, level) == jhg._octo_strides(js, level)
        assert (thg._octo_corner_offsets(ts, level)
                == jhg._octo_corner_offsets(js, level))


@pytest.mark.parametrize("grid,gather_dtype", GRIDS)
def test_encode_forward(grid, gather_dtype):
    js, ts = _spec_pair(grid, gather_dtype)
    table, x, _ = _inputs(js, 0)
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(x),
                                         js, bound=1.0))
    got = thg.hashgrid_encode(torch.tensor(table), torch.tensor(x), ts,
                              bound=1.0).numpy()
    assert got.shape == ref.shape == (x.shape[0], js.output_dim)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    oob = np.any(np.abs(x) > 1.0, axis=-1)
    assert oob.any() and (got[oob] == 0).all()


def _table_grads(js, ts, table, x, cot):
    def loss(t):
        return jnp.sum(jhg.hashgrid_encode(t, jnp.asarray(x), js) * cot)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    tt = torch.tensor(table, requires_grad=True)
    (thg.hashgrid_encode(tt, torch.tensor(x), ts)
     * torch.tensor(cot)).sum().backward()
    return tt.grad.numpy(), ref


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("grid", ["hashed", "dense"])
def test_table_gradient(grid, pallas, monkeypatch):
    """Against jax.grad through hashgrid_encode; with pallas the JAX side
    routes its backward through the Pallas scatter kernel in interpret
    mode (LAENERF_FORCE_PALLAS_SCATTER=1)."""
    if pallas:
        monkeypatch.setenv("LAENERF_FORCE_PALLAS_SCATTER", "1")
    js, ts = _spec_pair(grid, "bf16")
    table, x, cot = _inputs(js, 1)
    got, ref = _table_grads(js, ts, table, x, cot)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max() / scale
    assert err < 1.5e-2, f"relative table-gradient error {err:.3e}"
    # the gradient lands on the same entries (an entry may still cancel to
    # exactly zero on one side only, through the different bf16 roundings)
    assert np.mean((got != 0) != (ref != 0)) < 1e-3


def test_gather_table_hoist_and_x_grad_guard():
    js, ts = _spec_pair("hashed", "bf16")
    table, x, _ = _inputs(js, 2)
    t = torch.tensor(table)
    a = thg.hashgrid_encode(t, torch.tensor(x), ts)
    b = thg.hashgrid_encode(t, torch.tensor(x), ts,
                            gather_table=t.to(torch.bfloat16))
    assert torch.equal(a, b)
    # the gradient to x against jax.grad (1e-5 of its largest magnitude)
    # on the octo bf16 path and the generic linear and smoothstep ones;
    # points outside the bound get 0, and the table gradient (K1's input)
    # is the same whether or not x asks for one
    rng = np.random.RandomState(3)
    cot = rng.randn(*a.shape).astype(np.float32)
    oob = np.any(np.abs(x) > 1.0, axis=-1)
    assert oob.any() and not oob.all()
    for jspec, tspec in [(js, ts)] + [
            tuple(dataclasses.replace(s, octo_gather=False,
                                      interpolation=interp)
                  for s in (js, ts))
            for interp in ("linear", "smoothstep")]:
        ref = np.asarray(jax.grad(lambda p: jnp.sum(jhg.hashgrid_encode(
            jnp.asarray(table), p, jspec) * cot))(jnp.asarray(x)))
        xt = torch.tensor(x, requires_grad=True)
        tables = [torch.tensor(table, requires_grad=True) for _ in range(2)]
        for tt, xx in zip(tables, (xt, torch.tensor(x))):
            (thg.hashgrid_encode(tt, xx, tspec) * torch.tensor(cot)).sum() \
                .backward()
        got = xt.grad.numpy()
        scale = np.abs(ref).max()
        assert scale > 0
        err = np.abs(got - ref).max() / scale
        assert err < 1e-5, (tspec.octo_gather, tspec.interpolation, err)
        assert not np.any(got[oob]) and not np.any(ref[oob])
        assert torch.equal(tables[0].grad, tables[1].grad)
    # without the octo layout a 3-D spec takes the generic path, as in JAX
    # (tests/test_torch_background.py holds it against JAX in full)
    got = thg.hashgrid_encode(t, torch.tensor(x),
                              dataclasses.replace(ts, octo_gather=False))
    ref = jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(x),
                              dataclasses.replace(js, octo_gather=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
