"""Tests of the port's CUDA kernels against their plain PyTorch versions, on
the card. They skip without an NVIDIA GPU: a CUDA kernel has no CPU mode.

This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: relative 1e-5 of the max (f32 atomics sum in another order on
every run).
"""

import numpy as np
import pytest
import torch

from laenerf_tpu_torch.ops.hashgrid import HashGridSpec, hashgrid_encode
from laenerf_tpu_torch.ops.scatter_add import (scatter_add_rows,
                                               scatter_add_rows_plain)

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
