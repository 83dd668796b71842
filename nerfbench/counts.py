"""Operations, bytes and least times computed from shapes, and the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit).

`bound_of` and the K1 byte count are frozen copies of `chip_smoke.py`'s
(`bound_of`, and the bytes that `k1_site` counts for a K1 call: its rows,
its indices and the whole float32 gradient table written once).

A step's least time is the larger of its operations over the peak each
runs at and its bytes over the memory rate. The operations: the MLPs'
products (forward, and twice that backward) at the bf16 tensor-core rate,
the encoder's interpolation and its backward rows and the march's events
at the float32 rate. The bytes are what the step's inputs need, each
counted once: the table rows the forward reads (at most the whole table),
the float32 gradient table written, Adam's read and write of parameters,
gradients and both moments (7 words a parameter), the EMA's (3 words a
parameter) where the step keeps one, and the batch read.
"""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12


def bound_of(n_bytes, n_ops=0, ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by) for n_bytes moved and n_ops done at ops_per_s
    (float32 outside the tensor cores by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_bytes(n_rows, C, table_rows, row_bytes=2):
    """Bytes of one K1 call: n_rows update rows of C channels (bf16: 2
    bytes each), their int32 indices, the [table_rows, C] float32 output
    written once."""
    return n_rows * C * row_bytes + n_rows * 4 + table_rows * C * 4


def mlp_flops(dims):
    """Multiply-adds of a bias-free MLP's forward, counted as 2 operations,
    per row."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def step_least_s(mlp_ops, f32_ops, n_bytes):
    """(least seconds, what bounds it) of a step."""
    t_ops = mlp_ops / BF16_TC_OPS_PER_S + f32_ops / F32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def grid_ops(n, L, C):
    """Forward interpolation plus backward rows of n samples: 8 corners of
    L levels, C channels, weights of 3 factors."""
    return n * L * 8 * (2 * C + 2 + C)


def nerf_step(c, n_rays, n_samples, n_events, n_params):
    """Least time of one NeRF train step: n_samples evaluated, n_events
    march events run for n_rays rays."""
    L, C = c["num_levels"], c["level_dim"]
    T = c["table_rows"]
    sigma = [L * C, c["hidden_dim"], 1 + c["geo_feat_dim"]]
    color = [c["sh_degree"] ** 2 + c["geo_feat_dim"], c["hidden_dim_color"],
             c["hidden_dim_color"], 3]
    mlp_ops = 3 * n_samples * (mlp_flops(sigma) + mlp_flops(color))
    f32_ops = grid_ops(n_samples, L, C) + 40 * n_rays * n_events
    n_bytes = (min(n_samples * L * 8, T) * C * 4 + T * C * 4
               + 10 * n_params * 4 + n_rays * 4 * 4)
    return step_least_s(mlp_ops, f32_ops, n_bytes)


def laenerf_step(c, n_rows, n_params, crop_pixels):
    """Least time of one LAENeRF step over n_rows padded rows."""
    L, C = c["num_levels"], c["level_dim"]
    T = c["table_rows"]
    K = c["num_palette_bases"]
    hidden = [c["hidden_dim"]] * (c["num_layers"] - 1)
    weight = [L * C] + hidden + [K]
    offset = [L * C + c["dir_degree"] ** 2] + hidden + [3]
    mlp_ops = 3 * n_rows * (mlp_flops(weight) + mlp_flops(offset))
    f32_ops = grid_ops(n_rows, L, C) + 3 * n_rows * (6 * K + 20)
    n_bytes = (min(n_rows * L * 8, T) * C * 4 + T * C * 4
               + 7 * n_params * 4 + n_rows * 40 + crop_pixels * 20)
    return step_least_s(mlp_ops, f32_ops, n_bytes)
