"""Operations and bytes of LAENeRF's style step: VGG-19's convolutions to
the deepest style layer, forward and input gradient, and the step's least
time with them (counts.py's peaks).

A layout is the configuration's `vgg19_layout`: torchvision `features`
order, a number the output channels of a 3x3 convolution (followed by its
ReLU) and "M" a 2x2 max-pool.
"""

from . import counts


def layers(layout, max_layer):
    """(feature index, kind, output channels) up to max_layer, kind
    "conv", "relu" or "pool"."""
    out = []
    for item in layout:
        if item == "M":
            out.append(("pool", None))
        else:
            out += [("conv", item), ("relu", None)]
    return [(i, k, c) for i, (k, c) in enumerate(out) if i <= max_layer]


def stack_flops(layout, hw, max_layer, batch=1):
    """Operations of the forward's convolutions on a batch of [3, h, w]
    inputs: 2 a multiply-add, 9 taps a channel pair. The input gradient
    through a convolution costs as many again."""
    h, w = (int(v) for v in hw)
    cin, total = 3, 0
    for _, kind, cout in layers(layout, max_layer):
        if kind == "conv":
            total += 2 * 9 * cin * cout * h * w * batch
            cin = cout
        elif kind == "pool":
            h, w = h // 2, w // 2
    return total


def laenerf_parts(c, n_rows, n_params, crop_pixels):
    """counts.laenerf_step's (bf16 tensor-core operations, float32
    operations, bytes), which it returns only as a least time."""
    L, C = c["num_levels"], c["level_dim"]
    T = c["table_rows"]
    K = c["num_palette_bases"]
    hidden = [c["hidden_dim"]] * (c["num_layers"] - 1)
    weight = [L * C] + hidden + [K]
    offset = [L * C + c["dir_degree"] ** 2] + hidden + [3]
    mlp_ops = 3 * n_rows * (counts.mlp_flops(weight)
                            + counts.mlp_flops(offset))
    f32_ops = counts.grid_ops(n_rows, L, C) + 3 * n_rows * (6 * K + 20)
    n_bytes = (min(n_rows * L * 8, T) * C * 4 + T * C * 4
               + 7 * n_params * 4 + n_rows * 40 + crop_pixels * 20)
    return mlp_ops, f32_ops, n_bytes


def style_step(c, n_rows, n_params, crop_pixels):
    """(least seconds, what bounds it) of one style step past warm-up:
    the recolor step's work, the stack's forward and input gradient at
    the float32 rate (TF32 off), and the crop terms' bytes beyond the
    crop itself: the depth-guided TV's and the discontinuity's two edge
    maps (8 bytes a crop pixel) and the resized crop (12 bytes a pixel of
    it)."""
    mlp_ops, f32_ops, n_bytes = laenerf_parts(c, n_rows, n_params,
                                              crop_pixels)
    size = c["crop_size"]
    vgg = 2 * stack_flops(c["vgg19_layout"], (size, size),
                          max(c["style_layers"]))
    return counts.step_least_s(mlp_ops, f32_ops + vgg,
                               n_bytes + crop_pixels * 8 + size * size * 12)
