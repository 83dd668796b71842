"""CLIP ViT-B/16 vision tower (counterpart of laenerf_tpu/models/clip_vit.py):
the frozen image encoder of CLIP guidance, differentiable with respect to
the image so -(image_z . text_z) backprops into the NeRF.

Architecture: 16x16 patch embedding -> 768, a class token, 197 learned
positions, pre-LN, 12 pre-norm blocks (12-head attention, 3,072-wide
quickGELU MLP), post-LN on the class token, a linear projection to the
512-dim joint space, L2-normalised. Matmuls are x @ w with w [in, out] and
the 12 blocks' weights stacked on a leading [LAYERS] axis, as in the JAX
package's pytree (convert.py::clip_params_from_jax maps it).

Weights: LAENERF_CLIP_NPZ, else ~/.cache/laenerf_tpu_weights/
clip_vitb16_vision.npz, in HuggingFace's CLIPVisionModel state-dict layout
(the JAX package's docstring has the one-time converter); without one a
seeded random init (a warning once; the gradient path works, the guidance
means nothing).
"""

import os
import warnings

import numpy as np
import torch
from torch import nn

from ..utils.images import resize_bilinear

IMAGE_SIZE = 224
PATCH = 16
WIDTH = 768
LAYERS = 12
HEADS = 12
MLP_DIM = 3072
EMBED_DIM = 512
N_TOKENS = (IMAGE_SIZE // PATCH) ** 2 + 1  # 197

# OpenAI CLIP preprocessing constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_WEIGHTS_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                            "laenerf_tpu_weights")
# the [LAYERS]-stacked block weights' per-layer shapes
_BLOCK_SHAPES = {
    "ln1_w": (WIDTH,), "ln1_b": (WIDTH,),
    "qkv_w": (WIDTH, 3 * WIDTH), "qkv_b": (3 * WIDTH,),
    "out_w": (WIDTH, WIDTH), "out_b": (WIDTH,),
    "ln2_w": (WIDTH,), "ln2_b": (WIDTH,),
    "fc1_w": (WIDTH, MLP_DIM), "fc1_b": (MLP_DIM,),
    "fc2_w": (MLP_DIM, WIDTH), "fc2_b": (WIDTH,),
}
_warned = False


class CLIPVision(nn.Module):
    """The tower's parameters, frozen (requires_grad False): `patch_w`
    [768, 768] (rows ordered (ph, pw, c)), `class_emb`, `pos_emb` [197,
    768], `ln_pre`/`ln_post` {w, b}, `blocks` {name: [12, ...]}, `proj`
    [768, 512]. Made empty; fill it with load_state_dict."""

    def __init__(self, *, device):
        super().__init__()

        def z(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.patch_w = z(PATCH * PATCH * 3, WIDTH)
        self.class_emb = z(WIDTH)
        self.pos_emb = z(N_TOKENS, WIDTH)
        self.ln_pre = nn.ParameterDict({"w": z(WIDTH), "b": z(WIDTH)})
        self.blocks = nn.ParameterDict({k: z(LAYERS, *s)
                                        for k, s in _BLOCK_SHAPES.items()})
        self.ln_post = nn.ParameterDict({"w": z(WIDTH), "b": z(WIDTH)})
        self.proj = z(WIDTH, EMBED_DIM)
        self.requires_grad_(False)

    def forward(self, images):
        return clip_vision_forward(self, images)


def clip_vision_init(seed: int = 0, *, device="cuda", generator=None):
    """A seeded random tower: normal draws at the JAX package's scales
    (0.02 patch and class, 0.01 positions, 1/sqrt(in) matmuls), unit
    layer-norm gains, zero biases."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    model = CLIPVision(device=device)
    s = 1.0 / np.sqrt(WIDTH)
    scales = {"patch_w": 0.02, "class_emb": 0.02, "pos_emb": 0.01,
              "blocks.qkv_w": s, "blocks.out_w": s, "blocks.fc1_w": s,
              "blocks.fc2_w": 1.0 / np.sqrt(MLP_DIM), "proj": s}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in scales:
                p.normal_(generator=generator).mul_(scales[name])
            elif name.endswith("w"):  # the layer norms' gains
                p.fill_(1.0)
    return model


def load_clip_vision(*, device="cuda"):
    """(model, pretrained): the npz named by LAENERF_CLIP_NPZ or the
    cached one when present, else the seeded random init (warns once)."""
    global _warned
    path = os.environ.get("LAENERF_CLIP_NPZ")
    if path is None:
        cand = os.path.join(_WEIGHTS_DIR, "clip_vitb16_vision.npz")
        path = cand if os.path.exists(cand) else None
    if path and os.path.exists(path):
        with np.load(path) as z:
            sd = _params_from_hf_npz({k: z[k] for k in z.files})
        model = CLIPVision(device=device)
        model.load_state_dict(sd)
        return model, True
    if not _warned:
        warnings.warn("No pretrained CLIP weights found; using random init "
                      "(guidance semantics meaningless). See "
                      "laenerf_tpu_torch/models/clip_vit.py.")
        _warned = True
    return clip_vision_init(device=device), False


def _params_from_hf_npz(sd):
    """HuggingFace CLIPVisionModel state-dict arrays (plus
    visual_projection.weight) -> the tower's state dict (CPU tensors).
    torch Linear weights are [out, in], so they are transposed; the conv
    weight [768, 3, 16, 16] becomes rows ordered (ph, pw, c)."""
    def g(k):
        return np.asarray(sd[k], np.float32)

    blocks = {k: [] for k in _BLOCK_SHAPES}
    for i in range(LAYERS):
        p = f"encoder.layers.{i}."
        blocks["ln1_w"].append(g(p + "layer_norm1.weight"))
        blocks["ln1_b"].append(g(p + "layer_norm1.bias"))
        blocks["qkv_w"].append(np.concatenate(
            [g(p + f"self_attn.{n}_proj.weight").T for n in "qkv"], axis=1))
        blocks["qkv_b"].append(np.concatenate(
            [g(p + f"self_attn.{n}_proj.bias") for n in "qkv"], axis=0))
        blocks["out_w"].append(g(p + "self_attn.out_proj.weight").T)
        blocks["out_b"].append(g(p + "self_attn.out_proj.bias"))
        blocks["ln2_w"].append(g(p + "layer_norm2.weight"))
        blocks["ln2_b"].append(g(p + "layer_norm2.bias"))
        blocks["fc1_w"].append(g(p + "mlp.fc1.weight").T)
        blocks["fc1_b"].append(g(p + "mlp.fc1.bias"))
        blocks["fc2_w"].append(g(p + "mlp.fc2.weight").T)
        blocks["fc2_b"].append(g(p + "mlp.fc2.bias"))
    pw = np.transpose(g("embeddings.patch_embedding.weight"),
                      (2, 3, 1, 0)).reshape(PATCH * PATCH * 3, WIDTH)
    arrays = {
        "patch_w": pw,
        "class_emb": g("embeddings.class_embedding").reshape(WIDTH),
        "pos_emb": g("embeddings.position_embedding.weight"),
        "ln_pre.w": g("pre_layrnorm.weight"),
        "ln_pre.b": g("pre_layrnorm.bias"),
        **{f"blocks.{k}": np.stack(v) for k, v in blocks.items()},
        "ln_post.w": g("post_layernorm.weight"),
        "ln_post.b": g("post_layernorm.bias"),
        "proj": g("visual_projection.weight").T,
    }
    return {k: torch.tensor(np.ascontiguousarray(v))
            for k, v in arrays.items()}


def _ln(x, w, b, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def clip_preprocess(images):
    """[B, H, W, 3] in [0, 1] -> resized to 224^2 (bilinear, as
    jax.image.resize) and CLIP-normalised [B, 224, 224, 3];
    differentiable."""
    x = resize_bilinear(images.permute(0, 3, 1, 2),
                        (IMAGE_SIZE, IMAGE_SIZE)).permute(0, 2, 3, 1)
    mean = torch.as_tensor(CLIP_MEAN, device=images.device)
    std = torch.as_tensor(CLIP_STD, device=images.device)
    return (x - mean) / std


def clip_vision_forward(model: CLIPVision, images):
    """L2-normalised [B, 512] embeddings of preprocessed [B, 224, 224, 3]
    images. Attention is two matmuls and a softmax per block."""
    B = images.shape[0]
    n = IMAGE_SIZE // PATCH
    hd = WIDTH // HEADS
    x = images.reshape(B, n, PATCH, n, PATCH, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, n * n, PATCH * PATCH * 3) @ model.patch_w
    cls = model.class_emb.expand(B, 1, WIDTH)
    x = torch.cat([cls, x], dim=1) + model.pos_emb[None]
    x = _ln(x, model.ln_pre["w"], model.ln_pre["b"])

    def heads(t):
        return t.reshape(B, -1, HEADS, hd).transpose(1, 2)

    blk = model.blocks
    for i in range(LAYERS):
        h = _ln(x, blk["ln1_w"][i], blk["ln1_b"][i])
        q, k, v = (h @ blk["qkv_w"][i] + blk["qkv_b"][i]).split(WIDTH, dim=-1)
        q, k, v = heads(q), heads(k), heads(v)
        att = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(hd), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(B, -1, WIDTH)
        x = x + o @ blk["out_w"][i] + blk["out_b"][i]
        h = _ln(x, blk["ln2_w"][i], blk["ln2_b"][i])
        h = _quick_gelu(h @ blk["fc1_w"][i] + blk["fc1_b"][i])
        x = x + h @ blk["fc2_w"][i] + blk["fc2_b"][i]
    cls_out = _ln(x[:, 0], model.ln_post["w"], model.ln_post["b"])
    z = cls_out @ model.proj
    return z / torch.linalg.norm(z, dim=-1, keepdim=True)


def clip_similarity_loss(model: CLIPVision, images, text_z):
    """-(image_z . text_z), averaged over the batch, for renders [B, H, W,
    3] in [0, 1] and a text embedding [512] or [B, 512] (normalised
    here)."""
    z = clip_vision_forward(model, clip_preprocess(images))
    t = text_z / torch.linalg.norm(text_z, dim=-1, keepdim=True)
    return -torch.mean(torch.sum(z * (t[None] if t.dim() == 1 else t),
                                 dim=-1))
