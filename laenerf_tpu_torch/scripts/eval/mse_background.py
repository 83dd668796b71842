"""Background MSE: the edit-locality metric (the port's own copy of
scripts/eval/mse_background.py, with Pillow for the image files).

The counterpart of the reference's scripts/eval/mse_background_{llff,
mip360}.py (one script, --datatype selects the family): the MSE between
recolored renders and ground-truth test images *outside* the edit mask
(ICE-NeRF masks store the region in the G channel; the mask is inverted so
the background's error is measured). Masks live under scripts/eval/masks/
<datatype>/<scene>/ as in the reference, or under --masks_root.
"""

import argparse
import json
import os

import numpy as np
from PIL import Image

from ...utils.images import write_png


def _read(path):
    """An image file as an array, palette images expanded to RGB(A) as
    imageio reads them."""
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        return np.asarray(im)


def _load(path):
    if not os.path.exists(path) and os.path.exists(path + ".png"):
        path = path + ".png"  # blender-style file_path has no extension
    img = np.asarray(_read(path), np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    img = img / 255.0
    if img.shape[-1] == 4:
        # blender-style RGBA ground truth: composite over white, matching
        # how renders are produced (llff/mip360 data is plain RGB)
        img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
    return img[..., :3]


def _resize(img, h, w):
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.asarray(Image.fromarray(arr).resize((w, h),
                                                  Image.BILINEAR)) / 255.0


def evaluate(results_dir, scene, datatype="llff", save_dir=None,
             base_images=None, data_root="data", masks_root=None):
    with open(f"{data_root}/{datatype}/{scene}/transforms_test.json") as fp:
        transforms = json.load(fp)

    frames = transforms["frames"]
    if base_images is None:
        refs = [f"{data_root}/{datatype}/{scene}/{f['file_path']}"
                for f in frames]
    else:
        refs = [os.path.join(base_images, i)
                for i in sorted(os.listdir(base_images))]

    masks_root = masks_root or os.path.join(
        os.path.dirname(__file__), "masks", datatype, scene)
    masks = [os.path.join(masks_root, os.path.basename(f["file_path"]))
             for f in frames]
    # blender-style file_paths lack an extension; also accept sequentially
    # numbered masks as exported by the pipeline's eval phase
    fixed = []
    for k, m in enumerate(masks):
        if not os.path.exists(m):
            if os.path.exists(m + ".png"):
                m = m + ".png"
            elif os.path.exists(os.path.join(masks_root, f"{k:03d}.png")):
                m = os.path.join(masks_root, f"{k:03d}.png")
        fixed.append(m)
    masks = fixed
    outs = [os.path.join(results_dir, i)
            for i in sorted(os.listdir(results_dir))
            if i.lower().endswith((".png", ".jpg"))]

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)

    errors = []
    for k, (ref_p, out_p, mask_p) in enumerate(zip(refs, outs, masks)):
        ref = _load(ref_p)
        out = _load(out_p)
        if out.shape != ref.shape:
            out = _resize(out, ref.shape[0], ref.shape[1])
        mask = _load(mask_p)
        if mask.shape[:2] != ref.shape[:2]:
            mask = _resize(mask, ref.shape[0], ref.shape[1])
        # edit region in G channel -> background weight = 1 - normalized max
        m = mask.max(-1, keepdims=True)
        m = m / max(m.max(), 1e-8)
        bg = 1.0 - m
        err_img = np.square(out - ref) * bg
        errors.append(float(err_img.sum() / bg.sum() / 3))
        if save_dir:
            write_png(os.path.join(save_dir, f"error_{k:03d}.png"),
                      (np.clip(err_img, 0, 1) * 255).astype(np.uint8))

    errors = np.array(errors)
    result = {"errors": errors.tolist(), "mean": float(errors.mean())}
    if save_dir:
        with open(os.path.join(save_dir, "results.json"), "w") as fp:
            json.dump(result, fp, indent=2)
    print(json.dumps({"bg_mse_mean": result["mean"]}))
    return result


def main(argv=None):
    p = argparse.ArgumentParser(
        "laenerf_tpu_torch.scripts.eval.mse_background")
    p.add_argument("--scene", type=str, required=True)
    p.add_argument("--datatype", type=str, default="llff",
                   choices=["llff", "mip360"])
    p.add_argument("--results_dir", type=str, required=True)
    p.add_argument("--comparison_dir", type=str)
    p.add_argument("--save_dir", type=str)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--masks_root", type=str)
    a = p.parse_args(argv)
    evaluate(a.results_dir, a.scene, a.datatype, a.save_dir,
             a.comparison_dir, a.data_root, a.masks_root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
