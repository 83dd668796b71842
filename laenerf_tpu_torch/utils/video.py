"""Video writing (counterpart of laenerf_tpu/utils/video.py): an mp4
through imageio where it imports and can write one, else the frames as
<path without extension>_frames/%04d.png through Pillow."""

import os

from .images import write_png


def write_video(path, frames, fps=24):
    """frames: uint8 [H, W, 3] arrays. Returns the path written (the mp4 or
    the frames' directory)."""
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames, fps=fps)
        return path
    except Exception:
        out_dir = os.path.splitext(path)[0] + "_frames"
        os.makedirs(out_dir, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(os.path.join(out_dir, f"{i:04d}.png"), f)
        return out_dir
