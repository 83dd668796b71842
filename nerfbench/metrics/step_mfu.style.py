"""A style step's share of the card's roofline (counts_vgg.style_step
over the views' mean valid rows: the recolor step's work, VGG's
operations at the float32 rate and the crop terms' bytes)."""

from nerfbench.readers import step_mfu as read  # noqa: F401
