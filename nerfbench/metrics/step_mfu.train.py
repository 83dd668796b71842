"""A NeRF train step's share of the card's roofline (counts.nerf_step over
the samples the traced steps evaluated)."""

from nerfbench.readers import step_mfu as read  # noqa: F401
