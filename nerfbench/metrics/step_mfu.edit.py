"""A LAENeRF step's share of the card's roofline (counts.laenerf_step over
the views' mean valid rows)."""

from nerfbench.readers import step_mfu as read  # noqa: F401
