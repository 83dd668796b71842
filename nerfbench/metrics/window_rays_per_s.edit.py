"""Valid (region) rays of every LAENeRF step in the traced window over the
window's seconds on the host clock: the rate a user waits on, which
follows the host's speed."""

from nerfbench.readers import window_rate as read  # noqa: F401
