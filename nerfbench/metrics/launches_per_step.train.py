"""Device operations a NeRF train step launches."""

from nerfbench.readers import launches_per_step as read  # noqa: F401
