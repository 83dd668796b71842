"""Device operations a style step launches."""

from nerfbench.readers import launches_per_step as read  # noqa: F401
