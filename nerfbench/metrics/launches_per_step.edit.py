"""Device operations a LAENeRF step launches."""

from nerfbench.readers import launches_per_step as read  # noqa: F401
