"""Percent of the profiled stretch of style steps in which no operation
ran on the card."""

from nerfbench.readers import device_idle as read  # noqa: F401
