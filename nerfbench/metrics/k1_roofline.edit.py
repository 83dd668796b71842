"""K1's share of its roofline at the LAENeRF encoder's backward (C = 2),
counting each call's rows of valid (region) rays only; the profiled
stretch runs each view once."""

from nerfbench.readers import k1_roofline as read  # noqa: F401
