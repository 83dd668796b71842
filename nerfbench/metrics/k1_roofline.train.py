"""K1's share of its roofline at the NeRF backward: every row of a call
is a valid sample's, since the train path evaluates only those."""

from nerfbench.readers import k1_roofline as read  # noqa: F401
