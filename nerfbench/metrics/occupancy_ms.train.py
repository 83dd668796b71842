"""Milliseconds of an occupancy refresh (`train/trainer.py::occ_update`),
host clock synchronized with the card at both ends, averaged over the
refreshes of the traced run outside the profiled stretch."""

from nerfbench.readers import span_ms


def read(rec):
    return span_ms(rec, "occupancy")
