"""Host milliseconds of a `NeRFDataset.get_batch` call, the harness's own
call in the feed, averaged over the traced run's window (host clock)."""

from nerfbench.readers import span_ms


def read(rec):
    return span_ms(rec, "batch")
