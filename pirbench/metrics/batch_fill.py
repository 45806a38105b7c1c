"""batch_fill: the share of the bucket slots the servers answered that
carried a lookup (the rest is padding up to the bucket), from the
pipeline's counters over the window. Front and scheduler
(``serve/frontend.py``, ``serve/scheduler.py``)."""


def read(ctx):
    c = ctx.counters
    sent = c["queries"] - c["cache_hits"]
    slots = sent + c["padded"]
    if slots <= 0:
        return None
    return 100.0 * sent / slots
