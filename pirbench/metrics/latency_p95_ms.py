"""latency_p95_ms: the 95th percentile of a lookup's time from its
scheduled arrival to its record, by the host's clock, in a traced window
(the profiler's cost included), a lookup that did not come back counting
at infinite latency. The entry (``AsyncFrontend.submit`` to its future).
Read only in an open loop, where a lookup has a scheduled arrival."""

from pirbench.harness import percentile


def read(ctx):
    lat = getattr(ctx, "latencies", None)
    if not lat:
        return None
    return 1e3 * percentile(lat, 95)
