"""The 95th percentile, over every chunk due in the window, of the time
from its due time to the tick() or poll() return that hands out its
response; a chunk never answered counts as infinitely late."""

from benchmark.common import quantile


def read(rec):
    lat = rec.values.get("chunk_latency_s")
    if not lat:
        return None
    return 1e3 * quantile(lat, 0.95)
