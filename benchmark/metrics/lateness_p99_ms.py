"""The 99th percentile over the window's ticks of the tick() return after
its grid slot (how far the host falls behind the 60 ms grid)."""

from benchmark.common import quantile


def read(rec):
    late = rec.values.get("lateness_s")
    if not late:
        return None
    return 1e3 * quantile(late, 0.99)
