"""The share of the traced window in which no kernel or copy ran on any
stream of the device (the union of their spans)."""


def read(rec):
    if rec.trace is None or not rec.trace["window_s"]:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
