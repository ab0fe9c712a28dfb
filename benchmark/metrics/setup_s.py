"""Set-up: from the process's start to the window's first timed work
(building or loading the kernels, weights and traffic, the warm-up, and the
steps or ticks before the window), host clock."""


def read(rec):
    return rec.setup_s or None
