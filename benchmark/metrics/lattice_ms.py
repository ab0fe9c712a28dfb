"""Host wall time of one microbatch's lattice (``rnnt_lattice``) forward
and backward at the step's edge-score shapes, ending in a synchronise;
the median of three."""


def read(rec):
    return rec.values.get("lattice_ms")
