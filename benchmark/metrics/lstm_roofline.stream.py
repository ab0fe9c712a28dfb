"""K1 at the tick's shapes - T=2 for the pre-stack layers, T=1 for the
post-stack ones - at the cell's lanes: the layers' recurrence bounds
(``recurrence_bound_ms``) over their CUDA-event times."""


def read(rec):
    k = rec.values.get("k1")
    if not k or not k["ms"]:
        return None
    return 100.0 * k["bound_ms"] / k["ms"]
