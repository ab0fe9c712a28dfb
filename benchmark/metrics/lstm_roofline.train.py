"""The LSTM stacks' least time (input products and recurrences, forward
and backward, at the valid rows) over the CUDA-event time of
``RNNT.enc_pred`` forward and backward at the microbatch's shapes."""


def read(rec):
    j = rec.values.get("lstm")
    if not j or not j["ms"]:
        return None
    return 100.0 * j["bound_ms"] / j["ms"]
