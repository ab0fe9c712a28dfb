"""Seconds of audio in the microbatches whose optimizer step finished in
the window, over the window (which ends at a synchronise)."""


def read(rec):
    if "audio_s" not in rec.values or not rec.window_s:
        return None
    return rec.values["audio_s"] / rec.window_s
