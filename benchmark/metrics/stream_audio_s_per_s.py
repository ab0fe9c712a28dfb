"""Seconds of audio whose responses were handed out in the window, over
the window."""


def read(rec):
    if "answered_audio_s" not in rec.values or not rec.window_s:
        return None
    return rec.values["answered_audio_s"] / rec.window_s
