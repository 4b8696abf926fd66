"""Seconds of audio enhanced by every call completed in the window, over the
window's wall time (it ends on a device synchronisation)."""


def read(run):
    if run.audio_s is None or run.window_s <= 0:
        return None
    return run.audio_s / run.window_s
