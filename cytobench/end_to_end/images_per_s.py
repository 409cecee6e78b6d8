"""Frames whose rows reached the host in the window, over the window's
seconds (first dispatch to last fetch, host clock)."""


def read(rec):
    w = rec["window"]
    return w["images"] / w["seconds"] if w["seconds"] > 0 else None
