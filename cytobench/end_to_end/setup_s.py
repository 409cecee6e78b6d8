"""Seconds from the process's start to the window's: imports, frames and
weights made, the pipeline built, every kernel loaded or built, and the
cell's shapes warmed up (host clock)."""


def read(rec):
    return rec["setup_s"]
