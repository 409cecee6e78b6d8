"""Mean host milliseconds of one ``_dispatch_batch`` call in the traced
run's stream window, with no profiler running: the upload staged and the
four stages launched (layer: batch stream)."""


def read(rec):
    d = rec["window"]["dispatch_s"]
    return sum(d) / len(d) * 1e3 if d else None
