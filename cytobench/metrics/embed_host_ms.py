"""Mean host milliseconds a batch of the embed stage's span inside
``dispatch`` (``dispatch/embed``) in the steady stream under
``spans.recording()`` with no profiler (phase (S),
``cytobench/stream_spans.py``): the time the host spends launching the
stage, and waiting where the stage blocks on the card."""


def read(rec):
    return rec.get("spans", {}).get("total_ms", {}).get("dispatch/embed")
