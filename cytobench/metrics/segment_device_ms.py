"""Device milliseconds a batch of the segment stage in the stream: for each
``segment`` span inside ``dispatch`` in a profiled window under
``spans.recording()`` (phase (B), ``cytobench/stream_spans.py``), the union
of the intervals of the kernels, copies and memsets its runtime calls
launched (matched by correlation id)."""


def read(rec):
    return rec.get("span_trace", {}).get("stage_device_ms", {}).get("segment")
