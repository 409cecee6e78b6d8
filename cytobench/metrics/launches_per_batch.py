"""Kernels, copies and memsets launched inside ``dispatch`` a batch, counted
on the device's side of a profiled window of the stream under
``spans.recording()`` (phase (B), ``cytobench/stream_spans.py``): each device
event matched to a runtime call inside the range by correlation id."""


def read(rec):
    return rec.get("span_trace", {}).get("launches")
