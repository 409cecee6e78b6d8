"""Mean host milliseconds a batch of ``batched_nms`` in the detect stage
(``dispatch/detect/nms``, one span a call) in the steady stream under
``spans.recording()`` with no profiler (phase (S),
``cytobench/stream_spans.py``)."""


def read(rec):
    return rec.get("spans", {}).get("total_ms", {}).get("dispatch/detect/nms")
