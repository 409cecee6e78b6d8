"""Mean host milliseconds a batch of the fetch's unpack (``fetch/unpack``: the
row pack's copy, ``np.unpackbits`` of the crops, the split into arrays) in
the steady stream under ``spans.recording()`` with no profiler (phase (S),
``cytobench/stream_spans.py``): host time in which nothing new is queued."""


def read(rec):
    return rec.get("spans", {}).get("total_ms", {}).get("fetch/unpack")
