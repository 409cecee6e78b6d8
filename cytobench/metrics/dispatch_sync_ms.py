"""Host milliseconds a batch inside the blocking calls that ``dispatch_syncs``
counts, in a profiled window of the stream (phase (B),
``cytobench/stream_spans.py``). A lower bound: the profiler slows the host,
so the card is further ahead when the host reaches each call than it is
with the profiler off."""


def read(rec):
    return rec.get("span_trace", {}).get("sync_ms")
