"""Mean host milliseconds a batch that the fetch waits on its batch's copies
(``fetch/fetch_wait``) in the steady stream under ``spans.recording()`` with
no profiler (phase (S), ``cytobench/stream_spans.py``): near 0 where the
dispatch itself waits for the card, near the batch period less the
dispatch where the host only launches."""


def read(rec):
    return rec.get("spans", {}).get("total_ms", {}).get("fetch/fetch_wait")
