"""Blocking CUDA calls a batch inside ``dispatch`` but outside its
``slot_wait`` (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, each ``cudaMemcpy*`` that is not asynchronous, and
their ``cu*`` equivalents), in a profiled window of the stream under
``spans.recording()`` (phase (B), ``cytobench/stream_spans.py``)."""


def read(rec):
    return rec.get("span_trace", {}).get("syncs")
