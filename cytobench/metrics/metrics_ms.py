"""Mean milliseconds a batch of the metrics (the 16 morphometrics, hull support)
stage, from the engine's synchronised timings of
``process_batch_arrays(frames, timings)`` (``timings["metrics_total"]``) over
the synced batches after the window."""


def read(rec):
    t = rec.get("stages", {}).get("metrics_total")
    return sum(t) / len(t) * 1e3 if t else None
