"""Mean milliseconds a batch of the segment (prompts, decoder, window crop, mask head, resample)
stage, from the engine's synchronised timings of
``process_batch_arrays(frames, timings)`` (``timings["sam_inference_total"]``) over
the synced batches after the window."""


def read(rec):
    t = rec.get("stages", {}).get("sam_inference_total")
    return sum(t) / len(t) * 1e3 if t else None
