"""Mean milliseconds a batch of the embed (SAM preprocess, ViT encoder, neck)
stage, from the engine's synchronised timings of
``process_batch_arrays(frames, timings)`` (``timings["sam_preprocess"]``) over
the synced batches after the window."""


def read(rec):
    t = rec.get("stages", {}).get("sam_preprocess")
    return sum(t) / len(t) * 1e3 if t else None
