"""Mean milliseconds a batch of SAM 2's mask head (every prompt's whole
upscaling with the high-resolution levels, the stability choice over token
0's whole low-res mask, the chosen mask on the prompt's window and the crop's
samples), from the engine's synchronised timings of
``process_batch_arrays(frames, timings)`` (``timings["sam2_head"]``, inside
``segment``) over the synced batches after the window; nothing where the
program has no such span."""


def read(rec):
    t = rec.get("stages", {}).get("sam2_head")
    return sum(t) / len(t) * 1e3 if t else None
