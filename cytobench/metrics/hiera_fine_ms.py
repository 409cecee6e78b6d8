"""Mean milliseconds a batch of SAM 2's fine Hiera stages (the patch
embedding, the positions and stages 1-2), from the engine's synchronised
timings of ``process_batch_arrays(frames, timings)``
(``timings["hiera_fine"]``, inside ``embed``) over the synced batches after
the window; nothing where the program has no such span."""


def read(rec):
    t = rec.get("stages", {}).get("hiera_fine")
    return sum(t) / len(t) * 1e3 if t else None
