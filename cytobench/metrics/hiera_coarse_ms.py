"""Mean milliseconds a batch of SAM 2's coarse Hiera stages (stages 3-4, the
FPN neck and the decoder's high-resolution convs ``conv_s0`` / ``conv_s1``),
from the engine's synchronised timings of ``process_batch_arrays(frames,
timings)`` (``timings["hiera_coarse"]``, inside ``embed``) over the synced
batches after the window; nothing where the program has no such span."""


def read(rec):
    t = rec.get("stages", {}).get("hiera_coarse")
    return sum(t) / len(t) * 1e3 if t else None
