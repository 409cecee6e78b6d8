"""The SAM encoder's share of its roofline, in %: its least time over the
device time of its kernels in the traced window of the stream. The least
time sums, over the patch embedding, each layer and the neck, the longer
of its operations at 989 TFLOP/s and its bytes at 3.35 TB/s
(``cytobench/flops.py``), so it reads the same work whatever kernel does
it; the device time is, for each call of the encoder module, the union of
the intervals of the kernels it launched (``cytobench/trace.py``), so
neither SAM's preprocessing nor the host's gaps between launches count."""

from cytobench.flops import encoder_least_s


def read(rec):
    busy = rec.get("profile", {}).get("encoder_s")
    images = rec.get("encoder_images", [])
    if not busy or len(busy) != len(images) or min(busy) <= 0:
        return None
    least = sum(encoder_least_s(rec["config"], n) for n in images)
    return 100.0 * least / sum(busy)
