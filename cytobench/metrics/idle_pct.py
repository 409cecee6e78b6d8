"""The card's idle share of a short ``torch.profiler`` window of the
steady stream, in %: 1 - (the union of kernel intervals) / (the window)."""


def read(rec):
    p = rec.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
