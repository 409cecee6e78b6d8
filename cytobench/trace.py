"""Reading a ``torch.profiler`` window of the stream: the device's busy time
as the union of kernel intervals, the kernels that took the most time, the
longest idle gaps named by what the host was doing meanwhile, and the
device time of the SAM image encoder's kernels.

The window is the CPU range that the harness marks with :data:`WINDOW`;
the host's own phases are marked ``dispatch`` and ``fetch``, and each call
of the encoder module (the engine's ``sam.vision``, whose class the model
family names) :data:`ENCODER` (:func:`mark_encoder`). The profiler also
puts these marks on the device's timeline; they are no device work.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Tuple

WINDOW = "cytobench.window"
PHASES = ("dispatch", "fetch")
ENCODER = "cytobench.encoder"
RUNTIME = re.compile(r"cu(da)?[A-Z]")  # the CUDA runtime's and driver's calls


@contextlib.contextmanager
def mark_encoder(images: List[int], encoder_class: str):
    """Marks every forward of a module of class ``encoder_class`` with a
    :data:`ENCODER` range while the block runs, and appends each call's
    batch to ``images``. Module hooks from outside the program: it is not
    edited."""
    from torch.autograd.profiler import record_function
    from torch.nn.modules import module

    open_: List = []

    def pre(mod, args):
        if type(mod).__name__ == encoder_class:
            images.append(int(args[0].shape[0]))
            rf = record_function(ENCODER)
            rf.__enter__()
            open_.append(rf)

    def post(mod, args, out):
        if type(mod).__name__ == encoder_class and open_:
            open_.pop().__exit__(None, None, None)

    hooks = [module.register_module_forward_pre_hook(pre),
             module.register_module_forward_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(events) -> Dict:
    """{"window_s", "busy_s", "device_ops", "idle_gaps"} of a profiler's
    events, or {} where the profiler saw no window or no kernel in it."""
    from torch.autograd import DeviceType

    win = [e.time_range for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not win:
        return {}
    w0, w1 = win[0].start, win[0].end
    marks = (WINDOW, ENCODER) + PHASES
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in marks
              and not getattr(e, "is_user_annotation", False)]
    kern = [(max(e.time_range.start, w0), min(e.time_range.end, w1), e.name) for e in device
            if e.time_range.end > w0 and e.time_range.start < w1]
    if not kern:
        return {}
    merged = _merge([(s, e) for s, e, _ in kern])
    by_name: Dict[str, float] = {}
    for s, e, n in kern:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    cpu = [e for e in events if e.device_type == DeviceType.CPU and e.name != WINDOW]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((e - s, (s + e) / 2) for s, e in zip(edges[0::2], edges[1::2]) if e > s),
                  key=lambda g: -g[0])[:10]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(e - s for s, e in merged) / 1e6,
        "device_ops": [[n, t / 1e6] for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:10]],
        "idle_gaps": [[_doing(cpu, mid), d / 1e6] for d, mid in gaps],
        "encoder_s": _encoder_s(cpu, device),
    }


def _encoder_s(cpu, device) -> List[float]:
    """For each :data:`ENCODER` range, in order, the union of the intervals
    of the device work it launched, in seconds. A kernel, copy or memset
    belongs to the range that holds the runtime call that launched it: the
    profiler gives both the same correlation id."""
    out: List[float] = []
    for r in sorted((e for e in cpu if e.name == ENCODER), key=lambda e: e.time_range.start):
        a, b = r.time_range.start, r.time_range.end
        launches = {e.id for e in cpu if e.thread == r.thread and RUNTIME.match(e.name)
                    and a <= e.time_range.start and e.time_range.end <= b}
        mine = [(e.time_range.start, e.time_range.end) for e in device if e.id in launches]
        out.append(sum(e - s for s, e in _merge(mine)) / 1e6)
    return out


def _doing(cpu, t: float) -> str:
    """What the host ran at time t: its phase and its innermost call."""
    live = [e for e in cpu if e.time_range.start <= t <= e.time_range.end]
    phase = next((e.name for e in live if e.name in PHASES), "between batches")
    inner = [e for e in live if e.name not in PHASES]
    if not inner:
        return phase
    leaf = min(inner, key=lambda e: e.time_range.end - e.time_range.start)
    return f"{phase}: {leaf.name}"
