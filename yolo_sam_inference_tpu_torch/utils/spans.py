"""Named spans at the layer boundaries of the engine's batch stream.

    from yolo_sam_inference_tpu_torch.utils import spans

    with spans.recording() as rec:
        handle = pipe._dispatch_batch(frames)
        out = pipe._fetch_outputs(handle)
    for s in rec.spans:
        print(s.name, s.parent, s.batch, s.ms)

``span(name)`` marks a block of the program. With no recording active it
returns one shared object that does nothing: a module-level check, no
allocation, no torch call, no clock read. Only :func:`recording` turns
spans on, for the block it wraps. While it is on, each span keeps its name,
its parent (the span open on the same thread when it began), its batch id,
its thread and its start and end in memory, and also opens a profiler
range of the same name (``_RecordFunctionFast``: ``record_function`` with a
C-level entry and exit): where a profiler runs, the span lies on its
timeline and the device work launched inside it is linked to it by
correlation id. Start and end are read with ``time.time_ns()``, so both are
on the profiler's clock (Kineto reports events as unix-epoch nanoseconds:
the trace's start plus the event's offset), right after the range opens
and right before it closes. Nothing else runs between the profiler's stamp
and the span's: a thread descheduled there reads its stamp that much later
(with ``torch.profiler.record_function``'s Python-level entry and exit in
that gap, spans on a loaded host read 16-32 ms off their ranges).

A batch id (:func:`next_batch`) is given where a batch is dispatched and
passed to the span that opens the batch's fetch; a span given no batch id
takes its parent's.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from dataclasses import dataclass
from time import time_ns
from typing import Iterator, List, Optional

from torch._C._profiler import _RecordFunctionFast as record_function

_batches = itertools.count()


def next_batch() -> int:
    """A new batch id, unique in the process."""
    return next(_batches)


@dataclass(slots=True)
class Span:
    """One span as recorded: ``parent`` is the index of the enclosing span in
    :attr:`Recorder.spans` (None at the top), ``start_ns`` / ``end_ns``
    unix-epoch nanoseconds (``end_ns`` None while it is open)."""

    name: str
    parent: Optional[int]
    batch: Optional[int]
    thread: int
    start_ns: int
    end_ns: Optional[int] = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Recorder:
    """The spans of one :func:`recording` block, in the order they began."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()
_active: Optional[Recorder] = None


class _On:
    __slots__ = ("rec", "name", "batch", "range", "index")

    def __init__(self, rec: Recorder, name: str, batch: Optional[int]) -> None:
        self.rec, self.name, self.batch = rec, name, batch

    def __enter__(self) -> Span:
        rec, stack = self.rec, self.rec._stack()
        parent = stack[-1] if stack else None
        batch = self.batch
        if batch is None and parent is not None:
            batch = rec.spans[parent].batch
        self.range = record_function(self.name)
        self.range.__enter__()
        start = time_ns()
        s = Span(self.name, parent, batch, threading.get_native_id(), start)
        with rec._lock:
            self.index = len(rec.spans)
            rec.spans.append(s)
        stack.append(self.index)
        return s

    def __exit__(self, *exc) -> bool:
        self.rec._stack().pop()
        s, close = self.rec.spans[self.index], self.range.__exit__
        s.end_ns = time_ns()
        close(*exc)
        return False


def span(name: str, batch: Optional[int] = None):
    """A context manager marking a block as the span ``name`` (of the batch
    ``batch``, else its parent's); :data:`OFF` while nothing records."""
    if _active is None:
        return OFF
    return _On(_active, name, batch)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Records every span begun in the block, on every thread; yields the
    :class:`Recorder`. A recording inside another takes its spans alone."""
    global _active
    outer, _active = _active, Recorder()
    try:
        yield _active
    finally:
        _active = outer
