"""Profiling hooks: the program's span recorder and a ``torch.profiler``
exporter.

Counterpart of the JAX package's ``utils/profiling.py``. The reference
has only ad-hoc wall-clock meters (reference train.py:344-345,
run_webcam.py:51-56).

**Spans.** ``with span("dispatch", batch=7): ...`` marks a phase of the
program. While the recorder is on (:func:`enable`) each span is kept in
memory as a :class:`Span`: its name, the batch it belongs to (given, or
its parent's), its own index and its parent's (a stack per thread), the
thread, and its start and end by ``time.perf_counter_ns()``, the clock
of ``time.perf_counter``, so a caller's readings of that clock place the
spans on its own timeline. The buffer is bounded: when full it drops the
oldest span and counts it. :func:`spans` reads and clears it.

Off is the default, and costs one flag check: :func:`span` then returns
one shared no-op context manager, allocating nothing, taking no lock and
reading no clock. Spans mark phases, not layers: a few a batch.

**Exporter.** :func:`trace` writes a Chrome trace of a block; while it is
active the recorder is on and every span is also a
``torch.profiler.record_function`` of the same name, so the trace shows
the program's phases beside the device's work. Where :func:`trace`
turned the recorder on, it turns it off after and clears what it
recorded.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

__all__ = ["CAPACITY", "Span", "disable", "enable", "span", "spans", "trace"]

#: spans kept before the oldest is dropped (a 51 s video window at ~60
#: batches a second records ~25,000)
CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    batch: Optional[int]
    index: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int


_on = False
#: ``torch.profiler.record_function`` while :func:`trace` is active
_record_function = None
_buffer: "collections.deque" = collections.deque(maxlen=CAPACITY)
_dropped = 0
_lock = threading.Lock()
_index = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "batch", "index", "parent", "start", "_stack",
                 "_function")

    def __init__(self, name: str, batch: Optional[int]):
        self.name, self.batch = name, batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._stack = stack
        self.parent = None
        if stack:
            self.parent, batch = stack[-1]
            if self.batch is None:
                self.batch = batch
        self.index = next(_index)
        stack.append((self.index, self.batch))
        self._function = None
        if _record_function is not None:
            self._function = _record_function(self.name)
            self._function.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._function is not None:
            self._function.__exit__(*exc)
        self._stack.pop()
        record = Span(self.name, self.batch, self.index, self.parent,
                      threading.get_ident(), self.start, end)
        global _dropped
        with _lock:
            if len(_buffer) == _buffer.maxlen:
                _dropped += 1
            _buffer.append(record)
        return False


def span(name: str, batch: Optional[int] = None):
    """A context manager marking the phase ``name`` of batch ``batch``
    (by default its parent's): recorded while the recorder is on, the
    shared no-op otherwise."""
    if not _on:
        return _OFF
    return _Recording(name, batch)


def enable() -> None:
    """Start recording spans."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`spans`."""
    global _on
    _on = False


def spans() -> Tuple[List[Span], int]:
    """The spans recorded since the last call, in the order they ended,
    and how many were dropped from the full buffer meanwhile; clears
    both."""
    global _dropped
    with _lock:
        out, dropped = list(_buffer), _dropped
        _buffer.clear()
        _dropped = 0
    return out, dropped


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a host (and, with a card, CUDA) profile of the block as a
    Chrome trace under ``log_dir`` (``*.pt.trace.json``, which
    TensorBoard's profiler plugin reads), the program's spans among its
    events. No-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, record_function, tensorboard_trace_handler)

    global _record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = _on
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        _record_function = record_function
        enable()
        try:
            yield
        finally:
            _record_function = None
            if not was_on:
                # the spans went to the trace; a later reader of
                # :func:`spans` sees none of them
                disable()
                spans()
