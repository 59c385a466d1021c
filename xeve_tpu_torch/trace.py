"""In-memory spans of the encoder's frame pipeline; off unless started.

    from xeve_tpu_torch import trace
    trace.start()
    for bs, rec, poc in enc.encode_stream(frames):
        ...
    records = trace.stop()

start() clears the record and turns recording on; stop() turns it off and
returns one dict per span that closed while it was on, in the order the
spans opened:

  name    "frame.task", "native.ccall", "device_analyzer.collect", ...
  thread  the name of the thread that ran it ("MainThread", "xt-frame_0",
          "xt-dispatch_0", ...)
  t0, t1  its start and end, time.perf_counter() seconds
  cpu     CPU seconds of that thread inside it (time.thread_time())
  id      its number; numbers rise in the order spans open
  parent  id of the innermost span open on the same thread when it
          opened, or None
  attrs   its attributes; `poc`, the frame's display index, ties together
          the spans of one frame across threads

While off (the default) span() returns one shared object that does
nothing: it reads no clock, takes no lock and keeps nothing.
"""
from __future__ import annotations

import itertools
import threading
import time

_lock = threading.Lock()
_local = threading.local()
_on = False
_gen = 0                # which start() the open spans belong to
_records: list = []
_ids = itertools.count()


class _Off:
    """What span() returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "gen", "id", "parent", "t0", "c0")

    def __init__(self, name, attrs, gen):
        self.name, self.attrs, self.gen = name, attrs, gen

    def set(self, **attrs):
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.c0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        cpu = time.thread_time() - self.c0
        _local.stack.pop()
        rec = {"name": self.name,
               "thread": threading.current_thread().name,
               "t0": self.t0, "t1": t1, "cpu": cpu, "id": self.id,
               "parent": self.parent, "attrs": self.attrs}
        with _lock:
            if _on and _gen == self.gen:
                _records.append(rec)
        return False


def span(name: str, **attrs):
    """A context manager that records one interval of the calling thread
    while the recorder is on; OFF while it is off."""
    if not _on:
        return OFF
    return _Span(name, attrs, _gen)


def now():
    """The spans' clock (time.perf_counter()) while recording; None while
    off, without reading it."""
    return time.perf_counter() if _on else None


def attr(key: str):
    """`key` of the innermost span open on this thread that has it; None
    while off."""
    if not _on:
        return None
    for sp in reversed(getattr(_local, "stack", ())):
        if key in sp.attrs:
            return sp.attrs[key]
    return None


def start():
    """Clear the record and turn recording on."""
    global _on, _gen, _records
    with _lock:
        _records = []
        _gen += 1
        _on = True


def stop() -> list:
    """Turn recording off; returns the records kept since start()."""
    global _on, _records
    with _lock:
        _on = False
        out, _records = _records, []
    return sorted(out, key=lambda r: r["id"])
