"""The port's own spans and counters: what the serving step does, named by
stage, on the host's wall clock.

Spans mark the layer boundaries of a frame (`infer.step` and
`infer.add_reference_frame` are the roots; `encode`, with `window_attn`
under it for each Swin block's attention, `lstt`, `lstt.block<i>`,
`lt_read`, `st_read`, `decode`, `upsample_argmax`, `update_memory`,
`lt_write`, and `grow_lt` as a root of its own). They are
off by default: `span(name)` then returns a shared object whose `with`
does nothing, so a span costs one flag check. While on, each span appends
one record to an in-memory list; `take_spans` hands the records over and
clears it. A span never synchronizes, allocates on the device or launches
a kernel.

Counters always count: plain host-int adds under a name, read as a
snapshot by `counters`. The names in use:

  launch.<kernel>               calls of a CUDA kernel wrapper:
                                local_window_attn[_bf16],
                                flash_attn_fwd[_bf16], flash_attn_bwd[_bf16],
                                swin_window_attn
  attn.global.<route>           global reads by route: flash, dense
  attn.global.<route>.keys      the keys those reads covered (the live
                                length where it is a host int)
  attn.local.<route>            local reads by route: kernel, plain,
                                window
  attn.window.<route>           Swin blocks' window attention by route:
                                kernel, plain
  attn.window.<route>.windows   their windows times heads, padded windows
                                included
  engine.lt_write               writes of the long-term ring
  engine.lt_grow                grows of the long-term ring
  engine.lt_grow_bytes          the bytes those grows allocated
  encode.graph.replay           image encodes replayed from a CUDA graph
  encode.graph.capture          image encodes that captured one
  encode.graph.eager            image encodes run eagerly (ineligible, or
                                the engine keeps no graph); each encode
                                counts one of the three
  encode.graph.pool_bytes       the encoder graphs' memory pool's growth at
                                each capture (their sum: the pool's
                                reserved bytes)
  build.<source>                nvcc builds of csrc/<source>.cu
  build.<source>.s              their seconds
  load.<source>                 libraries loaded

A region's counts can be kept apart from the counters (`counted_apart`)
and added later (`count_all`): a CUDA graph's capture launches nothing,
so the engine keeps what its capture counted and adds it at each replay,
and the counters read as if every encode ran eagerly.

Both are process-wide, as a profiler is: the span flag is one flag for
every thread, and the stack of open spans is per thread (a checkpointed
training forward recomputes in autograd's threads).

The clock is `time.time_ns()`, the clock of torch.profiler's Chrome trace
(`baseTimeNanoseconds` + `ts`), so spans and the device's activity share
one timeline (`chrome_events`).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional

_ON = False
_SPANS: List[list] = []        # SpanRecord's fields, as lists
_LOCAL = threading.local()     # .stack: this thread's open spans; .thread
_FRAMES = [0]                  # the last frame id given to a root span
_COUNTS: Dict[str, float] = collections.defaultdict(int)


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]      # None while the span is open
    parent: int                # index of the enclosing span, -1 for a root
    thread: int                # threading.get_native_id() of its thread
    frame: int                 # the frame id of its root span


class _Span:
    __slots__ = ("name", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            stack, thread = _LOCAL.stack, _LOCAL.thread
        except AttributeError:
            stack = _LOCAL.stack = []
            thread = _LOCAL.thread = threading.get_native_id()
        if stack:
            parent = stack[-1]
            frame = _SPANS[parent][5]
        else:
            parent = -1
            _FRAMES[0] += 1
            frame = _FRAMES[0]
        self.index = len(_SPANS)
        _SPANS.append([self.name, time.time_ns(), None, parent, thread,
                       frame])
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        _SPANS[self.index][2] = time.time_ns()
        _LOCAL.stack.pop()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager marking one stage; records nothing while spans
    are off."""
    return _Span(name) if _ON else _OFF


def spans_on() -> bool:
    return _ON


def enable_spans(on: bool) -> bool:
    """Turn recording on or off; returns the previous setting, for
    restore."""
    global _ON
    prev, _ON = _ON, bool(on)
    return prev


def take_spans() -> List[SpanRecord]:
    """The records since the last take, in the order the spans opened
    (a record's `parent` indexes this list), and clear them. Take them
    between frames: a span still open is handed over with no end."""
    out = [SpanRecord(*r) for r in _SPANS]
    _SPANS.clear()
    return out


def count(name: str, n=1) -> None:
    _COUNTS[name] += n


def count_all(counts: Dict[str, float]) -> None:
    """Add every count of `counts` (a `counted_apart` result)."""
    for name, n in counts.items():
        _COUNTS[name] += n


@contextlib.contextmanager
def counted_apart():
    """Counts made inside the block go to the dict it yields and not to
    the counters (every thread's, while the block is open)."""
    global _COUNTS
    kept, apart = _COUNTS, collections.defaultdict(int)
    _COUNTS = apart
    try:
        yield apart
    finally:
        _COUNTS = kept


def counters() -> Dict[str, float]:
    """A snapshot of every counter that has counted."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


def self_ns(spans: List[SpanRecord]) -> List[int]:
    """Each closed span's duration less the time its children cover (the
    children of one span never overlap: they nest on one thread)."""
    own = [(s.end_ns - s.start_ns) if s.end_ns is not None else 0
           for s in spans]
    for s in spans:
        if s.parent >= 0 and s.end_ns is not None:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def chrome_events(spans: List[SpanRecord], base_ns: int,
                  pid: str = "program spans") -> List[dict]:
    """The closed spans as Chrome trace events on a process track of their
    own, `ts` in microseconds after `base_ns` (a torch.profiler trace's
    `baseTimeNanoseconds`)."""
    events = [{"ph": "M", "name": "process_name", "pid": pid,
               "args": {"name": pid}}]
    for i, s in enumerate(spans):
        if s.end_ns is None:
            continue
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"index": i, "parent": s.parent, "frame": s.frame}})
    return events
