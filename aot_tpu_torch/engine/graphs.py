"""CUDA graphs of a fixed-shape piece of the serving step: the image
encoder's kernels replayed by one graph launch (VOSEngine.encode_image).

`GraphCache` keeps one captured graph a key, at most MAX_GRAPHS of them,
dropping the least recently used. A call with a key replays that key's
graph: it copies the input into the graph's static input, replays, and
returns the graph's static outputs. A call with no key (the caller found
the call ineligible) runs the function eagerly. Each call counts one of
`<name>.replay`, `<name>.capture` and `<name>.eager`.

What a capture counts (`utils.tracing`: a kernel wrapper's
`launch.<kernel>`, a route's `attn.*`) launches nothing; it is kept apart
and added at every replay, and the warm-up's counts are dropped, so the
counters read as under eager: one call's counts a call.

`CudaCapture` records a function into a `torch.cuda.CUDAGraph`: one warm-up
call first, so that cuDNN's autotuning, the lazily made constants and the
kernels' one-time attribute setting all happen outside the capture, then
the capture on a side stream into the cache's one memory pool. Every graph of a cache shares that pool, so a graph's replay may
reuse memory another graph's outputs lie in: the outputs returned stay
valid until the cache's next call, whatever its key.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Hashable, Optional

import torch

from aot_tpu_torch.utils import tracing

MAX_GRAPHS = 4      # graphs a cache keeps (input shapes of one engine)


@dataclasses.dataclass
class Captured:
    graph: object                # .replay() launches the captured work
    static_in: torch.Tensor      # the input the graph reads
    outputs: object              # what the captured call returned
    counts: Dict[str, float]     # the counts its capture made


class GraphCache:
    """One graph a key, captured by `capture(fn, x) -> (graph, static
    input, outputs, the captured call's counts)` at the key's first call
    and replayed after; `capture.reserved_bytes()`, read after each
    capture, gives the growth counted under `<name>.pool_bytes`."""

    def __init__(self, name: str, capture=None):
        self.name = name
        self._capture = capture if capture is not None else CudaCapture()
        self._reserved = 0
        self._graphs: "collections.OrderedDict[Hashable, Captured]" = (
            collections.OrderedDict())

    def keys(self):
        """The keys held, the least recently used first."""
        return list(self._graphs)

    def run(self, key: Optional[Hashable], x: torch.Tensor,
            fn: Callable[[torch.Tensor], object]):
        """fn(x)'s outputs: from key's graph, captured first if the cache
        holds none; eagerly where key is None or the cache keeps no
        graph."""
        if key is None or MAX_GRAPHS < 1:
            tracing.count(self.name + ".eager")
            return fn(x)
        entry = self._graphs.get(key)
        if entry is None:
            while len(self._graphs) >= MAX_GRAPHS:
                self._graphs.popitem(last=False)
            with tracing.counted_apart():         # the warm-up's
                entry = Captured(*self._capture(fn, x))
            self._graphs[key] = entry
            tracing.count(self.name + ".capture")
            reserved = self._capture.reserved_bytes()
            tracing.count(self.name + ".pool_bytes", reserved - self._reserved)
            self._reserved = reserved
        else:
            self._graphs.move_to_end(key)
            entry.static_in.copy_(x)
            tracing.count(self.name + ".replay")
        entry.graph.replay()
        tracing.count_all(entry.counts)
        return entry.outputs


class CudaCapture:
    """Captures into one memory pool (`torch.cuda.graph_pool_handle()`),
    on one side stream a device."""

    def __init__(self):
        self.pool = None
        self.streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def __call__(self, fn: Callable[[torch.Tensor], object],
                 x: torch.Tensor):
        """fn captured into a CUDA graph over a static copy of x: warmed up
        once on the current stream, then captured on the side stream into
        the pool. Returns (graph, static input, outputs, what the captured
        call counted); nothing has run in the graph yet. The static input
        is a normal tensor, so that a later call may copy into it with or
        without inference mode.

        cuBLAS keeps a workspace for each stream it runs on (32 MiB on an
        H100), allocated at its first use there: the capture allocates the
        side stream's in the pool, and once it has ended the workspaces are
        let go, so that the one the graph holds lies in the pool's free
        memory, which the graphs alone reuse, and the allocator does not
        keep a second one live beside the current stream's."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        stream = self.streams.get(x.device)
        if stream is None:
            stream = self.streams[x.device] = torch.cuda.Stream(x.device)
        with torch.inference_mode(False):
            static_in = x.clone()
        fn(static_in)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=stream):
            with tracing.counted_apart() as counts:
                outputs = fn(static_in)
        torch._C._cuda_clearCublasWorkspaces()
        return graph, static_in, outputs, dict(counts)

    def reserved_bytes(self) -> int:
        """The bytes the allocator holds in segments of the pool."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
