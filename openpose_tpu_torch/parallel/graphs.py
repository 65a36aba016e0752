"""CUDA graphs of `PoseInference`'s fixed-shape device work.

A body (`PoseInference._net`, `_decode`) is written once as
``body(inputs, stage) -> outputs``, its device work inside ``with
stage(name)`` blocks.  Called eagerly, `stage` opens the tracer's span
`name`.  `GraphCache` keeps, per key (the body and the
inputs' shapes and dtypes), that body's graphs:

* the first call with a key runs eagerly; it is the warm-up that builds
  what the body builds on first use (cuBLAS and cuDNN handles and plans,
  the kernels' library, the cached resize matrices), none of which may
  first happen inside a capture.  A shape seen once never captures;
* the second call captures every stage as one graph, in order, into one
  memory pool (an output of one stage is the next one's input, with no
  copy), then replays them; every later call replays.

A replay copies the call's inputs into the graphs' static inputs, replays
each stage's graph inside its span, and returns clones of the static
outputs, since callers keep outputs across calls.  Copies and replays go
to the object's card's current stream, so they keep their order with the
caller's upload and fetch; one object's calls come from one thread at a
time.  Capture and replay set the object's card as the current device,
and a capture runs on a stream of that card: a graph of a card that is
not the current device (`cuda:1` beside a current `cuda:0`) would else be
captured on, and replayed to, the wrong card.

A graph reads the net's weights where they are, so an update in place (an
optimizer step, `load_state_dict`) shows in the next replay.

The kernel wrappers' launch counters (`paf_cuda`'s,
`conv_epilogue.bias_act`'s and `nms.nms`'s `launches`) count launches on
the device: a capture launches nothing, so it leaves them as they were,
and each replay adds what the capture's stages launched.
Counters (`utils/profiler.py::TRACE`): `pose.graph.captures`,
`pose.graph.replays` and `pose.graph.eager`, once per call of a body; a
capturing call counts a capture and a replay.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Sequence

import torch
from torch.overrides import TorchFunctionMode

from openpose_tpu_torch.ops import conv_epilogue, nms, paf_cuda
from openpose_tpu_torch.utils.profiler import TRACE

# the hand kernels' wrappers, whose launch counters a replay passes by
COUNTED = (paf_cuda.paf_scores_fused, paf_cuda.sample_bicubic_scales,
           conv_epilogue.bias_act, nms.nms)


def eager_stage(name):
    """The stage of an eager call: the tracer's span `name`."""
    return TRACE.span(name)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


class _Reads(TorchFunctionMode):
    """The tensors a capture reads that it did not make.  A graph reads
    them by address, so it must keep them alive: a resize matrix that its
    lru cache drops would else be freed, and its memory reused, under the
    graph."""

    def __init__(self):
        super().__init__()
        self.made = set()
        self.read: Dict[int, torch.Tensor] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in _tensors((args, kwargs)):
            if id(t) not in self.made:
                self.read[id(t)] = t
        self.made.update(id(t) for t in _tensors(out))
        return out


class _Graphed:
    """One key's graphs: the static inputs, one graph a stage of the body
    with its span's name, captured in order into one pool, the static
    outputs, and what the stages launched through the kernel wrappers."""

    def __init__(self, body: Callable, inputs: Sequence[torch.Tensor],
                 device: torch.device):
        self.device = device
        self.inputs = [torch.empty_like(t, device=device) for t in inputs]
        self.stages: List[tuple] = []
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)

        def stage(name):
            graph = torch.cuda.CUDAGraph()
            self.stages.append((name, graph))
            # thread-local: another thread's work on the card is no
            # business of this capture
            return torch.cuda.graph(graph, pool=pool, stream=stream,
                                    capture_error_mode="thread_local")

        before = [w.launches for w in COUNTED]
        with torch.cuda.device(device), _Reads() as reads:
            self.outputs = body(self.inputs, stage)
        self.keep = list(reads.read.values())
        self.launched = [w.launches - n for w, n in zip(COUNTED, before)]
        for wrapper, n in zip(COUNTED, before):
            wrapper.launches = n

    def replay(self, inputs: Sequence[torch.Tensor]):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t, non_blocking=True)
        with torch.cuda.device(self.device):
            for name, graph in self.stages:
                with eager_stage(name):
                    graph.replay()
        for wrapper, n in zip(COUNTED, self.launched):
            wrapper.launches += n
        return type(self.outputs)(t.clone() for t in self.outputs)


class GraphCache:
    """The graphs of one object's bodies, by key; at most `KEYS` keys
    (graphed or seen once), the least recently used out first."""

    KEYS = 8

    def __init__(self, device: torch.device):
        self.device = device
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def run(self, body: Callable, inputs: Sequence[torch.Tensor],
            engage: bool):
        """body(inputs, stage) -> a list or tuple of tensors; eager where
        `engage` is false (the caller's gate) or the key is new, else
        replayed."""
        if not engage:
            TRACE.count("pose.graph.eager")
            return body(inputs, eager_stage)
        # TF32 in the key: the heatmap path refuses to run with it on,
        # which an eager call checks and a replay would not
        key = (body.__name__, torch.backends.cuda.matmul.allow_tf32,
               *((tuple(t.shape), t.dtype) for t in inputs))
        if key not in self._entries:
            self._entries[key] = None
            if len(self._entries) > self.KEYS:
                self._entries.popitem(last=False)
            TRACE.count("pose.graph.eager")
            return body(inputs, eager_stage)
        self._entries.move_to_end(key)
        graphed = self._entries[key]
        if graphed is None:
            graphed = self._entries[key] = _Graphed(body, inputs, self.device)
            TRACE.count("pose.graph.captures")
        TRACE.count("pose.graph.replays")
        return graphed.replay(inputs)
