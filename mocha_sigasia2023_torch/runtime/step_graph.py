"""The frame step as a CUDA graph: captured once a session's shapes are
fixed, then replayed once a frame.

The batch runner (``runtime/stream.make_batch_runner``) and the live
session (``runtime/live.LiveCharacterizer``) run a session's frame steps
by :func:`route`: "graph" on a card with grad off, outside another capture;
"eager" elsewhere (every CPU step, and on a card a step under grad or
inside a capture, which ``eager_steps`` counts).  The bootstrap frame
(``init_stream``) is always eager.  On the graph route the session's first
step runs eagerly on a side stream as the capture's warm-up
(:func:`warm_up`, as PyTorch's CUDA graphs ask), then the step is captured
(:class:`Graph`) reading static buffers: the carry, the frame's inputs,
the session constants the step reads.  Each later step is one replay.

A graph's kernels launch at each replay without the Python that counts
them, so :class:`Graph` takes back what its capture added to the launch
counters (``fused_attention.launches*``, ``pose_roots.launches``,
``pose_ik.launches``, ``pose.eager_steps``) and adds it again at every
replay: a counter still reads the kernels launched.  ``captures`` counts
the frame step's captures, ``replays`` its replays (the encoder's chunk
graph, ``runtime/features``, counts its own).

The CVAE noise of a replay is the eager step's: the generator the step
draws from is registered with the graph (``register_generator_state``),
whose replays advance it as eager draws do.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..ops import attention, pose

captures = 0
replays = 0
# steps on a card that went eager (a capture's warm-up step is not one)
eager_steps = 0


def route(like: torch.Tensor, steps: int = 1) -> str:
    """"graph" for steps whose carry ``like`` lies on a card, with grad off
    and no capture under way; else "eager" (counted in ``eager_steps``
    on a card)."""
    global eager_steps
    if not like.is_cuda:
        return "eager"
    if torch.is_grad_enabled() or torch.cuda.is_current_stream_capturing():
        eager_steps += steps
        return "eager"
    return "graph"


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of tuples, lists and dicts, in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [t for sub in tree for t in leaves(sub)]


def clone_tree(tree):
    """A tree of the same type with each tensor copied into a contiguous
    tensor of its own."""
    if torch.is_tensor(tree):
        return tree.clone(memory_format=torch.contiguous_format)
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    items = [clone_tree(v) for v in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)


def copy_tree(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s, one ``_foreach_copy_`` a
    dtype (a tensor onto itself is skipped)."""
    groups: Dict[torch.dtype, tuple] = {}
    for d, s in zip(leaves(dst), leaves(src)):
        if d is not s:
            pair = groups.setdefault(d.dtype, ([], []))
            pair[0].append(d)
            pair[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def warm_up(fn, stream: torch.cuda.Stream):
    """``fn()`` on ``stream``, after the current stream's queued work and
    before its later work; the result's tensors are marked as used on the
    current stream, so that their memory is not handed back to ``stream``
    while that reads them."""
    current = torch.cuda.current_stream()
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    for t in leaves(out):
        t.record_stream(current)
    return out


def _launch_counters():
    f = attention.fused_attention
    return ((f, "launches"), (f, "launches_bf16"), (f, "launches_general"),
            (pose.pose_roots, "launches"), (pose.pose_ik, "launches"),
            (pose, "eager_steps"))


class Graph:
    """``body()`` captured on ``stream`` as a CUDA graph; ``out`` is what the
    capture returned (static: each replay writes it again).  ``generator``,
    when given, is registered with the graph: its draws inside the body
    advance it at each replay as they would eagerly.  ``counted``: whether
    the capture and the replays count in ``captures`` and ``replays``."""

    def __init__(self, body, stream: torch.cuda.Stream,
                 generator: Optional[torch.Generator] = None,
                 counted: bool = True):
        global captures
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        counters = _launch_counters()
        before = [getattr(o, a) for o, a in counters]
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = body()
            self.adds = tuple((o, a, getattr(o, a) - n)
                              for (o, a), n in zip(counters, before)
                              if getattr(o, a) != n)
        finally:      # the capture launched nothing
            for (o, a), n in zip(counters, before):
                setattr(o, a, n)
        self.counted = counted
        if counted:
            captures += 1

    def replay(self) -> None:
        global replays
        self.graph.replay()
        for o, a, n in self.adds:
            setattr(o, a, getattr(o, a) + n)
        if self.counted:
            replays += 1


class Rows:
    """Tensors of a fixed layout, ``capacity`` of them (frames), packed
    into one 2-D buffer a dtype, a row each.  ``gather(i)`` copies row
    ``i`` (a device tensor) into static row buffers that ``view`` reads;
    ``scatter(i, tensors)`` writes them into row ``i``; ``frames(a, b)``
    returns rows a..b as tensors with a leading frame axis.  With
    ``align``, each tensor starts at a multiple of that many elements."""

    def __init__(self, like: Dict[str, torch.Tensor], capacity: int,
                 align: int = 1):
        self.at = {}            # name -> (dtype, offset, shape)
        size: Dict[torch.dtype, int] = {}
        for k, v in like.items():
            o = -(-size.get(v.dtype, 0) // align) * align
            self.at[k] = (v.dtype, o, tuple(v.shape))
            size[v.dtype] = o + v.numel()
        dev = next(iter(like.values())).device
        self.bufs = {dt: torch.empty(capacity, n, dtype=dt, device=dev)
                     for dt, n in size.items()}
        self.rows = {dt: torch.empty(1, n, dtype=dt, device=dev)
                     for dt, n in size.items()}
        self.view = {k: self.rows[dt][0, o:o + _numel(s)].view(s)
                     for k, (dt, o, s) in self.at.items()}

    def load(self, frames: Dict[str, torch.Tensor]) -> None:
        """Rows 0..n of every tensor from ``frames`` (leading n)."""
        for k, (dt, o, s) in self.at.items():
            v = frames[k]
            self.bufs[dt][:len(v), o:o + _numel(s)].view(
                (len(v),) + s).copy_(v)

    def gather(self, i: torch.Tensor) -> Dict[str, torch.Tensor]:
        for dt, buf in self.bufs.items():
            torch.index_select(buf, 0, i, out=self.rows[dt])
        return self.view

    def scatter(self, i: torch.Tensor, tensors: Dict[str, torch.Tensor]):
        for dt, buf in self.bufs.items():
            parts = [tensors[k].reshape(-1)
                     for k, (d, _, _) in self.at.items() if d == dt]
            row = parts[0] if len(parts) == 1 else torch.cat(parts)
            buf.index_copy_(0, i, row[None])

    def frames(self, a: int, b: int) -> Dict[str, torch.Tensor]:
        return {k: self.bufs[dt][a:b, o:o + _numel(s)].view((b - a,) + s)
                .clone(memory_format=torch.contiguous_format)
                for k, (dt, o, s) in self.at.items()}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
