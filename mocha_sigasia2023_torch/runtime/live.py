"""Live (frame-at-a-time) characterization for real-time serving.

Counterpart of mocha_sigasia2023_tpu/runtime/live.py.  The offline paths
run whole clips (``stream.characterize_clip``, the batch runner); this
module wraps the same per-frame step as a stateful session: push one source
frame's features, get the characterized pose back.  The carry stays on the
device between calls.

Per frame, one flat float32 buffer crosses host -> device and one comes
back, each through pinned host memory with a non-blocking copy (a dict of
tensors would cost a copy per leaf).  ``push_frame_pipelined`` returns
frame i-1's pose while the device runs frame i: it waits on a CUDA event
recorded after frame i-1's device -> host copy, the counterpart of JAX's
asynchronous dispatch.  The pinned buffers are double-buffered, so the next
frame's upload never overwrites a buffer a queued copy still reads.

On a card a frame's device work between the two copies (the match, the
step and the flattening of its pose) is one replay of a CUDA graph
(``runtime/step_graph``), captured at the session's first step after that
step has run eagerly; the bootstrap frame is eager, and after a
:meth:`LiveCharacterizer.reset` it seeds the graph's carry.  On the CPU
every frame is eager.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import check_module_device, resolve_device
from ..utils.profiling import span
from . import step_graph
from . import stream as rts
from .matching import nn_index
from .stream import IKConfig, RuntimeConsts


class LiveCharacterizer:
    """Stateful real-time characterization session for one stream.

    Feed per-frame features (one row of ``clip_stream_features_device``
    output, with ``cnt``) through :meth:`push_frame`; poses come back as
    dicts of NumPy arrays.  The first pushed frame bootstraps the contact
    state and the root integrators.  ``generator`` (a ``torch.Generator`` on
    the device) draws the CVAE noise, by default one seeded with 1777;
    ``deterministic=True`` takes the CVAE mean instead.
    """

    FEAT_KEYS = ("encoded", "cnt", "pos_last", "rot_last", "vel_last",
                 "ang_last", "rvel_last", "rang_last", "contact_last",
                 "hips_speed_mean")
    OUT_KEYS = ("src_pos", "src_rot", "src_vel", "src_ang",
                "trans_pos", "trans_rot", "ik_pos", "ik_rot",
                "cm_pos", "cm_rot", "contact", "nn_index")

    def __init__(self, gen, cvae, consts: RuntimeConsts, parents, *,
                 contact_bones=(5, 24), ik: IKConfig = IKConfig(),
                 dt: float = 1.0 / 60.0, deterministic: bool = False,
                 root_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, device=None):
        dev = self._dev = resolve_device(device)
        check_module_device(gen, dev, "generator")
        if cvae is not None:
            check_module_device(cvae, dev, "cvae")
        rts.check_consts_device(consts, dev)
        self._gen = gen
        self._consts = consts
        self._sc = rts.stream_consts(consts)
        self._parents = tuple(int(p) for p in np.asarray(parents))
        self._contact_bones = tuple(int(b) for b in contact_bones)
        self._dt = dt
        self._root_dtype = root_dtype
        if generator is None and not deterministic:
            generator = torch.Generator(device=dev).manual_seed(1777)
        self._generator = generator
        self._step = rts.make_stream_step(
            gen, cvae, self._parents, contact_bones=self._contact_bones,
            ik=ik, dt=dt, deterministic=deterministic)

        tok, dim = gen.cfg.num_tokens, gen.cfg.encoder_dim
        J = gen.cfg.njoints + 1
        self._feat_shapes = {
            "encoded": (tok, dim), "cnt": (tok, dim),
            "pos_last": (J, 3), "rot_last": (J, 4),
            "vel_last": (J, 3), "ang_last": (J, 3),
            "rvel_last": (3,), "rang_last": (3,),
            "contact_last": (2,), "hips_speed_mean": (),
        }
        self._out_shapes = {
            "src_pos": (J, 3), "src_rot": (J, 4),
            "src_vel": (J, 3), "src_ang": (J, 3),
            "trans_pos": (J, 3), "trans_rot": (J, 4),
            "ik_pos": (J, 3), "ik_rot": (J, 4),
            "cm_pos": (J, 3), "cm_rot": (J, 4),
            "contact": (2,), "nn_index": (),
        }
        n_in = sum(int(np.prod(s)) for s in self._feat_shapes.values())
        n_out = sum(int(np.prod(s)) for s in self._out_shapes.values())
        pin = dev.type == "cuda"
        self._h_in = [torch.empty(n_in, pin_memory=pin) for _ in range(2)]
        self._h_out = [torch.empty(n_out, pin_memory=pin) for _ in range(2)]
        self._d_in = torch.empty(n_in, device=dev)
        self._frames = 0        # frames dispatched: picks the buffer pair
        self._carry = None
        self._pending = None    # (buffer, event) of the frame in flight
        self._graph = None      # the captured frame, and the carry it reads
        self._graph_carry = None

    def reset(self) -> None:
        """Forget the stream: the next frame bootstraps a new one (into the
        captured graph's carry, where there is one)."""
        if self._pending is not None and self._pending[1] is not None:
            self._pending[1].synchronize()
        self._carry = None
        self._pending = None

    def _unflatten(self, flat):
        x, o = {}, 0
        for k in self.FEAT_KEYS:
            shp = self._feat_shapes[k]
            n = int(np.prod(shp))
            x[k] = flat[o:o + n].reshape((1,) + shp)
            o += n
        return x

    def _match(self, x):
        with span("live.match"):
            q = (x["cnt"] - self._sc.cnt_mean) / self._sc.cnt_std
            return nn_index(q.reshape(1, -1), self._consts.cha_cnt_flat,
                            self._consts.cha_cnt_sq)

    @torch.no_grad()
    def _dispatch(self, frame: Dict):
        """Queue one frame: upload, step, download.  Returns (host output
        buffer, event recorded after its copy, or None on the CPU)."""
        with span("live.dispatch"):
            return self._dispatch_frame(frame)

    def _inputs(self):
        """The uploaded frame's features, with its match."""
        x = self._unflatten(self._d_in)
        x["nn_idx"] = self._match(x)
        return x

    def _flatten(self, out):
        return torch.cat([out[k].to(torch.float32).reshape(-1)
                          for k in self.OUT_KEYS])

    def _dispatch_frame(self, frame: Dict):
        b = self._frames % 2
        t = self._frames
        self._frames += 1
        np.concatenate([np.asarray(frame[k], np.float32).reshape(-1)
                        for k in self.FEAT_KEYS], out=self._h_in[b].numpy())
        self._d_in.copy_(self._h_in[b], non_blocking=True)
        if self._carry is None:
            carry, out = rts.init_stream(
                self._gen, self._sc, self._parents, self._inputs(),
                contact_bones=self._contact_bones, dt=self._dt,
                root_dtype=self._root_dtype)
            if self._graph is not None:
                step_graph.copy_tree(self._graph_carry, carry)
                carry = self._graph_carry
            self._carry = carry
            flat = self._flatten(out)
        elif step_graph.route(self._carry.src_pos0) == "graph":
            flat = self._graph_frame(t)
        else:
            x = self._inputs()
            with span("stream.step", t=t, route="eager"):
                self._carry, out = self._step(self._sc, self._carry, x,
                                              self._generator)
            flat = self._flatten(out)
        self._h_out[b].copy_(flat, non_blocking=True)
        if self._dev.type != "cuda":
            return self._h_out[b], None
        event = torch.cuda.Event()
        event.record()
        return self._h_out[b], event

    def _graph_frame(self, t):
        """Frame ``t``'s match, step and flattened pose as a replay; at the
        session's first step, that step eagerly on a side stream, then the
        capture."""
        if self._graph is not None:
            with span("stream.step", t=t, route="graph"):
                self._graph.replay()
            return self._graph.out

        def frame():
            return self._step(self._sc, self._carry, self._inputs(),
                              self._generator)

        side = torch.cuda.Stream(self._dev)
        with span("stream.step", t=t, route="eager"):
            carry, out = step_graph.warm_up(frame, side)
            flat = self._flatten(out)
        carry = step_graph.clone_tree(carry)

        def body():
            new, out = self._step(self._sc, carry, self._inputs(),
                                  self._generator)
            flat = self._flatten(out)
            step_graph.copy_tree(carry, new)
            return flat

        self._graph = step_graph.Graph(body, side, self._generator)
        self._carry = self._graph_carry = carry
        return flat

    def _unpack(self, pending) -> Dict[str, np.ndarray]:
        buf, event = pending
        with span("live.wait"):
            if event is not None:
                event.synchronize()
        flat = buf.numpy()
        out, o = {}, 0
        for k in self.OUT_KEYS:
            shp = self._out_shapes[k]
            n = int(np.prod(shp))
            out[k] = flat[o:o + n].reshape(shp).copy()
            o += n
        out["nn_index"] = out["nn_index"].astype(np.int64)
        return out

    def push_frame(self, frame: Dict) -> Dict[str, np.ndarray]:
        """Process one source frame; returns the characterized pose dict
        (src/trans/ik/cm pos+rot rows, contact flags, NN index)."""
        if self._pending is not None:
            raise RuntimeError(
                "a pipelined frame is still in flight: call flush() before "
                "switching from push_frame_pipelined to push_frame (its pose "
                "would otherwise be dropped)")
        with span("live.push", request=self._frames):
            return self._unpack(self._dispatch(frame))

    def push_frame_pipelined(self, frame: Dict
                             ) -> Optional[Dict[str, np.ndarray]]:
        """One-frame-pipelined serving: queue frame i, return frame i-1's
        pose (None on the first call; :meth:`flush` drains the tail).  The
        device runs frame i while the host reads frame i-1's output; the
        output lags its input by one frame."""
        with span("live.push", request=self._frames):
            prev, self._pending = self._pending, self._dispatch(frame)
            return None if prev is None else self._unpack(prev)

    def flush(self) -> Optional[Dict[str, np.ndarray]]:
        """The last pipelined frame's pose, if one is in flight."""
        prev, self._pending = self._pending, None
        return None if prev is None else self._unpack(prev)
