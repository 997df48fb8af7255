"""The (data, model) mesh over the ranks, and placement by rank.

Counterpart of mocha_sigasia2023_tpu/parallel/mesh.py.  JAX places a
global array over a mesh of devices and lets XLA insert the collectives;
here each rank is one process holding its own block, so a placement is a
slice and a reduction an explicit collective:

- :func:`shard_batch` keeps this rank's contiguous block of the leading
  axis, as ``P("data")`` places it: rank r of K gets rows
  ``[r B / K, (r + 1) B / K)``;
- :func:`replicate` broadcasts rank 0's tensors;
- :func:`shard_streams` keeps this rank's block of the stream axis of the
  stream runner's inputs (dim 0 of frame0, dim 1 of xs);
- :func:`all_reduce_mean_` is the gradient reduction XLA inserts in
  JAX's data-parallel step: one coalesced all-reduce over ``data``;
- :func:`all_gather_rows` concatenates every rank's block in rank order.

``model`` is kept at 1 by the trainer and the runner, as in JAX, and
plumbed so that a mesh of another shape can be made.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks of the process group.
    ``n_data`` defaults to the world size over ``n_model``; the mesh
    spans every rank.  ``device_type`` is the ranks' (``"cpu"`` for CPU
    ranks)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.initialize_multihost first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: a {n_data} x {n_model} mesh over "
                         f"{world} ranks; the mesh spans every rank")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def data_coordinate(mesh: Optional[DeviceMesh]):
    """(this rank's index on ``data``, the size of ``data``); (0, 1)
    without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank("data"), axis_size(mesh, "data")


def axis_size(mesh: DeviceMesh, dim: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(dim)]


def block(mesh: Optional[DeviceMesh], n: int) -> slice:
    """This rank's block of ``n`` rows split over ``data``; raises unless
    the data axis divides ``n``."""
    r, k = data_coordinate(mesh)
    if n % k:
        raise ValueError(f"{n} rows do not split over a data axis of {k}")
    return slice(r * n // k, (r + 1) * n // k)


def _slice_tree(tree, dim: int, mesh):
    if isinstance(tree, dict):
        return {k: _slice_tree(v, dim, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        if dim == 0:   # a list of items (clips, file names) is the batch
            return type(tree)(tree[block(mesh, len(tree))])
        return type(tree)(_slice_tree(v, dim, mesh) for v in tree)
    index = (slice(None),) * dim + (block(mesh, tree.shape[dim]),)
    return tree[index]


def shard_batch(mesh: Optional[DeviceMesh], batch):
    """This rank's block of every leaf's leading axis (tensors or arrays,
    in dicts; a list is itself the batch)."""
    return _slice_tree(batch, 0, mesh)


def shard_streams(mesh: Optional[DeviceMesh], frame0, xs):
    """This rank's block of the stream runner's inputs
    (``runtime.stream.stack_stream_inputs`` layout): frame0 leaves are
    (S, ...), cut on dim 0; xs leaves (T - 1, S, ...), cut on dim 1."""
    return _slice_tree(frame0, 0, mesh), _slice_tree(xs, 1, mesh)


def _group(mesh: Optional[DeviceMesh], dim: Optional[str]):
    if mesh is None or dim is None:
        return None             # the default group: every rank
    return mesh.get_group(dim)


def replicate(mesh: Optional[DeviceMesh], tree):
    """Rank 0's values on every rank: of a module's parameters and buffers
    (copied in place; the module is returned) or of a dict of tensors (a
    new dict).  One broadcast of one flat buffer a dtype."""
    if mesh is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            _broadcast_([*tree.parameters(), *tree.buffers()])
        return tree
    out = {k: v.clone() for k, v in tree.items()}
    _broadcast_(list(out.values()))
    return out


def _broadcast_(tensors: Sequence[torch.Tensor]) -> None:
    for same in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=0)
        _unflatten_into(flat, same)


def _by_dtype(tensors):
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def _unflatten_into(flat, tensors):
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     mesh: Optional[DeviceMesh], dim: str = "data") -> None:
    """Replace each tensor by its mean over the ranks of mesh axis ``dim``,
    in place: one all-reduce of one flat buffer a dtype (the gradients of
    a step are all float32, so one)."""
    if mesh is None:
        return
    k = axis_size(mesh, dim)
    if k == 1:
        return
    for same in _by_dtype(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=_group(mesh, dim))
        flat /= k
        _unflatten_into(flat, same)


def all_gather_rows(t: torch.Tensor, mesh: Optional[DeviceMesh],
                    dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in the
    order of the ranks on ``data``: the global array of blocks that
    :func:`shard_batch` cut on that axis."""
    r, k = data_coordinate(mesh)
    if k == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(k)]
    dist.all_gather(parts, t.contiguous(), group=_group(mesh, "data"))
    return torch.cat(parts, dim=dim)


def data_parallel_size(batch_size: int, n_devices: int) -> int:
    """The largest divisor of ``batch_size`` that is at most
    ``n_devices`` (at least 1): the JAX CLI's default data axis."""
    return max(d for d in range(1, max(n_devices, 1) + 1)
               if batch_size % d == 0)

