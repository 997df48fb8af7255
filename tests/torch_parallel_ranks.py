"""Rank functions of the port's data-parallel tests.

``mocha_sigasia2023_torch.parallel.spawn`` runs each of them in processes
of their own, one rank each, on the CPU under gloo.  They import torch and
the port only; each writes what it computed with ``torch.save`` to the
path its spec names (rank by rank where the ranks differ), and the test
reads it back.
"""

import os

import torch
import torch.distributed as dist

from mocha_sigasia2023_torch.models import convert
from mocha_sigasia2023_torch.models.cvae import CVAE, CVAEConfig
from mocha_sigasia2023_torch.models.generator import (Generator,
                                                      GeneratorConfig)
from mocha_sigasia2023_torch.parallel import distributed as pdist
from mocha_sigasia2023_torch.parallel import mesh as pmesh
from mocha_sigasia2023_torch.runtime import stream
from mocha_sigasia2023_torch.train.trainer import GeneratorTrainer


def _save(obj, path):
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def module_rank(rank, dev, spec):
    """Everything tests/test_torch_parallel.py reads, from one launch."""
    collectives_rank(rank, dev, spec["dir"], spec["port"])
    serving_rank(rank, dev, spec)


def collectives_rank(rank, dev, out_dir, port):
    """The mesh, placement and reduction helpers on two ranks, and
    initialize_multihost's view of the group: from the variables a
    launcher sets, then from explicit arguments."""
    mesh = pmesh.make_mesh(device_type="cpu")
    flat = pmesh.make_mesh(n_data=1, n_model=2, device_type="cpu")
    batch = {"X": torch.arange(16 * 3.0).reshape(16, 3),
             "clips": [f"clip_{i}" for i in range(6)]}
    mine = pmesh.shard_batch(mesh, batch)
    frame0 = {"e": torch.arange(8.0)}
    xs = {"e": torch.arange(3 * 8.0).reshape(3, 8)}
    f0_l, xs_l = pmesh.shard_streams(mesh, frame0, xs)
    rep = pmesh.replicate(mesh, {"w": torch.full((3,), float(rank + 7))})
    module = torch.nn.Linear(2, 2)
    with torch.no_grad():
        module.weight.fill_(rank + 1.0)
    pmesh.replicate(mesh, module)
    red = [torch.full((2, 2), float(rank + 1)), torch.tensor(float(rank))]
    pmesh.all_reduce_mean_(red, mesh)
    summed = torch.tensor([float(rank + 1)])
    dist.all_reduce(summed)
    gathered = pmesh.all_gather_rows(torch.tensor([[rank, 10 + rank]]), mesh)
    raised = None
    try:
        pmesh.shard_batch(mesh, {"X": torch.zeros(5)})
    except ValueError as e:
        raised = str(e)
    meshes = {
        "mesh": {"names": mesh.mesh_dim_names, "shape": tuple(mesh.shape),
                 "coord": pmesh.data_coordinate(mesh)},
        "flat": {"shape": tuple(flat.shape),
                 "coord": pmesh.data_coordinate(flat)}}
    from_env = (dist.get_rank(), dist.get_world_size())
    pdist.shutdown()
    explicit_dev = pdist.initialize_multihost(f"localhost:{port}", 2, rank,
                                              device="cpu")
    _save({
        "from_env": from_env, "explicit_device": str(explicit_dev),
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "backend": dist.get_backend(), "device": str(dev),
        "primary": pdist.is_primary_host(), **meshes,
        "X": mine["X"], "clips": mine["clips"], "f0": f0_l["e"],
        "xs": xs_l["e"], "rep": rep["w"], "module": module.weight.detach(),
        "mean": red, "sum": summed, "gathered": gathered, "raised": raised,
        "env": {k: os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE",
                                               "RANK", "LOCAL_RANK")},
    }, os.path.join(out_dir, f"collectives_{rank}.pt"))


def serving_rank(rank, dev, spec):
    """Sharded serving: this rank's block of the streams through the
    runner, deterministic and under the generator seed, gathered."""
    mesh = pmesh.make_mesh(device_type="cpu")
    gen = Generator(GeneratorConfig(**spec["gen_cfg"]))
    gen.load_state_dict(spec["gen"])
    cvae = CVAE(CVAEConfig(**spec["cvae_cfg"]))
    cvae.load_state_dict(spec["cvae"])
    gen.eval().requires_grad_(False)
    cvae.eval().requires_grad_(False)
    consts = stream.RuntimeConsts(**spec["consts"])
    frame0, xs = pmesh.shard_streams(mesh, spec["frame0"], spec["xs"])
    out = {}
    for deterministic in (True, False):
        run = stream.make_batch_runner(gen, cvae, consts, spec["parents"],
                                       deterministic=deterministic,
                                       device="cpu")
        g = None if deterministic else \
            torch.Generator().manual_seed(spec["seed"])
        out[deterministic] = stream.run_sharded(run, mesh, frame0, xs, g)
    out["local_streams"] = frame0["encoded"].shape[0]
    if rank == 0:
        _save(out, spec["out"])


def _trainer(spec, dev, mesh):
    t = GeneratorTrainer(spec["config"], 100, device=dev, mesh=mesh)
    with torch.no_grad():
        t.gen.load_state_dict(spec["gen"])
        t.gen_ema.load_state_dict(spec["gen"])
        t.prj.load_state_dict(spec["prj"])
    return t


def run_trainer(spec, dev, mesh):
    """The first batch's gradients (and metrics), then ``len(batches)``
    train steps; returns what the tests compare.  ``mesh`` None: one
    process."""
    t = _trainer(spec, dev, mesh)
    norm = spec["norm"]
    batches = [(pmesh.shard_batch(mesh, bs), pmesh.shard_batch(mesh, bc))
               for bs, bc in spec["batches"]]

    def key(step):
        return None if spec["seed"] is None else \
            torch.Generator().manual_seed(spec["seed"] + step)

    m, _ = t.backward(*batches[0], norm, key(0))
    grads = {n: p.grad.clone() for n, p in (
        *(("gen." + n, p) for n, p in t.gen.named_parameters()),
        *(("prj." + n, p) for n, p in t.prj.named_parameters()))}
    first = {k: float(v) for k, v in m.items()}
    metrics = []
    for step, (bs, bc) in enumerate(batches):
        m = t.train_step(bs, bc, norm, key(step))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"grads": grads, "first": first, "metrics": metrics,
            "step": t.step,
            "gen": {k: v.clone() for k, v in t.gen.state_dict().items()},
            "prj": {k: v.clone() for k, v in t.prj.state_dict().items()},
            "gen_ema": {k: v.clone()
                        for k, v in t.gen_ema.state_dict().items()}}


def trainer_rank(rank, dev, specs):
    """:func:`run_trainer` of each spec as one rank of a 2-rank mesh."""
    mesh = pmesh.make_mesh(device_type="cpu")
    for spec in specs:
        _save(run_trainer(spec, dev, mesh), spec["out"].format(rank=rank))


def state_dicts_from_jax(init):
    return {part: convert.state_dict_from_jax(init[part])
            for part in ("gen", "prj")}
