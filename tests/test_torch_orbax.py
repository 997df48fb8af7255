"""The port's orbax checkpoint directories (io/orbax.py on io/ocdbt.py and
io/zstd.py, train/checkpoint.py) against the JAX package's
``save_checkpoint_orbax`` / ``load_checkpoint_orbax`` and tensorstore.

Directories written by the JAX package (a tiny CVAE; a generator trainer
state with AdamW moments and 0-d counts; a bf16 leaf; a key holding ".";
a ``GeneratorConfig()``-width gen_ema) must read bit for bit as the JAX
package's ``load_checkpoint_orbax`` and the port's ``read_msgpack`` of the
same state read them; the JAX package must read the port's directories
bit for bit.  The OCDBT reader is held to tensorstore's listing,
interior B+tree nodes included; zarr arrays split into chunks, with
chunks missing, in F order, to tensorstore's zarr driver.
"""

import json
import os
import shutil
import time
from collections import namedtuple

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import cvae as jcvae  # noqa: E402
from mocha_sigasia2023_tpu.models import generator as jgen  # noqa: E402
from mocha_sigasia2023_tpu.models import projector as jprj  # noqa: E402
from mocha_sigasia2023_tpu.train import checkpoint as jckpt  # noqa: E402
from mocha_sigasia2023_tpu.train import trainer as jtrainer  # noqa: E402

from mocha_sigasia2023_torch.io import msgpack as tmsgpack  # noqa: E402
from mocha_sigasia2023_torch.io import ocdbt, orbax  # noqa: E402
from mocha_sigasia2023_torch.train import checkpoint as tckpt  # noqa: E402

SMALL = dict(encoder_dim=32, encoder_heads=2, encoder_dim_head=16,
             encoder_mlp_dim=64, encoder_depth=1, decoder_dim=32,
             decoder_heads=2, decoder_dim_head=16, decoder_mlp_dim=64,
             decoder_depth=1)


def _leaves(tree, prefix=""):
    """{path: leaf}, lists and "0".."n-1" maps both as indices."""
    if isinstance(tree, dict):
        if not tree:
            return {prefix: "empty"}
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        return _leaves({str(i): v for i, v in enumerate(tree)}, prefix)
    return {prefix: tree}


def _bits(x):
    """(dtype name, shape, bytes) of a leaf, bf16 tensors included."""
    if torch.is_tensor(x):
        assert x.dtype == torch.bfloat16
        return ("bfloat16", tuple(x.shape),
                x.view(torch.int16).numpy().tobytes())
    x = np.asarray(x)
    return str(x.dtype), x.shape, x.tobytes()


def _same_tree(got, want):
    a, b = _leaves(got), _leaves(want)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], str) or isinstance(b[k], str):
            assert a[k] == b[k], k
            continue
        assert _bits(a[k]) == _bits(b[k]), k
    return len(a)


def _trainer_state():
    """The JAX generator trainer's checkpoint layout (trainer.py:467-475)
    after one AdamW update: gen, prj, gen_ema and the optax state."""
    gcfg = jgen.GeneratorConfig(**SMALL)
    params = {"gen": jgen.init_generator(jax.random.PRNGKey(0), gcfg),
              "prj": jprj.init_projector(jax.random.PRNGKey(1),
                                         jprj.ProjectorConfig(
                                             encoder_dim=32, prj_dim=64,
                                             hidden=64))}
    opt = jtrainer.make_optimizer(1e-4, 1e-4, 100, 10)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.sin(p * 3.0 + 1.0), params)
    updates, state = opt.update(grads, state, params)
    new = jax.tree.map(lambda p, u: p + u, params, updates)
    return {"gen": new["gen"], "prj": new["prj"], "gen_ema": params["gen"],
            "opt_state": state}


def _cvae_state():
    cfg = jcvae.CVAEConfig(output_seq=12, latent_dim=16, depth=1, nheads=2,
                           feedforward_dim=32)
    return {"cvae": jcvae.init_cvae(jax.random.PRNGKey(0), cfg)}


def _odd_state():
    """A bf16 leaf, a key holding ".", 0-d leaves, an empty mapping."""
    return {"bf": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7,
            "a.b": np.arange(5, dtype=np.float64), "count": np.int32(3),
            "flags": np.array([True, False]), "step": np.int64(-2),
            "empty": {}, "nested": {"x.y": [np.ones((2, 1), np.float32)]}}


STATES = {"cvae": _cvae_state, "trainer": _trainer_state, "odd": _odd_state}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each state written by the JAX package as msgpack and as orbax."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for name, make in STATES.items():
        state = make()
        jckpt.save_checkpoint(str(root / f"{name}.msgpack"), state)
        jckpt.save_checkpoint_orbax(str(root / name), state)
        out[name] = (state, str(root / name), str(root / f"{name}.msgpack"))
    return out


@pytest.mark.parametrize("name", sorted(STATES))
def test_reads_jax_directories_bit_for_bit(written, name):
    _, path, mp = written[name]
    got = tckpt.load_checkpoint_orbax(path)
    assert _same_tree(got, tmsgpack.read_msgpack(mp)) > 0
    assert _same_tree(got, jax.tree.map(np.asarray,
                                        jckpt.load_checkpoint_orbax(path)))


def test_reads_jax_directory_with_template(written):
    state, path, mp = written["trainer"]
    template = jax.tree.map(np.asarray, state)
    got = tckpt.load_checkpoint_orbax(path, template)
    want = jckpt.load_checkpoint_orbax(path, template)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert _bits(a) == _bits(np.asarray(b))


@pytest.mark.parametrize("name", sorted(STATES))
def test_jax_reads_the_port_directories_bit_for_bit(written, tmp_path, name):
    state, path, _ = written[name]
    tree = tckpt.load_checkpoint_orbax(path)
    out = str(tmp_path / "port")
    tckpt.save_checkpoint_orbax(out, tree)
    tckpt.save_checkpoint_orbax(out, tree)       # replaces the directory
    assert not [p for p in os.listdir(tmp_path) if p != "port"]
    template = jax.tree.map(np.asarray, state)
    got = jckpt.load_checkpoint_orbax(out, template)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(template)):
        assert _bits(np.asarray(a)) == _bits(np.asarray(b))
    assert _same_tree(jax.tree.map(np.asarray,
                                   jckpt.load_checkpoint_orbax(out)),
                      jax.tree.map(np.asarray,
                                   jckpt.load_checkpoint_orbax(path)))
    assert _same_tree(tckpt.load_checkpoint_orbax(out), tree)


def test_full_width_gen_ema(tmp_path):
    """A GeneratorConfig()-width gen_ema written by the JAX package: every
    leaf bit for bit, and the read's time (printed)."""
    params = jgen.init_generator(jax.random.PRNGKey(3), jgen.GeneratorConfig())
    path = str(tmp_path / "gen_ema")
    jckpt.save_checkpoint_orbax(path, {"gen_ema": params})
    t0 = time.perf_counter()
    got = tckpt.load_checkpoint_orbax(path)
    seconds = time.perf_counter() - t0
    raw = sum(np.asarray(x).nbytes for x in jax.tree.leaves(params))
    print(f"full-width gen_ema: {raw / 1e6:.1f} MB read in {seconds:.2f} s "
          f"on this CPU")
    n = _same_tree(got, {"gen_ema": jax.tree.map(np.asarray, params)})
    assert n == len(jax.tree.leaves(params))
    zarrays = [json.loads(v) for k, v in ocdbt.read_store(path).items()
               if k.endswith(b"/.zarray")]
    # orbax 0.11.32 writes each of these arrays as one chunk
    assert all(z["chunks"] == z["shape"] for z in zarrays)


def _ts_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def test_ocdbt_reader_matches_tensorstore(written, tmp_path):
    for name in STATES:
        path = written[name][1]
        assert ocdbt.read_store(path) == _ts_items(path)
        # the per-process store alone, and the root read through it
        sub = os.path.join(path, "ocdbt.process_0")
        assert ocdbt.read_store(sub) == _ts_items(sub)
    # interior nodes: a store of nodes at most 200 bytes decoded
    store = str(tmp_path / "deep")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{store}/",
                          "config": {"max_decoded_node_bytes": 200}}).result()
    with ts.Transaction() as txn:
        for i in range(80):
            kv.with_transaction(txn).write(f"k{i:03d}/x.y".encode(),
                                           bytes([i]) * (i * 29)).result()
    items = _ts_items(store)
    assert len(items) == 80
    assert ocdbt.read_store(store) == items
    # without the root manifest, the per-process stores are merged
    part = str(tmp_path / "parts")
    shutil.copytree(written["cvae"][1], part)
    os.remove(os.path.join(part, ocdbt.MANIFEST))
    assert ocdbt.read_store(part) == ocdbt.read_store(written["cvae"][1])


def test_ocdbt_writer_is_read_by_tensorstore(tmp_path):
    rng = np.random.default_rng(0)
    items = {f"key/{i:04d}".encode(): rng.bytes(int(rng.integers(0, 3000)))
             for i in range(300)}
    ocdbt.write_store(str(tmp_path / "w"), items)
    assert _ts_items(str(tmp_path / "w")) == items
    assert ocdbt.read_store(str(tmp_path / "w")) == items


def test_ocdbt_refuses_corrupt_files(written, tmp_path):
    path = str(tmp_path / "c")
    shutil.copytree(written["cvae"][1], path)
    nodes = [os.path.join(path, "d", f) for f in os.listdir(
        os.path.join(path, "d"))]
    raw = bytearray(open(nodes[0], "rb").read())
    raw[20] ^= 0x40
    open(nodes[0], "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.read_store(path)
    manifest = os.path.join(path, ocdbt.MANIFEST)
    open(manifest, "wb").write(open(manifest, "rb").read()[:-9])
    with pytest.raises(ValueError, match="offset"):
        ocdbt.read_store(path)


def test_crc32c_check_value():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert ocdbt.crc32c(b"") == 0


@pytest.mark.parametrize("order", ["C", "F"])
def test_zarr_chunks_split_missing_and_cropped(tmp_path, order):
    """A zarr v2 array in an OCDBT store, written by tensorstore in chunks
    that do not divide its shape, two chunks never written (fill value)."""
    store = str(tmp_path / "z")
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                         "base": f"file://{store}/",
                                         "path": "w/"},
            "metadata": {"shape": [7, 10], "chunks": [3, 4],
                         "dtype": "<f4", "order": order, "fill_value": 2.5,
                         "compressor": {"id": "zstd", "level": 5}},
            "create": True}
    arr = ts.open(spec).result()
    data = np.arange(70, dtype=np.float32).reshape(7, 10) / 3
    want = np.full((7, 10), 2.5, np.float32)
    for r0, c0 in [(0, 0), (0, 4), (3, 0), (3, 8), (6, 4)]:
        block = np.s_[r0:min(r0 + 3, 7), c0:min(c0 + 4, 10)]
        arr[block].write(data[block]).result()
        want[block] = data[block]
    items = ocdbt.read_store(store)
    meta = orbax.parse_zarray(items[b"w/.zarray"], "w")
    chunks = {idx: items[f"w/{key}".encode()]
              for idx, key in orbax.chunk_keys(meta)
              if f"w/{key}".encode() in items}
    assert len(chunks) == 5
    from mocha_sigasia2023_torch.io import zstd
    got = orbax.assemble(meta, {i: zstd.decompress(c)
                                for i, c in chunks.items()}, "w")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr.read().result())


def test_refuses_zarr3_and_other_compressors(written, tmp_path):
    path = str(tmp_path / "v3")
    shutil.copytree(written["cvae"][1], path)
    meta_path = os.path.join(path, orbax.METADATA)
    meta = json.load(open(meta_path))
    meta["use_zarr3"] = True
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError, match="zarr v3"):
        tckpt.load_checkpoint_orbax(path)
    doc = json.dumps({"chunks": [2], "compressor": {"id": "blosc"},
                      "dtype": "<f4", "fill_value": None, "filters": None,
                      "order": "C", "shape": [2], "zarr_format": 2})
    with pytest.raises(ValueError, match="blosc"):
        orbax.parse_zarray(doc.encode(), "x")


Layer = namedtuple("Layer", "w b")


def test_restore_like_matches_jax(written):
    """A list-of-layers template, with a tuple and a NamedTuple, over the
    msgpack reader's tree and over its "0".."n-1" maps."""
    rng = np.random.default_rng(0)
    template = {"layers": [Layer(rng.standard_normal((2, 3)).astype(
                                     np.float32), np.zeros(2, np.float32))
                           for _ in range(3)],
                "pair": (np.int32(1), [np.ones(4)]), "empty": {}}
    state = jax.tree.map(lambda x: np.asarray(x) + 1, template)
    path = os.path.join(os.path.dirname(written["cvae"][1]), "layers.msgpack")
    jckpt.save_checkpoint(path, state)
    want = jckpt.restore_like(template, jckpt.load_checkpoint(path))
    for loaded in (tmsgpack.read_msgpack(path), jckpt.load_checkpoint(path)):
        got = tckpt.restore_like(template, loaded)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert isinstance(got["layers"][0], Layer)
        assert isinstance(got["pair"], tuple)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert _bits(np.asarray(a)) == _bits(np.asarray(b))
    with pytest.raises(ValueError, match="layers"):
        tckpt.restore_like({"layers": template["layers"][:2]},
                           tmsgpack.read_msgpack(path))
