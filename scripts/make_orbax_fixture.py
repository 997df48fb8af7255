"""Write the committed orbax fixture: JAX-written checkpoint directories
and their msgpack twins, at a tiny config.

    python3 scripts/make_orbax_fixture.py [--out tests/data/orbax]

Needs the JAX package and orbax-checkpoint (a host with both; the card's
machine has neither).  Writes, through the JAX package's own
``save_checkpoint_orbax`` and ``save_checkpoint``:

- ``gen/`` and ``gen.msgpack``: ``{"gen_ema": ...}``, a generator at
  encoder and decoder width 16 (one layer, one head of 8), from
  ``PRNGKey(0)``, with a bfloat16 copy of its first embedding weight
  under ``"bf16"``;
- ``cvae/`` and ``cvae.msgpack``: ``{"cvae": ...}``, a CVAE of latent 8,
  one layer of 2 heads, feed-forward 16, 6 tokens, from ``PRNGKey(1)``.

chip_smoke.py's ``orbax`` phase reads both directories with the port and
holds every leaf to its msgpack twin bit for bit.

``--full-width DIR`` writes, instead, ``{"gen", "gen_ema"}`` at
``GeneratorConfig()`` widths (``PRNGKey(0)`` and ``PRNGKey(1)``; about
44 MB on disk, not committed) for ``scripts/orbax_read_time.py``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from mocha_sigasia2023_tpu.models import cvae, generator  # noqa: E402
from mocha_sigasia2023_tpu.train import checkpoint  # noqa: E402

GEN = dict(encoder_dim=16, encoder_depth=1, encoder_heads=1,
           encoder_dim_head=8, encoder_mlp_dim=16, decoder_dim=16,
           decoder_depth=1, decoder_heads=1, decoder_dim_head=8,
           decoder_mlp_dim=16)
CVAE = dict(output_seq=6, latent_dim=8, depth=1, nheads=2,
            feedforward_dim=16)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                  "orbax"))
    ap.add_argument("--full-width", default=None, metavar="DIR",
                    help="write a GeneratorConfig()-width gen + gen_ema "
                         "directory to DIR instead")
    args = ap.parse_args()
    if args.full_width:
        cfg = generator.GeneratorConfig()
        shutil.rmtree(args.full_width, ignore_errors=True)
        checkpoint.save_checkpoint_orbax(args.full_width, {
            "gen": generator.init_generator(jax.random.PRNGKey(0), cfg),
            "gen_ema": generator.init_generator(jax.random.PRNGKey(1), cfg)})
        print(f"wrote {args.full_width}")
        return 0
    gen = generator.init_generator(jax.random.PRNGKey(0),
                                   generator.GeneratorConfig(**GEN))
    first = jax.tree.leaves(gen)[0]
    states = {
        "gen": {"gen_ema": gen, "bf16": first.astype(jnp.bfloat16)},
        "cvae": {"cvae": cvae.init_cvae(jax.random.PRNGKey(1),
                                        cvae.CVAEConfig(**CVAE))},
    }
    os.makedirs(args.out, exist_ok=True)
    for name, state in states.items():
        path = os.path.join(args.out, name)
        shutil.rmtree(path, ignore_errors=True)
        checkpoint.save_checkpoint_orbax(path, state)
        checkpoint.save_checkpoint(path + ".msgpack", state)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(args.out) for f in files)
    print(f"wrote {args.out}: {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
