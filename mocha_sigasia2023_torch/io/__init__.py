"""BVH and database.bin file I/O, and checkpoints: msgpack, and orbax
directories on OCDBT and zstd."""

from . import bvh, database
