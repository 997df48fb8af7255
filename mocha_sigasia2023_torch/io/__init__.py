"""BVH and database.bin file I/O."""

from . import bvh, database
