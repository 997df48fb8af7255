"""BVH file I/O."""

from . import bvh
