"""Context matching, stream featurization, the stream runners (batched,
multi-character, single-clip and live) and BVH export."""

from . import export, features, live, matching, stream
