"""Context matching, stream featurization, the stream runners and BVH
export."""

from . import export, features, matching, stream
