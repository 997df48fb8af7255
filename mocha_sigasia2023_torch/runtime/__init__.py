"""Context matching, stream featurization and the batched stream runner."""

from . import features, matching, stream
