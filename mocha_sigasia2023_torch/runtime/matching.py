"""Context matching: exact nearest neighbour over the character database.

Counterpart of mocha_sigasia2023_tpu/runtime/matching.py:23-34.  The
grouped multi-character matcher is not ported yet.
"""

from __future__ import annotations

import torch


def nn_index(query_flat: torch.Tensor, database_flat: torch.Tensor,
             db_sq_norms: torch.Tensor = None) -> torch.Tensor:
    """Exact top-1 Euclidean neighbour via |q - x|^2 = |q|^2 - 2 q.x + |x|^2
    (|q|^2 is constant under the argmin).  query_flat (..., D),
    database_flat (M, D).  Ties go to the first index, as in JAX."""
    if db_sq_norms is None:
        db_sq_norms = torch.sum(database_flat * database_flat, dim=-1)
    d2 = db_sq_norms - 2.0 * (query_flat @ database_flat.T)
    return torch.argmin(d2, dim=-1)
