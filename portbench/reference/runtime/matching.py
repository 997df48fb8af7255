"""Context matching: exact nearest neighbour over the character database.

Counterpart of mocha_sigasia2023_tpu/runtime/matching.py: ``normalize_cnt``,
``nn_index``, the grouped multi-character matcher ``nn_index_grouped`` and
``ContextIndex``.

The score product takes its operands in ``mm_dtype`` (float32, or the
caller's compute dtype) and sums their products in float64.  A product of
two float32 or bf16 values is exact in float64 and the sum nearly so, so
the argmin no longer depends on the summation order a GEMM picks for the
batch's shape: a stream gets the same picks alone, in a batch or in a
character stack, on the GPU and on the CPU (with float32 sums, a near-tie
a distance 0.014 apart on scores near 2e4 flipped between the grouped and
the single matcher on an H100).  The JAX package sums in the operands'
dtype, and in bf16 rounds the scores to bf16 as well.  A database stored
in another dtype (bf16 under ``cast_database``) is cast one character
block at a time, so a bf16 stack scores exactly as a float32 stack
pre-rounded through bf16, without a copy of the whole stack.
"""

from __future__ import annotations

import torch


def _scores(query, db, mm_dtype):
    """query (..., D) against db (M, D) -> (..., M) float64 dot products
    of the operands rounded to ``mm_dtype``."""
    return (query.to(mm_dtype).to(torch.float64)
            @ db.to(mm_dtype).to(torch.float64).T)


def nn_index(query_flat: torch.Tensor, database_flat: torch.Tensor,
             db_sq_norms: torch.Tensor = None,
             mm_dtype: torch.dtype = None) -> torch.Tensor:
    """Exact top-1 Euclidean neighbour via |q - x|^2 = |q|^2 - 2 q.x + |x|^2
    (|q|^2 is constant under the argmin).  query_flat (..., D),
    database_flat (M, D), operands in ``mm_dtype`` (the query's dtype by
    default).  Ties go to the first index, as in JAX."""
    mm_dtype = query_flat.dtype if mm_dtype is None else mm_dtype
    if db_sq_norms is None:
        db = database_flat.to(mm_dtype)
        db_sq_norms = torch.sum(db * db, dim=-1)
    d2 = db_sq_norms.to(torch.float64) - 2.0 * _scores(
        query_flat, database_flat, mm_dtype)
    return torch.argmin(d2, dim=-1)


def _group_slots(group_ids: torch.Tensor, n_groups: int,
                 group_size: int) -> torch.Tensor:
    """Each stream's row in a (n_groups * group_size) block layout: its
    group's block, at its rank among that group's streams (stable)."""
    onehot = (group_ids[:, None] == torch.arange(
        n_groups, device=group_ids.device)).to(torch.int64)
    rank = torch.cumsum(onehot, dim=0)[torch.arange(len(group_ids)),
                                       group_ids] - 1
    return group_ids.to(torch.int64) * group_size + rank


def nn_index_grouped(query_flat: torch.Tensor, db_stack_flat: torch.Tensor,
                     db_sq_stack: torch.Tensor, group_ids: torch.Tensor,
                     group_size: int,
                     mm_dtype: torch.dtype = None) -> torch.Tensor:
    """Exact top-1 neighbour of each stream's query against its own
    character's block of a stacked database.

    query_flat (..., S, D); db_stack_flat (C, M, D); db_sq_stack (C, M)
    |x|^2 (+inf on pad rows); group_ids (S,) each stream's character;
    group_size G >= the largest per-character stream count.  Each query is
    scattered into its character's row block of a (C, G, D) buffer (zeros
    where a character has fewer than G streams) and scored block by block,
    'cgd,cmd->cgm': C*G*M*D operations, S*M*D for an even assignment.
    Returns GLOBAL indices c*M + row, shape (..., S)."""
    C, M, D = db_stack_flat.shape
    G = int(group_size)
    mm_dtype = query_flat.dtype if mm_dtype is None else mm_dtype
    slot = _group_slots(group_ids, C, G)
    lead = query_flat.shape[:-2]
    padded = query_flat.new_zeros(lead + (C * G, D), dtype=mm_dtype)
    padded[..., slot, :] = query_flat.to(mm_dtype)
    # one (lead*G, D) x (D, M) product per character block: a float64
    # copy of the whole stack would double its size
    qc = padded.reshape(lead + (C, G, D)).movedim(-3, 0).reshape(C, -1, D)
    scores = torch.stack([_scores(qc[c], db_stack_flat[c], mm_dtype)
                          for c in range(C)])
    scores = scores.reshape((C,) + lead + (G, M)).movedim(0, -3)
    d2 = db_sq_stack[:, None, :].to(torch.float64) - 2.0 * scores
    local = torch.argmin(d2, dim=-1)                        # (..., C, G)
    global_idx = local + (torch.arange(C, device=local.device) * M)[:, None]
    return global_idx.reshape(lead + (C * G,))[..., slot]


def pick_gaps(query_flat: torch.Tensor, db_stack_flat: torch.Tensor,
              db_sq_stack: torch.Tensor, char_ids: torch.Tensor,
              picks: torch.Tensor) -> torch.Tensor:
    """How far each given pick lies from the nearest database row, as a
    share of that nearest squared distance: (|q - x_pick|^2 - |q - x_best|^2)
    / |q - x_best|^2, in float64, for query_flat (T, S, D) against each
    stream's character (db_stack_flat (C, M, D), db_sq_stack (C, M),
    char_ids (S,)) at character-local ``picks`` (T, S).  0 where the pick
    is the nearest row, +inf where the pick is not a row of the stream's
    own database.  (Not in the port: the benchmark's judge of the
    program's matches.)"""
    T, S, _ = query_flat.shape
    out = torch.empty((T, S), dtype=torch.float64, device=query_flat.device)
    for c in torch.unique(char_ids).tolist():
        cols = torch.nonzero(char_ids == c)[:, 0]
        q = query_flat[:, cols].to(torch.float64)
        q_sq = torch.sum(q * q, dim=-1)
        d2 = (db_sq_stack[c].to(torch.float64)
              - 2.0 * q @ db_stack_flat[c].to(torch.float64).T)
        best = d2.min(dim=-1).values
        pick = picks[:, cols].to(torch.int64)
        inside = (pick >= 0) & (pick < d2.shape[-1])
        at_pick = torch.gather(d2, -1, pick.clamp(0, d2.shape[-1] - 1)
                               [..., None])[..., 0]
        gap = (at_pick - best) / (q_sq + best)
        # a pick outside the stream's own database is no answer at all
        out[:, cols] = torch.where(inside, gap, torch.inf)
    return out
