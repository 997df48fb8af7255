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

import numpy as np
import torch


def normalize_cnt(cnt, mean, std):
    """(x - mean) / std with cnt_norm statistics."""
    return (cnt - mean) / std


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


class ContextIndex:
    """The normalized context features of one character as a matrix, with
    the squared norms: ``query`` maps raw context features to database
    indices."""

    def __init__(self, cha_cnt, cnt_mean, cnt_std, dtype=torch.float32,
                 device=None):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        nm = normalize_cnt(t(cha_cnt), t(cnt_mean)[None], t(cnt_std)[None])
        self.flat = nm.reshape(nm.shape[0], -1).to(dtype)
        self.sq_norms = torch.sum(self.flat * self.flat, dim=-1)
        self.cnt_mean = t(cnt_mean).to(dtype)
        self.cnt_std = t(cnt_std).to(dtype)

    def query(self, src_cnt: torch.Tensor) -> torch.Tensor:
        """src_cnt (..., tokens, dim) raw context features -> indices."""
        nm = normalize_cnt(src_cnt, self.cnt_mean, self.cnt_std)
        return nn_index(nm.reshape(nm.shape[:-2] + (-1,)), self.flat,
                        self.sq_norms)
