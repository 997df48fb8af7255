"""Skeleton graph adjacency + body-part pooling tables (NumPy).

The port's own copy of mocha_sigasia2023_tpu/models/graph.py:17-200: the
static (K, V, V) adjacency stacks of the joint and body-part graphs and the
joint<->body-part pool/unpool matrices.  Nothing here is learnable; the
generator turns these arrays into buffers.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Joint-level parent tables per layout (net/graph.py:17-114).
JOINT_PARENTS: Dict[str, List[int]] = {
    "mixamo": [-1, 0, 1, 2, 3, 4, 3, 6, 7, 8, 3, 10, 11, 12, 0, 14, 15, 16,
               0, 18, 19, 20],
    "Xia": [-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 10, 13, 14, 15, 10,
            17, 18, 19],
    "ian": [-1, 0, 1, 2, 3, 4, 5, 4, 7, 8, 9, 4, 11, 12, 13, 0, 15, 16, 17,
            0, 19, 20, 21],
    "mocha": [-1, 0, 1, 2, 3, 0, 5, 6, 7, 8, 9, 10, 11, 8, 13, 14, 8, 16,
              17, 18, 0, 20, 21, 22],
    "adult2child": [-1, 0, 1, 2, 3, 4, 5, 6, 7, 4, 9, 10, 11, 12, 12, 4, 15,
                    16, 17, 18, 18, 0, 21, 22, 23, 24, 25, 0, 27, 28, 29,
                    30, 31],
    "bandai": [-1, 0, 1, 2, 3, 2, 5, 6, 7, 2, 9, 10, 11, 0, 13, 14, 15, 0,
               17, 18, 19],
}

# Body-part partitions: part name -> joint ids (net/graph.py:326-457).
# Part order defines the 6 body-part node ids.
BODYPART_PARTITIONS: Dict[str, List[Tuple[str, List[int]]]] = {
    "mixamo": [
        ("Spine", [0, 1, 2, 3]), ("Neck", [4, 5]), ("LeftArm", [6, 7, 8, 9]),
        ("RightArm", [10, 11, 12, 13]), ("RightLeg", [14, 15, 16, 17]),
        ("LeftLeg", [18, 19, 20, 21]),
    ],
    "Xia": [
        ("Spine", [0, 9, 10]), ("LeftLeg", [1, 2, 3, 4]),
        ("RightLeg", [5, 6, 7, 8]), ("Neck", [11, 12]),
        ("LeftArm", [13, 14, 15, 16]), ("RightArm", [17, 18, 19, 20]),
    ],
    "Xia2": [
        ("Spine", [0, 9, 10]), ("LeftLeg", [0, 1, 2, 3, 4]),
        ("RightLeg", [0, 5, 6, 7, 8]), ("Neck", [10, 11, 12]),
        ("LeftArm", [10, 13, 14, 15, 16]), ("RightArm", [10, 17, 18, 19, 20]),
    ],
    "ian": [
        ("Spine", [0, 1, 2, 3, 4]), ("LeftLeg", [19, 20, 21, 22]),
        ("LeftArm", [11, 12, 13, 14]), ("Neck", [5, 6]),
        ("RightArm", [7, 8, 9, 10]), ("RightLeg", [15, 16, 17, 18]),
    ],
    "mocha": [
        ("Spine", [0, 5, 6, 7, 8]), ("LeftLeg", [1, 2, 3, 4]),
        ("LeftArm", [9, 10, 11, 12]), ("Neck", [13, 14, 15]),
        ("RightArm", [16, 17, 18, 19]), ("RightLeg", [20, 21, 22, 23]),
    ],
    "adult2child": [
        ("Spine", [0, 1, 2, 3, 4]), ("Neck", [5, 6, 7, 8]),
        ("RightArm", [9, 10, 11, 12, 13, 14]),
        ("LeftArm", [15, 16, 17, 18, 19, 20]),
        ("RightLeg", [21, 22, 23, 24, 25, 26]),
        ("LeftLeg", [27, 28, 29, 30, 31, 32]),
    ],
    "bandai": [
        ("Spine", [0, 1, 2]), ("Neck", [3, 4]), ("LeftArm", [5, 6, 7, 8]),
        ("RightArm", [9, 10, 11, 12]), ("LeftLeg", [13, 14, 15, 16]),
        ("RightLeg", [17, 18, 19, 20]),
    ],
}

NBODY = 6


def hop_distance(num_node: int, edges: Sequence[Tuple[int, int]],
                 max_hop: int) -> np.ndarray:
    """All-pairs hop distance up to max_hop; inf beyond
    (net/graph.py:290-301)."""
    A = np.zeros((num_node, num_node))
    for i, j in edges:
        A[j, i] = 1
        A[i, j] = 1
    dist = np.full((num_node, num_node), np.inf)
    powers = [np.linalg.matrix_power(A, d) for d in range(max_hop + 1)]
    reach = np.stack(powers) > 0
    for d in range(max_hop, -1, -1):
        dist[reach[d]] = d
    return dist


def normalize_digraph(A: np.ndarray) -> np.ndarray:
    """Column (in-degree) normalization A @ D^-1 (net/graph.py:304-312)."""
    deg = A.sum(axis=0)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 0.0)
    return A * inv[None, :]


def normalize_undigraph(A: np.ndarray) -> np.ndarray:
    """Symmetric normalization D^-1/2 A D^-1/2 (net/graph.py:315-323)."""
    deg = A.sum(axis=0)
    inv = np.where(deg > 0, deg ** -0.5, 0.0)
    return inv[:, None] * A * inv[None, :]


def _edges_from_parents(parents: Sequence[int]) -> List[Tuple[int, int]]:
    self_links = [(i, i) for i in range(len(parents))]
    bones = [(i, p) for i, p in enumerate(parents) if p >= 0]
    return self_links + bones


def _star_edges(n: int) -> List[Tuple[int, int]]:
    return [(i, i) for i in range(n)] + [(0, i) for i in range(1, n)]


def _partition_adjacency(A_norm, dist, max_hop, dilation, strategy, center):
    hops = list(range(0, max_hop + 1, dilation))
    if strategy == "uniform":
        return A_norm[None]
    if strategy == "distance":
        return np.stack([np.where(dist == h, A_norm, 0.0) for h in hops])
    if strategy == "spatial":
        parts = []
        for h in hops:
            on_hop = dist == h
            d_to_center = dist[:, center]
            same = d_to_center[:, None] == d_to_center[None, :]
            closer = d_to_center[:, None] > d_to_center[None, :]
            a_root = np.where(on_hop & same, A_norm, 0.0)
            a_close = np.where(on_hop & closer, A_norm, 0.0)
            a_further = np.where(on_hop & (~same) & (~closer), A_norm, 0.0)
            if h == 0:
                parts.append(a_root)
            else:
                parts.append(a_root + a_close)
                parts.append(a_further)
        return np.stack(parts)
    raise ValueError(f"unknown strategy {strategy!r}")


@functools.lru_cache(maxsize=None)
def joint_adjacency(layout: str = "mocha", strategy: str = "distance",
                    max_hop: int = 2, dilation: int = 1) -> np.ndarray:
    """(K, V, V) stacked adjacency for the joint graph
    (Graph_Joint, net/graph.py:6-153)."""
    parents = JOINT_PARENTS[layout]
    n = len(parents)
    edges = _edges_from_parents(parents)
    dist = hop_distance(n, edges, max_hop)
    hops = range(0, max_hop + 1, dilation)
    adj = np.zeros((n, n))
    for h in hops:
        adj[dist == h] = 1
    A_norm = normalize_digraph(adj)
    return _partition_adjacency(A_norm, dist, max_hop, dilation, strategy, 0)


@functools.lru_cache(maxsize=None)
def bodypart_adjacency(layout: str = "mocha", strategy: str = "distance",
                       max_hop: int = 1, dilation: int = 1) -> np.ndarray:
    """(K, 6, 6) adjacency for the body-part star graph
    (Graph_Bodypart, net/graph.py:156-287; Spine is the hub)."""
    n = NBODY
    edges = _star_edges(n)
    dist = hop_distance(n, edges, max_hop)
    hops = range(0, max_hop + 1, dilation)
    adj = np.zeros((n, n))
    for h in hops:
        adj[dist == h] = 1
    A_norm = normalize_digraph(adj)
    return _partition_adjacency(A_norm, dist, max_hop, dilation, strategy, 0)


@functools.lru_cache(maxsize=None)
def pool_matrix(layout: str = "mocha") -> np.ndarray:
    """(V, 6) joint->body-part averaging matrix
    (PoolJointToBodypart, net/graph.py:326-465): one-hot membership
    normalized so each part averages its joints."""
    parts = BODYPART_PARTITIONS[layout]
    njoints = max(max(ids) for _, ids in parts) + 1
    W = np.zeros((njoints, NBODY), dtype=np.float32)
    for b, (_, ids) in enumerate(parts):
        W[ids, b] = 1.0
    return W / W.sum(axis=0, keepdims=True)


@functools.lru_cache(maxsize=None)
def unpool_matrix(layout: str = "mocha") -> np.ndarray:
    """(6, V) body-part->joint broadcast matrix
    (UnpoolBodypartToJoint, net/graph.py:468-608): membership transposed,
    normalized over parts per joint."""
    parts = BODYPART_PARTITIONS[layout]
    njoints = max(max(ids) for _, ids in parts) + 1
    W = np.zeros((NBODY, njoints), dtype=np.float32)
    for b, (_, ids) in enumerate(parts):
        W[b, ids] = 1.0
    return W / W.sum(axis=0, keepdims=True)
