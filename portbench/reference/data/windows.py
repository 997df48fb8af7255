"""Clip windowing as index matrices + one gather.

Counterpart of mocha_sigasia2023_tpu/data/windows.py:18-121 (the index
builders and the whole-clip reflect padding are NumPy, the gathers
torch).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def padded_window_indices(T: int, window: int,
                          step: int) -> Tuple[np.ndarray, np.ndarray]:
    """Index/pad-mask matrices: starts range(0, T - window//4, step); short
    tail windows repeat the slice's first element on the left
    ((deficit+1)//2 entries) and its last on the right (deficit//2).
    Returns (idx, is_pad), each (num_windows, window)."""
    starts = np.arange(0, max(T - window // 4, 0), step)
    idx = np.zeros((len(starts), window), dtype=np.int32)
    pad = np.zeros((len(starts), window), dtype=bool)
    for w, j in enumerate(starts):
        L = min(window, T - j)
        deficit = window - L
        left = deficit // 2 + deficit % 2
        idx[w, :left] = j
        idx[w, left: left + L] = np.arange(j, j + L)
        idx[w, left + L:] = j + L - 1
        pad[w, :left] = True
        pad[w, left + L:] = True
    return idx, pad


def full_window_indices(T: int, window: int, step: int) -> np.ndarray:
    """Same start range, short windows dropped."""
    starts = [j for j in range(0, max(T - window // 4, 0), step)
              if T - j >= window]
    starts = np.asarray(starts, dtype=np.int64)
    return starts[:, None] + np.arange(window, dtype=np.int64)[None, :]


def gather_windows(x: torch.Tensor, idx, pad_mask=None) -> torch.Tensor:
    """(T, ...) -> (W, window, ...) along axis 0; padded entries optionally
    zeroed (velocity semantics)."""
    out = x[torch.as_tensor(np.asarray(idx), dtype=torch.long,
                            device=x.device)]
    if pad_mask is not None:
        keep = torch.as_tensor(~np.asarray(pad_mask), device=x.device)
        out = out * keep.to(out.dtype).reshape(
            keep.shape + (1,) * (out.dim() - 2))
    return out


def reflect_pad_to(x: np.ndarray, target: int) -> np.ndarray:
    """Whole-clip reflect padding: symmetric ping-pong reflection extending
    the clip (axis 0) to ``target`` frames, the odd frame of a deficit on
    the left."""
    T = len(x)
    if T >= target:
        return x

    def reflection(src, tlen):
        seg = np.flip(src, axis=0)
        out = seg.copy()
        while len(out) < tlen:
            seg = np.flip(seg, axis=0)
            out = np.concatenate([out, seg], axis=0)
        return out[:tlen]

    deficit = target - T
    left_len = deficit // 2 + deficit % 2
    right_len = deficit // 2
    left = np.flip(reflection(np.flip(x, axis=0), left_len), axis=0)
    right = reflection(x, right_len)
    return np.concatenate([left, x, right], axis=0)


def whole_clip_padded(features: Dict, min_multiple: int = 4,
                      min_len: int = 12) -> Dict:
    """Reflect-pad a featurized clip's tensors to the next multiple of
    ``min_multiple`` plus ``min_multiple`` frames (at least ``min_len``),
    as one gather of reflected frame indices."""
    T = int(features["positions"].shape[0])
    target = max((T // min_multiple) * min_multiple + min_multiple, min_len)
    idx = torch.as_tensor(reflect_pad_to(np.arange(T), target).copy(),
                          device=features["positions"].device)
    out = {k: features[k][idx] for k in ("positions", "velocities",
                                          "rotations", "angular_velocities",
                                          "contacts")}
    for k in ("bone_parents", "bone_names"):
        out[k] = features[k]
    return out


def window_features(features: Dict, window: int = 60, step: int = 20,
                    *, padded: bool = True) -> Dict:
    """Window a featurized clip into (W, window, J, C) tensors; ``padded``
    selects the repeat-padded preprocess semantics (velocity channels
    zeroed in the pad), else short windows are dropped."""
    T = int(features["positions"].shape[0])
    if padded:
        idx, pad = padded_window_indices(T, window, step)
    else:
        idx, pad = full_window_indices(T, window, step), None
    return {
        "positions": gather_windows(features["positions"], idx),
        "velocities": gather_windows(features["velocities"], idx, pad),
        "rotations": gather_windows(features["rotations"], idx),
        "angular_velocities": gather_windows(
            features["angular_velocities"], idx, pad),
        "contacts": gather_windows(features["contacts"], idx),
    }
