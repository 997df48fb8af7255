"""Least times on one NVIDIA H100 SXM, from the published peaks.

The attention bound is a copy of ``chip_smoke.attention_bound_ms``'s
arithmetic: q, k and v read once and o written once at the HBM rate,
against the two products (4 B H N M d operations) at the dense
tensor-core rate of the dtype plus the softmax (4 operations a logit) at
the float32 rate, whichever is larger.  It is computed from each call's
shapes and dtype, never from which kernel ran.
"""

from __future__ import annotations

# H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# dtype name -> (bytes an element, tensor-core rate of its products)
DTYPES = {"float32": (4, PEAK_TF32_FLOPS), "bfloat16": (2, PEAK_BF16_FLOPS)}


def attention_bound_s(b: int, h: int, n: int, m: int, d: int,
                      dtype: str = "float32") -> float:
    """Least seconds for one attention call of B*H heads, N queries, M keys
    and head size d."""
    esize, rate = DTYPES[dtype]
    t_bytes = esize * (b * h * n * d * 2 + b * h * m * d * 2) \
        / PEAK_BYTES_PER_S
    t_ops = 4 * b * h * n * m * d / rate + 4 * b * h * n * m / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops)
