"""One conformer layer's model FLOPs (``reference/blocks/conformer.py``)."""

from __future__ import annotations


def layer(n: int, d: int, blk: dict) -> float:
    """Over n positions at width d: the two feed-forward networks (d to e d
    and back, 4 e n d^2 each), the q, k, v, out and position projections
    (10 n d^2; the position rows are n too), the content and position
    scores and the weighted sum (6 n^2 d), the convolution module's first
    pointwise (d to c d), depthwise (k taps over d) and second pointwise
    (d to d)."""
    e, c, k = blk["ffn_expansion_factor"], blk["conv_expansion_factor"], blk["conv_kernel_size"]
    return (2 * 4.0 * e * n * d * d + 10.0 * n * d * d + 6.0 * n * n * d
            + 2.0 * n * d * c * d + 2.0 * n * d * k + 2.0 * n * d * d)
