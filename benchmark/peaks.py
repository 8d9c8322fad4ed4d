"""The chip's published peaks and the byte count of the program's K1.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit. A configuration names its FLOP peak by key ("peak").
"""

from __future__ import annotations

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "bfloat16_flops_per_s": 989e12,
    "tf32_flops_per_s": 495e12,
    "float32_flops_per_s": 67e12,
}


def k1_bytes(unique_rows: int, rows: int, row_bytes: int) -> int:
    """The bytes K1 (`gather_rows_scaled`: uint8 rows gathered, widened to
    float32 and scaled) needs for one call: each distinct uint8 row read
    once, every float32 row written, and the int64 ids read."""
    return unique_rows * row_bytes + rows * (row_bytes * 4 + 8)
