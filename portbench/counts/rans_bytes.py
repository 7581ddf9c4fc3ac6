"""Bytes one level of rANS coding must move, and the bandwidth it is held
to (the K5 rooflines).

Frozen copy of chip_smoke.py:1238-1250 (`rans_bytes`) and :351
(PEAK_BYTES_PER_S). Departure: the tables are given by their shapes
(cap, Lp), all the count reads of them.
"""

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def rans_bytes(table_shapes, n_valid: int, encode: bool, words_moved: int) -> int:
    """Bytes one level's four stages must move: per valid position its
    symbol and the two table entries it needs on encode, or its whole row
    on decode (the search reads it), plus the words written or read, and on
    decode the symbols and prev written and prev read (int32 each)."""
    total = 4 * words_moved
    for stage, (cap, lp) in enumerate(table_shapes):
        if encode:
            total += n_valid * (4 + 8)
        else:
            total += n_valid * 4 * lp + cap * 4 * (2 if stage == 0 else 3)
    return total
