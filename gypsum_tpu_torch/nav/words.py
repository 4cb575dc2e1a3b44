"""30-bit navigation word machinery: Hamming (32,26) parity per IS-GPS-200.

Each word carries 24 data bits + 6 parity bits; the transmitted data bits are
XOR'd with the previous word's last parity bit (D30*), and the parity
equations mix in the previous word's D29*/D30* (IS-GPS-200 §20.3.5 and Table
20-XIV). The reference implements checking only, imperatively
(gypsum/navigation_message_parser.py:307-391); here the same equations drive
both the checker and an *encoder* (used by the signal synthesizer and test
fixtures), vectorized over words.
"""

from __future__ import annotations

import numpy as np

from gypsum_tpu_torch.core.constants import (
    BITS_PER_WORD,
    DATA_BITS_PER_WORD,
    PARITY_BITS_PER_WORD,
    WORDS_PER_SUBFRAME,
)

# IS-GPS-200 Table 20-XIV: for each parity bit D25..D30, the 1-indexed source
# data bits XOR'd together, and whether D29* or D30* is mixed in.
_PARITY_TAPS: tuple[tuple[str, tuple[int, ...]], ...] = (
    ("d29", (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23)),
    ("d30", (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24)),
    ("d29", (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22)),
    ("d30", (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23)),
    ("d30", (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24)),
    ("d29", (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24)),
)


def compute_parity(source_bits: np.ndarray, d29_star: int, d30_star: int) -> np.ndarray:
    """The 6 parity bits for one word's 24 *source* (pre-complement) data bits."""
    out = np.empty(PARITY_BITS_PER_WORD, dtype=np.int8)
    for i, (star, taps) in enumerate(_PARITY_TAPS):
        acc = d29_star if star == "d29" else d30_star
        for t in taps:
            acc ^= int(source_bits[t - 1])
        out[i] = acc
    return out


def encode_word(source_bits: np.ndarray, d29_star: int, d30_star: int) -> np.ndarray:
    """Transmitted 30 bits for 24 source data bits given the previous word's
    last two parity bits: data is complemented by D30*, parity appended."""
    parity = compute_parity(source_bits, d29_star, d30_star)
    data_tx = (np.asarray(source_bits, dtype=np.int8) ^ d30_star).astype(np.int8)
    return np.concatenate([data_tx, parity])


def solve_parity_closing_bits(
    source_bits_22: np.ndarray, d29_star: int, d30_star: int
) -> np.ndarray:
    """Choose source bits 23-24 so the word's parity ends D29 = D30 = 0.

    IS-GPS-200 §20.3.3.2 reserves the last two data bits of words 2 (HOW) and
    10 to force the parity chain to zero at subframe boundaries — this is what
    lets a decoder prime D29*/D30* = 0 at the top of every subframe (the
    reference silently relies on it, gypsum/navigation_message_parser.py:205).
    """
    for b23 in (0, 1):
        for b24 in (0, 1):
            candidate = np.concatenate(
                [np.asarray(source_bits_22, dtype=np.int8), np.array([b23, b24], dtype=np.int8)]
            )
            parity = compute_parity(candidate, d29_star, d30_star)
            if parity[4] == 0 and parity[5] == 0:
                return candidate
    raise RuntimeError("unsolvable parity closing bits (cannot happen: equations are linear)")


def decode_words(
    subframe_bits: np.ndarray, strict: bool = False
) -> tuple[np.ndarray, list[int]]:
    """Decode one subframe's 300 transmitted bits into 240 source data bits.

    Returns (source_bits [240], failed_word_indexes). D29*/D30* start at 0 (the
    encoder guarantees the previous subframe closed at zero). With ``strict``
    a parity failure raises; otherwise failures are only reported, matching the
    reference's log-only behavior (gypsum/navigation_message_parser.py:384-391).
    """
    bits = np.asarray(subframe_bits, dtype=np.int8)
    if bits.shape != (BITS_PER_WORD * WORDS_PER_SUBFRAME,):
        raise ValueError(f"expected 300 bits, got {bits.shape}")
    d29_star, d30_star = 0, 0
    source = np.empty(DATA_BITS_PER_WORD * WORDS_PER_SUBFRAME, dtype=np.int8)
    failed: list[int] = []
    for w in range(WORDS_PER_SUBFRAME):
        word = bits[w * BITS_PER_WORD : (w + 1) * BITS_PER_WORD]
        data_tx, parity_rx = word[:DATA_BITS_PER_WORD], word[DATA_BITS_PER_WORD:]
        src = (data_tx ^ d30_star).astype(np.int8)
        expected = compute_parity(src, d29_star, d30_star)
        if not np.array_equal(expected, parity_rx):
            failed.append(w)
            if strict:
                raise ParityError(f"word {w} parity check failed")
        source[w * DATA_BITS_PER_WORD : (w + 1) * DATA_BITS_PER_WORD] = src
        d29_star, d30_star = int(parity_rx[4]), int(parity_rx[5])
    return source, failed


class ParityError(Exception):
    pass
