"""Nucleotide encodings.

Mirrors the reference's two-level encoding (core/sequence.h):
- "real" letters A,C,G,T as small ints 0..3 (reference: Real_seq_letter, sequence.h:155),
- ambiguous IUPAC letters as 4-bit bitmasks (reference: Seq_letter, sequence.h:20-31).

Here real letters are plain int8 numpy arrays; the bitmask form is only used
transiently while parsing FASTA.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
GAP = -1  # fully-missing marker in parsed (ambiguous) sequences

_BIT_A, _BIT_C, _BIT_G, _BIT_T = 1, 2, 4, 8

# IUPAC char -> 4-bit mask (bit order A,C,G,T)
IUPAC_TO_BITS = {
    "A": _BIT_A, "C": _BIT_C, "G": _BIT_G, "T": _BIT_T, "U": _BIT_T,
    "R": _BIT_A | _BIT_G, "Y": _BIT_C | _BIT_T, "S": _BIT_C | _BIT_G,
    "W": _BIT_A | _BIT_T, "K": _BIT_G | _BIT_T, "M": _BIT_A | _BIT_C,
    "B": _BIT_C | _BIT_G | _BIT_T, "D": _BIT_A | _BIT_G | _BIT_T,
    "H": _BIT_A | _BIT_C | _BIT_T, "V": _BIT_A | _BIT_C | _BIT_G,
    "N": _BIT_A | _BIT_C | _BIT_G | _BIT_T,
    "-": _BIT_A | _BIT_C | _BIT_G | _BIT_T,  # gaps treated as fully missing
    ".": _BIT_A | _BIT_C | _BIT_G | _BIT_T,
    "?": _BIT_A | _BIT_C | _BIT_G | _BIT_T,
}

REAL_TO_CHAR = np.array(["A", "C", "G", "T"])
CHAR_TO_REAL = {"A": A, "C": C, "G": G, "T": T, "U": T}

_BITS_TO_REAL = np.full(16, -1, dtype=np.int8)
_BITS_TO_REAL[_BIT_A] = A
_BITS_TO_REAL[_BIT_C] = C
_BITS_TO_REAL[_BIT_G] = G
_BITS_TO_REAL[_BIT_T] = T

# lookup table from uint8 char codes to bitmasks; 0 = invalid char
_CHARCODE_TO_BITS = np.zeros(256, dtype=np.uint8)
for ch, bits in IUPAC_TO_BITS.items():
    _CHARCODE_TO_BITS[ord(ch)] = bits
    _CHARCODE_TO_BITS[ord(ch.lower())] = bits


def str_to_bits(s: str) -> np.ndarray:
    """Parse a nucleotide string into 4-bit ambiguity masks (0 = invalid char)."""
    codes = np.frombuffer(s.encode("ascii", errors="replace"), dtype=np.uint8)
    return _CHARCODE_TO_BITS[codes]


def bits_to_real(bits: np.ndarray) -> np.ndarray:
    """Bitmasks -> real letters; ambiguous/invalid become -1."""
    return _BITS_TO_REAL[np.clip(bits, 0, 15)]


def str_to_real(s: str) -> np.ndarray:
    """Parse an unambiguous ACGT string into int8 real letters (raises on others)."""
    out = bits_to_real(str_to_bits(s))
    if (out < 0).any():
        bad = int(np.argmax(out < 0))
        raise ValueError(f"non-ACGT character {s[bad]!r} at position {bad}")
    return out


def real_to_str(seq: np.ndarray) -> str:
    return "".join(REAL_TO_CHAR[np.asarray(seq)])


def is_ambiguous(bits: np.ndarray) -> np.ndarray:
    """True where a bitmask denotes anything other than exactly one real letter."""
    return _BITS_TO_REAL[np.clip(bits, 0, 15)] < 0
