"""Compact symbol alphabet for the score-chain engine.

The reference engine works in BAM 4-bit nibble space with 12-bit 3-mers
(lib/contig.c:360-363, lib/base.h:8).  Observed symbols are in practice only
{pad(0), A(1), C(2), DEL(3), G(4), T(8), N(15)} — BASE_DEL=3 aliases the 'M'
ambiguity nibble in the reference as well (lib/config.h:19) so the aliasing
is inherited, not introduced.  We remap to a dense 8-symbol alphabet so a
3-mer fits in 9 bits (512 dense slots) and the chain DP state is 8 lanes:

    compact:  0 pad | 1 A | 2 C | 3 DEL | 4 G | 5 T | 6 N | 7 other-IUPAC

"other-IUPAC" buckets the 9 remaining ambiguity nibbles together (the
reference keeps them distinct; they are vanishingly rare in real reads).

A copy of nextpolish_tpu/ops/symbols.py: only its imports may differ,
and none had to (they are relative).
"""
from __future__ import annotations

import numpy as np

S = 8  # alphabet size
K3 = S * S * S  # dense 3-mer space (512)
PAD, A, C, DEL, G, T, N, OTHER = range(8)

# BAM nibble (0..15) -> compact symbol
NIB_TO_SYM = np.array(
    [PAD, A, C, DEL, G, OTHER, OTHER, OTHER, T, OTHER, OTHER, OTHER, OTHER,
     OTHER, OTHER, N],
    dtype=np.uint8,
)
# compact symbol -> BAM nibble ("=ACMGRSVTWYHKDBN" indexing)
SYM_TO_NIB = np.array([0, 1, 2, 3, 4, 8, 15, 15], dtype=np.uint8)
# compact symbol -> ASCII (DEL has no letter; kept as 'M' to mirror nibble 3)
SYM_TO_ASCII = np.frombuffer(b"=ACMGTNN", dtype=np.uint8).copy()


def kmer3(prev2: np.ndarray, prev1: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Dense 3-mer index (b1, b2, b3) -> b1*64 + b2*8 + b3."""
    return (
        prev2.astype(np.int32) * (S * S)
        + prev1.astype(np.int32) * S
        + cur.astype(np.int32)
    )


def rolling_kmers(syms: np.ndarray) -> np.ndarray:
    """Rolling 3-mers over a symbol stream with PAD beyond the left edge
    (semantics of contig_left_kmer chains, lib/contig.c:360-383)."""
    prev1 = np.empty_like(syms)
    prev1[0] = PAD
    prev1[1:] = syms[:-1]
    prev2 = np.empty_like(syms)
    prev2[:2] = PAD
    prev2[2:] = syms[:-2]
    return kmer3(prev2, prev1, syms)
