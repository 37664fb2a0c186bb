"""Per-cell status flags (lib/base.h:10-26).

A copy of nextpolish_tpu/models/flags.py: only its imports may differ,
and none had to (they are relative).
"""

FLAG_ZERO = 1  # no real coverage / low-quality marker (lowercase in FASTA)
FLAG_COVERAGE = 2  # chosen base below min_count_ratio_skip
FLAG_DEPTH = 4
FLAG_SNP = 8
FLAG_THIRD = 16
FLAG_INSERT = 32
FLAG_LEFT = 64
FLAG_RIGHT = 128
