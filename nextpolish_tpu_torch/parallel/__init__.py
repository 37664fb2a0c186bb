"""Routes that split one contig's chain DP (the window route on one card)."""
