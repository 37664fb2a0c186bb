"""Pileup-side helpers (the port keeps only what the consensus path needs)."""
