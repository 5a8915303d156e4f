"""Flash attention forward (K1)."""
