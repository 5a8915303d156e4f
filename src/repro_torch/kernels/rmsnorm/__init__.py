"""Fused RMSNorm (K2)."""
