"""Mamba2 SSD scan (K3)."""
