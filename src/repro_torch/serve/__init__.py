"""Batched autoregressive serving."""
