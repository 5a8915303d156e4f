"""Batched autoregressive serving loop built on decode_step."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from ..models.params import init_params
from ..models.transformer import decode_step, init_cache_specs


@dataclass
class ServeResult:
    tokens: torch.Tensor         # [B, steps] int32
    steps: int


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, {"tokens": [B, 1]}) -> (next [B], cache)."""

    def serve_step(params, cache, batch):
        logits, cache = decode_step(cfg, params, cache, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


@torch.inference_mode()
def greedy_decode(cfg: ModelConfig, params, prompt: torch.Tensor,
                  max_new_tokens: int = 8, max_len: int = 128) -> ServeResult:
    """Greedy generation: prompt [B, S0] -> [B, max_new_tokens], on the
    prompt's device."""
    b, s0 = prompt.shape
    if s0 + max_new_tokens > max_len:
        # decode_step writes one KV slot per step; past max_len there is no
        # slot left to write
        raise ValueError(
            f"greedy_decode: prompt length {s0} + max_new_tokens "
            f"{max_new_tokens} exceeds the KV cache (max_len={max_len}) "
            "— raise max_len or generate fewer tokens")
    if cfg.local_global_pattern > 0 and cfg.sliding_window > 0:
        cache_len = min(max_len, cfg.sliding_window)
        if s0 + max_new_tokens > cache_len:
            # every layer's cache has min(max_len, sliding_window) slots (the
            # reference's cache_shapes); past them a global layer has no slot
            # to write (the reference writes a clamped one and goes on, and
            # stops being right), so refuse before any launch
            raise ValueError(
                f"greedy_decode: {cfg.name} alternates local and global "
                f"layers; prompt length {s0} + max_new_tokens "
                f"{max_new_tokens} exceeds its KV cache of {cache_len} slots "
                f"(min(max_len={max_len}, sliding_window="
                f"{cfg.sliding_window}))")
    # the cache is all zeros: the generator is never drawn from
    cache = init_params(init_cache_specs(cfg, b, max_len),
                        torch.Generator(device=prompt.device), prompt.device)
    step_fn = make_serve_step(cfg)
    # feed the prompt token-by-token (prefill-by-decode; simple and exact)
    tok = None
    for i in range(s0):
        tok, cache = step_fn(params, cache, {"tokens": prompt[:, i:i + 1]})
    out = []
    for _ in range(max_new_tokens):
        out.append(tok)
        tok, cache = step_fn(params, cache, {"tokens": tok[:, None]})
    return ServeResult(tokens=torch.stack(out, dim=1), steps=max_new_tokens)
