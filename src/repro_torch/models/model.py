"""Public model API: init, parameter count, prefill and decode forwards.

Port of the serving half of `repro.models.model` (training forwards and
the losses wait for the training slice).  Entry points take parameters
built by `init_params` (random, from a seed, on the card by default) or
by `models.convert.params_from_numpy` (the JAX package's parameters).
An encdec model's prefill takes ``batch["encoder_embeds"]`` (B, Sx, D),
the frames its encoder reads (the modality frontend is a stub, as in the
JAX package); a vlm's ``batch["image_embeds"]`` (B, Sx, D).  Either is
cast to the compute dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as T
from repro_torch.models.ffn import ffn_width, gated
from repro_torch.models.layers import (
    ParamTree,
    apply_norm,
    dense_init,
    embed_init,
    init_norm,
    storage_dtype,
    torch_dtype,
)


# the batch entry a family's cross-attention reads: (B, Sx, D) encoder
# frames or image embeddings
CROSS_INPUT = {"encdec": "encoder_embeds", "vlm": "image_embeds"}


def init_params(cfg: ModelConfig, seed: int,
                device: DeviceLike = None) -> ParamTree:
    """Random parameters with the JAX package's distributions, drawn on
    `device` from a `torch.Generator` seeded with `seed`, each weight in
    its storage dtype (`layers.storage_dtype`)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                            storage_dtype(cfg, "embed")),
        "stack": T.init_stack(gen, cfg, T.stack_plan(cfg)),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  torch.float32)
    if cfg.family == "encdec":
        p["encoder"] = T.init_stack(gen, cfg, T.encoder_plan(cfg))
        p["enc_norm"] = init_norm(cfg.norm, cfg.d_model, dev)
    return ParamTree(p)


def _ffn_params(cfg: ModelConfig, kind: str, active_only: bool) -> int:
    D = cfg.d_model
    if kind == "moe":
        m = cfg.moe
        per_leaf = m.num_experts * D * m.d_ff_expert
        if active_only:  # as the JAX count: experts scaled by top_k / E
            per_leaf = int(per_leaf * m.top_k / m.num_experts)
        shared = 3 * D * m.d_ff_shared if m.num_shared_experts else 0
        return D * m.num_experts + 3 * per_leaf + shared
    d_ff = ffn_width(cfg, kind)
    return 3 * D * d_ff if gated(cfg) else 2 * D * d_ff + d_ff + D


def _attn_params(cfg: ModelConfig, cross: bool) -> int:
    D, hd = cfg.d_model, cfg.head_dim_
    dq, dkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    n = 2 * D * dq + 2 * D * dkv
    n += (dq + 2 * dkv) if cfg.qkv_bias else 0
    return n + (2 * hd if cfg.qk_norm and not cross else 0)


def _norm_params(cfg: ModelConfig) -> int:
    return cfg.d_model * (2 if cfg.norm == "layernorm" else 1)


def _layer_params(cfg: ModelConfig, kind: str, active_only: bool) -> int:
    D = cfg.d_model
    norm = _norm_params(cfg)
    if kind == "ssm":   # ln1 and the mamba mixer (ssm.init_mamba)
        Di, N, R = cfg.d_inner_, cfg.ssm.state_dim, cfg.dt_rank_
        conv = Di * cfg.ssm.conv_kernel + Di
        return (norm + D * 2 * Di + conv + Di * (R + 2 * N) + R * Di
                + Di + Di * N + Di + Di * D)
    if kind == "rglru":   # rglru.init_rglru_block
        Dl = cfg.lru_width_
        mixer = 3 * D * Dl + 2 * Dl * Dl + (RG.CONV_KERNEL + 1) * Dl + Dl
    else:
        mixer = _attn_params(cfg, cross=kind == "cross_attn")
    if kind == "decoder":   # ln_x and the cross-attention
        mixer += norm + _attn_params(cfg, cross=True)
    return 2 * norm + mixer + _ffn_params(cfg, kind, active_only)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count of the JAX package's parameter tree (no
    allocation); `active_only` counts top_k of the routed experts."""
    kinds = T.stack_plan(cfg).kinds + T.encoder_plan(cfg).kinds
    total = sum(_layer_params(cfg, kind, active_only) for kind in kinds)
    total += cfg.vocab_size * cfg.d_model                       # embed
    total += _norm_params(cfg)                                  # final norm
    if cfg.family == "encdec":
        total += _norm_params(cfg)                              # enc_norm
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size                   # lm_head
    return total


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(torch_dtype(cfg.compute_dtype))


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x, upcast=cfg.norm_upcast)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ head.float()


def _encode(params, encoder_embeds: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """The encoder stack over (B, Sx, D) frames, then its norm
    (model.py:89-97)."""
    S = encoder_embeds.shape[1]
    ctx = T.LayerCtx(positions=torch.arange(S, device=encoder_embeds.device),
                     mode="prefill")
    x = encoder_embeds.to(torch_dtype(cfg.compute_dtype))
    x, _, _ = T.apply_stack(params["encoder"], x, cfg, ctx,
                            T.encoder_plan(cfg))
    return apply_norm(cfg.norm, params["enc_norm"], x, upcast=cfg.norm_upcast)


def _cross_src(params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Optional[torch.Tensor]:
    """What cross-attention reads (model.py:140-145): the encoder's output
    (encdec) or the image embeddings (vlm)."""
    name = CROSS_INPUT.get(cfg.family)
    if name is None:
        return None
    if cfg.family == "encdec":
        return _encode(params, batch[name], cfg)
    return batch[name].to(torch_dtype(cfg.compute_dtype))


def forward_prefill(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Returns (last-token logits (B, V) f32, decode caches).

    With cache_len, the self K/V caches are padded with zeros to that
    length so decode steps have slots to write into; a local-attention
    cache to min(cache_len, window), its ring's length (model.py:154-173).
    Cross K/V keep the source's length, SSM and LRU states have none:
    they are left as they are."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cross_src = _cross_src(params, batch, cfg)
    x = _embed(params, tokens, cfg)
    ctx = T.LayerCtx(positions=torch.arange(S, device=tokens.device),
                     cross_src=cross_src, mode="prefill")
    plan = T.stack_plan(cfg)
    x, _, caches = T.apply_stack(params["stack"], x, cfg, ctx, plan)
    if cache_len is not None and cache_len > S:
        caches = [_pad_kv(c, kind, cfg, S, cache_len)
                  for c, kind in zip(caches, plan.kinds)]
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


def _pad_kv(cache: Dict[str, torch.Tensor], kind: str, cfg: ModelConfig,
            S: int, cache_len: int) -> Dict[str, torch.Tensor]:
    if "k" not in cache or cache["k"].shape[2] != S:
        return cache   # recurrent or cross state, or a ring at its window
    target = cache_len
    if kind == "local_attn":
        target = min(cache_len, cfg.hybrid.local_window)
    return {name: F.pad(t, (0, 0, 0, target - S))
            if target > S and name in ("k", "v") else t
            for name, t in cache.items()}


def forward_decode(
    params,
    tokens: torch.Tensor,        # (B, 1)
    positions: torch.Tensor,     # (B,)
    caches: List[Dict[str, torch.Tensor]],
    cfg: ModelConfig,
    cross_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decode step; writes the caches in place.  Returns (logits
    (B, V) f32, caches).  `cross_len` (B,) is each row's source length in
    the cross caches, which may be longer (a serving slot's); None reads
    every cross position, as after `forward_prefill`."""
    x = _embed(params, tokens, cfg)
    ctx = T.LayerCtx(pos=positions, cross_len=cross_len, mode="decode")
    x, _, caches = T.apply_stack(params["stack"], x, cfg, ctx,
                                 T.stack_plan(cfg), caches=caches)
    return _logits(params, x, cfg)[:, 0], caches
