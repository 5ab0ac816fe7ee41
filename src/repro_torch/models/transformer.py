"""Transformer stacks: per-layer init and apply, over the stack plan
(`models.plan`).

Port of `repro.models.transformer`: uniform stacks of ``self_attn``,
``moe`` or ``ssm`` layers, MoE stacks with leading ``dense`` layers
(DeepSeekMoE), the hybrid (Griffin) stack of ``rglru`` and
``local_attn`` layers with its tail, the vlm stack (Llama-3.2-Vision:
every `cross_attn_every`-th layer a ``cross_attn`` layer over image
embeddings) and the encoder-decoder (seamless-m4t: bidirectional
``encoder`` layers, `encoder_plan`, then ``decoder`` layers with
self-attention and cross-attention over the encoder's output).  The JAX
package scans stacked superblocks with `lax.scan`; the port keeps the
layers in an `nn.ModuleList` in `StackPlan.kinds` order and loops over
them in Python.  Three modes: "train" (full sequence, no decode state;
with ``cfg.remat == "full"`` each layer is rematerialised in the
backward pass, `torch.utils.checkpoint`, as the JAX package checkpoints
its scanned blocks), "prefill" (full sequence, also returns the decode
state; an encoder layer returns none) and "decode" (one token against
the state, which it writes in place).  Trained on a mesh, a layer holds
this rank's blocks of its weights and gathers them on use; its
attention, FFN, shared experts and mamba or RG-LRU mixer compute
tensor-parallel over `model` where `models.sharding.computes_tp` says
so.  Served on a mesh, prefill and decode do the same, and decode
follows each K/V cache's cut over `model` (`kvcache.CacheBlocks.cuts`:
by KV heads or by positions, `models.attention`) and reads and writes a
split mixer's recurrent states as the rank's channels; the MoE layer's
decode takes the expert-parallel local branch (`models.moe`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.layers import apply_norm, init_norm
from repro_torch.models.parallel import ParallelContext, single_device_ctx
from repro_torch.models.plan import (  # noqa: F401  (the stack's API)
    StackPlan,
    encoder_plan,
    stack_plan,
)
from repro_torch.models.sharding import computes_tp, on_use


# --------------------------------------------------------------------------
# per-layer init / apply
# --------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Dict:
    def norm():
        return init_norm(cfg.norm, cfg.d_model, gen.device)

    if kind == "ssm":
        return {"ln1": norm(), "mixer": S.init_mamba(gen, cfg)}
    p = {"ln1": norm()}
    if kind == "rglru":
        p["rec"] = R.init_rglru_block(gen, cfg)
    else:   # self_attn / moe / dense / local_attn / encoder / decoder
        p["attn"] = A.init_attention(gen, cfg, cross=kind == "cross_attn")
    if kind == "decoder":
        p["ln_x"] = norm()
        p["xattn"] = A.init_attention(gen, cfg, cross=True)
    p["ln2"] = norm()
    if kind == "moe":
        p["moe"] = M.init_moe(gen, cfg)
    else:
        p["ffn"] = F.init_ffn(gen, cfg, d_ff=F.ffn_width(cfg, kind))
    return p


@dataclasses.dataclass
class LayerCtx:
    positions: Optional[torch.Tensor] = None   # (S,) prefill
    pos: Optional[torch.Tensor] = None          # (B,) decode position
    cross_src: Optional[torch.Tensor] = None    # (B, Sx, D) prefill
    cross_len: Optional[torch.Tensor] = None    # (B,) decode: valid Sx
    mode: str = "prefill"                       # train | prefill | decode


def _write(cache: Dict, new: Dict) -> Dict:
    """Decode state into the cache's tensors, in place."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def _cross(p, h: torch.Tensor, cfg: ModelConfig, ctx: LayerCtx,
           cache: Optional[Dict], tp: Optional[ParallelContext] = None,
           seq: Optional[ParallelContext] = None
           ) -> Tuple[torch.Tensor, Dict]:
    """Cross-attention: prefill projects the source's K/V and returns
    them as the decode state; decode reads them from `cache`, masked past
    `ctx.cross_len` (all of it when None).  With `tp`, this rank's heads
    (`attention.attention_block`); with `seq`, the cache is this rank's
    positions (`attention.cross_attention_decode`)."""
    if ctx.mode == "decode":
        ck, cv = cache["ck"], cache["cv"]
        n = ctx.cross_len
        if n is None:
            whole = ck.shape[2] * (seq.tp_size if seq is not None else 1)
            n = torch.full((h.shape[0],), whole, device=h.device)
        return A.cross_attention_decode(p, h, cfg, ck, cv, n, tp, seq), cache
    ck, cv = A.project_cross_kv(p, ctx.cross_src, cfg, tp)
    return (A.cross_attention_block(p, h, cfg, ck, cv, tp),
            {"ck": ck, "cv": cv})


def apply_layer(
    kind: str,
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx: LayerCtx,
    cache: Optional[Dict] = None,
    pctx: ParallelContext = single_device_ctx(),
    prefix: Optional[str] = None,
    cut: Optional[Dict[str, Optional[str]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Returns (x, aux_loss, new_cache); in decode mode new_cache is
    `cache`, written in place; in train mode None.  On a mesh `p` holds
    this rank's blocks of the leaves named `prefix` + their path
    ("stack.3"), gathered here on use (`models.sharding.on_use`), and
    `pctx` reaches the MoE layer (expert-parallel with model ranks) and
    each block that computes tensor-parallel (`split`); a prefill's K/V
    are the rank's heads where its attention splits.  In decode mode
    `cut` tells how each K/V leaf of `cache` is cut over `model`
    (`kvcache.CacheBlocks.cuts`)."""
    if pctx.mesh is not None:
        if prefix is None:
            raise ValueError("a layer on a mesh needs its leaves' prefix")
        p = on_use(p, prefix, cfg, pctx)

    def split(block: str, leaf: str) -> Optional[ParallelContext]:
        """`pctx` where the layer's `block` computes tensor-parallel over
        `model`, else None."""
        if pctx.mesh is None or not computes_tp(f"{prefix}.{block}.{leaf}",
                                                cfg, pctx):
            return None
        return pctx

    def seq(name: str, block: str) -> Optional[ParallelContext]:
        """`pctx` where the K/V leaf `name` of `cache` is cut by
        positions over `model`, else None; a cut by heads needs the
        `block` split by heads."""
        how = (cut or {}).get(name)
        if how == "heads" and split(block, "wq") is None:
            raise ValueError(f"{prefix}.{name}: a cache cut by heads for "
                             "attention that does not split by them")
        return pctx if how == "positions" else None

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    decode = ctx.mode == "decode"
    train = ctx.mode == "train"

    h = apply_norm(cfg.norm, p["ln1"], x, upcast=cfg.norm_upcast)
    if kind == "ssm":
        tp = split("mixer", "in_proj")
        if decode:
            y, cs, ss = S.mamba_decode(p["mixer"], h, cfg, cache["conv"],
                                       cache["ssm"], tp)
            new_cache = _write(cache, {"conv": cs, "ssm": ss})
        elif train:
            y, new_cache = S.mamba_mix(p["mixer"], h, cfg, tp=tp), None
        else:
            y, cs, ss = S.mamba_mix(p["mixer"], h, cfg, return_state=True,
                                    tp=tp)
            new_cache = {"conv": cs, "ssm": ss}
        return x + y, aux, new_cache   # the mixer is the whole block

    if kind == "rglru":
        tp = split("rec", "w_y")
        if decode:
            y, cs, hs = R.rglru_block_decode(p["rec"], h, cfg, cache["conv"],
                                             cache["lru"], tp)
            new_cache = _write(cache, {"conv": cs, "lru": hs})
        elif train:
            y, new_cache = R.rglru_block_mix(p["rec"], h, cfg, tp=tp), None
        else:
            y, cs, hs = R.rglru_block_mix(p["rec"], h, cfg,
                                          return_state=True, tp=tp)
            new_cache = {"conv": cs, "lru": hs}
    elif kind == "cross_attn":
        y, new_cache = _cross(p["attn"], h, cfg, ctx, cache,
                              split("attn", "wq"), seq("ck", "attn"))
        new_cache = None if train else new_cache
    elif kind == "encoder":   # bidirectional, no decode state
        y = A.attention_block(p["attn"], h, cfg, ctx.positions, causal=False,
                              tp=split("attn", "wq"))
        new_cache = None
    else:   # self_attn / moe / dense / local_attn / decoder
        window = cfg.hybrid.local_window if kind == "local_attn" else 0
        if decode:
            y, nk, nv = A.attention_block_decode(
                p["attn"], h, cfg, ctx.pos, cache["k"], cache["v"],
                window=window, tp=split("attn", "wq"), seq=seq("k", "attn"))
            new_cache = {"k": nk, "v": nv}
        elif train:
            y = A.attention_block(p["attn"], h, cfg, ctx.positions,
                                  window=window, tp=split("attn", "wq"))
            new_cache = None
        else:
            y, kc, vc = A.attention_block(p["attn"], h, cfg, ctx.positions,
                                          window=window, return_kv=True,
                                          tp=split("attn", "wq"))
            new_cache = {"k": kc, "v": vc}
    x = x + y
    if kind == "decoder":   # then cross-attention over the encoder's output
        h = apply_norm(cfg.norm, p["ln_x"], x, upcast=cfg.norm_upcast)
        y, cross = _cross(p["xattn"], h, cfg, ctx, cache,
                          split("xattn", "wq"), seq("ck", "xattn"))
        if decode:
            new_cache = cache
        elif not train:
            new_cache = {**new_cache, **cross}
        x = x + y

    h = apply_norm(cfg.norm, p["ln2"], x, upcast=cfg.norm_upcast)
    if kind == "moe":
        y, aux = M.apply_moe(p["moe"], h, cfg, pctx, split("moe",
                                                            "shared_gate"))
    else:
        y = F.apply_ffn(p["ffn"], h, cfg,
                        split("ffn", "w_gate" if F.gated(cfg) else "w_in"))
    return x + y, aux, new_cache


# --------------------------------------------------------------------------
# stack apply
# --------------------------------------------------------------------------


def apply_stack(
    params: nn.ModuleList,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx: LayerCtx,
    plan: StackPlan,
    caches: Optional[List[Dict]] = None,
    pctx: ParallelContext = single_device_ctx(),
    name: str = "stack",
) -> Tuple[torch.Tensor, torch.Tensor, List[Dict]]:
    """Run every layer in order.  Returns (x, total_aux, new_caches);
    new_caches is None in train mode.  `name` is the stack's in the
    model's tree ("stack" or "encoder"): on a mesh each layer gathers its
    blocks on use, inside its rematerialised body when ``cfg.remat ==
    "full"``, so that the backward gathers them again and no whole weight
    outlives its layer.  A mesh's decode state (`kvcache.CacheBlocks`)
    gives each layer its K/V leaves' cuts."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    train = ctx.mode == "train"
    remat = train and cfg.remat == "full"
    new_caches = None if train else []
    cuts = getattr(caches, "cuts", None)
    for i, kind in enumerate(plan.kinds):
        c = caches[i] if caches is not None else None
        if remat:
            x, aux, nc = checkpoint(apply_layer, kind, params[i], x, cfg, ctx,
                                    c, pctx, f"{name}.{i}",
                                    use_reentrant=False)
        else:
            x, aux, nc = apply_layer(kind, params[i], x, cfg, ctx, c, pctx,
                                     f"{name}.{i}",
                                     cuts[i] if cuts is not None else None)
        aux_total = aux_total + aux
        if not train:
            new_caches.append(nc)
    return x, aux_total, new_caches
