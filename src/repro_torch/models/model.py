"""Public model API: init, parameter count, training forwards and losses,
prefill and decode forwards.

Port of `repro.models.model`.  Entry points take parameters built by
`init_params` (random, from a seed, on the card by default) or by
`models.convert.params_from_numpy` (the JAX package's parameters); with
``masters=True`` both give trainable float32 masters, which
`forward_train`, `loss_fn` and `train.trainer` differentiate; on a
mesh each rank holds its blocks (`models.sharding`) and the train
forwards gather them on use, or compute tensor-parallel on them
(`models.sharding.computes_tp`): the embedding as a vocab-parallel
lookup and the head as vocab-parallel logits with a logsumexp combined
over `model`.  The serving forwards do the same on a mesh, and
return the logits whole and the decode state as this rank's blocks
(`kvcache.CacheBlocks`).  An encdec model's prefill takes
``batch["encoder_embeds"]`` (B, Sx, D), the frames its encoder reads (the
modality frontend is a stub, as in the JAX package); a vlm's
``batch["image_embeds"]`` (B, Sx, D).  Either is cast to the compute
dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    storage_config,
    storage_dtype,
    torch_dtype,
)
from repro_torch.core.comm import all_gather, all_reduce_max
from repro_torch.models.kvcache import CacheBlocks, recut
from repro_torch.models.parallel import (ParallelContext, single_device_ctx,
                                        tp_enter, tp_exit)
from repro_torch.models.sharding import (computes_tp, kv_split, local_slice,
                                        on_use, shard_params, use_leaf)


# the batch entry a family's cross-attention reads: (B, Sx, D) encoder
# frames or image embeddings
CROSS_INPUT = {"encdec": "encoder_embeds", "vlm": "image_embeds"}


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: shapes, no
    memory."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _draw(cfg: ModelConfig, gen: torch.Generator, keep) -> ParamTree:
    """The tree in the JAX package's draw order, each leaf drawn by
    `gen` on its device; `keep(name, tree)` takes each top-level leaf and
    each layer's tree as it is drawn, before the next draw, and returns
    what the tree holds of it."""
    dev = gen.device

    def stack(name: str, plan: T.StackPlan) -> nn.ModuleList:
        return nn.ModuleList(
            [keep(f"{name}.{i}", ParamTree(T.init_layer(gen, cfg, kind)))
             for i, kind in enumerate(plan.kinds)])

    def norm(name: str) -> ParamTree:
        return keep(name, ParamTree(init_norm(cfg.norm, cfg.d_model, dev)))

    p = {
        "embed": keep("embed", embed_init(gen, cfg.vocab_size, cfg.d_model,
                                          storage_dtype(cfg, "embed"))),
        "stack": stack("stack", T.stack_plan(cfg)),
        "final_norm": norm("final_norm"),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = keep("lm_head", dense_init(
            gen, cfg.d_model, cfg.vocab_size, torch.float32))
    if cfg.family == "encdec":
        p["encoder"] = stack("encoder", T.encoder_plan(cfg))
        p["enc_norm"] = norm("enc_norm")
    return ParamTree(p)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf's whole shape by dotted name, in the tree's order, with
    nothing allocated: the tree drawn on the meta device (the JAX
    package's `param_shapes`, model.py:43)."""
    tree = _draw(cfg, _MetaGenerator(), lambda name, t: t)
    return {name: tuple(p.shape) for name, p in tree.named_parameters()}


def init_params(cfg: ModelConfig, seed: int, device: DeviceLike = None,
                masters: bool = False,
                pctx: Optional[ParallelContext] = None) -> ParamTree:
    """Random parameters with the JAX package's distributions, drawn on
    `device` from a `torch.Generator` seeded with `seed`, each weight in
    its storage dtype (`layers.storage_dtype`); with `masters`, trainable
    float32 masters (`layers.storage_config`) of the same draws.  Given a
    mesh `pctx`, every rank draws the whole tree, a layer (or the
    embedding, or the head) at a time, and keeps its block of each leaf
    before the next draw (`models.sharding.local_slice`): the bits of a
    one-process draw, and never the whole model on a rank."""
    dev = resolve_device(device)
    cfg = storage_config(cfg, masters)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def keep(name: str, t):
        if pctx is None or pctx.mesh is None:
            return t
        if isinstance(t, torch.Tensor):
            return t[local_slice(name, t.shape, cfg, pctx)].clone()
        return shard_params(t, cfg, pctx, prefix=name)

    return _draw(cfg, gen, keep).requires_grad_(masters)


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


def _vocab_split(name: str, cfg: ModelConfig, pctx: ParallelContext
                 ) -> Tuple[Optional[ParallelContext], int]:
    """(`pctx`, the first word of this rank's rows) where the leaf `name`
    (the embedding or the head) splits by vocab over `model`; (None, 0)
    where it is whole."""
    if not computes_tp(name, cfg, pctx):
        return None, 0
    return pctx, (pctx.mesh.coords[pctx.tp_axis]
                  * (cfg.vocab_size // pctx.tp_size))


def _head_name(cfg: ModelConfig) -> str:
    return "embed" if cfg.tie_embeddings else "lm_head"


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           pctx: ParallelContext = single_device_ctx()) -> torch.Tensor:
    """The tokens' rows; split by vocab, each rank's rows where the token
    falls in them and zeros elsewhere, summed over `model`."""
    dtype = torch_dtype(cfg.compute_dtype)
    tp, lo = _vocab_split("embed", cfg, pctx)
    if tp is None:
        return params["embed"][tokens].to(dtype)
    n = params["embed"].shape[0]
    local = tokens - lo
    inside = (local >= 0) & (local < n)
    rows = params["embed"][local.clamp(0, n - 1)].to(dtype)
    return tp_exit(torch.where(inside[..., None], rows, 0), tp)


def _logits(params, x: torch.Tensor, cfg: ModelConfig,
            pctx: ParallelContext = single_device_ctx()) -> torch.Tensor:
    """The final norm, then the head: every word's logit, or this rank's
    words' where the head splits by vocab over `model`."""
    x = apply_norm(cfg.norm, params["final_norm"], x, upcast=cfg.norm_upcast)
    tp, _ = _vocab_split(_head_name(cfg), cfg, pctx)
    return tp_enter(x.float(), tp) @ _head(params, cfg).float()


def _encode(params, encoder_embeds: torch.Tensor, cfg: ModelConfig,
            mode: str = "prefill",
            pctx: ParallelContext = single_device_ctx()) -> torch.Tensor:
    """The encoder stack over (B, Sx, D) frames, then its norm
    (model.py:89-97); `mode` "train" rematerialises its layers."""
    S = encoder_embeds.shape[1]
    ctx = T.LayerCtx(positions=torch.arange(S, device=encoder_embeds.device),
                     mode=mode)
    x = encoder_embeds.to(torch_dtype(cfg.compute_dtype))
    x, _, _ = T.apply_stack(params["encoder"], x, cfg, ctx,
                            T.encoder_plan(cfg), pctx=pctx, name="encoder")
    return apply_norm(cfg.norm, params["enc_norm"], x, upcast=cfg.norm_upcast)


def _cross_src(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
               mode: str = "prefill",
               pctx: ParallelContext = single_device_ctx()
               ) -> Optional[torch.Tensor]:
    """What cross-attention reads (model.py:140-145): the encoder's output
    (encdec) or the image embeddings (vlm)."""
    name = CROSS_INPUT.get(cfg.family)
    if name is None:
        return None
    if cfg.family == "encdec":
        return _encode(params, batch[name], cfg, mode, pctx)
    return batch[name].to(torch_dtype(cfg.compute_dtype))


def _on_use(params, cfg: ModelConfig, pctx: ParallelContext):
    """The tree as the train forwards read it: on a mesh, the top-level
    leaves as `models.sharding.use_leaf` gives them (the final and
    encoder norms whole; the embedding and the head this rank's words,
    gathered over the data axes only, where they split by vocab over
    `model`) and the stacks as they are, each layer gathering its own;
    `params` itself without a mesh or when done already."""
    if pctx.mesh is None or not isinstance(params, nn.Module):
        return params
    out = {name: sub if name in ("stack", "encoder")
           else on_use(sub, name, cfg, pctx)
           for name, sub in params.named_children()}
    for name, p in params.named_parameters(recurse=False):
        out[name] = use_leaf(name, p, cfg, pctx)
    return out


def _train_hidden(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  pctx: ParallelContext) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack's output over the whole sequence in train mode (no
    decode state, layers rematerialised when ``cfg.remat == "full"``),
    and the summed router aux loss."""
    params = _on_use(params, cfg, pctx)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cross_src = _cross_src(params, batch, cfg, mode="train", pctx=pctx)
    x = _embed(params, tokens, cfg, pctx)
    ctx = T.LayerCtx(positions=torch.arange(S, device=tokens.device),
                     cross_src=cross_src, mode="train")
    x, aux, _ = T.apply_stack(params["stack"], x, cfg, ctx,
                              T.stack_plan(cfg), pctx=pctx)
    return x, aux


def forward_train(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  pctx: ParallelContext = single_device_ctx()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) f32, aux_loss) (model.py:100-124).  On a
    mesh, `batch` is this rank's rows (`train.trainer.shard_batch`) and
    `params` its blocks, which the forward gathers on use; where the head
    splits by vocab, the logits are this rank's words' (B, S, V / tp)."""
    params = _on_use(params, cfg, pctx)
    x, aux = _train_hidden(params, batch, cfg, pctx)
    return _logits(params, x, cfg, pctx), aux


def forward_train_hidden(
    params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
    pctx: ParallelContext = single_device_ctx(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like `forward_train` but stops before the LM head, at the final
    norm (for `softmax_xent_chunked`; model.py:262-281)."""
    params = _on_use(params, cfg, pctx)
    x, aux = _train_hidden(params, batch, cfg, pctx)
    return apply_norm(cfg.norm, params["final_norm"], x,
                      upcast=cfg.norm_upcast), aux


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 z_weight: float = 1e-4,
                 tp: Optional[ParallelContext] = None, lo: int = 0):
    """Mean token cross-entropy (+ z-loss) in fp32: (ce + z, ce).  With
    `tp`, `logits` are this rank's words from `lo` on, and the logsumexp
    and the gold logit are combined over `model` (`_lse_gold`)."""
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    else:
        zero = torch.zeros(targets.shape, dtype=torch.float32,
                           device=logits.device)
        lse, gold = _lse_gold(*_xent_logits(zero - 1e30, zero, zero, logits,
                                            targets.long(), lo), tp)
    ce = (lse - gold).mean()
    z = (lse**2).mean() * z_weight
    return ce + z, ce


def _pick_chunk(v: int, target: int) -> int:
    c = min(target, v)
    while v % c:
        c -= 1
    return max(c, 1)


def _xent_chunk(m, s, gold, x32, h, targets, lo: int):
    """One vocab chunk of the online logsumexp: logits (B, S, c) of the
    chunk, the running max and sum, the gold logit where the target
    falls in the chunk."""
    return _xent_logits(m, s, gold, x32 @ h, targets, lo)


def _xent_logits(m, s, gold, logits, targets, lo: int):
    """`_xent_chunk` of the chunk's logits, its words from `lo` on."""
    c = logits.shape[-1]
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    t_loc = targets - lo
    in_chunk = (t_loc >= 0) & (t_loc < c)
    g = torch.gather(logits, -1, t_loc.clamp(0, c - 1)[..., None])[..., 0]
    return m_new, s, gold + torch.where(in_chunk, g, 0.0)


def softmax_xent_chunked(
    x: torch.Tensor,        # (B, S, D) final normed hidden
    head: torch.Tensor,     # (D, V)
    targets: torch.Tensor,  # (B, S)
    chunk: int,
    z_weight: float = 1e-4,
    tp: Optional[ParallelContext] = None,
    lo: int = 0,
):
    """Vocab-chunked CE: the (B, S, V) logits are never materialized.

    Online logsumexp over vocab chunks, each chunk rematerialised in the
    backward pass (`torch.utils.checkpoint`, as the JAX package's
    `jax.checkpoint` scan body; model.py:215-259).  With `tp`, `head` is
    this rank's words from `lo` on (D, V / tp), chunked here, and the
    logsumexp and the gold logit are combined over `model`
    (`_lse_gold`)."""
    D, V = head.shape
    c = _pick_chunk(V, chunk)
    x32, h32 = tp_enter(x.float(), tp), head.float()
    targets = targets.long()
    B, S = targets.shape
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    gold = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for a in range(0, V, c):
        m, s, gold = checkpoint(_xent_chunk, m, s, gold, x32,
                                h32[:, a:a + c], targets, lo + a,
                                use_reentrant=False)
    lse, gold = _lse_gold(m, s, gold, tp)
    ce = (lse - gold).mean()
    z = (lse**2).mean() * z_weight
    return ce + z, ce


def _lse_gold(m, s, gold, tp: Optional[ParallelContext]):
    """(logsumexp, gold logit) from the running max `m`, the sum `s` of
    exp(logit - m) and the gold logit of this rank's words: with `tp`,
    the max combined over `model` outside autograd (the logsumexp does
    not depend on it), the rescaled sums and the gold logits (the target
    falls in one rank's words) added over `model` differentiably."""
    if tp is not None:
        top = all_reduce_max(m, tp.mesh, tp.tp_axis)
        s = tp_exit(s * torch.exp(m - top), tp)
        gold = tp_exit(gold, tp)
        m = top
    return m + torch.log(torch.clamp(s, min=1e-30)), gold


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            pctx: ParallelContext = single_device_ctx()):
    """(total, {"loss": ce, "aux": router aux, "total": total})
    (model.py:284-301): cross-entropy with z-loss, vocab-chunked when
    ``cfg.loss_chunk_vocab``, plus the router aux term for MoE configs.

    On a mesh this is one rank's share: `params` its blocks, gathered
    on use, whose backward reduce-scatters each leaf's gradient over the
    axes it is cut on, or computed tensor-parallel over `model` (the
    embedding and the head by vocab, the cross-entropy's logsumexp
    combined over `model`); `batch` its rows, the cross-entropy theirs
    (every `model` rank of a row the same), and the aux term what its
    MoE layers return (every shard's mean in the all-to-all branch, its
    own in the local one).  The JAX package's global loss is the mean
    over the data ranks (`train.trainer` takes it), and its gradient the
    sum of every rank's autograd over the axes the leaf is cut on (here)
    and replicated on (in the trainer), over dp, and over tp too for a
    leaf every `model` rank computes whole (`train.trainer.sum_grads`)."""
    params = _on_use(params, cfg, pctx)
    tp, lo = _vocab_split(_head_name(cfg), cfg, pctx)
    if cfg.loss_chunk_vocab:
        x, aux = forward_train_hidden(params, batch, cfg, pctx)
        total, ce = softmax_xent_chunked(x, _head(params, cfg),
                                         batch["targets"],
                                         cfg.loss_chunk_vocab, tp=tp, lo=lo)
    else:
        logits, aux = forward_train(params, batch, cfg, pctx)
        total, ce = softmax_xent(logits, batch["targets"], tp=tp, lo=lo)
    if cfg.moe is not None:
        total = total + cfg.moe.router_aux_weight * aux
    return total, {"loss": ce, "aux": aux, "total": total}


def forward_prefill(
    params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    cache_len: Optional[int] = None,
    pctx: ParallelContext = single_device_ctx(),
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """Returns (last-token logits (B, V) f32, decode caches).

    With cache_len, the self K/V caches are padded with zeros to that
    length so decode steps have slots to write into; a local-attention
    cache to min(cache_len, window), its ring's length (model.py:154-173).
    Cross K/V keep the source's length, SSM and LRU states have none:
    they are left as they are.

    On a mesh `batch` is this rank's rows (`models.sharding.batch_spec`)
    and `params` its blocks, gathered on use or computed tensor-parallel
    over `model` as in training; the logits are whole on every rank,
    gathered over `model` from each rank's words where the head splits
    by vocab, and the caches a `kvcache.CacheBlocks` of this rank's
    blocks (`_blocks`), the padding cut with them."""
    params = _on_use(params, cfg, pctx)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    cross_src = _cross_src(params, batch, cfg, pctx=pctx)
    x = _embed(params, tokens, cfg, pctx)
    ctx = T.LayerCtx(positions=torch.arange(S, device=tokens.device),
                     cross_src=cross_src, mode="prefill")
    plan = T.stack_plan(cfg)
    x, _, caches = T.apply_stack(params["stack"], x, cfg, ctx, plan,
                                 pctx=pctx)
    if cache_len is not None and cache_len > S:
        caches = [_pad_kv(c, kind, cfg, S, cache_len)
                  for c, kind in zip(caches, plan.kinds)]
    if pctx.mesh is not None:
        caches = _blocks(caches, cfg, pctx)
    return _whole_logits(params, x[:, -1:], cfg, pctx)[:, 0], caches


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


def _blocks(caches: List[Dict[str, torch.Tensor]], cfg: ModelConfig,
            pctx: ParallelContext) -> CacheBlocks:
    """A prefill's decode state on a mesh as this rank's blocks: each
    self or cross K/V pair, the rank's heads where its attention splits
    by them, else whole, recut to the cache's cut of its whole shape
    (`models.sharding.kv_split`, `kvcache.recut`: one gather a pair where
    they differ); the recurrent states as they are: the rank's channels
    where its mixer splits over `model`, as `models.sharding.cache_spec`
    cuts them, else whole."""
    Hkv = cfg.num_kv_heads
    out, cuts = [], []
    for cache in caches:
        layer, cut = dict(cache), {}
        for pair in (("k", "v"), ("ck", "cv")):
            if pair[0] not in cache:
                continue
            k = cache[pair[0]]
            L = k.shape[2]
            to = kv_split(pair[0], (k.shape[0], Hkv, L, k.shape[3]), pctx)
            was = "heads" if k.shape[1] != Hkv else None
            layer.update(zip(pair, recut([cache[n] for n in pair], was, to,
                                         L, pctx)))
            cut.update(dict.fromkeys(pair, to))
        out.append(layer)
        cuts.append(cut)
    return CacheBlocks(out, cuts)


def _whole_logits(params, x: torch.Tensor, cfg: ModelConfig,
                  pctx: ParallelContext) -> torch.Tensor:
    """`_logits`, every word's on every rank: where the head splits by
    vocab, each rank's words gathered over `model` (one gather)."""
    logits = _logits(params, x, cfg, pctx)
    tp, _ = _vocab_split(_head_name(cfg), cfg, pctx)
    if tp is None:
        return logits
    return all_gather(logits, pctx.mesh, ((logits.ndim - 1, (tp.tp_axis,)),))


def forward_decode(
    params,
    tokens: torch.Tensor,        # (B, 1)
    positions: torch.Tensor,     # (B,)
    caches: List[Dict[str, torch.Tensor]],
    cfg: ModelConfig,
    cross_len: Optional[torch.Tensor] = None,
    pctx: ParallelContext = single_device_ctx(),
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decode step; writes the caches in place.  Returns (logits
    (B, V) f32, caches).  `cross_len` (B,) is each row's source length in
    the cross caches, which may be longer (a serving slot's); None reads
    every cross position, as after `forward_prefill`.  On a mesh, as
    `forward_prefill`: this rank's rows and blocks, the caches a
    `kvcache.CacheBlocks` (from `forward_prefill` or
    `kvcache.init_cache`), the logits whole."""
    if pctx.mesh is not None and not isinstance(caches, CacheBlocks):
        raise TypeError("decode on a mesh takes a rank's CacheBlocks "
                        "(forward_prefill, kvcache.init_cache with pctx)")
    params = _on_use(params, cfg, pctx)
    x = _embed(params, tokens, cfg, pctx)
    ctx = T.LayerCtx(pos=positions, cross_len=cross_len, mode="decode")
    x, _, new = T.apply_stack(params["stack"], x, cfg, ctx,
                              T.stack_plan(cfg), caches=caches, pctx=pctx)
    if isinstance(caches, CacheBlocks):
        new = CacheBlocks(new, caches.cuts)
    return _whole_logits(params, x, cfg, pctx)[:, 0], new
