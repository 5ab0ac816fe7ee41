"""Where each parameter lives on the mesh, a rank's share of it, and the
weights made whole where a layer uses them.

Port of `repro.models.sharding` (`param_spec`, `batch_spec`): the FSDP
(+TP) layout, in which every weight matrix is sharded over `model` on
its "parallel" dim and over the data axes on the other (ZeRO-3 with
tensor parallelism), by name and shape with divisibility fallbacks (a
dim that does not divide an axis stays replicated on it).  The same
rules place the float32 masters and both AdamW moments, for all ten
archs, under the three layouts of `models.parallel` (``fsdp_tp``,
``dp_only``, ``tp_only``).  A spec is a tuple, an entry a dim: None, an
axis name, or a tuple of axes whose first is major, as a
`PartitionSpec` places ``("data", "model")``.  A rule reads the shape of
the JAX leaf a port leaf belongs to (`models.plan.jax_leaf`): the JAX
package stacks its scanned layers, so a per-layer norm scale, 1-D here,
is 2-D there and never takes the 1-D rule that puts ``final_norm``'s
scale over `model` at widths of 4,096 and more.  `cache_spec` places
the decode state (sharding.py:149-176): the batch over the data axes,
a K/V cache's positions over `model` from 1,024 on (flash-decoding
style), else its KV heads, and the recurrent states' channels;
`cache_slice` gives a rank's block of a leaf, `kv_split` the cut of a
K/V leaf over `model` that `models.attention`'s decode follows.  The
conv, SSM and LRU states are held as `cache_spec` cuts them: a mixer
that splits over `model` computes on its channels alone.

`shard_params` cuts a whole parameter tree to this rank's blocks and
`gather_params` puts the whole tensors back; `local_slice` gives the
cut for a leaf by name, which `models.model.init_params`,
`models.convert` and `train.checkpoint` apply to whole tensors.  One
leaf's block is not the rule's: mamba's ``in_proj`` (D, 2 Di), whose
column cut over `model` would fall across its [x | z] halves, is held
as the rank's x columns beside its z columns (`held_columns`), so that
the split mixer reads it without a wire; whole tensors and checkpoints
keep the JAX package's column order.
`on_use` is the compute's side, as GSPMD partitions the JAX package's
compute under these rules: a layer's blocks gathered on use, their
backward the reduce-scatter (`core.comm.all_gather`), inside the
layer's rematerialised body so that no whole weight outlives it.  A
leaf that `computes_tp` (attention split by heads, the FFNs and the
shared experts by width, the mamba and RG-LRU mixers by channels, the
embedding and the head by vocab) is gathered over its data axes only,
the FSDP gather, and keeps its `model` block, which the modules compute
on; under ``tp_only`` it is not gathered at all.  Every other leaf is
gathered whole; the expert leaves keep their E dim split, which the
expert-parallel branch of `models.moe` consumes as it is.
`replicated_axes` and `sharded_axes` name the axes a leaf's gradient
and its squares are summed over (`train.trainer`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import all_gather
from repro_torch.models.layers import storage_dtype
from repro_torch.models.parallel import ParallelContext
from repro_torch.models.plan import jax_leaf

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# rule: param name -> spec kinds of the trailing dims, rightmost aligned
# (sharding.py:24-56): "tp" the model axis, "dp" FSDP over the data
# axes, None replicated
_MATRIX_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head: vocab on tp
    "embed": ("tp", "dp"),
    "lm_head": ("dp", "tp"),
    # attention
    "wq": ("dp", "tp"),
    "wk": ("dp", "tp"),
    "wv": ("dp", "tp"),
    "wo": ("tp", "dp"),
    # dense ffn
    "w_gate": ("dp", "tp"),
    "w_up": ("dp", "tp"),
    "w_down": ("tp", "dp"),
    "w_in": ("dp", "tp"),
    "w_out": ("tp", "dp"),
    # moe (the stacked experts have a rule of their own)
    "router": ("dp", None),
    "shared_gate": ("dp", "tp"),
    "shared_up": ("dp", "tp"),
    "shared_down": ("tp", "dp"),
    # mamba
    "in_proj": ("dp", "tp"),
    "x_proj": ("tp", None),
    "dt_proj": (None, "tp"),
    "out_proj": ("tp", "dp"),
    "A_log": ("tp", None),
    # rg-lru
    "w_y": ("dp", "tp"),
    "w_x": ("dp", "tp"),
    "w_a": ("tp", None),
    "w_i": ("tp", None),
    "w_out_rec": ("tp", "dp"),
}

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _axis_ok(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The axes of a spec entry, the major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: Tuple[str, ...]) -> Entry:
    return axes[0] if len(axes) == 1 else axes


def _rule(parts: Sequence[str], shape: Sequence[int],
          pctx: ParallelContext) -> list:
    """The JAX package's `param_spec` (sharding.py:59-111) of a leaf at
    path `parts` whose JAX shape is `shape`."""
    name = parts[-1]
    tp, tp_n = pctx.tp_axis, pctx.tp_size
    dp = _entry(tuple(pctx.dp_axes))
    dp_n = pctx.dp_size if pctx.fsdp_params else 1
    ndim = len(shape)

    def resolve(kinds, dims):
        out = []
        for kind, d in zip(kinds, dims):
            if kind == "tp" and _axis_ok(d, tp_n):
                out.append(tp)
            elif kind == "dp" and _axis_ok(d, dp_n):
                out.append(dp)
            else:
                out.append(None)
        return out

    if "moe" in parts[:-1] and name in _EXPERT_LEAVES:
        # stacked experts (..., E, D, F): experts over tp, D / F over dp
        return [None] * (ndim - 3) + resolve(("tp", "dp", None), shape[-3:])
    # the RG-LRU's final projection shares "w_out" with the plain MLPs
    rule = _MATRIX_RULES.get(
        "w_out_rec" if name == "w_out" and "rec" in parts else name)
    if rule is None or ndim < 2:
        # biases / norms / scalars: the last dim over tp if large
        if ndim == 1 and _axis_ok(shape[0], tp_n) and shape[0] >= 4096:
            return [tp]
        return [None] * ndim
    return [None] * (ndim - 2) + resolve(rule, shape[-2:])


class _CfgKey:
    """A config as a cache key (a `ModelConfig` holds a dict and has no
    hash): equal when their reprs are."""

    def __init__(self, cfg: ModelConfig):
        self.cfg, self._repr = cfg, repr(cfg)

    def __hash__(self) -> int:
        return hash(self._repr)

    def __eq__(self, other) -> bool:
        return isinstance(other, _CfgKey) and self._repr == other._repr


@functools.lru_cache(maxsize=16)
def _whole_shapes(key: _CfgKey) -> Dict[str, Tuple[int, ...]]:
    # models.model builds the tree and imports this module: the shapes
    # are read at call time
    from repro_torch.models.model import param_shapes

    return param_shapes(key.cfg)


def param_spec(name: str, shape: Sequence[int], cfg: ModelConfig,
               pctx: ParallelContext) -> Spec:
    """The spec of the leaf `name` ("stack.3.attn.wq", a `ParamTree`'s
    dotted name) of `shape`, whole or a rank's block: the JAX package's
    `param_spec` of the JAX leaf it belongs to, on the whole leaf's
    shape (`models.model.param_shapes`; `shape` itself for a name the
    config's tree lacks), without the JAX leaf's scan axis."""
    whole = _whole_shapes(_CfgKey(cfg)).get(name, tuple(shape))
    if len(whole) != len(shape):
        raise ValueError(f"{name}: {len(shape)} dims for a leaf of "
                         f"shape {tuple(whole)}")
    n_scan = jax_leaf(name, cfg)[1]
    jshape = ((n_scan,) if n_scan else ()) + tuple(whole)
    return tuple(_rule(name.split("."), jshape, pctx)[1 if n_scan else 0:])


def sharded_axes(name: str, shape: Sequence[int], cfg: ModelConfig,
                 pctx: ParallelContext) -> Tuple[str, ...]:
    """The mesh axes the leaf is cut over: its squares' sum runs over
    them."""
    return tuple(a for e in param_spec(name, shape, cfg, pctx)
                 for a in entry_axes(e))


def replicated_axes(name: str, shape: Sequence[int], cfg: ModelConfig,
                    pctx: ParallelContext) -> Tuple[str, ...]:
    """The mesh axes the leaf is replicated on, each once: its
    gradient's sum runs over them."""
    cut = sharded_axes(name, shape, cfg, pctx)
    return tuple(a for a in dict.fromkeys(pctx.all_axes) if a not in cut)


def local_slice(name: str, shape: Sequence[int], cfg: ModelConfig,
                pctx: ParallelContext) -> tuple:
    """This rank's block of the whole leaf `name` of `shape`, an index
    for a numpy array or a tensor: along a dim cut over several axes,
    block ``i_0 n_1 ... + i_1 ...`` of the coordinates' row-major index,
    the first axis major; for a leaf that `held_columns` reorders, its
    last entry a list of the block's columns in that order."""
    cut = _block(shape, param_spec(name, shape, cfg, pctx), pctx.mesh)
    order = held_columns(name, cfg, pctx)
    if order is None:
        return cut
    return cut[:-1] + (order[cut[-1]],)


def held_columns(name: str, cfg: ModelConfig, pctx: ParallelContext
                 ) -> Optional[List[int]]:
    """The whole leaf's columns in the order the `model` ranks' blocks
    lie end to end, where that is not the leaf's own: mamba's ``in_proj``
    (D, 2 Di) of a mixer that splits over `model` (`computes_tp`), whose
    rank r holds ``[x_r | z_r]``, its channels' columns of both halves,
    the input projection of the channels it computes (ssm.py:68-69).
    None for every other leaf."""
    parts = name.split(".")
    if parts[-2:] != ["mixer", "in_proj"] or not computes_tp(name, cfg,
                                                             pctx):
        return None
    di, tp = cfg.d_inner_, pctx.tp_size
    w = di // tp
    return [c for r in range(tp) for half in (0, di)
            for c in range(half + r * w, half + (r + 1) * w)]


def _block(shape: Sequence[int], spec: Spec, mesh) -> Tuple[slice, ...]:
    """`local_slice` of a leaf of `shape` placed by `spec` on `mesh`."""
    out = []
    for dim, entry in zip(shape, spec):
        axes = entry_axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        n, i = math.prod(mesh.shape[a] for a in axes), 0
        for a in axes:
            i = i * mesh.shape[a] + mesh.coords[a]
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def batch_spec(name: str, shape: Sequence[int],
               pctx: ParallelContext) -> Spec:
    """A batch entry's spec (sharding.py:129-134): rows over the data
    axes where they divide, else replicated."""
    if not _axis_ok(shape[0], pctx.dp_size):
        return (None,) * len(shape)
    return (_entry(tuple(pctx.dp_axes)),) + (None,) * (len(shape) - 1)


# ---------------- the decode state ------------------------------------------

# the rank of each decode-state leaf's base shape (kvcache.py:22-50): the
# batch is its first dim
_CACHE_RANK = {"k": 4, "v": 4, "ck": 4, "cv": 4, "conv": 3, "ssm": 3,
               "lru": 2}
KV_LEAVES = ("k", "v", "ck", "cv")
RECURRENT_LEAVES = ("conv", "ssm", "lru")
# a K/V cache of this many positions or more is cut by positions
SEQ_SPLIT_MIN = 1024


def cache_spec(name: str, shape: Sequence[int],
               pctx: ParallelContext) -> Spec:
    """The spec of one layer's decode-state leaf `name` ("k", "v", "ck",
    "cv", "conv", "ssm", "lru") of whole `shape`: the JAX package's
    `cache_spec` (sharding.py:149-176) without a scan axis.  The batch
    over the data axes where it divides; a self or cross K/V cache (B,
    Hkv, L, hd) by positions over `model` where L divides and is at
    least 1,024, else by KV heads where they divide; the conv and SSM
    states' channels ((B, K-1, C), (B, C, N)) and the LRU's width over
    `model`."""
    spec: list = [None] * len(shape)
    bdim = len(shape) - _CACHE_RANK.get(name, len(shape))
    if 0 <= bdim < len(shape) and _axis_ok(shape[bdim], pctx.dp_size):
        spec[bdim] = _entry(tuple(pctx.dp_axes))
    tp, tp_n = pctx.tp_axis, pctx.tp_size
    if name in KV_LEAVES:
        if _axis_ok(shape[-2], tp_n) and shape[-2] >= SEQ_SPLIT_MIN:
            spec[-2] = tp
        elif _axis_ok(shape[-3], tp_n):
            spec[-3] = tp
    elif name in RECURRENT_LEAVES:
        cdim = -2 if name == "ssm" else -1
        if _axis_ok(shape[cdim], tp_n):
            spec[cdim] = tp
    return tuple(spec)


def cache_slice(name: str, shape: Sequence[int],
                pctx: ParallelContext) -> Tuple[slice, ...]:
    """This rank's block of the whole decode-state leaf `name` of
    `shape` (`cache_spec`), as `local_slice` cuts a parameter."""
    return _block(shape, cache_spec(name, shape, pctx), pctx.mesh)


def kv_split(name: str, shape: Sequence[int],
             pctx: ParallelContext) -> Optional[str]:
    """How the K/V leaf of whole `shape` (B, Hkv, L, hd) is cut over
    `model` (`cache_spec`): "positions" (each rank L / tp positions of
    every KV head), "heads" (Hkv / tp heads at every position) or None
    (whole on every `model` rank)."""
    spec = cache_spec(name, shape, pctx)
    return "positions" if spec[-2] else "heads" if spec[-3] else None


def _leaf_owners(params: nn.Module, prefix: str = ""):
    """(dotted name, owning module, attribute) of every parameter, the
    names under `prefix`."""
    for mod_name, mod in params.named_modules(prefix=prefix):
        for attr, p in mod.named_parameters(recurse=False):
            yield (f"{mod_name}.{attr}" if mod_name else attr), mod, attr


def shard_params(params: nn.Module, cfg: ModelConfig,
                 pctx: ParallelContext, prefix: str = "") -> nn.Module:
    """Cut every sharded leaf of the whole tree `params`, whose leaves are
    named `prefix` + their dotted path, to this rank's block, in place (a
    copy of the block, so that the whole tensor is freed); requires_grad
    as it was.  Returns `params`."""
    for name, mod, attr in list(_leaf_owners(params, prefix)):
        p = getattr(mod, attr)
        cut = local_slice(name, p.shape, cfg, pctx)
        if any(s != slice(None) for s in cut):
            setattr(mod, attr, nn.Parameter(p.detach()[cut].clone(),
                                            requires_grad=p.requires_grad))
    return params


def _cuts(spec: Spec, skip: Sequence[int] = ()) -> tuple:
    return tuple((d, entry_axes(e)) for d, e in enumerate(spec)
                 if e is not None and d not in skip)


def gather_leaf(name: str, t: torch.Tensor, cfg: ModelConfig,
                pctx: ParallelContext) -> torch.Tensor:
    """The whole tensor of this rank's block `t` of leaf `name`, from
    every rank's (`core.comm.all_gather` over each sharded axis), outside
    autograd, in the leaf's own column order (`held_columns`); `t` itself
    where the leaf is replicated.  Every rank of the mesh calls it."""
    cuts = _cuts(param_spec(name, t.shape, cfg, pctx))
    if not cuts:
        return t
    with torch.no_grad():
        whole = all_gather(t.detach(), pctx.mesh, cuts)
        order = held_columns(name, cfg, pctx)
        if order is not None:
            out = torch.empty_like(whole)
            out[..., order] = whole
            whole = out
        return whole


def gather_params(params: nn.Module, cfg: ModelConfig,
                  pctx: ParallelContext) -> nn.Module:
    """`shard_params`' inverse: every sharded leaf back to its whole
    tensor, in place, from every rank's block.  Returns `params`."""
    for name, mod, attr in list(_leaf_owners(params)):
        p = getattr(mod, attr)
        whole = gather_leaf(name, p, cfg, pctx)
        if whole is not p:
            setattr(mod, attr, nn.Parameter(whole,
                                            requires_grad=p.requires_grad))
    return params


# the leaves of the blocks that compute tensor-parallel over `model`, and
# the dim each is split on (None: shared by every rank's part, whole):
# attention by heads (the query heads of a rank contiguous, and so the
# KV heads of their groups), the FFNs and the shared experts by width,
# the mamba mixer by its d_inner channels and the RG-LRU block by its
# lru_width channels (a rank's contiguous block; a conv leaf, "conv.w"
# (C, K) or "conv.b", named by its mixer), the embedding and the head by
# vocab
_TP_DIM: Dict[str, Dict[str, Optional[int]]] = {
    "attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0,
             "q_norm": None, "k_norm": None},
    "ffn": {"w_gate": 1, "w_up": 1, "w_down": 0, "w_in": 1, "b_in": 0,
            "w_out": 0},
    "moe": {"shared_gate": 1, "shared_up": 1, "shared_down": 0},
    "mixer": {"in_proj": 1, "conv.w": 0, "conv.b": 0, "x_proj": 0,
              "dt_proj": 1, "dt_bias": 0, "A_log": 0, "D": 0,
              "out_proj": 0},
    "rec": {"w_y": 1, "w_x": 1, "conv.w": 0, "conv.b": 0, "w_a": 0,
            "w_i": 0, "lambda": 0, "w_out": 0},
    "": {"embed": 0, "lm_head": 1},
}
_TP_DIM["xattn"] = _TP_DIM["attn"]


def _tp_dim(name: str) -> Tuple[str, bool, Optional[int]]:
    """(the block of leaf `name`, whether the leaf is one of a block that
    can split over `model`, the dim it is split on); a conv leaf's block
    is its grandparent, the mixer, as `param_spec` tells ``w_out_rec``."""
    parts = name.split(".")
    block = parts[-2] if len(parts) > 1 else ""
    leaf = parts[-1]
    if block == "conv" and len(parts) > 2:
        block, leaf = parts[-3], f"conv.{leaf}"
    dims = _TP_DIM.get(block, {})
    return block, leaf in dims, dims.get(leaf)


def computes_tp(name: str, cfg: ModelConfig, pctx: ParallelContext) -> bool:
    """Whether the leaf `name` computes tensor-parallel over `model`, as
    GSPMD partitions the JAX package's compute under its rules: each
    `model` rank computes its own heads (when `num_heads` and
    `num_kv_heads` both divide ``tp_size``; a cut inside a head is
    resharded, so the layer's attention gathers whole), its own columns
    of the gated or plain FFN's width and of the shared experts' (where
    the width divides ``tp_size``), and its own rows of the vocabulary in
    the embedding and the head, tied or not (where it divides), and its
    own channels of the mamba mixer (where `d_inner` divides) and of the
    RG-LRU block (where `lru_width` divides): every leaf of such a mixer,
    the convs, `A_log`, `D`, `dt_bias` and `lambda` too.  Every other
    leaf (norms, the router, the experts, which are expert-parallel, the
    plain FFN's output bias) is gathered whole on use, and so is a mixer
    whose width does not divide.  False without a mesh and under
    ``dp_only``.  One rule for every module: `use_leaf` gathers such a
    leaf over its data axes only, the modules split their compute by
    it, and `train.trainer.sum_grads` counts its gradient once."""
    tp = pctx.tp_size
    block, splits, dim = _tp_dim(name)
    if pctx.mesh is None or tp == 1 or not splits:
        return False
    if block in ("attn", "xattn"):
        return cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    if block == "mixer":
        return cfg.d_inner_ % tp == 0
    if block == "rec":
        return cfg.lru_width_ % tp == 0
    shape = _whole_shapes(_CfgKey(cfg)).get(name)
    return shape is not None and shape[dim] % tp == 0


def use_leaf(name: str, p: torch.Tensor, cfg: ModelConfig,
             pctx: ParallelContext) -> torch.Tensor:
    """Leaf `name` as its use reads it: this rank's block `p`
    all-gathered whole, differentiably, over the axes it is cut on (an
    expert leaf keeps its E dim split), first cast to the compute dtype
    where its use casts it to a narrower one (`layers.storage_dtype`),
    which halves the wire's bytes and gives the same bits; `p` itself
    where the leaf is replicated, or without a mesh.  A leaf that
    `computes_tp` is gathered over its data axes only and read as this
    rank's `model` block: its block as it holds it, or, where the rules
    leave it replicated (a bias under 4,096 wide, a conv's weights, the
    RG-LRU's `lambda`), its part cut here."""
    if pctx.mesh is None:
        return p
    spec = param_spec(name, p.shape, cfg, pctx)
    parts = name.split(".")
    expert = "moe" in parts[:-1] and parts[-1] in _EXPERT_LEAVES
    cuts = _cuts(spec, skip=(len(spec) - 3,) if expert else ())
    tp = computes_tp(name, cfg, pctx)
    if tp:
        cuts = tuple((d, axes) for d, axes in (
            (d, tuple(a for a in axes if a != pctx.tp_axis))
            for d, axes in cuts) if axes)
    if cuts:
        dtype = min(p.dtype, storage_dtype(cfg, parts[-1]),
                    key=lambda t: torch.finfo(t).bits)
        p = all_gather(p, pctx.mesh, cuts, dtype)
    dim = _tp_dim(name)[2]
    if tp and dim is not None and pctx.tp_axis not in entry_axes(spec[dim]):
        n, i = pctx.tp_size, pctx.mesh.coords[pctx.tp_axis]
        p = p.narrow(dim, i * (p.shape[dim] // n), p.shape[dim] // n)
    return p


def on_use(tree: nn.Module, prefix: str, cfg: ModelConfig,
           pctx: ParallelContext):
    """`use_leaf` of every leaf of `tree`, whose leaves are named
    `prefix` + their dotted path ("stack.3"): nested dicts (lists for a
    `ModuleList`) of what a layer reads; `tree` itself without a mesh.
    Every rank of the mesh calls it in one order."""
    if pctx.mesh is None:
        return tree
    if isinstance(tree, nn.ModuleList):
        return [on_use(t, f"{prefix}.{i}", cfg, pctx)
                for i, t in enumerate(tree)]
    out = {attr: on_use(sub, f"{prefix}.{attr}", cfg, pctx)
           for attr, sub in tree.named_children()}
    for attr, p in tree.named_parameters(recurse=False):
        out[attr] = use_leaf(f"{prefix}.{attr}", p, cfg, pctx)
    return out
