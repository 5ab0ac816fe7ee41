"""Continuous-batching serving engine (prefill + decode over slot caches).

Port of `repro.serve.engine`.  A fixed pool of slots shares one batched
decode cache.  New requests prefill one at a time, at their own length,
and are copied into a free slot; every engine tick runs one batched
decode step for all slots.  As in the JAX package, the tick decodes
every slot, idle ones included (token 0 at the slot's last position):
their tokens take MoE capacity (T = slots), so skipping them would
change the live slots' tokens.

An encdec model's encoder reads zero frames of the prompt's length, and
a vlm's cross-attention zero image embeddings of `num_image_tokens`, as
in the JAX engine (engine.py:70-78): its modality frontends are stubs.
A request may bring its own (`Request.embeds`, (Sx, D)) instead.

The cache is written in place: a prefill's decode state is copied into
its slot, each leaf by its kind (as the JAX engine's `put`,
engine.py:82-99): self and cross K/V along the sequence, the rest of the
slot zeroed (a local-attention ring of length W holds min(L, W)
entries); conv, SSM and LRU states whole, or on a mesh the rank's
channels of them.  The engine keeps each slot's
source length and decode masks the cross cache past it, so a slot
decodes as a fresh prefill-then-decode does; the JAX engine attends the
zero padding too (ROADMAP.md Queue 3, R4).  The port's conv states are
always K-1 rows, right-aligned, where the JAX engine pads a shorter
prompt's state at the end (ROADMAP.md Queue 3, R3).  Decode writes its
K/V at each slot's position (or ring slot) and its recurrent states in
place.  Greedy decoding is the tested path; with
``greedy=False`` the first token of a request is drawn from its
softmax with a `torch.Generator` seeded by the request id (the JAX
package draws it with `jax.random.categorical`, so the bits differ),
and later tokens are greedy, as in the JAX package.

The f32 router, decode attention and head match the JAX package's f32
dots only with TF32 off, PyTorch's default; the entry points
(`launch.serve`, chip_smoke.py) set it so.

On a mesh (`pctx`, serving over `model`) every rank runs this host
loop on the same queue, with its blocks of the weights
(`models.model.init_params` or `models.convert.params_from_numpy` given
the context) and of the slots' cache (`kvcache.init_cache` given it),
and gets the same tokens: the logits come back whole on every rank.  A
prefill pads its K/V to the slots' length, so that its blocks are the
slot's, and a split mixer's recurrent states come out as the rank's
channels, the slot's blocks of them (`models.sharding.cache_spec`); a
cross cache whose source is shorter than the slot is gathered over
`model` and cut again (`_insert`, `kvcache.recut`).  The engine
decodes with the JAX engine's MoE dispatch (the local branch at a
tick, the all-to-all at a prefill whose length divides tp).  A mesh
with more than one data rank is refused: the JAX engine cannot prefill an MoE arch there (a
batch of one over `data` in its `shard_map`), and slots over `data`
wait (ROADMAP Queue 1 item 7c).

The engine counts its prefills and decode ticks and the host seconds
each took (each ends in a copy of the next token to the host, which
waits for the device), and on a mesh the seconds of each on the wire
and the bytes sent (`core.comm.Mesh.wire_s`, `sent_bytes`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.kvcache import init_cache, recut
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import (
    CROSS_INPUT,
    forward_decode,
    forward_prefill,
)
from repro_torch.models.parallel import ParallelContext, single_device_ctx


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (L,) int32
    max_new_tokens: int = 16
    eos_id: int = -1               # -1: never stop early
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # (Sx, D) encoder frames (encdec) or image embeddings (vlm); None: zeros
    embeds: Optional[np.ndarray] = None


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        pctx: ParallelContext = single_device_ctx(),
        slots: int = 4,
        max_seq: int = 128,
        greedy: bool = True,
        device: DeviceLike = None,
    ):
        if pctx.mesh is not None and pctx.dp_size > 1:
            raise ValueError(
                f"serving on {pctx.dp_size} data ranks: slots over `data` "
                "are not served yet (ROADMAP Queue 1 item 7c, 'slots over "
                "data'); serve on a mesh of data 1")
        self.cfg = cfg
        self.params = params
        self.pctx = pctx
        self.slots = slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.device = resolve_device(device)
        self.cache = init_cache(cfg, slots, max_seq, device=self.device,
                                pctx=pctx)
        self.pos = np.zeros(slots, np.int32)
        # each slot's source length in its cross caches (encdec, vlm)
        self.cross_len = None
        if cfg.family in CROSS_INPUT:
            self.cross_len = torch.zeros(slots, dtype=torch.int64,
                                         device=self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.prefills = 0
        self.prefill_tokens = 0
        self.prefill_s = 0.0
        self.ticks = 0
        self.decode_s = 0.0
        self.prefill_wire_s = self.decode_wire_s = 0.0
        self.prefill_sent = self.decode_sent = 0

    # ---------------- request plumbing -------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    @torch.no_grad()
    def _insert(self, slot: int, req: Request):
        L = len(req.prompt)
        if L > self.max_seq:
            raise ValueError(f"prompt of {L} tokens > max_seq {self.max_seq}")
        t0 = time.perf_counter()
        wire = self._wire()
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                 device=self.device)
        mesh = self.pctx.mesh is not None
        logits, pc = forward_prefill(
            self.params, self._batch(req, tokens), self.cfg,
            cache_len=self.max_seq if mesh else None, pctx=self.pctx)
        # the single-request state into the batched slot
        tp = self.pctx.tp_size
        for i, (layer, pre) in enumerate(zip(self.cache, pc)):
            for name, buf in layer.items():
                src = pre[name].to(buf.dtype)
                if name in ("k", "v", "ck", "cv"):   # (1, Hkv, len, hd)
                    n = src.shape[2]
                    if mesh:   # the slot's block of the source's positions
                        was, to = pc.cuts[i][name], self.cache.cuts[i][name]
                        n *= tp if was == "positions" else 1
                        src, = recut([src], was, to, buf.shape[2] * (
                            tp if to == "positions" else 1), self.pctx)
                    held = src.shape[2]
                    if held > buf.shape[2]:
                        raise ValueError(f"{held} source positions > the "
                                         f"cache's {buf.shape[2]}")
                    buf[slot, :, :held] = src[0]
                    buf[slot, :, held:] = 0
                    if name == "ck":
                        self.cross_len[slot] = n
                else:                    # conv (K-1, C), ssm (Di, N), lru
                    buf[slot] = src[0]
        if self.greedy:
            tok = int(torch.argmax(logits[0]))
        else:
            gen = torch.Generator(device=logits.device).manual_seed(req.rid)
            tok = int(torch.multinomial(torch.softmax(logits[0], -1), 1,
                                        generator=gen))
        self.prefills += 1
        self.prefill_tokens += L
        self.prefill_s += time.perf_counter() - t0
        wire_s, sent = self._wire(wire)
        self.prefill_wire_s += wire_s
        self.prefill_sent += sent
        req.out_tokens.append(tok)
        self.active[slot] = req
        self.pos[slot] = L

    def _wire(self, since=None):
        """The mesh's (wire seconds, bytes sent) so far, or since `since`;
        (0, 0) without a mesh."""
        mesh = self.pctx.mesh
        now = (mesh.wire_s, mesh.sent_bytes) if mesh is not None else (0, 0)
        return now if since is None else (now[0] - since[0],
                                          now[1] - since[1])

    def _batch(self, req: Request, tokens: torch.Tensor) -> dict:
        """The prefill's inputs: tokens, and the encoder's frames or the
        image embeddings, zeros unless the request brings its own."""
        cfg = self.cfg
        name = CROSS_INPUT.get(cfg.family)
        if name is None:
            return {"tokens": tokens}
        dt = torch_dtype(cfg.compute_dtype)
        if req.embeds is not None:
            src = torch.as_tensor(np.asarray(req.embeds, np.float32),
                                  device=self.device).to(dt)
        else:
            n = len(req.prompt) if name == "encoder_embeds" else (
                cfg.num_image_tokens)
            src = torch.zeros((n, cfg.d_model), dtype=dt, device=self.device)
        return {"tokens": tokens, name: src[None]}

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    # ---------------- engine tick -------------------------------------------
    @torch.no_grad()
    def step(self) -> int:
        """Admit queued requests, run one batched decode step.  Returns the
        number of active requests after the tick."""
        for slot in self._free_slots():
            if not self.queue:
                break
            self._insert(slot, self.queue.pop(0))

        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        t0 = time.perf_counter()
        wire = self._wire()
        toks = np.zeros((self.slots, 1), np.int64)
        for i in live:
            toks[i, 0] = self.active[i].out_tokens[-1]
        logits, self.cache = forward_decode(
            self.params, torch.as_tensor(toks, device=self.device),
            torch.as_tensor(self.pos.astype(np.int64), device=self.device),
            self.cache, self.cfg, cross_len=self.cross_len, pctx=self.pctx)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.ticks += 1
        self.decode_s += time.perf_counter() - t0
        wire_s, sent = self._wire(wire)
        self.decode_wire_s += wire_s
        self.decode_sent += sent
        for i in live:
            r = self.active[i]
            self.pos[i] += 1
            tok = int(nxt[i])
            r.out_tokens.append(tok)
            if (
                tok == r.eos_id
                or len(r.out_tokens) >= r.max_new_tokens
                or self.pos[i] >= self.max_seq - 1
            ):
                r.done = True
                self.finished.append(r)
                self.active[i] = None
        return sum(r is not None for r in self.active)

    def run_to_completion(self, max_ticks: int = 1000) -> List[Request]:
        for _ in range(max_ticks):
            self.step()
            if not self.queue and all(r is None for r in self.active):
                break
        return self.finished
