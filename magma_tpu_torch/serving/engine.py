"""Continuous-batching serving engine over size-classed KV cache pools.

Port of ``magma_tpu/serving/engine.py``.  Requests map to batch *slots* of
resident KV cache pools on the card:

* prefill: the prompt runs through the LM into a 1-row scratch cache,
  right-padded to a ``prefill_bucket`` multiple (``kv_len`` masks the
  padding, the first token reads the last true position); the scratch
  row is copied into the slot's pool row and the first token sampled.  A
  prompt longer than ``prefill_chunk`` prefills in chunks through
  ``gptj.forward(read_history=True)``, one chunk riding each decode window
  of the first busy pool.
* decode: one window of ``decode_window`` steps for all B slots of a pool
  at once, with per-row cache positions.  Empty and finished slots ride
  along with a frozen ``cur_len``; their writes land at that position
  (clamped into the pool, ``gptj._write_cache``) and the next prefill into
  the slot overwrites the row.

Pools of several (slots, max_len) classes serve short requests from short
rows; a request takes the smallest class that holds its prompt and budget.
The batch a request decodes in sets its kernel chain: a 1-slot pool takes
the whole-model decode (K8), 2-8 slots the per-layer products with the
fused adapter (K5; int4: the layer boundary K6), 16 slots the int8 tiles
and K5.

Host and card: a window's dispatch copies its (B,) positions, active mask
and sampling parameters from fresh pinned buffers without waiting, and the
pipelined mode (default) dispatches a pool's next window, chained from the
device-resident last tokens, before it fetches the previous window's
tokens: one device-to-host copy per window.  Sampling draws from the
engine's own ``torch.Generator`` on the device, seeded by ``seed``.

Tensor parallelism (``mesh=``, ``engine.py:377-399``): one process per
rank, each holding its Megatron shards of the LM (the caller shards the
tree: ``parallel/sharding.py`` ``shard_lm_params``) and head-sharded pools, the forward's
collectives over "tp" (``models/gptj.py``).  Every rank must take the same
host decisions (admission, EOS, retirement, windows) or a collective waits
forever: every rank samples from the same gathered logits, and the
sampled tokens are then broadcast from the first rank over "tp", so the
ranks hold the same tokens whatever a sampling kernel does (one broadcast
of B ids a step; JAX's output tokens are replicated likewise).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from magma_tpu_torch.models import gptj
from magma_tpu_torch.ops.sampling import sample_token, sample_token_batched, strip_after_eos
from magma_tpu_torch.parallel.mesh import broadcast


@dataclasses.dataclass
class _Slot:
    req_id: int
    tokens: List[int]
    max_new_tokens: int
    sampling: Tuple[float, int, float]  # (temperature, top_k, top_p)
    # pipelined mode: the install's first token, on the device until the
    # next collect, so admission waits for nothing
    pending_first: Optional[torch.Tensor] = None
    install_next_write: int = 0


@dataclasses.dataclass
class _PendingWindow:
    """A dispatched window whose tokens are not fetched yet (pipelined)."""
    toks: torch.Tensor            # (B, n) on the device
    start_lens: np.ndarray        # cur_lens at dispatch
    active: np.ndarray            # active mask at dispatch
    req_ids: List[Optional[int]]  # slot -> request id at dispatch


@dataclasses.dataclass
class _InflightPrefill:
    group_id: int
    slot_id: int
    req_id: int
    embeds: torch.Tensor     # (1, s, D) the whole prompt
    s: int                   # true prompt length
    off: int                 # positions prefilled so far
    scratch: Dict            # 1-row cache of a whole number of chunks
    max_new: int
    sampling: Tuple[float, int, float]


@dataclasses.dataclass
class FinishedRequest:
    req_id: int
    tokens: List[int]        # generated ids, EOS included if emitted
    finish_reason: str       # "eos" | "length"


class _CacheGroup:
    """One size class: a dense (B, max_len) cache pool and its host
    bookkeeping."""

    def __init__(self, cfg, max_batch: int, max_len: int, eos_token: int, device, mesh=None):
        self.max_batch = max_batch
        self.max_len = max_len
        # under tp, this rank's heads of the pool (sharding.kv_cache_spec)
        self.cache = gptj.init_kv_cache(cfg, max_batch, max_len, device=device, mesh=mesh)
        self.cur_lens = np.zeros(max_batch, np.int32)
        self.last_toks = np.full(max_batch, eos_token, np.int64)
        # pipelined mode: the last tokens the next window chains from
        self.last_dev = torch.full((max_batch,), eos_token, dtype=torch.long, device=device)
        self.pending: Optional[_PendingWindow] = None
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        # per-slot sampling parameters (meaningful where a slot is live)
        self.temps = np.zeros(max_batch, np.float32)
        self.top_ks = np.zeros(max_batch, np.int32)
        self.top_ps = np.zeros(max_batch, np.float32)

    @property
    def active(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots])


def _prefill_full(cfg, params, embeds, prompt_len: int, *, scratch_len: int, mesh=None):
    """Whole-prompt prefill into a fresh 1-row scratch cache of
    ``scratch_len`` positions.  Returns (scratch, hidden (1, 1, D) at the
    last true position)."""
    dev = embeds.device
    scratch = gptj.init_kv_cache(cfg, 1, scratch_len, device=dev, mesh=mesh)
    hidden, scratch = gptj.forward(
        cfg, params, embeds, cache=scratch, cache_index=0,
        kv_len=torch.full((1,), prompt_len, dtype=torch.int32, device=dev), return_hidden=True,
        mesh=mesh)
    return scratch, hidden[:, prompt_len - 1:prompt_len]


def _chunk_body(cfg, params, scratch, emb_chunk, offset: int, true_len: int, mesh=None):
    """One chunk of an incremental prefill into a 1-row scratch cache: it
    attends to the history ``[0, offset)`` and causally to itself."""
    dev = emb_chunk.device
    hidden, scratch = gptj.forward(
        cfg, params, emb_chunk, cache=scratch, cache_index=offset,
        kv_len=torch.full((1,), true_len, dtype=torch.int32, device=dev), return_hidden=True,
        read_history=True, mesh=mesh)
    return scratch, hidden[:, true_len - 1:true_len]


def _install_slot(cfg, params, cache, scratch, slot: int, last_h, generator,
                  sampling: Tuple[float, int, float], *, top_p_mode: str,
                  mesh=None) -> torch.Tensor:
    """Copy a finished scratch prefill into pool row ``slot`` and sample the
    request's first token (a 0-d device tensor).  A chunked scratch may be
    longer than the pool: its position axis (2 for K/V, 3 for the int8
    scales) is clipped to the pool's length."""
    max_len = cache["k"].shape[2]
    for name, pool in cache.items():
        src = scratch[name][..., :max_len] if name.endswith("_scale") else \
            scratch[name][:, :, :max_len]
        pool[:, slot] = src[:, 0]
    dev = last_h.device
    t, k, p = sampling
    logits = gptj.lm_head(cfg, params, last_h, mesh)[:, 0]
    tok = sample_token_batched(
        generator, logits, torch.full((1,), t, device=dev),
        torch.full((1,), k, dtype=torch.int32, device=dev), torch.full((1,), p, device=dev),
        vocab_size=cfg.vocab_size, top_p_mode=top_p_mode)
    return broadcast(tok, mesh, "tp")[0]


def _window_body(cfg, params, cache, last_toks, cur_lens, active, generator, sample_fn, *,
                 n_steps: int, eos_token: int, mesh=None):
    """``n_steps`` decode steps for every row of one pool; rows not active
    keep their ``cur_len``, emit EOS and embed token 0 (EOS may be no
    token id).  ``sample_fn(generator, logits)`` returns (B,) tokens.
    Returns (cache, tokens (B, n_steps))."""
    toks, tok, lens = [], last_toks, cur_lens
    step = active.to(lens.dtype)
    for _ in range(n_steps):
        emb = gptj.embed_tokens(cfg, params, torch.where(active, tok, 0)[:, None], mesh)
        hidden, cache = gptj.forward(cfg, params, emb, cache=cache, cache_index=lens,
                                     return_hidden=True, mesh=mesh)
        logits = gptj.lm_head(cfg, params, hidden, mesh)[:, 0]
        tok = broadcast(torch.where(active, sample_fn(generator, logits), eos_token), mesh, "tp")
        toks.append(tok)
        lens = lens + step
    return cache, torch.stack(toks, dim=1)


def _static_sampler(cfg, temperature, top_k, top_p, top_p_mode) -> Callable:
    def fn(generator, logits):
        return sample_token(generator, logits, temperature=temperature, top_k=top_k,
                            top_p=top_p, vocab_size=cfg.vocab_size, top_p_mode=top_p_mode)
    return fn


def _batched_sampler(cfg, temps, top_ks, top_ps, top_p_mode) -> Callable:
    def fn(generator, logits):
        return sample_token_batched(generator, logits, temps, top_ks, top_ps,
                                    vocab_size=cfg.vocab_size, top_p_mode=top_p_mode)
    return fn


def _decode(cfg, params, cache, last_toks, cur_lens, active, generator, sample_fn, *,
            n_steps, eos_token, mesh=None):
    """A decode window alone.  The active mask is frozen for the window;
    rows that emit EOS inside it decode on into positions the host
    discards."""
    return _window_body(cfg, params, cache, last_toks, cur_lens, active, generator, sample_fn,
                        n_steps=n_steps, eos_token=eos_token, mesh=mesh)


def _decode_with_chunk(cfg, params, cache, last_toks, cur_lens, active, generator, sample_fn,
                       scratch, emb_chunk, offset, true_len, *, n_steps, eos_token, mesh=None):
    """A piggybacked dispatch: the in-flight prefill's next chunk (its own
    scratch cache), then a decode window of the pool.  Returns (cache,
    tokens, scratch, hidden at the chunk's last true position)."""
    scratch, last_h = _chunk_body(cfg, params, scratch, emb_chunk, offset, true_len, mesh)
    cache, toks = _window_body(cfg, params, cache, last_toks, cur_lens, active, generator,
                               sample_fn, n_steps=n_steps, eos_token=eos_token, mesh=mesh)
    return cache, toks, scratch, last_h


class LMServingEngine:
    """Continuous batching over size-classed KV cache pools.

    ``cache_classes``: (slots, max_len) pools, e.g. ``((8, 2048), (16,
    512))``; by default one pool of (``max_batch``, ``max_len``).  A
    request goes to the smallest class that holds prompt + max_new_tokens.
    The constructor sets the sampling defaults; ``submit`` may override
    (temperature, top_k, top_p) per request.  A window whose live slots all
    keep the defaults samples with ``sample_token`` (greedy: the argmax);
    any override samples the window with ``sample_token_batched``.  The
    cache dtype comes from ``cfg.kv_cache_dtype``.  ``params`` live on
    ``device`` (the GPU unless the caller asks for the CPU).  ``mesh``: a
    process mesh with a "tp" axis that n_heads divides: tensor-parallel
    serving (module docstring); ``params`` this rank's shards
    (``sharding.shard_lm_params``)."""

    def __init__(
        self,
        cfg,
        params,
        *,
        max_batch: int = 8,
        max_len: int = 2048,
        cache_classes: Optional[Sequence[Tuple[int, int]]] = None,
        eos_token: int = 50256,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        top_p_mode: str = "reference",
        prefill_bucket: int = 64,
        decode_window: int = 4,
        prefill_chunk: int = 0,
        seed: int = 0,
        pipeline_windows: bool = True,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the serving engine was asked for {self.device}, but CUDA is "
                               "not available; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if cfg.n_heads % mesh.size("tp"):
                raise ValueError(f"n_heads {cfg.n_heads} not divisible by tp={mesh.size('tp')}")
        self.params = params
        if cache_classes is None:
            cache_classes = ((max_batch, max_len),)
        # ascending capacity: admission picks the first class that fits
        self.classes = sorted(cache_classes, key=lambda c: c[1])
        self.max_len = max(c[1] for c in self.classes)
        self.eos_token = eos_token
        self.default_sampling = (float(temperature), int(top_k), float(top_p))
        self.top_p_mode = top_p_mode
        self.prefill_bucket = prefill_bucket
        # tokens decoded per dispatch; admission happens between windows
        self.decode_window = max(1, int(decode_window))
        # > 0: prompts longer than this prefill in chunks, one in flight
        self.prefill_chunk = int(prefill_chunk)
        # pipelined windows: host bookkeeping (streaming, retirement,
        # admission) lags one window; a request's last window may overlap
        # one discarded window
        self.pipeline_windows = bool(pipeline_windows)
        self._inflight: Optional[_InflightPrefill] = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_id = 0
        self.groups = [_CacheGroup(cfg, b, ml, eos_token, self.device, mesh)
                       for b, ml in self.classes]
        self.pending = collections.deque()
        self.finished: Dict[int, FinishedRequest] = {}

    # ------------------------------------------------------------------
    def submit(self, embeds, max_new_tokens: int = 100, *, temperature: Optional[float] = None,
               top_k: Optional[int] = None, top_p: Optional[float] = None) -> int:
        """Queue a request of (s, D) or (1, s, D) prompt embeddings, with
        optional per-request sampling (``sample_token``'s meaning;
        temperature 0 is greedy).  Returns the request id."""
        embeds = torch.as_tensor(embeds, device=self.device)
        if embeds.dim() == 2:
            embeds = embeds[None]
        s = embeds.shape[1]
        if s > self.max_len:
            raise ValueError(f"prompt length {s} > max_len {self.max_len}")
        if s == self.max_len and max_new_tokens > 1:
            # no room for a decode write: it would retire for "length"
            # after the prefill's token alone
            raise ValueError(
                f"prompt length equals max_len ({self.max_len}): at most 1 token can be "
                f"generated, but max_new_tokens={max_new_tokens}; shorten the prompt or "
                f"raise max_len")
        d_t, d_k, d_p = self.default_sampling
        sampling = (d_t if temperature is None else float(temperature),
                    d_k if top_k is None else int(top_k),
                    d_p if top_p is None else float(top_p))
        req_id = self._next_id
        self._next_id += 1
        self.pending.append((req_id, embeds, int(max_new_tokens), sampling))
        return req_id

    @property
    def has_work(self) -> bool:
        return (bool(self.pending) or self._inflight is not None
                or any(g.active.any() or g.pending is not None for g in self.groups))

    @property
    def resident_cache_positions(self) -> int:
        """Cache positions allocated over all pools."""
        return sum(g.max_batch * g.max_len for g in self.groups)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A fresh copy of ``a`` on the device.  On the card it goes through
        a new pinned buffer without a wait: the host allocator keeps the
        buffer until the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _pick_group(self, s: int, max_new: int) -> Optional[Tuple[int, int]]:
        """Smallest class whose capacity covers prompt + budget, with a free
        slot; the largest class takes any prompt that fits it (an
        over-budget request retires for "length").  Returns (group, slot)
        or None, never the in-flight chunked prefill's slot."""
        need = min(max(s + max_new, s + 1), self.max_len)
        fl = self._inflight
        for gi, g in enumerate(self.groups):
            if g.max_len < need and g.max_len != self.max_len:
                continue
            for slot in range(g.max_batch):
                if g.slots[slot] is not None:
                    continue
                if fl is not None and (fl.group_id, fl.slot_id) == (gi, slot):
                    continue
                return gi, slot
        return None

    def _install(self, group_id, slot_id, req_id, s, scratch, last_h, max_new, sampling,
                 emitted):
        """Finish a prefill: copy the scratch into the pool, record the first
        token, mark the slot live."""
        g = self.groups[group_id]
        tok = _install_slot(self.cfg, self.params, g.cache, scratch, slot_id, last_h,
                            self._gen, sampling, top_p_mode=self.top_p_mode, mesh=self.mesh)
        g.cur_lens[slot_id] = s
        g.temps[slot_id], g.top_ks[slot_id], g.top_ps[slot_id] = sampling
        if self.pipeline_windows:
            # the first token stays on the card, feeding the next window;
            # the host reads it at the next collect
            g.last_dev[slot_id] = tok
            g.slots[slot_id] = _Slot(req_id, [], max_new, sampling, pending_first=tok,
                                     install_next_write=s)
            return
        tok = int(tok)
        g.slots[slot_id] = _Slot(req_id, [tok], max_new, sampling)
        g.last_toks[slot_id] = tok
        emitted.setdefault(req_id, []).append(tok)
        self._retire_check(group_id, slot_id, s)

    def _start_inflight(self, group_id, slot_id, req_id, embeds, max_new, sampling, emitted):
        C = self.prefill_chunk
        g = self.groups[group_id]
        # a whole number of chunks: the padded last chunk writes in range
        scratch = gptj.init_kv_cache(self.cfg, 1, -(-g.max_len // C) * C, device=self.device,
                                     mesh=self.mesh)
        self._inflight = _InflightPrefill(group_id, slot_id, req_id, embeds, embeds.shape[1],
                                          0, scratch, max_new, sampling)
        # the first chunk runs now, so admission progresses with no window
        self._advance_inflight(emitted)

    def _advance_inflight(self, emitted):
        """One chunk of the in-flight prefill as its own dispatch."""
        fl = self._inflight
        chunk, off, true_len = self._next_chunk()
        fl.scratch, last_h = _chunk_body(self.cfg, self.params, fl.scratch, chunk, off, true_len,
                                         mesh=self.mesh)
        self._finish_chunk(true_len, last_h, emitted)

    def _next_chunk(self):
        fl = self._inflight
        C = self.prefill_chunk
        chunk = fl.embeds[:, fl.off:fl.off + C]
        true_len = chunk.shape[1]
        if true_len < C:
            chunk = F.pad(chunk, (0, 0, 0, C - true_len))
        return chunk, fl.off, true_len

    def _finish_chunk(self, true_len, last_h, emitted):
        fl = self._inflight
        fl.off += true_len
        if fl.off >= fl.s:
            self._inflight = None
            self._install(fl.group_id, fl.slot_id, fl.req_id, fl.s, fl.scratch, last_h,
                          fl.max_new, fl.sampling, emitted)

    def _admit(self, emitted):
        """Move pending requests into free slots (prefill each).  Any
        admissible request goes, not only the head: a long prompt waiting
        for the in-flight chunked prefill does not block shorter ones."""
        made_progress = True
        while made_progress and self.pending:
            made_progress = False
            for i, (req_id, embeds, max_new, sampling) in enumerate(self.pending):
                s = embeds.shape[1]
                needs_chunk = self.prefill_chunk and s > self.prefill_chunk
                if needs_chunk and self._inflight is not None:
                    continue
                placed = self._pick_group(s, max_new)
                if placed is None:
                    continue
                gi, slot = placed
                del self.pending[i]
                if needs_chunk:
                    self._start_inflight(gi, slot, req_id, embeds, max_new, sampling, emitted)
                else:
                    pad = min((-s) % self.prefill_bucket, self.groups[gi].max_len - s)
                    if pad:
                        embeds = F.pad(embeds, (0, 0, 0, pad))
                    scratch, last_h = _prefill_full(self.cfg, self.params, embeds, s,
                                                    scratch_len=self.groups[gi].max_len,
                                                    mesh=self.mesh)
                    self._install(gi, slot, req_id, s, scratch, last_h, max_new, sampling,
                                  emitted)
                made_progress = True
                break

    def _retire_check(self, group_id, slot_id, next_write):
        """Retire the slot if its latest token ends the request;
        ``next_write`` is the position the slot's next decode step writes."""
        g = self.groups[group_id]
        slot = g.slots[slot_id]
        if slot is None:
            return
        if slot.tokens and slot.tokens[-1] == self.eos_token:
            reason = "eos"
        elif len(slot.tokens) >= slot.max_new_tokens or next_write >= g.max_len:
            reason = "length"
        else:
            return
        self.finished[slot.req_id] = FinishedRequest(slot.req_id, slot.tokens, reason)
        g.slots[slot_id] = None

    def _worth_dispatching(self, gi) -> bool:
        """Pipelined mode: is any live slot owed tokens beyond those already
        committed (the window in flight and a deferred install token)?"""
        g = self.groups[gi]
        n_pend = g.pending.toks.shape[1] if g.pending is not None else 0
        for sid, slot in enumerate(g.slots):
            if slot is None:
                continue
            committed = len(slot.tokens) + (slot.pending_first is not None)
            if g.pending is not None and g.pending.active[sid] \
                    and g.pending.req_ids[sid] == slot.req_id:
                committed += n_pend
            if committed < slot.max_new_tokens:
                return True
        return False

    def _run_group_window(self, gi, chunk_job, emitted):
        """Dispatch one decode window of pool ``gi``, with the in-flight
        prefill's next chunk first when ``chunk_job`` is set.  Pipelined: the
        window chains from ``last_dev`` and is kept as ``g.pending``; the
        previous window is collected after it is dispatched."""
        g = self.groups[gi]
        pipelined = self.pipeline_windows
        if pipelined and not self._worth_dispatching(gi):
            self._collect_group(gi, emitted)
            if chunk_job is not None:
                self._advance_inflight(emitted)
            return
        active = g.active
        start_lens = g.cur_lens.copy()
        last_toks = g.last_dev if pipelined else self._to_device(g.last_toks)
        # defaults everywhere: sample_token (greedy: the argmax); any
        # per-request override: the per-row sampler
        if any(s is not None and s.sampling != self.default_sampling for s in g.slots):
            sample_fn = _batched_sampler(self.cfg, self._to_device(g.temps),
                                         self._to_device(g.top_ks), self._to_device(g.top_ps),
                                         self.top_p_mode)
        else:
            t, k, p = self.default_sampling
            sample_fn = _static_sampler(self.cfg, t, k, p, self.top_p_mode)
        args = (self.cfg, self.params, g.cache, last_toks, self._to_device(g.cur_lens),
                self._to_device(active), self._gen, sample_fn)
        kw = dict(n_steps=self.decode_window, eos_token=self.eos_token, mesh=self.mesh)
        chunk_done = None
        if chunk_job is not None:
            chunk, off, true_len = chunk_job
            fl = self._inflight
            g.cache, toks, fl.scratch, last_h = _decode_with_chunk(
                *args, fl.scratch, chunk, off, true_len, **kw)
            # finish the chunk after the bookkeeping below: its install may
            # fill a slot that was inactive in this window
            chunk_done = (true_len, last_h)
        else:
            g.cache, toks = _decode(*args, **kw)
        n = toks.shape[1]
        if pipelined:
            prev = g.pending
            g.pending = _PendingWindow(toks, start_lens, active,
                                       [s.req_id if s is not None else None for s in g.slots])
            g.last_dev = toks[:, -1]
            # the card wrote n positions for every active row
            g.cur_lens = g.cur_lens + active.astype(np.int32) * n
            if chunk_done is not None:
                # an install runs after this window on the stream, so its
                # row copy overwrites the window's writes to that slot
                self._finish_chunk(*chunk_done, emitted)
            self._collect_window(gi, prev, emitted)
            return
        toks = toks.cpu().numpy()  # the window's one device-to-host copy
        g.cur_lens = g.cur_lens + active.astype(np.int32) * n
        for slot_id in range(g.max_batch):
            for k in range(n):
                slot = g.slots[slot_id]
                if slot is None:
                    break  # retired in this window: the rest is discarded
                tok = int(toks[slot_id, k])
                slot.tokens.append(tok)
                g.last_toks[slot_id] = tok
                emitted.setdefault(slot.req_id, []).append(tok)
                # token k's input K/V went to start + k; the next write: + 1
                self._retire_check(gi, slot_id, int(start_lens[slot_id]) + k + 1)
        if chunk_done is not None:
            self._finish_chunk(*chunk_done, emitted)

    def _collect_window(self, gi, prev, emitted):
        """Fetch and book a dispatched window (pipelined mode): one copy to
        the host carries its tokens and any deferred install tokens."""
        g = self.groups[gi]
        firsts = [(sid, s) for sid, s in enumerate(g.slots)
                  if s is not None and s.pending_first is not None]
        fetch = ([] if prev is None else [prev.toks.reshape(-1)]) + [
            s.pending_first.reshape(1) for _, s in firsts]
        if not fetch:
            return
        vals = torch.cat(fetch).cpu().numpy()
        n_win = 0 if prev is None else prev.toks.numel()
        # install tokens first: an install precedes every window holding
        # its slot, so its token is the row's first output
        for (sid, slot), v in zip(firsts, vals[n_win:]):
            tok = int(v)
            slot.pending_first = None
            slot.tokens.append(tok)
            g.last_toks[sid] = tok
            emitted.setdefault(slot.req_id, []).append(tok)
            self._retire_check(gi, sid, slot.install_next_write)
        if prev is None:
            return
        toks = vals[:n_win].reshape(prev.toks.shape)
        for sid in range(g.max_batch):
            if not prev.active[sid] or prev.req_ids[sid] is None:
                continue
            for k in range(toks.shape[1]):
                slot = g.slots[sid]
                if slot is None or slot.req_id != prev.req_ids[sid]:
                    break  # retired (the slot maybe reused): a stale tail
                tok = int(toks[sid, k])
                slot.tokens.append(tok)
                g.last_toks[sid] = tok
                emitted.setdefault(slot.req_id, []).append(tok)
                self._retire_check(gi, sid, int(prev.start_lens[sid]) + k + 1)

    def _collect_group(self, gi, emitted):
        g = self.groups[gi]
        prev, g.pending = g.pending, None
        self._collect_window(gi, prev, emitted)

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """Admit pending requests, then one decode window per pool with live
        slots (the in-flight chunk rides the first).  Returns {request id:
        tokens emitted by this call}; pipelined, emission lags one window
        and a second admission fills the slots the collects freed."""
        emitted: Dict[int, List[int]] = {}
        self._admit(emitted)
        active_groups = [gi for gi, g in enumerate(self.groups) if g.active.any()]
        chunk_job = (self._next_chunk() if self._inflight is not None and active_groups
                     else None)
        if not active_groups:
            if self._inflight is not None:
                self._advance_inflight(emitted)
            if self.pipeline_windows:
                for gi in range(len(self.groups)):
                    self._collect_group(gi, emitted)
                self._admit(emitted)
            return emitted
        for n, gi in enumerate(active_groups):
            self._run_group_window(gi, chunk_job if n == 0 else None, emitted)
        if self.pipeline_windows:
            for gi, g in enumerate(self.groups):
                if gi not in active_groups and g.pending is not None:
                    self._collect_group(gi, emitted)
            self._admit(emitted)
        return emitted

    def run(self) -> Dict[int, FinishedRequest]:
        """Drain every pending and live request; returns {id: result}."""
        while self.has_work:
            self.step()
        return self.finished


class MagmaServingEngine(LMServingEngine):
    """Continuous batching at the ``Magma`` level: requests are (image,
    text) prompts embedded by the vision tower and the ImagePrefix, results
    decode to strings through the tokenizer.  Runs on the model's device,
    over the model's mesh unless ``mesh`` is given."""

    def __init__(self, model, **kwargs):
        kwargs.setdefault("eos_token", model.eos_token)
        kwargs.setdefault("device", model.device)
        kwargs.setdefault("mesh", model.mesh)
        super().__init__(model.lm_config, model.params["lm"], **kwargs)
        self.model = model

    def submit_prompt(self, inputs, max_new_tokens: int = 100, **sampling) -> int:
        """``inputs``: what ``Magma.preprocess_inputs`` takes (ImageInput,
        PIL images, strings); ``sampling``: per-request overrides."""
        return self.submit(self.model.preprocess_inputs(inputs), max_new_tokens, **sampling)

    def text_results(self) -> Dict[int, str]:
        return {
            rid: self.model.tokenizer._decode_ids(
                strip_after_eos(res.tokens, self.eos_token, self.model.image_token))
            for rid, res in self.finished.items()
        }
