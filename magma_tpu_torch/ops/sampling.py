"""Autoregressive sampling: top-k / top-p filters and the KV-cached decode
loop.

Port of ``generate_tokens`` (the single-program path), ``sample_token``,
the filters and ``strip_after_eos`` of ``magma_tpu/ops/sampling.py``
(reference magma/sampling.py:7-121).  Semantics matched:

* temperature == 0 -> argmax;
* top-k keeps the k largest logits, ties at the boundary included;
* top-p ``mode="reference"`` reproduces the reference's nonstandard filter
  (remove ranks whose shifted cumulative probability is < 1 - threshold);
  ``mode="standard"`` is textbook nucleus sampling;
* temperature divides the logits after filtering;
* one prefill over the prompt, then one token per step; rows that emitted
  EOS are held at EOS and the loop stops when every row is done.

The loop is an eager Python loop that reads one flag from the device per
step to stop early.  Where a decode step is one fused launch (K8 or K6,
``gptj.fused_decode``) it reads the flag one step late: the flag of sample
N is copied to the host without waiting, forward N is queued, and only
then does the host wait for the copy, so the card runs forward N while the
host prepares step N + 1.  Elsewhere (the bf16 tree, tensor-parallel and
sequence-sharded meshes), whose steps the host is slower to launch than
the card to run, the flag is read before forward N: there reading it late
hides nothing, and an EOS exit would first pay a whole forward's launches.
Sampling draws from an explicit ``torch.Generator``, so sampled tokens
differ from the JAX package's for the same seed; greedy tokens do not.  A
draw is ``torch.multinomial``'s own (exponential noise, then the argmax of
p / q) without its checks, which read the device.

``sample_token_batched`` takes per-row (temperature, top_k, top_p) device
tensors (the serving engine's mixed windows) with ``sample_token``'s
semantics row by row: top-k with ties at the k-th value kept, then top-p
over the filtered logits (the JAX package's batched sampler takes top-p
over the unfiltered logits and cuts ties; the port does not copy that).
``generate_tokens_split`` prefills whole or in ``prefill_chunk`` chunks
(``read_history``), which bounds activation memory at any (batch x
context), then decodes in windows with one host read per window; its draws
are ``generate_tokens``'s, in the same order, so for one generator seed
both give the same tokens.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from magma_tpu_torch import observability as obs
from magma_tpu_torch.parallel.mesh import broadcast
from magma_tpu_torch.utils import round_up

NEG_INF = float("-inf")


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, -inf elsewhere."""
    if k <= 0:
        raise ValueError(f"top_k must be > 0, got {k}")
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, NEG_INF)


def top_p_filter(logits: torch.Tensor, threshold: float = 0.9,
                 mode: str = "reference") -> torch.Tensor:
    """Nucleus-style filter over the last axis (see module docstring)."""
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    if mode == "reference":
        remove = cum_probs < (1.0 - threshold)
    elif mode == "standard":
        remove = cum_probs > threshold
    else:
        raise ValueError(f"top_p mode must be 'reference' or 'standard', got {mode!r}")
    # shift right: the first rank crossing the boundary stays included
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    filtered_sorted = sorted_logits.masked_fill(remove, NEG_INF)
    return torch.empty_like(logits).scatter_(-1, order, filtered_sorted)


def sample_token(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,          # (b, V) fp32
    *,
    temperature: float,
    top_k: int,
    top_p: float,
    vocab_size: int,
    top_p_mode: str = "reference",
) -> torch.Tensor:
    """One sampling step over possibly vocab-padded logits.  Returns (b,)
    int64 token ids."""
    if logits.shape[-1] > vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= vocab_size, NEG_INF)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if top_k > 0:
        logits = top_k_filter(logits, top_k)
    if top_p > 0.0:
        logits = top_p_filter(logits, top_p, mode=top_p_mode)
    return _categorical(generator, torch.softmax(logits / temperature, dim=-1))


def _categorical(generator: Optional[torch.Generator], probs: torch.Tensor) -> torch.Tensor:
    """One draw per row from (b, V) probabilities: ``torch.multinomial(probs,
    1)``'s draw, the same numbers taken from ``generator`` (exponential q,
    argmax p / q), without its validity checks, which wait for the card."""
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def _batched_filter(logits: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                    top_p_mode: str) -> torch.Tensor:
    """Per-row top-k then top-p, ``sample_token``'s filters, off one
    descending stable sort: -inf where a row's filters drop a logit.  A
    row's ``top_k <= 0`` or ``top_p <= 0`` turns that filter off."""
    if top_p_mode not in ("reference", "standard"):
        raise ValueError(f"top_p mode must be 'reference' or 'standard', got {top_p_mode!r}")
    sorted_logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = top_k.to(torch.long).clamp(1, logits.shape[-1])
    kth = sorted_logits.gather(-1, (k - 1)[:, None])
    # ties at the k-th value stay, as in top_k_filter
    keep = (top_k <= 0)[:, None] | (sorted_logits >= kth)
    sorted_logits = sorted_logits.masked_fill(~keep, NEG_INF)
    # top-p over the top-k-filtered logits, as top_p_filter follows top_k_filter:
    # the filtered ranks are the sort's tail, so this sort serves both
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    p = top_p.float()[:, None]
    remove = cum < (1.0 - p) if top_p_mode == "reference" else cum > p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    sorted_logits = sorted_logits.masked_fill(remove & (p > 0.0), NEG_INF)
    return torch.empty_like(logits).scatter_(-1, order, sorted_logits)


def sample_token_batched(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,          # (b, V) fp32
    temperature: torch.Tensor,     # (b,): 0 rows decode greedily
    top_k: torch.Tensor,           # (b,) int: <= 0 disables
    top_p: torch.Tensor,           # (b,): <= 0 disables
    *,
    vocab_size: int,
    top_p_mode: str = "reference",
) -> torch.Tensor:
    """``sample_token`` with per-row sampling parameters as device tensors
    (``sampling.py:119-167``): each row is ``sample_token`` with its own
    settings; greedy rows take the argmax.  Every row draws, so a batch
    whose rows share one setting takes ``sample_token``'s draws.  Returns
    (b,) int64 token ids."""
    if logits.shape[-1] > vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= vocab_size, NEG_INF)
    filtered = _batched_filter(logits, top_k, top_p, top_p_mode)
    t = temperature.float()
    safe_t = torch.where(t > 0, t, torch.ones_like(t))[:, None]
    sampled = _categorical(generator, torch.softmax(filtered / safe_t, dim=-1))
    return torch.where(t > 0, sampled, torch.argmax(logits, dim=-1))


@torch.no_grad()
def generate_tokens(
    cfg,
    params,
    embeddings: torch.Tensor,      # (b, s, D) prompt embeddings
    generator: Optional[torch.Generator] = None,
    *,
    max_steps: int = 100,
    temperature: float = 0.7,
    top_k: int = 0,
    top_p: float = 0.9,
    eos_token: int = 50256,
    prompt_len=None,               # None, int, or (b,) true lengths
    top_p_mode: str = "reference",
    timing: Optional[dict] = None,
    mesh=None,
) -> Tuple[torch.Tensor, int]:
    """KV-cached generation.  Returns (tokens (b, max_steps) int64 on the
    host, in pinned memory on a GPU; number of steps taken before early
    exit).  Positions after the early exit are EOS.

    ``mesh`` (``parallel/``): ``params`` are this rank's shards.  With
    ``attention_impl="ring"`` and an sp axis > 1 the cache is sharded over
    positions: ``max_len`` rounds up to a multiple of sp and each rank holds
    ``max_len / sp`` of them (``sampling.py:223-224``); decode attention is
    ``parallel/sp_decode.py``.  Each step's tokens are the first model
    rank's, broadcast over "tp" and "sp", so every rank takes the same
    early exit.

    ``prompt_len`` may be per-row (b,) for right-padded prompts of
    different lengths: each row decodes from its own last true position,
    padding is masked out of attention and cache writes land per row.

    The early-exit flag: after sample N the loop stages ``done.all()`` and
    the tokens so far for one non-blocking copy to pinned host memory and
    records an event (``_Flag``); the tokens returned are that host copy.
    Where ``gptj.fused_decode`` holds, it queues forward N before it waits
    for the event; sample N + 1 is drawn only after that wait, so the
    generator, the tokens and ``steps`` are those of reading the flag first.
    When every row is then done, forward N is wasted: no sample reads it,
    and the host does not wait for it, since the tokens were staged before
    it.  Elsewhere the wait comes before forward N.  A ``max_steps`` exit
    waits for the last staged copy alone.  The counters
    ``lm.lookahead_forwards`` (forwards queued before their step's flag was
    read) and ``lm.lookahead_wasted`` (at most one a call) say how often;
    ``lm.host_reads`` counts each wait for a flag.

    ``timing``: a dict that receives ``prefill_ms`` (cache allocation,
    prefill and head) and ``decode_ms`` (every sampling step and the
    ``steps - 1`` decode forwards that a sample reads), timed with CUDA
    events on a GPU and the host clock on a CPU.  ``decode_ms`` ends at the
    last staged copy, so it leaves out a wasted forward.  Reading them
    synchronises once, at the end."""
    from magma_tpu_torch.models import gptj

    b, s, _ = embeddings.shape
    with obs.span("lm.generate", b=b, positions=s):
        dev = embeddings.device
        t_start = _mark(dev) if timing is not None else None
        if prompt_len is None:
            prompt_len = s
        _count_prompt(prompt_len, b, s)
        prompt_len = torch.as_tensor(prompt_len, device=dev).to(torch.int32)
        prompt_len = prompt_len.reshape(-1).expand(b)

        with obs.span("lm.prefill", positions=s):
            # cache length rounded up to 64, as the JAX package sizes it
            max_len = round_up(s + max_steps, 64)
            if gptj._sp_cache_active(cfg, mesh):
                max_len = round_up(max_len, mesh.size(cfg.sp_axis))
            cache = gptj.init_kv_cache(cfg, b, max_len, device=dev, mesh=mesh)

            hidden, cache = gptj.forward(cfg, params, embeddings, cache=cache,
                                         cache_index=0, kv_len=prompt_len,
                                         return_hidden=True, mesh=mesh)
            last = gptj.lm_head(cfg, params, _last_true_hidden(hidden, prompt_len), mesh)[:, 0]
        t_prefill = _mark(dev) if timing is not None else None

        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        cur_len = prompt_len.clone()
        flag = _Flag(b, max_steps, eos_token, dev)
        ahead = gptj.fused_decode(cfg, params["blocks"], embeddings[:, :1], cache, mesh) is not None
        step = 0
        while step < max_steps:
            with obs.span("lm.decode_step", step=step):
                with obs.span("lm.sample"):
                    tok = sample_token(generator, last, temperature=temperature, top_k=top_k,
                                       top_p=top_p, vocab_size=cfg.vocab_size,
                                       top_p_mode=top_p_mode)
                tok = broadcast(torch.where(done, eos_token, tok), mesh, ("tp", "sp"))
                flag.tokens[:, step] = tok
                done = done | (tok == eos_token)
                step += 1
                obs.count("lm.decode_steps")
                flag.stage(done)
                if step == max_steps or (not ahead and flag.all_done(wasted=False)):
                    break
                with obs.span("lm.decode_forward"):
                    if ahead:
                        obs.count("lm.lookahead_forwards")
                    emb = gptj.embed_tokens(cfg, params, tok[:, None], mesh)
                    logits, cache = gptj.forward(cfg, params, emb, cache=cache,
                                                 cache_index=cur_len, mesh=mesh)
                last = logits[:, -1]
                cur_len = cur_len + 1
                if ahead and flag.all_done(wasted=True):
                    break
        tokens = flag.host_tokens()
        if timing is not None:
            _read_timing(timing, t_start, t_prefill, flag.mark)
    return tokens, step


class _Flag:
    """``generate_tokens``' early-exit flag.  Each step stages ``done.all()``
    after the tokens so far in one device buffer (``tokens`` is a view of
    it), copies the buffer to pinned host memory without waiting and
    records an event (``mark``) after the copy; ``all_done`` waits on that
    event, and the tokens returned are the host copy, older than any
    forward queued after it.  The host buffer comes from PyTorch's caching
    host allocator, which hands the same pinned block back call after call
    (no ``cudaHostAlloc`` a request).  On the CPU the copy is a plain one
    and ``mark`` the host clock."""

    def __init__(self, b: int, max_steps: int, eos_token: int, dev: torch.device):
        if max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {max_steps}")
        self.buf = torch.full((b * max_steps + 1,), eos_token, dtype=torch.long, device=dev)
        self.tokens = self.buf[:-1].view(b, max_steps)
        self.host = torch.empty(self.buf.shape, dtype=torch.long, pin_memory=dev.type == "cuda")
        self.dev, self.mark = dev, None

    def stage(self, done: torch.Tensor) -> None:
        self.buf[-1] = done.all()
        self.host.copy_(self.buf, non_blocking=True)
        self.mark = _mark(self.dev)

    def _wait(self) -> None:
        if not isinstance(self.mark, float):
            self.mark.synchronize()

    def all_done(self, wasted: bool) -> bool:
        """Is every row done at the last staged step?  ``wasted``: a forward
        was queued after that step, which no sample will read if so."""
        with obs.span("lm.eos_check"):
            obs.count("lm.host_reads")
            self._wait()
            if not bool(self.host[-1]):
                return False
        if wasted:
            obs.count("lm.lookahead_wasted")
        return True

    def host_tokens(self) -> torch.Tensor:
        """The tokens as last staged, on the host."""
        self._wait()
        return self.host[:-1].view(self.tokens.shape)


def _count_prompt(prompt_len, b: int, s: int) -> None:
    """The counters of a prefill over ``s`` positions a row: its positions and,
    from a host ``prompt_len`` (int or (b,)), the true ones (a device tensor
    is not read)."""
    if not obs.enabled():
        return
    obs.count("lm.prefill_positions", b * s)
    if isinstance(prompt_len, torch.Tensor):
        if prompt_len.device.type != "cpu":
            return
        prompt_len = prompt_len.tolist()
    obs.count("lm.prompt_positions", int(np.broadcast_to(np.asarray(prompt_len), (b,)).sum()))


def _read_timing(timing: dict, t_start, t_prefill, t_end) -> None:
    """``timing``'s stage times from the marks (on the card one wait, at the
    end)."""
    if not isinstance(t_end, float):
        obs.count("lm.host_reads")
    timing["prefill_ms"] = _elapsed_ms(t_start, t_prefill)
    timing["decode_ms"] = _elapsed_ms(t_prefill, t_end)


def _last_true_hidden(hidden: torch.Tensor, prompt_len: torch.Tensor) -> torch.Tensor:
    """(b, s, D) -> (b, 1, D) at each row's last true position."""
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return hidden[rows, prompt_len.long() - 1][:, None]


def _split_prefill(cfg, params, embeddings, prompt_len, *, max_steps):
    """The split generate's whole-prompt prefill: a cache sized for
    ``max_steps`` decode positions, and the last true position's logits."""
    from magma_tpu_torch.models import gptj

    b, s, _ = embeddings.shape
    cache = gptj.init_kv_cache(cfg, b, round_up(s + max_steps, 64), device=embeddings.device)
    hidden, cache = gptj.forward(cfg, params, embeddings, cache=cache, cache_index=0,
                                 kv_len=prompt_len, return_hidden=True)
    return cache, gptj.lm_head(cfg, params, _last_true_hidden(hidden, prompt_len))[:, 0]


def _split_prefill_chunk(cfg, params, emb_chunk, cache, last_h, offset: int, prompt_len, *,
                         chunk: int):
    """One chunk of the split prefill (``sampling.py:346-375``): attends to
    the cache history ``[0, offset)`` and to itself (``read_history``) and
    carries each row's hidden state at its last true position.  A row whose
    prompt ended before this chunk writes K/V past its length; a position
    p >= prompt_len is read only after the decode step that overwrites it."""
    from magma_tpu_torch.models import gptj

    fresh = (prompt_len - offset).clamp(0, chunk)
    hidden, cache = gptj.forward(cfg, params, emb_chunk, cache=cache, cache_index=offset,
                                 kv_len=fresh, return_hidden=True, read_history=True)
    last_pos = prompt_len.long() - 1
    has_last = (last_pos >= offset) & (last_pos < offset + chunk)
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    cand = hidden[rows, (last_pos - offset).clamp(0, chunk - 1)][:, None]
    return cache, torch.where(has_last[:, None, None], cand, last_h)


def _split_window(cfg, params, cache, last_logits, done, cur_len, generator, *, window,
                  temperature, top_k, top_p, eos_token, top_p_mode, first=0):
    """``window`` decode steps: ``generate_tokens``'s loop body (the same
    draws in the same order, the same EOS holding), each step's forward run
    whatever ``done`` says; ``first`` numbers the steps' spans.  Returns
    (cache, last logits, done, cur_len, tokens (b, window))."""
    from magma_tpu_torch.models import gptj

    toks = []
    for i in range(window):
        with obs.span("lm.decode_step", step=first + i):
            with obs.span("lm.sample"):
                tok = sample_token(generator, last_logits, temperature=temperature, top_k=top_k,
                                   top_p=top_p, vocab_size=cfg.vocab_size,
                                   top_p_mode=top_p_mode)
            tok = torch.where(done, eos_token, tok)
            done = done | (tok == eos_token)
            toks.append(tok)
            obs.count("lm.decode_steps")
            with obs.span("lm.decode_forward"):
                emb = gptj.embed_tokens(cfg, params, tok[:, None])
                logits, cache = gptj.forward(cfg, params, emb, cache=cache, cache_index=cur_len)
            last_logits = logits[:, -1]
            cur_len = cur_len + 1
    return cache, last_logits, done, cur_len, torch.stack(toks, dim=1)


@torch.no_grad()
def generate_tokens_split(
    cfg,
    params,
    embeddings: torch.Tensor,      # (b, s, D) prompt embeddings
    generator: Optional[torch.Generator] = None,
    *,
    max_steps: int = 100,
    temperature: float = 0.7,
    top_k: int = 0,
    top_p: float = 0.9,
    eos_token: int = 50256,
    prompt_len=None,               # None, int, or (b,) true lengths
    top_p_mode: str = "reference",
    window: int = 8,
    prefill_chunk: int = 0,
    timing: Optional[dict] = None,
) -> Tuple[torch.Tensor, int]:
    """``generate_tokens`` as a prefill and decode windows
    (``sampling.py:424-491``).  ``prefill_chunk > 0`` prefills a prompt
    longer than it in chunks of that many positions through
    ``read_history``, so prefill activations stay one chunk's worth at any
    (batch x context); the last chunk pads to a whole chunk and the cache
    rounds up to hold it.  Then windows of ``window`` steps, with one host
    read a window for the early exit.  Returns (tokens (b, max_steps), the
    steps run: ``max_steps`` or, after an early exit, the end of the last
    window); positions after every row's EOS are EOS, as in
    ``generate_tokens``, whose draws these are.  ``timing`` as there."""
    from magma_tpu_torch.models import gptj

    b, s, D = embeddings.shape
    with obs.span("lm.generate", b=b, positions=s):
        dev = embeddings.device
        t_start = _mark(dev) if timing is not None else None
        if prompt_len is None:
            prompt_len = s
        C = prefill_chunk if prefill_chunk and s > prefill_chunk else 0
        positions = round_up(s, C) if C else s  # the padded last chunk writes up to here
        _count_prompt(prompt_len, b, positions)
        prompt_len = torch.as_tensor(prompt_len, device=dev).to(torch.int32).reshape(-1).expand(b)

        with obs.span("lm.prefill", positions=positions):
            if C:
                cache = gptj.init_kv_cache(cfg, b, round_up(max(s + max_steps, positions), 64),
                                           device=dev)
                last_h = torch.zeros((b, 1, D), dtype=cfg.compute_dtype, device=dev)
                for ci in range(positions // C):
                    with obs.span("lm.prefill_chunk", chunk=ci):
                        emb_c = embeddings[:, ci * C:(ci + 1) * C]
                        if emb_c.shape[1] < C:
                            emb_c = torch.nn.functional.pad(emb_c, (0, 0, 0, C - emb_c.shape[1]))
                        cache, last_h = _split_prefill_chunk(cfg, params, emb_c, cache, last_h,
                                                             ci * C, prompt_len, chunk=C)
                last = gptj.lm_head(cfg, params, last_h)[:, 0]
            else:
                cache, last = _split_prefill(cfg, params, embeddings, prompt_len,
                                             max_steps=max_steps)
        t_prefill = _mark(dev) if timing is not None else None

        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        cur_len = prompt_len.clone()
        out, step = [], 0
        while step < max_steps:
            w = min(window, max_steps - step)
            cache, last, done, cur_len, toks = _split_window(
                cfg, params, cache, last, done, cur_len, generator, window=w, first=step,
                temperature=temperature, top_k=top_k, top_p=top_p, eos_token=eos_token,
                top_p_mode=top_p_mode)
            out.append(toks)
            step += w
            with obs.span("lm.eos_check"):
                obs.count("lm.host_reads")
                if bool(done.all()):
                    break
        tokens = torch.full((b, max_steps), eos_token, dtype=torch.long, device=dev)
        tokens[:, :step] = torch.cat(out, dim=1)
        if timing is not None:
            t_end = _mark(dev)
            _read_timing(timing, t_start, t_prefill, t_end)
    return tokens, step


def _mark(device: torch.device):
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_ms(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


def strip_after_eos(row, eos_token: int, image_token: int):
    """Truncate at the first EOS and drop image tokens (reference
    remove_tokens_after_eos, sampling.py:33-40)."""
    out = []
    for t in [int(x) for x in row]:
        if t == eos_token:
            break
        if t != image_token:
            out.append(t)
    return out
