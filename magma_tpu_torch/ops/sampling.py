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
step to stop early.  Sampling draws from an explicit ``torch.Generator``,
so sampled tokens differ from the JAX package's for the same seed; greedy
tokens do not.  ``sample_token_batched`` and ``generate_tokens_split`` are
not ported.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

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
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


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
) -> Tuple[torch.Tensor, int]:
    """KV-cached generation.  Returns (tokens (b, max_steps) int64 on the
    embeddings' device, number of steps taken before early exit).
    Positions after the early exit are EOS.

    ``prompt_len`` may be per-row (b,) for right-padded prompts of
    different lengths: each row decodes from its own last true position,
    padding is masked out of attention and cache writes land per row.

    ``timing``: a dict that receives ``prefill_ms`` (cache allocation,
    prefill and head) and ``decode_ms`` (every sampling step and the
    ``steps - 1`` decode forwards), timed with CUDA events on a GPU and the
    host clock on a CPU.  Reading them synchronises once, at the end."""
    from magma_tpu_torch.models import gptj

    b, s, _ = embeddings.shape
    dev = embeddings.device
    t_start = _mark(dev) if timing is not None else None
    if prompt_len is None:
        prompt_len = s
    prompt_len = torch.as_tensor(prompt_len, device=dev).to(torch.int32)
    prompt_len = prompt_len.reshape(-1).expand(b)

    # cache length rounded up to 64, as the JAX package sizes it
    max_len = round_up(s + max_steps, 64)
    cache = gptj.init_kv_cache(cfg, b, max_len, device=dev)

    hidden, cache = gptj.forward(cfg, params, embeddings, cache=cache,
                                 cache_index=0, kv_len=prompt_len,
                                 return_hidden=True)
    rows = torch.arange(b, device=dev)
    last_h = hidden[rows, prompt_len.long() - 1][:, None]
    last = gptj.lm_head(cfg, params, last_h)[:, 0]
    t_prefill = _mark(dev) if timing is not None else None

    tokens = torch.full((b, max_steps), eos_token, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    cur_len = prompt_len.clone()
    step = 0
    while step < max_steps:
        tok = sample_token(generator, last, temperature=temperature, top_k=top_k,
                           top_p=top_p, vocab_size=cfg.vocab_size,
                           top_p_mode=top_p_mode)
        tok = torch.where(done, eos_token, tok)
        tokens[:, step] = tok
        done = done | (tok == eos_token)
        step += 1
        if step == max_steps or bool(done.all()):
            break
        emb = gptj.embed_tokens(cfg, params, tok[:, None])
        logits, cache = gptj.forward(cfg, params, emb, cache=cache, cache_index=cur_len)
        last = logits[:, -1]
        cur_len = cur_len + 1
    if timing is not None:
        t_end = _mark(dev)
        timing["prefill_ms"] = _elapsed_ms(t_start, t_prefill)
        timing["decode_ms"] = _elapsed_ms(t_prefill, t_end)
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
