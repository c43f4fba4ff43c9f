"""Label construction and the causal LM loss.

Port of ``magma_tpu/training/labels.py`` (reference magma/utils.py:334-364
and the HF ``labels=`` loss of magma/magma.py:270-274): shift-by-one cross
entropy, ignore index -100, mean over the positions not ignored.  The
chunked loss runs the head 256 positions at a time, each chunk under
``torch.utils.checkpoint``, so the (b, s, 50304) fp32 logits never exist.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE = -100


def build_labels(image_seq_len: int, captions: torch.Tensor, eos_token: int) -> torch.Tensor:
    """(b, seq_len) int64 labels: IGNORE over the image-prefix positions,
    then the caption cut so the total is seq_len; every position after the
    first EOS is IGNORE (the first EOS itself is learned)."""
    b, s = captions.shape
    prefix = torch.full((b, image_seq_len), IGNORE, dtype=torch.long, device=captions.device)
    labels = torch.cat([prefix, captions[:, :s - image_seq_len].long()], dim=1)
    is_eos = (labels == eos_token).long()
    seen_eos_before = torch.cumsum(is_eos, dim=1) - is_eos
    return torch.where(seen_eos_before > 0, IGNORE, labels)


def _nll(logits: torch.Tensor, targets: torch.Tensor, vocab_size: int):
    """(sum of the shifted NLL over valid positions, their count); logits
    of the vocab padding masked to -1e30."""
    if logits.shape[-1] > vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e30)
    valid = targets != IGNORE
    safe = torch.where(valid, targets, 0)
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, safe[..., None])[..., 0]
    return ((logz - true_logit) * valid).sum(), valid.sum()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Shifted cross entropy over fp32 (b, s, V) logits (V possibly
    vocab-padded), mean over valid positions."""
    nll, count = _nll(logits[:, :-1], labels[:, 1:], vocab_size)
    return nll / torch.clamp(count, min=1)


def _chunk_nll(cfg, lm_params, mesh, h_c, t_c):
    from magma_tpu_torch.models import gptj

    return _nll(gptj.lm_head(cfg, lm_params, h_c, mesh), t_c, cfg.vocab_size)


def chunked_nll(cfg, lm_params, h: torch.Tensor, targets: torch.Tensor, chunk_size: int = 256,
                mesh=None):
    """(sum of the NLL, count of valid positions) of post-ln_f hidden states
    h (b, n, D) against their next-token ``targets`` (b, n), the head run
    ``chunk_size`` positions at a time: each chunk's logits are made,
    consumed and (under autograd) recomputed in the backward, in chunk
    order as the JAX package's scan sums them.  ``mesh``: a vocab-sharded
    head (``gptj.lm_head``)."""
    pad = (-h.shape[1]) % chunk_size
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=IGNORE)
    fn = functools.partial(_chunk_nll, cfg, lm_params, mesh)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.long, device=h.device)
    for c in range(0, h.shape[1], chunk_size):
        h_c, t_c = h[:, c:c + chunk_size], targets[:, c:c + chunk_size]
        if torch.is_grad_enabled():
            n, k = checkpoint(fn, h_c, t_c, use_reentrant=False)
        else:
            n, k = fn(h_c, t_c)
        nll = nll + n
        count = count + k
    return nll, count


def causal_lm_loss_chunked(cfg, lm_params, hidden: torch.Tensor, labels: torch.Tensor,
                           chunk_size: int = 256) -> torch.Tensor:
    """The shifted cross entropy of ``causal_lm_loss`` over post-ln_f hidden
    states (b, s, D), through ``chunked_nll``: the full logits never
    exist."""
    nll, count = chunked_nll(cfg, lm_params, hidden[:, :-1], labels[:, 1:], chunk_size)
    return nll / torch.clamp(count, min=1)
