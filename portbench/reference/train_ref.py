"""Plain float32 reference of MAGMA's training step, in PyTorch.

The recipe as its configuration states it, written from the published
description and importing nothing of the program: the CLIP ResNet in
training mode (BatchNorm over the micro-batch's (N, H, W) with the biased
variance, running statistics moved by ``momentum``), the ImagePrefix's
projection, dropout (kept with probability 1 - p, scaled by 1 / (1 - p)) and
layernorm, the frozen GPT-J with its trainable bottleneck adapters, the
shifted cross entropy over the caption through its first EOS (the image
positions and everything after the first EOS ignored), the mean over a
micro-batch's valid positions, gradients averaged over the ``ga``
micro-batches of a step, clipping by the global norm, and AdamW (betas
0.9 / 0.95, eps 1e-8, decoupled weight decay, optax's bias correction)
under DeepSpeed's WarmupDecayLR, the image encoder on its own rate.

Two things are taken as the program draws them, not as the paper leaves
them open: the dropout mask, drawn by ``torch.rand`` from a generator
seeded with ``seed * 1_000_003 + step`` on the same device, one draw of the
micro-batch's (rows, tokens, d_model) a micro-batch in order (which the
reference draws again itself, from the same seed), and the BatchNorm
running variance, which is the biased one (flax's convention).

Positions after a caption's first EOS change nothing of the loss (the
attention is causal and their labels are ignored), so each row runs only as
far as its last predicted position; the function is the same.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.magma_ref import _layer_norm, _rotary, preprocess

IGNORE = -100
BETAS = (0.9, 0.95)
EPS = 1e-8
KEEP_SEED = 1_000_003


FP8_MAX = 448.0  # float8_e4m3fn


def _exact(x):
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: x's values in float8 (e4m3) under one scale
    for the tensor (its max at the format's largest value), as float32;
    the gradient passes straight through."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _conv(x, w, stride, cast=_exact):
    k = w.shape[-1]
    if k > 1:  # XLA "SAME"
        pads = []
        for n in (x.shape[3], x.shape[2]):
            out = -(-n // stride)
            total = max((out - 1) * stride + k - n, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads)
    return F.conv2d(cast(x), cast(w), stride=stride)


def _adapter(aw: Dict, kind: str, branch_in, branch_out, cast=_exact):
    x = branch_out if kind == "normal" else branch_in
    if "ln" in aw:
        x = _layer_norm(x, *aw["ln"], 1e-5)
    z = cast(torch.relu(cast(x) @ cast(aw["wd"]) + aw["bd"])) @ cast(aw["wu"]) + aw["bu"]
    if kind == "scaled_parallel":
        z = z * aw["scale"]
    return branch_out + z


def paths(tree, prefix=""):
    """(path, leaf) pairs, keys and list indices joined by "/"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def trainable(path: str) -> bool:
    """The recipe's freezing: the LM frozen but its adapters; the ImagePrefix
    (tower, projection, layernorm) trained."""
    return path.startswith("image_prefix") or "adapter" in path


def _bn_train(x, p, s, eps, momentum):
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    new = {"mean": ((1 - momentum) * s["mean"] + momentum * mean).detach(),
           "var": ((1 - momentum) * s["var"] + momentum * var).detach()}
    y = (x - mean[None, :, None, None]) / torch.sqrt(var[None, :, None, None] + eps)
    return y * p["scale"][None, :, None, None] + p["bias"][None, :, None, None], new


def tower_train(enc: Dict, stats: Dict, x: torch.Tensor, cfg: Dict, momentum: float,
                cast=_exact):
    """CLIP's ModifiedResNet without its attention pool, training mode.
    Returns ((b, tokens, width * 32) features, new running statistics)."""
    eps = cfg["bn_eps"]

    def _conv_c(x, w, stride):
        return _conv(x, w, stride, cast)

    new: Dict = {"stem": {}}
    for i, stride in enumerate((2, 1, 1), start=1):
        x, new["stem"][f"bn{i}"] = _bn_train(_conv_c(x, enc["stem"][f"conv{i}"], stride),
                                             enc["stem"][f"bn{i}"], stats["stem"][f"bn{i}"],
                                             eps, momentum)
        x = torch.relu(x)
    x = F.avg_pool2d(x, 2)
    for stage in range(1, len(cfg["blocks"]) + 1):
        key, blocks = f"layer{stage}", []
        for b, (bp, bs) in enumerate(zip(enc[key], stats[key])):
            stride = (2 if stage > 1 else 1) if b == 0 else 1
            nb = {}
            out, nb["bn1"] = _bn_train(_conv_c(x, bp["conv1"], 1), bp["bn1"], bs["bn1"], eps,
                                       momentum)
            out, nb["bn2"] = _bn_train(_conv_c(torch.relu(out), bp["conv2"], 1), bp["bn2"],
                                       bs["bn2"], eps, momentum)
            out = torch.relu(out)
            if stride > 1:
                out = F.avg_pool2d(out, stride)
            out, nb["bn3"] = _bn_train(_conv_c(out, bp["conv3"], 1), bp["bn3"], bs["bn3"], eps,
                                       momentum)
            sc = x
            if "down_conv" in bp:
                sc = F.avg_pool2d(x, stride) if stride > 1 else x
                sc, nb["down_bn"] = _bn_train(_conv_c(sc, bp["down_conv"], 1), bp["down_bn"],
                                              bs["down_bn"], eps, momentum)
            x = torch.relu(out + sc)
            blocks.append(nb)
        new[key] = blocks
    return x.flatten(2).transpose(1, 2), new


def _lm_hidden(frozen: Dict, adapters: Dict, model: Dict, seqs: List[torch.Tensor],
               cast=_exact):
    """GPT-J with adapters over each row's embeddings; returns the hidden
    states after ln_f, one (n_j, D) per row."""
    cfg = model["lm"]
    D, H, rot, eps = cfg["d_model"], cfg["n_heads"], cfg["rotary_dim"], cfg["ln_eps"]
    hd = D // H
    lens = [s.shape[0] for s in seqs]
    x = torch.cat(seqs)
    pos = torch.cat([torch.arange(n, device=x.device) for n in lens])
    kinds = model.get("adapters", {})
    for layer, w in enumerate(frozen["layers"]):
        u = _layer_norm(x, w["ln_s"], w["ln_b"], eps)
        q, k, v = ((cast(u) @ w[n]).view(-1, H, hd) for n in ("q", "k", "v"))
        q, k = _rotary(q, pos, rot), _rotary(k, pos, rot)
        ctx, off = [], 0
        for n in lens:
            qs, ks, vs = (t[off:off + n].transpose(0, 1) for t in (q, k, v))
            mask = torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1)
            probs = torch.softmax((cast(qs) @ cast(ks).transpose(1, 2) / hd ** 0.5).masked_fill(
                mask, float("-inf")), dim=-1)
            ctx.append((cast(probs) @ cast(vs)).transpose(0, 1).reshape(n, D))
            off += n
        a = cast(torch.cat(ctx)) @ w["o"]
        if "o_bias" in w:
            a = a + w["o_bias"]
        if "attention" in kinds:
            a = _adapter(_layer_adapter(adapters["adapter_attn"], layer),
                         kinds["attention"]["adapter_type"], u, a, cast)
        m = cast(F.gelu(cast(u) @ w["fc_in"] + w["fc_in_b"], approximate="tanh"))
        m = m @ w["fc_out"]
        m = m + w["fc_out_b"]
        if "mlp" in kinds:
            m = _adapter(_layer_adapter(adapters["adapter_mlp"], layer),
                         kinds["mlp"]["adapter_type"], u, m, cast)
        x = x + a + m
    x = _layer_norm(x, frozen["ln_f_s"], frozen["ln_f_b"], eps)
    return list(x.split(lens))


def _layer_adapter(ad: Dict, layer: int) -> Dict:
    out = {"wd": ad["down"]["kernel"][layer], "bd": ad["down"]["bias"][layer],
           "wu": ad["up"]["kernel"][layer], "bu": ad["up"]["bias"][layer]}
    if "ln" in ad:
        out["ln"] = (ad["ln"]["scale"][layer], ad["ln"]["bias"][layer])
    if "scale" in ad:
        out["scale"] = ad["scale"][layer]
    return out


def frozen_lm(lm: Dict, cast=_exact) -> Dict:
    """The frozen LM in float32, one dict a layer, its matrices through
    ``cast`` once (they take no gradient)."""
    b = lm["blocks"]
    layers = []
    for i in range(b["ln_1"]["scale"].shape[0]):
        w = {"ln_s": b["ln_1"]["scale"][i].float(), "ln_b": b["ln_1"]["bias"][i].float(),
             "fc_in_b": b["mlp"]["fc_in"]["bias"][i].float(),
             "fc_out_b": b["mlp"]["fc_out"]["bias"][i].float()}
        for n in ("q", "k", "v", "o"):
            w[n] = cast(b["attn"][n][i].float())
        w["fc_in"] = cast(b["mlp"]["fc_in"]["kernel"][i].float())
        w["fc_out"] = cast(b["mlp"]["fc_out"]["kernel"][i].float())
        if "o_bias" in b["attn"]:
            w["o_bias"] = b["attn"]["o_bias"][i].float()
        layers.append(w)
    return {"layers": layers, "wte": lm["wte"].float(), "head": cast(lm["wte"].float()),
            "ln_f_s": lm["ln_f"]["scale"].float(), "ln_f_b": lm["ln_f"]["bias"].float()}


def micro_loss(train: Dict, frozen: Dict, stats: Dict, model: Dict, images: torch.Tensor,
               captions: torch.Tensor, keep: torch.Tensor, dropout: float, momentum: float,
               cast=_exact):
    """One micro-batch: (mean NLL over its valid positions, new running
    statistics)."""
    prefix = train["image_prefix"]
    feats, new_stats = tower_train(prefix["enc"], stats, images, model["tower"], momentum, cast)
    e = cast(feats) @ cast(prefix["proj"]["kernel"]) + prefix["proj"]["bias"]
    if dropout > 0:
        e = torch.where(keep, e / (1.0 - dropout), torch.zeros((), device=e.device))
    if "ln" in prefix:
        e = _layer_norm(e, prefix["ln"]["scale"], prefix["ln"]["bias"], 1e-5)
    n_img, seq_len = e.shape[1], captions.shape[1]
    eos, vocab = model["eos_token"], model["lm"]["vocab_size"]
    seqs, targets = [], []
    for j in range(captions.shape[0]):
        cap = captions[j, :seq_len - n_img]
        hits = (cap == eos).nonzero()
        n_cap = int(hits[0]) if len(hits) else cap.shape[0]
        # the labels: the caption's tokens and its first EOS, where it fits
        labels = cap[:min(n_cap + 1, cap.shape[0])]
        # label t is predicted at position n_img - 1 + t: the inputs end there
        seqs.append(torch.cat([e[j], frozen["wte"][cap[:labels.shape[0] - 1]]]))
        targets.append(labels)
    hidden = _lm_hidden(frozen, train["lm"]["blocks"], model, seqs, cast)
    nll, count = 0.0, 0
    head = frozen["head"][:vocab].T
    for h, t in zip(hidden, targets):
        logits = cast(h[n_img - 1:n_img - 1 + t.shape[0]]) @ head
        nll = nll + (torch.logsumexp(logits, -1) - logits.gather(1, t[:, None])[:, 0]).sum()
        count += t.shape[0]
    return nll / count, new_stats


def schedule(cfg: Dict, base_lr: float, count: int) -> float:
    """DeepSpeed's WarmupLR / WarmupDecayLR at ``count`` updates applied: a
    linear warmup min_lr -> base over ``warmup_num_steps``, then constant or
    a linear decay to 0 at ``lr_decay_iters``."""
    warm = max(cfg["warmup_num_steps"], 1)
    if count < cfg["warmup_num_steps"]:
        c = min(max(count, 0), warm)
        return cfg["min_lr"] + (base_lr - cfg["min_lr"]) * c / warm
    if cfg.get("lr_decay_iters") is None:
        return base_lr
    span = max(cfg["lr_decay_iters"] - cfg["warmup_num_steps"], 1)
    c = min(max(count - cfg["warmup_num_steps"], 0), span)
    return base_lr * (1 - c / span)


def _no_decay(path: str) -> bool:
    parts = path.split("/")
    return parts[-1] in ("bias", "scale") or any(
        p.startswith("ln") or p.startswith("bn") or p == "down_bn" for p in parts)


def run_steps(weights: Dict, model: Dict, recipe: Dict, batches: List, seed: int, device,
              n_steps: int, low_precision: bool = False) -> Dict:
    """``n_steps`` optimizer steps from the seeded weights over ``batches``
    (uint8 images (n, s, s, 3), int64 captions (n, seq_len)) of ga x micro
    rows.  Returns {"losses": [step losses], "grads": {path: the first
    step's gradient as clipped}, "params": {path: after the steps},
    "stats": {path: running statistics after the steps}}.  ``low_precision``:
    the control, every product's operands rounded to float8 (``fp8``), the
    nearest precision below the recipe's bf16."""
    cast = fp8 if low_precision else _exact
    with torch.no_grad():
        frozen = frozen_lm(weights["lm"], cast)
    for key in ("attn", "mlp"):  # the bf16 matrices: the float32 copies replace them
        weights["lm"]["blocks"].pop(key)
    train = {"lm": {"blocks": {k: v for k, v in weights["lm"]["blocks"].items()
                               if "adapter" in k}},
             "image_prefix": weights["image_prefix"]}
    leaves = [(p, t) for p, t in paths(train)]
    params = []
    for p, t in leaves:
        t.data = t.data.float()
        t.requires_grad_(True)
        params.append(t)
    stats = weights["stats"]["enc"]
    mu = [torch.zeros_like(t) for t in params]
    nu = [torch.zeros_like(t) for t in params]
    ga, micro = recipe["ga"], recipe["micro_batch"]
    out = {"losses": [], "grads": None}
    for step in range(n_steps):
        images, captions = batches[step]
        gen = torch.Generator(device=device).manual_seed(seed * KEEP_SEED + step)
        acc, loss_sum = None, 0.0
        for i in range(ga):
            rows = slice(i * micro, (i + 1) * micro)
            x = torch.cat([preprocess(im, recipe["image_side"], device) for im in images[rows]])
            n_img = (recipe["image_side"] // 32) ** 2
            keep = torch.rand((micro, n_img, model["lm"]["d_model"]), generator=gen,
                              device=device) < 1.0 - recipe["dropout"]
            caps = torch.as_tensor(np.asarray(captions[rows]), device=device)
            loss, stats = micro_loss(train, frozen, stats, model, x, caps, keep,
                                     recipe["dropout"], recipe["bn_momentum"], cast)
            grads = torch.autograd.grad(loss, params)
            acc = list(grads) if acc is None else [a + g for a, g in zip(acc, grads)]
            loss_sum += float(loss.detach())
        grads = [a / ga for a in acc]
        out["losses"].append(loss_sum / ga)
        with torch.no_grad():
            if recipe["clip"] > 0:
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                if norm >= recipe["clip"]:
                    grads = [g / norm * recipe["clip"] for g in grads]
            if step == 0:
                out["grads"] = {p: g.clone() for (p, _), g in zip(leaves, grads)}
            b1, b2 = BETAS
            for i, ((p, t), g) in enumerate(zip(leaves, grads)):
                enc = p.startswith("image_prefix/enc")
                lr = schedule(recipe, recipe["image_enc_lr"] if enc else recipe["lr"], step)
                mu[i] = (1 - b1) * g + b1 * mu[i]
                nu[i] = (1 - b2) * g * g + b2 * nu[i]
                u = (mu[i] / (1 - b1 ** (step + 1))) / (
                    torch.sqrt(nu[i] / (1 - b2 ** (step + 1))) + EPS)
                if not _no_decay(p):
                    u = u + recipe["weight_decay"] * t
                t.add_(-lr * u)
    out["params"] = {p: t.detach() for p, t in leaves}
    out["stats"] = dict(paths(stats))
    return out
