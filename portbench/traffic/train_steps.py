"""Training steps on ``Trainer.train_step``: one optimizer step of ``ga``
micro-batches of ``micro_batch`` image-caption pairs after another, each
step's rows new (``portbench/feed.py``), the images preprocessed on the card
by ``preprocess_uint8_batch``.  Measures the samples of the whole steps done
in the window over their time.

Set-up builds one Trainer from the seed's weights (those of the cell's
language-model family) and drives it through its first ``check_steps``
steps with the window's own call and feed; the comparison follows those
steps (their losses, the first gradient as the optimizer took it, the
parameters and BatchNorm statistics after them).  The same Trainer then
runs the window."""

import time
from pathlib import Path

from portbench.feed import batch
from portbench.trace import Slice, span

FLASH = "magma_tpu_torch.ops.flash_attention"


def _flash(kind):
    def extract(a, k):
        q, kk, v = a[0], a[1], a[2]
        return (kind, q.shape[0], q.shape[1], kk.shape[1], q.shape[2], q.shape[3],
                bool(k.get("causal", True)), v.shape[3])
    return extract


FLASH_WRAPPERS = {"flash_attention_kernel": (FLASH, _flash("k1")),
                  "flash_attention_bwd_dkv_kernel": (FLASH, _flash("k9a")),
                  "flash_attention_bwd_dq_kernel": (FLASH, _flash("k9b"))}


def run(ctx):
    import torch

    from magma_tpu_torch.ops.preprocess import preprocess_uint8_batch
    from magma_tpu_torch.training.train_loop import Trainer
    from portbench.harness import Outcome, build_magma
    from portbench.reference.train_ref import paths

    p, fam = ctx.cell.params, ctx.cell.family()
    model_cfg = ctx.cell.config["model"]
    weights = fam.make_weights(model_cfg, ctx.seed, ctx.device)
    model = build_magma(ctx.cell, weights, ctx.device)
    del weights
    model.config.seed = int(ctx.seed)  # the dropout bits' seed
    trainer = Trainer(model, model.config)
    ga, micro, side = p["ga"], p["micro_batch"], p["image_side"]
    seq, eos = model.seq_len, model.eos_token

    def rows(step):
        with span("feed"):
            images, captions = batch(p, ctx.seed, step, seq, eos)
            x = preprocess_uint8_batch(images, side, device=ctx.device)
            caps = torch.as_tensor(captions, device=ctx.device)
            return x.reshape(ga, micro, *x.shape[1:]), caps.reshape(ga, micro, seq)

    losses, first_grads = [], None
    for step in range(p["check_steps"]):
        losses.append(trainer.train_step(*rows(step)))
        if step == 0:  # the clipped gradient, from Adam's first moment
            opt = trainer.optimizer
            first_grads = {path: (m / (1 - 0.9)).detach().clone()
                           for path, m in zip(opt.paths, opt.mu)}
    after = {path: t.detach().clone() for path, t in trainer.trainable}
    stats = {path.split("image_prefix/enc/", 1)[-1]: t.clone()
             for path, t in paths(trainer.state)}
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"[train] set-up {setup_s:.2f} s ({p['check_steps']} steps, losses {losses})")

    traced = range(p["trace_step"], p["trace_step"] + 1) if ctx.trace else range(0)
    sl, ends, step = None, [], p["check_steps"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        i = len(ends)
        if i in traced:
            sl = Slice({**FLASH_WRAPPERS, **fam.WRAPPERS.get(Path(__file__).stem, {})})
            sl.__enter__()
        x, caps = rows(step)
        with span("train_step"):
            trainer.train_step(x, caps)
        if sl is not None:
            sl.__exit__(None, None, None)
        ends.append(time.perf_counter())
        step += 1
    n_samples = ga * micro * len(ends)
    window_s = ends[-1] - t0
    step_s = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    n_img = (side // 32) ** 2
    true, padded, mfu_flops = 0, 0, 0
    for i in range(len(ends)):
        caps = batch(p, ctx.seed, p["check_steps"] + i, seq, eos)[1]
        lengths = [int((c == eos).argmax()) if (c == eos).any() else seq for c in caps]
        flops = sum(fam.train_sample_flops(model_cfg, min(n_img + k, seq - 1),
                                           min(k + 1, seq - n_img)) for k in lengths)
        true += flops
        padded += len(lengths) * fam.train_sample_flops(model_cfg, seq, seq - n_img)
        if i not in traced:  # mfu leaves out the traced step, which the profiler slows
            mfu_flops += flops
    ctx.log(f"[train] window {window_s:.3f} s, {len(ends)} steps, {n_samples} samples; "
            f"model FLOPs {true:.4e} over true positions, {padded:.4e} padded to {seq}; "
            f"peak {torch.cuda.max_memory_allocated() / 1e9 if ctx.device == 'cuda' else 0:.2f} GB")
    record = {"setup_s": setup_s, "window_s": window_s, "samples": n_samples,
              "mfu_flops": mfu_flops,
              "mfu_s": sum(t for i, t in enumerate(step_s) if i not in traced),
              "trace": sl.reduce() if sl is not None else None,
              "model": model_cfg, "bank": None}
    holder = {"trainer": trainer}
    del trainer, model
    out = Outcome(record, attempted=len(ends), failed=0, served=[], release=holder.clear)
    out.trained = {"losses": losses, "grads": first_grads, "params": after, "stats": stats}
    return out
