"""Where path A's data-parallel gradient parts from one process's, on one GPU.

    python scripts/torch_dp_witness.py [--dtypes bfloat16,float32] [--cudnn-deterministic]

MAGMA v1 at full width (GPT-J 6B, the trainable CLIP RN50x16 with batch
statistics; ``chip_smoke.py``'s path A config, ImagePrefix dropout off),
random weights from seed 0, one micro-batch of two images and 2048-token
captions.  The gradient is split at the image prefix's output: the tower
runs forward, its output ``e`` becomes a leaf, the LM's loss gives the
LM's gradients and dL/de, and dL/de is then pushed back through the
tower's graph.  In one process the script computes:

* ``batched``: as one process trains (both images in each call), twice
  (``repeat``: the run-to-run floor);
* ``lm_rows``: the LM run one row at a time (the rows' losses weighted by
  their share of the valid positions), the tower as ``batched``;
* ``conv_alone``: the tower's convolutions run one image at a time (the
  BatchNorm statistics still over both), the LM as ``batched``;
* ``rank_shapes``: both;
* ``rank_arith``: the arithmetic of each rank of dp 2, in one process
  (``chip_smoke._prefix_in_shares``: each image runs the rank's code in a
  thread of its own, the threads meeting where the ranks' all_reduce
  would), the LM a row a call;
* ``rank_arith_2``: ``rank_arith`` again (its run-to-run floor);
* ``input_2^-20``: ``batched`` on images moved by 2^-20 of themselves
  (random signs): how far the tower amplifies a change of that size;
* ``plain_attn``: the LM's attention on the plain path (phase 9 of
  ``chip_smoke.py`` swaps it so);
* ``tower_only``: the batched tower's graph fed ``lm_rows``' dL/de: the
  tower's arithmetic unchanged, so what moves is dL/de alone.

Then two ranks over gloo on the one card (``chip_smoke.py`` phase 13's
dp 2) compute the same micro-batch's gradient, each its row, summed over
dp as the Trainer sums it.  Each line gives |g - g_batched| / |g_batched|
for the prefix's output e, dL/de, the LM's trainables' and the prefix's
(tower, projection, LN) gradients, and dp's distance from ``rank_shapes``
and ``rank_arith``.  Prints the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repository's config and batch helpers)


def _config(dtype):
    cfg = chip_smoke._train_config("A")
    cfg.image_embed_dropout_prob = 0.0
    cfg.encoder_overrides = dict(cfg.encoder_overrides or {}, compute_dtype=dtype)
    return cfg


def _micro(torch, cfg, seq):
    images, captions = chip_smoke._train_batch(torch, cfg, seq, 100)
    b = cfg.batch_size // cfg.gradient_accumulation_steps
    return images[:b], captions[:b]


def _split(trainer):
    named = trainer.trainable
    lm = [(p, t) for p, t in named if not p.startswith("image_prefix")]
    prefix = [(p, t) for p, t in named if p.startswith("image_prefix")]
    return lm, prefix


def _flat(torch, grads):
    return torch.cat([g.detach().float().reshape(-1) for g in grads])


@contextlib.contextmanager
def _conv_alone(torch):
    """Within the block the CLIP ResNet's convolutions run one image a call,
    as a rank of dp 2 runs them (BatchNorm unchanged)."""
    from magma_tpu_torch.models import clip_resnet

    conv = clip_resnet._conv
    clip_resnet._conv = lambda x, k, s, dt: torch.cat([conv(q, k, s, dt) for q in x.chunk(2)])
    try:
        yield
    finally:
        clip_resnet._conv = conv


def _gradients(torch, model, trainer, images, captions, *, lm_rows=False, conv_alone=False,
               ranks=False, extra_ge=()):
    """{"e": the prefix's output, "g_e": dL/de, "lm", "prefix": the
    trainables' gradients, "loss"; "extra": the prefix's gradients for each
    of ``extra_ge`` fed through the same tower graph}, flat fp32 on the
    CPU."""
    from magma_tpu_torch.models import image_prefix as ip_mod

    lm, prefix = _split(trainer)
    params, state = trainer.params, trainer.state
    if ranks:
        emb, _ = chip_smoke._prefix_in_shares(torch, model, params, state, images, 2)
    else:
        ctx = _conv_alone(torch) if conv_alone else contextlib.nullcontext()
        with ctx:
            emb, _ = ip_mod.apply(params["image_prefix"], state["image_prefix"], images,
                                  model.prefix_config, train=True, mesh=model.mesh)
    e = emb.detach().requires_grad_()
    loss = chip_smoke._lm_loss(torch, model, params, state, e, captions,
                               2 if lm_rows or ranks else 1)
    got = torch.autograd.grad(loss, [e] + [t for _, t in lm])
    pre = [_flat(torch, torch.autograd.grad(emb, [t for _, t in prefix], g.to(emb.device),
                                            retain_graph=True))
           for g in (got[0],) + tuple(extra_ge)]
    return {"e": e.detach().float().cpu(), "g_e": got[0].float().cpu(),
            "lm": _flat(torch, got[1:]).cpu(), "prefix": pre[0].cpu(),
            "extra": [t.cpu() for t in pre[1:]], "loss": loss.item()}


def _model(torch, dtype, mesh=None):
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.training.train_loop import Trainer

    cfg = _config(dtype)
    model = Magma(cfg, seed=0, device=torch.device("cuda"))
    trainer = Trainer(model, cfg, mesh=mesh)
    return model, trainer, cfg


def _worker(rank, world, port, dtypes, out, deterministic):
    import torch
    import torch.distributed as dist

    from magma_tpu_torch.parallel.mesh import all_reduce, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    mesh = make_mesh(world, 1)
    res = {}
    for dtype in dtypes:
        model, trainer, cfg = _model(torch, dtype, mesh)
        images, captions = _micro(torch, cfg, model.seq_len)
        share = images.shape[0] // world
        rows = slice(rank * share, (rank + 1) * share)
        g = _gradients(torch, model, trainer, images[rows], captions[rows])
        res[dtype] = {"e": g["e"], "g_e": g["g_e"], "loss": g["loss"],
                      "lm": all_reduce(g["lm"].to(model.device), mesh, "dp").cpu(),
                      "prefix": all_reduce(g["prefix"].to(model.device), mesh, "dp").cpu()}
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(res, Path(out) / f"dp.{rank}.pt")
    dist.destroy_process_group()


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtypes", default="bfloat16,float32",
                        help="the tower's compute dtypes to run")
    parser.add_argument("--out", default=str(ROOT / "build" / "dp_witness"))
    parser.add_argument("--cudnn-deterministic", action="store_true",
                        help="cuDNN's deterministic algorithms only, in every process")
    args = parser.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = args.cudnn_deterministic
    print(f"cuDNN deterministic: {args.cudnn_deterministic}")
    from magma_tpu_torch import cuda_build

    cuda_build.build()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dtypes = args.dtypes.split(",")
    one = {}
    for dtype in dtypes:
        t0 = time.perf_counter()
        model, trainer, cfg = _model(torch, dtype)
        images, captions = _micro(torch, cfg, model.seq_len)
        g = lambda **kw: _gradients(torch, model, trainer, images, captions, **kw)  # noqa: E731
        rows = g(lm_rows=True)
        runs = {"batched": g(extra_ge=(rows["g_e"],)), "repeat": g(), "lm_rows": rows,
                "conv_alone": g(conv_alone=True),
                "rank_shapes": g(lm_rows=True, conv_alone=True), "rank_arith": g(ranks=True),
                "rank_arith_2": g(ranks=True)}
        noise = torch.randn(images.shape, generator=torch.Generator(device=images.device)
                            .manual_seed(1), device=images.device)
        runs["input_2^-20"] = _gradients(torch, model, trainer, images * (1 + 2.0 ** -20 * noise),
                                         captions)
        runs["tower_only"] = dict(runs["batched"], g_e=rows["g_e"],
                                  prefix=runs["batched"]["extra"][0])
        cfg0 = model.lm_config
        model.lm_config = chip_smoke.dataclasses.replace(cfg0, attention_impl="xla")
        runs["plain_attn"] = g()
        model.lm_config = cfg0
        one[dtype] = runs
        print(f"[{dtype} tower] one process: {time.perf_counter() - t0:.1f} s")
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()

    ctx = mp.start_processes(_worker, args=(2, chip_smoke._free_port(), dtypes, str(out),
                                            args.cudnn_deterministic),
                             nprocs=2, join=False, start_method="spawn")
    while not ctx.join(timeout=5):
        pass
    dp = [torch.load(out / f"dp.{r}.pt", weights_only=False) for r in range(2)]
    keys = ("e", "g_e", "lm", "prefix")
    for dtype in dtypes:
        ref = one[dtype]["batched"]
        d = {k: torch.cat([dp[r][dtype][k] for r in range(2)]) for k in ("e", "g_e")}
        d.update(lm=dp[0][dtype]["lm"], prefix=dp[0][dtype]["prefix"],
                 loss=sum(dp[r][dtype]["loss"] for r in range(2)))
        same = all(torch.equal(dp[0][dtype][k], dp[1][dtype][k]) for k in ("lm", "prefix"))
        print(f"[{dtype} tower] |x - x_batched| / |x_batched| for the prefix's output e, "
              f"dL/de, the LM's and the prefix's gradients; the loss")
        for name, run in list(one[dtype].items()) + [("dp 2", d)]:
            print(f"  {name:12s} " + " ".join(f"{_rel(run[k], ref[k]):.3e}" for k in keys)
                  + f"  loss {run['loss']:.7f}")
        for name in ("rank_shapes", "rank_arith"):
            rs = one[dtype][name]
            print(f"  dp 2 vs {name}: " + " ".join(f"{_rel(d[k], rs[k]):.3e}" for k in keys)
                  + f"  (the ranks' summed gradients bit-equal: {same})")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    sys.exit(main())
