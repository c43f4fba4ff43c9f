"""Worker processes of the parallel CPU tests: ``spawn(cases, inputs, n)``
starts n processes of this file, one per rank, over gloo on 127.0.0.1;
each runs the named cases of ``CASES`` on the port (``magma_tpu_torch``)
and writes its results, which ``spawn`` returns as one dict per rank.

The workers never import jax (they assert it): the test process makes the
inputs with numpy and the JAX package and compares the results.
"""

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(cases, inputs, n: int, timeout: int = 240, argv=None):
    """Run ``cases`` (names in CASES) in n gloo processes; returns the
    per-rank result dicts.  ``argv``: instead of this file's cases, run
    ``python <argv>`` per rank under the same environment (a CLI)."""
    import torch

    with tempfile.TemporaryDirectory() as work:
        torch.save(inputs, os.path.join(work, "inputs.pt"))
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
        env.update(PYTHONPATH=str(ROOT), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
        cmd = argv or [str(Path(__file__).resolve()), ",".join(cases), work]
        procs = [subprocess.Popen([sys.executable, *cmd], cwd=work, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
                 for r in range(n)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        if argv:
            return outs
        return [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
                for r in range(n)]


# ---------------------------------------------------------------------------
# Cases (run in the workers)
# ---------------------------------------------------------------------------


def _t(a):
    import torch

    return torch.from_numpy(a.copy())


def case_ring(inp):
    """Ring attention at sp = world: each rank's output shard and the q/k/v
    gradients of sum(out ** 2) over the whole sequence."""
    from magma_tpu_torch.parallel.mesh import make_mesh
    from magma_tpu_torch.parallel.ring_attention import context_parallel_attention

    mesh = make_mesh(1, 1, sp=_world())
    n, i = mesh.size("sp"), mesh.axis_index("sp")
    out = {}
    for name, (q, k, v, causal, scale) in inp["ring"].items():
        s_loc = q.shape[1] // n
        ts = [_t(a[:, i * s_loc:(i + 1) * s_loc]).requires_grad_() for a in (q, k, v)]
        o = context_parallel_attention(*ts, mesh, scale=scale, causal=causal, seq_axis="sp")
        (o ** 2).sum().backward()
        out[name] = [o.detach().numpy()] + [t.grad.numpy() for t in ts]
    return out


def case_gather(inp):
    """``gather_from`` over a "tp" line whose order is not the ranks' own
    (layout ``inp["gather"][0]``): the gathered tensor, and the gradient
    each rank keeps of a weighted sum of it."""
    import numpy as np

    from magma_tpu_torch.parallel.mesh import gather_from, mesh_from_layout

    layout, full, weights = inp["gather"]
    mesh = mesh_from_layout(np.asarray(layout), ("dp", "tp"))
    n, i = mesh.size("tp"), mesh.line_rank("tp")
    w = full.shape[-1] // n
    x = _t(full[..., i * w:(i + 1) * w]).requires_grad_()
    y = gather_from(x, mesh, "tp")
    (y * _t(weights)).sum().backward()
    return {"gathered": y.detach().numpy(), "grad": x.grad.numpy(), "index": i}


def case_sp_decode(inp):
    """``sp_decode_attention`` at sp = world over each rank's positions."""
    from magma_tpu_torch.parallel.mesh import make_mesh
    from magma_tpu_torch.parallel.sp_decode import sp_decode_attention

    mesh = make_mesh(1, 1, sp=_world())
    n, i = mesh.size("sp"), mesh.axis_index("sp")
    out = {}
    for name, (q, k, v, cur, k_self, v_self, scales) in inp["sp_decode"].items():
        s_loc = k.shape[1] // n
        sl = slice(i * s_loc, (i + 1) * s_loc)
        kvs = None if scales is None else tuple(_t(sc[..., sl]) for sc in scales)
        o = sp_decode_attention(_t(q), _t(k[:, sl]), _t(v[:, sl]), _t(cur),
                                (_t(k_self), _t(v_self)), mesh, "sp", scale=0.17,
                                kv_scales=kvs)
        out[name] = o.float().numpy()
    return out


def _lm(cfg_kw, params_np):
    import torch

    from magma_tpu_torch.convert import from_jax_params
    from magma_tpu_torch.models import gptj

    cfg = gptj.GPTJConfig(**{k: (getattr(torch, v) if k.endswith("dtype") and k != "kv_cache_dtype"
                                 else v) for k, v in cfg_kw.items()})
    params = from_jax_params({"lm": params_np, "image_prefix": {}}, None, cfg, None)[0]["lm"]
    return cfg, params


def case_sp_generate(inp):
    """Greedy ``generate_tokens(mesh=)`` over the position-sharded cache at
    sp = world."""
    from magma_tpu_torch.ops.sampling import generate_tokens
    from magma_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, sp=_world())
    out = {}
    for name, (cfg_kw, params_np, emb, prompt_len) in inp["sp_generate"].items():
        cfg, params = _lm(cfg_kw, params_np)
        toks, steps = generate_tokens(cfg, params, _t(emb), max_steps=12, temperature=0.0,
                                      top_k=0, top_p=0.0, eos_token=-1,
                                      prompt_len=None if prompt_len is None else _t(prompt_len),
                                      mesh=mesh)
        out[name] = (toks.numpy(), steps)
    return out


def case_tp(inp):
    """The tensor-parallel forward and greedy tokens at tp 2 (two dp
    replicas of it when the world is 4) and at tp = world: logits of the
    bf16 tree and of the int8 ``fuse_in_proj=False`` layout."""
    import torch

    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops.sampling import generate_tokens
    from magma_tpu_torch.parallel.mesh import make_mesh
    from magma_tpu_torch.parallel.sharding import shard_lm_params

    out = {}
    cfg_kw, params_np, emb, kv_len = inp["tp"]
    for tp in sorted({2, _world()}):
        mesh = make_mesh(-1, tp)
        for layout in ("bf16", "int8"):
            cfg, params = _lm(cfg_kw, params_np)
            if layout == "int8":
                params = gptj.quantize_lm_params(params, fuse_in_proj=False)
            params = shard_lm_params(mesh, params)
            with torch.no_grad():
                logits, _ = gptj.forward(cfg, params, _t(emb), kv_len=_t(kv_len), mesh=mesh)
            toks, _ = generate_tokens(cfg, params, _t(emb), max_steps=8, temperature=0.0,
                                      top_k=0, top_p=0.0, eos_token=-1, prompt_len=_t(kv_len),
                                      mesh=mesh)
            out[(tp, layout)] = (logits.numpy(), toks.numpy(),
                                 tuple(params["blocks"]["attn"]["q"]["q"].shape
                                       if layout == "int8" else
                                       params["blocks"]["attn"]["q"].shape))
    return out


def case_engine(inp):
    """``LMServingEngine(mesh=)`` at tp 2 over this rank's shards: each
    request's tokens and finish reason."""
    from magma_tpu_torch.parallel.mesh import make_mesh
    from magma_tpu_torch.parallel.sharding import shard_lm_params
    from magma_tpu_torch.serving import LMServingEngine

    cfg_kw, params_np, prompts = inp["engine"]
    cfg, params = _lm(cfg_kw, params_np)
    mesh = make_mesh(-1, 2)
    eng = LMServingEngine(cfg, shard_lm_params(mesh, params), max_batch=4, max_len=128,
                          eos_token=50256, prefill_bucket=8, decode_window=3, device="cpu", mesh=mesh)
    ids = [eng.submit(_t(p), max_new_tokens=10) for p in prompts]
    res = eng.run()
    return {"tokens": [res[r].tokens for r in ids],
            "reasons": [res[r].finish_reason for r in ids],
            "pool_heads": eng.groups[0].cache["k"].shape[3]}


def case_trainer(inp):
    """Two ``Trainer.train_step``s of the tiny v1 recipe over each mesh of
    ``inp["trainer"]``, every rank fed the global batch: losses, the
    updated trainable tree, and a save and load of the checkpoint."""
    import numpy as np
    import torch

    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.convert import from_jax_params
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch.parallel.mesh import make_mesh
    from magma_tpu_torch.training.train_loop import Trainer
    from magma_tpu_torch.utils import tree_items

    out = {}
    for name, (cfg_kw, params_np, state_np, batches) in inp["trainer"].items():
        cfg_kw = dict(cfg_kw)
        cfg_kw["encoder_overrides"] = dict(cfg_kw["encoder_overrides"],
                                           compute_dtype=torch.float32)
        config = MultimodalConfig(**cfg_kw)
        model = Magma(config, device="cpu", init_weights=False)
        model.params, model.state = from_jax_params(params_np, state_np, model.lm_config,
                                                    model.prefix_config)
        mesh = make_mesh(config.mesh_dp, config.mesh_tp, config.mesh_sp)
        trainer = Trainer(model, config, mesh=mesh)
        grads = first_step_grads(trainer)
        losses = [trainer.train_step(*rank_share(trainer, images, caps))
                  for images, caps in batches]
        trained = {p: t.detach().numpy() for p, t in tree_items(trainer.params)
                   if t.requires_grad}
        # a checkpoint holds the whole tree: the tp shards gathered, rank 0
        # writing; loading it back gives each rank its shards again
        trainer.save(f"ckpt_{name}")
        torch.distributed.barrier()
        saved = torch.load(f"ckpt_{name}/step_2/checkpoint.pt", weights_only=False)["params"]
        frozen = {p: np.array_equal(dict(tree_items(saved))[p].numpy(), a)
                  for p, a in tree_items(params_np) if p.startswith("lm") and "adapter" not in p}
        before = {p: t.detach().clone() for p, t in tree_items(trainer.params)}
        step = trainer.load(f"ckpt_{name}")
        reloaded = step == 2 and all(torch.equal(t, before[p])
                                     for p, t in tree_items(trainer.params))
        out[name] = (losses, trained, mesh.coords, frozen, reloaded, grads)
    return out


def classifier_run(cfg_kw, batch, mesh=None):
    """A seeded ``MagmaClassifier``'s Trainer: one classification step (its
    first gradients, loss and accuracy) and an eval step, over ``mesh``."""
    import torch

    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.parallel.sharding import shard_batch
    from magma_tpu_torch.models.classifier import MagmaClassifier
    from magma_tpu_torch.training.train_loop import Trainer

    config = MultimodalConfig(**cfg_kw)
    trainer = Trainer(MagmaClassifier(config, seed=0, device="cpu"), config, mesh=mesh)
    grads = first_step_grads(trainer)
    loss, acc = trainer.train_step_classification(*rank_share(trainer, *batch))
    images, caps, labels = batch
    ev = trainer.eval_step_classification(
        *(shard_batch(torch.as_tensor(t), trainer.mesh) for t in (images, caps, labels)))
    return grads, (loss, acc), ev


def case_classifier(inp):
    """``classifier_run`` at dp = world."""
    from magma_tpu_torch.parallel.mesh import make_mesh

    return classifier_run(*inp["classifier"], mesh=make_mesh(_world(), 1))


def rank_share(trainer, *batch):
    """This rank's "dp" share of each micro-batch of a global flat batch
    (B, ...), flat again (B / dp, ...) in micro-batch order: what the
    multi-process loader hands a rank."""
    import numpy as np
    import torch

    from magma_tpu_torch.parallel.sharding import shard_batch

    ga = trainer.config.gradient_accumulation_steps
    out = []
    for t in batch:
        t = torch.as_tensor(np.asarray(t))
        t = shard_batch(t.reshape(ga, -1, *t.shape[1:]), trainer.mesh, 1)
        out.append(t.reshape(-1, *t.shape[2:]))
    return out


def first_step_grads(trainer):
    """{path: the gradient the trainer's first step hands AdamW}, numpy,
    filled in by that step."""
    store, step = {}, trainer.optimizer.step

    def spy(grads):
        if not store:
            store.update({p: g.detach().float().numpy().copy()
                          for (p, _), g in zip(trainer.trainable, grads)})
        return step(grads)

    trainer.optimizer.step = spy
    return store


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size()


def main():
    cases, work = sys.argv[1].split(","), sys.argv[2]
    assert "jax" not in sys.modules
    import torch

    from magma_tpu_torch.utils import init_distributed

    torch.set_num_threads(1)
    _, rank, _ = init_distributed("cpu")
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {case: CASES[case](inputs) for case in cases}
    assert "jax" not in sys.modules and not any(m.startswith("magma_tpu.") for m in sys.modules)
    torch.save(out, os.path.join(work, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
