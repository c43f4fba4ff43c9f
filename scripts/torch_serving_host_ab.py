"""Host time of the PyTorch port's serving forwards, compared between
checkouts of the repository on one GPU.

    python scripts/torch_serving_host_ab.py DIR [DIR ...] [--repeat 2] [--iters 20]

Each DIR is a checkout (for example this one, ".", and its parent unpacked
with ``git archive``).  Every run is a fresh process that imports
``magma_tpu_torch`` from its DIR, builds that checkout's kernels, makes the
full-width ``configs/MAGMA_v1.yml`` model from seed 0 on the card and times,
by the host clock with the card synchronised at the end of each call, the
median of ``--iters`` calls of

* the bf16 prefill forward of a 166-position prompt padded to 192 (the last
  position's head included) and one bf16 decode step after it,
* the same after ``quantize_for_serving(8)`` (the int8 path: K2a, K2b, K4a
  and K1 in the prefill, K8 in the b=1 decode step),
* the same after ``quantize_for_serving(4)`` of the model made again from
  the seed (the int4 path: K3, K4b, K1 and K2a in the prefill, K3 and K8
  in the decode step).

The device work is the same in every checkout when the kernels are; what
differs is host time.  The checkouts run in the order given, then in the
reverse order, ``--repeat`` times over (A B B A), so drift of the host shows
as a spread between the runs of one checkout.  Prints one JSON line per run
and the medians per checkout at the end.  ``--device cpu --tiny`` runs the
same at test width on the CPU, to try the script without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PROMPT_LEN = 166


def _child(tree: Path, device: str, tiny: bool, iters: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import magma_tpu_torch
    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.models.magma import Magma

    if device == "cuda":
        from magma_tpu_torch import cuda_build

        cuda_build.build()
    cfg = MultimodalConfig.from_yml(tree / "configs" / "MAGMA_v1.yml")
    if tiny:
        cfg = dataclasses.replace(
            cfg, lm_overrides=dict(n_layers=2, n_heads=2, d_model=256, d_ff=1024,
                                   rotary_dim=16, max_seq_len=512),
            encoder_overrides=dict(width=16, blocks=(1, 1, 1, 1), input_resolution=64))
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = Magma(cfg, seed=0, device=dev)
    package = Path(magma_tpu_torch.__file__).resolve().parent
    if package.parent != tree:
        raise RuntimeError(f"imported {package}, not the package of {tree}")
    out = {"tree": str(tree)}
    for tag in ("bf16", "int8", "int4"):
        if tag == "int8":
            model.quantize_for_serving(8)
        elif tag == "int4":  # int4 starts from full precision: the model again from the seed
            del model
            model = Magma(cfg, seed=0, device=dev)
            model.quantize_for_serving(4)
        lm_cfg, lm = model.lm_config, model.params["lm"]
        g = torch.Generator(device=dev).manual_seed(0)
        emb = (torch.randn((1, PROMPT_LEN, lm_cfg.d_model), generator=g, device=dev) * 0.02
               ).to(torch.bfloat16)
        padded = torch.nn.functional.pad(emb, (0, 0, 0, (-PROMPT_LEN) % 64))
        cache = gptj.init_kv_cache(lm_cfg, 1, padded.shape[1] + 64, device=dev)
        kv_len = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev)
        x = gptj.embed_tokens(lm_cfg, lm, torch.full((1, 1), model.eos_token, device=dev))
        pos = torch.full((1,), PROMPT_LEN, dtype=torch.int32, device=dev)

        def prefill():
            hidden, _ = gptj.forward(lm_cfg, lm, padded, cache=cache, cache_index=0,
                                     kv_len=kv_len, return_hidden=True)
            gptj.lm_head(lm_cfg, lm, hidden[:, PROMPT_LEN - 1:PROMPT_LEN])

        def step():
            gptj.forward(lm_cfg, lm, x, cache=cache, cache_index=pos)

        with torch.no_grad():
            for name, fn in (("prefill", prefill), ("decode", step)):
                times = []
                for i in range(iters + 2):  # two warm-up calls
                    t = time.perf_counter()
                    fn()
                    sync()
                    if i >= 2:
                        times.append((time.perf_counter() - t) * 1e3)
                out[f"{tag} {name} ms"] = statistics.median(times)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--child", type=Path)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(_child(args.child.resolve(), args.device, args.tiny, args.iters)))
        return 0
    if not args.trees:
        ap.error("name at least one checkout")
    order = [t.resolve() for t in args.trees]
    runs = []
    for r in range(args.repeat):
        for tree in order if r % 2 == 0 else order[::-1]:
            cmd = [sys.executable, __file__, "--child", str(tree), "--device", args.device,
                   "--iters", str(args.iters)] + (["--tiny"] if args.tiny else [])
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    keys = [k for k in runs[0] if k.endswith(" ms")]
    print("checkout | " + " | ".join(keys) + "  (median over runs; each run a median of "
          f"{args.iters} calls, host clock)")
    for tree in order:
        mine = [r for r in runs if r["tree"] == str(tree)]
        print(f"{tree} | " + " | ".join(
            f"{statistics.median(r[k] for r in mine):.2f} ({min(r[k] for r in mine):.2f}-"
            f"{max(r[k] for r in mine):.2f})" for k in keys))
    return 0


if __name__ == "__main__":
    sys.exit(main())
