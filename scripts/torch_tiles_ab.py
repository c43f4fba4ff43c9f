"""Device time of the port's int8 weight-only products at M > 8 (K2a, K2b,
K4a), of their input gradient (K10), of the W4A8 products (K3, K4b), of
flash attention at the training shape (K1, K9a, K9b), of the fused adapter
(K5), the layer boundary (K6) and the whole-layer decode step (K8),
compared between checkouts of the repository on one GPU.

    python scripts/torch_tiles_ab.py DIR [DIR ...] [--repeat 1] [--calls 20]
        [--only K1,K9a,K9b]

Each DIR is a checkout (for example its parent unpacked with ``git
archive`` into ``build/parent``, and this one, ".").  Every run is a fresh
process that imports ``magma_tpu_torch`` from its DIR, builds that
checkout's kernels and times each kernel wrapper alone (torch.profiler, the
device time of the launches whose kernel is not an elementwise fill) at the
shapes of the caption prefill (M = 192; K3 also at a 2048-row prompt) and
of the QLoRA step (M = 2048, the head chunk M = 256), and K1 and K9a/K9b
at a training layer's attention (b 2, s 2048, 16 heads of 256, causal;
M = b s), on seeded inputs made on the card (int4 weights quantised there
from seeded normals), cycling through enough layers that the weights do
not stay in the 50 MB L2.  A kernel is matched by a substring of its name
that both trees' kernels share ("w4a8", "flash_fwd", "flash_bwd_dkv",
"flash_bwd_dq", ...).  The checkouts run in the order given, then in the
reverse order, ``--repeat`` times over (A B B A).  Prints one JSON line
per run and the medians per checkout.

The K1 rows time path A's layer attention (b 2), path B's (b 1) and the
caption prefill's (b 1, s 256, kv_len 149), each through the wrapper, whichever
body it picks; each prints a sha256 digest of O and lse.

The K5 rows run ``fused_adapter_kernel`` on the v1 adapter of GPT-J 6B (D
4096, DH 1024; 28 seeded layers cycled) at M = 1, 8, 16 and 64 rows; the
K6 rows ``boundary_kernel`` at M = 1 and 8 on seeded int4 stacks of 4
layers (the dual, the next layer's in_proj, the v1 mlp adapter), with the
next in_proj ("w_in") and as the last layer (without it).  Each prints a
sha256 digest of its outputs on layer 0 and, beside the kernel alone, a
call's time by CUDA events (the median of ``--calls`` x 5 calls, the
wrapper included), so a call's host time is the difference.

The K8 rows run ``decode_all_layers_fused`` over seeded GPT-J 6B stacks (28
layers, int4 or int8, the v1 mlp adapter of width 1024) and a seeded bf16 or
int8 cache of 256 positions at pos 180, as a b=1 caption's decode step
does.  Each prints a sha256 digest of its outputs (y, k_new, v_new), so
the checkouts' results can be compared bit for bit; the last line says
which digests agree between the checkouts.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

D, F_, V = 4096, 16384, 50304
# (label, wrapper, M, K, N, layers cycled)
SHAPES = (
    ("K2b in_proj", "stacked", 192, D, 3 * D + F_, 2),
    ("K2b in_proj", "stacked", 2048, D, 3 * D + F_, 2),
    ("K2b o", "stacked", 2048, D, D, 4),
    ("K2b fc_out", "stacked", 2048, F_, D, 2),
    ("K4a o+fc_out", "dual", 192, D + F_, D, 4),
    ("K2a head", "head", 256, D, V, 1),
    ("K10 in_proj", "dx", 2048, D, 3 * D + F_, 2),
    ("K10 o", "dx", 2048, D, D, 4),
    ("K10 fc_out", "dx", 2048, F_, D, 2),
    ("K10 head", "dx", 2048, D, V, 1),
    ("K10 head", "dx", 256, D, V, 1),
    ("K3 in_proj", "int4", 192, D, 3 * D + F_, 2),
    ("K3 in_proj", "int4", 2048, D, 3 * D + F_, 2),
    ("K3 in_proj", "int4", 1, D, 3 * D + F_, 2),
    ("K4b o+fc_out", "int4_dual", 192, D + F_, D, 2),
    ("K4b o+fc_out", "int4_dual", 1, D + F_, D, 2),
    # K1, K9: (b, s, kv_len) in place of M, then the heads and the head_dim
    # in place of K and N (path A's layer, path B's, the caption prefill's)
    ("K1 fwd", "flash_fwd", (2, 2048, None), 16, 256, 1),
    ("K1 fwd B", "flash_fwd", (1, 2048, None), 16, 256, 1),
    ("K1 prefill", "flash_fwd", (1, 256, 149), 16, 256, 1),
    ("K9a dK,dV", "flash_dkv", (2, 2048, None), 16, 256, 1),
    ("K9b dQ", "flash_dq", (2, 2048, None), 16, 256, 1),
    # K8: the weight format, then the cache's, in place of K and N
    # K5: the v1 adapter's D and DH; K6: the weight format and the case in
    # place of K and N
    ("K5 adapter", "k5", 1, D, 1024, 28),
    ("K5 adapter", "k5", 8, D, 1024, 28),
    ("K5 adapter", "k5", 16, D, 1024, 28),
    ("K5 adapter", "k5", 64, D, 1024, 28),
    ("K6 boundary w_in", "k6", 1, "int4", "w_in", 4),
    ("K6 boundary w_in", "k6", 8, "int4", "w_in", 4),
    ("K6 boundary last", "k6", 1, "int4", "last", 4),
    ("K6 boundary last", "k6", 8, "int4", "last", 4),
    ("K8 int4 bf16-cache", "k8", 1, "int4", "bf16", 28),
    ("K8 int4 int8-cache", "k8", 1, "int4", "int8", 28),
    ("K8 int8 bf16-cache", "k8", 1, "int8", "bf16", 28),
    ("K8 int8 int8-cache", "k8", 1, "int8", "int8", 28),
)
K8_POS, K8_MAX_LEN = 180, 256
# the substrings of the kernel names each kind is timed by
MATCH = {"flash_fwd": ("flash_fwd",), "flash_dkv": ("flash_bwd_dkv",),
         "flash_dq": ("flash_bwd_dq",), "k8": ("decode_",), "k5": ("fused_adapter",),
         "k6": ("boundary",)}


@functools.lru_cache(maxsize=1)
def _k5_adapter(torch, quant, d, dh, L):
    """The seeded v1 adapter of ``L`` layers, packed on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)

    def vec(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev) * std

    return quant.quantize_adapter_fused(vec(L, d, dh, std=0.05), vec(L, dh),
                                        vec(L, dh, d, std=0.05), vec(L, d),
                                        out_scale=1 + vec(L, std=0.5))


@functools.lru_cache(maxsize=1)
def _k6_stacks(torch, quant, L):
    """Seeded int4 GPT-J 6B stacks of ``L`` layers for the boundary: the
    dual, the in_proj, the v1 mlp adapter and the vectors."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)

    def stack(k, n):
        packs = [quant.quantize_int4(torch.randn((k, n), generator=g, device=dev) * 0.02,
                                     compiled=True) for _ in range(L)]
        return {key: torch.stack([p[key] for p in packs]) for key in packs[0]}

    o, f = stack(D, D), stack(F_, D)
    dual = {"q4": torch.cat([o["q4"], f["q4"]], 1), "s4": torch.cat([o["s4"], f["s4"]], 1)}
    del o, f
    w_in = stack(D, 3 * D + F_)

    def vec(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev) * std

    fz = quant.quantize_adapter_fused(vec(L, D, 1024, std=0.05), vec(L, 1024),
                                      vec(L, 1024, D, std=0.05), vec(L, D),
                                      out_scale=1 + vec(L, std=0.5))
    vecs = (vec(L, D), 1 + vec(L, D, std=0.1), vec(L, D))  # b_fc_out, ln_g, ln_b
    return dual, w_in, fz, vecs


@functools.lru_cache(maxsize=1)
def _k8_stacks(torch, quant, fmt, L):
    """Seeded GPT-J 6B serving stacks of ``fmt`` built on the card, one layer
    at a time (the dual, the in_proj, the v1 mlp adapter, the vectors)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    q = ((lambda a: quant.quantize_int4(a, compiled=True)) if fmt == "int4"
         else (lambda a: quant.quantize_int8(a, compiled=True)))

    def stack(k, n):
        packs = [q(torch.randn((k, n), generator=g, device=dev) * 0.02) for _ in range(L)]
        return {key: torch.stack([p[key] for p in packs]) for key in packs[0]}

    o, f = stack(D, D), stack(F_, D)
    if fmt == "int4":
        dual = {"q4": torch.cat([o["q4"], f["q4"]], 1), "s4": torch.cat([o["s4"], f["s4"]], 1)}
    else:
        dual = {"q": torch.cat([o["q"], f["q"]], 1), "s": torch.stack([o["s"], f["s"]], 1)}
    del o, f
    w_in = stack(D, 3 * D + F_)

    def vec(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev) * std

    fz = quant.quantize_adapter_fused(vec(L, D, 1024, std=0.05), vec(L, 1024),
                                      vec(L, 1024, D, std=0.05), vec(L, D),
                                      out_scale=1 + vec(L, std=0.5))
    vecs = (vec(L, F_, std=0.1), vec(L, D), 1 + vec(L, D, std=0.1), vec(L, D))
    return dual, w_in, fz, vecs


def _k8_inputs(torch, quant, g, dev, fmt, kv, L):
    """The arguments of a K8 call (``decode_all_layers_fused(*args, **kw)``)
    on the stacks of ``fmt`` and a seeded cache of ``kv``."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops.rotary import rotary_sincos

    dual, w_in, fz, vecs = _k8_stacks(torch, quant, fmt, L)
    bf = torch.bfloat16
    shape = (L, 1, K8_MAX_LEN, 16, 256)
    kc, vc = (torch.randn(shape, generator=g, device=dev).to(bf) for _ in range(2))
    kvs = None
    if kv == "int8":
        (kc, ks), (vc, vs) = gptj._quantize_kv(kc), gptj._quantize_kv(vc)
        kvs = (ks, vs)
    fused = torch.randn((1, 3 * D + F_), generator=g, device=dev).to(bf)
    x = (torch.randn((1, D), generator=g, device=dev) * 0.3).to(bf)
    u = torch.randn((1, D), generator=g, device=dev).to(bf)
    sincos = rotary_sincos(torch.tensor([K8_POS], device=dev), 64)
    pos = torch.tensor([K8_POS], dtype=torch.int32, device=dev)
    args = (fused, x, u, sincos, kc, vc, kvs, pos, dual, w_in, *vecs)
    kw = dict(n_heads=16, scale=256 ** -0.5, fz_mlp=fz, mlp_src="out")
    return args, kw


def _digest(outs) -> str:
    """sha256 of the outputs' bytes (the first 16 hex digits)."""
    import torch

    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _inputs(torch, quant, g, dev, kind, m, k, n, layers):
    """Seeded weights (layers of them), scales, inputs, and a call of the
    kind's kernel wrapper on layer i: (weights, scales, call); for K1 and
    K9 the seeded q, k, v, dO of one layer's attention: (q, lse, call)."""
    bf16 = lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    if kind == "k5":
        fz = _k5_adapter(torch, quant, k, n, layers)
        x = bf16(m, k)
        return None, None, lambda i: quant.fused_adapter_kernel(x, fz, i)
    if kind == "k6":
        dual, w_in, fz, (b_fc_out, ln_g, ln_b) = _k6_stacks(torch, quant, layers)
        ctx, mh = bf16(m, D), (bf16(m, F_).float() * 0.5).to(torch.bfloat16)
        x = (bf16(m, D).float() * 0.3).to(torch.bfloat16)
        kw = dict(fz_mlp=fz, mlp_src="out", w_in=w_in if n == "w_in" else None)
        return None, None, lambda i: quant.boundary_kernel(ctx, mh, x, dual, b_fc_out, ln_g,
                                                           ln_b, i, **kw)
    if kind == "k8":
        from magma_tpu_torch.ops import decode_layer as dl

        args, kw = _k8_inputs(torch, quant, g, dev, k, n, layers)
        return None, None, lambda i: dl.decode_all_layers_fused(*args, **kw)
    if kind.startswith("flash"):
        from magma_tpu_torch.ops import flash_attention as fa

        (b, s, kv), h, hd = m, k, n
        q, kk, v, do = (bf16(b, s, h, hd) for _ in range(4))
        kvl = None if kv is None else torch.full((b,), kv, dtype=torch.int32, device=dev)
        o, lse = fa.flash_attention_fwd(q, kk, v, scale=hd ** -0.5, causal=True, kv_len=kvl)
        lse = lse.contiguous()
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        kw = dict(scale=hd ** -0.5, causal=True, q_offset=0)
        if kind == "flash_fwd":
            return q, lse, lambda i: fa.flash_attention_kernel(q, kk, v, kvl, **kw)
        fn = (fa.flash_attention_bwd_dkv_kernel if kind == "flash_dkv"
              else fa.flash_attention_bwd_dq_kernel)
        return q, lse, lambda i: fn(q, kk, v, do, lse, di, None, **kw)
    if kind.startswith("int4"):
        packs = [quant.quantize_int4(torch.randn((k, n), generator=g, device=dev) * 0.02,
                                     compiled=True) for _ in range(layers)]
        wq, s = torch.stack([p["q4"] for p in packs]), torch.stack([p["s4"] for p in packs])
        if kind == "int4_dual":
            ctx, h = bf16(m, D), bf16(m, F_)
            return wq, s, lambda i: quant.int4_dual_kernel(ctx, h, wq, s, i)
        x = bf16(m, k)
        return wq, s, lambda i: quant.int4_matmul_stacked_kernel(x, wq, s, i)
    wq = torch.randint(-127, 128, (layers, k, n), generator=g, device=dev, dtype=torch.int8)
    if kind == "dual":
        s = torch.rand((layers, 2, n), generator=g, device=dev) * 2e-4 + 1e-5
        ctx, h = bf16(m, D), bf16(m, F_)
        return wq, s, lambda i: quant.dual_matmul_kernel(ctx, h, wq, s, i)
    s = torch.rand((layers, n), generator=g, device=dev) * 2e-4 + 1e-5
    if kind == "dx":
        gr = torch.randn((m, n), generator=g, device=dev) * 1e-3
        return wq, s, lambda i: quant.int8_matmul_dx_kernel(gr, wq[i], s[i])
    x = bf16(m, k)
    if kind == "head":
        return wq, s, lambda i: quant.int8_matmul_kernel(x, wq[i], s[i])
    return wq, s, lambda i: quant.int8_matmul_stacked_kernel(x, wq, s, i)


def _call_ms(torch, call, it, n: int) -> float:
    """Median ms of one call between two CUDA events: the kernel and what
    the wrapper spends on the host before the launch reaches the card."""
    for _ in range(5):
        call(next(it))
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call(next(it))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _child(tree: Path, calls: int, only: tuple) -> dict:
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import magma_tpu_torch
    from magma_tpu_torch import cuda_build
    from magma_tpu_torch.ops import quant

    package = Path(magma_tpu_torch.__file__).resolve().parent
    if package.parent != tree:
        raise RuntimeError(f"imported {package}, not the package of {tree}")
    cuda_build.build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": str(tree)}
    for label, kind, m, k, n, layers in SHAPES:
        if only and label.split()[0] not in only:
            continue
        wq, s, call = _inputs(torch, quant, g, dev, kind, m, k, n, layers)
        match = MATCH.get(kind, ("w4a8",) if kind.startswith("int4") else ("int8", "gemv", "mma"))
        # K6 with the next in_proj reads layer i + 1: the last layer is not an i
        it = itertools.cycle(range(layers - 1 if kind == "k6" and n == "w_in" else layers))
        key = (label if kind == "k8" else f"{label} b={m[0]} s={m[1]}" if kind.startswith("flash")
               else f"{label} M={m}")
        if kind in ("k8", "flash_fwd"):  # K8's y, k_new, v_new; K1's O and lse
            out[f"{label} digest"] = _digest(call(0))
        if kind in ("k5", "k6"):  # K5's out; K6's y, u (and fused)
            out[f"{key} digest"] = _digest([call(0)] if kind == "k5" else call(0))
            out[f"{key} call"] = _call_ms(torch, call, it, 5 * calls)
        for _ in range(3):
            call(next(it))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(next(it))
            torch.cuda.synchronize()
        # each matching kernel launches once a call: a call takes the sum of
        # their mean durations, which a trace that lost some of its device
        # events still gives
        by_name = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and any(word in e.name for word in match)):
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
        out[key] = sum(statistics.fmean(t) for t in by_name.values()) if by_name else None
        if kind.startswith("int4") and m > 8:  # the activation pre-pass's share
            out[f"{label} M={m} pre-pass"] = sum(
                statistics.fmean(t) for name, t in by_name.items() if "quantize" in name)
        del wq, s
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma-separated kernel ids to time (e.g. K3,K4b: a label's first "
                         "word); all by default")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        only = tuple(w for w in args.only.split(",") if w)
        print(json.dumps(_child(args.child.resolve(), args.calls, only)))
        return 0
    trees = [t.resolve() for t in args.trees]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    order = (trees + trees[::-1]) * args.repeat
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree),
                               "--calls", str(args.calls), "--only", args.only],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    digests = {}
    for tree in trees:
        mine = [r for r in runs if r["tree"] == str(tree)]
        med = {k: statistics.median(r[k] for r in mine) for k in mine[0]
               if k != "tree" and not k.endswith("digest")
               and all(r[k] is not None for r in mine)}
        print(json.dumps({"tree": str(tree), "median_ms": med}))
        for k in mine[0]:
            if k.endswith("digest"):
                digests.setdefault(k, {}).setdefault(str(tree), set()).update(r[k] for r in mine)
    if digests:
        print(json.dumps({k: {"trees": {t: sorted(v) for t, v in per.items()},
                              "all_equal": len(set().union(*per.values())) == 1}
                          for k, per in digests.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
