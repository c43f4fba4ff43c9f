#!/usr/bin/env python3
"""Where K6 (the int4 layer boundary, ``csrc/boundary.cu``) and its plain
version part, by adapter recipe, on the card.

    python3 scripts/torch_k6_v2_witness.py      # needs one NVIDIA GPU
    python3 scripts/torch_k6_v2_witness.py --device cpu --rows 1 --recipes v2
                                                # a rehearsal: plain versions only

For each recipe of ``test_boundary_kernel_matches_plain`` ("v1", "scaled",
"v2"; the payloads are that test's ``_boundary_payloads``, imported from
tests/test_torch_cuda.py: D 4096, F 16384, two layers, seeded) and M = 1,
2, 5, 8, with the next in_proj (layer 0) and without (layer 1), it prints,
for each output (y, u, fused), the share of elements equal and the largest
difference over the largest magnitude, of:

* the kernel against its plain version (what the CUDA test holds);
* the composition of the dual, adapter and in_proj kernels (K4b, K5, K3)
  against the plain version: the same function, the adapters summed in
  K5's order;
* the plain composition with the adapters' products in fp64 against the
  plain version: a second exact-to-rounding order, which shows how far
  the recipe's data moves the bf16 outputs when only the order of the
  fp32 sums changes;
* a control: the kernel with every adapter fed from the other source
  ("in" for "out" and back) against the plain version, what a kernel that
  wired an adapter wrong would read.

Then, for each adapter of the recipe on its own input there (the plain
dual's branch output, or u_in), K5's h against the plain version's: K5
runs with an identity up product (codes 1, scales 1, bias 0), so its
output is its h exactly.  It prints the h elements that differ, by how
many bf16 ulps at most, how far each such element's exact pre-activation
(fp64) lies from its bf16 rounding midpoint, in units of 2^-24 times the
sum of the |terms| (the scale of an fp32 sum's rounding: a flip from the
order of the sums lies within a few of them, a wrong rounding or product
anywhere), and at how many of them the kernel's h is the exact value
rounded to bf16.
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RECIPES = ("v1", "scaled", "v2")


def _adapter_fp64(x, fz, li):
    """K5's function with its two products in fp64 (h still rounded to bf16)."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).double()
    h = torch.relu((x2 @ fz["wd"][li].double()) * fz["sd"][li, 0].double()
                   + fz["bd"][li, 0].double()).to(torch.bfloat16)
    out = (h.double() @ fz["wu"][li].double()) * fz["su"][li, 0].double() \
        + fz["bu"][li, 0].double()
    return out.float()


def _compare(a, b):
    diff = (a.float() - b.float()).abs()
    return (diff == 0).float().mean().item(), (diff.max() / b.float().abs().max()).item()


def _flipped(kw):
    """The adapters' sources swapped: a wrongly wired kernel's arguments."""
    other = {"in": "out", "out": "in"}
    return dict(kw, **{f"{t}_src": other[kw.get(f"{t}_src", "out")]
                       for t in ("attn", "mlp") if kw.get(f"fz_{t}") is not None})


def _h_flips(x, fz, li):
    """(n differing, n, max |dh| in bf16 ulps, max distance of a flip's
    pre-activation from its rounding midpoint in 2^-24 sum |terms|, flips
    where the kernel's h is the exact value rounded) of K5's h against the
    plain version's on x (m, D) bf16, layer li."""
    from magma_tpu_torch.ops import quant

    L, dh, d = fz["wu"].shape
    eye = torch.zeros((L, dh, d), dtype=torch.int8, device=x.device)
    eye[:, torch.arange(dh), torch.arange(dh)] = 1
    probe = dict(fz, wu=eye, su=torch.ones_like(fz["su"]), bu=torch.zeros_like(fz["bu"]))
    h_k = quant.fused_adapter_stacked(x, probe, li)[:, :dh]
    pre = torch.relu(quant._dq_product(x, fz["wd"][li], fz["sd"][li, 0]) + fz["bd"][li, 0])
    h_p = pre.to(torch.bfloat16).float()
    exact = torch.relu((x.double() @ fz["wd"][li].double()) * fz["sd"][li, 0].double()
                       + fz["bd"][li, 0].double())
    flips = h_k != h_p
    ulp16 = torch.ldexp(torch.ones_like(h_p), torch.frexp(h_p.abs().clamp_min(1e-30))[1] - 8)
    ulps = ((h_k - h_p).abs() / ulp16)[flips]
    # the midpoint between the two bf16 neighbours that h_k and h_p name
    mid = ((h_k.double() + h_p.double()) / 2)[flips]
    mag = (x.double().abs() @ fz["wd"][li].double().abs()) * fz["sd"][li, 0].double().abs()
    dist = (exact[flips] - mid).abs() / (mag[flips] * 2.0 ** -24)
    right = int((h_k[flips] == exact[flips].float().to(torch.bfloat16).float()).sum())
    return (int(flips.sum()), flips.numel(), float(ulps.max()) if ulps.numel() else 0.0,
            float(dist.max()) if dist.numel() else 0.0, right)


def _h_report(dev, recipe, dual, bfo, kw, rows):
    """K5's h flips on each adapter's input in the boundary's plain order."""
    from magma_tpu_torch.ops import quant

    bf = torch.bfloat16
    for m in rows:
        ctx, mh = _rows_of(dev, m)[:2]
        u_in = _rows_of(dev, m)[3]
        for li in (0, 1):
            a, mm = quant.dual_matmul_stacked_plain(ctx, mh, dual, li)
            a, mm = a.to(bf), mm.to(bf)
            if kw.get("o_bias") is not None:
                a = a + kw["o_bias"][li].reshape(1, -1).to(bf)
            mm = mm + bfo[li].reshape(1, -1).to(bf)
            parts = []
            for tag, out in (("attn", a), ("mlp", mm)):
                if kw.get(f"fz_{tag}") is None:
                    continue
                src = u_in if kw.get(f"{tag}_src", "out") == "in" else out
                n, tot, ulps, dist, right = _h_flips(src.contiguous(), kw[f"fz_{tag}"], li)
                parts.append(f"{tag}: {n} of {tot} differ, <= {ulps:.0f} ulp, midpoint "
                             f"<= {dist:.2f} x 2^-24 sum|terms|, kernel rounds exact {right}")
            print(f"{recipe} {m} {li} | K5's h vs plain | " + " | ".join(parts))


def _rows_of(dev, m):
    from test_torch_cuda import _bf16_rows

    return (_bf16_rows(dev, m, 4096, 10), _bf16_rows(dev, m, 16384, 11, 0.5),
            _bf16_rows(dev, m, 4096, 12, 0.3), _bf16_rows(dev, m, 4096, 13))


def main() -> int:
    import argparse

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import _boundary_payloads

    from magma_tpu_torch.ops import quant

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", default="1,2,5,8")
    ap.add_argument("--recipes", default=",".join(RECIPES))
    args = ap.parse_args()
    dev = torch.device(args.device)
    rows = [int(r) for r in args.rows.split(",")]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("needs an NVIDIA GPU")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())
    print("recipe m layer | output: kernel vs plain (equal, max rel) | kernels composed vs "
          "plain | plain fp64 adapters vs plain | control: kernel, sources swapped, vs plain")
    for recipe in args.recipes.split(","):
        dual, w_inp, bfo, ln_g, ln_b, kw = _boundary_payloads(dev, recipe)
        for m in rows:
            ctx, mh, x, u_in = _rows_of(dev, m)
            for li in (0, 1):
                pos = (ctx, mh, x, dual, bfo, ln_g, ln_b, li)
                k = dict(kw, w_in=w_inp if li == 0 else None, u_in=u_in)
                got = quant.boundary_fused_stacked(*pos, **k)
                ref = quant.boundary_fused_stacked_plain(*pos, **k)
                wrong = quant.boundary_fused_stacked(*pos, **_flipped(k))
                full = dict(dict(fz_attn=None, attn_src="out", o_bias=None, ln_eps=1e-5), **k)
                comp = quant._boundary_compose(
                    *pos, **full, dual=quant.dual_matmul_stacked,
                    adapter=quant.fused_adapter_stacked, inproj=quant.int4_matmul_stacked)
                alt = quant._boundary_compose(
                    *pos, **full, dual=quant.dual_matmul_stacked_plain,
                    adapter=_adapter_fp64, inproj=quant.int4_matmul_stacked_plain)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                parts = []
                for name, g_, r_, c_, a_, w_ in zip(("y", "u", "fused"), got, ref, comp, alt,
                                                    wrong):
                    parts.append(f"{name}: " + ", ".join(
                        f"{e:.3f} {d:.1e}" for e, d in (_compare(g_, r_), _compare(c_, r_),
                                                        _compare(a_, r_), _compare(w_, r_))))
                print(f"{recipe} {m} {li} | " + " | ".join(parts))
        _h_report(dev, recipe, dual, bfo, kw, rows)
        del dual, w_inp
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
