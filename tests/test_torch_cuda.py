"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode).  The file imports no jax, so on a machine with a GPU and
without jax it runs apart from tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from magma_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                 flash_attention_kernel,
                                                 flash_attention_plain)

pytestmark = pytest.mark.cuda

# bf16 kernel vs fp32 plain version on the same bf16 inputs.  O: both round
# to bf16 at the end and the kernel also rounds P before the PV product, so
# two fp32 values near a rounding boundary land one bf16 ulp apart (2^-7
# relative at most), plus an absolute floor for values near 0.  lse: fp32
# in both, another summation order.
O_ATOL, O_RTOL = 1e-2, 2.0 ** -7
LSE_ATOL = 1e-3

CASES = {
    "prefill_b1": dict(b=1, s_q=256, s_k=256, hd=256, kv_len=[149], q_offset=0),
    "fully_masked_row": dict(b=2, s_q=256, s_k=256, hd=256, kv_len=[149, 0], q_offset=0),
    "q_offset": dict(b=1, s_q=128, s_k=256, hd=256, kv_len=None, q_offset=128),
    "ragged_seq_hd128": dict(b=2, s_q=200, s_k=200, hd=128, kv_len=[200, 33], q_offset=0),
}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(dev, b, s_q, s_k, hd, seed=0):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal((b, s, 4, hd), dtype=np.float32))
                 .to(dev, torch.bfloat16) for s in (s_q, s_k, s_k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(case, dev):
    c = CASES[case]
    q, k, v = _qkv(dev, c["b"], c["s_q"], c["s_k"], c["hd"])
    kv_len = (None if c["kv_len"] is None
              else torch.tensor(c["kv_len"], dtype=torch.int32, device=dev))
    kw = dict(scale=c["hd"] ** -0.5, causal=True, kv_len=kv_len, q_offset=c["q_offset"])
    before = flash_attention_kernel.launches
    o, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    ref_o, ref_lse = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=O_ATOL, rtol=O_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)
    if case == "fully_masked_row":
        assert torch.all(o[1] == 0)


def test_kernel_reads_strided_inputs(dev):
    """(b, s, h, hd) views of a fused qkv buffer: no copy, same result."""
    qkv = torch.randn((1, 256, 3, 4, 256), device=dev, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    o, lse = flash_attention_kernel(q, k, v, None, scale=1 / 16, causal=True, q_offset=0)
    ref_o, ref_lse = flash_attention_plain(q, k, v, scale=1 / 16, causal=True)
    torch.testing.assert_close(o.float(), ref_o.float(), atol=O_ATOL, rtol=O_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["fp32", "head_dim_384", "cpu_kv_len", "negative_offset"])
def test_kernel_raises_on_what_it_does_not_take(bad, dev):
    q, k, v = _qkv(dev, 1, 128, 128, 256)
    kv_len, q_offset = None, 0
    if bad == "fp32":
        q, k, v = q.float(), k.float(), v.float()
    elif bad == "head_dim_384":
        q, k, v = _qkv(dev, 1, 128, 128, 384)
    elif bad == "cpu_kv_len":
        kv_len = torch.tensor([5], dtype=torch.int32)
    else:
        q_offset = -1
    before = flash_attention_kernel.launches
    with pytest.raises((TypeError, ValueError, NotImplementedError)):
        flash_attention_kernel(q, k, v, kv_len, scale=1.0, causal=True, q_offset=q_offset)
    assert flash_attention_kernel.launches == before


def test_tiny_lm_prefill_kernel_vs_plain_path(dev):
    """A bf16 tiny GPT-J (one 128-wide head) on the GPU: the prefill through
    the kernel agrees with the einsum path to bf16 noise, and greedy decode
    runs through one kernel launch per layer."""
    from magma_tpu_torch.models import gptj
    from magma_tpu_torch.ops.sampling import generate_tokens

    cfg = gptj.GPTJConfig.tiny(n_heads=1, attention_impl="flash",
                               param_dtype=torch.bfloat16)
    params = gptj.init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    emb = torch.randn((1, 40, cfg.d_model), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    logits = {}
    for impl in ("flash", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        logits[impl], _ = gptj.forward(c, params, emb)
    torch.testing.assert_close(logits["flash"], logits["xla"], atol=5e-2, rtol=0)
    before = flash_attention_kernel.launches
    tokens, steps = generate_tokens(cfg, params, emb, None, max_steps=6, temperature=0.0)
    assert flash_attention_kernel.launches == before + cfg.n_layers
    assert tokens.shape == (1, 6) and steps >= 1
