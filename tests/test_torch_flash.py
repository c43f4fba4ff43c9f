"""Port's flash attention vs the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain fp32 version; it is held
against ``magma_tpu.ops.flash_attention.flash_attention(interpret=True)``
for O (atol 2e-3, as tests/test_attention.py holds the kernel against the
XLA path) and against the kernel's own ``_fwd(interpret=True)`` for the
per-row logsumexp (atol 1e-4: both are fp32 reductions of the same scores,
in another order).  The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda.py, which needs a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magma_tpu.ops import flash_attention as jax_flash
from magma_tpu_torch.ops.attention import xla_attention
from magma_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 flash_attention_kernel)

B, H, HD = 2, 2, 256


def _qkv(s_q, s_k, seed=0):
    r = np.random.default_rng(seed)
    q = (r.standard_normal((B, s_q, H, HD)) * 0.5).astype(np.float32)
    k = (r.standard_normal((B, s_k, H, HD)) * 0.5).astype(np.float32)
    v = (r.standard_normal((B, s_k, H, HD)) * 0.5).astype(np.float32)
    return q, k, v


def _jax_lse(q, k, v, kv_len, q_offset, scale):
    """The JAX kernel's lse, padded and masked as its public wrapper does."""
    s_q, s_k = q.shape[1], k.shape[1]
    pad_q, pad_k = (-s_q) % 128, (-s_k) % 128
    q = np.pad(q, ((0, 0), (0, pad_q), (0, 0), (0, 0)))
    k = np.pad(k, ((0, 0), (0, pad_k), (0, 0), (0, 0)))
    v = np.pad(v, ((0, 0), (0, pad_k), (0, 0), (0, 0)))
    if kv_len is None and pad_k:
        kv_len = np.full((B,), s_k, np.int32)
    use_kv_len = kv_len is not None
    kvl = (np.repeat(kv_len, H) if use_kv_len
           else np.full((B * H,), k.shape[1])).astype(np.int32)

    def to_bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], HD))

    _, lse = jax_flash._fwd(to_bh(q), to_bh(k), to_bh(v), jnp.asarray(kvl),
                            scale=scale, causal=True, use_kv_len=use_kv_len,
                            q_offset=q_offset, interpret=True)
    return np.asarray(lse).reshape(B, H, -1)[..., :s_q]


CASES = {
    "causal": dict(s_q=256, s_k=256, kv_len=None, q_offset=0),
    "ragged_kv_len": dict(s_q=256, s_k=256, kv_len=[100, 256], q_offset=0),
    "q_offset": dict(s_q=128, s_k=256, kv_len=None, q_offset=128),
    "fully_masked_row": dict(s_q=256, s_k=256, kv_len=[149, 0], q_offset=0),
    "ragged_seq": dict(s_q=149, s_k=149, kv_len=None, q_offset=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax_kernel(case):
    c = CASES[case]
    q, k, v = _qkv(c["s_q"], c["s_k"])
    scale = 1.0 / np.sqrt(HD)
    kv_len = None if c["kv_len"] is None else np.asarray(c["kv_len"], np.int32)

    ref_o = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, causal=True,
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        q_offset=c["q_offset"], interpret=True)
    ref_lse = _jax_lse(q, k, v, kv_len, c["q_offset"], scale)

    o, lse = flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale,
        causal=True, kv_len=None if kv_len is None else torch.from_numpy(kv_len),
        q_offset=c["q_offset"])
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=1e-4)
    if case == "fully_masked_row":
        assert np.all(o[1].numpy() == 0.0)


def test_flash_matches_plain_einsum_attention():
    """The flash entry agrees with the port's einsum path (fp32, 1e-5)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(200, 200, seed=1))
    kv_len = torch.tensor([200, 57], dtype=torch.int32)
    scale = 1.0 / np.sqrt(HD)
    ref = xla_attention(q, k, v, scale=scale, causal=True, kv_len=kv_len)
    out = flash_attention(q, k, v, scale=scale, causal=True, kv_len=kv_len)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_flash_rejects_head_dim_off_128():
    q = torch.zeros((1, 100, 2, 64))
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, scale=1.0)


def test_kernel_wrapper_never_takes_cpu_tensors():
    """The kernel entry raises on CPU tensors instead of running the plain
    version: only the public wrapper picks by device."""
    q = torch.zeros((1, 128, 2, 256), dtype=torch.bfloat16)
    before = flash_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, q, q, None, scale=1.0, causal=True, q_offset=0)
    assert flash_attention_kernel.launches == before


# K1's two CUDA bodies by launch shape (b, h, s_q, s_k, hd): the training
# layers' attention (paths A and B, 16 heads of 256 at seq 2048) takes the
# wgmma body; the caption prefill at b = 1 (its prompt padded to 256) and
# the CUDA tests' small CASES keep the mma.sync body; a batch of prompts
# leaves it at 132 blocks of 128 rows (b 5 at 256 tokens)
RULE_CASES = {
    "path_a_train": ((2, 16, 2048, 2048, 256), True),
    "path_b_train": ((1, 16, 2048, 2048, 256), True),
    "slice_prefill": ((1, 16, 256, 256, 256), False),
    "prefill_192": ((1, 16, 192, 192, 256), False),
    "prefill_1024": ((1, 16, 1024, 1024, 256), False),
    "batched_prefill_b4": ((4, 16, 256, 256, 256), False),
    "batched_prefill_b5": ((5, 16, 256, 256, 256), True),
    "cuda_test_cases": ((2, 4, 256, 256, 256), False),
    "train_hd128": ((2, 16, 1024, 1024, 128), True),
    "no_keys": ((2, 16, 2048, 0, 256), False),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_dispatch_rule_sends_each_shape_to_its_body(case):
    from magma_tpu_torch.ops.flash_attention import flash_fwd_takes_wgmma

    shape, wgmma = RULE_CASES[case]
    assert flash_fwd_takes_wgmma(*shape) is wgmma
