"""The yardstick's arithmetic against counts made by hand at one shape per
kernel family, and the roofline share's reduction."""

import pytest

from portbench import cost, rooflines

LM = {"n_layers": 28, "d_model": 4096, "n_heads": 16, "d_ff": 16384, "rotary_dim": 64,
      "vocab_size": 50258}


def test_int8_matmul_at_the_decode_in_proj():
    # 8 rows of bf16 x (8, 4096), int8 w (4096, 28672), fp32 scales and out
    b, f = cost.int8_matmul(8, 4096, 28672)
    assert b == 8 * 4096 * 2 + 4096 * 28672 + 28672 * 4 + 8 * 28672 * 4
    assert f == 2 * 8 * 4096 * 28672


def test_int8_dual_at_the_out_proj():
    b, f = cost.int8_dual(16, 4096, 16384, 4096)
    assert b == (16 * 4096 * 2 + 4096 * 4096 + 4096 * 4 + 16 * 4096 * 4
                 + 16 * 16384 * 2 + 16384 * 4096 + 4096 * 4 + 16 * 4096 * 4)
    assert f == 2 * 16 * 4096 * 4096 + 2 * 16 * 16384 * 4096


def test_fused_adapter():
    b, f = cost.fused_adapter(16, 4096, 1024)
    assert b == 16 * 4096 * 2 + 2 * 4096 * 1024 + 4 * (2 * 1024 + 2 * 4096) + 16 * 4096 * 4
    assert f == 2 * 16 * 4096 * 1024 * 2


def test_decode_all_layers():
    b, f = cost.decode_all_layers(LM, [1024], cache_read=199, kv_bytes=2)
    D, F, L = 4096, 16384, 28
    per = (D * D + F * D + 8 * D) + (2 * D * 1024 + 4 * (2048 + 8192)) + 4 * (F + 4 * D) \
        + 2 * 200 * D * 2
    assert b == L * per + (L - 1) * (D * (3 * D + F) + 4 * (3 * D + F))
    assert f == 2 * (L * (D * D + F * D + 2 * D * 1024) + (L - 1) * D * (3 * D + F)) \
        + L * 4 * 200 * D
    # the bound is the bytes: ~5.6 GB at 3.35 TB/s
    assert cost.least_s(b, f) == pytest.approx(b / 3.35e12)
    assert 1.6e-3 < cost.least_s(b, f) < 1.8e-3


def test_flash_forward_and_backward():
    b, s, h, hd = 4, 2048, 16, 256
    tri = (s + 1) / (2 * s)
    nb, f = cost.flash_fwd(b, s, s, h, hd, True)
    assert nb == 2 * b * s * h * hd * 4 + 4 * b * h * s
    assert f == pytest.approx(4 * b * h * s * s * hd * tri)
    nb, f = cost.flash_bwd(b, s, s, h, hd, True, products=4, outputs=2)
    assert nb == 2 * b * s * h * hd * 4 + 8 * b * h * s + 2 * b * s * h * hd * 2
    assert f == pytest.approx(8 * b * h * s * s * hd * tri)
    nb, f = cost.flash_bwd(b, s, s, h, hd, True, products=3, outputs=1)
    assert nb == 2 * b * s * h * hd * 4 + 8 * b * h * s + 2 * b * s * h * hd
    assert f == pytest.approx(6 * b * h * s * s * hd * tri)


def test_flash_at_qk_192_and_v_128():
    """Latent attention's head dims (qk 128 + 64 rope, v 128): Q K^T, dQ and
    dK count 192, P V, dP and dV count 128, as do the bytes of v, o, dO and
    dV."""
    b, s, h, qk, v = 4, 2048, 16, 192, 128
    tri = (s + 1) / (2 * s)
    reads = 2 * b * s * h * qk + 2 * b * s * h * qk + 2 * b * s * h * v  # q, k, v
    nb, f = cost.flash_fwd(b, s, s, h, qk, True, v)
    assert nb == reads + 2 * b * s * h * v + 4 * b * h * s  # o, lse
    assert f == pytest.approx((2 * b * h * s * s * qk + 2 * b * h * s * s * v) * tri)
    reads += 2 * b * s * h * v + 4 * b * h * s + 4 * b * h * s  # dO, lse, delta
    nb, f = cost.flash_bwd(b, s, s, h, qk, True, v, products=4, outputs=2)
    assert nb == reads + 2 * b * s * h * qk + 2 * b * s * h * v  # dK, dV
    # S, dP, dV, dK
    assert f == pytest.approx(2 * b * h * s * s * (qk + v + v + qk) * tri)
    nb, f = cost.flash_bwd(b, s, s, h, qk, True, v, products=3, outputs=1)
    assert nb == reads + 2 * b * s * h * qk  # dQ
    # S, dP, dQ
    assert f == pytest.approx(2 * b * h * s * s * (qk + v + qk) * tri)


def test_model_flops():
    one = cost.lm_token_flops(LM, [1024], context=10, head=True)
    layer = 2 * (4096 * (3 * 4096 + 16384) + 4096 * 4096 + 16384 * 4096 + 2 * 4096 * 1024)
    assert one == 28 * (layer + 4 * 10 * 4096) + 2 * 4096 * 50258
    assert cost.prompt_flops(LM, [1024], 3) == sum(
        cost.lm_token_flops(LM, [1024], c, head=False) for c in (1, 2, 3)) + 2 * 4096 * 50258
    # a 2-stage toy tower by hand: stem at 16 px, one block a stage
    tw = {"width": 4, "blocks": [1, 1], "input_resolution": 32}
    stem = 2 * 16 * 16 * 9 * (3 * 2 + 2 * 2 + 2 * 4)
    b1 = 2 * 8 * 8 * (4 * 4 + 9 * 4 * 4) + 2 * 8 * 8 * 4 * 16 + 2 * 8 * 8 * 4 * 16
    b2 = 2 * 8 * 8 * (16 * 8 + 9 * 8 * 8) + 2 * 4 * 4 * 8 * 32 + 2 * 4 * 4 * 16 * 32
    assert cost.tower_flops(tw, 10) == stem + b1 + b2 + 2 * 4 * 4 * 128 * 10


def test_roofline_share_reduction():
    rec = {"model": {"lm": LM, "adapters": {"mlp": {"downsample_factor": 4}}},
           "trace": {"kernels": {
               "void (anonymous namespace)::gemv_kernel<1, 1>((anonymous namespace)::Params)":
                   [1e-4, 1e-4],
               "void (anonymous namespace)::w4a8_gemv_kernel<1>(Params)": [5.0],
               "gemv2T_kernel_val": [5.0]},
               "calls": [("k2", 8, 4096, 4096), ("k2", 8, 4096, 4096)]}}
    least = cost.least_s(*cost.int8_matmul(8, 4096, 4096))
    assert rooflines.share(rec, "int8") == pytest.approx(100 * 2 * least / 2e-4)
    assert rooflines.share(rec, "k8") is None
    assert rooflines.share({"trace": None}, "int8") is None


def test_flash_share_reads_v_head_dim():
    """A K1 launch logged with its v head dim (the wrapper's last field) is
    costed at it; one logged without it, as before, at q's."""
    kernels = {"void (anonymous namespace)::flash_fwd_wgmma<192>(Params)": [1e-3]}
    at = {hd_v: cost.least_s(*cost.flash_fwd(2, 2048, 2048, 16, 192, True, hd_v))
          for hd_v in (128, 192)}
    for call, hd_v in ((("k1", 2, 2048, 2048, 16, 192, True, 128), 128),
                       (("k1", 2, 2048, 2048, 16, 192, True), 192)):
        rec = {"model": {"lm": LM}, "trace": {"kernels": kernels, "calls": [call]}}
        assert rooflines.share(rec, "flash") == pytest.approx(100 * at[hd_v] / 1e-3)
    assert at[128] < at[192]
