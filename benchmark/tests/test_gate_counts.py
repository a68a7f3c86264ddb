"""The operation and byte counts against values worked out by hand for
both configurations."""

import harness


def model(name):
    return harness.load_json("configs", name)["model"]


def test_gpt_counts():
    gpt = harness.counts("gpt")
    # 4 x (4 + 8) x 4096^2 + 50257 x 4096
    assert gpt.matmul_params(model("gpt3-6.7b")) == 1_011_159_040
    # 6 N + 4 layers x 12 x 4096 x 2048 / 2
    assert gpt.train_flops_per_token(model("gpt3-6.7b")) == 6_268_280_832
    # 24 x 12 x 1024^2 + 50257 x 1024
    assert gpt.matmul_params(model("gpt2-medium")) == 353_453_056
    assert gpt.train_flops_per_token(model("gpt2-medium")) == 2_271_713_280
    # two tokens at a context of 3 and 5 positions
    m = model("gpt2-medium")
    assert gpt.serve_flops(m, 2, 8) == (2 * 353_453_056 * 2
                                        + 4 * 1024 * 24 * 8)


def test_flash_attention_counts():
    ops, by = harness.counts("flash_attention").train_step(8, 32, 2048, 128, 4)
    # 4 layers x 3 x 2 x 8 x 32 x 2048^2 x 128
    assert ops == 3_298_534_883_328
    # a layer: 12 activations of 8 x 2048 x 4096 bf16 + 2 f32 row stats
    assert by == 4 * (12 * 134_217_728 + 2 * 2_097_152)
    ops2, _ = harness.counts("flash_attention").train_step(32, 16, 1024, 64,
                                                           24)
    assert ops2 == 24 * 6 * 32 * 16 * 1024 ** 2 * 64


def test_layer_norm_counts():
    by = harness.counts("layer_norm").train_step(32768, 1024, 49)
    # fwd 2 x 32768 x 1024 x 2 + 2 x 1024 x 4; bwd 3 x ... + 3 x 1024 x 4
    assert by == 49 * (134_225_920 + 201_338_880)


def test_paged_decode_counts():
    assert harness.counts("paged_decode").call_bytes(1000, 2, 1024) \
        == 8_192_000 + 8_192


def test_peaks_are_the_data_sheets():
    p = harness.peaks()
    assert p["bf16_flops_per_s"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
