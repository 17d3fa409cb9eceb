"""The metric readers on a hand-made run context, and the trace
reduction's pieces."""

import pytest

from portbench import common, roofline, trace

M = {"vocab": 10, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
     "n_layers": 3, "d_ff": 16}


def _read(name, ctx):
    return common.metric_reader(name)(ctx)


def _train_ctx():
    t = {"batch": 2, "seq": 8}
    # two traced steps of three layers: six attentions, forward and back
    bound = 6 * roofline.attention_bound(M, 2, 8)
    tr = {"busy_s": 0.9, "window_s": 1.0, "steps": 2, "groups": {},
          "idle": {}, "ops": {"flash_fwd_mma_kernel": (bound, 12),
                              "flash_bwd_dq_mma_kernel": (bound, 6),
                              "flash_bwd_dkv_mma_kernel": (2 * bound, 6),
                              "nvjet_gemm": (5.0, 40)}}
    return {"kind": "train", "model": M, "traffic": t, "window_s": 4.0,
            "steps": 8, "tokens": 128, "setup_s": 3.0, "trace": tr,
            "step_flops": roofline.train_step_flops(M, 2, 8)}


def test_train_readers():
    ctx = _train_ctx()
    assert _read("setup_s", ctx) == 3.0
    assert _read("train_tokens_per_s", ctx) == 32.0
    assert _read("train.mfu_pct", ctx) == pytest.approx(
        100 * 8 * ctx["step_flops"] / (4 * roofline.PEAK_BF16_FLOPS))
    assert _read("flash_roofline", ctx) == pytest.approx(25.0)
    assert _read("device.idle_pct.train", ctx) == pytest.approx(10.0)


def test_flash_roofline_counts_the_function_not_the_launches():
    # a kernel split differently, or a forward run again under remat,
    # changes the device time but not the bound
    ctx = _train_ctx()
    fused = dict(ctx["trace"], ops={"flash_bwd_fused_kernel": (
        4 * 6 * roofline.attention_bound(M, 2, 8), 6)})
    assert _read("flash_roofline", {**ctx, "trace": fused}) == \
        pytest.approx(25.0)


def test_readers_with_nothing_to_read_return_none():
    ctx = _train_ctx()
    no_trace = {**ctx, "trace": None}
    assert _read("flash_roofline", no_trace) is None
    assert _read("device.idle_pct.train", no_trace) is None
    no_flash = {**ctx, "trace": dict(ctx["trace"],
                                     ops={"nvjet_gemm": (5.0, 40)})}
    assert _read("flash_roofline", no_flash) is None


def test_trace_pieces():
    assert trace._union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
    assert trace.group("void paged_decode_kernel<128, 8>") == \
        "K9 paged decode attention"
    assert trace.group("void decode_kernel<128, 8>") == "K6 decode attention"
    assert trace.group("void flash_bwd_dkv_mma_kernel<128>") == \
        "K5 flash dk/dv"
    assert trace.group("sm90_xmma_gemm_bf16") == "matrix products"
    assert trace.group("elementwise_kernel") == "other"
    tr = {"ops": {"a_decode_kernel": (1.0, 1), "paged_decode_kernel": (2.0, 1)},
          "groups": {"x": 1.0, "y": 3.0}, "idle": {"pb.train_step": 0.5}}
    assert trace.kernel_seconds(tr, "decode_kernel", exclude="paged") == 1.0
    assert trace.breakdown(tr) == {"device_ops": [["y", 3.0], ["x", 1.0]],
                                   "idle_gaps": [["pb.train_step", 0.5]]}
