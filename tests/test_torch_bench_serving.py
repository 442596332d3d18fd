"""The port's decode and serving bench tools and the input bench
(``tensorflow_train_distributed_torch/tools/bench_{generate,serving,
gateway,input}.py``), on the CPU at tiny sizes.

Mirrors ``tests/test_bench_tools.py``'s smokes of bench_generate (plain,
int8, a MoE preset, the refusals of ``--max-new 1`` and of the KV flags
on a MoE preset), bench_input and the decode byte fields, and holds what
both packages' tools count against the JAX tools, loaded by path: the
seeded request streams of bench_serving and bench_gateway, and the
request and generated-token counts of one tiny serving run.  Every
device metric of a ``--device cpu`` record is null.
"""

import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tensorflow_train_distributed_torch.tools import (
    bench_gateway,
    bench_generate,
    bench_input,
    bench_serving,
    roofline,
)

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool(name):
    """The JAX tool loaded by path; the tools directory it puts on
    ``sys.path`` for its siblings is taken off again."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_under_test", os.path.join(_TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def jax_serving():
    return _jax_tool("bench_serving")


def _main(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


# -- against the JAX tools ----------------------------------------------------


def test_request_streams_match_jax(jax_serving):
    """The seeded streams are the JAX tools' (bench_serving's one stream,
    bench_gateway's per-client streams)."""
    jax_gateway = _jax_tool("bench_gateway")
    for args in ((32, 16, 120, 16, 128, 30_000, 0),
                 (5, 4, 12, 4, 12, 256, 3)):
        ours, theirs = bench_serving._requests(*args), \
            jax_serving._requests(*args)
        assert [([int(t) for t in p], m) for p, m in ours] == \
            [([int(t) for t in p], m) for p, m in theirs]
    for client in range(3):
        args = (client, 8, 4, 24, 8, 32, 30_000, 0)
        assert bench_gateway._requests_for(*args) == \
            jax_gateway._requests_for(*args)


def test_tiny_serving_run_counts_match_jax(jax_serving):
    """One tiny engine run (llama_tiny, 2 slots, 4 requests): requests,
    generated tokens and tokens out equal the JAX tool's; the port's
    rates are null on the CPU."""
    args = ("llama_tiny", 2, 4, 4, (4, 12), (4, 12), 64, False, 0)
    theirs = jax_serving.bench_serving(*args, overlap_ab=False, reps=1)
    ours = bench_serving.bench_serving(*args, device="cpu",
                                       overlap_ab=False, reps=1)
    for k in ("n_requests", "gen_tokens", "total_tokens_out"):
        assert ours[k] == theirs[k], k
    assert ours["metric"] == theirs["metric"]
    rec = bench_gateway._null_timed(ours, "cpu", bench_serving.TIMED)
    for k in ("value", "wall_s", "ttft_ms_p50", "inter_token_ms_mean",
              "mbu"):
        assert rec[k] is None, k


def test_gateway_run_counts_its_streams():
    """2 clients x 2 requests through the in-process gateway: every
    request answered and every stream's new tokens generated."""
    rc, rec = _main(bench_gateway.main, [
        "--preset", "llama_tiny", "--clients", "2",
        "--requests-per-client", "2", "--no-ab", "--device", "cpu"])
    assert rc == 0 and rec["n_ok"] == 4 and rec["n_failed"] == 0
    streams = [r for c in range(2) for r in bench_gateway._requests_for(
        c, 2, 4, 24, 8, 32, 256, 0)]
    assert rec["gen_tokens"] == sum(m for _, m in streams)
    assert rec["value"] is None and rec["p99_latency_ms"] is None
    assert rec["mbu"] is None and rec["decode_bytes_per_step"] > 0


def test_serving_shared_prefix_hits_and_fused_refusal():
    rc, rec = _main(bench_serving.main, [
        "--preset", "llama_tiny", "--shared-prefix", "--requests", "2",
        "--prefix-len", "32", "--slots", "2", "--reps", "1", "--device",
        "cpu"])
    assert rc == 0
    assert rec["shared"]["paged"]["prefix_hit_tokens"] > 0
    assert rec["shared"]["linear"]["prefix_hit_tokens"] == 0
    assert rec["value"] is None
    rc, rec = _main(bench_serving.main, ["--fused-ab", "--device", "cpu"])
    assert rc == 2 and "K4" in rec["error"] and rec["value"] is None


# -- decode byte fields -------------------------------------------------------


class TestDecodeMbuFields:
    """``bench_gateway.decode_mbu_fields``: ``tools/roofline.py``'s
    ``decode_bytes_per_step`` (every weight but the embedding, its rows
    for the lanes, the lanes' KV rows; an int8 cache one byte an element
    and an f32 scale a row and kv head), and a null ``mbu`` off the
    card."""

    @pytest.fixture(scope="class")
    def model(self):
        from tensorflow_train_distributed_torch.server.worker import (
            llama_params,
        )

        return llama_params("llama_tiny", 0, "cpu")

    def test_byte_model_and_cpu_null(self, model):
        cfg, params = model
        slots, context = 4, 64
        out = bench_gateway.decode_mbu_fields(cfg, params, slots, context,
                                              100.0, "cpu")
        itemsize = 4                                  # llama_tiny is f32
        weights = sum(v.numel() for k, v in params.items()
                      if "token_embed" not in k) * itemsize
        kv = 2 * cfg.num_layers * slots * context * cfg.kv_heads \
            * cfg.attn_head_dim * itemsize
        want = weights + slots * cfg.d_model * itemsize + kv
        assert out["decode_bytes_per_step"] == want
        assert out["mbu"] is None

    def test_int8_rows_and_scales(self, model):
        import dataclasses

        cfg, params = model
        slots, context = 4, 64
        fp = bench_gateway.decode_mbu_fields(cfg, params, slots, context,
                                             100.0, "cpu")
        q8 = bench_gateway.decode_mbu_fields(
            dataclasses.replace(cfg, kv_cache_int8=True), params, slots,
            context, 100.0, "cpu")
        kv_rows = 2 * cfg.num_layers * slots * context * cfg.kv_heads
        assert (fp["decode_bytes_per_step"] - q8["decode_bytes_per_step"]
                == kv_rows * cfg.attn_head_dim * (4 - 1) - kv_rows * 4)

    def test_moe_counts_the_experts_a_step_runs(self):
        """gmm runs E (1 - (1 - k/E)^T) experts of T lanes' tokens; dense
        all E."""
        import dataclasses

        from tensorflow_train_distributed_torch import convert
        from tensorflow_train_distributed_torch.models.moe import (
            MOE_PRESETS,
        )

        cfg = MOE_PRESETS["moe_tiny"]
        params = convert.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        dense = roofline.decode_bytes_per_step(cfg, params, None, 2, 8.0)
        gmm = roofline.decode_bytes_per_step(
            dataclasses.replace(cfg, dispatch="gmm"), params, None, 2, 8.0)
        assert dense["experts_run"] == 4
        assert gmm["experts_run"] == pytest.approx(4 * (1 - 0.5 ** 2))
        assert gmm["bytes"] < dense["bytes"]


# -- bench_generate -----------------------------------------------------------


def test_bench_generate_cpu_smoke():
    rc, rec = _main(bench_generate.main, [
        "--preset", "llama_tiny", "--batch", "2", "--prompt-len", "16",
        "--max-new", "16", "--iters", "2", "--device", "cpu"])
    assert rc == 0 and rec["max_new_tokens"] == 16
    assert rec["unit"] == "tokens/sec" and rec["value"] is None
    assert rec["mbu"] is None and rec["prefill_ms"] is None
    assert rec["mean_context"] == bench_generate.mean_context(16, 16)
    assert rec["decode_bytes_per_step"] > 0


def test_bench_generate_int8_cpu_smoke():
    """--quant int8 streams int8 kernels: fewer weight bytes a step."""
    argv = ["--preset", "llama_tiny", "--batch", "2", "--prompt-len", "16",
            "--max-new", "16", "--iters", "1", "--device", "cpu"]
    _, fp = _main(bench_generate.main, argv)
    rc, rec = _main(bench_generate.main, argv + ["--quant", "int8"])
    assert rc == 0 and rec["quant"] == "int8"
    assert rec["decode_bytes_per_step"] < fp["decode_bytes_per_step"]
    assert rec["weight_bytes"] < fp["weight_bytes"]


def test_bench_generate_rejects_max_new_one(capsys):
    with pytest.raises(SystemExit) as e:
        bench_generate.main(["--preset", "llama_tiny", "--max-new", "1",
                             "--device", "cpu"])
    assert e.value.code == 2
    assert "--max-new must be >= 2" in capsys.readouterr().err


def test_bench_generate_moe_preset_cpu_smoke():
    """MoE presets decode through the same generate(); the llama-only KV
    flags are refused for them."""
    base = ["--preset", "moe_tiny", "--batch", "2", "--prompt-len", "8",
            "--max-new", "8", "--iters", "1", "--device", "cpu"]
    rc, rec = _main(bench_generate.main, base)
    assert rc == 0 and rec["value"] is None and rec["n_params"] > 0
    rc, rec = _main(bench_generate.main, base + ["--kv-cache", "int8"])
    assert rc != 0 and "llama-family" in rec["error"]


# -- bench_input --------------------------------------------------------------


def test_bench_input_cpu_smoke():
    """Every mode gives a positive host rate, the native decode legs and
    the stager's among them; the record names the decoder that
    ``decode_image`` chose."""
    rc, rec = _main(bench_input.main, [
        "--records", "32", "--image-hw", "48", "--size", "32", "--batch",
        "16", "--workers", "2", "--device", "cpu"])
    assert rc == 0
    assert set(rec["modes"]) == {"inprocess", "inprocess_u8", "workers2",
                                 "mmap_predecoded", "inprocess_native"}
    assert all(v > 0 for v in rec["modes"].values())
    assert set(rec["decode_modes"]) == {"pil", "native_t1", "native_t2",
                                        "native_t4", "native_halfres_t1"}
    assert all(v > 0 for v in rec["decode_modes"].values())
    from tensorflow_train_distributed_torch.data import image as I

    assert (rec["native"]["decoder"], rec["native"]["why"]) == I.decoder()
    assert np.isclose(rec["value"], max(rec["modes"].values()))
