"""The port's training bench tools, the card lock, the formula module and
the trace summary (``tensorflow_train_distributed_torch/tools/``), on the
CPU at tiny sizes.

Mirrors ``tests/test_bench_tools.py``: the memory guard's fit, refusal,
force and skip at the H100's data-sheet points in place of the v5e's;
the smokes of bench_bert, bench_moe and bench.py's bounded last line;
and holds the counts both packages' tools take (parameters, active
parameters, tokens a step) against the JAX tools, loaded by path as the
JAX test loads them.  Every tool refuses ``--device cuda`` on this
host with a failure record as its last line and no rate (no CPU
fallback), and a ``--device cpu`` record's device metrics are null.
"""

import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import pytest
import torch

from tensorflow_train_distributed_torch.runtime import chip_lock
from tensorflow_train_distributed_torch.tools import (
    bench,
    bench_bert,
    bench_gateway,
    bench_generate,
    bench_input,
    bench_lm,
    bench_moe,
    bench_serving,
    bench_vit,
    profile_summary,
    roofline,
)
from tensorflow_train_distributed_torch.training import memory

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under the suite's parallel workers a pool
    a worker oversubscribes the cores; no result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _lock_path(tmp_path, monkeypatch):
    monkeypatch.setenv("TTD_CHIP_LOCK_PATH", str(tmp_path / "card.lock"))
    monkeypatch.delenv(chip_lock.ENV_FLAG, raising=False)


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


def _last_record(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


# -- the memory guard ---------------------------------------------------------

LLAMA_125M = 134_105_856          # the JAX test's llama_125m count
H100_BUDGET = memory.hbm_budget_bytes(H100)


class TestHbmGuard:
    def test_h100_points(self):
        """llama_125m's state (2.0 GiB) fits the card; Llama-2-7B's full
        adam state (6.74 G parameters x 16 bytes, 100 GiB) does not."""
        check = bench_lm.check_hbm_budget
        check(LLAMA_125M, budget_bytes=H100_BUDGET, force=False)
        with pytest.raises(SystemExit) as e:
            check(6_738_415_616, budget_bytes=H100_BUDGET, force=False)
        assert e.value.code == 2

    def test_generation_budgets(self):
        """llama_1b fits; llama2_13b refuses; extra bytes count (an MoE's
        dispatch buffers can push a fitting state over)."""
        check = bench_lm.check_hbm_budget
        check(1_300_000_000, budget_bytes=H100_BUDGET, force=False)
        with pytest.raises(SystemExit):
            check(13_015_864_320, budget_bytes=H100_BUDGET, force=False)
        with pytest.raises(SystemExit):
            check(LLAMA_125M, budget_bytes=H100_BUDGET, force=False,
                  extra_bytes=int(H100_BUDGET))

    def test_skipped_off_the_card(self):
        assert bench_lm.card_budget_bytes("cpu") is None
        bench_lm.check_hbm_budget(10 ** 12, budget_bytes=None, force=False)

    def test_force_overrides(self):
        bench_lm.check_hbm_budget(10 ** 12, budget_bytes=H100_BUDGET,
                                  force=True)

    def test_refusal_record_is_json(self, capsys):
        with pytest.raises(SystemExit):
            bench_lm.check_hbm_budget(10 ** 12, budget_bytes=H100_BUDGET,
                                      force=False, device_kind=H100)
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "error" in rec and rec["estimated_gib"] > rec["budget_gib"]
        assert rec["device_kind"] == H100

    def test_moe_dispatch_bytes_count(self):
        """The MoE guard adds the dispatch buffers: moe_370m at a batch
        whose buffers alone exceed the card refuses though its state
        fits."""
        from tensorflow_train_distributed_torch.models.moe import (
            MOE_PRESETS,
        )

        cfg = MOE_PRESETS["moe_370m"]
        extra = bench_moe.dispatch_bytes(cfg, 512, 1024)
        assert extra > H100_BUDGET
        with pytest.raises(SystemExit):
            bench_lm.check_hbm_budget(363_000_000, budget_bytes=H100_BUDGET,
                                      force=False, extra_bytes=extra)


def test_device_table_is_the_h100_data_sheet():
    assert memory.peak_tflops(H100) == 989.0
    assert memory.peak_tflops(H100, "tf32") == 495.0
    assert memory.peak_tflops(H100, "f32") == 67.0
    assert memory.hbm_bandwidth_bytes_per_sec(H100) == 3.35e12
    assert memory.hbm_budget_bytes(H100) == 80e9
    assert memory.peak_tflops("cpu") is None
    assert memory.STATE_BYTES_PER_PARAM == 16


# -- the training tools against the JAX tools ---------------------------------


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX tool's own record of llama_tiny, 2 x 32, one timed step."""
    return _jax_tool("bench_lm").bench_lm("llama_tiny", 2, 32, 1, 1)


def test_bench_lm_counts_match_jax(jax_lm):
    rec = bench_lm.bench_lm("llama_tiny", 2, 32, 1, 2, device="cpu")
    assert rec["n_params"] == jax_lm["n_params"] == 106_816
    assert rec["tokens_per_step"] == (jax_lm["batch_per_chip"]
                                      * jax_lm["seq_len"]) == 64
    assert rec["unit"] == "tokens/sec" and rec["device"] == "cpu"
    for k in ("value", "step_time_ms", "mfu", "peak_mem_gib"):
        assert rec[k] is None, k
    assert rec["note"].startswith("not measured")


def _abstract(task, batch):
    return jax.eval_shape(lambda: task.init_variables(jax.random.key(0),
                                                      batch))["params"]


def test_bench_moe_counts_match_jax():
    """Total and active parameters of moe_tiny, dense and gmm, as the JAX
    tool splits them (``_split_params``)."""
    from tensorflow_train_distributed_tpu.models import moe as jmoe

    tool = _jax_tool("bench_moe")
    abstract = _abstract(jmoe.MoeLmTask(jmoe.MOE_PRESETS["moe_tiny"]),
                         {"tokens": jnp.zeros((1, 64), jnp.int32),
                          "targets": jnp.zeros((1, 64), jnp.int32)})
    dense, expert = tool._split_params(abstract)
    active = int(dense + expert * 2 / 4)
    for dispatch in ("dense", "gmm"):
        rec = bench_moe.bench_moe("moe_tiny", 4, 64, 1, 1, device="cpu",
                                  dispatch=dispatch)
        assert rec["n_params"] == tool.param_count(abstract) == 254_784
        assert rec["n_active_params"] == active == 156_480
        assert 0 < rec["n_active_params"] < rec["n_params"]
        assert rec["tokens_per_step"] == 256 and rec["value"] is None
        assert rec["dispatch"] == dispatch


def test_bench_bert_smoke_and_counts_match_jax():
    from tensorflow_train_distributed_tpu.models import bert as jbert

    abstract = _abstract(jbert.make_task(jbert.BERT_PRESETS["bert_tiny"]),
                         {"input_ids": jnp.zeros((1, 32), jnp.int32)})
    rec = bench_bert.bench_bert("bert_tiny", 2, 32, 1, 2, device="cpu")
    assert rec["unit"] == "samples/sec" and rec["value"] is None
    assert rec["n_params"] == _jax_tool("bench_lm").param_count(abstract)
    assert 0 < rec["non_embedding_params"] < rec["n_params"]
    assert rec["policy"] == "mixed_bfloat16" and rec["mfu"] is None


def test_bench_vit_smoke_and_counts_match_jax():
    from tensorflow_train_distributed_tpu.models import vit as jvit

    cfg = jvit.VIT_PRESETS["vit_tiny"]
    abstract = _abstract(jvit.make_task(cfg), {
        "image": jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
        "label": jnp.zeros((1,), jnp.int32)})
    rec = bench_vit.bench_vit("vit_tiny", 2, 1, 2, device="cpu")
    assert rec["n_params"] == _jax_tool("bench_lm").param_count(abstract)
    assert rec["patch_seq"] == cfg.num_patches
    assert rec["unit"] == "images/sec" and rec["value"] is None


# -- no fallback --------------------------------------------------------------

_NO_CARD = [
    (bench_lm.main, ["--preset", "llama_tiny"]),
    (bench_bert.main, ["--preset", "bert_tiny"]),
    (bench_moe.main, ["--preset", "moe_tiny"]),
    (bench_vit.main, ["--preset", "vit_tiny"]),
    (bench_generate.main, ["--preset", "llama_tiny"]),
    (bench_serving.main, ["--preset", "llama_tiny"]),
    (bench_gateway.main, ["--preset", "llama_tiny"]),
    (bench_input.main, []),
    (bench.main, ["--configs", "resnet_tiny", "--families", "resnet"]),
]


@pytest.mark.parametrize("fn,argv", _NO_CARD,
                         ids=[f.__module__.rsplit(".", 1)[1]
                              for f, _ in _NO_CARD])
def test_no_card_no_fallback(fn, argv, tmp_path, monkeypatch):
    """``--device cuda`` (the default) on this CPU-only host: a nonzero
    exit and a failure record as the last line, with no rate."""
    monkeypatch.setattr(bench, "FULL_EMIT_PATH", str(tmp_path / "e.json"))
    assert not torch.cuda.is_available()
    rc, rec = _last_record(fn, argv)
    assert rc != 0
    assert "NoCard" in rec["error"] and rec["value"] is None


# -- bench.py -----------------------------------------------------------------


def test_bench_emit_headline_is_bounded_and_last(tmp_path, monkeypatch):
    """Whatever the record's size, the last line is a compact headline
    and the full record is persisted."""
    monkeypatch.setattr(bench, "FULL_EMIT_PATH",
                        str(tmp_path / "last_emit.json"))
    fat = {"metric": bench.HEADLINE_METRIC, "value": 1.0,
           "unit": "images/sec", "vs_baseline": None, "device": "cuda",
           "device_kind": H100, "card": f"{H100}, 700.00 W",
           "error": "x" * 500,
           "configs": {f"cfg{i}": {"v": i, "pad": "y" * 400}
                       for i in range(30)}}
    buf = io.StringIO()
    with redirect_stdout(buf):
        bench._emit(fat)
    lines = buf.getvalue().strip().splitlines()
    head = json.loads(lines[-1])
    assert len(lines[-1]) < 500
    assert head["value"] == 1.0 and head["device_kind"] == H100
    assert head["vs_baseline"] is None and "configs" not in head
    assert len(head["error"]) <= 160
    assert all(len(ln) <= bench._MAX_FULL_LINE for ln in lines)
    with open(bench.FULL_EMIT_PATH) as f:
        assert json.load(f)["error"] == "x" * 500


def test_bench_resnet_family_on_cpu(tmp_path, monkeypatch):
    """The in-process family on the CPU: the config's record with every
    device metric null, the headline the last line."""
    monkeypatch.setattr(bench, "FULL_EMIT_PATH", str(tmp_path / "e.json"))
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(["--device", "cpu", "--configs", "resnet_tiny",
                         "--families", "resnet", "--batch-per-chip", "2",
                         "--warmup", "1", "--iters", "1"])
    lines = buf.getvalue().strip().splitlines()
    assert rc == 0
    head, full = json.loads(lines[-1]), json.loads(lines[-2])
    assert head["config"] == "resnet_tiny" and head["value"] is None
    row = full["configs"]["resnet_tiny"]
    assert row["images_per_sec"] is None and row["mfu"] is None
    assert full["card_lock"] == "none"


def test_bench_refuses_the_tpu_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "FULL_EMIT_PATH", str(tmp_path / "e.json"))
    for flag in (["--acquire-timeout", "60"], ["--allow-cpu-fallback"],
                 ["--no-persist"]):
        rc, rec = _last_record(bench.main, ["--device", "cpu", *flag])
        assert rc == 2 and "No counterpart needed" in rec["error"], flag
    rc, rec = _last_record(bench_lm.main, ["--device", "cpu",
                                           "--no-scan-layers"])
    assert rc == 2 and "No counterpart needed" in rec["error"]


# -- the card lock ------------------------------------------------------------


def test_chip_lock_holder_inheritance_and_timeout():
    assert chip_lock.held_fd() is None
    with chip_lock.chip_lock() as how:
        assert how == "acquired"
        assert chip_lock.lock_holder() == os.getpid()
        assert chip_lock.held_fd() is not None
        assert os.environ[chip_lock.ENV_FLAG] == "1"
        with chip_lock.chip_lock() as inner:      # a child's view
            assert inner == "inherited"
        os.environ.pop(chip_lock.ENV_FLAG)
        try:
            with pytest.raises(TimeoutError, match=str(os.getpid())):
                with chip_lock.chip_lock(timeout=0.1, poll=0.02):
                    pass
        finally:
            os.environ[chip_lock.ENV_FLAG] = "1"
    assert chip_lock.held_fd() is None
    assert chip_lock.ENV_FLAG not in os.environ
    assert chip_lock.lock_holder() is None


# -- the formulas -------------------------------------------------------------


def test_one_formula_module():
    """chip_smoke.py, the runtime lint and the tools read one table and
    one set of formulas."""
    import chip_smoke
    from tensorflow_train_distributed_torch.runtime.lint import compilecheck

    for name in ("bound", "product_bound", "decode_bytes_per_step",
                 "vit_forward_flops", "PEAK_BF16_FLOPS", "PEAK_F32_FLOPS",
                 "PEAK_F32_SPLIT_FLOPS", "RESNET50_FWD_FLOPS"):
        assert getattr(chip_smoke, name) is getattr(roofline, name), name
    assert chip_smoke.KINDS is profile_summary.KINDS
    assert chip_smoke.classify is profile_summary.classify
    assert roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert not hasattr(compilecheck, "_DATASHEET")


def test_compilecheck_reads_the_table(monkeypatch):
    from tensorflow_train_distributed_torch.runtime.lint import compilecheck

    monkeypatch.delenv("TTD_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TTD_PEAK_HBM_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: H100)
    assert compilecheck.peak_flops_per_s() == 989e12
    assert compilecheck.peak_hbm_bytes_per_s() == 3.35e12
    monkeypatch.setenv("TTD_PEAK_FLOPS", "1e12")
    assert compilecheck.peak_flops_per_s() == 1e12


def test_training_formulas_read_as_the_phases_did():
    """The decoder formula at llama_125m is phase 6's (6 (N - V d) + 6 L
    S d), the windowed one phase 10's mean visible keys, the MoE one
    phase 8's; BERT's and LoRA's as PERF.md writes them."""
    from tensorflow_train_distributed_torch.models import bert, llama, moe

    cfg = llama.LLAMA_PRESETS["llama_125m"]
    n = 134_105_856
    flops, formula = roofline.decoder_flops_per_token(n, cfg, 2048)
    assert flops == 6 * (n - 32_000 * 768) + 6 * 12 * 2048 * 768
    assert formula == roofline.FORMULAS["decoder"]
    win = llama.LLAMA_PRESETS["mistral_7b"]
    keys = sum(min(i + 1, 4096) for i in range(8192)) / 8192
    assert roofline.mean_visible_keys(8192, 4096) == keys
    flops, formula = roofline.decoder_flops_per_token(n, win, 8192)
    assert flops == 6 * (n - 32_000 * 4096) + 12 * 32 * 4096 * keys
    assert "mean visible keys" in formula
    mcfg = moe.MOE_PRESETS["moe_370m"]
    total, active = roofline.moe_active_params(
        {"a": 100, "layers.0.mlp.experts.w": 80}, mcfg)
    assert (total, active) == (180, 100 + 80 * 2 / 8)
    assert roofline.moe_flops_per_token(active, mcfg, 1024) == (
        6 * active + 12 * 8 * 768 * 1024 * 0.5)
    bcfg = bert.BERT_PRESETS["bert_base"]
    assert roofline.bert_flops_per_token(10, bcfg, 128) == (
        60 + 12 * 12 * 128 * 768)
    assert roofline.lora_flops_per_token(10, cfg, 2048) == (
        40 + 8 * 12 * 2048 * 768)
    assert roofline.bound(3.35e9, 0, 1e12) == (1.0, "bytes")


# -- profile_summary ----------------------------------------------------------


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


def test_profile_summary_kinds_busy_share_and_gaps(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "ttd_step",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ttd_step",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "ttd_step",
         "ts": 100, "dur": 100},
        _kernel("sm90_xmma_gemm_bf16bf16", 10, 30),
        _kernel("void flash_fwd_kernel<false>", 40, 20),
        _kernel("void flash_bwd_kernel<true>", 120, 20),
        _kernel("ce_fwd_kernel", 150, 10),
        _kernel("rms_norm_fwd", 170, 10),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 190,
         "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 150},
    ]
    path = tmp_path / "trace_1_0.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rec = profile_summary.summarize(str(tmp_path))
    assert rec["trace"] == str(path) and rec["steps"] == 2
    assert set(rec["kinds"]) == set(profile_summary.KINDS)
    kinds = rec["kinds"]
    assert kinds["matmul"]["ms_per_step"] == pytest.approx(0.015)
    assert kinds["flash_attention"]["launches_per_step"] == 0.5
    assert kinds["splash_attention_bwd"]["ms_per_step"] == pytest.approx(
        0.01)
    assert kinds["cross_entropy"]["ms_per_step"] > 0
    assert kinds["rms_norm"]["ms_per_step"] > 0
    assert kinds["other"]["ms_per_step"] == pytest.approx(0.005)
    assert rec["busy_share"] == pytest.approx(100 / 200)
    assert rec["idle_gaps_ms"] == pytest.approx(
        [0.06, 0.01, 0.01, 0.01, 0.01])
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert profile_summary.main([str(path)]) == 0
    assert "2 steps" in buf.getvalue()


def test_profile_summary_of_a_cpu_trace_is_not_measured(tmp_path):
    """A trace ``runtime/profiling.py`` took on the CPU holds no device
    events: "not measured", no device figure."""
    from tensorflow_train_distributed_torch.runtime import profiling

    timing = bench_lm.timed_steps(
        lambda: torch.ones(8, 8) @ torch.ones(8, 8), warmup=1, iters=1,
        device="cpu", profile_dir=str(tmp_path))
    assert timing["step_s"] is None and timing["trace"]
    rec = profile_summary.summarize(timing["trace"])
    assert rec["device"] == "not measured" and rec["steps"] == 2
    assert rec["busy_share"] is None
    assert all(v is None for v in rec["kinds"].values())
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert profile_summary.main([str(tmp_path)]) == 0
    assert "not measured" in buf.getvalue()
    assert profiling.stop_trace() is None       # none left running


def test_profile_summary_kinds_are_the_phases_kinds():
    for name, kind in (("paged_attention_ring_kernel", "paged_attention"),
                       ("ttd_grouped_tgmm_wgmma", "tgmm"),
                       ("ttd_grouped_gmm_wgmma", "gmm"),
                       ("cudnn::bn_fw_tr_1C11_kernel", "batch_norm"),
                       ("sm90_xmma_fprop_implicit_gemm", "conv"),
                       ("nvjet_tst_64x8", "matmul"),
                       ("elementwise_kernel", "other")):
        assert profile_summary.classify(name) == kind, name


# -- bench_input's native legs ---------------------------------------------------


def test_bench_input_native_legs_raise_without_a_compiler(tmp_path,
                                                          monkeypatch):
    """The libjpeg and stager legs need the native libraries: with no
    compiler and nothing built the tool ends in a failure record naming
    the compiler, and never times PIL in their place."""
    from tensorflow_train_distributed_torch import native
    from tensorflow_train_distributed_torch.data import image

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(image, "_DECODER", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    rc, rec = _last_record(bench_input.main, [
        "--records", "16", "--image-hw", "32", "--size", "16", "--batch",
        "8", "--workers", "", "--device", "cpu"])
    assert rc == 1 and rec["value"] is None
    assert "NativeUnavailable" in rec["error"]
    assert "no C++ compiler" in rec["error"]
