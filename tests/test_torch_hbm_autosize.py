"""HBM autosizing of the port's engine against the JAX engine's on the
CPU, mirroring JAX ``tests/test_spec_adaptive.py::TestHBMAutosize``.

``TTD_HBM_BYTES`` stands in for the device's memory.  At each synthetic
size the port solves the JAX engine's (kv_pool_blocks, budget), with a
plain, an int8 and a speculative engine.  The two solves count the same
bytes but for one named difference: the JAX cache tree keeps a block
table and a position vector in every layer, the port one of each for all
layers, so JAX's grid intercept is larger by (layers - 1) x (slots x
table width + slots) int32s and its prefill transient by (layers - 1)
int32s; the test asserts exactly that difference, and the same n.  Then
the solve's exactness against the port's own projection, the headroom,
the refusals (no pool fits, auto beside a budget, no memory report, a
bad headroom) in JAX's words, the kill switch and the linear engine
falling back to the default pool, admission's projected-bytes refusal
and the sanitizer's ``MemoryBudgetError`` at the pool, and ``serve.py``'s
``--kv-pool-blocks auto``, ``--hbm-headroom``, ``--hbm-budget-bytes`` and
``--no-paged-kv`` printing the JAX CLI's lines.  The suite's conftest arms
the memory sanitizer (``TTD_MEMCHECK=1``) before either package is
imported, so every budget here is enforced.
"""

import dataclasses
import importlib.util
import json
import os
import re
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu import serving as jserving
from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JAX_PRESETS,
    LlamaModel as JaxLlama,
)
from tensorflow_train_distributed_tpu.runtime.lint import (
    memcheck as jmemcheck,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch import serve as tserve
from tensorflow_train_distributed_torch import serving as tserving
from tensorflow_train_distributed_torch.models.llama import (
    LLAMA_PRESETS as TORCH_PRESETS,
)
from tensorflow_train_distributed_torch.runtime.lint import memcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (32 << 20, 64 << 20, 128 << 20)
ENGINE = dict(slots=2, cache_len=48, chunk=3, prompt_buckets=(8,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flat():
    params = JaxLlama(JAX_PRESETS["llama_tiny"]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _tree(flat):
    return jax.tree.map(jnp.asarray,
                        traverse_util.unflatten_dict(flat, sep="/"))


KINDS = {"plain": {}, "int8": dict(kv_cache_int8=True), "spec": {}}


def _engines(flat, kind, **kw):
    """(JAX engine, port engine) of one kind, same weights and kwargs."""
    jcfg = dataclasses.replace(JAX_PRESETS["llama_tiny"], **KINDS[kind])
    tcfg = dataclasses.replace(TORCH_PRESETS["llama_tiny"], **KINDS[kind])
    params = convert.params_from_flax(flat, tcfg)
    jkw, tkw = dict(ENGINE, **kw), dict(ENGINE, **kw)
    if kind == "spec":
        jkw.update(draft_config=jcfg, draft_params=_tree(flat),
                   speculative_k=2)
        tkw.update(draft_config=tcfg, draft_params=params, speculative_k=2)
    return (jserving.ServingEngine(jcfg, _tree(flat), **jkw),
            tserving.ServingEngine(tcfg, params, device="cpu", **tkw))


def _jax_tree_bytes(eng, n, batch, grid):
    """The JAX projection the solve reads, from its own models."""
    model = (jserving._decode_model(eng.config, eng.cache_len,
                                    slot_decode=True, paged_kv_blocks=1 + n,
                                    kv_block_size=eng.kv_block_size)
             if grid else eng._prefill_model)

    def shape_fn(v):
        return model.apply(v, jnp.zeros((batch, 1), jnp.int32),
                           mutable=["cache"])[1]["cache"]

    return jmemcheck.tree_bytes(jax.eval_shape(shape_fn, eng._variables))


def _port_ledger(eng, n):
    """The port's projection at ``n`` blocks: both grids plus one
    prefill pair, from the engine's meta caches, not from the solver."""
    grids = sum(memcheck.tree_bytes(eng._init_cache(
        eng.slots, draft, True, "meta", n_blocks=n))
        for draft in ((False, True) if eng._draft is not None else (False,)))
    return grids + eng._prefill_pair_bytes()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_solve_equals_jax_on_synthetic_sizes(flat, kind, monkeypatch):
    solved = []
    for avail in SIZES:
        monkeypatch.setenv("TTD_HBM_BYTES", str(avail))
        jeng, teng = _engines(flat, kind, kv_pool_blocks="auto")
        usable = int(avail * (1.0 - 0.1))
        n = teng.kv_blocks_total()
        assert (n, teng.hbm_budget_bytes) == (jeng._kv_pool.n_blocks,
                                              jeng.hbm_budget_bytes)
        assert teng.hbm_budget_bytes == teng.hbm_autosized_bytes() == usable
        # Exact and maximal against the port's own ledger.
        assert _port_ledger(teng, n) <= usable < _port_ledger(teng, n + 1)
        assert teng._solve_hbm_autosize() == (n, usable)
        solved.append(n)
    assert solved == sorted(solved) and solved[0] < solved[-1]
    # The one byte difference (the module docstring), target model.
    cfg = teng.config
    n_blk = -(-teng.cache_len // teng.kv_block_size)
    per_layer = teng.slots * n_blk * 4 + teng.slots * 4
    jax_grid = [_jax_tree_bytes(jeng, m, teng.slots, True) for m in (1, 2)]
    port_grid = [memcheck.tree_bytes(teng._init_cache(
        teng.slots, False, True, "meta", n_blocks=m)) for m in (1, 2)]
    assert jax_grid[1] - jax_grid[0] == port_grid[1] - port_grid[0]
    assert jax_grid[0] - port_grid[0] == (cfg.num_layers - 1) * per_layer
    assert (_jax_tree_bytes(jeng, 0, 1, False)
            - memcheck.tree_bytes(teng._cache_struct(1))
            == (cfg.num_layers - 1) * 4)


def test_headroom_scales_the_solve(flat, monkeypatch):
    monkeypatch.setenv("TTD_HBM_BYTES", str(SIZES[1]))
    roomy = _engines(flat, "plain", kv_pool_blocks="auto",
                     hbm_headroom=0.0)[1]
    tight = _engines(flat, "plain", kv_pool_blocks="auto",
                     hbm_headroom=0.5)[1]
    assert tight.hbm_budget_bytes < roomy.hbm_budget_bytes
    assert tight.kv_blocks_total() < roomy.kv_blocks_total()


def _both_raise(make_jax, make_port, match):
    """Both constructions raise ValueError; returns (jax, port) texts."""
    texts = []
    for make in (make_jax, make_port):
        with pytest.raises(ValueError, match=match) as e:
            make()
        texts.append(str(e.value))
    return texts


def _make(flat, which, **kw):
    def make():
        jcfg, tcfg = JAX_PRESETS["llama_tiny"], TORCH_PRESETS["llama_tiny"]
        if which == "jax":
            return jserving.ServingEngine(jcfg, _tree(flat), **ENGINE, **kw)
        return tserving.ServingEngine(
            tcfg, convert.params_from_flax(flat, tcfg), device="cpu",
            **ENGINE, **kw)
    return make


def test_over_headroom_is_a_construction_time_refusal(flat, monkeypatch):
    monkeypatch.setenv("TTD_HBM_BYTES", str(4 << 10))
    j, t = _both_raise(_make(flat, "jax", kv_pool_blocks="auto"),
                       _make(flat, "port", kv_pool_blocks="auto"),
                       "no pool fits")
    # Same text up to the bytes one block and a prefill pair need.
    assert j.split(" needs ")[0] == t.split(" needs ")[0]


@pytest.mark.parametrize("kw,match", [
    (dict(kv_pool_blocks="auto", hbm_budget_bytes=1 << 20),
     "one or the other"),
    (dict(kv_pool_blocks="auto", hbm_headroom=1.0), "headroom"),
    (dict(kv_pool_blocks="lots"), "int or 'auto'"),
    (dict(hbm_budget_bytes=0), "hbm_budget_bytes"),
])
def test_refusals_carry_jaxs_messages(flat, monkeypatch, kw, match):
    monkeypatch.setenv("TTD_HBM_BYTES", str(SIZES[1]))
    j, t = _both_raise(_make(flat, "jax", **kw), _make(flat, "port", **kw),
                       match)
    assert j == t


def test_no_device_report_is_a_clear_error(flat, monkeypatch):
    monkeypatch.delenv("TTD_HBM_BYTES", raising=False)
    monkeypatch.setattr(tserving, "_device_hbm_bytes", lambda device: None)
    with pytest.raises(ValueError, match="TTD_HBM_BYTES"):
        _make(flat, "port", kv_pool_blocks="auto")()
    # On the CPU, with no override, there is no report either.
    monkeypatch.undo()
    monkeypatch.delenv("TTD_HBM_BYTES", raising=False)
    assert tserving._device_hbm_bytes(torch.device("cpu")) is None


@pytest.mark.parametrize("how", ["kill_switch", "linear"])
def test_autosize_falls_back_to_the_default_pool(flat, monkeypatch, how):
    """``TTD_NO_HBM_AUTOSIZE=1``, or a linear engine (no pool): the
    default slots x ceil(cache_len / block) and no budget, as JAX."""
    monkeypatch.setenv("TTD_HBM_BYTES", str(SIZES[1]))
    kw = dict(kv_pool_blocks="auto")
    if how == "kill_switch":
        monkeypatch.setenv("TTD_NO_HBM_AUTOSIZE", "1")
    else:
        kw["paged"] = False
    jeng, teng = _engines(flat, "plain", **kw)
    assert teng.hbm_autosized_bytes() == jeng.hbm_autosized_bytes() == 0
    assert teng.hbm_budget_bytes is None and jeng.hbm_budget_bytes is None
    assert teng.kv_blocks_total() == jeng.kv_blocks_total() == (
        (2 * -(-48 // 16)) if how == "kill_switch" else 0)


def test_admission_refuses_projected_bytes_and_the_pool_raises(flat):
    """A budget below one prefill pair refuses admission at submit (the
    JAX text); a budget that holds the pair but not the pool passes
    admission and the pool's allocation raises MemoryBudgetError with
    the live set, as the JAX engine's does."""
    jeng, teng = _engines(flat, "plain")
    pair = teng._prefill_pair_bytes()
    texts = []
    for eng, budget in ((jeng, jeng._prefill_pair_bytes() - 1),
                        (teng, pair - 1)):
        eng.hbm_budget_bytes = budget
        with pytest.raises(ValueError, match="admission needs a projected"
                           ) as e:
            eng.submit([1, 2, 3], 4)
        texts.append(re.sub(r"\d+", "N", str(e.value)))
    assert texts[0] == texts[1]
    assert memcheck.armed()
    for eng, mc in ((jeng, jmemcheck), (teng, memcheck)):
        eng.hbm_budget_bytes = 2 * pair
        eng.submit([1, 2, 3], 4)
        with pytest.raises(mc.MemoryBudgetError, match="kv_pool"):
            eng.run()


def test_autosized_engine_serves_within_its_budget(flat, monkeypatch):
    """An autosized engine serves a preloaded prefix and refills with the
    default engine's tokens; the sanitizer's pool and prefill charges
    stay within the solved budget."""
    monkeypatch.setenv("TTD_HBM_BYTES", str(SIZES[0]))
    _, auto = _engines(flat, "plain", kv_pool_blocks="auto",
                       hbm_headroom=0.2)
    _, hand = _engines(flat, "plain")
    rng = np.random.default_rng(2)
    reqs = [([int(t) for t in rng.integers(1, 200, n)], m)
            for n, m in [(5, 6), (3, 9), (7, 4), (4, 8)]]
    outs = []
    for eng in (auto, hand):
        ids = [eng.submit(p, m) for p, m in reqs]
        out = eng.run()
        outs.append([out[i] for i in ids])
    assert outs[0] == outs[1]
    assert 0 < memcheck.live_bytes(owner=auto) <= auto.hbm_budget_bytes


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_cli_autosize", os.path.join(REPO, "tools", "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def npz(tmp_path_factory, flat):
    path = tmp_path_factory.mktemp("autosize") / "params.npz"
    np.savez(path, **flat)
    return str(path)


@pytest.mark.parametrize("flags", [
    ["--kv-pool-blocks", "auto", "--hbm-headroom", "0.2"],
    ["--no-paged-kv"],
    ["--hbm-budget-bytes", str(64 << 20)],
])
def test_serve_cli_flags_print_the_jax_cli_lines(flat, npz, flags, capsys,
                                                 monkeypatch, tmp_path):
    monkeypatch.setenv("TTD_HBM_BYTES", str(64 << 20))
    jcli = _jax_cli()
    monkeypatch.setattr(sys.modules["sample"], "_restore_params",
                        lambda d: _tree(flat))
    common = ["--config", "llama_tiny_sft", "--prompt", "1,2,3,4",
              "--prompt", "9,8,7,6,5,4,3", "--prompt", "5,5", "--max-new",
              "6", "--slots", "2", "--chunk", "2", "--cache-len", "48",
              "--kv-block-size", "4", *flags]
    assert jcli.main(common + ["--checkpoint-dir", str(tmp_path),
                               "--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert tserve.main(common + ["--params-npz", npz, "--device",
                                 "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want and len(want.splitlines()) == 3
    summary = tserve_summary(got.err)
    assert summary["paged"] == ("--no-paged-kv" not in flags)
    if "auto" in flags:
        assert summary["hbm_autosized_bytes"] == int((64 << 20) * 0.8)
    if "--hbm-budget-bytes" in flags:
        assert summary["hbm_budget_bytes"] == 64 << 20


def tserve_summary(err: str) -> dict:
    return json.loads(err.split("serve summary: ", 1)[1].splitlines()[0])


def test_serve_cli_refuses_what_fits_nothing(npz, monkeypatch, capsys):
    monkeypatch.setenv("TTD_HBM_BYTES", "4096")
    with pytest.raises(SystemExit, match="no pool fits"):
        tserve.main(["--config", "llama_tiny_sft", "--prompt", "1,2,3",
                     "--params-npz", npz, "--device", "cpu",
                     "--kv-pool-blocks", "auto"])
    with pytest.raises(SystemExit):
        tserve.main(["--config", "llama_tiny_sft", "--prompt", "1,2,3",
                     "--params-npz", npz, "--device", "cpu",
                     "--kv-pool-blocks", "lots"])
