"""``generate()``, the shared-index decode with its rolling ring and sink
buffers, ``generate_speculative`` and ``sample.py`` against the JAX
package on the CPU (f32, the same weights through ``convert``).

- Greedy tokens equal the JAX ``generate()``'s: ``llama_tiny`` (GQA) and
  an MHA variant, a single-token prompt, ``kv_cache_int8``, and a
  ``sliding_window`` 16 model with 0 and 4 sinks whose prompt and new
  tokens cross the window (the ring wraps), prompts shorter and longer
  than the window among them.
- The fresh prefill goes through the attention kernel dispatch on the
  prompt zero-padded to a multiple of 128 (its plain version here):
  prompts of 127, 128 and 129 tokens give JAX's tokens, and every
  dispatched length is a multiple of 128.
- Chunked prefill and multi-token calls on the ring and the linear cache
  equal one-shot prefill (JAX ``tests/test_window_attention.py``), and
  the decode's logits equal a teacher-forced forward.
- The refusals carry JAX's messages.
- Seeded sampling reproduces itself and, by a chi-square test, draws from
  the filtered softmax.
- ``generate_speculative`` gives ``generate()``'s greedy tokens with a
  self draft and a disagreeing one, and JAX's ``stats``.
- ``sample.py`` on a checkpoint of the port's launcher prints the JAX
  ``tools/sample.py`` lines on the same weights; ``--init-from-hf``, not
  ported, exits 2; ``--quant int8`` samples.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from scipy import stats

from tensorflow_train_distributed_tpu.models import generate as jgen
from tensorflow_train_distributed_tpu.models import speculative as jspec
from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JAX_PRESETS,
    LlamaModel as JaxLlama,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch import sample as tsample
from tensorflow_train_distributed_torch.models import generate as tgen
from tensorflow_train_distributed_torch.models import layers as TL
from tensorflow_train_distributed_torch.models import speculative as tspec
from tensorflow_train_distributed_torch.models.llama import (
    LLAMA_PRESETS as TORCH_PRESETS,
    LlamaModel as TorchLlama,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these many small ops: under the suite's
    parallel workers a thread pool a worker oversubscribes the cores and
    slows each op tens of times; the results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name="llama_tiny", **kw):
    return (dataclasses.replace(JAX_PRESETS[name], **kw),
            dataclasses.replace(TORCH_PRESETS[name], **kw))


def _flat(cfg, seed=0):
    params = JaxLlama(cfg).init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _tree(flat):
    return jax.tree.map(jnp.asarray, traverse_util.unflatten_dict(flat,
                                                                  sep="/"))


def _both(jcfg, tcfg, prompt, max_new, seed=0):
    flat = _flat(jcfg, seed)
    want = np.asarray(jgen.generate(jcfg, _tree(flat), jnp.asarray(prompt),
                                    max_new))
    got = tgen.generate(tcfg, convert.params_from_flax(flat, tcfg), prompt,
                        max_new, device="cpu")
    return want, got.numpy()


def _prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(1, 250, (b, s)).astype(
        np.int32)


GREEDY = {
    "gqa": ({}, 2, 9, 20),
    "mha": (dict(num_kv_heads=None), 2, 9, 12),
    "single_token_prompt": ({}, 3, 1, 10),
    "kv_int8": (dict(kv_cache_int8=True), 2, 7, 16),
    "window16": (dict(sliding_window=16), 2, 10, 30),
    "window16_long_prompt": (dict(sliding_window=16), 1, 40, 20),
    "window16_sinks4": (dict(sliding_window=16, attention_sinks=4), 2, 10,
                        30),
    "window16_sinks4_long_prompt": (
        dict(sliding_window=16, attention_sinks=4), 1, 40, 20),
    "window16_sinks4_one_token": (
        dict(sliding_window=16, attention_sinks=4), 1, 1, 30),
    "window_linear_cache": (dict(sliding_window=64, attention_sinks=2), 1,
                            20, 20),
}


@pytest.mark.parametrize("case", list(GREEDY))
def test_greedy_tokens_equal_jax(case):
    kw, b, s, n = GREEDY[case]
    want, got = _both(*_configs(**kw), _prompt(b, s, len(case)), n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [127, 128, 129])
@pytest.mark.parametrize("window", [None, 16])
def test_fresh_prefill_padded_to_128(s, window, monkeypatch):
    seen = []
    orig = TL.multihead_attention_kernel

    def spy(q, k, v, **kw):
        seen.append((q.shape[-2], k.shape[-2], kw["window"]))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(TL, "multihead_attention_kernel", spy)
    jcfg, tcfg = _configs(max_positions=256, sliding_window=window)
    want, got = _both(jcfg, tcfg, _prompt(1, s, s), 6)
    np.testing.assert_array_equal(got, want)
    n = -(-s // 128) * 128
    assert seen == [(n, n, window)] * tcfg.num_layers


def test_ring_memory_is_the_window():
    _, tcfg = _configs(sliding_window=16, attention_sinks=4)
    cache = TorchLlama(tcfg).init_cache(2, 100, shared=True)
    lc = cache.layers[0]
    assert lc["key_cache"].shape == (2, 16, 2, 16)
    assert lc["sink_key"].shape == (2, 4, 2, 16)
    assert cache.index == 0 and cache.fresh
    lin = TorchLlama(tcfg).init_cache(2, 16, shared=True).layers[0]
    assert lin["key_cache"].shape[1] == 16 and "sink_key" not in lin


@pytest.mark.parametrize("kw", [dict(sliding_window=8),
                                dict(sliding_window=8, attention_sinks=3),
                                dict(), dict(kv_cache_int8=True)],
                         ids=["ring", "ring_sinks", "linear", "int8"])
def test_chunked_prefill_matches_one_shot(kw):
    """Multi-token calls at cur > 0 equal one prefill, logits and the next
    step's, on the ring (``_rolling_block``) and the linear cache."""
    jcfg, tcfg = _configs(**kw)
    params = convert.params_from_flax(_flat(jcfg), tcfg)
    model = tgen._decode_model(tcfg, params, device="cpu")
    prompt = torch.as_tensor(_prompt(1, 26, 5)).long()
    one_c = model.init_cache(1, 40, shared=True)
    one = model(prompt, one_c)
    c = model.init_cache(1, 40, shared=True)
    parts = [model(prompt[:, i:j], c) for i, j in ((0, 11), (11, 14),
                                                    (14, 26))]
    torch.testing.assert_close(torch.cat(parts, 1), one, rtol=1e-5,
                               atol=1e-5)
    tok = torch.tensor([[7]])
    torch.testing.assert_close(model(tok, c), model(tok, one_c), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(sliding_window=8),
                                dict(sliding_window=8, attention_sinks=4)],
                         ids=["linear", "ring", "ring_sinks"])
def test_decode_equals_teacher_forcing(kw):
    """Each step's logits equal a causal forward of prompt + generated
    tokens (the training path) at that position; the ring wraps ~4x."""
    jcfg, tcfg = _configs(**kw)
    params = convert.params_from_flax(_flat(jcfg), tcfg)
    model = tgen._decode_model(tcfg, params, device="cpu")
    prompt = torch.as_tensor(_prompt(2, 11, 8)).long()
    logits = []
    out = tgen._generate(model, prompt, 30, tgen._picker(0.0, None, None,
                                                         None, 2, "cpu"),
                         logits_out=logits)
    with torch.no_grad():
        forced = model(out[:, :-1]).float()[:, 10:]
    torch.testing.assert_close(torch.stack(logits, 1), forced, rtol=1e-4,
                               atol=1e-4)


def test_refusals_match_jax():
    prompt = _prompt(1, 4)
    cases = [dict(sliding_window=8, kv_cache_int8=True),
             dict(attention_sinks=2),
             dict(sliding_window=4, attention_sinks=6)]
    for kw in cases:
        jcfg, tcfg = _configs(**kw)
        flat = _flat(_configs()[0])
        errs = []
        with pytest.raises(ValueError) as e:
            jgen.generate(jcfg, _tree(flat), jnp.asarray(prompt), 20)
        errs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            tgen.generate(tcfg, convert.params_from_flax(flat, tcfg), prompt,
                          20, device="cpu")
        errs.append(str(e.value))
        assert errs[0] == errs[1], kw
    jcfg, tcfg = _configs()
    params = convert.params_from_flax(_flat(jcfg), tcfg)
    for args, kw in (((prompt, 200), {}), ((prompt, -1), {}),
                     ((prompt, 4), dict(temperature=-1.0)),
                     ((prompt, 4), dict(top_k=3)),
                     ((prompt, 4), dict(temperature=1.0))):
        errs = []
        with pytest.raises(ValueError) as e:
            jgen.generate(jcfg, _tree(_flat(jcfg)), jnp.asarray(args[0]),
                          args[1], **kw)
        errs.append(str(e.value).replace("rng=", "seed="))
        with pytest.raises(ValueError) as e:
            tgen.generate(tcfg, params, *args, device="cpu", **kw)
        errs.append(str(e.value))
        assert errs[0] == errs[1], kw
    # Scales without int8 kernels (and the reverse) raise JAX's message.
    from tensorflow_train_distributed_torch.models import quant as tquant

    qparams, scales = tquant.quantize_params(params)
    for p, s in ((params, scales), (qparams, None)):
        with pytest.raises(ValueError, match="must be passed together"):
            tgen.generate(tcfg, p, prompt, 4, quant_scales=s, device="cpu")
    assert tgen.generate(tcfg, qparams, prompt, 4, quant_scales=scales,
                         device="cpu").shape == (prompt.shape[0],
                                                 prompt.shape[1] + 4)
    assert tgen.generate(tcfg, params, prompt, 0, device="cpu").tolist() == (
        prompt.tolist())
    with pytest.raises(ValueError, match="shared-index"):
        model = TorchLlama(dataclasses.replace(tcfg, sliding_window=8))
        model(torch.zeros(1, 3, dtype=torch.long), model.init_cache(1, 16))


def test_sampling_reproducible_and_follows_the_filtered_softmax():
    _, tcfg = _configs()
    params = convert.params_from_flax(_flat(_configs()[0]), tcfg)
    prompt = np.repeat(_prompt(1, 6, 11), 1500, axis=0)
    kw = dict(temperature=1.7, top_k=8, device="cpu")
    a = tgen.generate(tcfg, params, prompt, 1, seed=3, **kw)
    assert torch.equal(a, tgen.generate(tcfg, params, prompt, 1, seed=3,
                                        **kw))
    assert not torch.equal(a, tgen.generate(tcfg, params, prompt, 1,
                                            seed=4, **kw))
    model = tgen._decode_model(tcfg, params, device="cpu")
    with torch.no_grad():
        logits = model(torch.as_tensor(prompt[:1]).long())[0, -1].float()
    p = torch.softmax(tgen.filter_logits(logits, temperature=1.7, top_k=8),
                      -1).numpy()
    support = np.flatnonzero(p)
    assert len(support) == 8
    first = a[:, 6].numpy()
    assert set(first) <= set(support)
    counts = np.array([(first == t).sum() for t in support])
    assert stats.chisquare(counts, p[support] * len(first)).pvalue > 1e-3


@pytest.mark.parametrize("draft", ["self", "disagreeing"])
def test_generate_speculative_equals_generate_and_jax(draft):
    jcfg, tcfg = _configs()
    flat = _flat(jcfg)
    dname = "llama_tiny" if draft == "self" else "llama_tiny_scan"
    jd, td = _configs(dname)
    dflat = flat if draft == "self" else _flat(jd, 99)
    prompt = _prompt(1, 9, 3)
    jt, js = jspec.generate_speculative(jcfg, _tree(flat), jd, _tree(dflat),
                                        jnp.asarray(prompt), 20, k=3)
    tp = convert.params_from_flax(flat, tcfg)
    tt, ts = tspec.generate_speculative(
        tcfg, tp, td, convert.params_from_flax(dflat, td), prompt, 20, k=3,
        device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ts == js
    assert torch.equal(tt, tgen.generate(tcfg, tp, prompt, 20,
                                         device="cpu"))
    if draft == "self":
        assert ts["drafted_accepted"] == 3 * ts["rounds"]
    with pytest.raises(ValueError, match="sliding_window"):
        tspec.generate_speculative(
            dataclasses.replace(tcfg, sliding_window=8), tp, td,
            convert.params_from_flax(dflat, td), prompt, 4, device="cpu")
    with pytest.raises(ValueError, match="batch-1"):
        tspec.generate_speculative(tcfg, tp, td, tp, np.repeat(prompt, 2, 0),
                                   4, device="cpu")


def test_speculative_sampling_reproducible():
    _, tcfg = _configs()
    tp = convert.params_from_flax(_flat(_configs()[0]), tcfg)
    kw = dict(k=3, temperature=0.9, top_p=0.9, device="cpu")
    a = tspec.generate_speculative(tcfg, tp, tcfg, tp, _prompt(1, 5), 12,
                                   seed=1, **kw)
    b = tspec.generate_speculative(tcfg, tp, tcfg, tp, _prompt(1, 5), 12,
                                   seed=1, **kw)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]


# -- sample.py ----------------------------------------------------------------


def _train(tmp, steps=2):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch",
         "--config", "llama_tiny_sft", "--steps", str(steps), "--device",
         "cpu", "--checkpoint-dir", str(tmp / "ck"), "--checkpoint-every",
         str(steps)], cwd=tmp, env=env, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return str(tmp / "ck")


def _jax_sample_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_sample_cli", os.path.join(REPO, "tools", "sample.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sample_cli_prints_the_jax_cli_lines(tmp_path, capsys, monkeypatch):
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    ck = _train(tmp_path)
    flat = {}
    for name, v in CheckpointManager(ck).restore_params().items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        flat["/".join(parts)] = v.float().numpy()
    jcli = _jax_sample_cli()
    monkeypatch.setattr(jcli, "_restore_params", lambda d: _tree(flat))
    rows = ["--prompt", "1,2,3,4", "--prompt", "9,8,7,6"]
    spec = ["--speculative-draft-config", "llama_tiny_sft",
            "--speculative-draft-checkpoint", ck, "--speculative-k", "3"]
    for extra in ([], spec[:]):
        r = rows if not extra else rows[:2]
        args = ["--config", "llama_tiny_sft", "--checkpoint-dir", ck,
                "--max-new", "12", *r, *extra]
        assert jcli.main(args + ["--platform", "cpu"]) == 0
        want = capsys.readouterr().out
        assert tsample.main(args + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        assert got == want and len(got.splitlines()) == len(r) // 2 + (
            1 if extra else 0)
    base = ["--config", "llama_tiny_sft", "--checkpoint-dir", ck,
            "--prompt", "1,2", "--device", "cpu"]
    # --init-from-hf: the checkpoint exported as an HF directory samples
    # the same tokens; it names the weights alone.
    from tensorflow_train_distributed_torch.models.export_hf import (
        export_hf_from_registry,
    )

    hf = str(export_hf_from_registry("llama_tiny_sft", ck, tmp_path / "hf"))
    hf_args = ["--config", "llama_tiny_sft", "--max-new", "12", *rows,
               "--device", "cpu"]
    assert tsample.main(hf_args + ["--checkpoint-dir", ck]) == 0
    want_hf = capsys.readouterr().out
    assert tsample.main(hf_args + ["--init-from-hf", hf]) == 0
    assert capsys.readouterr().out == want_hf
    with pytest.raises(SystemExit) as e:
        tsample.main(base + ["--init-from-hf", hf])
    assert e.value.code == 2
    assert "not allowed with argument" in capsys.readouterr().err
    assert tsample.main(base + ["--quant", "int8"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 1
    for flags, match in (
            (["--prompt", "1,2,3"], "equal length"),
            (["--top-k", "3"], "temperature"),
            (["--max-new", "0"], "max-new"),
            (["--prompt", "1,999"], "outside vocab"),
            (["--lora-alpha", "8"], "lora-rank"),
            (["--dispatch", "gmm"], "dispatch"),
            (["--quant", "int8", *spec], "does not compose with --quant"),
            (spec[:2], "required")):
        with pytest.raises(SystemExit, match=match):
            tsample.main(base + flags)
    with pytest.raises(SystemExit, match="llama-family TARGET"):
        tsample.main(["--config", "moe_tiny_lm", "--params-npz", "x",
                      "--prompt", "1", "--device", "cpu", *spec])
    with pytest.raises(SystemExit, match="not a decoder LM"):
        tsample.main(["--config", "bert_tiny_mlm", "--params-npz", "x",
                      "--prompt", "1", "--device", "cpu"])
    assert json.loads(got.splitlines()[0])["speculative_stats"]["tokens"] == 12
