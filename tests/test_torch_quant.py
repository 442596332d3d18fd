"""int8 weight-only serving (``models.quant``) against the JAX package's
on the CPU, on the same weights (the JAX modules' own init, carried over
by ``convert``).

- ``quantize_params``: codes bit for bit and scales equal in f32 on
  llama_tiny, llama_tiny_scan (depth-stacked kernels, whose ``[L, out]``
  scales ``convert.scales_from_flax`` splits), moe_tiny (expert-stacked
  ``[E, in, out]`` kernels, ``[E, out]`` scales) and qwen_moe_tiny (the
  f32 router, the shared gate, qkv biases); ``dequantize_params``,
  ``quantized_bytes`` and the refusals' messages.
- The int8 forward equals JAX's ``quantized_inference`` within 2e-5 (the
  JAX test's own tolerance, f32), and the port's forward of the
  dequantized weights within 2e-5 (the quantization error comes only from
  the rounding, never from the serving plumbing).
- Greedy tokens of ``generate()`` with ``quant_scales`` equal JAX's,
  the rolling window's ring included, and so do the engine's with target
  and draft scales; int8 with the gmm dispatch raises JAX's error.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.models import generate as jgen
from tensorflow_train_distributed_tpu.models import moe as JM
from tensorflow_train_distributed_tpu.models import quant as jquant
from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JAX_LLAMA,
    LlamaModel as JaxLlama,
)
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.models import generate as tgen
from tensorflow_train_distributed_torch.models import moe as TM
from tensorflow_train_distributed_torch.models import quant as tquant
from tensorflow_train_distributed_torch.models.llama import (
    LLAMA_PRESETS as TORCH_LLAMA,
)
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)

CONFIGS = ("llama_tiny", "llama_tiny_scan", "moe_tiny", "qwen_moe_tiny")
TOL = 2e-5          # JAX tests/test_quant.py's, f32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these many small ops (the suite runs in
    parallel workers); the results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name, **kw):
    if name in JM.MOE_PRESETS:
        return (dataclasses.replace(JM.MOE_PRESETS[name], **kw),
                dataclasses.replace(TM.MOE_PRESETS[name], **kw))
    return (dataclasses.replace(JAX_LLAMA[name], **kw),
            dataclasses.replace(TORCH_LLAMA[name], **kw))


def _jax_model(cfg):
    return (JM.MoeLmModel(cfg) if isinstance(cfg, JM.MoeConfig)
            else JaxLlama(cfg))


def _flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(tree), sep="/").items()}


def _tree(flat):
    return jax.tree.map(jnp.asarray,
                        traverse_util.unflatten_dict(flat, sep="/"))


@pytest.fixture(scope="module")
def quantized():
    """{config: (flat JAX params, flat JAX qparams, flat JAX scales)}."""
    out = {}
    for i, name in enumerate(CONFIGS):
        jcfg, _ = _configs(name)
        params = _jax_model(jcfg).init(jax.random.PRNGKey(i),
                                       jnp.zeros((1, 8), jnp.int32))
        flat = _flat_np(params["params"])
        q, s = jquant.quantize_params(_tree(flat))
        out[name] = (flat, _flat_np(q), _flat_np(s))
    return out


def _prompt(b, s, seed=0):
    return np.random.default_rng(seed).integers(1, 250, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", CONFIGS)
def test_codes_and_scales_equal_jax_bit_for_bit(quantized, name):
    flat, jq, js = quantized[name]
    _, tcfg = _configs(name)
    qparams, scales = tquant.quantize_params(
        convert.params_from_flax(flat, tcfg))
    want_q = convert.params_from_flax(jq, tcfg)
    want_s = convert.scales_from_flax(js, tcfg)
    assert qparams.keys() == want_q.keys() and scales.keys() == want_s.keys()
    for k, v in qparams.items():
        assert v.dtype == want_q[k].dtype and torch.equal(v, want_q[k]), k
    for k, v in scales.items():
        assert v.dtype == torch.float32 and torch.equal(v, want_s[k]), k
    kinds = {k.split(".")[-2] for k in scales}
    assert {"query", "key", "value", "out", "lm_head"} <= kinds
    assert not any(k.endswith(("embedding", "bias")) or "norm" in k
                   for k, v in qparams.items() if v.dtype == torch.int8)
    if name.startswith("moe") or name.startswith("qwen"):
        stacked = [k for k in scales if ".experts." in k]
        assert stacked and all(scales[k].dim() == 2 for k in stacked)
        assert "router" in kinds
    if name == "qwen_moe_tiny":
        assert "shared_gate" in kinds
        assert qparams["layers.0.attention.query.bias"].dtype == (
            torch.float32)


@pytest.mark.parametrize("name", CONFIGS)
def test_dequantize_and_bytes_match_jax(quantized, name):
    flat, jq, js = quantized[name]
    _, tcfg = _configs(name)
    qparams, scales = tquant.quantize_params(
        convert.params_from_flax(flat, tcfg))
    deq = tquant.dequantize_params(qparams, scales)
    want = convert.params_from_flax(_flat_np(jquant.dequantize_params(
        _tree(jq), _tree(js))), tcfg)
    for k, v in deq.items():
        assert torch.equal(v, want[k]), k
    assert tquant.quantized_bytes(qparams) == jquant.quantized_bytes(
        _tree(jq))
    assert tquant.quantized_bytes(qparams) < tquant.quantized_bytes(
        convert.params_from_flax(flat, tcfg)) / 2


def test_refusals_carry_jaxs_messages(quantized):
    flat, jq, js = quantized["llama_tiny"]
    _, tcfg = _configs("llama_tiny")
    tp = convert.params_from_flax(flat, tcfg)
    tq, ts = tquant.quantize_params(tp)
    pairs = [(lambda: jquant.quantize_params(_tree(flat), bits=4),
              lambda: tquant.quantize_params(tp, bits=4)),
             (lambda: jquant.quantize_params(_tree(jq)),
              lambda: tquant.quantize_params(tq)),
             (lambda: jquant.check_quant_pairing(_tree(jq), None),
              lambda: tquant.check_quant_pairing(tq, None)),
             (lambda: jquant.check_quant_pairing(_tree(flat), _tree(js)),
              lambda: tquant.check_quant_pairing(tp, ts))]
    for jfn, tfn in pairs:
        with pytest.raises(ValueError) as je:
            jfn()
        with pytest.raises(ValueError) as te:
            tfn()
        assert str(te.value) == str(je.value)
    tquant.check_quant_pairing(tq, ts)
    model = TM.MoeLmModel(TM.MOE_PRESETS["moe_tiny"])
    for bad, match in (({"lm_head.scale": torch.ones(256)}, "no int8"),
                       ({"nowhere.scale": torch.ones(3)}, "no int8")):
        with pytest.raises(ValueError, match=match):
            tquant.attach_scales(model, bad, "cpu")
    with pytest.raises(ValueError, match="shape"):
        tgen._decode_model(tcfg, tq, quant_scales=dict(
            ts, **{"lm_head.scale": torch.ones(3)}), device="cpu")
    partial = {k: v for k, v in ts.items() if k != "lm_head.scale"}
    with pytest.raises(ValueError, match="lm_head.kernel has no quant"):
        tgen._decode_model(tcfg, tq, quant_scales=partial, device="cpu")


def _jax_int8_logits(jcfg, jq, js, tokens):
    with jquant.quantized_inference():
        return np.asarray(_jax_model(jcfg).apply(
            jquant.maybe_quant_variables(_tree(jq), _tree(js)),
            jnp.asarray(tokens)))


def _port_logits(tcfg, params, tokens, scales=None):
    model = tgen._decode_model(tcfg, params, quant_scales=scales,
                               device="cpu")
    with torch.no_grad():
        out = model(torch.as_tensor(tokens).long())
    return (out[0] if isinstance(out, tuple) else out).numpy()


@pytest.mark.parametrize("name", CONFIGS)
def test_int8_forward_matches_jax(quantized, name):
    flat, jq, js = quantized[name]
    jcfg, tcfg = _configs(name)
    tokens = _prompt(2, 8, 7)
    qparams, scales = tquant.quantize_params(
        convert.params_from_flax(flat, tcfg))
    got = _port_logits(tcfg, qparams, tokens, scales)
    np.testing.assert_allclose(got, _jax_int8_logits(jcfg, jq, js, tokens),
                               rtol=TOL, atol=TOL)
    deq = _port_logits(tcfg, tquant.dequantize_params(qparams, scales),
                       tokens)
    np.testing.assert_allclose(got, deq, rtol=TOL, atol=TOL)
    assert not np.allclose(got, _port_logits(
        tcfg, convert.params_from_flax(flat, tcfg), tokens), atol=1e-6)


GENERATE = {
    "llama_tiny": ("llama_tiny", {}, 2, 7, 10),
    "llama_tiny_scan": ("llama_tiny_scan", {}, 2, 7, 10),
    "window8_ring": ("llama_tiny", dict(sliding_window=8, max_positions=64),
                     1, 5, 20),
    "moe_tiny": ("moe_tiny", {}, 2, 9, 12),
    "moe_tiny_shared": ("moe_tiny_shared", {}, 2, 9, 12),
    "qwen_moe_tiny": ("qwen_moe_tiny", {}, 2, 9, 12),
}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_int8_tokens_equal_jax(case):
    name, kw, b, s, new = GENERATE[case]
    jcfg, tcfg = _configs(name, **kw)
    params = _jax_model(jcfg).init(jax.random.PRNGKey(3),
                                   jnp.zeros((1, 8), jnp.int32))["params"]
    flat = _flat_np(params)
    jq, js = jquant.quantize_params(_tree(flat))
    prompt = _prompt(b, s, 4)
    want = np.asarray(jgen.generate(jcfg, jq, jnp.asarray(prompt), new,
                                    quant_scales=js))
    tq, ts = tquant.quantize_params(convert.params_from_flax(flat, tcfg))
    got = tgen.generate(tcfg, tq, prompt, new, quant_scales=ts,
                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    # JAX's scale tree carried across serves the same tokens.
    again = tgen.generate(tcfg, convert.params_from_flax(_flat_np(jq), tcfg),
                          prompt, new, device="cpu",
                          quant_scales=convert.scales_from_flax(
                              _flat_np(js), tcfg))
    assert torch.equal(again, got)


ENGINE = dict(slots=2, cache_len=48, chunk=2, prompt_buckets=(8, 16),
              kv_block_size=4)


def _requests(seed):
    rng = np.random.default_rng(seed)
    pre = [int(t) for t in rng.integers(1, 250, 8)]
    rand = lambda n: [int(t) for t in rng.integers(1, 250, n)]  # noqa: E731
    return [(pre + rand(2), 6), (rand(5), 5), (pre + rand(3), 4),
            (rand(11), 7)]


def _served(eng, reqs):
    ids = [eng.submit(p, m) for p, m in reqs]
    out = eng.run()
    return [list(out[i]) for i in ids]


@pytest.mark.parametrize("case", ["llama_plain", "llama_spec_int8_draft",
                                  "moe_tiny_dense"])
def test_engine_int8_tokens_equal_jax(case):
    """Greedy tokens of the int8 engine equal the JAX engine's; under
    speculation the target and the draft each carry their own scales."""
    name = "moe_tiny" if case.startswith("moe") else "llama_tiny"
    jcfg, tcfg = _configs(name)
    flat = _flat_np(_jax_model(jcfg).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))["params"])
    jq, js = jquant.quantize_params(_tree(flat))
    tq, ts = tquant.quantize_params(convert.params_from_flax(flat, tcfg))
    jkw, tkw = dict(ENGINE), dict(ENGINE)
    if case == "llama_spec_int8_draft":
        dj, dt = _configs("llama_tiny_scan")
        dflat = _flat_np(JaxLlama(dj).init(
            jax.random.PRNGKey(6), jnp.zeros((1, 8), jnp.int32))["params"])
        djq, djs = jquant.quantize_params(_tree(dflat))
        dtq, dts = tquant.quantize_params(
            convert.params_from_flax(dflat, dt))
        jkw.update(draft_config=dj, draft_params=djq, draft_quant_scales=djs,
                   speculative_k=3)
        tkw.update(draft_config=dt, draft_params=dtq, draft_quant_scales=dts,
                   speculative_k=3)
    reqs = _requests(2)
    jeng = JaxEngine(jcfg, jq, quant_scales=js, overlap=False,
                     prefill_budget=0, **jkw)
    teng = TorchEngine(tcfg, tq, quant_scales=ts, device="cpu", **tkw)
    want = _served(jeng, reqs)
    assert _served(teng, reqs) == want
    if "spec" in case:
        assert teng.spec_stats == {k: jeng.spec_stats[k]
                                   for k in teng.spec_stats}
        with pytest.raises(ValueError, match="draft_quant_scales needs"):
            TorchEngine(tcfg, tq, quant_scales=ts, draft_quant_scales=dts,
                        device="cpu", **ENGINE)
        with pytest.raises(ValueError, match="passed together"):
            TorchEngine(tcfg, tq, quant_scales=ts, device="cpu",
                        **dict(tkw, draft_quant_scales=None))
    else:
        for p, s in ((tq, None), (convert.params_from_flax(flat, tcfg), ts)):
            with pytest.raises(ValueError, match="passed together"):
                TorchEngine(tcfg, p, quant_scales=s, device="cpu", **ENGINE)


def test_gmm_dispatch_refuses_int8_with_jaxs_message():
    jcfg, tcfg = _configs("moe_tiny", dispatch="gmm")
    flat = _flat_np(JM.MoeLmModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    jq, js = jquant.quantize_params(_tree(flat))
    prompt = _prompt(1, 5)
    with pytest.raises(NotImplementedError) as je:
        jgen.generate(jcfg, jq, jnp.asarray(prompt), 3, quant_scales=js)
    tq, ts = tquant.quantize_params(convert.params_from_flax(flat, tcfg))
    with pytest.raises(NotImplementedError) as te:
        tgen.generate(tcfg, tq, prompt, 3, quant_scales=ts, device="cpu")
    assert str(te.value) == str(je.value)
