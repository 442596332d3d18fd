"""The port's speculative decoding against the JAX package on the CPU.

- The shared rules (``models/speculative.py``): ``accept_block`` equal to
  JAX's on the same seeded inputs; ``sampled_accept``'s accepted and
  emitted counts equal, its residual distribution within 1e-6 of JAX's
  formula, its draw held to that distribution by chi-square (the port
  draws by Gumbel-max from its own streams, JAX by threefry);
  ``DepthController`` equal to JAX's over the same observe streams.
- The sampling streams (``serving.stream_uniforms``): equal to a Python
  integer transcription of the hash, independent of the row a stream
  sits in, and uniform.
- The engine, greedy: the target is ``llama_tiny``, the draft either the
  target itself (full acceptance) or ``llama_tiny_scan`` from
  ``PRNGKey(99)`` (near-zero acceptance), at k 3 and with the adaptive
  depths (0, 2, 4), with and without an int8 KV cache.  Tokens equal the
  JAX speculative engine's and the JAX plain engine's; ``spec_stats`` and
  the controller's telemetry equal JAX's field by field (both engines
  synchronous with atomic admission, where the depth of every round is
  decided after the previous one is observed); the port's default,
  pipelined engine gives the same tokens.  Each workload has a radix
  hit, so the draft's pool is read by the paged KV gather too.
- The engine, sampled: a self draft accepts every draft and replays bit
  for bit; its tokens do not depend on slot placement; a disagreeing
  draft's output law equals plain sampled serving's by a per-position
  chi-square test (alpha 1e-3), whose power the test shows in place
  (an accept-everything rule is rejected at p < 1e-6 on the same seeds).

``serve.py``'s speculative flags are tested in
``tests/test_torch_serving_overlap.py`` with its pipelining flags.
"""

import dataclasses
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from scipy import stats

from tensorflow_train_distributed_tpu.models import speculative as jspec
from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JAX_PRESETS,
    LlamaModel as JaxLlama,
)
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch import serving as tserving
from tensorflow_train_distributed_torch.models import speculative as tspec
from tensorflow_train_distributed_torch.models.llama import (
    LLAMA_PRESETS as TORCH_PRESETS,
)
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)

ENGINE = dict(slots=2, cache_len=64, chunk=2, prompt_buckets=(8, 16),
              kv_block_size=4)
SYNC = dict(overlap=False, prefill_budget=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these many small ops: under the suite's
    parallel workers a thread pool a worker oversubscribes the cores and
    slows each op tens of times; the results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for switch in ("TTD_NO_OVERLAP", "TTD_NO_INTERLEAVE",
                   "TTD_NO_ADAPTIVE_SPEC"):
        monkeypatch.delenv(switch, raising=False)


# -- the shared rules --------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 3, 5])
def test_accept_block_equals_jax(k):
    rng = np.random.default_rng(k)
    b, v = 64, 6
    preds = rng.integers(0, v, (b, k + 1))
    # Drafts agree with the target on a random leading run per row.
    d_block = np.where(np.arange(k)[None, :] < rng.integers(0, k + 1, (b, 1)),
                       preds[:, :k], rng.integers(0, v, (b, k)))
    want = jspec.accept_block(jnp.asarray(d_block, jnp.int32),
                              jnp.asarray(preds, jnp.int32))
    got = tspec.accept_block(torch.from_numpy(d_block),
                             torch.from_numpy(preds))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _dists(rng, shape, v):
    logits = 2.0 * rng.standard_normal((*shape, v)).astype(np.float32)
    logits[..., :2] = -np.inf                 # filtered entries
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _jax_residual(p, q, a):
    """JAX ``sampled_accept``'s residual (its lines, in jnp)."""
    q_pad = jnp.concatenate([q, jnp.zeros_like(p[:, :1])], axis=1)
    p_at = jnp.take_along_axis(p, a[:, None, None], axis=1)[:, 0]
    q_at = jnp.take_along_axis(q_pad, a[:, None, None], axis=1)[:, 0]
    res = jnp.clip(p_at - q_at, 0.0)
    tot = res.sum(-1, keepdims=True)
    return jnp.where(tot > 0, res / jnp.where(tot > 0, tot, 1.0), p_at)


@pytest.mark.parametrize("k", [0, 3])
def test_sampled_accept_counts_and_residual_equal_jax(k):
    rng = np.random.default_rng(10 + k)
    b, v = 32, 12
    q = _dists(rng, (b, k), v)
    p = _dists(rng, (b, k + 1), v)
    d_block = np.stack([[rng.choice(v, p=q[i, j]) for j in range(k)]
                        for i in range(b)]).reshape(b, k)
    us = rng.random((b, k)).astype(np.float32)
    jout = jspec.sampled_accept(
        jnp.asarray(d_block, jnp.int32), jnp.asarray(q), jnp.asarray(p),
        jnp.asarray(us), jax.random.split(jax.random.PRNGKey(0), b))
    tout = tspec.sampled_accept(
        torch.from_numpy(d_block), torch.from_numpy(q), torch.from_numpy(p),
        torch.from_numpy(us), torch.rand(b, v, dtype=torch.float64))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    a = tout[2]
    emit, final = tout[0].numpy(), tout[3].numpy()
    for i in range(b):
        np.testing.assert_array_equal(emit[i, :a[i]], d_block[i, :a[i]])
        assert emit[i, a[i]] == final[i] and not emit[i, a[i] + 1:].any()
    np.testing.assert_allclose(
        tspec.residual(torch.from_numpy(p), torch.from_numpy(q), a).numpy(),
        np.asarray(_jax_residual(jnp.asarray(p), jnp.asarray(q),
                                 jnp.asarray(a.numpy()))), atol=1e-6)


def test_sampled_accept_draw_follows_the_residual_as_jaxs_does():
    """One rejected row repeated n times: the port's draws (Gumbel-max on
    stream uniforms) and JAX's (threefry keys) both fit the residual
    distribution by chi-square."""
    rng = np.random.default_rng(3)
    v, n = 10, 6000
    q = _dists(rng, (1, 2), v)
    p = _dists(rng, (1, 3), v)
    d = np.array([[int(np.argmax(q[0, 0] - p[0, 0])), 0]])  # p/q small
    us = np.ones((1, 2), np.float32)                # rejects d_0 surely
    rep = lambda x: np.repeat(x, n, 0)                       # noqa: E731
    jfinal = np.asarray(jspec.sampled_accept(
        jnp.asarray(rep(d), jnp.int32), jnp.asarray(rep(q)),
        jnp.asarray(rep(p)), jnp.asarray(rep(us)),
        jax.random.split(jax.random.PRNGKey(1), n))[3])
    seeds = torch.arange(n)
    tout = tspec.sampled_accept(
        torch.from_numpy(rep(d)), torch.from_numpy(rep(q)),
        torch.from_numpy(rep(p)), torch.from_numpy(rep(us)),
        tserving.stream_uniforms(seeds, torch.zeros(n, dtype=torch.long),
                                 4, v))
    assert (tout[2] == 0).all()
    res = tspec.residual(torch.from_numpy(p), torch.from_numpy(q),
                         torch.zeros(1, dtype=torch.long))[0].double().numpy()
    support = np.flatnonzero(res > 0)
    for draws in (jfinal, tout[3].numpy()):
        assert set(np.unique(draws)) <= set(support)
        observed = np.array([(draws == s).sum() for s in support])
        _, pval = stats.chisquare(observed, n * res[support] / res.sum())
        assert pval > 1e-3, (observed, res)


def _feed(ctrl, rounds, rate):
    for _ in range(rounds):
        drafted = ctrl.depth() * 2
        ctrl.observe(drafted, int(drafted * rate))


def test_depth_controller_ramp_and_collapse():
    ctrl = tspec.DepthController((0, 2, 4, 8), start=2)
    _feed(ctrl, 20, 1.0)
    assert ctrl.depth() == 8 and ctrl.switches == 2
    ctrl = tspec.DepthController((0, 2, 4, 8))
    depths = []
    for _ in range(60):
        depths.append(ctrl.depth())
        ctrl.observe(ctrl.depth() * 2, 0)
    ladder = (0, 2, 4, 8)
    assert depths[0] == 8
    assert all(abs(ladder.index(b) - ladder.index(a)) <= 1
               for a, b in zip(depths, depths[1:]))
    assert ctrl.depth() == 0
    probes = [d for d in depths[20:] if d != 0]
    assert probes and set(probes) == {2}


def test_depth_controller_hysteresis_probe_and_telemetry():
    ctrl = tspec.DepthController((0, 2, 4, 8), start=4)
    for i in range(100):
        _feed(ctrl, 1, 1.0 if i % 2 == 0 else 0.0)
    assert ctrl.depth() == 4 and ctrl.switches <= 4
    ctrl = tspec.DepthController((0, 2, 4, 8))
    _feed(ctrl, 40, 0.0)
    assert ctrl.depth() == 0
    _feed(ctrl, 30, 1.0)
    assert ctrl.depth() == 8
    ctrl = tspec.DepthController((0, 4), start=4)
    _feed(ctrl, 10, 1.0)
    t = ctrl.telemetry()
    assert t["depth"] == 4 and t["rounds"] == 10
    assert t["per_depth"][4]["rounds"] == 10
    assert t["per_depth"][0]["rounds"] == 0


@pytest.mark.parametrize("depths,match", [
    ((4,), "buckets"), ((-1, 4), "non-negative"), ((0, 0), "buckets")])
def test_depth_controller_validation(depths, match):
    with pytest.raises(ValueError, match=match):
        tspec.DepthController(depths)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_depth_controller_equals_jax_over_a_random_stream(seed):
    """The depth sequence, the switches and the telemetry are those of
    JAX's controller fed the same observations (wall times included:
    telemetry only)."""
    rng = np.random.default_rng(seed)
    kw = dict(start=None if seed == 0 else 2, dwell=2 + seed)
    jc = jspec.DepthController((0, 2, 4, 8), **kw)
    tc = tspec.DepthController((0, 2, 4, 8), **kw)
    phase = rng.random(400) < np.repeat(rng.random(8), 50)
    for i in range(400):
        assert tc.depth() == jc.depth()
        drafted = tc.depth() * int(rng.integers(1, 9))
        accepted = int(drafted * (rng.random() * 0.4 + 0.6 * phase[i]))
        wall = float(rng.random())
        jc.observe(drafted, accepted, wall)
        tc.observe(drafted, accepted, wall)
    assert tc.switches == jc.switches and tc.switches > 3
    assert tc.telemetry() == jc.telemetry()


# -- the sampling streams ----------------------------------------------------


def _host_uniform(seed, count, draw, col):
    """The hash of ``stream_uniforms`` in Python integers."""
    m = (1 << 64) - 1

    def mix(z):
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
        return z ^ (z >> 31)

    g = 0x9E3779B97F4A7C15
    key = mix((seed * g + count + 1) & m)
    key = mix((key + (draw + 1) * g) & m)
    z = mix((key + (col + 1) * g) & m)
    return ((z >> 12) + 0.5) * 2.0 ** -52


def test_stream_uniforms_equal_the_integer_hash():
    seeds = torch.tensor([0, 1, 2 ** 32 - 1, 77])
    counts = torch.tensor([0, 5, 3, 1000])
    for draw in (tserving.PICK_DRAW, 0, 3, 6):
        got = tserving.stream_uniforms(seeds, counts, draw, 5).numpy()
        want = [[_host_uniform(int(s), int(c), draw, j) for j in range(5)]
                for s, c in zip(seeds, counts)]
        np.testing.assert_array_equal(got, np.array(want))


def test_stream_uniforms_independent_of_row_and_uniform():
    seeds = torch.arange(4000)
    counts = torch.arange(4000) % 7
    u = tserving.stream_uniforms(seeds, counts, 2, 16)
    assert ((u > 0) & (u < 1)).all()
    # A stream's values do not depend on the row it sits in.
    perm = torch.randperm(4000, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        tserving.stream_uniforms(seeds[perm], counts[perm], 2, 16), u[perm],
        rtol=0, atol=0)
    flat = u.flatten().numpy()
    assert stats.kstest(flat, "uniform").pvalue > 1e-3
    # Neighbouring draws, counts and columns are uncorrelated.
    other = tserving.stream_uniforms(seeds, counts + 1, 2, 16)
    for x, y in ((u[:, 0], u[:, 1]), (u[:, 0], other[:, 0]),
                 (u[:, 0], tserving.stream_uniforms(seeds, counts, 3,
                                                    1)[:, 0])):
        assert abs(np.corrcoef(x.numpy(), y.numpy())[0, 1]) < 0.06


# -- the engine, greedy --------------------------------------------------------


def _flat(name, key):
    params = JaxLlama(JAX_PRESETS[name]).init(
        key, jnp.zeros((1, 8), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


@pytest.fixture(scope="module")
def weights():
    return (_flat("llama_tiny", jax.random.PRNGKey(0)),
            _flat("llama_tiny_scan", jax.random.PRNGKey(99)))


def _jax_tree(flat):
    return jax.tree.map(jnp.asarray, traverse_util.unflatten_dict(flat,
                                                                  sep="/"))


def _requests(seed=0):
    """Five requests over two slots; #0 and #2 share an 8-token (two
    block) prefix, #4 resolves at prefill (max_new 1)."""
    rng = np.random.default_rng(seed)
    pre = [int(t) for t in rng.integers(1, 250, 8)]
    rand = lambda n: [int(t) for t in rng.integers(1, 250, n)]  # noqa: E731
    return [(pre + rand(1), 6), (rand(5), 9), (pre + rand(2), 7),
            (rand(12), 8), (rand(3), 1)]


def _run(engine, reqs):
    ids = [engine.submit(p, m) for p, m in reqs]
    out = engine.run()
    return [list(out[i]) for i in ids]


def _configs(kv_int8, draft):
    names = ("llama_tiny", "llama_tiny" if draft == "self"
             else "llama_tiny_scan")
    out = []
    for presets in (JAX_PRESETS, TORCH_PRESETS):
        cfgs = [presets[n] for n in names]
        if kv_int8:
            cfgs = [dataclasses.replace(c, kv_cache_int8=True) for c in cfgs]
        out.append(cfgs)
    return out


@pytest.fixture(scope="module")
def jax_plain(weights):
    out = {}
    for kv_int8 in (False, True):
        (jcfg, _), _ = _configs(kv_int8, "self")
        out[kv_int8] = _run(JaxEngine(jcfg, _jax_tree(weights[0]), **SYNC,
                                      **ENGINE), _requests())
    return out


SPEC_CASES = {
    "self_k3": ("self", False, dict(speculative_k=3)),
    "disagreeing_k3": ("scan", False, dict(speculative_k=3)),
    "disagreeing_adaptive": ("scan", False,
                             dict(speculative_k=4, spec_depths=(0, 2, 4))),
    "self_adaptive_int8": ("self", True,
                           dict(speculative_k=4, spec_depths=(0, 2, 4))),
}


@pytest.fixture(scope="module")
def spec_runs(weights):
    """Per case: (JAX tokens, JAX engine, port tokens and engine
    synchronous, port tokens and engine pipelined, draft pools the
    gather read)."""
    runs = {}
    for name, (draft, kv_int8, kw) in SPEC_CASES.items():
        (jcfg, jdcfg), (tcfg, tdcfg) = _configs(kv_int8, draft)
        dflat = weights[0] if draft == "self" else weights[1]
        jeng = JaxEngine(jcfg, _jax_tree(weights[0]), draft_config=jdcfg,
                         draft_params=_jax_tree(dflat), **SYNC, **ENGINE,
                         **kw)
        jtoks = _run(jeng, _requests())
        tk = dict(draft_config=tdcfg,
                  draft_params=convert.params_from_flax(dflat, tdcfg),
                  device="cpu", **ENGINE, **kw)
        target = convert.params_from_flax(weights[0], tcfg)
        gathered = []
        orig = K.paged_kv_gather

        def spy(pool, *a, **k):
            gathered.append(pool)
            return orig(pool, *a, **k)

        K.paged_kv_gather = spy
        try:
            sync = TorchEngine(tcfg, target, **SYNC, **tk)
            sync_toks = _run(sync, _requests())
        finally:
            K.paged_kv_gather = orig
        piped = TorchEngine(tcfg, target, **tk)
        runs[name] = (jtoks, jeng, sync_toks, sync, _run(piped, _requests()),
                      piped, gathered)
    return runs


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_tokens_equal_jax_spec_and_plain_engines(case, spec_runs,
                                                      jax_plain):
    jtoks, _, sync_toks, sync, piped_toks, piped, _ = spec_runs[case]
    assert sync_toks == jtoks
    assert piped_toks == jtoks
    assert jtoks == jax_plain[SPEC_CASES[case][1]]
    assert [len(t) for t in jtoks] == [len(p) + m for p, m in _requests()]
    assert piped.overlap and piped.interleave
    assert piped.overlap_stats["overlapped_harvests"] > 0


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_stats_and_telemetry_equal_jax(case, spec_runs):
    _, jeng, _, sync, _, piped, _ = spec_runs[case]
    assert sync.spec_stats == jeng.spec_stats
    assert sync.spec_telemetry() == jeng.spec_telemetry()
    assert sync.kv_stats == jeng.kv_stats
    assert sync.kv_blocks_in_use() == jeng.kv_blocks_in_use()
    s = sync.spec_stats
    assert s["emitted"] == sum(m - 1 for _, m in _requests())
    if case.startswith("self"):
        assert s["drafted_accepted"] == s["drafted"] > 0
    else:
        assert s["drafted_accepted"] < s["drafted"] // 4
    assert piped.spec_stats["emitted"] == s["emitted"]
    if "adaptive" in case:
        telemetry = sync.spec_telemetry()
        assert telemetry["rounds"] == s["rounds"]
        used = {d for d, v in telemetry["per_depth"].items() if v["rounds"]}
        # Full acceptance holds the deepest depth; none backs off to 0.
        assert used == ({4} if case.startswith("self") else {0, 2, 4})


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_radix_hit_reads_the_draft_pool(case, spec_runs):
    *_, sync, _, _, gathered = spec_runs[case]
    assert sync.kv_stats["prefix_hits"] >= 1
    draft_pools = {id(leaf) for layer in sync._d_cache.layers
                   for leaf in layer.values()}
    target_pools = {id(leaf) for layer in sync._cache.layers
                    for leaf in layer.values()}
    ids = {id(p) for p in gathered}
    assert ids & draft_pools and ids & target_pools
    assert sync._d_cache.block_table is sync._cache.block_table
    sync._radix.check_invariants()


def test_depth_zero_reproduces_plain_decode(weights):
    """A forced depth-0 round is a plain decode step: tokens equal."""
    (_, _), (tcfg, _) = _configs(False, "scan")
    target = convert.params_from_flax(weights[0], tcfg)
    draft = convert.params_from_flax(weights[1],
                                     TORCH_PRESETS["llama_tiny_scan"])
    plain = _run(TorchEngine(tcfg, target, device="cpu", **ENGINE),
                 _requests(1))
    eng = TorchEngine(tcfg, target, device="cpu",
                      draft_config=TORCH_PRESETS["llama_tiny_scan"],
                      draft_params=draft, speculative_k=2,
                      spec_depths=(0, 2), **ENGINE)
    eng._spec_ctrl = tspec.DepthController((0, 2), start=0, probe_every=10 ** 6)
    assert _run(eng, _requests(1)) == plain
    assert eng.spec_stats["drafted"] == 0
    assert eng.spec_stats["rounds"] == eng.spec_telemetry()["rounds"] > 0


def test_adaptive_kill_switch_pins_the_fixed_depth(weights, monkeypatch):
    (_, _), (tcfg, tdcfg) = _configs(False, "scan")
    kw = dict(draft_config=tdcfg,
              draft_params=convert.params_from_flax(weights[1], tdcfg),
              device="cpu", **ENGINE)
    target = convert.params_from_flax(weights[0], tcfg)
    fixed = TorchEngine(tcfg, target, speculative_k=3, **kw)
    want = _run(fixed, _requests())
    monkeypatch.setenv("TTD_NO_ADAPTIVE_SPEC", "1")
    pinned = TorchEngine(tcfg, target, speculative_k=3,
                         spec_depths=(0, 2, 3), **kw)
    assert pinned.spec_telemetry() == {}
    assert _run(pinned, _requests()) == want
    assert pinned.spec_stats == fixed.spec_stats


def test_constructor_refusals(weights):
    tcfg = TORCH_PRESETS["llama_tiny"]
    p = convert.params_from_flax(weights[0], tcfg)
    base = dict(device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="come together"):
        TorchEngine(tcfg, p, draft_config=tcfg, **base)
    with pytest.raises(ValueError, match="speculative_k needs"):
        TorchEngine(tcfg, p, speculative_k=3, **base)
    with pytest.raises(ValueError, match="speculative_k >= 1"):
        TorchEngine(tcfg, p, draft_config=tcfg, draft_params=p, **base)
    with pytest.raises(ValueError, match="spec_depths needs"):
        TorchEngine(tcfg, p, spec_depths=(0, 2), **base)
    with pytest.raises(ValueError, match="vocab"):
        TorchEngine(tcfg, p, draft_config=dataclasses.replace(
            tcfg, vocab_size=128), draft_params=p, speculative_k=2, **base)
    with pytest.raises(ValueError, match="sliding_window"):
        TorchEngine(tcfg, p, draft_config=dataclasses.replace(
            tcfg, sliding_window=8), draft_params=p, speculative_k=2, **base)
    with pytest.raises(ValueError, match="attention_sinks"):
        TorchEngine(tcfg, p, draft_config=dataclasses.replace(
            tcfg, attention_sinks=2), draft_params=p, speculative_k=2,
            **base)
    lora = dict(p, **{"layers_0/attention/query/lora_a":
                      torch.zeros(64, 2)})
    with pytest.raises(ValueError, match="LoRA"):
        TorchEngine(tcfg, p, draft_config=tcfg, draft_params=lora,
                    speculative_k=2, **base)
    with pytest.raises(ValueError, match="buckets"):
        TorchEngine(tcfg, p, draft_config=tcfg, draft_params=p,
                    speculative_k=2, spec_depths=(3,), **base)


# -- the engine, sampled -------------------------------------------------------

SAMPLED = dict(temperature=1.0, top_k=8)


def test_sampled_self_draft_accepts_all_and_replays(weights):
    tcfg = TORCH_PRESETS["llama_tiny"]
    p = convert.params_from_flax(weights[0], tcfg)
    reqs = _requests(22)

    def serve(**kw):
        eng = TorchEngine(tcfg, p, draft_config=tcfg, draft_params=p,
                          speculative_k=3, device="cpu", **SAMPLED,
                          **ENGINE, **kw)
        return _run(eng, reqs), dict(eng.spec_stats)

    (a, sa), (b, sb), (c, sc) = serve(), serve(), serve(**SYNC)
    assert a == b == c and sa == sb
    # p == q: every draft survives u < p/q = 1 (up to the rounding of a
    # stepped against a batched matmul, which the small hedge covers).
    assert sa["drafted_accepted"] >= sa["drafted"] - 3
    assert sa["emitted"] == sum(m - 1 for _, m in reqs)


def test_sampled_spec_independent_of_slot_placement(weights):
    (_, _), (tcfg, tdcfg) = _configs(False, "scan")
    p = convert.params_from_flax(weights[0], tcfg)
    d = convert.params_from_flax(weights[1], tdcfg)
    reqs = _requests(2)

    def serve(order, slots, **kw):
        eng = TorchEngine(tcfg, p, draft_config=tdcfg, draft_params=d,
                          speculative_k=3, device="cpu", top_p=0.9,
                          temperature=1.0, **dict(ENGINE, slots=slots), **kw)
        ids = {i: eng.submit(reqs[i][0], reqs[i][1], seed=100 + i)
               for i in order}
        out = eng.run()
        return [out[ids[i]] for i in range(len(reqs))]

    a = serve(range(len(reqs)), 2)
    assert a == serve(reversed(range(len(reqs))), 3)
    assert a == serve(range(len(reqs)), 1, **SYNC)


def test_sampled_spec_follows_plain_sampled_law(weights, monkeypatch):
    """Per-position chi-square homogeneity of 768 plain and 768
    speculative streams (disjoint seeds) at near-zero acceptance: the
    null survives at 1e-3 at every position; an accept-everything rule
    on the same seeds is rejected at p < 1e-6."""
    (_, _), (tcfg, tdcfg) = _configs(False, "scan")
    p = convert.params_from_flax(weights[0], tcfg)
    d = convert.params_from_flax(weights[1], tdcfg)
    prompt, max_new, n = [5, 1], 4, 768

    def counts(spec, seed_base):
        kw = (dict(draft_config=tdcfg, draft_params=d, speculative_k=3)
              if spec else {})
        eng = TorchEngine(tcfg, p, slots=32, cache_len=16, chunk=4,
                          prompt_buckets=(4,), kv_block_size=4,
                          temperature=1.0, top_k=4, device="cpu", **kw)
        ids = [eng.submit(prompt, max_new, seed=s + seed_base)
               for s in range(n)]
        out = eng.run()
        c = np.zeros((max_new, tcfg.vocab_size))
        for i in ids:
            for t, tok in enumerate(out[i][len(prompt):]):
                c[t, tok] += 1
        return c, eng.spec_stats

    def pvalue(c1, c2, t):
        col = c1[t] + c2[t]
        keep = col >= 10
        rows = [np.concatenate([c[t][keep], [c[t][~keep].sum()]])
                for c in (c1, c2)]
        if rows[0][-1] + rows[1][-1] == 0:
            rows = [r[:-1] for r in rows]
        return stats.chi2_contingency(np.stack(rows))[1]

    plain, _ = counts(False, 0)
    spec, st = counts(True, 100_000)
    assert st["rounds"] >= 1 and st["drafted_accepted"] < st["drafted"] / 4
    for t in range(max_new):
        assert pvalue(plain, spec, t) > 1e-3, t

    def accept_all(d_block, q, pp, us, final_u):
        b, k = d_block.shape
        a = torch.full((b,), k, dtype=torch.long)
        final = tspec.gumbel_argmax(torch.log(pp[:, k] + 1e-38), final_u)
        return tspec._assemble_emit(d_block, a, final), a + 1, a, final

    monkeypatch.setattr(tspec, "sampled_accept", accept_all)
    wrong, _ = counts(True, 100_000)
    assert min(pvalue(plain, wrong, t) for t in range(1, max_new)) < 1e-6
