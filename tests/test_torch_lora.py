"""The port's LoRA fine-tuning against the JAX package's ``models/lora.py``,
on the CPU (the counterpart of ``tests/test_lora.py``).

Tolerances, each at f32:

- logits of the adapted model against JAX's under ``lora_scope``: 1e-5
  relative and absolute, as ``tests/test_torch_training.py``'s forward;
  step 0 against the base model: bitwise;
- merged against unmerged logits: 1e-5 (+ 1e-5 absolute: the folded
  kernel rounds ``W + s·A·B`` once, the unmerged path adds two products);
- 10 ``Trainer`` steps of ``llama_tiny_sft`` at rank 4 against the JAX
  LoRA ``Trainer`` (``freeze_base`` around clip and adamw, weights and
  adapters carried across by ``convert.py``): the loss curve max |delta|
  <= 1e-4, the curve tolerance of ``tests/test_torch_training.py``; the
  adapters after them rtol 1e-3, atol 1e-5 (that file's final-params
  tolerance);
- ``grad_norm``: the port's is the adapters' global norm (what the clip
  reads); JAX's logged norm also counts the embeddings, norms and
  untargeted kernels, whose gradients it computes and then masks.  The
  test pins both: the port's equals the norm of JAX's adapter gradients
  (rtol 1e-4) and is smaller than JAX's logged one;
- served tokens: equal.
"""

import dataclasses
import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.data import DataConfig, HostDataLoader
from tensorflow_train_distributed_tpu.data.datasets import (
    SyntheticLM as JaxSyntheticLM,
)
from tensorflow_train_distributed_tpu.models import llama as JLL
from tensorflow_train_distributed_tpu.models import lora as JLO
from tensorflow_train_distributed_tpu.runtime.mesh import (
    MeshConfig,
    build_mesh,
)
from tensorflow_train_distributed_tpu.serving import (
    ServingEngine as JaxEngine,
)
from tensorflow_train_distributed_tpu.training import mixed_precision as jmp
from tensorflow_train_distributed_tpu.training.callbacks import History
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch import launch as tlaunch
from tensorflow_train_distributed_torch import serve as tserve
from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
from tensorflow_train_distributed_torch.data.pipeline import HostBatches
from tensorflow_train_distributed_torch.models import llama as TLL
from tensorflow_train_distributed_torch.models import lora as TLO
from tensorflow_train_distributed_torch.serving import (
    ServingEngine as TorchEngine,
)
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, STEPS = 16, 16, 10


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


def _cfgs(targets=("query", "value"), rank=4, alpha=16.0):
    jspec = JLO.LoraSpec(rank=rank, alpha=alpha, targets=targets)
    tspec = TLO.LoraSpec(rank=rank, alpha=alpha, targets=targets)
    return (dataclasses.replace(JLL.LLAMA_PRESETS["llama_tiny"], lora=jspec),
            dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"], lora=tspec))


def _tokens(vocab=256, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _jax_params(jcfg, seed=0, b_scale=0.0):
    """JAX's init under the LoRA scope; ``b_scale`` > 0 fills ``lora_b``
    with normal noise so the delta is not zero."""
    params = JLL.CausalLmTask(jcfg).init_variables(
        jax.random.PRNGKey(seed), {"tokens": jnp.zeros((1, 8), jnp.int32)}
    )["params"]
    flat = _flat(params)
    if b_scale:
        rng = np.random.default_rng(seed + 1)
        flat = {k: (rng.standard_normal(v.shape).astype(np.float32)
                    * b_scale if k.endswith("lora_b") else v)
                for k, v in flat.items()}
    return flat


def _jax_logits(jcfg, flat, tokens):
    params = traverse_util.unflatten_dict(flat, sep="/")
    with JLO.lora_scope(jcfg.lora):
        return np.asarray(JLL.LlamaModel(jcfg).apply({"params": params},
                                                     jnp.asarray(tokens)))


def _port(tcfg, flat):
    model = TLL.LlamaModel(tcfg, device="meta")
    model.load_state_dict(convert.params_from_flax(flat, tcfg), strict=True,
                          assign=True)
    return model


def _to_flax(params: dict) -> dict:
    """The port's names back to the unrolled flax names."""
    out = {}
    for name, v in params.items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        out["/".join(parts)] = v.detach().cpu().numpy()
    return out


# -- structure ----------------------------------------------------------------


@pytest.mark.parametrize("targets", [("query", "value"),
                                     ("key", "out", "wi_gate", "wi_up",
                                      "wo", "lm_head")])
def test_adapters_at_targets_only_with_jax_names_and_shapes(targets):
    jcfg, tcfg = _cfgs(targets)
    jflat = _jax_params(jcfg)
    model = TLL.LlamaModel(tcfg, device="meta")
    names = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in convert.params_from_flax(
        jflat, tcfg).items()}
    assert names == want
    adapters = {k for k in names if TLO.is_lora_param(k)}
    assert adapters and {k.split(".")[-2] for k in adapters} == set(targets)
    assert len(adapters) == 2 * (len([t for t in targets if t != "lm_head"])
                                 * tcfg.num_layers + ("lm_head" in targets))
    for name, p in model.named_parameters():
        assert p.requires_grad == TLO.is_lora_param(name), name
        if name.endswith("lora_a"):
            assert p.dtype == torch.float32
    n_lora, n_total = TLO.count_lora_params(dict(model.named_parameters()))
    assert (n_lora, n_total) == JLO.count_lora_params(
        traverse_util.unflatten_dict(jflat, sep="/"))
    assert TLO.lora_labels(dict(model.named_parameters())) == {
        n: ("lora" if p.requires_grad else "frozen")
        for n, p in model.named_parameters()}


def test_logits_match_jax_and_step0_is_the_base_model():
    jcfg, tcfg = _cfgs()
    tokens = _tokens()
    flat = _jax_params(jcfg)
    with torch.no_grad():
        got = _port(tcfg, flat)(torch.from_numpy(tokens)).numpy()
        base_flat = {k: v for k, v in flat.items() if not JLO.is_lora_param(
            tuple(k.split("/")))}
        base = _port(TLL.LLAMA_PRESETS["llama_tiny"], base_flat)(
            torch.from_numpy(tokens)).numpy()
    np.testing.assert_array_equal(got, base)
    noisy = _jax_params(jcfg, b_scale=0.05)
    want = _jax_logits(jcfg, noisy, tokens)
    with torch.no_grad():
        got = _port(tcfg, noisy)(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(got, base, atol=1e-3)


def test_merged_logits_equal_unmerged_and_merge_matches_jax():
    jcfg, tcfg = _cfgs(("query", "value", "wo"))
    tokens = _tokens(seed=1)
    noisy = _jax_params(jcfg, b_scale=0.05)
    model = _port(tcfg, noisy)
    params = dict(model.named_parameters())
    merged = TLO.merge_lora(params, tcfg.lora)
    assert not TLO.has_lora_leaves(merged)
    base_cfg = TLL.LLAMA_PRESETS["llama_tiny"]
    with torch.no_grad():
        unmerged = model(torch.from_numpy(tokens)).numpy()
        plain = TLL.LlamaModel(base_cfg, device="meta")
        plain.load_state_dict(merged, strict=True, assign=True)
        got = plain(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, unmerged, rtol=1e-5, atol=1e-5)
    jmerged = _flat(JLO.merge_lora(traverse_util.unflatten_dict(
        noisy, sep="/"), jcfg.lora))
    want = convert.params_from_flax(jmerged, base_cfg)
    assert merged.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(merged[k].detach().numpy(),
                                   want[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    with pytest.raises(ValueError, match="no \\(lora_a, lora_b\\) pairs"):
        TLO.merge_lora(merged, tcfg.lora)


def test_refusals():
    with pytest.raises(ValueError, match="unknown LoRA target"):
        TLO.validate_targets(["query", "qkv"])
    assert TLO.validate_targets([" query", "value ", ""]) == ("query",
                                                             "value")
    with pytest.raises(ValueError, match="alpha must be > 0"):
        TLO.LoraSpec(alpha=0.0)
    with pytest.raises(ValueError, match="rank must be >= 1"):
        TLO.LoraSpec(rank=0)
    with pytest.raises(ValueError, match="fused_qkv"):
        dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"], fused_qkv=True,
                            lora=TLO.LoraSpec())
    # fused_qkv with MLP targets only is allowed.
    cfg = dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"],
                              fused_qkv=True,
                              lora=TLO.LoraSpec(targets=("wo",)))
    TLL.LlamaModel(cfg, device="meta")
    with pytest.raises(ValueError, match="matched no module"):
        TLO.apply_lora(torch.nn.Linear(2, 2), TLO.LoraSpec())


def test_sidecar_round_trips_and_spec_checks(tmp_path):
    spec = TLO.LoraSpec(rank=2, alpha=8.0, targets=("query", "wo"))
    path = TLO.save_spec(str(tmp_path), spec)
    assert json.loads(open(path).read()) == {"rank": 2, "alpha": 8.0,
                                             "targets": ["query", "wo"]}
    assert TLO.load_spec(str(tmp_path)) == spec
    # The JAX package reads the port's sidecar, and the port JAX's.
    assert JLO.load_spec(str(tmp_path)) == JLO.LoraSpec(
        rank=2, alpha=8.0, targets=("query", "wo"))
    assert TLO.load_spec(str(tmp_path / "none")) is None
    cfg = dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"], lora=spec)
    params = dict(TLL.LlamaModel(cfg, device="meta").named_parameters())
    TLO.check_spec_matches(params, spec)
    with pytest.raises(ValueError, match="adapters on"):
        TLO.check_spec_matches(params, TLO.LoraSpec(rank=2))
    with pytest.raises(ValueError, match="rank"):
        TLO.check_spec_matches(params, dataclasses.replace(spec, rank=4))
    with pytest.raises(ValueError, match="no LoRA adapters"):
        TLO.check_spec_matches({"a.kernel": torch.zeros(1)}, spec)


def test_engine_refuses_an_unmerged_tree():
    _, tcfg = _cfgs()
    params = convert.init_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="merge LoRA adapters"):
        TorchEngine(TLL.LLAMA_PRESETS["llama_tiny"], params, device="cpu",
                    slots=1, cache_len=32, prompt_buckets=(8,))


# -- training against the JAX trainer -----------------------------------------


@pytest.fixture(scope="module")
def curves():
    """Both LoRA trainers for STEPS steps from the JAX init (adapters
    included) on the same batches: constant lr 1e-2, adamw with decay
    0.01, clip 1.0, all under ``freeze_base``."""
    jcfg, tcfg = _cfgs()
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    hist = History()
    jtx = JLO.freeze_base(optax.chain(optax.clip_by_global_norm(1.0),
                                      optax.adamw(1e-2, weight_decay=0.01)))
    jtr = JaxTrainer(JLL.CausalLmTask(jcfg), jtx, mesh,
                     policy=jmp.Policy.from_name("float32"),
                     config=JaxTrainerConfig(log_every=5,
                                             log_grad_norm=True),
                     callbacks=[hist])
    src = dict(num_examples=64, seq_len=SEQ, vocab_size=256)
    loader = HostDataLoader(JaxSyntheticLM(**src),
                            DataConfig(global_batch_size=BATCH, seed=0))
    jstate = jtr.create_state(next(iter(loader)))
    init = _flat(jstate.params)
    jgrads, _, _, _ = jtr._microbatch_grads(
        jstate.params, jstate.model_state, next(iter(loader)),
        jax.random.key(0), jstate.loss_scale)
    ttx = TLO.freeze_base(topt.make_optimizer(
        "adamw", 1e-2, weight_decay=0.01, grad_clip_norm=1.0))
    ttr = Trainer(TLL.CausalLmTask(tcfg, device="meta"), ttx,
                  policy=Policy.from_name("float32"),
                  config=TrainerConfig(log_every=5, log_grad_norm=True),
                  device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(init, tcfg))
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    jstate = jtr.fit(loader, steps=STEPS, state=jstate)
    tstate, history = ttr.fit(HostBatches(SyntheticLM(**src), BATCH, seed=0),
                              steps=STEPS, state=tstate)
    return dict(hist=hist, history=history, jstate=jstate, tstate=tstate,
                before=before, jgrads=_flat(jgrads), tcfg=tcfg)


def test_loss_curve_matches_the_jax_lora_trainer(curves):
    history, hist = curves["history"], curves["hist"]
    got = np.array([m["loss"] for _, m in history])
    want = np.array(hist.history["loss"])
    assert got.shape == want.shape == (STEPS,)
    assert np.max(np.abs(got - want)) <= 1e-4, got - want
    assert got[-1] < got[0]
    jfinal = convert.params_from_flax(_flat(curves["jstate"].params),
                                      curves["tcfg"])
    for name, p in curves["tstate"].params.items():
        np.testing.assert_allclose(p.detach().numpy(), jfinal[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_only_adapters_move_and_frozen_params_carry_no_moments(curves):
    tstate, before = curves["tstate"], curves["before"]
    moved = {k for k, v in tstate.params.items()
             if not torch.equal(v, before[k])}
    assert moved and all(TLO.is_lora_param(k) for k in moved)
    assert any(k.endswith("lora_b") for k in moved)
    for k, v in tstate.params.items():
        assert (v.grad is None), k      # no gradient buffer anywhere
    # chain(clip, adamw) state over the adapters only: adam's moments.
    adam = tstate.opt_state[1][0]
    adapters = [v for k, v in tstate.params.items() if TLO.is_lora_param(k)]
    assert len(adam.mu) == len(adam.nu) == len(adapters)
    assert [m.shape for m in adam.mu] == [a.shape for a in adapters]


def test_grad_norm_is_the_adapters_norm(curves):
    """The port logs the adapters' global norm; JAX's logged norm also
    counts the gradients it masks (embeddings, norms, untargeted
    kernels)."""
    jgrads = curves["jgrads"]
    adapters = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                           for k, v in jgrads.items()
                           if JLO.is_lora_param(tuple(k.split("/")))))
    got = curves["history"][0][1]["grad_norm"]
    np.testing.assert_allclose(got, adapters, rtol=1e-4)
    assert got < curves["hist"].history["grad_norm"][0]


# -- the launcher and serve.py ------------------------------------------------


def _cli(tmp, *flags, env=None, module="tensorflow_train_distributed_torch"):
    e = {k: v for k, v in os.environ.items()
         if k not in ("TTD_FAULT_PLAN", "TTD_SUPERVISE_ATTEMPT")}
    e["PYTHONPATH"] = REPO
    e.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", module, "--config", "llama_tiny_sft",
         "--device", "cpu", *flags], cwd=tmp, env=e, capture_output=True,
        text=True, timeout=180)


LORA_RUN = ["--steps", "8", "--checkpoint-every", "4", "--log-every", "2",
            "--lora-rank", "4", "--learning-rate", "0.01", "--precision",
            "float32"]


@pytest.fixture(scope="module")
def lora_runs(tmp_path_factory):
    """(a) 8 LoRA steps with a save every 4; (b) the same killed by the
    fault plan at step 6; (c) its rerun as supervisor attempt 1."""
    tmp = tmp_path_factory.mktemp("lora_cli")
    plan = ["--fault-plan", "step:6:kill9:attempt=0"]
    a = _cli(tmp, *LORA_RUN, "--checkpoint-dir", "a")
    b = _cli(tmp, *LORA_RUN, "--checkpoint-dir", "b", *plan)
    c = _cli(tmp, *LORA_RUN, "--checkpoint-dir", "b", *plan,
             env={"TTD_SUPERVISE_ATTEMPT": "1"})
    return tmp, a, b, c


def test_killed_lora_run_resumes_bit_for_bit(lora_runs):
    tmp, a, b, c = lora_runs
    assert a.returncode == 0, a.stderr[-2000:]
    assert b.returncode == -9, b.stderr[-2000:]
    assert c.returncode == 0, c.stderr[-2000:]
    assert "restored checkpoint step 4" in c.stderr
    for f in ("tensors.bin", "manifest.json"):
        assert (tmp / "a" / "8" / f).read_bytes() == \
            (tmp / "b" / "8" / f).read_bytes(), f
    assert TLO.load_spec(str(tmp / "a")) == TLO.LoraSpec(rank=4)
    summary = json.loads(a.stderr.split("launch summary: ")[1].splitlines()[0])
    assert 0 < summary["lora_params"] < summary["params"]


@pytest.mark.parametrize("flags,match", [
    (["--lora-rank", "4", "--ema-decay", "0.9"], "ema-decay"),
    (["--lora-rank", "4", "--lora-targets", "query,bogus"],
     "unknown LoRA target"),
    (["--lora-rank", "4", "--lora-alpha", "0"], "alpha"),
    (["--lora-rank", "4", "--config", "moe_tiny_lm"], "decoder-LM"),
])
def test_cli_refuses_bad_lora_flags(flags, match):
    argv = ["--config", "llama_tiny_sft", "--steps", "1", "--device", "cpu",
            *flags]
    with pytest.raises(SystemExit, match=match):
        tlaunch.run(tlaunch.build_parser().parse_args(argv))


def test_cli_refuses_a_sidecar_mismatch_and_a_stale_sidecar(lora_runs):
    tmp = lora_runs[0]
    base = ["--config", "llama_tiny_sft", "--steps", "9", "--device", "cpu",
            "--checkpoint-dir", str(tmp / "a")]
    with pytest.raises(SystemExit, match="disagree"):
        tlaunch.run(tlaunch.build_parser().parse_args(
            base + ["--lora-rank", "8"]))
    with pytest.raises(SystemExit, match="no --lora-rank"):
        tlaunch.run(tlaunch.build_parser().parse_args(base))
    assert TLO.load_spec(str(tmp / "a")) == TLO.LoraSpec(rank=4)


def test_serve_checkpoint_dir_gives_the_jax_engines_tokens(lora_runs,
                                                           capsys):
    """serve.py --checkpoint-dir on (a)'s LoRA checkpoint: the adapters
    merged per its sidecar; greedy tokens equal the JAX ServingEngine's
    on the same merged parameters, and the merge moved the kernels."""
    tmp = lora_runs[0]
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [11, 12, 13, 14, 15, 16, 17]]
    argv = ["--config", "llama_tiny_sft", "--checkpoint-dir",
            str(tmp / "a"), "--device", "cpu", "--max-new", "6",
            "--slots", "2", "--chunk", "2", "--cache-len", "64",
            "--kv-block-size", "4"]
    for p in prompts:
        argv += ["--prompt", ",".join(map(str, p))]
    assert tserve.main(argv) == 0
    got = [json.loads(x)["tokens"] for x in
           capsys.readouterr().out.splitlines()]
    from tensorflow_train_distributed_torch.training.checkpoint import (
        CheckpointManager,
    )

    params = CheckpointManager(str(tmp / "a")).restore_params()
    merged = TLO.merge_lora(params, TLO.LoraSpec(rank=4))
    base = {k: v for k, v in params.items() if not TLO.is_lora_param(k)}
    assert any(not torch.equal(merged[k], base[k]) for k in merged)
    jeng = JaxEngine(JLL.LLAMA_PRESETS["llama_tiny"],
                     jax.tree.map(jnp.asarray, traverse_util.unflatten_dict(
                         _to_flax(merged), sep="/")),
                     overlap=False, prefill_budget=0, slots=2, cache_len=64,
                     chunk=2, prompt_buckets=(8, 16), kv_block_size=4)
    ids = [jeng.submit(p, 6) for p in prompts]
    out = jeng.run()
    assert got == [list(out[i]) for i in ids]
    # Flags that contradict the sidecar exit non-zero.
    with pytest.raises(SystemExit, match="disagree"):
        tserve.main(argv + ["--lora-rank", "8"])
    with pytest.raises(SystemExit, match="need --lora-rank"):
        tserve.main(argv + ["--lora-alpha", "4"])
