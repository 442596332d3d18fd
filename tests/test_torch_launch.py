"""The port's launcher and what it adds to the model and the optimizer,
against the JAX package, on the CPU.

- The "dots" and "no_ffn" remat policies: gradients equal to no remat
  (f32, rtol 1e-5), and what each recomputes.
- lamb with decay and an injected learning rate, and adafactor on
  factored leaves, against optax (f32, rtol 1e-6, atol 1e-7: the
  optimizer tests' tolerance).
- ``Trainer.evaluate`` and ``predict`` against the JAX ``Trainer`` on
  ``llama_tiny_sft`` over a padded held-out split (1e-5).
- The launcher: its refusals (exit 2, one line naming the ROADMAP item),
  the chaos contract through ``python -m tensorflow_train_distributed_torch``
  (a torn save and a kill -9, then a rerun, bitwise equal to the
  uninterrupted run, with the same evaluation), and its loss curve
  against the JAX launcher's on the same config, seed and weights (the
  curve tolerance of ``tests/test_torch_training.py``: max |delta|
  1e-4 over 20 f32 steps).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu import launch as jlaunch
from tensorflow_train_distributed_tpu.data import DataConfig as JDataConfig
from tensorflow_train_distributed_tpu.data import (
    HostDataLoader as JHostDataLoader,
)
from tensorflow_train_distributed_tpu.data import datasets as jds
from tensorflow_train_distributed_tpu.models import registry as jreg
from tensorflow_train_distributed_tpu.runtime.mesh import (
    MeshConfig,
    build_mesh,
)
from tensorflow_train_distributed_tpu.training.trainer import (
    Trainer as JaxTrainer,
    TrainerConfig as JaxTrainerConfig,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch import launch as tlaunch
from tensorflow_train_distributed_torch.data import datasets as tds
from tensorflow_train_distributed_torch.data.pipeline import (
    DataConfig,
    HostDataLoader,
)
from tensorflow_train_distributed_torch.models import llama as TLL
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.mixed_precision import (
    Policy,
)
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(params) -> dict:
    import flax.linen as fnn

    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


# -- remat policies -----------------------------------------------------------


def _grads(cfg, params, tokens):
    model = TLL.LlamaModel(cfg, device="meta")
    model.load_state_dict({k: v.clone() for k, v in params.items()},
                          strict=True, assign=True)
    model(tokens).float().square().mean().backward()
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["dots", "no_ffn", "full"])
@pytest.mark.parametrize("knobs", [{}, dict(qkv_bias=True, fused_qkv=True)])
def test_remat_policy_gradients_match_no_remat(policy, knobs):
    base = dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"], remat=False,
                               **knobs)
    params = convert.init_params(base, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32)
    tokens = torch.randint(0, 256, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    want = _grads(base, params, tokens)
    got = _grads(dataclasses.replace(base, remat=True, remat_policy=policy),
                 params, tokens)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def _backward_ops(cfg, params, tokens):
    """(aten.mm calls in the backward, RMSNorm forwards, MLP forwards)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tensorflow_train_distributed_torch.models import layers as TLy

    counts = {"mm": 0, "norm": 0, "mlp": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                counts["mm"] += 1
            return func(*args, **(kwargs or {}))

    model = TLL.LlamaModel(cfg, device="meta")
    model.load_state_dict({k: v.clone() for k, v in params.items()},
                          strict=True, assign=True)
    hooks = [m.register_forward_pre_hook(
        lambda *a, key=key: counts.__setitem__(key, counts[key] + 1))
        for m in model.modules()
        for key in (("norm",) if isinstance(m, TLy.RMSNorm) else
                    ("mlp",) if isinstance(m, TLy.MlpBlock) else ())]
    loss = model(tokens).float().square().mean()
    with Count():
        loss.backward()
    for h in hooks:
        h.remove()
    return counts


def test_remat_policies_recompute_what_jax_recomputes():
    """Per block: "full" reruns the whole block in the backward (norms
    and MLP entered twice, the forward's matmuls again); "dots" reruns
    the block but takes the projections' outputs from the saves (no
    forward mm in the backward); "no_ffn" reruns the MLP alone.  The
    recompute stops once it has every tensor the backward needs, so each
    region's last projection (the FFN's ``wo``) is not run again."""
    base = dataclasses.replace(TLL.LLAMA_PRESETS["llama_tiny"], remat=False)
    params = convert.init_params(base, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32)
    tokens = torch.zeros(1, 8, dtype=torch.long)
    n = base.num_layers
    got = {p: _backward_ops(dataclasses.replace(base, remat=True,
                                                remat_policy=p),
                            params, tokens)
           for p in ("full", "dots", "no_ffn")}
    plain = _backward_ops(base, params, tokens)
    assert plain["norm"] == 2 * n + 1 and plain["mlp"] == n
    assert got["full"]["norm"] == got["dots"]["norm"] == 4 * n + 1
    assert got["full"]["mlp"] == got["dots"]["mlp"] == 2 * n
    assert got["no_ffn"]["norm"] == 2 * n + 1 and got["no_ffn"]["mlp"] == 2 * n
    # q, k, v, o, gate and up of each block; gate and up of each FFN.
    assert got["full"]["mm"] - plain["mm"] == 6 * n
    assert got["dots"]["mm"] == plain["mm"]
    assert got["no_ffn"]["mm"] - plain["mm"] == 2 * n


# -- lamb, adafactor, the injected learning rate -------------------------------


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name,jtx,kw", [
    ("adafactor", lambda: optax.adafactor(0.05), {}),
    ("adafactor", lambda: optax.adafactor(0.05, weight_decay_rate=0.01),
     dict(weight_decay=0.01)),
    ("lamb", lambda: optax.lamb(0.05, weight_decay=0.01),
     dict(weight_decay=0.01)),
    ("lamb", lambda: optax.inject_hyperparams(optax.lamb)(
        learning_rate=0.05, weight_decay=0.01),
     dict(weight_decay=0.01, inject_lr=True)),
    ("adafactor", lambda: optax.inject_hyperparams(optax.adafactor)(
        learning_rate=0.05), dict(inject_lr=True)),
])
def test_factored_and_injected_steps_match_optax(name, jtx, kw):
    """Three steps on leaves adafactor factors ([130, 160], and [3, 128,
    140] over its two largest axes) and on ones it does not, a zero leaf
    (lamb's trust ratio 1)."""
    shapes = [(130, 160), (3, 128, 140), (5,), (4, 3)]
    params = [_rand(s, i) for i, s in enumerate(shapes)]
    params[3][:] = 0
    jt = jtx()
    tt = topt.make_optimizer(name, 0.05, **kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jt.init(jp), tt.init(tp)
    for step in range(3):
        grads = [_rand(s, 10 * step + i) for i, s in enumerate(shapes)]
        ju, js = jt.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = tt.update([torch.from_numpy(g) for g in grads], ts, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {step}")


def test_injected_learning_rate_is_state():
    params = [torch.ones(4)]
    tx = topt.make_optimizer("sgd", 0.5, inject_lr=True)
    state = tx.init(params)
    state, n = topt.set_injected_hyperparam(state, "learning_rate", 0.25)
    assert n == 1
    u, state = tx.update([torch.ones(4)], state, params)
    assert u[0].tolist() == [-0.25] * 4
    assert float(topt.get_injected_hyperparam(state, "learning_rate")) == 0.25
    with pytest.raises(ValueError, match="constant"):
        topt.make_optimizer("sgd", lambda c: 0.1, inject_lr=True)


# -- evaluate and predict against the JAX Trainer ----------------------------


def test_evaluate_and_predict_match_jax_trainer():
    """llama_tiny_sft's model and weights; the tail 20 records of its
    source as a held-out split, batches of 8 (the third padded with 4
    repeats of weight 0)."""
    jentry, tentry = jreg.get_entry("llama_tiny_sft"), \
        treg.get_entry("llama_tiny_sft")
    kw = dict(tentry["dataset_kwargs"], num_examples=60)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = JaxTrainer(jentry["task_factory"](), optax.sgd(0.1), mesh,
                     config=JaxTrainerConfig(seed=0))
    _, jval = jds.train_val_split(jds.SyntheticLM(**kw), 1 / 3, min_val=8,
                                  min_train=8)
    jloader = JHostDataLoader(jval, JDataConfig(
        global_batch_size=8, seed=1, num_epochs=1, drop_remainder=False),
        process_index=0, process_count=1)
    jstate = jtr.create_state(next(iter(jloader)))
    cfg = tentry["config"]
    ttr = Trainer(TLL.CausalLmTask(cfg, device="meta"),
                  topt.make_optimizer("sgd", 0.1),
                  policy=Policy.from_name("bfloat16"), device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(_flat(jstate.params),
                                                       cfg))
    _, tval = tds.train_val_split(tds.SyntheticLM(**kw), 1 / 3, min_val=8,
                                  min_train=8)
    tloader = HostDataLoader(tval, DataConfig(
        global_batch_size=8, seed=1, num_epochs=1, drop_remainder=False))
    assert tloader.steps_per_epoch() == 3
    want = jtr.evaluate(jloader, jstate)
    got = ttr.evaluate(tloader, tstate)
    assert got.keys() == want.keys() >= {"loss", "accuracy", "perplexity",
                                          "loss_weight"}
    assert got["loss_weight"] == want["loss_weight"] == 20 * 32
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    jout = np.asarray(jtr.predict(jloader, jstate))
    tout = ttr.predict(tloader, tstate)
    assert tout.shape == jout.shape == (20, 32, 256)
    np.testing.assert_allclose(tout.float().numpy(), jout.astype(np.float32),
                               rtol=1e-5, atol=1e-5)
    one = ttr.evaluate(tloader, tstate, steps=1)
    assert one["loss_weight"] == 8 * 32


# -- the launcher -------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--strategy", "fsdp"], ["--mesh", "data=2"], ["--zero1"],
    ["--grad-quant", "int8"], ["--num-processes", "2"],
    ["--init-from-hf", "/nowhere"], ["--supervise"],
    ["--tensorboard-dir", "tb"], ["--profile-dir", "p"],
    ["--steps-per-execution", "4"], ["--platform", "cpu"]])
def test_unported_flags_are_refused(flags, capsys):
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--config", "llama_tiny_sft", "--device", "cpu",
                      *flags])
    assert e.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "ROADMAP Queue 1 item" in err[0], err


@pytest.mark.parametrize("flags,match", [
    (["--eval-only"], "--eval-steps"),
    (["--save-best"], "--checkpoint-dir"),
    (["--eval-every", "2"], "--eval-steps"),
    (["--eval-split", "0.1"], "--eval-steps"),
    (["--reduce-lr-factor", "1.5"], "reduce-lr-factor"),
    (["--reduce-lr-factor", "0.5", "--lr-schedule", "warmup_cosine"],
     "constant"),
    (["--ema-decay", "0"], "ema-decay"),
    (["--steps", "0"], "steps"),
    (["--pack-seq", "16"], "data-dir"),
    (["--device", "cuda"], "CUDA"),
])
def test_flag_conflicts_are_refused_before_setup(flags, match):
    if "cuda" in flags and torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    argv = ["--config", "llama_tiny_sft", "--device", "cpu", *flags]
    with pytest.raises(SystemExit, match=match):
        tlaunch.run(tlaunch.build_parser().parse_args(argv))


def test_list_configs_and_unknown_config(capsys):
    assert tlaunch.main(["--list-configs"]) == 0
    out = capsys.readouterr().out
    for name in ("llama_125m_lm:", "resnet50_imagenet:", "bert_base_mlm:",
                 "transformer_big_wmt:", "mnist:"):
        assert name in out
    with pytest.raises(SystemExit, match="Unknown config"):
        tlaunch.main(["--config", "vit_b16_imagenet", "--device", "cpu"])


_CHAOS_FLAGS = ["--steps", "12", "--checkpoint-every", "4",
                "--max-to-keep", "2", "--eval-split", "0.001",
                "--eval-steps", "4", "--eval-every", "6", "--log-every", "2"]


def _cli(tmp, *flags, env=None, config="llama_tiny_sft", base=_CHAOS_FLAGS):
    e = {k: v for k, v in os.environ.items()
         if k not in ("TTD_FAULT_PLAN", "TTD_SUPERVISE_ATTEMPT")}
    e["PYTHONPATH"] = REPO
    e.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "tensorflow_train_distributed_torch",
         "--config", config, "--device", "cpu", *base, *flags], cwd=tmp,
        env=e, capture_output=True, text=True, timeout=180)


def _lines(out):
    return [json.loads(x) for x in out.splitlines()]


def test_chaos_contract_through_the_cli(tmp_path):
    """(a) 12 steps uninterrupted; (b) the same with the step-8 save
    torn and a kill -9 at step 10; (c) the rerun on supervisor attempt 1
    quarantines step 8, restores step 4, takes the data up mid-epoch and
    ends bit for bit equal to (a), with the same evaluation; (d)
    ``--eval-only`` on (a)'s directory reproduces it."""
    plan = ["--fault-plan",
            "ckpt:save:partial:step=8:attempt=0;step:10:kill9:attempt=0"]
    a = _cli(tmp_path, "--checkpoint-dir", "a", "--jsonl-log", "a.jsonl")
    assert a.returncode == 0, a.stderr[-2000:]
    b = _cli(tmp_path, "--checkpoint-dir", "b", *plan)
    assert b.returncode == -9, b.stderr[-2000:]
    assert not (tmp_path / "b" / "8" / "_CHECKPOINT_METADATA").exists()
    c = _cli(tmp_path, "--checkpoint-dir", "b", *plan,
             env={"TTD_SUPERVISE_ATTEMPT": "1"})
    assert c.returncode == 0, c.stderr[-2000:]
    assert "restored checkpoint step 4" in c.stderr
    assert "data stream resumed at epoch 0, batch 4" in c.stderr
    assert (tmp_path / "b" / "corrupt" / "8").is_dir()
    for f in ("tensors.bin", "manifest.json"):
        assert (tmp_path / "a" / "12" / f).read_bytes() == \
            (tmp_path / "b" / "12" / f).read_bytes(), f
    la, lc = _lines(a.stdout), _lines(c.stdout)
    val = [x for x in la if "val_loss" in x]
    assert [x["step"] for x in val] == [6, 12]
    assert [x for x in lc if "val_loss" in x] == val   # resumed at 4
    assert la[-1]["eval"] == lc[-1]["eval"]
    assert la[-1]["eval"]["loss"] == val[-1]["val_loss"]
    steps = [json.loads(x)["step"] for x in
             (tmp_path / "a.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3, 4, 5, 6, 6, 7, 8, 9, 10, 11, 12, 12]
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["12", "8"]
    d = _cli(tmp_path, "--checkpoint-dir", "a", "--eval-only")
    assert d.returncode == 0, d.stderr[-2000:]
    (line,) = _lines(d.stdout)
    assert line == {"step": 12, "eval": la[-1]["eval"]}


def test_loss_curve_matches_the_jax_launcher(tmp_path):
    """20 f32 steps of llama_tiny_sft from seed 0, the JAX launcher on
    its 8-device CPU mesh (dp) and the port's from the same weights
    (``--params-npz`` of the JAX init): the same batches, schedule and
    optimizer, so the curves agree to the two trainers' f32 rounding."""
    flags = ["--config", "llama_tiny_sft", "--steps", "20", "--precision",
             "float32", "--log-every", "1", "--seed", "0"]
    want = jlaunch.run(jlaunch.build_parser().parse_args(
        flags + ["--strategy", "dp"])).history["loss"]
    entry = jreg.get_entry("llama_tiny_sft")
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = JaxTrainer(entry["task_factory"](), optax.sgd(0.1), mesh,
                     config=JaxTrainerConfig(seed=0))
    src = jds.get_dataset("lm", **entry["dataset_kwargs"])
    sample = JHostDataLoader(src, JDataConfig(global_batch_size=16),
                             process_index=0, process_count=1)
    init = jtr.create_state(next(iter(sample))).params
    np.savez(tmp_path / "init.npz", **_flat(init))
    got = tlaunch.run(tlaunch.build_parser().parse_args(
        flags + ["--device", "cpu", "--params-npz",
                 str(tmp_path / "init.npz")])).history["loss"]
    assert len(got) == len(want) == 20
    assert np.max(np.abs(np.array(got) - np.array(want))) <= 1e-4
    assert got[-1] < got[0]


# -- the other families -------------------------------------------------------


@pytest.mark.parametrize("config", ["bert_tiny_mlm", "resnet_tiny"])
def test_family_kill_and_resume_through_the_cli(tmp_path, config):
    """(a) 8 steps with a save every 4; (b) the same killed by the fault
    plan at step 6; (c) its rerun restores step 4 and ends with a step-8
    checkpoint bit for bit equal to (a)'s, BatchNorm's running statistics
    included, and the same evaluation."""
    base = ["--steps", "8", "--checkpoint-every", "4", "--eval-steps", "1",
            "--log-every", "2", "--global-batch-size", "8"]
    plan = ["--fault-plan", "step:6:kill9:attempt=0"]
    a = _cli(tmp_path, "--checkpoint-dir", "a", config=config, base=base)
    assert a.returncode == 0, a.stderr[-2000:]
    b = _cli(tmp_path, "--checkpoint-dir", "b", *plan, config=config,
             base=base)
    assert b.returncode == -9, b.stderr[-2000:]
    c = _cli(tmp_path, "--checkpoint-dir", "b", *plan, config=config,
             base=base, env={"TTD_SUPERVISE_ATTEMPT": "1"})
    assert c.returncode == 0, c.stderr[-2000:]
    assert "restored checkpoint step 4" in c.stderr
    for f in ("tensors.bin", "manifest.json"):
        assert (tmp_path / "a" / "8" / f).read_bytes() == \
            (tmp_path / "b" / "8" / f).read_bytes(), f
    manifest = json.loads((tmp_path / "a" / "8" / "manifest.json")
                          .read_text())
    stats = [k for k in manifest["tensors"] if k.startswith("model_state/")]
    assert bool(stats) == (config == "resnet_tiny"), stats
    assert _lines(a.stdout)[-1]["eval"] == _lines(c.stdout)[-1]["eval"]


@pytest.mark.parametrize("config", ["mnist", "transformer_tiny_wmt"])
def test_family_trains_through_the_cli(config, capsys):
    assert tlaunch.main(["--config", config, "--device", "cpu", "--steps",
                         "3", "--log-every", "1", "--global-batch-size",
                         "8", "--precision", "float32"]) == 0
    lines = _lines(capsys.readouterr().out)
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines)


def test_bleu_eval_is_for_the_wmt_family():
    with pytest.raises(SystemExit, match="seq2seq"):
        tlaunch.run(tlaunch.build_parser().parse_args(
            ["--config", "llama_tiny_sft", "--device", "cpu",
             "--bleu-eval", "1"]))


def _jax_init(name, batch_size):
    """The JAX launcher's init for ``name`` at seed 0, flat."""
    entry = jreg.get_entry(name)
    mesh = build_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = JaxTrainer(entry["task_factory"](), optax.sgd(0.1), mesh,
                     config=JaxTrainerConfig(seed=0))
    src = jds.get_dataset(entry["dataset"], **entry["dataset_kwargs"])
    sample = JHostDataLoader(src, JDataConfig(global_batch_size=batch_size),
                             process_index=0, process_count=1)
    return jtr.create_state(next(iter(sample))).params


def test_bleu_matches_the_jax_launcher(tmp_path):
    """``transformer_tiny_wmt --bleu-eval 1 --beam-size 2``: three f32
    steps from the same weights, then beam decoding of one evaluation
    batch; both launchers print the same BLEU and evaluation loss."""
    flags = ["--config", "transformer_tiny_wmt", "--steps", "3",
             "--precision", "float32", "--log-every", "1", "--seed", "0",
             "--eval-steps", "1", "--bleu-eval", "1", "--beam-size", "2"]
    want = jlaunch.run(jlaunch.build_parser().parse_args(
        flags + ["--strategy", "dp"])).eval_metrics
    np.savez(tmp_path / "init.npz",
             **_flat(_jax_init("transformer_tiny_wmt", 32)))
    got = tlaunch.run(tlaunch.build_parser().parse_args(
        flags + ["--device", "cpu", "--params-npz",
                 str(tmp_path / "init.npz")])).eval_metrics
    assert got["bleu"] == want["bleu"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_bleu_eval_matches_jax_on_overlapping_references():
    """The launchers' ``_bleu_eval`` on the same weights and a batch whose
    references are half the JAX greedy outputs (a BLEU well above 0):
    the same hypotheses, so the same score; padded rows left out."""
    from tensorflow_train_distributed_tpu.models import transformer as JT

    from tensorflow_train_distributed_torch.models import transformer as TT

    jentry = jreg.get_entry("transformer_tiny_wmt")
    params = _jax_init("transformer_tiny_wmt", 8)
    src = np.random.default_rng(3).integers(3, 256, (8, 16)).astype(
        np.int32)
    hyp = np.asarray(JT.greedy_translate(
        jentry["task_factory"]().config, params, src, max_len=16, bos_id=1,
        eos_id=2))
    refs = hyp.copy()
    refs[::2, 8:] = 5                      # half the rows differ at the end
    batch = {"inputs": src, "targets_out": refs,
             "sample_weight": np.array([1.0] * 7 + [0.0], np.float32)}
    args = tlaunch.build_parser().parse_args(
        ["--config", "transformer_tiny_wmt", "--bleu-eval", "1",
         "--beam-size", "2"])

    class _State:
        pass

    jstate = _State()
    jstate.params = params
    want = jlaunch._bleu_eval(args, jentry["task_factory"](), jstate,
                              [batch])
    tentry = treg.get_entry("transformer_tiny_wmt")
    ttr = Trainer(treg.make_task(tentry, device="meta"),
                  topt.make_optimizer("sgd", 0.1),
                  policy=Policy.from_name("float32"), device="cpu")
    tstate = ttr.create_state(convert.params_from_flax(_flat(params),
                                                       tentry["config"]))
    got = tlaunch._bleu_eval(args, ttr, tstate, [batch])
    assert want > 10.0
    assert got == want
    assert isinstance(ttr.task.model, TT.Seq2SeqTransformer)
