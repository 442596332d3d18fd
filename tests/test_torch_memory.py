"""The port's memory planner (``training/memory.py``) against the JAX
package's ``plan_state_memory`` on the CPU, and against the peaks
measured on an H100 that calibrate it.

- the state is exact: parameter and optimizer-state element counts equal
  what the JAX plan counts (llama_tiny, moe_tiny, bert_tiny,
  resnet_tiny), its bytes follow the port's 16-byte recipe, and a mesh
  divides it as ``parallel.state_plan`` does;
- the activation model with the port's coefficients reproduces the card
  points pinned below (NVIDIA H100 80GB HBM3, 700.00 W;
  ``torch.cuda.max_memory_allocated`` over 2 ``Trainer.fit`` steps);
- models it does not cover raise; Llama-2-7B's full fine-tune is refused
  with nothing allocated; ``bench_lm``'s guard counts activations.
"""

import dataclasses
import json

import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.tools import bench_lm
from tensorflow_train_distributed_torch.training import memory as M

H100 = "NVIDIA H100 80GB HBM3"
GIB = 2 ** 30


def _task(name, **changes):
    entry = treg.get_entry(name)
    if changes:
        entry = dict(entry, config=dataclasses.replace(entry["config"],
                                                       **changes))
    return treg.make_task(entry, device="meta")


def _tokens(b, s):
    return {"tokens": np.zeros((b, s), np.int32),
            "targets": np.zeros((b, s), np.int32)}


# -- the state ----------------------------------------------------------------

_LM = _tokens(2, 16)
_STATE_CASES = [
    ("llama_tiny_sft", _LM),
    ("moe_tiny_lm", _LM),
    ("bert_tiny_mlm", {"input_ids": np.zeros((2, 16), np.int32),
                       "labels": np.zeros((2, 16), np.int32),
                       "mask_weights": np.ones((2, 16), np.float32)}),
    ("resnet_tiny", {"image": np.zeros((2, 32, 32, 3), np.float32),
                     "label": np.zeros((2,), np.int32)}),
]


@pytest.mark.parametrize("name,batch", _STATE_CASES,
                         ids=[c[0] for c in _STATE_CASES])
def test_state_counts_equal_jax(name, batch):
    import jax

    from tensorflow_train_distributed_tpu.models import registry as jreg
    from tensorflow_train_distributed_tpu.runtime.compat import abstract_mesh
    from tensorflow_train_distributed_tpu.runtime.mesh import AXES
    from tensorflow_train_distributed_tpu.training.trainer import (
        plan_state_memory as jax_plan,
    )

    jtask = jreg.get_task(name)
    tx = optax.adamw(1e-3)
    ref = jax_plan(jtask, batch, tx, abstract_mesh((1,) * len(AXES), AXES))
    variables = jax.eval_shape(
        lambda: dict(jtask.init_variables(jax.random.key(0), batch)))
    params = variables.pop("params")
    count = lambda t: sum(x.size for x in jax.tree_util.tree_leaves(t))
    opt = jax.eval_shape(tx.init, params)
    opt_el = sum(x.size for x in jax.tree_util.tree_leaves(opt)
                 if x.ndim > 0)

    plan = M.plan_state_memory(_task(name), batch, "adamw")
    assert plan["param_elements"] == count(params)
    assert plan["opt_state_elements"] == opt_el == 2 * count(params)
    assert plan["model_state_elements"] == count(variables)
    # JAX's bytes: every leaf f32, plus two int32 scalars (step, count).
    assert ref["total_bytes"] == 4 * (plan["param_elements"]
                                      + plan["opt_state_elements"]
                                      + plan["model_state_elements"]) + 8
    # The port's recipe: f32 master, f32 gradient, two f32 moments.
    assert plan["per_device_bytes"] == (
        M.STATE_BYTES_PER_PARAM * plan["param_elements"]
        + 4 * plan["model_state_elements"])


def test_mesh_divides_the_optimizer_state_as_the_state_plan():
    from tensorflow_train_distributed_torch.parallel.state_plan import (
        StatePlan,
    )
    from tensorflow_train_distributed_torch.runtime.mesh import AXES, Mesh

    task = _task("llama_tiny_sft")
    shapes = {k: tuple(p.shape) for k, p in task.model.named_parameters()}
    one = M.plan_state_memory(task, None, "adamw")
    for sizes, zero1 in (({"fsdp": 2, "tensor": 2}, False),
                         ({"data": 4}, True)):
        mesh = Mesh({a: sizes.get(a, 1) for a in AXES})
        sp = StatePlan(mesh, shapes, zero1=zero1)
        pieces = sum(int(np.prod(sp.piece_shape(k))) for k in shapes)
        plan = M.plan_state_memory(task, None, "adamw", sizes, zero1=zero1)
        assert plan["opt_state_elements"] == 2 * pieces
        assert pieces < one["param_elements"]
        # Parameters and gradients stay whole on every rank.
        assert plan["local_param_elements"] == one["param_elements"]
        assert plan["grad_elements"] == one["grad_elements"]
        assert plan["per_device_bytes"] < one["per_device_bytes"]
        assert plan["total_bytes"] == one["total_bytes"]


def test_expert_axis_splits_expert_stacks():
    task = _task("moe_tiny_lm")
    one = M.plan_state_memory(task, None, "adamw")
    two = M.plan_state_memory(task, None, "adamw", {"expert": 2})
    assert two["local_param_elements"] < one["param_elements"]
    assert two["param_elements"] == one["param_elements"]


# -- the activation model against the card ------------------------------------

# (config, layers, batch, seq, remat, measured peak GiB, the plan's GiB):
# ``tools/memory_calibration.py`` on an NVIDIA H100 80GB HBM3, 700.00 W.
CARD_POINTS = [
    ("llama_125m_lm", 12, 8, 2048, True, 5.858, 5.968),
    ("llama_125m_lm", 12, 16, 2048, True, 10.035, 10.345),
    ("llama_125m_lm", 12, 8, 2048, False, 10.943, 11.021),
    ("llama_125m_lm", 12, 16, 2048, False, 20.163, 20.293),
    ("llama_125m_lm", 12, 4, 2048, False, 6.340, 6.385),
    ("llama_125m_lm", 12, 1, 128, True, 4.531, 4.496),
    ("mistral_7b_lm", 4, 8, 8192, True, 38.042, 38.040),
    ("mistral_7b_lm", 2, 8, 8192, True, 25.708, 25.683),
    ("mistral_7b_lm", 4, 1, 1024, True, 38.040, 38.040),
    ("mistral_7b_lm", 1, 8, 8192, False, 32.935, 32.774),
    ("mistral_7b_lm", 2, 4, 8192, False, 27.449, 27.405),
]


@pytest.mark.parametrize("point", CARD_POINTS,
                         ids=[f"{p[0]}-L{p[1]}-b{p[2]}-s{p[3]}-"
                              f"{'remat' if p[4] else 'none'}"
                              for p in CARD_POINTS])
def test_plan_reproduces_the_card_points(point):
    name, layers, b, s, remat, measured, pinned = point
    plan = M.plan_train_memory(_task(name, num_layers=layers, remat=remat),
                               _tokens(b, s), "adamw",
                               compute_dtype=torch.bfloat16,
                               device_name=H100)
    est = plan["step_bytes_per_device"] / GIB
    assert est == pytest.approx(pinned, abs=1e-3)
    assert est >= measured * (1 - M.PLAN_MARGIN)
    assert abs(est - measured) / measured < 0.035
    assert plan["fits"]


def test_plan_phases():
    """The backward sets phase 6's peak, the update phase 10's (its
    activations under remat are smaller than the update's lists)."""
    p6 = M.plan_train_memory(_task("llama_125m_lm"), _tokens(8, 2048))
    p10 = M.plan_train_memory(_task("mistral_7b_lm", num_layers=4),
                              _tokens(8, 8192))
    assert p6["peak_phase"] == "backward"
    assert p10["peak_phase"] == "update"
    assert p10["update_bytes_per_device"] == \
        M.UPDATE_BYTES_PER_PARAM * p10["grad_elements"]


def test_activation_terms():
    kw = dict(num_layers=12, d_model=768, batch=16, seq=2048, vocab=32000,
              ffn_size=2048)
    none = M.decoder_activation_bytes(remat=False, **kw)
    no_ffn = M.decoder_activation_bytes(remat="no_ffn", **kw)
    full = M.decoder_activation_bytes(remat=True, **kw)
    assert full < no_ffn < none
    # The head's logits: the whole activation of a zero-layer model.
    head = M.decoder_activation_bytes(**dict(kw, num_layers=0), remat=True)
    assert head == int(M.HEAD_BYTES_PER_LOGIT * 16 * 2048 * 32000)
    # The dense path adds [B, H, S, S] scores; a window changes nothing.
    dense = M.decoder_activation_bytes(remat=False, dense_heads=12,
                                       causal=False, **kw)
    assert dense - none == M.DENSE_SCORE_BYTES * 12 * 16 * 2048 ** 2 * 12


def test_per_device_extents_follow_the_mesh():
    task = _task("llama_125m_lm")
    four = M.plan_train_memory(task, _tokens(32, 2048), "adamw",
                               {"data": 4})
    one = M.plan_train_memory(task, _tokens(8, 2048), "adamw")
    assert four["per_device_batch"] == 8
    assert four["activation_bytes_per_device"] == \
        one["activation_bytes_per_device"]
    seq = M.plan_train_memory(task, _tokens(8, 2048), "adamw", {"seq": 2})
    assert seq["per_device_seq"] == 1024


def test_encoders_and_vision_are_covered():
    bert = M.plan_train_memory(_task("bert_base_mlm"),
                               {"input_ids": np.zeros((256, 128), np.int32)})
    assert bert["activation_bytes_per_device"] > 0
    vit = M.plan_train_memory(
        _task("vit_b16_imagenet"),
        {"image": np.zeros((256, 224, 224, 3), np.float32)})
    assert vit["per_device_seq"] == 196
    wmt = M.plan_train_memory(_task("transformer_big_wmt"),
                              {"inputs": np.zeros((64, 256), np.int32)})
    assert wmt["activation_bytes_per_device"] > 0


@pytest.mark.parametrize("name,reason", [
    ("moe_tiny_lm", "calibrated for dense decoders/encoders only"),
    ("resnet_tiny", "lacks num_layers/d_model dims"),
    ("mnist", "lacks num_layers/d_model dims"),
])
def test_uncovered_models_raise(name, reason):
    with pytest.raises(ValueError, match=reason):
        M.plan_train_memory(_task(name), _tokens(2, 16))


def test_uncovered_models_raise_as_jax_does():
    from tensorflow_train_distributed_tpu.models import registry as jreg
    from tensorflow_train_distributed_tpu.training.memory import (
        _model_dims as jax_dims,
    )

    with pytest.raises(ValueError) as ref:
        jax_dims(jreg.get_task("moe_tiny_lm"))
    with pytest.raises(ValueError) as got:
        M._model_dims(_task("moe_tiny_lm"))
    assert str(got.value).split(" — ")[0] == str(ref.value).split(" — ")[0]


class _Allocations(TorchDispatchMode):
    """Records the devices of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.devices |= {t.device.type for t in tree_flatten(out)[0]
                         if isinstance(t, torch.Tensor)}
        return out


def test_llama2_7b_full_fine_tune_refused_allocating_nothing():
    task = _task("llama2_7b_sft")
    spy = _Allocations()
    with spy:
        plan = M.plan_train_memory(task, _tokens(2, 4096), "adamw",
                                   device_name=H100)
    assert spy.devices <= {"meta"}
    assert plan["param_elements"] == 6_738_415_616
    assert plan["state_bytes_per_device"] == 16 * 6_738_415_616
    assert plan["state_bytes_per_device"] > M.hbm_budget_bytes(H100)
    assert plan["fits"] is False


# -- bench_lm's guard ---------------------------------------------------------


def test_bench_lm_guard_counts_activations(capsys):
    """llama_125m at b 192 x 2048: its state (2.0 GiB) fits, its step's
    logits do not; the refusal names the activations.  Without a task the
    same run passes on its state alone."""
    task = _task("llama_125m_lm")
    budget = M.hbm_budget_bytes(H100)
    n = 134_105_856
    bench_lm.check_hbm_budget(n, budget_bytes=budget, force=False)
    with pytest.raises(SystemExit) as e:
        bench_lm.check_hbm_budget(n, budget_bytes=budget, force=False,
                                  task=task, batch=192, seq=2048)
    assert e.value.code == 2
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["activation_gib"] > rec["budget_gib"] > rec["state_gib"]
    assert rec["activations"].startswith("counted")
    # Where the planner does not cover the model, the state alone.
    with pytest.raises(SystemExit):
        bench_lm.check_hbm_budget(10 ** 12, budget_bytes=budget,
                                  force=False, task=_task("moe_tiny_lm"),
                                  batch=2, seq=16)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["activation_gib"] is None
    assert "dense decoders/encoders only" in rec["activations"]
    bench_lm.check_hbm_budget(n, budget_bytes=budget, force=False,
                              task=task, batch=8, seq=2048)


# -- the calibration tool -----------------------------------------------------


def test_calibration_points_are_the_pinned_ones():
    from tensorflow_train_distributed_torch.tools import memory_calibration

    assert [p[:5] for p in CARD_POINTS] == list(memory_calibration.POINTS)


def test_calibration_fit_recovers_the_coefficients():
    """Peaks made from the model's own terms under the module's
    coefficients fit back to those coefficients."""
    from tensorflow_train_distributed_torch.tools import memory_calibration

    records = []
    for name, layers, b, s, remat, measured, _ in CARD_POINTS:
        rec = dict(config=name, layers=layers, batch=b, seq=s, remat=remat,
                   peak_fit=measured * GIB)
        plan = memory_calibration.plan(rec)
        t = plan["activation_terms"]
        rec["peak_fwd_bwd"] = (
            plan["state_bytes_per_device"] - plan["grad_bytes_per_device"]
            + plan["weight_copy_bytes_per_device"]
            + M.HEAD_BYTES_PER_LOGIT * t["head"]
            + M.REMAT_INPUT_SCALE * t["remat"] + M.BLOCK_SCALE * t["block"])
        records.append(rec)
    got = memory_calibration.fit(records)
    assert got["head_bytes_per_logit"] == pytest.approx(
        M.HEAD_BYTES_PER_LOGIT, rel=1e-9)
    assert got["remat_input_scale"] == pytest.approx(M.REMAT_INPUT_SCALE,
                                                     rel=1e-9)
    assert got["block_scale"] == pytest.approx(M.BLOCK_SCALE, rel=1e-9)
    assert [p["plan_gib"] for p in got["points"]] == pytest.approx(
        [p[6] for p in CARD_POINTS], abs=1e-3)


def test_calibration_needs_the_card(capsys, monkeypatch):
    from tensorflow_train_distributed_torch.tools import memory_calibration

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert memory_calibration.main([]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] is None and "no CUDA device" in rec["error"]
