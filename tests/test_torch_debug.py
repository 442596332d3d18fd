"""Debug mode over the port (``runtime/debug.py``) against the JAX
package's ``runtime/debug.py`` on the CPU.

- a non-finite value planted in the forward and one in the backward each
  raise ``FloatingPointError`` naming the op that produced it; one a
  hand-written kernel writes (through the kernel wrappers' autograd
  Functions, their launches stood in by plain math that counts as the
  kernels do) names the kernel, forward and backward;
- a clean trainer step is bit for bit the same with debug mode and
  without it, and debug mode restores every setting on exit, after an
  exception too;
- ``assert_tree_finite`` lists the leaves and counts JAX's lists, on a
  tree carried across by the weight converter; ``is_finite_scalar``
  answers as JAX's;
- ``TerminateOnNaN`` stops ``fit`` and no checkpoint is written after
  the poisoned step.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.runtime import debug as jdebug
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.data.datasets import SyntheticLM
from tensorflow_train_distributed_torch.data.pipeline import HostBatches
from tensorflow_train_distributed_torch.models import llama as TLL
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.runtime import debug as tdebug
from tensorflow_train_distributed_torch.training import callbacks as tcb
from tensorflow_train_distributed_torch.training import optimizers as topt
from tensorflow_train_distributed_torch.training.checkpoint import (
    CheckpointManager,
)
from tensorflow_train_distributed_torch.training.mixed_precision import Policy
from tensorflow_train_distributed_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)

NAN = float("nan")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(**kw):
    return Trainer(TLL.CausalLmTask(TLL.LLAMA_PRESETS["llama_tiny"],
                                    device="meta"),
                   topt.make_optimizer("adamw", 1e-3),
                   policy=Policy.from_name("float32"), device="cpu",
                   config=TrainerConfig(log_every=1, **kw.pop("config", {})),
                   **kw)


def _batches():
    return HostBatches(SyntheticLM(num_examples=64, seq_len=16,
                                   vocab_size=256), 8)


# -- the trap at the op ------------------------------------------------------


def test_forward_plant_names_the_op():
    x = torch.linspace(-1.0, 1.0, 8, requires_grad=True)
    zero = x - x
    with pytest.raises(FloatingPointError,
                       match=r"aten\.div\.Tensor produced 8 non-finite "
                             r"values in output 0 \(8,\)"):
        with tdebug.debug_mode():
            zero / zero
    # Carried along, a non-finite input is not the op's doing.
    with tdebug.debug_mode():
        y = torch.full((4,), NAN) * 2.0
    assert torch.isnan(y).all()


def test_backward_plant_names_the_op_and_its_node():
    x = torch.zeros(3, requires_grad=True)
    with tdebug.debug_mode():
        y = torch.sqrt(x).sum()        # finite forward: sqrt(0) = 0
        with pytest.raises(FloatingPointError,
                           match=r"non-finite values .* in the backward of "
                                 r"SqrtBackward0"):
            y.backward()


def test_backward_nan_node_raises_floating_point_error():
    """A node returning NaN that no aten op produced (a Function's own
    planted gradient) is caught by anomaly mode, as FloatingPointError."""
    planted = torch.full((3,), NAN)

    class Poison(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return planted

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(FloatingPointError,
                       match="PoisonBackward' returned nan values"):
        with tdebug.debug_mode():
            Poison.apply(x).sum().backward()


# -- the trap at the hand-written kernels ------------------------------------


@pytest.fixture()
def stand_in_kernels(monkeypatch):
    """K1f/K1b launches stood in by plain math that counts as the kernels
    do; ``plant`` holds an output one of them returns instead."""
    plant = {}

    def fwd(x2, scale, epsilon, with_r, body=None):
        y = K.rms_norm_reference(x2, scale, epsilon=epsilon)
        r = torch.rsqrt(x2.float().square().mean(-1) + epsilon)
        y = plant.get("rms_norm", y)
        K._count("rms_norm", (x2, scale), (y, r))
        return y, r

    def bwd(x2, scale, r, g, *, with_ds=True, body=None):
        dx, ds = K.rms_norm_backward_reference(x2, scale, r, g)
        dx = plant.get("rms_norm_bwd", dx)
        K._count("rms_norm_bwd", (x2, scale, r, g), (dx, ds))
        return dx, ds

    monkeypatch.setattr(K, "_on_cpu", lambda name, *ts: False)
    monkeypatch.setattr(K, "rms_norm_forward", fwd)
    monkeypatch.setattr(K, "rms_norm_backward", bwd)
    return plant


def _norm_inputs():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, generator=gen).requires_grad_()
    scale = (1.0 + 0.1 * torch.randn(64, generator=gen)).requires_grad_()
    return x, scale


def test_kernel_forward_plant_names_the_kernel(stand_in_kernels):
    x, scale = _norm_inputs()
    stand_in_kernels["rms_norm"] = torch.full((4, 64), NAN)
    K.reset_launch_counts()
    with pytest.raises(FloatingPointError,
                       match="the rms_norm kernel wrote 256 non-finite"):
        with tdebug.debug_mode():
            K.rms_norm(x, scale)
    assert K.launch_counts()["rms_norm"] == 1
    # Outside debug mode the same launch traps nothing.
    y = K.rms_norm(x, scale)
    assert torch.isnan(y).all() and K.launch_counts()["rms_norm"] == 2


def test_kernel_backward_plant_names_the_kernel(stand_in_kernels):
    x, scale = _norm_inputs()
    bad = torch.zeros(4, 64)
    bad[1, 3] = NAN
    stand_in_kernels["rms_norm_bwd"] = bad
    with tdebug.debug_mode():
        loss = K.rms_norm(x, scale).square().sum()
        with pytest.raises(FloatingPointError,
                           match=r"the rms_norm_bwd kernel wrote 1 "
                                 r"non-finite values to output 0"):
            loss.backward()


def test_kernel_input_poison_names_the_first_kernel_it_reaches(
        stand_in_kernels):
    """A poisoned value no op produced (a parameter's) passes the aten ops
    that carry it and stops at the first kernel."""
    x, scale = _norm_inputs()
    w = torch.eye(64)
    w[7, :] = NAN
    with pytest.raises(FloatingPointError,
                       match=r"the rms_norm kernel received 256 non-finite "
                             r"values in input 0 \(4, 64\)"):
        with tdebug.debug_mode():
            K.rms_norm(x @ w, scale)


def test_every_training_kernel_passes_its_tensors_to_the_trap():
    """Each training kernel's launch hands ``_count`` its inputs and
    outputs (the trap has nothing to check otherwise)."""
    import inspect

    src = inspect.getsource(K)
    for name in ("rms_norm", "rms_norm_bwd", "cross_entropy",
                 "cross_entropy_bwd", "flash_attention",
                 "flash_attention_bwd", "splash_attention",
                 "splash_attention_bwd"):
        assert f'_count("{name}", (' in src, name


# -- a clean step, and the settings debug mode touches -----------------------


def test_clean_step_is_bitwise_the_same_under_debug_mode():
    runs = []
    for debug in (False, True, False):
        tr = _trainer()
        state = tr.create_state()
        if debug:
            with tdebug.debug_mode():
                state, hist = tr.fit(_batches(), steps=2, state=state)
        else:
            state, hist = tr.fit(_batches(), steps=2, state=state)
        runs.append(([m["loss"] for _, m in hist],
                     {k: v.detach().clone() for k, v in state.params.items()}))
    for losses, params in runs[1:]:
        assert losses == runs[0][0]
        for k, v in params.items():
            assert torch.equal(v, runs[0][1][k]), k


def _settings():
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    return (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
            K.NAN_TRAP, torch.are_deterministic_algorithms_enabled(),
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            _get_current_dispatch_mode())


def test_debug_mode_restores_its_settings(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = _settings()
    assert before[0] is False and before[2:] == (None, False, None, None)
    with tdebug.debug_mode(disable_optimizations=True):
        inside = _settings()
        assert inside[:5] == (True, True, tdebug.trap_launch, True,
                              ":4096:8")
        assert inside[5] is not None
    assert _settings() == before
    with pytest.raises(FloatingPointError):
        with tdebug.debug_mode(disable_optimizations=True):
            zero = torch.zeros(2)
            zero / zero
    assert _settings() == before
    with pytest.raises(KeyError):
        with tdebug.debug_mode():
            raise KeyError("not numerics")
    assert _settings() == before
    # A caller's own workspace setting survives; nan_checks=False leaves
    # the traps off.
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with tdebug.debug_mode(nan_checks=False, disable_optimizations=True):
        inside = _settings()
        assert inside[:2] == before[:2]
        assert inside[2:5] == (None, True, ":16:8")
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"


def test_disable_optimizations_step_is_repeatable_bit_for_bit():
    """Two trainer steps under ``disable_optimizations=True`` give the same
    loss and parameters bit for bit, and the same as without it."""
    runs = []
    for flag in (True, True, False):
        tr = _trainer()
        state = tr.create_state()
        with tdebug.debug_mode(nan_checks=False, disable_optimizations=flag):
            state, hist = tr.fit(_batches(), steps=1, state=state)
        runs.append(([m["loss"] for _, m in hist],
                     {k: v.detach().clone() for k, v in state.params.items()}))
    for losses, params in runs[1:]:
        assert losses == runs[0][0]
        for k, v in params.items():
            assert torch.equal(v, runs[0][1][k]), k


def test_disable_optimizations_warns_once_cuda_is_initialised(monkeypatch):
    """The workspace variable set after CUDA is initialised cannot change
    cuBLAS's workspace: debug mode says so; set before, it does not."""
    import warnings

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.warns(RuntimeWarning, match="before the process starts"):
        with tdebug.debug_mode(nan_checks=False, disable_optimizations=True):
            pass
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with tdebug.debug_mode(nan_checks=False, disable_optimizations=True):
            pass


# -- post-hoc checks ---------------------------------------------------------


def _jax_llama_tiny_params():
    from flax import linen as fnn

    from tensorflow_train_distributed_tpu.models import llama as JL

    task = JL.CausalLmTask(JL.LLAMA_PRESETS["llama_tiny"])
    batch = {"tokens": np.zeros((2, 16), np.int32),
             "targets": np.zeros((2, 16), np.int32)}
    variables = task.init_variables(jax.random.key(0), batch)
    return jax.device_get(fnn.unbox(variables["params"]))


def test_assert_tree_finite_lists_jax_leaves_and_counts():
    params = _jax_llama_tiny_params()
    flat = {k: np.array(v) for k, v in traverse_util.flatten_dict(
        params, sep="/").items()}
    keys = sorted(flat)
    flat[keys[1]].reshape(-1)[:3] = np.nan
    flat[keys[4]].reshape(-1)[5] = np.inf
    flat[keys[-1]].reshape(-1)[-7:] = -np.inf
    with pytest.raises(FloatingPointError) as jerr:
        jdebug.assert_tree_finite(traverse_util.unflatten_dict(
            flat, sep="/"), "params")
    cfg = TLL.LLAMA_PRESETS["llama_tiny"]
    ported = convert.params_from_flax(flat, cfg)
    with pytest.raises(FloatingPointError) as terr:
        tdebug.assert_tree_finite(ported, "params")
    jlines = str(jerr.value).splitlines()
    tlines = str(terr.value).splitlines()
    assert jlines[0] == tlines[0] == "params has non-finite values:"
    counts = lambda lines: sorted(l.rsplit(": ", 1)[1] for l in lines[1:])
    assert counts(tlines) == counts(jlines) == sorted(
        ["3/%d non-finite" % flat[keys[1]].size,
         "1/%d non-finite" % flat[keys[4]].size,
         "7/%d non-finite" % flat[keys[-1]].size])
    bad = sorted(k for k, v in ported.items() if not torch.isfinite(v).all())
    assert sorted(l.strip().rsplit(": ", 1)[0] for l in tlines[1:]) == bad
    # A module's state_dict paths, and a clean tree.
    model = TLL.LlamaModel(cfg)
    model.load_state_dict(ported)
    with pytest.raises(FloatingPointError, match=bad[0]):
        tdebug.assert_tree_finite(model, "model")
    tdebug.assert_tree_finite({"a": [torch.ones(2), torch.arange(3)]})


@pytest.mark.parametrize("value", [
    0, 3, -2.5, 1e308, float("nan"), float("inf"), -float("inf"),
    np.float32(np.nan), np.float16(1.0), np.int64(7), "abc", None,
    [1.0], True,
])
def test_is_finite_scalar_matches_jax(value):
    assert tdebug.is_finite_scalar(value) == jdebug.is_finite_scalar(value)


def test_is_finite_scalar_on_tensors():
    assert tdebug.is_finite_scalar(torch.tensor(2.0))
    assert not tdebug.is_finite_scalar(torch.tensor(NAN))
    assert not tdebug.is_finite_scalar(np.array(np.inf))
    assert math.isnan(float(torch.tensor(NAN)))


def test_terminate_on_nan_stops_fit_and_vetoes_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=10)
    tr = _trainer(callbacks=[tcb.TerminateOnNaN()], checkpoint_manager=mgr,
                  config={"checkpoint_every": 1})
    state, hist = tr.fit(_batches(), steps=2)
    assert mgr.all_steps() == [1, 2] and not tr.state_poisoned
    with torch.no_grad():       # a row every token's query reads
        state.params["layers.0.attention.query.kernel"][0, :] = NAN
    state, hist = tr.fit(_batches(), steps=4, state=state)
    assert [s for s, _ in hist] == [3]
    assert math.isnan(hist[0][1]["loss"])
    assert tr.state_poisoned
    assert mgr.all_steps() == [1, 2]
