"""Weights carried from flax trees (both layer layouts) into the port."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tensorflow_train_distributed_tpu.models.llama import (
    LLAMA_PRESETS as JAX_PRESETS,
    LlamaModel as JaxLlama,
)
from tensorflow_train_distributed_torch import convert
from tensorflow_train_distributed_torch.models.llama import (
    LLAMA_PRESETS as TORCH_PRESETS,
)


def _flat(name, **knobs):
    cfg = dataclasses.replace(JAX_PRESETS[name], **knobs)
    params = JaxLlama(cfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 4), jnp.int32))["params"]
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        fnn.unbox(params), sep="/").items()}


@pytest.mark.parametrize("name", ["llama_tiny", "llama_tiny_scan"])
def test_tree_converts_to_every_port_parameter(name):
    flat = _flat(name)
    cfg = TORCH_PRESETS[name]
    params = convert.params_from_flax(flat, cfg)
    assert {k: tuple(v.shape) for k, v in params.items()} == (
        convert.expected_shapes(cfg))
    scanned = JAX_PRESETS[name].scan_layers
    layer1 = ("layers/stack/block/mlp/wo/kernel" if scanned
              else "layer_1/mlp/wo/kernel")
    want = flat[layer1][1] if scanned else flat[layer1]
    assert torch.equal(params["layers.1.mlp.wo.kernel"],
                       torch.from_numpy(np.array(want)))
    assert torch.equal(params["lm_head.kernel"],
                       torch.from_numpy(np.array(flat["lm_head/kernel"])))


def test_scanned_and_unrolled_give_one_layout():
    scan = _flat("llama_tiny_scan")
    unrolled = {}
    for k, v in scan.items():
        if k.startswith("layers/stack/block/"):
            for i in range(v.shape[0]):
                unrolled[f"layer_{i}/" + k[len("layers/stack/block/"):]] = v[i]
        else:
            unrolled[k] = v
    a = convert.params_from_flax(scan, TORCH_PRESETS["llama_tiny_scan"])
    b = convert.params_from_flax(unrolled, TORCH_PRESETS["llama_tiny"])
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_fused_qkv_bias_tree_converts():
    flat = _flat("llama_tiny", fused_qkv=True, qkv_bias=True)
    cfg = dataclasses.replace(TORCH_PRESETS["llama_tiny"], fused_qkv=True,
                              qkv_bias=True)
    params = convert.params_from_flax(flat, cfg)
    assert "layers.0.attention.qkv.bias" in params


@pytest.mark.parametrize("edit,match", [
    ("drop", "missing"), ("add", "extra"), ("reshape", "shape")])
def test_tree_mismatch_raises(edit, match):
    flat = _flat("llama_tiny")
    if edit == "drop":
        del flat["layer_0/attention/key/kernel"]
    elif edit == "add":
        flat["layer_0/attention/extra/kernel"] = np.zeros((2, 2), np.float32)
    else:
        flat["final_norm/scale"] = np.ones((3,), np.float32)
    with pytest.raises(ValueError, match=match):
        convert.params_from_flax(flat, TORCH_PRESETS["llama_tiny"])


def test_scanned_leaf_with_wrong_depth_raises():
    flat = _flat("llama_tiny_scan")
    key = "layers/stack/block/attn_norm/scale"
    flat[key] = flat[key][:1]
    with pytest.raises(ValueError, match="leading axis"):
        convert.params_from_flax(flat, TORCH_PRESETS["llama_tiny_scan"])


def test_load_npz_round_trip(tmp_path):
    flat = _flat("llama_tiny")
    np.savez(tmp_path / "p.npz", **flat)
    a = convert.load_npz(str(tmp_path / "p.npz"), TORCH_PRESETS["llama_tiny"])
    b = convert.params_from_flax(flat, TORCH_PRESETS["llama_tiny"])
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_bf16_leaves_convert_exactly():
    flat = {k: v.astype(jnp.bfloat16) for k, v in _flat("llama_tiny").items()}
    params = convert.params_from_flax(flat, TORCH_PRESETS["llama_tiny"])
    k = "layers.0.mlp.wi_up.kernel"
    assert params[k].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params[k].float().numpy(),
        flat["layer_0/mlp/wi_up/kernel"].astype(np.float32))


def test_init_params_seeded_and_shaped():
    cfg = TORCH_PRESETS["llama_tiny"]
    a = convert.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu", dtype=torch.bfloat16)
    b = convert.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu", dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in a.items()} == (
        convert.expected_shapes(cfg))
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["final_norm.scale"],
                       torch.ones(cfg.d_model, dtype=torch.bfloat16))


def test_init_params_starts_zero_centered_norm_scales_at_zero():
    """A zero-centered norm (Gemma) computes x̂·(1 + scale): its scales
    start at 0, every other norm's at 1."""
    cfg = dataclasses.replace(TORCH_PRESETS["llama_tiny"],
                              norm_zero_centered=True)
    p = convert.init_params(cfg, torch.Generator().manual_seed(1),
                            device="cpu")
    scales = [v for k, v in p.items() if k.endswith(".scale")]
    assert scales and not any(v.any() for v in scales)
