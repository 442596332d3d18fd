"""Expert parallelism: K6's ``group_offset`` (``ops.kernels.gmm`` /
``tgmm`` and their plain versions) against megablox in interpret mode,
and the expert-parallel MoE block and trainer over gloo against the
unsharded port.

Interpret-mode megablox is slow, so its shapes stay at m <= 256 and E
<= 4 (``tests/test_torch_moe_kernels.py``'s limits).  Tolerances: f32
values within 1e-5 of megablox (the same sums in another order) and
gradients within 1e-4 abs / 1e-3 rel, as that file holds them; rows
outside the shard exactly 0; the shards' outputs summed equal the
unsharded output bit for bit (each row is one shard's product plus
zeros), and each shard's tgmm equals its slice of the unsharded one bit
for bit.  The expert-parallel block and trainer: within 2e-5 of the
unsharded (the tokens' gradient is summed over the expert ranks in
another order).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from tensorflow_train_distributed_torch.models import moe
from tensorflow_train_distributed_torch.models import registry as treg
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.runtime import mesh as tmesh
from tensorflow_train_distributed_torch.testing import MultiProcessRunner

_MB = "jax.experimental.pallas.ops.tpu.megablox"
M, KD, N, SIZES = 256, 64, 96, [100, 0, 28, 128]


def _megablox():
    try:
        ops = importlib.import_module(_MB + ".ops")
    except ImportError:
        pytest.skip("megablox unavailable")
    return ops, ops.backend


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _rows(group):
    """The rows of ``group`` in SIZES."""
    start = sum(SIZES[:group])
    return slice(start, start + SIZES[group])


# (offset, local groups): the first group, an empty one alone, an odd
# offset over an empty and a ragged group, the last two (the pad's).
SHARDS = [(0, 1), (1, 1), (1, 2), (2, 2)]


@pytest.mark.parametrize("offset,local", SHARDS)
def test_gmm_group_offset_matches_megablox(offset, local):
    ops, _ = _megablox()
    lhs, rhs = _rand((M, KD)), _rand((4, KD, N), 1)
    gs = np.asarray(SIZES, np.int32)
    shard = rhs[offset:offset + local]
    want = np.asarray(ops.gmm(
        jnp.asarray(lhs), jnp.asarray(shard), jnp.asarray(gs),
        preferred_element_type=jnp.float32, interpret=True,
        group_offset=jnp.asarray(offset, jnp.int32)))
    got = K.gmm(_t(lhs), _t(shard), torch.from_numpy(gs),
                group_offset=offset).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    local_rows = np.zeros(M, bool)
    for g in range(offset, offset + local):
        local_rows[_rows(g)] = True
    assert not got[~local_rows].any()
    assert not want[~local_rows].any()


@pytest.mark.parametrize("offset,local", SHARDS)
def test_tgmm_group_offset_matches_megablox(offset, local):
    _, backend = _megablox()
    x, g = _rand((M, KD), 5), _rand((M, N), 6)
    gs = np.asarray(SIZES, np.int32)
    want = np.asarray(backend.tgmm(
        jnp.asarray(x).T, jnp.asarray(g), jnp.asarray(gs), jnp.float32,
        group_offset=jnp.asarray(offset, jnp.int32),
        num_actual_groups=local, interpret=True))
    got = K.tgmm(_t(x).t(), _t(g), torch.from_numpy(gs),
                 group_offset=offset, num_actual_groups=local).numpy()
    assert got.shape == (local, KD, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = K.tgmm(_t(x).t(), _t(g), torch.from_numpy(gs)).numpy()
    np.testing.assert_array_equal(got, full[offset:offset + local])


@pytest.mark.parametrize("local", [1, 2])
@pytest.mark.parametrize("transpose", [False, True])
def test_shards_sum_to_the_unsharded_gmm_bit_for_bit(local, transpose):
    lhs = _t(_rand((M, KD), 2))
    rhs = _t(_rand((4, N, KD) if transpose else (4, KD, N), 3))
    gs = torch.tensor(SIZES, dtype=torch.int32)
    full = K.gmm(lhs, rhs, gs, transpose_rhs=transpose)
    parts = [K.gmm(lhs, rhs[e0:e0 + local].contiguous(), gs,
                   transpose_rhs=transpose, group_offset=e0)
             for e0 in range(0, 4, local)]
    assert torch.equal(sum(parts[1:], parts[0]), full)
    # group_offset=None is the call without it.
    assert torch.equal(K.gmm(lhs, rhs, gs, transpose_rhs=transpose,
                             group_offset=None), full)


def test_gmm_vjp_with_group_offset_matches_megablox():
    """``_GmmFn``'s backward passes the offset to both products: grad_lhs
    zero off the shard's rows, grad_rhs over its local groups."""
    ops, _ = _megablox()
    lhs, rhs, cot = _rand((M, KD), 7), _rand((4, KD, N), 8), _rand((M, N), 9)
    gs = np.asarray(SIZES, np.int32)
    off, local = 2, 2

    def f(a, b):
        out = ops.gmm(a, b, jnp.asarray(gs),
                      preferred_element_type=jnp.float32, interpret=True,
                      group_offset=jnp.asarray(off, jnp.int32))
        return jnp.sum(out * cot)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs),
                                       jnp.asarray(rhs[off:off + local]))
    tl, tr = _t(lhs, True), _t(rhs[off:off + local], True)
    K.gmm(tl, tr, torch.from_numpy(gs), group_offset=off).backward(_t(cot))
    for got, w in ((tl.grad, want[0]), (tr.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-3)
    assert not tl.grad[:sum(SIZES[:off])].any()


def test_group_offset_argument_checks():
    lhs, gs = torch.zeros(8, 4), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="group_offset"):
        K._gmm_checks("gmm", lhs, torch.zeros(2, 4, 3), gs, False, 3)
    assert K._gmm_checks("gmm", lhs, torch.zeros(2, 4, 3), gs, False,
                         2) == (8, 4, 3)
    with pytest.raises(ValueError, match="do not lie"):
        K._local_groups(gs, 3, 2)
    assert K._local_groups(gs, None, None) == (0, 4)
    assert K._local_groups(gs, 1, None) == (1, 3)


def _block_inputs(seed=0):
    cfg = treg.get_entry("moe_tiny_lm_gmm")["config"]
    block, full = W.expert_block(cfg, seed)
    block.load_state_dict({k: v.clone() for k, v in full.items()},
                          assign=True)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32))
    return cfg, block, full, x


def test_routed_rows_decompose_over_expert_shards():
    """One process playing the expert group (what the card's phase 25(b)
    runs at moe_370m's width): ``expert_rows`` with E/4 experts a shard
    (``group_offset``), the rows summed over the shards where the
    expert-parallel path all-reduces them, then ``combine_rows``: the
    unsharded ``_routed_ffn_rows``' output bit for bit; the stacks'
    gradients each shard's slice bit for bit; the tokens' gradient (the
    shards' contributions summed by autograd, as the expert group's
    backward all-reduce sums them) within 1e-6."""
    cfg, block, full, x = _block_inputs(1)
    flat = x.reshape(-1, cfg.d_model).requires_grad_(True)
    probs = torch.softmax(block.router(flat), -1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = (top_p / top_p.sum(-1, keepdim=True)).detach()
    top_e = top_e.detach()
    stacks = [full[f"experts.{n}.kernel"].clone().requires_grad_(True)
              for n in ("wi_gate", "wi_up", "wo")]
    want = moe._routed_ffn_rows(flat, top_e, gate_w, cfg.num_experts,
                                *stacks, dtype=cfg.dtype)
    cot = torch.randn_like(want)
    want.backward(cot)
    e_local = cfg.num_experts // 4
    f = flat.detach().clone().requires_grad_(True)
    local = [[t.detach()[s * e_local:(s + 1) * e_local].clone()
              .requires_grad_(True) for t in stacks] for s in range(4)]
    outs = [moe.expert_rows(f, top_e, cfg.num_experts, *local[s],
                            dtype=cfg.dtype, group_offset=s * e_local)
            for s in range(4)]
    rows = sum((o for o, _ in outs[1:]), outs[0][0])
    got = moe.combine_rows(rows, outs[0][1], gate_w, dtype=cfg.dtype)
    assert torch.equal(got, want)
    got.backward(cot)
    for s in range(4):
        for t, lt in zip(stacks, local[s]):
            assert torch.equal(lt.grad,
                               t.grad[s * e_local:(s + 1) * e_local])
    torch.testing.assert_close(f.grad, flat.grad, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dispatch", ["gmm", "dense"])
def test_block_over_data_x_expert_gloo_ranks_matches_unsharded(dispatch,
                                                              tmp_path):
    """moe_tiny_lm_gmm's block (E 4, top-2) on data 2 × expert 2 gloo
    ranks: each rank its rows, its two experts; the output, the tokens'
    gradient and every weight's gradient against the unsharded block (as
    JAX's ``test_gmm_expert_sharded_matches_unsharded``)."""
    out = str(tmp_path / "ep.npz")
    MultiProcessRunner("_torch_dist_workers:moe_block_ep", 4, timeout=90,
                       payload=dict(mesh=dict(data=2, expert=2), seed=3,
                                    out=out, dispatch=dispatch)).run()
    got = np.load(out)
    cfg = dataclasses.replace(
        treg.get_entry("moe_tiny_lm_gmm")["config"], dispatch=dispatch)
    block, full = W.expert_block(cfg, 3)
    block.load_state_dict({k: torch.from_numpy(got[f"param.{k}"])
                           for k in full}, assign=True)
    x = torch.from_numpy(got["x"]).requires_grad_(True)
    y, _, _ = block(x)
    (y.float() ** 2).sum().backward()
    np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got["dx"], x.grad.numpy(), rtol=2e-5,
                               atol=2e-5)
    for k, p in block.named_parameters():
        np.testing.assert_allclose(got[f"grad.{k}"], p.grad.numpy(),
                                   rtol=2e-5, atol=2e-5, err_msg=k)


def test_expert_parallel_refusals():
    cfg = treg.get_entry("moe_tiny_lm_gmm")["config"]
    three = tmesh.Mesh(dict(pipeline=1, data=1, fsdp=1, expert=3, seq=1,
                            tensor=1), 0)
    with pytest.raises(ValueError, match="not divisible by the expert"):
        moe.set_expert_parallel(moe.MoEMlpBlock(cfg, device="meta"), three)
    ep_tp = tmesh.Mesh(dict(pipeline=1, data=1, fsdp=1, expert=2, seq=1,
                            tensor=2), 0)
    with pytest.raises(ValueError, match="expert×tensor"):
        moe.set_expert_parallel(moe.MoEMlpBlock(cfg, device="meta"), ep_tp)
    dense = dataclasses.replace(cfg, dispatch="dense")
    block = moe.MoEMlpBlock(dense, device="meta")
    one = tmesh.Mesh({a: 1 for a in tmesh.AXES}, 0)
    assert moe.set_expert_parallel(block, one) == 0
    assert block.expert_parallel is None


def test_trainer_under_dp_ep_matches_single_process(tmp_path):
    """moe_tiny_lm_gmm, 5 steps (sgd, clip 1, f32) on expert 2 gloo
    ranks (the dp_ep preset shrunk to two ranks): the losses and the
    gathered params against one process."""
    trainer = W.make_llama_trainer(None, config="moe_tiny_lm_gmm",
                                   optimizer="sgd", lr=0.3)
    state = trainer.create_state()
    init = {k: v.detach().numpy().copy() for k, v in state.params.items()}
    state, hist = trainer.fit(W.llama_batches(5, 16), steps=5, state=state)
    npz = str(tmp_path / "init.npz")
    np.savez(npz, **init)
    out = str(tmp_path / "out.npz")
    res = MultiProcessRunner(
        "_torch_dist_workers:train_llama", 2, timeout=120,
        payload=dict(mesh=dict(data=1, expert=2), steps=5, out=out,
                     params_npz=npz, config="moe_tiny_lm_gmm",
                     optimizer="sgd", lr=0.3)).run()
    loss = [m["loss"] for _, m in res[0].value["history"]]
    np.testing.assert_allclose(loss, [m["loss"] for _, m in hist], rtol=0,
                               atol=2e-5)
    with np.load(out) as f:
        for k, p in state.params.items():
            np.testing.assert_allclose(f[k], p.detach().numpy(), rtol=1e-3,
                                       atol=2e-5, err_msg=k)
