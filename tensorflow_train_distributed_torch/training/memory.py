"""Device tables and memory planning: the card's peak rates and memory,
the exact bytes of the train state, and an activation model calibrated on
an H100 (the counterpart of the JAX package's ``training/memory.py``).

One table for the port: the bench tools (``tools/``), the runtime lint's
mfu/mbu peaks (``runtime/lint/compilecheck.py``) and ``chip_smoke.py``
read it.  Keys are substrings of the lower-cased device name
(``torch.cuda.get_device_name``); a name the table does not know gives
None, and so does the CPU.

The rates are NVIDIA's data sheet for the H100 SXM at its full 700-W
limit, dense (no sparsity): 989 TFLOP/s bf16 on the tensor cores, 495
TF32, 67 f32 outside them; 3.35 TB/s of HBM3 and 80 GB of it.  A card
set below 700 W (``nvidia-smi``'s ``power.limit``) runs slower under
load; the tools print the limit beside every figure.

**The plan.**  ``plan_state_memory`` counts the parameter, gradient and
optimizer-state tensors exactly (built on the ``meta`` device: nothing is
allocated) and divides them as the port shards them on a mesh.
``plan_train_memory`` adds the activations of ``decoder_activation_bytes``
and the optimizer update's temporaries, and says whether the step fits
the card.  A training step's peak is the largest of three moments:

1. the head's backward: parameters and optimizer state, and every
   activation the backward still needs, the [tokens, vocab] f32 logits
   and their f32 gradient above all (no weight gradient exists yet);
2. the backward's end: the whole state, gradients included;
3. the optimizer's update: the state and the update's temporaries (the
   port's optax-style update builds new moment and update lists before
   the old ones are freed: 20 bytes a trainable parameter under adamw).

**The calibration** (``tools/memory_calibration.py`` on an NVIDIA H100
80GB HBM3 at 700.00 W: ``torch.cuda.max_memory_allocated`` above what
the process held before, over a forward and backward and over 2
``Trainer.fit`` steps, adamw, bf16 compute over f32 parameters, random
weights from seed 0).  Points, with the step's measured peak and the
plan's estimate:

====================================  ========  =====  ==========  ========
config                                b x s      remat  peak GiB    estimate
====================================  ========  =====  ==========  ========
llama_125m_lm (12 layers, d 768)      8 x 2048  full     5.858       5.968
llama_125m_lm                         16 x 2048 full    10.035      10.345
llama_125m_lm                         8 x 2048  none    10.943      11.021
llama_125m_lm                         16 x 2048 none    20.163      20.293
llama_125m_lm                         4 x 2048  none     6.340       6.385
llama_125m_lm                         1 x 128   full     4.531       4.496
mistral_7b_lm, 4 layers (window)      8 x 8192  full    38.042      38.040
mistral_7b_lm, 2 layers               8 x 8192  full    25.708      25.683
mistral_7b_lm, 4 layers               1 x 1024  full    38.040      38.040
mistral_7b_lm, 1 layer                8 x 8192  none    32.935      32.774
mistral_7b_lm, 2 layers               4 x 8192  none    27.449      27.405
====================================  ========  =====  ==========  ========

The three activation coefficients are the tool's least-squares fit of
the forward-and-backward peaks over the resident state and the weights'
compute copies (``HEAD_BYTES_PER_LOGIT`` 8.41, ``REMAT_INPUT_SCALE``
0.964, ``BLOCK_SCALE`` 0.984); the update's 20 bytes a parameter are the
excess over the state of the two b 1 points, whose peak is the update
(36.3 and 36.0 bytes a parameter in all).  The worst estimate below a
measured peak is 0.76% (``PLAN_MARGIN`` is 3%).  The JAX package's
coefficients were fit on a TPU v5e to other tensors (per-head BERT
scores, 14 bytes of state a parameter): none of its figures is used
here.  Not calibrated on the card: f32 compute (BERT, the Transformer),
the dense path's [B, H, S, S] scores (ViT at 196/197 rows), and the
"dots" and "no_ffn" remat policies; their estimates follow the same
terms.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: Data-sheet figures by device-name substring: peak TFLOP/s by dtype,
#: HBM bytes/s and HBM bytes.
DEVICE_TABLE = {
    "h100": {"tflops": {"bf16": 989.0, "fp16": 989.0, "tf32": 495.0,
                        "f32": 67.0},
             "hbm_bytes_per_sec": 3.35e12,
             "hbm_bytes": 80e9},
}

#: The H100's row, for code that reasons about the card it was written
#: for (kernel bounds in ``tools/roofline.py`` and ``chip_smoke.py``).
H100 = DEVICE_TABLE["h100"]

#: Bytes of training state a parameter holds under the port's adam
#: recipe: the f32 master, its f32 gradient and two f32 moments (the
#: compute dtype's copy is cast per product and not kept).
STATE_BYTES_PER_PARAM = 16

#: The activation model's coefficients (the calibration above).
#: Bytes a [tokens, vocab] logit element holds at the head's backward.
HEAD_BYTES_PER_LOGIT = 8.41
#: A checkpointed block keeps its input, [tokens, d] in the compute dtype.
REMAT_INPUT_SCALE = 0.964
#: A block without remat keeps ``6·d + 2·kv + 4·ffn`` elements a token in
#: the compute dtype (its input, both norms' outputs, q and k after RoPE,
#: v, the attention output, the residual; a gated FFN's gate, up, act(gate)
#: and product; an ungated one's two), times this.
BLOCK_SCALE = 0.984
#: Bytes a trainable parameter adds during the optimizer's update, beyond
#: the state (measured under adamw; other optimizers are budgeted at it).
UPDATE_BYTES_PER_PARAM = 20
#: Bytes a dense-attention score element holds (the JAX model's six
#: score-sized temporaries at 2 bytes; not calibrated on the card).
DENSE_SCORE_BYTES = 12
#: How far below a measured peak an estimate may fall (the calibration's
#: worst is 0.76%); ``chip_smoke.py`` phase 29 holds the plan to it.
PLAN_MARGIN = 0.03


def _row(device_name: str) -> Optional[dict]:
    name = device_name.lower()
    for sub, row in DEVICE_TABLE.items():
        if sub in name:
            return row
    return None


def peak_tflops(device_name: str, dtype: str = "bf16") -> Optional[float]:
    """Dense peak TFLOP/s of ``dtype`` ("bf16", "fp16", "tf32", "f32") on
    the named card; None when unknown."""
    row = _row(device_name)
    return None if row is None else row["tflops"].get(dtype)


def hbm_bandwidth_bytes_per_sec(device_name: str) -> Optional[float]:
    row = _row(device_name)
    return None if row is None else row["hbm_bytes_per_sec"]


def hbm_budget_bytes(device_name: str) -> Optional[float]:
    """The card's memory by its data sheet; None when unknown."""
    row = _row(device_name)
    return None if row is None else row["hbm_bytes"]


# -- activations -------------------------------------------------------------


def activation_terms(num_layers: int, d_model: int, batch: int, seq: int,
                     *, remat, vocab: int, ffn_size: Optional[int] = None,
                     kv_width: Optional[int] = None, gated: bool = True,
                     compute_bytes: int = 2, logits_per_token: bool = True,
                     extra_layer_elements: int = 0) -> dict:
    """The activation model's three fitted terms, before their
    coefficients: ``head``, the [tokens, vocab] logit elements (a
    sequence's, not a token's, when ``logits_per_token`` is False: ViT);
    ``remat``, the bytes of the checkpointed blocks' inputs; ``block``, the
    bytes of the tensors autograd keeps for every block without remat
    (``BLOCK_SCALE``'s count).  Arguments as
    ``decoder_activation_bytes``'s."""
    ffn = ffn_size or 4 * d_model
    kv = d_model if kv_width is None else kv_width
    tokens = batch * seq
    block = (6 * d_model + 2 * kv + (4 if gated else 2) * ffn
             + extra_layer_elements)
    if remat == "no_ffn":
        block -= (4 if gated else 2) * ffn
    per_layer = tokens * compute_bytes * num_layers
    return {"head": (tokens if logits_per_token else batch) * vocab,
            "remat": per_layer * d_model if remat is True else 0,
            "block": 0 if remat is True else per_layer * block}


def decoder_activation_bytes(num_layers: int, d_model: int, batch: int,
                             seq: int, *, remat, vocab: int,
                             dense_heads: int = 0, causal: bool = True,
                             **kw) -> int:
    """Activations of one train step at its head's backward, in bytes:
    ``activation_terms`` under the calibrated coefficients.

    ``batch``/``seq`` are per-device extents (divide global dims by the
    mesh's batch and seq shard degrees first; ``plan_train_memory`` does).
    ``remat`` is True for full block remat, False for none, or "no_ffn"
    (the block's FFN hiddens recomputed).  K2 and K7 (flash and splash
    attention) keep o and lse alone, so the window changes time, not
    memory; ``dense_heads`` > 0 adds the dense path's [B, H, S, S] scores
    (``DENSE_SCORE_BYTES`` an element, halved when ``causal``), per layer,
    or one layer's under remat.  ``kw``: ``ffn_size``, ``kv_width``,
    ``gated``, ``compute_bytes``, ``logits_per_token`` and
    ``extra_layer_elements`` (``activation_terms``).
    """
    t = activation_terms(num_layers, d_model, batch, seq, remat=remat,
                         vocab=vocab, **kw)
    act = (HEAD_BYTES_PER_LOGIT * t["head"] + REMAT_INPUT_SCALE * t["remat"]
           + BLOCK_SCALE * t["block"])
    if dense_heads:
        scores = DENSE_SCORE_BYTES * dense_heads * batch * seq * seq
        scores //= 2 if causal else 1
        act += scores * (1 if remat is True else num_layers)
    return int(act)


def _model_dims(task) -> dict:
    """The activation model's inputs from a task (or a config).

    Decoders (Llama family, windowed ones included) run K2/K7; BERT and
    the Transformer run K2 in f32; ViT runs the dense path at its 196/197
    rows.  Raises for configs the model does not cover: a wrong estimate
    is worse than none (it green-lights a step that runs out of memory).
    """
    cfg = getattr(task, "config", task)
    if cfg is None or not hasattr(cfg, "__dataclass_fields__"):
        raise ValueError(
            f"{type(task).__name__} has no .config; pass explicit dims "
            "via decoder_activation_bytes instead")
    if hasattr(cfg, "num_experts"):
        raise ValueError(
            "the activation model is calibrated for dense decoders/"
            "encoders only — MoE adds [G,S,E,C] dispatch/combine tensors "
            "and expert buffers it has no term for, so an estimate here "
            "would green-light OOM compiles; budget MoE configs by a "
            "measured run instead")
    width = getattr(cfg, "d_model", None) or getattr(cfg, "hidden_size",
                                                     None)
    layers = getattr(cfg, "num_layers", None)
    extra = 0
    if layers is None and hasattr(cfg, "num_encoder_layers"):
        # The Transformer: its decoder blocks add cross-attention's query,
        # output and memory keys and values.
        layers = cfg.num_encoder_layers + cfg.num_decoder_layers
        extra = 4 * width * cfg.num_decoder_layers // max(layers, 1)
    if layers is None or width is None:
        raise ValueError(
            f"{type(cfg).__name__} lacks num_layers/d_model dims for the "
            "activation model")
    remat = bool(getattr(cfg, "remat", False))
    policy = getattr(cfg, "remat_policy", "full")
    if remat and policy == "no_ffn":
        remat = "no_ffn"
    elif remat and policy == "dots":
        remat = False       # the matmuls' outputs are saved: budget as none
    kv = width
    if getattr(cfg, "num_kv_heads", None):
        kv = cfg.num_kv_heads * (getattr(cfg, "head_dim", None)
                                 or width // cfg.num_heads)
    ffn = (getattr(cfg, "ffn_size", None)
           or getattr(cfg, "intermediate_size", None)
           or getattr(cfg, "mlp_dim", None))
    vision = hasattr(cfg, "patch_size")
    seq = None
    if vision:
        seq = cfg.num_patches + (1 if getattr(cfg, "pooling", "") == "cls"
                                 else 0)
    dtype = getattr(cfg, "dtype", torch.bfloat16)
    return {"num_layers": layers, "width": width, "remat": remat,
            "ffn_size": ffn, "kv_width": kv,
            "gated": hasattr(cfg, "rms_epsilon"),
            "causal": not (vision or hasattr(cfg, "intermediate_size")),
            "vocab": getattr(cfg, "vocab_size", None)
            or getattr(cfg, "num_classes"),
            "logits_per_token": not vision,
            "dense_heads": cfg.num_heads if vision else 0,
            "seq": seq, "extra_layer_elements": extra,
            "compute_dtype": dtype if dtype.is_floating_point
            else torch.bfloat16}


# -- the state ---------------------------------------------------------------


def _mesh_of(mesh):
    from tensorflow_train_distributed_torch.runtime.mesh import AXES, Mesh

    if mesh is None:
        return Mesh({a: 1 for a in AXES})
    if isinstance(mesh, dict):
        return Mesh({a: int(mesh.get(a, 1)) for a in AXES})
    return mesh


def _optimizer(optimizer):
    from tensorflow_train_distributed_torch.training import optimizers

    if isinstance(optimizer, str):
        return optimizers.make_optimizer(optimizer, 1e-3)
    return optimizer


def _tensor_leaves(node):
    """Every tensor of an optimizer state (lists, tuples, dicts and
    dataclasses)."""
    import dataclasses

    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensor_leaves(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensor_leaves(v)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            yield from _tensor_leaves(getattr(node, f.name))


def plan_state_memory(task, sample_batch=None, optimizer="adamw", mesh=None,
                      *, zero1: bool = False,
                      param_dtype: torch.dtype = torch.float32) -> dict:
    """Exact per-device bytes of the train state: parameters (in
    ``param_dtype``, the policy's), their gradients (trainable ones, f32),
    the optimizer's state (``optimizer``: a ``GradientTransformation`` or
    a ``make_optimizer`` name, initialised on the meta device as the
    trainer initialises it) and the model's buffers (BatchNorm's
    statistics).  ``sample_batch`` is not needed (the model's shapes are
    its own); it is taken for the JAX signature.

    On ``mesh`` (a ``runtime.mesh.Mesh``, or a dict of axis sizes) the
    counts are this rank's, as ``parallel.state_plan`` shards them: an
    expert stack's experts split over ``expert``; parameters and their
    gradients otherwise whole (the tensor and fsdp axes shard storage, not
    compute); the optimizer state on each rank's piece (split over fsdp
    and tensor, and over data under ``zero1``).  Nothing is allocated.
    Returns JAX's ``total_bytes`` (the whole job's state) and
    ``per_device_bytes``, and the counts by kind.
    """
    from tensorflow_train_distributed_torch.parallel import sharding as S

    del sample_batch
    mesh = _mesh_of(mesh)
    model = task.model
    named = dict(model.named_parameters())
    shapes = {k: tuple(p.shape) for k, p in named.items()}
    specs = S.make_state_shardings(mesh, shapes)
    ep = mesh.shape["expert"]
    local = {k: ((s[0] // ep,) + s[1:]
                 if ep > 1 and "expert" in (specs[k][0] or ()) else s)
             for k, s in shapes.items()}
    storage = {k: S.storage_axes(sp) for k, sp in specs.items()}
    if zero1:
        storage = S.zero1_opt_shardings(mesh, local, storage)

    def piece(k):
        shape = list(local[k])
        for d, axes in enumerate(storage[k]):
            if axes:
                shape[d] //= mesh.group_size(axes)
        return tuple(shape)

    psize = param_dtype.itemsize
    tx = _optimizer(optimizer)

    def opt_bytes(shape_of) -> tuple:
        """(elements, bytes) of the optimizer state over parameters of
        the shapes ``shape_of`` gives, initialised as the trainer does."""
        leaves = list(_tensor_leaves(tx.init(
            [torch.empty(shape_of(k), dtype=param_dtype, device="meta")
             .requires_grad_(p.requires_grad) for k, p in named.items()])))
        return (sum(t.numel() for t in leaves),
                sum(t.numel() * t.element_size() for t in leaves))

    size = {k: math.prod(local[k]) for k in named}
    param_el = sum(math.prod(s) for s in shapes.values())
    local_el = sum(size.values())
    grad_el = sum(size[k] for k, p in named.items() if p.requires_grad)
    opt_el, opt_local = opt_bytes(piece)
    opt_total = opt_bytes(lambda k: shapes[k])[1]
    from tensorflow_train_distributed_torch import convert

    buffers = dict(model.named_buffers())
    buf = [buffers[b] for b in convert.model_state_names(model).values()]
    buf_el = sum(t.numel() for t in buf)
    buf_bytes = sum(t.numel() * t.element_size() for t in buf)
    per_device = local_el * psize + grad_el * 4 + opt_local + buf_bytes
    total = (param_el * psize + opt_total + buf_bytes
             + 4 * sum(math.prod(shapes[k]) for k, p in named.items()
                       if p.requires_grad))
    return {"total_bytes": float(total),
            "per_device_bytes": float(per_device),
            "param_elements": param_el, "local_param_elements": local_el,
            "grad_elements": grad_el, "opt_state_elements": opt_el,
            "model_state_elements": buf_el,
            "param_bytes_per_device": float(local_el * psize),
            "grad_bytes_per_device": float(grad_el * 4),
            "opt_state_bytes_per_device": float(opt_local),
            "model_state_bytes_per_device": float(buf_bytes)}


def _batch_extents(sample_batch, dims) -> tuple:
    """(global batch, sequence) of a sample batch: the first array of
    rank >= 2 in key order (JAX's rule); a vision model's sequence is its
    patch count."""
    arrays = [v for _, v in sorted(sample_batch.items())
              if len(getattr(v, "shape", ())) >= 2]
    if not arrays:
        raise ValueError("sample_batch has no [batch, ...] array")
    shape = tuple(arrays[0].shape)
    return shape[0], (dims["seq"] if dims["seq"] is not None else shape[1])


def plan_train_memory(task, sample_batch, optimizer="adamw", mesh=None, *,
                      zero1: bool = False,
                      param_dtype: torch.dtype = torch.float32,
                      compute_dtype: Optional[torch.dtype] = None,
                      device_name: Optional[str] = None,
                      budget_bytes: Optional[float] = None) -> dict:
    """Per-device plan of one train step: the exact state
    (``plan_state_memory``), the activations (``decoder_activation_bytes``
    at the per-device batch and sequence: the global ones divided by the
    mesh's batch and seq shard degrees), the update's temporaries, and the
    peak of the three moments the module docstring names
    (``step_bytes_per_device``, ``peak_phase``).  With ``budget_bytes``,
    or a ``device_name`` the table knows, ``fits`` says whether the step
    fits.  Raises ``ValueError`` for a model the activation model does not
    cover (``_model_dims``).  Allocates nothing.
    """
    from tensorflow_train_distributed_torch.runtime.mesh import batch_axes

    dims = _model_dims(task)
    plan = plan_state_memory(task, sample_batch, optimizer, mesh,
                             zero1=zero1, param_dtype=param_dtype)
    m = _mesh_of(mesh)
    global_batch, seq = _batch_extents(sample_batch, dims)
    shards = math.prod(m.shape[a] for a in batch_axes(m))
    per_batch = max(1, global_batch // shards)
    per_seq = max(1, seq // m.shape["seq"])
    compute = compute_dtype or dims["compute_dtype"]
    cb = compute.itemsize
    kw = dict(remat=dims["remat"], vocab=dims["vocab"],
              ffn_size=dims["ffn_size"], kv_width=dims["kv_width"],
              gated=dims["gated"], compute_bytes=cb,
              logits_per_token=dims["logits_per_token"],
              extra_layer_elements=dims["extra_layer_elements"])
    args = (dims["num_layers"], dims["width"], per_batch, per_seq)
    act = decoder_activation_bytes(*args, dense_heads=dims["dense_heads"],
                                   causal=dims["causal"], **kw)
    copies = 0
    if compute != param_dtype:
        # The compute-dtype copies of the weights autograd keeps: every
        # block's without remat, the embedding's and head's with it.
        named = dict(task.model.named_parameters())
        copies = cb * sum(p.numel() for k, p in named.items()
                          if dims["remat"] is not True or not k.startswith(
                              ("layers.", "encoder.layers.",
                               "decoder.layers.")))
    act += copies
    grads = plan["grad_bytes_per_device"]
    state = plan["per_device_bytes"]
    update = UPDATE_BYTES_PER_PARAM * plan["grad_elements"]
    phases = {"backward": state - grads + act, "gradients": state,
              "update": state + update}
    phase = max(phases, key=phases.get)
    plan.update(activation_bytes_per_device=float(act),
                activation_terms=activation_terms(*args, **kw),
                weight_copy_bytes_per_device=float(copies),
                update_bytes_per_device=float(update),
                state_bytes_per_device=float(state),
                step_bytes_per_device=float(phases[phase]),
                peak_phase=phase, per_device_batch=per_batch,
                per_device_seq=per_seq)
    if budget_bytes is None and device_name is not None:
        budget_bytes = hbm_budget_bytes(device_name)
    if budget_bytes is not None:
        plan["budget_bytes"] = float(budget_bytes)
        plan["fits"] = plan["step_bytes_per_device"] <= budget_bytes
    return plan
