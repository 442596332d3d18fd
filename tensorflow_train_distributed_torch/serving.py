"""Continuous-batching serving engine over a paged (or linear) KV cache.

Counterpart of the JAX package's ``serving.ServingEngine``, with its
speculative decoding and its pipelined scheduler:

- ``submit`` queues requests; ``run`` loops ``serve_step`` to the end.
- **Admission** claims a lane's physical blocks from the pool
  (``serving_kv``): the prompt's block-aligned prefix is matched in the
  radix index (shared blocks, one more reference each) and the rest
  allocated, evicting least-recently-used retired prefixes under
  pressure; a request whose blocks cannot be had keeps its place at the
  head of the queue (refused admission, never a corrupted live lane).
- **Prefill** runs each admitted prompt alone on a batch-1 LINEAR cache,
  in prompt-bucket pieces (or ``prefill_chunk`` pieces).  A prefix hit
  starts from a copy of the shared rows read out of the pool by the paged
  KV gather kernel, so only the suffix is computed.  The prefilled rows
  are then scattered into the lane's own blocks and its table row and
  position are installed.
- **Decode** steps every slot together, ``chunk`` steps per dispatch;
  each step's attention is the fused paged-attention kernel over the
  pool.  The host harvests finished requests (EOS or budget) between
  chunks, feeds their full blocks to the radix index, and refills the
  freed slots from the queue.
- **Speculative decoding** (``draft_config``/``draft_params``,
  ``speculative_k``): a dispatch is one round for all slots.  The draft
  proposes k tokens a slot in k+1 single-token steps over its own pool
  (the last only appends, so both caches hold the same rows), the target
  verifies each slot's [tok, d_0..d_{k-1}] block in one forward (paged
  attention at q_len k+1), each slot accepts its own prefix
  (``models.speculative``) and both caches rewind per slot.  The draft's
  pool has the target's block count and shares its block table, so one
  claim covers both.  Greedy output is the target's greedy decode token
  for token; sampled output follows the target's distribution.
  ``spec_depths`` adds the acceptance-adaptive depth controller
  (``TTD_NO_ADAPTIVE_SPEC=1`` pins ``speculative_k``).
- **One-chunk overlap** (default; ``overlap=False`` or
  ``TTD_NO_OVERLAP=1`` restores the synchronous path): the next chunk is
  dispatched from a device-resident carry (next token, stream counters)
  before the host waits for the previous one, whose tokens come back
  through a pinned copy and a CUDA event recorded after it alone.  Stop
  and refill decisions lag one chunk; the harvest trims what a slot's
  previous tenant left, so outputs are bit for bit the synchronous ones.
- **Staged interleaved prefill** (default; ``prefill_budget=0`` or
  ``TTD_NO_INTERLEAVE=1`` restores atomic admission): an admitted
  request's prefill pieces (target, then draft) advance at most
  ``prefill_budget`` tokens a step (default one piece) behind the
  in-flight chunk, so decoding lanes keep their cadence through a long
  admission.  The pieces and their order per request are unchanged.

Greedy decoding takes the argmax of f32 logits.  Sampling
(``temperature``/``top_k``/``top_p``) draws each token by Gumbel-max from
uniforms that depend on (request seed, tokens drawn so far, draw index)
alone (``stream_uniforms``, a counter-based hash computed where the
counters lie), so a request's tokens do not depend on its slot, its
neighbours, chunk boundaries or the overlap.  The JAX engine's threefry
bits cannot be reproduced, so sampled output agrees with it in
distribution, not token for token.

Lane control, as the JAX engine's:

- ``cancel`` drops a queued request, a staged partial prefill (its
  blocks free at once) or a decoding lane (its prompt blocks stay
  radix-held, the generated tail goes; a chunk in flight is trimmed at
  its harvest and the lane is flushed before the next dispatch).
- ``submit(..., resume_from=g)`` declares the prompt's last ``g`` tokens
  the request's own earlier output: the first pick draws at stream
  counter ``g``, so a resumed seeded stream continues where the
  uninterrupted one would have been.
- ``preload_prefix`` prefills a shared prefix once into a batch-1 cache
  pair (kept in an LRU of ``prefix_cache_limit`` entries) and seeds the
  radix index with its full blocks; later requests that extend it copy
  those blocks with the paged KV gather and take the sub-block tail from
  the pair.
- ``export_prefix_kv``/``install_prefix_kv`` and ``export_lane``/
  ``install_lane`` move a prefix's or a lane's full-block KV rows in the
  JAX engine's wire recipe (``_serialize_rows``): a manifest of flax
  cache paths, numpy dtype strings and shapes in path-sorted order, and
  the rows' bytes verbatim (int8 rows with their f32 scales), so either
  package installs what the other exports.

Both decoder families serve (``models.generate._decode_model``), in full
precision or with int8 weights (``quant_scales``, and
``draft_quant_scales`` for the draft; ``models.quant``).  A
dense-dispatch MoE prefills each prompt whole at its exact length: the
router's per-group capacity depends on the group's length, so bucket
padding or chunking would change which tokens drop against
``generate()``'s prefill.  Such an engine therefore refuses
``prefill_chunk`` and ``preload_prefix``, matches no radix prefix and
exports no KV rows.  The dropless gmm dispatch routes every token on its
own and keeps bucketed and chunked prefill, prefix caching and lane
export and install.  (The JAX engine warns at each new prompt length
because each is a new XLA program; this eager engine compiles nothing
per length, so it has no such warning.)

**The linear engine** (``paged=False``, ``TTD_NO_PAGED_KV=1``, the CLI's
``--no-paged-kv``): each slot owns a strip of ``cache_len`` rows in a
[slots, cache_len] cache, a prefilled request's rows are copied into its
slot's strip, and decode attends over the strip with the masked einsum
(``layers._cache_attend``): neither the paged-attention kernel nor the
paged KV gather runs.  Prefix reuse is manual (``preload_prefix``'s
LRU of batch-1 caches; there is no radix index), and what needs the pool
answers as the JAX linear engine does: ``export_prefix_kv`` None,
``install_prefix_kv`` 0, ``export_lane`` a lane with ``kv`` None, the
block and byte counters 0.  Greedy output equals the paged engine's.

**HBM autosizing** (``kv_pool_blocks="auto"``; ``TTD_NO_HBM_AUTOSIZE=1``
falls back to the default pool with no budget): the pool's block count
and the engine's ``hbm_budget_bytes`` are solved from the device's
memory (``torch.cuda.mem_get_info``'s total, or ``TTD_HBM_BYTES``) less
``hbm_headroom``: the largest pool whose slot grids (target and draft)
plus one batch-1 prefill cache pair fit, the grids' bytes linear in the
block count and read off two meta-device probes.  As in the JAX package
the weights, the CUDA context and whatever the process already holds
must fit in the headroom.  A budget (solved or given) is enforced by the
memory sanitizer (``TTD_MEMCHECK=1``, ``runtime.lint.memcheck``) on the
grids, the prefill caches and the stored prefixes, and admission refuses
a request whose projected bytes would not fit.

The engine records the JAX engine's flight-recorder spans and instants
(``runtime.events``: ``engine/*``, ``kv/*``, ``prefill/*``, ``slot/*``,
``decode/dispatch``, ``decode/wait``, ``decode/harvest``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU the kernels' plain versions run (``ops.kernels``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from tensorflow_train_distributed_torch import serving_kv
from tensorflow_train_distributed_torch.models import speculative as spec
from tensorflow_train_distributed_torch.models.generate import (
    _decode_model,
    cast_floating,
    filter_logits,
    validate_sampling,
)
from tensorflow_train_distributed_torch.models import layers as L
from tensorflow_train_distributed_torch.models.layers import KVCache
from tensorflow_train_distributed_torch.models.lora import has_lora_leaves
from tensorflow_train_distributed_torch.models.moe import MoeConfig
from tensorflow_train_distributed_torch.models.quant import (
    check_quant_pairing,
)
from tensorflow_train_distributed_torch.ops import kernels as K
from tensorflow_train_distributed_torch.runtime import events
from tensorflow_train_distributed_torch.runtime.lint import memcheck
from tensorflow_train_distributed_torch.runtime.lint.registry import (
    concurrency_guarded,
    dispatch_critical,
    memory_budget,
    thread_role,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _SlotState:
    request_id: int
    remaining: int                 # generated tokens still allowed
    tokens: list                   # prompt + generated so far
    last_token: int                # feeds the next decode step
    seed: int = 0                  # per-request sampling stream
    count: int = 1                 # tokens sampled so far (stream counter)
    done: bool = False


@dataclasses.dataclass
class _PrefillTask:
    """A request whose prefill is staged across ``serve_step`` calls: the
    slot is reserved while the batch-1 caches are built piece by piece.
    ``cursor``/``d_cursor`` count completed target/draft pieces; the
    caches start None, so staging itself does no device work."""

    request_id: int
    prompt: list
    max_new: int
    seed: int
    work: list                     # suffix after the matched prefix
    padded: np.ndarray             # [1, piece * n_pieces] token ids
    piece: int
    n_pieces: int
    kv: Optional[serving_kv.LaneKV]    # the paged claim (None: linear)
    table: Optional[torch.Tensor]      # its device block-table row
    cursor: int = 0                # target pieces completed
    cache_1: Optional[KVCache] = None
    first: Optional[torch.Tensor] = None   # pick after the last piece
    first_host: Optional[int] = None
    d_cursor: int = 0              # draft pieces completed
    d_cache_1: Optional[KVCache] = None
    resume: int = 0                # the first pick's stream counter
    pre_pair: Optional[tuple] = None   # a preloaded prefix's caches


def _killed(switch: str) -> bool:
    """A kill switch (``TTD_NO_OVERLAP``, ``TTD_NO_INTERLEAVE``,
    ``TTD_NO_ADAPTIVE_SPEC``, ``TTD_NO_PAGED_KV``,
    ``TTD_NO_HBM_AUTOSIZE``) set in the environment: it wins over the
    constructor's arguments, so a deployment flips it without touching
    its callers.  Read at construction."""
    return os.environ.get(switch, "0") not in ("", "0")


def _device_hbm_bytes(device: torch.device) -> Optional[int]:
    """The device's memory in bytes, for the autosize solve:
    ``TTD_HBM_BYTES=<bytes>`` overrides (tests, CPU hosts); else a CUDA
    device's total (``torch.cuda.mem_get_info``, the counterpart of the
    JAX ``bytes_limit``); None otherwise (the caller refuses)."""
    env = os.environ.get("TTD_HBM_BYTES", "")
    if env not in ("", "0"):
        return int(env)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def _pool_bytes(config, n_blocks: int, block_size: int) -> int:
    """Bytes of one model's paged pools: key and value rows per layer,
    plus the f32 scale pool of an int8 cache."""
    rows = config.num_layers * n_blocks * block_size * config.kv_heads
    if config.kv_cache_int8:
        return rows * (2 * config.attn_head_dim + 2 * 4)
    item = torch.empty((), dtype=config.dtype).element_size()
    return rows * 2 * config.attn_head_dim * item


def _bucket_len(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill "
                     f"bucket {buckets[-1]}")


# torch dtype -> (numpy's dtype string on the wire, the name the JAX
# engine's errors print): JAX writes ``np.dtype(...).str``, and numpy's
# bfloat16 (ml_dtypes) is a two-byte void there.
_WIRE_DTYPES = {torch.float32: ("<f4", "float32"),
                torch.bfloat16: ("<V2", "bfloat16"),
                torch.float16: ("<f2", "float16"),
                torch.int8: ("|i1", "int8")}


# -- sampling streams ---------------------------------------------------------

_M64 = (1 << 64) - 1


def _i64(x: int) -> int:
    """``x`` mod 2^64 as a signed 64-bit value (the int64 tensor view)."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)
# The draw index of a plain pick; a speculative round draws 0..k (the
# draft), k+1 (acceptance uniforms) and k+2 (the replacement or bonus).
PICK_DRAW = -1


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` (``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser: a bijection of 64-bit words (products
    wrap in int64)."""
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def stream_uniforms(seeds: torch.Tensor, counts: torch.Tensor, draw: int,
                    width: int) -> torch.Tensor:
    """[n, width] f64 uniforms in (0, 1): column j of row i depends on
    (``seeds[i]``, ``counts[i]``, ``draw``, j) alone.  splitmix64 of the
    stream's (seed, count), then of the draw index, then of the column,
    in int64 tensor ops on whatever device the counters lie, so a counter
    that exists only on the device needs no host copy."""
    key = _mix64(seeds.long() * _GOLDEN + counts.long() + 1)
    key = _mix64(key + _i64((draw + 1) * 0x9E3779B97F4A7C15))
    col = torch.arange(1, width + 1, dtype=torch.int64,  # ttd-lint: disable=memcheck -- a [width] column index of the sampling step, freed with it (the JAX jit program's working set)
                       device=seeds.device) * _GOLDEN
    z = _mix64(key[:, None] + col)
    return (_shr(z, 12).double() + 0.5) * 2.0 ** -52


@concurrency_guarded
class ServingEngine:
    """Continuous-batching decoder over a fixed slot grid and block pool.

    ``params``: the port's flat weights (``convert.params_from_flax`` or
    ``convert.init_params``), served in ``config.dtype``; ``draft_params``
    likewise for ``draft_config``.  int8 weights come with their scales
    (``quant_scales``, ``draft_quant_scales``: ``models.quant``).  ``record_logits=True`` keeps, per
    request, the f32 logits that produced each of its generated tokens
    after the first (``decode_logits[request_id]``, a list of [vocab]
    tensors: a decode step's, or the verify forward's row under
    speculation) — the seam a consistency check re-derives them
    through."""

    # The engine is single-threaded (the serving fleet's driver thread
    # makes every mutating call) except for these cross-thread surfaces,
    # declared as the JAX engine declares them.  The prefix store:
    # handler threads validate while the driver LRU-touches it, so every
    # access holds ``_prefix_lock``.  The stats dicts: one writer (the
    # driver, or the main thread of an offline run), which reads its own
    # writes lock-free; scrape threads (``/metrics``) read them under
    # ``_stats_lock`` and every write takes it, so a scrape never sees
    # half of one update (hits beside hit tokens, harvest seconds beside
    # overlapped seconds).  The JAX engine's ``_preloaded`` store has no
    # counterpart here: the port validates against ``_prefix_caches``.
    _GUARDED_BY = {
        "_prefix_caches": ("_prefix_lock",),
        "kv_stats": ("_stats_lock", "driver", "main"),
        "prefill_stats": ("_stats_lock", "driver", "main"),
        "overlap_stats": ("_stats_lock", "driver", "main"),
        "spec_stats": ("_stats_lock", "driver", "main"),
        "_spec_ctrl": ("_stats_lock", "driver", "main"),
    }

    def __init__(self, config, params: dict, *, slots: int = 8,
                 cache_len: Optional[int] = None,
                 eos_id: Optional[int] = None, chunk: int = 8,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 prefill_chunk: Optional[int] = None,
                 draft_config=None, draft_params: Optional[dict] = None,
                 speculative_k: int = 0, spec_depths=None,
                 quant_scales: Optional[dict] = None,
                 draft_quant_scales: Optional[dict] = None,
                 prompt_buckets=(32, 64, 128, 256, 512, 1024),
                 overlap: Optional[bool] = None,
                 prefill_budget: Optional[int] = None,
                 paged: Optional[bool] = None,
                 kv_block_size: int = 16,
                 kv_pool_blocks=None,
                 prefix_cache_limit: int = 32,
                 hbm_budget_bytes: Optional[int] = None,
                 hbm_headroom: float = 0.1,
                 record_logits: bool = False, device="cuda",
                 mesh=None, rules=None):
        if (config.sliding_window is not None or config.attention_sinks):
            raise ValueError(
                "the serving engine's caches hold the full context; "
                "sliding_window / attention_sinks configs are not served")
        if has_lora_leaves(params):
            raise ValueError(
                "merge LoRA adapters before engine serving: params = "
                "models.lora.merge_lora(params, spec)")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        # Dense-dispatch MoE prefills at the exact prompt length (the
        # module docstring); the dropless gmm dispatch need not.
        self._exact_prefill = (isinstance(config, MoeConfig)
                               and config.dispatch != "gmm")
        validate_sampling(temperature, top_k, top_p)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self._greedy = temperature == 0.0
        self.config = config
        self.device = torch.device(device)
        # The card's index ("cuda" names the current one): the driver
        # thread that launches this engine's work pins it (bind_thread).
        self._card = (None if self.device.type != "cuda"
                      else self.device.index if self.device.index is not None
                      else torch.cuda.current_device())
        self.slots = slots
        self.cache_len = cache_len or config.max_positions
        if self.cache_len > config.max_positions:
            raise ValueError(f"cache_len {self.cache_len} exceeds "
                             f"max_positions {config.max_positions}")
        self.eos_id = eos_id
        self.chunk = chunk
        # The byte ceiling of the engine's declared pools (the grids, the
        # prefill caches, the stored prefixes), enforced by the memory
        # sanitizer; None tracks only.  Admission refuses a request whose
        # projected bytes do not fit it.
        if hbm_budget_bytes is not None and hbm_budget_bytes < 1:
            raise ValueError(
                f"hbm_budget_bytes must be >= 1, got {hbm_budget_bytes}")
        self.hbm_budget_bytes = hbm_budget_bytes
        self._prefill_bytes_memo: Optional[int] = None
        self._cache_shapes: dict = {}  # (draft, batch, grid) -> meta cache
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        if prefill_chunk is not None and self._exact_prefill:
            raise ValueError(
                "prefill_chunk is unsupported for dense-dispatch "
                "MoE configs: the router's per-group capacity "
                "depends on the prefill length, so chunking would "
                "change routing vs generate() (dense MoE prefills "
                "at the exact length; dispatch='gmm' is dropless "
                "and supports chunked/bucketed prefill)")
        self.prefill_chunk = prefill_chunk
        self.prompt_buckets = tuple(
            b for b in sorted(prompt_buckets) if b <= self.cache_len)
        if (not self.prompt_buckets and not self._exact_prefill
                and prefill_chunk is None):
            raise ValueError("no prompt bucket fits cache_len")
        check_quant_pairing(params, quant_scales)
        if kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got "
                             f"{kv_block_size}")
        self.kv_block_size = int(kv_block_size)
        self._kv_nblk_lane = -(-self.cache_len // self.kv_block_size)
        self.paged = ((True if paged is None else bool(paged))
                      and not _killed("TTD_NO_PAGED_KV"))
        # ``kv_pool_blocks="auto"`` solves the pool and the budget from
        # the device's memory once both models exist (below);
        # TTD_NO_HBM_AUTOSIZE or a linear engine (no pool) falls back to
        # the default pool with no budget.
        if not 0.0 <= hbm_headroom < 1.0:
            raise ValueError(
                f"hbm_headroom must be in [0, 1), got {hbm_headroom}")
        self._hbm_headroom = float(hbm_headroom)
        self._hbm_autosized = 0
        autosize = kv_pool_blocks == "auto"
        if autosize:
            if hbm_budget_bytes is not None:
                raise ValueError(
                    "kv_pool_blocks='auto' solves hbm_budget_bytes "
                    "itself; pass one or the other")
            if _killed("TTD_NO_HBM_AUTOSIZE") or not self.paged:
                autosize = False
                kv_pool_blocks = None
        elif isinstance(kv_pool_blocks, str):
            raise ValueError(
                f"kv_pool_blocks must be an int or 'auto', got "
                f"{kv_pool_blocks!r}")
        if not autosize:
            if kv_pool_blocks is None:
                kv_pool_blocks = slots * self._kv_nblk_lane
            if kv_pool_blocks < 1:
                raise ValueError(f"kv_pool_blocks must be >= 1, got "
                                 f"{kv_pool_blocks}")
        # The locks of ``_GUARDED_BY`` (held for dict walks and counter
        # bumps only, never across device work).
        self._prefix_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # Speculative decoding across all slots: the per-slot cache index
        # makes each slot's rollback its own index decrement.
        self._spec_k = int(speculative_k)
        if (draft_config is None) != (draft_params is None):
            raise ValueError("draft_config and draft_params come together")
        if draft_quant_scales is not None and draft_config is None:
            raise ValueError("draft_quant_scales needs draft_config/params")
        if self._spec_k and draft_config is None:
            raise ValueError("speculative_k needs draft_config/params")
        if spec_depths is not None and draft_config is None:
            raise ValueError("spec_depths needs draft_config/params")
        if draft_config is not None:
            if self._spec_k < 1:
                raise ValueError(f"draft_config needs speculative_k >= 1, "
                                 f"got {self._spec_k}")
            if draft_config.attention_sinks:
                raise ValueError("the draft uses the per-slot caches too; "
                                 "attention_sinks draft configs are "
                                 "unsupported")
            spec._reject_config("target", config)
            spec._reject_config("draft", draft_config)
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(f"draft vocab {draft_config.vocab_size} "
                                 f"!= target vocab {config.vocab_size}")
            if has_lora_leaves(draft_params):
                raise ValueError("merge the draft's LoRA adapters first")
            check_quant_pairing(draft_params, draft_quant_scales)
        self.draft_config = draft_config
        # The controller only selects among depths; it never changes a
        # round's math (a pinned depth replays the fixed engine bitwise).
        self._spec_ctrl = (spec.DepthController(spec_depths)
                           if spec_depths is not None
                           and not _killed("TTD_NO_ADAPTIVE_SPEC") else None)
        self.mesh = mesh
        self._split = self._mesh_split(config, mesh, rules)
        local_config, params, prepare = self._mesh_layout(
            config, cast_floating(params, config.dtype), draft_config,
            quant_scales)
        self._local_config = local_config
        self._model = _decode_model(
            local_config, params, quant_scales=quant_scales,
            device=self.device, prepare=prepare)
        self._draft = (None if draft_config is None else _decode_model(
            draft_config, cast_floating(draft_params, draft_config.dtype),
            quant_scales=draft_quant_scales, device=self.device))
        if autosize:
            kv_pool_blocks, budget = self._solve_hbm_autosize()
            if mesh is not None and mesh.size > 1:
                # Each rank reads its own card; ranks that admitted
                # differently would part at the next collective.
                from tensorflow_train_distributed_torch.parallel import (
                    collectives,
                )
                from tensorflow_train_distributed_torch.runtime.mesh import (
                    AXES,
                )

                both = collectives.all_reduce(
                    torch.tensor([kv_pool_blocks, budget],
                                 dtype=torch.int64),
                    mesh.group(AXES), op="min")
                kv_pool_blocks, budget = (int(v) for v in both)
            self.hbm_budget_bytes = self._hbm_autosized = budget
        self._kv_pool = self._radix = None
        self._kv_pool_bytes = 0
        if self.paged:
            self._kv_pool = serving_kv.KVBlockPool(kv_pool_blocks,
                                                   self.kv_block_size)
            self._radix = serving_kv.RadixPrefixIndex(self._kv_pool)
            # Device bytes the pools pin (target and draft, int8 scale
            # pools included, the scratch block too), from the shapes.
            self._kv_pool_bytes = sum(
                _pool_bytes(c, 1 + kv_pool_blocks, self.kv_block_size)
                for c in (local_config, draft_config) if c is not None)
            self._kv_pool.bytes_per_block = (self._kv_pool_bytes
                                             // (1 + kv_pool_blocks))
        # Preloaded prefixes: tuple(tokens) -> (target, draft) batch-1
        # caches, least recently matched first.  Validation reads them
        # (``_match_prefix`` without touching the order), never the radix
        # index, which may evict.
        if prefix_cache_limit < 1:
            raise ValueError(f"prefix_cache_limit must be >= 1, got "
                             f"{prefix_cache_limit}")
        self.prefix_cache_limit = prefix_cache_limit
        self._prefix_caches: OrderedDict = OrderedDict()
        self.overlap = ((True if overlap is None else bool(overlap))
                        and not _killed("TTD_NO_OVERLAP"))
        if prefill_budget is not None and prefill_budget < 0:
            raise ValueError(f"prefill_budget must be >= 0 (0 = atomic "
                             f"admission), got {prefill_budget}")
        self.prefill_budget = prefill_budget
        self.interleave = (prefill_budget != 0
                           and not _killed("TTD_NO_INTERLEAVE"))
        # kv_stats: prompt tokens whose prefill a radix hit skipped,
        # blocks LRU-evicted under pressure, requests refused admission.
        self.kv_stats = {"prefix_hit_tokens": 0, "prefix_hits": 0,
                         "evictions": 0, "alloc_refusals": 0}
        # Host-clock totals of the serving loop: decode_s is the time
        # spent dispatching decode work and waiting for its tokens
        # (decode_steps counts target decode forwards: chunk a chunk,
        # one a speculative round); prefill_s the time spent prefilling.
        self.stats = {"decode_steps": 0, "decode_s": 0.0, "prefill_s": 0.0,
                      "prefill_tokens": 0}
        # rounds: engine rounds harvested; slot_rounds: active slots
        # across them (the acceptance denominator is drafted).
        self.spec_stats = {"rounds": 0, "slot_rounds": 0, "drafted": 0,
                           "drafted_accepted": 0, "emitted": 0}
        # chunks dispatched; harvest passes, and those that ran with a
        # successor in flight, with their host time (overlap_ratio()).
        self.overlap_stats = {"chunks": 0, "overlapped_harvests": 0,
                              "harvest_s": 0.0, "overlapped_harvest_s": 0.0}
        # installments of staged prefill run; requests staged; stall_s:
        # time spent prefilling while a lane decoded with no chunk in
        # flight to hide it (prefill_stall_s()).
        self.prefill_stats = {"installments": 0, "staged_requests": 0,
                              "stall_s": 0.0}
        self.record_logits = record_logits
        self.decode_logits: dict = {}
        self._queue: deque = deque()
        self._outputs: dict = {}
        self._next_id = 0
        self._slot_states: list = [None] * slots
        self._lane_kv: list = [None] * slots
        self._stale_slots: set = set()
        self._kv_refused_rid: Optional[int] = None
        self._cache: Optional[KVCache] = None     # slot grids, built lazily
        self._d_cache: Optional[KVCache] = None
        self._staging: dict = {}       # slot -> _PrefillTask, FIFO
        # The chunk in flight: ``rids`` pins each slot's request at
        # dispatch; the harvest trims slots whose tenant changed since.
        self._inflight: Optional[dict] = None
        # (next token, stream counters) [slots] on the device, feeding
        # the next dispatch without a host copy.
        self._carry: Optional[tuple] = None
        self._refills: set = set()     # slots refilled since the dispatch
        if self.hbm_budget_bytes is not None:
            self._prefill_pair_bytes()     # admission reads the memo

    # -- the mesh --------------------------------------------------------

    @staticmethod
    def _mesh_split(config, mesh, rules) -> Optional[tuple]:
        """(axis, n) of the tensor split the mesh gives the heads (the
        rules' ``heads`` target, ``tensor`` by default), None without."""
        if mesh is None:
            return None
        from tensorflow_train_distributed_torch.parallel import sharding

        table = sharding._rules_for_mesh(
            mesh, sharding.DEFAULT_RULES if rules is None else rules)
        axes = table.get("heads") or ()
        if len(axes) > 1:
            raise ValueError(f"heads split over {axes}: the engine splits "
                             "them over one mesh axis")
        return (axes[0], mesh.shape[axes[0]]) if axes else None

    def _mesh_layout(self, config, params: dict, draft_config,
                     quant_scales) -> tuple:
        """(this rank's config, its weights, the layout of its meta
        model).  Under a tensor split (``_split``) each rank builds the
        decoder with its H/t heads, KV/t kv heads and F/t ffn
        (``llama.tensor_split``), so its pools hold only its kv heads and
        the kernels (K1f, K4, K5) run on whole local heads on every rank.
        (The JAX engine turns its fused paged-attention kernel off under
        a mesh because GSPMD cannot partition a Pallas call; here each
        rank's call is whole, so K4 stays on.)  Under ``expert`` each MoE
        block holds its experts' stacks (``moe.set_expert_parallel``).
        ``data`` replicates the engine: every rank decodes every slot."""
        mesh = self.mesh
        prepare = []
        if self._split is not None:
            from tensorflow_train_distributed_torch.models import llama

            axis, n = self._split
            if not isinstance(config, llama.LlamaConfig):
                raise ValueError(
                    "a tensor-split engine serves Llama-family decoders; "
                    "serve MoE configs over the expert axis")
            if draft_config is not None or quant_scales is not None:
                raise ValueError(
                    "a tensor-split engine serves full-precision weights "
                    "without a draft")
            config, params = llama.tensor_split(config, params, n,
                                                mesh.index(axis))
            vocab = self.config.vocab_size

            def split(model):
                L.set_tensor_parallel(model, mesh, axis, vocab)
            prepare.append(split)
        if mesh is not None and mesh.shape["expert"] > 1 and isinstance(
                config, MoeConfig):
            from tensorflow_train_distributed_torch.models import moe

            ep, ix = mesh.shape["expert"], mesh.index("expert")
            params = {k: (v.chunk(ep, 0)[ix] if ".experts." in k else v)
                      for k, v in params.items()}

            def experts(model):
                moe.set_expert_parallel(model, mesh)
            prepare.append(experts)

        def run(model):
            for fn in prepare:
                fn(model)
        return config, params, (run if prepare else None)

    def _refuse_split(self, what: str) -> None:
        if self._split is not None:
            raise ValueError(
                f"{what}: a tensor-split engine's KV rows hold this "
                "rank's kv heads only; the wire recipe carries whole rows")

    # -- host <-> device ---------------------------------------------------

    def bind_thread(self) -> None:
        """Make the calling thread launch on the engine's card (torch's
        current device is per thread): a serving fleet's driver thread
        calls this before its first step.  The thread then launches on
        the card's default stream, where the engine's tensors, its
        pipelined chunk's event and the kernels (``ops.kernels`` launches
        on the current stream) all live; replicas that share a card share
        that stream, so their steps serialize on the card."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self._card)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on CUDA through pinned
        memory without blocking the host (the stream orders the copy)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_host(self, *ts: torch.Tensor) -> tuple:
        """Start copying ``ts`` to the host: (host tensors, the event to
        wait on, None off CUDA).  The event is recorded right after these
        copies, so waiting on it waits for this work alone, not for what
        is queued behind it."""
        if self.device.type != "cuda":
            return list(ts), None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in ts]
        for h, t in zip(host, ts):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # -- device programs ---------------------------------------------------

    def _pick(self, logits: torch.Tensor, seeds, counts) -> torch.Tensor:
        """Next token per row of ``logits`` [n, V].  Greedy: argmax over
        f32.  Sampling: Gumbel-max over ``filter_logits`` — exactly a draw
        from their softmax — with row i's noise from its stream
        (``seeds[i]``, ``counts[i]``) at ``PICK_DRAW``."""
        logits = logits.float()
        if self._greedy:
            return torch.argmax(logits, dim=-1)
        filt = self._filtered(logits)
        seeds = torch.as_tensor(seeds, dtype=torch.int64, device=filt.device)  # ttd-lint: disable=memcheck -- [n] stream seeds of the step, freed with it
        counts = torch.as_tensor(counts, dtype=torch.int64,  # ttd-lint: disable=memcheck -- [n] stream counters of the step, freed with it
                                 device=filt.device)
        return spec.gumbel_argmax(filt, stream_uniforms(
            seeds, counts, PICK_DRAW, filt.shape[-1]))

    def _prefill_piece(self, cache_1: KVCache, tokens_1xl: torch.Tensor,
                       local_idx: int, seed: int, rng0: int = 0):
        """One batch-1 prefill piece appended to ``cache_1``; returns the
        pick at ``local_idx`` (the last real row of this piece), drawn at
        stream counter ``rng0`` (0 for a fresh request, the resumed
        count for a resumed one).  Pad rows of a final piece sit after
        every real row, so causal masking keeps them invisible, and
        decode rewrites each before any query can attend it."""
        logits = self._model(tokens_1xl, cache_1)
        return self._pick(logits[:, local_idx], [seed], [rng0])[0]

    def _decode_chunk(self, tok: torch.Tensor, seeds: torch.Tensor,
                      counts: torch.Tensor):
        """``chunk`` decode steps for all slots → (tokens [slots, chunk],
        the next carry's token and counters, f32 logits [slots, chunk, V]
        when recording)."""
        toks, logs = [], []
        for j in range(self.chunk):
            logits = self._model(tok[:, None], self._cache)[:, -1]
            tok = self._pick(logits, seeds, counts + j)
            toks.append(tok)
            if self.record_logits:
                logs.append(logits.float())
        return (torch.stack(toks, dim=1), tok, counts + self.chunk,
                torch.stack(logs, dim=1) if self.record_logits else None)

    def _filtered(self, logits: torch.Tensor) -> torch.Tensor:
        return filter_logits(logits, temperature=self.temperature,
                             top_k=self.top_k, top_p=self.top_p)

    def _spec_round(self, tok: torch.Tensor, seeds: torch.Tensor,
                    counts: torch.Tensor, k: int):
        """One speculative round for all slots at depth ``k``: the draft's
        k+1 steps (the last only appends, so both caches hold the same
        rows), the target's verify of [tok, d_0..d_{k-1}] in one forward,
        each slot's acceptance, and both caches' per-slot rewind by
        (k+1) - emitted.  Depth 0 is a plain decode step with the draft
        kept in lockstep.  Returns (emit [B, k+1], emitted [B], next
        token [B], accepted [B], the next counters, the verify's f32
        logits [B, k+1, V] when recording)."""
        drafts, qs = [], []
        t = tok
        for j in range(k + 1):
            logits = self._draft(t[:, None], self._d_cache)[:, -1]
            if j == k:
                break                  # append-only step
            if self._greedy:
                t = torch.argmax(logits.float(), dim=-1)
            else:
                filt = self._filtered(logits.float())
                t = spec.gumbel_argmax(filt, stream_uniforms(
                    seeds, counts, j, filt.shape[-1]))
                qs.append(torch.softmax(filt, dim=-1))
            drafts.append(t)
        d_block = (torch.stack(drafts, dim=1) if k
                   else tok.new_zeros(tok.shape[0], 0))
        block = torch.cat([tok[:, None], d_block], dim=1)
        logits = self._model(block, self._cache).float()    # [B, k+1, V]
        if self._greedy:
            emit, emitted, acc, nxt = spec.accept_block(
                d_block, torch.argmax(logits, dim=-1))
        else:
            p = torch.softmax(self._filtered(logits), dim=-1)
            q = (torch.stack(qs, dim=1) if k
                 else p.new_zeros(p.shape[0], 0, p.shape[-1]))
            emit, emitted, acc, nxt = spec.sampled_accept(
                d_block, q, p, stream_uniforms(seeds, counts, k + 1, k),
                stream_uniforms(seeds, counts, k + 2, p.shape[-1]))
        back = ((k + 1) - emitted).to(torch.int32)
        self._cache.index -= back
        self._d_cache.index -= back
        return (emit, emitted, nxt, acc, counts + emitted,
                logits if self.record_logits else None)

    def _init_cache(self, batch: int, draft: bool, grid: bool,
                    device, n_blocks: Optional[int] = None) -> KVCache:
        """A zeroed cache of the target or the draft: a slot grid
        (``grid``: the paged pool of ``n_blocks`` blocks plus scratch, or
        the linear [slots, cache_len] strips) or a batch-1 linear
        prefill cache."""
        model = self._draft if draft else self._model
        if grid and self.paged:
            blocks = 1 + (self._kv_pool.n_blocks if n_blocks is None
                          else n_blocks)
            return model.init_cache(batch, self.cache_len,
                                    paged_blocks=blocks,
                                    block_size=self.kv_block_size,
                                    device=device)
        return model.init_cache(batch, self.cache_len, device=device)

    def _cache_struct(self, batch: int, draft: bool = False,
                      grid: bool = False) -> KVCache:
        """The cache ``_fresh_cache`` mints, on the meta device (shapes
        and dtypes, nothing allocated), memoized: what the budget
        projects and the autosize solve reads."""
        key = (draft, batch, grid)
        if key not in self._cache_shapes:
            self._cache_shapes[key] = self._init_cache(batch, draft, grid,
                                                       "meta")
        return self._cache_shapes[key]

    # The engine's allocator: every cache it mints comes through here or
    # through ``_admission_cache_1``.  The grids are owner-lifetime pools
    # ("kv_pool", "draft_pool"), the batch-1 prefill caches transients
    # released as their tensors die; the projection is the meta cache's,
    # so an over-budget allocation raises before any buffer exists.
    @memory_budget(
        pool=lambda self, batch=1, draft=False, grid=False:
            (("draft_pool" if draft else "kv_pool") if grid
             else ("draft_prefill" if draft else "prefill_cache")),
        budget_fn=lambda self, *a, **k: self.hbm_budget_bytes,
        project_fn=lambda self, batch=1, draft=False, grid=False:
            memcheck.tree_bytes(self._cache_struct(batch, draft, grid)),
        lifetime=lambda self, batch=1, draft=False, grid=False:
            ("owner" if grid else "leaf"))
    def _fresh_cache(self, batch: int = 1, draft: bool = False,
                     grid: bool = False) -> KVCache:
        """A zeroed cache of the target or the draft (``_init_cache``) on
        the engine's device."""
        return self._init_cache(batch, draft, grid, self.device)

    def _grids(self) -> list:
        """The slot grids (target, then the draft's), built on first use.
        A paged draft pool has the target's block count and shares its
        block table: one claim and one table row cover both."""
        if self._cache is None:
            self._cache = self._fresh_cache(self.slots, grid=True)
            if self._draft is not None:
                d = self._fresh_cache(self.slots, draft=True, grid=True)
                self._d_cache = (d if not self.paged else KVCache(
                    layers=d.layers, index=d.index, cache_len=d.cache_len,
                    block_table=self._cache.block_table))
        return [c for c in (self._cache, self._d_cache) if c is not None]

    def _insert(self, caches_1: list, slot: int, true_len: int) -> None:
        """The linear engine's insert: copy each batch-1 cache's rows
        [0, true_len) into ``slot``'s strip and pin its position to the
        true prompt length.  Rows past it hold the previous tenant's,
        which the position masks hide and decode rewrites before any
        query reads them (the JAX ``_insert`` copies the whole strip, pad
        rows included, which are hidden the same way)."""
        for grid, cache_1 in zip(self._grids(), caches_1):
            for lc, lin in zip(grid.layers, cache_1.layers):
                for name in ("key_cache", "value_cache"):
                    lc[name][slot, :true_len] = lin[name][0, :true_len]
                if "kv_scales" in lc:
                    lc["kv_scales"][:, slot, :true_len] = (
                        lin["kv_scales"][:, 0, :true_len])
            grid.index[slot] = true_len

    def _install(self, caches_1: list, slot: int, kv, table_row,
                 true_len: int) -> None:
        """Insert a prefilled request into ``slot``: scattered into its
        blocks past the shared ones (paged), or copied into its strip."""
        if self.paged:
            self._paged_insert(caches_1, slot, table_row, kv.matched,
                               true_len)
        else:
            self._insert(caches_1, slot, true_len)

    def _scatter_rows(self, caches_1: list, table_row: torch.Tensor,
                      start: int, end: int) -> None:
        """Scatter each batch-1 cache's rows [start, end) into the blocks
        ``table_row`` names in its grid's pool (rows below ``start`` live
        in radix-shared blocks and are already there — shared blocks are
        never written).  Tables and positions are untouched."""
        bs = self.kv_block_size
        pos = torch.arange(start, end, device=self.device)  # ttd-lint: disable=memcheck -- the scatter's row positions, freed with the insert
        dest = table_row[pos // bs].long() * bs + pos % bs
        for grid, cache_1 in zip(self._grids(), caches_1):
            for pool, lin in zip(grid.layers, cache_1.layers):
                for p_name, l_name in (("key_pool", "key_cache"),
                                       ("value_pool", "value_cache")):
                    leaf = pool[p_name]
                    leaf.view(-1, *leaf.shape[2:])[dest] = (
                        lin[l_name][0, start:end])
                if "kv_pool_scales" in pool:
                    sp = pool["kv_pool_scales"]
                    sp.view(2, -1, sp.shape[-1])[:, dest] = (
                        lin["kv_scales"][:, 0, start:end])

    def _paged_insert(self, caches_1: list, slot: int,
                      table_row: torch.Tensor, start: int,
                      true_len: int) -> None:
        """Scatter the prefilled rows [start, true_len) into the lane's
        blocks, install its table row and pin its positions to the true
        prompt length."""
        self._scatter_rows(caches_1, table_row, start, true_len)
        grids = self._grids()
        for grid in grids:
            grid.index[slot] = true_len
        grids[0].block_table[slot] = table_row

    def _gather_prefix(self, table_row: torch.Tensor, matched: int,
                       draft: bool, rows: Optional[int] = None) -> KVCache:
        """A fresh batch-1 LINEAR cache holding the lane's rows read out
        of the target's (or the draft's) pool through its table by the
        paged KV gather kernel, position pinned to ``matched`` — a prefix
        hit replaces recompute with this copy.  Rows past ``matched`` hold
        whatever the lane's blocks hold: garbage the write-before-read
        rule keeps invisible.  ``rows`` (default ``cache_len``) bounds the
        rows read (an export reads only what it ships)."""
        grid = self._grids()[1 if draft else 0]
        table = table_row[None]
        c = self.cache_len if rows is None else rows
        layers = []
        for pool in grid.layers:
            lc = {"key_cache": K.paged_kv_gather(pool["key_pool"], table, c),
                  "value_cache": K.paged_kv_gather(pool["value_pool"], table,
                                                   c)}
            if "kv_pool_scales" in pool:
                sp = pool["kv_pool_scales"]
                lc["kv_scales"] = torch.stack([
                    K.paged_kv_gather(sp[i][..., None], table, c)[..., 0]
                    for i in (0, 1)])
            layers.append(lc)
        index = torch.full((1,), matched, dtype=torch.int32,
                           device=self.device)
        return KVCache(layers=layers, index=index, cache_len=c)

    @dispatch_critical
    def _flush_stale_lanes(self) -> None:
        """Point retired lanes' table rows at the scratch block and zero
        their positions in both grids before the next dispatch: their
        blocks went back to the pool, and the garbage an idle lane (or
        the overlap's lagging chunk) decodes must land in scratch, not in
        blocks someone else now owns."""
        if self._stale_slots and self._cache is not None:
            rows = self._to_device(np.array(sorted(self._stale_slots)))  # ttd-lint: disable=dispatch -- a host set of slot numbers, no tensor
            self._cache.block_table[rows] = 0
            for grid in self._grids():
                grid.index[rows] = 0
        self._stale_slots.clear()

    # -- requests ----------------------------------------------------------

    @thread_role("handler", "driver", "main")
    def validate_request(self, prompt, max_new_tokens: int,
                         seed: Optional[int] = None,
                         resume_from: int = 0) -> list:
        """All of ``submit()``'s checks without queuing; returns the
        prompt as a list of ints."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if seed is not None and not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed must be a uint32, got {seed}")
        if not prompt:
            raise ValueError("empty prompt")
        if resume_from < 0 or resume_from >= len(prompt):
            # The resumed tail is part of the prompt, and at least one
            # original prompt token must remain under it.
            raise ValueError(
                f"resume_from must be in [0, len(prompt)), got "
                f"{resume_from} for a {len(prompt)}-token prompt")
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got "
                             f"{max_new_tokens}")
        if len(prompt) + max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt {len(prompt)} + {max_new_tokens} new exceeds "
                f"cache_len={self.cache_len}")
        if not all(0 <= t < self.config.vocab_size for t in prompt):
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.config.vocab_size})")
        if self.paged:
            need = -(-(len(prompt) + max_new_tokens) // self.kv_block_size)
            if need > self._kv_pool.n_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks (block_size="
                    f"{self.kv_block_size}) but the pool has "
                    f"{self._kv_pool.n_blocks}")
        if self.hbm_budget_bytes is not None:
            # Projected bytes beside the free-blocks check: an admission
            # mints one batch-1 prefill cache pair.  A pool that alone
            # exceeds the budget is not screened here: its allocation
            # raises MemoryBudgetError with the live set listed.
            live = (memcheck.live_bytes(owner=self)
                    if memcheck.armed() else 0)
            projected = live + self._prefill_pair_bytes()
            if projected > self.hbm_budget_bytes:
                raise ValueError(
                    f"admission needs a projected {projected} bytes "
                    f"(live pools + one prefill cache pair) but "
                    f"hbm_budget_bytes={self.hbm_budget_bytes} — "
                    f"shrink --kv-pool-blocks/slots or raise the "
                    f"budget")
        if (not self._exact_prefill and self.prefill_chunk is None
                and not resume_from):
            # Only the suffix after the longest preloaded prefix needs a
            # bucket; a resumed request already passed this bound once,
            # and its pieces chunk any span.
            work = len(prompt) - self._match_prefix(prompt)[0]
            if work > self.prompt_buckets[-1]:
                raise ValueError(
                    f"prompt length {len(prompt)} (suffix {work} after "
                    f"the longest preloaded prefix) exceeds the largest "
                    f"prefill bucket {self.prompt_buckets[-1]}")
        return prompt

    @thread_role("driver", "main")
    def submit(self, prompt, max_new_tokens: int,
               seed: Optional[int] = None, resume_from: int = 0) -> int:
        """Queue a request; returns its id (resolved by ``run()``).
        ``seed`` names its sampling stream (default: the request id).
        ``resume_from=g`` declares the prompt's last ``g`` tokens the
        request's own earlier output: its first pick draws at stream
        counter ``g``, so a seeded continuation is the uninterrupted
        stream's (greedy resumes for free)."""
        prompt = self.validate_request(prompt, max_new_tokens, seed,
                                       resume_from)
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, prompt, max_new_tokens,
                            rid if seed is None else seed, resume_from))
        events.instant("engine/queued", rid=rid, prompt_len=len(prompt),
                       max_new=max_new_tokens)
        return rid

    @thread_role("driver", "main")
    def cancel(self, request_id: int) -> bool:
        """Abandon a live request: drop it from the queue, discard its
        staged partial prefill (its claim's blocks free at once: the
        batch-1 caches never touched the pool), or release its decoding
        lane (its prompt blocks stay radix-held, the generated tail is
        dropped; a chunk in flight is trimmed at its harvest, and the
        lane is pointed at scratch in both pools before the next
        dispatch).  False when the id is unknown or already finished."""
        for i, item in enumerate(self._queue):
            if item[0] == request_id:
                del self._queue[i]
                events.instant("engine/cancel", rid=request_id,
                               where="queued")
                return True
        for slot, task in self._staging.items():
            if task.request_id == request_id:
                if task.kv is not None:
                    self._kv_release(task.kv)
                del self._staging[slot]
                events.instant("engine/cancel", rid=request_id,
                               where="staged")
                return True
        for slot, state in enumerate(self._slot_states):
            if state is not None and state.request_id == request_id:
                # Paged: the prompt blocks stay radix-held.  Linear: the
                # strip's rows go stale-but-invisible until the next
                # insert pins the slot again.
                self._lane_release(slot)
                self._slot_states[slot] = None
                events.instant("engine/cancel", rid=request_id,
                               where="slot")
                return True
        return False

    def pending(self) -> int:
        """Requests not yet finished (queued + staged + decoding)."""
        return (len(self._queue) + len(self._staging)
                + sum(s is not None for s in self._slot_states))

    def active_slots(self) -> int:
        """Slots occupied by a request, decoding or staged mid-prefill."""
        return (sum(s is not None for s in self._slot_states)
                + len(self._staging))

    def staged_rids(self) -> tuple:
        """Request ids whose prefill is staged in a reserved lane."""
        return tuple(t.request_id for t in self._staging.values())

    def queue_depth(self) -> int:
        """Requests accepted but not yet in a slot."""
        return len(self._queue)

    def progress(self) -> dict:
        """``{request_id: len(prompt + generated)}`` of every decoding
        request."""
        return {s.request_id: len(s.tokens)
                for s in self._slot_states if s is not None}

    def snapshot(self) -> dict:
        """``{request_id: prompt + generated so far}`` of every decoding
        request (copies)."""
        return {s.request_id: list(s.tokens)
                for s in self._slot_states if s is not None}

    def _active(self) -> bool:
        return any(s is not None for s in self._slot_states)

    # -- paged-pool admission ----------------------------------------------

    def _kv_claim(self, rid: int, prompt, max_new: int):
        """Claim a lane's blocks: radix-match the prompt's block-aligned
        prefix (one more reference per shared block), allocate the rest,
        evicting LRU retired prefixes under pressure.  None when the pool
        cannot supply them (admission refused; counted once per
        request)."""
        bs = self.kv_block_size
        need = -(-min(len(prompt) + max_new, self.cache_len) // bs)
        retry = rid == self._kv_refused_rid
        matched, shared = ((0, []) if self._exact_prefill
                           else self._radix.match(prompt, record=not retry))
        for b in shared:
            self._kv_pool.ref(b)
        n_owned = need - len(shared)
        # A starved queue head retries every step: one span per request.
        with (contextlib.nullcontext() if retry
              else events.span("kv/alloc", rid=rid, blocks=n_owned,
                               shared=len(shared))):
            owned = self._kv_pool.alloc(n_owned)
            if owned is None:
                self._evict_for(n_owned)
                owned = self._kv_pool.alloc(n_owned)
        if owned is None:
            for b in shared:
                self._kv_pool.deref(b)
            if self._kv_refused_rid != rid:
                self._kv_refused_rid = rid
                with self._stats_lock:
                    self.kv_stats["alloc_refusals"] += 1
                events.instant("kv/refused", rid=rid, blocks=n_owned)
            return None
        if matched:
            with self._stats_lock:
                self.kv_stats["prefix_hits"] += 1
                self.kv_stats["prefix_hit_tokens"] += matched
            events.instant("kv/prefix_hit", rid=rid, tokens=matched)
        return serving_kv.LaneKV(request_id=rid, matched=matched,
                                 shared=shared, owned=owned)

    def _evict_for(self, n: int) -> None:
        """LRU-evict retired radix blocks until ``n`` are free."""
        evicted = self._radix.evict_for(n)
        if evicted:
            with self._stats_lock:
                self.kv_stats["evictions"] += evicted
            events.instant("kv/evict", blocks=evicted)

    def _kv_release(self, kv) -> None:
        for b in kv.blocks():
            self._kv_pool.deref(b)

    def _kv_table(self, kv) -> torch.Tensor:
        """The lane's device block-table row (scratch-padded)."""
        return self._to_device(np.asarray(kv.table(self._kv_nblk_lane),
                                          np.int32))

    def _lane_claim(self, slot: int, kv, prompt) -> None:
        """Install a lane's claim and feed the radix index with the
        prompt's full blocks, so later requests share them at once."""
        self._lane_kv[slot] = kv
        self._stale_slots.discard(slot)
        if not self._exact_prefill:
            table = kv.table(self._kv_nblk_lane)
            self._radix.insert(prompt, lambda j: table[j])

    def _lane_release(self, slot: int, tokens=None) -> None:
        """Retire or cancel a lane: with ``tokens``, cache its generated
        full blocks in the radix index (rows are valid up to
        ``len(tokens) - 1``: the last token was never fed back); drop its
        references, mark it stale."""
        kv = self._lane_kv[slot]
        if kv is None:
            return
        if tokens is not None and not self._exact_prefill:
            bs = self.kv_block_size
            keep = tokens[:((len(tokens) - 1) // bs) * bs]
            table = kv.table(self._kv_nblk_lane)
            self._radix.insert(keep, lambda j: table[j])
        self._kv_release(kv)
        self._lane_kv[slot] = None
        self._stale_slots.add(slot)

    def _match_prefix(self, prompt, touch: bool = False):
        """Longest preloaded prefix the prompt strictly extends ->
        (its length, its (target, draft) caches), (0, None) when none.
        ``touch`` makes the winner the most recently used: admission
        passes True, validation False."""
        with self._prefix_lock:     # handler threads validate meanwhile
            best, best_key, best_pair = 0, None, None
            for toks, pair in self._prefix_caches.items():
                m = len(toks)
                if best < m < len(prompt) and prompt[:m] == list(toks):
                    best, best_key, best_pair = m, toks, pair
            if touch and best_key is not None:
                self._prefix_caches.move_to_end(best_key)
            return best, best_pair

    def _admission_match(self, kv, prompt):
        """(pre_len, pre_pair): the radix match, unless a preloaded pair
        covers more (a sub-block tail only the pair holds); the linear
        engine has the pairs alone."""
        pre_len, pre_pair = (0 if kv is None else kv.matched), None
        lin_len, lin_pair = self._match_prefix(prompt, touch=True)
        if lin_len > pre_len:
            pre_len, pre_pair = lin_len, lin_pair
        return pre_len, pre_pair

    @memory_budget(
        pool=lambda self, pre_pair, kv, table_row, draft:
            ("draft_prefill" if draft else "prefill_cache"),
        budget_fn=lambda self, *a, **k: self.hbm_budget_bytes,
        project_fn=lambda self, pre_pair, kv, table_row, draft:
            memcheck.tree_bytes(self._cache_struct(1, draft=draft)),
        lifetime="leaf")
    def _admission_cache_1(self, pre_pair, kv, table_row,
                           draft: bool) -> KVCache:
        """The batch-1 cache a request's suffix prefill appends to: a copy
        of the preloaded pair's cache when it won the match, fresh when
        nothing matched, else the pool gather of the shared rows."""
        if pre_pair is not None:
            c = pre_pair[1 if draft else 0]
            return KVCache(layers=[{k: v.clone() for k, v in lc.items()}
                                   for lc in c.layers],
                           index=c.index.clone(), cache_len=c.cache_len)
        if kv is None or kv.matched == 0:
            return self._fresh_cache(draft=draft)
        return self._gather_prefix(table_row, kv.matched, draft)

    def _pieces_for(self, m: int):
        """(piece_len, n_pieces) for prefilling an m-token span: one
        exact-length piece for a dense-dispatch MoE."""
        if self._exact_prefill:
            return m, 1
        if self.prefill_chunk is not None:
            return self.prefill_chunk, -(-m // self.prefill_chunk)
        piece = _bucket_len(min(m, self.prompt_buckets[-1]),
                            self.prompt_buckets)
        return piece, -(-m // piece)

    def _padded(self, work):
        m = len(work)
        piece, n_pieces = self._pieces_for(m)
        padded = np.zeros((1, piece * n_pieces), np.int64)
        padded[0, :m] = work
        return padded, piece, n_pieces

    def _run_piece(self, cache_1: KVCache, padded: np.ndarray, piece: int,
                   i: int, m: int, seed: int, draft: bool, rng0: int = 0):
        """Piece ``i`` of a prefill — the one per-piece rule of atomic
        and staged admission alike.  The target returns the pick at the
        last real row (meaningful on the last piece), drawn at stream
        counter ``rng0``; the draft only needs its rows, over the same
        piece grid."""
        toks = self._to_device(padded[:, i * piece:(i + 1) * piece])
        if draft:
            self._draft(toks, cache_1)
            return None
        local = min(m - 1 - i * piece, piece - 1)
        return self._prefill_piece(cache_1, toks, max(local, 0), seed, rng0)

    def _prefill_tokens(self, work, *, seed: int, cache_1: KVCache,
                        draft: bool = False, rng0: int = 0):
        """Append ``work`` to ``cache_1`` in pieces (request suffixes and
        preloaded prefixes alike); returns the target's pick at the last
        real row (a device scalar; None for the draft)."""
        padded, piece, n_pieces = self._padded(work)
        first = None
        for i in range(n_pieces):
            first = self._run_piece(cache_1, padded, piece, i, len(work),
                                    seed, draft, rng0)
        return first

    def _fill_free_slots(self) -> None:
        """Atomic admission (``prefill_budget=0`` / TTD_NO_INTERLEAVE):
        each free slot takes queued requests until one occupies it (a
        request resolved at prefill — one token, or EOS first — leaves
        the slot free for the next); decoding lanes wait it out, and
        ``prefill_stats['stall_s']`` charges that time."""
        stalled = self._active()
        t0 = time.perf_counter()
        prefilled = 0
        for slot in range(self.slots):
            while self._slot_states[slot] is None and self._queue:
                item = self._queue.popleft()
                rid, prompt, max_new = item[:3]
                if max_new == 0:
                    self._outputs[rid] = list(prompt)
                    continue
                n = self._admit(slot, item)
                if n is None:
                    # Refused: keep FIFO order; blocks free as lanes
                    # retire.
                    self._queue.appendleft(item)
                    self._note_prefill(t0, prefilled, stalled)
                    return
                prefilled += n
        self._note_prefill(t0, prefilled, stalled)

    def _admit(self, slot: int, item) -> Optional[int]:
        """Claim, prefill and insert one queued request into ``slot`` (or
        resolve it at prefill); returns the tokens prefilled, None when
        the pool refuses its blocks.  Its batch-1 caches die at the
        return, so the next admission's are not held beside them (the
        budget counts one prefill pair)."""
        rid, prompt, max_new, seed, resume = item
        kv = table_row = None
        if self.paged:
            kv = self._kv_claim(rid, prompt, max_new)
            if kv is None:
                return None
            table_row = self._kv_table(kv)
        pre_len, pre_pair = self._admission_match(kv, prompt)
        work = prompt[pre_len:]
        with events.span("prefill/request", rid=rid, tokens=len(work)):
            caches_1 = [self._admission_cache_1(pre_pair, kv, table_row,
                                                False)]
            first = int(self._prefill_tokens(work, seed=seed,
                                             cache_1=caches_1[0],
                                             rng0=resume))
        state = _SlotState(request_id=rid, remaining=max_new - 1,
                           tokens=list(prompt) + [first], last_token=first,
                           seed=seed, count=resume + 1)
        if max_new == 1 or (self.eos_id is not None and first == self.eos_id):
            # Resolved before the draft's prefill, which it would waste;
            # its blocks were never written.
            if kv is not None:
                self._kv_release(kv)
            self._outputs[rid] = state.tokens
            return len(work)
        with events.span("prefill/insert", rid=rid):
            if self._draft is not None:
                caches_1.append(self._admission_cache_1(pre_pair, kv,
                                                        table_row, True))
                self._prefill_tokens(work, seed=seed, cache_1=caches_1[1],
                                     draft=True)
            self._install(caches_1, slot, kv, table_row, len(prompt))
        if kv is not None:
            self._lane_claim(slot, kv, prompt)
        self._slot_states[slot] = state
        # The next dispatch splices this slot's host token and counter
        # over the device carry (the previous tenant's).
        self._refills.add(slot)
        events.instant("slot/insert", rid=rid, slot=slot)
        return len(work)

    def _note_prefill(self, t0: float, tokens: int, stalled: bool) -> None:
        if tokens:
            dt = time.perf_counter() - t0
            self.stats["prefill_s"] += dt
            self.stats["prefill_tokens"] += tokens
            if stalled:
                with self._stats_lock:
                    self.prefill_stats["stall_s"] += dt

    # -- staged prefill (decode-priority interleaving) -----------------------

    def _stage_from_queue(self) -> None:
        """Claim free lanes for queued requests as staged tasks.  Host
        bookkeeping only (a block claim and the lane's table row): no
        piece runs until an installment advances the task."""
        for slot in range(self.slots):
            if not self._queue:
                return
            if self._slot_states[slot] is not None or slot in self._staging:
                continue
            while self._queue:
                item = self._queue.popleft()
                rid, prompt, max_new, seed, resume = item
                if max_new == 0:
                    self._outputs[rid] = list(prompt)
                    continue
                kv = None
                if self.paged:
                    kv = self._kv_claim(rid, prompt, max_new)
                    if kv is None:
                        # FIFO: nothing behind the refused head may jump
                        # it.
                        self._queue.appendleft(item)
                        return
                pre_len, pre_pair = self._admission_match(kv, prompt)
                work = prompt[pre_len:]
                padded, piece, n_pieces = self._padded(work)
                self._staging[slot] = _PrefillTask(
                    request_id=rid, prompt=list(prompt), max_new=max_new,
                    seed=seed, work=work, padded=padded, piece=piece,
                    n_pieces=n_pieces, kv=kv,
                    table=None if kv is None else self._kv_table(kv),
                    resume=resume, pre_pair=pre_pair)
                with self._stats_lock:
                    self.prefill_stats["staged_requests"] += 1
                self.stats["prefill_tokens"] += len(work)
                break

    def _finalize_prefill(self, slot: int, task: _PrefillTask) -> None:
        """Both caches complete: insert them into the grids and flip the
        lane to decoding."""
        first = task.first_host
        caches_1 = [task.cache_1] + (
            [] if self._draft is None else [task.d_cache_1])
        self._install(caches_1, slot, task.kv, task.table, len(task.prompt))
        if task.kv is not None:
            self._lane_claim(slot, task.kv, task.prompt)
        del self._staging[slot]
        self._slot_states[slot] = _SlotState(
            request_id=task.request_id, remaining=task.max_new - 1,
            tokens=list(task.prompt) + [first], last_token=first,
            seed=task.seed, count=task.resume + 1)
        self._refills.add(slot)
        events.instant("slot/insert", rid=task.request_id, slot=slot)

    def _advance_piece(self, slot: int, task: _PrefillTask) -> int:
        """Run one installment of ``task`` — its next target piece, or
        once those are done its next draft piece, exactly the program
        atomic admission runs at this position — plus the insert after
        the last; returns its token cost."""
        with events.span("prefill/piece", rid=task.request_id,
                         piece=task.cursor + task.d_cursor,
                         n_pieces=task.n_pieces):
            if task.cursor < task.n_pieces:
                if task.cache_1 is None:
                    task.cache_1 = self._admission_cache_1(
                        task.pre_pair, task.kv, task.table, False)
                task.first = self._run_piece(
                    task.cache_1, task.padded, task.piece, task.cursor,
                    len(task.work), task.seed, False, task.resume)
                task.cursor += 1
                if task.cursor == task.n_pieces:
                    # Reading the first token waits for this piece; the
                    # chunk queued ahead keeps the device busy meanwhile.
                    first = int(task.first)
                    task.first_host = first
                    if task.max_new == 1 or (self.eos_id is not None
                                             and first == self.eos_id):
                        if task.kv is not None:    # blocks never written
                            self._kv_release(task.kv)
                        self._outputs[task.request_id] = (
                            list(task.prompt) + [first])
                        del self._staging[slot]
                    elif self._draft is None:
                        self._finalize_prefill(slot, task)
                return task.piece
            if task.d_cache_1 is None:
                task.d_cache_1 = self._admission_cache_1(
                    task.pre_pair, task.kv, task.table, True)
            self._run_piece(task.d_cache_1, task.padded, task.piece,
                            task.d_cursor, len(task.work), task.seed, True)
            task.d_cursor += 1
            if task.d_cursor == task.n_pieces:
                self._finalize_prefill(slot, task)
            return task.piece

    def _advance_prefills(self, hidden: bool) -> None:
        """Advance staged prefills by at most ``prefill_budget`` tokens
        (default one piece) in arrival order.  ``hidden``: a decode chunk
        is queued ahead of this work, so decoding lanes lose no cadence
        and no stall is charged.  With no lane decoding the budget is
        waived: admission runs at full speed."""
        self._stage_from_queue()
        if not self._staging:
            return
        decoding = self._active()
        t0 = time.perf_counter()
        spent = 0
        while self._staging:
            slot = next(iter(self._staging))
            spent += self._advance_piece(slot, self._staging[slot])
            with self._stats_lock:
                self.prefill_stats["installments"] += 1
            if slot not in self._staging:
                # Resolved or inserted: restage so the freed budget flows
                # to the next queued request.
                self._stage_from_queue()
            if decoding and (self.prefill_budget is None
                             or spent >= self.prefill_budget):
                break
        dt = time.perf_counter() - t0
        self.stats["prefill_s"] += dt
        if decoding and not hidden:
            with self._stats_lock:
                self.prefill_stats["stall_s"] += dt

    @thread_role("handler", "driver")
    def prefill_stall_s(self) -> float:
        """Seconds decoding lanes spent blocked behind admission prefill
        (prefill run while a lane decoded with no chunk in flight to
        hide it); ``ttd_engine_prefill_stall_seconds``, scraped from
        handler threads, so the read locks."""
        with self._stats_lock:
            return self.prefill_stats["stall_s"]

    # -- harvest -----------------------------------------------------------

    def _consume(self, state: _SlotState, tokens) -> int:
        """Append generated tokens under the budget and EOS rules (the one
        termination rule of chunks and speculative rounds); returns how
        many were taken."""
        taken = 0
        for t in tokens:
            t = int(t)
            state.tokens.append(t)
            state.last_token = t
            state.count += 1
            state.remaining -= 1
            taken += 1
            if (state.remaining <= 0
                    or (self.eos_id is not None and t == self.eos_id)):
                state.done = True
                break
        return taken

    def _retire_if_done(self, slot: int, state: _SlotState) -> None:
        if state.done:
            self._lane_release(slot, state.tokens)
            self._outputs[state.request_id] = state.tokens
            self._slot_states[slot] = None
            events.instant("slot/retire", rid=state.request_id, slot=slot,
                           tokens=len(state.tokens))

    def _live(self, rids):
        """(slot, state) of each slot still held by the request it held at
        dispatch: a slot retired or refilled since holds the previous
        tenant's overshoot, which is trimmed."""
        for slot, state in enumerate(self._slot_states):
            if state is not None and state.request_id == rids[slot]:
                yield slot, state

    def _record(self, state: _SlotState, logits, slot: int,
                taken: int) -> None:
        if logits is not None:
            self.decode_logits.setdefault(state.request_id, []).extend(
                logits[slot, :taken])

    def _harvest(self, toks: np.ndarray, rids, logits) -> None:
        for slot, state in self._live(rids):
            self._record(state, logits, slot, self._consume(state,
                                                            toks[slot]))
            self._retire_if_done(slot, state)

    def _harvest_spec(self, emit: np.ndarray, emitted: np.ndarray,
                      accepted: np.ndarray, k: int, rids, logits) -> None:
        """Consume each slot's emitted prefix of a round (the bonus token
        is the last, so a surviving slot's ``last_token`` is the next
        round's input) and count acceptance at the depth ``k`` the round
        was dispatched at; the controller observes the round once."""
        n_slots = acc_sum = 0
        slot_rounds = drafted = accepted_n = emitted_n = 0
        for slot, state in self._live(rids):
            taken = self._consume(state, emit[slot, :int(emitted[slot])])
            self._record(state, logits, slot, taken)
            n_slots += 1
            acc_sum += int(accepted[slot])
            slot_rounds += 1
            drafted += k
            accepted_n += int(accepted[slot])
            emitted_n += taken
            self._retire_if_done(slot, state)
        with self._stats_lock:
            s = self.spec_stats
            s["rounds"] += 1
            s["slot_rounds"] += slot_rounds
            s["drafted"] += drafted
            s["drafted_accepted"] += accepted_n
            s["emitted"] += emitted_n
            if self._spec_ctrl is not None:
                # Every harvested round is observed, a fully trimmed one
                # too: the controller's decisions stay a function of the
                # requests.
                self._spec_ctrl.observe(k * n_slots, acc_sum)

    def _spec_depth(self) -> int:
        """Depth of the next round: the controller's pick, else the fixed
        ``speculative_k`` (0 on a plain engine)."""
        with self._stats_lock:
            ctrl = self._spec_ctrl
            return self._spec_k if ctrl is None else ctrl.depth()

    @thread_role("handler", "driver")
    def spec_depth(self) -> int:
        """Scrape face of ``_spec_depth`` (``ttd_engine_spec_depth``)."""
        return self._spec_depth()

    @thread_role("handler", "driver")
    def spec_accepted_tokens(self) -> int:
        """Draft tokens the target accepted, over all rounds
        (``ttd_engine_spec_accepted_tokens_total``)."""
        with self._stats_lock:
            return self.spec_stats["drafted_accepted"]

    @thread_role("handler", "driver")
    def spec_drafted_tokens(self) -> int:
        """Draft tokens proposed, over all rounds
        (``ttd_engine_spec_drafted_tokens_total``)."""
        with self._stats_lock:
            return self.spec_stats["drafted"]

    def spec_telemetry(self) -> dict:
        """The depth controller's telemetry ({} at a fixed depth)."""
        with self._stats_lock:
            ctrl = self._spec_ctrl
            return {} if ctrl is None else ctrl.telemetry()

    @thread_role("handler", "driver")
    def kv_prefix_hit_tokens(self) -> int:
        """Prompt tokens whose prefill a radix hit skipped
        (``ttd_engine_prefix_hit_tokens_total``; scraped, so it locks)."""
        with self._stats_lock:
            return self.kv_stats["prefix_hit_tokens"]

    @thread_role("handler", "driver")
    def kv_evictions(self) -> int:
        """Radix blocks LRU-evicted under pressure
        (``ttd_engine_kv_evictions_total``)."""
        with self._stats_lock:
            return self.kv_stats["evictions"]

    # -- dispatch: the one-chunk overlap -------------------------------------

    @dispatch_critical
    def _carry_arrays(self):
        """The next dispatch's (token, counters) on the device: the
        previous dispatch's carry with the host values of slots refilled
        since spliced in (``torch.where``: no host wait).  Without a carry
        (first dispatch, or the synchronous path) all come from the
        host."""
        if self._carry is None:
            tok = np.zeros((self.slots,), np.int64)
            counts = np.zeros((self.slots,), np.int64)
            for slot, state in enumerate(self._slot_states):
                if state is not None:
                    tok[slot] = state.last_token
                    counts[slot] = state.count
            self._refills.clear()
            return self._to_device(tok), self._to_device(counts)
        tok, counts = self._carry
        if self._refills:
            mask = np.zeros((self.slots,), bool)
            tok_h = np.zeros((self.slots,), np.int64)
            cnt_h = np.zeros((self.slots,), np.int64)
            for slot in self._refills:
                state = self._slot_states[slot]
                if state is not None:
                    mask[slot] = True
                    tok_h[slot] = state.last_token
                    cnt_h[slot] = state.count
            m = self._to_device(mask)
            tok = torch.where(m, self._to_device(tok_h), tok)
            counts = torch.where(m, self._to_device(cnt_h), counts)
            self._refills.clear()
        return tok, counts

    @dispatch_critical
    def _dispatch_chunk(self) -> None:
        """Enqueue one decode chunk (or speculative round) for all slots
        from the carry and start its tokens' copy to the host; the host
        does not wait.  Records the slot -> request map the harvest's
        trim needs and the round's depth."""
        t0 = time.perf_counter()
        seeds = np.zeros((self.slots,), np.int64)
        rids: list = [None] * self.slots
        for slot, state in enumerate(self._slot_states):
            if state is not None:
                seeds[slot] = state.seed
                rids[slot] = state.request_id
        k = self._spec_depth()
        with events.span("decode/dispatch",
                         active=sum(r is not None for r in rids),
                         fused=int(self.paged), spec_k=k):  # ttd-lint: disable=dispatch -- a host bool
            self._flush_stale_lanes()
            tok, counts = self._carry_arrays()
            seeds_d = self._to_device(seeds)
            if self._draft is not None:
                (emit, emitted, nxt, acc, counts_next,
                 logits) = self._spec_round(tok, seeds_d, counts, k)
                # A continuing slot took exactly ``emitted`` tokens, so
                # the device advances its counter itself: round N+1 needs
                # no copy of round N.
                self._carry = (nxt, counts_next)
                inflight = {"spec": True, "k": k,
                            "host": self._to_host(emit, emitted, acc)}
                self.stats["decode_steps"] += 1
            else:
                toks, last, counts_next, logits = self._decode_chunk(
                    tok, seeds_d, counts)
                self._carry = (last, counts_next)
                inflight = {"spec": False, "host": self._to_host(toks)}
                self.stats["decode_steps"] += self.chunk
        self._inflight = dict(inflight, rids=rids, logits=logits)
        with self._stats_lock:
            self.overlap_stats["chunks"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0

    @dispatch_critical
    def _skip_eager_dispatch(self) -> bool:
        """Harvest first for this one step when every active slot
        certainly retires in the chunk in flight (budget exhaustion is
        known on the host, EOS is not): an eager successor would be
        garbage end to end.  A plain chunk emits ``chunk`` tokens a lane;
        a speculative round guarantees only one."""
        horizon = 1 if self._draft is not None else self.chunk
        certain = [s.remaining <= horizon
                   for s in self._slot_states if s is not None]
        return bool(certain) and all(certain)  # ttd-lint: disable=dispatch -- a host list of bools

    def _harvest_prev(self, inf: dict, overlapped: bool) -> None:
        """Wait for ``inf``'s tokens — its event only: when
        ``overlapped`` the successor is queued behind it and keeps the
        device busy — and consume them under the dispatch-time trim.  The
        wait counts as decode time; only the host pass after it goes into
        ``overlap_stats``."""
        t0 = time.perf_counter()
        host, event = inf["host"]
        with events.span("decode/wait", overlapped=overlapped):
            if event is not None:
                event.synchronize()
            arrays = [h.numpy() for h in host]
        t1 = time.perf_counter()
        self.stats["decode_s"] += t1 - t0
        with events.span("decode/harvest", overlapped=overlapped):
            if inf["spec"]:
                self._harvest_spec(*arrays, inf["k"], inf["rids"],
                                   inf["logits"])
            else:
                self._harvest(arrays[0], inf["rids"], inf["logits"])
        dt = time.perf_counter() - t1
        with self._stats_lock:
            o = self.overlap_stats
            o["harvest_s"] += dt
            if overlapped:
                o["overlapped_harvests"] += 1
                o["overlapped_harvest_s"] += dt

    @thread_role("handler", "driver")
    def overlap_ratio(self) -> float:
        """Share of the harvests' host time spent with a successor chunk
        in flight (0.0 on the synchronous path); ``ttd_engine_overlap_ratio``,
        read under ``_stats_lock`` so a scrape never sees a torn pair."""
        with self._stats_lock:
            num = self.overlap_stats["overlapped_harvest_s"]
            total = self.overlap_stats["harvest_s"]
        if total <= 0.0:
            return 0.0
        return min(1.0, num / total)

    @thread_role("driver", "main")
    @torch.no_grad()
    def serve_step(self) -> dict:
        """One iteration; returns the requests that finished,
        ``{request_id: tokens}``.  With ``overlap`` the step is
        pipelined: the successor chunk is dispatched from the device carry
        before the chunk in flight is harvested, one installment of
        staged prefill is queued behind it (``interleave``), and lanes the
        harvest freed stage at once.  A finished session may leave one
        garbage chunk in flight; the next harvest trims it."""
        if not self.overlap:
            return self._serve_step_sync()
        if not self.interleave:
            return self._serve_step_overlap_atomic()
        prev, self._inflight = self._inflight, None
        dispatched = False
        if self._active() and not self._skip_eager_dispatch():
            self._dispatch_chunk()
            dispatched = True
        self._advance_prefills(hidden=dispatched or prev is not None)
        if prev is not None:
            self._harvest_prev(prev, overlapped=dispatched)
        self._stage_from_queue()
        if not dispatched and self._active():
            # Nothing was in flight to hide this pass behind: dispatch
            # now so the next step's harvest overlaps.
            self._dispatch_chunk()
        out, self._outputs = self._outputs, {}
        return out

    def _serve_step_overlap_atomic(self) -> dict:
        """The pipelined step with atomic admission."""
        prev, self._inflight = self._inflight, None
        if self._queue and any(s is None for s in self._slot_states):
            # Requests that arrived since the last harvest ride the very
            # next chunk.
            self._fill_free_slots()
        dispatched = False
        if self._active() and not self._skip_eager_dispatch():
            self._dispatch_chunk()
            dispatched = True
        if prev is not None:
            self._harvest_prev(prev, overlapped=dispatched)
        self._fill_free_slots()
        if not dispatched and self._active():
            self._dispatch_chunk()
        out, self._outputs = self._outputs, {}
        return out

    def _serve_step_sync(self) -> dict:
        """Admit (staged installments unless interleaving is off too),
        dispatch one chunk from host values, wait for it and harvest:
        nothing lags, and the device idles through every host pass."""
        if self.interleave:
            self._advance_prefills(hidden=False)
        else:
            self._fill_free_slots()
        if self._active():
            self._carry = None
            self._dispatch_chunk()
            inf, self._inflight = self._inflight, None
            self._harvest_prev(inf, overlapped=False)
        out, self._outputs = self._outputs, {}
        return out

    @thread_role("main", "driver")
    def run(self) -> dict:
        """Serve every submitted request to completion; returns
        ``{request_id: prompt + generated tokens}``."""
        out: dict = {}
        while self.pending():
            out.update(self.serve_step())
        return out

    def kv_blocks_in_use(self) -> int:
        """Blocks referenced by live lanes and the radix cache (0 on the
        linear engine)."""
        return self._kv_pool.blocks_in_use() if self.paged else 0

    def kv_blocks_total(self) -> int:
        """Allocatable physical blocks in the paged pool (0 on the linear
        engine)."""
        return self._kv_pool.n_blocks if self.paged else 0

    def kv_bytes_in_use(self) -> int:
        """Referenced pool blocks in device bytes (live lanes and the
        radix cache, target and draft pools; 0 on the linear engine)."""
        return self._kv_pool.bytes_in_use() if self.paged else 0

    def kv_pool_bytes(self) -> int:
        """Device bytes the paged pools pin (target and draft, int8 scale
        pools included; 0 on the linear engine); constant per engine."""
        return self._kv_pool_bytes

    # -- HBM autosizing ----------------------------------------------------

    def _prefill_pair_bytes(self) -> int:
        """Bytes of one batch-1 prefill cache pair (target and draft):
        what an admission mints (memoized, from the meta caches)."""
        if self._prefill_bytes_memo is None:
            n = memcheck.tree_bytes(self._cache_struct(1))
            if self._draft is not None:
                n += memcheck.tree_bytes(self._cache_struct(1, draft=True))
            self._prefill_bytes_memo = n
        return self._prefill_bytes_memo

    def hbm_autosized_bytes(self) -> int:
        """The budget the autosize solve installed (0 when the engine was
        sized by hand or the solve was switched off)."""
        return self._hbm_autosized

    def _solve_hbm_autosize(self) -> tuple:
        """``kv_pool_blocks='auto'``: (kv_pool_blocks, hbm_budget_bytes).
        The grids' bytes are linear in the block count (the pools' rows
        scale; the block table, the positions and the scratch block do
        not), so two probes (n = 1, 2) of the grids built on the meta
        device give the slope and the intercept, and the solve takes the
        largest n with

            grid_bytes(n) + one batch-1 prefill pair
                <= device bytes * (1 - hbm_headroom)

        The right side becomes the budget, which the sanitizer then
        enforces: the engine's own pools and admissions fit by
        construction.  Nothing is allocated."""
        avail = _device_hbm_bytes(self.device)
        if avail is None:
            raise ValueError(
                "kv_pool_blocks='auto' needs a device memory report "
                "(torch.cuda.mem_get_info) or TTD_HBM_BYTES=<bytes>")

        def grid_bytes(n):
            return sum(memcheck.tree_bytes(self._init_cache(
                self.slots, draft, True, "meta", n_blocks=n))
                for draft in ((False, True) if self._draft is not None
                              else (False,)))

        trans = self._prefill_pair_bytes()
        b1, b2 = grid_bytes(1), grid_bytes(2)
        slope, intercept = b2 - b1, 2 * b1 - b2
        usable = int(avail * (1.0 - self._hbm_headroom))
        n = (usable - intercept - trans) // slope
        if n < 1:
            raise ValueError(
                f"kv_pool_blocks='auto': no pool fits — device HBM "
                f"{avail} bytes minus {self._hbm_headroom:.0%} headroom "
                f"leaves {usable}, but one block of pools plus batch-1 "
                f"prefill transients needs "
                f"{intercept + slope + trans} (shrink hbm_headroom, "
                f"slots, or cache_len)")
        return int(n), usable

    # -- preloaded prefixes ------------------------------------------------

    @thread_role("main", "driver")
    @torch.no_grad()
    def preload_prefix(self, tokens) -> None:
        """Prefill a shared prompt prefix once; every later request whose
        prompt strictly extends it prefills only the suffix.  The batch-1
        cache (and the draft's, under speculation) is kept, position
        pinned to the prefix's true length, in an LRU of
        ``prefix_cache_limit`` entries.  A later request starts from a
        copy of it (the linear engine), or (paged) the prefix's full
        blocks seed the radix index (``_seed_radix_from_cache``), so the
        request copies them out of the pool with the paged KV gather and
        takes a sub-block tail from the stored cache."""
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if not tokens:
            raise ValueError("empty prefix")
        if self._exact_prefill:
            raise ValueError(
                "prefix caching needs length-independent routing; "
                "dense-dispatch MoE prefills at the exact prompt length "
                "(dispatch='gmm' supports prefix caching)")
        n = len(tokens)
        if n >= self.cache_len:
            raise ValueError(f"prefix length {n} must leave cache room "
                             f"(cache_len={self.cache_len})")
        with events.span("prefill/prefix", tokens=n):
            cache_1 = self._fresh_cache()
            self._prefill_tokens(tokens, seed=0, cache_1=cache_1)
            cache_1.index.fill_(n)
            d_cache_1 = None
            if self._draft is not None:
                d_cache_1 = self._fresh_cache(draft=True)
                self._prefill_tokens(tokens, seed=0, cache_1=d_cache_1,
                                     draft=True)
                d_cache_1.index.fill_(n)
        key = tuple(tokens)
        with self._prefix_lock:
            self._prefix_caches[key] = (cache_1, d_cache_1)
            self._prefix_caches.move_to_end(key)
            while len(self._prefix_caches) > self.prefix_cache_limit:
                self._prefix_caches.popitem(last=False)
        # The stored pair lives until LRU eviction: the ledger charges it
        # until its tensors die, so an unbounded preload pattern trips
        # the budget here.
        memcheck.track(self, "prefix_cache", (cache_1, d_cache_1),
                       label=f"prefix{n}", budget=self.hbm_budget_bytes)
        if self.paged:
            self._seed_radix_from_cache(tokens, cache_1, d_cache_1)

    def _seed_radix_from_cache(self, tokens, cache_1: KVCache,
                               d_cache_1: Optional[KVCache]) -> None:
        """Scatter a prefix's full blocks from its batch-1 caches into
        freshly allocated pool blocks and hand them to the radix index
        (tree-held: shared by every later matching request, evicted only
        under pressure).  Blocks the radix already holds are pinned and
        skipped; a pool too busy to supply the rest leaves the prefix to
        its batch-1 caches alone."""
        bs = self.kv_block_size
        m = len(tokens) // bs
        if m == 0:
            return                        # sub-block prefix: pair only
        matched, shared = self._radix.match(tokens[:m * bs],
                                            allow_full=True)
        if matched >= m * bs:
            return
        # Pin the cached leading blocks against the eviction our own
        # allocation may trigger.
        for b in shared:
            self._kv_pool.ref(b)
        try:
            n_new = m - len(shared)
            fresh = self._kv_pool.alloc(n_new)
            if fresh is None:
                self._evict_for(n_new)
                fresh = self._kv_pool.alloc(n_new)
            if fresh is None:
                logger.warning(
                    "preload_prefix: KV pool too busy to share the "
                    "prefix's %d blocks (%d free); the batch-1 cache "
                    "still serves it", n_new, self._kv_pool.free_blocks())
                return
            row = shared + fresh
            table = np.zeros((self._kv_nblk_lane,), np.int32)
            table[:len(row)] = row
            caches_1 = [cache_1] + ([] if self._draft is None
                                    else [d_cache_1])
            self._scatter_rows(caches_1, self._to_device(table), matched,
                               m * bs)
            self._radix.insert(tokens[:m * bs], lambda j: row[j])
            # The tree took one reference per new node; release the
            # allocation's own.
            for b in fresh:
                self._kv_pool.deref(b)
        finally:
            for b in shared:
                self._kv_pool.deref(b)

    # -- KV handoff: the JAX engine's wire recipe ----------------------------

    def _wire_leaves(self, draft: bool, n: int) -> list:
        """[(path, layer, leaf name, shape)] of the row-holding leaves the
        JAX engine's batch-1 cache tree has for the target (or the
        draft), in its path-sorted order: flax module paths
        (``layer_{i}/attention/...`` unrolled, ``layers/stack/block/
        attention/...`` with a leading layer axis when scanned), shapes
        with the row axis cut to ``n``."""
        cfg = self.draft_config if draft else self.config
        kvh, hd = cfg.kv_heads, cfg.attn_head_dim
        names = ["key_cache", "value_cache"] + (
            ["kv_scales"] if cfg.kv_cache_int8 else [])
        shape = {"key_cache": [1, n, kvh, hd], "value_cache": [1, n, kvh, hd],
                 "kv_scales": [2, 1, n, kvh]}
        if cfg.scan_layers:
            out = [(("layers", "stack", "block", "attention", name), None,
                    name, [cfg.num_layers] + shape[name]) for name in names]
        else:
            out = [((f"layer_{i}", "attention", name), i, name, shape[name])
                   for i in range(cfg.num_layers) for name in names]
        return sorted(out, key=lambda leaf: leaf[0])

    def _serialize_rows(self, table_row: torch.Tensor, n: int):
        """The one wire byte recipe of every KV-bearing frame: gather the
        first ``n`` pool rows reachable through ``table_row`` into
        batch-1 linear caches (the paged KV gather kernel), cut each
        row-holding leaf to them, and concatenate their bytes in the
        manifest's order.  Returns ``(leaves, blob)``; the caller holds
        references on (or owns) the table's blocks."""
        pairs = [(False, self._gather_prefix(table_row, n, False, rows=n))]
        if self._draft is not None:
            pairs.append((True, self._gather_prefix(table_row, n, True,
                                                    rows=n)))
        leaves, chunks = [], []
        for draft, cache_1 in pairs:
            for path, layer, name, shape in self._wire_leaves(draft, n):
                if layer is None:
                    t = torch.stack([lc[name] for lc in cache_1.layers])
                else:
                    t = cache_1.layers[layer][name]
                t = t.narrow(t.dim() + (-2 if name == "kv_scales" else -3),
                             0, n).contiguous()
                assert list(t.shape) == shape
                leaves.append({"path": list(path), "draft": draft,
                               "dtype": _WIRE_DTYPES[t.dtype][0],
                               "shape": shape})
                chunks.append(t.view(torch.uint8).cpu().numpy().tobytes())
        return leaves, b"".join(chunks)

    @thread_role("main", "driver")
    @torch.no_grad()
    def export_prefix_kv(self, tokens):
        """Serialize the KV of ``tokens``' full leading blocks for a
        prefill-to-decode handoff: ``(meta, blob)``, or None when nothing
        is exportable (a sub-block prompt, a pool too busy to share).
        The head is preloaded when the radix does not hold it, then read
        back out of the pool and shipped verbatim; at least one suffix
        token stays unexported (its logit picks the first token on the
        receiving side).  A dense-dispatch MoE engine and the linear
        engine export nothing."""
        self._refuse_split("export_prefix_kv")
        if not self.paged or self._exact_prefill:
            return None
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        bs = self.kv_block_size
        m = max(0, (len(tokens) - 1) // bs)
        if m == 0:
            return None
        head = tokens[:m * bs]
        matched, shared = self._radix.match(head, allow_full=True,
                                            record=False)
        if matched < m * bs:
            self.preload_prefix(head)
            matched, shared = self._radix.match(head, allow_full=True,
                                                record=False)
        if matched < m * bs:
            return None
        for b in shared:
            self._kv_pool.ref(b)
        try:
            table = np.zeros((self._kv_nblk_lane,), np.int32)
            table[:len(shared)] = shared
            with events.span("kv/export", tokens=m * bs):
                leaves, blob = self._serialize_rows(self._to_device(table),
                                                    m * bs)
        finally:
            for b in shared:
                self._kv_pool.deref(b)
        return {"tokens": head, "n": m * bs, "draft": self._draft is not None,
                "leaves": leaves}, blob

    @thread_role("main", "driver")
    @torch.no_grad()
    def install_prefix_kv(self, meta, blob) -> int:
        """Install handed-off KV rows into the pool and the radix index;
        returns the warm-token count (0: refused, benign — the request
        prefills locally with the same output).  The wire bytes rebuild
        batch-1 caches in their exact dtypes, which seed the radix
        through ``_seed_radix_from_cache``, the path ``preload_prefix``
        takes.  A torn or lying manifest raises ValueError.  A
        dense-dispatch MoE engine and the linear engine install nothing
        (0)."""
        self._refuse_split("install_prefix_kv")
        if not self.paged or self._exact_prefill:
            return 0
        tokens = [int(t) for t in meta.get("tokens", ())]
        n = int(meta.get("n", 0))
        bs = self.kv_block_size
        if n <= 0 or n % bs or n != len(tokens):
            raise ValueError(f"bad handoff span: n={n} over "
                             f"{len(tokens)} tokens (block_size={bs})")
        if n >= self.cache_len:
            raise ValueError(f"handoff span {n} exceeds "
                             f"cache_len={self.cache_len}")
        matched, _ = self._radix.match(tokens, allow_full=True,
                                       record=False)
        if matched >= n:
            return n                      # already warm
        if bool(meta.get("draft")) != (self._draft is not None):
            return 0    # both caches must hold the same rows: prefill
        arrays, off = {}, 0
        for leaf in meta.get("leaves", ()):
            dtype = np.dtype(leaf["dtype"])
            shape = tuple(int(d) for d in leaf["shape"])
            count = int(np.prod(shape)) if shape else 1
            end = off + count * dtype.itemsize
            if end > len(blob):
                raise ValueError(
                    f"handoff blob truncated: leaf {leaf['path']} needs "
                    f"bytes [{off}, {end}) of {len(blob)}")
            arrays[(bool(leaf.get("draft")), tuple(leaf["path"]))] = (
                str(leaf["dtype"]), shape, bytes(blob[off:end]))
            off = end
        if off != len(blob):
            raise ValueError(f"handoff blob has {len(blob) - off} "
                             f"trailing bytes")

        def build(draft: bool) -> KVCache:
            cache_1 = self._fresh_cache(draft=draft)
            for path, layer, name, shape in self._wire_leaves(draft, n):
                got = arrays.get((draft, path))
                if got is None:
                    continue
                dtype, a_shape, raw = got
                layers = (cache_1.layers if layer is None
                          else [cache_1.layers[layer]])
                leaf_dtype = layers[0][name].dtype
                wire, label = _WIRE_DTYPES[leaf_dtype]
                # The manifest's own string: numpy reads "<V2" back as
                # "|V2".
                if list(a_shape) != shape or dtype != wire:
                    raise ValueError(
                        f"handoff leaf {path} is {np.dtype(dtype)}"
                        f"{list(a_shape)}, this engine needs {label}{shape}")
                t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(
                    leaf_dtype).reshape(shape).to(self.device)
                if layer is not None:
                    t = t[None]
                axis = -2 if name == "kv_scales" else -3
                for i, lc in enumerate(layers):
                    lc[name].narrow(lc[name].dim() + axis, 0, n).copy_(t[i])
            cache_1.index.fill_(n)
            return cache_1

        with events.span("kv/install", tokens=n):
            cache_1 = build(False)
            d_cache_1 = build(True) if self._draft is not None else None
            self._seed_radix_from_cache(tokens, cache_1, d_cache_1)
        matched, _ = self._radix.match(tokens, allow_full=True,
                                       record=False)
        return matched

    def _settle(self) -> None:
        """Harvest the chunk in flight (the pipelined engine), so the host
        state holds every token already generated on the device."""
        if self._inflight is not None:
            inf, self._inflight = self._inflight, None
            self._harvest_prev(inf, overlapped=False)

    @thread_role("main", "driver")
    @torch.no_grad()
    def export_lane(self, request_id: int):
        """Serialize a live request's migration state, ``(meta, blob)``,
        or None when the id is unknown or finished.  ``meta["kind"]``:

        - ``"lane"``: a decoding slot — its tokens (prompt + generated),
          ``remaining``, ``last_token``, ``seed``, ``count``, ``done``,
          and under ``meta["kv"]`` with ``blob`` the lane's full-block
          rows below ``len(tokens) - 1`` in the wire recipe
          (``_serialize_rows``; ``kv`` None for a sub-block lane and on
          the linear engine, whose target re-prefills);
        - ``"staged"``: mid-admission (parameters and the staged cursor;
          the partial prefill is not shipped);
        - ``"queued"``: parameters only.

        A chunk in flight is harvested first, so the tokens are all those
        generated so far.  Otherwise read-only: two calls between steps
        give equal ``meta`` and ``blob``; the caller decides whether the
        move committed and then ``cancel()``s here."""
        self._refuse_split("export_lane")
        self._settle()
        for item in self._queue:
            if item[0] == request_id:
                _, prompt, max_new, seed, resume = item
                return {"kind": "queued", "prompt": list(prompt),
                        "max_new": int(max_new), "seed": int(seed),
                        "resume_from": int(resume), "kv": None}, b""
        for task in self._staging.values():
            if task.request_id == request_id:
                return {"kind": "staged", "prompt": list(task.prompt),
                        "max_new": int(task.max_new), "seed": int(task.seed),
                        "resume_from": int(task.resume),
                        "cursor": int(task.cursor), "kv": None}, b""
        for slot, state in enumerate(self._slot_states):
            if state is None or state.request_id != request_id:
                continue
            meta = {"kind": "lane", "tokens": [int(t) for t in state.tokens],
                    "remaining": int(state.remaining),
                    "last_token": int(state.last_token),
                    "seed": int(state.seed), "count": int(state.count),
                    "done": bool(state.done), "kv": None}
            blob = b""
            bs = self.kv_block_size
            m = max(0, (len(state.tokens) - 1) // bs)
            kv = None if self._exact_prefill else self._lane_kv[slot]
            if kv is not None and m > 0:
                # The lane's claim holds a reference on every block of its
                # table; nothing runs between here and the gather.
                with events.span("kv/export", tokens=m * bs):
                    leaves, blob = self._serialize_rows(
                        self._kv_table(kv), m * bs)
                meta["kv"] = {"tokens": [int(t) for t in
                                         state.tokens[:m * bs]],
                              "n": m * bs, "draft": self._draft is not None,
                              "leaves": leaves}
            return meta, blob
        return None

    @thread_role("main", "driver")
    def install_lane(self, meta, blob) -> int:
        """Install a migrated lane's KV rows into the pool and the radix
        index; returns the warm-token count (0: nothing to install or
        refused — the re-admitted request prefills locally).  The request
        itself is re-admitted with ``submit(..., resume_from=)``, which
        radix-hits the rows seeded here."""
        self._refuse_split("install_lane")
        kv = meta.get("kv") if isinstance(meta, dict) else None
        if not kv or not blob:
            return 0
        return self.install_prefix_kv(dict(kv), blob)

