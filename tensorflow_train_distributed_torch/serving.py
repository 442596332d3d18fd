"""Continuous-batching serving engine over a paged KV cache.

Counterpart of the JAX package's ``serving.ServingEngine`` in its paged
mode, with its speculative decoding and its pipelined scheduler:

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

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU the kernels' plain versions run (``ops.kernels``).

Waiting for later slices: ``preload_prefix``, lane and prefix
export/install, cancellation and resume-from-token, HBM autosizing, the
linear-cache engine, int8 weights and MoE.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
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
from tensorflow_train_distributed_torch.models.layers import KVCache
from tensorflow_train_distributed_torch.models.lora import has_lora_leaves
from tensorflow_train_distributed_torch.ops import kernels as K


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
    kv: serving_kv.LaneKV
    table: torch.Tensor            # the lane's device block-table row
    cursor: int = 0                # target pieces completed
    cache_1: Optional[KVCache] = None
    first: Optional[torch.Tensor] = None   # pick after the last piece
    first_host: Optional[int] = None
    d_cursor: int = 0              # draft pieces completed
    d_cache_1: Optional[KVCache] = None


def _killed(switch: str) -> bool:
    """A kill switch (``TTD_NO_OVERLAP``, ``TTD_NO_INTERLEAVE``,
    ``TTD_NO_ADAPTIVE_SPEC``) set in the environment: it wins over the
    constructor's arguments, so a deployment flips it without touching
    its callers.  Read at construction."""
    return os.environ.get(switch, "0") not in ("", "0")


def _bucket_len(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill "
                     f"bucket {buckets[-1]}")


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
    col = torch.arange(1, width + 1, dtype=torch.int64,
                       device=seeds.device) * _GOLDEN
    z = _mix64(key[:, None] + col)
    return (_shr(z, 12).double() + 0.5) * 2.0 ** -52


class ServingEngine:
    """Continuous-batching decoder over a fixed slot grid and block pool.

    ``params``: the port's flat weights (``convert.params_from_flax`` or
    ``convert.init_params``), served in ``config.dtype``; ``draft_params``
    likewise for ``draft_config``.  ``record_logits=True`` keeps, per
    request, the f32 logits that produced each of its generated tokens
    after the first (``decode_logits[request_id]``, a list of [vocab]
    tensors: a decode step's, or the verify forward's row under
    speculation) — the seam a consistency check re-derives them
    through."""

    def __init__(self, config, params: dict, *, slots: int = 8,
                 cache_len: Optional[int] = None,
                 eos_id: Optional[int] = None, chunk: int = 8,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 prefill_chunk: Optional[int] = None,
                 draft_config=None, draft_params: Optional[dict] = None,
                 speculative_k: int = 0, spec_depths=None,
                 prompt_buckets=(32, 64, 128, 256, 512, 1024),
                 overlap: Optional[bool] = None,
                 prefill_budget: Optional[int] = None,
                 kv_block_size: int = 16,
                 kv_pool_blocks: Optional[int] = None,
                 record_logits: bool = False, device="cuda"):
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
        validate_sampling(temperature, top_k, top_p)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self._greedy = temperature == 0.0
        self.config = config
        self.device = torch.device(device)
        self.slots = slots
        self.cache_len = cache_len or config.max_positions
        if self.cache_len > config.max_positions:
            raise ValueError(f"cache_len {self.cache_len} exceeds "
                             f"max_positions {config.max_positions}")
        self.eos_id = eos_id
        self.chunk = chunk
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.prompt_buckets = tuple(
            b for b in sorted(prompt_buckets) if b <= self.cache_len)
        if not self.prompt_buckets and prefill_chunk is None:
            raise ValueError("no prompt bucket fits cache_len")
        if kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got "
                             f"{kv_block_size}")
        self.kv_block_size = int(kv_block_size)
        self._kv_nblk_lane = -(-self.cache_len // self.kv_block_size)
        if kv_pool_blocks is None:
            kv_pool_blocks = slots * self._kv_nblk_lane
        if kv_pool_blocks < 1:
            raise ValueError(f"kv_pool_blocks must be >= 1, got "
                             f"{kv_pool_blocks}")
        # Speculative decoding across all slots: the per-slot cache index
        # makes each slot's rollback its own index decrement.
        self._spec_k = int(speculative_k)
        if (draft_config is None) != (draft_params is None):
            raise ValueError("draft_config and draft_params come together")
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
        self.draft_config = draft_config
        # The controller only selects among depths; it never changes a
        # round's math (a pinned depth replays the fixed engine bitwise).
        self._spec_ctrl = (spec.DepthController(spec_depths)
                           if spec_depths is not None
                           and not _killed("TTD_NO_ADAPTIVE_SPEC") else None)
        self._model = _decode_model(
            config, cast_floating(params, config.dtype), device=self.device)
        self._draft = (None if draft_config is None else _decode_model(
            draft_config, cast_floating(draft_params, draft_config.dtype),
            device=self.device))
        self._kv_pool = serving_kv.KVBlockPool(kv_pool_blocks,
                                               self.kv_block_size)
        self._radix = serving_kv.RadixPrefixIndex(self._kv_pool)
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

    # -- host <-> device ---------------------------------------------------

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
        seeds = torch.as_tensor(seeds, dtype=torch.int64, device=filt.device)
        counts = torch.as_tensor(counts, dtype=torch.int64,
                                 device=filt.device)
        return spec.gumbel_argmax(filt, stream_uniforms(
            seeds, counts, PICK_DRAW, filt.shape[-1]))

    def _prefill_piece(self, cache_1: KVCache, tokens_1xl: torch.Tensor,
                       local_idx: int, seed: int):
        """One batch-1 prefill piece appended to ``cache_1``; returns the
        pick at ``local_idx`` (the last real row of this piece).  Pad rows
        of a final piece sit after every real row, so causal masking
        keeps them invisible, and decode rewrites each before any query
        can attend it."""
        logits = self._model(tokens_1xl, cache_1)
        return self._pick(logits[:, local_idx], [seed], [0])[0]

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

    def _fresh_cache(self, draft: bool = False) -> KVCache:
        """A zeroed batch-1 linear cache of the target or the draft."""
        model = self._draft if draft else self._model
        return model.init_cache(1, self.cache_len, device=self.device)

    def _grids(self) -> list:
        """The slot grids (target, then the draft's), built on first use.
        The draft's pool has the target's block count and shares its
        block table: one claim and one table row cover both."""
        if self._cache is None:
            blocks = 1 + self._kv_pool.n_blocks
            self._cache = self._model.init_cache(
                self.slots, self.cache_len, paged_blocks=blocks,
                block_size=self.kv_block_size, device=self.device)
            if self._draft is not None:
                d = self._draft.init_cache(
                    self.slots, self.cache_len, paged_blocks=blocks,
                    block_size=self.kv_block_size, device=self.device)
                self._d_cache = KVCache(
                    layers=d.layers, index=d.index, cache_len=d.cache_len,
                    block_table=self._cache.block_table)
        return [c for c in (self._cache, self._d_cache) if c is not None]

    def _paged_insert(self, caches_1: list, slot: int,
                      table_row: torch.Tensor, start: int,
                      true_len: int) -> None:
        """Scatter each batch-1 cache's rows [start, true_len) into the
        lane's blocks of its grid's pool, install the table row and pin
        the lane's positions to the true prompt length (rows below
        ``start`` live in radix-shared blocks and are already there —
        shared blocks are never written)."""
        grids = self._grids()
        bs = self.kv_block_size
        pos = torch.arange(start, true_len, device=self.device)
        dest = table_row[pos // bs].long() * bs + pos % bs
        for grid, cache_1 in zip(grids, caches_1):
            for pool, lin in zip(grid.layers, cache_1.layers):
                for p_name, l_name in (("key_pool", "key_cache"),
                                       ("value_pool", "value_cache")):
                    leaf = pool[p_name]
                    leaf.view(-1, *leaf.shape[2:])[dest] = (
                        lin[l_name][0, start:true_len])
                if "kv_pool_scales" in pool:
                    sp = pool["kv_pool_scales"]
                    sp.view(2, -1, sp.shape[-1])[:, dest] = (
                        lin["kv_scales"][:, 0, start:true_len])
            grid.index[slot] = true_len
        grids[0].block_table[slot] = table_row

    def _gather_prefix(self, table_row: torch.Tensor, matched: int,
                       draft: bool) -> KVCache:
        """A fresh batch-1 LINEAR cache holding the lane's rows read out
        of the target's (or the draft's) pool through its table by the
        paged KV gather kernel, position pinned to ``matched`` — a prefix
        hit replaces recompute with this copy.  Rows past ``matched`` hold
        whatever the lane's blocks hold: garbage the write-before-read
        rule keeps invisible."""
        grid = self._grids()[1 if draft else 0]
        table = table_row[None]
        c = self.cache_len
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

    def _flush_stale_lanes(self) -> None:
        """Point retired lanes' table rows at the scratch block and zero
        their positions in both grids before the next dispatch: their
        blocks went back to the pool, and the garbage an idle lane (or
        the overlap's lagging chunk) decodes must land in scratch, not in
        blocks someone else now owns."""
        if self._stale_slots and self._cache is not None:
            rows = self._to_device(np.array(sorted(self._stale_slots)))
            self._cache.block_table[rows] = 0
            for grid in self._grids():
                grid.index[rows] = 0
        self._stale_slots.clear()

    # -- requests ----------------------------------------------------------

    def validate_request(self, prompt, max_new_tokens: int,
                         seed: Optional[int] = None) -> list:
        """All of ``submit()``'s checks without queuing; returns the
        prompt as a list of ints."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if seed is not None and not 0 <= seed < 2 ** 32:
            raise ValueError(f"seed must be a uint32, got {seed}")
        if not prompt:
            raise ValueError("empty prompt")
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
        need = -(-(len(prompt) + max_new_tokens) // self.kv_block_size)
        if need > self._kv_pool.n_blocks:
            raise ValueError(
                f"request needs {need} KV blocks (block_size="
                f"{self.kv_block_size}) but the pool has "
                f"{self._kv_pool.n_blocks}")
        if (self.prefill_chunk is None
                and len(prompt) > self.prompt_buckets[-1]):
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest prefill "
                f"bucket {self.prompt_buckets[-1]}")
        return prompt

    def submit(self, prompt, max_new_tokens: int,
               seed: Optional[int] = None) -> int:
        """Queue a request; returns its id (resolved by ``run()``).
        ``seed`` names its sampling stream (default: the request id)."""
        prompt = self.validate_request(prompt, max_new_tokens, seed)
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, prompt, max_new_tokens,
                            rid if seed is None else seed))
        return rid

    def pending(self) -> int:
        """Requests not yet finished (queued + staged + decoding)."""
        return (len(self._queue) + len(self._staging)
                + sum(s is not None for s in self._slot_states))

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
        matched, shared = self._radix.match(prompt, record=not retry)
        for b in shared:
            self._kv_pool.ref(b)
        n_owned = need - len(shared)
        owned = self._kv_pool.alloc(n_owned)
        if owned is None:
            self.kv_stats["evictions"] += self._radix.evict_for(n_owned)
            owned = self._kv_pool.alloc(n_owned)
        if owned is None:
            for b in shared:
                self._kv_pool.deref(b)
            if self._kv_refused_rid != rid:
                self._kv_refused_rid = rid
                self.kv_stats["alloc_refusals"] += 1
            return None
        if matched:
            self.kv_stats["prefix_hits"] += 1
            self.kv_stats["prefix_hit_tokens"] += matched
        return serving_kv.LaneKV(request_id=rid, matched=matched,
                                 shared=shared, owned=owned)

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
        table = kv.table(self._kv_nblk_lane)
        self._radix.insert(prompt, lambda j: table[j])

    def _lane_release(self, slot: int, tokens) -> None:
        """Retire a lane: cache its generated full blocks in the radix
        index (rows are valid up to ``len(tokens) - 1``: the last token
        was never fed back), drop its references, mark it stale."""
        kv = self._lane_kv[slot]
        if kv is None:
            return
        bs = self.kv_block_size
        keep = tokens[:((len(tokens) - 1) // bs) * bs]
        table = kv.table(self._kv_nblk_lane)
        self._radix.insert(keep, lambda j: table[j])
        self._kv_release(kv)
        self._lane_kv[slot] = None
        self._stale_slots.add(slot)

    def _admission_cache_1(self, kv, table_row, draft: bool) -> KVCache:
        """The batch-1 cache a request's suffix prefill appends to: fresh
        when nothing matched, else the pool gather of the shared rows."""
        if kv.matched == 0:
            return self._fresh_cache(draft)
        return self._gather_prefix(table_row, kv.matched, draft)

    def _pieces_for(self, m: int):
        """(piece_len, n_pieces) for prefilling an m-token span."""
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
                   i: int, m: int, seed: int, draft: bool):
        """Piece ``i`` of a prefill — the one per-piece rule of atomic
        and staged admission alike.  The target returns the pick at the
        last real row (meaningful on the last piece); the draft only
        needs its rows, over the same piece grid."""
        toks = self._to_device(padded[:, i * piece:(i + 1) * piece])
        if draft:
            self._draft(toks, cache_1)
            return None
        local = min(m - 1 - i * piece, piece - 1)
        return self._prefill_piece(cache_1, toks, max(local, 0), seed)

    def _prefill_tokens(self, work, *, seed: int, cache_1: KVCache,
                        draft: bool = False):
        """Append ``work`` to ``cache_1`` in pieces; returns the target's
        pick at the last real row (a device scalar; None for the
        draft)."""
        padded, piece, n_pieces = self._padded(work)
        first = None
        for i in range(n_pieces):
            first = self._run_piece(cache_1, padded, piece, i, len(work),
                                    seed, draft)
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
                rid, prompt, max_new, seed = self._queue.popleft()
                if max_new == 0:
                    self._outputs[rid] = list(prompt)
                    continue
                kv = self._kv_claim(rid, prompt, max_new)
                if kv is None:
                    # Refused: keep FIFO order; blocks free as lanes retire.
                    self._queue.appendleft((rid, prompt, max_new, seed))
                    self._note_prefill(t0, prefilled, stalled)
                    return
                table_row = self._kv_table(kv)
                work = prompt[kv.matched:]
                prefilled += len(work)
                cache_1 = self._admission_cache_1(kv, table_row, False)
                first = int(self._prefill_tokens(work, seed=seed,
                                                 cache_1=cache_1))
                state = _SlotState(request_id=rid, remaining=max_new - 1,
                                   tokens=list(prompt) + [first],
                                   last_token=first, seed=seed, count=1)
                if max_new == 1 or (self.eos_id is not None
                                    and first == self.eos_id):
                    # Resolved before the draft's prefill, which it would
                    # waste; its blocks were never written.
                    self._kv_release(kv)
                    self._outputs[rid] = state.tokens
                    continue
                caches_1 = [cache_1]
                if self._draft is not None:
                    d_cache_1 = self._admission_cache_1(kv, table_row, True)
                    self._prefill_tokens(work, seed=seed, cache_1=d_cache_1,
                                         draft=True)
                    caches_1.append(d_cache_1)
                self._paged_insert(caches_1, slot, table_row, kv.matched,
                                   len(prompt))
                self._lane_claim(slot, kv, prompt)
                self._slot_states[slot] = state
                # The next dispatch splices this slot's host token and
                # counter over the device carry (the previous tenant's).
                self._refills.add(slot)
        self._note_prefill(t0, prefilled, stalled)

    def _note_prefill(self, t0: float, tokens: int, stalled: bool) -> None:
        if tokens:
            dt = time.perf_counter() - t0
            self.stats["prefill_s"] += dt
            self.stats["prefill_tokens"] += tokens
            if stalled:
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
                rid, prompt, max_new, seed = self._queue.popleft()
                if max_new == 0:
                    self._outputs[rid] = list(prompt)
                    continue
                kv = self._kv_claim(rid, prompt, max_new)
                if kv is None:
                    # FIFO: nothing behind the refused head may jump it.
                    self._queue.appendleft((rid, prompt, max_new, seed))
                    return
                work = prompt[kv.matched:]
                padded, piece, n_pieces = self._padded(work)
                self._staging[slot] = _PrefillTask(
                    request_id=rid, prompt=list(prompt), max_new=max_new,
                    seed=seed, work=work, padded=padded, piece=piece,
                    n_pieces=n_pieces, kv=kv, table=self._kv_table(kv))
                self.prefill_stats["staged_requests"] += 1
                self.stats["prefill_tokens"] += len(work)
                break

    def _finalize_prefill(self, slot: int, task: _PrefillTask) -> None:
        """Both caches complete: insert them into the grids and flip the
        lane to decoding."""
        first = task.first_host
        caches_1 = [task.cache_1] + (
            [] if self._draft is None else [task.d_cache_1])
        self._paged_insert(caches_1, slot, task.table, task.kv.matched,
                           len(task.prompt))
        self._lane_claim(slot, task.kv, task.prompt)
        del self._staging[slot]
        self._slot_states[slot] = _SlotState(
            request_id=task.request_id, remaining=task.max_new - 1,
            tokens=list(task.prompt) + [first], last_token=first,
            seed=task.seed, count=1)
        self._refills.add(slot)

    def _advance_piece(self, slot: int, task: _PrefillTask) -> int:
        """Run one installment of ``task`` — its next target piece, or
        once those are done its next draft piece, exactly the program
        atomic admission runs at this position — plus the insert after
        the last; returns its token cost."""
        if task.cursor < task.n_pieces:
            if task.cache_1 is None:
                task.cache_1 = self._admission_cache_1(task.kv, task.table,
                                                       False)
            task.first = self._run_piece(task.cache_1, task.padded,
                                         task.piece, task.cursor,
                                         len(task.work), task.seed, False)
            task.cursor += 1
            if task.cursor == task.n_pieces:
                # Reading the first token waits for this piece; the chunk
                # queued ahead of it keeps the device busy meanwhile.
                first = int(task.first)
                task.first_host = first
                if task.max_new == 1 or (self.eos_id is not None
                                         and first == self.eos_id):
                    self._kv_release(task.kv)   # blocks never written
                    self._outputs[task.request_id] = (
                        list(task.prompt) + [first])
                    del self._staging[slot]
                elif self._draft is None:
                    self._finalize_prefill(slot, task)
            return task.piece
        if task.d_cache_1 is None:
            task.d_cache_1 = self._admission_cache_1(task.kv, task.table,
                                                     True)
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
            self.prefill_stats["stall_s"] += dt

    def prefill_stall_s(self) -> float:
        """Seconds decoding lanes spent blocked behind admission prefill
        (prefill run while a lane decoded with no chunk in flight to
        hide it)."""
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
        self.spec_stats["rounds"] += 1
        n_slots = acc_sum = 0
        for slot, state in self._live(rids):
            taken = self._consume(state, emit[slot, :int(emitted[slot])])
            self._record(state, logits, slot, taken)
            n_slots += 1
            acc_sum += int(accepted[slot])
            self.spec_stats["slot_rounds"] += 1
            self.spec_stats["drafted"] += k
            self.spec_stats["drafted_accepted"] += int(accepted[slot])
            self.spec_stats["emitted"] += taken
            self._retire_if_done(slot, state)
        if self._spec_ctrl is not None:
            # Every harvested round is observed, a fully trimmed one too:
            # the controller's decisions stay a function of the requests.
            self._spec_ctrl.observe(k * n_slots, acc_sum)

    def spec_depth(self) -> int:
        """Depth of the next round: the controller's pick, else the fixed
        ``speculative_k`` (0 on a plain engine)."""
        return (self._spec_k if self._spec_ctrl is None
                else self._spec_ctrl.depth())

    def spec_telemetry(self) -> dict:
        """The depth controller's telemetry ({} at a fixed depth)."""
        return {} if self._spec_ctrl is None else self._spec_ctrl.telemetry()

    # -- dispatch: the one-chunk overlap -------------------------------------

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
        k = self.spec_depth()
        self._flush_stale_lanes()
        tok, counts = self._carry_arrays()
        seeds_d = self._to_device(seeds)
        if self._draft is not None:
            emit, emitted, nxt, acc, counts_next, logits = self._spec_round(
                tok, seeds_d, counts, k)
            # A continuing slot took exactly ``emitted`` tokens, so the
            # device advances its counter itself: round N+1 needs no copy
            # of round N.
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
        self.overlap_stats["chunks"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0

    def _skip_eager_dispatch(self) -> bool:
        """Harvest first for this one step when every active slot
        certainly retires in the chunk in flight (budget exhaustion is
        known on the host, EOS is not): an eager successor would be
        garbage end to end.  A plain chunk emits ``chunk`` tokens a lane;
        a speculative round guarantees only one."""
        horizon = 1 if self._draft is not None else self.chunk
        certain = [s.remaining <= horizon
                   for s in self._slot_states if s is not None]
        return bool(certain) and all(certain)

    def _harvest_prev(self, inf: dict, overlapped: bool) -> None:
        """Wait for ``inf``'s tokens — its event only: when
        ``overlapped`` the successor is queued behind it and keeps the
        device busy — and consume them under the dispatch-time trim.  The
        wait counts as decode time; only the host pass after it goes into
        ``overlap_stats``."""
        t0 = time.perf_counter()
        host, event = inf["host"]
        if event is not None:
            event.synchronize()
        arrays = [h.numpy() for h in host]
        t1 = time.perf_counter()
        self.stats["decode_s"] += t1 - t0
        if inf["spec"]:
            self._harvest_spec(*arrays, inf["k"], inf["rids"], inf["logits"])
        else:
            self._harvest(arrays[0], inf["rids"], inf["logits"])
        dt = time.perf_counter() - t1
        self.overlap_stats["harvest_s"] += dt
        if overlapped:
            self.overlap_stats["overlapped_harvests"] += 1
            self.overlap_stats["overlapped_harvest_s"] += dt

    def overlap_ratio(self) -> float:
        """Share of the harvests' host time spent with a successor chunk
        in flight (0.0 on the synchronous path)."""
        total = self.overlap_stats["harvest_s"]
        if total <= 0.0:
            return 0.0
        return min(1.0, self.overlap_stats["overlapped_harvest_s"] / total)

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

    def run(self) -> dict:
        """Serve every submitted request to completion; returns
        ``{request_id: prompt + generated tokens}``."""
        out: dict = {}
        while self.pending():
            out.update(self.serve_step())
        return out

    def kv_blocks_in_use(self) -> int:
        """Blocks referenced by live lanes and the radix cache."""
        return self._kv_pool.blocks_in_use()
