"""Continuous-batching serving engine over a paged KV cache.

Counterpart of the JAX package's ``serving.ServingEngine`` in its paged,
synchronous, atomic-admission mode (``paged=True, overlap=False,
prefill_budget=0``), whose outputs the JAX engine's other scheduling
modes reproduce bit for bit:

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
- **Decode** steps every slot together, ``chunk`` steps per
  ``serve_step``; each step's attention is the fused paged-attention
  kernel over the pool.  The host harvests finished requests (EOS or
  budget) between chunks, feeds their full blocks to the radix index,
  and refills the freed slots from the queue.

Greedy decoding takes the argmax of f32 logits.  Sampling
(``temperature``/``top_k``/``top_p``) draws each token from a
``torch.Generator`` seeded by (request seed, tokens drawn so far) alone,
so a request's tokens do not depend on its slot, its neighbours or chunk
boundaries.  The JAX engine's threefry bits cannot be reproduced, so
sampled output agrees with it in distribution, not token for token.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU the kernels' plain versions run (``ops.kernels``).

Waiting for later slices: speculative decoding, the one-chunk overlap,
staged interleaved prefill, ``preload_prefix``, lane and prefix
export/install, HBM autosizing, the linear-cache engine, int8 weights,
MoE, cancellation and resume-from-token.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from tensorflow_train_distributed_torch import serving_kv
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


def _bucket_len(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest prefill "
                     f"bucket {buckets[-1]}")


def _stream_seed(seed: int, count: int) -> int:
    """64-bit generator seed for draw ``count`` of stream ``seed``
    (splitmix64 of the pair): depends on nothing else."""
    z = (seed * 0x9E3779B97F4A7C15 + count + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


class ServingEngine:
    """Continuous-batching decoder over a fixed slot grid and block pool.

    ``params``: the port's flat weights (``convert.params_from_flax`` or
    ``convert.init_params``), served in ``config.dtype``.
    ``record_logits=True`` keeps, per request, the f32 logits of every
    decode step that produced one of its tokens (``decode_logits[
    request_id]``, a list of [vocab] tensors) — the seam a consistency
    check re-derives them through."""

    def __init__(self, config, params: dict, *, slots: int = 8,
                 cache_len: Optional[int] = None,
                 eos_id: Optional[int] = None, chunk: int = 8,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 prefill_chunk: Optional[int] = None,
                 prompt_buckets=(32, 64, 128, 256, 512, 1024),
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
        self._model = _decode_model(
            config, cast_floating(params, config.dtype), device=self.device)
        self._kv_pool = serving_kv.KVBlockPool(kv_pool_blocks,
                                               self.kv_block_size)
        self._radix = serving_kv.RadixPrefixIndex(self._kv_pool)
        self.kv_cache_int8 = config.kv_cache_int8
        # kv_stats: prompt tokens whose prefill a radix hit skipped,
        # blocks LRU-evicted under pressure, requests refused admission.
        self.kv_stats = {"prefix_hit_tokens": 0, "prefix_hits": 0,
                         "evictions": 0, "alloc_refusals": 0}
        # Host-clock totals of the serving loop (decode includes the
        # device wait: each chunk ends in a host copy of its tokens).
        self.stats = {"decode_steps": 0, "decode_s": 0.0, "prefill_s": 0.0,
                      "prefill_tokens": 0}
        self.record_logits = record_logits
        self.decode_logits: dict = {}
        self._queue: deque = deque()
        self._outputs: dict = {}
        self._next_id = 0
        self._slot_states: list = [None] * slots
        self._lane_kv: list = [None] * slots
        self._stale_slots: set = set()
        self._kv_refused_rid: Optional[int] = None
        self._cache: Optional[KVCache] = None   # slot grid, built lazily

    # -- device programs ---------------------------------------------------

    def _pick(self, logits: torch.Tensor, seeds, counts) -> torch.Tensor:
        """Next token per row of ``logits`` [n, V].  Greedy: argmax over
        f32.  Sampling: Gumbel-max over ``filter_logits`` — exactly a draw
        from their softmax — with row i's noise from a generator seeded by
        (``seeds[i]``, ``counts[i]``) only."""
        logits = logits.float()
        if self._greedy:
            return torch.argmax(logits, dim=-1)
        logits = filter_logits(logits, temperature=self.temperature,
                               top_k=self.top_k, top_p=self.top_p)
        noise = []
        for seed, count in zip(seeds, counts):
            g = torch.Generator(device=logits.device)
            g.manual_seed(_stream_seed(int(seed), int(count)))
            u = torch.rand(logits.shape[-1], generator=g,
                           device=logits.device)
            noise.append(-torch.log(-torch.log(u)))
        return torch.argmax(logits + torch.stack(noise), dim=-1)

    def _prefill_piece(self, cache_1: KVCache, tokens_1xl: torch.Tensor,
                       local_idx: int, seed: int):
        """One batch-1 prefill piece appended to ``cache_1``; returns the
        pick at ``local_idx`` (the last real row of this piece).  Pad rows
        of a final piece sit after every real row, so causal masking
        keeps them invisible, and decode rewrites each before any query
        can attend it."""
        logits = self._model(tokens_1xl, cache_1)
        return self._pick(logits[:, local_idx], [seed], [0])[0]

    def _decode_chunk(self, tok: torch.Tensor, seeds, counts):
        """``chunk`` decode steps for all slots → tokens [slots, chunk]
        (and f32 logits [slots, chunk, V] when recording)."""
        toks, logs = [], []
        for j in range(self.chunk):
            logits = self._model(tok[:, None], self._cache)[:, -1]
            tok = self._pick(logits, seeds, [c + j for c in counts])
            toks.append(tok)
            if self.record_logits:
                logs.append(logits.float())
        return (torch.stack(toks, dim=1),
                torch.stack(logs, dim=1) if self.record_logits else None)

    def _fresh_cache(self, batch: int, grid: bool = False) -> KVCache:
        if grid:
            return self._model.init_cache(
                batch, self.cache_len, paged_blocks=1 + self._kv_pool.n_blocks,
                block_size=self.kv_block_size, device=self.device)
        return self._model.init_cache(batch, self.cache_len,
                                      device=self.device)

    def _paged_insert(self, cache_1: KVCache, slot: int,
                      table_row: torch.Tensor, start: int,
                      true_len: int) -> None:
        """Scatter the batch-1 cache's rows [start, true_len) into the
        lane's blocks, install its table row and pin its position to the
        true prompt length (rows below ``start`` live in radix-shared
        blocks and are already there — shared blocks are never
        written)."""
        bs = self.kv_block_size
        if true_len > start:
            pos = torch.arange(start, true_len, device=self.device)
            dest = table_row[pos // bs].long() * bs + pos % bs
            for pool, lin in zip(self._cache.layers, cache_1.layers):
                for p_name, l_name in (("key_pool", "key_cache"),
                                       ("value_pool", "value_cache")):
                    leaf = pool[p_name]
                    leaf.view(-1, *leaf.shape[2:])[dest] = (
                        lin[l_name][0, start:true_len])
                if self.kv_cache_int8:
                    sp = pool["kv_pool_scales"]
                    sp.view(2, -1, sp.shape[-1])[:, dest] = (
                        lin["kv_scales"][:, 0, start:true_len])
        self._cache.block_table[slot] = table_row
        self._cache.index[slot] = true_len

    def _gather_prefix(self, table_row: torch.Tensor,
                       matched: int) -> KVCache:
        """A fresh batch-1 LINEAR cache holding the lane's rows read out
        of the pool through its table by the paged KV gather kernel,
        position pinned to ``matched`` — a prefix hit replaces recompute
        with this copy.  Rows past ``matched`` hold whatever the lane's
        blocks hold: garbage the write-before-read rule keeps
        invisible."""
        table = table_row[None]
        c = self.cache_len
        layers = []
        for pool in self._cache.layers:
            lc = {"key_cache": K.paged_kv_gather(pool["key_pool"], table, c),
                  "value_cache": K.paged_kv_gather(pool["value_pool"], table,
                                                   c)}
            if self.kv_cache_int8:
                sp = pool["kv_pool_scales"]
                lc["kv_scales"] = torch.stack([
                    K.paged_kv_gather(sp[i][..., None], table, c)[..., 0]
                    for i in (0, 1)])
            layers.append(lc)
        index = torch.full((1,), matched, dtype=torch.int32,
                           device=self.device)
        return KVCache(layers=layers, index=index, cache_len=c)

    def _reset_lanes(self, stale) -> None:
        """Point retired lanes' tables at the scratch block and zero their
        positions: their blocks went back to the pool, and the idle
        lane's garbage decode must land in scratch, not in blocks someone
        else now owns."""
        for slot in stale:
            self._cache.block_table[slot] = 0
            self._cache.index[slot] = 0

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
        """Requests not yet finished (queued + decoding)."""
        return (len(self._queue)
                + sum(s is not None for s in self._slot_states))

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
        return torch.tensor(kv.table(self._kv_nblk_lane), dtype=torch.int32,
                            device=self.device)

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

    def _flush_stale_lanes(self) -> None:
        if self._stale_slots and self._cache is not None:
            self._reset_lanes(sorted(self._stale_slots))
        self._stale_slots.clear()

    def _admission_cache_1(self, kv, table_row) -> KVCache:
        """The batch-1 cache a request's suffix prefill appends to: fresh
        when nothing matched, else the pool gather of the shared rows."""
        if kv.matched == 0:
            return self._fresh_cache(1)
        if self._cache is None:
            self._cache = self._fresh_cache(self.slots, grid=True)
        return self._gather_prefix(table_row, kv.matched)

    def _pieces_for(self, m: int):
        """(piece_len, n_pieces) for prefilling an m-token span."""
        if self.prefill_chunk is not None:
            return self.prefill_chunk, -(-m // self.prefill_chunk)
        piece = _bucket_len(min(m, self.prompt_buckets[-1]),
                            self.prompt_buckets)
        return piece, -(-m // piece)

    def _prefill_tokens(self, work, *, seed: int, cache_1: KVCache):
        """Append ``work`` to ``cache_1`` in pieces; returns the pick at
        the last real row (a device scalar)."""
        m = len(work)
        piece, n_pieces = self._pieces_for(m)
        padded = np.zeros((1, piece * n_pieces), np.int64)
        padded[0, :m] = work
        toks = torch.from_numpy(padded).to(self.device)
        first = None
        for i in range(n_pieces):
            local = min(m - 1 - i * piece, piece - 1)
            first = self._prefill_piece(
                cache_1, toks[:, i * piece:(i + 1) * piece], max(local, 0),
                seed)
        return first

    @torch.no_grad()
    def _fill_free_slots(self) -> None:
        """Atomic admission: each free slot takes queued requests until
        one occupies it (a request resolved at prefill — one token, or
        EOS first — leaves the slot free for the next)."""
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
                    self._note_prefill(t0, prefilled)
                    return
                n = len(prompt)
                table_row = self._kv_table(kv)
                work = prompt[kv.matched:]
                prefilled += len(work)
                cache_1 = self._admission_cache_1(kv, table_row)
                first = int(self._prefill_tokens(work, seed=seed,
                                                 cache_1=cache_1))
                state = _SlotState(request_id=rid, remaining=max_new - 1,
                                   tokens=list(prompt) + [first],
                                   last_token=first, seed=seed, count=1)
                if max_new == 1 or (self.eos_id is not None
                                    and first == self.eos_id):
                    self._kv_release(kv)     # its blocks were never written
                    self._outputs[rid] = state.tokens
                    continue
                if self._cache is None:
                    self._cache = self._fresh_cache(self.slots, grid=True)
                self._paged_insert(cache_1, slot, table_row, kv.matched, n)
                self._lane_claim(slot, kv, prompt)
                self._slot_states[slot] = state
        self._note_prefill(t0, prefilled)

    def _note_prefill(self, t0: float, tokens: int) -> None:
        if tokens:
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefill_tokens"] += tokens

    # -- host loop ---------------------------------------------------------

    def _consume(self, state: _SlotState, tokens) -> int:
        """Append generated tokens under the budget and EOS rules;
        returns how many were taken."""
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

    def _harvest(self, toks: np.ndarray, logits=None) -> None:
        for slot, state in enumerate(self._slot_states):
            if state is None:
                continue
            taken = self._consume(state, toks[slot])
            if logits is not None:
                self.decode_logits.setdefault(state.request_id, []).extend(
                    logits[slot, :taken])
            if state.done:
                self._lane_release(slot, state.tokens)
                self._outputs[state.request_id] = state.tokens
                self._slot_states[slot] = None

    @torch.no_grad()
    def serve_step(self) -> dict:
        """One iteration: refill free slots, run one decode chunk, harvest.
        Returns the requests that finished, ``{request_id: tokens}``."""
        self._fill_free_slots()
        if any(s is not None for s in self._slot_states):
            tok = np.zeros((self.slots,), np.int64)
            seeds = [0] * self.slots
            counts = [0] * self.slots
            for slot, state in enumerate(self._slot_states):
                if state is not None:
                    tok[slot] = state.last_token
                    seeds[slot] = state.seed
                    counts[slot] = state.count
            t0 = time.perf_counter()
            self._flush_stale_lanes()
            toks, logits = self._decode_chunk(
                torch.from_numpy(tok).to(self.device), seeds, counts)
            toks = toks.cpu().numpy()
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["decode_steps"] += self.chunk
            self._harvest(toks, logits)
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
