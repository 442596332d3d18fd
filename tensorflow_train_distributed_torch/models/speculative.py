"""Speculative decoding's shared rules: a small draft model proposes, the
target verifies a block of proposals in one forward.

Counterpart of the JAX package's ``models/speculative.py``.  The serving
engine (``serving.ServingEngine`` with a draft) runs these rules over all
slots at once, ``generate_speculative`` over one prompt on the shared-index
caches of ``generate()``:

- ``accept_block``: the greedy rule (Leviathan et al.).  Each row emits
  its leading drafts that equal the target's argmax, then the target's
  own pick at the first disagreement, so greedy output is the target's
  greedy decode token for token.
- ``sampled_accept``: the rejection rule.  Draft ``x_i`` survives with
  probability min(1, p_i(x_i) / q_i(x_i)); at the first rejection the
  replacement is drawn from norm(max(p_i - q_i, 0)), and when all k
  survive the bonus is drawn from p_k.  Emitted tokens are distributed
  as plain sampling from the target.
- ``DepthController``: the acceptance-adaptive choice among a fixed set
  of draft depths, a deterministic function of ``observe()`` alone.
- ``generate_speculative``: the batch-1 library path.  Greedy output is
  ``generate()``'s token for token; sampled output draws from the counter
  streams of ``serving.stream_uniforms`` (stream (``seed``, tokens done
  so far), draw indices 0..k for the draft, k+1 for the acceptance
  uniforms, k+2 for the replacement or bonus, ``PICK_DRAW`` for the first
  token), in law the target's.
"""

from __future__ import annotations

import torch

from tensorflow_train_distributed_torch.models.llama import LlamaConfig


def _reject_config(name: str, cfg) -> None:
    if not isinstance(cfg, LlamaConfig):
        raise ValueError(
            f"{name} config is {type(cfg).__name__}; speculative decode "
            "supports the Llama family only (MoE decode serves through "
            "generate(), but draft/verify rollback is untested there)")
    if cfg.sliding_window is not None:
        raise ValueError(
            f"{name} config uses sliding_window={cfg.sliding_window}: "
            "the rolling KV ring overwrites rows destructively, so "
            "speculative rollback (an index reset) is unsound — use "
            "full-attention configs")
    if cfg.lora is not None:
        raise ValueError(
            f"{name} config carries LoRA adapters; merge them first "
            "(models.lora.merge_lora) — speculative decode serves plain "
            "weights")


def _accept_count(ok: torch.Tensor) -> torch.Tensor:
    """Leading-True count per row of ``ok`` [B, k]: the appended zero
    column makes argmin (the first minimum) return k when every flag is
    True.  The one accepted-count rule of both acceptance laws."""
    pad = torch.zeros(ok.shape[0], 1, dtype=torch.int32, device=ok.device)
    return torch.argmin(torch.cat([ok.to(torch.int32), pad], dim=1), dim=1)


def _assemble_emit(d_block: torch.Tensor, a: torch.Tensor,
                   final: torch.Tensor) -> torch.Tensor:
    """Row i carries d_0..d_{a-1}, then ``final`` at position a, zeros
    beyond: [B, k+1].  The explicit zero column keeps k = 0 (the plain
    decode depth, ``d_block`` [B, 0]) one formula."""
    b, k = d_block.shape
    idx = torch.arange(k + 1, device=d_block.device)[None, :]
    d_pad = torch.cat([d_block, d_block.new_zeros(b, 1)], dim=1)
    final = final.to(d_block.dtype)
    return torch.where(idx < a[:, None], d_pad,
                       torch.where(idx == a[:, None], final[:, None],
                                   torch.zeros_like(d_pad)))


def accept_block(d_block: torch.Tensor, preds: torch.Tensor):
    """The greedy rule over a batch of rows.

    ``d_block`` [B, k] draft proposals, ``preds`` [B, k+1] the target's
    argmax over the verify block.  Returns ``(emit [B, k+1], emitted [B],
    accepted [B], bonus [B])``; entries of ``emit`` past ``emitted`` are
    zero."""
    k = d_block.shape[1]
    a = _accept_count(d_block == preds[:, :k])
    bonus = torch.gather(preds, 1, a[:, None])[:, 0]
    return _assemble_emit(d_block, a, bonus), a + 1, a, bonus


def residual(p: torch.Tensor, q: torch.Tensor,
             a: torch.Tensor) -> torch.Tensor:
    """The distribution the replacement (or bonus) token is drawn from:
    norm(max(p_a - q_a, 0)) with q zero-padded at k, so that all-accepted
    rows draw from p_k.  ``p`` [B, k+1, V], ``q`` [B, k, V], ``a`` [B]
    → [B, V].  A row whose residual sums to 0 (p == q at the rejected
    position, measure zero under exact arithmetic) falls back to p_a."""
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    pick = a[:, None, None].expand(-1, 1, p.shape[-1])
    p_at = torch.gather(p, 1, pick)[:, 0]
    q_at = torch.gather(q_pad, 1, pick)[:, 0]
    res = torch.clamp(p_at - q_at, min=0.0)
    tot = res.sum(-1, keepdim=True)
    return torch.where(tot > 0, res / torch.where(tot > 0, tot, 1.0), p_at)


def gumbel_argmax(log_weights: torch.Tensor,
                  uniforms: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of unnormalised log-weights [n, V]
    (Gumbel-max), from ``uniforms`` [n, V] in (0, 1); -inf entries are
    never drawn.  Computed in f64 so the noise resolves every uniform."""
    noise = -torch.log(-torch.log(uniforms.double()))
    return torch.argmax(log_weights.double() + noise, dim=-1)


def sampled_accept(d_block: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                   us: torch.Tensor, final_uniforms: torch.Tensor):
    """The rejection rule over a batch of rows.

    ``d_block`` [B, k] draft samples drawn from ``q`` [B, k, V] (the
    draft's filtered softmax); ``p`` [B, k+1, V] the target's filtered
    softmax over the verify block; ``us`` [B, k] acceptance uniforms;
    ``final_uniforms`` [B, V] the noise of the replacement/bonus draw.
    Returns ``(emit, emitted, accepted, final)`` laid out as
    ``accept_block``'s."""
    k = d_block.shape[1]
    ids = d_block.long()[..., None]
    px = torch.gather(p[:, :k], 2, ids)[..., 0]
    qx = torch.gather(q, 2, ids)[..., 0]
    a = _accept_count(us * qx < px)          # u < p/q without dividing
    final = gumbel_argmax(torch.log(residual(p, q, a) + 1e-38),
                          final_uniforms).to(d_block.dtype)
    return _assemble_emit(d_block, a, final), a + 1, a, final


class DepthController:
    """Acceptance-adaptive draft-depth selector over a fixed bucket set.

    Per harvested round the engine feeds back how many tokens the draft
    proposed and how many the target accepted; the controller keeps an
    EWMA of the acceptance rate and walks the bucket ladder: deepen one
    bucket when acceptance holds at or above ``deepen``, back off one when
    it falls to ``backoff``, and never move again within ``dwell`` rounds
    of the last move.  Depth 0 (plain decode, the draft cache kept in
    lockstep) yields no acceptance signal, so every ``probe_every``-th
    round at depth 0 probes the shallowest nonzero depth for one round,
    kept only if its acceptance clears ``deepen``.

    Decisions are a deterministic function of the ``observe()`` history
    alone: wall times are kept per depth for telemetry and never
    consulted, so a run replays bitwise regardless of host timing."""

    def __init__(self, depths, *, start=None, alpha=0.4,
                 deepen=0.7, backoff=0.35, dwell=4, probe_every=16):
        ds = sorted(set(int(d) for d in depths))
        if not ds or ds[0] < 0:
            raise ValueError(f"depths must be non-negative, got {depths}")
        if len(ds) < 2:
            raise ValueError(
                f"need >= 2 depth buckets to adapt over, got {ds} "
                "(a single depth is just the fixed engine)")
        if ds[-1] < 1:
            raise ValueError("need at least one nonzero depth")
        if not 0.0 <= backoff < deepen <= 1.0:
            raise ValueError(
                f"need 0 <= backoff < deepen <= 1, got "
                f"backoff={backoff}, deepen={deepen}")
        self.depths = tuple(ds)
        self.alpha = float(alpha)
        self.deepen_at = float(deepen)
        self.backoff_at = float(backoff)
        self.dwell = max(1, int(dwell))
        self.probe_every = max(2, int(probe_every))
        if start is None:
            start = ds[-1]
        if start not in ds:
            raise ValueError(f"start depth {start} not in buckets {ds}")
        self._i = ds.index(start)
        self._ewma = None           # no signal yet
        self._since_switch = 0      # rounds at the current depth
        self._zero_rounds = 0       # consecutive rounds at depth 0
        self._probing = False       # current round is a depth-0 probe
        self.rounds = 0
        self.switches = 0
        # Telemetry only: per-depth round counts and wall-time EWMAs.
        self._stats = {d: {"rounds": 0, "wall_ewma": None,
                           "acc_ewma": None} for d in self.depths}

    def depth(self) -> int:
        """Depth for the next dispatched round."""
        return self.depths[self._i]

    def acceptance(self):
        """Current acceptance-rate EWMA (None before any signal)."""
        return self._ewma

    def _move(self, i: int) -> None:
        if i != self._i:
            self._i = i
            self.switches += 1
            self._since_switch = 0
            self._ewma = None       # judge the new depth on its own

    def observe(self, drafted: int, accepted: int, wall_s=None) -> None:
        """Feed back one harvested round: ``drafted`` tokens proposed
        across active slots (active * k), ``accepted`` of them kept."""
        d = self.depths[self._i]
        self.rounds += 1
        self._since_switch += 1
        st = self._stats[d]
        st["rounds"] += 1
        if wall_s is not None:
            st["wall_ewma"] = (float(wall_s) if st["wall_ewma"] is None
                               else (1 - self.alpha) * st["wall_ewma"]
                               + self.alpha * float(wall_s))
        if d > 0 and drafted > 0:
            rate = accepted / drafted
            self._ewma = (rate if self._ewma is None
                          else (1 - self.alpha) * self._ewma
                          + self.alpha * rate)
            st["acc_ewma"] = self._ewma
        if self._probing:
            # One-round probe out of depth 0: keep the climb only if the
            # probe's own acceptance clears the deepen bar.
            self._probing = False
            self._zero_rounds = 0
            if self._ewma is None or self._ewma < self.deepen_at:
                self._move(0)
            return
        if d == 0:
            self._zero_rounds += 1
            if self._zero_rounds >= self.probe_every:
                self._probing = True
                self._move(self._shallowest_nonzero())
            return
        if self._since_switch < self.dwell or self._ewma is None:
            return
        if self._ewma >= self.deepen_at and self._i + 1 < len(self.depths):
            self._move(self._i + 1)
        elif self._ewma <= self.backoff_at and self._i > 0:
            self._move(self._i - 1)

    def _shallowest_nonzero(self) -> int:
        for i, d in enumerate(self.depths):
            if d > 0:
                return i
        raise AssertionError("the constructor guarantees a nonzero depth")

    def telemetry(self) -> dict:
        """Snapshot (copies): current depth, total rounds and switches,
        acceptance EWMA, per-depth round counts and EWMAs."""
        return {
            "depth": self.depth(),
            "rounds": self.rounds,
            "switches": self.switches,
            "acceptance": self._ewma,
            "per_depth": {d: dict(v) for d, v in self._stats.items()},
        }


def generate_speculative(target_config: LlamaConfig, target_params: dict,
                         draft_config: LlamaConfig, draft_params: dict,
                         prompt, max_new_tokens: int, *, k: int = 4,
                         cast_params: bool = True, temperature: float = 0.0,
                         top_k=None, top_p=None, seed: int = 0,
                         device="cuda"):
    """Decode ``max_new_tokens`` of a batch-1 ``prompt`` [1, S] by draft
    speculation; returns ``(tokens [1, S + max_new], stats)`` with
    ``stats`` = {"rounds", "drafted_accepted", "tokens"}.  Greedy
    (``temperature`` 0): the tokens of ``generate(target_config,
    target_params, prompt, max_new_tokens)``.  Sampling: the draft
    samples its proposals under the same filters and acceptance takes
    the rejection rule, so the tokens follow plain sampled decoding of
    the target; ``seed`` names the streams."""
    from tensorflow_train_distributed_torch.models.generate import (
        _ids,
        cast_floating,
        validate_sampling,
    )
    from tensorflow_train_distributed_torch.models.lora import (
        has_lora_leaves,
    )

    validate_sampling(temperature, top_k, top_p)
    prompt = _ids(prompt)
    if prompt.dim() != 2 or prompt.shape[0] != 1:
        raise ValueError(
            f"speculative decode is batch-1 (per-row acceptance lengths "
            f"need per-row cache indices); got shape {tuple(prompt.shape)}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    if k < 1:
        raise ValueError(f"k (draft block length) must be >= 1, got {k}")
    if draft_config.vocab_size != target_config.vocab_size:
        raise ValueError(
            f"draft vocab {draft_config.vocab_size} != target vocab "
            f"{target_config.vocab_size}: token ids would not line up")
    _reject_config("target", target_config)
    _reject_config("draft", draft_config)
    total = prompt.shape[1] + max_new_tokens + k + 1
    for name, cfg in (("target", target_config), ("draft", draft_config)):
        if total > cfg.max_positions:
            raise ValueError(
                f"prompt + max_new + k+1 = {total} exceeds the {name}'s "
                f"max_positions {cfg.max_positions}")
    for name, p in (("target", target_params), ("draft", draft_params)):
        if any(v.dtype == torch.int8 for v in p.values()):
            raise ValueError(
                f"{name} params are int8-quantized: speculative decode "
                "has no dequant path — pass full-precision trees "
                "(generate() handles int8 serving)")
        if has_lora_leaves(p):
            raise ValueError(
                f"{name} params carry unmerged LoRA adapters — fold them "
                "in first (models.lora.merge_lora)")
    if cast_params:
        target_params = cast_floating(target_params, target_config.dtype)
        draft_params = cast_floating(draft_params, draft_config.dtype)
    return _speculate(target_config, draft_config, target_params,
                      draft_params, prompt.to(device), int(max_new_tokens),
                      int(k), float(temperature), top_k, top_p, int(seed))


@torch.no_grad()
def _speculate(target_config, draft_config, target_params, draft_params,
               prompt, max_new: int, k: int, temperature: float, top_k,
               top_p, seed: int):
    """The rounds: the draft's k+1 single-token steps (the last only
    appends, so both caches hold the same rows), the target's verify of
    [tok, d_0..d_{k-1}] in one call, the acceptance, and both caches
    rolled back to the accepted context."""
    from tensorflow_train_distributed_torch.models.generate import (
        _decode_model,
        filter_logits,
    )
    from tensorflow_train_distributed_torch.serving import (
        PICK_DRAW,
        stream_uniforms,
    )

    dev = prompt.device
    greedy = temperature == 0.0
    seeds = torch.tensor([seed], dtype=torch.int64, device=dev)

    def filt(lg):
        return filter_logits(lg, temperature=temperature, top_k=top_k,
                             top_p=top_p)

    def uniforms(done: int, draw: int, width: int):
        counts = torch.tensor([done], dtype=torch.int64, device=dev)
        return stream_uniforms(seeds, counts, draw, width)

    prompt_len = prompt.shape[1]
    cache_len = prompt_len + max_new + k + 1
    target = _decode_model(target_config, target_params, device=dev)
    draft = _decode_model(draft_config, draft_params, device=dev)
    t_cache = target.init_cache(1, cache_len, shared=True, device=dev)
    d_cache = draft.init_cache(1, cache_len, shared=True, device=dev)
    last = target(prompt, t_cache)[:, -1].float()
    draft(prompt, d_cache)
    if greedy:
        tok = torch.argmax(last, dim=-1)
    else:
        f = filt(last)
        tok = gumbel_argmax(f, uniforms(0, PICK_DRAW, f.shape[-1]))
    out = [int(tok)]
    rounds = accepted = 0
    while len(out) < max_new:
        done = len(out)
        ctx = prompt_len + done - 1      # rows both caches hold
        drafts, qs = [], []
        t = tok
        for j in range(k + 1):
            lg = draft(t[:, None], d_cache)[:, -1].float()
            if j == k:
                break                      # append-only step
            if greedy:
                t = torch.argmax(lg, dim=-1)
            else:
                f = filt(lg)
                t = gumbel_argmax(f, uniforms(done, j, f.shape[-1]))
                qs.append(torch.softmax(f, dim=-1))
            drafts.append(t)
        d_block = torch.stack(drafts, dim=1)                  # [1, k]
        block = torch.cat([tok[:, None], d_block], dim=1)
        logits = target(block, t_cache).float()               # [1, k+1, V]
        if greedy:
            emit, emitted, acc, nxt = accept_block(
                d_block, torch.argmax(logits, dim=-1))
        else:
            p = torch.softmax(filt(logits), dim=-1)
            emit, emitted, acc, nxt = sampled_accept(
                d_block, torch.stack(qs, dim=1), p,
                uniforms(done, k + 1, k), uniforms(done, k + 2, p.shape[-1]))
        n = int(emitted[0])
        out.extend(int(x) for x in emit[0, :n])
        rounds += 1
        accepted += int(acc[0])
        # Roll both caches back to the emitted tokens: rows past them are
        # rewritten before anything attends them.
        d_cache.index = t_cache.index = ctx + n
        tok = nxt.reshape(1)
    gen = torch.tensor(out[:max_new], dtype=torch.int64, device=dev)
    stats = {"rounds": rounds, "drafted_accepted": accepted,
             "tokens": max_new}
    return torch.cat([prompt, gen[None]], dim=1), stats

