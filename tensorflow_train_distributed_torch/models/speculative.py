"""Speculative decoding's shared rules: a small draft model proposes, the
target verifies a block of proposals in one forward.

Counterpart of the JAX package's ``models/speculative.py`` without its
batch-1 library path (``generate_speculative``), which comes with the
port's ``generate()``.  The serving engine (``serving.ServingEngine`` with
a draft) runs these rules over all slots at once:

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
"""

from __future__ import annotations

import torch

from tensorflow_train_distributed_torch.models.llama import LlamaConfig


def _reject_config(name: str, cfg) -> None:
    if not isinstance(cfg, LlamaConfig):
        raise ValueError(
            f"{name} config is {type(cfg).__name__}; speculative decode "
            "supports the Llama family only")
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
