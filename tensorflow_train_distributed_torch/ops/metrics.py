"""Host-side evaluation metrics (counterpart of the JAX package's
``ops/metrics.py``, copied: pure Python, run on decoded outputs).

BLEU for the WMT config: ``models.transformer.beam_translate`` (or
``greedy_translate``) decodes, ``corpus_bleu`` scores.  Standard BLEU-4:
modified n-gram precision with clipping, geometric mean, brevity penalty
(Papineni et al. 2002).
"""

from __future__ import annotations

import collections
import math
from typing import Iterable, Sequence


def _ngrams(tokens: Sequence, n: int) -> collections.Counter:
    return collections.Counter(
        tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(hypotheses: Iterable[Sequence],
                references: Iterable[Sequence],
                *, max_order: int = 4, smooth: bool = False) -> float:
    """Corpus-level BLEU in [0, 100] over token-id (or str) sequences.

    One reference per hypothesis (the WMT newstest convention this harness
    needs).  ``smooth``: add-one smoothing on higher-order precisions
    (Lin & Och 2004) for tiny corpora where 4-gram matches may be zero.
    """
    hyps, refs = list(hypotheses), list(references)
    if len(hyps) != len(refs):
        raise ValueError(
            f"{len(hyps)} hypotheses vs {len(refs)} references")
    if not hyps:
        return 0.0
    matches = [0] * max_order
    totals = [0] * max_order
    hyp_len = ref_len = 0
    for hyp, ref in zip(hyps, refs):
        hyp, ref = list(hyp), list(ref)
        hyp_len += len(hyp)
        ref_len += len(ref)
        for n in range(1, max_order + 1):
            h, r = _ngrams(hyp, n), _ngrams(ref, n)
            matches[n - 1] += sum((h & r).values())
            totals[n - 1] += max(len(hyp) - n + 1, 0)
    log_precisions = []
    for order0, (m, t) in enumerate(zip(matches, totals)):
        if smooth and order0 > 0:  # Lin & Och smooth orders > 1 only
            m, t = m + 1, t + 1
        if m == 0 or t == 0:
            return 0.0
        log_precisions.append(math.log(m / t))
    geo = math.exp(sum(log_precisions) / max_order)
    bp = (1.0 if hyp_len >= ref_len
          else math.exp(1.0 - ref_len / max(hyp_len, 1)))
    return 100.0 * bp * geo


def strip_after_eos(ids: Sequence[int], eos_id: int) -> list[int]:
    """Token ids up to (excluding) the first EOS.

    Deliberately does NOT drop any other id: token 0 is a legitimate
    vocab id (<unk>/<pad> conventions vary), and ``greedy_translate``
    only writes padding AFTER the first EOS, so truncation alone is the
    correct cleanup for its output.
    """
    out = []
    for t in ids:
        if t == eos_id:
            break
        out.append(int(t))
    return out
