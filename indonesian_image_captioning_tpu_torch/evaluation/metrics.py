"""Caption metrics: BLEU-1..4, ROUGE-L, CIDEr-D (pure Python, CPU).

The port's copy of the JAX package's ``evaluation/metrics.py``; the
trainer's BLEU-4 gate is :func:`corpus_bleu_nltk_style`, so nltk is needed
only by :func:`meteor`.  One difference: :func:`corpus_bleu_nltk_style`
follows nltk 3.10's ``corpus_bleu`` (the JAX trainer's gate) also where a
higher-order precision is zero -- nltk then takes ``sys.float_info.min``
for it, a tiny positive score, where the JAX package's copy returns 0 --
so the port's gate sees the same improvement over 0 on an epoch that
matches unigrams only.

The reference scores with nlg-eval (eval_caption.py:149-159), which wraps the
MSCOCO caption-eval implementations, and with nltk ``corpus_bleu`` during
validation (trains/attention_scn.py:377).  nlg-eval is not in this image, so
the metrics are implemented natively with the SAME definitions:

  * ``corpus_bleu_coco`` — Papineni corpus BLEU with the "closest" effective
    reference length and uniform n-gram weights, the variant reported as
    Bleu_1..Bleu_4 by nlg-eval/pycocoevalcap.
  * ``corpus_bleu_nltk_style`` — the validation-time variant: average
    per-corpus modified precisions exactly like nltk's default
    (method0 smoothing), so the trainers' BLEU-4 matches the reference's.
  * ``rouge_l_coco`` — LCS F-beta (beta=1.2), max over references, averaged
    over the corpus (pycocoevalcap Rouge).
  * ``cider_d`` — TF-IDF weighted n-gram cosine with length penalty
    (sigma=6), the pycocoevalcap CIDEr-D definition.  English-only in the
    reference README (:73-75) but available for any corpus here.

  * ``meteor`` — nltk's WordNet-based METEOR (Lavie & Agarwal 2007),
    averaged over the corpus.  nlg-eval scores METEOR with the METEOR-1.5
    Java jar (English paraphrase tables); that jar is not in this image, so
    exact-jar parity is waived (BASELINE.md) — nltk's exact+stem+wordnet
    matcher is the closest pure-Python equivalent and is English-only in
    practice, matching the reference README's English-only METEOR claim
    (README.md:73-75).
"""

from __future__ import annotations

import math
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

Tokens = Sequence[str]


def _ngrams(tokens: Tokens, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

def _modified_precision_stats(references: List[Tokens], hypothesis: Tokens,
                              n: int, min_denom: int = 0):
    """(clipped count, total count).  nltk clamps the per-sentence
    denominator at 1 even for hypotheses shorter than n (min_denom=1);
    pycocoevalcap lets it be 0 (min_denom=0)."""
    hyp_ngrams = _ngrams(hypothesis, n)
    denom = max(min_denom, len(hypothesis) - n + 1)
    if not hyp_ngrams:
        return 0, denom
    max_ref = Counter()
    for ref in references:
        for ng, c in _ngrams(ref, n).items():
            max_ref[ng] = max(max_ref[ng], c)
    clipped = sum(min(c, max_ref[ng]) for ng, c in hyp_ngrams.items())
    return clipped, denom


def _closest_ref_len(references: List[Tokens], hyp_len: int) -> int:
    return min((abs(len(r) - hyp_len), len(r)) for r in references)[1]


def corpus_bleu_coco(list_of_references: List[List[Tokens]],
                     hypotheses: List[Tokens],
                     max_n: int = 4) -> List[float]:
    """Returns [BLEU-1, ..., BLEU-max_n] (cumulative, uniform weights),
    pycocoevalcap ``Bleu`` semantics (tiny-epsilon smoothing of zero
    precisions, closest reference length)."""
    assert len(list_of_references) == len(hypotheses)
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len_sum = 0
    ref_len_sum = 0
    for refs, hyp in zip(list_of_references, hypotheses):
        hyp_len_sum += len(hyp)
        ref_len_sum += _closest_ref_len(refs, len(hyp))
        for n in range(1, max_n + 1):
            c, t = _modified_precision_stats(refs, hyp, n)
            clipped[n - 1] += c
            totals[n - 1] += t
    small, tiny = 1e-9, 1e-15  # pycocoevalcap's ratio guards
    bp = 1.0 if hyp_len_sum > ref_len_sum else math.exp(
        1 - ref_len_sum / max(hyp_len_sum, 1))
    bleus = []
    log_sum = 0.0
    for n in range(max_n):
        p_n = (clipped[n] + tiny) / (totals[n] + small)
        log_sum += math.log(p_n)
        bleus.append(bp * math.exp(log_sum / (n + 1)))
    return bleus


def corpus_bleu_nltk_style(list_of_references: List[List[Tokens]],
                           hypotheses: List[Tokens],
                           weights=(0.25, 0.25, 0.25, 0.25)) -> float:
    """nltk.translate.corpus_bleu default semantics (nltk 3.10, method0
    "smoothing"), used for validation-gate parity: 0 when no unigram
    matches; a zero higher-order precision counts as
    ``sys.float_info.min``, which leaves a tiny positive score."""
    max_n = len(weights)
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len_sum = 0
    ref_len_sum = 0
    for refs, hyp in zip(list_of_references, hypotheses):
        hyp_len_sum += len(hyp)
        ref_len_sum += _closest_ref_len(refs, len(hyp))
        for n in range(1, max_n + 1):
            c, t = _modified_precision_stats(refs, hyp, n, min_denom=1)
            clipped[n - 1] += c
            totals[n - 1] += t
    if clipped[0] == 0:
        return 0.0
    bp = 1.0 if hyp_len_sum > ref_len_sum else math.exp(
        1 - ref_len_sum / max(hyp_len_sum, 1))
    s = math.fsum(w * math.log(clipped[i] / totals[i] if clipped[i]
                               else sys.float_info.min)
                  for i, w in enumerate(weights))
    return bp * math.exp(s)


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------

def _lcs_len(a: Tokens, b: Tokens) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_coco(list_of_references: List[List[Tokens]],
                 hypotheses: List[Tokens], beta: float = 1.2) -> float:
    """pycocoevalcap Rouge: per-pair max precision/recall over refs,
    F-beta, corpus mean."""
    scores = []
    for refs, hyp in zip(list_of_references, hypotheses):
        prec, rec = [], []
        for ref in refs:
            lcs = _lcs_len(ref, hyp)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(ref) if ref else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            scores.append(((1 + beta ** 2) * p * r) / (r + beta ** 2 * p))
        else:
            scores.append(0.0)
    return sum(scores) / len(scores) if scores else 0.0


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------

def cider_d(list_of_references: List[List[Tokens]],
            hypotheses: List[Tokens], max_n: int = 4,
            sigma: float = 6.0) -> float:
    """pycocoevalcap CIDEr-D: TF-IDF n-gram cosine with gaussian length
    penalty, averaged over n in 1..4, x10."""
    num = len(hypotheses)
    if num == 0:
        return 0.0
    # document frequencies over reference sets
    doc_freq: List[Dict[tuple, int]] = [defaultdict(int) for _ in range(max_n)]
    for refs in list_of_references:
        for n in range(max_n):
            seen = set()
            for ref in refs:
                seen.update(_ngrams(ref, n + 1).keys())
            for ng in seen:
                doc_freq[n][ng] += 1
    log_num = math.log(max(num, 1))

    def vec(tokens: Tokens):
        vs, norms = [], []
        for n in range(max_n):
            counts = _ngrams(tokens, n + 1)
            v = {}
            for ng, c in counts.items():
                df = math.log(max(doc_freq[n][ng], 1))
                v[ng] = c * (log_num - df)
            vs.append(v)
            norms.append(math.sqrt(sum(x * x for x in v.values())))
        return vs, norms

    total = 0.0
    for refs, hyp in zip(list_of_references, hypotheses):
        hv, hn = vec(hyp)
        score_n = [0.0] * max_n
        for ref in refs:
            rv, rn = vec(ref)
            delta = len(hyp) - len(ref)
            length_pen = math.exp(-(delta ** 2) / (2 * sigma ** 2))
            for n in range(max_n):
                # CIDEr-D clips hypothesis counts to reference counts
                dot = sum(min(c, rv[n].get(ng, 0.0)) * rv[n].get(ng, 0.0)
                          for ng, c in hv[n].items())
                if hn[n] and rn[n]:
                    score_n[n] += length_pen * dot / (hn[n] * rn[n])
        total += 10.0 * sum(s / len(refs) for s in score_n) / max_n
    return total / num


class _EmptyWordnet:
    """WordNet stand-in when the nltk corpus data is absent (zero-egress
    image): the synonym-matching stage matches nothing, leaving nltk's
    exact + Porter-stem stages — METEOR's language-independent core."""

    @staticmethod
    def synsets(word):
        return []


def _wordnet_or_empty():
    try:
        from nltk.corpus import wordnet
        wordnet.synsets("dog")       # force the lazy corpus load
        return wordnet
    except LookupError:
        return _EmptyWordnet()


def meteor(list_of_references: List[List[Tokens]],
           hypotheses: List[Tokens]) -> float:
    """Corpus-mean nltk METEOR (exact/stem/synonym unigram alignment with
    the fragmentation penalty, Lavie & Agarwal 2007 defaults).  Synonym
    matching needs the WordNet corpus; without it the exact+stem stages
    still run.  See the module docstring for the parity waiver vs
    nlg-eval's METEOR-1.5 Java jar."""
    from nltk.translate.meteor_score import meteor_score
    if not hypotheses:
        return 0.0
    wn = _wordnet_or_empty()
    total = 0.0
    for refs, hyp in zip(list_of_references, hypotheses):
        total += meteor_score([list(r) for r in refs], list(hyp), wordnet=wn)
    return total / len(hypotheses)


def compute_metrics(list_of_references: List[List[Tokens]],
                    hypotheses: List[Tokens],
                    include_cider: bool = True,
                    include_meteor: bool = True) -> Dict[str, float]:
    """The nlg-eval-shaped score dict the reference dumps
    (eval_caption.py:149-163): Bleu_1..4, METEOR, ROUGE_L, CIDEr."""
    bleus = corpus_bleu_coco(list_of_references, hypotheses)
    out = {f"Bleu_{i+1}": b for i, b in enumerate(bleus)}
    if include_meteor:
        out["METEOR"] = meteor(list_of_references, hypotheses)
    out["ROUGE_L"] = rouge_l_coco(list_of_references, hypotheses)
    if include_cider:
        out["CIDEr"] = cider_d(list_of_references, hypotheses)
    return out
