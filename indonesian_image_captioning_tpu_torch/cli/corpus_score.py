"""Corpus statistics: unigram LM perplexity and vocabulary counts.

``python -m indonesian_image_captioning_tpu_torch.cli.corpus_score -c
captions.json``.  Counterpart of the JAX package's ``cli/corpus_score.py``
(the reference's scratch script corpus_score.py: unigram, prob_sentence
and perplexity at :9-45, the vocabulary counts at :110-118), over a
captions JSON (a list of token lists or strings); it prints the same five
lines.  Pure Python.
"""

from __future__ import annotations

import argparse
import json
import math
from collections import Counter
from typing import Iterable, List


def unigram(corpus: Iterable[List[str]]) -> Counter:
    counts = Counter()
    for sent in corpus:
        counts.update(sent)
    return counts


def prob_sentence(sentence: List[str], counts: Counter) -> float:
    """The sentence's log-probability under the unigram counts (-inf when
    a word has none)."""
    total = sum(counts.values())
    logp = 0.0
    for w in sentence:
        c = counts.get(w, 0)
        if c == 0:
            return float("-inf")
        logp += math.log(c / total)
    return logp


def perplexity(corpus: List[List[str]], counts: Counter) -> float:
    n_words = sum(len(s) for s in corpus)
    logp = sum(prob_sentence(s, counts) for s in corpus)
    return math.exp(-logp / max(n_words, 1))


def main(argv=None):
    p = argparse.ArgumentParser(description="Corpus unigram stats")
    p.add_argument("--captions", "-c", required=True,
                   help="JSON file: list of captions (strings or token lists)")
    p.add_argument("--min_word_freq", type=int, default=5)
    args = p.parse_args(argv)
    with open(args.captions) as f:
        raw = json.load(f)
    corpus = [c.split() if isinstance(c, str) else list(c) for c in raw]
    counts = unigram(corpus)
    kept = sum(1 for w, c in counts.items() if c > args.min_word_freq)
    print(f"sentences: {len(corpus)}")
    print(f"tokens: {sum(counts.values())}")
    print(f"vocab: {len(counts)}")
    print(f"vocab (freq > {args.min_word_freq}): {kept}")
    print(f"unigram perplexity: {perplexity(corpus, counts):.3f}")


if __name__ == "__main__":
    main()
