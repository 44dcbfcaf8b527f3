"""Special-token constants shared by the vocabulary, decoders and evaluation.

The port's copy of the JAX package's ``core/tokens.py``.

Parity: reference utils/token.py:1-4.  The padding token id is fixed to 0 by
the wordmap builder (reference utils/dataset.py:301-306); <unk>/<start>/<end>
are appended after the corpus words.
"""

START_TOKEN = "<start>"
END_TOKEN = "<end>"
UNKNOWN_TOKEN = "<unk>"
PADDING_TOKEN = "<pad>"

# id of the padding token in every wordmap produced by this framework.
PAD_ID = 0
