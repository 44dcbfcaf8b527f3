"""The caption trainer: its steps (``steps.py``), feature cache, epoch
loop and ``caption.py``'s ``main`` and ``train``."""
