"""Indonesian image captioning in PyTorch, with hand-written Hopper kernels.

The port of ``indonesian_image_captioning_tpu`` (JAX, XLA and Pallas) to
PyTorch and CUDA on an NVIDIA H100.  It mirrors the JAX package's layout
(``core/``, ``data/``, ``models/``, ``ops/``, ``decode/``, ``serve/``,
``train/``, ``evaluation/``, ``cli/``) and function
names, and keeps its public layouts (NHWC features, ``(in, out)`` linear
weights, the fused SCN gate layout) so the two are compared like with like
(``tests/test_torch_*.py``).

Every Pallas kernel of the JAX package is a CUDA C++ kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use and bound with
``ctypes`` (``ops/_build.py``).  Each kernel's wrapper keeps a plain
PyTorch version beside it, which it runs only for tensors on the CPU.

Imports ``torch`` and never ``jax``, nor anything of the JAX package:
``core/config.py`` keeps its own copy of the JAX package's configuration
dataclasses, field for field, and the pure-Python modules it needs
(``core/tokens.py``, ``data/vocab.py``, ``evaluation/metrics.py``) are
copies too.
"""

__version__ = "0.1.0"
