"""deeplio_tpu_torch — the PyTorch/CUDA port of ``deeplio_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``config/``, ``ops/``, ``models/``, ``data/``, ``eval/``, ``utils/``) so
each counterpart is easy to find, and imports nothing of JAX or of the
JAX package. The hot kernels are hand-written CUDA for Hopper
(``csrc/``), built with ``nvcc`` at first use (``ops/_kernels.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``device.py``).
"""

__version__ = "0.1.0"
