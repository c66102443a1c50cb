"""deepmerge_tpu_torch — the PyTorch/CUDA port of ``deepmerge_tpu``.

The JAX package stays in the repository as the reference this port is held
against. This package imports ``torch`` and never ``jax``, and nothing of
``deepmerge_tpu``: it keeps its own copies of the reference's host modules
(``config``, ``geodata``, ``native``, ``utils``) under the same names. The
TPU's Pallas kernels on the ported paths are hand-written CUDA C++ for
Hopper (``csrc/``), built at first use by ``ops.kernels.build``; on CPU
tensors every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from deepmerge_tpu_torch.config import Config, DataConfig, ModelConfig  # noqa: F401
