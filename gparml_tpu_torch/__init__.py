"""gparml_tpu_torch — the PyTorch / CUDA port of gparml_tpu.

Counterpart of ``gparml_tpu/__init__.py``. The package mirrors the JAX
package's layout module for module (``ops/``, ``models/``, ``opt/``,
``utils/``, ``parallel/``, ``data.py``), imports ``torch`` and ``numpy`` and
never ``jax``. The Psi-statistics forward and backward run in hand-written
CUDA kernels (``csrc/``) on an NVIDIA Hopper card and in plain PyTorch on
CPU tensors.
"""

__version__ = "0.1.0"

from gparml_tpu_torch import data  # noqa: E402
from gparml_tpu_torch.models import gplvm, params  # noqa: E402
from gparml_tpu_torch.opt import scg  # noqa: E402

__all__ = ["data", "gplvm", "params", "scg", "__version__"]
