"""celestia_tpu_torch: the PyTorch + CUDA port of celestia_tpu for NVIDIA Hopper.

Same module layout as ``celestia_tpu``; every device program of that
package becomes a CUDA C++ kernel under ``csrc/`` (built at first use by
``kernels/``), each with a plain PyTorch twin in the module that wraps it.
Imports ``torch`` and ``numpy`` only — never ``jax`` or ``celestia_tpu``.
Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``.

Kept import-light: one environment check arms the lock-order shadow
checker (utils/lockwatch.py) BEFORE any submodule constructs its
module-level locks -- the watcher can only wrap locks whose construction
it precedes.  Without ``CELESTIA_TPU_TORCH_LOCKWATCH`` in the environment
this file does nothing.
"""

import os as _os

if _os.environ.get("CELESTIA_TPU_TORCH_LOCKWATCH", "").strip():
    from celestia_tpu_torch.utils import lockwatch as _lockwatch

    _lockwatch.install_from_env()
