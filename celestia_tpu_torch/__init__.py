"""celestia_tpu_torch: the PyTorch + CUDA port of celestia_tpu for NVIDIA Hopper.

Same module layout as ``celestia_tpu``; every device program of that
package becomes a CUDA C++ kernel under ``csrc/`` (built at first use by
``kernels/``), each with a plain PyTorch twin in the module that wraps it.
Imports ``torch`` and ``numpy`` only — never ``jax`` or ``celestia_tpu``.
Entry points run on the card (``cuda:0``) unless the caller passes
``device="cpu"``.
"""
