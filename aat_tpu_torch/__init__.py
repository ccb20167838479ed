"""PyTorch + CUDA port of ``aat_tpu`` for NVIDIA Hopper.

Imports torch and numpy only, never ``jax`` or ``aat_tpu``: the JAX
package stays beside it as the reference. Module names mirror the JAX
package's; hand-written kernels live in ``csrc/`` and are built at first
use by :mod:`aat_tpu_torch.runtime.kernels`.
"""
