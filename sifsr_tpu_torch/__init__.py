"""PyTorch/CUDA port of sifsr_tpu for NVIDIA Hopper (H100).

The JAX package ``sifsr_tpu`` is the reference; this package re-implements
its whole-granule serving path (``cli.predict``, ``cli.serve``, every granule
mode), its training path (three recipes, the native loader and the
streaming dataset, data parallelism over ``torch.distributed``), its evaluation with the
classical baselines (``cli.model_perf``, ``cli.compare_methods``) and its
data-preparation tools, and its comparison steps (the space-to-depth packed
float and int8 steps) and FLOP counts, in PyTorch, with every TPU kernel of the repository
written by hand in CUDA C++ for ``sm_90a`` (``csrc/``, bound through ctypes by
``kernels/_build.py``). It imports neither JAX nor anything of ``sifsr_tpu``.

Public functions keep the JAX package's NHWC layouts. Entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when CUDA is absent;
pass ``device="cpu"`` to run every kernel's plain PyTorch version instead.
"""

from sifsr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
