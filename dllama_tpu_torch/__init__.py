"""PyTorch/CUDA port of dllama_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one, with the same layout (``formats/``,
``tokenizer/``, ``models/``, ``ops/``, ``runtime/``, ``serve/``). It imports
``torch`` and never the JAX package: the host-only modules it needs are its
own copies. The Pallas kernels on its path are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built at first use (:mod:`.ops.cuda_build`).
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
