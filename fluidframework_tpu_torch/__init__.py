"""fluidframework-tpu-torch — the PyTorch/CUDA port of ``fluidframework_tpu``.

The same collaboration service, with its device hot paths written in
PyTorch for an NVIDIA H100 and the kernels the reference package wrote in
Pallas rewritten by hand in CUDA C++ for ``sm_90a`` (``csrc/``). The JAX
package stays beside it as the reference: each ported module keeps its
counterpart's name and layout, and differential tests (``tests/
test_torch_*.py``) hold the two byte for byte on the same inputs.

This package imports ``torch`` and numpy, never ``jax`` and never the
reference package: every module it needs is its own copy.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise instead of serving on the CPU. Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels (the tests do).

Ported so far: the map-storm serving tick — the deli sequencer
(``ops/sequencer.py`` + ``ops/sequencer_cuda.py``), the SharedMap LWW fold
(``ops/map_kernel.py`` + ``ops/map_fold_cuda.py``), their hosts
(``server/kernel_host.py``, the map half of ``server/merge_host.py``),
the routerlicious service and the map-only ``server/storm.py``.
"""

__version__ = "0.1.0"
