"""Device hot paths in PyTorch, with hand-written CUDA kernels.

Each ported kernel has three parts side by side: the plain PyTorch
version (``sequencer.process_batch``, ``map_kernel.fold_words_plain``,
``mergetree_blocks.apply_tick_blocks``, ``mergetree_kernel.apply_tick``,
``matrix_kernel.apply_tick``, ``matrix_kernel.apply_tick_steps``),
the CUDA C++ kernel under ``../csrc/`` built by :mod:`._build`, and a
``*_best`` wrapper that launches the kernel for CUDA tensors and runs the
plain version only for tensors on the CPU.
"""
