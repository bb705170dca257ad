"""pressurepoissonsolver_torch — the composite-grid Poisson solver in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`pressurepoissonsolver_tpu` (the JAX reference): fixed-size
cell-centered patches on quadtrees with 2:1 balance, DST/DCT patch solvers
as batched matmuls, FAC geometric multigrid with active-set smoothing, and
mixed-precision iteratively refined BiCGStab.  Fields keep the reference
layout ``[P, ny, nx]`` (x fastest) and face vectors ``[P, 2D, m]``.

This slice covers the 2D solve (``PoissonSolver.solve`` and
``solve_refined``).  The ghost-closure stencil runs as the CUDA kernel in
``csrc/ghost_stencil.cu`` on CUDA tensors and as its plain PyTorch
version on CPU tensors.

Importing the package has no side effects: no global dtype or backend
setting is changed and no kernel is built.  Every object that holds
tensors takes an explicit ``device``.
"""

__version__ = "0.1.0"
