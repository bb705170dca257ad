"""pressurepoissonsolver_torch — the composite-grid Poisson solver in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`pressurepoissonsolver_tpu` (the JAX reference): fixed-size
cell-centered patches on quadtrees/octrees with 2:1 balance, DST/DCT patch
solvers as batched matmuls, FAC geometric multigrid with active-set
smoothing, and mixed-precision iteratively refined BiCGStab.  Fields keep
the reference layout ``[P, ny, nx]`` / ``[P, nz, ny, nx]`` (x fastest) and
face vectors ``[P, 2D, m]``.

The port covers everything the reference does on one device: the 2D and
3D solves (``PoissonSolver.solve`` with BiCGStab, CG or GMRES,
``solve_refined`` with inner BiCGStab, CG or Richardson, ``solve_schur``
with every interface preconditioner, ``solve_monitored``), the V- and
W-cycles with constant or linear prolongation, the quadratic 2D closures,
the assembled operators (``matrix.bcoo_matvec``, ``pbm_matvec``) and the
command-line apps (``python -m pressurepoissonsolver_torch.apps.steady2d``
/ ``steady3d``, :mod:`.cli`), and runs them patch-sharded over several
devices, one rank each, over ``torch.distributed`` (:mod:`.parallel`)
through either of the reference's engines: the cut-face halo engine, whose
exchange overlaps the stencil, or the gathered engine (``comm="pjit"``).
It also runs the reference's multi-host check
(:mod:`.scripts.multihost`).  The ghost-closure stencils run as the CUDA kernels in
``csrc/ghost_stencil.cu`` (2D) and ``csrc/ghost_stencil_3d.cu`` (3D) on
CUDA tensors and as their plain PyTorch versions on CPU tensors.

Importing the package has no side effects: no global dtype or backend
setting is changed and no kernel is built.  Every object that holds
tensors takes an explicit ``device``.
"""

__version__ = "0.1.0"
