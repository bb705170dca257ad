"""The port's command-line apps against the JAX reference's on the
``--schur`` path, on the CPU: every interface preconditioner, the monitored
Schur solves, the assembled (``--matrix-type crs``) and pointer-block
(``--matrix-type pbm``) interface operators, ``--out-gamma``, and a 3D
Schur run.  Meshes, comparisons and tolerances as in ``test_torch_cli.py``."""

import pytest

from test_torch_cli import BASE2, BASE3, compare_runs, meshes, outputs_equal, run_both  # noqa: F401

# (D, argv)
CASES = {
    "gmg-gamma": (2, BASE2 + ["--schur", "--out-gamma", "{out}/gamma.npy"]),
    "cheb-gmres-monitor": (2, BASE2 + ["--schur", "--prec", "cheb", "--solver", "gmres",
                                       "--monitor"]),
    "blockjacobi-monitor": (2, BASE2 + ["--schur", "--prec", "BlockJacobi", "--monitor"]),
    "none-cg-monitor": (2, BASE2 + ["--schur", "--prec", "none", "--solver", "cg",
                                    "--monitor"]),
    "crs-blockjacobi": (2, BASE2 + ["--schur", "--matrix-type", "crs", "--prec",
                                    "BlockJacobi"]),
    "crs-gmg-gmres": (2, BASE2 + ["--schur", "--matrix-type", "crs", "--solver", "gmres"]),
    "pbm-gmg": (2, BASE2 + ["--schur", "--matrix-type", "pbm", "--out-gamma",
                            "{out}/gamma.npy"]),
    "pbm-cheb-neumann": (2, BASE2 + ["--schur", "--matrix-type", "pbm", "--prec", "cheb",
                                     "--neumann"]),
    "3d-gmg-monitor": (3, BASE3 + ["--schur", "--monitor"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_schur_matches_reference(case, meshes, tmp_path):  # noqa: F811
    D, argv = CASES[case]
    j, t = run_both(D, argv, meshes, tmp_path)
    compare_runs(argv, j, t)
    outputs_equal(j[2], t[2], exact_rhs="--neumann" not in argv)
