"""The port's command-line apps against the JAX reference's, on the CPU:
the same argv through ``pressurepoissonsolver_tpu.cli.main`` and
``pressurepoissonsolver_torch.cli.main(..., device="cpu")``.

Meshes: ``refined_tree(2, 3, 1)`` at n=8 (19 patches, 1216 DOF) and
``refined_tree(3, 2, 1)`` at n=4 (15 patches), written with
``Tree.to_file`` and read back through ``--mesh``; ``--uniform``/``--divide``
in one case.  The composite-solve cases are here, the ``--schur`` cases in
``test_torch_cli_schur.py``; together they pass every single-device flag
of the reference CLI.

Held equal: the out-json's iteration counts (exactly; within one where an
f32 cycle is inside), its error to 1e-10 relative and its residual and
conservation (already relative quantities / round-off) to 1e-10 absolute;
the printed lines (every word equal, integers equal, other numbers to
``LINE_ATOL``), the timer's section names but not its seconds; the output
files (text files word for word, numbers to 1e-9 of the file's largest;
arrays as below).  Runs with f32 vectors throughout (``--dtype float32``)
are held to 1e-5."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pressurepoissonsolver_tpu.cli as jcli
import pressurepoissonsolver_tpu.utils.timer as jtimer
import pressurepoissonsolver_tpu.utils.writers as jwriters
import pressurepoissonsolver_torch.cli as tcli
import pressurepoissonsolver_torch.geometry as tgeo
import pressurepoissonsolver_torch.utils.timer as ttimer
import pressurepoissonsolver_torch.utils.writers as twriters

from _torch_parity import hierarchies

# the meshes the cases read: (D, base levels, corner levels)
MESHES = {"m2": (2, 3, 1), "m3": (3, 2, 1)}
BASE2 = ["--mesh", "{m2}", "-n", "8", "-t", "1e-10", "--gmg-coarse-direct-dof", "64"]
BASE3 = ["--mesh", "{m3}", "-n", "4", "-t", "1e-10"]
NUM = re.compile(r"[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|nan|inf)")
# the printed numbers: to round-off with f64 vectors; with an f32 cycle
# inside, the outer residual history moves with the f32 rounding of the
# inner solves (about 1e-8 of ||f||)
LINE_ATOL = {"f64": 1e-10, "f32-cycle": 1e-7, "f32": 1e-5}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    out = {}
    for name, (D, base, corner) in MESHES.items():
        out[name] = str(d / f"{name}.bin")
        tgeo.refined_tree(D, base, corner).to_file(out[name])
    return out


def precision(argv) -> str:
    """"f32" when every vector is f32, "f32-cycle" when an f32 cycle runs
    inside an f64 solve, else "f64"."""
    dtype = argv[argv.index("--dtype") + 1] if "--dtype" in argv else "float64"
    if dtype == "float32":
        return "f32"
    if dtype == "mixed" or ("--solver" in argv and argv[argv.index("--solver") + 1] == "ir"):
        return "f32-cycle"
    return "f64"


def run_both(D, argv, meshes, tmp_path):
    """``argv`` (``{m2}``/``{m3}`` name a mesh, ``{out}`` a per-package
    output directory) through both CLIs; per package the out-json, the
    printed lines and the output directory."""
    res = {}
    for name, main in (("jax", lambda a: jcli.main(D, a)),
                       ("port", lambda a: tcli.main(D, a, device="cpu"))):
        out = tmp_path / name
        out.mkdir()
        args = [a.format(out=out, **meshes) for a in argv]
        args += ["--out-json", str(out / "out.json")]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(args) == 0
        res[name] = (json.loads((out / "out.json").read_text()),
                     buf.getvalue().splitlines(), out)
    return res["jax"], res["port"]


def _numbers_close(a: str, b: str, atol: float) -> bool:
    if re.fullmatch(r"[-+]?\d+", a):  # counts, sizes, indices
        return a == b
    x, y = float(a), float(b)
    return (np.isnan(x) and np.isnan(y)) or abs(x - y) <= atol


def lines_equal(jlines, tlines, atol):
    """The printed lines: the same words, integers equal, other numbers
    within ``atol``; timer seconds are skipped."""
    jl = [l for l in jlines if "(sec)" not in l]
    tl = [l for l in tlines if "(sec)" not in l]
    assert len(jl) == len(tl), (jl, tl)
    for a, b in zip(jl, tl):
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        for x, y in zip(NUM.findall(a), NUM.findall(b)):
            assert _numbers_close(x, y, atol), (a, b)


def outputs_equal(jout, tout, exact_rhs, atol_scale=1e-9):
    """Every text file word for word with its numbers within ``atol_scale``
    of the file's largest; ``.npy`` arrays to 1e-10 of their largest (the
    right-hand side exactly when ``exact_rhs``: ``--neumann`` shifts it by
    a computed mean); ``.npz`` CSR matrices exactly."""
    jfiles = sorted(p.relative_to(jout) for p in jout.rglob("*") if p.is_file())
    tfiles = sorted(p.relative_to(tout) for p in tout.rglob("*") if p.is_file())
    assert jfiles == tfiles
    for rel in jfiles:
        a, b = jout / rel, tout / rel
        if rel.suffix == ".json":
            continue
        if rel.suffix == ".npz":
            A, B = sp.load_npz(a), sp.load_npz(b)
            assert A.shape == B.shape and (A != B).nnz == 0
        elif rel.suffix == ".npy":
            x, y = np.load(a), np.load(b)
            assert x.shape == y.shape and x.dtype == y.dtype
            if rel.name.startswith("rhs") and exact_rhs:
                assert np.array_equal(x, y)
            else:
                assert np.abs(x - y).max() <= 1e-10 * np.abs(x).max()
        else:
            ta, tb = a.read_text(), b.read_text()
            assert NUM.sub("#", ta) == NUM.sub("#", tb), rel
            xa = np.array([float(v) for v in NUM.findall(ta)])
            xb = np.array([float(v) for v in NUM.findall(tb)])
            scale = np.abs(xa).max() if xa.size else 1.0
            assert np.abs(xa - xb).max(initial=0.0) <= atol_scale * scale, rel


def compare_runs(argv, j, t):
    """The out-json and printed lines of one argv (see the module doc)."""
    (jj, jlines, _), (tj, tlines, _) = j, t
    prec = precision(argv)
    assert set(jj) == set(tj)
    band = 0 if prec == "f64" else 1
    for key in ("iterations", "outer_iterations", "inner_iterations"):
        if key in jj:
            assert abs(jj[key] - tj[key]) <= (0 if key == "outer_iterations" else band), key
    assert jj["dof"] == tj["dof"]
    tol = 1e-5 if prec == "f32" else 1e-10
    assert abs(jj["error"] - tj["error"]) <= tol * jj["error"]
    assert abs(jj["residual"] - tj["residual"]) <= tol
    assert abs(jj["conservation"] - tj["conservation"]) <= tol
    counts_equal = all(jj[k] == tj[k] for k in jj if k.endswith("iterations"))
    if counts_equal:
        lines_equal(jlines, tlines, LINE_ATOL[prec])
    else:  # one more or one fewer monitor line: compare the other lines
        keep = [l for l in jlines if "rel residual" not in l and not l.startswith("Iter")]
        lines_equal(keep, [l for l in tlines if "rel residual" not in l
                           and not l.startswith("Iter")], LINE_ATOL[prec])


OUTPUTS = ["--out-claw", "{out}/claw", "--out-vtk", "{out}/vtk", "--out-rhs",
           "{out}/rhs.npy", "--out-gamma", "{out}/gamma.npy", "--out-matrix",
           "{out}/A.npz"]

# (D, argv): the composite solves
CASES = {
    "default-outputs": (2, BASE2 + OUTPUTS),
    "cg": (2, BASE2 + ["--solver", "cg"]),
    "cg-mixed-monitor": (2, BASE2 + ["--solver", "cg", "--dtype", "mixed", "--monitor"]),
    "bicgstab-monitor": (2, BASE2 + ["--monitor", "--max_iterations", "50"]),
    "gmres-monitor": (2, BASE2 + ["--solver", "gmres", "--monitor"]),
    "gmres-none": (2, BASE2 + ["--solver", "gmres", "--prec", "none",
                               "--max_iterations", "400"]),
    "ir-cg-monitor": (2, BASE2 + ["--solver", "ir", "--monitor"]),
    "ir-richardson": (2, BASE2 + ["--solver", "ir", "--inner-solver", "richardson",
                                  "--inner-tol", "1e-4"]),
    "ir-quadratic": (2, BASE2 + ["--solver", "ir", "--inner-solver", "bicgstab",
                                 "--iface-interp", "quadratic", "--gmg-pre-sweeps", "2",
                                 "--gmg-fac-smoothing", "active", "--out-gamma",
                                 "{out}/gamma.npy"]),
    "w-cycle": (2, BASE2 + ["--gmg-cycle-type", "W", "--gmg-mid-sweeps", "2",
                            "--gmg-post-sweeps", "2"]),
    "linear-coarse-sweeps": (2, BASE2 + ["--gmg-interpolator", "linear",
                                         "--gmg-coarse-sweeps", "2",
                                         "--gmg-coarse-direct-dof", "0"]),
    "schwarz-bcgs": (2, BASE2 + ["--prec", "Schwarz", "--patch_solver", "bcgs"]),
    "crs-cg": (2, BASE2 + ["--matrix-type", "crs", "--solver", "cg"]),
    "crs-gmres": (2, BASE2 + ["--matrix-type", "crs", "--solver", "gmres"]),
    "neumann": (2, BASE2 + ["--neumann", "--out-rhs", "{out}/rhs.npy"]),
    "neumann-sides-gauss": (2, BASE2 + ["--neumann-sides", "x_lo,y_hi", "--nozerof",
                                        "--problem", "gauss"]),
    "uniform-f32-loop": (2, ["--uniform", "3", "--divide", "1", "-n", "4", "--dtype",
                             "float32", "-t", "1e-5", "--patch_solver", "fftw",
                             "--gmg-max-levels", "3", "--gmg-patches-per-shard", "2",
                             "--gmg-fac-ring", "2", "--gmg-fac-smoothing", "active",
                             "--comm", "halo", "--loop", "2"]),
    "3d-ir-outputs": (3, BASE3 + ["--solver", "ir", "--out-vtk", "{out}/vtk",
                                  "--out-gamma", "{out}/gamma.npy"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_reference(case, meshes, tmp_path):
    D, argv = CASES[case]
    j, t = run_both(D, argv, meshes, tmp_path)
    compare_runs(argv, j, t)
    outputs_equal(j[2], t[2], exact_rhs="--neumann" not in argv)


def test_config_round_trip(meshes, tmp_path):
    """``--output-config`` writes the reference's ini word for word, and
    ``--config`` reproduces the run."""
    argv = BASE2 + ["--solver", "gmres", "--gmg-pre-sweeps", "2"]
    configs = {}
    for name, main in (("jax", lambda a: jcli.main(2, a)),
                       ("port", lambda a: tcli.main(2, a, device="cpu"))):
        cfg = tmp_path / f"{name}.ini"
        with contextlib.redirect_stdout(io.StringIO()):
            assert main([a.format(**meshes) for a in argv]
                        + ["--output-config", str(cfg)]) == 0
        configs[name] = cfg.read_text()
    assert configs["jax"] == configs["port"]
    reps = []
    for args in ([a.format(**meshes) for a in argv], ["--config", str(tmp_path / "port.ini")]):
        out = tmp_path / "rt.json"
        with contextlib.redirect_stdout(io.StringIO()):
            assert tcli.main(2, args + ["--out-json", str(out)], device="cpu") == 0
        reps.append(json.loads(out.read_text()))
    assert reps[0]["iterations"] == reps[1]["iterations"]
    assert reps[0]["error"] == reps[1]["error"]


BAD = [
    ["--matrix-type", "crs", "--solver", "ir"],
    ["--matrix-type", "crs", "--schur", "--shards", "2"],
    ["--matrix-type", "crs", "--monitor"],
    ["--prec", "cheb"],
    ["--prec", "BlockJacobi"],
    ["--schur", "--solver", "ir"],
    ["--schur", "--prec", "Schwarz"],
    ["--matrix-type", "pbm"],
    ["--neumann", "--neumann-sides", "x_lo"],
    ["--shards", "2"],
]


@pytest.mark.parametrize("argv", BAD, ids=[" ".join(a) for a in BAD])
def test_cli_rejects_bad_combos(argv, capsys):
    """Invalid combinations exit up front, as in the reference; the
    shard-only ones say why (``--shards 2`` outside a two-rank world, an
    assembled Schur matrix with ``--shards``)."""
    with pytest.raises(SystemExit) as exc:
        tcli.main(2, ["--uniform", "2", "-n", "8"] + argv, device="cpu")
    assert exc.value.code == 2
    if "--shards" in argv:
        err = capsys.readouterr().err
        assert ("single-device only" in err if "crs" in argv
                else "world has 1 rank" in err)


def test_quadratic_3d_rejected():
    with pytest.raises(SystemExit):
        tcli.main(3, ["--uniform", "2", "-n", "4", "--iface-interp", "quadratic"],
                  device="cpu")


@pytest.mark.parametrize("D", [2, 3])
def test_writers_byte_equal(D, tmp_path):
    """The port's writers, given tensors, write the reference writer's
    bytes for the same arrays."""
    jh, th = hierarchies(D=D)
    pl = th.finest
    rng = np.random.default_rng(D)
    fields = {k: rng.standard_normal((pl.num_patches,) + pl.ns_shape)
              for k in ("Solution", "Residual")}
    for pkg, writers, conv in (("jax", jwriters, np.asarray),
                               ("port", twriters, torch.from_numpy)):
        lvl = jh.finest if pkg == "jax" else pl
        f = {k: conv(v) for k, v in fields.items()}
        writers.write_vtk(lvl, f, str(tmp_path / pkg / "vtk"))
        if D == 2:
            writers.write_claw(lvl, f["Solution"], f["Residual"], str(tmp_path / pkg / "claw"))
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == pl.num_patches + 1 + (2 if D == 2 else 0)
    for rel in files:
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes()


def test_timer_report_format():
    """The section timer prints the reference's table; sections accumulate
    over repeats; on the CPU it synchronises nothing."""
    jt, tt = jtimer.Timer(), ttimer.Timer("cpu")
    for t in (jt, tt):
        for name in ("A", "B", "B"):
            with t.section(name):
                pass
    assert not tt._sync
    tt._sections = jt._sections
    assert tt.report() == jt.report() and "B (2 repeats)" in tt.report()
    assert tt["A"] >= 0 and tt["missing"] == 0.0


def test_apps_run_as_modules(meshes):
    """``python -m pressurepoissonsolver_torch.apps.steady2d|3d`` parse the
    reference CLI's flags (``--help`` lists them and exits 0)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for D in (2, 3):
        proc = subprocess.run(
            [sys.executable, "-m", f"pressurepoissonsolver_torch.apps.steady{D}d", "--help"],
            cwd=repo, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=repo))
        assert proc.returncode == 0, proc.stderr
        for flag in ("--matrix-type", "--gmg-cycle-type", "--iface-interp", "--monitor"):
            assert flag in proc.stdout
