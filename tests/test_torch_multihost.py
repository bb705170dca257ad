"""``pressurepoissonsolver_torch.scripts.multihost`` on the CPU: the public
sharded solve as a job of 2 hosts x 4 gloo ranks, started with torchrun's
environment, with both engines (``comm="pjit"`` and ``"halo"``), held to
the single-process solve at max-abs 1e-9 and to the counts of the JAX
script's report (``MULTIHOST_r5.json``, the same problem and options); the
report has the JAX script's keys and goes to ``--out`` only."""

import json
import os

import pytest
import torch

from pressurepoissonsolver_torch.scripts import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multihost_job_matches_one_process(tmp_path, capsys):
    ref_path = os.path.join(ROOT, "MULTIHOST_r5.json")
    with open(ref_path) as fh:
        before = fh.read()
    ref = json.loads(before)
    out = tmp_path / "report" / "multihost.json"
    assert multihost.main(["--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert set(report) == set(ref)
    assert (report["processes"], report["devices_per_process"], report["dof"]) == (
        2, 4, ref["dof"])
    for comm in ("pjit", "halo"):
        got = report[comm]
        assert set(got) == set(ref[comm])
        assert got["match"] and got["max_abs_diff_vs_1proc"] < 1e-9, got
        assert got["iterations"] == ref[comm]["iterations"]
        assert got["residual"] <= 1e-11
    assert report["ok"] and report["backend"].startswith("gloo")
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == report
    with open(ref_path) as fh:
        assert fh.read() == before
    assert os.listdir(tmp_path) == ["report"] and os.listdir(out.parent) == [out.name]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal without a card")
def test_multihost_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.main([])
