"""The port's obs dryrun (``protocol_tpu_torch/tools/obs_dryrun.py``) on
the CPU: one run exits 0 with its artifacts, one with a seeded violation
exits 1, the scrape carries every metric family the reference's dryrun
(``tools/obs_dryrun.py``) reads, with the reference registry's types, and
``SLO.json`` lists the reference's default objectives.  Each run is a
subprocess: the node's metrics, tracer and SLO engine are process-wide."""

import concurrent.futures
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from protocol_tpu.obs import metrics as ref_metrics
from protocol_tpu.obs.slo import default_objectives as ref_default_objectives
from protocol_tpu_torch.tools import obs_dryrun
from protocol_tpu_torch.tools.crash_matrix import child_env

REPO = pathlib.Path(__file__).resolve().parent.parent
ARTIFACTS = ("METRICS_scrape.txt", "TRACE_epoch0.json", "TIMELINE_latest.json", "SLO.json")


def dryrun(out_dir, *extra):
    return subprocess.run(
        [sys.executable, "-m", "protocol_tpu_torch.tools.obs_dryrun", "--device", "cpu",
         "--out-dir", str(out_dir), *extra],
        cwd=out_dir.parent, env=child_env(), capture_output=True, text=True, timeout=150,
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The plain run and the seeded-violation run, side by side."""
    tmp = tmp_path_factory.mktemp("obs_dryrun")
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        plain = pool.submit(dryrun, tmp / "plain")
        seeded = pool.submit(dryrun, tmp / "seeded", "--seed-slo-violation")
        return {"plain": (plain.result(), tmp / "plain"), "seeded": (seeded.result(), tmp / "seeded")}


def test_the_dryrun_exits_0_with_its_artifacts(runs):
    proc, out = runs["plain"]
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "all SLO objectives green" in proc.stdout
    for name in ARTIFACTS:
        assert (out / name).stat().st_size > 0, name
    run = json.loads((out / "DRYRUN.json").read_text())
    assert run["device"] == "cpu" and run["backend"] == "cuda-sparse"
    assert run["failed_checks"] == [] and run["violating"] == [] and run["slo_ok"]
    assert run["epoch_interval"] == 2 and run["iterations"] >= 1
    # The plain versions ran: no kernel launched.
    assert not any(run["launches"].values())
    tree = json.loads((out / "TRACE_epoch0.json").read_text())
    assert tree["name"] == "epoch_tick"


def test_a_seeded_violation_exits_1(runs):
    proc, out = runs["seeded"]
    assert proc.returncode == 1, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "SLO VIOLATION" in proc.stderr
    slo = json.loads((out / "SLO.json").read_text())
    assert not slo["ok"]
    assert sorted(k for k, o in slo["objectives"].items() if not o["ok"]) == ["seeded-violation"]
    assert json.loads((out / "DRYRUN.json").read_text())["failed_checks"] == []


def test_the_scrape_types_every_family_the_reference_dryrun_reads(runs):
    """Every ``eigentrust_*`` sample the reference's dryrun reads names a
    family of the reference's registry; the port's scrape types each one
    as the reference registry does."""
    _, out = runs["plain"]
    scrape = (out / "METRICS_scrape.txt").read_text()
    source = (REPO / "tools" / "obs_dryrun.py").read_text()
    registry = {m.name: m.kind for m in ref_metrics.METRICS._metrics.values()}
    read = set()
    for name in set(re.findall(r"eigentrust_[a-z_]+", source)):
        family = name if name in registry else re.sub(r"_(count|sum|bucket)$", "", name)
        assert family in registry, name
        read.add(family)
    assert len(read) == 9
    for family in sorted(read):
        assert f"# TYPE {family} {registry[family]}\n" in scrape, family


def test_slo_lists_the_reference_default_objectives(runs):
    _, out = runs["plain"]
    slo = json.loads((out / "SLO.json").read_text())
    names = {o.name for o in ref_default_objectives()}
    assert names <= set(slo["objectives"])
    assert set(obs_dryrun.REQUIRED_OBJECTIVES) <= names
    assert all(slo["objectives"][n]["ok"] for n in names)


def test_the_dryrun_raises_without_a_card(monkeypatch):
    """``--device`` unset means the card: no card, no node."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs_dryrun.main([])
