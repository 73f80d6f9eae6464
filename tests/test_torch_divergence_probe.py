"""The port's divergence probe (``protocol_tpu_torch/tools/divergence_probe.py``)
against the reference's tool (``tools/divergence_probe.py``) on the CPU:
the same schedules, the same leg verdicts on the same records, the same
proof bytes from the same scores and the same fleet aggregate from the
same decoys; the launcher's schedule keywords, which leave today's
callers as they were; one small pod replay under the baseline, the
perturbed and a seeded schedule (every leg holding across the first two,
exactly the six digest legs tripping against the third), with the
baseline held against a plain replay (``--against-plain``) and that
check tripping on a changed iteration count or score; and no card, no
run.  The full ``--smoke`` pair is ``-m slow``."""

import json
import os
import pathlib
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import divergence_probe as ref_probe  # noqa: E402

from protocol_tpu_torch.parallel import launch  # noqa: E402
from protocol_tpu_torch.parallel.launch import rank_schedule, run_ranks  # noqa: E402
from protocol_tpu_torch.tools import divergence_probe as probe  # noqa: E402

#: A small pod replay: 512 peers, 4,096 edges, 2 epochs.
SMALL = ["--device", "cpu", "--peers", "512", "--edges", "4096", "--epochs", "2",
         "--timeout", "120"]

ALL_LEGS = {
    "return_codes", "workers_ok", "wal_ack_digests", "manifest_digests", "epoch_digests",
    "cross_host_bit_identity", "final_scores_sha256", "scores_npy_bytes", "proof_bytes",
    "fleet_merge_order_insensitive",
}


def _run_record(**over) -> dict:
    """A run record as ``run_schedule`` returns one (the fields the
    comparison reads), every leg holding against a copy of itself."""
    base = {
        "return_codes": [0, 0],
        "workers_ok": [True, True],
        "wal_ack_digests": {"acks-h000.jsonl": "a1", "acks-h001.jsonl": "a2"},
        "manifest_digests": {"host-000/checkpoints/manifest.json": "m1"},
        "epoch_digests": [{"epoch": 0, "residual": 0.5, "scores_sha256": "s0"}],
        "cross_host_bit_identity": True,
        "final_scores_sha256": ["fs", "fs"],
        "scores_npy_sha256": "npy",
        "proof": {"prover": "poseidon-commitment", "proof_bytes": 32, "proof_sha256": "pf",
                  "verified": True},
        "fleet": {"scrapes": 9, "sources": ["decoy-0"], "aggregate_sha256": "fl"},
    }
    base.update(over)
    return base


#: For each leg, the second record of a pair that trips it alone.
TRIPS = {
    "return_codes": _run_record(return_codes=[0, 1]),
    "workers_ok": _run_record(workers_ok=[True, False]),
    "wal_ack_digests": _run_record(wal_ack_digests={"acks-h000.jsonl": "XX",
                                                    "acks-h001.jsonl": "a2"}),
    "manifest_digests": _run_record(manifest_digests={"host-000/checkpoints/manifest.json": "XX"}),
    "epoch_digests": _run_record(epoch_digests=[{"epoch": 0, "residual": 0.25,
                                                 "scores_sha256": "s0"}]),
    "cross_host_bit_identity": _run_record(cross_host_bit_identity=False),
    "final_scores_sha256": _run_record(final_scores_sha256=["fx", "fx"]),
    "scores_npy_bytes": _run_record(scores_npy_sha256="other"),
    "proof_bytes": _run_record(proof={"prover": "poseidon-commitment", "proof_bytes": 32,
                                      "proof_sha256": "OTHER", "verified": True}),
    "fleet_merge_order_insensitive": _run_record(fleet={"scrapes": 3, "sources": ["decoy-0"],
                                                        "aggregate_sha256": "fx"}),
}


def test_schedules_are_the_references():
    assert probe.SCHEDULES == ref_probe.SCHEDULES
    assert probe._DECOYS == ref_probe._DECOYS


def test_identical_records_pass_every_leg():
    port = probe.compare_runs(_run_record(), _run_record())
    assert port == ref_probe.compare_runs(_run_record(), _run_record())
    assert port["ok"] is True and set(port["legs"]) == ALL_LEGS


@pytest.mark.parametrize("leg", sorted(TRIPS))
def test_each_leg_trips_alone_as_in_the_reference(leg):
    port = probe.compare_runs(_run_record(), TRIPS[leg])
    assert port == ref_probe.compare_runs(_run_record(), TRIPS[leg])
    assert port["ok"] is False
    assert [k for k, v in port["legs"].items() if not v] == [leg]


@pytest.mark.parametrize("record", [
    _run_record(wal_ack_digests={}),
    _run_record(manifest_digests={"host-000/checkpoints/manifest.json": "unreadable"}),
    _run_record(epoch_digests=[]),
    _run_record(final_scores_sha256=[None, None]),
    _run_record(final_scores_sha256=["fs", "fy"]),
    _run_record(scores_npy_sha256=None),
    _run_record(proof=None),
    _run_record(proof={"prover": "p", "proof_bytes": 1, "proof_sha256": "pf", "verified": False}),
    _run_record(fleet={"scrapes": 0, "sources": [], "aggregate_sha256": "fl"}),
], ids=["no-acks", "unreadable-manifest", "no-epochs", "no-scores", "hosts-differ", "no-npy",
        "no-proof", "unverified-proof", "no-fleet-source"])
def test_empty_or_bad_sinks_never_pass_vacuously(record):
    """A leg compares something or fails: the reference's verdicts on
    the same self-comparison."""
    port = probe.compare_runs(record, record)
    assert port == ref_probe.compare_runs(record, record)
    assert port["ok"] is False


@pytest.mark.parametrize("seed", [0, 1])
def test_proof_bytes_equal_the_references(tmp_path, seed):
    path = tmp_path / "scores.npy"
    scores = np.random.default_rng(seed).random(300).astype(np.float32)
    np.save(path, scores / scores.sum())
    port = probe._proof_digest(path)
    assert port == ref_probe._proof_digest(path)
    assert port["verified"] and port["prover"] == "poseidon-commitment"


def test_fleet_aggregate_equals_the_references(tmp_path):
    """Both scrapers over decoys written in the two schedules' orders
    reach the reference's aggregate."""
    digests = set()
    for i, sched in enumerate(probe.SCHEDULES):
        for name, mod in (("port", probe), ("ref", ref_probe)):
            fleet = tmp_path / f"{name}-{i}"
            mod._write_decoys(fleet, sched["decoy_order"])
            scraper = mod._Scraper(fleet, sched["scrape_interval"])
            scraper.start()
            time.sleep(0.1)
            got = scraper.finish()
            assert got["sources"] == ["decoy-0", "decoy-1", "decoy-2"] and got["scrapes"] >= 1
            digests.add(got["aggregate_sha256"])
    assert len(digests) == 1


def test_launch_schedule_names_each_perturbation():
    base, pert = (probe.launch_schedule(s, 2) for s in probe.SCHEDULES)
    assert base == {"start_order": [0, 1], "stagger_s": 0.0, "threads": 2,
                    "env": {"PYTHONHASHSEED": "1"}}
    assert pert == {"start_order": [1, 0], "stagger_s": 0.25, "threads": 1,
                    "env": {"PYTHONHASHSEED": "31337"}}
    seen = {"hashseed": "31337", "omp_num_threads": "1", "threads": 1}
    assert probe.schedule_seen({"host_id": 1, "schedule": {**seen, "start_position": 0}}, pert)
    assert not probe.schedule_seen({"host_id": 0, "schedule": {**seen, "start_position": 0}},
                                   pert)
    assert not probe.schedule_seen({"host_id": 1, "schedule": {**seen, "start_position": 0,
                                                               "threads": 2}}, pert)
    assert not probe.schedule_seen({"ok": False, "error": "no worker report"}, pert)


def test_run_ranks_defaults_leave_callers_as_they_were():
    """No schedule keyword: rank order, one thread, the parent's
    environment, and the parent's ``os.environ`` untouched."""
    env = dict(os.environ)
    got = run_ranks(2, rank_schedule, backend="gloo", device="cpu", timeout_s=60)
    assert dict(os.environ) == env
    for rank, seen in enumerate(got):
        assert seen["rank"] == rank and seen["start_position"] == rank
        assert seen["threads"] == 1
        assert seen["hashseed"] == os.environ.get("PYTHONHASHSEED")
        assert seen["omp_num_threads"] == os.environ.get("OMP_NUM_THREADS")
    assert rank_schedule() == {}  # only a launched rank has one


def test_run_ranks_applies_a_schedule():
    env = dict(os.environ)
    kw = dict(start_order=[1, 0], stagger_s=0.1, threads=2, env={"PYTHONHASHSEED": "77"})
    got = run_ranks(2, rank_schedule, backend="gloo", device="cpu", timeout_s=60, **kw)
    again = run_ranks(2, rank_schedule, backend="gloo", device="cpu", timeout_s=60,
                      **{**kw, "env": {"PYTHONHASHSEED": "78"}})
    assert dict(os.environ) == env
    assert [s["start_position"] for s in got] == [1, 0]
    assert all(s["threads"] == 2 and s["hashseed"] == "77" and s["omp_num_threads"] == "2"
               for s in got)
    assert [s["hashseed"] for s in again] == ["78", "78"]
    with pytest.raises(ValueError, match="start_order"):
        run_ranks(2, rank_schedule, backend="gloo", device="cpu", timeout_s=60,
                  start_order=[0, 0])


def test_every_launch_starts_its_ranks_under_the_environment_lock():
    """A launch without a schedule waits too while another launch's
    environment is set, so it cannot start its ranks under it."""
    entered = threading.Event()

    def start():
        with launch._environment({}):
            entered.set()

    with launch._ENV_LOCK:
        waiter = threading.Thread(target=start)
        waiter.start()
        assert not entered.wait(0.2)
    assert entered.wait(10)
    waiter.join()


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """The probe's ``main`` at the small scale (baseline, the perturbed
    schedule, then the plain replay of ``--against-plain``), then the
    perturbed schedule once more with the protocol seed moved: four pod
    launches in all.  Also the work directory of ``main``."""
    tmp = tmp_path_factory.mktemp("divergence_probe")
    out = tmp / "DET.json"
    rc = probe.main([*SMALL, "--against-plain", "--out", str(out), "--workdir", str(tmp / "main")])
    report = json.loads(out.read_text())
    args = probe.parse_args(SMALL)
    args.device = "cpu"
    seeded = probe.run_schedule(args, probe.SCHEDULES[1], tmp / "seeded", seed=args.seed + 1)
    return rc, report, seeded, tmp / "main"


def test_perturbed_replays_agree_in_every_sink(replays):
    rc, report, _, _ = replays
    assert rc == 0 and report["ok"], report["comparison"]
    assert set(report["comparison"]["legs"]) == ALL_LEGS
    assert all(report["comparison"]["legs"].values())
    base, pert = report["runs"]
    assert ref_probe.compare_runs(base, pert) == report["comparison"]
    assert report["mesh"] == "2x1" and report["device"] == "cpu" and report["nvidia_smi"] is None
    assert report["skipped"] is False and report["seed_divergence_mode"] is False
    assert all(k == 0 for k in report["launches"].values())
    # The durability sinks by name: 2 checkpoint manifests, 2 pod
    # manifests, 4 shard stamps; no fleet snapshot or trace.
    assert sorted(base["manifest_digests"]) == [
        "host-000/checkpoints/manifest.json", "host-001/checkpoints/manifest.json",
        "manifests/pod_manifest_e00000000.json", "manifests/pod_manifest_e00000001.json",
        "manifests/shard-e00000000-h000.json", "manifests/shard-e00000000-h001.json",
        "manifests/shard-e00000001-h000.json", "manifests/shard-e00000001-h001.json",
    ]
    assert sorted(base["wal_ack_digests"]) == ["acks-h000.jsonl", "acks-h001.jsonl"]
    assert base["plan_outcomes"] == ["rebuild", "delta"] and base["budget_findings"] == []


def test_each_host_saw_its_schedule(replays):
    _, report, seeded, _ = replays
    base, pert = report["runs"]
    for run in (base, pert, seeded):
        launch = probe.launch_schedule(run["schedule"], 2)
        for host, seen in enumerate(run["schedule_seen"]):
            assert seen["rank"] == host
            assert seen["start_position"] == launch["start_order"].index(host)
            assert seen["hashseed"] == run["schedule"]["hashseed"]
            assert seen["threads"] == int(run["schedule"]["omp_threads"])
            assert seen["omp_num_threads"] == run["schedule"]["omp_threads"]
    assert [s["start_position"] for s in pert["schedule_seen"]] == [1, 0]


def test_the_baseline_equals_a_plain_replay(replays):
    """On the CPU the plain replay gives the baseline's bits: the same
    iterations and plan outcomes, residuals, checkpointed and final
    scores at a distance of 0."""
    _, report, _, _ = replays
    plain, base = report["against_plain"], report["runs"][0]
    assert plain["ok"] and plain["workers_ok"] == [True, True]
    assert plain["iterations"] == base["iterations"] and len(plain["iterations"]) == 2
    assert plain["plan_outcomes"] == base["plan_outcomes"]
    assert plain["residuals"] == [e["residual"] for e in base["epoch_digests"]]
    assert plain["residual_diff"] == [0.0, 0.0] and plain["final_l1"] == 0.0
    assert plain["epoch_l1"] == {"0": 0.0, "1": 0.0}


@pytest.mark.parametrize("change", ["iterations", "scores"])
def test_the_plain_check_trips_on_a_changed_replay(replays, tmp_path, change):
    """Held against a baseline record with one more iteration in an
    epoch, or with its final scores moved by 2e-6 in L1, the plain
    replay fails the check."""
    _, report, _, main_dir = replays
    card = json.loads(json.dumps(report["runs"][0]))
    shutil.copytree(main_dir / "state-baseline", tmp_path / "state-baseline")
    scores = np.load(main_dir / "scores-baseline.npy")
    if change == "iterations":
        card["iterations"][1] += 1
    else:
        scores[0] += 2 * probe.PLAIN_L1
    np.save(tmp_path / "scores-baseline.npy", scores)
    args = probe.parse_args(SMALL)
    args.device = "cpu"
    got = probe.against_plain(args, card, tmp_path)
    assert got["ok"] is False and got["workers_ok"] == [True, True]
    if change == "iterations":
        assert got["iterations"] != card["iterations"] and got["final_l1"] == 0.0
    else:
        assert got["iterations"] == card["iterations"] and got["final_l1"] > probe.PLAIN_L1


def test_a_moved_seed_trips_exactly_the_digest_legs(replays):
    _, report, seeded, _ = replays
    base = report["runs"][0]
    verdict = probe.compare_runs(base, seeded)
    assert verdict == ref_probe.compare_runs(base, seeded)
    assert verdict["ok"] is False
    assert sorted(k for k, v in verdict["legs"].items() if not v) == sorted(probe.DIGEST_LEGS)
    assert seeded["seed"] == base["seed"] + 1


def test_a_failed_launch_fails_the_run(tmp_path):
    """No ``skipped`` outcome: hosts killed at the launch's time limit
    leave no return code, no report and no sink, and the run fails."""
    args = probe.parse_args([*SMALL, "--timeout", "0.5"])  # the last --timeout wins
    args.device = "cpu"
    run = probe.run_schedule(args, probe.SCHEDULES[0], tmp_path, seed=args.seed)
    assert run["return_codes"] == [None, None] and "still ran after" in run["error"]
    assert run["workers_ok"] == [False, False] and run["proof"] is None
    verdict = probe.compare_runs(run, run)
    assert verdict["ok"] is False
    assert not verdict["legs"]["return_codes"] and not verdict["legs"]["workers_ok"]


def test_the_probe_raises_without_a_card(monkeypatch, tmp_path):
    """``--device`` unset means the card: no card, no run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--smoke", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


@pytest.mark.slow
def test_the_smoke_pair_on_the_cpu(tmp_path):
    """The CI pair at its scale (2,048 / 16,384 / 3): exit 0 with every
    leg, then exit 1 with exactly the digest legs tripped."""
    out = tmp_path / "plain.json"
    assert probe.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    assert all(json.loads(out.read_text())["comparison"]["legs"].values())
    out = tmp_path / "seeded.json"
    assert probe.main(["--smoke", "--device", "cpu", "--seed-divergence", "--out", str(out)]) == 1
    legs = json.loads(out.read_text())["comparison"]["legs"]
    assert sorted(k for k, v in legs.items() if not v) == sorted(probe.DIGEST_LEGS)
