"""The port stands alone: it never imports ``jax`` or the ``protocol_tpu``
package, and its entry points never drop to the CPU unasked.

The import check runs in a subprocess because this test process has
imported jax already (tests/conftest.py).  ``protocol_tpu_torch`` starts
with ``protocol_tpu``, so the checks match the reference package's name
exactly, not by prefix.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import protocol_tpu_torch
from protocol_tpu_torch.models.eigentrust import EigenTrustModel
from protocol_tpu_torch.models.graphs import erdos_renyi
from protocol_tpu_torch.ops import _build
from protocol_tpu_torch.trust.backend import get_backend, registered_backends

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "protocol_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "protocol_tpu")


def forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_forbidden_matches_exact_names():
    assert forbidden("protocol_tpu") and forbidden("protocol_tpu.ops") and forbidden("jax.numpy")
    assert not forbidden("protocol_tpu_torch") and not forbidden("protocol_tpu_torch.ops")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "protocol_tpu_torch.ops.gather_window" in loaded
    assert "protocol_tpu_torch.node.manager" in loaded
    assert "protocol_tpu_torch.zk.plonk" in loaded
    assert [m for m in loaded if forbidden(m)] == []


def test_port_modules_walk_the_node_and_its_host_modules():
    """The import check above covers every subpackage the node brought,
    not only the kernels' modules."""
    mods = set(port_modules())
    for sub in ("analysis", "chaos", "crypto", "ingest", "node", "obs", "parallel", "prover",
                "utils", "zk"):
        assert f"protocol_tpu_torch.{sub}" in mods, sub
    for mod in ("node.manager", "node.pipeline", "node.checkpoint", "node.wal",
                "crypto.native", "obs.watchers", "trust.native", "zk.proof", "prover.jobs",
                "parallel.mesh", "parallel.launch", "parallel.sharded", "parallel.dryrun",
                "crypto.keccak", "zk.rns", "zk.bn254", "zk.fields", "zk.cs", "zk.gadgets",
                "zk.chips", "zk.eddsa", "zk.circuit", "zk.transcript", "zk.native", "zk.graft",
                "zk.graft.field", "zk.graft.ntt", "zk.graft.pippenger", "ops.segments",
                "zk.kzg", "zk.plonk", "obs.export", "obs.fleet", "ingest.dedup",
                "ingest.ratelimit", "ingest.workers", "ingest.plane", "prover.workers",
                "prover.plane", "node.config", "node.ethereum", "node.server", "obs.slo",
                "obs.podtrace", "crypto.merkle"):
        assert f"protocol_tpu_torch.{mod}" in mods, mod


def test_a_spawned_rank_loads_neither_jax_nor_the_reference():
    """A rank started by ``run_ranks`` imports its program from the port
    (this process has jax loaded; the spawned rank starts fresh)."""
    from protocol_tpu_torch.parallel.dryrun import loaded_modules
    from protocol_tpu_torch.parallel.launch import run_ranks

    assert "jax" in sys.modules
    assert run_ranks(2, loaded_modules, backend="gloo", device="cpu", timeout_s=60) == [[], []]


def test_spawned_plane_workers_load_neither_jax_nor_the_reference():
    """A verify worker and a prover worker, spawned from this process
    (which has jax loaded), each after a real batch or prove, hold
    neither ``jax``, ``jaxlib`` nor ``protocol_tpu`` in ``sys.modules``:
    their bootstrap and their work import only the port."""
    from protocol_tpu_torch.crypto import group_pks_hash
    from protocol_tpu_torch.ingest.workers import VerifyPool
    from protocol_tpu_torch.node.bootstrap import FIXED_SET, keyset_from_raw
    from protocol_tpu_torch.node.epoch import Epoch
    from protocol_tpu_torch.node.manager import Manager, ManagerConfig
    from protocol_tpu_torch.parallel.dryrun import loaded_modules
    from protocol_tpu_torch.prover.workers import ProverPool

    import protocol_tpu.crypto  # noqa: F401 - the parent holds the reference too

    assert "jax" in sys.modules and "protocol_tpu" in sys.modules
    _, pks = keyset_from_raw(FIXED_SET)
    manager = Manager(ManagerConfig(prover="commitment", check_circuit=False))
    manager.generate_initial_attestations()
    att = next(iter(manager.attestations.values()))
    item = (att.sig.big_r.x, att.sig.big_r.y, att.sig.s, att.pk.point.x, att.pk.point.y,
            tuple(att.scores))
    verify, prove = VerifyPool(workers=1), ProverPool(workers=1)
    try:
        assert verify.verify(group_pks_hash(pks), [item]) == [True]
        result = prove.prove(manager.build_proof_job(Epoch(1)))
        assert result.metrics["pid"] != os.getpid()
        for pool in (verify, prove):
            _, executor = pool._snapshot()
            loaded = executor.submit(loaded_modules, None).result(timeout=120)
            assert loaded == [], loaded
    finally:
        verify.close()
        prove.close()


def test_the_server_entry_point_serves_and_stops_without_jax(tmp_path):
    """``python -m protocol_tpu_torch.node.server --config <file>`` on the
    CPU (``device: "cpu"``, the commitment prover, a free port, an epoch
    clock that does not tick): ``/healthz`` answers, ``SIGTERM`` ends the
    process within 30 s and leaves its flight dump, and the import log
    (``-X importtime``, every module the process imported, at boot and
    after) names no ``jax``, ``jaxlib`` or ``protocol_tpu`` module."""
    import signal
    import socket
    import time

    def get(path):
        with socket.create_connection(("127.0.0.1", port), timeout=5) as conn:
            conn.sendall(f"GET {path} HTTP/1.1\r\nhost: t\r\n\r\n".encode())
            raw = b"".join(iter(lambda: conn.recv(65536), b""))
        head, _, body = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), json.loads(body)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    config = tmp_path / "node.json"
    config.write_text(json.dumps({
        "epoch_interval": 3600, "endpoint": [[127, 0, 0, 1], port], "prover": "commitment",
        "trust_backend": "cuda-windowed", "device": "cpu", "wal_fsync": False,
        "checkpoint_dir": str(tmp_path / "ckpt"), "journal_path": str(tmp_path / "journal.jsonl"),
    }))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    log = tmp_path / "stderr.log"
    with open(log, "w") as stderr:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "protocol_tpu_torch.node.server",
             "--config", str(config)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=stderr,
        )
    try:
        health = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                health = get("/healthz")
            except OSError:
                health = None
            if health is not None and health[1]["components"]["recovery"]["state"] == "ok":
                break
            time.sleep(0.2)
        assert health is not None, (proc.poll(), log.read_text()[-2000:])
        assert health[0] == 200 and health[1]["components"]["recovery"]["state"] == "ok"
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        assert time.monotonic() - t0 < 30
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = log.read_text()
    assert (tmp_path / "journal.jsonl.dump").exists()
    assert "flight recorder dumped" in err and "SIGTERM" in err
    imported = [ln.rsplit("|", 1)[1].strip() for ln in err.splitlines()
                if ln.startswith("import time:") and "|" in ln]
    # ``-m`` runs the server module as ``__main__``; what it imports is logged.
    for mod in ("protocol_tpu_torch.node.manager", "protocol_tpu_torch.node.config",
                "protocol_tpu_torch.ingest.plane", "protocol_tpu_torch.obs.slo"):
        assert mod in imported, mod
    assert [m for m in imported if forbidden(m)] == []


def server_raises_without_a_card(tmp_path, doc):
    """``python -m protocol_tpu_torch.node.server`` on ``doc``, where no
    card is visible: it must exit non-zero naming the missing card."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the node would boot on it")
    config = tmp_path / "node.json"
    config.write_text(json.dumps({"prover": "commitment", "endpoint": [[127, 0, 0, 1], 0], **doc}))
    out = subprocess.run(
        [sys.executable, "-m", "protocol_tpu_torch.node.server", "--config", str(config)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_the_server_entry_point_raises_without_a_card(tmp_path):
    """With ``device`` unset and a card backend, the entry point raises
    where no card is visible: nothing falls back to the CPU."""
    server_raises_without_a_card(tmp_path, {"trust_backend": "cuda-windowed"})


def test_the_server_entry_point_defaults_to_the_card(tmp_path):
    """A config that names neither a backend nor a device boots on the
    card (the port's default rung), so it too raises without one."""
    server_raises_without_a_card(tmp_path, {})


def test_importing_the_node_builds_no_library():
    """The crypto runtime, like the kernels, is built at first use only."""
    from protocol_tpu_torch.crypto import native as cnative

    code = (
        "import protocol_tpu_torch.node.manager, protocol_tpu_torch.crypto.native as c\n"
        "print(c._lib is None)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == "True"
    assert cnative.library_path().parent == REPO / "build" / "protocol_tpu_torch"


def test_importing_the_prover_builds_no_library():
    """The zk runtime is built at first use too, never on import."""
    from protocol_tpu_torch.zk import native as znative

    code = (
        "import protocol_tpu_torch.zk, protocol_tpu_torch.zk.plonk, protocol_tpu_torch.zk.kzg\n"
        "import protocol_tpu_torch.zk.native as z\n"
        "print(z._lib is None)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == "True"
    assert znative.library_path().parent == REPO / "build" / "protocol_tpu_torch"


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if forbidden(n)] == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        protocol_tpu_torch.resolve_device()
    assert protocol_tpu_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", [n for n in registered_backends() if n != "native-cpu"])
def test_backend_without_device_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend(name)
    assert get_backend(name, device="cpu").device == torch.device("cpu")


def test_native_cpu_backend_is_the_host_by_name(no_cuda):
    """``native-cpu`` is exact rational arithmetic on the host, as in the
    reference: it asks for no card and takes no device."""
    assert get_backend("native-cpu").device == torch.device("cpu")
    with pytest.raises(TypeError):
        get_backend("native-cpu", device="cuda")


def test_headline_converge_timing_raises_without_cuda(no_cuda):
    from protocol_tpu_torch.bench import headline_converge

    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline_converge.run()


def test_model_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EigenTrustModel(erdos_renyi(50, seed=0)).converge()


def test_unknown_backend_name():
    with pytest.raises(ValueError, match="unknown trust backend"):
        get_backend("tpu-windowed", device="cpu")


def test_kernel_build_is_lazy_and_keyed_by_source():
    """Importing the port builds nothing; the library name changes with
    the source bytes, so an edited kernel is never served stale."""
    assert _build._LIBS == {}
    path = _build.library_path("gather_window")
    assert path.parent == REPO / "build" / "protocol_tpu_torch"
    assert path.name.startswith("gather_window-") and path.suffix == ".so"
    kernels = {p.stem for p in (PORT / "ops" / "csrc").glob("*.cu")}
    bench = {p.stem for p in (PORT / "bench" / "csrc").glob("*.cu")}
    assert set(_build.BENCH_KERNELS) == bench and not kernels & bench
    assert set(_build.SIGNATURES) == kernels | bench
    assert _build.source("rowsum_tail").parent == PORT / "ops" / "csrc"
    assert _build.source("rowsum_tail_scalar").parent == PORT / "bench" / "csrc"


def test_lazy_submodules():
    assert protocol_tpu_torch.ops.gather_window.WINDOW == 1024
    with pytest.raises(AttributeError):
        protocol_tpu_torch.nonexistent  # noqa: B018
