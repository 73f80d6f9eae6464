"""The port stands alone: it never imports ``jax`` or the ``protocol_tpu``
package, and its entry points never drop to the CPU unasked.

The import check runs in a subprocess because this test process has
imported jax already (tests/conftest.py).  ``protocol_tpu_torch`` starts
with ``protocol_tpu``, so the checks match the reference package's name
exactly, not by prefix.
"""

import ast
import json
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
    assert [m for m in loaded if forbidden(m)] == []


def test_port_modules_walk_the_node_and_its_host_modules():
    """The import check above covers every subpackage the node brought,
    not only the kernels' modules."""
    mods = set(port_modules())
    for sub in ("analysis", "chaos", "crypto", "node", "obs", "parallel", "prover", "utils", "zk"):
        assert f"protocol_tpu_torch.{sub}" in mods, sub
    for mod in ("node.manager", "node.pipeline", "node.checkpoint", "node.wal",
                "crypto.native", "obs.watchers", "trust.native", "zk.proof", "prover.jobs",
                "parallel.mesh", "parallel.launch", "parallel.sharded", "parallel.dryrun"):
        assert f"protocol_tpu_torch.{mod}" in mods, mod


def test_a_spawned_rank_loads_neither_jax_nor_the_reference():
    """A rank started by ``run_ranks`` imports its program from the port
    (this process has jax loaded; the spawned rank starts fresh)."""
    from protocol_tpu_torch.parallel.dryrun import loaded_modules
    from protocol_tpu_torch.parallel.launch import run_ranks

    assert "jax" in sys.modules
    assert run_ranks(2, loaded_modules, backend="gloo", device="cpu", timeout_s=60) == [[], []]


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
