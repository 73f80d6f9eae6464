"""The port's probe kernels (K2-K4) against the reference probes.

The reference's probe scripts (``bench/probe_mosaic_gather.py``,
``bench/probe_fused_primitives.py``) run their benchmarks when imported,
so the Pallas kernels are rebuilt here exactly as the scripts build
them and run in interpret mode on the CPU:

- K2: the ``take_along_axis`` ``pallas_call`` of
  ``probe_mosaic_gather.py:75-79``, with ``interpret=True``;
- K3: the transpose ``pallas_call`` of ``probe_mosaic_gather.py:107-110``,
  with ``interpret=True``;
- K4: the probe's own ``gather_region``, loaded from the script by AST
  (its imports, ``BLOCK_ROWS``, ``_kernel`` and ``gather_region`` only)
  and run under ``pltpu.force_tpu_interpret_mode()``.

Every kernel is a pure copy, so every case is held **bit-equal**
(``np.array_equal``).  The CUDA kernels themselves run only on a card;
``chip_smoke.py`` holds them against their plain versions there.  Here
the wrappers' CPU route, their launch counters and argument checks, and
the probe modules' import-time silence are covered.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from protocol_tpu_torch.bench import probe_fused_primitives as pfp
from protocol_tpu_torch.bench import probe_mosaic_gather as pmg
from test_torch_no_jax import no_cuda  # noqa: F401  (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_MOSAIC = REPO / "bench" / "probe_mosaic_gather.py"
REF_FUSED = REPO / "bench" / "probe_fused_primitives.py"


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def gather_inputs(axis, rows, cols, seed=0):
    rng = np.random.default_rng(seed)
    hi = rows if axis == 0 else cols
    table = rng.random((rows, cols), dtype=np.float32)
    idx = rng.integers(0, hi, (rows, cols)).astype(np.int32)
    return table, idx


def pallas_take_along_axis(table, idx, axis):
    """The reference probe's kernel (probe_mosaic_gather.py:75-79), interpreted."""
    rows, cols = table.shape
    kernel = pl.pallas_call(
        lambda t_ref, i_ref, o_ref: o_ref.__setitem__(
            slice(None), jnp.take_along_axis(t_ref[:], i_ref[:], axis=axis)),
        out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(kernel)(table, idx))


def pallas_transpose(table):
    """The reference probe's kernel (probe_mosaic_gather.py:107-110), interpreted."""
    rows, cols = table.shape
    kernel = pl.pallas_call(
        lambda t_ref, o_ref: o_ref.__setitem__(slice(None), t_ref[:].T),
        out_shape=jax.ShapeDtypeStruct((cols, rows), jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(kernel)(table))


@pytest.fixture(scope="module")
def ref_gather_region():
    """The reference probe's own ``gather_region``, without running the
    script's 268 MB benchmarks: only its imports, ``BLOCK_ROWS``,
    ``_kernel`` and ``gather_region`` are executed."""
    tree = ast.parse(REF_FUSED.read_text())
    keep = [
        node for node in tree.body
        if isinstance(node, (ast.Import, ast.ImportFrom))
        or (isinstance(node, ast.FunctionDef) and node.name in ("_kernel", "gather_region"))
        or (isinstance(node, ast.Assign) and [getattr(x, "id", None) for x in node.targets] == ["BLOCK_ROWS"])
    ]
    assert [getattr(n, "name", None) for n in keep if isinstance(n, ast.FunctionDef)] == [
        "_kernel", "gather_region",
    ]
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(REF_FUSED), "exec"), ns)
    return ns["gather_region"]


@pytest.fixture(scope="module")
def region_case():
    """The probe's K4 inputs, drawn as the probe draws them
    (``default_rng(2)``), at 2 regions instead of 1,024."""
    n_regions = 2
    rng = np.random.default_rng(2)
    table = rng.random((n_regions * 512, 128), np.float32)
    wid = rng.integers(0, 64, n_regions * pfp.BLOCK_ROWS).astype(np.int32)
    local = rng.integers(0, 1024, (n_regions * 512, 128)).astype(np.int32)
    return n_regions, wid, table, local


class TestTakeAlongAxis:
    @pytest.mark.parametrize("axis, rows, cols", [(1, 64, 128), (1, 8, 1024), (0, 64, 128)])
    def test_plain_matches_pallas_interpret(self, axis, rows, cols):
        table, idx = gather_inputs(axis, rows, cols)
        port = pmg.take_along_axis_plain(t(table), t(idx), axis)
        np.testing.assert_array_equal(port.numpy(), pallas_take_along_axis(table, idx, axis))

    @pytest.mark.parametrize("axis, rows, cols", [(1, 8, 1024), (0, 64, 128), (0, 5, 12)])
    def test_wrapper_takes_plain_route_on_cpu_without_counting(self, axis, rows, cols):
        table, idx = gather_inputs(axis, rows, cols, seed=rows + cols)
        before = pmg.take_along_axis.launches
        out = pmg.take_along_axis(t(table), t(idx), axis)
        assert pmg.take_along_axis.launches == before == 0
        np.testing.assert_array_equal(out.numpy(), pmg.take_along_axis_plain(t(table), t(idx), axis).numpy())
        # The library call the chip run times beside it computes the same.
        np.testing.assert_array_equal(out.numpy(), torch.gather(t(table), axis, t(idx).long()).numpy())

    @pytest.mark.parametrize(
        "mutate, exc",
        [
            (lambda a: dict(a, axis=2), ValueError),
            (lambda a: dict(a, idx=a["idx"][:, :-1]), ValueError),
            (lambda a: dict(a, t=a["t"][0]), ValueError),
            (lambda a: dict(a, t=a["t"][:, :-2], idx=a["idx"][:, :-2]), ValueError),
            (lambda a: dict(a, t=a["t"].double()), TypeError),
            (lambda a: dict(a, idx=a["idx"].long()), TypeError),
            (lambda a: dict(a, idx=a["idx"].to("meta")), ValueError),
            (lambda a: dict(a, t=a["t"].to("meta"), idx=a["idx"].to("meta")), ValueError),
        ],
        ids=["axis", "idx-shape", "t-rank", "cols-not-4", "t-dtype", "idx-dtype", "mixed-device",
             "meta-device"],
    )
    def test_rejects_bad_operands(self, mutate, exc):
        a = mutate(dict(t=torch.zeros(8, 16), idx=torch.zeros(8, 16, dtype=torch.int32), axis=1))
        with pytest.raises(exc):
            pmg.take_along_axis(a["t"], a["idx"], a["axis"])


class TestTranspose2d:
    @pytest.mark.parametrize("rows, cols", [(128, 256), (256, 128)])
    def test_plain_matches_pallas_interpret(self, rows, cols):
        table = np.random.default_rng(rows).random((rows, cols), dtype=np.float32)
        port = pmg.transpose2d_plain(t(table))
        assert port.is_contiguous()
        np.testing.assert_array_equal(port.numpy(), pallas_transpose(table))

    @pytest.mark.parametrize("rows, cols", [(128, 256), (33, 65)])
    def test_wrapper_takes_plain_route_on_cpu_without_counting(self, rows, cols):
        table = t(np.random.default_rng(cols).random((rows, cols), dtype=np.float32))
        before = pmg.transpose2d.launches
        out = pmg.transpose2d(table)
        assert pmg.transpose2d.launches == before == 0
        np.testing.assert_array_equal(out.numpy(), table.numpy().T)

    @pytest.mark.parametrize(
        "arg, exc",
        [
            (torch.zeros(4, 4, 4), ValueError),
            (torch.zeros(4, 4, dtype=torch.float64), TypeError),
            (torch.zeros(4, 4, device="meta"), ValueError),
        ],
        ids=["rank", "dtype", "meta-device"],
    )
    def test_rejects_bad_operands(self, arg, exc):
        with pytest.raises(exc):
            pmg.transpose2d(arg)


class TestGatherRegion:
    def test_plain_matches_the_probes_own_kernel(self, ref_gather_region, region_case):
        n_regions, wid, table, local = region_case
        with pltpu.force_tpu_interpret_mode():
            ref = ref_gather_region(
                jnp.asarray(wid), jnp.asarray(table), jnp.asarray(local), n_regions=n_regions
            )
        port = pfp.gather_region_plain(t(wid), t(table), t(local))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

    def test_plain_matches_the_formula(self, region_case):
        _, wid, table, local = region_case
        rows = np.arange(local.shape[0])
        flat = (rows // 512)[:, None] * 65536 + np.repeat(wid, 8)[:, None] * 1024 + local
        port = pfp.gather_region_plain(t(wid), t(table), t(local))
        np.testing.assert_array_equal(port.numpy(), table.reshape(-1)[flat])

    def test_wrapper_takes_plain_route_on_cpu_without_counting(self, region_case):
        _, wid, table, local = region_case
        before = pfp.gather_region.launches
        out = pfp.gather_region(t(wid), t(table), t(local))
        assert pfp.gather_region.launches == before == 0
        np.testing.assert_array_equal(
            out.numpy(), pfp.gather_region_plain(t(wid), t(table), t(local)).numpy()
        )

    @pytest.mark.parametrize(
        "mutate, exc",
        [
            (lambda a: dict(a, table=a["table"][:-8]), ValueError),
            (lambda a: dict(a, table=a["table"][:, :64]), ValueError),
            (lambda a: dict(a, local=a["local"][:-8]), ValueError),
            (lambda a: dict(a, wid=a["wid"][:-1]), ValueError),
            (lambda a: dict(a, table=a["table"].double()), TypeError),
            (lambda a: dict(a, wid=a["wid"].long()), TypeError),
            (lambda a: dict(a, local=a["local"].to("meta")), ValueError),
        ],
        ids=["table-rows", "table-cols", "local-shape", "wid-shape", "table-dtype", "wid-dtype",
             "mixed-device"],
    )
    def test_rejects_bad_operands(self, mutate, exc):
        a = mutate(dict(
            wid=torch.zeros(64, dtype=torch.int32),
            table=torch.zeros(512, 128),
            local=torch.zeros(512, 128, dtype=torch.int32),
        ))
        with pytest.raises(exc):
            pfp.gather_region(a["wid"], a["table"], a["local"])

    def test_bound_counts_distinct_windows(self, region_case):
        n_regions, wid, _, _ = region_case
        nbytes, distinct = pfp.region_gather_bytes(t(wid))
        pairs = {(r // 64, int(w)) for r, w in enumerate(wid)}
        assert distinct == len(pairs)
        n_rows = n_regions * 64
        assert nbytes == 8 * n_rows * 1024 + 4 * n_rows + 4096 * len(pairs)


def reference_loop_literals(path):
    """The literal lists that the reference script's module-level
    ``for`` loops walk, in order."""
    tree = ast.parse(path.read_text())
    return [ast.literal_eval(n.iter) for n in tree.body if isinstance(n, ast.For)]


def reference_assignments(path):
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name):
            out[target.id] = value
        elif isinstance(target, ast.Tuple):
            out.update(zip((n.id for n in target.elts), value))
    return out


class TestProbeModules:
    def test_keep_the_reference_shapes(self):
        axis1, axis0, transposes, tables = reference_loop_literals(REF_MOSAIC)
        assert [tuple(s) for s in axis1] == list(pmg.AXIS1_SHAPES)
        assert [tuple(s) for s in axis0] == list(pmg.AXIS0_SHAPES)
        assert [tuple(s) for s in transposes] == list(pmg.TRANSPOSE_SHAPES)
        assert tables == list(pmg.GATHER_TABLES)
        assert reference_assignments(REF_MOSAIC)["E"] == pmg.GATHER_INDICES
        fused = reference_assignments(REF_FUSED)
        assert (fused["n_regions"], fused["BLOCK_ROWS"]) == (pfp.N_REGIONS, pfp.BLOCK_ROWS)
        assert (fused["W"], fused["S"]) == (pfp.W, pfp.S)

    @pytest.mark.parametrize("probe", [pmg, pfp], ids=["mosaic_gather", "fused_primitives"])
    def test_run_without_device_raises_without_cuda(self, no_cuda, probe):  # noqa: F811
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe.run()
        with pytest.raises(ValueError, match="time the card"):
            probe.run("cpu")

    @pytest.mark.parametrize("module", ["probe_mosaic_gather", "probe_fused_primitives"])
    def test_import_prints_and_allocates_nothing(self, module):
        # numpy reports its data buffers to tracemalloc in a domain of its
        # own; the probe data is drawn with numpy before it goes to torch.
        # What the probe module imports is loaded first: only its own
        # import is watched.
        code = (
            "import json, tracemalloc, torch, numpy\n"
            "import protocol_tpu_torch.ops, protocol_tpu_torch.bench._timing\n"
            "tracemalloc.start()\n"
            f"import protocol_tpu_torch.bench.{module} as m\n"
            "snap = tracemalloc.take_snapshot().filter_traces(\n"
            "    [tracemalloc.DomainFilter(True, numpy.lib.tracemalloc_domain)])\n"
            "arrays = [k for k, v in vars(m).items() if isinstance(v, (torch.Tensor, numpy.ndarray))]\n"
            "print(json.dumps(dict(\n"
            "    numpy_bytes=sum(s.size for s in snap.statistics('filename')), arrays=arrays,\n"
            "    cuda=torch.cuda.is_initialized())))\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
            check=True,
        )
        lines = out.stdout.strip().splitlines()
        assert len(lines) == 1, out.stdout  # the import itself printed nothing
        assert json.loads(lines[0]) == dict(numpy_bytes=0, arrays=[], cuda=False)
