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


# -- K2's schedule, emulated ---------------------------------------------------
#
# numpy mirrors of csrc/take_along_axis.cu's two regimes: which block
# stages which row and serves which outputs, with the kernel's clamps.
# Each shows every output element written exactly once and bit-equal to
# the plain version.

K2_SOURCE = REPO / "protocol_tpu_torch" / "ops" / "csrc" / "take_along_axis.cu"
K3_SOURCE = REPO / "protocol_tpu_torch" / "ops" / "csrc" / "transpose2d.cu"
THREADS_SMEM, THREADS_DIRECT = 512, 256


def _part(n, q, parts):
    return q * n // parts, (q + 1) * n // parts


def emulate_take(table, idx, axis, g):
    """K2's launch ``g`` (a ``Geometry``) on numpy arrays: (out, writes
    per element)."""
    rows, cols = table.shape
    flat_t, flat_i = table.ravel(), idx.ravel().astype(np.int64)
    out = np.zeros(rows * cols, np.float32)
    writes = np.zeros(rows * cols, np.int64)

    def put(e, v):
        np.add.at(writes, e, 1)
        out[e] = v

    if g.regime == "direct":  # per / 4 float4 units a thread, a block-width apart
        n4 = rows * cols // 4
        units = g.per // 4
        for blk in range(-(-n4 // (THREADS_DIRECT * units))):
            first = blk * THREADS_DIRECT * units
            for start in range(first, first + THREADS_DIRECT * units, THREADS_DIRECT):
                u = np.arange(start, min(start + THREADS_DIRECT, n4))
                e = (4 * u[:, None] + np.arange(4)).ravel()
                r, c = e // cols, e % cols
                k = flat_i[e]
                src = r * cols + np.clip(k, 0, cols - 1) if axis == 1 else np.clip(k, 0, rows - 1) * cols + c
                put(e, flat_t[src])
    else:  # smem, axis 1: block b stages row b // parts, serves part b % parts
        assert axis == 1 and cols <= pmg.STAGE_MAX_FLOATS
        for blk in range(rows * g.parts):
            r = blk // g.parts
            stage = flat_t[r * cols:(r + 1) * cols].copy()
            lo, hi = _part(cols // 4, blk % g.parts, g.parts)
            # Two units a thread in flight: i and i + 512, then 1,024 on.
            for i0 in range(lo, hi, 2 * THREADS_SMEM):
                for u in (np.arange(i0, min(i0 + THREADS_SMEM, hi)),
                          np.arange(i0 + THREADS_SMEM, min(i0 + 2 * THREADS_SMEM, hi))):
                    e = (4 * u[:, None] + np.arange(4)).ravel()
                    put(r * cols + e, stage[np.clip(flat_i[r * cols + e], 0, cols - 1)])
    return out.reshape(rows, cols), writes.reshape(rows, cols)


def planted_indices(axis, rows, cols, seed):
    """Random indices with 0, the range's last index and values outside
    the range in every seventh element, as the chip's edge checks draw."""
    hi = rows if axis == 0 else cols
    idx = np.random.default_rng(seed).integers(0, hi, (rows, cols)).astype(np.int32)
    planted = np.array([0, hi - 1, -1, hi, -(2**31), 2**31 - 1], np.int32)
    flat = idx.reshape(-1)
    at = np.arange(0, flat.size, 7)
    flat[at] = planted[np.arange(at.size) % planted.size]
    return idx


def held(axis, rows, cols, g):
    """The launch ``g`` emulated at one shape, held to the plain version."""
    table = np.random.default_rng(rows * 31 + cols).random((rows, cols), dtype=np.float32)
    idx = planted_indices(axis, rows, cols, rows + cols)
    out, writes = emulate_take(table, idx, axis, g)
    assert (writes == 1).all(), f"{g}: elements written {np.unique(writes)} times"
    clamped = np.clip(idx, 0, (rows if axis == 0 else cols) - 1)
    ref = pmg.take_along_axis_plain(t(table), t(clamped), axis).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


# +- 4 columns about each limit: where rows start and stop being staged,
# and where the direct regime changes its elements a thread.
AXIS1_EDGE_COLS = [c + d for c in (1024, 2048, pmg.SMEM_MIN_COLS, pmg.STAGE_MAX_FLOATS)
                   for d in (-4, 0, 4)]


class TestTakeAlongAxisSchedule:
    @pytest.mark.parametrize("sms", [6, 132])
    @pytest.mark.parametrize("rows", [1, 3, 5])
    @pytest.mark.parametrize("cols", [4, 8, 12, *AXIS1_EDGE_COLS])
    def test_axis1_launch_writes_each_element_once(self, rows, cols, sms):
        g = pmg.take_along_axis_geometry(1, rows, cols, sms)
        assert g.regime == ("smem" if pmg.SMEM_MIN_COLS < cols <= pmg.STAGE_MAX_FLOATS else "direct")
        held(1, rows, cols, g)

    @pytest.mark.parametrize("rows, cols", [(1, 131068), (2, 131072), (1, 131076)])
    def test_axis1_launch_about_the_last_16_a_thread_row(self, rows, cols):
        g = pmg.take_along_axis_geometry(1, rows, cols, 132)
        assert g == pmg.Geometry("direct", per=16 if cols <= 131072 else 4)
        held(1, rows, cols, g)

    @pytest.mark.parametrize("rows", [1, 3, 16, 17, 40])
    @pytest.mark.parametrize("cols", [4, 12, 64, 132])
    def test_axis0_launch_writes_each_element_once(self, rows, cols):
        g = pmg.take_along_axis_geometry(0, rows, cols, 6)
        assert g == pmg.Geometry("direct", per=4)
        held(0, rows, cols, g)

    @pytest.mark.parametrize("axis, rows, cols, regime, parts, per", [
        (1, 8192, 128, "direct", 1, 4), (1, 1024, 1024, "direct", 1, 4), (1, 512, 2048, "direct", 1, 8),
        (1, 256, 4096, "direct", 1, 16), (1, 256, 4100, "smem", 1, 0), (1, 128, 8192, "smem", 2, 0),
        (1, 64, 16384, "smem", 4, 0), (1, 8, 131072, "direct", 1, 16), (1, 8, 131076, "direct", 1, 4),
        (1, 8, 1048576, "direct", 1, 4), (0, 8, 128, "direct", 1, 4), (0, 8192, 128, "direct", 1, 4),
        (1, 3, pmg.STAGE_MAX_FLOATS, "smem", 13, 0), (1, 3, pmg.STAGE_MAX_FLOATS + 4, "direct", 1, 16),
        (1, 133, pmg.STAGE_MAX_FLOATS, "smem", 1, 0), (0, pmg.STAGE_MAX_FLOATS // 4, 4, "direct", 1, 4),
    ])
    def test_launch_the_wrapper_takes(self, axis, rows, cols, regime, parts, per):
        assert pmg.take_along_axis_geometry(axis, rows, cols, 132) == pmg.Geometry(regime, parts, per)

    @pytest.mark.parametrize("axis, rows, cols", [
        (1, 64, 16384), (1, 128, 8192), (1, 8, 131072), (0, 8192, 128), (1, 133, 4100),
    ])
    def test_probe_shapes_on_the_card(self, axis, rows, cols):
        """The H100's 132 SMs, at shapes the chip runs."""
        held(axis, rows, cols, pmg.take_along_axis_geometry(axis, rows, cols, 132))

    @pytest.mark.parametrize("per", [4, 8, 16])
    @pytest.mark.parametrize("axis, rows, cols", [(1, 5, 12), (1, 7, 1040), (0, 33, 20), (0, 3, 4)])
    def test_direct_at_each_count_a_thread(self, axis, rows, cols, per):
        held(axis, rows, cols, pmg.Geometry("direct", per=per))

    @pytest.mark.parametrize("parts", [1, 2, 3, 7, 13])
    @pytest.mark.parametrize("rows, cols", [(1, 8), (2, 4100), (3, 9000)])
    def test_smem_at_each_split_of_a_row(self, rows, cols, parts):
        # More parts than float4 units leaves blocks with nothing to do.
        held(1, rows, cols, pmg.Geometry("smem", parts=parts))

    @pytest.mark.parametrize("seed", range(8))
    def test_geometry_stays_within_the_kernels_limits(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            axis = int(rng.integers(0, 2))
            rows = int(rng.integers(1, 20000))
            cols = 4 * int(rng.integers(1, 300000))
            sms = int(rng.integers(1, 200))
            g = pmg.take_along_axis_geometry(axis, rows, cols, sms)
            assert g.parts >= 1
            if g.regime == "smem":
                assert axis == 1 and pmg.SMEM_MIN_COLS < cols <= pmg.STAGE_MAX_FLOATS
                assert g.per == 0 and rows * g.parts <= max(2 * sms, rows)
                assert g.parts <= -(-cols // pmg.PART_MIN)
            else:
                assert g.regime == "direct" and g.parts == 1 and g.per in (4, 8, 16)

    def test_constants_match_the_kernel_source(self):
        src = K2_SOURCE.read_text()
        assert f"kStageMaxFloats = {pmg.STAGE_MAX_FLOATS};" in src
        assert f"kThreads = {THREADS_SMEM};" in src and f"kDirectThreads = {THREADS_DIRECT};" in src
        r = pmg.REGIMES
        assert f"enum Regime : int {{ kSmem = {r['smem']}, kDirect = {r['direct']} }};" in src
        for per, units in ((4, 1), (8, 2), (16, 4)):
            assert f"if (per == {per}) return launch_direct<{units}>" in src

    def test_wrapper_takes_no_regime_of_the_callers(self):
        table, idx = gather_inputs(1, 8, 16)
        with pytest.raises(TypeError):
            pmg.take_along_axis(t(table), t(idx), 1, regime="smem")


# -- K3's tile walk, emulated --------------------------------------------------
#
# csrc/transpose2d.cu: block (x, y) of a (L / 32, R / 32) grid moves the 32 x
# 32 tile at input rows 32 y.., columns 32 x.., through a tile padded to 33
# columns, with 32 x 8 threads, each thread four elements a pass.

TILE, ROWS_PER_PASS, PAD = 32, 8, 33


def emulate_transpose(table):
    """(out, writes per element) of the kernel's grid on ``table``."""
    rows, cols = table.shape
    out = np.full((cols, rows), np.nan, np.float32)
    writes = np.zeros((cols, rows), np.int64)
    tx, ty = np.meshgrid(np.arange(TILE), np.arange(ROWS_PER_PASS), indexing="xy")
    for by in range(-(-rows // TILE)):
        for bx in range(-(-cols // TILE)):
            r0, c0 = by * TILE, bx * TILE
            smem = np.full(TILE * PAD, np.nan, np.float32)
            for j0 in range(0, TILE, ROWS_PER_PASS):  # loads: a warp reads one input row
                j, r, c = j0 + ty, r0 + j0 + ty, c0 + tx
                ok = (r < rows) & (c < cols)
                smem[(j * PAD + tx)[ok]] = table[r[ok], c[ok]]
            for j0 in range(0, TILE, ROWS_PER_PASS):  # stores: a warp writes one output row
                j, c, r = j0 + ty, c0 + j0 + ty, r0 + tx
                ok = (c < cols) & (r < rows)
                np.add.at(writes, (c[ok], r[ok]), 1)
                out[c[ok], r[ok]] = smem[(tx * PAD + j)[ok]]
    return out, writes


class TestTranspose2dSchedule:
    @pytest.mark.parametrize("rows, cols", [
        (33, 65), (1, 4), (4, 1), (65, 4097), (128, 8190), (100, 36), (4098, 128), (64, 64),
        (300, 100),
    ])
    def test_grid_writes_each_element_once(self, rows, cols):
        table = np.random.default_rng(rows + cols).random((rows, cols), dtype=np.float32)
        out, writes = emulate_transpose(table)
        assert (writes == 1).all()
        np.testing.assert_array_equal(out, pmg.transpose2d_plain(t(table)).numpy())

    def test_tile_accesses_are_free_of_bank_conflicts(self):
        lanes = np.arange(TILE)
        for j in range(TILE):
            assert len(set((j * PAD + lanes) % 32)) == 32  # a warp stores one tile row
            assert len(set((lanes * PAD + j) % 32)) == 32  # a warp reads one tile column

    def test_constants_match_the_kernel_source(self):
        src = K3_SOURCE.read_text()
        for text in (f"kTile = {TILE};", f"kRowsPerPass = {ROWS_PER_PASS};",
                     "tile[kTile][kTile + 1]"):
            assert text in src
        assert pmg._TRANSPOSE_MAX_ROWS == 65_535 * TILE


class TestYardsticks:
    def test_earlier_form_raises_on_cpu_tensors(self):
        from protocol_tpu_torch.bench import yardsticks as ys

        table, idx = gather_inputs(1, 8, 16)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            ys.take_along_axis_ldg(t(table), t(idx), 1)

    def test_edge_checks_need_the_card(self, no_cuda):  # noqa: F811
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmg.check_edges()
        with pytest.raises(ValueError, match="on the card"):
            pmg.check_edges("cpu")

    def test_edges_cover_each_regimes_limits(self):
        axis1 = {c for a, _, c in pmg.GATHER_EDGES if a == 1}
        for limit in (1024, 2048, pmg.SMEM_MIN_COLS, pmg.STAGE_MAX_FLOATS, 131072):
            assert {limit - 4, limit, limit + 4} <= axis1
        rows1 = {r for a, r, c in pmg.GATHER_EDGES if a == 1 and c >= pmg.STAGE_MAX_FLOATS - 4}
        assert min(rows1) < 132 < max(rows1)
        taken = {pmg.take_along_axis_geometry(a, r, c, 132) for a, r, c in pmg.GATHER_EDGES}
        assert {g.regime for g in taken} == set(pmg.REGIMES)
        assert {g.per for g in taken} == {0, 4, 8, 16}
        assert any(g.parts > 1 for g in taken)
        assert {(33, 65), (1, 4), (4, 1), (65, 4097)} <= set(pmg.TRANSPOSE_EDGES)
        assert any(c % 4 and r % 4 == 0 for r, c in pmg.TRANSPOSE_EDGES)
