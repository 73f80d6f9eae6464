"""The port's fault-injection framework (``protocol_tpu_torch/chaos/``)
held to the reference's suite (``tests/test_chaos.py``), case for case,
and to the reference's own outputs where both produce them: the same
declared fault points, the same seeded schedule of hits, the same torn
bytes, the same crash exit code.

Covers the disabled default, the registry, the trigger semantics (after,
times, seeded p), every fault kind (crash in a subprocess, since the
in-process tests cannot survive ``os._exit``; delay, io-error,
rpc-error, torn writes through ``corrupt`` and ``wrap_file``), counting
mode and the environment variable.
"""

from __future__ import annotations

import errno
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from protocol_tpu import chaos as ref_chaos
from protocol_tpu_torch import chaos

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _reset_chaos():
    yield
    chaos.reset()
    ref_chaos.reset()


class TestDisabledDefault:
    def test_inactive_by_default(self):
        assert chaos.ACTIVE is False

    def test_fire_without_schedule_is_noop(self):
        # Sites never reach fire() when inactive, but an unguarded call
        # must still be harmless.
        chaos.fire("wal.post_append")

    def test_registry_lists_declared_points(self):
        # Importing the node modules registers their fault points.
        import protocol_tpu.node.checkpoint  # noqa: F401
        import protocol_tpu.node.ethereum  # noqa: F401
        import protocol_tpu.node.server  # noqa: F401
        import protocol_tpu.node.wal  # noqa: F401
        import protocol_tpu_torch.node.checkpoint  # noqa: F401
        import protocol_tpu_torch.node.ethereum  # noqa: F401
        import protocol_tpu_torch.node.server  # noqa: F401
        import protocol_tpu_torch.node.wal  # noqa: F401

        points = chaos.registry()
        for expected in (
            "wal.append",
            "wal.post_append",
            "wal.replay",
            "checkpoint.write",
            "checkpoint.pre_rename",
            "checkpoint.post_save",
            "ingest.pre_apply",
            "epoch.post_converge",
            "prover.pre_enqueue",
            "rpc.get_logs",
            "rpc.block_number",
        ):
            assert expected in points, expected
        assert points == ref_chaos.registry()


def both(spec: dict) -> None:
    chaos.configure(spec)
    ref_chaos.configure(spec)


class TestTriggers:
    def test_after_fires_on_exact_hit(self):
        both({"seed": 1, "faults": [{"point": "p", "kind": "io-error", "after": 3}]})
        for mod in (chaos, ref_chaos):
            mod.fire("p")
            mod.fire("p")
            with pytest.raises(OSError) as exc:
                mod.fire("p")
            assert exc.value.errno == errno.ENOSPC
            mod.fire("p")  # hit 4: past the schedule

    def test_times_fires_on_first_n_hits(self):
        chaos.configure({"seed": 1, "faults": [{"point": "p", "kind": "rpc-error", "times": 2}]})
        for _ in range(2):
            with pytest.raises(chaos.ChaosRpcError):
                chaos.fire("p")
        chaos.fire("p")  # hit 3 passes

    def test_probability_is_seed_deterministic(self):
        def draws(mod, seed: int) -> list[bool]:
            mod.configure({"seed": seed, "faults": [{"point": "p", "kind": "io-error", "p": 0.5}]})
            out = []
            for _ in range(32):
                try:
                    mod.fire("p")
                    out.append(False)
                except OSError:
                    out.append(True)
            return out

        a, b = draws(chaos, 7), draws(chaos, 7)
        assert a == b, "same seed must replay the same schedule"
        assert any(a) and not all(a), "p=0.5 over 32 hits should mix"
        assert draws(chaos, 8) != a, "a different seed should re-roll"
        assert a == draws(ref_chaos, 7), "the reference draws the same schedule"

    def test_custom_errno(self):
        chaos.configure({"seed": 1, "faults": [{"point": "p", "kind": "io-error", "errno": "EIO"}]})
        with pytest.raises(OSError) as exc:
            chaos.fire("p")
        assert exc.value.errno == errno.EIO

    def test_delay_sleeps(self):
        chaos.configure({"seed": 1, "faults": [{"point": "p", "kind": "delay", "delay_s": 0.05}]})
        t0 = time.perf_counter()
        chaos.fire("p")
        assert time.perf_counter() - t0 >= 0.04

    def test_counting_mode_tracks_hits_without_faults(self):
        both({"seed": 0, "faults": []})
        assert chaos.ACTIVE
        for mod in (chaos, ref_chaos):
            mod.fire("a")
            mod.fire("a")
            mod.fire("b")
        assert chaos.hits() == {"a": 2, "b": 1} == ref_chaos.hits()


class TestTornWrites:
    def test_corrupt_truncates_at_byte_k(self):
        both({"seed": 1, "faults": [
            {"point": "w", "kind": "torn", "at": 4, "after": 1, "then_crash": False}]})
        torn = [mod.corrupt("w", b"0123456789") for mod in (chaos, ref_chaos)]
        assert torn == [b"0123", b"0123"]
        # Only the scheduled hit tears; the next write is whole.
        assert chaos.corrupt("w", b"0123456789") == b"0123456789"
        assert ref_chaos.corrupt("w", b"0123456789") == b"0123456789"

    def test_wrap_file_drops_past_k(self):
        both({"seed": 1, "faults": [{"point": "w", "kind": "torn", "at": 6, "then_crash": False}]})
        written = []
        for mod in (chaos, ref_chaos):
            buf = io.BytesIO()
            f = mod.wrap_file("w", buf)
            f.write(b"0123")
            f.write(b"456789")  # claims success, silently drops past byte 6
            written.append(buf.getvalue())
        assert written == [b"012345", b"012345"]

    def test_wrap_file_without_schedule_passes_through(self):
        chaos.configure({"seed": 1, "faults": []})
        buf = io.BytesIO()
        assert chaos.wrap_file("w", buf) is buf


class TestCrash:
    def _run(self, spec: dict, body: str, env=None) -> int:
        code = "from protocol_tpu_torch import chaos\n" f"chaos.configure({spec!r})\n" + body
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=120,
                              cwd=str(REPO), env=env)
        return proc.returncode

    def test_crash_exits_with_chaos_code(self):
        rc = self._run(
            {"seed": 1, "faults": [{"point": "p", "kind": "crash", "after": 2}]},
            "chaos.fire('p')\nchaos.fire('p')\nprint('unreachable')\n",
        )
        assert rc == chaos.CRASH_EXIT_CODE == ref_chaos.CRASH_EXIT_CODE

    def test_torn_then_crash_arms_next_fire(self):
        rc = self._run(
            {"seed": 1, "faults": [{"point": "w", "kind": "torn", "at": 2}]},
            "out = chaos.corrupt('w', b'abcdef')\n"
            "assert out == b'ab', out\n"
            "chaos.fire('x')\nprint('unreachable')\n",
        )
        assert rc == chaos.CRASH_EXIT_CODE

    def test_env_var_configures(self):
        spec = json.dumps({"seed": 1, "faults": [{"point": "p", "kind": "crash"}]})
        proc = subprocess.run(
            [sys.executable, "-c", "from protocol_tpu_torch import chaos\nchaos.fire('p')\n"],
            env={**os.environ, "PROTOCOL_TPU_CHAOS": spec}, capture_output=True, timeout=120,
            cwd=str(REPO),
        )
        assert proc.returncode == chaos.CRASH_EXIT_CODE
