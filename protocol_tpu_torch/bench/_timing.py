"""Device time of one call on the card, and a kernel held against its
plain version.

``time_ms`` is the counterpart of the reference probes' ``timed_chain``
and ``timed``.  Those ran the op ``REPS`` times inside one jitted
``fori_loop`` with a data dependence on the loop carry, so that XLA
could neither hoist nor delete it.  Eager PyTorch launches every call
for real, so here each call is timed on its own between CUDA events and
the median is taken.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch

#: H100 SXM device-memory rate (NVIDIA data sheet), for byte bounds.
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, for operation bounds.
F32_OPS_PER_S = 67e12
#: H100 SXM 32-bit integer rate: the float32 rate counts two operations
#: (an FMA) for each of an SM's 128 float32 lanes a clock; an SM has 64
#: integer lanes, each one 32-bit multiply-add (IMAD) a clock.  For the
#: graft kernels' operation bounds, in IMADs.
INT32_OPS_PER_S = F32_OPS_PER_S / 4

#: Untimed calls before the timed ones (kernel load, allocator, caches).
WARMUP = 3
#: Timed calls; the result is their median.
REPS = 20
#: Cycles of ``torch.cuda._sleep`` queued ahead of each timed call, about
#: 0.1 ms at Hopper's clock: the card spins while the host enqueues the
#: start event, the call and the end event, so the events bracket the
#: call's device time and not the host's launch overhead.
SPIN_CYCLES = 200_000


def time_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median device time in ms of ``fn()`` over ``reps`` calls, each
    between two CUDA events on the current stream, after ``warmup``
    untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int = 0, ops_per_s: float = F32_OPS_PER_S) -> float:
    """The least time in ms the card takes to move ``nbytes`` through
    device memory and do ``ops`` operations at ``ops_per_s`` (float32 by
    default): the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s) * 1e3


def bound_by(nbytes: int, ops: int = 0, ops_per_s: float = F32_OPS_PER_S) -> str:
    """Which of the two sets ``bound_ms``: ``"bytes"`` or ``"operations"``."""
    return "bytes" if nbytes / HBM_BYTES_PER_S >= ops / ops_per_s else "operations"


def _lanes(out) -> tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bit patterns: unlike ``torch.equal``, a
    ``-0.0`` does not equal a ``+0.0``."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def kernel_vs_plain(kernel, plain, *, wrapper, nbytes: int, ops: int = 0, library=None) -> dict:
    """Call ``kernel()``, a call of the kernel's ``wrapper``, once and
    require it to equal ``plain()`` and, where given, ``library()`` bit
    for bit, every output lane where the calls return a tuple (a
    difference raises); then time all three.  Returns the times, the
    bound, the max abs error and ``launches``, the growth of
    ``wrapper.launches`` over the call: ``1 + WARMUP + REPS``."""
    before = wrapper.launches
    out = _lanes(kernel())
    ref = _lanes(plain())
    err = max(
        (float((o - r).abs().max()) for o, r in zip(out, ref) if o.numel() and o.shape == r.shape),
        default=0.0,
    )
    if len(out) != len(ref) or not all(same_bits(o, r) for o, r in zip(out, ref)):
        raise RuntimeError(f"{wrapper.__name__} differs from its plain version (max abs err {err})")
    if library is not None and not all(same_bits(o, r) for o, r in zip(out, _lanes(library()))):
        raise RuntimeError(f"{wrapper.__name__} differs from its library call")
    del out, ref
    return dict(
        max_abs_err=err,
        ms=time_ms(kernel),
        plain_ms=time_ms(plain),
        library_ms=None if library is None else time_ms(library),
        bound_ms=bound_ms(nbytes, ops),
        bytes=nbytes,
        launches=wrapper.launches - before,
    )


#: Profiler sessions ``trace_ms`` takes at most before it gives up.
TRACE_TRIES = 3
#: Throwaway launches, and seconds of waiting after them, with which a
#: profiler session starts before the traced work.  The profiler (torch
#: 2.11 on an H100) can lose the records of a session's first launches
#: and copies; ``bench/probe_trace_start.py`` measures how often, and how
#: many, with and without them.
TRACE_PRIMER_LAUNCHES = 64
TRACE_SETTLE_S = 0.2
#: The ``record_function`` range of ``settle_trace`` in a trace.
SETTLE_RANGE = "settle_trace"


def settle_trace(device=None) -> None:
    """Start a profiler session that has just started with launches it
    may lose: ``TRACE_PRIMER_LAUNCHES`` small adds on ``device`` (the
    current card where None), a synchronize, then a wait of
    ``TRACE_SETTLE_S``, all inside a ``SETTLE_RANGE`` range
    (``settled_after``)."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.profiler.record_function(SETTLE_RANGE):
        x = torch.zeros(1, device=device)
        for _ in range(TRACE_PRIMER_LAUNCHES):
            x.add_(1.0)
        torch.cuda.synchronize(device)
        time.sleep(TRACE_SETTLE_S)


def settled_after(prof) -> float:
    """The trace time (us) from which a session's records are the traced
    work's: the middle of ``settle_trace``'s wait, when the card is idle,
    so that the primer's records lie before it and the work's after it
    whatever the skew between the host's and the card's clocks, up to
    half the wait.  ``-inf`` in a session that did not settle."""
    ends = [e.time_range.end for e in prof.events() if e.name == SETTLE_RANGE]
    return max(ends) - TRACE_SETTLE_S * 1e6 / 2 if ends else float("-inf")


def device_events(prof) -> list:
    """The card's records (kernels and copies) of a session's traced
    work: those that start after ``settled_after``."""
    from torch.autograd import DeviceType

    after = settled_after(prof)
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.time_range.start > after]


@contextlib.contextmanager
def trace_session():
    """A ``torch.profiler`` session over the CPU and the card, settled
    (``settle_trace``) before it yields the profiler; read its work's
    device records with ``device_events``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        settle_trace()
        yield prof


def trace_ms(fn, calls: int = REPS) -> float | None:
    """Device time in ms of one call of ``fn``, a call that launches one
    kernel: the median duration of that kernel's launches in a settled
    ``torch.profiler`` trace (``trace_session``) over ``calls`` calls
    after one untimed call.  Without the launch or the gaps between
    kernels.  The kernel is the name launched most often in the trace,
    the median keeps out a stray event, and a trace with no device event
    is taken again, up to ``TRACE_TRIES`` times.  None where none held
    one."""
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with trace_session() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name: dict[str, list[float]] = {}
        for e in device_events(prof):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if by_name:
            return statistics.median(max(by_name.values(), key=len)) / 1e3
    return None
