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

import statistics

import torch

#: H100 SXM device-memory rate (NVIDIA data sheet), for byte bounds.
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, for operation bounds.
F32_OPS_PER_S = 67e12

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


def bound_ms(nbytes: int, ops: int = 0) -> float:
    """The least time in ms the card takes to move ``nbytes`` through
    device memory and do ``ops`` float32 operations: the larger of the
    two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def bound_by(nbytes: int, ops: int = 0) -> str:
    """Which of the two sets ``bound_ms``: ``"bytes"`` or ``"operations"``."""
    return "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"


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
