"""Progress reporting and stage timing (port of `ccgp_tpu/utils/progress.py`).

The reference wraps its slow loops in a text progress bar (`apply_pb`,
`1D Codes and Designs/1D Combined GP Public.R:36-53`). Here: a host-side
progress bar for sweeps over studies, a wall-clock stage timer, and a
`torch.profiler` trace around a block (JAX's `jax_trace`).
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Iterable, Iterator, Optional


def progress(it: Iterable, total: Optional[int] = None, width: int = 40,
             label: str = "", stream=sys.stderr) -> Iterator:
    """Minimal dependency-free progress bar over a host-side iterable."""
    items = list(it) if total is None else it
    n = total if total is not None else len(items)
    start = time.time()
    for i, v in enumerate(items):
        yield v
        done = i + 1
        bar = "=" * int(done / max(n, 1) * width)
        el = time.time() - start
        stream.write(f"\r{label}[{bar:<{width}}] {done}/{n} {el:6.1f}s")
        stream.flush()
    stream.write("\n")


@contextlib.contextmanager
def stage_timer(name: str, sink: Optional[dict] = None, stream=sys.stderr):
    """Wall-clock a pipeline stage; add the seconds into `sink[name]` if
    a sink is given, else write the milliseconds to `stream`. The clock is
    the host's: synchronize the device inside the block to time its
    work."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    else:
        stream.write(f"[{name}] {dt * 1e3:.1f} ms\n")


@contextlib.contextmanager
def torch_trace(logdir: str):
    """A `torch.profiler` trace of the block, CPU and (where there is one)
    CUDA activity, written to `logdir` as a Chrome trace (view it in
    Perfetto or TensorBoard)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     str(logdir))):
        yield
