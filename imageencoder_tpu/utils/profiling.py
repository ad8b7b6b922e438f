"""Tracing / profiling hooks (the reference has wall-clock timers only,
utils.hpp:168-198; this framework adds per-stage timing + JAX device traces).

Usage:
    with Trace("encode") as t:
        with t.stage("transform"):
            ...
        with t.stage("pack"):
            ...
    t.report()   # per-stage ms + throughput, via Logger

Ambient usage (how the CLI's --trace works): library stages mark
themselves with the module-level ``stage()`` context manager, which is a
no-op unless a ``tracing()`` scope is active — zero overhead on untraced
runs, and the codec internals need no plumbing of trace objects:

    with tracing("decode", pixels=w * h) as t:
        decode_image(data)          # its internal stage() calls report to t
    t.report()

    with device_trace("/tmp/jax-trace"):   # XLA-level profile for xprof
        run()
"""

from __future__ import annotations

import contextlib
import time

from .logger import Logger


class Trace:
    def __init__(self, name: str, pixels: int | None = None):
        self.name = name
        self.pixels = pixels
        self.stages: list[tuple[str, float]] = []
        self._t0 = None
        self.total = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total = time.perf_counter() - self._t0
        return False

    @contextlib.contextmanager
    def stage(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((label, time.perf_counter() - t0))

    def report(self) -> None:
        for label, dt in self.stages:
            Logger.write(f"[trace:{self.name}] {label}: {dt * 1e3:.2f} ms")
        if self.total:
            msg = f"[trace:{self.name}] total: {self.total * 1e3:.2f} ms"
            if self.pixels:
                msg += f" ({self.pixels / self.total / 1e6:.1f} Mpix/s)"
            Logger.write(msg)


_CURRENT: Trace | None = None


def current() -> Trace | None:
    """The innermost active tracing() scope, or None."""
    return _CURRENT


@contextlib.contextmanager
def tracing(name: str, pixels: int | None = None):
    """Activate a Trace as the ambient collector for nested stage() marks."""
    global _CURRENT
    t = Trace(name, pixels)
    prev = _CURRENT
    _CURRENT = t
    try:
        with t:
            yield t
    finally:
        _CURRENT = prev


@contextlib.contextmanager
def stage(label: str):
    """Mark a library stage; records into the ambient trace if one is
    active, else free (a single global read)."""
    t = _CURRENT
    if t is None:
        yield
    else:
        with t.stage(label):
            yield


@contextlib.contextmanager
def device_trace(logdir: str):
    """XLA device trace via the JAX profiler (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


GEMM_KEY = "<cublas gemm>"


def _kernel_op_names(hlo_texts) -> dict:
    """{kernel name: op_name metadata} from optimized HLO module text.

    XLA names a fusion's GPU kernel after the fusion instruction with '.'
    and '-' replaced by '_'; a fusion without its own scoped op_name takes
    the first one in the computation it calls.  Custom calls that launch a
    named kernel (Pallas calls) are also keyed by every identifier in
    their backend config, which holds the kernel's name.  cuBLAS kernels
    carry cuBLAS's own names; when every cuBLAS call of the modules has
    the same op_name, GEMM_KEY maps to it.
    """
    import re

    comp_ops, instrs, gemm_ops = {}, [], set()
    comp = None
    for line in "\n".join(hlo_texts).splitlines():
        m = re.match(r"^(?:ENTRY )?%([\w.\-]+) \(", line)
        if m:
            comp = m.group(1)
            continue
        m = re.match(r"^\s*(?:ROOT )?%([\w.\-]+) = (.*)$", line)
        if not m:
            continue
        op = re.search(r'op_name="([^"]*/[^"]*)"', line)
        if op and comp is not None:
            comp_ops.setdefault(comp, op.group(1))
        calls = re.search(r"calls=%([\w.\-]+)", line)
        cfg = line.split("backend_config=", 1)[1] \
            if "custom-call(" in line and "backend_config=" in line else ""
        if 'custom_call_target="__cublas' in line and op:
            gemm_ops.add(op.group(1))
        instrs.append((m.group(1), op.group(1) if op else None,
                       calls.group(1) if calls else None,
                       re.findall(r"[A-Za-z_]\w+", cfg)))
    out = {}
    for name, op, calls, quoted in instrs:
        op = op or comp_ops.get(calls)
        if op is None:
            continue
        out.setdefault(re.sub(r"[.\-]", "_", name), op)
        for q in quoted:
            out.setdefault(q, op)
    if len(gemm_ops) == 1:
        out[GEMM_KEY] = gemm_ops.pop()
    return out


def attribute_stage_times(events, scopes, kernel_ops):
    """Sum (kernel name, stats, duration ns) events per scope.

    An event belongs to the first scope in ``scopes`` that is a path
    segment of its op name: its own ``tf_op`` stat when that holds one,
    else ``kernel_ops[kernel name]`` (:func:`_kernel_op_names`), and for a
    cuBLAS GEMM kernel ``kernel_ops[GEMM_KEY]``.  Returns
    (totals, unattributed): totals maps each scope, plus "_unattributed"
    and "_device_total", to nanoseconds; unattributed maps the kernel
    names no scope claimed to their nanoseconds.
    """
    def scope_of(op):
        return next((s for s in scopes
                     if f"/{s}/" in op or op.endswith(f"/{s}")), None)

    totals = {s: 0 for s in scopes}
    totals["_unattributed"] = 0
    totals["_device_total"] = 0
    unattributed: dict = {}
    for name, stats, dur in events:
        op = kernel_ops.get(name)
        if op is None and "gemm" in name:
            op = kernel_ops.get(GEMM_KEY)
        scope = scope_of(stats.get("tf_op", "")) or scope_of(op or "")
        totals["_device_total"] += dur
        if scope is None:
            totals["_unattributed"] += dur
            unattributed[name] = unattributed.get(name, 0) + dur
        else:
            totals[scope] += dur
    return totals, unattributed


def device_stage_times(trace_dir: str, scopes, hlo_texts=()):
    """Per-scope device time of the newest ``*.xplane.pb`` under
    ``trace_dir`` (read with ``jax.profiler.ProfileData``): every event on
    a device plane goes through :func:`attribute_stage_times`, with kernel
    names resolved through ``hlo_texts`` (optimized HLO modules, as
    ``jitted.lower(...).compile().as_text()`` prints them)."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {trace_dir}")
    events = [(ev.name, {k: str(v) for k, v in ev.stats},
               int(ev.duration_ns))
              for plane in ProfileData.from_file(paths[-1]).planes
              if plane.name.startswith("/device:")
              for line in plane.lines for ev in line.events]
    return attribute_stage_times(events, scopes,
                                 _kernel_op_names(hlo_texts))
