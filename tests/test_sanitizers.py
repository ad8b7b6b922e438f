"""TSAN/ASAN gate for the native runtime's concurrency.

Builds sanitizer-instrumented binaries of runtime.cpp + the pure-C++
driver (tools/sanitize_drive.cpp) and runs them:

* ASAN (+leak check): must be completely clean — covers the OpenMP
  chunk packers' blind 8-byte emits, the speculative FSM's scribble
  slack, and every buffer-capacity bound.
* TSAN: must report NO races beyond gcc-libgomp's known false-positive
  class.  libgomp's fork/barrier handoff is invisible to TSAN, so
  workers' READS of the on-main-stack capture struct (and of read-only
  main-stack inputs) at region entry are reported even though the fork
  orders them; runtime.cpp's TSAN_HB_* annotations add the
  barrier-equivalent edges for everything else, so any report that is a
  WRITE by a worker, or that involves a heap/global location, is real
  and fails the test.

This is the native-concurrency analogue of the reference's one piece of
sanitizer rigor (the Valgrind fix, BitStream.cpp:16-19).
"""

from __future__ import annotations

import re
import shutil
import subprocess

import pytest

from imageencoder_tpu.runtime.build import build_sanitized as _build


@pytest.mark.skipif(shutil.which("g++") is None, reason="no compiler")
def test_asan_clean():
    exe = _build("address")
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300,
                       env={"ASAN_OPTIONS": "detect_leaks=1 halt_on_error=1",
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "sanitize_drive: ok" in r.stdout
    assert "ERROR" not in r.stderr, r.stderr[-3000:]


@pytest.mark.skipif(shutil.which("g++") is None, reason="no compiler")
def test_tsan_no_real_races():
    exe = _build("thread")
    r = subprocess.run([str(exe)], capture_output=True, text=True,
                       timeout=300,
                       env={"TSAN_OPTIONS": "halt_on_error=0",
                            "PATH": "/usr/bin:/bin"})
    assert "sanitize_drive: ok" in r.stdout, r.stderr[-3000:]
    real = []
    for rep in r.stderr.split("=================="):
        if "WARNING: ThreadSanitizer" not in rep:
            continue
        kind = re.search(r"(Read|Write|Atomic read|Atomic write) of size",
                         rep)
        benign = (kind is not None and kind.group(1) == "Read"
                  and "Location is stack of main thread" in rep)
        if not benign:
            real.append(rep[:1500])
    assert not real, "\n================\n".join(real)
