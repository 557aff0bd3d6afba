"""Native runtime components (C++).

The reference ships native code at the task boundary — the Go
bootstrap binary prepended to every task command (sdk/bootstrap/
main.go) — while the scheduler logic stays managed.  Same split here:
the ``task_exec`` C++ supervisor owns per-task process lifecycle
(sessions, output capture, grace-kill escalation, durable pid/exit
records), and the Python agent orchestrates it.

``task_exec_path()`` builds the binary on first use with the system
g++ and caches it next to the source; environments without a
toolchain fall back to pure-Python supervision transparently.

Port of ``dcos_commons_tpu/native/__init__.py`` and a copy of its
``task_exec.cc``.  One difference: the build writes a temporary name
of its own process (``task_exec.tmp.<pid>``) and renames it into
place, so two processes that build at once (test workers) never write
one file; the reference writes ``task_exec.tmp`` for all of them.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import threading

LOG = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "task_exec.cc")
_BIN = os.path.join(_DIR, "bin", "task_exec")
_lock = threading.Lock()
_failed = False


def task_exec_path() -> str:
    """Path to the built supervisor binary, or '' when unavailable.

    Build is attempted once per process; failures (no g++, readonly
    install) disable the native path for the rest of the process.
    """
    global _failed
    if _failed:
        return ""
    if os.path.exists(_BIN) and os.path.getmtime(_BIN) >= os.path.getmtime(
        _SRC
    ):
        return _BIN
    with _lock:
        if _failed:
            return ""
        if os.path.exists(_BIN) and os.path.getmtime(
            _BIN
        ) >= os.path.getmtime(_SRC):
            return _BIN
        gxx = shutil.which("g++") or shutil.which("c++")
        if gxx is None:
            LOG.info("no C++ toolchain: using pure-Python task supervision")
            _failed = True
            return ""
        os.makedirs(os.path.dirname(_BIN), exist_ok=True)
        tmp = f"{_BIN}.tmp.{os.getpid()}"
        try:
            subprocess.run(
                [gxx, "-O2", "-std=c++17", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, _BIN)
        except (subprocess.SubprocessError, OSError) as e:
            LOG.warning("task_exec build failed (%s): using pure Python", e)
            _failed = True
            return ""
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return _BIN
