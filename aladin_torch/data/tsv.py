"""Random-access TSV reader with a byte-offset sidecar.

Equivalent capability to the reference's TSVFile (ref:oscar/utils/tsv_file.py):
a ``.lineidx`` sidecar of line byte offsets enables O(1) row seeks into the
multi-GB features TSV; the file handle is lazily opened and re-opened when
the process id changes (fork-safety for loader workers, ref:tsv_file.py:77-85).

A copy of aladin_tpu/data/tsv.py; the port decodes rows in pure Python
(the native C++ reader is not ported yet).
"""

from __future__ import annotations

import base64
import os
import threading
from typing import List, Optional

import numpy as np


class TSVFile:
    def __init__(self, tsv_file: str, generate_lineidx: bool = True):
        self.tsv_file = tsv_file
        self.lineidx_file = os.path.splitext(tsv_file)[0] + ".lineidx"
        self._tls = threading.local()
        self._all_fps: List = []  # every handle opened, across threads
        self._fps_lock = threading.Lock()
        self._gen = 0  # bumped by close(): other threads must reopen
        self._lineidx: Optional[List[int]] = None
        if not os.path.isfile(self.lineidx_file) and generate_lineidx:
            self._generate_lineidx()

    def _generate_lineidx(self) -> None:
        offsets = []
        with open(self.tsv_file, "rb") as f:
            pos = 0
            for line in f:
                offsets.append(pos)
                pos += len(line)
        with open(self.lineidx_file, "w") as f:
            f.write("\n".join(str(o) for o in offsets) + "\n")

    def _ensure_open(self):
        """Per-thread AND per-process file handle: seek+readline share a file
        position, so the handle must never be shared across loader threads
        (thread pool) or forked workers (the reference's pid-reopen guard,
        ref:tsv_file.py:77-85; the surviving thread of a fork keeps its
        thread-local entry, hence the explicit pid check)."""
        fp = getattr(self._tls, "fp", None)
        if (fp is None or getattr(self._tls, "pid", None) != os.getpid()
                or getattr(self._tls, "gen", -1) != self._gen):
            fp = self._tls.fp = open(self.tsv_file, "rb")
            self._tls.pid = os.getpid()
            self._tls.gen = self._gen
            with self._fps_lock:
                self._all_fps.append(fp)
        return fp

    def _ensure_lineidx(self) -> None:
        if self._lineidx is None:
            with open(self.lineidx_file, "r") as f:
                self._lineidx = [int(l.strip()) for l in f if l.strip()]

    def num_rows(self) -> int:
        self._ensure_lineidx()
        return len(self._lineidx)

    def seek(self, idx: int) -> List[str]:
        self._ensure_lineidx()
        # a concurrent close() may invalidate the handle between
        # _ensure_open and the read (the generation bump is only seen at
        # _ensure_open time); retry on the resulting ValueError so pool
        # threads reopen instead of crashing (ADVICE r2 #3)
        for _ in range(3):
            fp = self._ensure_open()
            try:
                fp.seek(self._lineidx[idx])
                return fp.readline().decode("utf-8").rstrip("\n").split("\t")
            except ValueError:
                self._tls.fp = None  # stale: force reopen on retry
        fp = self._ensure_open()
        fp.seek(self._lineidx[idx])
        return fp.readline().decode("utf-8").rstrip("\n").split("\t")

    def close(self) -> None:
        """Close EVERY handle this instance opened — loader pool threads
        open their own via _ensure_open, and closing only the calling
        thread's would leak the rest (inherited as open fds by forks)."""
        with self._fps_lock:
            fps, self._all_fps = self._all_fps, []
            self._gen += 1  # stale thread-local handles must reopen
        for fp in fps:
            try:
                fp.close()
            except Exception:
                pass
        self._tls.fp = None

    def __len__(self) -> int:
        return self.num_rows()


def decode_region_features(b64: str, num_boxes: int, feat_dim: int = -1) -> np.ndarray:
    """base64 blob -> (num_boxes, feat_dim) float32 region features
    (ref:alad/dataset.py:317-324 semantics)."""
    buf = base64.b64decode(b64)
    arr = np.frombuffer(buf, dtype=np.float32)
    return arr.reshape((num_boxes, -1)) if feat_dim < 0 else arr.reshape((num_boxes, feat_dim))


def write_tsv(path: str, rows) -> None:
    """TSV writer with lineidx generation (ref:oscar/utils/tsv_file_ops.py:12-24
    capability; used by tests/tools to build fixtures)."""
    lineidx = os.path.splitext(path)[0] + ".lineidx"
    with open(path, "w", encoding="utf-8") as f, open(lineidx, "w") as fi:
        pos = 0
        for row in rows:
            line = "\t".join(str(c) for c in row) + "\n"
            f.write(line)
            fi.write(f"{pos}\n")
            pos += len(line.encode("utf-8"))
