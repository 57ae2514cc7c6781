"""Streaming CSV export of estimates with ±Nσ bounds.

JAX rebuild of the reference exporter (reference: exporter.go:12-96).
The device side stays pure: filters return stacked estimate pytrees;
this module is the host boundary that drains them to CSV.  Headers
prefixed with `_` are written without covariance-bound columns
(exporter.go:74-76); files carry creation/closing timestamps
(exporter.go:26, 88).
"""

from __future__ import annotations

import datetime
import math
import os


class CSVExporter:
    """Per-estimate CSV writer (reference: exporter.go:18-57)."""

    def __init__(self, headers, filepath, filename, covar_bound: float = 2.0):
        self.covar_bound = covar_bound
        self.delimiter = ","
        self._bounded = [not h.startswith("_") for h in headers]
        self._fh = open(os.path.join(filepath, filename), "w")
        cols = []
        bhdr = f"{covar_bound:.0f}s"
        for h, bounded in zip(headers, self._bounded):
            if bounded:
                cols += [h, f"{h}+{bhdr}", f"{h}-{bhdr}"]
            else:
                cols.append(h[1:])
        now = datetime.datetime.now(datetime.timezone.utc)
        self._fh.write(f"# Creation date (UTC): {now}\n")
        self._fh.write(self.delimiter.join(cols) + "\n")

    def write(self, est) -> None:
        """Write one estimate row: value, +Nσ, -Nσ per state component
        (σ from the covariance diagonal, exporter.go:34-45); components
        whose header was `_`-prefixed get the value only, keeping rows
        aligned with the header (the Go reference's Write always emits
        three columns and silently misaligns such files)."""
        import numpy as np

        state = np.asarray(est.state).reshape(-1)
        covar = np.asarray(est.covariance)
        vals = []
        for i in range(state.shape[0]):
            vals.append(f"{state[i]:f}")
            if i >= len(self._bounded) or self._bounded[i]:
                bound = self.covar_bound * math.sqrt(max(covar[i, i], 0.0))
                vals += [f"{bound:f}", f"{-bound:f}"]
        self._fh.write(self.delimiter.join(vals) + "\n")

    def _trace_matrix(self, ests):
        """[T, out_cols] float64 matrix of (value, +Nσ, -Nσ) columns."""
        import numpy as np

        states = np.asarray(ests.state)
        covars = np.asarray(ests.covariance)
        cols = []
        for i in range(states.shape[1]):
            cols.append(states[:, i])
            if i >= len(self._bounded) or self._bounded[i]:
                bound = self.covar_bound * np.sqrt(
                    np.maximum(covars[:, i, i], 0.0)
                )
                cols += [bound, -bound]
        return np.stack(cols, axis=1)

    def write_all(self, ests) -> None:
        """Drain a stacked [T, ...] estimate pytree in one host transfer.

        Uses the native C++ formatter (gokalman_tpu.native.fastcsv,
        printf-"%f"-compatible so output is byte-identical) when
        available; Python string formatting otherwise."""
        matrix = self._trace_matrix(ests)
        from . import native

        text = native.format_csv(matrix)
        if text is not None:
            self._fh.write(text)
            return
        rows = []
        for k in range(matrix.shape[0]):
            rows.append(self.delimiter.join(f"{v:f}" for v in matrix[k]))
        self._fh.write("\n".join(rows) + "\n")

    def write_raw(self, s: str) -> None:
        self._fh.write(s)

    def write_raw_ln(self, s: str) -> None:
        self._fh.write(s + "\n")

    def close(self) -> None:
        now = datetime.datetime.now(datetime.timezone.utc)
        self.write_raw_ln(f"# Closing date (UTC): {now}\n")
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def new_csv_exporter(headers, filepath, filename):
    """Default 2σ bounds (reference: exporter.go:94-96)."""
    return CSVExporter(headers, filepath, filename, covar_bound=2.0)


class AsyncCSVExporter(CSVExporter):
    """Streaming estimate sink with a background writer thread.

    The reference streams each Estimate into a Go channel drained by a
    CSV-writing goroutine so filtering never blocks on I/O
    (examples/jerkcar/main.go:71-91, README.md:10-24).  This is the
    same pipeline without shared mutable state: `write`/`write_all`
    convert estimates to host arrays and enqueue; the writer thread
    formats (through the native C++ formatter when available — the
    ctypes call releases the GIL, so formatting genuinely overlaps
    device compute) and writes.  Output bytes are identical to the
    synchronous CSVExporter.  `close()` drains the queue, joins the
    thread, and re-raises any writer-side exception.
    """

    def __init__(self, headers, filepath, filename, covar_bound: float = 2.0,
                 max_queue: int = 64):
        import queue
        import threading

        super().__init__(headers, filepath, filename, covar_bound)
        self._q = queue.Queue(maxsize=max_queue)
        self._err = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        from . import native

        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                if isinstance(item, str):
                    # Raw text routed through the queue so it lands in
                    # submission order relative to estimate rows.
                    self._fh.write(item)
                    continue
                text = native.format_csv(item)
                if text is None:
                    text = "\n".join(
                        self.delimiter.join(f"{v:f}" for v in row)
                        for row in item
                    ) + "\n"
                self._fh.write(text)
            except Exception as e:  # surfaced on close()
                self._err = e
                return
            finally:
                self._q.task_done()

    def _put(self, item):
        import queue

        try:
            self._q.put(item, timeout=60)
        except queue.Full:
            # A dead writer leaves producers blocked: surface ITS error
            # rather than an opaque queue.Full.  If the writer is alive
            # but merely backed up (slow disk + small max_queue), say
            # so explicitly — a bare queue.Full is indistinguishable
            # from writer death.
            self._check()
            raise RuntimeError(
                "AsyncCSVExporter writer thread is alive but the queue "
                "stayed full for 60s — output device too slow for this "
                "max_queue; raise max_queue or use the sync CSVExporter"
            ) from None

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if not self._thread.is_alive():
            raise RuntimeError("AsyncCSVExporter is closed")

    def write(self, est) -> None:
        import types

        import numpy as np

        self._check()
        stacked = types.SimpleNamespace(
            state=np.asarray(est.state)[None],
            covariance=np.asarray(est.covariance)[None],
        )
        self._put(self._trace_matrix(stacked))

    def write_all(self, ests) -> None:
        self._check()
        self._put(self._trace_matrix(ests))

    def write_raw(self, s: str) -> None:
        """Raw text through the writer queue (NOT directly to the file
        handle): preserves ordering relative to queued estimate rows
        and avoids interleaving with the writer thread."""
        self._check()
        self._put(s)

    def write_raw_ln(self, s: str) -> None:
        self.write_raw(s + "\n")

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        if self._err is not None:
            err, self._err = self._err, None
            self._fh.close()
            raise err
        # Writer thread is down: write the closing stamp directly
        # (routing through write_raw would hit the closed-queue check).
        now = datetime.datetime.now(datetime.timezone.utc)
        self._fh.write(f"# Closing date (UTC): {now}\n\n")
        self._fh.close()


def read_csv(path):
    """Read a CSV written by CSVExporter (or any comment-prefixed
    numeric CSV): returns (headers, data [rows, cols] float array).

    The reference's examples consume pre-recorded CSV inputs
    (examples/jerkcar reads measurement files); this is the matching
    ingest utility — `#` comment lines are skipped, the first
    non-comment line is the header.
    """
    import numpy as np

    headers = None
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if headers is None:
                headers = line.split(",")
                continue
            rows.append([float(v) for v in line.split(",")])
    return headers, np.asarray(rows)
