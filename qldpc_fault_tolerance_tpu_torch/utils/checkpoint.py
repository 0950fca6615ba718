"""Shard-level sweep checkpointing with mid-cell resume records.

The reference restarts killed sweeps from scratch (SURVEY §5: "checkpoint /
resume: none").  Here each (code, noise model, p, cycles) cell's outcome is
appended to a JSONL file as soon as it finishes; re-running the same sweep
skips completed cells.  Cells are keyed by their physical parameters, so a
resumed sweep may change batch sizes or ordering freely.

v2 adds **mid-cell progress records**: the megabatch engines periodically
persist ``(batches_done, failures, min_w, ...)`` plus a run fingerprint
while a cell is running, so a killed run resumes INSIDE the cell — the
remaining megabatches replay the same fold-in key stream from the recorded
cursor and the result is seed-for-seed identical to an uninterrupted run
(tests/test_resilience.py).  A finished cell's ``put`` supersedes its
progress records.

Loading is crash-tolerant: a truncated / corrupt line (the tail a kill
mid-append leaves behind) is skipped with a warning and a
``ckpt.corrupt_lines`` telemetry counter instead of raising
``json.JSONDecodeError`` and bricking the resume.

This is the JAX package's module, jax-free there too, kept as the port's
own copy; its telemetry and diagnostics are the port's
(``utils.telemetry``, ``utils.diagnostics``).  Fault injection (the JAX
package's ``sweep_ckpt_put`` site and its ``truncate`` fault) is not in the
port yet: appends here never fail on purpose.
"""
from __future__ import annotations

import json
import os
import warnings

__all__ = ["SweepCheckpoint", "CellProgress"]


def _canon(value):
    if isinstance(value, float):
        return round(value, 12)
    return value


class SweepCheckpoint:
    """Append-only JSONL store of finished sweep cells + in-cell progress.

    >>> ckpt = SweepCheckpoint("sweep.jsonl")
    >>> key = dict(code="hgp_34_n625", noise="phenl", p=0.01, cycles=5)
    >>> if (rec := ckpt.get(key)) is None:
    ...     rec = {"wer": run_the_cell()}
    ...     ckpt.put(key, rec)
    """

    def __init__(self, path: str):
        self.path = path
        # a fresh service/sweep host hands a path whose directory doesn't
        # exist yet; creating it here (not at first append) means the
        # cold-start failure surfaces at construction, where it's
        # actionable, instead of killing the first cell's put
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._cells: dict[str, dict] = {}
        self._progress: dict[str, dict] = {}
        # a crash mid-append can leave the file without a trailing newline;
        # appending straight after it would corrupt the NEXT record too, so
        # the first append after loading such a file starts on a fresh line
        self._needs_newline = False
        if os.path.exists(path):
            self._load(path)

    def _load(self, path: str) -> None:
        from . import telemetry

        raw_tail = b""
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() > 0:
                f.seek(-1, os.SEEK_END)
                raw_tail = f.read(1)
        self._needs_newline = raw_tail not in (b"", b"\n")
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                    ks = self._key_str(entry["key"])
                    if "record" in entry:
                        self._cells[ks] = entry["record"]
                        self._progress.pop(ks, None)
                    elif "progress" in entry:
                        self._progress[ks] = entry["progress"]
                    else:
                        raise KeyError("record")
                except (json.JSONDecodeError, KeyError, TypeError) as e:
                    # crash mid-append leaves a torn tail; losing ONE cell
                    # (it reruns) beats bricking the whole resume
                    warnings.warn(
                        f"{path}:{lineno}: skipping corrupt checkpoint line "
                        f"({type(e).__name__}: {e}) — the cell it recorded "
                        "will rerun", stacklevel=3)
                    telemetry.count("ckpt.corrupt_lines")

    @staticmethod
    def _key_str(key: dict) -> str:
        return json.dumps(
            {k: _canon(v) for k, v in key.items()}, sort_keys=True
        )

    def _append(self, obj: dict) -> None:
        """Atomic append + fsync."""
        line = json.dumps(obj) + "\n"
        if self._needs_newline:
            line = "\n" + line
        # pessimistic until the full line lands: a write that dies partway
        # leaves a torn tail, and the NEXT append from this process must
        # start on a fresh line or it would corrupt its own record too
        self._needs_newline = True
        with open(self.path, "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        self._needs_newline = False

    def get(self, key: dict):
        """Record for a finished cell, or None (progress records are NOT
        finished cells)."""
        return self._cells.get(self._key_str(key))

    def put(self, key: dict, record: dict) -> None:
        """Persist a finished cell; supersedes any progress records."""
        ks = self._key_str(key)
        self._cells[ks] = record
        self._progress.pop(ks, None)
        self._append({"key": json.loads(ks), "record": record})

    def get_progress(self, key: dict):
        """Latest in-cell progress for an UNFINISHED cell, or None."""
        ks = self._key_str(key)
        if ks in self._cells:
            return None
        return self._progress.get(ks)

    def put_progress(self, key: dict, progress: dict) -> None:
        """Persist mid-cell progress (append-only; the latest line wins on
        reload, and a subsequent ``put`` supersedes them all)."""
        ks = self._key_str(key)
        self._progress[ks] = progress
        self._append({"key": json.loads(ks), "progress": progress})

    def __len__(self) -> int:
        return len(self._cells)

    def __contains__(self, key: dict) -> bool:
        return self._key_str(key) in self._cells


class CellProgress:
    """Binding of one sweep cell to its checkpoint for mid-cell resume.

    The engine calls ``load(fingerprint)`` before the run — a stored cursor
    is honored only when the fingerprint (batch layout + PRNG key stream)
    matches, because resuming under a different stream would silently
    change the estimate — and ``save(...)`` every ``every``-th megabatch
    drain.  ``every`` trades re-done work on a crash against fsync traffic
    (each save is one appended JSONL line)."""

    def __init__(self, checkpoint: SweepCheckpoint, key: dict,
                 every: int = 1):
        self.checkpoint = checkpoint
        self.key = dict(key)
        self.every = max(1, int(every))
        self._saves = 0

    def load(self, fingerprint: dict):
        """State dict to resume from, or None (no progress / stale
        fingerprint)."""
        from . import telemetry

        state = self.checkpoint.get_progress(self.key)
        if state is None:
            return None
        if state.get("fingerprint") != fingerprint:
            warnings.warn(
                "mid-cell progress found but its run fingerprint does not "
                "match (different batch size / chunk / key); restarting the "
                "cell from zero", stacklevel=2)
            telemetry.count("ckpt.stale_progress")
            return None
        telemetry.count("resilience.resumes")
        telemetry.event("cell_resume", key=self.key,
                        batches_done=int(state.get("batches_done", 0)))
        return state

    def save(self, fingerprint: dict, batches_done: int, failures: int,
             min_w: int, tele=None, extra: dict | None = None) -> None:
        """``extra``: additional JSON-safe state merged into the cursor —
        the weighted (importance-sampled) streams persist their float
        weight moments here (``{"weighted": {s1, s2, w1, w2}}``); loaders
        that don't know the keys ignore them, exactly like the additive
        diagnostics block below."""
        self._saves += 1
        if (self._saves - 1) % self.every:
            return
        state = {
            "v": 2, "fingerprint": fingerprint,
            "batches_done": int(batches_done), "failures": int(failures),
            "min_w": int(min_w),
        }
        if tele is not None:
            state["tele"] = [int(x) for x in tele]
        if extra:
            state.update(extra)
        # statistical observability: the cursor carries its Wilson interval
        # (shots reconstructed from the fingerprint's batch layout) so a
        # tail -f of the checkpoint shows estimator health mid-cell; purely
        # additive — the resume loader ignores the extra keys
        from . import diagnostics

        if diagnostics.active():
            shots = int(batches_done) * int(fingerprint.get("batch_size", 0)
                                            or 0)
            if shots:
                state.update(diagnostics.ci_fields(failures, shots))
        self.checkpoint.put_progress(self.key, state)

    def save_cells(self, fingerprint, batches_done, failures, shots, min_w,
                   cursors=None, tele=None, extra: dict | None = None
                   ) -> None:
        """Vector twin of ``save`` for cell-FUSED runs: one progress record
        carries the whole bucket's per-cell counters.  ``batches_done`` is
        the uniform cursor of the fixed-budget fused stream; adaptive runs
        additionally persist per-cell ``cursors`` (cells advance at
        different rates once lanes reallocate).  Same ``every`` throttling,
        fingerprint and ``extra`` rules as the scalar record (weighted
        fused buckets persist per-cell weight-moment lists there)."""
        self._saves += 1
        if (self._saves - 1) % self.every:
            return
        state = {
            "v": 2, "fused": True, "fingerprint": fingerprint,
            "batches_done": int(batches_done),
            "failures": [int(x) for x in failures],
            "shots": [int(x) for x in shots],
            "min_w": [int(x) for x in min_w],
        }
        if cursors is not None:
            state["cursors"] = [int(x) for x in cursors]
        if tele is not None:
            state["tele"] = [int(x) for x in tele]
        if extra:
            state.update(extra)
        # per-cell Wilson intervals on the fused cursor (counts are right
        # here; additive keys the resume loader ignores)
        from . import diagnostics

        if diagnostics.active() and any(int(s) for s in state["shots"]):
            state.update(diagnostics.ci_arrays(state["failures"],
                                               state["shots"]))
        self.checkpoint.put_progress(self.key, state)
