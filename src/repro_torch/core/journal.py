"""Append-only JSONL journal for the scheduler control plane.

One record per line, appended and flushed before the action it describes
is applied (write-ahead for *inputs*: submissions, cancellations, advance
requests) or immediately after the substrate reports it (write-behind for
*transition events*).  Because the whole simulation stack is
deterministic, this split is exactly a redo log: replaying the input
records through a fresh backend regenerates every transition event, and
the journaled transitions double as a checksum of the replay
(``SchedulerService.recover`` verifies the journaled events are a prefix
of the regenerated stream before trusting the rebuilt state).

Durability model: every ``append`` flushes to the OS, so a SIGKILL of the
daemon loses at most the record being written — ``read`` tolerates ONE
trailing partial line (a torn final write) and drops it.  A malformed
record anywhere *before* the tail means real corruption and raises
``JournalError``.  ``fsync=True`` additionally fsyncs per record for
whole-machine-crash durability, at a large cost per append.

Record kinds (the ``"k"`` field):

  hdr — journal header: format version, backend label, admission config.
  snap — compaction marker (immediately after ``hdr``): ``n`` transition
        events have been folded away; ``sha`` is the chained hash over
        them (see ``chain_hash``).  Replay regenerates those events from
        the inputs and verifies the chain instead of comparing records.
  sub — a submit attempt: ``t, name, app, ok, reason`` (write-ahead).
  cxl — a cancel attempt: ``name, ok`` (write-ahead).
  adv — an advance request: ``until`` (float, or None = drain) (write-ahead).
  evt — one lifecycle transition from the event substrate:
        ``e`` in {queued, launch, done, ckpt, requeue, migrate, fail,
        retry, lost}, plus ``t, job, node, g, end, f`` (write-behind).

Version history: v1 journaled transitions without the DVFS frequency
level; v2 adds the ``f`` field to ``evt`` records so crash recovery
replays chosen (count, frequency) actions bit-identically; v3 adds the
fault-plane transition kinds (``fail``/``retry``/``lost``) and ``snap``
compaction records.

Twin of ``repro.core.journal``, byte for byte in what it writes: the
file format (version, canonical JSON, record kinds, chained hash) is the
contract between the two packages, so a journal written by either
recovers in the other (tests/test_torch_service.py).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

JOURNAL_VERSION = 3


def _canon(rec: Dict) -> str:
    """The canonical serialization every journal byte goes through."""
    return json.dumps(rec, separators=(",", ":"), sort_keys=True)


def chain_hash(records: List[Dict], prev: str = "") -> str:
    """Chained sha256 over canonical record serializations:
    ``h_i = sha256(h_{i-1} + canon(rec_i))``, seeded by ``prev`` (empty
    for a chain starting at the journal's origin).  Sequential chaining
    makes compaction associative: a second snapshot continues the first
    snapshot's chain over the events journaled since, and the result is
    identical to one chain over the full event stream."""
    h = prev
    for rec in records:
        h = hashlib.sha256((h + _canon(rec)).encode()).hexdigest()
    return h


class JournalError(RuntimeError):
    """The journal is corrupt (malformed record before the tail) or
    inconsistent with the backend that is replaying it."""


class Journal:
    """Append-only JSONL writer.  One instance owns the file handle for
    the daemon's lifetime; ``read`` is a static method so recovery can
    inspect a journal before deciding to open it for append."""

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._f = open(path, "a", encoding="utf-8")

    def append(self, rec: Dict) -> None:
        self._f.write(_canon(rec))
        self._f.write("\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def snapshot(self) -> int:
        """Compact the journal in place: fold every ``evt`` record into a
        ``snap`` marker (count + chained hash), keeping the header and all
        input records verbatim.  Replay still regenerates the folded
        events deterministically from the inputs; the chain lets recovery
        verify them without storing them.  Crash-safe: the compacted file
        is written beside the journal, fsynced, and atomically renamed
        over it — a kill at any point leaves either the old or the new
        journal, never a mix.  Returns the number of events folded."""
        self.close()
        records = Journal.read(self.path)
        if not records or records[0].get("k") != "hdr":
            raise JournalError(f"{self.path}: cannot snapshot without a header")
        hdr, body = records[0], records[1:]
        prev_n, prev_sha = 0, ""
        if body and body[0].get("k") == "snap":
            prev_n = int(body[0]["n"])
            prev_sha = str(body[0]["sha"])
            body = body[1:]
        evts = [r for r in body if r.get("k") == "evt"]
        keep = [r for r in body if r.get("k") != "evt"]
        snap = {
            "k": "snap",
            "n": prev_n + len(evts),
            "sha": chain_hash(evts, prev_sha),
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in [hdr, snap] + keep:
                f.write(_canon(rec))
                f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        return len(evts)

    def size(self) -> int:
        """Current journal size in bytes.  ``append`` flushes every
        record, so the on-disk size is exact — this is what the service's
        size-triggered auto-compaction polls."""
        return os.path.getsize(self.path)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None

    @staticmethod
    def repair(path: str, records: List[Dict]) -> None:
        """Make the file end exactly after the last complete record in
        ``records`` (as returned by ``read``).  ``append`` serialization
        is canonical (sorted keys, fixed separators), so the byte length
        of the valid prefix is recomputable; a torn tail is truncated
        away and a lost final newline is restored — without this,
        reopening for append would write into the middle of the partial
        line and corrupt the journal."""
        want = sum(
            len(json.dumps(r, separators=(",", ":"), sort_keys=True).encode())
            + 1
            for r in records
        )
        size = os.path.getsize(path)
        if size > want:
            os.truncate(path, want)
        elif size == want - 1:  # the final newline itself was torn off
            with open(path, "a", encoding="utf-8") as f:
                f.write("\n")

    @staticmethod
    def read(path: str) -> List[Dict]:
        """Parse every complete record.  A torn *final* line (no trailing
        newline, or trailing garbage that fails to parse) is dropped —
        that is the expected signature of a crash mid-append.  Anything
        malformed earlier raises ``JournalError``."""
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
        out: List[Dict] = []
        lines = raw.split("\n")
        # a well-formed journal ends with "\n", so the final split element
        # is ""; anything else is a torn tail and may only be dropped if
        # it is genuinely the last line
        complete, tail = lines[:-1], lines[-1]
        for i, line in enumerate(complete):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError as exc:
                if i == len(complete) - 1 and not tail:
                    break  # torn write that still got its newline out
                raise JournalError(
                    f"{path}: malformed record on line {i + 1}: {line[:80]!r}"
                ) from exc
            if not isinstance(rec, dict) or "k" not in rec:
                raise JournalError(
                    f"{path}: record on line {i + 1} is not a journal record"
                )
            out.append(rec)
        if tail:
            try:
                rec = json.loads(tail)
                if isinstance(rec, dict) and "k" in rec:
                    out.append(rec)  # complete record, newline lost
            except ValueError:
                pass  # torn tail: drop it
        return out
