"""Write-ahead request journal for the fleet front end — the JAX
package's ``repro.serve.journal`` on the port (pure Python: records written
by either package load and replay in the other, byte for byte).

Every externally-visible state change of a fleet request is appended to
the journal BEFORE it takes effect (write-ahead), so a crash of the
front-end itself — or a post-mortem of a replica failure — can
reconstruct exactly what every client was promised and what it received.
Record kinds (one JSON object per record; ``t`` is the fleet clock):

``submit``     {rid, prompt_len, max_new, t [, prompt]} — client accepted.
``placement``  {rid, replica, engine_rid, attempt, reason, resume_base, t}
               — the request was offered to a replica. ``attempt`` counts
               placements (0 = first); ``reason`` is "submit" for the
               first, then "crash"/"hang" (failover), "retry" (backoff
               after a shed/full fleet), or "restore" (cross-process
               resume); ``resume_base`` is how many tokens had already
               streamed when the recompute prompt ``[prompt ‖
               tokens-so-far]`` was built.
``token``      {rid, replica, pos, toks, t} — ``toks`` streamed to the
               client; ``pos`` is the stream position of toks[0]
               (contiguity is validated by replay()).
``terminal``   {rid, reason, n_tokens, t} — the typed terminal result.
``replica``    {replica, event: crash|hang|resume, tick, t} — fleet
               health transitions (forensics; not part of request state).
``snapshot``   {digest, t [, ...]} — durability anchor: the full replay
               fold at this point, embedded.  Replay from the last anchor
               is equivalent to replay from the start (``compact()``
               exploits this to bound journal growth); a mid-stream
               anchor whose digest disagrees with the running fold is a
               corruption signal.

``replay()`` folds the records back into per-request terminal state and
is the crash-consistency gate: the fleet bench asserts that the replayed
tokens and terminal reasons equal the live tracker's, byte for byte.

Durability: every record carries a monotone ``seq`` and a ``crc`` (CRC32
of the record minus the crc field, canonical JSON).  ``load(...,
strict=False)`` recovers the valid prefix of a crash-torn file — a
truncated final line, trailing garbage, or a duplicated tail drops only
the bad suffix, counted in ``tail_lost``/``dups_dropped`` rather than
poisoning replay.  The ``fsync`` policy ("none" | "interval" | "always")
trades tail-loss window against write amplification; "interval" (the
default) flushes per record and fsyncs every ``fsync_every`` records.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from typing import Callable, Dict, List, Optional

RECORD_KINDS = ("submit", "placement", "token", "terminal", "replica",
                "snapshot")
FSYNC_POLICIES = ("none", "interval", "always")


class JournalCorrupt(RuntimeError):
    """replay() found records that cannot describe any real execution
    (unknown kind, token stream with a gap, terminal/token mismatch), or
    strict load found a record failing its CRC/sequence check."""


def record_crc(body: Dict) -> int:
    """CRC32 of a record's canonical JSON (sans the ``crc`` field itself).
    Canonical = sorted keys, no whitespace — stable across a JSON
    round-trip, so recomputing on a parsed record matches the original."""
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(blob.encode("utf-8")) & 0xFFFFFFFF


@dataclasses.dataclass
class ReplayedRequest:
    """One request's state as reconstructed from the journal."""

    rid: int
    prompt_len: int = 0
    max_new: int = 0
    prompt: Optional[List[int]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: str = ""              # "" = still in flight at the
    #                                      journal's horizon
    placements: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def n_failovers(self) -> int:
        return sum(1 for p in self.placements
                   if p["reason"] in ("crash", "hang"))


@dataclasses.dataclass
class ReplayState:
    """The fold of a journal: request states + replica event history."""

    requests: Dict[int, ReplayedRequest] = dataclasses.field(
        default_factory=dict)
    replica_events: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def terminal(self) -> Dict[int, ReplayedRequest]:
        return {rid: r for rid, r in self.requests.items()
                if r.finish_reason}


def state_digest(st: ReplayState) -> Dict:
    """JSON-compatible embedding of a ReplayState for anchor records."""
    return {
        "requests": {
            str(rid): {
                "prompt_len": r.prompt_len,
                "max_new": r.max_new,
                "prompt": r.prompt,
                "tokens": list(r.tokens),
                "finish_reason": r.finish_reason,
                "placements": list(r.placements),
            }
            for rid, r in st.requests.items()
        },
        "replica_events": list(st.replica_events),
    }


def _seed_state(digest: Dict) -> ReplayState:
    st = ReplayState()
    for rid, rec in digest.get("requests", {}).items():
        st.requests[int(rid)] = ReplayedRequest(
            rid=int(rid),
            prompt_len=rec["prompt_len"],
            max_new=rec["max_new"],
            prompt=rec.get("prompt"),
            tokens=list(rec["tokens"]),
            finish_reason=rec["finish_reason"],
            placements=list(rec["placements"]),
        )
    st.replica_events = list(digest.get("replica_events", []))
    return st


def _digests_equal(a: Dict, b: Dict) -> bool:
    return (json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True))


class Journal:
    """Append-only journal with an in-memory record list and an optional
    JSONL file sink. ``append`` is called by the supervisor/tracker
    BEFORE the recorded action takes effect."""

    def __init__(self, path: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 log_prompts: bool = True,
                 fsync: str = "interval",
                 fsync_every: int = 16):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"unknown fsync policy {fsync!r}; "
                             f"expected one of {FSYNC_POLICIES}")
        self.path = path
        self.clock = clock or time.monotonic
        self.log_prompts = log_prompts
        self.fsync = fsync
        self.fsync_every = max(1, int(fsync_every))
        self.records: List[Dict] = []
        self.tail_lost = 0        # records dropped by non-strict load
        self.dups_dropped = 0     # duplicate-seq records dropped by load
        self._since_fsync = 0
        self._sink = open(path, "w") if path else None

    def append(self, kind: str, **fields) -> Dict:
        if kind not in RECORD_KINDS:
            raise ValueError(f"unknown journal record kind {kind!r}; "
                             f"expected one of {RECORD_KINDS}")
        rec = dict(kind=kind, t=round(self.clock(), 6),
                   seq=len(self.records), **fields)
        rec["crc"] = record_crc(rec)
        self.records.append(rec)
        if self._sink is not None:
            self._sink.write(json.dumps(rec) + "\n")
            if self.fsync == "always":
                self._sink.flush()
                os.fsync(self._sink.fileno())
            elif self.fsync == "interval":
                self._sink.flush()
                self._since_fsync += 1
                if self._since_fsync >= self.fsync_every:
                    os.fsync(self._sink.fileno())
                    self._since_fsync = 0
            # "none": leave it to stdio buffering — fastest, widest
            # tail-loss window; a crash loses everything unflushed.
        return rec

    def anchor(self, **fields) -> Dict:
        """Append a snapshot-anchor record embedding the current replay
        fold.  Replaying from this record onward reconstructs the same
        state as replaying the whole journal."""
        digest = state_digest(replay(self.records))
        return self.append("snapshot", digest=digest, **fields)

    def compact(self) -> int:
        """Drop every record before the last snapshot anchor (replay cost
        becomes O(suffix)).  Rewrites the file sink in place when one is
        attached.  Returns the number of records dropped; no-op (0) when
        the journal has no anchor."""
        idx = None
        for i in range(len(self.records) - 1, -1, -1):
            if self.records[i].get("kind") == "snapshot":
                idx = i
                break
        if idx is None or idx == 0:
            return 0
        dropped = idx
        self.records = self.records[idx:]
        if self._sink is not None:
            self._sink.close()
            self.save(self.path)
            self._sink = open(self.path, "a")
            self._since_fsync = 0
        return dropped

    def close(self) -> None:
        if self._sink is not None:
            self._sink.flush()
            try:
                os.fsync(self._sink.fileno())
            except OSError:
                pass
            self._sink.close()
            self._sink = None

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    @classmethod
    def load(cls, path: str, strict: bool = True) -> "Journal":
        """Parse a journal file.

        ``strict=True`` (default): any malformed line, CRC failure, or
        non-monotone sequence number raises JournalCorrupt.

        ``strict=False``: valid-prefix recovery for crash-torn files —
        parsing stops at the first bad line and the dropped suffix is
        counted in ``tail_lost``; duplicated records (seq at or below the
        running maximum, e.g. a tail appended twice) are skipped and
        counted in ``dups_dropped``.  CRC/seq checks only apply to
        records that carry those fields, so pre-durability journals and
        hand-built record lists stay loadable — but once a file has
        shown CRC-stamped records, a CRC-less line is corruption (torn
        garbage that happens to parse), not a format downgrade.
        """
        j = cls()
        with open(path) as f:
            lines = f.readlines()
        last_seq: Optional[int] = None
        saw_crc = False
        for i, line in enumerate(lines):
            s = line.strip()
            if not s:
                continue
            try:
                rec = json.loads(s)
                if not isinstance(rec, dict):
                    raise ValueError("record is not a JSON object")
                if "crc" in rec:
                    saw_crc = True
                    body = {k: v for k, v in rec.items() if k != "crc"}
                    if record_crc(body) != rec["crc"]:
                        raise ValueError("record CRC mismatch")
                elif saw_crc:
                    raise ValueError("record missing CRC in a CRC-stamped "
                                     "journal")
            except ValueError as e:
                if strict:
                    raise JournalCorrupt(
                        f"{path}: line {i + 1}: {e}") from None
                j.tail_lost = sum(1 for rest in lines[i:] if rest.strip())
                break
            seq = rec.get("seq")
            if seq is not None and last_seq is not None and seq <= last_seq:
                if strict:
                    raise JournalCorrupt(
                        f"{path}: line {i + 1}: duplicate/out-of-order "
                        f"seq {seq} after {last_seq}")
                j.dups_dropped += 1
                continue
            if seq is not None:
                last_seq = seq
            j.records.append(rec)
        return j

    # -- replay ------------------------------------------------------------

    def replay(self, from_anchor: bool = False) -> ReplayState:
        """Fold the records.  ``from_anchor=True`` replays only from the
        last snapshot anchor (the compaction invariant guarantees the
        same result as a full replay; the bounded-suffix path)."""
        records = self.records
        if from_anchor:
            for i in range(len(records) - 1, -1, -1):
                if records[i].get("kind") == "snapshot":
                    records = records[i:]
                    break
        return replay(records)


def replay(records: List[Dict]) -> ReplayState:
    """Fold journal records into per-request terminal state, validating
    the stream invariants a real execution must satisfy: token positions
    contiguous from 0, no tokens before submit or after terminal, and the
    terminal's ``n_tokens`` equal to the stream length.  A snapshot
    anchor at the head seeds the fold; one mid-stream must agree with the
    running fold (disagreement means the journal and the snapshot
    describe different histories)."""
    st = ReplayState()
    seeded_or_folded = False
    for rec in records:
        kind = rec.get("kind")
        if kind == "submit":
            rid = rec["rid"]
            if rid in st.requests:
                raise JournalCorrupt(f"request {rid} submitted twice")
            st.requests[rid] = ReplayedRequest(
                rid, prompt_len=rec["prompt_len"], max_new=rec["max_new"],
                prompt=rec.get("prompt"))
            seeded_or_folded = True
        elif kind == "placement":
            req = _live(st, rec, "placement")
            req.placements.append({k: rec[k] for k in
                                   ("replica", "engine_rid", "attempt",
                                    "reason", "resume_base")})
        elif kind == "token":
            req = _live(st, rec, "token")
            if rec["pos"] != len(req.tokens):
                raise JournalCorrupt(
                    f"request {req.rid}: token record at pos {rec['pos']} "
                    f"but stream holds {len(req.tokens)} tokens")
            req.tokens.extend(rec["toks"])
        elif kind == "terminal":
            req = _live(st, rec, "terminal")
            if rec["n_tokens"] != len(req.tokens):
                raise JournalCorrupt(
                    f"request {req.rid}: terminal claims "
                    f"{rec['n_tokens']} tokens, stream holds "
                    f"{len(req.tokens)}")
            req.finish_reason = rec["reason"]
        elif kind == "replica":
            st.replica_events.append(rec)
        elif kind == "snapshot":
            digest = rec.get("digest", {})
            if not seeded_or_folded and not st.requests:
                st = _seed_state(digest)
                seeded_or_folded = True
            elif not _digests_equal(digest, state_digest(st)):
                raise JournalCorrupt(
                    "snapshot anchor digest disagrees with the replayed "
                    "state at its position")
        else:
            raise JournalCorrupt(f"unknown record kind {kind!r}")
    return st


def _live(st: ReplayState, rec: Dict, what: str) -> ReplayedRequest:
    rid = rec.get("rid")
    req = st.requests.get(rid)
    if req is None:
        raise JournalCorrupt(f"{what} record for unknown request {rid}")
    if req.finish_reason:
        raise JournalCorrupt(
            f"{what} record for request {rid} after its terminal")
    return req
