"""Crash-consistent snapshots of the full serving state — the JAX
package's ``repro.serve.snapshot`` on the port: the same ``SMXSNAP1``
container, sections and recovery ladder. Arrays travel as CPU torch
tensors; the engine's random state is its ``torch.Generator`` state (field
``gen_state``) where the reference keeps a JAX PRNG key, so the two
packages do not read each other's engine sections.

A snapshot is a single file holding every byte the engine needs to resume
serving exactly where it left off:

- the `PagedKVCache` pools (int8 values + f32 scale siblings when quantized,
  bf16/f32 otherwise), the free list in exact order, refcounts, per-request
  block tables, and pool stats;
- the `RadixCache` tree (node keys, blocks, pins, LRU stamps, insertion
  seqs, per-request publish cursors, eviction clock, cache stats);
- the `Scheduler` queues (waiting / running / finished requests with full
  per-request state incl. `n_prefilled` chunk progress and decode-block
  reservations);
- the `ContinuousEngine` counters, stable decode-row assignment, on-device
  next-token vector, and generator state.

Container format (`SMXSNAP1`):

    SMXSNAP1 <header_len> <header_crc32>\n     magic line
    <header JSON, header_len bytes>            version, meta, section index
    <section 0 payload><section 1 payload>...  raw bytes, concatenated

Each section index entry records ``{name, kind, nbytes, crc32}`` (plus
``dtype``/``shape`` for arrays), so corruption is detected per-section
before any state is rebuilt.  JSON sections are UTF-8; array sections are
C-order raw bytes.  bfloat16 arrays are stored as their 16-bit pattern
(written through ``view(torch.int16)``, read back through
``view(torch.bfloat16)``: no ``ml_dtypes`` needed) with the logical dtype
recorded in the index.

Writes are atomic: payload goes to a same-directory temp file which is
fsync'd then `os.replace`'d over the target, so a crash mid-write leaves
either the old snapshot or none — never a torn one.

Recovery ladder (see `restore_engine`): clean snapshot -> warm start;
checksum or invariant (fsck) failure -> cold start, with terminal streams
recomputed from the journal alone.  Either way recovered greedy streams are
byte-identical to an uninterrupted run because decode is deterministic.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

SNAPSHOT_MAGIC = "SMXSNAP1"
SNAPSHOT_VERSION = 1


class SnapshotCorrupt(RuntimeError):
    """Snapshot failed validation: bad magic, checksum, or incompatible
    engine geometry.  Restore paths catch this and fall back to cold start."""


# ---------------------------------------------------------------------------
# array <-> bytes
# ---------------------------------------------------------------------------

def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A (possibly device) tensor as a C-contiguous CPU tensor of its own
    (a copy, so later in-place writes to the pool never reach it)."""
    return t.detach().to("cpu", copy=True).contiguous()


def _encode_array(t: torch.Tensor) -> Tuple[bytes, str, Tuple[int, ...]]:
    """Raw C-order bytes + logical dtype name + shape of a CPU tensor.

    bfloat16 has no portable numpy representation, so it travels as its
    16-bit pattern; the logical dtype name in the index restores it.
    """
    name = str(t.dtype).replace("torch.", "")
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes(order="C"), name, tuple(t.shape)


def _decode_array(payload: bytes, dtype_name: str, shape) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if dtype_name == "bfloat16":
        raw = np.frombuffer(payload, dtype=np.int16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    raw = np.frombuffer(payload, dtype=np.dtype(dtype_name)).reshape(shape)
    return torch.from_numpy(raw.copy())


# ---------------------------------------------------------------------------
# snapshot object
# ---------------------------------------------------------------------------

@dataclass
class Snapshot:
    """In-memory snapshot: a meta dict plus named sections (JSON-compatible
    dicts or CPU tensors).  `write`/`read` handle the on-disk container."""

    meta: Dict[str, Any]
    sections: Dict[str, Any] = field(default_factory=dict)

    def write(self, path: str) -> Dict[str, Any]:
        index: List[Dict[str, Any]] = []
        payloads: List[bytes] = []
        for name, obj in self.sections.items():
            if isinstance(obj, torch.Tensor):
                payload, dtype_name, shape = _encode_array(obj)
                entry = {
                    "name": name,
                    "kind": "array",
                    "dtype": dtype_name,
                    "shape": list(shape),
                }
            else:
                payload = json.dumps(obj, sort_keys=True).encode("utf-8")
                entry = {"name": name, "kind": "json"}
            entry["nbytes"] = len(payload)
            entry["crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
            index.append(entry)
            payloads.append(payload)

        header = json.dumps(
            {"version": SNAPSHOT_VERSION, "meta": self.meta, "index": index},
            sort_keys=True,
        ).encode("utf-8")
        magic = (
            f"{SNAPSHOT_MAGIC} {len(header)} "
            f"{zlib.crc32(header) & 0xFFFFFFFF}\n"
        ).encode("ascii")

        directory = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".snap.", dir=directory)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(magic)
                f.write(header)
                for payload in payloads:
                    f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic on POSIX
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return {
            "path": path,
            "nbytes": len(magic) + len(header) + sum(len(p) for p in payloads),
            "sections": [e["name"] for e in index],
        }

    @classmethod
    def read(cls, path: str) -> "Snapshot":
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise SnapshotCorrupt(f"cannot read snapshot {path}: {e}") from e

        nl = blob.find(b"\n")
        if nl < 0:
            raise SnapshotCorrupt(f"{path}: no magic line")
        parts = blob[:nl].decode("ascii", errors="replace").split()
        if len(parts) != 3 or parts[0] != SNAPSHOT_MAGIC:
            raise SnapshotCorrupt(f"{path}: bad magic {parts[:1]!r}")
        try:
            header_len, header_crc = int(parts[1]), int(parts[2])
        except ValueError as e:
            raise SnapshotCorrupt(f"{path}: malformed magic line") from e

        header_raw = blob[nl + 1 : nl + 1 + header_len]
        if len(header_raw) != header_len:
            raise SnapshotCorrupt(f"{path}: truncated header")
        if (zlib.crc32(header_raw) & 0xFFFFFFFF) != header_crc:
            raise SnapshotCorrupt(f"{path}: header checksum mismatch")
        header = json.loads(header_raw.decode("utf-8"))
        if header.get("version") != SNAPSHOT_VERSION:
            raise SnapshotCorrupt(
                f"{path}: unsupported snapshot version {header.get('version')}"
            )

        sections: Dict[str, Any] = {}
        off = nl + 1 + header_len
        for entry in header["index"]:
            n = int(entry["nbytes"])
            payload = blob[off : off + n]
            if len(payload) != n:
                raise SnapshotCorrupt(
                    f"{path}: truncated section {entry['name']!r}"
                )
            if (zlib.crc32(payload) & 0xFFFFFFFF) != int(entry["crc32"]):
                raise SnapshotCorrupt(
                    f"{path}: checksum mismatch in section {entry['name']!r}"
                )
            if entry["kind"] == "array":
                sections[entry["name"]] = _decode_array(
                    payload, entry["dtype"], entry["shape"]
                )
            else:
                sections[entry["name"]] = json.loads(payload.decode("utf-8"))
            off += n
        return cls(meta=header["meta"], sections=sections)


# ---------------------------------------------------------------------------
# engine -> snapshot
# ---------------------------------------------------------------------------

_REQUEST_FIELDS = (
    "req_id", "prompt", "max_new", "temperature", "state", "tokens",
    "n_generated", "n_cached", "n_prefix_hit", "n_prefilled", "epoch",
    "n_preemptions", "t_submit", "t_admit", "t_first_token", "t_last_token",
    "t_finish", "finish_reason", "deadline_s", "ttft_budget_s",
    "ttft_observed",
)


def _pack_request(req) -> Dict[str, Any]:
    rec = {}
    for name in _REQUEST_FIELDS:
        v = getattr(req, name)
        if isinstance(v, (list, np.ndarray)):
            v = [int(t) for t in v]
        elif isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        rec[name] = v
    return rec


def _unpack_request(rec: Dict[str, Any], request_cls):
    req = request_cls(
        req_id=int(rec["req_id"]),
        prompt=np.asarray(rec["prompt"], np.int32),
        max_new=int(rec["max_new"]),
        temperature=float(rec["temperature"]),
    )
    for name in _REQUEST_FIELDS:
        if name in ("req_id", "prompt", "max_new", "temperature"):
            continue
        v = rec[name]
        if name == "tokens":
            v = [int(t) for t in v]
        setattr(req, name, v)
    return req


def engine_fingerprint(engine) -> Dict[str, Any]:
    """Geometry a snapshot must match to be applied to an engine."""
    cfg = engine.cfg
    return {
        "n_layers": int(cfg.n_layers),
        "n_kv_heads": int(cfg.n_kv_heads),
        "head_dim": int(cfg.head_dim_),
        "vocab_size": int(cfg.vocab_size),
        "block_size": int(engine.pool.block_size),
        "num_blocks": int(engine.pool.num_blocks),
        "kv_dtype": engine.pool.kv_dtype,
        "quantized": bool(engine.pool.quantized),
        "max_batch": int(engine.sched.max_batch),
        "max_len": int(engine.sched.max_len),
        "prefix_cache": engine.prefix_cache is not None,
    }


def snapshot_state(engine) -> Snapshot:
    """Capture the full serving state of a (drained-pipeline) engine.

    Drains the async sampling pipeline first so every generated token is
    host-visible — the snapshot then has no in-flight device work to lose.
    """
    engine.drain()
    pool = engine.pool
    cache = engine.prefix_cache
    sched = engine.sched

    meta = {
        "fingerprint": engine_fingerprint(engine),
        "steps": int(engine.metrics.steps),
        "evict_policy": (getattr(cache, "evict_policy", None)
                         if cache else None),
    }
    sections: Dict[str, Any] = {}

    # --- pool arrays -------------------------------------------------------
    sections["pool.k"] = _to_host(pool.k)
    sections["pool.v"] = _to_host(pool.v)
    if pool.quantized:
        sections["pool.k_scale"] = _to_host(pool.k_scale)
        sections["pool.v_scale"] = _to_host(pool.v_scale)

    sections["pool_meta"] = {
        "free": [int(b) for b in pool._free],
        "ref": [int(r) for r in np.asarray(pool._ref)],
        "tables": {str(rid): [int(b) for b in blocks]
                   for rid, blocks in pool._tables.items()},
        "stats": asdict(pool.stats),
        "kv_dtype": pool.kv_dtype,
        "quantized": bool(pool.quantized),
    }

    # --- radix tree --------------------------------------------------------
    if cache is not None:
        nodes: List[Dict[str, Any]] = []
        ids: Dict[int, int] = {id(cache.root): 0}
        # parent-before-child order so restore can wire parents in one pass
        stack = [cache.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                ids[id(child)] = len(ids)
                nodes.append({
                    "id": ids[id(child)],
                    "parent": ids[id(node)],
                    "key": [int(t) for t in child.key],
                    "block": int(child.block),
                    "ref": int(child.ref),
                    "stamp": int(child.stamp),
                    "seq": int(child.seq),
                })
                stack.append(child)
        sections["radix"] = {
            "nodes": nodes,
            # purge() detaches nodes other requests still pin (their
            # pins unwind at release, which never touches tree
            # structure).  A detached node is unreachable — no future
            # match or eviction sees it — so its pin carries no state
            # worth restoring: keep only pins on live tree nodes
            "held": {str(rid): [ids[id(n)] for n in pins
                                if id(n) in ids]
                     for rid, pins in cache._held.items()},
            "cursor": {str(rid): [ids[id(node)], int(skip)]
                       for rid, (node, skip) in cache._cursor.items()},
            "clock": int(cache._clock),
            "stats": asdict(cache.stats),
        }

    # --- scheduler ---------------------------------------------------------
    sections["sched"] = {
        "waiting": [_pack_request(r) for r in sched.waiting],
        "running": [_pack_request(r) for r in sched.running],
        "finished": {str(rid): _pack_request(r)
                     for rid, r in sched.finished.items()},
        "reserved": {str(rid): int(n) for rid, n in sched._reserved.items()},
        "next_id": int(sched._next_id),
        "n_preemptions": int(sched.n_preemptions),
        "tokens_discarded": int(sched.tokens_discarded),
    }

    # --- engine ------------------------------------------------------------
    # a row whose request has already left `running` (finished and popped
    # by the caller) is vacated here, exactly as `_sync_rows` would on the
    # next step — the restored scheduler sections no longer carry it
    running_ids = {id(r) for r in sched.running}
    sections["engine"] = {
        "metrics": asdict(engine.metrics),
        "rows": [int(r.req_id) if (r is not None and id(r) in running_ids)
                 else None for r in engine._rows],
        "vec": [int(t) for t in engine._vec.tolist()],
        "gen_state": [int(b) for b in engine._gen.get_state().tolist()],
        "fault_pressure_blocks": int(
            getattr(engine, "_fault_pressure_blocks", 0)),
    }
    return Snapshot(meta=meta, sections=sections)


def write_snapshot(engine, path: str) -> Dict[str, Any]:
    """snapshot_state + atomic write; returns {path, nbytes, sections}."""
    return snapshot_state(engine).write(path)


# ---------------------------------------------------------------------------
# snapshot -> engine
# ---------------------------------------------------------------------------

def apply_snapshot(engine, snap: Snapshot, fsck: bool = True) -> None:
    """Rebuild a freshly-constructed, warmed engine's full state in place.

    The engine must have matching geometry (checked against the snapshot
    fingerprint) and no live requests.  On success the engine continues
    exactly where the snapshotted one stopped: same pools, same tree, same
    queues, same decode rows, same generator stream.  The pools and scales
    are copied into the engine's own tensors, on its device; the token
    vector goes to that device too.  With ``fsck=True`` (the default)
    `check_invariants` runs on the restored state and any violation
    propagates — callers treat it like a checksum failure and fall back to
    cold start.
    """
    from repro_torch.serve.invariants import check_invariants
    from repro_torch.serve.scheduler import Request

    fp_engine = engine_fingerprint(engine)
    fp_snap = snap.meta.get("fingerprint", {})
    if fp_engine != fp_snap:
        diff = {k: (fp_snap.get(k), fp_engine.get(k))
                for k in set(fp_snap) | set(fp_engine)
                if fp_snap.get(k) != fp_engine.get(k)}
        raise SnapshotCorrupt(f"fingerprint mismatch (snap, engine): {diff}")
    if engine.sched.running or engine.sched.waiting:
        raise RuntimeError("apply_snapshot requires an idle engine")

    pool = engine.pool
    cache = engine.prefix_cache
    sched = engine.sched

    # drop the engine's own tree FIRST: reset() releases its blocks back
    # into the pool, which must not touch the restored free list/refcounts
    if cache is not None:
        cache.reset()

    # --- pool --------------------------------------------------------------
    pm = snap.sections["pool_meta"]
    # into the engine's own tensors, on its device (the fingerprint held
    # their shapes and dtype equal)
    names = ["k", "v"] + (["k_scale", "v_scale"] if pool.quantized else [])
    for name in names:
        getattr(pool, name).copy_(snap.sections[f"pool.{name}"])
    pool._free = [int(b) for b in pm["free"]]
    pool._ref = np.asarray(pm["ref"], dtype=np.int32)
    pool._tables = {int(rid): [int(b) for b in blocks]
                    for rid, blocks in pm["tables"].items()}
    for name, value in pm["stats"].items():
        setattr(pool.stats, name, value)

    # --- radix tree --------------------------------------------------------
    if cache is not None:
        rx = snap.sections.get("radix")
        if rx is None:
            raise SnapshotCorrupt("engine has a prefix cache but snapshot "
                                  "carries no radix section")
        by_id = {0: cache.root}
        node_cls = type(cache.root)
        for rec in rx["nodes"]:
            parent = by_id[int(rec["parent"])]
            node = node_cls(
                key=tuple(int(t) for t in rec["key"]),
                block=int(rec["block"]),
                parent=parent,
                seq=int(rec["seq"]),
            )
            node.ref = int(rec["ref"])
            node.stamp = int(rec["stamp"])
            node.seq = int(rec["seq"])
            parent.children[node.key] = node
            by_id[int(rec["id"])] = node
        cache._held = {int(rid): [by_id[int(i)] for i in pins]
                       for rid, pins in rx["held"].items()}
        cache._cursor = {int(rid): (by_id[int(i)], int(skip))
                         for rid, (i, skip) in rx["cursor"].items()}
        cache._clock = int(rx["clock"])
        for name, value in rx["stats"].items():
            setattr(cache.stats, name, value)

    # --- scheduler ---------------------------------------------------------
    sc = snap.sections["sched"]
    sched.waiting.clear()
    sched.running.clear()
    sched.finished.clear()
    by_rid: Dict[int, Any] = {}
    for rec in sc["waiting"]:
        req = _unpack_request(rec, Request)
        sched.waiting.append(req)
        by_rid[req.req_id] = req
    for rec in sc["running"]:
        req = _unpack_request(rec, Request)
        sched.running.append(req)
        by_rid[req.req_id] = req
    for rid, rec in sc["finished"].items():
        req = _unpack_request(rec, Request)
        sched.finished[int(rid)] = req
        by_rid[req.req_id] = req
    sched._reserved = {int(rid): int(n) for rid, n in sc["reserved"].items()}
    sched._next_id = int(sc["next_id"])
    sched.n_preemptions = int(sc["n_preemptions"])
    sched.tokens_discarded = int(sc["tokens_discarded"])

    # --- engine ------------------------------------------------------------
    eg = snap.sections["engine"]
    engine.metrics = engine._fresh_metrics()
    for name, value in eg["metrics"].items():
        if hasattr(engine.metrics, name):
            setattr(engine.metrics, name, value)
    # decode rows must be the *same objects* as sched.running entries:
    # _sync_rows vacates rows by id() membership.
    engine._rows = [None if rid is None else by_rid[int(rid)]
                    for rid in eg["rows"]]
    engine._vec = torch.tensor(eg["vec"], dtype=torch.int32,
                               device=engine.device)
    engine._gen.set_state(torch.tensor(eg["gen_state"], dtype=torch.uint8))
    engine._fault_pressure_blocks = int(eg.get("fault_pressure_blocks", 0))
    engine._pending = []

    if fsck:
        check_invariants(pool, cache)


def requeue_inflight(engine) -> List[Dict[str, Any]]:
    """Convert a restored engine's in-flight requests into resubmit specs.

    Cross-process resume cannot continue half-done device work, but it can
    replay it exactly: each waiting/running request becomes a
    ``[prompt ‖ emitted]`` resubmission spec (the recompute contract), and
    its blocks go back to the pool/tree — generated-token KV is first
    published into the radix tree so the resubmission re-hits it as warm
    prefix instead of recomputing prefill from scratch.
    """
    sched = engine.sched
    cache = engine.prefix_cache
    pool = engine.pool
    specs: List[Dict[str, Any]] = []

    for req in list(sched.running):
        # keep the KV produced so far warm: publish [prompt ‖ generated]
        # into the tree before the table is released
        try:
            sched._publish_generated(req)
        except Exception:
            pass
        specs.append({
            "rid": int(req.req_id),
            "prompt": [int(t) for t in req.prompt],
            "tokens": [int(t) for t in req.tokens],
            "max_new": int(req.max_new),
            "temperature": float(req.temperature),
        })
        sched._release(req)
        sched._reserved.pop(req.req_id, None)
    sched.running.clear()

    for req in list(sched.waiting):
        specs.append({
            "rid": int(req.req_id),
            "prompt": [int(t) for t in req.prompt],
            "tokens": [int(t) for t in req.tokens],
            "max_new": int(req.max_new),
            "temperature": float(req.temperature),
        })
        if pool._tables.get(req.req_id):
            if cache is not None:
                cache.release(req.req_id)
            else:
                pool.free(req.req_id)
        sched._reserved.pop(req.req_id, None)
    sched.waiting.clear()
    sched.finished.clear()

    engine._rows = [None] * sched.max_batch
    engine._vec = torch.zeros((sched.max_batch,), dtype=torch.int32,
                              device=engine.device)
    engine._pending = []
    specs.sort(key=lambda s: s["rid"])
    return specs


def restore_engine(
    engine_factory: Callable[[], Any],
    snapshot_path: Optional[str],
    fsck: bool = True,
    requeue: bool = True,
) -> Tuple[Any, List[Dict[str, Any]], Dict[str, Any]]:
    """Build an engine from a snapshot, falling back to cold start.

    Returns ``(engine, specs, info)`` where ``specs`` are resubmission specs
    for requests that were in flight at snapshot time (empty when
    ``requeue=False`` or on cold start) and ``info`` records which rung of
    the recovery ladder ran: ``{"mode": "warm"|"cold", "reason": ...}``.

    The factory must return a constructed+warmed engine; it is called once
    for the warm attempt and once more if that attempt fails fsck, so a
    poisoned snapshot can never leak state into the cold fallback.
    """
    from repro_torch.serve.invariants import InvariantViolation

    if snapshot_path and os.path.exists(snapshot_path):
        engine = engine_factory()
        try:
            snap = Snapshot.read(snapshot_path)
            apply_snapshot(engine, snap, fsck=fsck)
            specs = requeue_inflight(engine) if requeue else []
            return engine, specs, {"mode": "warm", "reason": "snapshot ok"}
        except (SnapshotCorrupt, InvariantViolation) as e:
            reason = f"{type(e).__name__}: {e}"
        engine = engine_factory()  # discard poisoned partial state
        return engine, [], {"mode": "cold", "reason": reason}

    engine = engine_factory()
    reason = "no snapshot" if not snapshot_path else "snapshot missing"
    return engine, [], {"mode": "cold", "reason": reason}
