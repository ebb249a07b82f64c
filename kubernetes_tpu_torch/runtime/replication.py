"""API-store replication: commit-index-gated WAL shipping + lossless failover.

The reference's HA story for the API store is etcd raft behind
storage.Interface (staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go:1,
watch fan-out storage/cacher/cacher.go:448): writes replicate to a quorum
before acknowledgment and a new leader takes over on lease expiry. This
build keeps the single-writer store (client/apiserver.py) and adds the
raft-lite subset that matters at this scale:

  * **log shipping, parallel fan-out, commit-index-acked**: every
    mutation is streamed to ALL followers concurrently; the client sees
    success iff the commit index (runtime/consensus.py) reaches the
    record — i.e. a MAJORITY of the replica set (primary included) holds
    it durably appended. **Every acknowledged write replicates to a
    quorum before acknowledgment — true by construction**: on a quorum
    miss the write path raises instead of acking, and the store enters
    degraded READ-ONLY mode (writes 503-retryable, reads/watches keep
    serving) until follower acks catch the commit index back up to the
    leader's tip, at which point writes re-open and the WAL records the
    epoch transition. There is no availability-first fallback.
  * **terms**: each promotion bumps a monotonically increasing term. A
    handshake carrying a higher term FENCES the lower-term node: a deposed
    primary that learns of a successor steps down to read-only (raft's
    "higher term wins").
  * **vote-granted election on (term, commit_index, rv)**: followers know
    the replica-set peer list and learn the commit index from every
    recs/hb frame. On primary-lease expiry a follower first VERIFIES the
    primary is actually unreachable (a merely-slow link re-tails instead
    of promoting), then runs a raft-style election round at a FRESH term:
    each voter grants at most ONE candidate per term (so two same-term
    majorities — split brain — are structurally impossible), refuses
    candidates whose (term, rv, commit) log is behind its own (§5.4.1
    up-to-date check), and refuses everyone while its own primary lease
    is still fresh (leader stickiness). A candidate promotes only on a
    strict GRANT majority of cluster_size; rv order is log-prefix order,
    so the winner provably holds every committed — that is, every
    client-acknowledged — write: raft's leader-completeness argument in
    miniature. A minority partition can never elect.
  * **commit-index resync**: a reconnecting follower's hello carries its
    rv; when the leader still buffers that log suffix (and the terms
    match, so the follower's log is a prefix of the leader's) it replays
    just the tail in a ``catchup`` frame instead of a full snapshot.

Wire protocol: newline-delimited JSON frames over TCP.
  follower -> primary  {"hello": {"rv": N, "term": T, "uid": U}}
                       (uid = stable replica identity: a reconnect evicts
                        the same replica's superseded half-open link so
                        one node never holds two commit-quorum slots)
  primary  -> follower {"snap": {"rv": N, "term": T, "commit": C,
                                 "objects": {...}}}
                       {"catchup": {"from": N, "rv": N', "term": T,
                                    "commit": C, "recs": [...]}}
                       {"recs": [[rv, verb, kind, obj|null], ...],
                        "term": T, "commit": C}
                       {"hb": rv, "term": T, "commit": C}
                       {"ejected": T}   (you are out of the sync set)
  follower -> primary  {"ack": rv}     (rv is DURABLY applied; sent after
                                        snap/catchup handshakes too)
Election endpoint (per follower):
  {"status": 1} ->
      {"rv": N, "term": T, "commit": C, "synced": 0|1, "promoted": 0|1,
       "id": I}
  {"vote": {"term": T', "id": I, "key": [t, rv, commit]}} ->
      same status + {"granted": 0|1}   (single grant per term, log
                                        up-to-date check, lease-fresh
                                        stickiness)
A primary receiving a hello with term > its own replies {"fence": T} and
steps its store down; a follower seeing a snap/recs term < its own drops
the connection (stale primary).
"""

from __future__ import annotations

import json
import logging
import queue
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api import serialization
from ..utils.metrics import metrics
from .consensus import (
    COUNTER_CATCHUP_RESYNCS,
    COUNTER_SNAPSHOT_RESYNCS,
    ConsensusCoordinator,
    DegradedWrites,  # noqa: F401  (re-export: the write-path 503 surface)
    QuorumLost,  # noqa: F401  (re-export)
    log_key,
)

# ONE NotPrimary type for the whole tree (advisor r4): the store raises it
# on fenced writes; re-exported here for callers importing from runtime.
from ..client.apiserver import NotPrimary  # noqa: F401  (re-export)

logger = logging.getLogger("kubernetes_tpu.runtime.replication")

# a DiskCorrupt replica (mid-log WAL corruption at recovery) finished a
# full snap/catchup resync from the leader and is promotable again
COUNTER_CORRUPT_HEALS = "store_disk_corrupt_heals_total"
GAUGE_DISK_CORRUPT = "store_disk_corrupt"


def _send(f, frame: dict) -> None:
    f.write((json.dumps(frame, default=str) + "\n").encode())
    f.flush()


def _recv(f) -> Optional[dict]:
    line = f.readline()
    if not line:
        return None
    return json.loads(line)


class _FollowerConn:
    """Primary-side state for one connected follower.

    Outbound frames go through a bounded queue drained by a dedicated
    writer thread (etcd's per-peer stream goroutine). This is load-
    bearing, not a convenience: the previous design bounded ship()'s
    send with a temporary socket timeout, and settimeout() flips the fd's
    blocking mode UNDER the ack reader concurrently parked in recv on
    the SAME socket — a reader that began its read inside the toggle
    window died on a spurious BlockingIOError and took a perfectly
    healthy follower's acks (and its commit-index contribution) with it.
    With a writer thread, nobody ever changes the socket's mode: sends
    block only their own thread, a wedged link shows up as a FULL queue
    (bounded memory, explicit drop), and the reader's recv is untouched."""

    _next_fid = 0
    _fid_lock = threading.Lock()
    QUEUE_MAX = 4096  # frames; a link this far behind is wedged, not slow

    def __init__(self, sock: socket.socket, rfile, wfile):
        self.sock = sock
        self.rfile = rfile
        self.wfile = wfile
        self.acked_rv = 0
        self.ack_cond = threading.Condition()
        self.uid: Optional[str] = None  # replica identity from the hello
        # heartbeat-side stall detection state (see _heartbeat_loop)
        self.hb_seq_mark = 0
        self.hb_stalled_since: Optional[float] = None
        self.outq: "queue.Queue[Optional[dict]]" = queue.Queue(self.QUEUE_MAX)
        # flush tracking: seq of frames enqueued vs actually written to
        # the socket — legacy-mode ship() waits for the flush so a
        # concurrent close() can't silently discard a frame it already
        # counted as delivered (consensus mode needs no such wait: its
        # commit gate only trusts real follower acks)
        self.sent_cond = threading.Condition()
        self.enq_seq = 0
        self.sent_seq = 0
        with _FollowerConn._fid_lock:
            # link identity for the consensus match table: a RECONNECT is a
            # new link with empty known-durable state, never a resumed one
            _FollowerConn._next_fid += 1
            self.fid = _FollowerConn._next_fid

    def start_writer(self, on_error: Callable[["_FollowerConn"], None]) -> None:
        def run() -> None:
            while True:
                frame = self.outq.get()
                if frame is None:
                    return  # poison pill from _drop
                try:
                    _send(self.wfile, frame)
                except OSError:
                    on_error(self)
                    return
                with self.sent_cond:
                    self.sent_seq += 1
                    self.sent_cond.notify_all()

        threading.Thread(
            target=run, daemon=True, name=f"repl-writer-{self.fid}"
        ).start()

    def send_async(self, frame: dict) -> int:
        """Enqueue without blocking. Returns the frame's flush seq
        (truthy), or 0 when the queue is full (wedged link)."""
        try:
            with self.sent_cond:
                self.outq.put_nowait(frame)
                self.enq_seq += 1
                return self.enq_seq
        except queue.Full:
            return 0

    def wait_flushed(self, seq: int, deadline: float) -> bool:
        """Block until the writer has written frame `seq` (or deadline)."""
        with self.sent_cond:
            while self.sent_seq < seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.sent_cond.wait(remaining)
            return True

    def close_writer(self) -> None:
        try:
            self.outq.put_nowait(None)
        except queue.Full:
            pass  # writer will exit on the closed socket's OSError


class ReplicationListener:
    """Primary-side replication endpoint. Attach to an APIServer via
    `attach(server)`: every logged mutation is shipped to all connected
    followers in parallel and acknowledged once a quorum holds it.

    cluster_size: total replica count INCLUDING this primary. When set,
    a ConsensusCoordinator (runtime/consensus.py) gates every ship() on
    the commit index: the write acks iff a majority holds it durably
    within ack_timeout_s, else the write raises QuorumLost and the store
    enters degraded read-only mode until followers catch up. Laggards
    past the quorum stay connected and catch up from the TCP stream.
    When None (legacy two-node mode), every live follower must ack under
    one shared deadline, and a follower that would stall the quorum is
    ejected (with an explicit "ejected" frame — an ejected follower must
    never self-promote; it is missing acknowledged writes)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        term: int = 1,
        heartbeat_s: float = 0.2,
        ack_timeout_s: float = 0.75,
        cluster_size: Optional[int] = None,
    ):
        self.term = term
        self.heartbeat_s = heartbeat_s
        self.ack_timeout_s = ack_timeout_s
        self.cluster_size = cluster_size
        self.consensus: Optional[ConsensusCoordinator] = (
            ConsensusCoordinator(cluster_size, term=term, window_s=ack_timeout_s)
            if cluster_size is not None
            else None
        )
        self.server: Optional[Any] = None  # APIServer, set by attach()
        self._followers: List[_FollowerConn] = []
        self._lock = threading.Lock()
        # shared ack signal: ship() blocks here and re-checks the quorum on
        # every ack from ANY follower (per-conn waits would serialize — a
        # dead first conn would burn the whole deadline even with quorum
        # already met elsewhere)
        self._ack_cond = threading.Condition()
        self._stopped = threading.Event()
        self._sock = socket.create_server((host, port))
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        threading.Thread(
            target=self._accept_loop, daemon=True, name="repl-accept"
        ).start()
        threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="repl-heartbeat"
        ).start()

    # -- wiring ---------------------------------------------------------------

    def attach(self, server) -> None:
        """Install on the store: server.replicator = self. In consensus
        mode also arm the store's degraded-mode write gate and point the
        coordinator's epoch records at the store's WAL — the local rv may
        already be ahead of 0 (recovered store), seed the tip from it."""
        self.server = server
        server.replicator = self
        if self.consensus is not None:
            self.consensus.attach_wal(server._wal)
            self.consensus.local_append(server._rv)
            gate = getattr(server, "write_gate", None)
            if gate is not None:
                gate.attach_consensus(self.consensus)

    # -- accept / handshake ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, _addr = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(
                target=self._serve_follower,
                args=(sock,),
                daemon=True,
                name="repl-follower",
            ).start()

    def _serve_follower(self, sock: socket.socket) -> None:
        rfile = sock.makefile("rb")
        wfile = sock.makefile("wb")
        try:
            hello = _recv(rfile)
            if hello is None:
                sock.close()
                return
            if "ping" in hello:
                # liveness probe (see Follower._primary_reachable): a bare
                # TCP connect is answered by the kernel's listen backlog
                # even when this process is wedged — only an application
                # reply proves the primary is actually serving
                _send(wfile, {"pong": self.term})
                sock.close()
                return
            if "hello" not in hello:
                sock.close()
                return
            peer_term = int(hello["hello"].get("term", 0))
            peer_rv = int(hello["hello"].get("rv", 0))
            peer_uid = hello["hello"].get("uid")
            if peer_uid:
                # a reconnect supersedes the same replica's old link: a
                # half-open previous connection would otherwise keep its
                # consensus match entry alive alongside the new one —
                # double-counting ONE physical replica toward the commit
                # majority (phantom quorum at cluster_size >= 5)
                with self._lock:
                    stale = [
                        c for c in self._followers if c.uid == peer_uid
                    ]
                for c in stale:
                    logger.info("dropping superseded link for replica %s", peer_uid)
                    self._drop(c)
            if peer_term > self.term:
                # a successor exists: fence ourselves (raft higher-term rule)
                _send(wfile, {"fence": peer_term})
                self._step_down(peer_term)
                sock.close()
                return
            conn = _FollowerConn(sock, rfile, wfile)
            conn.uid = peer_uid
            # consistent handshake under the store lock so no mutation
            # lands between the state transfer and the live stream. The
            # follower may be arbitrarily behind (or empty) -> full
            # snapshot; a SAME-TERM reconnector whose log suffix the
            # leader still buffers gets just the tail replayed from its
            # rv (commit-index resync) — same-term is the prefix proof:
            # this leader shipped every record the follower holds.
            srv = self.server
            if srv is None:
                sock.close()
                return
            cons = self.consensus
            # the writer thread owns the socket's send side from here on:
            # the state-transfer frame below is ENQUEUED, never sent
            # inline — an inline snapshot send to a peer that stopped
            # reading would block on a full kernel buffer while HOLDING
            # srv._lock, wedging the entire API server behind one bad
            # reconnector (the failure class the writer threads exist
            # for; the heartbeat stall detector reaps such a link)
            conn.start_writer(lambda c: self._drop(c))
            with srv._lock:
                commit = cons.commit_index if cons is not None else srv._rv
                delta = None
                if cons is not None and peer_term == self.term:
                    if peer_rv == srv._rv:
                        delta = []
                    elif peer_rv < srv._rv:
                        tail = cons.buffer.since(peer_rv)
                        if (
                            tail
                            and tail[0][0] == peer_rv + 1
                            and tail[-1][0] == srv._rv
                        ):
                            delta = tail
                if delta is not None:
                    conn.send_async(
                        {
                            "catchup": {
                                "from": peer_rv,
                                "rv": srv._rv,
                                "term": self.term,
                                "commit": commit,
                                "recs": delta,
                            }
                        }
                    )
                    metrics.inc(COUNTER_CATCHUP_RESYNCS)
                else:
                    snap = {
                        "rv": srv._rv,
                        "term": self.term,
                        "commit": commit,
                        "objects": {
                            kind: [
                                serialization.encode(o) for o in store.values()
                            ]
                            for kind, store in srv._objects.items()
                        },
                    }
                    conn.send_async({"snap": snap})
                    metrics.inc(COUNTER_SNAPSHOT_RESYNCS)
                # registering under srv._lock keeps stream continuity:
                # every mutation after the state-transfer cut enqueues
                # behind it (ship() runs under this same lock), so the
                # follower sees snapshot-then-records in exact rv order
                with self._lock:
                    self._followers.append(conn)
        except (OSError, ValueError, json.JSONDecodeError):
            sock.close()
            return
        # ack reader: runs for the life of the connection, and its recv is
        # never perturbed — all sends go through the conn's writer thread,
        # so nothing ever toggles this socket's blocking mode. An idle
        # link simply has nothing to say; only EOF/hard errors drop it.
        try:
            while not self._stopped.is_set():
                frame = _recv(rfile)
                if frame is None:
                    break
                if "ack" in frame:
                    rv = int(frame["ack"])
                    with conn.ack_cond:
                        conn.acked_rv = rv
                        conn.ack_cond.notify_all()
                    if self.consensus is not None:
                        # the follower's ack means DURABLY applied: it
                        # advances the commit index (and may lift
                        # degraded mode when the quorum catches the tip)
                        self.consensus.follower_ack(conn.fid, rv)
                    with self._ack_cond:
                        self._ack_cond.notify_all()
        except (OSError, ValueError):
            pass
        self._drop(conn)

    def _drop(self, conn: _FollowerConn, eject: bool = False) -> None:
        with self._lock:
            if conn in self._followers:
                self._followers.remove(conn)
            else:
                eject = False  # already gone; don't re-notify
        if self.consensus is not None:
            # a dead link's acks can no longer back the quorum (the commit
            # index itself never regresses: committed is forever)
            self.consensus.forget(conn.fid)
        if eject:
            # explicit stale notice (advisor r4): without it the dropped
            # follower sees only silence, its lease lapses, and it promotes
            # at a stale rv with term+1 — fencing the healthy primary and
            # losing every write acked after the ejection. With the frame
            # it KNOWS it is out of the sync set and must re-sync instead.
            # Sent through the writer queue like every frame (no
            # interleaving with an in-flight send); wait for the writer to
            # actually flush it before the close cuts the link — an
            # already-wedged link just loses a best-effort notice.
            seq = conn.send_async({"ejected": self.term})
            if seq:
                conn.wait_flushed(seq, time.monotonic() + 0.5)
        conn.close_writer()
        try:
            # shutdown, not just close: the rfile/wfile makefile handles
            # hold _io_refs, so close() alone never closes the fd — the
            # peer would see no FIN (it blocks in recv forever instead of
            # reconnecting) and our own ack reader would block forever too.
            # shutdown() tears the TCP stream down regardless of refs.
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    def _step_down(self, new_term: int) -> None:
        logger.warning(
            "fenced by higher term %d (was %d): stepping down", new_term, self.term
        )
        srv = self.server
        if srv is not None:
            srv.read_only = True

    # -- shipping -------------------------------------------------------------

    def ship(self, records: List[Tuple[int, str, str, Any]]) -> None:
        """Replicate records (already WAL-durable locally) to every
        follower in parallel; returns once committed. One shared deadline
        bounds the total stall at ack_timeout_s no matter how many
        followers are half-dead (r4 weak #7: the serial loop stalled
        ack_timeout PER follower).

        Consensus mode (cluster_size set): returns iff the commit index
        reached the last record — a majority of the replica set holds
        every record durably. On a window miss it raises QuorumLost (the
        caller must NOT acknowledge the write) and the store enters
        degraded read-only mode until followers catch up; the laggards
        stay connected — they may hold the only follower copies of
        earlier writes, and their buffered stream is exactly what lifts
        degraded mode.

        Legacy mode (cluster_size None): every live follower must ack;
        one that cannot inside the deadline is ejected with an explicit
        stale notice (etcd's analogue: a dying member stalls the quorum
        round until the leader drops it)."""
        if not records:
            return
        recs = [
            [rv, verb, kind, serialization.encode(obj) if obj is not None else None]
            for rv, verb, kind, obj in records
        ]
        last_rv = records[-1][0]
        cons = self.consensus
        if cons is not None:
            # the local WAL append already happened (store._log_batch
            # orders durability before shipping): count self, buffer the
            # tail for commit-index resync of reconnectors
            cons.local_append(last_rv, recs)
        with self._lock:
            followers = list(self._followers)
        if not followers and cons is None:
            if self._stopped.is_set():
                # closed mid-burst (primary shutdown / simulated crash):
                # the follower set was just torn down, so "no followers"
                # here is NOT solo mode — acking would record a write no
                # surviving replica ever saw
                raise NotPrimary(
                    "replication listener closed mid-write: not acknowledged"
                )
            return  # legacy solo mode: nothing to wait for
        deadline = time.monotonic() + self.ack_timeout_s
        # send phase: enqueue on every link's writer (never blocks the
        # write path; each writer thread drains its own socket). A FULL
        # queue means the link is wedged beyond QUEUE_MAX frames of
        # backlog — drop it explicitly instead of buffering unboundedly.
        live: List[_FollowerConn] = []
        seqs: Dict[_FollowerConn, int] = {}
        frame = {"recs": recs, "term": self.term}
        if cons is not None:
            frame["commit"] = cons.commit_index
        for conn in followers:
            seq = conn.send_async(frame)
            if seq:
                live.append(conn)
                seqs[conn] = seq
            else:
                logger.warning("dropping follower (outbound queue full)")
                self._drop(conn, eject=False)
        if cons is not None:
            # commit-index gate: ONE bounded wait; acks from ANY follower
            # advance it. Window miss -> degraded read-only + QuorumLost
            # (the in-flight write is NOT acknowledged to the client).
            # quorum_miss rechecks under its lock: an ack racing the
            # window expiry means the write IS committed — ack it.
            if cons.wait_commit(last_rv, max(deadline - time.monotonic(), 0.0)):
                return
            exc = cons.quorum_miss(last_rv)
            if exc is None:
                return  # committed in the race window after all
            raise exc
        # legacy flush phase: acking-on-deadline-expiry (below) only makes
        # sense if the frame actually LEFT this process — wait for each
        # writer to hand it to the kernel, under the same shared deadline
        for conn in live:
            conn.wait_flushed(seqs[conn], deadline)
        # legacy wait phase: ONE shared deadline and ONE shared condition
        # across ALL links; all-acked by any subset returns immediately
        with self._ack_cond:
            while True:
                n_acked = sum(1 for c in live if c.acked_rv >= last_rv)
                if n_acked == len(live):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._ack_cond.wait(remaining)
        laggards = [c for c in live if c.acked_rv < last_rv]
        if laggards and self._stopped.is_set():
            # the listener was closed mid-write (primary shutting down /
            # simulated crash): the un-acked frame may never have reached
            # the follower — success here would acknowledge a write the
            # surviving replica can lose. Fail the call instead.
            raise NotPrimary(
                "replication listener closed mid-write: not acknowledged"
            )
        for conn in laggards:
            logger.warning("ejecting follower (ack timeout)")
            self._drop(conn, eject=True)

    def _heartbeat_loop(self) -> None:
        while not self._stopped.wait(self.heartbeat_s):
            srv = self.server
            rv = srv._rv if srv is not None else 0
            frame = {"hb": rv, "term": self.term}
            if self.consensus is not None:
                # piggyback the commit index so followers learn it even
                # on an idle stream (their election votes carry it), and
                # refresh the per-follower lag gauges off the write path
                frame["commit"] = self.consensus.commit_index
                self.consensus.publish_follower_lags()
            with self._lock:
                followers = list(self._followers)
            now = time.monotonic()
            stall_after = max(self.ack_timeout_s * 4, 2.0)
            for conn in followers:
                conn.send_async(frame)  # full queue: stall logic decides
                # dead-link detection (the inline-send era dropped on send
                # OSError; a writer thread sending into a half-open socket
                # "succeeds" into the kernel buffer for many minutes):
                # a non-empty queue whose writer makes NO progress across
                # consecutive beats is a wedged link — drop it so it stops
                # inflating follower_count and holding a match entry.
                if conn.outq.empty() or conn.sent_seq != conn.hb_seq_mark:
                    conn.hb_seq_mark = conn.sent_seq
                    conn.hb_stalled_since = None
                elif conn.hb_stalled_since is None:
                    conn.hb_stalled_since = now
                elif now - conn.hb_stalled_since > stall_after:
                    logger.warning("dropping follower (writer stalled)")
                    self._drop(conn)

    @property
    def follower_count(self) -> int:
        with self._lock:
            return len(self._followers)

    def close(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            for conn in self._followers:
                conn.close_writer()
                try:
                    conn.sock.shutdown(socket.SHUT_RDWR)  # see _drop
                except OSError:
                    pass
                try:
                    conn.sock.close()
                except OSError:
                    pass
            self._followers.clear()


class Follower:
    """Standby replica: tails a primary's replication stream into an
    in-memory state (and optionally its own WAL), promotes on lease expiry
    — gated by sync state, primary reachability, and (when a peer list is
    configured) a majority election.

    on_promote(server) is called with the LIVE APIServer built from the
    replica when this follower wins the failover.

    peers/cluster_size/node_id (optional, all-or-nothing): the election
    configuration. `peers` lists the OTHER followers' election endpoints;
    cluster_size is the TOTAL replica count including the primary. The
    follower serves its own election endpoint at `election_address`."""

    def __init__(
        self,
        primary_addr: Tuple[str, int],
        lease_s: float = 1.0,
        wal=None,
        on_promote: Optional[Callable[[Any], None]] = None,
        peers: Optional[List[Tuple[str, int]]] = None,
        cluster_size: Optional[int] = None,
        node_id: int = 0,
        heartbeat_s: float = 0.2,
        ack_timeout_s: float = 0.75,
        disk_corrupt: bool = False,
    ):
        self.primary_addr = primary_addr
        self.lease_s = lease_s
        self.wal = wal
        # disk_corrupt: this replica's WAL recovery found MID-LOG
        # corruption (wal.RecoveryReport.corrupt) — its state is an honest
        # prefix but may be missing acked writes, so it must not promote
        # until a snap/catchup resync from the leader has healed it.
        # disk_failed flips when OUR OWN wal appends start failing: the
        # replica keeps tailing (in-memory reads stay correct) but is
        # barred from promotion — a leader that cannot durably log is not
        # a leader.
        self.disk_corrupt = bool(disk_corrupt)
        self.disk_failed = False
        self.on_promote = on_promote
        self.peers = list(peers) if peers else []
        self.cluster_size = cluster_size
        self.node_id = node_id
        # replication timing this node will use if IT becomes the leader
        # (promote() must not silently revert a cluster tuned for slow
        # links back to defaults — that would flap every post-failover
        # write into QuorumLost)
        self.heartbeat_s = heartbeat_s
        self.ack_timeout_s = ack_timeout_s
        # stable replica identity across reconnects: lets the primary
        # evict this replica's superseded half-open link at re-handshake
        # (one physical replica must never hold two commit-quorum slots)
        self.replica_uid = f"{node_id}-{random.getrandbits(64):016x}"
        self.term = 0
        self.rv = 0
        # highest commit index learned from the leader (piggybacked on
        # snap/catchup/recs/hb frames): the election vote's durability
        # proof — a candidate behind on commit loses to one that holds it
        self.commit_index = 0
        self.objects: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        # read-path observers (apiserver/frontend.FollowerReadStore):
        # notified off-lock after records apply / the commit index moves /
        # a snapshot resets state — how a follower-attached watch cache
        # learns of changes without polling. Commit waits park on the
        # condition (notified from _learn_commit).
        self._observers: List[Any] = []
        self._commit_cond = threading.Condition()
        self._stopped = threading.Event()
        self._compacting = threading.Event()
        self._last_seen: Optional[float] = None  # None until first frame
        self._promoted: Optional[Any] = None
        self._synced = threading.Event()  # snapshot applied at least once
        self._ejected = threading.Event()  # primary declared us stale
        # the ReplicationListener this node runs AFTER winning a
        # consensus-mode election (promote() wires it so the new leader's
        # acks stay quorum-gated); peers learn its address via _my_status
        self._promoted_listener: Optional[ReplicationListener] = None
        self._cur_sock: Optional[socket.socket] = None  # live tail socket
        # single-vote-per-term election state (raft §5.2): at most ONE
        # candidate per term ever collects this node's grant, so two
        # leaders in one term are structurally impossible
        self._vote_lock = threading.Lock()
        self._voted_term = 0
        self._voted_for: Optional[int] = None
        self._next_vote_term = 0
        self._election_sock: Optional[socket.socket] = None
        self.election_address: Optional[Tuple[str, int]] = None
        if peers is not None or cluster_size is not None:
            self._election_sock = socket.create_server(("127.0.0.1", 0))
            self.election_address = self._election_sock.getsockname()[:2]
            threading.Thread(
                target=self._election_loop, daemon=True, name="repl-election"
            ).start()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="repl-tail"
        )
        self._monitor = threading.Thread(
            target=self._lease_loop, daemon=True, name="repl-lease"
        )

    def start(self) -> "Follower":
        self._thread.start()
        self._monitor.start()
        return self

    def wait_synced(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    def register_observer(self, obs: Any) -> None:
        """Attach a read-path observer. Duck interface (all optional):
        ``on_records(recs)`` with recs = [(rv, verb, kind, obj-copy)]
        after a batch durably applies, ``on_commit(commit_index)`` when
        the learned commit index advances, ``on_snapshot()`` after a full
        state transfer replaced the replica state (the observer's
        incremental view is invalid — resync from list)."""
        self._observers.append(obs)

    def _observe(self, method: str, *args) -> None:
        for obs in self._observers:
            fn = getattr(obs, method, None)
            if fn is None:
                continue
            try:
                fn(*args)
            except Exception:
                logger.exception("follower observer %s failed", method)

    def list_kind(self, kind: str) -> Tuple[List[Any], int]:
        """(deep-copied objects of kind, replica rv) under the replica
        lock: the follower-read seed list (FollowerReadStore.list)."""
        import copy as _copy

        with self._lock:
            d = self.objects.get(kind, {})
            return [_copy.deepcopy(o) for o in d.values()], self.rv

    def wait_commit(self, rv: int, timeout: float = 5.0) -> bool:
        """Block until the learned commit index covers rv (or timeout).
        The follower-read freshness gate: a consistent read demanding rv
        R is served only once a quorum durably holds R."""
        deadline = time.monotonic() + timeout
        with self._commit_cond:
            while self.commit_index < rv:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopped.is_set():
                    return self.commit_index >= rv
                self._commit_cond.wait(remaining)
        return True

    @property
    def ejected(self) -> bool:
        return self._ejected.is_set()

    # -- tail -----------------------------------------------------------------

    def _run(self) -> None:
        """Reconnect loop: an initial connection failure (primary briefly
        not listening, transient refusal) RETRIES instead of arming the
        failover timer — a follower that has never synced has nothing to
        promote (advisor r4 high: promoting an empty replica would bring
        up a blank control plane over real durable state)."""
        backoff = 0.05
        while not self._stopped.is_set():
            try:
                sock = socket.create_connection(self.primary_addr, timeout=5.0)
            except OSError:
                if self._promoted is not None:
                    return
                self._stopped.wait(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            backoff = 0.05
            self._cur_sock = sock
            self._tail_one(sock)
            self._cur_sock = None
            self._stopped.wait(0.05)

    def _tail_one(self, sock: socket.socket) -> None:
        # create_connection's 5s CONNECT timeout would otherwise persist
        # onto every recv: an idle-but-healthy stream (heartbeat interval
        # at or above it) would churn through spurious disconnect/resync
        # cycles — and a cycle landing mid-ship fails a healthy write.
        sock.settimeout(None)
        rfile = sock.makefile("rb")
        wfile = sock.makefile("wb")
        try:
            _send(
                wfile,
                {
                    "hello": {
                        "rv": self.rv,
                        "term": self.term,
                        "uid": self.replica_uid,
                    }
                },
            )
            while not self._stopped.is_set():
                frame = _recv(rfile)
                if frame is None:
                    break
                self._last_seen = time.monotonic()
                self._learn_commit(frame)
                if "snap" in frame:
                    self._apply_snapshot(frame["snap"])
                    self._synced.set()
                    self._ejected.clear()  # full snapshot: stale no more
                    self._mark_disk_healed("snapshot")
                    # ack the handshake state: the leader's commit index
                    # needs to know we durably hold it (a reconnect during
                    # degraded mode lifts it through exactly this ack)
                    _send(wfile, {"ack": self.rv})
                elif "catchup" in frame:
                    # commit-index resync: the leader replayed just our
                    # missing log suffix — applying it makes us exactly as
                    # synced (and as promotable) as a full snapshot would
                    cu = frame["catchup"]
                    if int(cu.get("term", 0)) < self.term:
                        break  # stale primary
                    self.term = int(cu.get("term", self.term))
                    self._apply_records(cu.get("recs", []))
                    self._synced.set()
                    self._ejected.clear()
                    # a corrupt replica's hello carried its valid-prefix
                    # rv; this catchup re-appended the missing suffix to
                    # the (already-truncated) WAL — the log is whole again
                    self._mark_disk_healed("catchup")
                    _send(wfile, {"ack": self.rv})
                elif "recs" in frame:
                    if int(frame.get("term", 0)) < self.term:
                        break  # stale primary
                    self._apply_records(frame["recs"])
                    _send(wfile, {"ack": self.rv})
                elif "ejected" in frame:
                    # we were dropped from the sync set for lagging: we are
                    # MISSING acknowledged writes. Promotion from here would
                    # lose them (advisor r4 medium) — block promotion until
                    # the next connect re-handshakes for a FULL snapshot
                    # (which clears the block: fresh state is promotable).
                    logger.warning(
                        "ejected from sync set at rv=%d: will not promote "
                        "until re-synced", self.rv
                    )
                    self._synced.clear()
                    self._ejected.set()
                    break
                elif "fence" in frame:
                    break
                # heartbeats only refresh _last_seen
        except (OSError, ValueError, json.JSONDecodeError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _mark_disk_healed(self, how: str) -> None:
        """A full resync (snap, or catchup onto the repaired valid-prefix
        WAL) replaced/completed our state from the leader: the DiskCorrupt
        promotion bar lifts."""
        if not self.disk_corrupt:
            return
        self.disk_corrupt = False
        metrics.inc(COUNTER_CORRUPT_HEALS)
        metrics.set_gauge(GAUGE_DISK_CORRUPT, 0.0)
        logger.warning(
            "disk-corrupt replica healed via %s resync at rv=%d: "
            "promotable again", how, self.rv,
        )

    def _learn_commit(self, frame: dict) -> None:
        """Track the leader's piggybacked commit index (recs/hb carry it
        top-level; snap/catchup inside their payload). Monotonic."""
        c = frame.get("commit", 0)
        for key in ("snap", "catchup"):
            if key in frame:
                c = max(c, frame[key].get("commit", 0) or 0)
        if c and int(c) > self.commit_index:
            self.commit_index = int(c)
            with self._commit_cond:
                self._commit_cond.notify_all()
            self._observe("on_commit", self.commit_index)

    def _apply_snapshot(self, snap: dict) -> None:
        with self._lock:
            self.rv = snap["rv"]
            self.term = int(snap.get("term", self.term))
            self.objects = {
                kind: {
                    (o := serialization.decode(kind, data)).metadata.key: o
                    for data in objs
                }
                for kind, objs in snap["objects"].items()
            }
        if self.wal is not None:
            # persist the handshake snapshot too: recovery from this WAL
            # must rebuild the FULL replicated state, not just the records
            # streamed after the connection (review r4)
            self.wal.write_snapshot(*self._snapshot_state())
        # a full state transfer invalidates any incremental read-path
        # view built from the record stream: observers resync from list
        self._observe("on_snapshot")

    def _snapshot_state(self):
        """(rv, {kind: [DEEP-COPIED objects]}) under the lock: a promotion
        racing a snapshot write mutates the live objects (the promoted
        APIServer shares self.objects), so the write must encode copies —
        the same rule as APIServer._compact_async."""
        import copy as _copy

        with self._lock:
            return self.rv, {
                kind: [_copy.deepcopy(o) for o in d.values()]
                for kind, d in self.objects.items()
            }

    def _maybe_compact(self) -> None:
        """Follower-side WAL compaction, OFF the replication tail thread:
        inline it would stall the ack past the primary's ship timeout and
        starve heartbeats into a spurious self-promotion."""
        if self.wal is None or not self.wal.due() or self._compacting.is_set():
            return
        self._compacting.set()

        def run():
            try:
                self.wal.write_snapshot(*self._snapshot_state())
            except Exception:
                logger.exception("follower WAL compaction failed")
            finally:
                self._compacting.clear()

        threading.Thread(target=run, daemon=True, name="repl-compact").start()

    def _apply_records(self, recs: List) -> None:
        wal_batch = []
        with self._lock:
            for rv, verb, kind, data in recs:
                if rv <= self.rv:
                    continue
                self.rv = rv
                d = self.objects.setdefault(kind, {})
                obj = serialization.decode(kind, data) if data is not None else None
                if verb == "delete":
                    if obj is not None:
                        d.pop(obj.metadata.key, None)
                elif obj is not None:
                    d[obj.metadata.key] = obj
                wal_batch.append((rv, verb, kind, obj))
        if self.wal is not None and wal_batch and not self.disk_failed:
            # replica durability: promotion after OUR crash recovers from
            # this WAL exactly like a primary restart; compaction is the
            # follower's own job (the primary's doesn't cross the wire)
            try:
                self.wal.append_batch(wal_batch)
                self._maybe_compact()
            except OSError as e:
                # OUR disk died, not the stream. Fail-stop the durability
                # side only: in-memory state stays correct (reads and watch
                # fan-out keep working) but this replica can never again
                # vouch for durability, so promotion is barred permanently
                # and we stop touching the WAL — appending to a failed sink
                # would just re-raise forever.
                self.disk_failed = True
                logger.error(
                    "follower WAL append failed (disk fail-stop): %s — "
                    "replica continues serving in-memory but is barred "
                    "from promotion", e,
                )
        if wal_batch and self._observers:
            # observers get COPIES: the stored objects are live replica
            # state (a promotion shares self.objects with the promoted
            # APIServer) and the read path hands its view to watch queues
            import copy as _copy

            self._observe(
                "on_records",
                [
                    (rv, verb, kind, _copy.deepcopy(obj))
                    for rv, verb, kind, obj in wal_batch
                ],
            )

    # -- election endpoint ----------------------------------------------------

    def _my_status(self) -> dict:
        status = {
            "rv": self.rv,
            "term": self.term,
            "commit": self.commit_index,
            "synced": int(self._synced.is_set()),
            "promoted": int(self._promoted is not None),
            "id": self.node_id,
        }
        listener = self._promoted_listener
        if listener is not None:
            # advertise the new leader's replication endpoint: peers that
            # find us promoted during their election rounds redirect their
            # tails here (and their acks are what open our write quorum)
            status["repl_addr"] = list(listener.address)
        return status

    def _grant_vote(self, vote_term: int, cand_id: int, cand_key) -> bool:
        """Voter side of the election (raft §5.2/§5.4.1): grant iff
          * the round's term is NEW (above our current term — a round at
            or below it is stale),
          * our primary lease is NOT fresh (leader stickiness: a node
            still hearing the primary must not help depose it),
          * we have not voted for a DIFFERENT candidate this term
            (single vote per term: two majorities cannot form), and
          * the candidate's log is at least as up-to-date as ours
            (log_key: term, rv, capped commit — so a grant-majority
            winner provably holds every committed write).
        """
        with self._vote_lock:
            if self._promoted is not None:
                return False
            if vote_term <= self.term:
                return False
            last = self._last_seen
            if last is not None and (time.monotonic() - last) <= self.lease_s:
                return False
            if vote_term < self._voted_term:
                return False
            if vote_term == self._voted_term and self._voted_for != cand_id:
                return False
            if tuple(cand_key) < log_key(self._my_status()):
                return False
            self._voted_term = vote_term
            self._voted_for = cand_id
            return True

    def _election_loop(self) -> None:
        # runs until stop() closes the socket — NOT gated on _stopped:
        # promote() sets _stopped (the tail must die) but the election
        # endpoint must keep answering, both to tell candidates a leader
        # exists and to advertise the new leader's repl_addr so every
        # surviving follower (not just the first to ask) can redirect
        while True:
            try:
                sock, _addr = self._election_sock.accept()
            except OSError:
                return
            try:
                sock.settimeout(2.0)
                rfile = sock.makefile("rb")
                wfile = sock.makefile("wb")
                frame = _recv(rfile)
                if frame and "status" in frame:
                    _send(wfile, self._my_status())
                elif frame and "vote" in frame:
                    v = frame["vote"]
                    granted = self._grant_vote(
                        int(v.get("term", 0)),
                        int(v.get("id", -1)),
                        tuple(v.get("key", (0, 0, 0))),
                    )
                    reply = self._my_status()
                    reply["granted"] = int(granted)
                    # let refused candidates fast-forward past terms this
                    # voter has already consumed, instead of crawling one
                    # term per election round
                    reply["voted_term"] = self._voted_term
                    _send(wfile, reply)
            except (OSError, ValueError, json.JSONDecodeError):
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass

    def _request_vote(
        self, addr: Tuple[str, int], vote_term: int, key
    ) -> Optional[dict]:
        return self._rpc(
            addr,
            {
                "vote": {
                    "term": vote_term,
                    "id": self.node_id,
                    "key": list(key),
                }
            },
        )

    # -- failover -------------------------------------------------------------

    def _primary_reachable(self) -> bool:
        """A lease can lapse because the primary died OR because this link
        (or this process) stalled. Before any promotion, distinguish: if
        the primary still ANSWERS, it is alive — re-tail instead of
        splitting the brain (advisor r4 medium). The probe requires an
        application-level pong: a bare TCP connect is completed by the
        kernel's listen backlog even when the primary process is wedged,
        which would defer failover forever for a hung-but-listening
        primary."""
        reply = self._rpc(self.primary_addr, {"ping": 1})
        return bool(reply) and "pong" in reply

    @staticmethod
    def _rpc(
        addr: Tuple[str, int], frame: dict, timeout: float = 0.5
    ) -> Optional[dict]:
        """One-shot request/reply over a fresh connection (election
        status/vote polls, liveness probes). None on any failure."""
        try:
            sock = socket.create_connection(addr, timeout=timeout)
            try:
                sock.settimeout(timeout)
                wfile = sock.makefile("wb")
                rfile = sock.makefile("rb")
                _send(wfile, frame)
                return _recv(rfile)
            finally:
                sock.close()
        except (OSError, ValueError, json.JSONDecodeError):
            return None

    def _poll_status(self, addr: Tuple[str, int]) -> Optional[dict]:
        return self._rpc(addr, {"status": 1})

    def _maybe_defect_to_new_leader(self) -> None:
        """Zombie-leader escape: a follower whose tail is still fed by a
        DEPOSED or degraded old primary keeps a fresh lease (heartbeats
        carry no proof of leadership) and would never run an election —
        parked on a zombie forever while the real leader runs a replica
        short. So even with a fresh lease, occasionally ask the peers: if
        any reachable peer is promoted at a HIGHER term and advertises
        its replication endpoint, redirect there and cut the current
        tail (the zombie, at its lower term, can never fence us back)."""
        for addr in self.peers:
            s = self._poll_status(addr)
            if (
                s
                and s.get("promoted")
                and int(s.get("term", 0)) > self.term
                and s.get("repl_addr")
            ):
                new_addr = (s["repl_addr"][0], int(s["repl_addr"][1]))
                logger.warning(
                    "defecting from zombie primary %s to promoted peer "
                    "id=%s term=%s at %s",
                    self.primary_addr, s.get("id"), s.get("term"), new_addr,
                )
                self.primary_addr = new_addr
                cur = self._cur_sock
                if cur is not None:
                    try:
                        cur.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                return

    def _lease_loop(self) -> None:
        # freshly-randomized tick per round (raft's randomized election
        # timeout): dueling candidates that split one round's votes MUST
        # desynchronize — a fixed per-node factor (or none) phase-locks
        # them into splitting every round forever, since the vote
        # fast-forward re-aligns their terms after each split
        ticks = 0
        while not self._stopped.wait(
            self.lease_s / 4 * random.uniform(0.5, 1.5)
        ):
            ticks += 1
            if self._ejected.is_set():
                continue  # stale replica: no promotion until re-synced
            if self.disk_corrupt or self.disk_failed:
                # a replica whose WAL was mid-log corrupt (until a resync
                # heals it) or whose disk fail-stopped (permanent) must
                # never become primary: its durability story is a lie
                continue
            if not self._synced.is_set() or self.rv <= 0:
                continue  # nothing real to promote yet (advisor r4 high)
            last = self._last_seen
            if last is None or time.monotonic() - last <= self.lease_s:
                # lease fresh — but the feeder may be a zombie: scan the
                # peers about once per lease period for a promoted
                # higher-term leader (no-op while partitioned from them)
                if self.peers and ticks % 4 == 0:
                    self._maybe_defect_to_new_leader()
                continue
            if self._primary_reachable():
                # primary alive, our tail is what lapsed: treat the probe
                # as a heartbeat; the reconnect loop re-tails
                self._last_seen = time.monotonic()
                continue
            won_term = self._run_election()
            if won_term is None:
                continue  # no grant majority this round: retry
            self.promote(term=won_term)
            return

    def _run_election(self) -> Optional[int]:
        """One election round (raft §5.2): pick a FRESH term, vote for
        ourselves, request votes from every peer, and win only on a
        strict GRANT majority of cluster_size. Voters grant at most one
        candidate per term and only candidates whose (term, rv, commit)
        log is at least as up-to-date as their own — so two leaders in
        one term are impossible (grant majorities intersect) and the
        winner provably holds every committed (client-acknowledged)
        write. Returns the won term, or None (stand down this round).

        A failed round never reuses its term (_next_vote_term): a peer's
        grant from a dead round can then never combine with a later
        round's grants into two same-term majorities."""
        if not self.peers and self.cluster_size is None:
            return self.term + 1  # legacy two-node: the sole follower
        self._next_vote_term = max(self._next_vote_term, self.term + 1)
        vote_term = self._next_vote_term
        self._next_vote_term += 1
        my_key = log_key(self._my_status())
        # self-vote under the same single-vote rule we apply to peers
        with self._vote_lock:
            if self._promoted is not None:
                return None
            if vote_term < self._voted_term or (
                vote_term == self._voted_term
                and self._voted_for != self.node_id
            ):
                return None
            self._voted_term = vote_term
            self._voted_for = self.node_id
        replies = [
            r
            for r in (
                self._request_vote(a, vote_term, my_key) for a in self.peers
            )
            if r
        ]
        for r in replies:
            if r.get("promoted"):
                # a leader already exists: stand down — and redirect our
                # tail to its replication endpoint when it advertises one
                # (our ack is likely the quorum slot that re-opens its
                # writes; without the redirect we would retry the DEAD old
                # primary's address forever)
                addr = r.get("repl_addr")
                if addr:
                    self.primary_addr = (addr[0], int(addr[1]))
                    logger.warning(
                        "election: peer id=%s already promoted; re-tailing "
                        "its replication endpoint %s", r.get("id"),
                        self.primary_addr,
                    )
                else:
                    logger.warning(
                        "election: a peer already promoted; standing down"
                    )
                return None
        n = self.cluster_size or (len(self.peers) + 2)  # peers + self + primary
        reachable = 1 + len(replies)
        if reachable * 2 <= n:
            logger.warning(
                "election: no quorum (%d/%d reachable): refusing to promote "
                "(minority partition must not serve writes)", reachable, n
            )
            return None
        # commit-index floor (belt-and-braces; the voters' up-to-date
        # check already enforces it): committed means CLIENT-ACKNOWLEDGED.
        # If anyone reachable learned a commit index above our rv,
        # acknowledged writes exist that we do not hold.
        known_commit = max(
            [self.commit_index] + [int(r.get("commit", 0)) for r in replies]
        )
        if self.rv < known_commit:
            logger.warning(
                "election: our rv=%d is below the known commit index %d "
                "(acknowledged writes we do not hold): refusing to promote",
                self.rv, known_commit,
            )
            return None
        grants = 1 + sum(1 for r in replies if r.get("granted"))
        if grants * 2 <= n:
            # fast-forward past terms the voters have already consumed so
            # the next round isn't refused as stale
            self._next_vote_term = max(
                [self._next_vote_term]
                + [int(r.get("voted_term", 0)) + 1 for r in replies]
            )
            logger.info(
                "election: %d/%d grants at term %d (need majority): "
                "standing down this round", grants, n, vote_term,
            )
            return None
        logger.warning(
            "election: WON term %d with %d/%d grants (rv=%d commit=%d)",
            vote_term, grants, n, self.rv, self.commit_index,
        )
        return vote_term

    def promote(self, force: bool = False, term: Optional[int] = None):
        """Become primary at `term` (an election-won term; defaults to
        term+1 for the legacy/operator paths), building a live APIServer
        from the replica. Idempotent; returns the promoted server.
        Refuses (returns None) when this replica has never synced, was
        ejected from the sync set, recovered a mid-log-corrupt WAL that
        hasn't been healed by a resync yet, or fail-stopped its disk —
        promoting any of those would serve wrong/stale state over real
        durable writes — unless force=True (operator override)."""
        with self._lock:
            if self._promoted is not None:
                return self._promoted
            if not force and (
                not self._synced.is_set() or self.rv <= 0
                or self._ejected.is_set()
                or self.disk_corrupt or self.disk_failed
            ):
                logger.error(
                    "refusing promotion: synced=%s rv=%d ejected=%s "
                    "disk_corrupt=%s disk_failed=%s (use force=True to "
                    "override)",
                    self._synced.is_set(), self.rv, self._ejected.is_set(),
                    self.disk_corrupt, self.disk_failed,
                )
                return None
            from ..client.apiserver import APIServer

            self._stopped.set()
            self.term = term if term is not None else self.term + 1
            srv = APIServer(wal=self.wal)
            srv._rv = self.rv
            srv._objects = self.objects
            if self.cluster_size is not None:
                # consensus mode: the new leader's ack contract is the
                # SAME as the old one's — no write acks until a majority
                # holds it. Bring up a replication endpoint at the won
                # term (advertised via _my_status "repl_addr"; surviving
                # followers redirect their tails to it from their next
                # election round) and gate the store on its commit index.
                # Until a quorum of followers reconnects, writes degrade
                # instead of silently acking unreplicated.
                listener = ReplicationListener(
                    term=self.term,
                    cluster_size=self.cluster_size,
                    heartbeat_s=self.heartbeat_s,
                    ack_timeout_s=self.ack_timeout_s,
                )
                listener.attach(srv)
                self._promoted_listener = listener
            self._promoted = srv
            logger.warning(
                "follower promoted to primary at rv=%d term=%d", self.rv, self.term
            )
        # best-effort fence of the old primary: it may be merely STALLED
        # (lease lapsed without dying) — a hello at our higher term makes
        # it step down read-only instead of splitting the brain. A dead
        # primary simply refuses the connection.
        try:
            sock = socket.create_connection(self.primary_addr, timeout=1.0)
            try:
                wfile = sock.makefile("wb")
                _send(wfile, {"hello": {"rv": self.rv, "term": self.term}})
            finally:
                sock.close()
        except OSError:
            pass
        if self.on_promote is not None:
            try:
                self.on_promote(srv)
            except Exception:
                logger.exception("on_promote callback failed")
        return srv

    @property
    def promoted(self):
        return self._promoted

    def stop(self) -> None:
        self._stopped.set()
        if self._promoted_listener is not None:
            self._promoted_listener.close()
        if self._election_sock is not None:
            try:
                self._election_sock.close()
            except OSError:
                pass
