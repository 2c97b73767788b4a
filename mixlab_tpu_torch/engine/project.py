"""Project persistence: SQLite-backed workspace + media blob streams
(port of ``mixlab_tpu/engine/project.py``).

Rebuild of the reference persistence layer:
  * versioned embedded migrations applied in sorted order with a
    ``schema_migrations`` single-row version table (``src/db/mod.rs:28-60``,
    ``src/db/migrations.rs``); schema matches the reference's tables
    (media / streams / blobs / workspace);
  * workspace serialized as JSON upserted at rowid 1
    (``src/project.rs:80-106``);
  * media stored as chunked blob streams of 1 MiB
    (``src/project/stream.rs:11-190``): ``WriteStream`` buffers and flushes
    full chunks updating the stream size, ``ReadStream`` is a seekable
    reader resolving the blob row by ``offset - offset % CHUNK``;
  * ``ProjectHandle`` wires the port's Engine (on ``device``) with a
    persistence callback executed on a background writer thread (the
    reference's spawned persist task consuming a watch channel,
    ``src/project.rs:120-132`` — coalescing to the newest snapshot).

The schema and the JSON are the JAX package's, so either package opens the
other's files.  The handle gives the engine ``media_opener=open_media``, as
the JAX package does, so an uploaded file plays through a MediaSource.
One difference: ``close`` stops the engine first (its decode and codec
threads, and the codec processes they own) and then the database, so a
closed handle leaves no thread reading a blob and no process behind.

Project files use the reference's ``<name>.mixlab`` convention.
"""

from __future__ import annotations

import json
import queue
import sqlite3
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

from mixlab_tpu_torch import protocol as p
from mixlab_tpu_torch.engine.config import EngineConfig
from mixlab_tpu_torch.engine.engine import Engine
from mixlab_tpu_torch.engine.graph import Workspace

STREAM_BLOB_SIZE = 1024 * 1024  # stream.rs:11


class ProjectClosedError(RuntimeError):
    """Raised by any ProjectBase query after close().

    The reference cannot hit this state — all SQLite access goes through
    spawn_blocking closures owned by the project task (src/project.rs:61-66)
    so nothing can race a closed handle; here decode threads hold ReadStreams
    directly, so post-close access must fail with a typed error the media
    threads can treat as end-of-stream."""

MIGRATIONS: List[Tuple[int, str]] = [
    (0, "CREATE TABLE schema_migrations (version INTEGER NOT NULL);"),
    (
        20200804,
        """
        CREATE TABLE media (
            id INTEGER PRIMARY KEY NOT NULL,
            name TEXT NOT NULL,
            kind TEXT NOT NULL,
            stream_id INTEGER NOT NULL,
            FOREIGN KEY (stream_id) REFERENCES streams (id)
        );
        CREATE TABLE streams (
            id INTEGER PRIMARY KEY NOT NULL,
            size INTEGER NOT NULL,
            CONSTRAINT non_negative_size CHECK (size >= 0)
        );
        CREATE TABLE blobs (
            stream_id INTEGER NOT NULL,
            offset INTEGER NOT NULL,
            data BLOB NOT NULL,
            FOREIGN KEY (stream_id) REFERENCES streams (id),
            CONSTRAINT non_negative_offset CHECK (offset >= 0)
        );
        CREATE UNIQUE INDEX blob_sequence_idx ON blobs (stream_id, offset);
        """,
    ),
    (20200805, "CREATE TABLE workspace (serialized TEXT NOT NULL);"),
]


class ProjectBase:
    """Serialized access to the SQLite database (one writer lock — the
    reference funnels all access through spawn_blocking closures)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._conn = sqlite3.connect(str(self.path), check_same_thread=False)
        self._lock = threading.RLock()
        self._closed = False
        self._migrate()

    def _check_open(self):
        if self._closed:
            raise ProjectClosedError(f"project database closed: {self.path}")

    def _migrate(self):
        with self._lock, self._conn:
            cur = self._conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' AND name='schema_migrations'"
            )
            have_table = cur.fetchone() is not None
            version = -1
            if have_table:
                row = self._conn.execute(
                    "SELECT version FROM schema_migrations LIMIT 1"
                ).fetchone()
                version = row[0] if row else -1
            for v, sql in sorted(MIGRATIONS):
                if v > version:
                    self._conn.executescript(sql)
                    version = v
            if have_table or version >= 0:
                self._conn.execute("DELETE FROM schema_migrations")
                self._conn.execute(
                    "INSERT INTO schema_migrations (version) VALUES (?)", (version,)
                )

    def execute(self, sql, params=()):
        with self._lock:
            self._check_open()
            with self._conn:
                return self._conn.execute(sql, params)

    def query_one(self, sql, params=()):
        with self._lock:
            self._check_open()
            return self._conn.execute(sql, params).fetchone()

    def query_all(self, sql, params=()):
        with self._lock:
            self._check_open()
            return self._conn.execute(sql, params).fetchall()

    # -- workspace ---------------------------------------------------------

    def read_workspace(self) -> Optional[dict]:
        row = self.query_one("SELECT serialized FROM workspace WHERE rowid = 1")
        return json.loads(row[0]) if row else None

    def write_workspace(self, snapshot: dict):
        text = json.dumps(snapshot, separators=(",", ":"))
        with self._lock:
            self._check_open()
            with self._conn:
                cur = self._conn.execute(
                    "UPDATE workspace SET serialized = ? WHERE rowid = 1", (text,)
                )
                if cur.rowcount == 0:
                    self._conn.execute(
                        "INSERT INTO workspace (rowid, serialized) VALUES (1, ?)",
                        (text,),
                    )

    # -- media streams -----------------------------------------------------

    def create_stream(self) -> "WriteStream":
        with self._lock:
            self._check_open()
            with self._conn:
                cur = self._conn.execute("INSERT INTO streams (size) VALUES (0)")
                return WriteStream(self, cur.lastrowid)

    def open_stream(self, stream_id: int) -> Optional["ReadStream"]:
        row = self.query_one("SELECT size FROM streams WHERE id = ?", (stream_id,))
        if row is None:
            return None
        return ReadStream(self, stream_id, row[0])

    # -- media library -----------------------------------------------------

    def media_library(self) -> p.MediaLibrary:
        rows = self.query_all(
            "SELECT media.id, media.name, media.kind, streams.size"
            " FROM media JOIN streams ON streams.id = media.stream_id"
            " ORDER BY media.id"
        )
        return p.MediaLibrary(
            items=[
                p.MediaItem(p.MediaId(r[0]), r[1], r[2], r[3]) for r in rows
            ]
        )

    def insert_media(self, name: str, kind: str, stream_id: int) -> p.MediaId:
        with self._lock:
            self._check_open()
            with self._conn:
                cur = self._conn.execute(
                    "INSERT INTO media (name, kind, stream_id) VALUES (?, ?, ?)",
                    (name, kind, stream_id),
                )
                return p.MediaId(cur.lastrowid)

    def open_media(self, media_id: p.MediaId) -> Optional["ReadStream"]:
        row = self.query_one(
            "SELECT stream_id FROM media WHERE id = ?", (media_id.value,)
        )
        if row is None:
            return None
        return self.open_stream(row[0])

    def close(self):
        with self._lock:
            self._closed = True
            self._conn.close()

    def __enter__(self) -> "ProjectBase":
        return self

    def __exit__(self, *exc):
        self.close()


class WriteStream:
    """Buffered chunked writer (stream.rs:31-84)."""

    def __init__(self, base: ProjectBase, stream_id: int):
        self.base = base
        self.id = stream_id
        self.offset = 0
        self.buff = bytearray()

    def write(self, data: bytes):
        view = memoryview(data)
        while len(view):
            take = min(len(view), STREAM_BLOB_SIZE - len(self.buff))
            self.buff += view[:take]
            view = view[take:]
            if len(self.buff) == STREAM_BLOB_SIZE:
                self._flush()

    def finalize(self) -> int:
        self._flush()
        return self.id

    def _flush(self):
        if self.buff:
            with self.base._lock:
                self.base._check_open()
                with self.base._conn:
                    self.base._conn.execute(
                        "INSERT INTO blobs (stream_id, offset, data) VALUES (?, ?, ?)",
                        (self.id, self.offset, bytes(self.buff)),
                    )
                    self.base._conn.execute(
                        "UPDATE streams SET size = ? WHERE id = ?",
                        (self.offset + len(self.buff), self.id),
                    )
            self.offset += len(self.buff)
            self.buff = bytearray()


class ReadStream:
    """Seekable chunked reader (stream.rs:96-190)."""

    def __init__(self, base: ProjectBase, stream_id: int, size: int):
        self.base = base
        self.stream_id = stream_id
        self.size = size
        self.offset = 0

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.size - self.offset
        out = bytearray()
        while n > 0 and self.offset < self.size:
            blob_offset = self.offset - (self.offset % STREAM_BLOB_SIZE)
            row = self.base.query_one(
                "SELECT data FROM blobs WHERE stream_id = ? AND offset = ?",
                (self.stream_id, blob_offset),
            )
            if row is None:
                break
            blob = row[0]
            start = self.offset - blob_offset
            take = min(n, len(blob) - start)
            if take <= 0:
                break
            out += blob[start : start + take]
            self.offset += take
            n -= take
        return bytes(out)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 0:
            self.offset = pos
        elif whence == 1:
            self.offset += pos
        elif whence == 2:
            self.offset = self.size + pos
        self.offset = max(0, min(self.offset, self.size))
        return self.offset

    def tell(self) -> int:
        return self.offset


# ---------------------------------------------------------------------------
# project handle
# ---------------------------------------------------------------------------


class ProjectHandle:
    """Open project: database + engine + persist writer thread."""

    def __init__(self, path: str | Path, cfg: EngineConfig = EngineConfig(),
                 block_ticks: int = 1, device: str = "cuda"):
        self.base = ProjectBase(path)
        saved = self.base.read_workspace()
        ws = Workspace.from_persist(saved) if saved else Workspace()

        self._persist_q: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(
            target=self._persist_loop, daemon=True, name="persist"
        )
        self._writer.start()

        self.engine = Engine(
            workspace=ws,
            cfg=cfg,
            block_ticks=block_ticks,
            persist_cb=self._enqueue_persist,
            media_opener=self.base.open_media,
            device=device,
        )
        self.notify_media = threading.Event()

    def _enqueue_persist(self, snapshot: dict):
        self._persist_q.put(snapshot)

    def _persist_loop(self):
        while True:
            snapshot = self._persist_q.get()
            if snapshot is None:
                return
            # coalesce: only write the newest pending snapshot
            while True:
                try:
                    nxt = self._persist_q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self.base.write_workspace(snapshot)
                    return
                snapshot = nxt
            self.base.write_workspace(snapshot)

    # -- media uploads (project/media.rs) ----------------------------------

    def upload_media(self, name: str, kind: str, data_iter) -> p.MediaId:
        ws = self.base.create_stream()
        for chunk in data_iter:
            ws.write(chunk)
        stream_id = ws.finalize()
        media_id = self.base.insert_media(name, kind, stream_id)
        self.notify_media.set()
        return media_id

    def close(self):
        self.engine.stop()
        self._persist_q.put(None)
        self._writer.join(timeout=5.0)
        self.base.close()


def open_or_create(path: str | Path, cfg: EngineConfig = EngineConfig(),
                   block_ticks: int = 1, device: str = "cuda") -> ProjectHandle:
    return ProjectHandle(path, cfg, block_ticks=block_ticks, device=device)
