"""Crash-safe checkpoint store: atomic publish, integrity header, rotation.

The legacy B&B checkpoint path was a bare ``np.savez_compressed(path)`` —
a crash mid-write left a truncated file that ``np.load`` could not read,
and the campaign's only snapshot was gone. This store fixes all three
failure classes:

- **atomicity**: payloads are written to a same-directory temp file,
  fsync'd, and ``os.replace``'d into place — a reader never observes a
  half-written final path;
- **integrity**: every file carries a header (magic, format version,
  instance fingerprint, payload length, blake2b checksum) so a torn or
  bit-rotted snapshot is DETECTED on read instead of exploding inside
  ``np.load`` — or worse, resuming silently wrong;
- **rotation**: the last ``keep`` good snapshots are retained
  (``path``, ``path.1``, ..., newest first), and
  :func:`read_with_fallback` walks them newest-to-oldest, returning the
  newest VALID snapshot instead of raising on the first corrupt one.
  Each fallback counts into ``HEALTH.fallback_restores``.

File layout::

    b"TSPCKPT1" | u32 header_len | header JSON | payload bytes

Legacy headerless files (bare ``.npz``, zip magic ``PK``) are still
readable — integrity is then whatever ``np.load`` can make of them.

Fault seams: ``ckpt.write`` filters the full file image before publish
(``truncate`` publishes the torn image THEN raises, modeling a writer
killed after the rename was queued; ``corrupt`` publishes silently);
``ckpt.read`` filters each candidate's bytes during restore.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .faults import FaultInjected, registry
from .health import HEALTH

MAGIC = b"TSPCKPT1"
#: the process umask, captured once at import (single-threaded) — mkstemp
#: creates 0600 files, but a PUBLISHED snapshot/cache entry must carry
#: the same permissions the old ``open(path + ".tmp", "wb")`` writer gave
#: it, or a store shared between users turns read-denied after this
#: writer touches it
_UMASK = os.umask(0)
os.umask(_UMASK)
FORMAT_VERSION = 1
#: rotation depth: how many good snapshots survive (env-overridable)
DEFAULT_KEEP = 3
_LEGACY_ZIP_MAGIC = b"PK"


class CheckpointError(RuntimeError):
    """A checkpoint file failed integrity verification."""


def default_keep() -> int:
    try:
        return max(1, int(os.environ.get("TSP_CKPT_KEEP", DEFAULT_KEEP)))
    except ValueError:
        return DEFAULT_KEEP


def instance_fingerprint(d) -> str:
    """Content hash of a distance matrix: shape + exact float64 bytes.
    Deterministic across processes, so a resumed chunk can verify it is
    continuing the SAME instance before any solver state is touched."""
    a = np.ascontiguousarray(np.asarray(d, np.float64))
    h = hashlib.blake2b(digest_size=16)
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _checksum(payload: bytes) -> str:
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


def pack(
    payload: bytes,
    fingerprint: Optional[str] = None,
    extra_header: Optional[Dict] = None,
) -> bytes:
    """``extra_header``: additional JSON-serializable header keys (e.g.
    the engine's ``frontier_layout`` version). Purely informational —
    readers ignore keys they don't know, so old snapshots (without them)
    and old readers (seeing new ones) both keep working; the reserved
    integrity keys above cannot be overridden."""
    header_dict = dict(extra_header or {})
    header_dict.update(
        {
            "version": FORMAT_VERSION,
            "fingerprint": fingerprint,
            "payload_len": len(payload),
            "checksum": _checksum(payload),
        }
    )
    header = json.dumps(header_dict).encode()
    return MAGIC + struct.pack(">I", len(header)) + header + payload


def _parse_header(blob: bytes) -> Tuple[Optional[Dict], int]:
    """Returns ``(header, payload_offset)``; header None for legacy bare
    npz. Raises CheckpointError on a torn/unrecognized image."""
    if blob[:2] == _LEGACY_ZIP_MAGIC:
        return None, 0
    if len(blob) < len(MAGIC) + 4 or blob[: len(MAGIC)] != MAGIC:
        raise CheckpointError("unrecognized checkpoint image (bad magic)")
    (hlen,) = struct.unpack(">I", blob[len(MAGIC) : len(MAGIC) + 4])
    start = len(MAGIC) + 4
    if len(blob) < start + hlen:
        raise CheckpointError("truncated checkpoint header")
    try:
        header = json.loads(blob[start : start + hlen])
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointError(f"unparseable checkpoint header: {e}") from None
    if header.get("version") != FORMAT_VERSION:
        raise CheckpointError(
            f"unsupported checkpoint format version {header.get('version')!r}"
        )
    return header, start + hlen


def unpack(blob: bytes) -> Tuple[Optional[Dict], bytes]:
    """Verify and split a file image into ``(header, payload)``. Raises
    :class:`CheckpointError` on any integrity violation."""
    header, off = _parse_header(blob)
    payload = blob[off:]
    if header is None:
        return None, payload
    if len(payload) != header["payload_len"]:
        raise CheckpointError(
            f"truncated checkpoint payload: {len(payload)} bytes, "
            f"header promises {header['payload_len']}"
        )
    if _checksum(payload) != header["checksum"]:
        raise CheckpointError("checkpoint payload checksum mismatch")
    return header, payload


def read_header(path: str) -> Optional[Dict]:
    """Header of ``path`` without touching the payload (cheap pre-flight
    for fingerprint checks). None for legacy headerless files."""
    with open(path, "rb") as f:
        prefix = f.read(len(MAGIC) + 4)
        if prefix[:2] == _LEGACY_ZIP_MAGIC:
            return None
        if len(prefix) < len(MAGIC) + 4 or prefix[: len(MAGIC)] != MAGIC:
            raise CheckpointError("unrecognized checkpoint image (bad magic)")
        (hlen,) = struct.unpack(">I", prefix[len(MAGIC) :])
        raw = f.read(hlen)
    if len(raw) < hlen:
        raise CheckpointError("truncated checkpoint header")
    try:
        return json.loads(raw)
    except (ValueError, UnicodeDecodeError) as e:
        raise CheckpointError(f"unparseable checkpoint header: {e}") from None


def rotation_paths(path: str, keep: Optional[int] = None) -> List[str]:
    """Candidate snapshot paths, newest first."""
    keep = default_keep() if keep is None else keep
    return [path] + [f"{path}.{i}" for i in range(1, keep)]


def write_atomic(
    path: str,
    payload: bytes,
    *,
    fingerprint: Optional[str] = None,
    keep: Optional[int] = None,
    extra_header: Optional[Dict] = None,
) -> None:
    """Publish a snapshot crash-safely: temp file + fsync + rotation shift
    + ``os.replace``. The previous ``keep - 1`` good snapshots survive as
    ``path.1 ... path.{keep-1}``. ``extra_header``: see :func:`pack`."""
    import tempfile

    keep = default_keep() if keep is None else max(1, keep)
    blob = pack(payload, fingerprint, extra_header)
    blob, injected = registry().filter_bytes("ckpt.write", blob)
    # UNIQUE same-directory temp name (mkstemp), not a fixed `path.tmp`:
    # the shared fleet cache tier publishes the same final path from
    # MULTIPLE processes concurrently, and a fixed temp name lets racer
    # B truncate the file racer A is about to os.replace into place — a
    # torn image at the final path, exactly what this writer exists to
    # prevent. With unique temps every publish replaces a fully-written,
    # fsync'd image; racers just decide who wins the rename.
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)),
        prefix=os.path.basename(path) + ".tmp.",
    )
    try:
        os.fchmod(fd, 0o666 & ~_UMASK)  # umask semantics, not mkstemp's 0600
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        # rotation shift: path -> path.1 -> ... (oldest dropped). Done
        # before the publish so the newest PREVIOUS snapshot is always
        # recoverable.
        chain = rotation_paths(path, keep)
        for older, newer in zip(reversed(chain[1:]), reversed(chain[:-1])):
            if os.path.exists(newer):
                os.replace(newer, older)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    if injected == "truncate":
        # the torn image reached the final path (writer "killed" after the
        # rename was queued) — now crash, as the real failure would
        raise FaultInjected("ckpt.write", "truncate", registry().hits("ckpt.write"))


#: per-directory throttle for :func:`maybe_sweep_stale_tmp` (the hot
#: shared-cache lookup path must not pay a listdir per read)
_SWEEP_SEEN: Dict[str, float] = {}
_SWEEP_LOCK = None  # created lazily to keep this module import-light


def maybe_sweep_stale_tmp(dirname: str, min_interval_s: float = 300.0) -> int:
    """Throttled :func:`sweep_stale_tmp`: at most one real sweep per
    directory per ``min_interval_s`` per process — the read path calls
    this freely (one dict lookup when throttled)."""
    global _SWEEP_LOCK
    if _SWEEP_LOCK is None:
        import threading

        _SWEEP_LOCK = threading.Lock()
    now = time.monotonic()
    with _SWEEP_LOCK:
        last = _SWEEP_SEEN.get(dirname)
        if last is not None and now - last < min_interval_s:
            return 0
        _SWEEP_SEEN[dirname] = now
    return sweep_stale_tmp(dirname)


def sweep_stale_tmp(dirname: str, max_age_s: float = 60.0) -> int:
    """Remove orphaned ``*.tmp.*`` files (a writer SIGKILLed between
    :func:`write_atomic`'s mkstemp and its ``os.replace`` leaves one —
    the price of the unique temp names concurrent publishers need).
    Only files older than ``max_age_s`` go: a live publisher's temp
    exists for milliseconds, so the age bound can never race one.
    Returns the number removed. Call on opening a long-lived store
    directory (the fleet's shared cache tier does)."""
    removed = 0
    try:
        names = os.listdir(dirname)
    except OSError:
        return 0
    now = time.time()
    for name in names:
        if ".tmp." not in name:
            continue
        path = os.path.join(dirname, name)
        try:
            if now - os.stat(path).st_mtime > max_age_s:
                os.unlink(path)
                removed += 1
        except OSError:
            continue  # vanished / racing sweeper: someone else got it
    return removed


def _fsync_dir(dirname: str) -> None:
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds: best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def read_with_fallback(
    path: str, *, keep: Optional[int] = None
) -> Tuple[Optional[Dict], bytes, str, int]:
    """Read the newest VALID snapshot in the rotation chain.

    Returns ``(header, payload, source_path, fallbacks)`` where
    ``fallbacks`` counts newer candidates that were skipped as missing or
    corrupt. Raises :class:`CheckpointError` when no candidate survives
    verification (the per-candidate reasons are in the message)."""
    from .retry import RetryPolicy

    def read_candidate(cand: str) -> bytes:
        with open(cand, "rb") as f:
            blob = f.read()
        return registry().filter_bytes("ckpt.read", blob)[0]

    # reading a store is the natural sweep point for temps orphaned by
    # SIGKILLed writers (chunk campaigns resume every chunk; the fleet
    # cache tier also sweeps at its own init) — THROTTLED, because the
    # shared cache tier routes every L2 lookup through here and a
    # listdir per read would scale lookup cost with directory size;
    # age-bounded, so a concurrent writer's live temp is never raced
    maybe_sweep_stale_tmp(os.path.dirname(os.path.abspath(path)))
    # a TRANSIENT read failure (flaky storage, an injected ckpt.read
    # raise) is retried before the candidate is written off — falling
    # back a rotation step over a hiccup would silently discard progress
    read_retry = RetryPolicy(max_attempts=2, base_delay_s=0.005, seed=0)
    failures: List[str] = []
    for idx, cand in enumerate(rotation_paths(path, keep)):
        try:
            blob = read_retry.call(lambda c=cand: read_candidate(c))
            header, payload = unpack(blob)
        except FileNotFoundError:
            failures.append(f"{cand}: missing")
            continue
        except (CheckpointError, OSError, FaultInjected) as e:
            failures.append(f"{cand}: {e}")
            continue
        if idx > 0:
            HEALTH.incr("fallback_restores")
        return header, payload, cand, idx
    raise CheckpointError(
        f"no valid checkpoint in rotation of {path!r}: " + "; ".join(failures)
    )


def write_json_atomic(path: str, obj, *, indent: Optional[int] = 1) -> None:
    """Atomic publish for durable JSON artifacts (bench/profile outputs):
    the crash-safe replacement for ``open(path, "w")``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def npz_bytes(**arrays) -> bytes:
    """Serialize arrays to in-memory ``.npz`` bytes (the store's payload)."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()
