"""HTTP download manager with partitioned, claim-counted caching
(counterpart of shardmerge_tpu/io/download.py), on threads and the
standard library's ``urllib``.

Each file downloads on its own daemon thread (at most ``max_concurrent``
transfers at once) in 1 MiB chunks into ``<name>.tmp``, is checked against
its content-length and renamed into ``<storage>/<partition>/<name>``. A
failed transfer is retried ``max_retries`` times with exponential backoff
(``sleep`` is injectable, so tests never wait); HTTP 401/403 raise the
actionable token error at once and are never retried. Claims count the
readers a file still has: with ``clean_cache`` a file whose claims are used
up is deleted (``release``, or ``get_file`` as in the JAX package), and
``cleanup`` deletes every file the manager knows.

Every request carries the resolved HuggingFace token (``--token``,
``HF_TOKEN``/``HUGGING_FACE_HUB_TOKEN``, then the stored
``huggingface-cli login``).

Merge ranks that share a host share its storage: one of them (``role``
"lead", local rank 0) transfers each file and leaves a failure note
``<name>.failed`` beside a file it could not fetch; the others ("follow")
transfer nothing and wait for the file to be renamed into place, or for
the note. A follower deletes nothing, so ``clean_cache`` is refused with
it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import unquote, urlparse

logger = logging.getLogger(__name__)

__all__ = [
    "DownloadManager",
    "DownloadStats",
    "DownloadStatus",
    "DownloadTask",
    "auth_error",
    "hf_auth_headers",
    "http_get",
    "resolve_hf_token",
]

_CHUNK_SIZE = 1 << 20  # 1 MiB
_POLL_S = 0.05  # a follower's look for the leader's file


def resolve_hf_token(token: Optional[str] = None) -> Optional[str]:
    """A HuggingFace access token: the argument, then the HF_TOKEN /
    HUGGING_FACE_HUB_TOKEN environment variables, then the stored login
    (``$HF_HOME/token``); None when nothing is configured."""
    if token:
        return token
    for var in ("HF_TOKEN", "HUGGING_FACE_HUB_TOKEN"):
        v = os.environ.get(var)
        if v:
            return v
    tok_file = Path(os.environ.get("HF_HOME") or Path.home() / ".cache" / "huggingface") / "token"
    try:
        v = tok_file.read_text().strip()
    except OSError:
        return None
    return v or None


def hf_auth_headers(token: Optional[str] = None) -> dict:
    """Authorization header dict for HF requests ({} when anonymous)."""
    t = resolve_hf_token(token)
    return {"Authorization": f"Bearer {t}"} if t else {}


def auth_error(status: int, uri: str) -> RuntimeError:
    """A loud, actionable error for HTTP 401/403 on a HF-shaped URL."""
    return RuntimeError(
        f"{uri} returned HTTP {status} — the repo is gated or private. "
        "Pass --token, set HF_TOKEN, or run `huggingface-cli login` "
        "(and accept the repo's license on huggingface.co if gated)."
    )


def http_get(url: str, headers: dict, timeout: float):
    """Open a GET response; 401/403 raise :func:`auth_error`, other HTTP
    errors raise ``urllib.error.HTTPError`` (``.code`` holds the status)."""
    try:
        return urllib.request.urlopen(urllib.request.Request(url, headers=headers), timeout=timeout)
    except urllib.error.HTTPError as e:
        if e.code in (401, 403):
            e.close()
            raise auth_error(e.code, url) from None
        raise


class DownloadStatus(Enum):
    PENDING = "pending"
    DOWNLOADING = "downloading"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass
class DownloadTask:
    """One registered download; ``done`` is set when the transfer ends."""

    uri: str
    partition: str
    path: Path
    total_size: int
    downloaded: int
    status: DownloadStatus
    claims: int
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[str] = None  # failure cause, surfaced by get_file


@dataclass
class DownloadStats:
    active_workers: int
    completed_jobs: int
    failed_jobs: int
    total_downloaded: int
    total_size: int

    @property
    def progress_pct(self) -> float:
        if self.total_size == 0:
            return 0.0
        return (self.total_downloaded / self.total_size) * 100


class DownloadManager:
    """Concurrent downloads into per-model partition directories."""

    def __init__(
        self,
        storage_path,
        progress_interval: float = 1.0,
        clean_cache: bool = False,
        http_timeout: float = 3600.0,
        max_retries: int = 0,
        max_concurrent: int = 8,
        token: Optional[str] = None,
        sleep: Callable[[float], None] = time.sleep,
        role: str = "alone",
    ):
        if role not in ("alone", "lead", "follow"):
            raise ValueError(f"role {role!r}: expected 'alone', 'lead' or 'follow'")
        if role == "follow" and clean_cache:
            raise ValueError("a following download manager deletes nothing: clean_cache is the leader's alone")
        self.role = role
        self.storage_path = Path(storage_path)
        self.progress_interval = progress_interval
        self.last_progress_time = 0.0
        self.clean_cache = clean_cache
        self.http_timeout = http_timeout
        self.max_retries = max_retries
        self.headers = hf_auth_headers(token)
        self.sleep = sleep
        self.downloads: Dict[Tuple[str, str], DownloadTask] = {}
        self.progress_callbacks: List[Callable[[DownloadStats], None]] = []
        # bytes transferred, and the wall from the first transfer's start
        # to the last one's end
        self.bytes_downloaded = 0
        self.first_start: Optional[float] = None
        self.last_end: Optional[float] = None
        self._lock = threading.Lock()
        self._slots = threading.Semaphore(max_concurrent)

    # -- helpers ------------------------------------------------------------

    def _clean_filename(self, uri: str) -> str:
        return os.path.basename(unquote(urlparse(uri).path))

    def _get_partition_path(self, partition: str) -> Path:
        partition_path = self.storage_path / partition
        partition_path.mkdir(parents=True, exist_ok=True)
        return partition_path

    # -- public API ----------------------------------------------------------

    def cache_file(self, partition: str, uri: str, no_claims: int = 1) -> bool:
        """Register ``uri`` for download into ``partition``.

        Returns True if the file already exists or is in flight (its claim
        count is reset to ``no_claims``), False if a transfer was started."""
        key = (partition, uri)
        with self._lock:
            task = self.downloads.get(key)
            if task is not None:
                task.claims = no_claims
                return True
            dest = self._get_partition_path(partition) / self._clean_filename(uri)
            task = DownloadTask(uri=uri, partition=partition, path=dest, total_size=0,
                                downloaded=0, status=DownloadStatus.PENDING, claims=no_claims)
            self.downloads[key] = task
            if dest.exists():
                task.status = DownloadStatus.COMPLETED
                task.total_size = task.downloaded = dest.stat().st_size
                task.done.set()
        if task.done.is_set():
            self._check_progress(force=True)
            return True
        follow = self.role == "follow"
        if follow:
            logger.info("Waiting for the host's downloading rank to fetch %s to %s", uri, dest)
        else:
            logger.info("Starting download of %s to %s", uri, dest)
        threading.Thread(target=self._await_file if follow else self._download_file, args=(task,),
                         daemon=True, name=f"download-{dest.name}").start()
        return False

    def wait(self, partition: str, uri: str, timeout: Optional[float] = None) -> DownloadTask:
        """Block until the registered transfer of ``uri`` has ended."""
        task = self.downloads[(partition, uri)]
        if not task.done.wait(timeout):
            raise TimeoutError(f"download of {uri} did not finish in {timeout} s")
        return task

    def get_file(self, partition: str, uri: str, claim: bool = True) -> Optional[Path]:
        """Path to a downloaded file (None while it is in flight); takes one
        claim. With ``clean_cache`` a file whose claims are used up is
        deleted here and None returned. Raises RuntimeError for an
        unregistered or failed download."""
        key = (partition, uri)
        with self._lock:
            task = self.downloads.get(key)
            if task is None:
                raise RuntimeError(f"No download registered for {uri}")
            if self.clean_cache and task.claims <= 0:
                logger.debug("Removing %s due to zero claims", task.path)
                task.path.unlink(missing_ok=True)
                del self.downloads[key]
                return None
            if claim:
                task.claims -= 1
        if task.status == DownloadStatus.FAILED:
            cause = f": {task.error}" if task.error else ""
            raise RuntimeError(f"Failed to download {uri}{cause}")
        if task.status == DownloadStatus.COMPLETED:
            return task.path
        return None

    def fetch(self, partition: str, uri: str, no_claims: int = 1) -> Path:
        """Register ``uri`` (if it is not yet), wait for it and return its
        path without taking a claim; one transfer however many threads ask."""
        key = (partition, uri)
        with self._lock:
            known = key in self.downloads
        if not known:
            self.cache_file(partition, uri, no_claims=no_claims)
        self.wait(partition, uri)
        path = self.get_file(partition, uri, claim=False)
        if path is None:  # removed at zero claims meanwhile: fetch it again
            return self.fetch(partition, uri, no_claims)
        return path

    def release(self, partition: str, uri: str) -> bool:
        """Take one claim; with ``clean_cache`` delete the file once its
        claims are used up. Returns whether it was deleted."""
        key = (partition, uri)
        with self._lock:
            task = self.downloads.get(key)
            if task is None:
                return False
            task.claims -= 1
            if not (self.clean_cache and task.claims <= 0 and task.done.is_set()):
                return False
            task.path.unlink(missing_ok=True)
            del self.downloads[key]
        logger.info("Removed %s: its last tensor was read", task.path)
        return True

    def add_progress_callback(self, callback):
        if not callable(callback):
            raise ValueError("Callback must be callable")
        self.progress_callbacks.append(callback)

    def cleanup(self, partition: Optional[str] = None):
        """Delete downloaded files (one partition, or all)."""
        with self._lock:
            keys = [k for k in self.downloads if partition is None or k[0] == partition]
            for key in keys:
                task = self.downloads.pop(key)
                if task.path.exists():
                    logger.info("Removing cache file: %s", task.path)
                    task.path.unlink()

    def clear_failure_notes(self):
        """Delete the failure notes an earlier run left in storage (the
        leader does, before any follower waits on a note)."""
        for note in self.storage_path.rglob("*.failed"):
            note.unlink(missing_ok=True)

    # -- transfer ------------------------------------------------------------

    @staticmethod
    def _failure_note(path: Path) -> Path:
        return path.with_suffix(path.suffix + ".failed")

    def _transfer(self, task: DownloadTask, temp_path: Path):
        with self._slots, http_get(task.uri, self.headers, self.http_timeout) as response:
            length = response.headers.get("Content-Length")
            task.total_size = int(length) if length else 0
            task.downloaded = 0
            chunk = memoryview(bytearray(_CHUNK_SIZE))
            with open(temp_path, "wb") as f:
                while True:
                    n = response.readinto(chunk)
                    if not n:
                        break
                    f.write(chunk[:n])
                    task.downloaded += n
                    self._check_progress()
        if temp_path.stat().st_size != task.total_size:
            raise RuntimeError(f"Downloaded size does not match content-length for {task.uri}")

    def _download_file(self, task: DownloadTask):
        temp_path = task.path.with_suffix(task.path.suffix + ".tmp")
        note = self._failure_note(task.path)
        if self.role == "lead":
            note.unlink(missing_ok=True)
        with self._lock:
            if self.first_start is None:
                self.first_start = time.perf_counter()
        try:
            task.status = DownloadStatus.DOWNLOADING
            self._check_progress(force=True)
            attempt = 0
            while True:
                try:
                    self._transfer(task, temp_path)
                    break
                except Exception as e:
                    # auth failures are not transient: a retry only delays
                    # the actionable message
                    if "gated or private" in str(e) or attempt >= self.max_retries:
                        raise
                    attempt += 1
                    backoff = min(2.0**attempt, 30.0)
                    logger.warning("Download of %s failed (%s; attempt %d/%d); retrying in %.0fs",
                                   task.uri, e, attempt, self.max_retries, backoff)
                    self.sleep(backoff)
            os.replace(temp_path, task.path)
            with self._lock:
                self.bytes_downloaded += task.downloaded
                self.last_end = time.perf_counter()
            task.status = DownloadStatus.COMPLETED
            logger.info("Download completed for %s -> %s", task.uri, task.path)
        except Exception as e:
            task.status = DownloadStatus.FAILED
            task.error = str(e)
            logger.error("Download failed for %s: %s", task.uri, e)
            temp_path.unlink(missing_ok=True)
            if self.role == "lead":
                # followers on this host wait on the file: tell them it is not coming
                note_tmp = note.with_suffix(".failed.tmp")
                note_tmp.write_text(str(e))
                os.replace(note_tmp, note)
        finally:
            try:
                self._check_progress(force=True)
            finally:
                task.done.set()

    def _await_file(self, task: DownloadTask):
        """A follower's transfer: wait until the leader has renamed the file
        into place whole. Fails on the leader's failure note, or when its
        transfer shows no progress for ``http_timeout`` seconds (the
        leader's own socket timeout)."""
        temp_path = task.path.with_suffix(task.path.suffix + ".tmp")
        note = self._failure_note(task.path)
        task.status = DownloadStatus.DOWNLOADING
        seen, since = None, time.monotonic()
        try:
            while not task.path.exists():
                if note.exists():
                    raise RuntimeError(f"the host's downloading rank failed: {note.read_text()}")
                try:
                    size = temp_path.stat().st_size
                except OSError:  # not begun, or just renamed
                    size = None
                if size != seen:
                    seen, since = size, time.monotonic()
                elif time.monotonic() - since > self.http_timeout:
                    raise TimeoutError(f"the host's downloading rank made no progress on {task.uri} "
                                       f"in {self.http_timeout:.0f} s")
                time.sleep(_POLL_S)
            task.total_size = task.downloaded = task.path.stat().st_size
            task.status = DownloadStatus.COMPLETED
        except Exception as e:
            task.status = DownloadStatus.FAILED
            task.error = str(e)
            logger.error("Download failed for %s: %s", task.uri, e)
        finally:
            task.done.set()

    def _check_progress(self, force: bool = False):
        now = time.time()
        if not force and now - self.last_progress_time < self.progress_interval:
            return
        self.last_progress_time = now
        active = completed = failed = 0
        total_downloaded = total_size = 0
        for task in list(self.downloads.values()):
            if task.status == DownloadStatus.DOWNLOADING:
                active += 1
                total_downloaded += task.downloaded
                total_size += task.total_size
            elif task.status == DownloadStatus.COMPLETED:
                completed += 1
            elif task.status == DownloadStatus.FAILED:
                failed += 1
        stats = DownloadStats(active, completed, failed, total_downloaded, total_size)
        logger.debug("Download stats - Active: %d, Completed: %d, Failed: %d, Progress: %.1f%%",
                     active, completed, failed, stats.progress_pct)
        for callback in self.progress_callbacks:
            callback(stats)
