"""The port's DownloadManager (shardmerge_tpu_torch/io/download.py, on
threads and urllib) against a standard-library HTTP server on localhost:
the counterparts of tests/test_io_download.py. No test sleeps (the retry
backoff is injected) and every client has a socket timeout of seconds.

``LocalHub`` is also the Hub of the index, input and CLI tests."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import urlparse

import pytest

from shardmerge_tpu_torch.io.download import DownloadManager, DownloadStatus, resolve_hf_token

TIMEOUT = 5.0


class LocalHub:
    """A threaded localhost HTTP server serving byte blobs (or files) by
    path, counting requests per path, with an optional required token and
    paths that promise more bytes than they send."""

    def __init__(self):
        self.blobs = {}  # path -> bytes or Path
        self.bad_length = set()
        self.hits = {}
        self.auth = {}
        self.require_token = None
        self._lock = threading.Lock()

    def serve_dir(self, repo: str, directory: Path, revision: str = "main"):
        """Serve every file of ``directory`` as repo ``repo`` (resolve/ and raw/ URLs)."""
        for f in Path(directory).iterdir():
            if f.is_file():
                for kind in ("resolve", "raw"):
                    self.blobs[f"/{repo}/{kind}/{revision}/{f.name}"] = f

    def hits_of(self, suffix: str) -> int:
        return sum(n for p, n in self.hits.items() if p.endswith(suffix))

    def _handler(self):
        hub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                path = urlparse(self.path).path
                auth = self.headers.get("Authorization")
                with hub._lock:
                    hub.hits[path] = hub.hits.get(path, 0) + 1
                    hub.auth[path] = auth
                if hub.require_token is not None and auth != f"Bearer {hub.require_token}":
                    self.send_error(401)
                    return
                blob = hub.blobs.get(path)
                if blob is None:
                    self.send_error(404)
                    return
                data = blob.read_bytes() if isinstance(blob, Path) else blob
                self.send_response(200)
                extra = 10 if path in hub.bad_length else 0
                self.send_header("Content-Length", str(len(data) + extra))
                self.end_headers()
                try:
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # a header read drops the connection early
                if extra:
                    self.close_connection = True

        return Handler

    def __enter__(self):
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), self._handler())
        self.server.daemon_threads = True
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, kwargs={"poll_interval": 0.02}, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()


def _manager(path, **kw):
    return DownloadManager(storage_path=path, http_timeout=TIMEOUT, sleep=lambda s: None, **kw)


def test_download_success_and_rename(tmp_path):
    with LocalHub() as hub:
        hub.blobs["/m/shard.bin"] = b"x" * 100_000
        manager = _manager(tmp_path)
        uri = f"{hub.base}/m/shard.bin"
        assert manager.cache_file("model-a", uri, no_claims=2) is False  # a new download
        task = manager.wait("model-a", uri, timeout=TIMEOUT)
        assert task.status == DownloadStatus.COMPLETED
        path = manager.get_file("model-a", uri)
        assert path == tmp_path / "model-a" / "shard.bin"
        assert path.read_bytes() == b"x" * 100_000
        assert not path.with_suffix(".bin.tmp").exists()
        assert task.claims == 1


def test_download_404_fails(tmp_path):
    with LocalHub() as hub:
        manager = _manager(tmp_path)
        uri = f"{hub.base}/missing.bin"
        manager.cache_file("m", uri)
        assert manager.wait("m", uri, timeout=TIMEOUT).status == DownloadStatus.FAILED
        with pytest.raises(RuntimeError, match="Failed to download"):
            manager.get_file("m", uri)


def test_content_length_mismatch_fails_and_removes_tmp(tmp_path):
    with LocalHub() as hub:
        hub.blobs["/m/x.bin"] = b"y" * 5000
        hub.bad_length.add("/m/x.bin")
        manager = _manager(tmp_path)
        uri = f"{hub.base}/m/x.bin"
        manager.cache_file("m", uri)
        assert manager.wait("m", uri, timeout=TIMEOUT).status == DownloadStatus.FAILED
        assert not (tmp_path / "m" / "x.bin").exists()
        assert not (tmp_path / "m" / "x.bin.tmp").exists()


def test_retries_recover(tmp_path):
    """The first attempt 404s; the injected backoff makes the blob appear
    and records the waits it would have slept (2 s, then doubling)."""
    with LocalHub() as hub:
        waits = []

        def backoff(seconds):
            waits.append(seconds)
            hub.blobs["/m/later.bin"] = b"z" * 64

        manager = DownloadManager(storage_path=tmp_path, max_retries=3, http_timeout=TIMEOUT, sleep=backoff)
        uri = f"{hub.base}/m/later.bin"
        manager.cache_file("m", uri)
        assert manager.wait("m", uri, timeout=TIMEOUT).status == DownloadStatus.COMPLETED
        assert waits == [2.0] and hub.hits["/m/later.bin"] == 2


def test_existing_file_reused(tmp_path):
    dest = tmp_path / "m" / "shard.bin"
    dest.parent.mkdir(parents=True)
    dest.write_bytes(b"cached")
    manager = _manager(tmp_path)
    uri = "http://127.0.0.1:1/m/shard.bin"  # unreachable: must not be asked
    assert manager.cache_file("m", uri) is True
    assert manager.downloads[("m", uri)].status == DownloadStatus.COMPLETED
    assert manager.get_file("m", uri) == dest


def test_clean_cache_deletes_on_zero_claims(tmp_path):
    dest = tmp_path / "m" / "s.bin"
    dest.parent.mkdir(parents=True)
    dest.write_bytes(b"d")
    manager = _manager(tmp_path, clean_cache=True)
    uri = "http://127.0.0.1:1/m/s.bin"
    manager.cache_file("m", uri, no_claims=1)
    assert manager.get_file("m", uri) == dest  # claim -> 0
    assert manager.get_file("m", uri, claim=False) is None  # deleted
    assert not dest.exists()
    # release(): the last claim deletes at once
    dest.write_bytes(b"d")
    manager.cache_file("m", uri, no_claims=2)
    assert manager.release("m", uri) is False and dest.exists()
    assert manager.release("m", uri) is True and not dest.exists()
    assert ("m", uri) not in manager.downloads


def test_progress_callbacks(tmp_path):
    with LocalHub() as hub:
        hub.blobs["/m/p.bin"] = b"q" * 10_000
        manager = DownloadManager(storage_path=tmp_path, progress_interval=0.0, http_timeout=TIMEOUT)
        seen = []
        manager.add_progress_callback(seen.append)
        with pytest.raises(ValueError):
            manager.add_progress_callback("not callable")
        uri = f"{hub.base}/m/p.bin"
        manager.cache_file("m", uri)
        manager.wait("m", uri, timeout=TIMEOUT)
        assert seen and seen[-1].completed_jobs == 1


def test_cleanup_removes_files(tmp_path):
    for part in ["a", "b"]:
        d = tmp_path / part
        d.mkdir()
        (d / "f.bin").write_bytes(b"1")
    manager = _manager(tmp_path)
    manager.cache_file("a", "http://127.0.0.1:1/f.bin")
    manager.cache_file("b", "http://127.0.0.1:1/f.bin")
    manager.cleanup(partition="a")
    assert not (tmp_path / "a" / "f.bin").exists()
    assert (tmp_path / "b" / "f.bin").exists()
    manager.cleanup()
    assert not (tmp_path / "b" / "f.bin").exists()
    assert manager.downloads == {}


def _no_ambient_hf_auth(monkeypatch, tmp_path):
    """Deterministic token resolution: no env vars, an empty HF_HOME."""
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.delenv("HUGGING_FACE_HUB_TOKEN", raising=False)
    hf_home = tmp_path / "hfhome"
    hf_home.mkdir(exist_ok=True)
    monkeypatch.setenv("HF_HOME", str(hf_home))
    return hf_home


def test_hf_token_resolution_order_matches_jax(tmp_path, monkeypatch):
    from shardmerge_tpu.io.download import resolve_hf_token as jax_resolve

    hf_home = _no_ambient_hf_auth(monkeypatch, tmp_path)
    steps = [resolve_hf_token()]
    assert jax_resolve() is None
    (hf_home / "token").write_text("stored\n")
    steps.append(resolve_hf_token())
    monkeypatch.setenv("HF_TOKEN", "envtok")
    steps.append(resolve_hf_token())
    steps.append(resolve_hf_token("explicit"))
    assert steps == [None, "stored", "envtok", "explicit"]
    assert [jax_resolve(), jax_resolve("explicit")] == steps[2:]


def test_token_rides_shard_requests_and_401_is_actionable(tmp_path, monkeypatch):
    """Without a token a 401 fails at once with the actionable message and
    is not retried; with it every request carries the header."""
    _no_ambient_hf_auth(monkeypatch, tmp_path)
    with LocalHub() as hub:
        hub.blobs["/m/g.bin"] = b"s" * 1024
        hub.require_token = "sekret"
        uri = f"{hub.base}/m/g.bin"
        m0 = _manager(tmp_path / "s0", max_retries=3)
        m0.cache_file("p", uri)
        m0.wait("p", uri, timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="HF_TOKEN"):
            m0.get_file("p", uri)
        assert hub.hits["/m/g.bin"] == 1
        m1 = _manager(tmp_path / "s1", token="sekret")
        assert m1.fetch("p", uri).read_bytes() == b"s" * 1024
        assert hub.auth["/m/g.bin"] == "Bearer sekret"


def test_a_host_ranks_follower_transfers_nothing_and_waits_for_the_leader(tmp_path):
    """Ranks of one host share its storage: the follower registers first and
    waits; the leader's one transfer serves both. A file the leader cannot
    fetch fails the follower too (the leader's failure note), and a note an
    earlier run left is cleared by the leader."""
    with LocalHub() as hub:
        hub.blobs["/m/shard.bin"] = b"z" * 300_000
        leader, follower = _manager(tmp_path, role="lead"), _manager(tmp_path, role="follow")
        uri = f"{hub.base}/m/shard.bin"
        assert follower.cache_file("m", uri) is False
        assert not follower.downloads[("m", uri)].done.is_set()  # nothing on disk: it waits
        leader.cache_file("m", uri)
        assert follower.wait("m", uri, timeout=TIMEOUT).status == DownloadStatus.COMPLETED
        assert follower.get_file("m", uri).read_bytes() == b"z" * 300_000
        assert hub.hits_of("/m/shard.bin") == 1

        missing = f"{hub.base}/m/missing.bin"
        (tmp_path / "m" / "old.bin.failed").write_text("an earlier run")
        leader.clear_failure_notes()
        assert not list(tmp_path.rglob("*.failed"))
        follower.cache_file("m", missing)
        leader.cache_file("m", missing)
        assert follower.wait("m", missing, timeout=TIMEOUT).status == DownloadStatus.FAILED
        with pytest.raises(RuntimeError, match="downloading rank failed.*404"):
            follower.get_file("m", missing)
        assert hub.hits_of("/m/missing.bin") == 1
    with pytest.raises(ValueError, match="deletes nothing"):
        _manager(tmp_path, role="follow", clean_cache=True)
