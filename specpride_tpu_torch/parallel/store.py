"""The elastic coordinator's state store (the port's copy of the JAX
package's ``parallel/store.py``): the small-record compare-and-swap layer
the leases, the exactly-once commits and the split handshake of
:mod:`specpride_tpu_torch.parallel.coordinator` run on.

Two backends keep the JAX package's records, on disk and on the wire, so
either package reads a coordinator store the other wrote:

* :class:`FsStore`, a shared directory: ``leases/range_*.json`` created
  by ``os.link`` from a private temporary file, renewed by ``os.utime``,
  stolen by a rename to a tombstone; ``done/`` markers; ETags the sha256
  of the record's bytes.
* :class:`HttpCasStore`, a conditional-put object store (``--elastic
  http://host:port``): ``PUT`` with ``If-None-Match: *`` creates, ``PUT``
  / ``DELETE`` with ``If-Match`` replace and delete, and the server's
  ``X-SpecPride-Age`` header judges freshness on one clock.

Every protocol step is one of four atomic shapes: create-if-absent
(``put_new``), a freshness bump (``touch``), compare-and-delete
(``delete_if``) and the store-side age (``age_s``).  :class:`CasServer`
is the in-tree reference server (stdlib ``ThreadingHTTPServer``, in
memory) behind ``cas-server``.  The module holds no torch.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid

logger = logging.getLogger("specpride_tpu_torch")

# one object-store round trip: the records are tiny, so a slower answer is
# an outage the lease TTL should see, not a transfer in progress
HTTP_TIMEOUT_S = 10.0


def _etag_of(body: bytes) -> str:
    return hashlib.sha256(body).hexdigest()[:16]


def _encode(payload: dict) -> bytes:
    return (json.dumps(payload) + "\n").encode("utf-8")


def _decode(body: bytes) -> dict | None:
    """A torn or concurrent state decodes as None: "look again", never a
    crash."""
    try:
        data = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    return data if isinstance(data, dict) else None


class Store:
    """The coordinator's storage contract.  Keys are ``/``-separated
    relative paths (``leases/range_00003.json``), payloads small JSON
    objects; every mutation is atomic per key, and the protocol needs no
    transaction across keys."""

    def put_new(self, key: str, payload: dict) -> bool:
        """Create-if-absent; False when the key exists (the race is
        lost)."""
        raise NotImplementedError

    def get(self, key: str) -> tuple[dict, str] | None:
        """``(payload, etag)``, or None (absent or torn)."""
        raise NotImplementedError

    def put(self, key: str, payload: dict) -> None:
        """Unconditional replace, for single-writer records (a rank's own
        heartbeat)."""
        raise NotImplementedError

    def touch(self, key: str) -> bool:
        """Restart the key's age without changing its content; False when
        the key is gone or was replaced (the lease is lost)."""
        raise NotImplementedError

    def delete_if(self, key: str, etag: str) -> bool:
        """Remove the key if its etag still matches; False otherwise."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Best-effort unconditional delete."""
        raise NotImplementedError

    def list_keys(self, prefix: str) -> list[str]:
        """The sorted keys under ``prefix`` (one directory level)."""
        raise NotImplementedError

    def age_s(self, key: str) -> float | None:
        """Seconds since the key was last written or touched, on the
        store's clock (None when absent): the liveness input."""
        raise NotImplementedError

    def get_with_age(self, key: str
                     ) -> tuple[dict, str, float | None] | None:
        """``(payload, etag, age_s)`` in one round trip where the backend
        can: the claim and steal scans judge the age of every record they
        read."""
        got = self.get(key)
        if got is None:
            return None
        return got[0], got[1], self.age_s(key)

    def describe(self) -> str:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FsStore(Store):
    """A shared directory, in the JAX package's on-disk layout."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._now = time.time  # the store's clock (the skew tests move it)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def _write_tmp(self, path: str, payload: dict) -> str:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as fh:
            fh.write(_encode(payload))
        return tmp

    def put_new(self, key: str, payload: dict) -> bool:
        tmp = self._write_tmp(self._path(key), payload)
        try:
            os.link(tmp, self._path(key))  # create-if-absent, whole content
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)
        return True

    def get(self, key: str) -> tuple[dict, str] | None:
        try:
            with open(self._path(key), "rb") as fh:
                body = fh.read()
        except OSError:
            return None
        payload = _decode(body)
        if payload is None:
            return None
        return payload, _etag_of(body)

    def put(self, key: str, payload: dict) -> None:
        os.replace(self._write_tmp(self._path(key), payload),
                   self._path(key))

    def touch(self, key: str) -> bool:
        try:
            os.utime(self._path(key))
        except OSError:
            return False
        return True

    def delete_if(self, key: str, etag: str) -> bool:
        current = self.get(key)
        if current is None or current[1] != etag:
            return False
        # a rename, not an unlink: one racer's rename wins, and the
        # tombstone stays as evidence of the steal
        path = self._path(key)
        try:
            os.rename(path, f"{path}.dead.{os.getpid()}."
                            f"{uuid.uuid4().hex[:8]}")
        except FileNotFoundError:
            return False
        return True

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def list_keys(self, prefix: str) -> list[str]:
        try:
            names = os.listdir(self._path(prefix.rstrip("/")))
        except OSError:
            return []
        clean = prefix.rstrip("/") + "/"
        return sorted(clean + name for name in names
                      if not name.endswith(".lock")
                      and ".tmp." not in name and ".dead." not in name)

    def age_s(self, key: str) -> float | None:
        try:
            mtime = os.stat(self._path(key)).st_mtime
        except OSError:
            return None
        return max(self._now() - mtime, 0.0)

    def describe(self) -> str:
        return f"filesystem:{self.root}"


class HttpCasStore(Store):
    """The conditional-put / ETag object-store client (``--elastic
    URL``): each step one HTTP round trip, a lost race a 412 mapped onto
    the False or None the filesystem backend returns; freshness is the
    server's ``X-SpecPride-Age``, so a skewed client never judges a live
    lease expired early."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def _request(self, method: str, key: str, body: bytes | None = None,
                 headers: dict | None = None):
        req = urllib.request.Request(f"{self.base_url}/{key}", data=body,
                                     method=method, headers=headers or {})
        return urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S)

    def put_new(self, key: str, payload: dict) -> bool:
        try:
            with self._request("PUT", key, _encode(payload),
                               {"If-None-Match": "*"}):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 412:
                return False
            raise

    def _get(self, key: str):
        """``(body, etag, age header)`` of one GET, or None on 404."""
        try:
            with self._request("GET", key) as resp:
                return (resp.read(), resp.headers.get("ETag", ""),
                        resp.headers.get("X-SpecPride-Age"))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def get(self, key: str) -> tuple[dict, str] | None:
        got = self.get_with_age(key)
        return None if got is None else (got[0], got[1])

    def put(self, key: str, payload: dict) -> None:
        with self._request("PUT", key, _encode(payload)):
            pass

    def touch(self, key: str) -> bool:
        current = self.get(key)
        if current is None:
            return False
        payload, etag = current
        try:
            with self._request("PUT", key, _encode(payload),
                               {"If-Match": f'"{etag}"'}):
                return True
        except urllib.error.HTTPError as e:
            if e.code in (404, 412):
                return False
            raise

    def delete_if(self, key: str, etag: str) -> bool:
        try:
            with self._request("DELETE", key,
                               headers={"If-Match": f'"{etag}"'}):
                return True
        except urllib.error.HTTPError as e:
            if e.code in (404, 412):
                return False
            raise

    def delete(self, key: str) -> None:
        try:
            with self._request("DELETE", key):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def list_keys(self, prefix: str) -> list[str]:
        url = f"{self.base_url}/?prefix={urllib.parse.quote(prefix)}"
        with urllib.request.urlopen(urllib.request.Request(url),
                                    timeout=HTTP_TIMEOUT_S) as resp:
            data = json.loads(resp.read().decode("utf-8"))
        keys = data.get("keys", []) if isinstance(data, dict) else []
        return sorted(k for k in keys if isinstance(k, str))

    def age_s(self, key: str) -> float | None:
        got = self._get(key)
        return None if got is None else _age(got[2])

    def get_with_age(self, key: str
                     ) -> tuple[dict, str, float | None] | None:
        """Body, ETag and the server's age off one GET."""
        got = self._get(key)
        if got is None:
            return None
        body, etag, age = got
        payload = _decode(body)
        if payload is None:
            return None
        return payload, etag.strip('"'), _age(age)

    def describe(self) -> str:
        return f"object-store:{self.base_url}"


def _age(header) -> float | None:
    try:
        return max(float(header), 0.0)
    except (TypeError, ValueError):
        return None


def is_remote_spec(spec: str) -> bool:
    return spec.startswith(("http://", "https://"))


def store_from_spec(spec: str) -> Store:
    """An ``--elastic`` value as its backend: an ``http(s)://`` URL is
    the object-store client, anything else a shared directory."""
    return HttpCasStore(spec) if is_remote_spec(spec) else FsStore(spec)


# -- the in-tree CAS server -------------------------------------------------


class CasServer:
    """An in-memory conditional-put object store over HTTP, the
    reference of the contract :class:`HttpCasStore` speaks:

    * ``PUT``: replace; ``If-None-Match: *`` creates only (412 if
      present); ``If-Match: <etag>`` replaces only if unchanged (412
      otherwise).  The reply carries the new ``ETag``.
    * ``GET``: the body, ``ETag`` and ``X-SpecPride-Age`` (seconds since
      the last write, on the server's clock); ``GET /?prefix=P`` lists
      keys.
    * ``DELETE``: with an optional ``If-Match``.

    ETags are revisions (``"<rev>-<sha12>"``): two writes of the same
    bytes still get distinct etags, so an etag-guarded steal never takes
    a re-claimed lease for the one it read."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._lock = threading.Lock()
        # key -> (body, etag, last write on the monotonic clock)
        self._data: dict[str, tuple[bytes, str, float]] = {}
        self._rev = 0
        store = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # the stdlib default spams stderr
                pass

            def _key(self) -> str:
                return self.path.lstrip("/").split("?", 1)[0]

            def _reply(self, code: int, body: bytes = b"",
                       headers: dict | None = None) -> None:
                self.send_response(code)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - stdlib naming
                if "?" in self.path and "prefix=" in self.path:
                    prefix = urllib.parse.unquote(
                        self.path.split("prefix=", 1)[1].split("&", 1)[0])
                    with store._lock:
                        keys = sorted(k for k in store._data
                                      if k.startswith(prefix))
                    self._reply(200, json.dumps({"keys": keys}).encode(),
                                {"Content-Type": "application/json"})
                    return
                with store._lock:
                    rec = store._data.get(self._key())
                    now = time.monotonic()
                if rec is None:
                    self._reply(404)
                    return
                body, etag, written = rec
                self._reply(200, body, {
                    "ETag": f'"{etag}"',
                    "X-SpecPride-Age": f"{max(now - written, 0.0):.3f}",
                    "Content-Type": "application/json",
                })

            def do_PUT(self):  # noqa: N802 - stdlib naming
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                key = self._key()
                if_none = self.headers.get("If-None-Match")
                if_match = self.headers.get("If-Match")
                with store._lock:
                    existing = store._data.get(key)
                    if if_none == "*" and existing is not None:
                        self._reply(412)
                        return
                    if if_match is not None and (
                            existing is None
                            or existing[1] != if_match.strip('"')):
                        self._reply(412)
                        return
                    store._rev += 1
                    etag = (f"{store._rev}-"
                            f"{hashlib.sha256(body).hexdigest()[:12]}")
                    store._data[key] = (body, etag, time.monotonic())
                self._reply(201 if existing is None else 200, b"",
                            {"ETag": f'"{etag}"'})

            def do_DELETE(self):  # noqa: N802 - stdlib naming
                key = self._key()
                if_match = self.headers.get("If-Match")
                with store._lock:
                    existing = store._data.get(key)
                    if existing is None:
                        self._reply(404)
                        return
                    if if_match is not None and (
                            existing[1] != if_match.strip('"')):
                        self._reply(412)
                        return
                    del store._data[key]
                self._reply(204)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "CasServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="specpride-cas-server",
                                        daemon=True)
        self._thread.start()
        logger.info("CAS server listening on %s", self.url)
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
