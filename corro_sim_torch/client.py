"""Client library — the `corro-client` crate's surface over HTTP.

Mirrors ``CorrosionApiClient`` (``crates/corro-client/src/lib.rs:32-345``):
``execute``, ``query`` (streaming), ``schema``, ``subscribe`` /
``subscription`` (re-attach by id with ``from=``), and
``CorrosionPooledClient``-style multi-address failover
(``lib.rs:377-640``). Subscription streams decode ND-JSON and track the
last observed change id so a dropped connection resumes where it left off
(``corro-client/src/sub.rs:57-309``).

Port of ``corro_sim/client.py`` (standard library only); it speaks the
same wire, so either package's client talks to either package's server.
"""

from __future__ import annotations

import http.client
import json
import socket
import urllib.parse

from corro_sim_torch.api.wire import decode_values as _decode_wire
from corro_sim_torch.api.wire import encode_value as _encode_wire


class ApiClientError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status
        self.message = message


class SubscriptionStream:
    """Iterator over live QueryEvents with observed-change-id tracking.

    ``sub.rs:100-180``: the reference stream remembers the greatest change
    id it has yielded; `resume()` re-attaches with ``from=`` so no event is
    dropped or replayed across reconnects."""

    def __init__(self, client: "ApiClient", sub_id: str, hash_: str, resp):
        self.client = client
        self.id = sub_id
        self.hash = hash_
        self._resp = resp
        self.last_change_id: int | None = None

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        line = self._resp.readline()
        if not line:
            raise StopIteration
        event = _decode_wire(json.loads(line))
        cid = _change_id_of(event)
        if cid is not None:
            self.last_change_id = cid
        return event

    def events(self, n: int) -> list[dict]:
        """Collect exactly n events (bounded by the client socket timeout)."""
        return [next(self) for _ in range(n)]

    def close(self) -> None:
        try:
            self._resp.close()
        except Exception:
            pass

    def resume(self) -> "SubscriptionStream":
        """Re-attach after a disconnect, catching up from the last seen
        change id (the reference client's reconnect loop). If no change id
        was ever observed (dropped before the eoq), re-attach with a full
        snapshot — skipping rows there would silently lose every event
        since subscribe."""
        if self.last_change_id is None:
            return self.client.subscription(self.id, skip_rows=False)
        return self.client.subscription(
            self.id, from_change_id=self.last_change_id, skip_rows=True
        )


def _change_id_of(event: dict) -> int | None:
    if "change" in event:
        return event["change"][3]
    if "eoq" in event:
        return event["eoq"].get("change_id")
    return None


class ApiClient:
    """One-address client (``CorrosionApiClient``)."""

    def __init__(
        self,
        addr: tuple[str, int] | str,
        token: str | None = None,
        node: int | None = None,
        timeout: float = 30.0,
        ssl_context=None,
    ):
        tls = ssl_context is not None
        if isinstance(addr, str):
            u = urllib.parse.urlparse(
                addr if "//" in addr else f"http://{addr}"
            )
            tls = tls or u.scheme == "https"
            addr = (u.hostname or "127.0.0.1",
                    u.port or (443 if tls else 80))
        self.addr = addr
        self.token = token
        self.node = node  # default target agent ordinal
        self.timeout = timeout
        if tls and ssl_context is None:
            import ssl as _ssl

            ssl_context = _ssl.create_default_context()
        self.ssl_context = ssl_context

    # ---------------------------------------------------------- plumbing
    def _conn(self) -> http.client.HTTPConnection:
        if self.ssl_context is not None:
            return http.client.HTTPSConnection(
                *self.addr, timeout=self.timeout, context=self.ssl_context
            )
        return http.client.HTTPConnection(*self.addr, timeout=self.timeout)

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _path(self, path: str, node: int | None, **params) -> str:
        q = {k: v for k, v in params.items() if v is not None}
        n = node if node is not None else self.node
        if n is not None:
            q["node"] = n
        return path + ("?" + urllib.parse.urlencode(q) if q else "")

    def _request_json(self, method, path, body=None):
        c = self._conn()
        try:
            c.request(
                method, path,
                body=None if body is None
                else json.dumps(body, default=_encode_wire),
                headers=self._headers(),
            )
            resp = c.getresponse()
            data = json.loads(resp.read() or b"{}")
            if resp.status >= 400:
                raise ApiClientError(
                    resp.status, data.get("error", "request failed")
                )
            return data
        finally:
            c.close()

    def _request_stream(self, method, path, body=None):
        c = self._conn()
        c.request(
            method, path,
            body=None if body is None
            else json.dumps(body, default=_encode_wire),
            headers=self._headers(),
        )
        resp = c.getresponse()
        if resp.status >= 400:
            data = json.loads(resp.read() or b"{}")
            c.close()
            raise ApiClientError(
                resp.status, data.get("error", "request failed")
            )
        return resp

    # ------------------------------------------------------------- verbs
    def execute(self, statements, node: int | None = None) -> dict:
        """POST /v1/transactions (``corro-client/src/lib.rs:200-240``)."""
        return self._request_json(
            "POST", self._path("/v1/transactions", node), statements
        )

    def query(self, sql, node: int | None = None):
        """POST /v1/queries → generator of QueryEvents (streaming)."""
        resp = self._request_stream(
            "POST", self._path("/v1/queries", node), sql
        )
        try:
            while True:
                line = resp.readline()
                if not line:
                    return
                yield _decode_wire(json.loads(line))
        finally:
            resp.close()

    def query_rows(self, sql, node: int | None = None):
        cols, rows = [], []
        for e in self.query(sql, node):
            if "columns" in e:
                cols = e["columns"]
            elif "row" in e:
                rows.append(e["row"][1])
            elif "error" in e:
                raise ApiClientError(200, e["error"])
        return cols, rows

    def subscribe(
        self, sql, node: int | None = None, skip_rows: bool = False
    ) -> SubscriptionStream:
        """POST /v1/subscriptions → live stream (``lib.rs:94-143``)."""
        resp = self._request_stream(
            "POST",
            self._path(
                "/v1/subscriptions", node,
                skip_rows="true" if skip_rows else None,
            ),
            sql,
        )
        return SubscriptionStream(
            self,
            resp.headers.get("corro-query-id", ""),
            resp.headers.get("corro-query-hash", ""),
            resp,
        )

    def subscription(
        self,
        sub_id: str,
        from_change_id: int | None = None,
        skip_rows: bool = False,
        node: int | None = None,
    ) -> SubscriptionStream:
        """GET /v1/subscriptions/:id — re-attach (``lib.rs:145-198``)."""
        resp = self._request_stream(
            "GET",
            self._path(
                f"/v1/subscriptions/{sub_id}", node,
                **{"from": from_change_id},
                skip_rows="true" if skip_rows else None,
            ),
        )
        s = SubscriptionStream(
            self, resp.headers.get("corro-query-id", sub_id),
            resp.headers.get("corro-query-hash", ""), resp,
        )
        if from_change_id is not None:
            s.last_change_id = from_change_id
        return s

    def schema(self, ddl_statements, node: int | None = None) -> dict:
        """POST /v1/migrations (``lib.rs:242-276`` schema)."""
        if isinstance(ddl_statements, str):
            ddl_statements = [ddl_statements]
        return self._request_json(
            "POST", self._path("/v1/migrations", node), ddl_statements
        )

    def schema_from_paths(self, paths, node: int | None = None) -> dict:
        """Apply schema files (``lib.rs:278-308``)."""
        stmts = []
        for p in paths:
            with open(p) as f:
                stmts.append(f.read())
        return self.schema(stmts, node)

    def table_stats(self, tables=(), node: int | None = None) -> dict:
        return self._request_json(
            "POST", self._path("/v1/table_stats", node),
            {"tables": list(tables)},
        )

    def members(self) -> list:
        return self._request_json("GET", "/v1/cluster/members")

    def metrics_text(self) -> str:
        resp = self._request_stream("GET", "/metrics")
        try:
            return resp.read().decode()
        finally:
            resp.close()


class PooledApiClient:
    """Multi-address failover client (``CorrosionPooledClient``,
    ``corro-client/src/lib.rs:377-640``): tries addresses in order,
    sticking with the first that answers; connection errors rotate."""

    def __init__(self, addrs, token: str | None = None, **kw):
        if not addrs:
            raise ValueError("need at least one address")
        self._clients = [ApiClient(a, token=token, **kw) for a in addrs]
        self._current = 0

    def _call(self, fn_name, *args, **kw):
        last_err: Exception | None = None
        for i in range(len(self._clients)):
            idx = (self._current + i) % len(self._clients)
            try:
                out = getattr(self._clients[idx], fn_name)(*args, **kw)
                self._current = idx
                return out
            except (ConnectionError, socket.error, http.client.HTTPException) as e:
                last_err = e
        raise last_err  # type: ignore[misc]

    def execute(self, statements, node=None):
        return self._call("execute", statements, node=node)

    def query_rows(self, sql, node=None):
        return self._call("query_rows", sql, node=node)

    def subscribe(self, sql, node=None, skip_rows=False):
        return self._call("subscribe", sql, node=node, skip_rows=skip_rows)

    def schema(self, ddl, node=None):
        return self._call("schema", ddl, node=node)
