"""HTTP API: the reference's public client surface over a LiveCluster.

Port of ``corro_sim/api/http.py``. The server and its handlers are host
Python; every route reaches the cluster through its methods, which hold
the cluster's lock while they touch its tensors, so a handler thread
never reads a plane that the tick thread is updating in place.

Route parity with ``corro-agent/src/api/public`` (SURVEY §2.3):

  POST /v1/transactions   — statement batch → one committed version
                            (``api_v1_transactions``, ``public/mod.rs:134-205``)
  POST /v1/queries        — one SELECT → streaming ND-JSON ``QueryEvent``s
                            (``api_v1_queries``, ``public/mod.rs:215-441``)
  POST /v1/subscriptions  — SELECT → live query stream; dedupe by normalized
                            SQL; ``corro-query-id``/``corro-query-hash``
                            headers (``public/pubsub.rs:665``)
  GET  /v1/subscriptions/:id?from=N&skip_rows= — re-attach an existing sub
                            (``api_v1_sub_by_id``, ``public/pubsub.rs:36-110``)
  POST /v1/migrations     — DDL batch → additive schema migration
                            (``api_v1_db_schema``, ``public/mod.rs:443-528``)
  POST /v1/table_stats    — per-table row counts (``public/mod.rs:535-590``)
  GET  /v1/cluster/members, GET /metrics — membership + Prometheus text
                            (the reference serves these via corro-admin and
                            the Prometheus exporter; one port suffices here)

Differences by design: one server fronts the *whole simulated cluster*, so
every route takes ``?node=N`` to pick which agent you'd have dialed
(default 0). Event bodies are ND-JSON lines exactly like the reference
(serde shapes of ``TypedQueryEvent``, ``corro-api-types/src/lib.rs:25-38``),
so a reference client's decode loop works unchanged.

Authorization mirrors ``BearerToken`` authz (``agent/util.rs:219-246``):
when the server is given a token, every request must carry
``Authorization: Bearer <token>``.
"""

from __future__ import annotations

import hashlib
import json
import re
import select
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from corro_sim_torch.api.wire import decode_values as _decode_wire_values
from corro_sim_torch.api.wire import encode_value as _json_value
from corro_sim_torch.harness.cluster import ExecError, LiveCluster
from corro_sim_torch.utils.tracing import parse_traceparent, tracer

_SUB_PATH = re.compile(r"^/v1/subscriptions/([A-Za-z0-9_-]+)$")

# Stream poll cadence. The reference parks on a tokio broadcast receiver;
# an HTTP thread here polls its deque instead.
_POLL_S = 0.02


class _ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _parse_qs(query: str) -> dict:
    return dict(urllib.parse.parse_qsl(query, keep_blank_values=True))


def query_hash(sql: str) -> str:
    """Stable hash of the normalized query — the ``corro-query-hash``
    header value (``public/pubsub.rs:640-663`` hashes the statement)."""
    return hashlib.sha256(sql.strip().encode()).hexdigest()[:16]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "corro-sim"

    # quiet request logging; the cluster has its own metrics
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # ----------------------------------------------------------- plumbing
    @property
    def api(self) -> "ApiServer":
        return self.server.api  # type: ignore[attr-defined]

    def _authz(self) -> bool:
        token = self.api.authz_token
        if token is None:
            return True
        got = self.headers.get("Authorization", "")
        if got == f"Bearer {token}":
            return True
        self._send_json({"error": "unauthorized"}, status=401)
        return False

    def _body_json(self):
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if not raw:
            raise _ApiError(400, "empty body")
        try:
            return _decode_wire_values(json.loads(raw))
        except json.JSONDecodeError as e:
            raise _ApiError(400, f"invalid JSON body: {e}") from None
        except ValueError as e:  # malformed blob shape
            raise _ApiError(400, str(e)) from None

    def _node(self, params: dict) -> int:
        try:
            return int(params.get("node", "0") or 0)
        except ValueError:
            raise _ApiError(400, "node must be an integer") from None

    def _send_json(self, obj, status: int = 200, headers: dict | None = None):
        body = (json.dumps(obj, default=_json_value) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        ctx = getattr(self, "_trace_ctx", None)
        if ctx is not None:
            self.send_header("traceparent", ctx.to_traceparent())
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _start_stream(self, status: int = 200, headers: dict | None = None):
        """Open an unbounded ND-JSON response (read-until-close framing)."""
        self.send_response(status)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.close_connection = True

    def _stream_events(self, events) -> None:
        for e in events:
            self.wfile.write(
                (json.dumps(_as_wire(e), default=_json_value) + "\n")
                .encode()
            )
        self.wfile.flush()

    # ------------------------------------------------------------- routes
    def _traced(self, name: str, fn, streaming: bool = False):
        """Run a route handler under a span.

        Distributed trace propagation: an incoming W3C ``traceparent``
        parents the span (``SyncTraceContextV1`` analog,
        ``corro-types/src/sync.rs:33-67``). Streaming routes record only
        an *accept* span — a subscription body lives as long as the
        client stays connected, and measuring connection lifetime would
        flood the slow-span watchdog and bury real signals."""
        parent = parse_traceparent(self.headers.get("traceparent"))
        try:
            if streaming:
                with tracer.span(f"{name} accept", parent=parent) as ctx:
                    self._trace_ctx = ctx
                fn()
            else:
                with tracer.span(name, parent=parent) as ctx:
                    self._trace_ctx = ctx
                    fn()
        except _ApiError as e:
            self._send_json({"error": e.message}, status=e.status)
        except BrokenPipeError:
            pass

    def do_POST(self):  # noqa: N802
        with self.api.cluster._api_req_lock:
            self.api.cluster._api_requests += 1
        self._trace_ctx = None  # never leak a prior request's context
        if not self._authz():
            return
        path, _, qs = self.path.partition("?")
        params = _parse_qs(qs)
        name = f"http POST {path}"
        if path == "/v1/transactions":
            self._traced(name, lambda: self._post_transactions(params))
        elif path == "/v1/queries":
            self._traced(name, lambda: self._post_queries(params))
        elif path == "/v1/subscriptions":
            self._traced(name, lambda: self._post_subscriptions(params),
                         streaming=True)
        elif path in ("/v1/migrations", "/v1/db/schema"):
            self._traced(name, lambda: self._post_migrations(params))
        elif path == "/v1/table_stats":
            self._traced(name, lambda: self._post_table_stats(params))
        elif path == "/v1/faults":
            self._traced(name, self._post_faults)
        else:
            self._traced(name, lambda: self._send_json(
                {"error": "not found"}, status=404))

    # POST /v1/faults — arm/disarm a chaos scenario on the live cluster:
    # {"scenario": "lossy:p=0.1", "rounds": 128} or {"clear": true}
    def _post_faults(self):
        body = self._body_json()
        if not isinstance(body, dict):
            raise _ApiError(400, "body must be a JSON object")
        if body.get("clear"):
            self._send_json(self.api.cluster.clear_scenario())
            return
        spec = body.get("scenario")
        if not spec:
            raise _ApiError(400, "body needs \"scenario\" (or \"clear\")")
        try:
            out = self.api.cluster.load_scenario(
                str(spec), rounds=int(body.get("rounds", 128)),
                seed=body.get("seed"),
            )
        except (ValueError, KeyError, TypeError) as e:
            raise _ApiError(400, str(e)) from None
        self._send_json(out)

    def do_GET(self):  # noqa: N802
        with self.api.cluster._api_req_lock:
            self.api.cluster._api_requests += 1
        self._trace_ctx = None
        if not self._authz():
            return
        path, _, qs = self.path.partition("?")
        params = _parse_qs(qs)
        name = f"http GET {path}"
        m = _SUB_PATH.match(path)
        if m:
            self._traced(
                name, lambda: self._get_subscription(m.group(1), params),
                streaming=True,
            )
        elif path == "/v1/cluster/members":
            self._traced(
                name, lambda: self._send_json(self.api.cluster.members())
            )
        elif path == "/v1/table_stats":
            self._traced(
                name,
                lambda: self._post_table_stats(params, body={"tables": []}),
            )
        elif path == "/v1/flight":
            self._traced(name, lambda: self._get_flight(params))
        elif path == "/v1/sweep":
            self._traced(name, self._get_sweep)
        elif path == "/v1/perf":
            self._traced(name, self._get_perf)
        elif path == "/v1/doctor":
            self._traced(name, self._get_doctor)
        elif path == "/v1/probes":
            self._traced(name, lambda: self._get_probes(params))
        elif path == "/v1/faults":
            self._traced(
                name,
                lambda: self._send_json(self.api.cluster.fault_report()),
            )
        elif path == "/v1/workload":
            # the last load-harness run's report (workload/harness.py):
            # sub-delivery latency quantiles, coalescing, query fan — 404
            # until a load has been driven through this cluster
            self._traced(name, self._get_workload)
        elif path == "/v1/changes":
            self._traced(name, lambda: self._get_changes(params))
        elif path == "/metrics":
            self._traced(name, self._get_metrics)
        else:
            self._traced(name, lambda: self._send_json(
                {"error": "not found"}, status=404))

    # GET /v1/changes?offset=N&limit=K — relay a growing ND-JSON
    # changeset feed by line position: the serving side of the twin's
    # live HTTP watch (io/feedsource.py HTTPWatchSource). The
    # body is raw ND-JSON starting at line `offset`; an unterminated
    # final line is served as-is (the watcher holds torn fragments back
    # and re-fetches), so the relay never invents a newline the writer
    # has not committed.
    def _get_changes(self, params):
        path = getattr(self.api, "feed_path", None)
        if path is None:
            raise _ApiError(
                404, "no changeset feed attached to this server "
                     "(ApiServer(feed_path=...))"
            )
        try:
            offset = max(0, int(params.get("offset", "0")))
            limit = int(params.get("limit", "4096"))
        except ValueError:
            raise _ApiError(400, "offset/limit must be integers") \
                from None
        limit = max(1, min(limit, 65536))
        out: list = []
        try:
            with open(path, "rb") as f:
                for i, raw in enumerate(f):
                    if i < offset:
                        continue
                    out.append(raw)
                    if len(out) >= limit:
                        break
        except OSError as e:
            raise _ApiError(503, f"feed unreadable: {e}") from None
        body = b"".join(out)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _get_workload(self):
        rep = getattr(self.api.cluster, "workload_report", None)
        if rep is None:
            raise _ApiError(
                404, "no workload has been driven through this cluster "
                     "(corro_sim_torch.workload.harness.run_live_load)"
            )
        self._send_json(rep)

    # POST /v1/transactions — ExecResponse; statement errors come back as
    # per-statement {"error"} results with HTTP 200, like the reference.
    def _post_transactions(self, params):
        stmts = self._body_json()
        if not isinstance(stmts, list):
            raise _ApiError(400, "body must be a JSON array of statements")
        t0 = time.perf_counter()
        try:
            resp = self.api.cluster.execute(stmts, node=self._node(params))
        except ExecError as e:
            resp = {
                "results": [{"error": str(e)}],
                "time": time.perf_counter() - t0,
                "version": None,
            }
        self._send_json(resp)

    def _post_queries(self, params):
        stmt = self._body_json()
        node = self._node(params)
        sql, bound, structured = _parse_body_statement(stmt)
        self._start_stream()
        t0 = time.perf_counter()
        try:
            # binding errors stream as QueryEvent::Error like any other
            # query failure (the reference's api_v1_queries streams them).
            # Structured statements always bind — a placeholder with an
            # empty params list must fail as a binding error, not as a
            # downstream '?' syntax error.
            if structured:
                from corro_sim_torch.api.statements import bind_params

                sql = bind_params(sql, bound)
            events = self.api.cluster.query(sql, node=node)
        except Exception as e:  # streamed QueryEvent::Error, like reference
            self._stream_events([{"error": str(e)}])
            return
        events = _with_eoq_time(events, time.perf_counter() - t0)
        self._stream_events(events)

    def _post_subscriptions(self, params):
        stmt = self._body_json()
        node = self._node(params)
        skip_rows = params.get("skip_rows", "") in ("true", "1")
        sql = _sql_of_body(stmt)
        cluster = self.api.cluster
        try:
            sub_id, initial, q = cluster.subscribe_attached(sql, node=node)
        except Exception as e:
            raise _ApiError(400, str(e)) from None
        try:
            # hash the *normalized* SQL so create and re-attach agree
            # (the reference hashes the deduped statement the same way)
            norm = cluster.subs.get(sub_id).select.normalized()
            self._start_stream(
                headers={
                    "corro-query-id": sub_id,
                    "corro-query-hash": query_hash(norm),
                }
            )
            if not skip_rows:
                self._stream_events(initial)
            else:
                # skip_rows still announces where the change feed starts
                eoq = [e for e in initial if "eoq" in e]
                self._stream_events(eoq)
            self._tail(q)
        finally:
            cluster.sub_detach_queue(sub_id, q)

    def _get_subscription(self, sub_id: str, params):
        cluster = self.api.cluster
        skip_rows = params.get("skip_rows", "") in ("true", "1")
        from_raw = params.get("from")
        from_id = None
        if from_raw is not None:
            try:
                from_id = int(from_raw)
            except ValueError:
                raise _ApiError(400, "from must be an integer") from None
        try:
            initial, q = cluster.sub_attach(
                sub_id, from_change_id=from_id, skip_rows=skip_rows
            )
        except KeyError:
            raise _ApiError(404, f"no such subscription {sub_id!r}") from None
        if initial is None:
            # compacted past `from` — reference 404s; resubscribe
            raise _ApiError(404, f"change id {from_id} no longer buffered")
        m = cluster.subs.get(sub_id)
        try:
            self._start_stream(
                headers={
                    "corro-query-id": sub_id,
                    "corro-query-hash": query_hash(m.select.normalized()),
                }
            )
            self._stream_events(initial)
            self._tail(q)
        finally:
            cluster.sub_detach_queue(sub_id, q)

    def _tail(self, q) -> None:
        """Forward live events until the client hangs up or shutdown.

        Hangup on an *idle* stream is detected by readability: the client
        sends nothing after its request, so a readable socket means EOF —
        without this, an event-less subscription would pin its handler
        thread and queue forever."""
        trip = self.api.cluster.tripwire
        sock = self.connection
        while not trip.tripped and not self.api._closing:
            if q:
                batch = []
                while q:
                    batch.append(q.popleft())
                self.api.cluster.channels.on_recv("subs_events", len(batch))
                try:
                    self._stream_events(batch)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return
            else:
                readable, _, _ = select.select([sock], [], [], _POLL_S)
                if readable:
                    return  # EOF (or protocol violation) — hang up

    def _post_migrations(self, params):
        stmts = self._body_json()
        if isinstance(stmts, str):
            stmts = [stmts]
        if not isinstance(stmts, list) or not all(
            isinstance(s, str) for s in stmts
        ):
            raise _ApiError(400, "body must be DDL statement string(s)")
        sql = ";\n".join(s.rstrip().rstrip(";") for s in stmts)
        try:
            plan = self.api.cluster.migrate(sql)
        except Exception as e:
            raise _ApiError(400, str(e)) from None
        self._send_json(plan)

    def _post_table_stats(self, params, body=None):
        req = body if body is not None else self._body_json()
        want = req.get("tables") if isinstance(req, dict) else None
        stats = self.api.cluster.table_stats()
        invalid = [t for t in (want or []) if t not in stats]
        picked = (
            {t: stats[t] for t in want if t in stats} if want else stats
        )
        total = sum(
            sum(s["live_rows_per_node"]) for s in picked.values()
        )
        self._send_json(
            {
                "total_row_count": total,
                "invalid_tables": invalid,
                "tables": picked,
            }
        )

    def _get_flight(self, params):
        """GET /v1/flight — the cluster's per-round telemetry timeline.

        ``?n=K`` trims to the last K rounds; ``?format=ndjson`` returns
        the raw ND-JSON export (loadable by ``FlightRecorder.load``)."""
        fl = getattr(self.api.cluster, "flight", None)
        if fl is None:
            raise _ApiError(404, "no flight recorder attached")
        if params.get("format") == "ndjson":
            body = fl.to_ndjson().encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        last = None
        if params.get("n"):
            try:
                last = int(params["n"])
            except ValueError:
                raise _ApiError(400, "n must be an integer") from None
            if last < 0:
                raise _ApiError(400, "n must be >= 0")
        self._send_json(fl.timeline(last_rounds=last))

    def _get_sweep(self):
        """GET /v1/sweep — the fleet observatory's live sweep snapshot
        (obs/lanes.py): per-chunk lane-state counts, the
        one-char-per-lane state string and cumulative wasted
        frozen-lane rounds while a sweep runs in this process, the
        final summary after. 404 until a sweep has run."""
        from corro_sim_torch.obs.lanes import sweep_status

        st = sweep_status()
        if st is None:
            raise _ApiError(404, "no sweep has run in this process")
        self._send_json(st)

    def _get_perf(self):
        """GET /v1/perf — the performance-ledger snapshot. The ledger
        (``obs/ledger.py``) is not ported yet, so this answers 404 and
        names the missing module."""
        raise _ApiError(
            404, "the performance ledger is not ported yet "
                 "(corro_sim_torch/obs/ledger.py is missing)"
        )

    def _get_doctor(self):
        """GET /v1/doctor — the cross-artifact diagnosis snapshot. The
        doctor (``obs/doctor.py``) and the ledger it reads are not ported
        yet, so this answers 404 and names the missing modules."""
        raise _ApiError(
            404, "the run doctor is not ported yet "
                 "(corro_sim_torch/obs/doctor.py and obs/ledger.py are "
                 "missing)"
        )

    def _get_probes(self, params):
        """GET /v1/probes — probe-tracer provenance + lag observatory.

        Default: JSON report (per-probe summaries with BFS stretch,
        infection trees, node lag). ``?format=ndjson`` streams the raw
        probe journal; ``?format=trace`` returns Chrome trace-event JSON
        loadable in Perfetto / chrome://tracing."""
        cluster = self.api.cluster
        fmt = params.get("format")
        if fmt in ("ndjson", "trace"):
            tr = cluster.probe_trace()
            if tr is None:
                raise _ApiError(
                    404,
                    "probe tracer disabled — start the cluster with "
                    "cfg_overrides={'probes': K}",
                )
            if fmt == "ndjson":
                body = tr.to_ndjson().encode()
                ctype = "application/x-ndjson"
            else:
                body = (json.dumps(tr.to_chrome_trace()) + "\n").encode()
                ctype = "application/json"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self._send_json(cluster.probe_report())

    def _get_metrics(self):
        from corro_sim_torch.utils.metrics import render_prometheus

        text = render_prometheus(self.api.cluster)
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _parse_body_statement(stmt):
    """A request body as ``(sql, params, structured)``; bad wire shapes
    (``corro-api-types/src/lib.rs:181-201``) → 400. Binding stays with the
    caller: queries stream binding errors, subscriptions 400 them."""
    if isinstance(stmt, str):
        return stmt, [], False
    from corro_sim_torch.api.statements import parse_statement

    try:
        sql, params = parse_statement(stmt)
    except Exception as e:
        raise _ApiError(400, str(e)) from None
    return sql, params, True


def _sql_of_body(stmt) -> str:
    """A request body as SQL text with params INLINED as literals — the
    reference binds them in ``api_v1_queries`` and inlines them for
    subscriptions via ``expand_sql`` (``api/public/pubsub.rs:226-331``);
    inlining makes subscription dedupe-by-normalized-SQL see the bound
    values. Structured statements always bind: a placeholder with an empty
    params list is a binding error here, not a '?' syntax error later."""
    sql, params, structured = _parse_body_statement(stmt)
    if not structured:
        return sql
    from corro_sim_torch.api.statements import bind_params

    try:
        return bind_params(sql, params)
    except Exception as e:
        raise _ApiError(400, str(e)) from None




def _as_wire(e) -> dict:
    """Events are dicts already; buffered SubEvents expose as_json()."""
    return e if isinstance(e, dict) else e.as_json()


def _with_eoq_time(events, elapsed: float):
    out = []
    for e in events:
        if isinstance(e, dict) and "eoq" in e:
            eoq = dict(e["eoq"])
            eoq["time"] = elapsed
            e = {"eoq": eoq}
        out.append(e)
    return out


class ApiServer:
    """Threaded HTTP front-end bound to one LiveCluster.

    Lifecycle mirrors ``setup_http_api_handler`` (``agent/util.rs:167-296``):
    bind, serve until tripwire, drain. ``tick_interval`` optionally runs a
    background gossip ticker so subscription tails advance without writes
    (the reference's agents gossip on their own clock)."""

    def __init__(
        self,
        cluster: LiveCluster,
        host: str = "127.0.0.1",
        port: int = 0,
        authz_token: str | None = None,
        tick_interval: float | None = None,
        ssl_context=None,
        feed_path: str | None = None,
    ):
        self.cluster = cluster
        self.authz_token = authz_token
        # ND-JSON changeset feed relayed at GET /v1/changes — the
        # serving side of the twin's HTTPWatchSource (`twin
        # http://host/v1/changes --tail`); 404 when unset
        self.feed_path = feed_path
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.api = self  # type: ignore[attr-defined]
        self._tls = ssl_context is not None
        if ssl_context is not None:
            # TLS (optionally mutual) on the API listener — the posture
            # the reference applies to its gossip endpoint
            # (api/peer.rs:129-343). Wrap per-CONNECTION with the
            # handshake deferred: an eager handshake would run inside the
            # single accept loop, letting one stalled client wedge every
            # other connection. Deferred, OpenSSL negotiates on the
            # handler thread's first read — the same exposure profile as
            # a plain-HTTP silent client.
            httpd = self._httpd
            plain_get_request = httpd.get_request

            def get_request():
                sock, addr = plain_get_request()
                return (
                    ssl_context.wrap_socket(
                        sock, server_side=True,
                        do_handshake_on_connect=False,
                    ),
                    addr,
                )

            httpd.get_request = get_request
        self._thread: threading.Thread | None = None
        self._ticker: threading.Thread | None = None
        self._tick_interval = tick_interval
        self._closing = False

    @property
    def addr(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.addr
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="corro-api", daemon=True
        )
        self._thread.start()
        if self._tick_interval:
            self._ticker = threading.Thread(
                target=self._tick_loop, name="corro-ticker", daemon=True
            )
            self._ticker.start()
        return self

    def _tick_loop(self):
        trip = self.cluster.tripwire
        while not trip.tripped and not self._closing:
            self.cluster.tick(1)
            time.sleep(self._tick_interval)

    def close(self) -> None:
        self._closing = True
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._ticker:
            self._ticker.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
