"""Template engine — the `corro-tpl` crate's surface in Python.

The reference renders config files from Rhai templates
(``crates/corro-tpl/src/lib.rs``): inside a template, ``sql("SELECT …")``
returns a ``QueryResponse`` you can iterate row by row or serialize with
``.to_json()`` / ``.to_json(#{pretty: true, row_values_as_array: true})``
/ ``.to_csv()`` (``lib.rs:43-90,368-470``); ``hostname()`` is available
(``lib.rs:598``); and every ``sql()`` call hooks a subscription so the
template **re-renders automatically** when its query results change
(``TemplateCommand::Render``, ``lib.rs:359-430``).

Template syntax (rhai-tpl analog, block-structured so the compiler can
track indentation):

    <%= expr %>                      emit an expression
    <% x = expr %>                   statement
    <% for row in sql("...") %> … <% end %>
    <% if cond %> … <% elif c %> … <% else %> … <% end %>

Rendering compiles the template to Python with ``sql``/``hostname``/
``write`` in scope. Templates are operator-supplied executable config —
the same trust model as the reference's Rhai scripts.

Port of ``corro_sim/tpl.py`` (host Python only; the same behaviour).
"""

from __future__ import annotations

import csv
import io
import json
import os
import socket
import threading
import time


class TemplateError(ValueError):
    pass


class Row:
    """One result row: index, name, and attribute access."""

    def __init__(self, columns, values):
        self._columns = columns
        self._values = values

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._values[key]
        return self._values[self._columns.index(key)]

    def __getattr__(self, name):
        try:
            return self._values[self._columns.index(name)]
        except ValueError:
            raise AttributeError(name) from None

    def __iter__(self):
        return iter(self._values)

    def to_json(self) -> str:
        return json.dumps(dict(zip(self._columns, self._values)))

    def __repr__(self):
        return f"Row({dict(zip(self._columns, self._values))})"


class QueryResponse:
    """Iterable result of an in-template ``sql()`` call
    (``corro-tpl/src/lib.rs:37-90``)."""

    def __init__(self, columns, rows):
        self.columns = list(columns)
        self._rows = [Row(self.columns, r) for r in rows]

    def __iter__(self):
        return iter(self._rows)

    def __len__(self):
        return len(self._rows)

    def to_json(self, pretty: bool = False,
                row_values_as_array: bool = False) -> str:
        """ND-JSON rows — objects by default, arrays with
        ``row_values_as_array`` (``write_sql_to_json``, ``lib.rs:398``)."""
        out = []
        for row in self._rows:
            obj = (
                list(row) if row_values_as_array
                else dict(zip(self.columns, row))
            )
            out.append(json.dumps(obj, indent=2 if pretty else None))
        return "\n".join(out)

    def to_csv(self, header: bool = True) -> str:
        """CSV with a header row (``write_sql_to_csv``, ``lib.rs:368``)."""
        buf = io.StringIO()
        w = csv.writer(buf)
        if header:
            w.writerow(self.columns)
        for row in self._rows:
            w.writerow(list(row))
        return buf.getvalue().rstrip("\n")


# ------------------------------------------------------------- compiler

_OPENERS = ("for ", "if ", "while ")


def compile_template(text: str):
    """Template → Python code object emitting via ``write``."""
    src: list[str] = []
    indent = 0

    def emit(line):
        src.append("    " * indent + line)

    pos = 0
    while True:
        start = text.find("<%", pos)
        if start < 0:
            chunk = text[pos:]
            if chunk:
                emit(f"write({chunk!r})")
            break
        if start > pos:
            emit(f"write({text[pos:start]!r})")
        end = text.find("%>", start)
        if end < 0:
            raise TemplateError("unterminated <% block")
        body = text[start + 2:end]
        pos = end + 2
        # swallow one newline directly after a statement block (layout aid)
        if not body.startswith("=") and pos < len(text) and text[pos] == "\n":
            pos += 1
        if body.startswith("="):
            emit(f"write(str(({body[1:].strip()})))")
            continue
        stmt = body.strip()
        if stmt == "end":
            if indent == 0:
                raise TemplateError("'end' without an open block")
            indent -= 1
        elif stmt in ("else", "else:") or stmt.startswith("elif "):
            if indent == 0:
                raise TemplateError(f"{stmt!r} without an open block")
            indent -= 1
            emit(stmt if stmt.endswith(":") else stmt + ":")
            indent += 1
        elif stmt.startswith(_OPENERS):
            emit(stmt if stmt.endswith(":") else stmt + ":")
            indent += 1
        else:
            emit(stmt)
    if indent != 0:
        raise TemplateError("unclosed block (missing <% end %>)")
    return compile("\n".join(src) or "pass", "<template>", "exec")


class Engine:
    """Render templates against an agent (``corro-tpl``'s engine setup,
    ``lib.rs:471-607``)."""

    def __init__(self, client, node: int | None = None):
        self.client = client
        self.node = node

    def render(self, text: str) -> tuple[str, list[str]]:
        """Returns (output, queries) — the SQL strings the template ran
        (these are what a live watcher subscribes to)."""
        code = compile_template(text)
        out: list[str] = []
        queries: list[str] = []

        def sql(q: str) -> QueryResponse:
            cols, rows = self.client.query_rows(q, node=self.node)
            queries.append(q)
            return QueryResponse(cols, rows)

        env = {
            "write": out.append,
            "sql": sql,
            "hostname": socket.gethostname,
            "json": json,
        }
        exec(code, env)  # noqa: S102 — templates are operator config
        return "".join(out), queries


class TemplateWatcher:
    """Render → write → watch → re-render loop (``TemplateCommand::Render``
    dispatch, ``lib.rs:412-430``; CLI `corrosion template`).

    Output is written atomically (tmp + rename) so readers of the config
    file never observe a half-rendered state."""

    def __init__(self, client, template_path, output_path,
                 node: int | None = None, tripwire=None):
        from corro_sim_torch.utils.runtime import Tripwire

        self.engine = Engine(client, node)
        self.template_path = str(template_path)
        self.output_path = str(output_path)
        self.tripwire = tripwire or Tripwire()
        self.renders = 0
        # one wake event for the watcher's whole life: set by any sub
        # reader on a change, and by the tripwire on shutdown (on_trip
        # registers exactly once — per-wait registration would accumulate)
        self._wake = threading.Event()
        self.tripwire.on_trip(self._wake.set)

    def render_once(self) -> list[str]:
        with open(self.template_path) as f:
            text = f.read()
        out, queries = self.engine.render(text)
        tmp = self.output_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(out)
        os.replace(tmp, self.output_path)
        self.renders += 1
        return queries

    def run(self, max_renders: int | None = None) -> None:
        """Blocking watch loop: subscribe to every template query; any
        change event triggers a re-render (and re-subscription, since a
        re-render may run different queries). Transient agent failures
        retry with backoff — a config-rendering daemon must outlive its
        API server's restarts."""
        import sys

        from corro_sim_torch.utils.runtime import Backoff

        backoff = iter(Backoff(0.25, 15.0))
        while not self.tripwire.tripped:
            subs = []
            try:
                queries = self.render_once()
                if max_renders is not None and self.renders >= max_renders:
                    return
                for q in queries:
                    subs.append(
                        self.engine.client.subscribe(
                            q, node=self.engine.node, skip_rows=True
                        )
                    )
                if not subs:
                    return  # nothing to watch — static template
                backoff = iter(Backoff(0.25, 15.0))  # healthy → reset
                self._wait_for_change(subs)
            except TemplateError:
                raise  # a broken template never fixes itself by retrying
            except Exception as e:
                print(f"template watcher error (retrying): {e}",
                      file=sys.stderr)
                if self.tripwire.sleep(next(backoff)):
                    return
            finally:
                for s in subs:
                    s.close()

    def _wait_for_change(self, subs) -> None:
        """Park until any subscription yields a change event or shutdown.
        One reader thread per stream (buffered HTTP bodies defeat
        select())."""
        self._wake.clear()
        if self.tripwire.tripped:
            return

        def reader(stream):
            try:
                for event in stream:
                    if "change" in event:
                        break
            except Exception:
                pass
            # change seen, clean EOF, or error: all wake the loop — a
            # stream that ended for ANY reason needs a re-subscribe
            self._wake.set()

        threads = [
            threading.Thread(target=reader, args=(s,), daemon=True)
            for s in subs
        ]
        for t in threads:
            t.start()
        self._wake.wait()

    def spawn(self, **kw) -> threading.Thread:
        from corro_sim_torch.utils.runtime import spawn_counted

        return spawn_counted(self.run, name="tpl-watcher", **kw)


def wait_for_render(watcher: TemplateWatcher, count: int,
                    timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if watcher.renders >= count:
            return True
        time.sleep(0.02)
    return False
