"""The shared ``name[:k=v,...]`` spec grammar.

Port of ``corro_sim/utils/spec.py``. One string names a parameterized
generator — traffic workloads (:mod:`corro_sim_torch.workload`) speak
it::

    zipf:alpha=1.1,rate=0.4
    churn_storm:waves=4,batch=8

Values parse as int, then float, then bare string. The parser is
registry-agnostic; callers validate ``name`` against their own table.
"""

from __future__ import annotations

__all__ = ["format_spec", "parse_spec"]


def parse_spec(spec: str) -> tuple[str, dict]:
    """``name[:k=v,...]`` → ``(name, params)``."""
    name, _, kv = spec.partition(":")
    name = name.strip()
    if not name:
        raise ValueError(f"spec {spec!r} has no generator name")
    params: dict = {}
    if kv.strip():
        for item in kv.split(","):
            k, eq, v = item.partition("=")
            if not eq:
                raise ValueError(f"spec param {item!r} must be key=value")
            v = v.strip()
            try:
                parsed: object = int(v)
            except ValueError:
                try:
                    parsed = float(v)
                except ValueError:
                    parsed = v
            params[k.strip()] = parsed
    return name, params


def format_spec(name: str, params: dict) -> str:
    """The canonical rendering ``parse_spec`` round-trips."""
    if not params:
        return name
    kv = ",".join(f"{k}={v}" for k, v in sorted(params.items()))
    return f"{name}:{kv}"
