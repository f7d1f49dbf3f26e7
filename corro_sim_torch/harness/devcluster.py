"""Devcluster: the topology-file harness (corro-devcluster analog).

The reference's dev harness parses a ``Simple`` topology file of
``A -> B`` edges (`corro-devcluster/src/topology/mod.rs`), assigns each
named node a port + state directory, generates per-node configs whose
``bootstrap`` lists implement the edges, and spawns one real agent
process per node (`src/main.rs:104-216`).

The simulator's unit of deployment is one *cluster* process (see
`corro_sim_torch/harness/cluster.py`), so the backend here maps the topology
onto a single LiveCluster:

- every named node becomes an ordinal (sorted by name, deterministic);
- bootstrap edges only seed SWIM membership in the reference — once
  membership converges, gossip targets any member, so steady-state
  connectivity is the *connected component* of the bootstrap graph.
  Components map onto the simulator's partition ids: nodes in different
  components never exchange gossip or sync, exactly like agents whose
  bootstrap chains never meet;
- per-node state directories are still created, each holding a
  ``node.json`` with the name → ordinal/API mapping (the "which agent is
  this" role the reference's per-node config.toml plays).

Port of ``corro_sim/harness/devcluster.py``: host code but for
:func:`build_cluster`'s ``device=``, which the port's LiveCluster takes.
"""

from __future__ import annotations

import json
import os
import re

_EDGE = re.compile(
    r"^\s*([A-Za-z][A-Za-z0-9_-]*)\s*->\s*([A-Za-z][A-Za-z0-9_-]*)\s*$"
)


class TopologyError(ValueError):
    pass


def parse_topology(text: str) -> dict[str, list[str]]:
    """``A -> B`` lines → adjacency {node: [bootstrap targets]}.

    Nodes appearing only on the right are registered with no edges, like
    the reference's ``parse_edge`` (topology/mod.rs:22-38). Blank lines
    and ``#`` comments are skipped."""
    adj: dict[str, list[str]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        m = _EDGE.match(s)
        if not m:
            raise TopologyError(f"syntax error in topology line {i}: {s!r}")
        a, b = m.group(1), m.group(2)
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    return adj


def all_nodes(adj: dict[str, list[str]]) -> list[str]:
    """Sorted node names (``get_all_nodes``, topology/mod.rs:40-52)."""
    names = set(adj)
    for targets in adj.values():
        names.update(targets)
    return sorted(names)


def components(adj: dict[str, list[str]]) -> dict[str, int]:
    """Name → connected-component id (undirected reachability).

    Gossip connectivity is symmetric once membership converges, so the
    undirected component is the right equivalence — a lone ``A -> B``
    edge makes A and B one cluster."""
    names = all_nodes(adj)
    undirected: dict[str, set] = {n: set() for n in names}
    for a, targets in adj.items():
        for b in targets:
            undirected[a].add(b)
            undirected[b].add(a)
    comp: dict[str, int] = {}
    next_id = 0
    for n in names:
        if n in comp:
            continue
        stack = [n]
        comp[n] = next_id
        while stack:
            cur = stack.pop()
            for other in undirected[cur]:
                if other not in comp:
                    comp[other] = next_id
                    stack.append(other)
        next_id += 1
    return comp


def build_cluster(
    topology_text: str,
    schema_sql: str,
    state_dir: str | None = None,
    seed: int = 0,
    default_capacity: int = 256,
    tripwire=None,
    device=None,
):
    """Topology + schema → (LiveCluster, name→ordinal map).

    The cluster's partition vector encodes the topology's connected
    components, so cross-component convergence never happens (the same
    outcome as reference agents whose bootstrap sets never link up).
    ``device``: where the cluster's tensors live (default ``cuda``)."""
    from corro_sim_torch.harness.cluster import LiveCluster

    adj = parse_topology(topology_text)
    names = all_nodes(adj)
    if not names:
        raise TopologyError("topology has no nodes")
    comp = components(adj)
    ordinal = {name: i for i, name in enumerate(names)}
    cluster = LiveCluster(
        schema_sql,
        num_nodes=len(names),
        seed=seed,
        default_capacity=default_capacity,
        tripwire=tripwire,
        device=device,
    )
    cluster.set_partition([comp[n] for n in names])
    if state_dir:
        from corro_sim_torch.membership.bootstrap import generate_bootstrap

        # every named node gets a deterministic gossip address, and each
        # node's bootstrap edges resolve through the same pipeline a real
        # agent uses (generate_bootstrap: parse → resolve → ≤10), exactly
        # how the reference devcluster writes per-node config bootstrap
        # lists (corro-devcluster/src/main.rs:104-216)
        gossip_addr = {
            n: ("127.0.0.1", 9000 + ordinal[n]) for n in names
        }

        def name_resolver(host, port, dns):
            return [gossip_addr[host]] if host in gossip_addr else []

        for name in names:
            node_state = os.path.join(state_dir, name)
            os.makedirs(node_state, exist_ok=True)
            boots = generate_bootstrap(
                [f"{b}:{gossip_addr[b][1]}" for b in adj.get(name, [])],
                resolve=name_resolver,
            )
            with open(os.path.join(node_state, "node.json"), "w") as f:
                json.dump(
                    {
                        "name": name,
                        "node": ordinal[name],
                        "component": comp[name],
                        "gossip_addr": list(gossip_addr[name]),
                        "bootstrap": adj.get(name, []),
                        "bootstrap_addrs": [list(a) for a in boots],
                    },
                    f,
                    indent=2,
                )
    return cluster, ordinal
