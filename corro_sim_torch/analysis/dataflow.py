"""fx dataflow engine: forward influence propagation + liveness over the
traced step graphs.

The port's counterpart of ``corro_sim/analysis/dataflow.py``. The fx
audit (:mod:`~corro_sim_torch.analysis.fx_audit`) proves program
IDENTITY; the contract auditor
(:mod:`~corro_sim_torch.analysis.contracts`) needs *which inputs can
influence which outputs at all*. A traced graph
(:class:`~corro_sim_torch.analysis.fx_audit.Program`) is straight-line
SSA over aten ops — the host's decisions are baked into it — so the
passes are single forward walks, all conservative (they may
over-approximate influence or liveness, never under-approximate it, so a
"cannot influence" verdict is sound for the traced rounds):

- **influence** (:func:`influence_masks`) — per-node bitmasks of the
  graph inputs that can flow into it: every node's mask is the union of
  its tensor arguments' masks. No control dependence is lost: the host
  decides what to trace from host data only, since tracing refuses a
  host read of a tensor's value (``fx_audit.HostReadInStep``);
- **liveness** (:func:`liveness`) — a last-use buffer walk over the
  nodes' tensor metadata, yielding a static peak-resident estimate;
- **censuses** — :func:`sort_eqns`, :func:`nondeterministic_eqns` and
  :func:`host_read_eqns` collect the determinism-relevant nodes.

The JAX package's ``while_eqns`` has no analog: the port has no device
loops (a loop is the host's, and its trip count is baked into the
graph). Its collective censuses of lowered programs have none either:
the mesh's ``torch.distributed`` calls are not in an fx graph, and the
contract auditor counts them at run time.

Nothing here imports torch at module scope; callers hand in a traced
``Program`` and get Python ints back.
"""

from __future__ import annotations

import dataclasses
import math

# ops whose result on the card depends on the order of atomic updates
# when they accumulate floats, and draws from the global generator
_FLOAT_ACCUMULATE = ("aten.index_add", "aten.scatter_add",
                     "aten.scatter_reduce", "aten.index_reduce",
                     "aten.index_put", "aten._index_put_impl",
                     "aten._unsafe_index_put", "aten.embedding_bag")
_GLOBAL_DRAWS = ("aten.rand", "aten.randn", "aten.randint",
                 "aten.randperm", "aten.bernoulli", "aten.normal",
                 "aten.multinomial", "aten.exponential", "aten.uniform",
                 "aten.random_", "aten.poisson")


def _name(node) -> str:
    return str(node.target)


def _tensor_args(node):
    """The graph nodes among ``node``'s arguments (nested lists too)."""
    out = []

    def walk(a):
        if hasattr(a, "op") and hasattr(a, "users"):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
        elif isinstance(a, dict):
            for x in a.values():
                walk(x)

    walk(node.args)
    walk(node.kwargs)
    return out


def _outputs(graph) -> list:
    (out,) = [n for n in graph.nodes if n.op == "output"]
    res = out.args[0]
    return list(res) if isinstance(res, (list, tuple)) else [res]


def _placeholders(graph) -> list:
    return [n for n in graph.nodes if n.op == "placeholder"]


# ------------------------------------------------------------ influence

def node_masks(prog) -> dict:
    """Node -> influence bitmask (bit ``i``: graph input ``i``)."""
    masks: dict = {}
    for i, n in enumerate(_placeholders(prog.graph)):
        masks[n] = 1 << i
    for n in prog.graph.nodes:
        if n.op in ("placeholder", "output"):
            continue
        m = 0
        for a in _tensor_args(n):
            m |= masks.get(a, 0)
        masks[n] = m
    return masks


def influence_masks(prog) -> list[int]:
    """Per-output influence bitmask: output *i*'s mask has bit *j* set
    iff graph input *j* can influence it."""
    masks = node_masks(prog)
    return [masks.get(o, 0) if hasattr(o, "op") else 0
            for o in _outputs(prog.graph)]


def influenced_outputs(prog, taint_in: set[int]) -> set[int]:
    """Indices of outputs influenced by any of the ``taint_in`` input
    indices."""
    mask = 0
    for i in taint_in:
        mask |= 1 << i
    return {o for o, m in enumerate(influence_masks(prog)) if m & mask}


def inert_inputs(prog) -> set[int]:
    """Input indices that influence NO output except an identity
    pass-through of themselves (the output IS the input node)."""
    ins = _placeholders(prog.graph)
    outs = _outputs(prog.graph)
    masks = influence_masks(prog)
    inert: set[int] = set()
    for i, v in enumerate(ins):
        bit = 1 << i
        if all(not (m & bit) or o is v for o, m in zip(outs, masks)):
            inert.add(i)
    return inert


# -------------------------------------------------------------- censuses

def sort_eqns(prog) -> list[dict]:
    """Every sort node with its stability: ``aten.sort.stable`` /
    ``aten.argsort.stable`` with ``stable=True`` are stable; the default
    overloads are not."""
    out = []
    for n in prog.graph.nodes:
        name = _name(n)
        if n.op != "call_function" or not name.startswith(
                ("aten.sort.", "aten.argsort.")):
            continue
        stable = bool(n.kwargs.get("stable", False)) if name.endswith(
            ".stable") else False
        dim = n.kwargs.get("dim", n.args[1] if len(n.args) > 1
                           and isinstance(n.args[1], int) else -1)
        out.append({"is_stable": stable, "op": name, "dimension": dim})
    return out


def _val(node):
    return node.meta.get("val")


def nondeterministic_eqns(prog) -> list[str]:
    """Nodes whose result depends on more than their inputs: float
    accumulation by index (atomics on the card) and draws from the
    global generator."""
    out = []
    for n in prog.graph.nodes:
        if n.op != "call_function":
            continue
        name = _name(n)
        if name.startswith(_GLOBAL_DRAWS):
            out.append(name)
            continue
        if name.startswith(_FLOAT_ACCUMULATE):
            accum = (not name.startswith(("aten.index_put",
                                          "aten._index_put_impl",
                                          "aten._unsafe_index_put"))
                     or bool(n.kwargs.get("accumulate", False) or (
                         len(n.args) > 3 and n.args[3] is True)))
            v = _val(n)
            dtype = getattr(v, "dtype", None)
            if accum and dtype is not None and dtype.is_floating_point:
                out.append(name)
    return out


def host_read_eqns(prog) -> list[str]:
    """``aten._local_scalar_dense`` nodes: host reads in the graph (none
    in a traced program: a host read stops the trace)."""
    return [str(n.name) for n in prog.graph.nodes
            if n.op == "call_function"
            and _name(n).startswith("aten._local_scalar_dense")]


# -------------------------------------------------------------- liveness

@dataclasses.dataclass
class LivenessReport:
    peak_bytes: int  # static peak-resident estimate
    input_bytes: int  # the graph's inputs (the state ABI and rows)
    output_bytes: int
    const_bytes: int  # tensors baked into the graph
    transient_bytes: int  # peak minus the always-resident inputs


def _bytes(val) -> int:
    if val is None:
        return 0
    if isinstance(val, (list, tuple)):
        return sum(_bytes(v) for v in val)
    shape = getattr(val, "shape", None)
    dtype = getattr(val, "dtype", None)
    if shape is None or dtype is None:
        return 0
    return int(math.prod(shape)) * int(dtype.itemsize)


def _node_bytes(prog, n) -> int:
    if n.op == "get_attr":
        return _bytes(getattr(prog.gm, n.target, None))
    return _bytes(_val(n))


def liveness(prog) -> LivenessReport:
    """Static peak-memory estimate of one traced program: buffers live
    from their defining node to their last consuming node (graph outputs
    to the end), inputs and constants from the start to their last use.
    No aliasing or view modeling — a view counts its own bytes — so this
    is an upper-bound-shaped estimate whose value is drift detection."""
    nodes = list(prog.graph.nodes)
    outs = {id(o) for o in _outputs(prog.graph) if hasattr(o, "op")}
    last_use: dict = {}
    for i, n in enumerate(nodes):
        for a in _tensor_args(n):
            last_use[id(a)] = i
    for o in outs:
        last_use[o] = len(nodes)
    live: dict = {}
    in_b = const_b = 0
    for n in nodes:
        if n.op in ("placeholder", "get_attr"):
            b = _node_bytes(prog, n)
            if n.op == "placeholder":
                in_b += b
            else:
                const_b += b
            if id(n) in last_use:
                live[id(n)] = b
    peak = sum(live.values())
    for i, n in enumerate(nodes):
        if n.op in ("placeholder", "get_attr", "output"):
            continue
        b = _node_bytes(prog, n)
        peak = max(peak, sum(live.values()) + b)
        if last_use.get(id(n), -1) > i:
            live[id(n)] = b
        for a in _tensor_args(n):
            if last_use.get(id(a)) == i:
                live.pop(id(a), None)
    out_b = sum(_node_bytes(prog, o) for o in _outputs(prog.graph)
                if hasattr(o, "op"))
    return LivenessReport(
        peak_bytes=int(peak), input_bytes=int(in_b),
        output_bytes=int(out_b), const_bytes=int(const_b),
        transient_bytes=int(max(0, peak - in_b - const_b)),
    )
