"""corro-lint rule catalog: torch hazards on the step path, over the AST.

The port's counterpart of ``corro_sim/analysis/rules.py``. The JAX
package's rules flag JAX trace hazards; these flag what hurts the
port's eager step on the card, under the same IDs where an analog
exists:

  CL101 host-sync       ``.item()``/``.tolist()``/``.numpy()``/``.cpu()``,
                        ``np.asarray()`` or ``float()``/``int()``/
                        ``bool()`` of a tensor inside a function
                        reachable from the step's entry points, outside
                        a ``sanctioned`` block — a blocking device→host
                        wait that stalls the pipelined dispatch.
  CL102 prng-reuse      a key of ``prng.py`` consumed by more than one
                        draw (or re-consumed across loop iterations)
                        without ``split``/``fold_in`` — correlated
                        streams.
  CL103 scalar-tensor   ``torch.tensor``/``torch.as_tensor`` of a bare
                        Python number on the step path — a blocking
                        host→device copy on the card (the copy waits for
                        the queue to drain) whose dtype is inferred; use
                        ``torch.full((), x, dtype=..., device=...)``.
  CL104 traced-branch   Python ``if``/``while``/``assert``/ternary on a
                        tensor's truth value on the step path — a hidden
                        host sync per call.
  CL106 use-after-consume a state read again after it was passed to a
                        function that consumes its input state
                        (``sim_step``, ``run_sim``, ``sync_round``,
                        ``delivery_pass``, ``merge_grouped``,
                        ``route_merge_sharded``): their planes are
                        merged in place.
  CL107 module-scope-device device work at import time: a tensor made on
                        a CUDA device, a kernel build, or a
                        ``torch.cuda`` call at module or class scope —
                        it runs before an entry point chose the device,
                        and the tests import every module on machines
                        without a card.
  CL108 unseeded-shuffle a ``torch.rand*``/``randperm``/``multinomial``/
                        ``bernoulli``/``normal`` draw without an
                        explicit ``generator=``, or a ``sort``/
                        ``argsort`` on the step path without
                        ``stable=True`` — either makes a seeded run
                        depend on more than its seed.
  CL109 duplicate-fold-tag two distinct ``prng.fold_in`` call sites
                        folding the same literal tag onto the same key
                        expression — both derive the SAME child stream.

The JAX package's CL105 (host mutation inside traced code, which runs
at trace time only) has no analog here: the eager step runs its Python
body on every call, so a closure mutation is ordinary host code.

The step path is declared: :data:`STEP_SEEDS` names the port's step
entry points, and functions handed to a tracing or compiling entry
point (``torch.compile``, ``torch.jit.script``, ``make_fx``,
``torch.func.*``) seed it too; every function they call that resolves
inside the analyzed tree (module-level call graph over ``from
corro_sim_torch.x import y`` edges) is on it. Tainted values (tensors)
are seeded from parameters annotated ``torch.Tensor`` or ``*State``,
plus anything assigned from a ``torch.*`` call or a ``prng`` draw, and
flow through arithmetic, indexing and attribute access (``.shape``/
``.dtype``/``.device``/``.ndim`` and ``is None`` checks are host-static
and strip taint). An unannotated parameter is assumed host-static, so
the analysis prefers precision over recall.

Suppression: ``# corro-lint: ignore[CL101]`` (comma-separated IDs, or
bare ``ignore`` for all rules) on the finding's line or the line above.
"""

from __future__ import annotations

import ast
import dataclasses


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str  # "error" | "warning"
    summary: str


RULES: dict[str, Rule] = {
    r.id: r
    for r in (
        Rule("CL101", "host-sync", "error",
             "host read of a tensor's value on the step path, outside "
             "a sanctioned point"),
        Rule("CL102", "prng-reuse", "error",
             "PRNG key consumed more than once without split/fold_in"),
        Rule("CL103", "scalar-tensor", "warning",
             "tensor built from a bare Python number on the step path "
             "(a blocking host-to-device copy with an inferred dtype)"),
        Rule("CL104", "traced-branch", "error",
             "Python control flow on a tensor's truth value on the step "
             "path"),
        Rule("CL106", "use-after-consume", "error",
             "state read after being passed to a function that consumes "
             "it"),
        Rule("CL107", "module-scope-device", "warning",
             "device work (CUDA tensor, kernel build, torch.cuda call) "
             "at module import time"),
        Rule("CL108", "unseeded-shuffle", "warning",
             "random draw without an explicit generator, or a sort on "
             "the step path without stable=True"),
        Rule("CL109", "duplicate-fold-tag", "error",
             "same literal fold_in tag folded onto the same key at "
             "two call sites (stream collision)"),
    )
}

# the step path's declared entry points: (module, function)
STEP_SEEDS = frozenset({
    ("corro_sim_torch.engine.step", "sim_step"),
    ("corro_sim_torch.engine.step", "_repair_step"),
    ("corro_sim_torch.core.delivery", "delivery_pass"),
    ("corro_sim_torch.sync.sync", "sync_round"),
    ("corro_sim_torch.membership.swim", "swim_step"),
    ("corro_sim_torch.membership.swim_window", "swim_window_step"),
    ("corro_sim_torch.gossip.broadcast", "broadcast_step"),
    ("corro_sim_torch.core.merge_kernel", "merge_grouped"),
    ("corro_sim_torch.core.merge_kernel", "route_merge_sharded"),
})

# functions that consume their input state, and the position of the
# consumed argument (CL106)
CONSUMERS = {
    "sim_step": (1, "state"),
    "run_sim": (1, "state"),
    "sync_round": (3, "table"),
    "delivery_pass": (1, "table"),
    "merge_grouped": (0, "state"),
    "route_merge_sharded": (0, "state"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# annotations that seed taint: tensors and state dataclasses; everything
# else (configs, ints, callables, numpy keys) is host data
_ARRAY_ANNOTATIONS = {
    "torch.Tensor", "Tensor", "TensorLike",
}
# attribute reads that are host-static even on a tensor
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout"}
# tensor methods that return host values (shapes, counts, pointers)
_HOST_METHODS = {"size", "numel", "dim", "element_size", "stride",
                 "is_contiguous", "data_ptr", "nbytes", "storage_offset",
                 "get_device", "is_floating_point"}
# prng.py functions that DERIVE keys rather than consuming entropy
_KEY_DERIVERS = {"PRNGKey", "split", "fold_in"}
# in-tree derivation helpers (engine/driver.py) that wrap fold_in/split
_TREE_KEY_DERIVERS = {"chunk_keys", "round_key"}
# prng.py draws: they consume a key and return a tensor
_PRNG_DRAWS = {"random_bits", "uniform", "randint", "permutation",
               "choice"}


def _is_prng(dotted: str | None) -> bool:
    return dotted is not None and (
        dotted.startswith("corro_sim_torch.prng.")
        or dotted.startswith("prng."))


def _is_key_deriver(dotted: str | None) -> bool:
    if dotted is None:
        return False
    leaf = dotted.rsplit(".", 1)[-1]
    if _is_prng(dotted) and leaf in _KEY_DERIVERS:
        return True
    return leaf in _TREE_KEY_DERIVERS


# tracing and compiling entry points whose function arguments run on the
# step path
_TRACE_ENTRYPOINTS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.fx.symbolic_trace", "torch.func.functionalize",
    "torch.func.vmap", "torch.vmap", "torch.func.grad",
    "torch.fx.experimental.proxy_tensor.make_fx",
}


def _module_name(path: str) -> str:
    """Dotted module name, anchored at the innermost package root."""
    parts = path.replace("\\", "/").split("/")
    name = parts[-1]
    if name.endswith(".py"):
        name = name[:-3]
    pkg: list[str] = []
    for i in range(len(parts) - 2, -1, -1):
        if parts[i] == "corro_sim" or parts[i].startswith("corro_"):
            pkg = parts[i:-1]
            break
    return ".".join(pkg + [name]) if pkg else name


class _ModuleIndex:
    """Per-module import aliases + function defs + call edges."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.module = _module_name(path)
        self.tree = tree
        # alias -> dotted path ("np" -> "numpy"); from-imports map
        # name -> "module.attr" so call targets resolve cross-module
        self.aliases: dict[str, str] = {}
        self.functions: dict[str, ast.FunctionDef] = {}  # qualname -> def
        self._index_imports(tree)
        self._index_functions(tree)

    def _index_imports(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # relative: resolve against this package
                    pkg = self.module.split(".")[: -node.level]
                    base = ".".join(pkg + ([node.module]
                                           if node.module else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{base}.{a.name}"

    def _index_functions(self, tree: ast.Module) -> None:
        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    self.functions[qual] = child
                    visit(child, qual + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)
        visit(tree, "")

    def dotted(self, node: ast.AST) -> str | None:
        """Resolve an expression to a dotted path through the alias map:
        ``np.repeat`` -> "numpy.repeat"."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))


# calls that return host values, never tensors
_HOST_BUILTINS = {
    "len", "int", "float", "bool", "range", "min", "max", "isinstance",
    "getattr", "hasattr", "print", "callable", "type", "id", "repr", "str",
}
# torch namespaces whose calls are not tensor values
_TORCH_HOST = ("torch.cuda.", "torch.device", "torch.Size", "torch.dtype",
               "torch.get_", "torch.set_", "torch.is_", "torch.backends.",
               "torch.distributed.", "torch.utils.", "torch.profiler.",
               "torch.manual_seed", "torch.no_grad", "torch.inference_mode",
               "torch.ops.", "torch.fx.", "torch.func.", "torch.compile",
               "torch.jit.", "torch.library.")


def _is_tensor_call(idx: _ModuleIndex, node: ast.Call) -> bool:
    """A call that produces a tensor: a ``torch.*`` op or a ``prng`` draw."""
    d = idx.dotted(node.func)
    if d is None:
        return False
    if d.startswith("torch.") and not d.startswith(_TORCH_HOST):
        return True
    return _is_prng(d) and d.rsplit(".", 1)[-1] in _PRNG_DRAWS


def _annotation_taints(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann)
    for t in text.replace("|", " ").replace("Optional[", " ").split():
        t = t.strip("[], \"'")
        if t in _ARRAY_ANNOTATIONS or t.split(".")[-1].endswith("State"):
            return True
    return False


def _ends_in_jump(stmts: list[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


def _is_sanctioned_with(idx: _ModuleIndex, st: ast.With) -> bool:
    """A ``with sanctioned(...)`` block: the transfer guard's sanctioned
    point, where a host read is the point."""
    for item in st.items:
        e = item.context_expr
        if isinstance(e, ast.Call):
            d = idx.dotted(e.func) or ""
            if d.rsplit(".", 1)[-1] in ("sanctioned", "_tg_sanctioned"):
                return True
    return False


# --------------------------------------------------------------- taint

class _Taint:
    """Forward taint over one function body (two passes for loop-carried
    flow). ``tainted`` holds names currently bound to tensors."""

    def __init__(self, idx: _ModuleIndex, fn: ast.FunctionDef):
        self.idx = idx
        self.tainted: set[str] = set()
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])):
            if _annotation_taints(a.annotation):
                self.tainted.add(a.arg)

    def expr(self, node: ast.AST) -> bool:
        """Is this expression's value a tensor?"""
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.expr(node.left) or any(
                self.expr(c) for c in node.comparators
            )
        if isinstance(node, ast.BinOp):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) or self.expr(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            func = node.func
            # host-converting calls return HOST values — the conversion
            # itself is CL101's business
            if isinstance(func, ast.Name) and func.id in _HOST_BUILTINS:
                return False
            d = self.idx.dotted(func)
            if d is not None and (d.startswith("numpy.") or d == "numpy"):
                return False
            if _is_tensor_call(self.idx, node):
                return True
            if isinstance(func, ast.Attribute) and func.attr in (
                "item", "tolist", "numpy", *_HOST_METHODS,
            ):
                return False
            # a method on a tensor (x.sum(), x.to(...)) stays a tensor
            if isinstance(func, ast.Attribute) and self.expr(func.value):
                return True
            return False
        return False

    def assign(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.assign(e, tainted)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, tainted)


# ------------------------------------------------------------ checkers

class _FunctionChecker:
    """Runs the per-function rules; ``on_path`` arms CL101/103/104."""

    def __init__(self, idx: _ModuleIndex, fn: ast.FunctionDef,
                 on_path: bool, findings: list[Finding]):
        self.idx = idx
        self.fn = fn
        self.traced = on_path
        self.findings = findings
        self.taint = _Taint(idx, fn)
        self.sanctioned = 0  # depth of enclosing `with sanctioned(...)`
        self._seen: set[tuple] = set()

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        key = (rule, node.lineno, node.col_offset)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(
            rule=rule, severity=RULES[rule].severity, path=self.idx.path,
            line=node.lineno, col=node.col_offset, message=message,
        ))

    # -- driver: two passes, report on the second (loop-carried taint) --
    def run(self) -> None:
        for report in (False, True):
            self._stmts(self.fn.body, report)

    def _stmts(self, stmts: list[ast.stmt], report: bool) -> None:
        for st in stmts:
            self._stmt(st, report)

    def _stmt(self, st: ast.stmt, report: bool) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested defs are checked as their own functions
        if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = st.value
            if value is not None:
                self._expr(value, report)
                t = self.taint.expr(value)
                targets = (
                    st.targets if isinstance(st, ast.Assign)
                    else [st.target]
                )
                for tgt in targets:
                    if isinstance(st, ast.AugAssign):
                        t = t or self.taint.expr(tgt)
                    self.taint.assign(tgt, t)
            return
        if isinstance(st, ast.If):
            self._branch_test(st.test, report)
            self._expr(st.test, report)
            self._stmts(st.body, report)
            self._stmts(st.orelse, report)
            return
        if isinstance(st, ast.While):
            self._branch_test(st.test, report)
            self._expr(st.test, report)
            for _ in range(2):  # second pass: next-iteration hazards
                self._stmts(st.body, report)
            return
        if isinstance(st, ast.For):
            self._expr(st.iter, report)
            self.taint.assign(st.target, self.taint.expr(st.iter))
            for _ in range(2):
                self._stmts(st.body, report)
            self._stmts(st.orelse, report)
            return
        if isinstance(st, ast.Assert):
            self._branch_test(st.test, report)
            self._expr(st.test, report)
            return
        if isinstance(st, (ast.Return, ast.Expr)):
            if st.value is not None:
                self._expr(st.value, report)
            return
        if isinstance(st, ast.With):
            for item in st.items:
                self._expr(item.context_expr, report)
            inside = _is_sanctioned_with(self.idx, st)
            self.sanctioned += inside
            self._stmts(st.body, report)
            self.sanctioned -= inside
            return
        if isinstance(st, ast.Try):
            self._stmts(st.body, report)
            for h in st.handlers:
                self._stmts(h.body, report)
            self._stmts(st.orelse, report)
            self._stmts(st.finalbody, report)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child, report)

    # -- CL104 -----------------------------------------------------
    def _branch_test(self, test: ast.AST, report: bool) -> None:
        if (report and self.traced and not self.sanctioned
                and self.taint.expr(test)):
            self.emit(
                "CL104", test,
                "Python control flow on a tensor's truth value — a host "
                "sync per call on the card; keep the decision on the "
                "device (torch.where) or take it from host data",
            )

    # -- expression walk: CL101 / CL103 / ternaries ----------------
    def _expr(self, node: ast.AST, report: bool) -> None:
        for call in [n for n in ast.walk(node)
                     if isinstance(n, ast.Call)]:
            self._check_call(call, report)
        if report and self.traced and not self.sanctioned:
            for ifexp in [n for n in ast.walk(node)
                          if isinstance(n, ast.IfExp)]:
                if self.taint.expr(ifexp.test):
                    self.emit(
                        "CL104", ifexp,
                        "ternary on a tensor's truth value — use "
                        "torch.where",
                    )
        for comp in [n for n in ast.walk(node)
                     if isinstance(n, ast.comprehension)]:
            for cond in comp.ifs:
                self._branch_test(cond, report)

    def _check_call(self, call: ast.Call, report: bool) -> None:
        if not (report and self.traced):
            return
        func = call.func
        d = self.idx.dotted(func)
        arg0 = call.args[0] if call.args else None
        if not self.sanctioned:
            # CL101: scalar coercions and host copies of tensors
            if (
                isinstance(func, ast.Name)
                and func.id in ("float", "int", "bool", "complex")
                and arg0 is not None
                and self.taint.expr(arg0)
            ):
                self.emit(
                    "CL101", call,
                    f"{func.id}() of a tensor waits for the device and "
                    "copies to the host on the step path (re-serializes "
                    "dispatch); keep the value on the device or read it "
                    "at a sanctioned point between chunks",
                )
            if (
                isinstance(func, ast.Attribute)
                and func.attr in ("item", "tolist", "numpy", "cpu")
                and self.taint.expr(func.value)
            ):
                self.emit(
                    "CL101", call,
                    f".{func.attr}() of a tensor is a blocking "
                    "device->host read on the step path",
                )
            if (
                d in ("numpy.asarray", "numpy.array")
                and arg0 is not None
                and self.taint.expr(arg0)
            ):
                self.emit(
                    "CL101", call,
                    f"{d.replace('numpy', 'np')}() of a tensor copies it "
                    "to the host on the step path",
                )
        # CL103: a tensor from a bare Python number
        if (
            d in ("torch.tensor", "torch.as_tensor")
            and arg0 is not None
            and self._is_numeric_literal(arg0)
        ):
            self.emit(
                "CL103", call,
                "tensor built from a bare Python number on the step path "
                "— on the card a blocking host->device copy, and its "
                "dtype is inferred; use torch.full((), x, dtype=..., "
                "device=...)",
            )

    @staticmethod
    def _is_numeric_literal(node: ast.AST) -> bool:
        if isinstance(node, ast.UnaryOp):
            node = node.operand
        return isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float, complex))


def _consumed_position(idx: _ModuleIndex, call: ast.Call):
    """``(callee, consumed argument node)`` of a call to a state
    consumer, else None."""
    d = idx.dotted(call.func)
    if d is None:
        return None
    leaf = d.rsplit(".", 1)[-1]
    if leaf not in CONSUMERS:
        return None
    pos, kw = CONSUMERS[leaf]
    if pos < len(call.args):
        return leaf, call.args[pos]
    for k in call.keywords:
        if k.arg == kw:
            return leaf, k.value
    return None


def _check_consumed_uses(idx: _ModuleIndex, fn: ast.FunctionDef,
                         findings: list[Finding]) -> None:
    """CL106 linear scan: consume at call, flag any later Load before a
    rebind. Loop bodies are scanned twice so a next-iteration reuse of a
    consumed carry is caught."""
    pending: dict[str, tuple[str, int]] = {}
    seen: set[tuple] = set()

    def scan_expr_loads(node: ast.AST, skip: set[int]) -> None:
        for n in ast.walk(node):
            if (
                isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load)
                and n.id in pending
                and id(n) not in skip
            ):
                callee, line = pending[n.id]
                key = ("CL106", n.lineno, n.col_offset)
                if key not in seen:
                    seen.add(key)
                    findings.append(Finding(
                        rule="CL106", severity=RULES["CL106"].severity,
                        path=idx.path, line=n.lineno, col=n.col_offset,
                        message=(
                            f"'{n.id}' was consumed by '{callee}' at line "
                            f"{line} and read again — its planes may "
                            "have been merged in place; read the call's "
                            "result instead (or clone before the call)"
                        ),
                    ))

    def consume(value: ast.AST) -> set[int]:
        """Arm every consumer call inside ``value``; returns the ids of
        the consumed argument nodes (not reads after the fact)."""
        skip: set[int] = set()
        calls = [n for n in ast.walk(value) if isinstance(n, ast.Call)]
        for call in calls:
            got = _consumed_position(idx, call)
            if got is not None and isinstance(got[1], ast.Name):
                skip.add(id(got[1]))
        scan_expr_loads(value, skip)
        for call in calls:
            got = _consumed_position(idx, call)
            if got is not None and isinstance(got[1], ast.Name):
                pending[got[1].id] = (got[0], call.lineno)
        return skip

    def scan(stmts: list[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.Assign, ast.AnnAssign)):
                targets = (
                    st.targets if isinstance(st, ast.Assign)
                    else [st.target]
                )
                if st.value is not None:
                    consume(st.value)
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            pending.pop(n.id, None)
            elif isinstance(st, (ast.For, ast.While)):
                for _ in range(2):
                    scan(st.body)
                scan(st.orelse)
            elif isinstance(st, ast.If):
                # each arm scans from the pre-branch state, then the arm
                # states union
                scan_expr_loads(st.test, set())
                snap = dict(pending)
                scan(st.body)
                after_body = dict(pending)
                pending.clear()
                pending.update(snap)
                scan(st.orelse)
                pending.update(after_body)
            elif isinstance(st, ast.With):
                for item in st.items:
                    scan_expr_loads(item.context_expr, set())
                scan(st.body)
            elif isinstance(st, ast.Try):
                scan(st.body)
                for h in st.handlers:
                    scan(h.body)
                scan(st.orelse)
                scan(st.finalbody)
            elif isinstance(st, (ast.Expr, ast.Return)) and (
                    st.value is not None):
                consume(st.value)
            else:
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.expr):
                        scan_expr_loads(child, set())

    scan(fn.body)


# ------------------------------------------------------ CL102 (PRNG)

def _check_prng_reuse(idx: _ModuleIndex, fn: ast.FunctionDef,
                      findings: list[Finding]) -> None:
    """A key name consumed (passed to a draw, a non-deriver call, or
    stored into a container) more than once — branch-aware: exclusive
    ``if``/``else`` arms take the max, loop bodies double uses of keys
    bound outside the loop."""
    key_vars: dict[str, ast.stmt] = {}  # name -> binding statement

    def value_is_key(value: ast.AST) -> bool:
        if isinstance(value, ast.Call):
            return _is_key_deriver(idx.dotted(value.func))
        if isinstance(value, ast.Subscript):
            return value_is_key(value.value) or (
                isinstance(value.value, ast.Name)
                and value.value.id in key_vars
            )
        if isinstance(value, ast.Name):
            return value.id in key_vars
        return False

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and value_is_key(node.value):
            for t in node.targets:
                for n in (
                    t.elts if isinstance(t, (ast.Tuple, ast.List))
                    else [t]
                ):
                    if isinstance(n, ast.Name):
                        key_vars[n.id] = node
    if not key_vars:
        return

    def consumptions(node: ast.AST, name: str) -> list[ast.AST]:
        """Consuming use sites of ``name`` within one expression."""
        out = []
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                if _is_key_deriver(idx.dotted(n.func)):
                    continue
                for a in list(n.args) + [k.value for k in n.keywords]:
                    if isinstance(a, ast.Name) and a.id == name:
                        out.append(a)
                    elif isinstance(a, (ast.Tuple, ast.List)):
                        out.extend(
                            e for e in a.elts
                            if isinstance(e, ast.Name) and e.id == name
                        )
        return out

    def in_loop_bound_outside(name: str, loop: ast.stmt) -> bool:
        binding = key_vars.get(name)
        if binding is None:
            return False
        return not any(b is binding for b in ast.walk(loop))

    def count(stmts: list[ast.stmt], name: str) -> tuple[int, list]:
        total, sites = 0, []
        i = 0
        while i < len(stmts):
            st = stmts[i]
            if isinstance(st, ast.If):
                tb, ts = count_node_exprs(st.test, name)
                b, bs = count(st.body, name)
                o, os_ = count(st.orelse, name)
                if _ends_in_jump(st.body) and not st.orelse:
                    r, rs = count(stmts[i + 1:], name)
                    branch, bsites = max(
                        ((b, bs), (o + r, os_ + rs)),
                        key=lambda x: x[0],
                    )
                    return total + tb + branch, sites + ts + bsites
                branch, bsites = max(((b, bs), (o, os_)),
                                     key=lambda x: x[0])
                total += tb + branch
                sites += ts + bsites
            elif isinstance(st, (ast.For, ast.While)):
                b, bs = count(st.body, name)
                mult = 2 if (b and in_loop_bound_outside(name, st)) else 1
                total += b * mult
                sites += bs
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                pass
            elif isinstance(st, ast.Try):
                b, bs = count(st.body, name)
                total += b
                sites += bs
                for h in st.handlers:
                    hb, hs = count(h.body, name)
                    total += hb
                    sites += hs
            else:
                c, cs = count_node_exprs(st, name)
                total += c
                sites += cs
            i += 1
        return total, sites

    def count_node_exprs(node: ast.AST, name: str) -> tuple[int, list]:
        sites = consumptions(node, name)
        return len(sites), sites

    for name in key_vars:
        n, sites = count(fn.body, name)
        if n > 1 and len(sites) >= 1:
            site = sites[1] if len(sites) > 1 else sites[0]
            findings.append(Finding(
                rule="CL102", severity=RULES["CL102"].severity,
                path=idx.path, line=site.lineno, col=site.col_offset,
                message=(
                    f"PRNG key '{name}' is consumed {n}x without an "
                    "intervening split/fold_in — reused entropy "
                    "correlates supposedly-independent streams; derive "
                    "a fresh subkey per consumer"
                ),
            ))


# ------------------------------------ CL107 (module-scope device work)

# kernel builds: the port's builders and torch's extension loaders
_BUILD_LEAVES = {"build_kernel", "load", "load_inline", "jit"}
_BUILD_ROOTS = ("torch.utils.cpp_extension.", "triton.")


def _device_work(idx: _ModuleIndex, node: ast.Call) -> str | None:
    """What device work a call does at import, or None."""
    d = idx.dotted(node.func) or ""
    leaf = d.rsplit(".", 1)[-1]
    if d.startswith("torch.cuda."):
        return f"{d}()"
    if leaf == "build_kernel" or (d.startswith(_BUILD_ROOTS)
                                  and leaf in _BUILD_LEAVES):
        return f"a kernel build ({d})"
    if isinstance(node.func, ast.Attribute) and node.func.attr == "cuda":
        return ".cuda()"
    for k in node.keywords:
        if k.arg == "device" and isinstance(k.value, ast.Constant) and (
                isinstance(k.value.value, str)
                and k.value.value.startswith("cuda")):
            return f"a tensor on {k.value.value!r}"
    if isinstance(node.func, ast.Attribute) and node.func.attr == "to":
        for a in node.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str) and (
                    a.value.startswith("cuda")):
                return f".to({a.value!r})"
    return None


def _check_module_scope_device(idx: _ModuleIndex,
                               findings: list[Finding]) -> None:
    """Device work that runs at import — in a module/class-scope
    statement or a decorator of a module-level def: a tensor made on a
    CUDA device, a kernel build, a ``torch.cuda`` call. Code inside
    ``lambda``/generator bodies is lazy and exempt; function bodies run
    at call time."""

    def emit(node, what) -> None:
        findings.append(Finding(
            rule="CL107", severity=RULES["CL107"].severity,
            path=idx.path, line=node.lineno, col=node.col_offset,
            message=(
                f"{what} at module import time — it runs before an entry "
                "point chose the device, and every test imports the "
                "module on machines without a card; do it lazily inside "
                "the code that launches the kernel"
            ),
        ))

    def scan_expr(node) -> None:
        if isinstance(node, (ast.Lambda, ast.GeneratorExp)):
            return
        if isinstance(node, ast.Call):
            what = _device_work(idx, node)
            if what is not None:
                emit(node, what)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                scan_expr(child)

    def scan_stmts(stmts) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in st.decorator_list:
                    scan_expr(dec)
                continue  # the body runs at call time, not import time
            if isinstance(st, ast.ClassDef):
                scan_stmts(st.body)  # class bodies execute at import
                continue
            # one traversal only (a double visit would emit duplicates)
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    scan_expr(child)
                elif isinstance(child, ast.stmt):
                    scan_stmts([child])
                elif isinstance(
                    getattr(child, "body", None), list
                ):
                    scan_stmts(child.body)

    scan_stmts(idx.tree.body)


# --------------------------------------------- CL108 (unseeded shuffle)

_TORCH_DRAWS = {"torch.rand", "torch.randn", "torch.randint",
                "torch.randperm", "torch.multinomial", "torch.bernoulli",
                "torch.normal", "torch.poisson", "torch.rand_like",
                "torch.randn_like", "torch.randint_like"}
_SORTS = {"sort", "argsort"}


def _check_unseeded_shuffle(idx: _ModuleIndex, fn: ast.FunctionDef,
                            on_path: bool,
                            findings: list[Finding]) -> None:
    """``torch`` draws without ``generator=`` anywhere (they read the
    global generator, so a seeded run depends on what ran before it),
    and on the step path ``sort``/``argsort`` without ``stable=True``
    (ties may come back in any order on the card)."""

    def emit(call: ast.Call, message: str) -> None:
        if any(f.rule == "CL108" and f.path == idx.path
               and f.line == call.lineno and f.col == call.col_offset
               for f in findings):
            return  # already flagged via an enclosing function walk
        findings.append(Finding(
            rule="CL108", severity=RULES["CL108"].severity,
            path=idx.path, line=call.lineno, col=call.col_offset,
            message=message,
        ))

    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        d = idx.dotted(node.func)
        kws = {k.arg: k.value for k in node.keywords}
        if d in _TORCH_DRAWS and "generator" not in kws:
            emit(node, f"{d}() without generator= draws from the global "
                       "generator — pass a seeded torch.Generator (or "
                       "draw through prng.py)")
            continue
        leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
                else None)
        is_sort = (d in ("torch.sort", "torch.argsort")
                   or (leaf in _SORTS and not (d or "").startswith(
                       ("numpy.", "np."))))
        if on_path and is_sort:
            st = kws.get("stable")
            if not (isinstance(st, ast.Constant) and st.value is True):
                emit(node, "sort without stable=True on the step path — "
                           "equal keys may come back in any order on the "
                           "card; pin stable=True")


def _literal_tag(idx: _ModuleIndex, consts: dict[str, int],
                 node: ast.AST) -> int | None:
    """Resolve a fold_in tag expression to a literal int, or None: an int
    constant or a bare name bound to a module-level int constant. Loop
    variables and arithmetic stay unresolved on purpose."""
    if isinstance(node, ast.Constant):
        v = node.value
        if isinstance(v, int) and not isinstance(v, bool):
            return v
        return None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _literal_tag(idx, consts, node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _check_duplicate_fold_tag(idx: _ModuleIndex, fn: ast.FunctionDef,
                              findings: list[Finding]) -> None:
    """CL109: two ``prng.fold_in`` call sites in one function folding the
    same resolved literal tag onto the same key expression — both derive
    the SAME child stream. Fires once, at the second site; named
    constants resolve through module-level int assignments."""
    consts: dict[str, int] = {}
    for st in idx.tree.body:
        if (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)
                and isinstance(st.value, ast.Constant)
                and isinstance(st.value.value, int)
                and not isinstance(st.value.value, bool)):
            consts[st.targets[0].id] = st.value.value

    seen: dict[tuple[str, int], ast.Call] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call) or len(node.args) < 2:
            continue
        d = idx.dotted(node.func)
        if not (_is_prng(d) and d.endswith(".fold_in")):
            continue
        tag = _literal_tag(idx, consts, node.args[1])
        if tag is None:
            continue
        sig = (ast.dump(node.args[0]), tag)
        first = seen.setdefault(sig, node)
        if (first.lineno, first.col_offset) == (node.lineno,
                                                node.col_offset):
            continue
        if any(f.rule == "CL109" and f.path == idx.path
               and f.line == node.lineno and f.col == node.col_offset
               for f in findings):
            continue  # already flagged via an enclosing function walk
        findings.append(Finding(
            rule="CL109", severity=RULES["CL109"].severity,
            path=idx.path, line=node.lineno, col=node.col_offset,
            message=(
                f"fold_in tag {tag} already folded onto this key at "
                f"line {first.lineno} — both sites derive the same "
                "stream (K2 collision); give each draw site its own "
                "declared tag constant"
            ),
        ))


# ---------------------------------------------------- step-path graph

def _seeds_and_edges(idx: _ModuleIndex):
    """Seed step-path functions + call edges for one module."""
    seeds: set[tuple[str, str]] = {
        (m, q) for m, q in STEP_SEEDS if m == idx.module
        and q in idx.functions
    }
    edges: dict[tuple[str, str], set[tuple[str, str]]] = {}
    parents: dict[str, str] = {}  # child qual -> parent qual

    qual_by_node = {id(node): q for q, node in idx.functions.items()}

    for qual, fn in idx.functions.items():
        for dec in fn.decorator_list:
            d = idx.dotted(dec if not isinstance(dec, ast.Call)
                           else dec.func)
            if d in _TRACE_ENTRYPOINTS:
                seeds.add((idx.module, qual))
        # nesting: a def inside a step-path def is on the path
        for child in ast.walk(fn):
            if (
                isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                and child is not fn
                and id(child) in qual_by_node
            ):
                parents.setdefault(qual_by_node[id(child)], qual)
        key = (idx.module, qual)
        edges.setdefault(key, set())
        for call in [n for n in ast.walk(fn) if isinstance(n, ast.Call)]:
            d = idx.dotted(call.func)
            if d in _TRACE_ENTRYPOINTS:
                # callbacks handed to a tracing/compiling entry point
                for a in call.args:
                    cb = idx.dotted(a)
                    if cb is None:
                        continue
                    if cb in idx.functions:
                        seeds.add((idx.module, cb))
                    elif cb in idx.aliases.values():
                        mod, _, name = cb.rpartition(".")
                        seeds.add((mod, name))
                    elif isinstance(a, ast.Name):
                        for q in idx.functions:
                            if q.split(".")[-1] == a.id and (
                                q.startswith(qual + ".") or "." not in q
                            ):
                                seeds.add((idx.module, q))
            # plain-call edges to local or imported functions
            target = None
            if isinstance(call.func, ast.Name):
                name = call.func.id
                cands = [q for q in idx.functions
                         if q.split(".")[-1] == name]
                if cands:
                    target = (idx.module, max(cands, key=len))
                elif name in idx.aliases:
                    mod, _, attr = idx.aliases[name].rpartition(".")
                    if mod:
                        target = (mod, attr)
            elif d is not None and d.startswith("corro_sim_torch."):
                # module-attribute calls: ``step_mod.sim_step(...)``
                mod, _, attr = d.rpartition(".")
                target = (mod, attr)
            if target is not None:
                edges[key].add(target)
    return seeds, edges, parents


def step_path(trees: dict[str, ast.Module]) -> set[tuple[str, str]]:
    """Every ``(module, qualname)`` reachable from the step's seeds."""
    return _reach([_ModuleIndex(p, t) for p, t in trees.items()])


def _reach(indexes) -> set[tuple[str, str]]:
    seeds: set[tuple[str, str]] = set()
    edges: dict[tuple[str, str], set[tuple[str, str]]] = {}
    parents_all: dict[tuple[str, str], tuple[str, str]] = {}
    for idx in indexes:
        s, e, parents = _seeds_and_edges(idx)
        seeds |= s
        for k, v in e.items():
            edges.setdefault(k, set()).update(v)
        for child, parent in parents.items():
            parents_all[(idx.module, child)] = (idx.module, parent)
    children: dict = {}
    for child, parent in parents_all.items():
        children.setdefault(parent, []).append(child)
    reached: set[tuple[str, str]] = set()
    work = list(seeds)
    while work:
        node = work.pop()
        if node in reached:
            continue
        reached.add(node)
        work.extend(t for t in edges.get(node, ()) if t not in reached)
        work.extend(c for c in children.get(node, ()) if c not in reached)
    return reached


def analyze(trees: dict[str, ast.Module]) -> list[Finding]:
    """Run every rule over the parsed files; returns unsuppressed-raw
    findings (suppression filtering happens in :mod:`lint`)."""
    indexes = [_ModuleIndex(path, tree) for path, tree in trees.items()]
    on_path = _reach(indexes)
    findings: list[Finding] = []
    for idx in indexes:
        _check_module_scope_device(idx, findings)
        for qual, fn in idx.functions.items():
            hot = (idx.module, qual) in on_path
            _FunctionChecker(idx, fn, hot, findings).run()
            _check_prng_reuse(idx, fn, findings)
            _check_consumed_uses(idx, fn, findings)
            _check_unseeded_shuffle(idx, fn, hot, findings)
            _check_duplicate_fold_tag(idx, fn, findings)
        # module-level statements: PRNG, consumption and draw discipline
        pseudo = ast.FunctionDef(
            name="<module>", args=ast.arguments(
                posonlyargs=[], args=[], kwonlyargs=[], kw_defaults=[],
                defaults=[],
            ),
            body=[st for st in idx.tree.body
                  if not isinstance(st, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef))],
            decorator_list=[],
        )
        _check_prng_reuse(idx, pseudo, findings)
        _check_consumed_uses(idx, pseudo, findings)
        _check_unseeded_shuffle(idx, pseudo, False, findings)
        _check_duplicate_fold_tag(idx, pseudo, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
