"""Function index, best-effort call graph, and lane inference.

A **lane** is one concurrent execution context: every
``threading.Thread(target=...)`` creation site (named by its literal
``name=`` prefix when present), every ``ThreadPoolExecutor.submit``
callee, HTTP handler ``do_*`` methods, plus the implicit ``main`` lane
seeded by the functions that CREATE threads (command entry points and
lane constructors run on the dispatching thread).

Call resolution is deliberately conservative — a static lint must
under-approximate rather than hallucinate edges:

* bare names resolve through the lexical scope chain (nested siblings,
  then module level, then project imports);
* ``self.m(...)`` resolves within the enclosing class;
* other attribute calls resolve only when the method name is defined by
  exactly ONE project function AND is not a common stdlib method name
  (``get``/``put``/``join``/... would otherwise pull queue traffic into
  the graph);
* a function referenced by name in non-call position (a callback handed
  to a retry wrapper) is assumed invoked on the SAME lane — except when
  the reference is a ``Thread(target=...)`` / ``submit`` argument,
  which starts its own lane.
"""

from __future__ import annotations

import ast
import re

from specpride_tpu_torch.analysis.core import Module, Project, kwarg

_LOCKISH_RE = re.compile(r"(?i)(lock|cond|mutex|sem)")

# attribute-call names too generic to resolve by project-wide uniqueness
_COMMON_METHODS = frozenset({
    "get", "put", "set", "add", "pop", "close", "read", "write", "open",
    "join", "start", "wait", "acquire", "release", "send", "recv",
    "items", "keys", "values", "update", "append", "extend", "clear",
    "copy", "flush", "run", "stop", "next", "submit", "result", "emit",
    "notify", "notify_all", "count", "index", "sort", "split", "strip",
    "encode", "decode", "format", "mkdir", "exists", "load", "dump",
})


class WriteSite:
    __slots__ = ("owner", "attr", "line", "guarded", "fn", "module")

    def __init__(self, owner: str, attr: str, line: int, guarded: bool,
                 fn: "FunctionInfo", module: Module):
        self.owner = owner  # class qualname for self-writes, "" = global
        self.attr = attr
        self.line = line
        self.guarded = guarded
        self.fn = fn
        self.module = module


class FunctionInfo:
    def __init__(self, module: Module, node, cls: str | None,
                 parent: "FunctionInfo | None"):
        self.module = module
        self.node = node
        self.cls = cls  # enclosing class name, if a method
        self.parent = parent  # enclosing function, if nested
        self.children: dict[str, FunctionInfo] = {}
        bits = []
        p = parent
        while p is not None:
            bits.append(p.node.name)
            p = p.parent
        prefix = ".".join(reversed(bits))
        name = node.name if not prefix else f"{prefix}.{name_of(node)}"
        if cls:
            name = f"{cls}.{name}"
        self.qualname = f"{module.name}:{name}"
        self.calls: list[tuple] = []  # resolution requests
        self.refs: list[str] = []  # names referenced in non-call position
        self.writes: list[WriteSite] = []
        self.lanes: set[str] = set()
        self.spawns: list[tuple] = []  # (target_expr, lane_name, lineno)
        self.uses_lock = False  # body contains a lock-ish `with`


def name_of(node) -> str:
    return node.name


def _is_lockish(expr_src: str) -> bool:
    return bool(_LOCKISH_RE.search(expr_src))


class _FnWalker(ast.NodeVisitor):
    """Walks ONE function body (not nested defs), collecting calls,
    name references, attribute writes with lock context, and thread
    spawns."""

    def __init__(self, fn: FunctionInfo, index: "CallGraph"):
        self.fn = fn
        self.index = index
        self.lock_depth = 0
        self.spawn_target_ids: set[int] = set()

    # -- structure ------------------------------------------------------

    def visit_FunctionDef(self, node):  # nested def: separate function
        self.index.index_function(self.fn.module, node, self.fn.cls,
                                  self.fn)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):  # nested class: index its methods
        self.index.index_class(self.fn.module, node)

    def visit_Lambda(self, node):
        self.generic_visit(node)

    def visit_With(self, node):
        lockish = any(
            _is_lockish(ast.unparse(item.context_expr))
            for item in node.items
        )
        for item in node.items:
            self.visit(item.context_expr)
        if lockish:
            self.fn.uses_lock = True
            self.lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if lockish:
            self.lock_depth -= 1

    visit_AsyncWith = visit_With

    # -- writes ---------------------------------------------------------

    def _note_write(self, target) -> None:
        # unwrap subscripts: `self.d[k] = v` mutates attribute `d`
        while isinstance(target, ast.Subscript):
            target = target.value
        if isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ):
            base = target.value.id
            if base == "self" and self.fn.cls:
                self.fn.writes.append(WriteSite(
                    f"{self.fn.module.name}:{self.fn.cls}", target.attr,
                    target.lineno, self.lock_depth > 0, self.fn,
                    self.fn.module,
                ))
            elif base in self.index.module_aliases.get(
                self.fn.module.name, {}
            ):
                owner = self.index.module_aliases[self.fn.module.name][
                    base
                ]
                self.fn.writes.append(WriteSite(
                    "", f"{owner}.{target.attr}", target.lineno,
                    self.lock_depth > 0, self.fn, self.fn.module,
                ))
        elif isinstance(target, ast.Name):
            if target.id in self._globals():
                self.fn.writes.append(WriteSite(
                    "", f"{self.fn.module.name}.{target.id}",
                    target.lineno, self.lock_depth > 0, self.fn,
                    self.fn.module,
                ))
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._note_write(elt)

    def _globals(self) -> set:
        cached = getattr(self.fn, "_global_names", None)
        if cached is None:
            cached = set()
            for stmt in ast.walk(self.fn.node):
                if isinstance(stmt, ast.Global):
                    cached.update(stmt.names)
            self.fn._global_names = cached
        return cached

    def visit_Assign(self, node):
        for tgt in node.targets:
            self._note_write(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node):
        self._note_write(node.target)
        self.visit(node.value)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._note_write(node.target)
            self.visit(node.value)

    # -- calls / refs / spawns -----------------------------------------

    def _lane_name(self, call: ast.Call, target) -> str:
        name_kw = kwarg(call, "name")
        if isinstance(name_kw, ast.Constant) and isinstance(
            name_kw.value, str
        ):
            return name_kw.value
        if isinstance(name_kw, ast.JoinedStr) and name_kw.values:
            first = name_kw.values[0]
            if isinstance(first, ast.Constant) and isinstance(
                first.value, str
            ):
                return first.value.rstrip("-_ ") or "thread"
        if isinstance(target, ast.Name):
            return f"thread:{target.id}"
        if isinstance(target, ast.Attribute):
            return f"thread:{target.attr}"
        return "thread"

    def visit_Call(self, node):
        fn = node.func
        # thread spawn?
        callee = (
            fn.attr if isinstance(fn, ast.Attribute)
            else fn.id if isinstance(fn, ast.Name) else ""
        )
        if callee == "Thread":
            target = kwarg(node, "target")
            if target is not None:
                self.fn.spawns.append(
                    (target, self._lane_name(node, target), node.lineno)
                )
                self.spawn_target_ids.add(id(target))
        elif callee == "submit" and node.args:
            # executor.submit(fn, ...): a pool lane named for the callee
            target = node.args[0]
            lane = (
                f"pool:{target.id}" if isinstance(target, ast.Name)
                else f"pool:{target.attr}"
                if isinstance(target, ast.Attribute) else "pool"
            )
            self.fn.spawns.append((target, lane, node.lineno))
            self.spawn_target_ids.add(id(target))
        # call edge request
        if isinstance(fn, ast.Name):
            self.fn.calls.append(("name", fn.id))
        elif isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                self.fn.calls.append(("self", fn.attr))
            elif isinstance(fn.value, ast.Name):
                self.fn.calls.append(("objattr", fn.value.id, fn.attr))
            else:
                self.fn.calls.append(("attr", fn.attr))
        if isinstance(fn, ast.Attribute):
            self.visit(fn.value)
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load) and id(node) not in (
            self.spawn_target_ids
        ):
            self.fn.refs.append(node.id)

    def visit_Attribute(self, node):
        # `self._meth` referenced as a callback
        if (
            isinstance(node.ctx, ast.Load)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and id(node) not in self.spawn_target_ids
        ):
            self.fn.refs.append(f"self.{node.attr}")
        self.generic_visit(node)


class CallGraph:
    """Index + lane propagation over one :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.functions: dict[str, FunctionInfo] = {}
        self.by_module: dict[str, dict[str, FunctionInfo]] = {}
        self.methods: dict[str, list[FunctionInfo]] = {}  # name -> fns
        # per-module import aliases: local name -> project module name
        self.module_aliases: dict[str, dict[str, str]] = {}
        # per-module imported functions: local name -> qualname
        self.imported_fns: dict[str, dict[str, str]] = {}
        module_names = {m.name for m in project.modules}
        for mod in project.modules:
            self.by_module.setdefault(mod.name, {})
            self._collect_imports(mod, module_names)
        for mod in project.modules:
            for node in mod.tree.body:
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    self.index_function(mod, node, None, None)
                elif isinstance(node, ast.ClassDef):
                    self.index_class(mod, node)
        # resolve imported function names now every def is indexed
        for mod_name, imports in self.imported_fns.items():
            for local, qual in list(imports.items()):
                if qual not in self.functions:
                    del imports[local]
        self._walk_bodies()
        self.lanes = self._propagate()

    # -- indexing -------------------------------------------------------

    def _collect_imports(self, mod: Module, module_names: set) -> None:
        aliases: dict[str, str] = {}
        fns: dict[str, str] = {}
        pkg_prefixes = {n.split(".")[0] for n in module_names}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in module_names:
                        aliases[a.asname or a.name.split(".")[0]] = (
                            a.name
                        )
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = node.module
                if base.split(".")[0] not in pkg_prefixes:
                    continue
                for a in node.names:
                    full = f"{base}.{a.name}"
                    local = a.asname or a.name
                    if full in module_names:
                        aliases[local] = full
                    elif base in module_names:
                        fns[local] = f"{base}:{a.name}"
        self.module_aliases[mod.name] = aliases
        self.imported_fns[mod.name] = fns

    def index_class(self, mod: Module, node: ast.ClassDef) -> None:
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.index_function(mod, item, node.name, None)
        # HTTP handler classes: do_* methods run on server threads
        bases = [ast.unparse(b) for b in node.bases]
        if any(b.endswith(("RequestHandler", "Handler")) for b in bases):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and (
                    item.name.startswith("do_") or item.name == "handle"
                ):
                    fi = self.functions.get(
                        f"{mod.name}:{node.name}.{item.name}"
                    )
                    if fi is not None:
                        fi.lanes.add("http-handler")

    def index_function(self, mod: Module, node, cls: str | None,
                       parent: FunctionInfo | None) -> FunctionInfo:
        fi = FunctionInfo(mod, node, cls, parent)
        self.functions[fi.qualname] = fi
        if parent is not None:
            parent.children[node.name] = fi
        else:
            self.by_module[mod.name][
                node.name if not cls else f"{cls}.{node.name}"
            ] = fi
        self.methods.setdefault(node.name, []).append(fi)
        return fi

    def _walk_bodies(self) -> None:
        # worklist, not a snapshot: walking a body INDEXES its nested
        # defs (visit_FunctionDef), and those must be walked too — a
        # snapshot loop would leave every nested thread body (the
        # repo's dominant concurrency pattern: _packer/_stager/_worker
        # closures) with empty call/write info and kill propagation
        walked: set[str] = set()
        while True:
            pending = [
                fi for q, fi in list(self.functions.items())
                if q not in walked
            ]
            if not pending:
                break
            for fi in pending:
                walked.add(fi.qualname)
                walker = _FnWalker(fi, self)
                for stmt in fi.node.body:
                    walker.visit(stmt)

    # -- resolution -----------------------------------------------------

    def resolve_name(self, caller: FunctionInfo, name: str):
        p = caller
        while p is not None:
            if name in p.children:
                return p.children[name]
            p = p.parent
        mod_fns = self.by_module.get(caller.module.name, {})
        if name in mod_fns:
            return mod_fns[name]
        if caller.cls and f"{caller.cls}.{name}" in mod_fns:
            return mod_fns[f"{caller.cls}.{name}"]
        qual = self.imported_fns.get(caller.module.name, {}).get(name)
        if qual:
            return self.functions.get(qual)
        return None

    def resolve_call(self, caller: FunctionInfo, call: tuple):
        kind = call[0]
        if kind == "name":
            return self.resolve_name(caller, call[1])
        if kind == "self":
            if caller.cls:
                qual = f"{caller.module.name}:{caller.cls}.{call[1]}"
                if qual in self.functions:
                    return self.functions[qual]
            return self._unique_method(call[1])
        if kind == "objattr":
            base, meth = call[1], call[2]
            owner = self.module_aliases.get(caller.module.name, {}).get(
                base
            )
            if owner:
                return self.by_module.get(owner, {}).get(meth)
            return self._unique_method(meth)
        if kind == "attr":
            return self._unique_method(call[1])
        return None

    def _unique_method(self, name: str):
        if name in _COMMON_METHODS:
            return None
        hits = self.methods.get(name, [])
        return hits[0] if len(hits) == 1 else None

    def resolve_spawn_target(self, caller: FunctionInfo, target):
        if isinstance(target, ast.Name):
            return self.resolve_name(caller, target.id)
        if isinstance(target, ast.Attribute) and isinstance(
            target.value, ast.Name
        ):
            if target.value.id == "self" and caller.cls:
                qual = (
                    f"{caller.module.name}:{caller.cls}.{target.attr}"
                )
                return self.functions.get(qual)
            return self._unique_method(target.attr)
        return None

    # -- lane propagation ----------------------------------------------

    def _propagate(self) -> dict[str, set]:
        """Assign lanes to functions.  Returns lane -> entry qualnames."""
        entries: dict[str, set] = {}

        def seed(fi: FunctionInfo, lane: str) -> None:
            entries.setdefault(lane, set()).add(fi.qualname)

        for fi in self.functions.values():
            for target, lane, _line in fi.spawns:
                tgt = self.resolve_spawn_target(fi, target)
                if tgt is not None:
                    seed(tgt, lane)
            if fi.spawns or (
                fi.parent is None and not fi.cls
                and (fi.node.name.startswith("cmd_")
                     or fi.node.name == "main")
            ):
                seed(fi, "main")
        for fi in self.functions.values():
            for lane in fi.lanes:  # pre-seeded (http handlers)
                entries.setdefault(lane, set()).add(fi.qualname)

        for lane, quals in entries.items():
            visited: set[str] = set()
            stack = [self.functions[q] for q in quals]
            while stack:
                fi = stack.pop()
                if fi.qualname in visited:
                    continue
                visited.add(fi.qualname)
                fi.lanes.add(lane)
                spawn_ids = set()
                for target, _lane, _line in fi.spawns:
                    tgt = self.resolve_spawn_target(fi, target)
                    if tgt is not None:
                        spawn_ids.add(tgt.qualname)
                nexts = []
                for call in fi.calls:
                    tgt = self.resolve_call(fi, call)
                    if tgt is not None:
                        nexts.append(tgt)
                for ref in fi.refs:
                    if ref.startswith("self."):
                        tgt = self.resolve_call(fi, ("self", ref[5:]))
                    else:
                        tgt = self.resolve_name(fi, ref)
                    if tgt is not None and tgt.qualname not in spawn_ids:
                        nexts.append(tgt)
                for tgt in nexts:
                    if tgt.qualname not in visited:
                        stack.append(tgt)
        return entries
