"""``kernel-hygiene``: the hand-written kernels' construction invariants,
the port's counterpart of the JAX package's ``jit-hygiene`` (the port has
no ``jit``).

Five rules, each checked by AST:

a. **No build or load at import.**  No module-level call to the build
   module's (``ops/_build.py``) ``load`` or ``load_host``, and no
   module-level ``import triton`` or ``torch.utils.cpp_extension``: the
   CPU tests import every module on a host without ``nvcc``.
b. **Every wrapper has its plain version and its counter.**  In the
   module that defines ``_launch`` and the ``launches`` table
   (``ops/kernels.py``), every function that calls ``_launch`` has a
   ``<name>_plain`` sibling and a key in ``launches``, and counts its
   launches under that key; every key has such a wrapper.
c. **No fallback.**  No ``try`` whose body launches a kernel (a call of
   ``_launch`` or of a ``lib.<entry>``) has a handler that calls a
   ``*_plain`` function or returns on the CPU (``.cpu()`` or ``"cpu"``
   beside a ``return``): a wrapper on a CUDA tensor launches or raises.
d. **Every dispatched kernel can be warmed.**  Every kernel name passed
   to ``_note_dispatch`` (``backends/torch_backend.py``) has an entry in
   the warm-start table ``_WARM_BUILDERS`` (``warmstart/registry.py``),
   and every entry there is dispatched somewhere.  A name is read from a
   literal, a conditional of literals, a local bound to one, or a
   parameter of the enclosing function whose callers in the same module
   pass one; any other form is skipped.
e. **No host sync inside a launching wrapper.**  No ``.item()``,
   ``.tolist()``, ``.cpu()`` or ``torch.cuda.synchronize()`` in a
   function that calls ``_launch``.

As in every checker, a rule whose anchor is absent reports nothing.
"""

from __future__ import annotations

import ast

from specpride_tpu_torch.analysis.core import (
    Finding,
    Project,
    str_const,
)

CHECK = "kernel-hygiene"

_LOADS = frozenset({"load", "load_host"})
_SYNCS = frozenset({"item", "tolist", "cpu"})


def _import_time_nodes(tree):
    """Every node that runs when the module is imported: the module body
    and class bodies, with decorators and defaults of its defs, but not
    the bodies of functions and lambdas."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
            continue
        if isinstance(node, ast.Lambda):
            stack.extend(node.args.defaults)
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _own_nodes(fn):
    """The nodes of ``fn``'s body, not descending into nested defs and
    classes (``_functions`` yields those on their own)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            stack.extend(ast.iter_child_nodes(node))


def _calls_launch(fn) -> bool:
    return any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
        and n.func.id == "_launch"
        for n in _own_nodes(fn)
    )


def _launches_kernel(nodes) -> bool:
    """A call of ``_launch`` or of ``lib.<entry>`` among ``nodes``."""
    for stmt in nodes:
        for n in ast.walk(stmt):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Name) and f.id == "_launch":
                return True
            if isinstance(f, ast.Attribute) and isinstance(
                f.value, ast.Name
            ) and f.value.id == "lib":
                return True
    return False


def _functions(tree):
    """``(qualname, def)`` for every function, methods as
    ``Class.name`` and nested defs as ``outer.inner``."""
    stack = [("", n) for n in tree.body]
    while stack:
        prefix, node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{prefix}{node.name}"
            yield qual, node
            stack.extend((f"{qual}.", n) for n in node.body)
        elif isinstance(node, ast.ClassDef):
            stack.extend((f"{prefix}{node.name}.", n) for n in node.body)
        else:
            stack.extend((prefix, n) for n in ast.iter_child_nodes(node)
                         if isinstance(n, ast.stmt))


# -- a. no build or load at import ----------------------------------------


def _build_names(project: Project, mod) -> tuple[set, set]:
    """Local names in ``mod`` bound to the build module (``ops/_build``)
    and to its ``load`` / ``load_host``."""
    build_mods = {m.name for m in project.modules
                  if m.rel.endswith("ops/_build.py")}
    aliases: set = set()
    loads: set = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in build_mods and a.asname:
                    aliases.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if f"{node.module}.{a.name}" in build_mods:
                    aliases.add(a.asname or a.name)
                elif node.module in build_mods and a.name in _LOADS:
                    loads.add(a.asname or a.name)
    return aliases, loads


def _import_time_findings(project: Project) -> list[Finding]:
    findings = []
    for mod in project.modules:
        aliases, loads = _build_names(project, mod)
        for node in _import_time_nodes(mod.tree):
            what = None
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] == "triton":
                        what = "triton"
                    elif a.name.startswith("torch.utils.cpp_extension"):
                        what = "cpp_extension"
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.module.split(".")[0] == "triton":
                    what = "triton"
                elif node.module.startswith("torch.utils.cpp_extension") or (
                    node.module == "torch.utils"
                    and any(a.name == "cpp_extension" for a in node.names)
                ):
                    what = "cpp_extension"
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in _LOADS and (
                    isinstance(f.value, ast.Name)
                    and f.value.id in aliases
                ):
                    what = f.attr
                elif isinstance(f, ast.Name) and f.id in loads:
                    what = f.id
            if what is None:
                continue
            findings.append(Finding(
                check=CHECK, path=mod.rel, line=node.lineno,
                symbol=f"{what}:import-time",
                message=(
                    f"`{what}` is imported or called when the module is "
                    f"imported — build and import kernels inside the "
                    f"function that launches them (the CPU tests import "
                    f"every module without nvcc)"
                ),
            ))
    return findings


# -- b. wrappers, plain versions and counters ------------------------------


def _wrapper_findings(project: Project) -> list[Finding]:
    findings = []
    for mod in project.modules:
        top = {n.name: n for n in mod.tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        table = None
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "launches"
                for t in node.targets
            ) and isinstance(node.value, ast.Dict):
                table = (node, [str_const(k) for k in node.value.keys])
        if "_launch" not in top or table is None:
            continue
        table_node, keys = table
        wrappers = {name: fn for name, fn in top.items()
                    if name != "_launch" and _calls_launch(fn)}
        for name, fn in sorted(wrappers.items()):
            if f"{name}_plain" not in top:
                findings.append(Finding(
                    check=CHECK, path=mod.rel, line=fn.lineno,
                    symbol=f"{name}:plain",
                    message=(
                        f"kernel wrapper `{name}` has no `{name}_plain` "
                        f"sibling — the CPU path and the on-card check "
                        f"need the plain PyTorch version"
                    ),
                ))
            if name not in keys:
                findings.append(Finding(
                    check=CHECK, path=mod.rel, line=fn.lineno,
                    symbol=f"{name}:counter",
                    message=(
                        f"kernel wrapper `{name}` has no key in "
                        f"`launches` — its launches cannot be counted"
                    ),
                ))
            for call in _own_nodes(fn):
                if isinstance(call, ast.Call) and isinstance(
                    call.func, ast.Name
                ) and call.func.id == "_launch" and call.args:
                    counted = str_const(call.args[0])
                    if counted is not None and counted != name:
                        findings.append(Finding(
                            check=CHECK, path=mod.rel, line=call.lineno,
                            symbol=f"{name}:counter-name",
                            message=(
                                f"kernel wrapper `{name}` counts its "
                                f"launches under `{counted}`"
                            ),
                        ))
        for key in keys:
            if key is not None and key not in wrappers:
                findings.append(Finding(
                    check=CHECK, path=mod.rel, line=table_node.lineno,
                    symbol=f"{key}:wrapper",
                    message=(
                        f"`launches` counts `{key}` but no function of "
                        f"this module named so calls `_launch`"
                    ),
                ))
    return findings


# -- c. no fallback --------------------------------------------------------


def _falls_back(handler: ast.ExceptHandler) -> bool:
    plain = cpu = returns = False
    for n in ast.walk(handler):
        if isinstance(n, ast.Call):
            f = n.func
            name = (f.id if isinstance(f, ast.Name)
                    else f.attr if isinstance(f, ast.Attribute) else "")
            plain = plain or name.endswith("_plain")
            cpu = cpu or (isinstance(f, ast.Attribute) and f.attr == "cpu")
        elif isinstance(n, ast.Return):
            returns = True
        elif str_const(n) == "cpu":
            cpu = True
    return plain or (returns and cpu)


def _fallback_findings(project: Project) -> list[Finding]:
    findings = []
    for mod in project.modules:
        for qual, fn in _functions(mod.tree):
            for node in _own_nodes(fn):
                if not isinstance(
                    node, (ast.Try, getattr(ast, "TryStar", ast.Try))
                ) or not _launches_kernel(node.body):
                    continue
                for handler in node.handlers:
                    if _falls_back(handler):
                        findings.append(Finding(
                            check=CHECK, path=mod.rel,
                            line=handler.lineno,
                            symbol=f"{qual}:fallback",
                            message=(
                                f"`{qual}` catches a failed kernel launch "
                                f"and falls back to the plain version or "
                                f"the CPU — on a CUDA tensor a wrapper "
                                f"launches or raises"
                            ),
                        ))
    return findings


# -- d. every dispatched kernel can be warmed ------------------------------


def _literals(node) -> set | None:
    """The strings a literal or a conditional of literals gives."""
    s = str_const(node)
    if s is not None:
        return {s}
    if isinstance(node, ast.IfExp):
        a, b = _literals(node.body), _literals(node.orelse)
        if a is not None and b is not None:
            return a | b
    return None


def _param_args(tree, fn, param: str) -> set | None:
    """The literals that the callers of ``fn`` in ``tree`` pass as
    ``param``; None if a caller passes another form, or none is found."""
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    is_method = bool(params) and params[0] == "self"
    if param not in params:
        return None
    index = params.index(param) - (1 if is_method else 0)
    out: set = set()
    seen = False
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        f = call.func
        name = (f.attr if isinstance(f, ast.Attribute) and is_method
                else f.id if isinstance(f, ast.Name) and not is_method
                else None)
        if name != fn.name:
            continue
        seen = True
        arg = next((kw.value for kw in call.keywords if kw.arg == param),
                   call.args[index] if 0 <= index < len(call.args) else None)
        got = _literals(arg) if arg is not None else None
        if got is None:
            return None
        out |= got
    return out if seen else None


def _dispatched_names(tree, fn, arg) -> set | None:
    """The kernel names ``arg`` (the first argument of a
    ``_note_dispatch`` call inside ``fn``) can take, or None."""
    got = _literals(arg)
    if got is not None or not isinstance(arg, ast.Name):
        return got
    bound = [
        n.value for n in _own_nodes(fn)
        if isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == arg.id for t in n.targets
        )
    ]
    if bound:
        out: set = set()
        for value in bound:
            lits = _literals(value)
            if lits is None:
                return None
            out |= lits
        return out
    return _param_args(tree, fn, arg.id)


def _warm_findings(project: Project) -> list[Finding]:
    hit = project.one_constant("_WARM_BUILDERS")
    if hit is None or not isinstance(hit[1], ast.Dict):
        return []
    reg_mod, reg_node, reg_line = hit
    builders = {str_const(k): k.lineno for k in reg_node.keys
                if str_const(k) is not None}
    defined = any(
        isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name == "_note_dispatch"
        for mod in project.modules for n in ast.walk(mod.tree)
    )
    if not defined:
        return []
    findings = []
    dispatched: set = set()
    for mod in project.modules:
        for _qual, fn in _functions(mod.tree):
            for call in _own_nodes(fn):
                if not (isinstance(call, ast.Call) and call.args):
                    continue
                f = call.func
                name = (f.attr if isinstance(f, ast.Attribute)
                        else f.id if isinstance(f, ast.Name) else "")
                if name != "_note_dispatch":
                    continue
                names = _dispatched_names(mod.tree, fn, call.args[0])
                for kernel in sorted(names or ()):
                    dispatched.add(kernel)
                    if kernel not in builders:
                        findings.append(Finding(
                            check=CHECK, path=mod.rel, line=call.lineno,
                            symbol=f"{kernel}:unwarmed",
                            message=(
                                f"kernel `{kernel}` is dispatched but has "
                                f"no `_WARM_BUILDERS` entry — warmup "
                                f"cannot prepare it"
                            ),
                        ))
    for key, line in sorted(builders.items()):
        if key not in dispatched:
            findings.append(Finding(
                check=CHECK, path=reg_mod.rel, line=line or reg_line,
                symbol=f"{key}:undispatched",
                message=(
                    f"`_WARM_BUILDERS` warms `{key}` but no "
                    f"`_note_dispatch` call dispatches it — a stale entry"
                ),
            ))
    return findings


# -- e. no host sync inside a launching wrapper ----------------------------


def _host_sync_findings(project: Project) -> list[Finding]:
    findings = []
    for mod in project.modules:
        for qual, fn in _functions(mod.tree):
            if not _calls_launch(fn):
                continue
            for node in _own_nodes(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                f = node.func
                if f.attr in _SYNCS:
                    bad = f".{f.attr}()"
                elif f.attr == "synchronize" and ast.unparse(
                    f.value
                ).endswith("cuda"):
                    bad = "torch.cuda.synchronize()"
                else:
                    continue
                findings.append(Finding(
                    check=CHECK, path=mod.rel, line=node.lineno,
                    symbol=f"{qual}:host-sync",
                    message=(
                        f"host sync `{bad}` inside the launching wrapper "
                        f"`{qual}` — it stalls the host on the card"
                    ),
                ))
    return findings


def run(project: Project) -> list[Finding]:
    return (
        _import_time_findings(project)
        + _wrapper_findings(project)
        + _fallback_findings(project)
        + _warm_findings(project)
        + _host_sync_findings(project)
    )
