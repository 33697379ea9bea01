"""Shared model for the port's static analyzer: project loader,
findings, inline suppressions, and the literal/docs helpers every checker
uses.

The loader is convention-driven, not path-hardcoded: checkers locate
their cross-artifact anchors (``EVENT_SCHEMA``, ``SITES``,
``JOB_REFUSED_FLAGS``, the warm-start ``_WARM_BUILDERS`` table, the docs
event table) by scanning module-level assignments and ``docs/*.md`` under
the project root, so the same checkers run over the real tree and over
miniature fixture packages.  A checker whose anchors are absent reports
nothing rather than failing.

The walk is the port's own: at the root it prunes the JAX package
``specpride_tpu/`` and the JAX-era ``bench.py`` (``PRUNE_ROOT_FILES``).
The call graph resolves an attribute call only through a method name that
one project function defines, and the JAX package repeats almost every
method name of the port, so a walk that took it in would lose the port's
lanes.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

# directories never scanned for project code (fixture trees follow the
# same conventions, so the one exclusion list serves both).  These are
# pruned ONLY at the project root: a package may legitimately own a
# `data/` or `scripts/` SUBPACKAGE (specpride_tpu/data holds the packed
# layouts), and excluding it at depth would silently blind every
# checker to it.
EXCLUDE_ROOT_DIRS = frozenset({
    "tests", "docs", "native", "notebooks", "scripts", "build", "dist",
    "data", "specpride_tpu",
})

# root-level sources of the JAX era, pruned like the JAX package: they
# import it
PRUNE_ROOT_FILES = frozenset({"bench.py"})

# pruned at any depth: never project code (as is every dot-directory)
EXCLUDE_ANY_DIRS = frozenset({"__pycache__"})

# inline suppression: `# lint: ok[check-id] reason` (comma list allowed)
# on the finding's line.  The reason is mandatory by convention — the
# comment IS the justification the baseline file would otherwise carry.
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ok\[([a-z0-9_,\- ]+)\]")


@dataclasses.dataclass
class Finding:
    """One checker verdict, anchored for stable baseline matching.

    ``symbol`` is the durable anchor (an attribute qualname, a flag, an
    event name, ...) — fingerprints deliberately exclude the line
    number so unrelated edits above a legacy finding don't churn the
    baseline."""

    check: str
    path: str  # project-root-relative, posix separators
    line: int
    symbol: str
    message: str

    @property
    def fingerprint(self) -> tuple[str, str, str]:
        return (self.check, self.path, self.symbol)

    def to_json(self) -> dict:
        return {
            "check": self.check,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
        }

    @classmethod
    def from_json(cls, rec: dict) -> "Finding":
        return cls(
            check=str(rec["check"]), path=str(rec["path"]),
            line=int(rec.get("line", 0)), symbol=str(rec["symbol"]),
            message=str(rec.get("message", "")),
        )

    def sort_key(self) -> tuple:
        return (self.check, self.path, self.line, self.symbol)


class Module:
    """One parsed project source file."""

    def __init__(self, root: str, path: str):
        self.path = path
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        # dotted name mirrors the import system close enough for the
        # alias resolution the checkers do (packages drop __init__)
        name = self.rel[:-3].replace("/", ".")
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        self.name = name
        with open(path, encoding="utf-8") as fh:
            self.source = fh.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=path)
        self._suppressed: dict[int, set] | None = None

    def suppressed_at(self, line: int) -> set:
        """Check ids suppressed on ``line`` by an inline comment."""
        if self._suppressed is None:
            table: dict[int, set] = {}
            for i, text in enumerate(self.lines, 1):
                m = _SUPPRESS_RE.search(text)
                if m:
                    table[i] = {
                        tok.strip() for tok in m.group(1).split(",")
                        if tok.strip()
                    }
            self._suppressed = table
        return self._suppressed.get(line, set())


class Project:
    """The analyzed tree: parsed modules plus the docs files the
    cross-artifact checkers diff code against."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.modules: list[Module] = []
        self.errors: list[str] = []
        for path in sorted(self._iter_py(self.root)):
            try:
                self.modules.append(Module(self.root, path))
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                rel = os.path.relpath(path, self.root)
                self.errors.append(f"{rel}: unparseable ({e})")
        self._docs: list[tuple[str, str]] | None = None

    @staticmethod
    def _iter_py(root: str):
        for dirpath, dirnames, filenames in os.walk(root):
            at_root = os.path.samefile(dirpath, root)
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in EXCLUDE_ANY_DIRS
                and not d.startswith(".")
                and not (at_root and d in EXCLUDE_ROOT_DIRS)
            )
            for fn in filenames:
                if fn.endswith(".py") and not fn.startswith("__graft") and (
                    not (at_root and fn in PRUNE_ROOT_FILES)
                ):
                    yield os.path.join(dirpath, fn)

    # -- docs -----------------------------------------------------------

    @property
    def docs(self) -> list[tuple[str, str]]:
        """``(relpath, text)`` for every markdown file lint diffs
        against: ``docs/*.md`` plus the top-level ``README.md``."""
        if self._docs is None:
            out = []
            docs_dir = os.path.join(self.root, "docs")
            if os.path.isdir(docs_dir):
                for fn in sorted(os.listdir(docs_dir)):
                    if fn.endswith(".md"):
                        p = os.path.join(docs_dir, fn)
                        with open(p, encoding="utf-8") as fh:
                            out.append((f"docs/{fn}", fh.read()))
            readme = os.path.join(self.root, "README.md")
            if os.path.exists(readme):
                with open(readme, encoding="utf-8") as fh:
                    out.append(("README.md", fh.read()))
            self._docs = out
        return self._docs

    def doc(self, rel: str) -> str | None:
        for name, text in self.docs:
            if name == rel:
                return text
        return None

    # -- anchor discovery ----------------------------------------------

    def module_constants(self, name: str):
        """Every module-level ``NAME = <expr>`` assignment across the
        project, as ``(module, value_node, lineno)``."""
        for mod in self.modules:
            for node in mod.tree.body:
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name) and tgt.id == name:
                            yield mod, node.value, node.lineno
                elif isinstance(node, ast.AnnAssign) and node.value:
                    tgt = node.target
                    if isinstance(tgt, ast.Name) and tgt.id == name:
                        yield mod, node.value, node.lineno

    def one_constant(self, name: str):
        """The unique module-level assignment of ``name``, or None."""
        hits = list(self.module_constants(name))
        return hits[0] if len(hits) == 1 else None


# -- AST literal helpers -------------------------------------------------


def str_const(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_seq(node) -> list[str] | None:
    """String elements of a literal tuple/list/set; None if the node is
    not a purely-literal string sequence.  ``A + B`` concatenations of
    such sequences (the ``SITES = EXECUTOR_SITES + (...)``
    idiom) resolve when the caller passes an ``env`` of known names."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for elt in node.elts:
            s = str_const(elt)
            if s is None:
                return None
            out.append(s)
        return out
    return None


def str_seq_resolved(node, env: dict) -> list[str] | None:
    """Like :func:`str_seq` but resolves Name references and binary
    ``+`` through ``env`` (name -> list of strings)."""
    direct = str_seq(node)
    if direct is not None:
        return direct
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = str_seq_resolved(node.left, env)
        right = str_seq_resolved(node.right, env)
        if left is not None and right is not None:
            return left + right
    if isinstance(node, ast.Call):
        # frozenset({...}) / tuple([...]) / sorted((...)) wrappers
        fn = node.func
        fname = fn.id if isinstance(fn, ast.Name) else getattr(
            fn, "attr", ""
        )
        if fname in ("frozenset", "tuple", "list", "set", "sorted") and (
            len(node.args) == 1
        ):
            return str_seq_resolved(node.args[0], env)
    return None


def dict_of_str_sets(node, env: dict | None = None) -> dict | None:
    """Parse ``{"k": frozenset({"a", ...}), ...}`` (the EVENT_SCHEMA
    shape) into ``{k: set_of_strings}``; None when the node is not a
    dict literal.  Unresolvable values map to None (caller skips)."""
    if not isinstance(node, ast.Dict):
        return None
    env = env or {}
    out: dict = {}
    for k, v in zip(node.keys, node.values):
        key = str_const(k)
        if key is None:
            continue
        seq = str_seq_resolved(v, env)
        out[key] = set(seq) if seq is not None else None
    return out


def walk_no_docstrings(tree):
    """``ast.walk`` skipping docstring Constant nodes — the metrics
    universe sweep must not mistake a name quoted in prose for a
    registration."""
    doc_nodes = set()
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef,
             ast.AsyncFunctionDef),
        ):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                body[0].value, ast.Constant
            ) and isinstance(body[0].value.value, str):
                doc_nodes.add(id(body[0].value))
    for node in ast.walk(tree):
        if id(node) not in doc_nodes:
            yield node


def kwarg(node: ast.Call, name: str):
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def has_starstar(node: ast.Call) -> bool:
    return any(kw.arg is None for kw in node.keywords)


def flag_to_dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


# -- docs markdown helpers ----------------------------------------------

_CODE_SPAN_RE = re.compile(r"`([^`]+)`")


def parse_event_table(text: str) -> dict[str, dict]:
    """The docs event table: the markdown table whose header row's
    first cell is ``event``, rows ``| `name` | payload | meaning |``.

    Returns ``{event: {"required": set, "mentioned": set, "line": n}}``.
    Required fields are the backticked names in the payload cell BEFORE
    any ``plus`` marker — the documented convention for optional/
    additive fields; ``mentioned`` is every backticked name in the cell
    (the journal-schema checker holds the v4 trace-envelope fields to
    mentioned-at-least, required-or-optional)."""
    out: dict[str, dict] = {}
    in_table = False
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.lstrip().startswith("|"):
            in_table = False
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if not cells:
            continue
        if cells[0] == "event":
            in_table = True
            continue
        if not in_table or len(cells) < 2:
            continue
        if set(cells[0]) <= {"-", ":"}:  # the |---|---| separator row
            continue
        m = _CODE_SPAN_RE.fullmatch(cells[0])
        if not m:
            continue
        event = m.group(1)
        if not re.fullmatch(r"[a-z][a-z0-9_]*", event):
            continue
        payload = cells[1]
        # optional/additive fields are documented after a "(plus ...)"
        required_part = re.split(r"\(?\bplus\b", payload, maxsplit=1)[0]
        required = set(_CODE_SPAN_RE.findall(required_part))
        out[event] = {
            "required": required,
            "mentioned": set(_CODE_SPAN_RE.findall(payload)),
            "line": lineno,
        }
    return out
