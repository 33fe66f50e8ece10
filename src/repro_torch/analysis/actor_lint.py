"""Actor-concurrency analyzer (rule family ACT5xx).

AST pass over ``Actor`` subclasses.  The actor runtime serializes all
state access through the mailbox thread — the analyzer flags code that
breaks that model: actor state mutated from a side thread, locks held
inside an actor (a smell that state already leaks across threads),
synchronous ``call()`` a mailbox thread can block on forever,
half-implemented checkpoint/restore pairs that silently corrupt
recovery (ACT505), checkpoint keys that never round-trip through
``restore_state`` (ACT507 — saved-but-unread state silently vanishes on
durable resume), and (ACT506, data-plane modules only) actor ``call()``
sites that bypass the RetryPolicy, where one transient fault crashes
the caller.
"""
from __future__ import annotations

import ast
import inspect
import os
from typing import Iterable, Optional, Union

from repro_torch.analysis.findings import Report, Severity, make_report

# attribute names that conventionally hold an actor's own handle —
# call()ing through one from inside the actor self-deadlocks (the
# mailbox thread waits on a future only the mailbox thread can resolve)
_SELF_HANDLE_NAMES = {"self_handle", "own_handle", "my_handle",
                      "handle_to_self"}
_THREAD_FACTORIES = {"Thread", "Timer"}
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}


def _is_actor_class(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        if isinstance(base, ast.Name) and base.id.endswith("Actor"):
            return True
        if isinstance(base, ast.Attribute) and base.attr.endswith("Actor"):
            return True
    return False


def _self_attr_writes(fn: Union[ast.FunctionDef, ast.Lambda]) -> list:
    """Statements inside ``fn`` that assign/mutate ``self.<attr>``."""
    out = []
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out.append((t.attr, node.lineno))
    return out


def _callable_name(func: ast.AST) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _thread_target(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "target":
            return kw.value
    if call.args:
        return call.args[0]
    return None


def _returned_dict_keys(fn: ast.FunctionDef) -> set[str]:
    """Constant string keys of every dict literal ``fn`` returns."""
    keys: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
    return keys


def _state_keys_read(fn: ast.FunctionDef, param: str) -> Optional[set[str]]:
    """Keys ``fn`` reads off its ``param`` dict via ``param["k"]`` /
    ``param.get("k")``.  Returns None when ``param`` is also consumed
    generically (iterated, passed on, ``.items()``/``.update`` style) —
    then every key is potentially read and nothing can be proven."""
    read: set[str] = set()
    opaque_parents: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == param:
            opaque_parents.add(id(node.value))
            if isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                read.add(node.slice.value)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == param \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            opaque_parents.add(id(node.func.value))
            read.add(node.args[0].value)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == param \
                and isinstance(node.ctx, ast.Load) \
                and id(node) not in opaque_parents:
            return None   # whole-dict use: cannot prove a key unread
    return read


def _expr_mentions_self_name(node: ast.AST) -> bool:
    """True for expressions like ``self.runtime.get(self.name)``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "name" \
                and isinstance(sub.value, ast.Name) \
                and sub.value.id == "self":
            return True
    return False


class _ActorClassLinter:
    def __init__(self, cls: ast.ClassDef, where: str, rep: Report):
        self.cls = cls
        self.where = where
        self.rep = rep
        self.methods = {n.name: n for n in cls.body
                        if isinstance(n, ast.FunctionDef)}

    def run(self):
        self._check_ckpt_pair()
        self._check_ckpt_roundtrip()
        for m in self.methods.values():
            self._check_method(m)

    # ACT505 ------------------------------------------------------------
    def _check_ckpt_pair(self):
        has_ckpt = "checkpoint_state" in self.methods
        has_restore = "restore_state" in self.methods
        if has_ckpt != has_restore:
            got = "checkpoint_state" if has_ckpt else "restore_state"
            missing = "restore_state" if has_ckpt else "checkpoint_state"
            self.rep.add(
                "ACT505", Severity.ERROR,
                f"actor {self.cls.name!r} defines {got}() without "
                f"{missing}()", f"{self.where}:{self.cls.lineno}",
                "the CheckpointStore saves what checkpoint_state returns "
                "and recovery feeds it to restore_state; implementing "
                "one side silently breaks the fault-tolerance path")

    # ACT507 ------------------------------------------------------------
    def _check_ckpt_roundtrip(self):
        """checkpoint_state()'s persisted keys must round-trip through
        restore_state(): a key that is saved but never read back silently
        vanishes on recovery — the durable-manifest path then restores an
        actor that LOOKS healthy but lost state."""
        ck = self.methods.get("checkpoint_state")
        rs = self.methods.get("restore_state")
        if ck is None or rs is None:
            return   # the missing half is ACT505's finding
        saved = _returned_dict_keys(ck)
        if not saved:
            return   # non-literal payload: nothing provable statically
        params = [a.arg for a in rs.args.args if a.arg != "self"]
        if not params:
            return
        read = _state_keys_read(rs, params[0])
        if read is None:
            return   # whole-dict consumption (e.g. update/iteration)
        missing = sorted(saved - read)
        if missing:
            self.rep.add(
                "ACT507", Severity.ERROR,
                f"actor {self.cls.name!r}: restore_state() never reads "
                f"key(s) {missing} persisted by checkpoint_state()",
                f"{self.where}:{rs.lineno}",
                "every persisted key must be consumed on restore (or "
                "dropped from the checkpoint) — unread keys are state "
                "that silently fails to survive recovery")

    def _check_method(self, m: ast.FunctionDef):
        for node in ast.walk(m):
            if not isinstance(node, ast.Call):
                continue
            name = _callable_name(node.func)

            # ACT501 / ACT502 — threads and locks inside an actor
            lock_like = name in _LOCK_FACTORIES and (
                isinstance(node.func, ast.Name)
                or (isinstance(node.func, ast.Attribute)
                    and _callable_name(node.func.value) == "threading"))
            if name in _THREAD_FACTORIES:
                self._check_thread(node, m)
            elif lock_like:
                self.rep.add(
                    "ACT502", Severity.WARNING,
                    f"actor {self.cls.name!r} creates a threading."
                    f"{name} in {m.name}() (line {node.lineno})",
                    f"{self.where}:{node.lineno}",
                    "the mailbox thread already serializes actor state; "
                    "a lock means state is shared with another thread — "
                    "route that access through call()/cast() instead")

            # ACT503 / ACT504 — blocking call() from the mailbox thread
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "call":
                self._check_call(node, m)

    # ACT501 ------------------------------------------------------------
    def _check_thread(self, call: ast.Call, m: ast.FunctionDef):
        target = _thread_target(call)
        fns: list = []
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self" \
                and target.attr in self.methods:
            fns.append(self.methods[target.attr])
        elif isinstance(target, ast.Name):
            for sub in ast.walk(m):
                if isinstance(sub, ast.FunctionDef) \
                        and sub.name == target.id:
                    fns.append(sub)
        elif isinstance(target, ast.Lambda):
            fns.append(target)
        writes = [w for fn in fns for w in _self_attr_writes(fn)]
        if writes:
            attr, line = writes[0]
            self.rep.add(
                "ACT501", Severity.ERROR,
                f"actor {self.cls.name!r} spawns a thread in {m.name}() "
                f"whose target mutates self.{attr} (line {line}) off "
                "the mailbox thread", f"{self.where}:{call.lineno}",
                "actor state is only safe on the mailbox thread; have "
                "the side thread cast() a message back instead of "
                "writing state directly")
        else:
            self.rep.add(
                "ACT501", Severity.INFO,
                f"actor {self.cls.name!r} spawns a thread in {m.name}() "
                f"(line {call.lineno}); verify its target never touches "
                "actor state", f"{self.where}:{call.lineno}", "")

    # ACT503 / ACT504 ----------------------------------------------------
    def _check_call(self, call: ast.Call, m: ast.FunctionDef):
        recv = call.func.value  # type: ignore[union-attr]
        self_handle = (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and recv.attr in _SELF_HANDLE_NAMES)
        via_registry = isinstance(recv, ast.Call) \
            and _callable_name(recv.func) == "get" \
            and any(_expr_mentions_self_name(a) for a in recv.args)
        if self_handle or via_registry:
            self.rep.add(
                "ACT503", Severity.ERROR,
                f"actor {self.cls.name!r} issues a synchronous call() on "
                f"its own handle in {m.name}() (line {call.lineno})",
                f"{self.where}:{call.lineno}",
                "the mailbox thread blocks on a future that only the "
                "mailbox thread can complete — guaranteed self-deadlock;"
                " use cast() or invoke the method directly")
        for kw in call.keywords:
            if kw.arg == "timeout" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is None:
                self.rep.add(
                    "ACT504", Severity.ERROR,
                    f"actor {self.cls.name!r} blocks on call(timeout="
                    f"None) in {m.name}() (line {call.lineno})",
                    f"{self.where}:{call.lineno}",
                    "an unbounded call() inside an actor method can "
                    "wedge the mailbox forever if the peer dies; pass a "
                    "finite timeout")


class _CallRetryLinter(ast.NodeVisitor):
    """ACT506 — data-plane call() sites must not bypass RetryPolicy.

    Flags ``<handle>.call("method", ...)`` outside any ``try`` and
    without a ``retry=`` keyword in files under ``core/``.  There, one
    transient fault (actor restarting, mailbox timeout) propagates
    straight into the caller — the planner or supervisor — and takes the
    data plane down with it.  Only the ``except`` path of a ``try``
    counts as protection; ``orelse``/``finally`` run unguarded.
    """

    def __init__(self, where: str, rep: Report):
        self.where = where
        self.rep = rep
        self._try_depth = 0

    def visit_Try(self, node: ast.Try):
        self._try_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self._try_depth -= 1
        for part in (node.handlers, node.orelse, node.finalbody):
            for stmt in part:
                self.visit(stmt)

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "call"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            return
        if self._try_depth > 0 \
                or any(kw.arg == "retry" for kw in node.keywords):
            return
        method = node.args[0].value
        self.rep.add(
            "ACT506", Severity.WARNING,
            f"bare actor call({method!r}) at line {node.lineno} "
            "bypasses RetryPolicy and is not inside try",
            f"{self.where}:{node.lineno}",
            "pass retry=<RetryPolicy> (or wrap in try) so a transient "
            "actor fault degrades the step instead of crashing the "
            "caller")


def _is_data_plane_file(filename: str) -> bool:
    """ACT506 scope: files under a core/ directory, except the actor
    runtime itself (actors.py implements the retry mechanism)."""
    parts = filename.replace(os.sep, "/").split("/")
    return "core" in parts[:-1] and parts[-1] != "actors.py"


def lint_actor_source(source: str, filename: str = "<string>",
                      report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        rep.add("ACT500", Severity.ERROR,
                f"cannot parse {filename}: {e.msg} (line {e.lineno})",
                filename, "")
        return rep
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and _is_actor_class(node):
            _ActorClassLinter(node, filename, rep).run()
    if _is_data_plane_file(filename):
        _CallRetryLinter(filename, rep).visit(tree)
    return rep


def lint_actor_file(path: str, report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    with open(path, encoding="utf-8") as f:
        return lint_actor_source(f.read(), path, rep)


def lint_actor_paths(paths: Iterable[str],
                     report: Optional[Report] = None) -> Report:
    """Lint every .py file under the given files/directories."""
    rep = make_report(report)
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        lint_actor_file(os.path.join(root, fn), rep)
        elif p.endswith(".py"):
            lint_actor_file(p, rep)
    return rep


def lint_actor_class(cls: type, report: Optional[Report] = None) -> Report:
    """Lint a live Actor subclass via its source (tests, REPL)."""
    rep = make_report(report)
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):
        return rep
    import textwrap
    return lint_actor_source(textwrap.dedent(src),
                             getattr(cls, "__module__", "<class>"), rep)
