"""The port's AST lint rules (the twin of ``src/repro/analysis/rules.py``,
DESIGN.md §11).

The reference's seven rules under the same names. Three carry over as
they are, because the port keeps the constructs they read (``Request``
and the ``i*`` ops, ``tr.span``, ``with comm.stream(...)``,
``finish``/``free``/``start``); four key on JAX constructs in the
reference and are retargeted to the port's PyTorch conventions:

* ``scatter-drop``   — an in-place tensor write (``index_put_``,
  ``index_copy_``, ``index_add_``, ``scatter_``, ``scatter_add_``,
  ``index_fill_``, ``masked_scatter_``, or ``X[idx] = v`` into a device
  pool, cache or state leaf) whose index names a slot, row, table, block
  or parked position directly. PyTorch has no drop mode: a ``-1``
  sentinel wraps to the last block or row, on the CPU and on CUDA alike,
  and an index past the end raises or trips a device assert. The port's
  convention filters the index first (``_write_targets``,
  ``_row_indices``) or aims it at the slot cache's scratch column.
* ``state-thread``   — the same write forms into a carried-state leaf
  (``conv``/``ssm``/``cross_k``/``cross_v`` — DESIGN.md §13) with an
  index that is neither constant nor filtered, whatever it is named.
* ``donated-use``    — the port has no buffer donation: its steps write
  their arguments in place. A name bound (without ``.clone()`` or a
  copy) to a tensor of an in-place step's argument before the call and
  read after it holds the new value, not the old one.
* ``request-leak``   — every issued ``Request`` must reach
  ``wait``/``test``/``waitall`` on every path (including the exception
  path of a try/finally).
* ``span-leak``      — a manually bound tracer span must reach ``end()``.
* ``stream-order``   — no blocking collective inside a
  ``with comm.stream(...)`` region; no comm op on a comm after
  ``finish()``/``free()`` without a revalidating ``start()``.
* ``host-sync``      — no host-synchronizing call (``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.nonzero()``,
  ``torch.cuda.synchronize``, ``bool``/``int``/``float`` of a tensor
  argument) inside the model's step bodies: the functions the engine
  calls once per micro-step and the module-local helpers they call.

The rules are deliberately heuristic (name patterns, function-local
dataflow), tuned to produce zero false positives on the port's tree.
Suppress a deliberate exception with ``# lint: ok[rule-name]`` on the
flagged line, with its reason.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class Finding:
    file: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: [{self.rule}] {self.message}"


def _chain(node: ast.AST) -> Optional[str]:
    """Dotted name for a Name/Attribute chain ('self.kv.buffers'), else
    None for anything with a non-trivial base."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _walk_skipping_defs(node: ast.AST):
    """Yield descendant nodes without descending into nested function or
    class definitions (their bodies run in another scope/time)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


def _functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class Rule:
    name = ""
    summary = ""

    def check(self, tree: ast.Module, filename: str) -> List[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# in-place index writes (shared by scatter-drop and state-thread)
# ---------------------------------------------------------------------------

#: the in-place tensor writes through an index: method -> (position,
#: keyword) of its index argument
_WRITE_METHODS: Dict[str, Tuple[int, str]] = {
    "index_put_": (0, "indices"), "index_copy_": (1, "index"),
    "index_add_": (1, "index"), "scatter_": (1, "index"),
    "scatter_add_": (1, "index"), "index_fill_": (1, "index"),
    "masked_scatter_": (0, "mask"),
}

#: calls whose results index nothing out of range: the filter helpers
#: (only in-range rows and valid table entries, ``models/transformer.py``)
#: and ``arange`` (every row, as the slot cache's writes count them, with
#: padding aimed at its scratch column)
_FILTERS = frozenset({"_write_targets", "_row_indices", "arange"})

#: methods that keep an index's values (casts, views): the index is
#: still the receiver's
_SAME_VALUES = frozenset({
    "long", "int", "to", "view", "reshape", "flatten", "contiguous",
    "cuda", "type", "unsqueeze", "squeeze", "expand", "clone", "detach",
})


@dataclass
class _Write:
    node: ast.AST            # the call or the assignment
    target: ast.AST          # the tensor written
    index: ast.AST           # its index expression
    form: str                # the method name, or "[...] ="


def _index_writes(tree: ast.AST) -> Iterator[_Write]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _WRITE_METHODS:
            pos, kw = _WRITE_METHODS[node.func.attr]
            index = next((k.value for k in node.keywords if k.arg == kw),
                         node.args[pos] if pos < len(node.args) else None)
            if index is not None:
                yield _Write(node, node.func.value, index, node.func.attr)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript):
                    yield _Write(node, t.value, t.slice, "[...] =")


def _direct_names(expr: ast.AST) -> Set[str]:
    """Identifiers an index expression names directly: names, attribute
    names and subscripted names, through casts and views, but not
    through any other call (a call computes a new index)."""
    out: Set[str] = set()
    stack = [expr]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
            stack.append(n.value)
        elif isinstance(n, ast.Call):
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _SAME_VALUES:
                stack.append(n.func.value)
        elif isinstance(n, (ast.Lambda, ast.Constant)):
            continue
        else:
            stack.extend(ast.iter_child_nodes(n))
    return out


def _filtered_names(fn: ast.AST) -> Set[str]:
    """Names bound in ``fn`` (not in nested defs) from a call of
    :data:`_FILTERS` (``sel_b, sel_j, flat = _write_targets(...)``)."""
    out: Set[str] = set()
    for node in _walk_skipping_defs(fn):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        while isinstance(value, ast.Subscript) or (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr in _SAME_VALUES):
            value = (value.value if isinstance(value, ast.Subscript)
                     else value.func.value)
        if isinstance(value, ast.Call):
            fc = _chain(value.func)
            if fc is not None and fc.split(".")[-1] in _FILTERS:
                for t in node.targets:
                    out.update(n.id for n in ast.walk(t)
                               if isinstance(n, ast.Name))
    return out


def _scopes(tree: ast.Module) -> Dict[int, Set[str]]:
    """id(write node) -> the filtered names of its innermost function."""
    out: Dict[int, Set[str]] = {}
    for fn in [tree, *_functions(tree)]:
        filtered = _filtered_names(fn)
        for node in _walk_skipping_defs(fn):
            out[id(node)] = filtered
    return out


def _target_names(expr) -> Set[str]:
    """Identifiers mentioned in the expression written into: variable
    names, attribute names, and string keys of dict-style cache access
    (``cache["conv"]``)."""
    names: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            names.add(n.value)
    return names


# ---------------------------------------------------------------------------
# scatter-drop
# ---------------------------------------------------------------------------

class ScatterDropRule(Rule):
    name = "scatter-drop"
    summary = ("in-place index writes by a raw slot/row/table/block index "
               "must filter it first (no drop mode in PyTorch)")

    #: index identifiers that mark a write as slot-pool / block-table /
    #: parked-position addressing: the indices that carry out-of-range
    #: sentinels by design (padding rows, -1 table entries, parked
    #: positions)
    _PAT = re.compile(r"slot|row|table|block|park", re.IGNORECASE)
    #: write targets of a subscript assignment that are device pools,
    #: caches or state leaves (host lists and numpy tables are not)
    _DEVICE = re.compile(r"pool|cache|buffers|leaves|^(k|v|pos|conv|ssm|"
                         r"cross_k|cross_v)$")

    def check(self, tree, filename):
        out: List[Finding] = []
        scopes = _scopes(tree)
        for w in _index_writes(tree):
            if w.form == "[...] =" and not any(
                    self._DEVICE.search(n) for n in _target_names(w.target)):
                continue
            filtered = scopes.get(id(w.node), set())
            hits = sorted(n for n in _direct_names(w.index) - filtered
                          if self._PAT.search(n))
            if not hits:
                continue
            out.append(Finding(
                filename, w.node.lineno, w.node.col_offset, self.name,
                f"in-place {w.form} indexed directly by {', '.join(hits)}: "
                "slot/block-table indices carry out-of-range sentinels by "
                "design (padding rows, -1 table entries, parked "
                "positions) and PyTorch has no drop mode — a -1 wraps to "
                "the last block or row, past the end raises or trips a "
                "device assert; filter the index first (_write_targets, "
                "_row_indices) or aim it at a scratch column"))
        return out


# ---------------------------------------------------------------------------
# state-thread
# ---------------------------------------------------------------------------

class StateThreadRule(Rule):
    name = "state-thread"
    summary = ("in-place index writes into carried-state leaves (conv/ssm/"
               "cross_k/cross_v) must use a filtered index")

    #: names that mark the write TARGET as a carried-state leaf
    #: (DESIGN.md §13): SSM/hybrid recurrent state and enc-dec cross
    #: K/V. Complements scatter-drop, which keys on the *index* name — a
    #: state write through an innocuously named index (``idx``) still
    #: addresses per-request rows whose padding sentinel is out of range
    #: by design, so the target name is the invariant here.
    _STATE = re.compile(r"\bconv\b|\bssm\b|cross_k|cross_v", re.IGNORECASE)

    def check(self, tree, filename):
        out: List[Finding] = []
        scopes = _scopes(tree)
        for w in _index_writes(tree):
            hits = sorted(n for n in _target_names(w.target)
                          if self._STATE.search(n))
            if not hits:
                continue
            # a fully-constant index is a fixed address, not a
            # per-request write — out of scope
            if all(isinstance(n, ast.Constant) for n in ast.walk(w.index)
                   if isinstance(n, (ast.Name, ast.Constant))):
                continue
            if not _direct_names(w.index) - scopes.get(id(w.node), set()):
                continue
            out.append(Finding(
                filename, w.node.lineno, w.node.col_offset, self.name,
                f"in-place {w.form} into carried-state leaf "
                f"({', '.join(hits)}) through an unfiltered index: state "
                "rows are per-request and their padding/parked indices are "
                "out of range by design — PyTorch wraps a -1 onto a live "
                "request's state; write through _row_indices' dst/src"))
        return out


# ---------------------------------------------------------------------------
# donated-use
# ---------------------------------------------------------------------------

#: the port's in-place steps (the counterpart of the reference's donating
#: jits, ``models/transformer.py``, ``optim/adamw.py``,
#: ``train/explicit.py``): the model's steps write the cache argument
#: (named ``cache``/``buffers``/``pool``) in place
_INPLACE_CACHE_STEPS = frozenset({
    "decode_step_paged", "prefill_chunk_paged", "verify_step_paged",
    "decode_step", "prefill_chunk", "encode_prechunk", "clone_paged_block",
})
_CACHE_ARG = re.compile(r"cache|buffers|pool")
#: in-place callees by the positions they write
_INPLACE_POSITIONS: Dict[str, Tuple[int, ...]] = {
    "adamw_update": (1, 2),          # (grads, state, params)
}
#: factories of in-place steps: ``step = make_train_step(...)`` makes
#: ``step(state, batch)`` write its state (AdamW in place; the explicit
#: trainer's step updates its optimizer shards in place)
_INPLACE_FACTORIES: Dict[str, Tuple[int, ...]] = {"make_train_step": (0,)}
#: methods that return a view of (or the same) tensor
_VIEWS = frozenset({
    "view", "view_as", "reshape", "flatten", "squeeze", "unsqueeze",
    "detach", "narrow", "select", "expand", "expand_as", "permute",
    "transpose", "t", "contiguous", "as_strided", "unflatten",
})


class DonatedUseRule(Rule):
    name = "donated-use"
    summary = ("a name aliasing part of an in-place step's argument must "
               "not be read after the step as if it held the old value")

    @staticmethod
    def _alias_root(expr: ast.AST) -> Optional[str]:
        """The argument chain a value expression is a part or a view of
        (``cache["k"][0]`` -> ``cache``, ``state.params`` -> ``state``),
        or None when it is no such part, or copies (``.clone()``)."""
        node, deeper = expr, False
        while True:
            if isinstance(node, ast.Subscript):
                node, deeper = node.value, True
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _VIEWS:
                node, deeper = node.func.value, True
            else:
                break
        c = _chain(node)
        if c is None or deeper:
            return c
        return c.rsplit(".", 1)[0] if "." in c else None

    @staticmethod
    def _factories(tree) -> Dict[str, Tuple[int, ...]]:
        out: Dict[str, Tuple[int, ...]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                fc = _chain(node.value.func)
                pos = _INPLACE_FACTORIES.get(
                    fc.split(".")[-1] if fc else "")
                if pos is None:
                    continue
                for t in node.targets:
                    c = _chain(t)
                    if c is not None:
                        out[c] = pos
        return out

    @staticmethod
    def _written(call: ast.Call, made: Dict[str, Tuple[int, ...]]
                 ) -> List[str]:
        """The argument chains an in-place call writes."""
        fc = _chain(call.func)
        if fc is None:
            return []
        last = fc.split(".")[-1]
        if last in _INPLACE_CACHE_STEPS:
            args = list(call.args) + [k.value for k in call.keywords]
            return [c for c in map(_chain, args)
                    if c is not None and _CACHE_ARG.search(
                        c.split(".")[-1])]
        pos = _INPLACE_POSITIONS.get(last) or made.get(fc)
        if not pos:
            return []
        return [c for p in pos if p < len(call.args)
                for c in [_chain(call.args[p])] if c is not None]

    def check(self, tree, filename):
        out: List[Finding] = []
        made = self._factories(tree)
        for fn in _functions(tree):
            out.extend(self._check_function(fn, made, filename))
        return out

    def _check_function(self, fn, made, filename) -> List[Finding]:
        aliases: List[Tuple[int, str, str]] = []   # (line, name, root)
        calls: List[Tuple[int, List[str]]] = []    # (end line, written)
        stores: Dict[str, List[int]] = {}
        loads: List[Tuple[int, str, ast.AST]] = []
        for node in _walk_skipping_defs(fn):
            if isinstance(node, ast.Assign):
                line = node.end_lineno or node.lineno
                for t in node.targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name):
                            stores.setdefault(leaf.id, []).append(line)
                if len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    root = self._alias_root(node.value)
                    if root is not None:
                        aliases.append((line, node.targets[0].id, root))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
                for leaf in ast.walk(node.target):
                    if isinstance(leaf, ast.Name):
                        stores.setdefault(leaf.id, []).append(
                            node.end_lineno or node.lineno)
            elif isinstance(node, ast.Call):
                written = self._written(node, made)
                if written:
                    calls.append((node.end_lineno or node.lineno, written))
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load):
                loads.append((node.lineno, node.id, node))
        out: List[Finding] = []
        calls.sort()
        loads.sort(key=lambda x: (x[0], x[2].col_offset))
        for a_line, name, root in aliases:
            hit = next((c for c, written in calls if c > a_line and any(
                root == w or root.startswith(w + ".") for w in written)),
                None)
            after = [s for s in stores.get(name, []) if s > a_line]
            rebound = min(after) if after else None
            if hit is None or (rebound is not None and rebound <= hit):
                continue
            load = next((x for x in loads if x[1] == name and x[0] > hit
                         and (rebound is None or x[0] < rebound)), None)
            if load is not None:
                out.append(Finding(
                    filename, load[0], load[2].col_offset, self.name,
                    f"`{name}` aliases part of `{root}` (bound at line "
                    f"{a_line}), which an in-place step wrote at line "
                    f"{hit}: it now holds the new value, not the old one "
                    "— bind a `.clone()` before the step if the old "
                    "value is meant"))
        return out


# ---------------------------------------------------------------------------
# request-leak
# ---------------------------------------------------------------------------

_ISSUE_OPS = frozenset({
    "isend", "irecv", "icollective", "iallreduce", "ireduce", "ibcast",
    "ibarrier", "iallgather", "ireduce_scatter",
})
_COMPLETE_OPS = frozenset({"wait", "test", "synchronize"})
_COMPLETE_FNS = frozenset({"waitall", "testall"})


class RequestLeakRule(Rule):
    name = "request-leak"
    summary = ("a Request from i*-ops must reach wait/test/waitall on "
               "every path")

    # hooks the span-leak rule overrides — the AST walk is identical,
    # only the issue/completion vocabulary and the wording differ
    _issue_attrs = _ISSUE_OPS
    _ctor: Optional[str] = "Request"
    _complete_attrs = _COMPLETE_OPS
    _complete_fns = _COMPLETE_FNS
    _noun = "Request"

    def _is_issue(self, call: ast.Call) -> bool:
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in self._issue_attrs:
            return True
        if self._ctor is None:
            return False
        c = _chain(call.func)
        return c is not None and c.split(".")[-1] == self._ctor

    def _msg_discard(self) -> str:
        return ("Request discarded at the call site: the operation "
                "is never completed — bind it and wait()/waitall() "
                "(or testall in a progress loop)")

    def _msg_leak(self, name: str) -> str:
        return (f"Request bound to `{name}` is never completed: no "
                "wait()/test()/waitall() reaches it in this "
                "function and it does not escape")

    def _msg_exception(self, name: str) -> str:
        return (f"Requests bound to `{name}` are issued inside a try "
                "body and only completed there: an exception mid-issue "
                "abandons every request already in flight — move the "
                "waitall/wait into the finally block")

    def check(self, tree, filename):
        out: List[Finding] = []
        for fn in _functions(tree):
            out.extend(self._check_function(fn, filename))
        return out

    def _check_function(self, fn, filename) -> List[Finding]:
        out: List[Finding] = []
        issues: Dict[str, List[ast.Call]] = {}   # binding -> issue calls
        escaped: Set[str] = set()
        completed: Dict[str, List[ast.AST]] = {}  # binding -> completions
        aliases: Dict[str, str] = {}              # loop var -> iterated list
        synchronized = False

        def bind_of(call: ast.Call, parents: Dict[int, ast.AST]
                    ) -> Optional[str]:
            """The name an issue call's result lands in; records escapes
            and discards along the way (None = handled elsewhere)."""
            p = parents.get(id(call))
            if isinstance(p, ast.Expr):
                out.append(Finding(
                    filename, call.lineno, call.col_offset, self.name,
                    self._msg_discard()))
                return None
            if isinstance(p, ast.Assign) and len(p.targets) == 1 \
                    and isinstance(p.targets[0], ast.Name):
                return p.targets[0].id
            if isinstance(p, ast.Call) and isinstance(p.func, ast.Attribute) \
                    and p.func.attr in ("append", "add", "insert") \
                    and isinstance(p.func.value, ast.Name):
                return p.func.value.id     # reqs.append(comm.isend(...))
            # returned / stored on self / passed to a helper: assume the
            # receiver owns completion
            return "<escaped>"

        parents: Dict[int, ast.AST] = {}
        for node in _walk_skipping_defs(fn):
            for child in ast.iter_child_nodes(node):
                parents.setdefault(id(child), node)
        for child in ast.iter_child_nodes(fn):
            parents.setdefault(id(child), fn)

        for node in _walk_skipping_defs(fn):
            if isinstance(node, ast.Call) and self._is_issue(node):
                b = bind_of(node, parents)
                if b and b != "<escaped>":
                    issues.setdefault(b, []).append(node)
            elif isinstance(node, ast.For) \
                    and isinstance(node.target, ast.Name) \
                    and isinstance(node.iter, ast.Name):
                aliases[node.target.id] = node.iter.id
            elif isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in self._complete_attrs:
                    if node.func.attr == "synchronize":
                        synchronized = True
                    base = node.func.value
                    if isinstance(base, ast.Name):
                        name = aliases.get(base.id, base.id)
                        completed.setdefault(name, []).append(node)
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in self._complete_fns:
                    for arg in node.args:
                        for n in ast.walk(arg):
                            if isinstance(n, ast.Name):
                                completed.setdefault(
                                    aliases.get(n.id, n.id), []
                                ).append(node)
            elif isinstance(node, (ast.Return, ast.Yield)) \
                    and node.value is not None:
                for n in ast.walk(node.value):
                    if isinstance(n, ast.Name):
                        escaped.add(n.id)
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        for n in ast.walk(node.value):
                            if isinstance(n, ast.Name):
                                escaped.add(n.id)

        # a binding passed as an argument to any other call escapes
        for node in _walk_skipping_defs(fn):
            if isinstance(node, ast.Call):
                if self._is_issue(node):
                    continue
                fc = _chain(node.func)
                is_completion = (
                    (isinstance(node.func, ast.Attribute)
                     and node.func.attr in self._complete_attrs)
                    or (fc is not None
                        and fc.split(".")[-1] in self._complete_fns))
                if is_completion:
                    continue
                for arg in node.args:
                    if isinstance(arg, ast.Name) and arg.id in issues:
                        escaped.add(arg.id)

        for name, calls in issues.items():
            if synchronized or name in escaped or name in completed:
                self._check_exception_path(
                    fn, name, calls, completed.get(name, []), filename, out)
                continue
            for call in calls:
                out.append(Finding(
                    filename, call.lineno, call.col_offset, self.name,
                    self._msg_leak(name)))
        return out

    @staticmethod
    def _span(stmts: Sequence[ast.AST]) -> Tuple[int, int]:
        return (stmts[0].lineno,
                stmts[-1].end_lineno or stmts[-1].lineno)

    def _check_exception_path(self, fn, name, calls, completions,
                              filename, out) -> None:
        """Issues inside a try body whose only completions are also in
        the try body, with a finally that never completes them, leak on
        the exception path — the transport bug class."""
        if not completions:
            return
        for node in _walk_skipping_defs(fn):
            if not (isinstance(node, ast.Try) and node.finalbody):
                continue
            lo, hi = self._span(node.body)
            flo, fhi = self._span(node.finalbody)
            inside = [c for c in calls if lo <= c.lineno <= hi]
            if not inside:
                continue
            safe = [c for c in completions
                    if not (lo <= c.lineno <= hi)]
            if safe:
                continue
            out.append(Finding(
                filename, inside[0].lineno, inside[0].col_offset,
                self.name, self._msg_exception(name)))


# ---------------------------------------------------------------------------
# span-leak
# ---------------------------------------------------------------------------

_SPAN_ISSUE_OPS = frozenset({"span", "begin_span"})
_SPAN_COMPLETE_OPS = frozenset({"end", "end_span"})


class SpanLeakRule(RequestLeakRule):
    """Same AST shape as request-leak, retargeted at the tracer's
    manual span API (DESIGN.md §15): a handle from ``tr.span(...)`` /
    ``tr.begin_span(...)`` bound to a local name must reach ``end()``
    on every path. Context-manager use (``with tr.span(...):``) and
    handles that escape (returned, stored on ``self``, passed on) are
    exception-safe or owned elsewhere and never flagged — exactly the
    request-leak escape semantics. A leaked span corrupts the tracer's
    thread-local nesting stack, mis-parenting every later span on that
    thread."""

    name = "span-leak"
    summary = ("a manually-bound tracer span must reach end() on every "
               "path (or be opened as a context manager)")

    _issue_attrs = _SPAN_ISSUE_OPS
    _ctor = None
    _complete_attrs = _SPAN_COMPLETE_OPS
    _complete_fns = frozenset()
    _noun = "Span"

    def _msg_discard(self) -> str:
        return ("Span discarded at the call site: it opens on the "
                "tracer's stack and is never ended — use "
                "`with tr.span(...):` or bind the handle and end() it")

    def _msg_leak(self, name: str) -> str:
        return (f"Span bound to `{name}` is never ended: no end() "
                "reaches it in this function and it does not escape — "
                "the tracer's nesting stack leaks")

    def _msg_exception(self, name: str) -> str:
        return (f"Spans bound to `{name}` are opened inside a try body "
                "and only ended there: an exception leaves them on the "
                "tracer's stack — move the end() into the finally "
                "block (or use `with tr.span(...):`)")


# ---------------------------------------------------------------------------
# stream-order
# ---------------------------------------------------------------------------

_BLOCKING_OPS = frozenset({
    "allreduce", "reduce", "bcast", "barrier", "allgather",
    "reduce_scatter", "alltoall", "send_recv",
})
_COMM_OPS = _BLOCKING_OPS | _ISSUE_OPS | frozenset({
    "split", "dup", "stream", "group", "run", "thread_comm",
    "process_comm", "set_attr", "get_attr",
})


class StreamOrderRule(Rule):
    name = "stream-order"
    summary = ("no blocking collective inside a stream region; no comm op "
               "after finish()/free() without start()")

    def check(self, tree, filename):
        out: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.With):
                self._check_stream_region(node, filename, out)
        for fn in _functions(tree):
            self._check_use_after_finish(fn, filename, out)
        return out

    @staticmethod
    def _is_stream_with(node: ast.With) -> bool:
        for item in node.items:
            e = item.context_expr
            if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                    and e.func.attr == "stream":
                return True
        return False

    def _check_stream_region(self, node: ast.With, filename, out) -> None:
        if not self._is_stream_with(node):
            return
        for stmt in node.body:
            for n in _walk_skipping_defs(stmt):
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _BLOCKING_OPS:
                    out.append(Finding(
                        filename, n.lineno, n.col_offset, self.name,
                        f"blocking `{n.func.attr}` inside a CommStream "
                        "region: the stream exists to overlap — use the "
                        f"nonblocking `i{n.func.attr}` and wait() after "
                        "the region (a blocking call here also bypasses "
                        "the stream's ordering token)"))
            if isinstance(stmt, ast.Call) \
                    and isinstance(stmt.func, ast.Attribute) \
                    and stmt.func.attr in _BLOCKING_OPS:
                out.append(Finding(
                    filename, stmt.lineno, stmt.col_offset, self.name,
                    f"blocking `{stmt.func.attr}` inside a CommStream "
                    "region"))

    def _check_use_after_finish(self, fn, filename, out) -> None:
        closed: Dict[str, int] = {}    # comm chain -> line of finish/free
        sites: List[Tuple[int, str, str, ast.Call]] = []
        for node in _walk_skipping_defs(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                base = _chain(node.func.value)
                if base is None:
                    continue
                sites.append((node.lineno, base, node.func.attr, node))
        sites.sort(key=lambda s: s[0])
        for line, base, op, node in sites:
            if op in ("finish", "free"):
                closed.setdefault(base, line)
            elif op == "start":
                closed.pop(base, None)
            elif op in _COMM_OPS and base in closed:
                out.append(Finding(
                    filename, line, node.col_offset, self.name,
                    f"`{base}.{op}` after `{base}.finish()`/`free()` at "
                    f"line {closed[base]}: the activation window is "
                    "closed and every derived object is dead — call "
                    "start() to open a new window first"))


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

#: the model's step bodies: the functions the engine calls once per
#: micro-step (``models/transformer.py``, ``models/encdec.py``, the SSM
#: steps of ``models/mamba.py``)
_STEP_BODIES = frozenset({
    "decode_step_paged", "prefill_chunk_paged", "verify_step_paged",
    "decode_step", "prefill_chunk", "ssm_decode_step", "ssm_apply_chunk",
})


class HostSyncRule(Rule):
    name = "host-sync"
    summary = ("no host-synchronizing call inside the model's step bodies "
               "or the module-local helpers they call")

    _SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero"})
    _SYNC_CHAINS = frozenset({"torch.cuda.synchronize", "torch.nonzero"})
    #: annotations of arguments that are host values, not tensors
    _HOST_TYPES = frozenset({"int", "float", "bool", "str"})

    @staticmethod
    def _region(tree) -> Dict[str, ast.AST]:
        """The step bodies defined at the module's top level and,
        transitively, the top-level functions they call by name."""
        defs = {n.name: n for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        todo = [n for n in defs if n in _STEP_BODIES]
        region: Dict[str, ast.AST] = {}
        while todo:
            name = todo.pop()
            if name in region:
                continue
            region[name] = defs[name]
            for node in ast.walk(defs[name]):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id in defs:
                    todo.append(node.func.id)
        return region

    def check(self, tree, filename):
        out: List[Finding] = []
        for fname, fn in sorted(self._region(tree).items()):
            args = fn.args.args + fn.args.posonlyargs + fn.args.kwonlyargs
            tensors = {a.arg for a in args if not (
                isinstance(a.annotation, ast.Name)
                and a.annotation.id in self._HOST_TYPES)}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._sync_call(node, tensors)
                if msg:
                    out.append(Finding(
                        filename, node.lineno, node.col_offset, self.name,
                        f"{msg} inside step body `{fname}`: forces a "
                        "device->host sync once per micro-step (the launch "
                        "queue drains, the card idles) — keep the value on "
                        "the device, or decide it on the host before the "
                        "step"))
        return out

    def _sync_call(self, node: ast.Call, tensors: Set[str]) -> Optional[str]:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in self._SYNC_ATTRS:
            return f"`.{node.func.attr}()`"
        fc = _chain(node.func)
        if fc in self._SYNC_CHAINS:
            return f"`{fc}`"
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("bool", "float", "int") and node.args \
                and isinstance(node.args[0], ast.Name) \
                and node.args[0].id in tensors:
            return f"`{node.func.id}()` of a tensor argument"
        return None


ALL_RULES: Tuple[Rule, ...] = (
    ScatterDropRule(),
    StateThreadRule(),
    DonatedUseRule(),
    RequestLeakRule(),
    SpanLeakRule(),
    StreamOrderRule(),
    HostSyncRule(),
)

RULES_BY_NAME: Dict[str, Rule] = {r.name: r for r in ALL_RULES}
