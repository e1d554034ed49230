"""Minimal dy2static AST conversion for tensor-conditioned control flow.

Reference parity: the dygraph_to_static AST transformer stack
(``fluid/dygraph/dygraph_to_static/ast_transformer.py:1``,
``ifelse_transformer.py``, ``loop_transformer.py``) — the reference rewrites
every ``if``/``while`` whose predicate is a Tensor into
``cond``/``while_loop`` program ops before building the ProgramDesc.

The port keeps its own copy of the reference's pass (counterpart of
``paddle_tpu/jit/dy2static.py``).  ``to_static`` traces through
``torch.export``, where a data-dependent Python ``if``/``while`` raises a
guard-on-data-dependent error at trace time.  This module provides the two
halves of the reference's story:

1. :func:`convert` — an AST pass rewriting the COMMON control-flow shapes,
   the same shapes the reference's ifelse/loop transformers target:

   - ``if <pred>: ... [else: ...]`` with plain-assignment branches
     becomes a pair of branch functions taking their free reads as
     parameters and returning the assigned names, joined by a runtime
     dispatch that uses ``tensor.cond`` for traced predicates and a
     plain Python branch otherwise;
   - ``while <pred>: ...`` becomes a carry-tuple ``tensor.while_loop``;
   - ``break``/``continue`` in loop bodies are lowered to guard flags
     first (the reference's ``break_continue_transformer.py:1`` scheme):
     ``break`` -> ``flag = True`` with the loop test strengthened to
     ``test & ~flag``, ``continue`` -> a per-iteration flag, and the
     statements a taken jump would skip are wrapped in ``if ~flag``
     guards — all of which then convert through the if/while machinery;
   - early ``return`` inside ``if`` ladders is normalized away before
     conversion (the reference's ``return_transformer.py:1`` analog):
     an ``if`` whose branch returns has the post-if continuation folded
     into its other branch, every former return site assigns one result
     variable, and the function ends with a single ``return`` of it —
     if-else nesting rather than the reference's return-flag guards, so
     both ``torch.cond`` branches yield the SAME result structure instead
     of a None-seeded carry.

   ``return`` inside a LOOP also converts when the returned expression
   reads only pre-loop-bound names: it lowers to ``_rv``-assign + flag +
   ``break`` with the result carry seeded pre-loop by the same
   expression (structure only — the seed value is dead unless selected),
   and the post-loop continuation guarded on the flag's negation.

   Unconvertible shapes are left untouched (a static-bool ``if`` still
   traces fine as-is); loop returns reading loop-fresh names and jumps
   inside ``try`` blocks stay with the sound fallback + hint.

2. :func:`hint_for_tracer_error` — the message ``to_static`` attaches when
   tracing still hits a data-dependent error (used by
   ``StaticFunction.__call__``, which first retries with the converted
   function).

Known (documented) semantic deltas of the minimal pass, matching the traced
rather than Python: under a traced predicate BOTH branches execute; each
branch's free reads are evaluated at the dispatch point even if that
branch is not taken.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, Iterable, List, Set

import torch

__all__ = ["convert", "ConversionError", "hint_for_tracer_error",
           "_rt_cond", "_rt_while"]


class ConversionError(Exception):
    """Raised when the minimal AST pass cannot convert the function."""


class _SeedEvalError(Exception):
    """Pre-loop evaluation of a loop-return result seed raised.

    The loop-return lowering binds ``_RV`` before the loop by evaluating
    the first return expression on PRE-loop values (structure only — the
    value is dead unless the loop never returns).  Eager Python never
    evaluates that expression there, so it may raise where the original
    function would not (``return 1/i`` with ``i == 0`` before the loop).
    The converted function signals this instead of leaking the bogus
    exception; ``convert`` catches it and falls back to the unconverted
    function."""


# ---------------------------------------------------------------------------
# runtime helpers the rewritten source calls
# ---------------------------------------------------------------------------

def _is_tensorish(x) -> bool:
    return torch.is_tensor(x)


def _rt_cond(pred, true_fn, true_args, false_fn, false_args):
    """Tensor predicate -> tensor.cond (torch.cond under trace); python
    bool -> plain branch call."""
    if _is_tensorish(pred):
        from ..tensor.control_flow import cond

        return cond(pred, lambda: true_fn(*true_args),
                    lambda: false_fn(*false_args))
    return true_fn(*true_args) if pred else false_fn(*false_args)


def _rt_while(cond_fn, body_fn, carry):
    """Tensor-predicated while -> tensor.while_loop; python predicate ->
    plain loop.  ``carry`` is always a tuple.

    The predicate is re-checked for tensor-ness every iteration, not just
    once: a ``while True: ... if p: break`` lowering starts with a python
    ``True & ~False`` test that only becomes traced after the first body
    evaluation sets the break flag to a tensor — the loop then hands the
    current carry to ``while_loop`` (one peeled iteration) instead of
    failing a python bool() on a traced value."""
    probe = cond_fn(*carry)
    while not _is_tensorish(probe) and probe:
        out = body_fn(*carry)
        carry = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        probe = cond_fn(*carry)
    if _is_tensorish(probe):
        from ..tensor.control_flow import while_loop

        return tuple(while_loop(cond_fn, body_fn, list(carry)))
    return carry


def _rt_not(x):
    """Logical not that composes with traced booleans."""
    return ~x if _is_tensorish(x) else (not x)


def _rt_and(a, b):
    """Logical and that composes with traced booleans (loop test &
    not-break-flag conjunction)."""
    if _is_tensorish(a) or _is_tensorish(b):
        return a & b
    return bool(a) and bool(b)


def _rt_loop_seed(thunk):
    """Evaluate a loop-return ``_RV`` seed expression, converting any
    exception into :class:`_SeedEvalError` so the caller can fall back to
    the unconverted function (whose eager loop never evaluates the seed
    on pre-loop values)."""
    try:
        return thunk()
    except Exception as e:  # noqa: BLE001 - any eval failure means fallback
        raise _SeedEvalError(e) from e


def _rt_range3(start, stop, step):
    """Normalize ``range()`` bounds for a converted ``for`` loop.

    When any bound is a traced value, the python numbers among them are
    promoted to arrays so the while_loop carry keeps ONE dtype across
    iterations (``i = 0`` then ``i += step_tensor`` would otherwise
    change the carry structure between trace passes)."""
    vals = (start, stop, step)
    if any(_is_tensorish(x) for x in vals):
        like = next(x for x in vals if _is_tensorish(x))
        vals = tuple(x if _is_tensorish(x)
                     else torch.as_tensor(x, device=like.device)
                     for x in vals)
    return vals


# ---------------------------------------------------------------------------
# scope analysis (never descends into nested function/class bodies)
# ---------------------------------------------------------------------------

_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                   ast.ClassDef)


def _shallow_walk(nodes: Iterable[ast.AST]):
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _SCOPE_BARRIERS):
            continue  # their bodies are a different scope
        stack.extend(ast.iter_child_nodes(node))


def _assigned_names(stmts) -> Set[str]:
    """Names bound by the statements at THIS scope level."""
    names: Set[str] = set()
    for node in _shallow_walk(stmts):
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            names.add(node.id)
        elif isinstance(node, _SCOPE_BARRIERS) and hasattr(node, "name"):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
    return names


class _FreeReads(ast.NodeVisitor):
    """Names loaded before being bound, in (approximate) execution order."""

    def __init__(self, bound: Set[str]):
        self.bound = set(bound)
        self.free: Set[str] = set()

    def visit_Name(self, node: ast.Name):
        if isinstance(node.ctx, ast.Load):
            if node.id not in self.bound:
                self.free.add(node.id)
        else:
            self.bound.add(node.id)

    def visit_Assign(self, node: ast.Assign):
        self.visit(node.value)  # RHS evaluates first
        for t in node.targets:
            self.visit(t)

    def visit_AugAssign(self, node: ast.AugAssign):
        self.visit(node.value)
        # target is read-then-written
        for n in _shallow_walk([node.target]):
            if isinstance(n, ast.Name) and n.id not in self.bound:
                self.free.add(n.id)
        for t in _shallow_walk([node.target]):
            if isinstance(t, ast.Name):
                self.bound.add(t.id)

    def generic_visit(self, node):
        if isinstance(node, _SCOPE_BARRIERS):
            if hasattr(node, "name"):
                self.bound.add(node.name)
            return
        super().generic_visit(node)


def _free_reads(stmts, pre_bound: Set[str] = frozenset()) -> Set[str]:
    v = _FreeReads(set(pre_bound))
    for s in stmts:
        v.visit(s)
    return v.free


_BANNED = (ast.Return, ast.Break, ast.Continue, ast.Yield, ast.YieldFrom)


def _convertible_body(stmts) -> bool:
    return not any(isinstance(n, _BANNED) for n in _shallow_walk(stmts))


def _no_return_yield(stmts) -> bool:
    """Loop-body gate: break/continue ARE convertible (lowered to guard
    flags first), only return/yield force the fallback."""
    return not any(isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom))
                   for n in _shallow_walk(stmts))


def _definite_binds(s) -> Set[str]:
    """Names statement ``s`` binds on EVERY control path through it
    (loops may run zero times -> nothing; if needs both branches)."""
    if isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        return _assigned_names([s])
    if isinstance(s, ast.If) and s.orelse:
        return (_definite_binds_block(s.body)
                & _definite_binds_block(s.orelse))
    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return {s.name}
    if isinstance(s, (ast.Import, ast.ImportFrom)):
        return {(a.asname or a.name).split(".")[0] for a in s.names}
    if isinstance(s, ast.With):
        names = _definite_binds_block(s.body)
        for item in s.items:
            if item.optional_vars is not None:
                names |= _assigned_names([ast.Assign(
                    targets=[item.optional_vars],
                    value=ast.Constant(value=None))])
        return names
    return set()


def _definite_binds_block(stmts) -> Set[str]:
    out: Set[str] = set()
    for s in stmts:
        out |= _definite_binds(s)
    return out


# ---------------------------------------------------------------------------
# early-return normalization (reference return_transformer.py:1 analog)
# ---------------------------------------------------------------------------

_RV = "_pt_d2s_rv"  # single-underscore: must survive _user_names filtering


class _Unsupported(Exception):
    """A return shape the normalization pass refuses (return inside a
    loop/try/with): the caller skips the pass and keeps the fallback."""


def _assign_node(name: str, value: ast.expr) -> ast.stmt:
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=value)


def _has_return(stmts) -> bool:
    return any(isinstance(n, ast.Return) for n in _shallow_walk(stmts))


def _return_nested(stmts) -> bool:
    """True when a Return sits under an If or a loop (at any non-scope
    depth) — the trigger for normalization; plain tail returns need
    nothing."""
    stack = [(s, False) for s in stmts]
    while stack:
        s, nested = stack.pop()
        if isinstance(s, ast.Return) and nested:
            return True
        if isinstance(s, _SCOPE_BARRIERS):
            continue
        for c in ast.iter_child_nodes(s):
            stack.append((c, nested or isinstance(
                s, (ast.If, ast.For, ast.AsyncFor, ast.While))))
    return False


def _terminates(stmts) -> bool:
    """Control cannot fall off the end of this statement list."""
    for s in stmts:
        if isinstance(s, (ast.Return, ast.Raise)):
            return True
        if isinstance(s, ast.If) and s.orelse and \
                _terminates(s.body) and _terminates(s.orelse):
            return True
    return False


def _norm_block(stmts, bound, local_names) -> list:
    """Statements where EVERY path assigns ``_RV`` (or raises)."""
    new, term = _norm_tail(list(stmts), bound, local_names)
    if not term:
        # falling off the end of a tail block is python's implicit
        # `return None`
        new = new + [_assign_node(_RV, ast.Constant(value=None))]
    return new


_LOOP_LEVEL_BARRIERS = (ast.For, ast.AsyncFor, ast.While, *_SCOPE_BARRIERS)


def _at_loop_level(stmts, types):
    """Nodes of the given types belonging to THIS loop body — the walk
    every loop-level analysis shares: nested loops and nested scopes own
    their jumps/returns, so the traversal never descends into them."""
    out = []
    stack = list(stmts)
    while stack:
        s = stack.pop()
        if isinstance(s, types):
            out.append(s)
            continue
        if isinstance(s, _LOOP_LEVEL_BARRIERS):
            continue
        stack.extend(ast.iter_child_nodes(s))
    return out


def _has_user_break(stmts) -> bool:
    """A Break written by the USER at this loop's level (checked before
    return lowering introduces its own breaks)."""
    return bool(_at_loop_level(stmts, ast.Break))


def _returns_at_loop_level(stmts):
    """Return nodes belonging to THIS loop body (not nested loops')."""
    return _at_loop_level(stmts, ast.Return)


class _LoopReturnLower(ast.NodeTransformer):
    """``return e`` inside one loop's body -> ``_RV = e; flag = True;
    break`` (the break_continue machinery then converts the exit)."""

    def __init__(self, flag):
        self.flag = flag

    def visit(self, node):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While,
                             *_SCOPE_BARRIERS)):
            return node  # nested loops/scopes own their returns
        return super().visit(node)

    def visit_Return(self, node: ast.Return):
        return [_assign_node(_RV, node.value if node.value is not None
                             else ast.Constant(value=None)),
                _assign_node(self.flag, ast.Constant(value=True)),
                ast.Break()]


def _eval_safe_seed(e) -> bool:
    """True for seed expressions whose pre-loop evaluation cannot raise
    beyond NameError (which the bound-names check already rules out):
    bare names, constants, unary +/- of those, and tuples/lists of
    them.  Anything else (arithmetic, calls, subscripts) may raise or
    side-effect when evaluated on PRE-loop values — ``return 1/i`` with
    ``i == 0`` before the loop — so it gets the runtime seed guard."""
    if isinstance(e, (ast.Constant, ast.Name)):
        return True
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, (ast.USub, ast.UAdd)):
        return _eval_safe_seed(e.operand)
    if isinstance(e, (ast.Tuple, ast.List)):
        return all(_eval_safe_seed(x) for x in e.elts)
    return False


def _lower_loop_returns(s, bound, flag, local_names, allow_bare=False):
    """Rewrite a loop statement whose body returns: (pre_stmts, loop').
    Raises _Unsupported for shapes that cannot seed the result carry."""
    rets = _returns_at_loop_level(s.body)
    total = sum(1 for n in _shallow_walk(s.body)
                if isinstance(n, ast.Return))
    if not rets or total != len(rets):
        # returns inside NESTED loops of this body (alone or alongside
        # loop-level ones): the lowerer would leave a raw Return behind;
        # one level is supported, deeper nesting keeps the fallback
        raise _Unsupported("return in nested loop")
    if s.orelse:
        raise _Unsupported("return in loop with else")
    vals = [r.value for r in rets]
    if any(v is None for v in vals) and any(v is not None for v in vals):
        raise _Unsupported("mixed bare and value returns in loop")
    if vals[0] is None and not allow_bare:
        # bare returns seed _RV=None; a reachable continuation returning
        # a VALUE would then join mismatching structures at the guard
        # cond — keep the curated fallback instead of an opaque error
        raise _Unsupported("bare return in loop with a reachable "
                           "continuation")
    # the while carry needs _RV bound BEFORE the loop with the same
    # structure the in-loop returns produce: seed it by evaluating the
    # first return's expression on the pre-loop values (pure tensor
    # math; its value is dead unless the loop never rebinds _RV, which
    # implies the flag stayed False and the seed is never selected).
    # Only FUNCTION-LOCAL reads need a pre-loop binding — globals and
    # builtins (pt, np, helper fns) resolve at runtime regardless.
    seed = vals[0] if vals[0] is not None else ast.Constant(value=None)
    free = _free_reads([ast.Expr(value=seed)]) & set(local_names)
    if not free <= bound:
        raise _Unsupported(
            "loop return value reads locals unbound before the loop: %s"
            % sorted(free - bound))
    import copy

    if _eval_safe_seed(seed):
        seed_value = copy.deepcopy(seed)
    else:
        # evaluation-UNSAFE seed (ADVICE r5 medium): wrap it so a runtime
        # exception becomes _SeedEvalError and convert()'s wrapper falls
        # back to the unconverted function instead of raising where eager
        # code never evaluates
        seed_value = ast.Call(
            func=ast.Name(id="__pt_rt_loop_seed", ctx=ast.Load()),
            args=[ast.Lambda(args=_make_args([]),
                             body=copy.deepcopy(seed))],
            keywords=[])
    pre = [_assign_node(flag, ast.Constant(value=False)),
           _assign_node(_RV, seed_value)]
    loop = copy.deepcopy(s)
    lower = _LoopReturnLower(flag)
    # transform the BODY's statements (the visitor's loop/scope guard
    # would otherwise skip the loop node we are lowering)
    new_body = []
    for st in loop.body:
        r = lower.visit(st)
        new_body.extend(r if isinstance(r, list) else [r])
    loop.body = new_body
    ast.fix_missing_locations(loop)
    return pre, loop


def _norm_tail(stmts, bound, local_names):
    """Rewrite a TAIL-position statement list (falling off its end ends
    the function): every ``return e`` becomes ``_RV = e``, an ``if``
    whose branch returns absorbs the post-if continuation into whichever
    branches fall through — so both sides of the eventual ``torch.cond``
    compute a real result value instead of a None placeholder — and a
    LOOP whose body returns is lowered to ``_RV``-assign + flag + break
    with the continuation guarded on the flag's negation.  ``bound``:
    names possibly bound before the first statement (for the loop-return
    seed check).  Returns (new_stmts, terminates)."""
    out = []
    bound = set(bound)
    for idx, s in enumerate(stmts):
        rest = stmts[idx + 1:]
        if isinstance(s, ast.Return):
            out.append(_assign_node(
                _RV, s.value if s.value is not None
                else ast.Constant(value=None)))
            return out, True  # anything after is unreachable
        if isinstance(s, ast.Raise):
            out.append(s)
            return out, True
        if _has_return([s]):
            import copy

            if isinstance(s, (ast.For, ast.While)):
                # `while <truthy constant>` whose ONLY exit is the
                # lowered return: the continuation is unreachable —
                # emitting its implicit rv=None would poison the cond
                # structure
                only_exit_is_return = (
                    isinstance(s, ast.While)
                    and isinstance(s.test, ast.Constant)
                    and bool(s.test.value)
                    and not _has_user_break(s.body))
                flag = "_pt_d2s_lret_%d" % (idx + len(out) + 1)
                pre, loop = _lower_loop_returns(
                    s, bound, flag, local_names,
                    allow_bare=only_exit_is_return)
                out.extend(pre)
                out.append(loop)
                if only_exit_is_return:
                    return out, True
                # the continuation runs only when the loop exited
                # without returning; its paths all assign _RV, while the
                # taken-return path keeps the loop's _RV
                cont_bound = bound | _assigned_names([loop]) | {flag, _RV}
                out.append(ast.If(
                    test=_not_flags([flag]),
                    body=_norm_block(copy.deepcopy(rest), cont_bound,
                                     local_names),
                    orelse=[]))
                return out, True
            if not isinstance(s, ast.If):
                # return inside try/with: handler interactions are not
                # modeled; the sound fallback (tracer hint) remains
                raise _Unsupported(type(s).__name__)
            # each branch gets its OWN copy of the continuation: later
            # passes mutate statements in place (loop jump lowering
            # rewrites a While's test/body), and a node aliased into
            # both branches would be seen pre-lowered by one and
            # already-lowered by the other
            body = list(s.body) if _terminates(s.body) \
                else list(s.body) + copy.deepcopy(rest)
            orelse = list(s.orelse) if s.orelse and _terminates(s.orelse) \
                else list(s.orelse) + copy.deepcopy(rest)
            branch_bound = bound
            out.append(ast.If(test=s.test,
                              body=_norm_block(body, branch_bound,
                                               local_names),
                              orelse=_norm_block(orelse, branch_bound,
                                                 local_names)))
            return out, True
        out.append(s)
        bound |= _assigned_names([s])
    return out, False


def _normalize_returns(fdef, arg_names) -> bool:
    """Apply return normalization to a function body in place; True when
    the pass ran.  The body afterwards has exactly one ``return _RV`` at
    the end and no Return anywhere else (outside nested scopes)."""
    if not _return_nested(fdef.body):
        return False
    local_names = _assigned_names(fdef.body) | set(arg_names)
    body = _norm_block(fdef.body, set(arg_names), local_names)
    new = body + [ast.Return(value=ast.Name(id=_RV, ctx=ast.Load()))]
    # continuation duplication is linear for return ladders but can
    # compound for deeply nested fall-through returns; refuse pathological
    # blowup rather than compile a megabyte of AST
    if sum(1 for _ in ast.walk(ast.Module(body=new, type_ignores=[]))) > 20000:
        raise _Unsupported("normalized AST too large")
    fdef.body = new
    return True


# ---------------------------------------------------------------------------
# break/continue lowering (reference break_continue_transformer.py:1 analog)
# ---------------------------------------------------------------------------

def _jumps_at_level(stmts) -> bool:
    """True when a Break/Continue belongs to THIS loop body (nested
    loops own theirs)."""
    return bool(_at_loop_level(stmts, (ast.Break, ast.Continue)))


def _not_flags(names) -> ast.expr:
    """``__pt_rt_not(f1 | f2 | ...)`` — composes for python bools and
    traced booleans alike."""
    expr = ast.Name(id=names[0], ctx=ast.Load())
    for n in names[1:]:
        expr = ast.BinOp(left=expr, op=ast.BitOr(),
                         right=ast.Name(id=n, ctx=ast.Load()))
    return ast.Call(func=ast.Name(id="__pt_rt_not", ctx=ast.Load()),
                    args=[expr], keywords=[])


class _JumpLower:
    """Rewrites one loop body's break/continue into flag assignments,
    wrapping the statements a taken jump would skip in ``if ~flag``
    guards (which the if-conversion then turns into conds).  The caller
    initializes the break flag before the loop, resets the continue flag
    each iteration, and strengthens the loop test with ``& ~brk``."""

    def __init__(self, brk: str, cnt: str):
        self.brk, self.cnt = brk, cnt
        self.has_brk = self.has_cnt = False
        self.unsupported = None

    def block(self, stmts):
        """-> (new_stmts, flags_possibly_set)."""
        out, all_sets = [], set()
        for idx, s in enumerate(stmts):
            s2, sets = self.stmt(s)
            out.append(s2)
            all_sets |= sets
            rest = stmts[idx + 1:]
            if sets and rest:
                inner, inner_sets = self.block(rest)
                all_sets |= inner_sets
                out.append(ast.If(test=_not_flags(sorted(sets)),
                                  body=inner, orelse=[]))
                break
        return out, all_sets

    def stmt(self, s):
        if isinstance(s, ast.Break):
            self.has_brk = True
            return _assign_node(self.brk, ast.Constant(value=True)), \
                {self.brk}
        if isinstance(s, ast.Continue):
            self.has_cnt = True
            return _assign_node(self.cnt, ast.Constant(value=True)), \
                {self.cnt}
        if isinstance(s, (ast.For, ast.AsyncFor, ast.While,
                          *_SCOPE_BARRIERS)):
            return s, set()  # inner loop's jumps belong to it
        if isinstance(s, ast.Try):
            if _jumps_at_level([s]):
                # a jump out of an except/finally interacts with the
                # handler machinery; not lowered
                self.unsupported = "break/continue inside try"
            return s, set()
        if isinstance(s, ast.If):
            nb, sb = self.block(s.body)
            no, so = self.block(s.orelse)
            if sb | so:
                return ast.If(test=s.test, body=nb, orelse=no), sb | so
            return s, set()
        if isinstance(s, (ast.With, ast.AsyncWith)):
            nb, sb = self.block(s.body)
            if sb:
                s2 = type(s)(items=s.items, body=nb)
                return s2, sb
            return s, set()
        return s, set()


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

def _user_names(names: Set[str]) -> Set[str]:
    """Drop the transformer's own generated names (__pt_*)."""
    return {n for n in names if not n.startswith("__pt_")}


class _CtrlFlowTransformer:
    """Statement-list-level rewriter.

    Works on statement lists (not NodeTransformer field recursion) so a
    ``While`` sees its successor statements: the carry can then be the
    assigned names that are actually LIVE — read by the loop test, read
    before assignment within an iteration (loop-carried), or read after
    the loop — instead of every body temporary (which would be unbound at
    loop entry)."""

    def __init__(self, local_names: Set[str], arg_names: Set[str],
                 loaded_names: Set[str] = None,
                 closure_reads: Set[str] = frozenset()):
        self.locals = set(local_names)
        # names definitely bound at function entry; transform_block threads
        # a definitely-bound set past each statement so loop conversion can
        # refuse a carry that would be unbound at loop entry
        self.entry_bound = set(arg_names)
        # every Name read ANYWHERE in the function (full walk, including
        # nested defs that may close over locals): a branch-assigned name
        # absent from this set can never be observed after the branch, so
        # the if conversion may drop it from the joined outputs
        self.loaded = (set(loaded_names) if loaded_names is not None
                       else None)
        # names read inside nested defs/lambdas anywhere in the function:
        # successor-liveness analysis skips those scopes, so a name a later
        # closure reads must always count as live
        self.closure_reads = set(closure_reads)
        self.n = 0

    def _tuple(self, names, ctx) -> ast.expr:
        return ast.Tuple(
            elts=[ast.Name(id=n, ctx=ctx()) for n in names], ctx=ctx())

    def transform_block(self, stmts: List[ast.stmt],
                        bound: Set[str] = None,
                        after: List[ast.stmt] = ()) -> List[ast.stmt]:
        """``bound``: names POSSIBLY bound before the first statement
        (function args at top level; every name any preceding statement
        may assign, loop/branch bodies included). The loop/if guards use
        it to refuse conversion only for names bound NOWHERE earlier —
        there conversion is impossible; for merely conditionally-bound
        names eager python itself raises UnboundLocalError on the
        unlucky path, so converting preserves behavior.

        ``after``: the statements that execute AFTER this block completes
        (the enclosing continuation) — threaded so liveness analysis for
        nested if/while conversion sees reads beyond the current
        statement list (a carry read only after the enclosing branch
        still counts as live)."""
        bound = set(self.entry_bound if bound is None else bound)
        out: List[ast.stmt] = []
        for idx, s in enumerate(stmts):
            succ = stmts[idx + 1:] + list(after)
            if isinstance(s, ast.If):
                out.extend(self._transform_if(s, bound, succ))
            elif isinstance(s, ast.While):
                out.extend(self._transform_while(s, succ, bound))
            elif isinstance(s, ast.For) and \
                    (lowered := self._lower_for_range(s, succ,
                                                      bound)) is not None:
                out.extend(lowered)
            else:
                # a try body's continuation includes its handlers: any
                # point in the body may jump there, so names the handler
                # reads must count as live for nested conversions
                handler_stmts = [st for h in getattr(s, "handlers", [])
                                 for st in h.body]
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(s, field, None)
                    if isinstance(sub, list) and sub and isinstance(
                            sub[0], ast.stmt):
                        after_f = (handler_stmts + succ
                                   if field == "body" and handler_stmts
                                   else succ)
                        setattr(s, field,
                                self.transform_block(sub, bound, after_f))
                for h in getattr(s, "handlers", []):
                    h.body = self.transform_block(h.body, bound, succ)
                out.append(s)
            bound |= _assigned_names([s])
        return out

    def _transform_if(self, node: ast.If, bound: Set[str] = None,
                      successors: List[ast.stmt] = ()) -> List[ast.stmt]:
        node.body = self.transform_block(node.body, bound, successors)
        node.orelse = self.transform_block(node.orelse, bound, successors)
        if not (_convertible_body(node.body)
                and _convertible_body(node.orelse)):
            return [node]
        outs = sorted(_user_names(
            _assigned_names(list(node.body) + list(node.orelse))))
        if self.loaded is not None:
            # a name assigned in a branch but read nowhere in the whole
            # function is unobservable — dropping it avoids forcing the
            # OTHER branch to return a value it never had (e.g. the
            # pre-seeded target of a converted for inside one branch)
            outs = [o for o in outs if o in self.loaded]
        if bound is not None:
            # must-assign on BOTH branches (a name only conditionally
            # assigned inside a nested loop of a branch does not count)
            both = _user_names(
                _definite_binds_block(node.body)
                & _definite_binds_block(node.orelse))
            live_after = (_free_reads(list(successors))
                          | self.closure_reads)
            # a free read by either branch also forces the refusal: the
            # dispatch evaluates every branch's free params up front, so
            # an unbound one would NameError even on the assigning path
            branch_free = _free_reads(node.body) | _free_reads(node.orelse)
            for o in list(outs):
                if o not in bound and o not in both:
                    if o in live_after or o in branch_free:
                        # one branch reads o as a free parameter while
                        # the other assigns it, and no pre-if value
                        # exists: a converted cond would hit
                        # UnboundLocalError; leave it for the tracer
                        # hint (define o before the if)
                        return [node]
                    # dead after the if (a branch-local temporary, e.g.
                    # introduced by return normalization folding the
                    # continuation into one branch): not an output
                    outs.remove(o)
        self.n += 1
        i = self.n
        defs, branches = [], []
        for tag, body in (("true", list(node.body)),
                          ("false", list(node.orelse) or [ast.Pass()])):
            ret = ast.Return(value=self._tuple(outs, ast.Load))
            # free reads of the branch (incl. the return of outs the other
            # branch assigned), restricted to function-local names — only
            # those risk UnboundLocalError inside the closure
            params = sorted(_free_reads(body + [ret]) & self.locals)
            name = "__pt_%s_%d" % (tag, i)
            defs.append(ast.FunctionDef(
                name=name,
                args=_make_args(params),
                body=body + [ret],
                decorator_list=[]))
            branches.append((name, params))
        call_args = [node.test]
        for name, params in branches:
            call_args.append(ast.Name(id=name, ctx=ast.Load()))
            call_args.append(self._tuple(params, ast.Load))
        call = ast.Assign(
            targets=[self._tuple(outs, ast.Store)] if outs else
            [ast.Name(id="__pt_unused_%d" % i, ctx=ast.Store())],
            value=ast.Call(func=ast.Name(id="__pt_rt_cond", ctx=ast.Load()),
                           args=call_args, keywords=[]))
        return defs + [call]

    def _lower_for_range(self, node: ast.For, successors,
                         bound: Set[str] = None):
        """``for i in range(...)`` -> hidden-counter ``while`` (then the
        while conversion makes it a torch.while_loop when the bounds are
        traced).  The counter is hidden so body writes to the target do
        not perturb iteration, matching python ``for`` semantics; the
        target keeps its last value after the loop (and is pre-seeded
        with ``start`` so a zero-trip loop leaves it defined — a
        documented delta from python, which leaves it unbound).  Returns
        None (leave untouched) for non-range iterables, starred/keyword
        args, tuple targets, or bodies with break/continue/return.

        Reference: the for→while transformer of
        ``dygraph_to_static/loop_transformer.py:52``."""
        it = node.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and not it.keywords
                and 1 <= len(it.args) <= 3
                and not any(isinstance(a, ast.Starred) for a in it.args)
                and isinstance(node.target, ast.Name)
                and _no_return_yield(node.body)):
            return None
        # break/continue: lowered on the raw body BEFORE the hidden
        # counter increment is appended, so a `continue` skips the rest
        # of the USER body but never the increment (which would spin the
        # counter loop forever)
        body_core, jump_init, test_guard = list(node.body), [], None
        flag_names: List[str] = []
        if _jumps_at_level(body_core):
            brk, cntf = self._new_flags()
            lw = _JumpLower(brk, cntf)
            body_core, _ = lw.block(body_core)
            if lw.unsupported:
                return None
            if lw.has_cnt:
                body_core = [_assign_node(cntf,
                                          ast.Constant(value=False))] \
                    + body_core
                self._register_flag(cntf)
                flag_names.append(cntf)
            if lw.has_brk:
                jump_init.append(_assign_node(brk,
                                              ast.Constant(value=False)))
                test_guard = brk
                self._register_flag(brk)
                flag_names.append(brk)
        args = list(it.args)
        if len(args) == 1:
            start, stop = ast.Constant(value=0), args[0]
            step = ast.Constant(value=1)
        elif len(args) == 2:
            (start, stop), step = args, ast.Constant(value=1)
        else:
            start, stop, step = args
        self.n += 1
        i = self.n
        cnt, stop_n, step_n = ("__pt_fi_%d" % i, "__pt_fstop_%d" % i,
                               "__pt_fstep_%d" % i)
        # generated names must count as locals so the while conversion
        # includes them in its carry/parameter analysis
        self.locals |= {cnt, stop_n, step_n}
        pre = [ast.Assign(
            targets=[self._tuple([cnt, stop_n, step_n], ast.Store)],
            value=ast.Call(
                func=ast.Name(id="__pt_rt_range3", ctx=ast.Load()),
                args=[start, stop, step], keywords=[])),
            # pre-seed the target so it is bound even for zero-trip loops
            # (lets the while conversion carry it when read after the loop)
            ast.Assign(targets=[ast.Name(id=node.target.id,
                                         ctx=ast.Store())],
                       value=ast.Name(id=cnt, ctx=ast.Load()))]

        def cmp(op, a, b):
            return ast.Compare(left=ast.Name(id=a, ctx=ast.Load()),
                               ops=[op()],
                               comparators=[b if isinstance(b, ast.expr)
                                            else ast.Name(id=b,
                                                          ctx=ast.Load())])

        # ((step > 0) & (i < stop)) | ((step < 0) & (i > stop)) — bitwise
        # ops so traced scalars compose; python bools are ints, same result
        test = ast.BinOp(
            left=ast.BinOp(left=cmp(ast.Gt, step_n, ast.Constant(value=0)),
                           op=ast.BitAnd(), right=cmp(ast.Lt, cnt, stop_n)),
            op=ast.BitOr(),
            right=ast.BinOp(left=cmp(ast.Lt, step_n, ast.Constant(value=0)),
                            op=ast.BitAnd(),
                            right=cmp(ast.Gt, cnt, stop_n)))
        if test_guard is not None:
            test = ast.Call(
                func=ast.Name(id="__pt_rt_and", ctx=ast.Load()),
                args=[test, _not_flags([test_guard])], keywords=[])
        body = ([ast.Assign(targets=[ast.Name(id=node.target.id,
                                              ctx=ast.Store())],
                            value=ast.Name(id=cnt, ctx=ast.Load()))]
                + body_core
                # a new counter each step: torch's ``+=`` writes in place,
                # which would move the loop target bound to the counter
                + [ast.Assign(targets=[ast.Name(id=cnt, ctx=ast.Store())],
                              value=ast.BinOp(
                                  left=ast.Name(id=cnt, ctx=ast.Load()),
                                  op=ast.Add(),
                                  right=ast.Name(id=step_n,
                                                 ctx=ast.Load())))])
        wh = ast.While(test=test, body=body, orelse=[])
        post = list(node.orelse)
        if post and test_guard is not None:
            # python runs a for's else iff no break fired: exactly the
            # lowered break flag's negation
            post = [ast.If(test=_not_flags([test_guard]), body=post,
                           orelse=[])]
        inner_bound = None if bound is None else (
            set(bound) | {cnt, stop_n, step_n, node.target.id}
            | set(flag_names))
        return (pre + jump_init
                + self._transform_while(wh, post + list(successors),
                                        inner_bound)
                + self.transform_block(post, inner_bound,
                                       list(successors)))

    def _new_flags(self):
        """Fresh (brk, cnt) flag names, registered as locals AND as
        loaded names: flags flow through converted-if outputs (so the
        loaded-names unobservability filter must keep them) and through
        the while carry."""
        self.n += 1
        names = ("_pt_d2s_brk_%d" % self.n, "_pt_d2s_cnt_%d" % self.n)
        return names

    def _register_flag(self, name: str):
        self.locals.add(name)
        if self.loaded is not None:
            self.loaded.add(name)

    def _lower_loop_jumps(self, node: ast.While, bound):
        """Lower this while's break/continue into guard flags, mutating
        ``node`` in place.  Returns (pre_stmts, bound) — pre_stmts seed
        the break flag before the loop — or None when the shape is
        refused (loop else, jump inside try), leaving the node
        untouched."""
        if not _jumps_at_level(node.body):
            return [], bound
        if node.orelse:
            # python runs a while's else only when no break fired; the
            # lowered loop cannot skip it, so leave the loop eager
            return None
        brk, cnt = self._new_flags()
        lw = _JumpLower(brk, cnt)
        new_body, _ = lw.block(node.body)
        if lw.unsupported:
            return None
        pre = []
        if lw.has_cnt:
            # reset each iteration: continue only skips the CURRENT
            # iteration's remainder
            new_body = [_assign_node(cnt, ast.Constant(value=False))] \
                + new_body
            self._register_flag(cnt)
        if lw.has_brk:
            pre.append(_assign_node(brk, ast.Constant(value=False)))
            node.test = ast.Call(
                func=ast.Name(id="__pt_rt_and", ctx=ast.Load()),
                args=[node.test, _not_flags([brk])], keywords=[])
            self._register_flag(brk)
        node.body = new_body
        if bound is not None:
            bound = set(bound) | {n for n, h in
                                  ((brk, lw.has_brk), (cnt, lw.has_cnt))
                                  if h}
        return pre, bound

    def _transform_while(self, node: ast.While,
                         successors: List[ast.stmt],
                         bound: Set[str] = None) -> List[ast.stmt]:
        pre = []
        lowered = self._lower_loop_jumps(node, bound)
        if lowered is not None:
            pre, bound = lowered
        # the body's continuation is the next iteration (test + body) or
        # the loop exit (successors)
        node.body = self.transform_block(
            node.body, bound,
            [ast.Expr(value=node.test)] + list(node.body)
            + list(successors))
        if node.orelse or not _convertible_body(node.body):
            return pre + [node]
        assigned = _user_names(_assigned_names(node.body))
        live = (_free_reads([ast.Expr(value=node.test)])  # loop test
                | _free_reads(node.body)                  # loop-carried
                | _free_reads(successors)                 # read after loop
                | self.closure_reads) & self.locals
        carry = sorted(assigned & live
                       | (_free_reads([ast.Expr(value=node.test)])
                          & self.locals))
        if not (assigned & live):
            return pre + [node]  # nothing loop-carried: leave untouched
        if bound is not None and not set(carry) <= set(bound):
            # a carry name first assigned INSIDE the loop and read after it
            # has no pre-loop value to seed the while_loop carry with; a
            # converted loop would hit UnboundLocalError building the
            # initial carry tuple. Left unconverted: the tracer error (with
            # the define-before-loop rewrite hint) is the honest outcome.
            return pre + [node]
        self.n += 1
        i = self.n
        cname, bname = "__pt_wcond_%d" % i, "__pt_wbody_%d" % i
        cond_def = ast.FunctionDef(
            name=cname, args=_make_args(carry),
            body=[ast.Return(value=node.test)], decorator_list=[])
        body_def = ast.FunctionDef(
            name=bname, args=_make_args(carry),
            body=list(node.body) +
            [ast.Return(value=self._tuple(carry, ast.Load))],
            decorator_list=[])
        call = ast.Assign(
            targets=[self._tuple(carry, ast.Store)],
            value=ast.Call(
                func=ast.Name(id="__pt_rt_while", ctx=ast.Load()),
                args=[ast.Name(id=cname, ctx=ast.Load()),
                      ast.Name(id=bname, ctx=ast.Load()),
                      self._tuple(carry, ast.Load)],
                keywords=[]))
        return pre + [cond_def, body_def, call]


class _IfExpTransformer(ast.NodeTransformer):
    """``a if pred else b`` ->
    ``__pt_rt_cond(pred, lambda: a, (), lambda: b, ())``.

    Expression-level and scope-safe: the lambdas only READ enclosing
    variables, so no parameter/carry analysis is needed, and with a
    Python-bool predicate the runtime keeps lazy single-branch
    evaluation.  Branches containing a walrus (NamedExpr) — wrapping
    would move the binding into the lambda scope — or await/yield
    (illegal/behavior-changing inside a lambda) are left untouched.
    ``n`` counts only rewrites whose predicate LOOKS tensor-capable
    (contains a comparison/call/binop), so a pure-Python string ternary
    alone never makes convert() claim success."""

    _UNWRAPPABLE = (ast.NamedExpr, ast.Await, ast.Yield, ast.YieldFrom)

    def __init__(self):
        self.n = 0

    def visit_IfExp(self, node: ast.IfExp):
        self.generic_visit(node)
        for sub in (node.body, node.orelse):
            if any(isinstance(x, self._UNWRAPPABLE) for x in ast.walk(sub)):
                return node
        if any(isinstance(x, (ast.Compare, ast.Call, ast.BinOp))
               for x in ast.walk(node.test)):
            self.n += 1
        empty = ast.Tuple(elts=[], ctx=ast.Load())
        return ast.Call(
            func=ast.Name(id="__pt_rt_cond", ctx=ast.Load()),
            args=[node.test,
                  ast.Lambda(args=_make_args([]), body=node.body),
                  empty,
                  ast.Lambda(args=_make_args([]), body=node.orelse),
                  ast.Tuple(elts=[], ctx=ast.Load())],
            keywords=[])


def _make_args(names: List[str]) -> ast.arguments:
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=n) for n in names], vararg=None,
        kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[])


def convert(fn: Callable) -> Callable:
    """Rewrite ``fn``'s tensor-conditioned if/while into cond/while_loop
    calls and return the recompiled function.  Raises ConversionError when
    the source is unavailable, the function has closure cells (recompiling
    would sever them), or nothing was rewritten."""
    inner = inspect.unwrap(fn)
    if getattr(inner, "__closure__", None):
        raise ConversionError(
            "cannot convert %r: it closes over outer variables; rewrite "
            "the tensor-dependent if/while with paddle_tpu_torch.static.nn.cond / "
            "while_loop by hand" % getattr(fn, "__name__", fn))
    try:
        src = textwrap.dedent(inspect.getsource(inner))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError) as e:
        raise ConversionError("cannot get source of %r: %s" % (fn, e))
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise ConversionError("source of %r is not a function def" % (fn,))
    fdef.decorator_list = []  # @to_static etc. must not re-wrap
    arg_names = {a.arg for a in (fdef.args.posonlyargs + fdef.args.args
                                 + fdef.args.kwonlyargs)}
    if fdef.args.vararg:
        arg_names.add(fdef.args.vararg.arg)
    if fdef.args.kwarg:
        arg_names.add(fdef.args.kwarg.arg)
    returns_normalized = False
    try:
        # before name analysis: the pass introduces _RV reads/stores that
        # the locals/loaded sets must see
        returns_normalized = _normalize_returns(fdef, arg_names)
    except _Unsupported:
        pass  # e.g. unseedable loop return: keep the sound fallback
    local_names = _assigned_names(fdef.body) | arg_names
    loaded = {n.id for n in ast.walk(fdef)
              if isinstance(n, ast.Name)
              and isinstance(n.ctx, (ast.Load, ast.Del))}
    for n in ast.walk(fdef):  # AugAssign targets are read-then-written
        if isinstance(n, ast.AugAssign):
            loaded |= {t.id for t in ast.walk(n.target)
                       if isinstance(t, ast.Name)}
    # names read inside nested defs/lambdas: always live (a later closure
    # may observe them even when no successor statement reads them)
    closure_reads: Set[str] = set()
    for n in _shallow_walk(fdef.body):
        if isinstance(n, _SCOPE_BARRIERS):
            closure_reads |= {m.id for m in ast.walk(n)
                              if isinstance(m, ast.Name)
                              and isinstance(m.ctx, ast.Load)}
    tr = _CtrlFlowTransformer(local_names, arg_names, loaded,
                              closure_reads)
    fdef.body = tr.transform_block(fdef.body)
    te = _IfExpTransformer()
    te.visit(fdef)
    if tr.n == 0 and te.n == 0 and not returns_normalized:
        raise ConversionError(
            "no convertible if/while found in %r"
            % getattr(fn, "__name__", fn))
    ast.fix_missing_locations(tree)
    code = compile(tree, "<dy2static:%s>" % getattr(
        inner, "__name__", "fn"), "exec")
    # the helpers go into the function's own globals: torch.cond and
    # torch.while_loop trace their bodies with dynamo, whose guards look
    # globals up on the module the function names
    glb = inner.__globals__
    glb["__pt_rt_cond"] = _rt_cond
    glb["__pt_rt_while"] = _rt_while
    glb["__pt_rt_range3"] = _rt_range3
    glb["__pt_rt_not"] = _rt_not
    glb["__pt_rt_and"] = _rt_and
    glb["__pt_rt_loop_seed"] = _rt_loop_seed
    loc: dict = {}
    exec(code, glb, loc)  # noqa: S102 - recompiling user fn, the reference
    new_fn = loc[fdef.name]  # ast_transformer.py does the same via exec
    new_fn.__defaults__ = getattr(inner, "__defaults__", None)
    new_fn.__kwdefaults__ = getattr(inner, "__kwdefaults__", None)
    new_fn.__dy2static_converted__ = True
    if any(isinstance(n, ast.Name) and n.id == "__pt_rt_loop_seed"
           for n in ast.walk(fdef)):
        # an evaluation-unsafe loop-return seed is guarded at runtime:
        # if seeding raises, run the ORIGINAL function — eager Python
        # never evaluates the seed expression before the loop, so the
        # unconverted body is the correct semantics (and if it then hits
        # a tracer error, StaticFunction's hint path reports it).
        # Documented delta (like the both-branches-execute delta above):
        # statements BEFORE the failing seed have already run once in the
        # converted body, so pre-loop side effects (list mutation, I/O)
        # are applied twice on this fallback path; pure tensor code —
        # the conversion's target domain — is unaffected
        orig = getattr(inner, "__func__", inner)
        converted = new_fn

        def new_fn(*args, **kwargs):
            try:
                return converted(*args, **kwargs)
            except _SeedEvalError:
                return orig(*args, **kwargs)

        new_fn.__name__ = converted.__name__
        new_fn.__qualname__ = getattr(converted, "__qualname__",
                                      converted.__name__)
        new_fn.__dy2static_converted__ = True
    return new_fn


def hint_for_tracer_error(err: Exception, fn=None) -> str:
    name = getattr(fn, "__name__", "the function")
    return (
        "to_static(%s): a Python `if`/`while` (or bool()/int() call) "
        "depends on a traced Tensor value, which cannot be evaluated at "
        "trace time, and the automatic AST conversion could not rewrite "
        "this site. Rewrite it with paddle_tpu_torch.static.nn.cond(pred, "
        "true_fn, false_fn) / paddle_tpu_torch.tensor.while_loop(cond_fn, "
        "body_fn, "
        "loop_vars), or hoist the condition out of the traced function. "
        "Original error: %s" % (name, err))
