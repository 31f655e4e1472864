"""A Stan model in the scalar subset of the language as CUDA source for
kernel K2, beside its torch form.

The JAX package's Pallas kernel K2 takes any traced ``jnp`` density, a
``StanTarget``'s included (``SliceSamplerPallas.step_batched`` hoists its
constants into kernel inputs). The port's K2 takes a user's density as a
``DeviceSource`` of hook ``"target"`` (``device_source.py``): CUDA text
beside a torch form. :func:`emit_source` writes one from a
:class:`~.stan.StanTarget`'s parsed program, by lowering it to a small
intermediate form (statements over float32 and int scalars) that is both
printed as C and interpreted on torch tensors, so that the two do the same
float32 operations in the same order and the kernel is bit for bit its twin
(``csrc/user_density.cuh``).

The subset:

* parameters ``real``, ``vector[n]``, ``row_vector[n]`` and ``array[n]
  real``, with ``<lower>``, ``<upper>`` or both given by data (Stan's exp
  and scaled-logit transforms and their jacobians);
* data and transformed data ``int``, ``real`` and their 1-D containers;
  transformed parameters and model-block locals ``real`` and 1-D ``vector``;
* statements ``~`` and ``target +=`` over the univariate densities whose
  functions all have a device form (``cephes_logf``, ``cephes_expf``,
  ``cephes_log1pf``, ``softplus``, ``sigmoid``, ``xla_expm1f``,
  ``xla_tanhf``, IEEE arithmetic, ``sqrtf``), every ``lgamma`` of data or
  literals folded on the host as the model's torch form computes it, and
  every device function of data alone (``log(sigma[j])``) too
  (:meth:`_Emitter.fold_calls`);
  ``for`` over data bounds, ``if`` / ternary, assignments, indexing by data
  ints, ``reject``, ``print``.

The text depends on the model, the data's shapes and its loop bounds; the
values (data, bounds, folded constants) go into one float32 array, at
offsets written into the text, so that the same model on new values of the
same shapes reuses its library. Ints go in the array as floats, and ints
above 2^24 in magnitude, which float32 cannot hold, are refused. A ``for``
loop that the torch form vectorizes (``stan._Evaluator._vectorized_for``:
32 or more iterations of sampling statements, operands of the loop's length)
is emitted as that vectorized statement, so that both forms give the JAX
package's result. Sums are added in order: the twin is held to
``StanTarget.log_density`` within float32 tolerance.

Outside the subset :func:`emit_source` raises :class:`StanSubsetError`,
naming the construct and its line; ``SliceSamplerCUDA`` then refuses the
target with that message (``ops/cuda_slice.py: check_target``).
"""

from __future__ import annotations

import math
import operator
import re

import numpy as np
import torch

from .. import f32math
from ..device_source import DeviceSource
from . import stan as S
from .distributions import _sigmoid, _softplus

MAX_EXACT_INT = 2 ** 24  # float32 holds every int up to here


class StanSubsetError(ValueError):
    """The model lies outside the subset that :func:`emit_source` writes
    as CUDA source."""


def _f32(v) -> float:
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# the intermediate form
#
# float expressions: ("c", v) a float32 constant, ("a", off, i) the array's
# value at off + i, ("x", off, i) the state's coordinate off + i, ("v", name)
# a local, ("ve", name, i) an element of a local array, ("i2f", i), ("neg", a),
# ("+" | "-" | "*" | "/", a, b), ("fma", a, b, c), ("call", fn, a), ("sel", c,
# a, b). int expressions: ("ic", v), ("iv", name) a loop variable, ("ia",
# off, i) the array's value as an int, ("i+" | "i-" | "i*" | "i/" | "i%", a,
# b) (C's truncating / and %). conditions: ("cmp", op, a, b), ("and", a, b),
# ("or", a, b), ("not", a). statements: ("decl", name, n) a float local
# (n None) or array, zeroed; ("set", name, e); ("sete", name, i, e);
# ("for", var, lo, hi, body); ("if", cond, then, other).
# ---------------------------------------------------------------------------

_CALLS = {"log": "cephes_logf", "exp": "cephes_expf", "log1p": "cephes_log1pf",
          "expm1": "xla_expm1f", "tanh": "xla_tanhf", "sqrt": "sqrtf",
          "softplus": "softplus", "sigmoid": "sigmoid", "fabs": "fabsf"}
_TORCH_CALLS = {"log": f32math._log, "exp": f32math._exp, "log1p": f32math._log1p,
                "expm1": f32math._expm1, "tanh": f32math._tanh, "sqrt": torch.sqrt,
                "softplus": _softplus, "sigmoid": _sigmoid, "fabs": torch.abs}
_FOPS = {"+": operator.add, "-": operator.sub, "*": operator.mul, "/": operator.truediv}
_CMPS = {"<": operator.lt, "<=": operator.le, ">": operator.gt, ">=": operator.ge,
         "==": operator.eq, "!=": operator.ne}


def _idiv(a, b):
    """C's truncating ``a / b``, of ints or of numpy arrays of them."""
    return abs(a) // abs(b) * (1 - 2 * ((a < 0) != (b < 0)))


_IOPS = {"i+": operator.add, "i-": operator.sub, "i*": operator.mul, "i/": _idiv,
         "i%": lambda a, b: a - b * _idiv(a, b)}


INT_KINDS = frozenset(("ic", "iv", "ia", *_IOPS))


class _Twin:
    """The torch form: the intermediate form interpreted on ``x [..., d]``,
    float32 throughout (data and constants as 0-d tensors), ints on the
    host; an ``if`` on a tensor runs both branches and blends what they
    wrote, which on every lane is the value of the branch the kernel takes."""

    def __init__(self, stmts):
        self.stmts = stmts

    def __call__(self, x, params, arrays):
        del params
        st = _TwinState(x, arrays[0].detach().cpu().numpy())
        env = {}
        _run(self.stmts, env, st)
        return env["__ret__"].expand(x.shape[:-1]) if env["__ret__"].dim() == 0 else env["__ret__"]


class _TwinState:
    def __init__(self, x, host):
        self.cols = x.unbind(-1)
        self.host = host
        self.device = x.device
        self.ints = {}
        self.consts = {}

    def const(self, v):
        out = self.consts.get(v)
        if out is None:
            out = self.consts[v] = torch.tensor(v, dtype=torch.float32, device=self.device)
        return out

    def value(self, v):
        """A value read from the array, or an int, as a float32 tensor."""
        return self.const(float(v))

    def as_int(self, v):
        return int(v)


class _FoldState:
    """A fold's evaluation on the host: each loop variable a numpy array
    over the iterations, what is read from the array a float32 tensor of
    their values (``_Emitter.fold_calls``)."""

    def __init__(self, host, ints):
        self.host, self.ints = host, ints

    def const(self, v):
        return torch.tensor(v, dtype=torch.float32)

    def value(self, v):
        return torch.from_numpy(np.asarray(v, np.float32))

    def as_int(self, v):
        return np.asarray(v).astype(np.int64)


def _ival(e, st):
    k = e[0]
    if k == "ic":
        return e[1]
    if k == "iv":
        return st.ints[e[1]]
    if k == "ia":
        return st.as_int(st.host[e[1] + _ival(e[2], st)])
    return _IOPS[k](_ival(e[1], st), _ival(e[2], st))


def _fval(e, env, st):
    k = e[0]
    if k == "c":
        return st.const(e[1])
    if k == "a":
        return st.value(st.host[e[1] + _ival(e[2], st)])
    if k == "x":
        return st.cols[e[1] + _ival(e[2], st)]
    if k == "v":
        return env[e[1]]
    if k == "ve":
        return env[e[1]][_ival(e[2], st)]
    if k == "i2f":
        return st.value(_ival(e[1], st))
    if k == "neg":
        return -_fval(e[1], env, st)
    if k in _FOPS:
        return _FOPS[k](_fval(e[1], env, st), _fval(e[2], env, st))
    if k == "fma":
        return f32math._fma(*(_fval(a, env, st) for a in e[1:]))
    if k == "call":
        return _TORCH_CALLS[e[1]](_fval(e[2], env, st))
    if k == "sel":
        c = _cval(e[1], env, st)
        a, b = _fval(e[2], env, st), _fval(e[3], env, st)
        if isinstance(c, bool):
            return a if c else b
        return torch.where(c, a, b)
    raise AssertionError(e)


def _cval(e, env, st):
    k = e[0]
    if k == "cmp":
        a, b = (_ival(v, st) if v[0] in INT_KINDS else _fval(v, env, st) for v in e[2:])
        out = _CMPS[e[1]](a, b)
        return torch.as_tensor(out) if isinstance(out, (np.ndarray, np.generic)) else out
    if k == "not":
        c = _cval(e[1], env, st)
        return (not c) if isinstance(c, bool) else torch.logical_not(c)
    a, b = _cval(e[1], env, st), _cval(e[2], env, st)
    if isinstance(a, bool) and isinstance(b, bool):
        return (a and b) if k == "and" else (a or b)
    a, b = (torch.as_tensor(v) for v in (a, b))
    return torch.logical_and(a, b) if k == "and" else torch.logical_or(a, b)


def _run(stmts, env, st):
    for s in stmts:
        k = s[0]
        if k == "decl":
            zero = st.const(0.0)
            env[s[1]] = zero if s[2] is None else [zero] * s[2]
        elif k == "set":
            env[s[1]] = _fval(s[2], env, st)
        elif k == "sete":
            arr = list(env[s[1]])
            arr[_ival(s[2], st)] = _fval(s[3], env, st)
            env[s[1]] = arr
        elif k == "ret":
            env["__ret__"] = _fval(s[1], env, st)
        elif k == "for":
            for i in range(_ival(s[2], st), _ival(s[3], st) + 1):
                st.ints[s[1]] = i
                _run(s[4], env, st)
            st.ints.pop(s[1], None)
        elif k == "if":
            c = _cval(s[1], env, st)
            if isinstance(c, bool):
                _run(s[2] if c else s[3], env, st)
                continue
            env_t, env_f = dict(env), dict(env)
            _run(s[2], env_t, st)
            _run(s[3], env_f, st)
            for name in env:
                vt, vf = env_t[name], env_f[name]
                if vt is vf:
                    env[name] = vt
                elif isinstance(vt, list):
                    env[name] = [a if a is b else torch.where(c, a, b) for a, b in zip(vt, vf)]
                else:
                    env[name] = torch.where(c, vt, vf)
        else:
            raise AssertionError(s)


# -- printing as C --------------------------------------------------------


def _c_float(v: float) -> str:
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return f"{v.hex()}f"


def _ci(e) -> str:
    k = e[0]
    if k == "ic":
        return str(e[1])
    if k == "iv":
        return e[1]
    if k == "ia":
        return f"(int)A[{e[1]} + {_ci(e[2])}]"
    op = {"i+": "+", "i-": "-", "i*": "*", "i/": "/", "i%": "%"}[k]
    return f"({_ci(e[1])} {op} {_ci(e[2])})"


def _cf(e) -> str:
    k = e[0]
    if k == "c":
        return _c_float(e[1])
    if k == "a":
        return f"A[{e[1]} + {_ci(e[2])}]"
    if k == "x":
        return f"x[{e[1]} + {_ci(e[2])}]"
    if k == "v":
        return e[1]
    if k == "ve":
        return f"{e[1]}[{_ci(e[2])}]"
    if k == "i2f":
        return f"(float)({_ci(e[1])})"
    if k == "neg":
        return f"(-{_cf(e[1])})"
    if k in _FOPS:
        return f"({_cf(e[1])} {k} {_cf(e[2])})"
    if k == "fma":
        return f"__fmaf_rn({_cf(e[1])}, {_cf(e[2])}, {_cf(e[3])})"
    if k == "call":
        return f"{_CALLS[e[1]]}({_cf(e[2])})"
    if k == "sel":
        return f"({_cc(e[1])} ? {_cf(e[2])} : {_cf(e[3])})"
    raise AssertionError(e)


def _cc(e) -> str:
    k = e[0]
    if k == "cmp":
        a, b = (_ci(v) if v[0] in INT_KINDS else _cf(v) for v in e[2:])
        return f"({a} {e[1]} {b})"
    if k == "not":
        return f"(!{_cc(e[1])})"
    return f"({_cc(e[1])} {'&&' if k == 'and' else '||'} {_cc(e[2])})"


def _print(stmts, out, ind):
    pad = "  " * ind
    for s in stmts:
        k = s[0]
        if k == "decl":
            out.append(f"{pad}float {s[1]} = 0.0f;" if s[2] is None
                       else f"{pad}float {s[1]}[{s[2]}] = {{}};")
        elif k == "set":
            out.append(f"{pad}{s[1]} = {_cf(s[2])};")
        elif k == "sete":
            out.append(f"{pad}{s[1]}[{_ci(s[2])}] = {_cf(s[3])};")
        elif k == "ret":
            out.append(f"{pad}return {_cf(s[1])};")
        elif k == "for":
            out.append(f"{pad}for (int {s[1]} = {_ci(s[2])}; {s[1]} <= {_ci(s[3])}; ++{s[1]}) {{")
            _print(s[4], out, ind + 1)
            out.append(f"{pad}}}")
        elif k == "if":
            out.append(f"{pad}if {_cc(s[1])} {{")
            _print(s[2], out, ind + 1)
            if s[3]:
                out.append(f"{pad}}} else {{")
                _print(s[3], out, ind + 1)
            out.append(f"{pad}}}")
        else:
            raise AssertionError(s)


# ---------------------------------------------------------------------------
# values while emitting
# ---------------------------------------------------------------------------


class _Val:
    """A value of the program while it is lowered: a float or int scalar
    (``elem`` the expression) or a 1-D container of ``n`` (``elem(i)`` the
    expression of element ``i``, an int expression); ``data`` when it reads
    no parameter and no local; ``host`` the value on the host where it is
    known when the source is written (literals, data ints: loop bounds)."""

    def __init__(self, is_int, n, elem, data, host=None, node=None, cname=None):
        self.is_int, self.n, self.elem, self.data, self.host = is_int, n, elem, data, host
        self.node = node  # the Stan expression, for folds evaluated on the host
        self.cname = cname  # a local's name in the source (what may be assigned)

    def at(self, i):
        return self.elem(i) if self.n is not None else self.elem


def _fold_ops(e):
    """``e`` with every operation on constants computed now, in float32 as
    the twin computes it (so that the text holds no arithmetic the twin
    would do in float64)."""
    k = e[0]
    if k in _FOPS or k in ("neg", "fma", "call"):
        args = e[2:] if k == "call" else e[1:]
        if all(a[0] == "c" for a in args):
            st = _TwinState(torch.zeros(1, 1), np.zeros(1, np.float32))
            return ("c", float(_fval(e, {}, st)))
    return e


def _c(v):
    return ("c", _f32(v))


def _op(k, *args):
    return _fold_ops((k, *args))


def _call(fn, a):
    return _fold_ops(("call", fn, a))


class _Emitter:
    def __init__(self, target):
        self.t = target
        self.values: list[float] = []
        self.syms: dict = {}
        self.loops: list = []  # enclosing for loops: (cname, lo, hi), bounds known now
        self.host_loop: dict = {}  # Stan loop variable -> its host value while folding
        self.n_names = 0
        self.stmts: list = []
        self.folded: dict = {}  # (expression, its loops) -> where fold_calls put it

    # -- plumbing ------------------------------------------------------

    def refuse(self, what, word=None):
        line = _line_of(self.t.source, word) if word else None
        where = f" (line {line})" if line else ""
        raise StanSubsetError(
            f"stan: {what}{where} is outside the subset of the language that is compiled "
            "to CUDA source for kernel K2 (models/stan_cuda.py)")

    def name(self, base):
        self.n_names += 1
        return f"v{self.n_names}_{re.sub(r'[^A-Za-z0-9_]', '_', base)}"

    def alloc(self, vals) -> int:
        off = len(self.values)
        self.values.extend(_f32(v) for v in np.asarray(vals, np.float64).reshape(-1))
        return off

    def emit(self, s):
        self.stmts.append(s)

    def block(self, fn):
        """The statements ``fn()`` emits, as a list."""
        saved, self.stmts = self.stmts, []
        try:
            fn()
            return self.stmts
        finally:
            self.stmts = saved

    # -- data and parameters ------------------------------------------

    def bind_data(self, name, v):
        if S._is_t(v):
            v = v.detach().cpu().numpy()
        a = np.asarray(v)
        if a.ndim > 1:
            self.refuse(f"the {a.ndim}-D data {name!r}", name)
        is_int = np.issubdtype(a.dtype, np.integer) or isinstance(v, (int, np.integer))
        if is_int and np.abs(a).max(initial=0) > MAX_EXACT_INT:
            raise StanSubsetError(
                f"stan: int data {name!r} holds a value beyond 2^24, which the float32 "
                "array of the CUDA source cannot hold exactly")
        if a.dtype == np.bool_:
            self.refuse(f"the bool data {name!r}", name)
        off = self.alloc(a)
        node = ("var", name)
        if a.ndim == 0:
            host = int(a) if is_int else None
            e = ("ia", off, ("ic", 0)) if is_int else ("a", off, ("ic", 0))
            self.syms[name] = _Val(is_int, None, e, True, host, node)
        else:
            kind = "ia" if is_int else "a"
            self.syms[name] = _Val(is_int, a.shape[0], lambda i, off=off, kind=kind: (kind, off, i),
                                   True, None, node)

    def bind_param(self, spec):
        """The constrained value of ``spec`` (the state itself where the
        transform is the identity, else a local array), its log-jacobian
        added to ``lj`` element by element."""
        if spec.kind not in ("real", "vector", "row_vector") or len(spec.shape) > 1:
            self.refuse(f"the {spec.kind} parameter {spec.name!r}", spec.name)
        n = spec.shape[0] if spec.shape else None
        for bound in (spec.lower, spec.upper):
            if S._is_t(bound) and bound.requires_grad:
                self.refuse(f"a parameter-dependent bound of {spec.name!r}", spec.name)
        if spec.identity:
            self.syms[spec.name] = _Val(False, n, (lambda i: ("x", spec.off, i)) if n
                                        else ("x", spec.off, ("ic", 0)), False)
            return
        size = n or 1
        lo = None if spec.lower is None else np.broadcast_to(S._host(spec.lower), (size,))
        hi = None if spec.upper is None else np.broadcast_to(S._host(spec.upper), (size,))
        cname = self.name(spec.name)
        self.emit(("decl", cname, size))
        i = self.name("e")
        u, ii = ("x", spec.off, ("iv", i)), ("iv", i)
        if lo is not None and hi is not None:
            # x = lo + width sigmoid(u); log|J| = log(width) + log_sigmoid(u) + log_sigmoid(-u)
            width = hi.astype(np.float64) - lo.astype(np.float64)
            lo_off, w_off = self.alloc(lo), self.alloc(width)
            lw_off = self.alloc(f32math.log(torch.tensor(width.astype(np.float32))).numpy())
            val = _op("+", ("a", lo_off, ii), _op("*", ("a", w_off, ii), _call("sigmoid", u)))
            lj = _op("+", _op("+", ("a", lw_off, ii), ("neg", _call("softplus", ("neg", u)))),
                     ("neg", _call("softplus", u)))
        elif lo is not None:
            val, lj = _op("+", ("a", self.alloc(lo), ii), _call("exp", u)), u
        else:
            val, lj = _op("-", ("a", self.alloc(hi), ii), _call("exp", u)), u
        self.emit(("for", i, ("ic", 0), ("ic", size - 1),
                   [("sete", cname, ii, val), ("set", "lj", ("+", ("v", "lj"), lj))]))
        self.syms[spec.name] = _Val(False, n, (lambda j: ("ve", cname, j)) if n
                                    else ("ve", cname, ("ic", 0)), False)

    # -- expressions ---------------------------------------------------

    def fe(self, v, i=None):
        """Float expression of ``v`` (element ``i`` of a container)."""
        e = v.at(i) if v.n is not None else v.elem
        if not v.is_int:
            return e
        return _c(e[1]) if e[0] == "ic" else ("i2f", e)

    def expr(self, node):
        v = self._expr(node)
        if v.data and v.node is None:
            v = _Val(v.is_int, v.n, v.elem, v.data, v.host, node)
        return v

    def _expr(self, node):
        k = node[0]
        if k == "num":
            v = node[1]
            if isinstance(v, int):
                return _Val(True, None, ("ic", v), True, v)
            return _Val(False, None, _c(v), True)
        if k == "var":
            if node[1] not in self.syms:
                raise NameError(f"stan: undefined variable {node[1]!r}")
            return self.syms[node[1]]
        if k == "bin":
            return self.arith(node[1], self.expr(node[2]), self.expr(node[3]), node)
        if k == "unary":
            v = self.expr(node[2])
            if node[1] == "!":
                self.refuse("'!' outside a condition", "!")
            if node[1] == "+":
                return v
            if v.is_int:
                return self.arith("-", _Val(True, None, ("ic", 0), True, 0), v, node)
            return self.map(v, lambda e: _op("neg", e))
        if k in ("cmp", "and", "or"):
            self.refuse("a comparison used as a value", None)
        if k == "ternary":
            c = self.cond(node[1])
            a, b = self.expr(node[2]), self.expr(node[3])
            if a.n is not None or b.n is not None:
                self.refuse("a ternary of containers", "?")
            return _Val(False, None, ("sel", c, self.fe(a), self.fe(b)), False)
        if k == "index":
            return self.index(node)
        if k == "transpose":
            v = self.expr(node[1])
            return v
        if k == "call":
            return self.call(node[1], node[2])
        self.refuse(f"the expression {node[0]!r}")

    def map(self, v, fn, data=None):
        """``fn`` of each element of ``v`` (a float result)."""
        data = v.data if data is None else data
        if v.n is None:
            return _Val(False, None, fn(self.fe(v)), data)
        return _Val(False, v.n, lambda i: fn(self.fe(v, i)), data)

    def zip(self, vals, fn, what):
        """``fn`` of the elements of ``vals`` at each index, scalars
        broadcast; the containers must have one length."""
        ns = {v.n for v in vals if v.n is not None}
        if len(ns) > 1:
            self.refuse(f"{what} of containers of lengths {sorted(ns)}")
        n = ns.pop() if ns else None
        data = all(v.data for v in vals)
        if n is None:
            return _Val(False, None, fn(*(self.fe(v) for v in vals)), data)
        return _Val(False, n, lambda i: fn(*(self.fe(v, i) for v in vals)), data)

    def arith(self, op, a, b, node):
        if a.is_int and b.is_int and op in ("+", "-", "*", "/", "%"):
            if a.n is not None or b.n is not None:
                self.refuse("int container arithmetic", None)
            iop = {"+": "i+", "-": "i-", "*": "i*", "/": "i/", "%": "i%"}[op]
            host = None
            if a.host is not None and b.host is not None:
                host = _IOPS[iop](a.host, b.host)
            return _Val(True, None, (iop, a.elem, b.elem), a.data and b.data, host)
        if op == "^":
            if not (b.is_int and b.host == 2 and b.n is None):
                self.refuse("'^' with another exponent than the literal 2 (powf)", "^")
            return self.map(a, lambda e: _op("*", e, e))
        if op == "%" or op == "\\":
            self.refuse(f"the operator {op!r} on reals", op)
        if op == "*" and a.n is not None and b.n is not None:
            self.refuse("'*' of two containers (matrix algebra)", "*")
        fop = {"+": "+", "-": "-", "*": "*", "/": "/", ".*": "*", "./": "/"}[op]
        return self.zip([a, b], lambda x, y: _op(fop, x, y), f"{op!r}")

    def cond(self, node):
        k = node[0]
        if k == "cmp":
            a, b = self.expr(node[2]), self.expr(node[3])
            if a.n is not None or b.n is not None:
                self.refuse("a comparison of containers", None)
            if a.is_int and b.is_int:
                return ("cmp", node[1], a.elem, b.elem)
            return ("cmp", node[1], self.fe(a), self.fe(b))
        if k in ("and", "or"):
            return (k, self.cond(node[1]), self.cond(node[2]))
        if k == "unary" and node[1] == "!":
            return ("not", self.cond(node[2]))
        v = self.expr(node)
        if v.n is not None:
            self.refuse("a container used as a condition", None)
        if v.is_int:
            return ("cmp", "!=", v.elem, ("ic", 0))
        return ("cmp", "!=", self.fe(v), ("c", 0.0))

    def index(self, node):
        base = self.expr(node[1])
        items = node[2]
        if len(items) != 1 or (isinstance(items[0], tuple) and items[0][0] == "irange"):
            self.refuse("a multi-index or range index", "[")
        idx = self.expr(items[0])
        if base.n is None:
            self.refuse("an index into a scalar", "[")
        if not idx.is_int:
            self.refuse("an index that is not an int", "[")
        data = base.data and idx.data
        if idx.n is None:
            return _Val(base.is_int, None, base.elem(("i-", idx.elem, ("ic", 1))), data)
        return _Val(base.is_int, idx.n, lambda i: base.elem(("i-", idx.elem(i), ("ic", 1))), data)

    # -- calls ---------------------------------------------------------

    def call(self, name, arg_nodes):
        if name in self.t._ev.functions:
            self.refuse(f"the user-defined function {name!r}", name)
        if name.endswith("_lpdf") or name.endswith("_lpmf"):
            if name[:-5] not in _TERMS:
                self.refuse(f"the density {name[:-5]!r}", name)
            args = [self.expr(a) for a in arg_nodes]
            return self.sum(self.density(name[:-5], args[0], args[1:], name))
        unary = {"exp": "exp", "log": "log", "log1p": "log1p", "expm1": "expm1",
                 "sqrt": "sqrt", "tanh": "tanh", "inv_logit": "sigmoid",
                 "logistic_sigmoid": "sigmoid", "log1p_exp": "softplus", "fabs": "fabs"}
        if name in ("num_elements", "size", "rows"):
            v = self.expr(arg_nodes[0])
            n = 1 if v.n is None else v.n
            return _Val(True, None, ("ic", n), True, n)
        args = [self.expr(a) for a in arg_nodes]
        if name in unary and len(args) == 1:
            return self.map(args[0], lambda e: _call(unary[name], e))
        if name == "abs" and len(args) == 1 and not args[0].is_int:
            return self.map(args[0], lambda e: _call("fabs", e))
        if name == "log1m" and len(args) == 1:
            return self.map(args[0], lambda e: _call("log1p", _op("neg", e)))
        if name == "square" and len(args) == 1:
            if args[0].is_int:
                return self.arith("*", args[0], args[0], None)
            return self.map(args[0], lambda e: _op("*", e, e))
        if name == "inv" and len(args) == 1:
            return self.map(args[0], lambda e: _op("/", _c(1.0), e))
        if name == "logit" and len(args) == 1:
            return self.map(args[0], lambda e: _op("-", _call("log", e),
                                                   _call("log1p", _op("neg", e))))
        if name == "log_inv_logit" and len(args) == 1:
            return self.map(args[0], lambda e: _op("neg", _call("softplus", _op("neg", e))))
        if name == "log1m_inv_logit" and len(args) == 1:
            return self.map(args[0], lambda e: _op("neg", _call("softplus", e)))
        if name in ("sum", "mean", "dot_self") and len(args) == 1:
            v = args[0]
            if name == "dot_self":
                v = self.map(v, lambda e: _op("*", e, e))
            s = self.sum(v)
            if name == "mean":
                return _Val(False, None, _op("/", self.fe(s), _c(v.n or 1)), s.data)
            return s
        if name == "rep_vector" and len(args) == 2:
            if args[1].host is None:
                self.refuse("rep_vector of a length that is not data", name)
            v = args[0]
            return _Val(v.is_int, args[1].host, lambda i: v.elem, v.data)
        if name in ("log_sum_exp", "log_mix"):
            if name == "log_mix" and len(args) == 3:
                th, la, lb = (self.fe(a) for a in args)
                a = _op("+", _call("log", th), la)
                b = _op("+", _call("log1p", _op("neg", th)), lb)
            elif len(args) == 2 and all(v.n is None for v in args):
                a, b = (self.fe(v) for v in args)
            else:
                self.refuse(f"{name} of containers", name)
            return self.logaddexp(a, b)
        if name in ("lgamma", "tgamma") and len(args) == 1:
            out = self.fold(lambda v: S._lgamma(1.0 * S._L(v)), args, name)
            return out if name == "lgamma" else self.map(out, lambda e: _call("exp", e))
        if name in ("lchoose", "lbeta") and len(args) == 2:
            fn = S._MATH_FNS[name]
            return self.fold(fn, args, name)
        self.refuse(f"the function {name!r}", name)

    def logaddexp(self, a, b):
        """``max + log1p(exp(-|a - b|))``, ``a + b`` where ``a - b`` is NaN
        (the torch form's logaddexp), on two temporaries."""
        ta, tb = self.name("la"), self.name("lb")
        self.emit(("decl", ta, None))
        self.emit(("decl", tb, None))
        self.emit(("set", ta, a))
        self.emit(("set", tb, b))
        va, vb = ("v", ta), ("v", tb)
        d = ("-", va, vb)
        out = ("+", ("sel", ("cmp", ">", va, vb), va, vb),
               ("call", "log1p", ("call", "exp", ("neg", ("call", "fabs", d)))))
        return _Val(False, None, ("sel", ("cmp", "!=", d, d), ("+", va, vb), out), False)

    def sum(self, v):
        """The in-order sum of ``v``'s elements (from 0), a new local."""
        if v.n is None:
            return v
        s, i = self.name("sum"), self.name("e")
        self.emit(("decl", s, None))
        self.emit(("for", i, ("ic", 0), ("ic", v.n - 1),
                   [("set", s, ("+", ("v", s), self.fe(v, ("iv", i))))]))
        return _Val(False, None, ("v", s), False)

    # -- folds: lgamma of data, on the host ------------------------------

    def fold(self, fn, args, what):
        """``fn`` of data values, computed now on the host with the torch
        form's operations, for every iteration of the enclosing loops (and
        every element); the results go into the array."""
        for v in args:
            if not v.data:
                self.refuse(f"{what} of a parameter (lgamma has no device form)", what)
        ev = S._Evaluator(self.t._blocks.get("functions", []))
        n = None
        for v in args:
            n = v.n if v.n is not None else n
        m = n or 1
        ranges = [range(lo, hi + 1) for _, _, lo, hi in self.loops]
        blocks = []
        for combo in _product(ranges):
            env = dict(self.t._data_env)
            env.update(self.host_loop)
            env.update({name: i for (name, _, _, _), i in zip(self.loops, combo)})
            with torch.no_grad():
                out = fn(*(ev.eval_expr(v.node, env) for v in args))
            blocks.append(np.broadcast_to(S._host(out).astype(np.float32), (m,)))
        off = self.alloc(np.concatenate(blocks) if blocks else np.zeros(0))
        it = ("ic", 0)
        stride = 1
        for _, cname, lo, hi in reversed(self.loops):
            it = ("i+", it, ("i*", ("i-", ("iv", cname), ("ic", lo)), ("ic", stride)))
            stride *= hi - lo + 1
        base = ("i*", it, ("ic", m))
        if n is None:
            return _Val(False, None, ("a", off, base), True)
        return _Val(False, n, lambda i: ("a", off, ("i+", base, i)), True)

    # -- folds: device functions of data, on the host --------------------

    def fold_calls(self, stmts, loops=()):
        """``stmts`` with every largest sub-expression that calls a device
        function on values of the array alone (``-log(sigma[j])``) read from
        the array instead, where it was computed now for every iteration of
        the loops it reads, with the twin's float32 operations: the same
        bits, and the kernel does not compute it at each query."""
        out = []
        for s in stmts:
            k = s[0]
            if k == "for":
                assert s[2][0] == "ic" and s[3][0] == "ic", s
                out.append(s[:4] + (self.fold_calls(s[4], loops + ((s[1], s[2][1], s[3][1]),)),))
            elif k == "if":
                out.append(("if", self.fold_e(s[1], loops), self.fold_calls(s[2], loops),
                            self.fold_calls(s[3], loops)))
            elif k == "decl":
                out.append(s)
            else:
                out.append(s[:-1] + (self.fold_e(s[-1], loops),))
        return out

    def fold_e(self, e, loops):
        k = e[0]
        if k in INT_KINDS or k in _LEAVES:
            return e
        if k not in _CONDS and _has_call(e) and not _reads_state(e):
            return self.fold_value(e, loops)
        return tuple(self.fold_e(a, loops) if isinstance(a, tuple) else a for a in e)

    def fold_value(self, e, loops):
        names = set()
        _loop_vars(e, names)
        used = [loop for loop in loops if loop[0] in names]
        key = (e, tuple(used))
        if key in self.folded:
            return self.folded[key]
        grids = np.meshgrid(*(np.arange(lo, hi + 1) for _, lo, hi in used), indexing="ij")
        m = int(np.prod([hi - lo + 1 for _, lo, hi in used]))
        st = _FoldState(np.asarray(self.values, np.float32),
                        {name: g.reshape(-1) for (name, _, _), g in zip(used, grids)})
        with torch.no_grad():
            off = self.alloc(torch.broadcast_to(_fval(e, {}, st), (m,)).numpy())
        idx, stride = None, 1
        for name, lo, hi in reversed(used):
            term = ("iv", name) if lo == 0 else ("i-", ("iv", name), ("ic", lo))
            term = term if stride == 1 else ("i*", term, ("ic", stride))
            idx = term if idx is None else ("i+", idx, term)
            stride *= hi - lo + 1
        self.folded[key] = ("a", off, idx or ("ic", 0))
        return self.folded[key]

    # -- densities -----------------------------------------------------

    def density(self, dist, y, args, word):
        """The log density's terms, one for each element (scalars
        broadcast), written as the torch form's ``_DENSITIES`` entry."""
        if dist not in _TERMS:
            self.refuse(f"the density {dist!r}", word)
        fold_fn, term = _TERMS[dist]
        vals = [y, *args]
        if len(vals) != term.__code__.co_argcount - (fold_fn is not None):
            raise SyntaxError(f"stan: {dist} takes {term.__code__.co_argcount - 1} arguments")
        if fold_fn is not None:
            vals = vals + [self.fold(S._lifted(fold_fn), [vals[i] for i in _FOLD_ARGS[dist]],
                                     f"the {dist} density's lgamma")]
        return self.zip(vals, term, dist)

    # -- statements ----------------------------------------------------

    def add_target(self, v):
        s = self.sum(v)
        self.emit(("set", "tgt", ("+", ("v", "tgt"), self.fe(s))))

    def stmts_(self, stmts, scoped=True):
        """Lower ``stmts``; the names they declare go out of scope after
        them unless ``scoped`` is false (a program block's)."""
        saved = dict(self.syms)
        try:
            for s in stmts:
                self.stmt(s)
        finally:
            if scoped:
                self.syms = saved

    def stmt(self, s):
        k = s[0]
        if k == "nop":
            return
        if k == "block":
            self.stmts_(s[1])
            return
        if k == "decl":
            self.decl(s)
            return
        if k == "assign":
            self.assign(s[1], s[2], self.expr(s[3]))
            return
        if k == "reject":
            self.emit(("set", "tgt", ("+", ("v", "tgt"), ("c", -math.inf))))
            return
        if k == "target":
            self.add_target(self.expr(s[1]))
            return
        if k == "sample":
            if len(s) > 4 and s[4] is not None:
                self.refuse("a truncated sampling statement T[,] (its log CDF has no device "
                            "form)", "T")
            dist = s[2][:-5] if s[2].endswith(("_lpdf", "_lpmf")) else s[2]
            if dist not in _TERMS:
                self.refuse(f"the density {dist!r}", s[2])
            y = self.expr(s[1])
            args = [self.expr(a) for a in s[3]]
            self.add_target(self.density(dist, y, args, s[2]))
            return
        if k == "for":
            self.for_(s)
            return
        if k == "if":
            c = self.cond(s[1])
            then = self.block(lambda: self.stmts_(s[2]))
            other = self.block(lambda: self.stmts_(s[3]))
            self.emit(("if", c, then, other))
            return
        words = {"while": "while", "break": "break", "continue": "continue", "return": "return"}
        self.refuse(f"the statement {k!r}", words.get(k))

    def decl(self, s):
        _, name, base, adims, edims, lower, upper, init = s
        if base not in ("real", "vector", "row_vector") or len(adims) + len(edims) > 1:
            self.refuse(f"the local {base} {name!r}", name)
        dims = adims + edims
        n = None
        if dims:
            nv = self.expr(dims[0])
            if nv.host is None:
                self.refuse(f"the size of {name!r}, which is not data", name)
            n = nv.host
        cname = self.name(name)
        self.emit(("decl", cname, n))
        self.syms[name] = _Val(False, n, (lambda i: ("ve", cname, i)) if n is not None
                               else ("v", cname), False, cname=cname)
        if init is not None:
            self.assign(("var", name), "=", self.expr(init))

    def assign(self, lv, op, val):
        if lv[0] == "var":
            target, idx = self.syms.get(lv[1]), None
        elif lv[0] == "index" and lv[1][0] == "var" and len(lv[2]) == 1:
            target, idx = self.syms.get(lv[1][1]), self.expr(lv[2][0])
            if not idx.is_int or idx.n is not None:
                self.refuse("an assignment through a non-int or container index", lv[1][1])
        else:
            self.refuse("this assignment's left-hand side", None)
        if target is None or target.cname is None:
            self.refuse(f"an assignment to {lv!r}, which is not a local", None)
        cname = target.cname
        aug = {"+=": "+", "-=": "-", "*=": "*", "/=": "/"}.get(op)

        def rhs(cur, new):
            return new if aug is None else _op(aug, cur, new)

        if idx is not None:
            i = ("i-", idx.elem, ("ic", 1))
            if val.n is not None:
                self.refuse("a container assigned to an element", lv[1][1])
            self.emit(("sete", cname, i, rhs(("ve", cname, i), self.fe(val))))
        elif target.n is None:
            if val.n is not None:
                self.refuse("a container assigned to a real", lv[1])
            self.emit(("set", cname, rhs(("v", cname), self.fe(val))))
        else:
            if val.n is not None and val.n != target.n:
                self.refuse("an assignment of containers of other lengths", lv[1])
            i = self.name("e")
            ii = ("iv", i)
            new = self.fe(val, ii) if val.n is not None else self.fe(val)
            self.emit(("for", i, ("ic", 0), ("ic", target.n - 1),
                       [("sete", cname, ii, rhs(("ve", cname, ii), new))]))

    def for_(self, s):
        _, var, lo_n, hi_n, body = s
        lo, hi = self.expr(lo_n), self.expr(hi_n)
        if lo.host is None or hi.host is None:
            self.refuse("a loop bound that is not data", "for")
        if self.vectorized(s, lo.host, hi.host):
            return
        cname = self.name(var)
        saved = self.syms.get(var)
        self.syms[var] = _Val(True, None, ("iv", cname), True, None, ("var", var))
        self.loops.append((var, cname, lo.host, hi.host))
        try:
            inner = self.block(lambda: self.stmts_(body))
        finally:
            self.loops.pop()
            if saved is None:
                self.syms.pop(var, None)
            else:
                self.syms[var] = saved
        self.emit(("for", cname, ("ic", lo.host), ("ic", hi.host), inner))

    def vectorized(self, s, lo, hi):
        """The loop as the torch form's ``_vectorized_for`` takes it: its
        sampling statements once, the loop variable the vector ``lo..hi``,
        where that form vectorizes it (its shape-only guard included)."""
        _, var, _, _, body = s
        n = hi - lo + 1
        if n < 32 or not body or any(st[0] != "sample" or (len(st) > 4 and st[4] is not None)
                                     for st in body):
            return False
        saved = self.syms.get(var)
        self.syms[var] = _Val(True, n, lambda i: ("i+", i, ("ic", lo)), True, None, ("var", var))
        self.host_loop[var] = np.arange(lo, hi + 1)
        try:
            terms = []
            for st in body:
                dist = st[2][:-5] if st[2].endswith(("_lpdf", "_lpmf")) else st[2]
                if dist not in S._DENSITIES:
                    return False
                vals = [self.expr(st[1]), *(self.expr(a) for a in st[3])]
                if not all(v.n in (None, n) for v in vals):
                    return False
                terms.append((dist, vals, st[2]))
            total = self.name("vec")
            self.emit(("decl", total, None))
            for dist, vals, word in terms:
                s_ = self.sum(self.density(dist, vals[0], vals[1:], word))
                self.emit(("set", total, ("+", ("v", total), self.fe(s_))))
            self.emit(("set", "tgt", ("+", ("v", "tgt"), ("v", total))))
            return True
        finally:
            self.host_loop.pop(var, None)
            if saved is None:
                self.syms.pop(var, None)
            else:
                self.syms[var] = saved


_LEAVES = frozenset(("c", "a", "x", "v", "ve", "i2f"))
_CONDS = frozenset(("cmp", "and", "or", "not"))


def _reads_state(e) -> bool:
    """Whether the expression or condition ``e`` reads the state or a local."""
    if e[0] in ("x", "v", "ve"):
        return True
    if e[0] in INT_KINDS or e[0] in _LEAVES:
        return False
    return any(_reads_state(a) for a in e[1:] if isinstance(a, tuple))


def _has_call(e) -> bool:
    if e[0] == "call":
        return True
    if e[0] in INT_KINDS or e[0] in _LEAVES:
        return False
    return any(_has_call(a) for a in e[1:] if isinstance(a, tuple))


def _loop_vars(e, out):
    """Add the loop variables that ``e`` reads to ``out``."""
    if e[0] == "iv":
        out.add(e[1])
    for a in e[1:]:
        if isinstance(a, tuple):
            _loop_vars(a, out)


def _product(ranges):
    out = [()]
    for r in ranges:
        out = [c + (i,) for c in out for i in r]
    return out


def _line_of(text, word):
    """The 1-based line of ``word``'s first use in ``text`` outside
    comments, or None."""
    if not word:
        return None
    pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(word) + r"(?![A-Za-z0-9_])")
    for i, line in enumerate(text.splitlines(), 1):
        if pat.search(line.split("//")[0]):
            return i
    return None


# -- the densities' terms, as the torch form writes them ---------------------

_HALF = math.log(2.0 * math.pi) * 0.5


def _neg(a):
    return _op("neg", a)


def _log_sigmoid(a):
    return _neg(_call("softplus", _neg(a)))


def _normal(y, mu, s):
    z = _op("/", _op("-", y, mu), s)
    return _op("-", _op("-", _op("*", _c(-0.5), _op("*", z, z)), _call("log", s)), _c(_HALF))


def _binomial(n, N, p, lchoose):
    return _op("+", _op("+", lchoose, _op("*", n, _call("log", p))),
               _op("*", _op("-", N, n), _call("log1p", _neg(p))))


def _binomial_logit(n, N, a, lchoose):
    return _op("+", _op("+", lchoose, _op("*", n, _log_sigmoid(a))),
               _op("*", _op("-", N, n), _log_sigmoid(_neg(a))))


def _logistic(y, mu, s):
    z = _op("/", _op("-", y, mu), s)
    return _op("-", _op("-", _neg(z), _call("log", s)),
               _op("*", _c(2.0), _call("softplus", _neg(z))))


def _uniform(y, a, b):
    inside = ("and", ("cmp", ">=", y, a), ("cmp", "<=", y, b))
    return ("sel", inside, _neg(_call("log", _op("-", b, a))), ("c", -math.inf))


def _student_t(y, nu, mu, s, lg):
    z = _op("/", _op("-", y, mu), s)
    half = _op("/", _op("+", nu, _c(1.0)), _c(2.0))
    return _op("-", _op("-", _op("-", lg, _op("*", _c(0.5), _call("log", _op("*", nu, _c(math.pi))))),
                        _call("log", s)),
               _op("*", half, _call("log1p", _op("/", _op("*", z, z), nu))))


# each density: (its constant, computed on the host from data, or None;
# the term of (y, *args[, constant]))
_TERMS = {
    "normal": (None, _normal),
    "std_normal": (None, lambda y: _normal(y, _c(0.0), _c(1.0))),
    "cauchy": (None, lambda y, mu, s: _neg(_call("log", _op(
        "*", _op("*", _c(math.pi), s),
        _op("+", _c(1.0), _op("*", _op("/", _op("-", y, mu), s), _op("/", _op("-", y, mu), s))))))),
    "beta": (lambda a, b: S._lgamma(1.0 * a) + S._lgamma(1.0 * b) - S._lgamma(1.0 * (a + b)),
             lambda y, a, b, lbeta: _op("-", _op("+", _op("*", _op("-", a, _c(1.0)), _call("log", y)),
                                                 _op("*", _op("-", b, _c(1.0)), _call("log1p", _neg(y)))),
                                        lbeta)),
    "bernoulli": (None, lambda y, t: _op("+", _op("*", y, _call("log", t)),
                                         _op("*", _op("-", _c(1.0), y), _call("log1p", _neg(t))))),
    "bernoulli_logit": (None, lambda y, a: _op("+", _op("*", y, _log_sigmoid(a)),
                                               _op("*", _op("-", _c(1.0), y), _log_sigmoid(_neg(a))))),
    "binomial": (lambda n, N: (S._lgamma(1.0 + N) - S._lgamma(1.0 + n)
                                  - S._lgamma(1.0 + N - n)), _binomial),
    "binomial_logit": (lambda n, N: (S._lgamma(1.0 + N) - S._lgamma(1.0 + n)
                                        - S._lgamma(1.0 + N - n)), _binomial_logit),
    "uniform": (None, _uniform),
    "exponential": (None, lambda y, r: _op("-", _call("log", r), _op("*", r, y))),
    "lognormal": (None, lambda y, mu, s: _op("-", _normal(_call("log", y), mu, s), _call("log", y))),
    "student_t": (lambda nu: S._lgamma((nu + 1.0) / 2.0) - S._lgamma(nu / 2.0),
                  _student_t),
    "gamma": (lambda a: S._lgamma(1.0 * a),
              lambda y, a, b, lg: _op("-", _op("+", _op("-", _op("*", a, _call("log", b)), lg),
                                               _op("*", _op("-", a, _c(1.0)), _call("log", y))),
                                      _op("*", b, y))),
    "inv_gamma": (lambda a: S._lgamma(1.0 * a),
                  lambda y, a, b, lg: _op("-", _op("-", _op("-", _op("*", a, _call("log", b)), lg),
                                                   _op("*", _op("+", a, _c(1.0)), _call("log", y))),
                                          _op("/", b, y))),
    "poisson": (lambda k: S._lgamma(k + 1.0),
                lambda k, lam, lg: _op("-", _op("-", _op("*", k, _call("log", lam)), lam), lg)),
    "poisson_log": (lambda k: S._lgamma(k + 1.0),
                    lambda k, a, lg: _op("-", _op("-", _op("*", k, a), _call("exp", a)), lg)),
    "double_exponential": (None, lambda y, mu, s: _op(
        "-", _op("/", _neg(_call("fabs", _op("-", y, mu))), s), _call("log", _op("*", _c(2.0), s)))),
    "logistic": (None, _logistic),
    "chi_square": (lambda nu: S._lgamma(0.5 * nu),
                   lambda y, nu, lg: _op("-", _op("-", _op("-", _op(
                       "*", _op("-", _op("*", _c(0.5), nu), _c(1.0)), _call("log", y)),
                       _op("*", _c(0.5), y)), _op("*", _op("*", _c(0.5), nu), _c(math.log(2.0)))), lg)),
}
# which of (y, *args) each constant reads: the data its fold needs
_FOLD_ARGS = {"beta": (1, 2), "binomial": (0, 1), "binomial_logit": (0, 1),
              "student_t": (1,), "gamma": (1,), "inv_gamma": (1,), "poisson": (0,),
              "poisson_log": (0,), "chi_square": (1,)}


_HOOK_HEAD = """using namespace pigeons;

// A Stan model's log density (propto=false, with the constraint jacobians),
// written by pigeons_tpu_torch/models/stan_cuda.py. A: the model's values.
__device__ float pigeons_user_target(const float* x, int d, const float* params,
                                     const DensityArrays& arrays) {
  const float* A = arrays.ptr[0];
"""


def emit_source(target) -> DeviceSource:
    """``target``'s log density as a ``DeviceSource`` of hook ``"target"``
    (raises :class:`StanSubsetError` outside the subset)."""
    em = _Emitter(target)
    if target._blocks.get("functions"):
        em.refuse("a functions block (user-defined functions)", "functions")
    for name, v in target._data_env.items():
        em.bind_data(name, v)
    em.emit(("decl", "lj", None))
    em.emit(("decl", "tgt", None))
    for spec in target._params:
        em.bind_param(spec)
    em.stmts_(target._blocks.get("transformed parameters", []), scoped=False)
    em.stmts_(target._blocks.get("model", []), scoped=False)
    em.emit(("ret", ("+", ("v", "tgt"), ("v", "lj"))))
    stmts = em.fold_calls(em.stmts)
    lines = []
    _print(stmts, lines, 1)
    code = _HOOK_HEAD + "\n".join(lines) + "\n}\n"
    values = torch.tensor(em.values if em.values else [0.0], dtype=torch.float32)
    return DeviceSource(code, "target", _Twin(stmts), arrays=(values,))
