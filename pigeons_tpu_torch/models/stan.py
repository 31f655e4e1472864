"""Real ``.stan`` ingestion: a Stan-subset front end compiled to torch.

Counterpart of ``pigeons_tpu/models/stan.py``. The reference compiles
``.stan`` files through BridgeStan's C++; the JAX package compiles the Stan
language itself into a traced ``jnp`` density, and this module compiles the
same parsed program into a torch density: one ``log_density(x [..., d])``
(``propto=false`` plus the change-of-variables jacobian, BridgeStan's
convention) that the runtime evaluates over all lanes at once and
differentiates with autograd for ``AutoMALA``, the default explorer.

The tokenizer and parser are the JAX package's, unchanged, so both packages
build equal ASTs. The evaluator walks the AST as the JAX one does and keeps
its semantics: data are numpy values (Python arithmetic among them runs in
float64, as it does there), a value that meets a parameter becomes a float32
tensor (float data) or an int64 tensor (int data), as a numpy array becomes a
float32 / int32 array in a JAX run, and ``if`` on a parameter is a ``where``
blend with the double-``where`` sanitization of the untaken branch, so that
autograd gives no NaN gradient where ``jax.grad`` gives a finite one. The
per-state density is batched with ``torch.func.vmap``, the counterpart of the
JAX runtime's ``jax.vmap``.

Arithmetic follows the JAX package's XLA forms where they matter: ``exp``,
``log``, ``log1p``, ``expm1`` and ``lgamma`` are :mod:`..f32math`'s (XLA's
Cephes polynomials and Lanczos sum), ``sigmoid`` / ``softplus`` those of
:mod:`.distributions`; the special functions are ``torch.special``'s, and
``betainc`` (which torch lacks) is :func:`betainc` below. Sums are torch's,
whose order is not XLA's: densities agree within float32 tolerance.

Supported language: that of the JAX package (its module docstring); its
three faults are kept, so that the port gives the JAX package's results:
``_vectorized_for`` takes a loop body as vectorizable by its operands'
shapes alone; ``rep_matrix`` of a 1-D value tiles it as columns, whatever
its row/column type; ``_lcdf_uniform`` floors the probability at 1e-38.

For kernel K2, :mod:`.stan_cuda` emits a model in the scalar subset of the
language as CUDA source beside its torch form (``StanTarget.device_source``);
:class:`StanTarget` records why a model outside it has none
(``device_refusal``), which ``SliceSamplerCUDA`` names when it refuses it.
"""

from __future__ import annotations

import contextlib
import json
import math
import operator
import re
from typing import Any, Optional

import numpy as np
import torch

from .. import f32math, rng
from .distributions import log_sigmoid as _log_sigmoid_t
from .distributions import sigmoid as _sigmoid_t
from .distributions import softplus as _softplus_t
from .target import Reference, Target

# ---------------------------------------------------------------------------
# values: numpy data and torch tensors
# ---------------------------------------------------------------------------

# the device that tensors made from data go to during an evaluation
_DEVICE = [torch.device("cpu")]


@contextlib.contextmanager
def _on(device):
    prev = _DEVICE[0]
    _DEVICE[0] = torch.device(device)
    try:
        yield
    finally:
        _DEVICE[0] = prev


def _is_t(v) -> bool:
    return isinstance(v, torch.Tensor)


def _T(v, dtype=None):
    """``v`` as a tensor on the evaluation's device: float data as float32,
    int data as int64, bools as bool (a JAX run's canonical types)."""
    if _is_t(v):
        return v if dtype is None or v.dtype == dtype else v.to(dtype)
    a = np.asarray(v)
    if dtype is None:
        if a.dtype == np.bool_:
            dtype = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dtype = torch.int64
        else:
            dtype = torch.float32
    return torch.as_tensor(a, device=_DEVICE[0]).to(dtype)


def _F(v):
    """``v`` as a float32 tensor."""
    return _T(v, torch.float32) if not (_is_t(v) and v.is_floating_point()) else v


def _L(v):
    """An operand for a torch expression: tensors stay, numpy and Python
    scalars become Python scalars (torch's weak scalars, as JAX's), numpy
    arrays tensors."""
    if _is_t(v):
        return v
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    a = np.asarray(v)
    if a.ndim == 0:
        return _L(a.item())
    return _T(a)


def _lifted(fn):
    """``fn`` with its arguments made operands of torch expressions."""

    def call(*args):
        return fn(*(_L(a) for a in args))

    call.__name__ = fn.__name__
    return call


def _arith(op, a, b):
    """``op(a, b)``: numpy semantics between data, torch's where a tensor
    takes part."""
    if _is_t(a) or _is_t(b):
        return op(_L(a), _L(b))
    return op(a, b)


def _where(c, a, b):
    return torch.where(_T(c, torch.bool), _L(a), _L(b))


def _shape(v) -> tuple:
    return tuple(v.shape) if _is_t(v) else np.shape(v)


_FOLDS: dict = {}
_FOLD_MAX_SIZE = 4096


def _folded(fn):
    """``fn`` of a data value computed once and kept, as XLA folds a
    function of constants when it compiles the JAX package's density: the
    result (a float32 tensor on the evaluation's device) is the same, and a
    density that calls ``lgamma`` of its data is not slowed by it."""

    def call(v):
        if _is_t(v):
            return fn(v)
        a = np.asarray(v)
        if a.size > _FOLD_MAX_SIZE:
            return fn(v)
        key = (fn.__name__, a.dtype.str, a.shape, a.tobytes(), str(_DEVICE[0]))
        out = _FOLDS.get(key)
        if out is None:
            if len(_FOLDS) > 65536:
                _FOLDS.clear()
            with torch.no_grad():
                out = _FOLDS[key] = fn(v)
        return out

    call.__name__ = fn.__name__
    return call


@_folded
def _exp(v):
    return f32math.exp(_F(v))


@_folded
def _log(v):
    return f32math.log(_F(v))


@_folded
def _log1p(v):
    return f32math.log1p(_F(v))


@_folded
def _expm1(v):
    return f32math.expm1(_F(v))


@_folded
def _lgamma(v):
    """``jax.lax.lgamma`` in float32: :func:`f32math.lgamma` (XLA's Lanczos
    sum) from 0.5 on, torch's below, where XLA reflects the argument."""
    x = _F(v)
    big = x >= 0.5
    lo = torch.lgamma(torch.where(big, torch.full_like(x, 0.25), x))
    return torch.where(big, f32math.lgamma(torch.where(big, x, torch.ones_like(x))), lo)


@f32math.elementwise_vmap
class _Tanh(torch.autograd.Function):
    """XLA's float32 ``tanh`` (``f32math._tanh``, its rational form), with
    ``jax.grad``'s rule ``g (1 + tanh) (1 - tanh)``."""

    @staticmethod
    def forward(x):
        return f32math._tanh(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return (g + g * y) * (1.0 - y)


def _tanh(v):
    x = _F(v)
    return _Tanh.apply(x) if f32math.needs_grad(x) else f32math._tanh(x)


def _sigmoid(v):
    return _sigmoid_t(_F(v))


def _log_sigmoid(v):
    return _log_sigmoid_t(_F(v))


def _softplus(v):
    return _softplus_t(_F(v))


def _logaddexp(a, b):
    """``jnp.logaddexp``: ``max + log1p(exp(-|a - b|))`` (``a + b`` where
    ``a - b`` is NaN) from the differentiable :mod:`..f32math` forms."""
    a, b = torch.broadcast_tensors(_F(a), _F(b))
    delta = a - b
    out = torch.maximum(a, b) + f32math.log1p(f32math.exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), a + b, out)


def _logsumexp(v, dim=None):
    """``jax.nn.logsumexp``: the max, held constant, plus the log of the
    sum of the shifted exps."""
    v = _F(v)
    m = (v.amax() if dim is None else v.amax(dim)).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = _exp(v - m).sum() if dim is None else _exp(v - m.unsqueeze(dim)).sum(dim)
    return _log(s) + m


def _softmax(v):
    v = _F(v)
    e = _exp(v - v.amax(-1, keepdim=True).detach())
    return e / e.sum(-1, keepdim=True)


def _log_softmax(v):
    v = _F(v)
    shifted = v - v.amax(-1, keepdim=True).detach()
    return shifted - _log(_exp(shifted).sum(-1, keepdim=True))


def _norm_logcdf(x, loc=0.0, scale=1.0):
    """``jax.scipy.stats.norm.logcdf``: ``log_ndtr((x - loc) / scale)``."""
    return torch.special.log_ndtr(_F(_arith(operator.truediv, _arith(operator.sub, x, loc),
                                            scale)))


def _float_sum(v):
    return _F(v).sum()


# ---------------------------------------------------------------------------
# the regularized incomplete beta function (torch has none)
# ---------------------------------------------------------------------------

_BETAINC_ITERS = 300


def _betainc_cf(a, b, x):
    """The continued fraction of ``I_x(a, b)`` (Lentz's method, as in
    Numerical Recipes ``betacf``), in float64, a fixed number of terms."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    d = 1.0 / d
    h = d
    for m in range(1, _BETAINC_ITERS + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
    return h


def _betainc64(a, b, x):
    """``I_x(a, b)`` in float64, by the continued fraction on the side of
    the mean where it converges fast, the symmetry ``1 - I_{1-x}(b, a)`` on
    the other."""
    xs = x.clamp(0.0, 1.0)
    lbeta = torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
    inner = (xs > 0) & (xs < 1)
    xi = torch.where(inner, xs, torch.full_like(xs, 0.5))
    front = torch.exp(lbeta + a * torch.log(xi) + b * torch.log1p(-xi))
    direct = xi < (a + 1.0) / (a + b + 2.0)
    fa = torch.where(direct, a, b)
    fb = torch.where(direct, b, a)
    fx = torch.where(direct, xi, 1.0 - xi)
    cf = _betainc_cf(fa, fb, fx)
    val = torch.where(direct, front * cf / a, 1.0 - front * cf / b)
    val = torch.where(xs <= 0, torch.zeros_like(val), torch.where(xs >= 1, torch.ones_like(val), val))
    bad = (a <= 0) | (b <= 0) | torch.isnan(x)
    return torch.where(bad, torch.full_like(val, float("nan")), val)


@f32math.elementwise_vmap
class _Betainc(torch.autograd.Function):
    """``jax.scipy.special.betainc(a, b, x)`` in float32. The value is the
    float64 continued fraction rounded once; the gradient in ``x`` is the
    beta density, and ``a`` and ``b`` get none (``jax.grad`` has no rule
    for them either)."""

    @staticmethod
    def forward(a, b, x):
        return _betainc64(a.double(), b.double(), x.double()).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b, x = (v.double() for v in ctx.saved_tensors)
        lbeta = torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
        dens = torch.exp(lbeta + (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x))
        gx = (g.double() * dens).to(g.dtype)
        gx = gx if gx.shape == ctx.saved_tensors[2].shape else gx.sum_to_size(
            ctx.saved_tensors[2].shape)
        return None, None, gx


def betainc(a, b, x):
    """The regularized incomplete beta function ``I_x(a, b)`` on float32
    operands (broadcast), held to ``jax.scipy.special.betainc`` on a grid
    with both tails (``tests/test_torch_stan_lang.py``)."""
    a, b, x = torch.broadcast_tensors(_F(a), _F(b), _F(x))
    return _Betainc.apply(a, b, x)


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>//[^\n]*|\#[^\n]*|/\*.*?\*/)
  | (?P<str>"[^"\n]*")
  | (?P<num>((\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?))
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\.\*|\./|<=|>=|==|!=|\+=|-=|\*=|/=|&&|\|\||[-+*/^<>=!?:;,(){}\[\]|~%.'\\])
  | (?P<ws>\s+)
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(src: str):
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise SyntaxError(f"stan: cannot tokenize at: {src[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup in ("comment", "ws"):
            continue
        tokens.append((m.lastgroup, m.group()))
    tokens.append(("eof", ""))
    return tokens


# ---------------------------------------------------------------------------
# parser -> tuple AST
# ---------------------------------------------------------------------------

_BLOCKS = (
    "functions",
    "data",
    "transformed data",
    "parameters",
    "transformed parameters",
    "model",
    "generated quantities",
)

_TYPES = ("int", "real", "vector", "row_vector", "matrix", "array", "void")

# constrained container types (Stan reference manual ch. 10 transforms)
_SPECIAL_VEC = ("simplex", "ordered", "positive_ordered", "unit_vector")
_SPECIAL_MAT = (
    "cov_matrix",
    "corr_matrix",
    "cholesky_factor_corr",
    "cholesky_factor_cov",
)
_TYPE_KEYWORDS = (
    "int",
    "real",
    "vector",
    "row_vector",
    "matrix",
    "array",
) + _SPECIAL_VEC + _SPECIAL_MAT


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise SyntaxError(f"stan: expected {val!r}, got {t[1]!r}")
        return t

    def accept(self, val):
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # -- program ---------------------------------------------------------

    def parse_program(self):
        blocks = {}
        while self.peek()[0] != "eof":
            name = self.next()[1]
            if name == "transformed" or name == "generated":
                name = name + " " + self.next()[1]
            if name not in _BLOCKS:
                raise SyntaxError(f"stan: unknown block {name!r}")
            self.expect("{")
            if name == "functions":
                blocks[name] = self.parse_functions()
            elif name in ("data", "parameters"):
                blocks[name] = self.parse_decls_only()
            else:
                blocks[name] = self.parse_stmts()
            self.expect("}")
        return blocks

    def parse_functions(self):
        funcs = []
        while self.peek()[1] != "}":
            ret_type = self.next()[1]
            name = self.next()[1]
            self.expect("(")
            params = []
            while self.peek()[1] != ")":
                ptype = self.next()[1]
                if ptype == "array":  # array[] real x
                    self.expect("[")
                    while self.peek()[1] != "]":
                        self.next()
                    self.expect("]")
                    ptype = "array " + self.next()[1]
                pname = self.next()[1]
                params.append((ptype, pname))
                if self.peek()[1] == ",":
                    self.next()
            self.expect(")")
            self.expect("{")
            body = self.parse_stmts()
            self.expect("}")
            funcs.append((name, ret_type, params, body))
        return funcs

    def parse_decls_only(self):
        decls = []
        while self.peek()[1] != "}":
            decls.extend(self.parse_decl())
        return decls

    # -- declarations ----------------------------------------------------

    def _parse_constraint(self):
        lower = upper = None
        if self.accept("<"):
            while True:
                kind = self.next()[1]
                self.expect("=")
                # additive precedence: ">" must close the constraint, not
                # parse as a comparison
                e = self.parse_add()
                if kind == "lower":
                    lower = e
                elif kind == "upper":
                    upper = e
                else:
                    raise SyntaxError(f"stan: unsupported constraint {kind!r}")
                if not self.accept(","):
                    break
            self.expect(">")
        return lower, upper

    def _parse_type(self):
        """One (possibly array-of-container) type spec ->
        ``(kind, array_dims, elem_dims, lower, upper)``."""
        base = self.next()[1]
        array_dims = []
        if base == "array":
            self.expect("[")
            array_dims.append(self.parse_expr())
            while self.accept(","):
                array_dims.append(self.parse_expr())
            self.expect("]")
            base = self.next()[1]
        lower = upper = None
        elem_dims = []
        if base in ("int", "real"):
            lower, upper = self._parse_constraint()
        elif base in ("vector", "row_vector"):
            lower, upper = self._parse_constraint()
            self.expect("[")
            elem_dims.append(self.parse_expr())
            self.expect("]")
        elif base == "matrix":
            lower, upper = self._parse_constraint()
            self.expect("[")
            elem_dims.append(self.parse_expr())
            self.expect(",")
            elem_dims.append(self.parse_expr())
            self.expect("]")
        elif base in _SPECIAL_VEC:
            self.expect("[")
            elem_dims.append(self.parse_expr())
            self.expect("]")
        elif base in _SPECIAL_MAT:
            self.expect("[")
            elem_dims.append(self.parse_expr())
            if self.accept(","):
                elem_dims.append(self.parse_expr())
            self.expect("]")
        else:
            raise SyntaxError(f"stan: unsupported type {base!r}")
        return base, tuple(array_dims), tuple(elem_dims), lower, upper

    def parse_decl(self):
        """One declaration statement, possibly with multiple names and
        initializers; returns a list of ('decl', name, kind, array_dims,
        elem_dims, lower, upper, init) nodes."""
        kind, adims, edims, lower, upper = self._parse_type()
        out = []
        while True:
            name = self.next()[1]
            init = None
            if self.accept("="):
                init = self.parse_expr()
            out.append(("decl", name, kind, adims, edims, lower, upper, init))
            if not self.accept(","):
                break
        self.expect(";")
        return out

    # -- statements ------------------------------------------------------

    def parse_stmts(self):
        stmts = []
        while self.peek()[1] not in ("}",) and self.peek()[0] != "eof":
            stmts.extend(self.parse_stmt())
        return stmts

    def parse_stmt(self):
        t = self.peek()
        v = t[1]
        if v == "{":
            self.next()
            body = self.parse_stmts()
            self.expect("}")
            return [("block", body)]
        if v == "for":
            self.next()
            self.expect("(")
            var = self.next()[1]
            self.expect("in")
            lo = self.parse_expr()
            self.expect(":")
            hi = self.parse_expr()
            self.expect(")")
            body = self.parse_stmt()
            return [("for", var, lo, hi, body)]
        if v == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            body = self.parse_stmt()
            return [("while", cond, body)]
        if v == "break":
            self.next()
            self.expect(";")
            return [("break",)]
        if v == "continue":
            self.next()
            self.expect(";")
            return [("continue",)]
        if v == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            other = []
            if self.accept("else"):
                other = self.parse_stmt()
            return [("if", cond, then, other)]
        if v == "return":
            self.next()
            e = None
            if self.peek()[1] != ";":
                e = self.parse_expr()
            self.expect(";")
            return [("return", e)]
        if v in ("print", "reject"):
            self.next()
            depth = 0
            while not (depth == 0 and self.peek()[1] == ";"):
                tv = self.next()[1]
                depth += tv == "("
                depth -= tv == ")"
            self.expect(";")
            # print is a no-op; reject() zeroes the density (Stan: the draw
            # is rejected — in a density evaluation that is target = -inf)
            return [("reject",)] if v == "reject" else [("nop",)]
        if v == "target":
            self.next()
            self.expect("+=")
            e = self.parse_expr()
            self.expect(";")
            return [("target", e)]
        # declaration? (type keywords are reserved words in Stan)
        if v in _TYPE_KEYWORDS and self.peek(1)[1] != "(":
            return self.parse_decl()
        # expression statement: lvalue op expr | expr ~ dist(...)
        e = self.parse_expr()
        nxt = self.next()[1]
        if nxt == "~":
            dist = self.next()[1]
            self.expect("(")
            args = self.parse_args(")")
            # optional truncation T[a, b] / T[a, ] / T[, b]
            trunc = None
            if self.peek()[1] == "T":
                self.next()
                self.expect("[")
                lo = None if self.peek()[1] == "," else self.parse_expr()
                self.expect(",")
                hi = None if self.peek()[1] == "]" else self.parse_expr()
                self.expect("]")
                trunc = (lo, hi)
            self.expect(";")
            return [("sample", e, dist, args, trunc)]
        if nxt in ("=", "+=", "-=", "*=", "/="):
            rhs = self.parse_expr()
            self.expect(";")
            return [("assign", e, nxt, rhs)]
        if nxt == ";":
            return [("nop",)]
        raise SyntaxError(f"stan: unexpected {nxt!r} after expression")

    def parse_args(self, closer):
        args = []
        if self.peek()[1] != closer:
            args.append(self.parse_expr())
            while self.peek()[1] in (",", "|"):
                self.next()
                args.append(self.parse_expr())
        self.expect(closer)
        return args

    # -- expressions -----------------------------------------------------

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        c = self.parse_or()
        if self.accept("?"):
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_expr()
            return ("ternary", c, a, b)
        return c

    def parse_or(self):
        e = self.parse_and()
        while self.accept("||"):
            e = ("or", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_cmp()
        while self.accept("&&"):
            e = ("and", e, self.parse_cmp())
        return e

    def parse_cmp(self):
        e = self.parse_add()
        while self.peek()[1] in ("<", "<=", ">", ">=", "==", "!="):
            op = self.next()[1]
            e = ("cmp", op, e, self.parse_add())
        return e

    def parse_add(self):
        e = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            e = ("bin", op, e, self.parse_mul())
        return e

    def parse_mul(self):
        e = self.parse_unary()
        while self.peek()[1] in ("*", "/", "%", ".*", "./", "\\"):
            op = self.next()[1]
            e = ("bin", op, e, self.parse_unary())
        return e

    def parse_unary(self):
        if self.peek()[1] in ("-", "+", "!"):
            op = self.next()[1]
            return ("unary", op, self.parse_unary())
        return self.parse_pow()

    def parse_pow(self):
        e = self.parse_postfix()
        if self.accept("^"):
            return ("bin", "^", e, self.parse_unary())
        return e

    def parse_postfix(self):
        t = self.next()
        if t[1] == "(":
            e = self.parse_expr()
            self.expect(")")
        elif t[0] == "num":
            v = t[1]
            e = ("num", int(v) if re.fullmatch(r"\d+", v) else float(v))
        elif t[0] == "name":
            if self.peek()[1] == "(":
                self.next()
                args = self.parse_args(")")
                e = ("call", t[1], args)
            else:
                e = ("var", t[1])
        else:
            raise SyntaxError(f"stan: unexpected token {t[1]!r}")
        while self.peek()[1] == "[":
            self.next()
            idx = [self.parse_index_item()]
            while self.accept(","):
                idx.append(self.parse_index_item())
            self.expect("]")
            e = ("index", e, tuple(idx))
        if self.accept("'"):
            e = ("transpose", e)
        return e

    def parse_index_item(self):
        """One multi-index item: expr | expr:expr | expr: | :expr | :
        (Stan range indexing, reference manual 'multiple indexing')."""
        if self.peek()[1] == ":":
            self.next()
            if self.peek()[1] in (",", "]"):
                return ("irange", None, None)
            return ("irange", None, self.parse_expr())
        e = self.parse_expr()
        if self.accept(":"):
            if self.peek()[1] in (",", "]"):
                return ("irange", e, None)
            return ("irange", e, self.parse_expr())
        return e




# ---------------------------------------------------------------------------
# densities (full constants: propto=false, matching the reference's choice
# "to get correct log normalization constants", interface.jl:64-69)
# ---------------------------------------------------------------------------

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@_lifted
def _lpdf_normal(y, mu, sigma):
    return -0.5 * ((y - mu) / sigma) ** 2 - _log(sigma) - _HALF_LOG_2PI


@_lifted
def _lpdf_cauchy(y, mu, sigma):
    return -_log(math.pi * sigma * (1.0 + ((y - mu) / sigma) ** 2))


@_lifted
def _lpdf_beta(y, a, b):
    lbeta = _lgamma(1.0 * a) + _lgamma(1.0 * b) - _lgamma(1.0 * (a + b))
    return (a - 1.0) * _log(y) + (b - 1.0) * _log1p(-y) - lbeta


@_lifted
def _lpmf_bernoulli(y, theta):
    return y * _log(theta) + (1.0 - y) * _log1p(-theta)


@_lifted
def _lpmf_binomial(n, N, p):
    lchoose = _lgamma(1.0 + N) - _lgamma(1.0 + n) - _lgamma(1.0 + N - n)
    return lchoose + n * _log(p) + (N - n) * _log1p(-p)


@_lifted
def _lpdf_uniform(y, a, b):
    inside = _T(y >= a) & _T(y <= b)
    return _where(inside, -_log(b - a), -math.inf)


@_lifted
def _lpdf_exponential(y, rate):
    return _log(rate) - rate * y


@_lifted
def _lpdf_lognormal(y, mu, sigma):
    return _lpdf_normal(_log(y), mu, sigma) - _log(y)


@_lifted
def _lpdf_student_t(y, nu, mu, sigma):
    z = (y - mu) / sigma
    return (
        _lgamma((nu + 1.0) / 2.0)
        - _lgamma(nu / 2.0)
        - 0.5 * _log(nu * math.pi)
        - _log(sigma)
        - (nu + 1.0) / 2.0 * _log1p(z * z / nu)
    )


@_lifted
def _lpdf_gamma(y, alpha, beta):
    return alpha * _log(beta) - _lgamma(1.0 * alpha) + (alpha - 1.0) * _log(y) - beta * y


@_lifted
def _lpdf_inv_gamma(y, alpha, beta):
    return alpha * _log(beta) - _lgamma(1.0 * alpha) - (alpha + 1.0) * _log(y) - beta / y


@_lifted
def _lpmf_poisson(k, lam):
    return k * _log(lam) - lam - _lgamma(k + 1.0)


@_lifted
def _lpdf_double_exponential(y, mu, sigma):
    return -_F(abs(y - mu)) / sigma - _log(2.0 * sigma)


@_lifted
def _lpdf_logistic(y, mu, sigma):
    z = (y - mu) / sigma
    return -z - _log(sigma) - 2.0 * _softplus(-z)


@_lifted
def _lpdf_chi_square(y, nu):
    return (0.5 * nu - 1.0) * _log(y) - 0.5 * y - 0.5 * nu * math.log(2.0) - _lgamma(0.5 * nu)


@_lifted
def _lpdf_weibull(y, alpha, sigma):
    z = y / sigma
    return _log(alpha / sigma) + (alpha - 1.0) * _log(z) - _F(z) ** alpha


@_lifted
def _lpdf_pareto(y, y_min, alpha):
    return _log(alpha) + alpha * _log(y_min) - (alpha + 1.0) * _log(y)


@_lifted
def _lpmf_neg_binomial_2(n, mu, phi):
    lchoose = _lgamma(n + phi) - _lgamma(n + 1.0) - _lgamma(1.0 * phi)
    return lchoose + n * (_log(mu) - _log(mu + phi)) + phi * (_log(phi) - _log(mu + phi))


@_lifted
def _lpmf_poisson_log(k, alpha):
    return k * alpha - _exp(alpha) - _lgamma(k + 1.0)


@_lifted
def _lpmf_binomial_logit(n, N, alpha):
    lchoose = _lgamma(1.0 + N) - _lgamma(1.0 + n) - _lgamma(1.0 + N - n)
    return lchoose + n * _log_sigmoid(alpha) + (N - n) * _log_sigmoid(-alpha)


@_lifted
def _lpmf_neg_binomial_2_log(n, eta, phi):
    # mu = exp(eta); log(mu + phi) = logaddexp(eta, log phi), fully in logs
    lse = _logaddexp(eta, _log(phi))
    lchoose = _lgamma(n + phi) - _lgamma(n + 1.0) - _lgamma(1.0 * phi)
    return lchoose + n * (eta - lse) + phi * (_log(phi) - lse)


def _ordered_interval_logprob(a_log_upper, b_log_upper):
    """log(exp(a) - exp(b)) for log-CDF-style upper tails a >= b, with
    b = -inf handled exactly (gradient-safe)."""
    neg = torch.isneginf(b_log_upper)
    diff = torch.where(neg, torch.ones_like(b_log_upper), -_expm1(b_log_upper - a_log_upper))
    return a_log_upper + _log(diff)


def _ordinal_inputs(y, eta, c):
    c = _F(c)
    y = _T(y, torch.int64).reshape(-1)
    eta = _F(eta).reshape(-1).expand(y.shape)
    big = torch.full((1,), math.inf, dtype=c.dtype, device=c.device)
    return y, eta, torch.cat([-big, c, big])


def _lpmf_ordered_logistic(y, eta, c):
    """y in 1..K with K-1 ordered cutpoints (Stan functions reference):
    P(y=k) = sigmoid(eta - c_{k-1}) - sigmoid(eta - c_k), c_0 = -inf,
    c_K = +inf. Vectorizes over arrays of (y, eta)."""
    y, eta, c_ext = _ordinal_inputs(y, eta, c)
    a = _log_sigmoid(eta - c_ext[y - 1])  # log upper-tail at c_{k-1}
    b = _log_sigmoid(eta - c_ext[y])  # log upper-tail at c_k
    return torch.sum(_ordered_interval_logprob(a, b))


def _lpmf_ordered_probit(y, eta, c):
    y, eta, c_ext = _ordinal_inputs(y, eta, c)
    # upper tail 1 - Phi(c - eta) = Phi(eta - c)
    a = _norm_logcdf(eta - c_ext[y - 1])
    b = _norm_logcdf(eta - c_ext[y])
    return torch.sum(_ordered_interval_logprob(a, b))


@_lifted
def _lpdf_von_mises(y, mu, kappa):
    # log I0 via the exponentially-scaled Bessel: log(i0e) + kappa
    log_i0 = _log(torch.special.i0e(_F(kappa))) + kappa
    return kappa * torch.cos(_F(y - mu)) - math.log(2.0 * math.pi) - log_i0


# -- multivariate densities (match Stan's normalization, propto=false) ------


def _betaln(a, b):
    return _lgamma(1.0 * a) + _lgamma(1.0 * b) - _lgamma(1.0 * _arith(operator.add, a, b))


def _rows_of(y, K):
    """View y as [n_rows, K] (Stan vectorizes multivariate densities over
    arrays of vectors)."""
    return _F(y).reshape(-1, K)


def _cholesky(m):
    """``jnp.linalg.cholesky``: NaN where the matrix is not positive
    definite (torch would raise)."""
    L, info = torch.linalg.cholesky_ex(_F(m))
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, math.nan))


def _solve(A, B):
    X, info = torch.linalg.solve_ex(_F(A), _F(B))
    return X


def _inv(A):
    X, info = torch.linalg.inv_ex(_F(A))
    return X


def _slogdet(A):
    return torch.linalg.slogdet(_F(A))


def _solve_tri(L, B, lower=True):
    B = _F(B)
    vec = B.dim() == 1
    X = torch.linalg.solve_triangular(_F(L), B[:, None] if vec else B, upper=not lower)
    return X[:, 0] if vec else X


def _lpdf_multi_normal_cholesky(y, mu, L):
    L = _F(L)
    K = L.shape[-1]
    ys = _rows_of(y, K)
    mus = _F(mu).reshape(-1, K).expand(ys.shape)
    z = _solve_tri(L, (ys - mus).T, lower=True)
    n = ys.shape[0]
    return (
        -0.5 * torch.sum(z * z)
        - n * torch.sum(_log(torch.diagonal(L)))
        - 0.5 * n * K * math.log(2.0 * math.pi)
    )


def _lpdf_multi_normal(y, mu, Sigma):
    return _lpdf_multi_normal_cholesky(y, mu, _cholesky(Sigma))


def _lpdf_multi_normal_prec(y, mu, Omega):
    Omega = _F(Omega)
    K = Omega.shape[-1]
    ys = _rows_of(y, K)
    mus = _F(mu).reshape(-1, K).expand(ys.shape)
    d = ys - mus
    n = ys.shape[0]
    sign, logdet = _slogdet(Omega)
    quad = torch.sum(d * (d @ Omega))
    return -0.5 * quad + 0.5 * n * logdet - 0.5 * n * K * math.log(2.0 * math.pi)


def _lpdf_dirichlet(theta, alpha):
    alpha = _F(alpha)
    return (
        torch.sum((alpha - 1.0) * _log(theta))
        + _lgamma(torch.sum(alpha))
        - torch.sum(_lgamma(alpha))
    )


def _lkj_log_norm(K, eta):
    """log of the LKJ normalizing constant c_K(eta): the density over
    correlation matrices is c * det(R)^(eta-1). Via the C-vine construction
    (Lewandowski-Kurowicka-Joe): the canonical partial correlations of row i
    are iid scaled Beta(b_i, b_i) on (-1, 1) with b_i = eta + (K-1-i)/2, so
    c is the product of those (2^(2b-1) B(b,b))^-1 normalizers."""
    total = 0.0
    for i in range(1, K):
        b = _arith(operator.add, eta, (K - 1 - i) / 2.0)
        total = total - (K - i) * _arith(
            operator.add, _arith(operator.mul, 2.0 * b - 1.0, math.log(2.0)), _betaln(b, b))
    return total


def _lpdf_lkj_corr_cholesky(L, eta):
    L = _F(L)
    K = L.shape[-1]
    k = torch.arange(1, K + 1, device=L.device)
    pw = _L(K - k + 2.0 * _L(eta) - 2.0)  # exponent of L_kk (Stan math lkj_corr_cholesky)
    diag = torch.diagonal(L)
    lp = torch.sum(pw[1:] * _log(diag[1:]))
    return lp + _lkj_log_norm(K, eta)


def _lpdf_lkj_corr(R, eta):
    R = _F(R)
    K = R.shape[-1]
    sign, logdet = _slogdet(R)
    return _arith(operator.sub, eta, 1.0) * logdet + _lkj_log_norm(K, eta)


def _lpmf_categorical(y, theta):
    yi = _T(y, torch.int64) - 1
    return torch.sum(_log(theta)[yi])


def _lpmf_categorical_logit(y, beta):
    yi = _T(y, torch.int64) - 1
    return torch.sum(_log_softmax(beta)[yi])


def _lpmf_multinomial(y, theta):
    y = _T(y)
    return (
        _lgamma(torch.sum(y) + 1.0)
        - torch.sum(_lgamma(y + 1.0))
        + torch.sum(y * _log(theta))
    )


def _multigammaln(a, K):
    j = torch.arange(1, K + 1, device=_DEVICE[0], dtype=torch.float32)
    return K * (K - 1) / 4.0 * math.log(math.pi) + torch.sum(_lgamma(_L(a) + (1.0 - j) / 2.0))


def _lpdf_wishart(W, nu, S):
    S = _F(S)
    K = S.shape[-1]
    _, logdet_w = _slogdet(W)
    _, logdet_s = _slogdet(S)
    tr = torch.diagonal(_solve(S, W)).sum()
    nu = _L(nu)
    return (
        0.5 * (nu - K - 1.0) * logdet_w
        - 0.5 * tr
        - 0.5 * nu * K * math.log(2.0)
        - 0.5 * nu * logdet_s
        - _multigammaln(nu / 2.0, K)
    )


def _lpdf_inv_wishart(W, nu, S):
    S = _F(S)
    K = S.shape[-1]
    _, logdet_w = _slogdet(W)
    _, logdet_s = _slogdet(S)
    tr = torch.diagonal(_solve(W, S)).sum()
    nu = _L(nu)
    return (
        0.5 * nu * logdet_s
        - 0.5 * (nu + K + 1.0) * logdet_w
        - 0.5 * tr
        - 0.5 * nu * K * math.log(2.0)
        - _multigammaln(nu / 2.0, K)
    )


_DENSITIES = {
    "normal": _lpdf_normal,
    "std_normal": lambda y: _lpdf_normal(y, 0.0, 1.0),
    "cauchy": _lpdf_cauchy,
    "beta": _lpdf_beta,
    "bernoulli": _lpmf_bernoulli,
    "bernoulli_logit": _lifted(lambda y, a: y * _log_sigmoid(a) + (1.0 - y) * _log_sigmoid(-a)),
    "binomial": _lpmf_binomial,
    "uniform": _lpdf_uniform,
    "exponential": _lpdf_exponential,
    "lognormal": _lpdf_lognormal,
    "student_t": _lpdf_student_t,
    "gamma": _lpdf_gamma,
    "inv_gamma": _lpdf_inv_gamma,
    "poisson": _lpmf_poisson,
    "double_exponential": _lpdf_double_exponential,
    "logistic": _lpdf_logistic,
    "chi_square": _lpdf_chi_square,
    "weibull": _lpdf_weibull,
    "pareto": _lpdf_pareto,
    "neg_binomial_2": _lpmf_neg_binomial_2,
    "neg_binomial_2_log": _lpmf_neg_binomial_2_log,
    "poisson_log": _lpmf_poisson_log,
    "binomial_logit": _lpmf_binomial_logit,
    "von_mises": _lpdf_von_mises,
}


# log-CDFs for truncation (`y ~ dist(...) T[a, b]`) and the `_lcdf`/`_lccdf`
# call forms (Stan functions reference). Each returns the elementwise log CDF.
def _lcdf_normal(y, mu, sigma):
    return _norm_logcdf(y, mu, sigma)


@_lifted
def _lcdf_exponential(y, rate):
    return _log(-_expm1(-rate * y))


@_lifted
def _lcdf_uniform(y, a, b):
    # the JAX package clips to [1e-38, 1]; 1e-38 is a float32 subnormal,
    # which XLA flushes to 0: the clip is to [0, 1], the log CDF -inf below a
    # and its gradient NaN there, the clip's zero times the log's infinite
    # derivative (a reference fault, kept: the mask multiplies, as in JAX)
    r = _F((y - a) / (b - a))
    inside = ((r > 0.0) & (r < 1.0)).to(r.dtype)
    return _log(r * inside + torch.clamp(r, 0.0, 1.0).detach() * (1.0 - inside))


@_lifted
def _lcdf_cauchy(y, mu, sigma):
    return _log(0.5 + torch.atan(_F((y - mu) / sigma)) / math.pi)


@_lifted
def _lcdf_logistic(y, mu, sigma):
    return _log_sigmoid((y - mu) / sigma)


def _lcdf_lognormal(y, mu, sigma):
    return _norm_logcdf(_log(y), mu, sigma)


@_lifted
def _lcdf_gamma(y, alpha, beta):
    return _log(torch.special.gammainc(_F(1.0 * alpha), _F(beta * y)))


@_lifted
def _lcdf_chi_square(y, nu):
    return _log(torch.special.gammainc(_F(0.5 * nu), _F(0.5 * y)))


@_lifted
def _lcdf_weibull(y, alpha, sigma):
    return _log(-_expm1(-(_F(y / sigma) ** alpha)))


@_lifted
def _lcdf_beta(y, a, b):
    return _log(betainc(1.0 * a, 1.0 * b, y))


@_lifted
def _lcdf_student_t(y, nu, mu, sigma):
    # via the regularized incomplete beta (Abramowitz & Stegun 26.7.1)
    z = _F((y - mu) / sigma)
    x = nu / (nu + z * z)
    tail = 0.5 * betainc(0.5 * nu, 0.5, x)
    return _log(torch.where(z > 0, 1.0 - tail, tail))


@_lifted
def _lcdf_double_exponential(y, mu, sigma):
    z = _F((y - mu) / sigma)
    return torch.where(z < 0, math.log(0.5) + z, _log1p(-0.5 * _exp(-z)))


@_lifted
def _lcdf_pareto(y, y_min, alpha):
    return _log1p(-(_F(y_min / y) ** alpha))


_LCDFS = {
    "normal": _lcdf_normal,
    "std_normal": lambda y: _lcdf_normal(y, 0.0, 1.0),
    "exponential": _lcdf_exponential,
    "uniform": _lcdf_uniform,
    "cauchy": _lcdf_cauchy,
    "logistic": _lcdf_logistic,
    "lognormal": _lcdf_lognormal,
    "gamma": _lcdf_gamma,
    "chi_square": _lcdf_chi_square,
    "weibull": _lcdf_weibull,
    "beta": _lcdf_beta,
    "student_t": _lcdf_student_t,
    "double_exponential": _lcdf_double_exponential,
    "pareto": _lcdf_pareto,
}


def _truncation_term(dist, y, args, lo, hi):
    """log of the truncation normalizer P(lo <= Y <= hi) (per element,
    broadcast over vectorized y), plus the support indicator: Stan's
    ``T[a, b]`` subtracts log(F(b) - F(a)) and rejects draws outside."""
    if dist not in _LCDFS:
        raise SyntaxError(
            f"stan: truncation T[,] is not supported for {dist!r} "
            f"(no log-CDF; supported: {sorted(_LCDFS)})"
        )
    cdf = _LCDFS[dist]
    if lo is not None and hi is not None:
        lz = _log(torch.clamp(_exp(cdf(hi, *args)) - _exp(cdf(lo, *args)), 1e-38, 1.0))
        inside = _T(_arith(operator.ge, y, lo)) & _T(_arith(operator.le, y, hi))
    elif lo is not None:
        lz = _log1p(-_exp(cdf(lo, *args)))
        inside = _T(_arith(operator.ge, y, lo))
    elif hi is not None:
        lz = _F(cdf(hi, *args))
        inside = _T(_arith(operator.le, y, hi))
    else:
        return torch.zeros((), device=_DEVICE[0])
    return torch.sum(torch.where(inside, lz.expand(inside.shape), math.inf))


# multivariate/container densities: the whole statement contributes ONE
# scalar (no elementwise summation over y's last axis)
_MV_DENSITIES = {
    "multi_normal": _lpdf_multi_normal,
    "multi_normal_cholesky": _lpdf_multi_normal_cholesky,
    "multi_normal_prec": _lpdf_multi_normal_prec,
    "dirichlet": _lpdf_dirichlet,
    "lkj_corr_cholesky": _lpdf_lkj_corr_cholesky,
    "lkj_corr": _lpdf_lkj_corr,
    "categorical": _lpmf_categorical,
    "categorical_logit": _lpmf_categorical_logit,
    "multinomial": _lpmf_multinomial,
    "ordered_logistic": _lpmf_ordered_logistic,
    "ordered_probit": _lpmf_ordered_probit,
    "wishart": _lpdf_wishart,
    "inv_wishart": _lpdf_inv_wishart,
}


def _as_f(v):
    if isinstance(v, (int, bool)):
        return float(v)
    return v


def _full(shape, v):
    """``jnp.full(shape, v)``: a Python int fills an int array, a float a
    float32 one, a tensor is broadcast."""
    if _is_t(v):
        return v.expand(shape).clone() if shape else v
    v = _L(v)
    dtype = torch.int64 if isinstance(v, int) and not isinstance(v, bool) else torch.float32
    return torch.full(shape, v, dtype=dtype, device=_DEVICE[0])


def _rep_matrix(v, *ns):
    if len(ns) == 2:
        return _full((int(ns[0]), int(ns[1])), v)
    v = _L(v)
    # a 1-D value is tiled as columns whether it is a vector or a row_vector
    # (the JAX package's fault, kept: Stan tiles a row_vector as rows)
    if getattr(v, "ndim", 0) == 1:
        return v[:, None].repeat(1, int(ns[0]))
    return _T(v).repeat(int(ns[0]), 1)


def _index_arg(j):
    return int(j) if isinstance(j, (int, np.integer)) else _T(j, torch.int64) - 1


def _col(m, j):
    m = _L(m)
    return m[:, int(j) - 1] if isinstance(j, (int, np.integer)) else m[:, _index_arg(j)]


def _row(m, i):
    m = _L(m)
    return m[int(i) - 1] if isinstance(i, (int, np.integer)) else m[_index_arg(i)]


def _segment(v, i, n):
    return _L(v)[int(i) - 1: int(i) - 1 + int(n)]


def _append_row(a, b):
    return torch.cat([torch.atleast_1d(_F(a)), torch.atleast_1d(_F(b))], dim=0)


def _std(v, var=False):
    v = _F(v)
    out = v.var(correction=1) if var else v.std(correction=1)
    return out


def _cbrt(x):
    x = _F(x)
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _unary(fn):
    return lambda x: fn(_F(x))


def _binary(fn):
    return lambda a, b: fn(*torch.broadcast_tensors(_F(a), _F(b)))


_MATH_FNS = {
    "exp": _exp,
    "log": _log,
    "expm1": _expm1,
    "log1p": _log1p,
    "log1m": lambda x: _log1p(-_F(x)),
    "sqrt": _unary(torch.sqrt),
    "square": lambda x: x * x,
    "inv": lambda x: 1.0 / _as_f(x),
    "inv_logit": _sigmoid,
    "logit": lambda p: _log(p) - _log1p(-_F(p)),
    "pow": lambda a, b: _F(a) ** _L(b),
    "abs": lambda x: torch.abs(_T(x)),
    "fabs": lambda x: torch.abs(_T(x)),
    "fmin": lambda a, b: torch.minimum(*torch.broadcast_tensors(_T(a), _T(b))),
    "fmax": lambda a, b: torch.maximum(*torch.broadcast_tensors(_T(a), _T(b))),
    "sum": lambda x: _T(x).sum(),
    "mean": lambda x: _F(x).mean(),
    "dot_self": lambda x: torch.sum(_L(x) * _L(x)),
    "log1p_exp": _softplus,
    "log_sum_exp": lambda *a: (_logaddexp(*a) if len(a) == 2
                               else _logsumexp(torch.stack([_F(v) for v in a])
                                               if len(a) > 1 else a[0])),
    "machine_precision": lambda: float(np.finfo(np.float64).eps),
    "lgamma": lambda x: _lgamma(1.0 * _L(x)),
    "tgamma": lambda x: _exp(_lgamma(1.0 * _L(x))),
    "num_elements": lambda x: int(np.prod(_shape(x))) if _shape(x) else 1,
    "rows": lambda x: int(_shape(x)[0]),
    "cols": lambda x: int(_shape(x)[1]),
    "size": lambda x: int(_shape(x)[0]),
    "rep_vector": lambda v, n: _full((int(n),), v),
    "rep_row_vector": lambda v, n: _full((int(n),), v),
    "rep_array": lambda v, *ns: _full(tuple(int(n) for n in ns), v),
    # -- matrix / linear algebra builtins (Stan functions reference ch. 5-7;
    # the reference reaches these through BridgeStan's C++, interface.jl:120) --
    "rep_matrix": _rep_matrix,
    "diag_matrix": lambda v: torch.diag(_T(v)),
    "diagonal": lambda m: torch.diagonal(_T(m)),
    "identity_matrix": lambda n: torch.eye(int(n), device=_DEVICE[0]),
    "cholesky_decompose": _cholesky,
    "inverse": _inv,
    "inverse_spd": _inv,
    "determinant": lambda m: torch.linalg.det(_F(m)),
    "log_determinant": lambda m: _slogdet(m)[1],
    "trace": lambda m: torch.diagonal(_T(m)).sum(),
    "transpose": lambda m: _T(m).T,
    "quad_form": lambda A, B: _F(B).T @ _F(A) @ _F(B),
    "quad_form_diag": lambda A, v: _F(A) * (_F(v)[:, None] * _F(v)[None, :]),
    "quad_form_sym": lambda A, B: _F(B).T @ _F(A) @ _F(B),
    "diag_pre_multiply": lambda v, m: _F(v)[:, None] * _F(m),
    "diag_post_multiply": lambda m, v: _F(m) * _F(v)[None, :],
    "multiply_lower_tri_self_transpose": lambda L: torch.tril(_F(L)) @ torch.tril(_F(L)).T,
    "crossprod": lambda m: _F(m).T @ _F(m),
    "tcrossprod": lambda m: _F(m) @ _F(m).T,
    "mdivide_left_tri_low": lambda L, b: _solve_tri(torch.tril(_F(L)), b, lower=True),
    "mdivide_right_tri_low": lambda b, L: _solve_tri(torch.tril(_F(L)).T, _F(b).T,
                                                     lower=False).T,
    "mdivide_left": lambda A, b: _solve(A, b),
    "mdivide_right": lambda b, A: _solve(_F(A).T, _F(b).T).T,
    "dot_product": lambda a, b: torch.dot(_F(a).reshape(-1), _F(b).reshape(-1)),
    "rows_dot_product": lambda a, b: torch.sum(_F(a) * _F(b), dim=-1),
    "columns_dot_product": lambda a, b: torch.sum(_F(a) * _F(b), dim=0),
    "rows_dot_self": lambda a: torch.sum(_F(a) ** 2, dim=-1),
    "columns_dot_self": lambda a: torch.sum(_F(a) ** 2, dim=0),
    "to_vector": lambda m: (_T(m).T.reshape(-1) if getattr(_L(m), "ndim", 0) == 2
                            else _T(m).reshape(-1)),
    "to_row_vector": lambda m: _T(m).reshape(-1),
    "to_array_1d": lambda m: _T(m).reshape(-1),
    "to_matrix": lambda v, *ns: (_T(v).reshape(int(ns[1]), int(ns[0])).T
                                 if len(ns) == 2 else _T(v)),
    "col": _col,
    "row": _row,
    "head": lambda v, n: _L(v)[: int(n)],
    "tail": lambda v, n: _L(v)[-int(n):],
    "segment": _segment,
    "append_row": _append_row,
    "append_col": lambda a, b: torch.cat([_T(a), _T(b)], dim=-1),
    "softmax": _softmax,
    "log_softmax": _log_softmax,
    "cumulative_sum": lambda v: torch.cumsum(_T(v), 0),
    "reverse": lambda v: torch.flip(_T(v), dims=(0,)),
    "sort_asc": lambda v: torch.sort(_T(v)).values,
    "sort_desc": lambda v: -torch.sort(-_T(v)).values,
    "sd": lambda v: _std(v),
    "variance": lambda v: _std(v, var=True),
    "prod": lambda v: torch.prod(_T(v)),
    "distance": lambda a, b: torch.sqrt(torch.sum((_F(a) - _F(b)) ** 2)),
    "squared_distance": lambda a, b: torch.sum((_F(a) - _F(b)) ** 2),
    "norm2": lambda v: torch.sqrt(torch.sum(_F(v) ** 2)),
    "norm1": lambda v: torch.sum(torch.abs(_T(v))),
    # Stan overloads min/max: binary scalar form AND container reduction
    "min": lambda *a: (_T(a[0]).min() if len(a) == 1
                       else torch.minimum(*torch.broadcast_tensors(_T(a[0]), _T(a[1])))),
    "max": lambda *a: (_T(a[0]).max() if len(a) == 1
                       else torch.maximum(*torch.broadcast_tensors(_T(a[0]), _T(a[1])))),
    "floor": _unary(torch.floor),
    "ceil": _unary(torch.ceil),
    "sin": _unary(torch.sin),
    "cos": _unary(torch.cos),
    "tan": _unary(torch.tan),
    "atan": _unary(torch.atan),
    "exp2": _unary(torch.exp2),
    "log2": _unary(torch.log2),
    "log10": _unary(torch.log10),
    # -- additional scalar/special functions common in applied Stan --------
    "asin": _unary(torch.asin),
    "acos": _unary(torch.acos),
    "sinh": _unary(torch.sinh),
    "cosh": _unary(torch.cosh),
    "tanh": _tanh,
    "asinh": _unary(torch.asinh),
    "acosh": _unary(torch.acosh),
    "atanh": _unary(torch.atanh),
    "atan2": _binary(torch.atan2),
    "hypot": _binary(torch.hypot),
    "cbrt": _cbrt,
    "round": _unary(torch.round),
    "trunc": _unary(torch.trunc),
    "fdim": lambda a, b: torch.clamp_min(_F(_arith(operator.sub, a, b)), 0.0),
    "fmod": _binary(torch.fmod),
    "erf": _unary(torch.special.erf),
    "erfc": _unary(torch.special.erfc),
    "Phi": _unary(torch.special.ndtr),
    "Phi_approx": lambda x: _sigmoid(0.07056 * _F(x) ** 3 + 1.5976 * _F(x)),
    "inv_Phi": _unary(torch.special.ndtri),
    "std_normal_lcdf": _norm_logcdf,
    "digamma": _unary(torch.special.digamma),
    "trigamma": lambda x: torch.special.polygamma(1, _F(x)),
    "log_inv_logit": _log_sigmoid,
    "log1m_inv_logit": lambda x: _log_sigmoid(-_F(x)),
    "inv_cloglog": lambda x: -_expm1(-_exp(x)),
    "cloglog": lambda p: _log(-_log1p(-_F(p))),
    "log1m_exp": lambda x: _log(-_expm1(x)),  # x < 0
    "log_diff_exp": lambda a, b: _L(a) + _log(-_expm1(_arith(operator.sub, b, a))),
    "lmultiply": lambda a, b: _where(_T(_L(a) == 0), 0.0, _L(a) * _log(b)),
    "lchoose": lambda n, k: (_lgamma(1.0 + _L(n)) - _lgamma(1.0 + _L(k))
                             - _lgamma(1.0 + _L(n) - _L(k))),
    "lbeta": lambda a, b: _betaln(_L(a), _L(b)),
    "log_mix": lambda theta, la, lb: _logaddexp(_log(theta) + _L(la),
                                                _log1p(-_F(theta)) + _L(lb)),
    "logistic_sigmoid": _sigmoid,
    "step": lambda x: _where(_T(_L(x) >= 0), 1.0, 0.0),
    "int_step": lambda x: torch.where(_T(_L(x) > 0), 1, 0),
    "positive_infinity": lambda: math.inf,
    "negative_infinity": lambda: -math.inf,
    "not_a_number": lambda: math.nan,
    "is_nan": lambda x: torch.isnan(_T(x)),
    "is_inf": lambda x: torch.isinf(_T(x)),
}


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------


class _Return(Exception):
    """Raised for a top-level (unconditional) return."""

    def __init__(self, value):
        self.value = value


class _Break(Exception):
    """Raised for `break` under concrete (data-computable) control flow."""


class _Continue(Exception):
    """Raised for `continue` under concrete control flow."""


def _stan_mul(a, b, node_a, node_b):
    """Stan `*`: matrix algebra, not elementwise (`.*` is elementwise).

    Containers collapse to arrays without a row/column tag, so two 1-D
    operands are disambiguated syntactically: ``v * u'`` is an outer product,
    anything else (``x' * y``, ``row_vector * vector``) a dot product —
    Stan's type system only admits row*col and col*row for 1-D pairs."""
    an, bn = getattr(a, "ndim", 0), getattr(b, "ndim", 0)
    if an == 0 or bn == 0:
        return _arith(operator.mul, a, b)
    a, b = _F(a), _F(b)
    if an == 2 or bn == 2:
        return torch.matmul(a, b)
    if isinstance(node_b, tuple) and node_b[0] == "transpose":
        if not (isinstance(node_a, tuple) and node_a[0] == "transpose"):
            return torch.outer(a, b)  # v * u'
    return torch.dot(a, b)


def _mv_density_sum(dist, y, params):
    """Container densities contribute one scalar per statement (no implicit
    elementwise vectorization beyond what the density itself defines)."""
    return _MV_DENSITIES[dist](y, *params)


def _bool(v):
    """``v`` as a bool tensor, or a Python bool for a data condition."""
    return _T(v, torch.bool)


_CMP = {"<": operator.lt, "<=": operator.le, ">": operator.gt, ">=": operator.ge,
        "==": operator.eq, "!=": operator.ne}


class _Evaluator:
    """Tree-walking evaluator building torch expressions.

    ``if``/early-``return`` with tensor conditions compile to ``where``
    blends: statements execute both branches on copies of the environment
    and blend every modified variable; conditional returns accumulate as
    (condition, value) pairs resolved when the function exits. Conditions
    that are concrete Python values short-circuit to real branches."""

    def __init__(self, functions, rng=None):
        self.functions = {f[0]: f for f in functions}
        self.rng = rng  # np.random.Generator for *_rng (host extraction only)

    # -- expressions -----------------------------------------------------

    def eval_expr(self, node, env):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "var":
            if node[1] not in env:
                raise NameError(f"stan: undefined variable {node[1]!r}")
            return env[node[1]]
        if kind == "bin":
            op, a, b = node[1], self.eval_expr(node[2], env), self.eval_expr(node[3], env)
            if op == "+":
                return _arith(operator.add, a, b)
            if op == "-":
                return _arith(operator.sub, a, b)
            if op == "*":
                return _stan_mul(a, b, node[2], node[3])
            if op == "/":
                if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
                    # Stan int division truncates toward zero (C semantics),
                    # unlike Python's floor division: -3/2 == -1
                    q = abs(int(a)) // abs(int(b))
                    return -q if (a < 0) != (b < 0) else q
                if getattr(a, "ndim", 0) == 2 and getattr(b, "ndim", 0) == 2:
                    # matrix division A / B = A B^-1 (mdivide_right)
                    return _solve(_F(b).T, _F(a).T).T
                return _arith(operator.truediv, a, b)
            if op == "\\":
                # left division A \ b = A^-1 b (mdivide_left)
                return _solve(a, b)
            if op == "^":
                return _arith(operator.pow, _as_f(a), b)
            if op == "%":
                if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
                    # C semantics: result carries the sign of the dividend
                    return int(math.fmod(int(a), int(b)))
                return _arith(operator.mod, a, b)
            if op == ".*":
                return _arith(operator.mul, a, b)
            if op == "./":
                return _arith(operator.truediv, a, b)
        if kind == "unary":
            v = self.eval_expr(node[2], env)
            if node[1] == "-":
                return -v
            if node[1] == "!":
                return torch.logical_not(_T(v)) if hasattr(v, "dtype") else (not v)
            return v
        if kind == "cmp":
            op, a, b = node[1], self.eval_expr(node[2], env), self.eval_expr(node[3], env)
            return _arith(_CMP[op], a, b)
        if kind == "and":
            a = self.eval_expr(node[1], env)
            b = self.eval_expr(node[2], env)
            return torch.logical_and(_bool(a), _bool(b)) if _traced(a) or _traced(b) else (a and b)
        if kind == "or":
            a = self.eval_expr(node[1], env)
            b = self.eval_expr(node[2], env)
            return torch.logical_or(_bool(a), _bool(b)) if _traced(a) or _traced(b) else (a or b)
        if kind == "ternary":
            c = self.eval_expr(node[1], env)
            if isinstance(c, (bool, np.bool_)):
                return self.eval_expr(node[2] if c else node[3], env)
            # tensor condition: both branches are evaluated (Stan's C++ only
            # executes one), so sanitize inputs on untaken lanes — the
            # double-where trick — or inf/NaN in the dead branch would
            # poison gradients
            a = self.eval_expr(node[2], _mask_env(env, c))
            b = self.eval_expr(node[3], _mask_env(env, torch.logical_not(_bool(c))))
            return _where(c, a, b)
        if kind == "index":
            base = self.eval_expr(node[1], env)
            idx = tuple(self._eval_index_item(i, env) for i in node[2])
            return _index(base, idx if len(idx) > 1 else idx[0])
        if kind == "transpose":
            v = self.eval_expr(node[1], env)
            return _T(v).T if hasattr(v, "ndim") and v.ndim > 1 else v
        if kind == "call":
            return self.eval_call(node[1], node[2], env)
        raise SyntaxError(f"stan: cannot evaluate {node!r}")

    def _eval_index_item(self, node, env):
        """One multi-index item -> a 0-based int/array index or a slice.
        Range bounds must be data (concrete) — Stan slices are shape-level."""
        if isinstance(node, tuple) and node[0] == "irange":
            lo = None if node[1] is None else self.eval_expr(node[1], env)
            hi = None if node[2] is None else self.eval_expr(node[2], env)
            for v in (lo, hi):
                if v is not None and not isinstance(v, (int, np.integer)):
                    raise SyntaxError(
                        "stan: range-index bounds must be data (concrete at "
                        "trace time)"
                    )
            return slice(None if lo is None else int(lo) - 1,
                         None if hi is None else int(hi))
        i = self.eval_expr(node, env)
        return _arith(operator.sub, i, 1)  # Stan is 1-indexed

    def eval_call(self, name, arg_nodes, env):
        args = [self.eval_expr(a, env) for a in arg_nodes]
        if name in self.functions:
            return self.call_function(name, args)
        if name in _MATH_FNS:
            return _MATH_FNS[name](*args)
        if name.endswith("_lpdf") or name.endswith("_lpmf"):
            dist = name[:-5]
            if dist in _MV_DENSITIES:
                return _mv_density_sum(dist, args[0], args[1:])
            if dist not in _DENSITIES:
                raise SyntaxError(f"stan: unsupported density {dist!r}")
            return _float_sum(_DENSITIES[dist](args[0], *args[1:]))
        if name.endswith("_lcdf") or name.endswith("_lccdf"):
            dist = name[: -5 if name.endswith("_lcdf") else -6]
            if dist not in _LCDFS:
                raise SyntaxError(f"stan: no log-CDF for {dist!r}")
            lc = _F(_LCDFS[dist](args[0], *args[1:]))
            if name.endswith("_lccdf"):
                lc = _log(-_expm1(torch.clamp_max(lc, -1e-38)))
            return torch.sum(lc)
        if name.endswith("_rng"):
            dist = name[:-4]
            if self.rng is None:
                raise RuntimeError(
                    f"stan: {name} is only available in generated quantities "
                    "during host-side extraction"
                )
            return self._draw(dist, args)
        raise SyntaxError(f"stan: unknown function {name!r}")

    def _draw(self, dist, args):
        """The JAX package's numpy draws, call for call: the same generator
        gives the same bits."""
        r = self.rng
        a = [_host(x) for x in args]
        if dist == "normal":
            return r.normal(a[0], a[1])
        if dist == "bernoulli":
            return (r.random(np.shape(a[0])) < a[0]).astype(np.float64)
        if dist == "uniform":
            return r.uniform(a[0], a[1])
        if dist == "exponential":
            return r.exponential(1.0 / a[0])
        if dist == "beta":
            return r.beta(a[0], a[1])
        if dist == "binomial":
            return r.binomial(int(a[0]), a[1])
        if dist == "gamma":
            return r.gamma(a[0], 1.0 / a[1])
        if dist == "poisson":
            return r.poisson(a[0])
        if dist == "lognormal":
            return r.lognormal(a[0], a[1])
        if dist == "student_t":
            return a[1] + a[2] * r.standard_t(a[0])
        if dist == "cauchy":
            return a[0] + a[1] * np.tan(np.pi * (r.random() - 0.5))
        if dist == "dirichlet":
            return r.dirichlet(np.asarray(a[0], np.float64))
        if dist == "multi_normal":
            return r.multivariate_normal(a[0], a[1])
        if dist == "categorical":
            p = np.asarray(a[0], np.float64)
            return 1 + r.choice(len(p), p=p / p.sum())
        if dist == "multinomial":
            # Stan: multinomial_rng(theta, N)
            return r.multinomial(int(a[1]), np.asarray(a[0], np.float64))
        raise SyntaxError(f"stan: unsupported rng {dist!r}")

    def call_function(self, name, args):
        fname, ret_type, params, body = self.functions[name]
        env = {p[1]: a for p, a in zip(params, args)}
        try:
            rets = self.exec_stmts(body, env)
        except _Return as r:
            return r.value
        if not rets:
            return None
        # blend conditional returns (last unconditional return is the base)
        base = None
        conds = []
        for cond, val in rets:
            if cond is None:
                base = val
            else:
                conds.append((cond, val))
        out = base
        for cond, val in reversed(conds):
            out = val if out is None else _where(cond, val, out)
        return out

    # -- statements ------------------------------------------------------

    def exec_stmts(self, stmts, env, mask=None):
        """Execute statements into ``env``; returns a list of
        (condition-or-None, value) for returns reached under tensor
        conditions. ``mask`` is the path condition (None = on all lanes).
        After a conditional return, the remaining statements run under the
        narrowed mask with a re-sanitized environment, so code that is dead
        on the returned path cannot overflow into NaN gradients."""
        rets = []
        cur_mask = mask
        for s in stmts:
            r = self.exec_stmt(s, env, cur_mask)
            rets.extend(r)
            for rc, _ in r:
                if rc is not None and _traced(rc):
                    alive = torch.logical_not(_bool(rc))
                    if cur_mask is not None:
                        alive = torch.logical_and(_bool(cur_mask), alive)
                    cur_mask = alive
                    san = _mask_env(env, cur_mask)
                    env.clear()
                    env.update(san)
        return rets

    def _add_target(self, env, inc, mask):
        if mask is not None:
            inc = _where(mask, inc, 0.0)
        env["__target__"] = _arith(operator.add, env.get("__target__", 0.0), inc)

    def exec_stmt(self, s, env, mask):
        kind = s[0]
        if kind == "nop":
            return []
        if kind == "block":
            return self.exec_stmts(s[1], env, mask)
        if kind == "decl":
            _, name, base, adims, edims, lower, upper, init = s
            if init is not None:
                env[name] = self.eval_expr(init, env)
            else:
                shape = tuple(
                    int(self.eval_expr(d, env)) for d in adims + edims
                )
                if base in _SPECIAL_MAT and len(edims) == 1:
                    shape = shape + (shape[-1],)  # square container
                env[name] = torch.zeros(shape, device=_DEVICE[0]) if shape else 0.0
            return []
        if kind == "assign":
            lv, op, rhs = s[1], s[2], s[3]
            val = self.eval_expr(rhs, env)
            return self._assign(lv, op, val, env, mask)
        if kind == "reject":
            # Stan semantics: the proposal is rejected -> density -inf on
            # the lanes that reach the statement
            self._add_target(env, torch.tensor(-math.inf, device=_DEVICE[0]), mask)
            return []
        if kind == "target":
            inc = self.eval_expr(s[1], env)
            inc = _T(inc).sum() if hasattr(inc, "ndim") and getattr(inc, "ndim", 0) else inc
            self._add_target(env, inc, mask)
            return []
        if kind == "sample":
            y = self.eval_expr(s[1], env)
            dist = s[2]
            if dist.endswith("_lpdf") or dist.endswith("_lpmf"):
                dist = dist[:-5]
            args = [self.eval_expr(a, env) for a in s[3]]
            trunc = s[4] if len(s) > 4 else None
            if dist in _MV_DENSITIES:
                if trunc is not None:
                    raise SyntaxError(
                        f"stan: truncation is not defined for {dist!r}"
                    )
                inc = _mv_density_sum(dist, y, args)
            elif dist in _DENSITIES:
                inc = _float_sum(_DENSITIES[dist](y, *args))
                if trunc is not None:
                    lo = None if trunc[0] is None else self.eval_expr(trunc[0], env)
                    hi = None if trunc[1] is None else self.eval_expr(trunc[1], env)
                    inc = inc - _truncation_term(dist, y, args, lo, hi)
            else:
                raise SyntaxError(f"stan: unsupported density {dist!r}")
            self._add_target(env, inc, mask)
            return []
        if kind == "for":
            lo = self.eval_expr(s[2], env)
            hi = self.eval_expr(s[3], env)
            if not isinstance(lo, (int, np.integer)) or not isinstance(hi, (int, np.integer)):
                raise SyntaxError(
                    "stan: loop bounds must be data (loops unroll at trace time)"
                )
            vec = self._vectorized_for(s, int(lo), int(hi), env, mask)
            if vec is not None:
                return vec
            rets = []
            for i in range(int(lo), int(hi) + 1):
                env[s[1]] = i
                try:
                    rets.extend(self.exec_stmts(s[4], env, mask))
                except _Continue:
                    continue
                except _Break:
                    break
            env.pop(s[1], None)
            return rets
        if kind == "while":
            # the condition must be data-computable: the loop runs at trace
            # time (like `for`); tensor conditions fail loudly
            rets = []
            n_iter = 0
            while True:
                cond = self.eval_expr(s[1], env)
                if _traced(cond):
                    raise SyntaxError(
                        "stan: while conditions must be data-computable "
                        "(concrete at trace time); parameter-dependent "
                        "while loops cannot compile to a static graph"
                    )
                if not bool(cond):
                    break
                n_iter += 1
                if n_iter > 1_000_000:
                    raise RuntimeError(
                        "stan: while loop exceeded 1e6 trace-time iterations"
                    )
                try:
                    rets.extend(self.exec_stmts(s[2], env, mask))
                except _Continue:
                    continue
                except _Break:
                    break
            return rets
        if kind == "break":
            if mask is not None:
                raise SyntaxError(
                    "stan: break under a parameter-dependent condition is "
                    "not supported (control flow must be data-computable)"
                )
            raise _Break()
        if kind == "continue":
            if mask is not None:
                raise SyntaxError(
                    "stan: continue under a parameter-dependent condition "
                    "is not supported (control flow must be data-computable)"
                )
            raise _Continue()
        if kind == "if":
            cond = self.eval_expr(s[1], env)
            if isinstance(cond, (bool, np.bool_)):
                return self.exec_stmts(s[2] if cond else s[3], env, mask)
            # tensor condition: run both branches on SANITIZED copies of the
            # environment (untaken lanes see dummy inputs — the double-where
            # trick, so dead-branch inf/NaN cannot poison values or
            # gradients), then blend every write
            cond = _bool(cond)
            notcond = torch.logical_not(cond)
            c = cond if mask is None else torch.logical_and(_bool(mask), cond)
            notc = notcond if mask is None else torch.logical_and(_bool(mask), notcond)
            env_t = _mask_env(env, cond)
            base_t = dict(env_t)
            rets = [
                (torch.logical_and(c, _bool(rc)) if rc is not None else c, rv)
                for rc, rv in self.exec_stmts(s[2], env_t, c)
            ]
            env_f = _mask_env(env, notcond)
            base_f = dict(env_f)
            rets += [
                (torch.logical_and(notc, _bool(rc)) if rc is not None else notc, rv)
                for rc, rv in self.exec_stmts(s[3], env_f, notc)
            ]
            for k in set(env_t) | set(env_f):
                mod_t = env_t.get(k) is not base_t.get(k)
                mod_f = env_f.get(k) is not base_f.get(k)
                if not (mod_t or mod_f):
                    continue  # untouched: keep the original, unsanitized value
                vt = env_t[k] if mod_t else env.get(k)
                vf = env_f[k] if mod_f else env.get(k)
                if vt is None:  # declared only inside the then-branch
                    env[k] = env_t[k]
                elif vf is None:
                    env[k] = env_f[k]
                else:
                    env[k] = _where(cond, vt, vf)
            return rets
        if kind == "return":
            val = None if s[1] is None else self.eval_expr(s[1], env)
            if mask is None:
                raise _Return(val)
            return [(mask, val)]
        raise SyntaxError(f"stan: cannot execute {s!r}")

    def _vectorized_for(self, s, lo, hi, env, mask):
        """Vectorize a data-length loop of pure sampling statements.

        ``for (i in 1:N) y[i] ~ normal(mu[i], sigma);`` unrolled costs O(N)
        evaluation time; with the loop variable bound to ``arange(lo, hi+1)``
        the body evaluates ONCE with vector semantics (1-based gathers become
        batched gathers) and the elementwise density sums to the same total.
        Only applied when every body statement is a univariate
        ``~``-statement and every evaluated operand is a scalar or an
        [N]-vector — anything else falls back to unrolling. The operands'
        shapes are all that is checked, as in the JAX package (a body that
        reads the loop variable other than as an index can take this path
        with other values than the unrolled one's; the port keeps that
        fault, and ``tests/test_torch_stan_lang.py`` pins it)."""
        n = hi - lo + 1
        if n < 32:
            return None  # unroll small loops (keeps traces bit-stable)
        body = s[4]
        if not body or any(
            st[0] != "sample" or (len(st) > 4 and st[4] is not None)
            for st in body
        ):
            return None  # assignments / truncated statements: unroll
        venv = dict(env)
        # a host numpy index vector keeps data gathers on numpy values
        venv[s[1]] = np.arange(lo, hi + 1)
        total = torch.zeros((), device=_DEVICE[0])
        try:
            for st in body:
                y = self.eval_expr(st[1], venv)
                dist = st[2]
                if dist.endswith("_lpdf") or dist.endswith("_lpmf"):
                    dist = dist[:-5]
                if dist not in _DENSITIES:
                    return None
                args = [self.eval_expr(a, venv) for a in st[3]]
                if not all(_shape(v) in ((), (n,)) for v in (y, *args)):
                    return None
                total = total + _float_sum(_DENSITIES[dist](y, *args))
        except Exception:
            return None  # the unrolled path re-raises any real model error
        self._add_target(env, total, mask)
        return []

    def _assign(self, lv, op, val, env, mask):
        if lv[0] == "var":
            name = lv[1]
            cur = env.get(name, 0.0)
            new = val if op == "=" else _apply_aug(op, cur, val)
            if mask is not None and op != "=" or (mask is not None and name in env):
                new = _where(mask, new, cur)
            env[name] = new
            return []
        if lv[0] == "index":
            base_name = lv[1]
            if base_name[0] != "var":
                raise SyntaxError("stan: only simple indexed assignment supported")
            name = base_name[1]
            idx = tuple(_arith(operator.sub, self.eval_expr(i, env), 1) for i in lv[2])
            arr = _T(env[name])
            sel = idx if len(idx) > 1 else idx[0]
            cur = _index(arr, sel)
            new = val if op == "=" else _apply_aug(op, cur, val)
            if mask is not None:
                new = _where(mask, new, cur)
            env[name] = _index_set(arr, sel, new)
            return []
        raise SyntaxError(f"stan: unsupported lvalue {lv!r}")


def _apply_aug(op, cur, val):
    return {
        "+=": lambda: _arith(operator.add, cur, val),
        "-=": lambda: _arith(operator.sub, cur, val),
        "*=": lambda: _arith(operator.mul, cur, val),
        "/=": lambda: _arith(operator.truediv, cur, val),
    }[op]()


def _traced(v):
    """A tensor: the counterpart of a JAX tracer or array."""
    return _is_t(v)


def _host(v):
    """A value for numpy: a tensor's (CPU) array."""
    return v.detach().cpu().numpy() if _is_t(v) else np.asarray(v)


def _index_key(sel):
    """An index for torch: numpy arrays and int tensors as long tensors."""
    if isinstance(sel, tuple):
        return tuple(_index_key(s) for s in sel)
    if isinstance(sel, (slice, int, np.integer)):
        return int(sel) if not isinstance(sel, slice) else sel
    return _T(sel, torch.int64)


def _index(base, sel):
    """``base[sel]``: numpy indexing of data, torch indexing of tensors."""
    if not _is_t(base):
        if not any(_is_t(s) for s in (sel if isinstance(sel, tuple) else (sel,))):
            return base[sel]
        base = _T(base)
    return base[_index_key(sel)]


def _index_set(arr, sel, new):
    """``arr.at[sel].set(new)``: a new tensor (out of place, so that it
    works under vmap), the value cast to the array's dtype as the scatter
    casts it."""
    key = sel if isinstance(sel, tuple) else (sel,)
    key = tuple(_T(k, torch.int64) if not _is_t(k) else k.long() for k in key)
    new = _T(new).to(arr.dtype)
    out_shape = arr[key].shape
    if _is_t(new) and new.shape != out_shape:
        new = new.expand(out_shape)
    return torch.index_put(arr, key, new)


def _mask_env(env, cond):
    """Branch-entry input sanitization (the generalized double-``where``
    trick): on lanes where ``cond`` is False, every floating tensor is
    replaced by 1.0 before the branch body is evaluated. The branch's outputs
    on those lanes are discarded by the caller's blend, and the gradient
    through the ``where`` is zero, so overflow/0-division in the dead branch
    can no longer produce NaN values or NaN gradients. Only scalar
    conditions sanitize (the subset's conditions are scalars; anything else
    passes through)."""
    if tuple(getattr(cond, "shape", ())) != ():
        return dict(env)
    out = {}
    for k, v in env.items():
        if k != "__target__" and _traced(v) and v.is_floating_point():
            out[k] = torch.where(_bool(cond), v, torch.ones_like(v))
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# constraint transforms (Stan reference manual ch. 10, change of variables).
# Closed-form log-jacobians; each is held to the JAX package's and to the
# autodiff slogdet(jacobian) oracle in tests/test_torch_stan_lang.py.
# ---------------------------------------------------------------------------


def _constrain_scalarwise(u, lower, upper):
    """Unconstrained -> constrained + log-jacobian, elementwise (Stan's
    lb/ub/lub transforms)."""
    if lower is None and upper is None:
        return u, torch.zeros_like(u)
    if lower is not None and upper is None:
        return _arith(operator.add, lower, _exp(u)), u
    if lower is None and upper is not None:
        return _arith(operator.sub, upper, _exp(u)), u
    width = _arith(operator.sub, upper, lower)
    s = _sigmoid(u)
    x = _arith(operator.add, lower, _arith(operator.mul, width, s))
    logjac = _log(width) + _log_sigmoid(u) + _log_sigmoid(-u)
    return x, logjac


def _constrain_simplex(u):
    """Stick-breaking (Stan 10.6): u [K-1] -> x on the K-simplex; the JAX
    package's ``lax.scan`` as a loop with the same carry."""
    K = u.shape[0] + 1
    ks = np.arange(1, K)
    z = _sigmoid(u - _log(1.0 * (K - ks)))
    rem = torch.ones((), dtype=u.dtype, device=u.device)
    xs, ljs = [], []
    for k in range(K - 1):
        zk = z[k]
        xk = zk * rem
        ljs.append(_log(zk) + _log1p(-zk) + _log(rem))
        xs.append(xk)
        rem = rem - xk
    x = torch.cat([torch.stack(xs), rem[None]]) if xs else rem[None]
    lj = torch.sum(torch.stack(ljs)) if ljs else torch.zeros((), device=u.device)
    return x, lj


def _constrain_ordered(u):
    """x_1 = u_1, x_k = x_(k-1) + exp(u_k) (Stan 10.4)."""
    x = u[0] + torch.cat([torch.zeros((1,), dtype=u.dtype, device=u.device),
                          torch.cumsum(_exp(u[1:]), 0)])
    return x, torch.sum(u[1:])


def _constrain_positive_ordered(u):
    x = torch.cumsum(_exp(u), 0)
    return x, torch.sum(u)


def _constrain_unit_vector(u):
    """x = u/|u| with Stan's auxiliary -|u|^2/2 'jacobian' term (Stan 10.8:
    the pushforward of the standard normal is uniform on the sphere)."""
    r2 = torch.sum(u * u)
    x = u / torch.sqrt(r2)
    return x, -0.5 * r2


def _tril_key(il, device):
    return tuple(torch.as_tensor(i, dtype=torch.int64, device=device) for i in il)


def _cpc_cholesky(u, K):
    """Canonical-partial-correlation -> Cholesky factor of a correlation
    matrix (Stan 10.12). ``u`` is the K(K-1)/2 strictly-lower entries in
    row-major order. Returns (L, logjac) where logjac covers both the tanh
    and the CPC->L maps: sum over strict-lower (i,j) of
    log(1-z_ij^2) + log prod_(j'<j) sqrt(1-z_ij'^2)."""
    il = _tril_key(np.tril_indices(K, -1), u.device)  # row-major strict lower
    z = torch.index_put(torch.zeros((K, K), dtype=u.dtype, device=u.device), il, _tanh(u))
    mask_sl = torch.as_tensor(np.tril(np.ones((K, K), bool), -1), device=u.device)
    c = torch.where(mask_sl, torch.sqrt(1.0 - z * z), 1.0)
    cp_inc = torch.cumprod(c, dim=1)
    ecp = torch.cat(
        [torch.ones((K, 1), dtype=u.dtype, device=u.device), cp_inc[:, :-1]], dim=1
    )  # exclusive row cumprod: remaining length before column j
    L = torch.where(mask_sl, z * ecp, 0.0) + torch.diag(torch.diagonal(ecp))
    logjac = torch.sum(torch.where(mask_sl, _log1p(-z * z) + _log(ecp), 0.0))
    return L, logjac


def _constrain_cholesky_factor_corr(u, K):
    return _cpc_cholesky(u, K)


def _constrain_corr_matrix(u, K):
    L, logjac = _cpc_cholesky(u, K)
    R = L @ L.T
    # L -> R on the strict lower triangle is triangular with dR_ij/dL_ij =
    # L_jj: each column-j diagonal appears once per row below it
    diag = torch.diagonal(L)
    w = torch.arange(K - 1, -1, -1, dtype=u.dtype, device=u.device)  # K-1-j, 0-based j
    return R, logjac + torch.sum(w * _log(diag))


def _constrain_cov_matrix(u, K):
    """u = (log-diagonal [K], strict-lower row-major [K(K-1)/2]);
    Sigma = L L' with L_ii = exp(d_i). log|J| = K log 2 + sum (K-j+1) d_j
    (0-based j; Stan 10.9's K log 2 + sum (K-k+2) z_kk with 1-based k)."""
    d = u[:K]
    il = _tril_key(np.tril_indices(K, -1), u.device)
    L = torch.index_put(torch.zeros((K, K), dtype=u.dtype, device=u.device), il, u[K:])
    L = L + torch.diag(_exp(d))
    Sigma = L @ L.T
    w = torch.arange(K + 1, 1, -1, dtype=u.dtype, device=u.device)  # K-j+1, j=0..K-1
    return Sigma, K * math.log(2.0) + torch.sum(w * d)


def _constrain_cholesky_factor_cov(u, M, N):
    """Lower-trapezoidal [M, N] factor with positive diagonal: diagonal logs
    first, then the below-diagonal entries row-major. log|J| = sum d."""
    d = u[:N]
    rest = u[N:]
    rows, cols = np.tril_indices(M, -1)
    keep = cols < N
    rows, cols = rows[keep], cols[keep]
    L = torch.index_put(torch.zeros((M, N), dtype=u.dtype, device=u.device),
                        _tril_key((rows, cols), u.device), rest)
    diag = _tril_key((np.arange(N), np.arange(N)), u.device)
    L = torch.index_put(L, diag, _exp(d))
    return L, torch.sum(d)


# ---------------------------------------------------------------------------
# parameter specs: one transform per declared parameter
# ---------------------------------------------------------------------------


class _ParamSpec:
    """One parameters-block declaration compiled to its unconstraining
    transform: ``constrain(u[unc_size]) -> (value[shape], logjac)``."""

    def __init__(self, name, off, unc_size, shape, constrain, kind, identity,
                 lower=None, upper=None):
        self.name = name
        self.off = off
        self.unc_size = unc_size
        self.shape = shape  # constrained shape (incl. leading array dims)
        self.constrain = constrain
        self.kind = kind
        self.identity = identity  # True iff value == u (no transform)
        self.lower, self.upper = lower, upper  # the bounds' values (data)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1


def _base_transform(kind, edims, lo, hi):
    """One element's transform: (unc_base_size, base_shape, fn)."""
    if kind in ("int", "real", "vector", "row_vector", "matrix"):
        shape = tuple(edims)
        size = int(np.prod(shape)) if shape else 1

        def fn(u):
            v, lj = _constrain_scalarwise(u, lo, hi)
            v = _F(v)
            return (v.reshape(shape) if shape else v[0]), torch.sum(lj)

        return size, shape, fn
    if kind == "simplex":
        K = edims[0]
        return K - 1, (K,), _constrain_simplex
    if kind == "ordered":
        K = edims[0]
        return K, (K,), _constrain_ordered
    if kind == "positive_ordered":
        K = edims[0]
        return K, (K,), _constrain_positive_ordered
    if kind == "unit_vector":
        K = edims[0]
        return K, (K,), _constrain_unit_vector
    if kind == "cholesky_factor_corr":
        K = edims[0]
        return K * (K - 1) // 2, (K, K), lambda u: _constrain_cholesky_factor_corr(u, K)
    if kind == "corr_matrix":
        K = edims[0]
        return K * (K - 1) // 2, (K, K), lambda u: _constrain_corr_matrix(u, K)
    if kind == "cov_matrix":
        K = edims[0]
        return K * (K + 1) // 2, (K, K), lambda u: _constrain_cov_matrix(u, K)
    if kind == "cholesky_factor_cov":
        M = edims[0]
        N = edims[1] if len(edims) > 1 else M
        n_below = sum(min(i, N) for i in range(M))
        return N + n_below, (M, N), lambda u: _constrain_cholesky_factor_cov(u, M, N)
    raise SyntaxError(f"stan: unsupported parameter type {kind!r}")


def _make_param_spec(name, off, kind, adims, edims, lo, hi):
    unc_base, base_shape, fn = _base_transform(kind, edims, lo, hi)
    identity = (
        kind in ("real", "vector", "row_vector", "matrix")
        and lo is None
        and hi is None
    )
    if not adims:
        return _ParamSpec(name, off, unc_base, base_shape, fn, kind, identity, lo, hi)
    A = int(np.prod(adims))

    def fn_arr(u):
        vals, ljs = torch.func.vmap(fn)(u.reshape(A, unc_base))
        return vals.reshape(tuple(adims) + base_shape), torch.sum(ljs)

    return _ParamSpec(
        name, off, A * unc_base, tuple(adims) + base_shape, fn_arr, kind,
        identity, lo, hi,
    )


# ---------------------------------------------------------------------------
# the target
# ---------------------------------------------------------------------------


def _float32_like_jax(v):
    """A data value as a JAX run's ``vmap`` hands it back: float data as
    float32, ints as int32 (numpy scalars for scalars)."""
    a = _host(v)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    return a[()] if a.ndim == 0 else a


class StanTarget(Target):
    """A parsed ``.stan`` model as a target (reference: ``StanLogPotential``
    + BridgeStan ext). ``source`` is the Stan text, as in the JAX package;
    ``device_source`` the model as CUDA source for kernel K2
    (:mod:`.stan_cuda`) where the model lies in its subset, else
    ``device_refusal`` says which construct keeps it off the kernel."""

    device_source = None  # set in __init__; shadows Target's, since ``source`` is the text

    def __init__(self, source: str, data: Optional[dict] = None, name: str = "stan_model"):
        self.source = source
        self.name = name
        self._data_in = data
        blocks = _Parser(_tokenize(source)).parse_program()
        self._blocks = blocks
        self._ev = _Evaluator(blocks.get("functions", []))

        # data block: bind + validate
        data = dict(data or {})
        env = {}
        for d in blocks.get("data", []):
            _, dname, base, adims, edims, lower, upper, init = d
            if dname not in data:
                raise ValueError(f"stan: missing data value for {dname!r}")
            v = data[dname]
            if not adims and not edims:
                v = int(v) if base == "int" else float(v)
            else:
                dt = np.int64 if base == "int" else np.float64
                v = np.asarray(v, dtype=dt)
                want = tuple(
                    int(self._ev.eval_expr(dd, env)) for dd in adims + edims
                )
                if base in _SPECIAL_MAT and len(edims) == 1:
                    want = want + (want[-1],)
                if v.shape != want:
                    raise ValueError(
                        f"stan: data {dname!r} has shape {v.shape}, declared "
                        f"{want}"
                    )
            env[dname] = v
        # transformed data: runs once, host-side
        td_env = dict(env)
        self._ev.exec_stmts(blocks.get("transformed data", []), td_env)
        td_env.pop("__target__", None)
        self._data_env = td_env
        self._data_envs = {torch.device("cpu"): td_env}

        # parameters: one unconstraining transform per declaration
        self._params = []
        off = 0
        for p in blocks.get("parameters", []):
            _, pname, base, adims, edims, lower, upper, init = p
            if base == "int":
                raise ValueError(
                    "stan: integer parameters are not supported (Stan itself "
                    "forbids them)"
                )
            adims_c = tuple(int(self._ev.eval_expr(d, td_env)) for d in adims)
            edims_c = tuple(int(self._ev.eval_expr(d, td_env)) for d in edims)
            lo = None if lower is None else self._ev.eval_expr(lower, td_env)
            hi = None if upper is None else self._ev.eval_expr(upper, td_env)
            spec = _make_param_spec(pname, off, base, adims_c, edims_c, lo, hi)
            self._params.append(spec)
            off += spec.unc_size
        self.dim = off
        if off == 0:
            raise ValueError("stan: model has no parameters")

        from .stan_cuda import emit_source, StanSubsetError

        try:
            self.device_source, self.device_refusal = emit_source(self), None
        except StanSubsetError as e:
            self.device_source, self.device_refusal = None, str(e)

    # -- plumbing --------------------------------------------------------

    def __reduce__(self):
        # rebuilt from the text and the data (its closures do not pickle)
        return StanTarget, (self.source, self._data_in, self.name)

    def to(self, device) -> "StanTarget":
        """The target with its source's arrays on ``device`` (its data are
        moved at first use on a device)."""
        if self.device_source is None:
            return self
        out = object.__new__(StanTarget)
        out.__dict__.update(self.__dict__)
        out.device_source = self.device_source.to(device)
        return out

    def _env_on(self, device):
        """The data environment with its tensors on ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        env = self._data_envs.get(device)
        if env is None:
            env = {k: (v.to(device) if _is_t(v) else v) for k, v in self._data_env.items()}
            self._data_envs[device] = env
        return env

    def _constrain_env(self, x):
        """x (unconstrained flat [d]) -> (env incl. transformed parameters,
        total log-jacobian)."""
        env = dict(self._env_on(x.device))
        logjac = torch.zeros((), dtype=x.dtype, device=x.device)
        for spec in self._params:
            u = x[spec.off : spec.off + spec.unc_size]
            v, lj = spec.constrain(u)
            logjac = logjac + lj
            env[spec.name] = v
        ev = _Evaluator(self._blocks.get("functions", []))
        ev.exec_stmts(self._blocks.get("transformed parameters", []), env)
        env.pop("__target__", None)
        return env, logjac

    def _log_density_one(self, x):
        env, logjac = self._constrain_env(x)
        env["__target__"] = torch.zeros((), dtype=x.dtype, device=x.device)
        ev = _Evaluator(self._blocks.get("functions", []))
        ev.exec_stmts(self._blocks.get("model", []), env)
        return _F(env["__target__"]) + logjac

    def log_density(self, x):
        """BridgeStan convention: model block + constraint jacobian,
        propto=false (``interface.jl:64-69``), of ``x [..., d]``."""
        with _on(x.device):
            if x.dim() == 1:
                return self._log_density_one(x)
            flat = x.reshape(-1, self.dim)
            out = torch.func.vmap(self._log_density_one)(flat)
            return out.reshape(x.shape[:-1])

    def default_reference(self) -> Reference:
        """The standard normal on the unconstrained space, normalized, as
        the JAX package's (so stepping-stone logZ is the marginal
        likelihood): ``N(0, I)``, whose unnormalized form kernel K2
        evaluates."""
        d = self.dim

        def log_density(u):
            return torch.sum(-0.5 * u * u - _HALF_LOG_2PI, dim=-1)

        return Reference(log_density=log_density,
                         sample_iid=lambda keys: rng.normal(keys, (d,)), normal_sigma=1.0)

    def default_explorer(self):
        from ..ops import AutoMALA

        return AutoMALA()  # reference interface.jl:51

    # -- extraction (param_constrain with tp + gq, state.jl:4-8) ---------

    def sample_names(self, include_tp=True, include_gq=True):
        """CONSTRAINED-space draw names (``constrained_samples`` layout),
        matching BridgeStan's ``param_names``."""
        names = []
        for spec in self._params:
            if spec.shape:
                names += [f"{spec.name}[{i}]" for i in range(spec.size)]
            else:
                names.append(spec.name)
        if include_tp:
            names += self._block_var_names("transformed parameters")
        if include_gq:
            names += self._block_var_names("generated quantities")
        names.append("log_density")
        return names

    def unconstrained_sample_names(self):
        """Column labels for ``pt.sample_array()``, which holds the
        UNCONSTRAINED parameter vector: identity coordinates keep the
        parameter's name, transformed ones are suffixed ``_unc`` so a
        logit/log/cholesky-scale column is never mislabeled as the
        constrained value."""
        names = []
        for spec in self._params:
            base = spec.name if spec.identity else f"{spec.name}_unc"
            if spec.unc_size == 1 and not spec.shape:
                names.append(base)
            else:
                names += [f"{base}[{i}]" for i in range(spec.unc_size)]
        names.append("log_density")
        return names

    def _block_var_names(self, block):
        names = []
        env, _ = self._constrain_env(torch.zeros(self.dim))
        ev = _Evaluator(
            self._blocks.get("functions", []), rng=np.random.default_rng(0)
        )
        ev.exec_stmts(self._blocks.get(block, []), env)
        for s in self._blocks.get(block, []):
            if s[0] == "decl":
                v = env[s[1]]
                shape = _shape(v)
                n = int(np.prod(shape)) if shape else 1
                if shape:
                    names += [f"{s[1]}[{i}]" for i in range(n)]
                else:
                    names.append(s[1])
        return names

    def constrained_samples(self, pt, include_tp=True, include_gq=True, seed=0):
        """Reference ``param_constrain(...; include_tp, include_gq, rng)``:
        maps the run's unconstrained samples to a dict of constrained
        parameter draws plus transformed parameters and generated
        quantities (``state.jl:4-8``). The generated quantities draw from
        ``numpy.random.default_rng(seed)`` call for call as the JAX
        package's do, with the data as its ``vmap`` hands them back
        (float32, int32), so that equal inputs give equal bits."""
        sa = np.asarray(pt.sample_array())[:, : self.dim]
        rng_np = np.random.default_rng(seed)
        x = torch.as_tensor(sa, dtype=torch.float32)
        with torch.no_grad():
            envs = torch.func.vmap(self._batched_env)(x)
        data_keys = [k for k in self._data_env if k not in envs]
        out = {}
        for spec in self._params:
            out[spec.name] = envs[spec.name].numpy()
        if include_tp:
            for s in self._blocks.get("transformed parameters", []):
                if s[0] == "decl":
                    out[s[1]] = envs[s[1]].numpy()
        if include_gq and self._blocks.get("generated quantities"):
            gq_names = [
                s[1] for s in self._blocks["generated quantities"] if s[0] == "decl"
            ]
            data_rows = {k: _float32_like_jax(self._data_env[k]) for k in data_keys}
            host_envs = {k: v.numpy() for k, v in envs.items()}
            cols = {g: [] for g in gq_names}
            for i in range(sa.shape[0]):
                env = {k: (v[i] if v.ndim else v) for k, v in host_envs.items()}
                env = {**self._data_env, **data_rows, **env}
                ev = _Evaluator(self._blocks.get("functions", []), rng=rng_np)
                ev.exec_stmts(self._blocks["generated quantities"], env)
                for g in gq_names:
                    cols[g].append(_host(env[g]))
            for g in gq_names:
                out[g] = np.stack(cols[g])
        return out

    def _batched_env(self, x):
        """The constrained environment of one state as tensors, the data
        left out (``constrained_samples`` adds them as JAX's ``vmap`` hands
        them back)."""
        env, _ = self._constrain_env(x)
        return {k: _T(v) for k, v in env.items() if k not in self._data_env}


def load_stan_data(path: str) -> dict:
    """Read a Stan/CmdStan data file (JSON, e.g.
    ``examples/stan/bernoulli.data.json``)."""
    with open(path) as f:
        return json.load(f)


def stan_target(
    file: Optional[str] = None,
    source: Optional[str] = None,
    data: Optional[Any] = None,
    name: Optional[str] = None,
) -> StanTarget:
    """Build a target from a ``.stan`` file or source string; ``data`` is a
    dict or a path to a CmdStan-style JSON data file. The analogue of the
    reference's ``StanLogPotential(stan_file, data)``."""
    if (file is None) == (source is None):
        raise ValueError("pass exactly one of file= or source=")
    if file is not None:
        with open(file) as f:
            source = f.read()
        name = name or file.rsplit("/", 1)[-1].removesuffix(".stan")
    if isinstance(data, str):
        data = load_stan_data(data)
    return StanTarget(source, data=data, name=name or "stan_model")
