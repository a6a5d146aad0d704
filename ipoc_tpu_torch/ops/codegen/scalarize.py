"""One torch model definition as straight-line kernel code (counterpart of
``ipoc_tpu/ops/pallas/scalarize.py``).

A stage program is a function of a few small tensors (shapes ``(nx,)``,
``(nu,)``, ``()``) written with the model's callables and ``torch.func``
derivatives.  :func:`scalarize` traces it with
``torch.fx.experimental.proxy_tensor.make_fx`` (over ``functionalize``, so
in-place aten ops such as ``fill_`` and ``copy_`` become their functional
forms): the AD transforms are traced into one aten graph, the counterpart of
a jaxpr.  The graph is then interpreted with every tensor held as a numpy
*object array of scalar nodes*, a hash-consed expression DAG:

* constants are Python scalars, so ``x*0 -> 0``, ``x*1 -> x``, ``x+0 -> x``
  and constant subexpressions fold while the DAG is built: the one-hot
  basis structure of the AD transforms evaporates;
* view and shape ops (select, reshape, expand, stack, ...) are index
  bookkeeping on the object arrays;
* hash-consing merges equal subexpressions at scalar granularity (CSE);
* only the nodes the outputs reach are kept (dead-node elimination).

One DAG gives two things: :meth:`ScalarProgram.c_source`, the text of a
``template <typename scalar_t>`` function for the CUDA kernels (behind the
``IPOC_HD`` macro of ``csrc/scalar_math.h``, so that plain ``g++`` compiles
it too), and :meth:`ScalarProgram.evaluate`, a torch evaluator on
batch-last tensors for the CPU tests.  The emitted code computes in
``scalar_t`` throughout: dtype conversions between floating types in the
graph are dropped and every constant is written as ``scalar_t(...)``.

An aten op the interpreter does not cover raises ``NotImplementedError``;
there is no vector fallback (the JAX package's ``_block_lift`` exists for
Mosaic's layouts and is not ported).

Structural-zero caveat: folding ``mul(x, 0) -> 0`` and ``div(0, x) -> 0``
assumes the dropped factor is finite and non-zero, which holds for AD basis
tangents and model denominators at feasible iterates (the solver only
evaluates stage derivatives at accepted, feasible points; a trial point's
NaN/inf cost is handled by the caller's selects).
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Scalar expression nodes
# ---------------------------------------------------------------------------

_BOOL_OPS = {"lt", "le", "gt", "ge", "eq", "ne", "and", "or", "not"}
_COMMUTATIVE = {"add", "mul", "max", "min", "eq", "ne", "and", "or"}


def _nan_max(a, b):
    return a if a != a else (b if b != b else (a if a >= b else b))


def _nan_min(a, b):
    return a if a != a else (b if b != b else (a if a <= b else b))


def _remainder(a, b):
    # torch.remainder's rule (and jnp.remainder's): the result takes the
    # sign of the divisor.
    m = np.fmod(a, b)
    if m != 0 and (b < 0) != (m < 0):
        m = m + b
    return m


# Constant folding, in float64 (names are this module's op names).
_FOLD = {
    "neg": np.negative, "abs": np.abs, "sin": np.sin, "cos": np.cos,
    "tan": np.tan, "exp": np.exp, "log": np.log, "sqrt": np.sqrt,
    "rsqrt": lambda a: 1.0 / np.sqrt(a), "tanh": np.tanh,
    "sigmoid": lambda a: 1.0 / (1.0 + np.exp(-a)),
    "reciprocal": lambda a: 1.0 / a, "log1p": np.log1p, "expm1": np.expm1,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "sinh": np.sinh, "cosh": np.cosh,
    "add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide,
    "max": _nan_max, "min": _nan_min, "rem": _remainder, "pow": np.power,
    "atan2": np.arctan2,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt,
    "ge": operator.ge, "eq": operator.eq, "ne": operator.ne,
    "and": lambda a, b: bool(a) and bool(b),
    "or": lambda a, b: bool(a) or bool(b), "not": lambda a: not a,
    "where": lambda c, a, b: a if c else b,
}

# C++ emission: functions of csrc/scalar_math.h for the math, operators for
# the arithmetic.
_C = {
    "neg": "-{0}", "add": "{0} + {1}", "sub": "{0} - {1}",
    "mul": "{0} * {1}", "div": "{0} / {1}",
    "max": "ipoc_max({0}, {1})", "min": "ipoc_min({0}, {1})",
    "rem": "ipoc_rem({0}, {1})", "pow": "ipoc_pow({0}, {1})",
    "atan2": "ipoc_atan2({0}, {1})",
    "lt": "{0} < {1}", "le": "{0} <= {1}", "gt": "{0} > {1}",
    "ge": "{0} >= {1}", "eq": "{0} == {1}", "ne": "{0} != {1}",
    "and": "{0} && {1}", "or": "{0} || {1}", "not": "!{0}",
    "where": "{0} ? {1} : {2}",
}
for _name in ("abs", "sin", "cos", "tan", "exp", "log", "sqrt", "rsqrt",
              "tanh", "sigmoid", "reciprocal", "log1p", "expm1", "asin",
              "acos", "atan", "sinh", "cosh"):
    _C[_name] = f"ipoc_{_name}({{0}})"

# The elementary functions: what ScalarProgram.split hands off.
ELEMENTARY_CALLS = frozenset({
    "sin", "cos", "tan", "exp", "log", "sqrt", "rsqrt", "pow", "atan2", "rem",
    "tanh", "sigmoid", "reciprocal", "log1p", "expm1", "asin", "acos",
    "atan", "sinh", "cosh"})

# Torch evaluation on (B,) tensors.
_TORCH = {
    "neg": torch.neg, "abs": torch.abs, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "exp": torch.exp, "log": torch.log,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "tanh": torch.tanh,
    "sigmoid": torch.sigmoid, "reciprocal": torch.reciprocal,
    "log1p": torch.log1p, "expm1": torch.expm1, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh,
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "max": torch.maximum, "min": torch.minimum, "rem": torch.remainder,
    "pow": torch.pow, "atan2": torch.atan2,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "eq": torch.eq, "ne": torch.ne, "and": torch.logical_and,
    "or": torch.logical_or, "not": torch.logical_not, "where": torch.where,
}


class Node:
    """One scalar operation, or one element of a program input."""

    __slots__ = ("op", "args", "order")

    def __init__(self, op, args, order):
        self.op = op        # an op name of _FOLD, or "input"
        self.args = args    # Node | float | bool; (argpos, flat_idx) for input
        self.order = order  # creation index: a valid topological order

    @property
    def is_bool(self):
        return self.op in _BOOL_OPS


def _is_const(v):
    return not isinstance(v, Node)


def _ckey(v):
    """Hash key of a constant (type-tagged: 0.0 and False differ)."""
    return ("c", type(v).__name__, repr(v))


class _Dag:
    """Hash-consing scalar DAG with algebraic simplification."""

    def __init__(self):
        self.table = {}
        self.n_created = 0
        self.n_folded = 0
        self.n_hits = 0

    def _new(self, key, op, args):
        nd = self.table.get(key)
        if nd is not None:
            self.n_hits += 1
            return nd
        nd = Node(op, args, self.n_created)
        self.n_created += 1
        self.table[key] = nd
        return nd

    def input(self, argpos, flat_idx):
        return self._new(("input", argpos, flat_idx), "input",
                         (argpos, flat_idx))

    def op(self, name, *args):
        if all(_is_const(a) for a in args):
            self.n_folded += 1
            with np.errstate(all="ignore"):
                out = _FOLD[name](*args)
            return bool(out) if name in _BOOL_OPS else float(out)
        hit, val = self._simplify(name, args)
        if hit:
            return val
        if name == "pow" and _is_const(args[1]):
            e = args[1]
            if e in (2.0, 3.0, 4.0):
                sq = self.op("mul", args[0], args[0])
                if e == 2.0:
                    return sq
                return self.op("mul", sq, args[0] if e == 3.0 else sq)
            if e == 0.5:
                return self.op("sqrt", args[0])
            if e == -1.0:
                return self.op("div", 1.0, args[0])
        keys = tuple(_ckey(a) if _is_const(a) else id(a) for a in args)
        if name in _COMMUTATIVE:
            keys = tuple(sorted(keys, key=repr))
        return self._new((name, keys), name, tuple(args))

    @staticmethod
    def _simplify(name, args):
        """``(True, value)`` where an identity applies, else ``(False,
        None)``."""
        if name in ("add", "sub", "mul", "div", "pow"):
            a, b = args
            ac, bc = _is_const(a), _is_const(b)
            if name == "add":
                if bc and b == 0:
                    return True, a
                if ac and a == 0:
                    return True, b
            elif name == "sub":
                if bc and b == 0:
                    return True, a
                if a is b:
                    return True, 0.0
            elif name == "mul":
                if (bc and b == 0) or (ac and a == 0):
                    return True, 0.0
                if bc and b == 1:
                    return True, a
                if ac and a == 1:
                    return True, b
            elif name == "div":
                if bc and b == 1:
                    return True, a
                if ac and a == 0:
                    return True, 0.0
            elif name == "pow" and bc:
                if b == 1:
                    return True, a
                if b == 0:
                    return True, 1.0
        elif name == "neg" and isinstance(args[0], Node) \
                and args[0].op == "neg":
            return True, args[0].args[0]
        elif name == "where" and _is_const(args[0]):
            return True, args[1] if args[0] else args[2]
        elif name in ("and", "or"):
            a, b = args
            for c, x in ((a, b), (b, a)):
                if _is_const(c):
                    if name == "and":
                        return True, (x if c else False)
                    return True, (True if c else x)
        return False, None


# ---------------------------------------------------------------------------
# Aten graph interpretation over object arrays of nodes
# ---------------------------------------------------------------------------


def _obj(value):
    """A Python scalar, a tensor or a numpy array as an object array of
    Python scalars."""
    if isinstance(value, np.ndarray) and value.dtype == object:
        return value
    if isinstance(value, Node):
        out = np.empty((), dtype=object)
        out[()] = value
        return out
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    a = np.asarray(value)
    out = np.empty(a.shape, dtype=object)
    flat = out.reshape(-1)
    for i, v in enumerate(a.reshape(-1)):
        v = v.item()
        flat[i] = bool(v) if isinstance(v, bool) else float(v)
    return out


def _filled(shape, value):
    out = np.empty(tuple(shape), dtype=object)
    out[...] = value
    return out


def _dim(d, ndim):
    return d + ndim if d < 0 else d


class _Interp:
    """Interpret one functionalized aten graph over object arrays."""

    def __init__(self, bld: _Dag):
        self.bld = bld

    # -- elementwise ---------------------------------------------------------

    def ew(self, name, *vals):
        arrs = [_obj(v) for v in vals]
        bc = np.broadcast_arrays(*arrs)
        out = np.empty(bc[0].shape, dtype=object)
        for idx in np.ndindex(out.shape):
            out[idx] = self.bld.op(name, *(b[idx] for b in bc))
        return out

    def reduce(self, name, x, dims, keepdim):
        x = _obj(x)
        if dims is None or len(dims) == 0:
            dims = list(range(x.ndim))
        dims = sorted({_dim(d, x.ndim) for d in dims})
        keep = [d for d in range(x.ndim) if d not in dims]
        moved = np.transpose(x, dims + keep)
        n = int(np.prod([x.shape[d] for d in dims], dtype=np.int64))
        flat = moved.reshape((n, -1))
        out = np.empty(flat.shape[1], dtype=object)
        for j in range(flat.shape[1]):
            acc = flat[0, j]
            for i in range(1, n):
                acc = self.bld.op(name, acc, flat[i, j])
            out[j] = acc
        shape = tuple(x.shape[d] for d in keep)
        out = out.reshape(shape)
        if keepdim:
            out = out.reshape(tuple(1 if d in dims else x.shape[d]
                                    for d in range(x.ndim)))
        return out

    # -- scatters ------------------------------------------------------------

    @staticmethod
    def diagonal_scatter(x, src, offset=0, dim1=0, dim2=1):
        out = np.array(_obj(x), dtype=object, copy=True)
        src = _obj(src)
        view = np.moveaxis(out, (_dim(dim1, out.ndim), _dim(dim2, out.ndim)),
                           (-2, -1))
        for k in range(src.shape[-1]):
            view[..., k + max(-offset, 0), k + max(offset, 0)] = src[..., k]
        return out

    @staticmethod
    def select_scatter(x, src, dim, index):
        out = np.array(_obj(x), dtype=object, copy=True)
        dim = _dim(dim, out.ndim)
        np.moveaxis(out, dim, 0)[index, ...] = _obj(src)
        return out

    @staticmethod
    def slice_scatter(x, src, dim=0, start=None, end=None, step=1):
        out = np.array(_obj(x), dtype=object, copy=True)
        dim = _dim(dim, out.ndim)
        idx = [slice(None)] * out.ndim
        idx[dim] = slice(start, end, step)
        out[tuple(idx)] = _obj(src)
        return out

    # -- dispatch ------------------------------------------------------------

    def call(self, target, args, kwargs, val):
        if target is operator.getitem:
            return args[0][args[1]]
        name = target._schema.name.split("::")[1]
        overload = target._overloadname
        shape = tuple(val.shape) if isinstance(val, torch.Tensor) else None
        if isinstance(val, torch.Tensor) and not (
                val.dtype.is_floating_point or val.dtype == torch.bool):
            raise NotImplementedError(
                f"scalarize: aten.{name}.{overload} gives {val.dtype}; only "
                "floating and bool values are supported")
        base = name[:-5] if name.endswith("_copy") and name not in (
            "_to_copy", "lift_fresh_copy") else name
        fn = getattr(self, f"a_{base}", None)
        if fn is not None:
            out = fn(*args, **kwargs)
        elif base in _ALIASES:
            out = self.ew(_ALIASES[base], *args)
        elif base in _IGNORED:
            return None
        else:
            raise NotImplementedError(
                f"scalarize: aten op {name}.{overload} is not covered")
        if out is None:
            return None
        if shape is not None:
            out = _obj(out)
            if out.shape != shape:
                out = np.broadcast_to(out, shape)
        return out

    # arithmetic with alpha / rounding modes
    def a_add(self, a, b, alpha=1):
        return self.ew("add", a, b if alpha == 1 else self.ew("mul", b, alpha))

    def a_sub(self, a, b, alpha=1):
        return self.ew("sub", a, b if alpha == 1 else self.ew("mul", b, alpha))

    def a_rsub(self, a, b, alpha=1):
        return self.a_sub(b, a, alpha)

    def a_div(self, a, b, rounding_mode=None):
        if rounding_mode is not None:
            raise NotImplementedError(f"scalarize: div rounding {rounding_mode}")
        return self.ew("div", a, b)

    def a_where(self, c, a, b):
        return self.ew("where", c, a, b)

    # identities and dtype conversions (the emitted code stays in scalar_t)
    def a__to_copy(self, x, dtype=None, **_):
        if dtype is None or dtype.is_floating_point:
            return _obj(x)
        if dtype == torch.bool:
            return self.ew("ne", x, 0.0)
        raise NotImplementedError(f"scalarize: conversion to {dtype}")

    def _identity(self, x, *_, **__):
        return _obj(x)

    a_clone = a_alias = a_lift_fresh_copy = a_detach = a_contiguous = \
        a_positive = _identity

    def a_copy(self, x, src, non_blocking=False):
        return np.broadcast_to(_obj(src), _obj(x).shape)

    # constants
    def a_fill(self, x, value):
        return _filled(_obj(x).shape, _obj(value)[()])

    def a_zeros_like(self, x, **_):
        return _filled(_obj(x).shape, 0.0)

    a_empty_like = a_zeros_like

    def a_ones_like(self, x, **_):
        return _filled(_obj(x).shape, 1.0)

    def a_full_like(self, x, value, **_):
        return _filled(_obj(x).shape, _obj(value)[()])

    def a_new_zeros(self, x, size, **_):
        return _filled(size, 0.0)

    a_new_empty = a_new_zeros

    def a_new_ones(self, x, size, **_):
        return _filled(size, 1.0)

    def a_new_full(self, x, size, value, **_):
        return _filled(size, float(value))

    def a_zeros(self, size, **_):
        return _filled(size, 0.0)

    a_empty = a__efficientzerotensor = a_zeros

    def a_ones(self, size, **_):
        return _filled(size, 1.0)

    def a_full(self, size, value, **_):
        return _filled(size, float(value))

    def a_scalar_tensor(self, value, **_):
        return _filled((), float(value))

    def a__new_zeros_with_same_feature_meta(self, x, other, **_):
        return None  # shape from the node's value

    def a_eye(self, n, m=None, **_):
        return _obj(np.eye(n, n if m is None else m))

    # shapes
    def a_select(self, x, dim, index):
        x = _obj(x)
        return np.take(x, index, axis=_dim(dim, x.ndim))

    def a_slice(self, x, dim=0, start=None, end=None, step=1):
        x = _obj(x)
        idx = [slice(None)] * x.ndim
        idx[_dim(dim, x.ndim)] = slice(start, end, step)
        return x[tuple(idx)]

    def a_view(self, x, size):
        return _obj(x).reshape(tuple(size))

    a_reshape = a__unsafe_view = a_view

    def a_expand(self, x, size, implicit=False):
        x = _obj(x)
        lead = len(size) - x.ndim
        shape = tuple(x.shape[i - lead] if s == -1 else s
                      for i, s in enumerate(size))
        return np.broadcast_to(x, shape)

    def a_unsqueeze(self, x, dim):
        x = _obj(x)
        return np.expand_dims(x, _dim(dim, x.ndim + 1))

    def a_squeeze(self, x, dim=None):
        x = _obj(x)
        dims = range(x.ndim) if dim is None else (
            dim if isinstance(dim, (list, tuple)) else [dim])
        dims = tuple(_dim(d, x.ndim) for d in dims if x.shape[d] == 1)
        return np.squeeze(x, axis=dims)

    def a_permute(self, x, dims):
        return np.transpose(_obj(x), tuple(dims))

    def a_t(self, x):
        return _obj(x).T

    def a_transpose(self, x, d0, d1):
        return np.swapaxes(_obj(x), d0, d1)

    def a_diagonal(self, x, offset=0, dim1=0, dim2=1):
        x = _obj(x)
        return np.array(np.diagonal(x, offset, _dim(dim1, x.ndim),
                                    _dim(dim2, x.ndim)), dtype=object)

    def a_diagonal_scatter(self, x, src, offset=0, dim1=0, dim2=1):
        return self.diagonal_scatter(x, src, offset, dim1, dim2)

    def a_select_scatter(self, x, src, dim, index):
        return self.select_scatter(x, src, dim, index)

    def a_slice_scatter(self, x, src, dim=0, start=None, end=None, step=1):
        return self.slice_scatter(x, src, dim, start, end, step)

    def a_select_backward(self, g, sizes, dim, index):
        return self.select_scatter(_filled(sizes, 0.0), g, dim, index)

    def a_slice_backward(self, g, sizes, dim, start, end, step):
        return self.slice_scatter(_filled(sizes, 0.0), g, dim, start, end,
                                  step)

    def a_diagonal_backward(self, g, sizes, offset, dim1, dim2):
        return self.diagonal_scatter(_filled(sizes, 0.0), g, offset, dim1,
                                     dim2)

    def a_split_with_sizes(self, x, sizes, dim=0):
        x = _obj(x)
        return np.split(x, np.cumsum(sizes)[:-1], axis=_dim(dim, x.ndim))

    def a_stack(self, xs, dim=0):
        xs = [_obj(x) for x in xs]
        return np.stack(xs, axis=_dim(dim, xs[0].ndim + 1))

    def a_cat(self, xs, dim=0):
        xs = [_obj(x) for x in xs if _obj(x).size or _obj(x).ndim > 1]
        return np.concatenate(xs, axis=_dim(dim, xs[0].ndim))

    # reductions
    def a_sum(self, x, dim=None, keepdim=False, dtype=None):
        return self.reduce("add", x, dim, keepdim)

    def a_amax(self, x, dim=(), keepdim=False):
        return self.reduce("max", x, dim, keepdim)

    def a_amin(self, x, dim=(), keepdim=False):
        return self.reduce("min", x, dim, keepdim)

    def a_max(self, x, *rest):
        if rest:
            if isinstance(rest[0], int):
                raise NotImplementedError("scalarize: max with indices")
            return self.ew("max", x, rest[0])
        return self.reduce("max", x, None, False)

    def a_min(self, x, *rest):
        if rest:
            if isinstance(rest[0], int):
                raise NotImplementedError("scalarize: min with indices")
            return self.ew("min", x, rest[0])
        return self.reduce("min", x, None, False)


# Elementwise aten ops with this module's op name.
_ALIASES = {
    "mul": "mul", "neg": "neg", "abs": "abs", "sin": "sin", "cos": "cos",
    "tan": "tan", "exp": "exp", "log": "log", "sqrt": "sqrt",
    "rsqrt": "rsqrt", "tanh": "tanh", "sigmoid": "sigmoid",
    "reciprocal": "reciprocal", "log1p": "log1p", "expm1": "expm1",
    "asin": "asin", "acos": "acos", "atan": "atan", "sinh": "sinh",
    "cosh": "cosh", "maximum": "max", "minimum": "min",
    "remainder": "rem", "pow": "pow", "atan2": "atan2",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "logical_and": "and", "logical_or": "or", "logical_not": "not",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_not": "not",
}
# Metadata checks that forward-mode AD leaves in the graph: no value.
_IGNORED = {"is_same_size", "_has_same_storage_numel"}


def _resolve(a, env):
    if isinstance(a, torch.fx.Node):
        return env[a]
    if isinstance(a, (list, tuple)):
        return type(a)(_resolve(x, env) for x in a)
    if isinstance(a, dict):
        return {k: _resolve(v, env) for k, v in a.items()}
    return a


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


def _c_const(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if math.isnan(v):
        return "scalar_t(NAN)"
    if math.isinf(v):
        return "scalar_t(INFINITY)" if v > 0 else "-scalar_t(INFINITY)"
    return f"scalar_t({v!r})"


class ScalarProgram:
    """A scalarized stage program: inputs and outputs of fixed small shapes,
    and the DAG between them."""

    def __init__(self, name, in_shapes, out_shapes, outs, order, stats):
        self.name = name
        self.in_shapes = in_shapes    # list of tuples
        self.out_shapes = out_shapes  # list of tuples
        self.outs = outs              # object arrays of Node | constant
        self.order = order            # reachable nodes, topological order
        self.stats = stats

    def c_source(self, indent: str = "") -> str:
        """The program as ``template <typename scalar_t> static IPOC_HD void
        name(const scalar_t* in0, ..., scalar_t* out0, ...)``: every input
        and output a flat row-major array (a 0-d value has one element)."""
        params = [f"const scalar_t* __restrict__ in{i}"
                  for i in range(len(self.in_shapes))]
        params += [f"scalar_t* __restrict__ out{i}"
                   for i in range(len(self.out_shapes))]
        lines = ["template <typename scalar_t>",
                 f"static IPOC_HD void {self.name}("
                 + ", ".join(params) + ") {"]
        names = {}
        for k, nd in enumerate(self.order):
            var = f"v{k}"
            names[id(nd)] = var
            if nd.op == "input":
                pos, idx = nd.args
                lines.append(f"  const scalar_t {var} = in{pos}[{idx}];")
                continue
            ins = [names[id(a)] if isinstance(a, Node) else _c_const(a)
                   for a in nd.args]
            ctype = "bool" if nd.is_bool else "scalar_t"
            lines.append(f"  const {ctype} {var} = "
                         f"{_C[nd.op].format(*ins)};")
        for i, arr in enumerate(self.outs):
            for j, e in enumerate(arr.reshape(-1)):
                v = names[id(e)] if isinstance(e, Node) else _c_const(e)
                lines.append(f"  out{i}[{j}] = scalar_t({v});"
                             if isinstance(e, Node) and e.is_bool
                             else f"  out{i}[{j}] = {v};")
        lines.append("}")
        return "\n".join(indent + ln for ln in lines)

    def split(self, arg: int, names=("pre", "post"), outputs=None):
        """Split the program at input ``arg``: ``(pre, post)``, two programs
        that compute this one's DAG (its outputs ``outputs``, by default
        all of them).

        ``pre`` takes every input but ``arg`` and returns one vector, the
        handoff values: the calls of elementary functions
        (``ELEMENTARY_CALLS``: sin, cos, log, rem, ...) that do not depend
        on ``arg`` and that ``post`` reads, and the inputs it reads.
        ``post`` takes ``(handoff, arg)`` and computes everything else
        that the outputs need, the arithmetic that does not depend on
        ``arg`` included.  So the arithmetic reaches the compiler in one
        piece, as in the whole program: ``nvcc`` contracts a product into
        the sum that reads it (an FMA, one rounding) where it sees both,
        and folds a negation into a product, as it sees them; handing off
        arithmetic values changed which products it contracted.  Every
        node keeps its operation and operands, so ``post(pre(...), a)`` is
        this program's result to the bit (a boolean handoff value goes
        through ``scalar_t`` as 0 or 1)."""
        sel = range(len(self.outs)) if outputs is None else list(outputs)
        dep = {}
        for nd in self.order:
            dep[id(nd)] = (nd.args[0] == arg if nd.op == "input" else
                           any(dep[id(a)] for a in nd.args
                               if isinstance(a, Node)))
        outs = {id(e): e for i in sel for e in self.outs[i].reshape(-1)
                if isinstance(e, Node)}
        needed = _reach(outs.values())
        readers = {}
        for nd in self.order:
            for a in nd.args:
                if isinstance(a, Node):
                    readers.setdefault(id(a), []).append(nd)
        # What post computes, decided from the last node back (a node's
        # readers come after it).
        post = set()
        for nd in reversed(self.order):
            if nd.op == "input" or id(nd) not in needed:
                continue
            if dep[id(nd)] or nd.op not in ELEMENTARY_CALLS and (id(nd) in outs or any(
                    id(r) in post for r in readers.get(id(nd), ()))):
                post.add(id(nd))
        hand = {}
        for nd in self.order:
            if id(nd) in post:
                for a in nd.args:
                    if isinstance(a, Node) and id(a) not in post \
                            and not dep[id(a)]:
                        hand[id(a)] = a
        for e in outs.values():
            if id(e) not in post and not dep[id(e)]:
                hand[id(e)] = e
        handoff = sorted(hand.values(), key=lambda nd: nd.order)

        n = len(handoff)
        keep = [i for i in range(len(self.in_shapes)) if i != arg]

        def pre_leaf(nd):
            if nd.op == "input":
                return Node("input", (keep.index(nd.args[0]), nd.args[1]),
                            nd.order)
            return None

        pre_new = _rebuild(handoff, pre_leaf)
        pre_out = np.empty((n,), dtype=object)
        for k, nd in enumerate(handoff):
            pre_out[k] = pre_new[id(nd)]
        first = min((nd.order for nd in self.order), default=0) - 1
        h_in = {}
        for k, nd in enumerate(handoff):
            node = Node("input", (0, k), first - 2 * n + 2 * k)
            h_in[id(nd)] = (Node("ne", (node, 0.0), first - 2 * n + 2 * k + 1)
                            if nd.is_bool else node)

        def post_leaf(nd):
            if id(nd) in h_in:
                return h_in[id(nd)]
            if nd.op == "input":
                return Node("input", (1, nd.args[1]), nd.order)
            return None

        post_new = _rebuild(outs.values(), post_leaf)
        pre = _program(names[0], [self.in_shapes[i] for i in keep], [pre_out])
        post = _program(names[1], [(n,), self.in_shapes[arg]],
                        [_mapped(self.outs[i], post_new) for i in sel])
        return pre, post

    def cut(self, inputs, outputs, name, factor=()):
        """The part of the program that computes ``outputs`` (indices of its
        outputs) from ``inputs``, as a program of its own.

        ``inputs`` lists the new program's arguments in order, each
        ``("in", k)`` (this program's input k) or ``("out", k)`` (its output
        k: the cut starts at those values, as from an earlier part's
        results).  Raises ``ValueError`` where an output reads an input of
        this program that ``inputs`` does not list.  Each output in
        ``factor`` (0-d) comes out as the pair ``(a, b)`` with ``a * b``
        its value: the operands of a product, else ``(value, 1)``; a sum
        of such values then contracts into FMAs where the whole program's
        did.  Every node keeps its operation and operands."""
        leaf = {}
        for pos, (kind, k) in enumerate(inputs):
            if kind == "out":
                for j, e in enumerate(self.outs[k].reshape(-1)):
                    if isinstance(e, Node) and id(e) not in leaf:
                        leaf[id(e)] = (pos, j)
            else:
                for nd in self.order:
                    if nd.op == "input" and nd.args[0] == k:
                        leaf[id(nd)] = (pos, nd.args[1])
        in_shapes = [self.out_shapes[k] if kind == "out" else self.in_shapes[k]
                     for kind, k in inputs]

        def new_leaf(nd):
            if id(nd) in leaf:
                return Node("input", leaf[id(nd)], nd.order)
            if nd.op == "input":
                raise ValueError(
                    f"cut of {self.name}: outputs {list(outputs)} read input "
                    f"{nd.args[0]}, which the cut's inputs {list(inputs)} "
                    "do not hold")
            return None

        roots = [e for k in outputs for e in self.outs[k].reshape(-1)
                 if isinstance(e, Node)]
        new = _rebuild(roots, new_leaf)
        outs = []
        for k in outputs:
            arr = _mapped(self.outs[k], new)
            if k in factor:
                arr = _factor(arr.item())
            outs.append(arr)
        return _program(name, in_shapes, outs)

    def evaluate(self, *args):
        """Evaluate the DAG with torch on batch-last tensors: argument ``i``
        has shape ``in_shapes[i] + (B,)``; each output ``out_shape + (B,)``,
        in the arguments' dtype."""
        B = args[0].shape[-1]
        dtype, device = args[0].dtype, args[0].device
        rows = [a.reshape(-1, B) for a in args]

        def const(c):
            return torch.full((B,), c, device=device,
                              dtype=torch.bool if isinstance(c, bool)
                              else dtype)

        val = {}
        for nd in self.order:
            if nd.op == "input":
                pos, idx = nd.args
                val[id(nd)] = rows[pos][idx]
            else:
                ins = [val[id(a)] if isinstance(a, Node) else const(a)
                       for a in nd.args]
                val[id(nd)] = _TORCH[nd.op](*ins)
        outs = []
        for shape, arr in zip(self.out_shapes, self.outs):
            elems = [val[id(e)].to(dtype) if isinstance(e, Node)
                     else const(float(e)) for e in arr.reshape(-1)]
            stacked = (torch.stack(elems) if elems
                       else torch.empty((0, B), dtype=dtype, device=device))
            outs.append(stacked.reshape(tuple(shape) + (B,)))
        return tuple(outs)


def _reach(roots):
    """``id -> node`` of every node that ``roots`` reach."""
    seen = {}
    stack = list(roots)
    while stack:
        nd = stack.pop()
        if id(nd) in seen:
            continue
        seen[id(nd)] = nd
        stack.extend(a for a in nd.args if isinstance(a, Node))
    return seen


def _rebuild(roots, leaf):
    """New nodes for everything ``roots`` reach, in creation order;
    ``leaf(nd)`` gives the new node of an old input or handoff node, or
    None to rebuild it from its operands."""
    new = {}
    stack = list(roots)
    seen = {}
    while stack:
        nd = stack.pop()
        if id(nd) in seen:
            continue
        seen[id(nd)] = nd
        if leaf(nd) is None:
            stack.extend(a for a in nd.args if isinstance(a, Node))
    for nd in sorted(seen.values(), key=lambda nd: nd.order):
        got = leaf(nd)
        new[id(nd)] = got if got is not None else Node(
            nd.op, tuple(new[id(a)] if isinstance(a, Node) else a
                         for a in nd.args), nd.order)
    return new


def _mapped(arr, new):
    """``arr`` (an object array of nodes and constants) with each node
    replaced by ``new[id(node)]``."""
    out = np.empty(arr.shape, dtype=object)
    for idx in np.ndindex(arr.shape):
        e = arr[idx]
        out[idx] = new[id(e)] if isinstance(e, Node) else e
    return out


def _factor(e):
    """The pair ``(a, b)`` with ``a * b == e`` exactly (see
    :meth:`ScalarProgram.cut`)."""
    out = np.empty((2,), dtype=object)
    if isinstance(e, Node) and e.op == "mul":
        out[0], out[1] = e.args
    else:
        out[0], out[1] = e, 1.0
    return out


def _program(name, in_shapes, outs):
    """A program of the nodes that ``outs`` reach, in creation order,
    inputs included (the handoff inputs of a split's post, and their
    boolean views, sort first)."""
    order = sorted(_reach(e for arr in outs for e in arr.reshape(-1)
                          if isinstance(e, Node)).values(),
                   key=lambda nd: nd.order)
    stats = {"ops": sum(1 for nd in order if nd.op != "input")}
    return ScalarProgram(name, [tuple(s) for s in in_shapes],
                         [tuple(o.shape) for o in outs], outs, order, stats)


def same_program(p: "ScalarProgram", q: "ScalarProgram") -> bool:
    """Whether ``p`` and ``q`` compute their outputs with the same
    operations on the same operands (the same DAG up to node identity)."""
    if p.in_shapes != q.in_shapes or p.out_shapes != q.out_shapes:
        return False
    pair = {}
    stack = [(a, b) for x, y in zip(p.outs, q.outs)
             for a, b in zip(x.reshape(-1), y.reshape(-1))]
    while stack:
        a, b = stack.pop()
        if isinstance(a, Node) != isinstance(b, Node):
            return False
        if not isinstance(a, Node):
            if _ckey(a) != _ckey(b):
                return False
            continue
        if id(a) in pair:
            if pair[id(a)] is not b:
                return False
            continue
        pair[id(a)] = b
        if a.op != b.op or len(a.args) != len(b.args):
            return False
        if a.op == "input":
            if a.args != b.args:
                return False
            continue
        stack.extend(zip(a.args, b.args))
    return True


def trace(fn, example_args):
    """``make_fx`` of the functionalized ``fn``: the aten graph."""
    from torch.func import functionalize
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(functionalize(fn, remove="mutations_and_views"))(
        *example_args)


def scalarize(fn, in_shapes, name: str = "program") -> ScalarProgram:
    """Trace ``fn`` on float64 inputs of ``in_shapes`` and scalarize it.

    ``fn`` returns a tensor or a tuple of tensors.  Raises
    ``NotImplementedError`` for an aten op the interpreter does not cover.
    """
    gen = torch.Generator().manual_seed(0)
    example = [0.1 + 0.4 * torch.rand(tuple(s), generator=gen,
                                      dtype=torch.float64)
               for s in in_shapes]
    gm = trace(fn, example)
    bld = _Dag()
    interp = _Interp(bld)
    env, outs, n_traced, targets = {}, None, 0, set()
    pos = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            shape = tuple(in_shapes[pos])
            a = np.empty(shape, dtype=object)
            flat = a.reshape(-1)
            for i in range(flat.size):
                flat[i] = bld.input(pos, i)
            env[node] = a
            pos += 1
        elif node.op == "get_attr":
            env[node] = _obj(getattr(gm, node.target))
        elif node.op == "call_function":
            n_traced += 1
            targets.add(str(node.target))
            val = node.meta.get("val")
            out = interp.call(node.target, _resolve(node.args, env),
                              _resolve(node.kwargs, env), val)
            if out is None and isinstance(val, torch.Tensor):
                out = _filled(tuple(val.shape), 0.0)
            env[node] = out
        elif node.op == "output":
            res = _resolve(node.args[0], env)
            outs = list(res) if isinstance(res, (list, tuple)) else [res]
    outs = [_obj(o) for o in outs]

    # Reachability from the outputs, then emission in creation order.
    needed = {}
    stack = [e for arr in outs for e in arr.reshape(-1) if isinstance(e, Node)]
    while stack:
        nd = stack.pop()
        if id(nd) in needed:
            continue
        needed[id(nd)] = nd
        if nd.op != "input":
            stack.extend(a for a in nd.args
                         if isinstance(a, Node) and id(a) not in needed)
    order = sorted(needed.values(), key=lambda nd: nd.order)
    stats = {"traced_nodes": n_traced, "aten_targets": len(targets),
             "ops": sum(1 for nd in order if nd.op != "input"),
             "created": bld.n_created, "folded": bld.n_folded,
             "cse_hits": bld.n_hits}
    return ScalarProgram(name, [tuple(s) for s in in_shapes],
                         [tuple(o.shape) for o in outs], outs, order, stats)
