"""The lane IR: what the LaneCompiler (struct.compile) builds, and its
torch evaluator.

The reference's LaneCompiler walks a spec's AST once per trace and emits
``jax.numpy`` operations that XLA fuses into one device program.  The
port's compiler runs the same walk against this module instead: every
array it makes is a ``Node`` of a static per-row shape and a dtype (bool
or int32), and the graph of nodes is the spec's step (or invariant) as
data.  Two realizations read the same graph:

* ``evaluate`` runs it with torch on a batch of rows: the plain version
  of kernels K17 and K18, and the CPU path;
* struct.emit prints it as ``__host__ __device__`` C++, the body of K17
  and K18 (nvcc builds it for the card, g++ for the host tests).

The module doubles as the numpy-style facade the compiler calls
(``asarray``, ``where``, ``stack``, ``einsum``, ...; nodes overload the
operators, ``astype``, ``sum``, ``any``, ``all``, ``cumsum`` and
indexing), so the compiler keeps the reference's code line for line.

Shapes are per row, exactly as the reference traces its step on one row
(``vec[None]``, shape ``[1, F]``, under ``jax.vmap``): ``input_node(F)`` is
``[1, F]`` and every shape derives from it by numpy broadcasting.  The
evaluator adds the rows as a leading axis in front of every value, as vmap
does.  Semantics are jax.numpy's on int32 and bool: wrapping int32
arithmetic, floor division and modulo, first-index argmax/argmin, and
gathers that wrap a negative index once and clamp (jax's default gather
mode).  Every node is hash-consed, so a subexpression the walk builds
twice is one node, and a node whose operands are all constants is folded.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Sequence

import numpy as np
import torch


int32 = "int32"
bool_ = "bool"

_NUMPY = {int32: np.int32, bool_: np.bool_}


class LaneIRError(ValueError):
    pass


def _dtype_of(d) -> str:
    if d in (int32, bool_):
        return d
    if d is bool or d is np.bool_ or d == np.dtype(bool):
        return bool_
    if d in (int, np.int32, np.int64) or d == np.dtype(np.int32):
        return int32
    raise LaneIRError(f"unsupported dtype {d!r}")


def _bshape(*shapes):
    """numpy broadcasting of per-row shapes."""
    nd = max((len(s) for s in shapes), default=0)
    out = []
    for k in range(nd):
        d = 1
        for s in shapes:
            x = s[len(s) - nd + k] if len(s) - nd + k >= 0 else 1
            if x == 1:
                continue
            if d not in (1, x):
                raise LaneIRError(f"shapes {shapes} do not broadcast")
            d = x
        out.append(d)
    return tuple(out)


def row_size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


_MEMO: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class Node:
    """One lane-IR operation.  ``op`` names it, ``args`` are its operand
    nodes, ``attr`` its static parameters, ``value`` a constant's numpy
    payload."""

    __slots__ = ("op", "args", "attr", "shape", "dtype", "value",
                 "__weakref__")
    __array_priority__ = 1000  # numpy defers its operators to ours

    def __init__(self, op, args, attr, shape, dtype, value=None):
        self.op = op
        self.args = args
        self.attr = attr
        self.shape = shape
        self.dtype = dtype
        self.value = value

    def __repr__(self):
        return f"Node({self.op}, {self.shape}, {self.dtype})"

    __hash__ = object.__hash__

    def __bool__(self):
        raise LaneIRError("a lane value has no host truth value")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_const(self) -> bool:
        return self.op == "const"

    # -- operators ------------------------------------------------------

    def __add__(self, o):
        return _binary("add", self, o)

    def __radd__(self, o):
        return _binary("add", o, self)

    def __sub__(self, o):
        return _binary("sub", self, o)

    def __rsub__(self, o):
        return _binary("sub", o, self)

    def __mul__(self, o):
        return _binary("mul", self, o)

    def __rmul__(self, o):
        return _binary("mul", o, self)

    def __floordiv__(self, o):
        return _binary("floordiv", self, o)

    def __rfloordiv__(self, o):
        return _binary("floordiv", o, self)

    def __mod__(self, o):
        return _binary("mod", self, o)

    def __rmod__(self, o):
        return _binary("mod", o, self)

    def __and__(self, o):
        return _binary("and", self, o)

    def __rand__(self, o):
        return _binary("and", o, self)

    def __or__(self, o):
        return _binary("or", self, o)

    def __ror__(self, o):
        return _binary("or", o, self)

    def __xor__(self, o):
        return _binary("xor", self, o)

    def __rxor__(self, o):
        return _binary("xor", o, self)

    def __rshift__(self, o):
        return _binary("shr", self, o)

    def __lshift__(self, o):
        return _binary("shl", self, o)

    def __rlshift__(self, o):
        return _binary("shl", o, self)

    def __eq__(self, o):
        return _binary("eq", self, o)

    def __ne__(self, o):
        return _binary("ne", self, o)

    def __lt__(self, o):
        return _binary("lt", self, o)

    def __le__(self, o):
        return _binary("le", self, o)

    def __gt__(self, o):
        return _binary("gt", self, o)

    def __ge__(self, o):
        return _binary("ge", self, o)

    def __invert__(self):
        return _make("not" if self.dtype == bool_ else "bnot", (self,), (),
                     self.shape, self.dtype)

    def __neg__(self):
        return _binary("sub", 0, self)

    # -- methods --------------------------------------------------------

    def astype(self, dtype):
        return _cast(self, _dtype_of(dtype))

    def sum(self, axis=None):
        return _reduce("sum", self, axis)

    def any(self, axis=None):
        return _reduce("any", self, axis)

    def all(self, axis=None):
        return _reduce("all", self, axis)

    def cumsum(self, axis=-1):
        ax = _axis(self, axis)
        x = _cast(self, int32)
        return _make("cumsum", (x,), (ax,), self.shape, int32)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _reshape(self, tuple(shape))

    def __getitem__(self, key):
        return _getitem(self, key)


# ---------------------------------------------------------------------------
# node construction (hash-consed, constants folded)
# ---------------------------------------------------------------------------


def _const_key(value: np.ndarray):
    return ("const", value.dtype.str, value.shape, value.tobytes())


def const(value, dtype=None) -> Node:
    """A constant node from a numpy array or Python scalar."""
    arr = np.asarray(value)
    if dtype is None:
        dtype = bool_ if arr.dtype == np.bool_ else int32
    dtype = _dtype_of(dtype)
    if dtype == int32 and arr.dtype != np.int32:
        if arr.size and (arr.min() < -(1 << 31) or arr.max() >= (1 << 31)):
            raise LaneIRError("constant outside int32")
    arr = np.array(arr, dtype=_NUMPY[dtype], order="C")  # keeps 0-d
    key = _const_key(arr)
    hit = _MEMO.get(key)
    if hit is not None:
        return hit
    arr.setflags(write=False)
    n = Node("const", (), (), tuple(arr.shape), dtype, arr)
    _MEMO[key] = n
    return n


def input_node(n_fields: int) -> Node:
    """The step's input: one state row, ``[1, n_fields]`` int32 fields
    (the evaluator feeds a block of them)."""
    key = ("input", n_fields)
    hit = _MEMO.get(key)
    if hit is not None:
        return hit
    n = Node("input", (), (n_fields,), (1, n_fields), int32)
    _MEMO[key] = n
    return n


def _make(op, args, attr, shape, dtype) -> Node:
    args = tuple(args)
    key = (op, tuple(id(a) for a in args), attr, dtype)
    hit = _MEMO.get(key)
    if hit is not None:
        return hit
    n = Node(op, args, attr, tuple(shape), dtype)
    if args and all(a.is_const for a in args):
        # fold: the torch evaluator computes the constant once
        return const(evaluate([n], None)[0][0].numpy(), dtype)
    _MEMO[key] = n
    return n


def asarray(x, dtype=None) -> Node:
    if isinstance(x, Node):
        return x if dtype is None else x.astype(dtype)
    return const(x, dtype)


def _lift(x) -> Node:
    """Python scalar -> 0-d constant (weakly typed: see _binary)."""
    if isinstance(x, Node):
        return x
    if isinstance(x, (bool, np.bool_)):
        return const(bool(x), bool_)
    if isinstance(x, (int, np.integer)):
        return const(int(x), int32)
    if isinstance(x, np.ndarray):
        return const(x)
    raise LaneIRError(f"cannot lift {type(x).__name__} into the lane IR")


_ARITH = ("add", "sub", "mul", "floordiv", "mod", "shr", "shl", "max", "min")
_CMP = ("eq", "ne", "lt", "le", "gt", "ge")
_BIT = ("and", "or", "xor")


def _weak(a, b):
    """jax's promotion of a Python scalar against an array: a bool scalar
    takes the array's type, an int scalar makes a bool array int."""
    weak_a, weak_b = not isinstance(a, Node), not isinstance(b, Node)
    a, b = _lift(a), _lift(b)
    if weak_a and not weak_b and a.dtype == bool_:
        a = _cast(a, b.dtype)
    if weak_b and not weak_a and b.dtype == bool_:
        b = _cast(b, a.dtype)
    return a, b


def _binary(op, a, b) -> Node:
    a, b = _weak(a, b)
    shape = _bshape(a.shape, b.shape)
    if op in _CMP:
        if a.dtype != b.dtype:
            a, b = _cast(a, int32), _cast(b, int32)
        return _make(op, (a, b), (), shape, bool_)
    if op in _BIT:
        if a.dtype == b.dtype == bool_:
            return _make(op, (a, b), (), shape, bool_)
        return _make(op, (_cast(a, int32), _cast(b, int32)), (), shape,
                     int32)
    if op in _ARITH:
        if op in ("max", "min") and a.dtype == b.dtype == bool_:
            return _make("or" if op == "max" else "and", (a, b), (), shape,
                         bool_)
        return _make(op, (_cast(a, int32), _cast(b, int32)), (), shape,
                     int32)
    raise LaneIRError(op)


def _cast(x: Node, dtype: str) -> Node:
    if x.dtype == dtype:
        return x
    return _make("cast", (x,), (dtype,), x.shape, dtype)


def _axis(x: Node, axis) -> int:
    ax = axis + x.ndim if axis < 0 else axis
    if not 0 <= ax < x.ndim:
        raise LaneIRError(f"axis {axis} out of range for {x.shape}")
    return ax


def _reduce(kind, x: Node, axis) -> Node:
    if axis is None:
        raise LaneIRError(f"{kind} needs an axis")
    ax = _axis(x, axis)
    shape = x.shape[:ax] + x.shape[ax + 1:]
    if kind in ("any", "all"):
        return _make(kind, (_cast(x, bool_),), (ax,), shape, bool_)
    if kind == "sum":
        return _make("sum", (_cast(x, int32),), (ax,), shape, int32)
    # argmax / argmin: jax compares bools as 0/1
    return _make(kind, (_cast(x, int32),), (ax,), shape, int32)


def _reshape(x: Node, shape: tuple) -> Node:
    """Row-major reshape to a shape of the same size."""
    shape = tuple(shape)
    if shape == x.shape:
        return x
    if x.is_const:
        return const(x.value.reshape(shape), x.dtype)
    if row_size(shape) != row_size(x.shape):
        raise LaneIRError(f"reshape {x.shape} -> {shape}")
    return _make("reshape", (x,), (shape,), shape, x.dtype)


def _getitem(x: Node, key) -> Node:
    if isinstance(key, Node) and x.is_const:
        # table gather: x [n] constant, key any int shape
        if x.ndim != 1:
            raise LaneIRError("gather from a constant of rank != 1")
        idx = _cast(key, int32)
        return _make("gather", (x, idx), (), idx.shape, x.dtype)
    if not isinstance(key, tuple):
        key = (key,)
    n_real = sum(1 for k in key if k is not None and k is not Ellipsis)
    if sum(1 for k in key if k is Ellipsis) > 1:
        raise LaneIRError("two ellipses")
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (x.ndim - n_real) + key[i + 1:]
    else:
        key = key + (slice(None),) * (x.ndim - n_real)
    # per input axis: None (keep), ("int", i), ("slice", a, b), ("take", ids)
    per_axis, out_shape, ax = [], [], 0
    for k in key:
        if k is None:
            out_shape.append(1)
            continue
        dim = x.shape[ax]
        if isinstance(k, slice):
            if k.step not in (None, 1):
                raise LaneIRError("strided slice")
            if k.start is None and k.stop is None:
                per_axis.append(None)
                out_shape.append(dim)
            else:
                a, b, _ = k.indices(dim)
                per_axis.append(("slice", a, b))
                out_shape.append(b - a)
        elif isinstance(k, (int, np.integer)):
            i = int(k) + (dim if k < 0 else 0)
            if not 0 <= i < dim:
                raise LaneIRError("index out of range")
            per_axis.append(("int", i))
        elif isinstance(k, Node) and k.is_const and k.ndim == 1:
            ids = tuple(int(v) + (dim if v < 0 else 0) for v in k.value)
            per_axis.append(("take", ids))
            out_shape.append(len(ids))
        else:
            raise LaneIRError(f"unsupported index {k!r}")
        ax += 1
    y = x
    # apply from the last axis, so earlier axis numbers stay put
    for a in range(len(per_axis) - 1, -1, -1):
        p = per_axis[a]
        if p is None:
            continue
        if p[0] == "int":
            shape = y.shape[:a] + y.shape[a + 1:]
            y = _make("index", (y,), (a, p[1]), shape, y.dtype)
        elif p[0] == "slice":
            shape = y.shape[:a] + (p[2] - p[1],) + y.shape[a + 1:]
            y = _make("slice", (y,), (a, p[1], p[2]), shape, y.dtype)
        else:
            shape = y.shape[:a] + (len(p[1]),) + y.shape[a + 1:]
            y = _make("take", (y,), (a, p[1]), shape, y.dtype)
    return _reshape(y, tuple(out_shape))


# ---------------------------------------------------------------------------
# the jax.numpy facade the compiler calls
# ---------------------------------------------------------------------------


def _full_shape(shape):
    return (shape,) if not isinstance(shape, (tuple, list)) else tuple(shape)


def full(shape, fill_value, dtype=None) -> Node:
    shape = _full_shape(shape)
    if dtype is None:
        dtype = bool_ if isinstance(fill_value, (bool, np.bool_)) else int32
    dtype = _dtype_of(dtype)
    return const(np.full(shape, fill_value), dtype)


def zeros(shape, dtype=None) -> Node:
    return full(shape, 0, int32 if dtype is None else dtype)


def ones(shape, dtype=None) -> Node:
    return full(shape, 1, int32 if dtype is None else dtype)


def zeros_like(x: Node, dtype=None) -> Node:
    return zeros(x.shape, x.dtype if dtype is None else dtype)


def arange(n: int, dtype=None) -> Node:
    return const(np.arange(n, dtype=np.int32), int32)


def where(c, a, b) -> Node:
    c = _cast(_lift(c), bool_)
    a, b = _weak(a, b)
    if a.dtype != b.dtype:
        a, b = _cast(a, int32), _cast(b, int32)
    shape = _bshape(c.shape, a.shape, b.shape)
    return _make("where", (c, a, b), (), shape, a.dtype)


def maximum(a, b) -> Node:
    return _binary("max", a, b)


def minimum(a, b) -> Node:
    return _binary("min", a, b)


def clip(x, lo, hi) -> Node:
    return minimum(maximum(x, lo), hi)


def broadcast_to(x, shape) -> Node:
    x = _lift(x)
    shape = _full_shape(shape)
    if _bshape(x.shape, shape) != shape:
        raise LaneIRError(f"cannot broadcast {x.shape} to {shape}")
    if x.shape == shape:
        return x
    return _make("broadcast", (x,), (shape,), shape, x.dtype)


def broadcast_arrays(*xs) -> List[Node]:
    xs = [_lift(x) for x in xs]
    shape = _bshape(*(x.shape for x in xs))
    return [broadcast_to(x, shape) for x in xs]


def stack(xs: Sequence, axis: int = 0) -> Node:
    """jnp.stack (its operands broadcast to one shape first)."""
    xs = [_lift(x) for x in xs]
    if not xs:
        raise LaneIRError("stack of nothing")
    dtype = xs[0].dtype
    if any(x.dtype != dtype for x in xs):
        dtype = int32
    xs = broadcast_arrays(*(_cast(x, dtype) for x in xs))
    common = _bshape(*(x.shape for x in xs))  # a broadcast constant folds
    nd = len(common) + 1
    ax = axis + nd if axis < 0 else axis
    shape = common[:ax] + (len(xs),) + common[ax:]
    return _make("stack", tuple(xs), (ax,), shape, dtype)


def argmax(x, axis=-1) -> Node:
    return _reduce("argmax", _lift(x), axis)


def argmin(x, axis=-1) -> Node:
    return _reduce("argmin", _lift(x), axis)


def einsum(spec: str, a: Node, m: Node) -> Node:
    """``"...u,uv->...v"`` with a constant 0/1 matrix holding at most one
    1 per row (the compiler's remask): out[..., v] = sum of a[..., u]
    over the u that map to v.  Lowered as the translation table the
    matrix encodes (``remask``), never as a dense product."""
    if spec.replace(" ", "") != "...u,uv->...v":
        raise LaneIRError(f"einsum {spec!r}")
    if not (isinstance(m, Node) and m.is_const and m.ndim == 2):
        raise LaneIRError("einsum needs a constant matrix")
    mv = np.asarray(m.value).astype(np.int64)
    if mv.shape[0] != a.shape[-1] or not np.isin(mv, (0, 1)).all() or (
            mv.sum(axis=1) > 1).any():
        raise LaneIRError("einsum matrix is not a one-hot translation")
    t = np.where(mv.any(axis=1), mv.argmax(axis=1), -1).astype(np.int32)
    a = _cast(a, int32)
    shape = a.shape[:-1] + (mv.shape[1],)
    return _make("remask", (a, const(t, int32)), (mv.shape[1],), shape,
                 int32)


# ---------------------------------------------------------------------------
# graph walks
# ---------------------------------------------------------------------------


def topo(outputs: Sequence[Node]) -> List[Node]:
    """Every node the outputs depend on, operands before users."""
    order, seen = [], set()
    stack_ = [(n, False) for n in reversed(outputs)]
    while stack_:
        n, done = stack_.pop()
        if done:
            order.append(n)
            continue
        if id(n) in seen:
            continue
        seen.add(id(n))
        stack_.append((n, True))
        for a in reversed(n.args):
            if id(a) not in seen:
                stack_.append((a, False))
    return order


def stats(outputs: Sequence[Node]) -> Dict[str, int]:
    """Size of a graph: nodes, per-row elements, the largest node's and
    the largest constant's elements."""
    nodes = topo(outputs)
    sizes = [row_size(n.shape) for n in nodes if not n.is_const]
    consts = [n.value.size for n in nodes if n.is_const]
    return dict(nodes=len(nodes), elements=int(sum(sizes)),
                largest_node=max(sizes, default=0),
                largest_const=max(consts, default=0),
                const_elements=int(sum(consts)))


# ---------------------------------------------------------------------------
# the torch evaluator (the plain version)
# ---------------------------------------------------------------------------


def _gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n = tab.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return tab[idx]


def _al(t: torch.Tensor, nd: int) -> torch.Tensor:
    """A value (rows, *shape) with its row shape padded to nd axes."""
    pad = nd - (t.dim() - 1)
    if pad <= 0:
        return t
    return t.reshape((t.shape[0],) + (1,) * pad + tuple(t.shape[1:]))


_ELEM = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "max": torch.maximum, "min": torch.minimum,
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
    "and": torch.bitwise_and, "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
    "shr": torch.bitwise_right_shift, "shl": torch.bitwise_left_shift,
    "floordiv": lambda x, y: torch.div(x, y, rounding_mode="floor"),
    "mod": torch.remainder,
}


def _eval_node(n: Node, v, device) -> torch.Tensor:
    """One node's value, (rows, *n.shape); rows is 1 for a value that
    does not depend on the input."""
    op = n.op
    if op == "const":
        return torch.from_numpy(np.array(n.value))[None].to(device)
    nd = n.ndim
    a = [v[id(x)] for x in n.args]
    if op in _ELEM:
        out = _ELEM[op](_al(a[0], nd), _al(a[1], nd))
        return out if n.dtype == bool_ else out.to(torch.int32)
    if op in ("not", "bnot"):
        return ~a[0]
    if op == "cast":
        return (a[0] != 0) if n.dtype == bool_ else a[0].to(torch.int32)
    if op == "where":
        return torch.where(*(_al(x, nd) for x in a))
    if op == "gather":
        return _gather(a[0][0], a[1])
    if op in ("sum", "any", "all", "argmax", "argmin", "cumsum"):
        x, dim = a[0], n.attr[0] + 1
        if op == "sum":
            return x.sum(dim, dtype=torch.int32)
        if op == "any":
            return x.any(dim)
        if op == "all":
            return x.all(dim)
        if op == "cumsum":
            return torch.cumsum(x, dim, dtype=torch.int32)
        fn = torch.argmax if op == "argmax" else torch.argmin
        return fn(x, dim).to(torch.int32)
    rows = max(t.shape[0] for t in a)
    if op == "reshape":
        return a[0].reshape((a[0].shape[0],) + n.shape)
    if op == "broadcast":
        return _al(a[0], nd).expand((a[0].shape[0],) + n.shape)
    if op == "stack":
        xs = torch.broadcast_tensors(*(_al(x, nd - 1) for x in a))
        return torch.stack(xs, n.attr[0] + 1)
    if op == "index":
        return a[0].select(n.attr[0] + 1, n.attr[1])
    if op == "slice":
        ax, s0, e0 = n.attr
        return a[0].narrow(ax + 1, s0, e0 - s0)
    if op == "take":
        ax, ids = n.attr
        return a[0].index_select(ax + 1, torch.tensor(ids, device=device))
    if op == "remask":
        x, t = a[0], a[1][0]
        out = torch.zeros(x.shape[:-1] + (n.attr[0],), dtype=torch.int32,
                          device=device)
        keep = (t >= 0).nonzero().flatten()
        return out.index_add_(x.dim() - 1, t[keep].to(torch.int64),
                              x.index_select(x.dim() - 1, keep))
    raise LaneIRError(f"no evaluator for {op} ({rows} rows)")


def evaluate(outputs: Sequence[Node], fields) -> List[torch.Tensor]:
    """Run the graph on ``fields`` ([B, F] int32 tensor of rows; None
    when the graph reads no input).  Returns one tensor per output of
    shape (B, *node.shape) - (1, *node.shape) for an output that does not
    depend on the input; intermediate values are dropped once no later
    node reads them."""
    device = fields.device if fields is not None else torch.device("cpu")
    order = topo(outputs)
    uses: Dict[int, int] = {}
    for n in order:
        for x in n.args:
            uses[id(x)] = uses.get(id(x), 0) + 1
    keep = {id(n) for n in outputs}
    v: Dict[int, torch.Tensor] = {}
    for n in order:
        if n.op == "input":
            if fields is None or fields.shape[1] != n.attr[0]:
                raise LaneIRError("input fields missing or of another "
                                  "width")
            v[id(n)] = fields.to(torch.int32)[:, None, :]
        else:
            v[id(n)] = _eval_node(n, v, device)
        for x in n.args:
            uses[id(x)] -= 1
            if uses[id(x)] == 0 and id(x) not in keep:
                del v[id(x)]
    return [v[id(n)] for n in outputs]
