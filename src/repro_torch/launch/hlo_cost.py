"""Cost of the op stream a step dispatches: FLOPs, bytes moved, collective
bytes and live bytes, counted one op at a time.

Port of `repro/launch/hlo_cost.py` (the same file name, so that a reader
finds the counterpart).  The reference parses XLA's optimized HLO text.
PyTorch has no HLO and the port runs eagerly, so this module counts the op
stream that the port's own code dispatches instead, with a
`TorchDispatchMode` that sees every ATen op below autograd (the backward
and remat's recompute included) and every `c10d` collective:

    with CostCounter() as cc:
        step(state, batch)
    cc.cost          # Cost(flops, bytes, collective_bytes)

On `meta` tensors nothing is allocated and nothing computed, so a
production cell runs on one host as rank 0 of a fake process group
(`launch/dryrun.py`); on CUDA tensors the same counter sees the same ops.
Every eager op is a kernel boundary, which is what XLA's fusions stand for
in the reference:

  * FLOPs: the matmul family (`mm`, `addmm`, `bmm`, `baddbmm`,
    `convolution` and every other op with a formula in
    `torch.utils.flop_counter`'s registry) by that formula, 2 M N K; every
    other op that makes an output, its output bytes / 4 (the reference's
    ~1 FLOP an f32-normalised element of a fusion's output);
  * bytes: each op's operand bytes plus its output bytes.  An op that
    writes none of its arguments and returns only tensors on its inputs'
    storages moves nothing and counts 0: the views (`view`, `t`,
    `transpose`, `permute`, `expand`, `slice`, `select`, `unsqueeze`,
    `squeeze`, `as_strided`, `detach`, `alias`: the schema says so,
    `func.is_view`) and the ops whose schema does not say so but whose
    output shares its input's storage all the same (`_unsafe_view`, which
    `einsum` and `reshape` emit after a `clone`; the storages tell, as
    they tell the live bytes below); `empty*` count 0 too.  A write into part of a tensor in place counts the
    update, not the buffer, as the reference's dynamic-update-slice:
    `copy_` reads its source and writes its destination (a slice's size),
    and `index_copy_` / `index_put_` read the indices and the update and
    write the update.  The out-of-place `index_copy` / `index_put` (the
    decode cache's write) count as the card runs them: they read the
    whole source buffer, the indices and the update and write a whole new
    buffer, as every other op is counted.
  * collective bytes: each `c10d` op's operand bytes on this rank, by the
    reference's five kinds; a `c10d` op outside the map raises, so no
    traffic is dropped unseen.  Their operands and outputs also count as
    bytes, as in the reference.
  * live bytes: a storage counts from the op output that creates it until
    it is released (a finalizer on the storage, which its views share);
    storages the step is handed (its arguments) are apart.  The softmax
    kernels copy a non-contiguous operand into a contiguous buffer for the
    op's duration (`_CONTIGUOUS_COPIES`; no op makes it): such a copy
    counts towards the peak alone (at qwen2-7b `train_4k`'s chunked
    attention the backward's two copies are 1.88 GB).  `memory_summary`
    turns them into the reference's `memory_analysis` keys.

A Python loop of L layers runs L times and is counted L times, so no
trip-count rule is needed; nested loops multiply.  The HLO readers of the
reference (`analyze_text`, `parse_module`, `loop_multipliers`, `Op`,
`Computation`) have no torch meaning and are not ported.

`fit_cost` evaluates a count that would take too long directly (a
production cell's Python loops) as an exact polynomial fit over small
values of its loop counts (`launch/dryrun.py` says which).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import sys
import threading
import weakref
from fractions import Fraction
from typing import Callable, Mapping, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op -> (kind, index of its operand argument, index of its output
#: argument or None).  `recv_` writes its tensors: they are the permute's
#: output on this rank, as `send`'s are its operand, so a permute counts
#: once (the reference counts a collective-permute's operand).
_C10D = {
    "allgather_": ("all-gather", 1, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allreduce_": ("all-reduce", 0, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "send": ("collective-permute", 0, None),
    "recv_": ("collective-permute", None, 0),
}
_C10D_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "detach_"}
_MATMULS = {p.__name__ for p in flop_registry if hasattr(p, "__name__")}
#: ops whose kernels (CPU and CUDA) copy each non-contiguous tensor operand
#: into a contiguous buffer that lives for the op's duration
_CONTIGUOUS_COPIES = {"_softmax", "_log_softmax", "_softmax_backward_data",
                      "_log_softmax_backward_data"}
#: writes into part of a buffer in place: the update's bytes, not the
#: buffer's (the out-of-place forms write a whole new buffer)
_PARTIAL_WRITES = {"index_copy_", "index_put_", "_index_put_impl_"}
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_REL: dict[str, str] = {}
_ENGINE = os.path.join("torch", "autograd", "graph.py")
_HERE = os.path.abspath(__file__)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})

    def scaled(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k,
                    {c: v * k for c, v in self.collective_bytes.items()})

    def add(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for c in COLLECTIVES:
            self.collective_bytes[c] += other.collective_bytes[c]


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its name (`aten.mm.default`), the shapes of its
    tensor operands and of its outputs, its dtype (the first output's, else
    the first operand's), its FLOPs and bytes, and where it was issued: the
    innermost two frames of `src/repro_torch/` (file:line:function, the
    innermost first, below autograd's engine), prefixed with the autograd
    node when the op runs in a backward (`MmBackward0`).  The reference's counterpart is an HLO op's
    `op_name` metadata; the port's models are nested dicts, not modules,
    so there is no module path to use instead."""

    op: str
    shapes: tuple
    out_shapes: tuple
    dtype: str
    flops: float
    bytes: float
    where: str = ""


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts (an op's arguments)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None                      # no storage (a sparse tensor)


def _aliases(func, ins, outputs) -> bool:
    """True when `func` writes none of its arguments and every output lies
    on an input's storage: it moved no byte (an in-place op returns its
    written argument, and is not free)."""
    if not outputs or any(a.alias_info is not None and a.alias_info.is_write
                          for a in func._schema.arguments):
        return False
    keys = {st._cdata for st in map(_storage, ins) if st is not None}
    return all((st := _storage(t)) is not None and st._cdata in keys
               for t in outputs)


def _where() -> str:
    """The innermost two `src/repro_torch/` frames of the op's issue, and
    in a backward the autograd node; the walk stops at autograd's engine,
    so a backward op names its node alone and a remat recompute its own
    frames (the same on a CUDA device thread, which has no other frames)."""
    frames, f = [], sys._getframe(2)
    while f is not None and len(frames) < 2:
        path = f.f_code.co_filename
        if path.startswith(_PORT) and path != _HERE:
            rel = _REL.get(path) or _REL.setdefault(
                path, os.path.relpath(path, _PORT))
            frames.append(f"{rel}:{f.f_lineno}:{f.f_code.co_name}")
        elif path.endswith(_ENGINE):
            break
        f = f.f_back
    node = torch._C._current_autograd_node()
    where = " < ".join(frames)
    if node is not None:
        where = node.name() + (" @ " + where if where else "")
    return where


class CostCounter(TorchDispatchMode):
    """Counts every op dispatched inside `with CostCounter() as cc:` (see
    the module docstring): `cc.cost`, `cc.records` (an `OpRecord` an op),
    `cc.live_bytes` and `cc.peak_bytes` (of the storages created inside).  Ops the counter itself runs are not
    counted."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = 0        # exact ints: the fits need exact sums
        self.elementwise_bytes = 0   # output bytes of the other ops
        self.moved_bytes = 0
        self.collective = {k: 0 for k in COLLECTIVES}
        self.records: list[OpRecord] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.n_ops = 0
        self._known: dict[int, bool] = {}    # storage -> created inside
        self._lock = threading.Lock()

    @property
    def cost(self) -> Cost:
        return Cost(self.matmul_flops + self.elementwise_bytes / 4.0,
                    float(self.moved_bytes),
                    {k: float(v) for k, v in self.collective.items()})

    # -- storages ---------------------------------------------------------

    def _key(self, t: torch.Tensor):
        st = _storage(t)
        return (None, None) if st is None else (st._cdata, st)

    def _see_inputs(self, ts) -> None:
        for t in ts:
            key, st = self._key(t)
            if key is not None and key not in self._known:
                self._known[key] = False
                weakref.finalize(st, self._forget, key, 0)

    def _see_outputs(self, ts) -> None:
        for t in ts:
            key, st = self._key(t)
            if key is None or key in self._known:
                continue
            n = st.nbytes()
            self._known[key] = True
            with self._lock:
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._forget, key, n)

    def _forget(self, key: int, n: int) -> None:
        with self._lock:
            self._known.pop(key, None)
            self.live_bytes -= n

    # -- ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        self._see_inputs(ins)
        if func.namespace in _C10D_NAMESPACES:
            operands, outputs = self._collective(name, args)
            flops = 0
        else:
            outputs = _tensors(out)
            if func.is_view or name in _FREE or _aliases(func, ins,
                                                         outputs):
                operands, outputs, flops = [], [], 0
            else:
                operands, outputs = self._traffic(name, args, ins, outputs)
                packet = func._overloadpacket
                if packet in flop_registry:
                    flops = int(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
                    self.matmul_flops += flops
                else:
                    ob = _nbytes(outputs)
                    self.elementwise_bytes += ob
                    flops = ob / 4.0
        nbytes = _nbytes(operands) + _nbytes(outputs)
        self.moved_bytes += nbytes
        out_ts = _tensors(out)
        self._see_outputs(out_ts)
        if name in _CONTIGUOUS_COPIES:
            copies = _nbytes(t for t in ins if not t.is_contiguous())
            with self._lock:
                self.peak_bytes = max(self.peak_bytes,
                                      self.live_bytes + copies)
        self.n_ops += 1
        first = (out_ts or ins or [None])[0]
        self.records.append(OpRecord(
            op=str(func), shapes=tuple(tuple(t.shape) for t in ins),
            out_shapes=tuple(tuple(t.shape) for t in out_ts),
            dtype=str(first.dtype).replace("torch.", "") if first is not None
            else "", flops=float(flops), bytes=float(nbytes),
            where=_where()))
        return out

    def _collective(self, name: str, args):
        if name not in _C10D:
            raise NotImplementedError(
                f"CostCounter: c10d op {name!r} has no collective kind; map "
                f"it in launch/hlo_cost.py's _C10D so that its bytes are "
                f"counted")
        kind, i_in, i_out = _C10D[name]
        operands = _tensors(args[i_in]) if i_in is not None else []
        outputs = _tensors(args[i_out]) if i_out is not None else []
        if name == "allreduce_":
            outputs = operands           # in place: read and written
        self.collective[kind] += _nbytes(operands)
        return operands, outputs

    @staticmethod
    def _traffic(name: str, args, ins, outputs):
        """(tensors read, tensors written) of an op that does work."""
        if name == "copy_":
            return _tensors(args[1]), outputs
        if name in _PARTIAL_WRITES:
            if name.startswith("index_copy"):
                update = _tensors((args[2], args[3]))      # index, source
            else:
                update = _tensors((args[1], args[2]))      # indices, values
            return update, update[-1:]
        return ins, outputs


# -- memory ---------------------------------------------------------------------


def _storages(tree) -> dict[int, int]:
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def memory_summary(counter: CostCounter, args, out) -> dict[str, int]:
    """The reference's `memory_analysis` keys for a counted call
    `out = fn(*args)`: the bytes of the argument storages, of the output
    storages, of the outputs that are arguments updated in place, and the
    peak of the live bytes the call created (`temp_size_in_bytes`; its new
    outputs are among them).  Eager code has no generated code, so
    `generated_code_size_in_bytes` is left out."""
    a, o = _storages(args), _storages(out)
    return {"argument_size_in_bytes": sum(a.values()),
            "output_size_in_bytes": sum(o.values()),
            "temp_size_in_bytes": counter.peak_bytes,
            "alias_size_in_bytes": sum(v for k, v in o.items() if k in a)}


# -- the counted result, its profile and its fit --------------------------------


@dataclasses.dataclass
class Counted:
    """A counted call: its `Cost`, its memory summary, its matmuls'
    FLOPs by (where, out shape, op) and its op count; `fitted` names the
    fit's points when it was fitted (`fit_cost`)."""

    cost: Cost
    memory: dict
    matmuls: dict
    n_ops: float
    fitted: dict | None = None


def matmul_table(records: Sequence[OpRecord]) -> dict:
    """{(where, out shape, op): FLOPs} over the records with a matmul
    formula (the rest count output bytes / 4 and are left out)."""
    table: dict = {}
    for r in records:
        if r.flops and r.op.split(".")[1] in _MATMULS:
            key = (r.where, str(list(r.out_shapes[0])) if r.out_shapes
                   else "", r.op)
            table[key] = table.get(key, 0.0) + r.flops
    return table


def top_flops(records, k: int = 20) -> list[tuple[float, str, str, str]]:
    """Top-k matmuls by FLOPs summed over their repeats (the counterpart of
    the reference's loop-weighted dots): (flops, where, out shape, op).
    `records` is a list of `OpRecord`s or a `matmul_table`."""
    table = records if isinstance(records, dict) else matmul_table(records)
    rows = [(f, where, shape, op) for (where, shape, op), f
            in table.items()]
    rows.sort(reverse=True)
    return rows[:k]


def count(fn: Callable, *args) -> tuple:
    """`(fn(*args), Counted)`: one call under a `CostCounter`."""
    with CostCounter() as cc:
        out = fn(*args)
    counted = Counted(cc.cost, memory_summary(cc, args, out),
                      matmul_table(cc.records), cc.n_ops)
    return out, counted


def _lagrange(nodes: Sequence[int], x: int) -> list[Fraction]:
    return [math.prod((Fraction(x - m, n - m) for m in nodes if m != n),
                      start=Fraction(1)) for n in nodes]


def fit_cost(count_at: Callable[[dict], Counted], at: Mapping[str, int],
             points: Mapping[str, Sequence[int]],
             first: tuple[dict, Counted] | None = None,
             matmul_shapes: bool = True) -> Counted:
    """`count_at(values)` evaluated at `at` as the exact Lagrange fit over
    the tensor product of `points` (a dim's count a polynomial of degree
    len(points) - 1 in its value); dims of `at` not in `points` are held at
    their value.  Costs that are such polynomials (a loop's ops repeated
    once a value) come out exactly, and so do the memory summary's sizes
    of arguments and outputs.  Its peak (`temp_size_in_bytes`) is an
    estimate: it stands at one moment of the call and is no polynomial, so
    it is extended from the grid's largest point along each dim's slope to
    its second largest (first order, no cross terms, which a product of
    far extrapolations would amplify).
    `first` is an already counted (values, Counted) of the grid, reused.
    `matmul_shapes=False` keys the matmul table by (where, op) alone, for
    fits whose points change the matmuls' shapes (their shape is left
    blank)."""
    dims = list(points)
    weights = [_lagrange(points[d], at[d]) for d in dims]
    corner = tuple(len(points[d]) - 1 for d in dims)
    slope = [Fraction(at[d] - points[d][-1], points[d][-1] - points[d][-2])
             for d in dims]
    acc: dict = {}
    for idx in itertools.product(*(range(len(points[d])) for d in dims)):
        values = dict(at, **{d: points[d][i] for d, i in zip(dims, idx)})
        if first is not None and first[0] == values:
            got = first[1]
        else:
            got = count_at(values)
        w = math.prod((weights[j][i] for j, i in enumerate(idx)),
                      start=Fraction(1))
        off = [j for j, i in enumerate(idx) if i != corner[j]]
        if not off:
            wp = 1 + sum(slope)
        elif len(off) == 1 and idx[off[0]] == corner[off[0]] - 1:
            wp = -slope[off[0]]
        else:
            wp = Fraction(0)
        for key, v in _flat(got, matmul_shapes).items():
            peak = key == ("mem", "temp_size_in_bytes")
            acc[key] = acc.get(key, Fraction(0)) + (wp if peak else w) \
                * Fraction(v)
    value = {k: float(v) for k, v in acc.items()}
    cost = Cost(value.pop(("flops",)), value.pop(("bytes",)),
                {c: value.pop(("coll", c)) for c in COLLECTIVES})
    n_ops = value.pop(("n_ops",))
    memory = {k[1]: int(round(v)) for k, v in value.items()
              if k[0] == "mem"}
    memory["estimate"] = True
    matmuls = {k[1]: v for k, v in value.items() if k[0] == "mm" and v}
    return Counted(cost, memory, matmuls, n_ops,
                   fitted={d: list(points[d]) for d in dims})


def _flat(c: Counted, matmul_shapes: bool = True) -> dict:
    out = {("flops",): c.cost.flops, ("bytes",): c.cost.bytes,
           ("n_ops",): c.n_ops}
    out.update({("coll", k): v for k, v in c.cost.collective_bytes.items()})
    out.update({("mem", k): v for k, v in c.memory.items()
                if k != "estimate"})
    for (where, shape, op), v in c.matmuls.items():
        key = ("mm", (where, shape if matmul_shapes else "", op))
        out[key] = out.get(key, 0.0) + v
    return out
