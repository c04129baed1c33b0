"""The port's RPR rule set: PyTorch/CUDA-aware lints for this codebase.

The port's form of `repro/analysis/rules.py`: the same seven codes, each
the torch form of the reference's hazard class.

  RPR001  host sync in hot scopes — `.item()`, `.tolist()`, `.cpu()`,
          `.numpy()`, `float()` / `int()` / `bool()` of a tensor,
          `np.asarray(tensor)` and `torch.cuda.synchronize()` inside the
          engine loop and its line search, PCG, the per-iteration
          diagnostics, the memory poll and the serving rowwise solve.  Each
          makes the host wait on the card every iteration, the overhead
          class the reference's `jax.device_get` rule guards.  The
          sanctioned reads are exempt: a value of
          `embed/engine.py::_host_scalars` (one batched read) is a host
          value, and a read inside `with explicit_read():`
          (`analysis.guards`) is deliberate.
  RPR002  a random draw without `generator=` — `torch.rand*`, `randperm`,
          `multinomial`, `normal`, `bernoulli`, `poisson` and the in-place
          samplers (`Tensor.uniform_` and kin) draw from hidden global
          state: a rerun or a resume can no longer replay them, as a reused
          PRNG key breaks the reference's draws.
  RPR003  a tensor factory without `device=` in a hot scope — it builds on
          the CPU and pays an upload (or a wrong-device error) every
          iteration: a hidden per-iteration cost, as a retrace is in JAX.
  RPR004  kernel-source constraints in `csrc/*.cu` (read as text) — a float
          or double `atomicAdd` makes the sum order depend on the schedule,
          which breaks the bit-identical reruns and resumes the port pins
          (ROADMAP, the determinism rule); a `__global__` without
          `__launch_bounds__` leaves the register budget, and so the
          occupancy the launch shapes were tuned for, to the compiler.
          Where the reference checked Pallas tiles, Hopper's constraints
          live in the CUDA sources.
  RPR005  a bf16 reduction without an f32 accumulator — `torch.sum` /
          `mean` / `prod` / `cumsum` without `dtype=`, or a product
          (`matmul`, `mm`, `dot`, `einsum` ...), over a value that took a
          bfloat16 path accumulates or returns in bf16; the kernels widen
          to float32 after the load and sum in float32.
  RPR006  `DeprecationWarning` without `stacklevel=2`, as the reference.
  RPR007  `span(...)` not used as a context manager, as the reference.

Each rule is a callable `rule(tree, path, src) -> list[Finding]`; the
driver (lint.py) parses once and runs all rules per Python file, and runs
the rules of `CUDA_RULES` over each CUDA source with `tree` None.
"""
from __future__ import annotations

import ast
import re
from typing import Callable

from .lint import Finding

# -- shared AST helpers ----------------------------------------------------------


def qualname(node: ast.AST) -> str:
    """Dotted name of a call target: `torch.randn`, `np.asarray`, `float`.
    Empty string for non-name expressions (subscripts, calls)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _walk_scopes(tree: ast.Module):
    """Yield (scope_name, func_node, parents) for every function in the
    module, where scope_name is the dotted lexical path (e.g.
    `fit_loop.<locals>.save` collapses to `fit_loop.save`)."""
    def rec(node, prefix, parents):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}.{child.name}" if prefix else child.name
                yield name, child, parents
                yield from rec(child, name, parents + [child])
            elif isinstance(child, ast.ClassDef):
                name = f"{prefix}.{child.name}" if prefix else child.name
                yield from rec(child, name, parents)
            else:
                yield from rec(child, prefix, parents)

    yield from rec(tree, "", [])


def _assigned_names(target: ast.AST):
    for node in ast.walk(target):
        if isinstance(node, ast.Name):
            yield node.id


def _own_nodes(fn: ast.AST):
    """The nodes of `fn`'s body that no nested def owns (a nested def is
    its own scope)."""
    nested = {id(n) for _, f, _ in _walk_scopes(fn) for n in ast.walk(f)}
    return [n for n in ast.walk(fn) if id(n) not in nested and n is not fn]


def _kwargs(call: ast.Call) -> set[str | None]:
    return {kw.arg for kw in call.keywords}


# -- RPR001: host sync in hot scopes ---------------------------------------------

#: functions whose bodies are per-iteration hot paths of the port: the
#: engine loop and its line-search helpers, PCG, the per-iteration
#: diagnostics, the telemetry memory poll, the serving rowwise solve and
#: the LM's train step.
HOT_SCOPE_NAMES = frozenset({
    "fit_loop", "_fit_loop", "initial_step", "host_backtrack", "pcg",
    "diagnostics", "device_memory_stats", "rowwise_transform", "train_step",
})

#: no-argument tensor methods that copy to the host
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: calls that read a tensor's value on the host
_SYNC_CALLS = {
    "np.asarray": "np.asarray",
    "numpy.asarray": "np.asarray",
    "np.array": "np.array",
    "numpy.array": "np.array",
    "float": "float()",
    "int": "int()",
    "bool": "bool()",
}
#: the sanctioned batched read: its values are host floats
_HOST_READ = "_host_scalars"
#: the sanctioned-read scope of analysis.guards
_READ_SCOPE = "explicit_read"


def _device_tainted(fns) -> set[str]:
    """Names plausibly bound to tensors in the given functions: any
    assignment whose right side mentions `torch.`, and tuple-unpacks of a
    call result (energy and step functions return tensor tuples), except
    values of the sanctioned batched read."""
    tainted: set[str] = set()
    for fn in fns:
        for node in ast.walk(fn):
            if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                 ast.GeneratorExp)):
                for gen in node.generators:
                    it_src = ast.unparse(gen.iter)
                    if _HOST_READ in it_src:
                        continue
                    if "self." in it_src or "torch." in it_src:
                        tainted.update(_assigned_names(gen.target))
                continue
            if not isinstance(node, ast.Assign):
                continue
            seg = ast.unparse(node.value)
            if _HOST_READ in seg:
                continue
            unpack = (isinstance(node.value, ast.Call)
                      and any(isinstance(t, (ast.Tuple, ast.List))
                              for t in node.targets))
            if "torch." in seg or unpack:
                for t in node.targets:
                    tainted.update(_assigned_names(t))
    return tainted


def _sanctioned(fn: ast.AST) -> set[int]:
    """ids of the nodes inside a `with explicit_read():` block."""
    out: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With) and any(
                isinstance(item.context_expr, ast.Call)
                and qualname(item.context_expr.func).split(".")[-1]
                == _READ_SCOPE for item in node.items):
            for stmt in node.body:
                out.update(id(n) for n in ast.walk(stmt))
    return out


def _in_hot(name: str, parents) -> bool:
    return (name.rsplit(".", 1)[-1] in HOT_SCOPE_NAMES
            or any(p.name in HOT_SCOPE_NAMES for p in parents
                   if isinstance(p, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))))


def rule_rpr001(tree: ast.Module, path: str, src: str) -> list[Finding]:
    findings = []
    for scope, fn, parents in _walk_scopes(tree):
        if not _in_hot(scope, parents):
            continue
        tainted = _device_tainted([fn] + list(parents))
        exempt = _sanctioned(fn)
        for node in _own_nodes(fn):
            if id(node) in exempt or not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS and not node.args
                    and not node.keywords):
                findings.append(Finding(
                    "RPR001", path, node.lineno, node.col_offset, scope,
                    f"`.{node.func.attr}()` in hot scope: blocking "
                    f"device->host sync per call (batch reads through "
                    f"_host_scalars, or mark a deliberate one with "
                    f"explicit_read)"))
                continue
            q = qualname(node.func)
            if q == "torch.cuda.synchronize":
                findings.append(Finding(
                    "RPR001", path, node.lineno, node.col_offset, scope,
                    "`torch.cuda.synchronize()` in hot scope: the host "
                    "waits for the card every call"))
                continue
            label = _SYNC_CALLS.get(q)
            if label is None or not node.args:
                continue
            a = node.args[0]
            arg_src = ast.unparse(a)
            if _HOST_READ in arg_src:
                continue
            device_arg = ("torch." in arg_src or "self." in arg_src
                          or (isinstance(a, ast.Name) and a.id in tainted))
            if not device_arg:
                continue
            findings.append(Finding(
                "RPR001", path, node.lineno, node.col_offset, scope,
                f"`{label}` of a tensor in hot scope: implicit "
                f"device->host sync per call (batch reads through "
                f"_host_scalars, or mark a deliberate one with "
                f"explicit_read)"))
    return findings


# -- RPR002: random draws without a generator ------------------------------------

#: torch functions that sample
_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "multinomial", "normal", "bernoulli", "poisson",
})
#: Tensor methods that sample
_SAMPLER_METHODS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_", "multinomial", "bernoulli",
})


def rule_rpr002(tree: ast.Module, path: str, src: str) -> list[Finding]:
    findings = []
    scopes = [("<module>", tree)] + [(s, f) for s, f, _ in _walk_scopes(tree)]
    for scope, fn in scopes:
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            if "generator" in _kwargs(node):
                continue
            q = qualname(node.func)
            parts = q.split(".")
            is_torch = (len(parts) == 2 and parts[0] == "torch"
                        and parts[1] in _SAMPLERS)
            is_method = (isinstance(node.func, ast.Attribute)
                         and node.func.attr in _SAMPLER_METHODS
                         and parts[0] not in ("torch", "np", "numpy",
                                              "random", "rng"))
            if not (is_torch or is_method):
                continue
            name = q if is_torch else f".{node.func.attr}"
            findings.append(Finding(
                "RPR002", path, node.lineno, node.col_offset, scope,
                f"`{name}(...)` draws without `generator=`: hidden global "
                f"RNG state, so reruns and resumes cannot replay it (pass "
                f"an explicit torch.Generator)"))
    return findings


# -- RPR003: tensor factories without device= in hot scopes ----------------------

_FACTORIES = frozenset({
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
    "linspace", "logspace", "eye", "rand", "randn", "randint", "randperm",
})


def rule_rpr003(tree: ast.Module, path: str, src: str) -> list[Finding]:
    findings = []
    for scope, fn, parents in _walk_scopes(tree):
        if not _in_hot(scope, parents):
            continue
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            parts = qualname(node.func).split(".")
            if not (len(parts) == 2 and parts[0] == "torch"
                    and parts[1] in _FACTORIES):
                continue
            if "device" in _kwargs(node):
                continue
            findings.append(Finding(
                "RPR003", path, node.lineno, node.col_offset, scope,
                f"`torch.{parts[1]}` without `device=` in hot scope: "
                f"built on the CPU every iteration (and uploaded, or a "
                f"device mismatch); pass the device of the data"))
    return findings


# -- RPR004: kernel-source constraints (CUDA sources) ----------------------------

_FLOAT_PTR = re.compile(
    r"\b(?:float|double|half|__half|__nv_bfloat16|float[24]|double2)\s*\*"
    r"\s*(?:const\s+)?(?:__restrict__\s+)?(\w+)")
_ATOMIC = re.compile(r"\b(?:unsafeAtomicAdd|atomicAdd(?:_block|_system)?)"
                     r"\s*\(")
_FLOAT_CAST = re.compile(r"[(<]\s*(?:float|double|__half|__nv_bfloat16)\s*\*")
_GLOBAL = re.compile(r"\b__global__\b")


def _line_col(src: str, offset: int) -> tuple[int, int]:
    line = src.count("\n", 0, offset) + 1
    return line, offset - (src.rfind("\n", 0, offset) + 1)


def _strip_comments(src: str) -> str:
    """The source with comments blanked (offsets and lines kept)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, src, flags=re.S)


def _first_arg(code: str, start: int) -> str:
    """The text of the first argument of the call whose '(' is at
    `start - 1`."""
    depth, i = 0, start
    while i < len(code):
        c = code[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            if depth == 0:
                break
            depth -= 1
        elif c == "," and depth == 0:
            break
        i += 1
    return code[start:i]


def rule_rpr004(tree, path: str, src: str) -> list[Finding]:
    if tree is not None:          # Python: nothing to check here
        return []
    code = _strip_comments(src)
    findings = []
    float_ptrs = set(_FLOAT_PTR.findall(code))
    for m in _ATOMIC.finditer(code):
        arg = _first_arg(code, m.end())
        ident = re.match(r"\W*(\w+)", arg)
        if _FLOAT_CAST.search(arg) or (ident and ident.group(1)
                                       in float_ptrs):
            line, col = _line_col(code, m.start())
            findings.append(Finding(
                "RPR004", path, line, col, "<module>",
                "floating-point atomicAdd: the sum order follows the "
                "schedule, so reruns and resumes are not bit-identical "
                "(sum partials in a fixed order)"))
    for m in _GLOBAL.finditer(code):
        head_end = code.find("(", m.end())
        while head_end != -1 and code[m.end():head_end].rstrip().endswith(
                "__launch_bounds__"):
            # skip the __launch_bounds__(...) arguments
            depth, i = 0, head_end
            while i < len(code):
                depth += {"(": 1, ")": -1}.get(code[i], 0)
                i += 1
                if depth == 0:
                    break
            head_end = code.find("(", i)
        head = code[m.end():head_end]
        name = re.findall(r"\w+", head)
        if "__launch_bounds__" not in head:
            line, col = _line_col(code, m.start())
            findings.append(Finding(
                "RPR004", path, line, col, name[-1] if name else "<module>",
                "`__global__` without `__launch_bounds__`: the register "
                "budget, and so the occupancy the launch shapes assume, "
                "is left to the compiler"))
    return findings


# -- RPR005: bf16 reductions without an f32 accumulator --------------------------

_REDUCERS = ("torch.sum", "torch.mean", "torch.prod", "torch.cumsum",
             "torch.nansum")
_PRODUCTS = ("torch.matmul", "torch.mm", "torch.bmm", "torch.dot",
             "torch.vdot", "torch.einsum", "torch.tensordot", "torch.mv")
_REDUCER_METHODS = frozenset({"sum", "mean", "prod", "cumsum", "nansum"})


def rule_rpr005(tree: ast.Module, path: str, src: str) -> list[Finding]:
    findings = []
    for scope, fn, _ in _walk_scopes(tree):
        tainted: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                seg = ast.unparse(node.value)
                names = [n for t in node.targets
                         for n in _assigned_names(t)]
                if "float32" in seg or ".float()" in seg:
                    tainted.difference_update(names)
                elif "bfloat16" in seg or "bf16" in seg:
                    tainted.update(names)
        if not tainted:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            q = qualname(node.func)
            kwargs = _kwargs(node)
            if (isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in tainted
                    and node.func.attr in _REDUCER_METHODS
                    and "dtype" not in kwargs):
                findings.append(Finding(
                    "RPR005", path, node.lineno, node.col_offset, scope,
                    f"`.{node.func.attr}()` reduces a bf16-stored value "
                    f"without dtype=torch.float32: accumulates in bf16 "
                    f"(widen after the load, accumulate in f32)"))
                continue
            arg_names = {a.id for a in node.args if isinstance(a, ast.Name)}
            if not (arg_names & tainted):
                continue
            if q in _REDUCERS and "dtype" not in kwargs:
                findings.append(Finding(
                    "RPR005", path, node.lineno, node.col_offset, scope,
                    f"`{q}` reduces a bf16-stored value without "
                    f"dtype=torch.float32: accumulates in bf16 (widen "
                    f"after the load, accumulate in f32)"))
            elif q in _PRODUCTS:
                findings.append(Finding(
                    "RPR005", path, node.lineno, node.col_offset, scope,
                    f"`{q}` of a bf16-stored value: the product comes "
                    f"back in bf16 (widen the operands to float32 first)"))
    return findings


# -- RPR006: DeprecationWarning without stacklevel=2 -----------------------------


def rule_rpr006(tree: ast.Module, path: str, src: str) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if qualname(node.func) not in ("warnings.warn", "warn"):
            continue
        cat = node.args[1] if len(node.args) > 1 else None
        for kw in node.keywords:
            if kw.arg == "category":
                cat = kw.value
        if cat is None or qualname(cat) != "DeprecationWarning":
            continue
        level = None
        for kw in node.keywords:
            if kw.arg == "stacklevel":
                level = kw.value
        if level is None or (isinstance(level, ast.Constant)
                             and isinstance(level.value, int)
                             and level.value < 2):
            findings.append(Finding(
                "RPR006", path, node.lineno, node.col_offset, "<module>",
                "DeprecationWarning without stacklevel=2: the warning "
                "points at the shim, not at the caller to migrate"))
    return findings


# -- RPR007: span() not used as a context manager --------------------------------


def rule_rpr007(tree: ast.Module, path: str, src: str) -> list[Finding]:
    findings = []
    for scope, fn, _ in _walk_scopes(tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Expr):
                continue
            call = node.value
            if not isinstance(call, ast.Call):
                continue
            q = qualname(call.func)
            if q == "span" or q.endswith(".span"):
                findings.append(Finding(
                    "RPR007", path, call.lineno, call.col_offset, scope,
                    "`span(...)` called but discarded: nothing is timed "
                    "— use `with span(...):` around the block"))
    return findings


ALL_RULES: dict[str, Callable] = {
    "RPR001": rule_rpr001,
    "RPR002": rule_rpr002,
    "RPR003": rule_rpr003,
    "RPR004": rule_rpr004,
    "RPR005": rule_rpr005,
    "RPR006": rule_rpr006,
    "RPR007": rule_rpr007,
}
#: the rules that read CUDA sources (run with tree None)
CUDA_RULES = frozenset({"RPR004"})
