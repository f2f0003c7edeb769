"""The op-chain transport: op chains and the boot snapshot, pickled for a
cluster worker.

The engine's ops are closures and lambdas (``DataFrame.withColumnBatch``'s
``op``, a transformer's ``apply_partition``), which plain pickle refuses,
and the port must not need cloudpickle. :func:`dumps` is a
``pickle.Pickler`` whose ``reducer_override`` sends such a function BY
VALUE: its marshalled code, name, defaults, the contents of its closure
cells, and its globals BY MODULE REFERENCE (the worker imports the
module and the function reads that module's namespace, as it would
here). A function reachable by its qualified name is pickled by
reference, as pickle does, and so is a module a closure holds. A
function of ``__main__`` resolves against the worker's ``__main__``,
which a spawned worker imports again from the coordinator's main script
file (a ``python -c`` or stdin program has none to import). marshal's format is the interpreter's own; the
worker is the same interpreter, started by spawn, so it reads it.

A torch tensor (a parameter included) travels as a CPU numpy array, its
dtype and ``requires_grad``: the weights of a model cross the pipe once
per worker with the chain that holds them, and the worker places them on
its own ``EngineConfig.device`` at its first forward. A
``ModelFunction`` leaves its locks, captured graphs and memoized
variants behind (``ModelFunction.__getstate__``).

An op that cannot be pickled raises :class:`OpNotShippable` naming it;
the coordinator never runs it itself instead. Only bytes that this
program wrote are ever loaded (:func:`loads` runs in the workers the
router spawned, on what the router sent them).
"""

from __future__ import annotations

import importlib
import io
import marshal
import pickle
import sys
import types
from typing import Any, Dict, Optional, Sequence

__all__ = ["OpNotShippable", "dumps", "loads", "dumps_ops"]


class OpNotShippable(TypeError):
    """An op of a chain bound for a cluster worker cannot be pickled."""


def _importable(fn: types.FunctionType) -> bool:
    """True when pickle's by-reference lookup finds ``fn`` itself."""
    qualname = getattr(fn, "__qualname__", "")
    if "<locals>" in qualname or "<lambda>" in qualname:
        return False
    module = sys.modules.get(getattr(fn, "__module__", None) or "")
    if module is None:
        return False
    obj: Any = module
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return False
    return obj is fn


def _make_function(code: bytes, module: str, name: str, qualname: str,
                   n_cells: int) -> types.FunctionType:
    """The worker's half: a function over ``module``'s namespace with
    empty closure cells (filled by :func:`_fill_function`, after the
    function is in pickle's memo, so a closure that holds the function
    itself resolves)."""
    mod = sys.modules.get(module)
    if mod is None:
        mod = importlib.import_module(module)
    cells = tuple(types.CellType() for _ in range(n_cells))
    fn = types.FunctionType(marshal.loads(code), mod.__dict__, name, None,
                            cells or None)
    fn.__qualname__ = qualname
    return fn


def _fill_function(fn: types.FunctionType, state: Dict[str, Any]
                   ) -> types.FunctionType:
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__dict__.update(state["dict"])
    for cell, (full, value) in zip(fn.__closure__ or (), state["cells"]):
        if full:
            cell.cell_contents = value
    return fn


def _rebuild_tensor(arr: Any, dtype: str, requires_grad: bool,
                    parameter: bool) -> Any:
    import torch

    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, types.FunctionType) and not _importable(obj):
            cells = []
            for cell in obj.__closure__ or ():
                try:
                    cells.append((True, cell.cell_contents))
                except ValueError:  # an empty cell
                    cells.append((False, None))
            state = {"defaults": obj.__defaults__,
                     "kwdefaults": obj.__kwdefaults__,
                     "dict": dict(obj.__dict__), "cells": cells}
            return (_make_function,
                    (marshal.dumps(obj.__code__), obj.__module__,
                     obj.__name__, obj.__qualname__,
                     len(obj.__closure__ or ())),
                    state, None, None, _fill_function)
        if isinstance(obj, types.ModuleType):
            return importlib.import_module, (obj.__name__,)
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            t = obj.detach()
            if t.device.type != "cpu":
                t = t.to("cpu")
            t = t.contiguous()
            dtype = "bfloat16" if t.dtype == torch.bfloat16 else ""
            arr = (t.view(torch.int16) if dtype else t).numpy()
            return (_rebuild_tensor,
                    (arr, dtype, bool(obj.requires_grad),
                     isinstance(obj, torch.nn.Parameter)))
        return NotImplemented


def dumps(obj: Any) -> bytes:
    """``obj`` as bytes, closures and lambdas by value, tensors as CPU
    arrays."""
    out = io.BytesIO()
    _Pickler(out, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return out.getvalue()


def loads(payload: bytes) -> Any:
    """The object :func:`dumps` pickled."""
    return pickle.loads(payload)


def dumps_ops(ops: Sequence[Any]) -> bytes:
    """One op chain as bytes; :class:`OpNotShippable` names the first op
    that cannot be pickled."""
    try:
        return dumps(list(ops))
    except Exception as err:  # noqa: BLE001 - re-raised naming the op
        culprit: Optional[str] = None
        for i, op in enumerate(ops):
            try:
                dumps(op)
            except Exception:  # noqa: BLE001 - this is the one
                culprit = (f"op {i} "
                           f"({getattr(op, '__qualname__', type(op).__name__)})")
                break
        raise OpNotShippable(
            f"cannot ship {culprit or 'the op chain'} to a cluster worker: "
            f"{type(err).__name__}: {err}") from err
