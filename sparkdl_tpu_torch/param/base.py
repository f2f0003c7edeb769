"""Core ``Param``/``Params`` machinery (Spark ML semantics, dependency-free).

Reimplements the behavioral contract of ``pyspark.ml.param.Params`` that the
reference's L5 param layer extends (SURVEY.md §1 L5, §5.6): instance-level
param maps layered over class-level defaults, copy-with-extra semantics used
by ``fit(dataset, paramMap)``, and keyword-only constructors.
"""

from __future__ import annotations

import copy as _copy
import functools
import inspect
from typing import Any, Callable, Dict, Iterator, List, Optional


class Param:
    """A parameter descriptor with self-contained documentation.

    Mirrors ``pyspark.ml.param.Param``: identity is ``(parent, name)``.
    ``parent`` is the uid of the owning :class:`Params` instance once bound,
    or the owning class name for class-level declarations.
    """

    def __init__(self, parent: Any, name: str, doc: str,
                 typeConverter: Optional[Callable[[Any], Any]] = None):
        self.parent = parent.uid if isinstance(parent, Params) else str(parent)
        self.name = str(name)
        self.doc = str(doc)
        self.typeConverter = typeConverter or (lambda v: v)

    def _copy_new_parent(self, parent: "Params") -> "Param":
        new = _copy.copy(self)
        new.parent = parent.uid
        return new

    def __str__(self) -> str:
        return f"{self.parent}__{self.name}"

    def __repr__(self) -> str:
        return f"Param(parent={self.parent!r}, name={self.name!r}, doc={self.doc!r})"

    def __hash__(self) -> int:
        return hash(str(self))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Param) and str(self) == str(other)


_uid_counters: Dict[str, int] = {}


def _gen_uid(cls_name: str) -> str:
    n = _uid_counters.get(cls_name, 0)
    _uid_counters[cls_name] = n + 1
    return f"{cls_name}_{n:04x}"


def keyword_only(func: Callable) -> Callable:
    """Force keyword-only invocation and stash kwargs on the instance.

    The reference uses pyspark's ``@keyword_only`` on every Transformer /
    Estimator ``__init__`` and ``setParams`` so that ``_set(**kwargs)`` can
    apply exactly the user-passed values. Same contract here: the wrapped
    function can read ``self._input_kwargs``.
    """

    @functools.wraps(func)
    def wrapper(self, *args: Any, **kwargs: Any) -> Any:
        if args:
            raise TypeError(
                f"{func.__name__}() only accepts keyword arguments, got "
                f"{len(args)} positional")
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    wrapper._keyword_only = True  # type: ignore[attr-defined]
    return wrapper


class Params:
    """Mixin for components that carry typed parameters.

    Subclasses declare class-level :class:`Param` attributes; on first
    instantiation each is re-bound to the instance (fresh ``parent`` uid) so
    two instances never share mutable param state. Values resolve through
    two layers: the instance ``_paramMap`` (explicitly set) over
    ``_defaultParamMap`` (declared defaults) — identical to Spark ML.
    """

    def __init__(self) -> None:
        self.uid = _gen_uid(type(self).__name__)
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        self._params_cache: Optional[List[Param]] = None
        self._copy_params()

    def _copy_params(self) -> None:
        for name in dir(type(self)):
            attr = getattr(type(self), name, None)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_new_parent(self))

    # -- declaration / lookup ------------------------------------------------

    @property
    def params(self) -> List[Param]:
        if self._params_cache is None:
            self._params_cache = sorted(
                (getattr(self, name) for name in dir(self)
                 if name != "params" and isinstance(getattr(self, name, None), Param)),
                key=lambda p: p.name)
        return self._params_cache

    def hasParam(self, paramName: str) -> bool:
        attr = getattr(self, paramName, None)
        return isinstance(attr, Param)

    def getParam(self, paramName: str) -> Param:
        param = getattr(self, paramName, None)
        if not isinstance(param, Param):
            raise ValueError(f"{type(self).__name__} has no param {paramName!r}")
        return param

    def _resolveParam(self, param) -> Param:
        if isinstance(param, Param):
            self._shouldOwn(param)
            return param
        if isinstance(param, str):
            return self.getParam(param)
        raise TypeError(f"cannot resolve {param!r} as a param")

    def _shouldOwn(self, param: Param) -> None:
        if not (param.parent == self.uid and self.hasParam(param.name)):
            raise ValueError(f"Param {param} does not belong to {self.uid}")

    # -- set / get -----------------------------------------------------------

    def set(self, param, value: Any) -> "Params":
        param = self._resolveParam(param)
        try:
            value = param.typeConverter(value)
        except (TypeError, ValueError) as e:
            raise TypeError(
                f"Invalid value for param {param.name}: {e}") from e
        self._paramMap[param] = value
        return self

    def _set(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            if value is not None:
                self.set(self.getParam(name), value)
        return self

    def _setDefault(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            param = self.getParam(name)
            if value is not None:
                value = param.typeConverter(value)
            self._defaultParamMap[param] = value
        return self

    def clear(self, param) -> "Params":
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    def isSet(self, param) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param) -> Any:
        param = self._resolveParam(param)
        if param in self._paramMap:
            return self._paramMap[param]
        if param in self._defaultParamMap:
            return self._defaultParamMap[param]
        raise KeyError(f"Param {param.name} is not set and has no default")

    def getDefault(self, param) -> Any:
        return self._defaultParamMap[self._resolveParam(param)]

    # -- param maps / copy (fit(df, paramMap) semantics) ---------------------

    def extractParamMap(self, extra: Optional[Dict[Param, Any]] = None) -> Dict[Param, Any]:
        merged = dict(self._defaultParamMap)
        merged.update(self._paramMap)
        if extra:
            merged.update(extra)
        return merged

    def copy(self, extra: Optional[Dict[Param, Any]] = None) -> "Params":
        """Deep-ish copy: new instance, same uid, params re-bound, extra applied.

        Spark ML keeps the uid across ``copy`` — downstream code (param maps
        keyed by (uid, name)) relies on that, so we do too.
        """
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        that._params_cache = None
        that._copy_params_keep_uid()
        if extra:
            # pyspark semantics: extra entries whose param the new instance
            # does not own are silently ignored (lets one param map fan out
            # across pipeline stages, each taking only what it owns).
            for param, value in extra.items():
                if isinstance(param, Param) and that.hasParam(param.name):
                    that._paramMap[that.getParam(param.name)] = value
        return that

    def _copy_params_keep_uid(self) -> None:
        # Re-bind Param descriptors so they compare equal under the kept uid;
        # remap existing entries onto the re-bound keys.
        old_pm, old_dm = self._paramMap, self._defaultParamMap
        by_name_pm = {p.name: v for p, v in old_pm.items()}
        by_name_dm = {p.name: v for p, v in old_dm.items()}
        for name in dir(type(self)):
            attr = getattr(type(self), name, None)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_new_parent(self))
        self._paramMap = {self.getParam(n): v for n, v in by_name_pm.items()}
        self._defaultParamMap = {self.getParam(n): v for n, v in by_name_dm.items()}

    def _copyValues(self, to: "Params", extra: Optional[Dict[Param, Any]] = None) -> "Params":
        paramMap = self.extractParamMap(extra)
        for param, value in paramMap.items():
            if to.hasParam(param.name):
                to._paramMap[to.getParam(param.name)] = value
        return to

    # -- docs ----------------------------------------------------------------

    def explainParam(self, param) -> str:
        param = self._resolveParam(param)
        values = []
        if self.hasDefault(param):
            values.append(f"default: {self.getDefault(param)!r}")
        if self.isSet(param):
            values.append(f"current: {self._paramMap[param]!r}")
        state = ", ".join(values) if values else "undefined"
        return f"{param.name}: {param.doc} ({state})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(uid={self.uid})"
