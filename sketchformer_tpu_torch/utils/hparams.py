"""Typed hyperparameter container with ``"k=v,k=v"`` string overrides.

Capability parity with the reference's TF1-contrib-style ``HParams`` object
(reference: utils/hparams.py — merge typed defaults, parse CLI override
strings, JSON round-trip into the experiment dir), re-designed as a plain
dict-backed container with strict typing so configs stay static/hashable
facts at trace time (XLA requires static shapes; everything here is host-side
Python).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator


def _parse_value(raw: str, like: Any) -> Any:
    """Coerce string ``raw`` to the type of the existing default ``like``."""
    if isinstance(like, bool):
        low = raw.strip().lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse {raw!r} as bool")
    if isinstance(like, int) and not isinstance(like, bool):
        return int(raw)
    if isinstance(like, float):
        return float(raw)
    if isinstance(like, (list, tuple)):
        items = [s for s in raw.split(";") if s]
        elem = like[0] if len(like) else ""
        return type(like)(_parse_value(s, elem) for s in items)
    if like is None or isinstance(like, str):
        return raw
    raise TypeError(f"unsupported hparam type {type(like)!r}")


class HParams:
    """A flat, typed hyperparameter namespace.

    >>> hps = HParams(d_model=256, dropout=0.1, use_continuous=False)
    >>> hps.parse("d_model=512,dropout=0.0")
    >>> hps.d_model
    512
    """

    def __init__(self, **kwargs: Any) -> None:
        object.__setattr__(self, "_values", dict(kwargs))

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        try:
            return values[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        values = object.__getattribute__(self, "_values")
        if name in values:
            values[name] = value
        else:
            raise AttributeError(
                f"unknown hparam {name!r}; declare it in the constructor"
            )

    def __contains__(self, name: str) -> bool:
        return name in object.__getattribute__(self, "_values")

    def __iter__(self) -> Iterator[str]:
        return iter(object.__getattribute__(self, "_values"))

    def __repr__(self) -> str:
        vals = object.__getattribute__(self, "_values")
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(vals.items()))
        return f"HParams({inner})"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, HParams):
            return NotImplemented
        return self.values() == other.values()

    # -- bulk ops ---------------------------------------------------------
    def values(self) -> Dict[str, Any]:
        return dict(object.__getattribute__(self, "_values"))

    def override(self, **kwargs: Any) -> "HParams":
        """Return a copy with the given fields replaced (must exist)."""
        values = self.values()
        for k, v in kwargs.items():
            if k not in values:
                raise AttributeError(f"unknown hparam {k!r}")
            values[k] = v
        return HParams(**values)

    def parse(self, spec: str) -> "HParams":
        """Apply a ``"k=v,k=v"`` override string in place; returns self.

        Values are coerced to the type of the existing default. List values
        use ``;`` as the element separator: ``buckets=32;64;128``.
        """
        if not spec:
            return self
        values = object.__getattribute__(self, "_values")
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"malformed hparam override {item!r}")
            key, raw = item.split("=", 1)
            key = key.strip()
            if key not in values:
                raise AttributeError(f"unknown hparam {key!r}")
            values[key] = _parse_value(raw, values[key])
        return self

    # -- persistence ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(self.values(), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "HParams":
        with open(path) as f:
            return cls(**json.load(f))

    def merge(self, other: "HParams") -> "HParams":
        """New HParams with ``other``'s values layered over ``self``'s."""
        values = self.values()
        values.update(other.values())
        return HParams(**values)
