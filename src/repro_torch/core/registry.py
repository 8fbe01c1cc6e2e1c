"""Shared name -> implementation registry.

Every pluggable axis of the reproduction (policies, workloads,
controllers, middleware stages, fault kinds) used to carry its own
copy-pasted ``_REGISTRY`` dict plus the same two ``ValueError`` messages.
This module is that pattern, written once: a :class:`Registry` instance
per axis, with the uniform list-alternatives error text the tests match
against::

    unknown <kind> '<name>'; available: a, b, c
    <kind> '<name>' already registered (module.Qualname)

The per-axis modules keep their public ``register / unregister /
available / get_class / get`` functions as thin delegates, so existing
imports (and third-party registrations) are untouched.

:func:`validate_choice` applies the same "unknown X; available: ..."
contract to closed enums that are not registries (consensus reducers,
cache modes, metrics modes) — ``SimConfig.__post_init__`` and
``SweepSpec`` validation both route through it.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, TypeVar

T = TypeVar("T")


class Registry:
    """One pluggable axis: a name -> class mapping with uniform errors.

    ``kind`` is the singular noun used in error text ("policy",
    "workload", ...).  ``name_attr`` is the class attribute stamped with
    the registered name ("name" everywhere but faults, which use
    "kind"); ``None`` skips stamping.
    """

    def __init__(self, kind: str, *, name_attr: str = "name"):
        self.kind = kind
        self.name_attr = name_attr
        self._entries: Dict[str, type] = {}

    # -- registration -----------------------------------------------------
    def register(self, name: str) -> Callable[[T], T]:
        """Class decorator: ``@REG.register("name")``.  Registering a
        DIFFERENT class under a taken name is an error (catches
        copy-paste and name collisions); re-registering the same class
        is a no-op (module re-import).  :meth:`unregister` first to
        replace deliberately."""

        def deco(cls: T) -> T:
            prev = self._entries.get(name)
            if prev is not None and prev is not cls:
                raise ValueError(
                    f"{self.kind} {name!r} already registered "
                    f"({prev.__module__}.{prev.__qualname__})"
                )
            if self.name_attr:
                setattr(cls, self.name_attr, name)
            self._entries[name] = cls
            return cls

        return deco

    def unregister(self, name: str) -> None:
        """Remove a registration (tests / deliberate replacement)."""
        self._entries.pop(name, None)

    # -- lookup -----------------------------------------------------------
    def available(self) -> Tuple[str, ...]:
        return tuple(sorted(self._entries))

    def get_class(self, name: str):
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r}; available: "
                f"{', '.join(self.available())}"
            ) from None

    def get(self, name: str):
        return self.get_class(name)()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)


def validate_choice(
    value: str, kind: str, alternatives: Sequence[str]
) -> str:
    """Raise the uniform "unknown <kind> ...; available: ..." ValueError
    when ``value`` is not one of ``alternatives``; return it otherwise."""
    if value not in alternatives:
        raise ValueError(
            f"unknown {kind} {value!r}; available: "
            f"{', '.join(alternatives)}"
        )
    return value
