"""Names of the reference whose module the port does not have yet: each
raises ``NotImplementedError`` naming its ``ROADMAP.md`` item when used, so
it never silently vanishes from the surface."""
from __future__ import annotations

M12_PART3 = ("M12 part 3 (parameter server, RPC, elastic, auto-tuner, "
             "checkpoint, watchdog, auto-parallel engine; ROADMAP queue 1)")


def function(qualname, item):
    """A stand-in function for ``qualname`` that raises, naming ``item``."""
    def f(*args, **kwargs):
        raise NotImplementedError(
            f"{qualname} is {item}, which the port does not have yet")
    f.__name__ = qualname.rsplit(".", 1)[-1]
    f.__qualname__ = f.__name__
    return f


def cls(qualname, item):
    """A stand-in class for ``qualname`` whose construction raises."""
    def init(self, *args, **kwargs):
        raise NotImplementedError(
            f"{qualname} is {item}, which the port does not have yet")
    name = qualname.rsplit(".", 1)[-1]
    return type(name, (), {"__init__": init, "__doc__": f"Not ported: {item}."})


class Module:
    """A stand-in module: any attribute read raises, naming ``item``."""

    def __init__(self, qualname, item):
        self._qualname, self._item = qualname, item

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(
            f"{self._qualname}.{name} is {self._item}, which the port does "
            "not have yet")
