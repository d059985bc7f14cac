"""Small shared utilities."""
from __future__ import annotations

import inspect


def parse_count(s: str) -> int:
    """'1e7', '10_000', '1<<20' style counts: the CLI's edge and row
    count grammar."""
    s = s.replace("_", "")
    if "<<" in s:
        a, b = s.split("<<")
        return int(a) << int(b)
    return int(float(s))


def accepts_kwarg(fn, name: str) -> bool:
    """True when ``fn`` can be called with keyword ``name``: threads
    optional engine kwargs (e.g. ``batch=``) through pluggable generator
    and aligner interfaces.  A ``**kwargs`` catch-all accepts every
    name."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    if name in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def call_with_optional_kwargs(fn, *args, **optional):
    """``fn(*args)`` plus whichever of ``optional`` are non-None and in
    ``fn``'s signature."""
    kwargs = {k: v for k, v in optional.items()
              if v is not None and accepts_kwarg(fn, k)}
    return fn(*args, **kwargs)
