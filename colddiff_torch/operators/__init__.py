"""Degradation operator registry.

Only ``blur`` is ported so far.  The other names of ``colddiff.operators``
raise ``NotImplementedError`` that names the ``ROADMAP.md`` item that will
port them.
"""

from .base import Degradation
from .blur import GaussianBlur

_REGISTRY = {
    "blur": GaussianBlur,
}

# colddiff.operators names not ported yet -> the ROADMAP.md item porting them
_PENDING = {
    name: "ROADMAP.md section 1, item 8 (other operators)"
    for name in ("noise", "mix", "decolor", "fade", "fade_naive",
                 "fade_generation", "resolution", "snow")
}


def get_operator(name: str, **cfg) -> Degradation:
    """Build a degradation operator by name (only 'blur' is ported).

    ``cfg`` is the JAX ``get_operator``'s keywords plus ``device``, where the
    operator's tables live: ``"cuda"`` unless the caller asks for the CPU.
    """
    if name in _PENDING:
        raise NotImplementedError(
            f"degradation '{name}' is not ported to colddiff_torch yet; "
            f"see {_PENDING[name]}")
    try:
        cls = _REGISTRY[name]
    except KeyError as e:
        raise ValueError(
            f"unknown degradation '{name}'; have {sorted(_REGISTRY)}") from e
    return cls.create(**cfg)


__all__ = ["Degradation", "GaussianBlur", "get_operator"]
