"""Degradation operator registry.

Ported: ``blur``, ``decolor``, ``fade``, ``fade_generation`` and
``resolution``.  The other names of ``colddiff.operators`` raise
``NotImplementedError`` that names the ``ROADMAP.md`` item that will port
them.
"""

from .base import Degradation
from .blur import GaussianBlur
from .decolor import Decolorization
from .fade import Fade
from .fade_generation import FadeGeneration
from .resolution import Resolution

_REGISTRY = {
    "blur": GaussianBlur,
    "decolor": Decolorization,
    "fade": Fade,
    "fade_generation": FadeGeneration,
    "resolution": Resolution,
}

# colddiff.operators names not ported yet -> the ROADMAP.md item porting them
_PENDING = {
    "noise": "ROADMAP.md section 1, item 8 (Family-B noise and mix)",
    "mix": "ROADMAP.md section 1, item 8 (Family-B noise and mix)",
    "snow": "ROADMAP.md section 1, item 8 (snow, with og)",
    "fade_naive": "ROADMAP.md section 1, item 8 (fade_naive and its spiral routines)",
}


def get_operator(name: str, **cfg) -> Degradation:
    """Build a degradation operator by name.

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


__all__ = ["Degradation", "Decolorization", "Fade", "FadeGeneration", "GaussianBlur",
           "Resolution", "get_operator"]
