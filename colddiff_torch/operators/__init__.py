"""Degradation operator registry: the nine operators of ``colddiff.operators``.

``get_operator(name, **cfg)`` builds one by name with the JAX
``get_operator``'s keywords plus ``device`` (the card unless the caller asks
for the CPU).
"""

from .base import Degradation
from .blur import GaussianBlur
from .decolor import Decolorization
from .fade import Fade
from .fade_generation import FadeGeneration
from .fade_naive import FadeNaive
from .noise import Animorphosis, GaussianNoise, Interpolation
from .resolution import Resolution
from .snow import Snow

_REGISTRY = {
    "blur": GaussianBlur,
    "noise": GaussianNoise,
    "mix": Animorphosis,
    "decolor": Decolorization,
    "fade": Fade,
    "fade_naive": FadeNaive,
    "fade_generation": FadeGeneration,
    "resolution": Resolution,
    "snow": Snow,
}


def get_operator(name: str, **cfg) -> Degradation:
    """Build a degradation operator by name.

    ``cfg`` is the JAX ``get_operator``'s keywords plus ``device``, where the
    operator's tables live: ``"cuda"`` unless the caller asks for the CPU.
    """
    try:
        cls = _REGISTRY[name]
    except KeyError as e:
        raise ValueError(
            f"unknown degradation '{name}'; have {sorted(_REGISTRY)}") from e
    return cls.create(**cfg)


__all__ = ["Degradation", "Animorphosis", "Decolorization", "Fade", "FadeGeneration",
           "FadeNaive", "GaussianBlur", "GaussianNoise", "Interpolation", "Resolution",
           "Snow", "get_operator"]
