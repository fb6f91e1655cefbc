"""Weights in and out of the torch UNets.

``UnetConvNext`` and ``UnetResNet`` keep the reference's state-dict names,
so a reference ``model.pt`` loads with ``load_state_dict`` and no
conversion; :func:`load_reference_checkpoint` only picks the UNet's tensors
out of the file.  :func:`convnext_state_dict_from_flax` and
:func:`resnet_state_dict_from_flax` are the inverses of
``colddiff.models.import_torch.import_unet_convnext`` and
``import_unet_resnet``: they turn a Flax parameter tree (nested dicts of
numpy arrays) into that state dict, so the two packages can run on the
same weights; :func:`state_dict_from_flax` picks the family from the
tree.  :func:`train_state_from_flax` carries a whole JAX training state
(params, EMA, optax Adam moments, step) of either family over to the
port's Trainer.

Tensor conversions (inverses of the JAX importer's):
  conv, depthwise conv  [kh, kw, I, O] -> [O, I, kh, kw]
  conv-transpose        [kh, kw, I, O] -> [I, O, kh, kw], then flip(kh, kw)
  linear                [I, O]         -> [O, I]
  ConvNeXt LayerNorm    [C]            -> [1, C, 1, 1] (``g``, ``b``)
  ResNet GroupNorm      [C]            -> [C] (``weight``, ``bias``)
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = ["convnext_state_dict_from_flax", "resnet_state_dict_from_flax",
           "state_dict_from_flax", "train_state_from_flax", "load_reference_checkpoint"]

# Flax top-level module -> (torch prefix, kind)
_TOP = {
    "time_mlp1": ("time_mlp.1", "linear"),
    "time_mlp2": ("time_mlp.3", "linear"),
    "mid_block1": ("mid_block1", "block"),
    "mid_attn": ("mid_attn", "attn"),
    "mid_block2": ("mid_block2", "block"),
    "final_block": ("final_conv.0", "block"),
    "final_conv": ("final_conv.1", "conv"),
}
_LEVEL = re.compile(r"(down|up)_(\d+)_(block1|block2|attn|downsample|upsample)")
_LEVEL_PART = {
    "block1": (0, "block"),
    "block2": (1, "block"),
    "attn": (2, "attn"),
    "downsample": (3, "conv"),
    "upsample": (3, "conv_transpose"),
}
# ConvNextBlock submodule -> (torch name, kind)
_BLOCK = {
    "ds_conv": ("ds_conv", "conv"),
    "mlp_dense": ("mlp.1", "linear"),
    "norm": ("net.0", "norm"),
    "net_conv1": ("net.1", "conv"),
    "net_conv2": ("net.3", "conv"),
    "res_conv": ("res_conv", "conv"),
}


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a))


def _put(out: dict, prefix: str, kind: str, p: Mapping) -> None:
    """Convert one Flax leaf module ``p`` of ``kind`` into ``out``."""
    if kind == "norm":
        out[f"{prefix}.g"] = _tensor(np.reshape(p["scale"], (1, -1, 1, 1)))
        out[f"{prefix}.b"] = _tensor(np.reshape(p["bias"], (1, -1, 1, 1)))
        return
    if kind == "group_norm":
        out[f"{prefix}.weight"] = _tensor(p["scale"])
        out[f"{prefix}.bias"] = _tensor(p["bias"])
        return
    k = np.asarray(p["kernel"])
    if kind == "linear":
        w = k.T
    elif kind == "conv":
        w = np.transpose(k, (3, 2, 0, 1))
    elif kind == "conv_transpose":
        w = np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    else:
        raise ValueError(f"unknown parameter kind {kind}")
    out[f"{prefix}.weight"] = _tensor(w)
    if "bias" in p:
        out[f"{prefix}.bias"] = _tensor(p["bias"])


def convnext_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Torch ``UnetConvNext`` state dict from a Flax ``UnetConvNext`` tree.

    ``params`` is ``model.init(...)``'s result or its ``"params"`` entry, as
    nested dicts of numpy (or JAX) arrays.  Dtypes are kept.
    """
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = _LEVEL.fullmatch(name)
        if m:
            side, i, part = m.groups()
            slot, kind = _LEVEL_PART[part]
            prefix = f"{side}s.{i}.{slot}"
        else:
            prefix, kind = _TOP[name]
        if kind == "block":
            for sub_name, leaf in sub.items():
                torch_name, leaf_kind = _BLOCK[sub_name]
                _put(out, f"{prefix}.{torch_name}", leaf_kind, leaf)
        elif kind == "attn":
            _put(out, f"{prefix}.fn.norm", "norm", sub["norm"])
            _put(out, f"{prefix}.fn.fn.to_qkv", "conv", sub["attn"]["to_qkv"])
            _put(out, f"{prefix}.fn.fn.to_out", "conv", sub["attn"]["to_out"])
        else:
            _put(out, prefix, kind, sub)
    return out


# ResNet family: Flax top-level module -> (torch prefix, kind); "block"
# holds leaves of _RESNET_LEAF (a ResnetBlock or a SoftmaxAttention)
_RESNET_TOP = {
    "temb_dense0": ("temb.dense.0", "linear"),
    "temb_dense1": ("temb.dense.1", "linear"),
    "conv_in": ("conv_in", "conv"),
    "mid_block1": ("mid.block_1", "block"),
    "mid_attn": ("mid.attn_1", "block"),
    "mid_block2": ("mid.block_2", "block"),
    "norm_out": ("norm_out", "group_norm"),
    "conv_out": ("conv_out", "conv"),
}
_RESNET_LEVEL = re.compile(r"(down|up)_(\d+)_(block|attn)_(\d+)")
_RESNET_RESAMPLE = re.compile(r"(down|up)_(\d+)_(downsample|upsample)")
_RESNET_LEAF = {"norm1": "group_norm", "norm2": "group_norm", "norm": "group_norm",
                "conv1": "conv", "conv2": "conv", "nin_shortcut": "conv",
                "temb_proj": "linear", "q": "conv", "k": "conv", "v": "conv",
                "proj_out": "conv"}


def _resnet_prefix(name: str):
    m = _RESNET_LEVEL.fullmatch(name)
    if m:
        side, i, part, j = m.groups()
        return f"{side}.{i}.{part}.{j}", "block"
    m = _RESNET_RESAMPLE.fullmatch(name)
    if m:
        side, i, part = m.groups()
        return f"{side}.{i}.{part}.conv", "resample"
    return _RESNET_TOP[name]


def resnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Torch ``UnetResNet`` state dict from a Flax ``UnetResNet`` tree
    (the inverse of ``import_unet_resnet``; ``params`` as for
    :func:`convnext_state_dict_from_flax`)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        prefix, kind = _resnet_prefix(name)
        if kind == "block":
            for leaf_name, leaf in sub.items():
                _put(out, f"{prefix}.{leaf_name}", _RESNET_LEAF[leaf_name], leaf)
        elif kind == "resample":
            _put(out, prefix, "conv", sub["conv"])
        else:
            _put(out, prefix, kind, sub)
    return out


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The torch state dict of a Flax ``UnetConvNext`` or ``UnetResNet``
    tree, the family told by its modules (only the ResNet has ``conv_in``)."""
    inner = params["params"] if "params" in params else params
    if "conv_in" in inner:
        return resnet_state_dict_from_flax(inner)
    return convnext_state_dict_from_flax(inner)


def _adam_moments(opt_state: Any):
    """The ``ScaleByAdamState(count, mu, nu)`` inside an optax state (found
    by its fields, so optax need not be imported)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_moments(sub)
            if found is not None:
                return found
    return None


def train_state_from_flax(params: Mapping, ema_params: Mapping, opt_state: Any,
                          step: int, *, param_names: Sequence[str]) -> Dict[str, Any]:
    """A JAX ``TrainState`` as the port's checkpoint blob
    ``{step, model, ema, opt}``, which ``Trainer.load_state`` takes.

    ``model`` and ``ema`` are ``UnetConvNext`` or ``UnetResNet`` state
    dicts (:func:`state_dict_from_flax`).  ``opt`` is a
    ``torch.optim.Adam`` state dict over the parameters in the order
    ``param_names`` (the model's ``named_parameters()`` order): optax's
    ``ScaleByAdamState(count, mu, nu)`` becomes each parameter's ``step``,
    ``exp_avg`` and ``exp_avg_sq``.  The moments go through the same layout
    transforms as their parameters; Adam is elementwise, so the transformed
    moments are the moments of the transformed parameters.  The param
    group holds only ``params``: an optax state carries no hyperparameters,
    and ``Trainer.load_state`` keeps its own.
    """
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no optax ScaleByAdamState (mu, nu)")
    model = state_dict_from_flax(params)
    mu = state_dict_from_flax(adam.mu)
    nu = state_dict_from_flax(adam.nu)
    names = list(param_names)
    if sorted(names) != sorted(model):
        raise ValueError("param_names do not name the converted parameters: "
                         f"{sorted(set(names) ^ set(model))}")
    count = float(np.asarray(adam.count))
    state = {i: {"step": torch.tensor(count, dtype=torch.float32),
                 "exp_avg": mu[n], "exp_avg_sq": nu[n]}
             for i, n in enumerate(names)}
    return {"step": int(step), "model": model,
            "ema": state_dict_from_flax(ema_params),
            "opt": {"state": state, "param_groups": [{"params": list(range(len(names)))}]}}


# the UNet tensors of both families (``down``/``up`` cover ``downs``/``ups``),
# as colddiff/models/import_torch.py keeps them
_UNET_PREFIXES = ("time_mlp", "downs", "ups", "mid", "final_conv", "temb", "conv_in",
                  "down", "up", "norm_out", "conv_out")


def load_reference_checkpoint(path_or_blob, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The UNet tensors of a reference ``model.pt`` (or an already loaded blob).

    Reference Trainer checkpoints are ``{step, model, ema}``
    (deblurring_diffusion_pytorch.py:1140-1149); a missing or None slot falls
    back to the other with a warning.  DataParallel ``module.`` prefixes and
    the ``denoise_fn.`` scope are stripped and the degradation's buffers
    (gaussian kernels, alphas, ...) dropped, as the JAX importer does.  The
    result loads into :class:`UnetConvNext` or :class:`UnetResNet` with
    ``load_state_dict``.
    """
    blob = (path_or_blob if isinstance(path_or_blob, dict)
            else torch.load(path_or_blob, map_location="cpu"))
    if "model" in blob or "ema" in blob:
        want, other = ("ema", "model") if use_ema else ("model", "ema")
        sd = blob.get(want)
        if sd is None:
            sd = blob.get(other)
            if sd is None:
                raise KeyError(
                    "checkpoint has neither a usable 'model' nor 'ema' state dict")
            warnings.warn(f"checkpoint has no usable '{want}' state dict; "
                          f"falling back to '{other}' weights", stacklevel=2)
    else:
        sd = blob
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        if k.startswith("denoise_fn."):
            k = k[len("denoise_fn."):]
        elif "." in k and not k.startswith(_UNET_PREFIXES):
            continue  # degradation buffers
        out[k] = torch.as_tensor(v)
    return out
