"""Model families found by name: a family is a file of its own, which the
harness takes with no other file touched, and the two accepted families
keep the parameters they had when they were branches of the harness."""

import hashlib
import json
import sys

import pytest
import torch
from torch import nn

from benchmark import common, families, flops
from benchmark.drivers import sample
from benchmark.reference import models as ref_models

FAMILY = "TwoConvNHWC"
TWO_CONV = '''
"""A throwaway family: two convolutions, NHWC in and out, with a time input."""
import torch
import torch.nn.functional as F
from torch import nn


class TwoConv(nn.Module):
    def __init__(self, ch, channels):
        super().__init__()
        self.conv_in = nn.Conv2d(channels, ch, 3, padding=1)
        self.time = nn.Linear(1, ch)
        self.conv_out = nn.Conv2d(ch, channels, 3, padding=1)

    def forward(self, x, t, q=lambda v: v):
        h = F.conv2d(q(x.permute(0, 3, 1, 2)), q(self.conv_in.weight), self.conv_in.bias,
                     padding=1)
        h = h + F.linear(q(t.float()[:, None]), q(self.time.weight), self.time.bias)[..., None, None]
        return F.conv2d(q(F.silu(h)), q(self.conv_out.weight), self.conv_out.bias,
                        padding=1).permute(0, 2, 3, 1)


def port(config):
    with torch.device("meta"):
        return TwoConv(config["model"]["ch"], config["channels"])


def reference(config):
    return TwoConv(config["model"]["ch"], config["channels"])
'''
# sha256 of the reference's parameter names and shapes and of the modules
# whose weights make_weights draws, in order, read when each family was a
# branch of reference.models.build and common.port_model
DIGESTS = {
    "celeba128_deblur_convnext":
        "a92fd769fadff22c406cbd49592c66e76d71ec6d9a498b0156a07af3121842f6",
    "cifar10_deblur_resnet":
        "07f594cc9a53e43763e61c0120b6246db1199b67b9019f9abbebd83b66416df8",
}


@pytest.fixture
def two_conv(tmp_path, monkeypatch):
    """A configuration of a family whose file lies outside the repository."""
    (tmp_path / f"{FAMILY}.py").write_text(TWO_CONV)
    monkeypatch.setattr(families, "__path__", [*families.__path__, str(tmp_path)])
    yield {"model": {"family": FAMILY, "ch": 4}, "image_size": 8, "channels": 3}
    sys.modules.pop(f"{families.__name__}.{FAMILY}", None)
    if hasattr(families, FAMILY):
        delattr(families, FAMILY)


def test_a_new_family_is_a_file_of_its_own(two_conv):
    cell = {"config": two_conv, "traffic": {"pool_images": 6, "batch": 4}}
    inp = sample.inputs(cell, 2**31 + 17, "cpu")
    assert list(inp["weights"]) == ["conv_in.weight", "conv_in.bias", "time.weight",
                                    "time.bias", "conv_out.weight", "conv_out.bias"]
    port = common.port_model(two_conv, inp["weights"], "cpu")
    ref = ref_models.build(two_conv)
    ref.load_state_dict(inp["weights"])
    x, t = inp["pool"][inp["rows"][0]], torch.tensor([0, 3, 9, 19])
    with torch.no_grad():
        got, want = port(x, t), ref(x, t)
    assert got.shape == (4, 8, 8, 3) and got.abs().max() > 0
    assert torch.equal(got, want)
    # two 3x3 convs of 8 x 8 x 3 x 4 multiply-adds each, and the time's 1 x 4
    assert flops.forward_flops(two_conv) == 2 * (2 * 8 * 8 * 3 * 4 * 9) + 2 * 4


@pytest.mark.parametrize("family", ["NoSuchFamily", "UnetResNet.port"])
def test_an_unknown_family_names_the_file_it_looked_for(family):
    config = {"model": {"family": family}, "image_size": 8, "channels": 3}
    want = str(common.BENCH / "families" / f"{family}.py")
    with pytest.raises(ValueError, match="looked for") as err:
        ref_models.build(config)
    assert want in str(err.value)
    with pytest.raises(ValueError, match="looked for"):
        common.port_model(config, {}, "cpu")


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_accepted_families_keep_their_parameters(name):
    config = common.load_json(common.BENCH / "configs" / f"{name}.json")
    with torch.device("meta"):
        ref = ref_models.build(config)
        port = families.find(config).port(config)
    drawn = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
    listing = {"parameters": [[n, list(p.shape)] for n, p in ref.named_parameters()],
               "drawn": [[n, type(m).__name__] for n, m in ref.named_modules()
                         if isinstance(m, drawn)]}
    assert hashlib.sha256(json.dumps(listing).encode()).hexdigest() == DIGESTS[name]
    assert ({n: p.shape for n, p in port.named_parameters()}
            == {n: p.shape for n, p in ref.named_parameters()})
