"""The same-distribution anchor of the JAX generation records, on the CPU.

Proxy-FID(images 0-127, images 128-255) of ``SyntheticDataset(64, 3,
length=256)`` with the port's fallback extractor, as
``scripts/gmm_generation.py:82-92`` computes it, against the value and the
train mean and std that ``docs/examples/gmm_generation.json`` records.  It
needs no model: the data and the extractor are pinned to JAX, so it holds
within rel 1e-3 (the FID's ``sqrtm`` on features from another conv
library), the mean and std bitwise on this host.  The scripts hold the
mean and std within 4 float32 ulps, since another host's numpy may round
them apart; a case shows that limit from both sides.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from colddiff_torch.data import SyntheticDataset
from colddiff_torch.eval.fid import calculate_fid_given_samples, fid_features_fn
from colddiff_torch.scripts._records import compare_ulps

RECORD = Path(__file__).resolve().parents[1] / "docs" / "examples" / "gmm_generation.json"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_half_vs_half_anchor_equals_the_jax_record():
    record = json.loads(RECORD.read_text())
    ds = SyntheticDataset(64, 3, length=256)
    train = np.stack([ds[i] for i in range(256)])
    feats = fid_features_fn(device="cpu")
    assert feats.name == record["extractor"] == "fallback-random-projection"
    got = calculate_fid_given_samples([train[:128], train[128:]], batch_size=32,
                                      features=feats, device="cpu")
    want = record["calibration"]["proxy_fid_train_half_vs_half"]
    assert abs(got - want) <= 1e-3 * want, (got, want)
    for entry in record["gmm"].values():
        assert float(train.mean()) == entry["train_mean"]
        assert float(train.std()) == entry["train_std"]


@pytest.mark.parametrize("key", ["train_mean", "train_std"])
@pytest.mark.parametrize("ulps,within", [(2, True), (-2, True), (4, True), (5, False),
                                         (-5, False)])
def test_host_statistics_limit_is_four_float32_ulps(key, ulps, within):
    """The limit ``untrained_rows`` and the generation records put on the
    train mean and std, from both sides: the JAX value moved by 2 or 4
    float32 ulps passes, by 5 fails."""
    record = json.loads(RECORD.read_text())
    want = next(iter(record["gmm"].values()))[key]
    got = float(np.float32(want) + ulps * abs(np.spacing(np.float32(want))))
    row = compare_ulps(got, want)
    assert row["within"] is within, row
    assert row["ulps"] == pytest.approx(abs(ulps), rel=1e-6)
    assert row["limit"].startswith("4 float32 ulps")
