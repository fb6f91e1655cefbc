"""The control of each cell added with ADM, at the cell's own size on the card:
the reference one precision step below the configuration's, in the
program's place, fails the cell's limits."""

import importlib

import pytest

from benchmark import common

CELLS = ("imagenet256_deblur_adm.train_b8x4", "celeba128_deblur_convnext.sample_b64")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_of_a_new_cell_is_not_correct_on_the_card(card, name):
    cell = common.cell(name)
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic']['kind']}")
    numbers = driver.compare(cell, 20261019, driver.control(cell, 20261019, card), card)
    ok, checks = common.judge(numbers, cell["limits"])
    assert ok is False, checks
