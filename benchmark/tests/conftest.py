"""Shared fixtures of the benchmark's CPU tests: the cells, loaded by name."""

from __future__ import annotations

import copy

import pytest

from benchmark.spec import load_cell


@pytest.fixture
def tri_cell():
    return copy.deepcopy(load_cell("tri_iv.chair_table.train_spread"))

