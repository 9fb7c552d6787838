"""The port's synchronous System against the JAX System with surf64
features: 12 frames of the rendered benchmark scene at 320x240, 600
features (tests/torch_system_parity.py states the tolerances and why).
The runs are made once per module, as the JAX System's compiles
dominate."""

import pytest

import torch_system_parity as parity


@pytest.fixture(scope="module")
def runs():
    return parity.runs("surf64")


def test_same_initialization(runs):
    parity.check_same_initialization(runs)


def test_map_counts_agree(runs):
    parity.check_map_counts(runs)


def test_keyframe_trajectories_agree(runs):
    parity.check_keyframe_trajectories(runs)
