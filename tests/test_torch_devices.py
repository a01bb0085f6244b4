"""The port's public entry points run on the card unless the caller asks for
the CPU: each one's ``device`` parameter defaults to ``"cuda"``. Without a
card such a default call fails (CUDA is not compiled in or not available);
nothing falls back to the host."""

import inspect

import pytest
import torch

from alphafive_tpu_torch.config import get_preset
from alphafive_tpu_torch.env import vector
from alphafive_tpu_torch.models import evaluator, resnet
from alphafive_tpu_torch.train import evaluate

ENTRY_POINTS = {
    "env.vector.init": vector.init,
    "models.evaluator.net_evaluator": evaluator.net_evaluator,
    "models.resnet.PolicyValueNet.from_flax": resnet.PolicyValueNet.from_flax,
    "models.resnet.FusedPolicyValueNet": resnet.FusedPolicyValueNet.__init__,
    "train.evaluate.random_openings": evaluate.random_openings,
    "train.evaluate.play_games": evaluate.play_games,
    "train.evaluate.evaluate_vs": evaluate.evaluate_vs,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_cuda(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


def test_default_call_without_a_card_fails():
    """On a host without CUDA the default device is refused, not replaced by
    the CPU; an explicit ``device="cpu"`` works."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default call succeeds")
    env = get_preset("tiny_test").env
    with pytest.raises((AssertionError, RuntimeError)):
        vector.init(env, 2)
    assert vector.init(env, 2, "cpu").board.device.type == "cpu"
