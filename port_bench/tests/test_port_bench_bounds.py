"""The yardstick's arithmetic against the figures it was copied from."""
import pytest

from port_bench.bounds import clip_adam, model_flops, noisy_linear
from port_bench.bounds.peaks import bound_s


def test_canonical_forward_at_six_actions():
    assert model_flops.forward_flops("canonical", 4, 84, 512, 51, 6) \
        == 29_050_880


def test_clip_adam_canonical_is_bound_by_bytes():
    f, b = clip_adam.clip_adam(6_868_842, 4)
    assert b / 3.35e12 > f / 67e12
    assert bound_s(f, b, "float32") * 1e3 == pytest.approx(0.0574, abs=5e-5)


def test_noisy_linear_round_target_is_bound_by_operations():
    f, b = noisy_linear.forward(8192, 3136, 512, "row", "float32")
    assert f / 67e12 > b / 3.35e12
    assert bound_s(f, b, "float32") * 1e3 == pytest.approx(0.786, abs=5e-4)


def test_noisy_linear_backward_learner_row():
    f, b = noisy_linear.backward(32, 3136, 512, "shared", "float32")
    assert bound_s(f, b, "float32") * 1e3 == pytest.approx(0.00795,
                                                           abs=5e-6)
