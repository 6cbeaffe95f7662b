"""chip_smoke.py's phases at tiny sizes on the CPU, with the Triton
kernel in the Pallas interpreter: the script's control flow, scenes and
checks, without the card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def tiny_scenes():
    return (
        chip_smoke.scene_a(image_size=32),
        chip_smoke.scene_b(image_size=32, views=2, subdivisions=1),
    )


@pytest.mark.parametrize("which", [0, 1])
def test_phase_resolve(tiny_scenes, which):
    res = chip_smoke.phase_resolve(tiny_scenes[which], interpret=True)
    assert res["equal"] == 1.0


@pytest.mark.parametrize("which", [0, 1])
def test_phase_step(tiny_scenes, which):
    res = chip_smoke.phase_step(tiny_scenes[which], steps=2, interpret=True)
    assert res["image_max"] == 0.0
    assert res["ms_triton"] > 0 and res["ms_xla"] > 0


def test_phase_trainer():
    losses = chip_smoke.phase_trainer(image_size=32, steps=4)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_phase_sharded(backend):
    res = chip_smoke.phase_sharded(
        n_devices=4, image_size=16, backend=backend,
        interpret=backend == "triton",
    )
    assert res["mesh"] == {"data": 1, "tile": 2, "face": 2}


def test_scene_b_is_the_deployment_size():
    """Scene (b) at full size: 157,696 faces, 8 views, 512^2 (shapes
    only; nothing is rendered)."""
    b = chip_smoke.scene_b()
    assert b["faces"].shape == (157_696, 3)
    assert b["eyes"].shape == (8, 3)
    assert b["hp"].image_size == 512 and not b["hp"].anti_aliasing


def test_main_without_gpu_fails(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err
