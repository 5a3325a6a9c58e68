"""The control: the plain reference computed in bfloat16, the precision
below the configurations' float32, put in the program's place, has to
fail the comparison that decides ``correct``. On the CPU at a tiny size;
on a card (``-m cuda``) at each cell's own size and plan, three seeds
each, printing the readings."""

import json

import pytest
import torch
from conftest import tiny_cell

from hb import cells, check
from reference import uniform_f32 as ref

SEEDS = (2 ** 31 + 3, 3_000_000_019, 4_123_456_789)


def plan_and_scene(cell, device):
    from cudabrot_tpu_torch import engines
    from cudabrot_tpu_torch.cli import parse_args

    cfg, _ = parse_args(cell.argv(1, 1))
    engine = engines.make_engine(cfg, device=device)
    scene = ref.Scene.from_cell(cell.config["canvas"], cell.traffic["band"])
    return check.plan_of(engine, ref), scene


@pytest.mark.parametrize("band", [(20, 100), (200, 2000)])
def test_control_fails_on_the_cpu(band):
    plan, scene = plan_and_scene(tiny_cell(band=band), "cpu")
    got = check.control_checks(ref, SEEDS[0], 0, plan, scene, "cpu")
    assert got["lanes"] > 0


def test_reference_at_float32_passes_itself():
    plan, scene = plan_and_scene(tiny_cell(), "cpu")
    got = check.control_checks(ref, SEEDS[0], 0, plan, scene, "cpu",
                               dtype=torch.float32)
    assert got == {"bins": 0, "counters": 0, "lanes": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.load_benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(cuda_device, cell):
    plan, scene = plan_and_scene(cells.load_cell(cell), cuda_device)
    for seed in SEEDS:
        got = check.control_checks(ref, seed, 0, plan, scene, cuda_device)
        print(json.dumps({"control": cell, "seed": seed, **got}))
        assert any(v > check.LIMIT for v in got.values())
