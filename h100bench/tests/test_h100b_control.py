"""The control: the plain reference computed in bfloat16, the precision
below the configurations' float32, put in the program's place, has to
fail the comparison that decides ``correct``. On the CPU at a tiny size;
on a card (``-m cuda``) at each cell's own size and plan, three seeds
each, at every replica's RNG ordinal, printing the readings."""

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
    return ref.plan_of(engine), scene, len(check.engines_of(engine))


@pytest.mark.parametrize("band", [(20, 100), (200, 2000)])
def test_control_fails_on_the_cpu(band):
    plan, scene, _ = plan_and_scene(tiny_cell(band=band), "cpu")
    got = check.control_checks(ref, SEEDS[0], 0, plan, scene, "cpu")
    assert got["lanes"] > 0


def test_reference_at_float32_passes_itself():
    plan, scene, _ = plan_and_scene(tiny_cell(), "cpu")
    got = check.control_checks(ref, SEEDS[0], 0, plan, scene, "cpu",
                               dtype=torch.float32)
    assert got == {"bins": 0, "counters": 0, "lanes": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.load_benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(cuda_device, cell):
    cell = cells.load_cell(cell)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{cell.name} needs {cell.chips} cards")
    plan, scene, replicas = plan_and_scene(cell, cuda_device)
    for seed in SEEDS:
        for ordinal in range(replicas):
            got = check.control_checks(ref, seed, 0, plan, scene,
                                       cuda_device, ordinal=ordinal)
            print(json.dumps({"control": cell.name, "seed": seed,
                              "ordinal": ordinal, **got}))
            assert any(v > check.LIMIT for v in got.values())


def test_plan_of_takes_the_first_replica_and_refuses_by_name():
    plan, _, replicas = plan_and_scene(tiny_cell(flags={"--devices": "3"}),
                                       "cpu")
    assert replicas == 3
    assert plan == plan_and_scene(tiny_cell(), "cpu")[0]
    for name in ref.REFUSED_ENGINES:
        with pytest.raises(ValueError, match=name):
            ref.plan_of(type(name, (), {})())
