"""The cell files: every cell of BENCHMARK.json loads, every metric has a
reader, and bad names and units are refused."""

import json

import pytest
from conftest import BENCH_DIR

from hb import cells


def test_every_cell_loads_and_builds_its_command_line():
    bench = cells.load_benchmark()
    assert bench["paths"] == ["h100bench"]
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell.chips == w["chips"] in (1, 4)
        argv = cell.argv(2 ** 31 + 11, 10)
        assert argv[-4:] == ["--seed", str(2 ** 31 + 11), "-t", "10.0"]
        assert {m["name"] for m in cell.end_to_end} == {"points_per_s",
                                                        "setup_s"}
        assert [m["name"] for m in cell.per_layer] == [
            m["name"] for m in bench["per_layer"]
            if w["name"] in m.get("workloads", [w["name"]])]


def test_command_line_parses_to_the_cell():
    from cudabrot_tpu_torch.cli import parse_args

    cell = cells.load_cell("hires15k.fine")
    cfg, _ = parse_args(cell.argv(7, 12))
    assert (cfg.canvas.width, cfg.canvas.height) == (20000, 15000)
    assert (cfg.canvas.min_imag, cfg.canvas.max_imag) == (-1.5, 1.5)
    assert (cfg.band.min_escape_iterations,
            cfg.band.max_escape_iterations) == (45000, 60000)
    assert cfg.seed == 7 and cfg.seconds_to_run == 12.0
    assert cfg.options.precision == "float32"


def test_every_metric_has_a_reader():
    bench = cells.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_configs_name_their_reference_and_canvas():
    bench = cells.load_benchmark()
    for c in bench["configs"]:
        conf = json.loads((BENCH_DIR.parent / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert cells.reference(conf).Scene.from_cell(
            conf["canvas"], {"min_escape": 1, "max_escape": 2}).pixels > 0


@pytest.mark.parametrize("name", ["", "a b", "a,b", "a/b", "-x", "x" * 65,
                                  "é"])
def test_bad_names_are_refused(name):
    with pytest.raises(cells.CellError):
        cells.check_name(name, "cell")


@pytest.mark.parametrize("unit", ["", "points per s", "µs", "x" * 17])
def test_bad_units_are_refused(unit):
    entry = {"name": "m", "unit": unit, "better": "lower",
             "source": "host_clock"}
    with pytest.raises(cells.CellError):
        cells.check_metric(entry, "end_to_end")


def test_good_metric_entries_pass_and_program_sources_are_per_layer_only():
    entry = {"name": "a.b_c", "unit": "points/s", "better": "higher",
             "source": "host_clock"}
    assert cells.check_metric(entry, "end_to_end") is entry
    entry["source"] = "program_counter"
    with pytest.raises(cells.CellError):
        cells.check_metric(entry, "end_to_end")
    assert cells.check_metric(entry, "per_layer") is entry


def test_unknown_cell_and_reader_are_refused():
    with pytest.raises(cells.CellError):
        cells.load_cell("canvas1k.nothing")
    with pytest.raises(cells.CellError):
        cells.reader("no_such_metric")


def test_the_dp4_cell_renders_on_four_cards():
    from cudabrot_tpu_torch.cli import parse_args

    cell = cells.load_cell("canvas1k.dp4")
    assert cell.chips == 4
    cfg, _ = parse_args(cell.argv(7, 12))
    assert cfg.options.num_devices == 4
    assert "replica.issue_ms" in {m["name"] for m in cell.per_layer}
    assert "replica.issue_ms" not in {
        m["name"] for m in cells.load_cell("canvas1k.default").per_layer}
