"""cudabrot_tpu_torch entry points: the CLI on the CPU, the refusal to run
without CUDA unless asked, configuration parity with the JAX package, and
import isolation from JAX."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cudabrot_tpu import cli as jcli
from cudabrot_tpu_torch import cli, config, driver
from cudabrot_tpu_torch.engines import make_engine
from cudabrot_tpu_torch.io import checkpoint, pgm
from cudabrot_tpu_torch.ops import launches
from cudabrot_tpu_torch.utils.device import DeviceError, resolve_device

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores (two
# workers spinning on eight cores made a 4 s oracle pass take 386 s).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = ["-w", "40", "-h", "30", "-m", "60", "-c", "5", "--lane-rows", "4",
         "--steps-per-pass", "128", "--steps-per-flush", "16",
         "--replay-capacity", "8192", "-t", "-1"]


def test_cli_renders_on_cpu(tmp_path):
    out, stats, ck = (str(tmp_path / n) for n in ("x.pgm", "s.json", "c.npz"))
    launches.reset()
    rc = cli.main([*SMALL, "--passes", "3", "-o", out, "--stats-json", stats,
                   "-s", ck, "--png"], device="cpu")
    assert rc == 0
    img = pgm.read_pgm(out)
    assert img.shape == (30, 40) and int(img.max()) == 65535
    assert os.path.exists(str(tmp_path / "x.png"))
    s = json.load(open(stats))
    assert s["engine"] == "cuda" and s["device"] == "cpu" and s["passes"] == 3
    hist = np.load(ck)["hist"]
    assert int(hist.sum()) == s["on_canvas_points"] > 0
    assert launches.COUNTS["classify_plain"] == 3
    assert launches.COUNTS["classify"] == 0
    # Resume continues the pass count and grows the histogram.
    rc = cli.main([*SMALL, "--passes", "2", "-o", out, "-s", ck], device="cpu")
    assert rc == 0
    hist2, meta = checkpoint.load(ck, cli.parse_args([*SMALL])[0])
    assert meta["passes"] == 5 and int(hist2.sum()) > int(hist.sum())


def test_cli_without_cuda_fails_cleanly(capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device exists")
    rc = cli.main(["-w", "40", "-h", "30", "--passes", "1"])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().out
    cfg = config.RenderConfig()
    for call in (lambda: make_engine(cfg), lambda: driver.run_render(cfg),
                 lambda: resolve_device("cuda:0")):
        with pytest.raises(DeviceError):
            call()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(DeviceError, match="Unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("argv,device,message", [
    ([], None, "CUDA is not available"),
    (["--interleave"], None, "CUDA is not available"),
    (["--replay", "host", "--devices", "2", "--hist-sharding", "rows"],
     "cpu", "does not apply to --hist-sharding rows"),
    (["--devices", "2", "--sampler", "mh", "--hist-sharding", "rows"], "cpu",
     "incompatible with row-sharded histograms"),
])
def test_render_color_refusals(capsys, tmp_path, argv, device, message):
    """render-color without CUDA and without device="cpu" returns 1 with
    the main command's CUDA message (it never falls back to the CPU), and a
    forwarded flag the port refuses fails with the main command's message;
    neither writes an image."""
    if device is None and torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device exists")
    out = str(tmp_path / "c.png")
    rc = cli.main(["render-color", "--mode", "hsl", "-w", "16", "-h", "16",
                   "--passes", "1", "-o", out, *argv], device=device)
    assert rc == 1
    assert message in capsys.readouterr().out
    assert not os.path.exists(out)


@pytest.mark.parametrize("opts,match", [
    (dict(refill_rng="hardware"), "hardware generator"),
    (dict(refill_rng="hardware_rw"), "hardware generator"),
    (dict(scatter="sort"), "sort backend was removed"),
    (dict(replay_block=1024), "blocked replay"),
    (dict(engine="pallas"), "TPU engine"),
    (dict(sampler="mh", hist_dtype="uint64", replay="device"),
     "uint64 histograms require host replay"),
    (dict(sampler="mh", replay="host", replay_device_share=0.5),
     "does not apply to --sampler mh"),
    (dict(precision="extended", sampler="mh", num_devices=2,
          replay_device_share=0.5), "does not apply to --sampler mh"),
    (dict(precision="extended", replay="host", replay_device_share=0.5),
     "does not apply to extended-precision renders"),
    (dict(replay="host", hist_dtype="uint64", replay_device_share=0.5),
     "cannot use a device replay share"),
    (dict(engine="oracle", hist_dtype="uint64"),
     "host-replay path only"),
    (dict(hist_dtype="uint64", replay="device"),
     "uint64 histograms require host replay"),
    (dict(num_devices=4, hist_dtype="uint64", replay="device"),
     "uint64 histograms require host replay"),
    (dict(histogram_sharding="rows", num_devices=2, replay="host"),
     "does not apply to --hist-sharding rows"),
])
def test_unported_options_refused(opts, match):
    """What the port refuses: the TPU's options when the configuration is
    built, and the combinations no engine runs (the JAX package's
    messages) when the engine is."""
    with pytest.raises(config.ConfigError, match=match):
        make_engine(config.RenderConfig(
            canvas=config.Canvas(width=16, height=16),
            options=config.EngineOptions(**opts)), device="cpu")


@pytest.mark.parametrize("argv", [
    ["--scatter", "sort"],
    ["--replay-block", "1024"], ["--refill-rng", "hardware"],
])
def test_cli_refuses_unported_flags(argv):
    with pytest.raises(cli.CliError):
        cli.parse_args(argv)


@pytest.mark.parametrize("opts,route", [
    (dict(scatter="pallas"), "ids"),
    (dict(scatter="sorted"), "bigtiles"),
    (dict(scatter="pallas", precision="extended"), "ids"),
    (dict(scatter="sorted", num_devices=2, histogram_sharding="rows"),
     "bigtiles"),
])
def test_tpu_scatter_routes_accepted(opts, route):
    """The JAX package's --scatter pallas and sorted build an engine on
    their id-stream route (the port refused them as TPU backends before
    they were ported)."""
    eng = make_engine(config.RenderConfig(
        canvas=config.Canvas(width=16, height=16),
        options=config.EngineOptions(**opts)), device="cpu")
    inners = getattr(eng, "inners", [eng])
    assert len(inners) == opts.get("num_devices", 1)
    assert all(e.scatter_backend == route for e in inners)


@pytest.mark.parametrize("argv", [
    ["--scatter", "pallas"], ["--scatter", "sorted"],
])
def test_cli_parses_tpu_scatter_routes(argv):
    cfg = cli.parse_args(argv)[0]
    assert cfg.options.scatter == argv[1]


@pytest.mark.parametrize("opts", [
    dict(engine="oracle"), dict(precision="extended"),
    dict(engine="oracle", precision="extended"),
    dict(engine="oracle", precision="float64"),
    dict(precision="extended", emit_filter="canvas"),
    dict(sampler="mh"), dict(sampler="mh", precision="extended"),
    dict(scatter="bigtiles"), dict(scatter="bigtiles", precision="extended"),
    dict(scatter="bigtiles", sampler="mh"),
])
def test_ported_engine_options_validate(opts):
    config.EngineOptions(**opts).validate()


DEEP = ["-w", "32", "-h", "32", "-m", "2000", "-c", "50", "--center",
        "-0.743643887037151,0.131825904205330", "--span", "1e-5", "-t", "-1"]


def test_cli_deep_zoom_extended_renders_on_cpu(tmp_path):
    """The deep-zoom line (--precision extended --center --span) at 32x32:
    a valid PGM through the df32 classify pass and the df32 replay."""
    out, stats, ck = (str(tmp_path / n) for n in ("d.pgm", "s.json", "c.npz"))
    launches.reset()
    rc = cli.main([*DEEP, "--precision", "extended", "--lane-rows", "4",
                   "--steps-per-pass", "1024", "--steps-per-flush", "64",
                   "--replay-capacity", "4096", "--passes", "2", "-o", out,
                   "--stats-json", stats, "-s", ck], device="cpu")
    assert rc == 0
    img = pgm.read_pgm(out)
    assert img.shape == (32, 32) and int(img.max()) == 65535
    s = json.load(open(stats))
    assert s["engine"] == "cuda" and s["passes"] == 2
    assert int(np.load(ck)["hist"].sum()) == s["on_canvas_points"] > 0
    assert launches.COUNTS["classify_ext_plain"] == 2
    assert launches.COUNTS["replay_deposit_ext_plain"] == 2
    assert launches.COUNTS["classify_plain"] == 0
    assert launches.COUNTS["classify_ext"] == 0


MH_CROP = ["--sampler", "mh", "--center", "-0.7436,0.1319", "--span", "6e-3",
           "-w", "40", "-h", "40", "-m", "500", "-c", "50", "-t", "-1",
           "--lane-rows", "4", "--steps-per-pass", "2048",
           "--steps-per-flush", "256", "--mh-burnin", "1"]


def test_cli_mh_crop_renders_on_cpu(tmp_path, capsys):
    """--sampler mh through cli.main on the CPU: a valid PGM, exact deposit
    accounting in 1/256 units, the MH stats keys, and the checkpoint's
    weight-scale guard both ways."""
    out, stats, ck = (str(tmp_path / n) for n in ("m.pgm", "s.json", "c.npz"))
    launches.reset()
    rc = cli.main([*MH_CROP, "--passes", "3", "-o", out, "--stats-json",
                   stats, "-s", ck], device="cpu")
    assert rc == 0
    img = pgm.read_pgm(out)
    assert img.shape == (40, 40) and int(img.max()) == 65535
    s = json.load(open(stats))
    assert s["engine"] == "cuda" and s["device"] == "cpu" and s["passes"] == 3
    hist = np.load(ck)["hist"]
    assert int(hist.sum()) == s["on_canvas_points"] == s["mh_deposited"] > 0
    assert s["weight_scale"] == 256 and s["mh_lost_weight"] == 0
    assert s["replay_dropped"] == 0 and s["mh_accepts"] > 0
    assert {"mh_merges", "mh_merged_rep"} <= set(s)
    assert launches.COUNTS["classify_mh_plain"] == 3
    assert launches.COUNTS["classify_mh"] == launches.COUNTS["mh_deposit"] == 0
    # The sample domain is 8x the window around the centre.
    cfg = cli.parse_args(MH_CROP)[0]
    assert cfg.sample_domain == pytest.approx(
        (-0.7436 - 0.024, -0.7436 + 0.024, 0.1319 - 0.024, 0.1319 + 0.024))
    # Resuming without --sampler mh would mix 1/256-unit counts with raw
    # ones: a clean error, no traceback. With it, the render continues.
    capsys.readouterr()
    cv = cfg.canvas
    uniform = [
        "--min-real", repr(cv.min_real), "--max-real", repr(cv.max_real),
        "--min-imag", repr(cv.min_imag), "--max-imag", repr(cv.max_imag),
        "--sample-domain", ",".join(repr(v) for v in cfg.sample_domain),
        *MH_CROP[MH_CROP.index("-w"):MH_CROP.index("--mh-burnin")]]
    assert cli.main([*uniform, "--replay-capacity", "4096", "--passes", "1",
                     "-o", out, "-s", ck], device="cpu") == 1
    msg = capsys.readouterr().out
    assert "1/256" in msg and "--sampler" in msg
    assert cli.main([*MH_CROP, "--passes", "2", "-o", out, "-s", ck],
                    device="cpu") == 0
    hist2, meta = checkpoint.load(ck, cfg)
    assert meta["passes"] == 5 and meta["weight_scale"] == 256
    assert int(hist2.sum()) > int(hist.sum())


def test_cli_mh_extended_renders_on_cpu(tmp_path):
    """--sampler mh --precision extended at a 2e-5 window (the df32 chain
    pass, centre-relative window)."""
    out, stats = str(tmp_path / "e.pgm"), str(tmp_path / "s.json")
    launches.reset()
    rc = cli.main(["--sampler", "mh", "--precision", "extended", "--center",
                   "-0.743643887,0.131825904", "--span", "2e-5", "-w", "32",
                   "-h", "32", "-m", "3000", "-c", "100", "-t", "-1",
                   "--inner-unroll", "4", "--steps-per-flush", "256",
                   "--steps-per-pass", "4096", "--lane-rows", "2",
                   "--mh-burnin", "0", "--passes", "2", "-o", out,
                   "--stats-json", stats], device="cpu")
    assert rc == 0
    assert pgm.read_pgm(out).shape == (32, 32)
    s = json.load(open(stats))
    assert s["on_canvas_points"] == s["mh_deposited"] > 0
    assert s["weight_scale"] == 256 and s["replay_dropped"] == 0
    assert launches.COUNTS["classify_ext_mh_plain"] == 2
    assert launches.COUNTS["classify_ext_mh"] == 0


def test_cli_mh_bad_input(capsys):
    with pytest.raises(cli.CliError) as e:
        cli.parse_args(["--sampler", "bogus"])
    assert "Unknown sampler: bogus" in e.value.message
    with pytest.raises(cli.CliError) as e:
        cli.parse_args(["--sampler", "mh", "--mh-restart", "300"])
    assert "mh_restart" in e.value.message
    assert cli.main(["--sampler", "mh", "--engine", "oracle", "-w", "32",
                     "-h", "32", "--passes", "1"], device="cpu") == 1
    assert "cuda engine only" in capsys.readouterr().out


@pytest.mark.parametrize("precision", ["extended", "float64", "float32"])
def test_cli_oracle_renders_on_cpu(tmp_path, precision):
    out, stats = str(tmp_path / "o.pgm"), str(tmp_path / "s.json")
    argv = [*DEEP, "-m", "400", "--engine", "oracle", "--precision",
            precision, "--passes", "1", "-o", out, "--stats-json", stats]
    rc = cli.main(argv, device="cpu")
    assert rc == 0
    assert open(out, "rb").read().startswith(b"P5\n32 32\n65535\n")
    s = json.load(open(stats))
    assert s["engine"] == "oracle" and s["samples"] == 1 << 16
    assert s["in_band"] > 0


def test_cli_float64_without_oracle_is_a_clean_error(tmp_path, capsys):
    rc = cli.main([*DEEP, "--precision", "float64", "--passes", "1", "-o",
                   str(tmp_path / "x.pgm")], device="cpu")
    assert rc == 1
    out = capsys.readouterr().out
    assert "float64 iteration is not supported by the cuda engine" in out
    assert "--engine oracle" in out and "Traceback" not in out
    assert not (tmp_path / "x.pgm").exists()


@pytest.mark.parametrize("argv", [
    [],
    ["-w", "300", "-h", "200", "-m", "500", "-c", "50", "-g", "2.2",
     "-t", "-1", "--passes", "8", "--seed", "7", "-d", "0"],
    ["--min-real", "-1.5", "--max-real", "0.5", "--emit-filter", "canvas",
     "--fractal", "burning-ship", "--steps-per-pass", "1024"],
    ["--center", "-0.74,0.13", "--span", "0.01", "-w", "200", "-h", "100"],
    ["--precision", "extended", "--center",
     "-0.743643887037151,0.131825904205330", "--span", "1e-5", "-m", "20000",
     "-c", "500"],
    ["--engine", "oracle", "--precision", "float64", "--replay-capacity",
     "4096"],
])
def test_parse_args_matches_jax(argv):
    """The same flags give the same render description (lane_rows aside:
    the port sizes it for an H100)."""
    tc, te = cli.parse_args(argv)
    jc, je = jcli.parse_args(argv)
    t, j = dataclasses.asdict(tc), dataclasses.asdict(jc)
    assert t["options"].pop("lane_rows") == 2048
    assert j["options"].pop("lane_rows") == 64
    assert t == j
    assert dataclasses.asdict(te) == dataclasses.asdict(je)


@pytest.mark.parametrize("argv,msg", [
    (["--frobnicate"], "Invalid argument: --frobnicate"),
    (["-m"], "Argument -m needs a value."),
    (["-m", "12x"], "Invalid number given to argument -m: 12x"),
    (["-w", "0"], "Output width must be positive."),
])
def test_parse_errors_match_jax(argv, msg):
    with pytest.raises(cli.CliError) as te:
        cli.parse_args(argv)
    with pytest.raises(jcli.CliError) as je:
        jcli.parse_args(argv)
    assert te.value.message == je.value.message == msg


def test_port_never_imports_jax(tmp_path):
    """Importing every module of the package (and chip_smoke) in a fresh
    process, and rendering through the host replay (the native library,
    the worker, the calibration), leaves jax and cudabrot_tpu out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cudabrot_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from cudabrot_tpu_torch import cli\n"
        "assert cli.main(['-w', '16', '-h', '16', '--lane-rows', '1', "
        "'--steps-per-pass', '64', '--steps-per-flush', '16', "
        "'--replay-capacity', '4096', '--passes', '1', '-t', '-1', "
        "'--hist-dtype', 'uint64', '-o', sys.argv[1]], device='cpu') == 0\n"
        "for m in ('io.native', 'engines.host_replay', 'utils.calibration', "
        "'utils.calibrate', 'parallel.data_parallel'):\n"
        "    assert 'cudabrot_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cudabrot_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('cudabrot_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "u64.pgm")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 19


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero with no result line where CUDA is
    unavailable, and when it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
