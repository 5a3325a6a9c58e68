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


def test_render_color_not_yet_ported(capsys):
    assert cli.main(["render-color", "--mode", "hsl"]) == 1
    assert "not yet ported" in capsys.readouterr().out


@pytest.mark.parametrize("opts,match", [
    (dict(refill_rng="hardware"), "hardware generator"),
    (dict(refill_rng="hardware_rw"), "hardware generator"),
    (dict(scatter="pallas"), "TPU deposit backend"),
    (dict(scatter="bigtiles"), "TPU deposit backend"),
    (dict(scatter="sorted"), "TPU deposit backend"),
    (dict(replay_block=1024), "blocked replay"),
    (dict(engine="pallas"), "TPU engine"),
    (dict(engine="oracle"), "--engine oracle is not yet ported"),
    (dict(sampler="mh"), "--sampler mh is not yet ported"),
    (dict(precision="extended"), "extended/float64 is not yet ported"),
    (dict(precision="float64"), "extended/float64 is not yet ported"),
    (dict(replay="host"), "--replay host is not yet ported"),
    (dict(replay_device_share=0.5), "--replay-device-share is not yet"),
    (dict(hist_dtype="uint64"), "--hist-dtype uint64 is not yet ported"),
    (dict(num_devices=4), "num_devices > 1 is not yet ported"),
    (dict(histogram_sharding="rows"), "--hist-sharding rows is not yet"),
])
def test_unported_options_refused(opts, match):
    with pytest.raises(config.ConfigError, match=match):
        config.EngineOptions(**opts).validate()


@pytest.mark.parametrize("argv", [
    ["--scatter", "pallas"], ["--engine", "oracle"], ["--sampler", "mh"],
])
def test_cli_refuses_unported_flags(argv):
    with pytest.raises(cli.CliError):
        cli.parse_args(argv)


@pytest.mark.parametrize("argv", [
    [],
    ["-w", "300", "-h", "200", "-m", "500", "-c", "50", "-g", "2.2",
     "-t", "-1", "--passes", "8", "--seed", "7", "-d", "0"],
    ["--min-real", "-1.5", "--max-real", "0.5", "--emit-filter", "canvas",
     "--fractal", "burning-ship", "--steps-per-pass", "1024"],
    ["--center", "-0.74,0.13", "--span", "0.01", "-w", "200", "-h", "100"],
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


def test_port_never_imports_jax():
    """Importing every module of the package (and chip_smoke) in a fresh
    process leaves jax and cudabrot_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cudabrot_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cudabrot_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('cudabrot_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


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
