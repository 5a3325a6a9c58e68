"""cudabrot_tpu_torch's multi-process rendering (``parallel/distributed.py``
on torch.distributed with the gloo backend) on the CPU.

Two coordinated processes with two CPU devices each must render exactly
what one process renders on four (``tests/test_distributed.py:51`` of the
JAX package): RNG ordinals are global (process p's i-th device is p·2+i)
and the merges are integer sums. The primary alone prints and writes; a
SIGINT on the other process stops both on the same pass.
"""

import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from cudabrot_tpu_torch import cli
from cudabrot_tpu_torch.io import checkpoint as ckpt
from cudabrot_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import sys
import torch
torch.set_num_threads(1)
from cudabrot_tpu_torch.cli import main
sys.exit(main(sys.argv[1:], device="cpu"))
"""

#: Seconds any one child may take (each renders in a few).
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(pid=None, port=None, procs=2):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # Lines reach the pipe as they are printed (the SIGINT test waits for
    # one).
    env["PYTHONUNBUFFERED"] = "1"
    for k in ("CUDABROT_COORDINATOR", "CUDABROT_DISTRIBUTED"):
        env.pop(k, None)
    if pid is not None:
        env.update(CUDABROT_COORDINATOR=f"127.0.0.1:{port}",
                   CUDABROT_NUM_PROCESSES=str(procs),
                   CUDABROT_PROCESS_ID=str(pid))
    return env


def _spawn(args, env):
    return subprocess.Popen([sys.executable, "-c", CHILD, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _group(args, procs=2):
    """``args`` in ``procs`` coordinated processes; their (rc, out, err)."""
    port = _free_port()
    ps = [_spawn(args, _env(pid, port, procs)) for pid in range(procs)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in ps]
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(ps, outs)]


def _render_args(out_dir, *extra):
    return ["-w", "40", "-h", "36", "-m", "60", "-c", "5", "--lane-rows",
            "2", "--steps-per-pass", "128", "--steps-per-flush", "16",
            "--replay-capacity", "4096", "--passes", "3", "-t", "-1",
            "--devices", "4", "--checkpoint-interval", "2",
            "-o", os.path.join(out_dir, "out.pgm"),
            "-s", os.path.join(out_dir, "state.ckpt"), *extra]


@pytest.mark.parametrize("extra", [[], ["--precision", "extended",
                                        "--sample-domain",
                                        "-0.7500005,-0.7499995,"
                                        "0.0549995,0.0550005",
                                        "-m", "128", "-c", "8"],
                                   ["--replay", "host"]])
def test_two_processes_match_single_process(tmp_path, extra):
    single, multi = tmp_path / "single", tmp_path / "multi"
    single.mkdir()
    multi.mkdir()
    ref = subprocess.run(
        [sys.executable, "-c", CHILD, *_render_args(str(single), *extra)],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    results = _group(_render_args(str(multi), *extra))
    for rc, out, err in results:
        assert rc == 0, (out[-1000:], err[-2000:])
    # The primary reports; the other process prints nothing at all.
    assert "Buddhabrot passes took" in results[0][1]
    assert "Distributed runtime: 2 processes" in results[0][1]
    assert results[1][1] == ""
    cfg = cli.parse_args(_render_args(str(single), *extra))[0]
    h_single, m_single = ckpt.load(str(single / "state.ckpt"), cfg)
    h_multi, m_multi = ckpt.load(str(multi / "state.ckpt"), cfg)
    assert m_single["passes"] == m_multi["passes"] == 3
    assert h_single.sum() > 0
    np.testing.assert_array_equal(h_multi, h_single)
    pgm = [(d / "out.pgm").read_bytes() for d in (single, multi)]
    assert pgm[0] == pgm[1]


def test_uint64_merge_above_2_32_does_not_wrap(tmp_path):
    """Two host-replay processes resuming a uint64 checkpoint whose counts
    exceed 2^32: the merged histogram (gathered and summed in uint64, where
    the JAX package's engine sums in uint32) equals one process's, past the
    uint32 range."""
    single, multi = tmp_path / "single", tmp_path / "multi"
    extra = ("--hist-dtype", "uint64")
    cfg = cli.parse_args(_render_args(str(single), *extra))[0]
    big = np.full(cfg.canvas.shape, 0xFFFF_FFF0, np.uint64)
    for d in (single, multi):
        d.mkdir()
        ckpt.save(str(d / "state.ckpt"), big, cfg, passes=0)
    ref = subprocess.run(
        [sys.executable, "-c", CHILD, *_render_args(str(single), *extra)],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    for rc, out, err in _group(_render_args(str(multi), *extra)):
        assert rc == 0, (out[-1000:], err[-2000:])
    h_single, _ = ckpt.load(str(single / "state.ckpt"), cfg)
    h_multi, _ = ckpt.load(str(multi / "state.ckpt"), cfg)
    assert h_multi.dtype == np.uint64
    np.testing.assert_array_equal(h_multi, h_single)
    assert int(h_multi.max()) > 0xFFFF_FFFF
    assert (h_multi >= big).all()


def test_allgather_sum_keeps_the_dtype(monkeypatch):
    """One process: the histogram as it is, in its dtype."""
    h64 = np.full((3, 4), 1 << 40, np.uint64)
    assert distributed.allgather_sum(h64) is h64
    h32 = np.full((3, 4), 7, np.uint32)
    assert distributed.allgather_sum(h32).dtype == np.uint32


def test_sigint_on_nonprimary_stops_both(tmp_path):
    """A SIGINT to the non-primary process stops the whole render: every
    process leaves the pass loop on the same pass (any_flag), or the
    collectives would hang past the timeout. -t -1 without --passes never
    ends on its own."""
    args = ["-w", "32", "-h", "32", "-m", "40", "-c", "4", "--lane-rows",
            "2", "--steps-per-pass", "128", "--steps-per-flush", "16",
            "--replay-capacity", "4096", "-t", "-1", "--devices", "2",
            "-o", str(tmp_path / "out.pgm")]
    port = _free_port()
    ps = [_spawn(args, _env(pid, port)) for pid in range(2)]
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in ps[0].stdout], daemon=True)
    reader.start()
    try:
        seen = ""
        deadline = time.monotonic() + TIMEOUT
        while "Press ctrl+C" not in seen:
            try:
                seen += lines.get(timeout=max(deadline - time.monotonic(),
                                              0.01))
            except queue.Empty:
                break
        assert "Press ctrl+C" in seen, seen
        time.sleep(1.0)
        ps[1].send_signal(signal.SIGINT)
        out1, err1 = ps[1].communicate(timeout=TIMEOUT)
        ps[0].wait(timeout=TIMEOUT)
        reader.join(timeout=TIMEOUT)
        err0 = ps[0].stderr.read()
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
    while not lines.empty():
        seen += lines.get()
    assert ps[0].returncode == 0, (seen[-1000:], err0[-2000:])
    assert ps[1].returncode == 0, (out1[-1000:], err1[-2000:])
    assert "Buddhabrot passes took" in seen
    assert (tmp_path / "out.pgm").exists()


@pytest.mark.parametrize("extra,message", [
    (["--devices", "4", "--hist-sharding", "rows"],
     "the JAX package's row-sharded engine, which this one follows, "
     "cannot read its histogram back across processes"),
    (["--devices", "3"], "--devices 3 does not divide over 2 processes"),
])
def test_multi_process_refusals(tmp_path, extra, message):
    """What two processes cannot run is refused on both, by name, with exit
    code 1: rows across processes (the JAX package's row-sharded engine
    cannot read its histogram back across processes) and a device count
    the processes cannot share."""
    args = ["-w", "16", "-h", "16", "--lane-rows", "2", "--steps-per-pass",
            "128", "--passes", "1", "-t", "-1", "-o",
            str(tmp_path / "x.pgm"), *extra]
    results = _group(args)
    assert [rc for rc, _, _ in results] == [1, 1]
    assert message in results[0][1]
    assert results[1][1] == ""
    assert not (tmp_path / "x.pgm").exists()


def test_unreachable_group_is_an_error(monkeypatch, capsys):
    """A launch environment that names a group the process cannot join is
    an error (exit code 1 from the CLI), never a render alone: an
    incomplete environment, and a coordinator nobody serves."""
    import datetime

    monkeypatch.setenv("CUDABROT_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.delenv("CUDABROT_NUM_PROCESSES", raising=False)
    with pytest.raises(distributed.DistributedError,
                       match="CUDABROT_NUM_PROCESSES"):
        distributed.initialize_from_env(lambda *_: None)
    monkeypatch.setenv("CUDABROT_NUM_PROCESSES", "2")
    monkeypatch.setenv("CUDABROT_PROCESS_ID", "1")
    monkeypatch.setattr(distributed, "TIMEOUT",
                        datetime.timedelta(seconds=2))
    assert cli.main(["-w", "16", "-h", "16", "--passes", "1"],
                    device="cpu") == 1
    assert "Cannot join the process group" in capsys.readouterr().out
    assert distributed.process_count() == 1


def test_single_process_helpers(monkeypatch):
    """Without a launch environment no group is joined, and every helper
    is the identity on one process."""
    for k in ("CUDABROT_COORDINATOR", "CUDABROT_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.initialize_from_env(lambda *_: None)
    assert distributed.process_count() == 1 and distributed.is_primary()
    assert distributed.any_flag(True) and not distributed.any_flag(False)
    h = np.arange(6, dtype=np.uint32).reshape(2, 3)
    np.testing.assert_array_equal(distributed.allgather_sum_u32(h), h)
    np.testing.assert_array_equal(distributed.allgather_ints([3, 4]),
                                  [[3, 4]])
