"""Machine constants for the hybrid replay split.

Port of ``cudabrot_tpu/utils/calibration.py``, holding only what the port
reads. The host-replay engine's auto device share
(``engines.cuda_engine.Tuning.auto_device_share``) balances a pass's
classify time and device replay share against the host replay of the rest;
these constants turn its operation and point counts into seconds.
``python -m cudabrot_tpu_torch.utils.calibrate`` measures them on the
current card and host and writes a JSON file, which the engine reads when
(and only when) ``--calibration <file>`` or the
``CUDABROT_TPU_TORCH_CALIBRATION`` environment variable names it; a file
written for the JAX package (``CUDABROT_TPU_CALIBRATION``) is never read.

Calibration is opt-in: the share decides only which side replays an
orbit, never which samples are drawn, but a per-machine file found
implicitly would still make two hosts split differently. The defaults are
one run of the probe on one machine: an NVIDIA H100 80GB HBM3 at a
700.00 W power limit (``nvidia-smi --query-gpu=name,power.limit``), on a
host of 8 cores of a GenuineIntel family 6 model 207 CPU (its virtual
machine hides the model name). Another host is another machine: the same
card's host replay into a DRAM-bound canvas ran 2.4 times slower on a
family 6 model 143 host (``--calibration`` for another machine).

The driver closes the loop with a drift warning: when the worker's
measured replay rate on a DRAM-sized canvas differs 2x from
``host_replay_dram_rate``, it suggests running the probe
(``driver._warn_calibration_drift``).
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured machine constants (see the module docstring for the
    machine the defaults were measured on)."""

    #: Native host replay points/s on an LLC-resident histogram (1000^2)
    #: with the worker's auto thread count (8): the small-canvas share
    #: solve. 131,072 orbits of the band [1000, 8000).
    host_replay_llc_rate: float = 1.792e9
    #: The same into a DRAM-bound canvas (16000x12000): the big-canvas
    #: share solve and the drift warning.
    host_replay_dram_rate: float = 1.006e8
    #: The fused device replay's (replay_deposit) orbit points/s, the same
    #: orbits into the 16000x12000 canvas.
    device_replay_rate: float = 1.654e10
    #: Classify-kernel operations per second (the f32 kernel at the
    #: default cell, 6.55 ms a pass): turns Tuning's step_ops model
    #: (operations per lane-step and per window boundary) into classify
    #: seconds per pass.
    classify_op_rate: float = 8.029e12
    #: Device seconds per pass besides the classify kernel: the
    #: compaction and the payload packing (a host-mode pass at the default
    #: cell, 10.22 ms, less its classify).
    pass_overhead_seconds: float = 3.665e-3
    #: Card-to-host copy rate (bytes/s) of the default cell's pinned
    #: payload (64 MiB).
    link_rate_bytes: float = 2.567e10
    #: Where the numbers came from ("default" or the probe's metadata).
    source: str = "default"


DEFAULT = Calibration()

ENV_VAR = "CUDABROT_TPU_TORCH_CALIBRATION"
_active: Calibration = DEFAULT
_active_path: str | None = None


def load(path: str) -> Calibration:
    """Read a calibration JSON (keys it does not know are ignored)."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path} does not hold a JSON object")
    fields = {f.name for f in dataclasses.fields(Calibration)}
    kwargs = {k: v for k, v in raw.items() if k in fields}
    for k, v in kwargs.items():
        if k != "source" and not isinstance(v, (int, float)):
            raise ValueError(f"{path}: {k} must be a number, not {v!r}")
    kwargs.setdefault("source", path)
    return Calibration(**kwargs)


def save(path: str, cal: Calibration) -> None:
    payload = dataclasses.asdict(cal)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def activate(path: str | None) -> Calibration:
    """Install the calibration the engines use: ``path``, else the
    environment variable's file, else the defaults (``""`` restores the
    defaults). Called by the CLI before engines are built."""
    global _active, _active_path
    if path is None:
        path = os.environ.get(ENV_VAR) or None
    if not path:
        _active, _active_path = DEFAULT, None
    elif path != _active_path:
        _active, _active_path = load(path), path
    return _active


def active() -> Calibration:
    """The calibration in effect (the environment variable's file on first
    use, else the defaults, unless activate() installed one)."""
    global _active, _active_path
    if _active is DEFAULT and _active_path is None:
        env = os.environ.get(ENV_VAR)
        if env:
            _active, _active_path = load(env), env
    return _active
