"""Command-line interface.

Flag-for-flag compatible with the reference CLI (ParseArguments,
cudabrot.cu:662-754): `-d -o -s -m -c -w -h -g -t --min-real --max-real
--min-imag --max-imag --help`, with the same defaults (cudabrot.cu:763-772,
530-543), the same strict numeric parsing (trailing garbage rejected,
cudabrot.cu:625-658), and the same lifecycle prints. Note `-h` is image
*height*; help is `--help` only — which is why this is a hand-rolled scan
like the reference rather than argparse.

TPU-native extensions (all long-form, so no reference flag is shadowed):
`--fractal`, `--sample-domain`, `--engine`, `--scatter`, `--precision`,
`--seed`, `--passes`,
`--devices`, `--checkpoint-interval`, `--png`, `--stats-json`,
`--lane-rows`, `--steps-per-pass`, `--pipeline`. A `render-color`
subcommand replaces the reference's out-of-process bash/ImageMagick color
pipeline (generate_hires_color_image.sh).

Port of ``cudabrot_tpu/cli.py``: ``parse_args`` and the usage text are
copies; ``run`` drives this package's engine, on ``cuda:<-d>`` unless the
caller passes ``device="cpu"``. ``render-color`` is not yet ported.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Callable

from cudabrot_tpu_torch.config import (
    Canvas,
    ConfigError,
    EngineOptions,
    IterationBand,
    RenderConfig,
)

USAGE = """Usage: {prog} [options]

Options may be one or more of the following:
  --help: Prints these instructions.
  -d <device number>: Sets which accelerator device to use. Defaults to
     device 0.
  -o <output file name>: If provided, the rendered image will be saved
     to a .pgm file with the given name. Otherwise, saves the image
     to output.pgm.
  -m <max escape iterations>: The maximum number of iterations to use
     before giving up on seeing whether a point escapes.
  -c <min escape iterations>: If a point escapes before this number of
     iterations, it will be ignored.
  -g <gamma correction>: A gamma-correction value to use on the
     resulting image. If negative, no gamma correction will occur.
  -t <seconds to run>: A number of seconds to run the calculation for.
     Defaults to 10.0. If negative, the program will run continuously
     and will terminate (saving the image) when it receives a SIGINT.
  -w <width>: The width of the output image, in pixels. Defaults to
     1000.
  -h <height>: The height of the output image, in pixels. Defaults to
     1000.
  -s <save/load file>: If provided, this gives a file name into which
     the rendering buffer will be saved, for future continuation.
     If the program is loaded and the file exists, the buffer will be
     filled with the contents of the file, but the dimensions must
     match. Note that this file may be huge for high-resolution images.

The following settings control the location of the output image on the
complex plane, but samples are always drawn from the entire Mandelbrot-
set domain (-2-2i to 2+2i). So these settings can be used to save
memory or "crop" the output, but won't otherwise speed up rendering:
  --min-real <min real>: The minimum value along the real axis to
             include in the output image. Defaults to -2.0.
  --max-real <max real>: The maximum value along the real axis to
             include in the output image. Defaults to 2.0.
  --min-imag <min imag>: The minimum value along the imaginary axis to
             include in the output image. Defaults to -2.0.
  --max-imag <max imag>: The maximum value along the imaginary axis to
             include in the output image. Defaults to 2.0.

TPU-native extensions:
  --fractal <name>: buddhabrot (default), burning-ship (the
             reference's compile-time RENDER_BURNING_SHIP switch), or
             anti-buddhabrot (orbits of NON-escaping samples; -c is
             ignored).
  --sample-domain <minr,maxr,mini,maxi>: restrict the region samples
             (c values) are drawn from (default: the full -2-2i to
             2+2i domain, like the reference). Shrinking it refines
             the sample grid proportionally (useful for deep crops)
             — but note only orbits SEEDED inside the window are
             rendered, so this is not a plain crop of the full image.
  --center <re,im> / --span <s>: zoom shorthand — one window centered
             at re+im*i with real extent s (imag extent scaled by the
             h/w pixel aspect) becomes BOTH the canvas bounds and the
             sample domain (with --sampler mh the sample domain is 8x
             the window instead — MH seeds contributors from AROUND
             the crop; that is the point of the chains). The deep-zoom
             spelling:
             --precision extended --center -0.743644,0.131826 --span 1e-5
  --engine <name>: auto (default), pallas, or oracle.
  --scatter <name>: histogram accumulation backend: auto (default),
             pallas (Mosaic RMW kernel, VMEM-resident canvases),
             bigtiles (sort + tile-streaming Mosaic RMW, >VMEM
             canvases), sorted (sort + collapsed scatter-add; A/B
             only), or xla.
  --precision <p>: float32 (default), float64 (oracle engine only),
             or extended — double-float (~2^-48) TPU deep-zoom
             arithmetic for canvases narrower than ~1e-4, where
             float32 orbit points quantize coarser than a pixel.
             Pair with --sample-domain set to the same window.
  --hist-dtype <d>: uint32 (default) or uint64 — 64-bit histogram bins
             for extreme-duration renders (host replay only).
  --seed <n>: RNG seed. Defaults to 1337.
  --passes <n>: Stop after exactly n engine passes (deterministic
             alternative to -t).
  --devices <n>: Data-parallelize over n devices (default: 1; 'all'
             uses every visible device).
  --checkpoint-interval <n>: With -s, also write the checkpoint every n
             passes (default: only at exit, like the reference).
  --preview <file>: with --checkpoint-interval, write a tone-mapped PNG
             of the in-progress render every interval (atomic replace;
             point a viewer at it for a live preview).
  --png: Additionally save the image as 16-bit PNG next to the PGM.
  --stats-json <file>: Write render statistics as JSON.
  --replay <mode>: orbit replay execution: auto (default), host
             (native C++ engine overlapped with classification), or
             device.
  --replay-threads <n>: threads for the native host replay engine
             (per-thread private histograms, deterministic merge).
             Defaults to one per available core.
  --replay-device-share <s>: in host-replay mode, the orbit-point mass
             fraction the DEVICE replays concurrently (hybrid split;
             0 forces pure host replay, negative restores the
             auto-tuned share). Benchmarking/ops override of
             Tuning.auto_device_share.
  --refill-rng <mode>: lane-refill random stream: threefry (default —
             in-kernel Threefry-2x32, bit-exact with jax.random on
             every backend), hardware_rw (TPU hardware generator
             re-seeded every window; statistically indistinguishable
             from threefry per benchmarks/prng_bias_probe.py and
             ~25% faster at classify-bound bands), or hardware
             (free-running hardware generator; deep-tail biased,
             perf experiments only).
  --emit-filter <mode>: any (default — every band-passing orbit is
             replayed, reference semantics) or canvas (replay only
             orbits whose trajectory entered the canvas window:
             identical rendered measure — non-visitors deposit
             nothing — at a fraction of the replay/transfer cost
             when the canvas crops the plane).
  --sampler <mode>: sample selection: uniform (default — independent
             uniform draws, reference semantics) or mh
             (Metropolis-Hastings importance sampling: per-lane Markov
             chains target samples whose orbits hit the canvas window,
             deposits re-weighted by 1/v so the rendered measure is the
             uniform one. Restores signal on deep crops where uniform
             sampling starves; histogram counts are in 1/256 units —
             recorded in checkpoints — and tone mapping is unaffected.
             Composes with --precision extended for deep-zoom windows.
             Deposits are kernel-recorded visit bins scattered fully
             on-device (pallas engine; multi-device and multi-process
             capable).
  --mh-restart <n>: MH uniform-restart mixture weight in 1/256ths
             (default 16 = 1/16 of proposals are global draws).
  --mh-rep-cap <n>: MH tenure batching cap (default 4096).
  --mh-burnin <n>: passes whose MH emissions are discarded as chain
             burn-in (default 1).
  --mh-visit-slots <n>: MH visit-bin reservoir width (power of two in
             [2,32], default 8): tenures with more canvas visits than
             this deposit on a uniform reservoir subsample (full mass;
             a variance knob, not a bias).
  --calibration <file>: machine-constant calibration JSON written by
             tools/calibrate.py; feeds the kernel cost model and the
             hybrid replay-share solver (also honored via the
             CUDABROT_TPU_CALIBRATION env var).
  --hist-sharding <mode>: multi-device histogram layout: replicated
             (default) or rows (row-sharded across the mesh; canvas
             memory and scatter throughput scale with devices).
  --progress <seconds>: log a progress line every N seconds.
  --profile-dir <dir>: capture a torch.profiler trace of the render loop.
  --lane-rows <n> / --steps-per-pass <n> / --steps-per-flush <n> /
  --inner-unroll <n> / --pipeline <n>: engine tuning (analogs of the
             reference's block size/count/samples-per-thread
             constants); all default to band-adaptive auto-tuning.
             Off-TPU (interpret mode) prefer --inner-unroll <= 8: the
             auto-chosen 16-32 windows compile pathologically on the
             XLA CPU backend (TPU compiles are fine).
  --replay-capacity <n>: per-pass emission/replay batch capacity
             (default: auto from the band model; raise it if the
             driver warns about emission-capacity overflow drops).
  --replay-block <n>: lanes per device-replay block (multiple of 128;
             one scatter call per block-chunk pair; default auto 1024).
  --replay-chunk <n>: device-replay steps per scatter call (default
             auto: the band maximum's pow2, capped at 1024; smaller
             chunks cut masked-sentinel scatter waste at short bands
             at the cost of more scatter calls).
"""


class CliError(Exception):
    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


def print_usage(prog: str, out: Callable[[str], None] = print) -> None:
    out(USAGE.format(prog=prog))


def _parse_int(argv: list[str], i: int) -> int:
    """Strict integer parse (ParseIntArg, cudabrot.cu:625-641)."""
    if i + 1 >= len(argv):
        raise CliError(f"Argument {argv[i]} needs a value.")
    raw = argv[i + 1]
    try:
        return int(raw, 10)
    except ValueError:
        raise CliError(
            f"Invalid number given to argument {argv[i]}: {raw}"
        ) from None


def _parse_float(argv: list[str], i: int) -> float:
    """Strict double parse (ParseDoubleArg, cudabrot.cu:644-658)."""
    if i + 1 >= len(argv):
        raise CliError(f"Argument {argv[i]} needs a value.")
    raw = argv[i + 1]
    try:
        return float(raw)
    except ValueError:
        raise CliError(
            f"Invalid number given to argument {argv[i]}: {raw}"
        ) from None


def _parse_str(argv: list[str], i: int, missing_msg: str) -> str:
    if i + 1 >= len(argv):
        raise CliError(missing_msg)
    return argv[i + 1]


@dataclasses.dataclass
class CliExtras:
    save_png: bool = False
    stats_json: str | None = None
    calibration: str | None = None


def parse_args(argv: list[str]) -> tuple[RenderConfig, CliExtras]:
    """Parse reference-compatible argv into a RenderConfig.

    Raises CliError (caller prints usage + exits, mirroring
    cudabrot.cu:750-752) or SystemExit(0) for --help.
    """
    # Defaults from main (cudabrot.cu:763-772) and SetDefaultCanvas
    # (cudabrot.cu:530-543).
    vals = {
        "device_index": 0,
        "output_image": "output.pgm",
        "inprogress_file": None,
        "max_it": 100,
        "min_it": 20,
        "w": 1000,
        "h": 1000,
        "min_real": -2.0,
        "max_real": 2.0,
        "min_imag": -2.0,
        "max_imag": 2.0,
        "gamma": 1.0,
        "seconds": 10.0,
        "fractal": "buddhabrot",
        "seed": 1337,
        "max_passes": None,
        "checkpoint_interval": 0,
        "preview_file": None,
        "progress_interval": 0.0,
        "profile_dir": None,
        "sample_domain": None,
        "center": None,
        "span": None,
    }
    opt = {}
    extras = CliExtras()

    def _validate_canvas() -> None:
        # The reference re-validates after every dimension-affecting flag
        # (RecomputePixelDeltas calls at cudabrot.cu:706-746) so an invalid
        # intermediate state fails fast; Canvas.validate mirrors that.
        try:
            Canvas(
                width=vals["w"],
                height=vals["h"],
                min_real=vals["min_real"],
                max_real=vals["max_real"],
                min_imag=vals["min_imag"],
                max_imag=vals["max_imag"],
            )
        except ConfigError as e:
            raise CliError(str(e)) from None

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--help":
            print_usage(sys.argv[0])
            raise SystemExit(0)
        elif arg == "-d":
            vals["device_index"] = _parse_int(argv, i)
            i += 2
        elif arg == "-o":
            vals["output_image"] = _parse_str(
                argv, i, "Missing output file name."
            )
            i += 2
        elif arg == "-s":
            vals["inprogress_file"] = _parse_str(
                argv, i, "Missing in-progress buffer file name."
            )
            i += 2
        elif arg == "-m":
            vals["max_it"] = _parse_int(argv, i)
            if vals["max_it"] > 60000:
                print(
                    "Warning: Using a high number of iterations may cause "
                    "the program respond slowly to Ctrl+C or time running "
                    "out."
                )
            i += 2
        elif arg == "-c":
            vals["min_it"] = _parse_int(argv, i)
            i += 2
        elif arg == "-w":
            vals["w"] = _parse_int(argv, i)
            _validate_canvas()
            i += 2
        elif arg == "-h":
            vals["h"] = _parse_int(argv, i)
            _validate_canvas()
            i += 2
        elif arg == "-g":
            vals["gamma"] = _parse_float(argv, i)
            i += 2
        elif arg == "-t":
            vals["seconds"] = _parse_float(argv, i)
            i += 2
        elif arg == "--min-real":
            vals["min_real"] = _parse_float(argv, i)
            _validate_canvas()
            i += 2
        elif arg == "--max-real":
            vals["max_real"] = _parse_float(argv, i)
            _validate_canvas()
            i += 2
        elif arg == "--min-imag":
            vals["min_imag"] = _parse_float(argv, i)
            _validate_canvas()
            i += 2
        elif arg == "--max-imag":
            vals["max_imag"] = _parse_float(argv, i)
            _validate_canvas()
            i += 2
        elif arg == "--fractal":
            name = _parse_str(argv, i, "Missing fractal name.")
            from cudabrot_tpu_torch.models.fractals import FRACTALS

            if name not in FRACTALS:
                raise CliError(
                    f"Unknown fractal: {name} (available: "
                    f"{', '.join(sorted(FRACTALS))})"
                )
            vals["fractal"] = name
            i += 2
        elif arg == "--sample-domain":
            raw = _parse_str(argv, i, "Missing sample domain.")
            parts = raw.split(",")
            if len(parts) != 4:
                raise CliError(
                    f"Invalid sample domain (need minr,maxr,mini,maxi): "
                    f"{raw}"
                )
            try:
                vals["sample_domain"] = tuple(float(p) for p in parts)
            except ValueError:
                raise CliError(
                    f"Invalid number given to argument {arg}: {raw}"
                ) from None
            i += 2
        elif arg == "--center":
            raw = _parse_str(argv, i, "Missing center.")
            parts = raw.split(",")
            if len(parts) != 2:
                raise CliError(f"Invalid center (need re,im): {raw}")
            try:
                vals["center"] = tuple(float(p) for p in parts)
            except ValueError:
                raise CliError(
                    f"Invalid number given to argument {arg}: {raw}"
                ) from None
            i += 2
        elif arg == "--span":
            vals["span"] = _parse_float(argv, i)
            if vals["span"] <= 0:
                raise CliError("Span must be positive.")
            i += 2
        elif arg == "--engine":
            opt["engine"] = _parse_str(argv, i, "Missing engine name.")
            i += 2
        elif arg == "--scatter":
            opt["scatter"] = _parse_str(argv, i, "Missing scatter backend.")
            i += 2
        elif arg == "--precision":
            opt["precision"] = _parse_str(argv, i, "Missing precision.")
            i += 2
        elif arg == "--hist-dtype":
            opt["hist_dtype"] = _parse_str(
                argv, i, "Missing histogram dtype."
            )
            i += 2
        elif arg == "--seed":
            vals["seed"] = _parse_int(argv, i)
            i += 2
        elif arg == "--passes":
            vals["max_passes"] = _parse_int(argv, i)
            i += 2
        elif arg == "--checkpoint-interval":
            vals["checkpoint_interval"] = _parse_int(argv, i)
            i += 2
        elif arg == "--preview":
            vals["preview_file"] = _parse_str(
                argv, i, "Missing preview file name."
            )
            i += 2
        elif arg == "--devices":
            raw = _parse_str(argv, i, "Missing device count.")
            if raw == "all":
                opt["num_devices"] = None
            else:
                opt["num_devices"] = _parse_int(argv, i)
            i += 2
        elif arg == "--lane-rows":
            opt["lane_rows"] = _parse_int(argv, i)
            i += 2
        elif arg == "--steps-per-pass":
            opt["steps_per_pass"] = _parse_int(argv, i)
            i += 2
        elif arg == "--steps-per-flush":
            opt["steps_per_flush"] = _parse_int(argv, i)
            i += 2
        elif arg == "--inner-unroll":
            opt["inner_unroll"] = _parse_int(argv, i)
            i += 2
        elif arg == "--replay-capacity":
            # One knob for both engines: the pallas compaction batch and
            # the oracle's replay batch are the same concept.
            cap = _parse_int(argv, i)
            opt["replay_capacity"] = cap
            opt["oracle_replay_capacity"] = cap
            i += 2
        elif arg == "--replay-block":
            opt["replay_block"] = _parse_int(argv, i)
            i += 2
        elif arg == "--replay-chunk":
            opt["replay_chunk"] = _parse_int(argv, i)
            i += 2
        elif arg == "--pipeline":
            opt["pipeline_depth"] = _parse_int(argv, i)
            i += 2
        elif arg == "--replay":
            opt["replay"] = _parse_str(argv, i, "Missing replay mode.")
            i += 2
        elif arg == "--replay-device-share":
            opt["replay_device_share"] = _parse_float(argv, i)
            i += 2
        elif arg == "--replay-threads":
            opt["replay_threads"] = _parse_int(argv, i)
            i += 2
        elif arg == "--refill-rng":
            opt["refill_rng"] = _parse_str(argv, i, "Missing refill rng.")
            i += 2
        elif arg == "--emit-filter":
            opt["emit_filter"] = _parse_str(argv, i, "Missing emit filter.")
            i += 2
        elif arg == "--sampler":
            opt["sampler"] = _parse_str(argv, i, "Missing sampler mode.")
            i += 2
        elif arg == "--mh-restart":
            opt["mh_restart"] = _parse_int(argv, i)
            i += 2
        elif arg == "--mh-rep-cap":
            opt["mh_rep_cap"] = _parse_int(argv, i)
            i += 2
        elif arg == "--mh-burnin":
            opt["mh_burnin_passes"] = _parse_int(argv, i)
            i += 2
        elif arg == "--mh-visit-slots":
            opt["mh_visit_slots"] = _parse_int(argv, i)
            i += 2
        elif arg == "--calibration":
            extras.calibration = _parse_str(
                argv, i, "Missing calibration file name."
            )
            i += 2
        elif arg == "--hist-sharding":
            opt["histogram_sharding"] = _parse_str(
                argv, i, "Missing sharding mode."
            )
            i += 2
        elif arg == "--progress":
            vals["progress_interval"] = _parse_float(argv, i)
            i += 2
        elif arg == "--profile-dir":
            vals["profile_dir"] = _parse_str(
                argv, i, "Missing profile directory."
            )
            i += 2
        elif arg == "--png":
            extras.save_png = True
            i += 1
        elif arg == "--stats-json":
            extras.stats_json = _parse_str(argv, i, "Missing stats file name.")
            i += 2
        else:
            raise CliError(f"Invalid argument: {arg}")

    if (vals["center"] is None) != (vals["span"] is None):
        raise CliError("--center and --span must be given together.")
    if vals["center"] is not None:
        # Zoom shorthand: one window centered at --center with real
        # extent --span (imag extent scaled by the pixel aspect) becomes
        # BOTH the canvas bounds and the sample domain — the deep-zoom
        # configuration the long-flag spelling needs 8 coordinated
        # values for. Explicit bound/domain flags are overridden.
        cx, cy = vals["center"]
        half_r = vals["span"] / 2.0
        half_i = half_r * vals["h"] / vals["w"]
        vals["min_real"], vals["max_real"] = cx - half_r, cx + half_r
        vals["min_imag"], vals["max_imag"] = cy - half_i, cy + half_i
        if opt.get("sampler") == "mh":
            # MH renders the window but SEEDS contributors from around
            # it (orbits passing through the canvas mostly start
            # outside it — finding them is what the chains are for), so
            # a domain == canvas would cripple the sampler. 8x the
            # window (clamped to the reference domain) keeps the
            # out-of-window contributors reachable while the 2^24
            # sample grid stays ~1000x finer than the canvas pixels —
            # the measured bench geometry (benchmarks/PERF_NOTES.md).
            vals["sample_domain"] = (
                max(cx - 8 * half_r, -2.0), min(cx + 8 * half_r, 2.0),
                max(cy - 8 * half_i, -2.0), min(cy + 8 * half_i, 2.0),
            )
        else:
            vals["sample_domain"] = (
                cx - half_r, cx + half_r, cy - half_i, cy + half_i
            )
    try:
        from cudabrot_tpu_torch.config import SAMPLE_DOMAIN

        cfg = RenderConfig(
            sample_domain=(
                vals["sample_domain"]
                if vals["sample_domain"] is not None
                else SAMPLE_DOMAIN
            ),
            canvas=Canvas(
                width=vals["w"],
                height=vals["h"],
                min_real=vals["min_real"],
                max_real=vals["max_real"],
                min_imag=vals["min_imag"],
                max_imag=vals["max_imag"],
            ),
            band=IterationBand(
                max_escape_iterations=vals["max_it"],
                min_escape_iterations=vals["min_it"],
            ),
            fractal=vals["fractal"],
            gamma=vals["gamma"],
            seconds_to_run=vals["seconds"],
            max_passes=vals["max_passes"],
            seed=vals["seed"],
            output_image=vals["output_image"],
            inprogress_file=vals["inprogress_file"],
            checkpoint_interval=vals["checkpoint_interval"],
            preview_file=vals["preview_file"],
            device_index=vals["device_index"],
            progress_interval=vals["progress_interval"],
            profile_dir=vals["profile_dir"],
            options=EngineOptions(**opt),
        )
    except ConfigError as e:
        raise CliError(str(e)) from None
    return cfg, extras


def run(cfg: RenderConfig, extras: CliExtras, log=print, device=None) -> int:
    """Render + tone-map + save (the main() sequence, cudabrot.cu:762-791).

    Runs on ``cuda:<cfg.device_index>`` unless ``device`` is given."""
    from cudabrot_tpu_torch import driver
    from cudabrot_tpu_torch.engines import make_engine
    from cudabrot_tpu_torch.io import checkpoint as _ckpt
    from cudabrot_tpu_torch.io import pgm as pgm_io
    from cudabrot_tpu_torch.ops import tonemap as tonemap_op
    from cudabrot_tpu_torch.utils.device import DeviceError

    if extras.calibration:
        log(
            "--calibration is not yet ported to cudabrot_tpu_torch (its "
            "tuning has no measured cost constants)."
        )
        return 1
    log(
        f"Creating {cfg.canvas.width}x{cfg.canvas.height} image, "
        f"{cfg.band.max_escape_iterations} max iterations."
    )
    log("Calculating image...")
    try:
        engine = make_engine(cfg, device=device)
        result = driver.run_render(cfg, engine=engine, log=log)
    except (_ckpt.CheckpointError, ConfigError, DeviceError) as e:
        # Fatal like the reference's size check (cudabrot.cu:239-245), but
        # with a clean message instead of a traceback.
        log(str(e))
        return 1

    mapped = tonemap_op.tonemap(result.histogram, cfg.gamma)
    log(f"Max value: {mapped.max_count}, scale: {mapped.linear_scale:f}")

    if extras.stats_json:
        # Written before the image encode, so a failed save cannot lose
        # the measurement record.
        payload = {
            "passes": result.passes,
            "elapsed_seconds": result.elapsed_seconds,
            "engine": result.engine_name,
            "device": str(engine.device),
            "interrupted": result.interrupted,
            "max_count": mapped.max_count,
            **result.stats,
        }
        with open(extras.stats_json, "w") as f:
            json.dump(payload, f, indent=2)

    log("Saving image.")
    # Image-save failures are non-fatal, like the reference's SaveImage
    # (cudabrot.cu:553-556): the checkpoint (if any) is already on disk.
    image_saved = True
    try:
        pgm_io.write_pgm(cfg.output_image, mapped.image)
    except OSError as e:
        log(f"Failed saving image {cfg.output_image}: {e}")
        image_saved = False
    if extras.save_png:
        from cudabrot_tpu_torch.io import png as png_io

        png_path = cfg.output_image.rsplit(".", 1)[0] + ".png"
        try:
            png_io.write_png(png_path, mapped.image)
        except OSError as e:
            log(f"Failed saving image {png_path}: {e}")
    if image_saved:
        log(f"Done! Output image saved: {cfg.output_image}")
    return 0


def main(argv: list[str] | None = None, device=None) -> int:
    """CLI entry point. ``device``: None renders on ``cuda:<-d>``; pass
    ``"cpu"`` to run the kernels' plain PyTorch versions."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "render-color":
        print("render-color is not yet ported to cudabrot_tpu_torch.")
        return 1
    try:
        cfg, extras = parse_args(argv)
    except CliError as e:
        print(e.message)
        print_usage(sys.argv[0])
        return 0  # parity: the reference exits 0 from PrintUsage
    return run(cfg, extras, device=device)


if __name__ == "__main__":
    raise SystemExit(main())
