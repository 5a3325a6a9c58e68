"""Multi-band color composition — the in-process replacement for the
reference's out-of-process pipeline.

The reference renders N grayscale iteration bands and shells out to
ImageMagick `convert -normalize` plus the external `image_combiner` /
`image_combiner_hsl` binaries (generate_hires_color_image.sh:27-71,
README.md:170-185). Everything here is in-repo and vectorized numpy:

  * `normalize` — contrast stretch approximating ImageMagick `-normalize`
    (which is documented as `-contrast-stretch 2%x1%`: clip the darkest 2%
    and brightest 1% of pixels, then stretch to full range);
  * `combine_rgb` — image_combiner semantics: each grayscale layer scales a
    named color, layers sum, channels clamp (README.md:177-184);
  * `combine_hsl` — image_combiner_hsl semantics: three grayscale layers
    feed the H, S, and L channels with an additive hue rotation
    (generate_hires_color_image.sh:66-71);
  * `render-color` CLI — runs the banded renders and the combine in one
    process (the bands default to the README's RGB recipe and can be
    overridden).

Port of ``cudabrot_tpu/color.py``: the numpy combine functions, the band
recipes and the parser are copies (the same bytes out); the bands render
through this package's engines and driver, on ``cuda:<-d>`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from cudabrot_tpu_torch.io import pgm as pgm_io
from cudabrot_tpu_torch.io import png as png_io

#: Named colors understood by combine_rgb, matching image_combiner's common
#: usage in README.md:180-184 (HTML color names, unit RGB).
COLORS = {
    "red": (1.0, 0.0, 0.0),
    "lime": (0.0, 1.0, 0.0),
    "green": (0.0, 0.5, 0.0),
    "blue": (0.0, 0.0, 1.0),
    "white": (1.0, 1.0, 1.0),
    "cyan": (0.0, 1.0, 1.0),
    "magenta": (1.0, 0.0, 1.0),
    "yellow": (1.0, 1.0, 0.0),
    "orange": (1.0, 0.647, 0.0),
    "purple": (0.5, 0.0, 0.5),
}


def _to_unit(img: np.ndarray) -> np.ndarray:
    """Grayscale image (uint8/uint16/float) -> float in [0, 1]."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return np.clip(img.astype(np.float32), 0.0, 1.0)


def normalize(img: np.ndarray, black_clip: float = 0.02,
              white_clip: float = 0.01) -> np.ndarray:
    """Contrast-stretch: the ImageMagick `-normalize` equivalent used at
    generate_hires_color_image.sh:35."""
    unit = _to_unit(img)
    lo = np.quantile(unit, black_clip)
    hi = np.quantile(unit, 1.0 - white_clip)
    if hi <= lo:
        return np.zeros_like(unit)
    return np.clip((unit - lo) / (hi - lo), 0.0, 1.0)


def combine_rgb(layers: list[tuple[np.ndarray, str]]) -> np.ndarray:
    """Sum color-scaled grayscale layers, clamped (image_combiner
    semantics). Returns float RGB in [0,1]."""
    out = None
    for img, color_name in layers:
        try:
            color = COLORS[color_name]
        except KeyError:
            raise ValueError(
                f"Unknown color {color_name!r}; available: {sorted(COLORS)}"
            ) from None
        unit = _to_unit(img)[..., None] * np.asarray(color, np.float32)
        out = unit if out is None else out + unit
    if out is None:
        raise ValueError("combine_rgb needs at least one layer")
    return np.clip(out, 0.0, 1.0)


def hsl_to_rgb(h: np.ndarray, s: np.ndarray, l: np.ndarray) -> np.ndarray:
    """Vectorized HSL -> RGB (all unit-range arrays)."""
    c = (1.0 - np.abs(2.0 * l - 1.0)) * s
    hp = (h % 1.0) * 6.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    zeros = np.zeros_like(c)
    sector = np.floor(hp).astype(np.int32) % 6
    r = np.choose(sector, [c, x, zeros, zeros, x, c])
    g = np.choose(sector, [x, c, c, x, zeros, zeros])
    b = np.choose(sector, [zeros, zeros, x, c, c, x])
    m = l - c / 2.0
    return np.clip(np.stack([r + m, g + m, b + m], axis=-1), 0.0, 1.0)


def combine_hsl(
    h_img: np.ndarray,
    s_img: np.ndarray,
    l_img: np.ndarray,
    adjust_hue: float = 0.0,
) -> np.ndarray:
    """image_combiner_hsl semantics (generate_hires_color_image.sh:66-71):
    grayscale layers drive hue/saturation/lightness; adjust_hue rotates the
    hue wheel additively. Returns float RGB in [0,1]."""
    h = (_to_unit(h_img) + adjust_hue) % 1.0
    return hsl_to_rgb(h, _to_unit(s_img), _to_unit(l_img))


def save_rgb(path: str, rgb_unit: np.ndarray) -> None:
    """Write unit-range float RGB as 8-bit PNG (or 16-bit if .png16)."""
    if path.endswith(".png16"):
        png_io.write_png(
            path[: -len("16")],
            np.round(rgb_unit * 65535.0).astype(np.uint16),
        )
    else:
        png_io.write_png(path, np.round(rgb_unit * 255.0).astype(np.uint8))


@dataclasses.dataclass(frozen=True)
class BandSpec:
    """One banded render of the color recipe."""

    max_it: int
    min_it: int
    gamma: float
    seconds: float
    passes: int | None = None


#: Default three-band RGB recipe from README.md:177-184.
DEFAULT_RGB_BANDS = {
    "blue": BandSpec(max_it=100, min_it=20, gamma=2.0, seconds=20.0),
    "lime": BandSpec(max_it=2000, min_it=600, gamma=2.0, seconds=20.0),
    "red": BandSpec(max_it=10000, min_it=9000, gamma=2.5, seconds=40.0),
}

#: Default HSL recipe bands from generate_hires_color_image.sh:27-59 (time
#: budgets scaled down from the production 12h/4h/2h by default).
DEFAULT_HSL_BANDS = {
    "H": BandSpec(max_it=8000, min_it=1000, gamma=-1.0, seconds=40.0),
    "S": BandSpec(max_it=500, min_it=20, gamma=-1.0, seconds=20.0),
    "L": BandSpec(max_it=60000, min_it=45000, gamma=-1.0, seconds=120.0),
}


def render_bands_interleaved(cfgs: dict, log=print, device=None) -> dict:
    """Render all bands concurrently by round-robin pass dispatch.

    The bands are independent renders (own engine, own sample stream, own
    histogram), so their passes can interleave freely on one card: the
    passes of the three engines queue on one device, each synchronizing
    every ``driver.resolve_pipeline_depth`` passes. Per-band histograms
    are bitwise identical to sequential runs of the same pass counts
    (engines never share state, and integer adds commute); with time
    boxes, budgets overlap instead of adding.

    ``cfgs`` maps band key -> RenderConfig (seconds_to_run / max_passes
    taken from each config). Returns band key -> driver.RenderResult
    (``elapsed_seconds``: the interleaved loop's wall time, shared by
    every band)."""
    from cudabrot_tpu_torch import driver, engines

    slots = {}
    for key, cfg in cfgs.items():
        engine = engines.make_engine(cfg, device=device)
        state = engine.init_state(None)
        engine.warmup(state)
        slots[key] = {"engine": engine, "state": state, "passes": 0,
                      "cfg": cfg, "depth": driver.resolve_pipeline_depth(cfg)}

    start = time.monotonic()
    active = list(slots)
    with driver.SigintFlag(log) as flag:
        while active:
            if flag.triggered:
                break
            elapsed = time.monotonic() - start
            for key in list(active):
                s = slots[key]
                cfg = s["cfg"]
                done = (
                    cfg.max_passes is not None
                    and s["passes"] >= cfg.max_passes
                )
                if (
                    s["passes"] > 0
                    and cfg.seconds_to_run >= 0
                    and elapsed > cfg.seconds_to_run
                ):
                    done = True
                if done:
                    active.remove(key)
                    continue
                s["state"] = s["engine"].run_pass(s["state"], s["passes"])
                s["passes"] += 1
                if s["passes"] % s["depth"] == 0:
                    s["engine"].synchronize()
        interrupted = flag.triggered

    for s in slots.values():
        s["engine"].synchronize()
    elapsed = time.monotonic() - start
    out = {}
    for key, s in slots.items():
        engine, state = s["engine"], s["state"]
        out[key] = driver.RenderResult(
            histogram=engine.histogram(state), passes=s["passes"],
            elapsed_seconds=elapsed, stats=engine.stats(state),
            engine_name=engine.name, interrupted=interrupted)
        log(f"  band {key!r}: {s['passes']} passes")
    return out


def render_bands(cfgs: dict, interleave: bool, log=print,
                 device=None) -> dict:
    """Band key -> driver.RenderResult of each band's render: interleaved
    (``render_bands_interleaved``), or one ``driver.run_render`` after
    another."""
    from cudabrot_tpu_torch import driver

    if interleave:
        log(
            f"Streaming {len(cfgs)} bands concurrently: "
            + ", ".join(
                f"{k}(m={c.band.max_escape_iterations},"
                f"c={c.band.min_escape_iterations})"
                for k, c in cfgs.items()
            )
        )
        return render_bands_interleaved(cfgs, log=log, device=device)
    results = {}
    for key, cfg in cfgs.items():
        log(f"Rendering band {key!r}: m={cfg.band.max_escape_iterations} "
            f"c={cfg.band.min_escape_iterations}")
        results[key] = driver.run_render(cfg, log=log, device=device)
    return results


COLOR_USAGE = """Usage: {prog} render-color [options]

Renders multiple iteration bands and combines them into one color image,
replacing the reference's generate_hires_color_image.sh + external
image_combiner tools with an in-process pipeline.

Options:
  --mode <rgb|hsl>: combination mode. Default rgb (README.md recipe);
        hsl follows generate_hires_color_image.sh.
  -o <output>: output PNG file name. Default color_output.png.
  -w/-h, --min-real/--max-real/--min-imag/--max-imag, --center/--span:
        canvas (and zoom-shorthand window), as in the
        main command.
  --band <key:max:min:gamma:seconds>: override one band. Keys are
        blue/lime/red (rgb) or H/S/L (hsl). Repeatable.
  --passes <n>: render each band for a fixed pass count instead of a
        time box (deterministic).
  --adjust-hue <x>: hue rotation for hsl mode. Default 0.3
        (generate_hires_color_image.sh:70).
  --normalize: apply the ImageMagick-style contrast stretch to each band
        before combining (generate_hires_color_image.sh:35).
  --interleave: stream all bands concurrently (round-robin pass
        dispatch), so time budgets overlap (wall = max, not sum).
        Per-band output is bitwise identical to sequential --passes runs.
  -d/--engine/--scatter/--seed/--devices/--hist-sharding/--precision/
  --sample-domain/--fractal/--refill-rng/--replay-capacity/--sampler/
  --mh-restart/--mh-rep-cap/--mh-burnin/--replay/--replay-threads/
  --emit-filter/--lane-rows/--steps-per-pass/--steps-per-flush/
  --inner-unroll:
        forwarded to the renderer (e.g. --precision extended +
        --sample-domain for color deep zooms, or --sampler mh for
        importance-sampled color crops). The bands render on CUDA
        device -d (default 0), or on --devices cards from it. Forwarded values the main command
        refuses (--replay host with --hist-sharding rows, --devices
        beyond the cards present, the TPU's --engine pallas and
        --refill-rng hardware) fail with its message.
  --keep-bands: also save each band's grayscale PGM.
"""


def main(argv: list[str], device=None) -> int:
    """The render-color command. ``device``: None renders every band on
    ``cuda:<-d>``; pass ``"cpu"`` to run the kernels' plain PyTorch
    versions."""
    from cudabrot_tpu_torch import cli as main_cli

    mode = "rgb"
    out_path = "color_output.png"
    canvas_args: list[str] = []
    engine_args: list[str] = []
    band_overrides: dict[str, BandSpec] = {}
    adjust_hue = 0.3
    do_normalize = False
    keep_bands = False
    interleave = False
    passes: int | None = None

    i = 0
    while i < len(argv):
        arg = argv[i]

        def _val(msg: str) -> str:
            if i + 1 >= len(argv):
                raise main_cli.CliError(msg)
            return argv[i + 1]

        if arg == "--help":
            print(COLOR_USAGE.format(prog=sys.argv[0]))
            return 0
        elif arg == "--mode":
            mode = _val("Missing mode.")
            i += 2
        elif arg == "-o":
            out_path = _val("Missing output file name.")
            i += 2
        elif arg in ("-w", "-h", "--min-real", "--max-real", "--min-imag",
                     "--max-imag", "--center", "--span"):
            canvas_args += [arg, _val(f"Argument {arg} needs a value.")]
            i += 2
        elif arg in ("-d", "--engine", "--scatter", "--seed", "--devices",
                     "--hist-sharding", "--precision", "--sample-domain", "--fractal",
                     "--refill-rng", "--replay-capacity", "--sampler",
                     "--mh-restart", "--mh-rep-cap", "--mh-burnin",
                     "--replay", "--replay-threads", "--emit-filter",
                     "--lane-rows", "--steps-per-pass",
                     "--steps-per-flush", "--inner-unroll"):
            engine_args += [arg, _val(f"Argument {arg} needs a value.")]
            i += 2
        elif arg == "--band":
            spec = _val("Missing band spec.")
            try:
                key, max_it, min_it, gamma, seconds = spec.split(":")
                band_overrides[key] = BandSpec(
                    max_it=int(max_it),
                    min_it=int(min_it),
                    gamma=float(gamma),
                    seconds=float(seconds),
                )
            except ValueError:
                print(f"Invalid band spec: {spec}")
                return 1
            i += 2
        elif arg == "--passes":
            passes = int(_val("Missing pass count."))
            i += 2
        elif arg == "--adjust-hue":
            adjust_hue = float(_val("Missing hue adjustment."))
            i += 2
        elif arg == "--normalize":
            do_normalize = True
            i += 1
        elif arg == "--interleave":
            interleave = True
            i += 1
        elif arg == "--keep-bands":
            keep_bands = True
            i += 1
        else:
            print(f"Invalid argument: {arg}")
            print(COLOR_USAGE.format(prog=sys.argv[0]))
            return 0

    if mode == "rgb":
        bands = dict(DEFAULT_RGB_BANDS)
    elif mode == "hsl":
        bands = dict(DEFAULT_HSL_BANDS)
    else:
        print(f"Unknown mode: {mode}")
        return 1
    unknown = set(band_overrides) - set(bands)
    if unknown:
        print(f"Unknown band keys for mode {mode}: {sorted(unknown)}")
        return 1
    bands.update(band_overrides)

    from cudabrot_tpu_torch.config import ConfigError
    from cudabrot_tpu_torch.io.checkpoint import CheckpointError
    from cudabrot_tpu_torch.io.native import NativeError
    from cudabrot_tpu_torch.ops import tonemap as tonemap_op
    from cudabrot_tpu_torch.utils.device import DeviceError

    def band_cfg(spec: BandSpec):
        band_argv = canvas_args + engine_args + [
            "-m", str(spec.max_it),
            "-c", str(spec.min_it),
            "-t", str(spec.seconds),
        ]
        if passes is not None:
            band_argv += ["--passes", str(passes)]
        cfg, _ = main_cli.parse_args(band_argv)
        return cfg

    try:
        cfgs = {key: band_cfg(spec) for key, spec in bands.items()}
        results = render_bands(cfgs, interleave, device=device)
    except main_cli.CliError as e:
        print(e.message)
        return 1
    except (CheckpointError, ConfigError, DeviceError, NativeError) as e:
        print(str(e))
        return 1

    layers: dict[str, np.ndarray] = {}
    for key, spec in bands.items():
        img = tonemap_op.tonemap(results[key].histogram, spec.gamma).image
        if do_normalize:
            layers[key] = normalize(img)
        else:
            layers[key] = img
        if keep_bands:
            pgm_io.write_pgm(f"band_{key}.pgm", img)

    if mode == "rgb":
        rgb = combine_rgb([(layers[k], k) for k in bands])
    else:
        rgb = combine_hsl(layers["H"], layers["S"], layers["L"],
                          adjust_hue=adjust_hue)
    save_rgb(out_path, rgb)
    print(f"Done! Color image saved: {out_path}")
    return 0
