"""Command-line interface, argument-compatible with the reference binary
(the port of tpuflow/cli.py).

Usage modes (reference: src/main.cpp:99-125):
  1. ``python -m tpuflow_torch.cli``                  -> ./settings.xml
  2. ``python -m tpuflow_torch.cli <settings.xml>``   -> the given settings file
  3. ``python -m tpuflow_torch.cli <f1> <f2> <w> <h> [counter] <outdir> [alpha sigma]``

Flags: ``--constancy {grey,gradient,log}``, ``--device {cuda,cpu}``
(default ``cuda``, which raises on a machine without CUDA and never falls
back to the CPU) and ``--quiet``. ``--sequence`` (with ``--size`` and
``--out``), ``--chain`` and ``--warp-report`` are not ported yet; they
exit with a message saying so.

Outputs per pair (reference: src/main.cpp:205-213):
  ``<out>/<counter>flow-u-<w>-<h>.raw``  float32 RAW u
  ``<out>/<counter>flow-v-<w>-<h>.raw``  float32 RAW v
  ``<out>/<counter>res.pgm``             P6 PPM colour-circle visualisation
  ``<out>/<counter>amp-<w>-<h>.raw``     float32 RAW magnitude

Frames are read as u8 or f32 by file size, and the output directory is
always the argument after width/height/counter, as in tpuflow's CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from tpuflow_torch.config import DataConstancy, FlowConfig, IOConfig, load_settings_xml

USAGE = ("usage: tpuflow_torch <file1> <file2> <width> <height> [counter] "
         "<outdir> [alpha sigma]  |  tpuflow_torch [settings.xml]")
# Flags of tpuflow's CLI that belong to later slices of the port.
UNPORTED = ("sequence", "size", "out", "chain", "warp_report")


def _positional_mode(argv) -> tuple[FlowConfig, IOConfig]:
    """<f1> <f2> <w> <h> [counter] <outdir> [alpha sigma]"""
    if len(argv) not in (5, 6, 8):
        raise SystemExit(USAGE)
    width, height = int(argv[2]), int(argv[3])
    counter = ""
    rest = argv[4:]
    if len(rest) in (2, 4):  # counter present
        counter, outdir, sweep = rest[0], rest[1], rest[2:]
    else:
        outdir, sweep = rest[0], rest[1:]
    cfg = FlowConfig()
    if sweep:
        cfg = dataclasses.replace(cfg, equation_alpha=float(sweep[0]),
                                  gaussian_sigma=float(sweep[1]))
        # Parameter-sweep runs embed alpha/sigma in the output names
        # (reference: src/main.cpp:119-124).
        counter = f"alpha{sweep[0]}_sigma{sweep[1]}_"
    io = IOConfig(width=width, height=height, input_path="", output_path=outdir,
                  file_name1=argv[0], file_name2=argv[1], counter=counter)
    return cfg, io


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--constancy", choices=[c.value for c in DataConstancy])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda runs the CUDA kernels (and raises without CUDA); "
                             "cpu runs their plain PyTorch versions")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--help", action="help")
    for name in UNPORTED:
        parser.add_argument("--" + name.replace("_", "-"), nargs="?", const=True,
                            help=argparse.SUPPRESS)
    flags, positional = parser.parse_known_args(argv)

    given = ["--" + n.replace("_", "-") for n in UNPORTED if getattr(flags, n) is not None]
    if given:
        raise SystemExit(f"{', '.join(given)}: not ported yet to tpuflow_torch "
                         "(use tpuflow.cli for sequences, chains and the warp report)")

    if len(positional) >= 4:
        cfg, io = _positional_mode(positional)
    elif len(positional) >= 2:
        # 2-3 bare args: an incomplete positional invocation, not a settings file.
        raise SystemExit(USAGE)
    else:
        settings = positional[0] if positional else "settings.xml"
        if not os.path.exists(settings):
            raise SystemExit(f"settings file not found: {settings}")
        cfg, io = load_settings_xml(settings)

    if flags.constancy:
        cfg = dataclasses.replace(cfg, data_constancy=DataConstancy(flags.constancy))

    from tpuflow_torch.io import (
        read_frame, write_flow_image_rgb, write_magnitude_f32, write_raw_f32,
    )
    from tpuflow_torch.solver.flow2d import compute_flow

    os.makedirs(io.output_path or ".", exist_ok=True)
    frame_0 = read_frame(os.path.join(io.input_path, io.file_name1), io.width, io.height)
    frame_1 = read_frame(os.path.join(io.input_path, io.file_name2), io.width, io.height)

    if not flags.quiet:
        print(f"tpuflow_torch: {io.width}x{io.height} on {flags.device}, "
              f"{cfg.data_constancy.value} constancy, levels<={cfg.warp_levels_count}, "
              f"{cfg.outer_iterations_count}x{cfg.inner_iterations_count} iterations")
    t0 = time.perf_counter()
    result = compute_flow(frame_0, frame_1, cfg, device=flags.device)
    if not flags.quiet:
        print(f"computed in {time.perf_counter() - t0:.3f}s "
              f"({result.megapixels_per_second:.2f} Mpix/s)")

    suffix = f"-{io.width}-{io.height}.raw"
    out, c = io.output_path, io.counter
    write_raw_f32(os.path.join(out, f"{c}flow-u{suffix}"), result.u)
    write_raw_f32(os.path.join(out, f"{c}flow-v{suffix}"), result.v)
    write_flow_image_rgb(result.u, result.v, 10, os.path.join(out, f"{c}res.pgm"))
    write_magnitude_f32(result.u, result.v, os.path.join(out, f"{c}amp{suffix}"))
    if not flags.quiet:
        print(f"wrote {c}flow-u{suffix}, {c}flow-v{suffix}, {c}res.pgm, "
              f"{c}amp{suffix} to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
