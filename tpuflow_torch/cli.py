"""Command-line interface, argument-compatible with the reference binary
(the port of tpuflow/cli.py).

Usage modes (reference: src/main.cpp:99-125):
  1. ``python -m tpuflow_torch.cli``                  -> ./settings.xml
  2. ``python -m tpuflow_torch.cli <settings.xml>``   -> the given settings file
  3. ``python -m tpuflow_torch.cli <f1> <f2> <w> <h> [counter] <outdir> [alpha sigma]``
  4. ``python -m tpuflow_torch.cli --sequence GLOB --size WxH --out DIR [--chain N]``
     -> consecutive pairs of the sorted frames, streamed and resumable
     (``parallel.multihost.process_sequence``)

Flags: ``--constancy {grey,gradient,log}``, ``--device {cuda,cpu}``
(default ``cuda``, which raises on a machine without CUDA and never falls
back to the CPU), ``--warp-report`` (one pair: also print the levels whose
motion went beyond the ±4 and ±8 px classes) and ``--quiet``.

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
         "<outdir> [alpha sigma]  |  tpuflow_torch [settings.xml]  |  "
         "tpuflow_torch --sequence GLOB --size WxH --out DIR [--chain N]")


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


def _sequence_mode(flags) -> int:
    """Streaming mode: consecutive pairs over a sorted frame glob."""
    import glob

    from tpuflow_torch.parallel.multihost import process_sequence

    if not flags.size or not flags.out:
        raise SystemExit("--sequence requires --size WxH and --out DIR")
    w, h = (int(x) for x in flags.size.lower().split("x"))
    frames = sorted(glob.glob(flags.sequence))
    if len(frames) < 2:
        raise SystemExit(f"--sequence matched {len(frames)} files; need >= 2")
    cfg = FlowConfig()
    if flags.constancy:
        cfg = dataclasses.replace(cfg, data_constancy=DataConstancy(flags.constancy))
    completed = process_sequence(list(zip(frames[:-1], frames[1:])), w, h, flags.out, cfg,
                                 chain=flags.chain or 1, device=flags.device)
    if not flags.quiet:
        print(f"processed {len(completed)} pairs -> {flags.out}")
    return 0


def _warp_report_line(report) -> str:
    """The one line of ``--warp-report``: the levels whose prolongated flow
    moved beyond ±4 px (tier 1) or ±8 px (tier 2)."""
    moved = [(w, h, int(t)) for (w, h), t in zip(report["levels"], report["tiers"]) if t > 0]
    if not moved:
        return "warp-report: every level within the ±4 px displacement class"
    return (f"warp-report: {report['n_wide']} level(s) beyond ±4 px, {report['n_gather']} "
            "beyond ±8 px: " + ", ".join(f"{w}x{h}@tier{t}" for w, h, t in moved))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--constancy", choices=[c.value for c in DataConstancy])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda runs the CUDA kernels (and raises without CUDA); "
                             "cpu runs their plain PyTorch versions")
    parser.add_argument("--sequence", metavar="GLOB",
                        help="process consecutive pairs of all frames matching a glob "
                             "(streaming, resumable via the manifest)")
    parser.add_argument("--size", metavar="WxH", help="frame size for --sequence")
    parser.add_argument("--out", metavar="DIR", help="output directory for --sequence")
    parser.add_argument("--chain", type=int, metavar="N",
                        help="--sequence: submit N pairs back to back and fetch their "
                             "flows in one copy")
    parser.add_argument("--warp-report", action="store_true",
                        help="one pair: also print the levels whose motion went beyond "
                             "the +-4 and +-8 px displacement classes")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--help", action="help")
    flags, positional = parser.parse_known_args(argv)

    if flags.sequence:
        if flags.warp_report:
            raise SystemExit("--warp-report reports one pair; it does not apply to --sequence")
        return _sequence_mode(flags)
    if flags.chain is not None:
        raise SystemExit("--chain applies to --sequence only")

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

    from tpuflow_torch.io import read_frame
    from tpuflow_torch.parallel.multihost import write_pair
    from tpuflow_torch.solver.flow2d import (
        FlowResult, compute_flow, compute_flow_warp_report,
    )

    os.makedirs(io.output_path or ".", exist_ok=True)
    frame_0 = read_frame(os.path.join(io.input_path, io.file_name1), io.width, io.height)
    frame_1 = read_frame(os.path.join(io.input_path, io.file_name2), io.width, io.height)

    if not flags.quiet:
        print(f"tpuflow_torch: {io.width}x{io.height} on {flags.device}, "
              f"{cfg.data_constancy.value} constancy, levels<={cfg.warp_levels_count}, "
              f"{cfg.outer_iterations_count}x{cfg.inner_iterations_count} iterations")
    t0 = time.perf_counter()
    if flags.warp_report:
        # the same flow, bit for bit, with each level's displacement class
        u, v, report = compute_flow_warp_report(frame_0, frame_1, cfg, device=flags.device)
        result = FlowResult(u=u, v=v, seconds=time.perf_counter() - t0)
    else:
        result = compute_flow(frame_0, frame_1, cfg, device=flags.device)
    if not flags.quiet:
        print(f"computed in {time.perf_counter() - t0:.3f}s "
              f"({result.megapixels_per_second:.2f} Mpix/s)")
    if flags.warp_report:
        print(_warp_report_line(report))

    suffix = f"-{io.width}-{io.height}.raw"
    out, c = io.output_path, io.counter
    write_pair(out, c, result.u, result.v, io.width, io.height)
    if not flags.quiet:
        print(f"wrote {c}flow-u{suffix}, {c}flow-v{suffix}, {c}res.pgm, "
              f"{c}amp{suffix} to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
