"""npge_tpu_torch CLI — the default pangenome build on an explicit device.

    python -m npge_tpu_torch.cli prepare --fasta a.fa b.fa [--genomes G.tsv] -w WORK
    python -m npge_tpu_torch.cli make-pangenome -w WORK [--device cuda|cpu]
        [-o KEY=VALUE ...] [--timing]

``prepare`` is the reference's own (host-only) verb. ``make-pangenome``
builds on ``--device`` (default ``cuda``) and exits non-zero when that
device is unavailable; it writes ``pangenome.bs`` and ``pangenome.json``
like the reference and runs the (non-deep) IsPangenome check.
"""

from __future__ import annotations

import argparse
import sys

from npge_tpu.cli import _load_cfg, cmd_prepare
from npge_tpu.model.hashing import blockset_hash


# mirrors npge_tpu/cli.py:cmd_make_pangenome
def cmd_make_pangenome(args) -> None:
    from npge_tpu.algo.is_pangenome import check_is_pangenome
    from npge_tpu.algo.reports import json_line
    from npge_tpu.io.checkpoint import load_stage, save_stage
    from npge_tpu_torch.algo.pangenome import build_pangenome
    from npge_tpu_torch.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"make-pangenome: {e}")
    cfg = _load_cfg(args)
    src = load_stage(args.workdir, "input")
    if src is None:
        raise SystemExit(f"no input.bs under {args.workdir}; run prepare first")
    bs, timings = build_pangenome(src.arena, cfg, dev, verbose=args.verbose)
    rep = check_is_pangenome(bs, cfg)
    extra = {}
    if timings.counters.get("deep.proven_at_kmin"):
        # the build's exit proved the deep re-seed probe at k=MIN_ANCHOR_SIZE
        # non-improving for this blockset; recorded as the reference does
        extra["deep_probe"] = {
            "blockset_hash": f"{blockset_hash(bs):016x}",
            "k": cfg.MIN_ANCHOR_SIZE,
            "cfg": cfg.to_json(),
            "ok": True,
        }
    save_stage(
        args.workdir, "pangenome", bs,
        is_pangenome=rep.ok, messages=rep.messages,
        timings=timings.seconds,
        **extra,
    )
    print(json_line("pangenome", bs, is_pangenome=rep.ok))
    if args.timing:
        print(timings.report(), file=sys.stderr)
    if not rep.ok:
        print("WARNING: IsPangenome checks failed:", rep.messages, file=sys.stderr)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="npge-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("prepare", help="ingest FASTA genomes (GetData+Prepare)")
    sp.add_argument("-w", "--workdir", default="npge-work")
    sp.add_argument("--fasta", nargs="+")
    sp.add_argument("--genomes", help="genomes.tsv accession renaming table")
    sp.add_argument("--data-dir", help="directory with <accession>.fa files")
    sp.set_defaults(fn=cmd_prepare, download=False)

    sp = sub.add_parser("make-pangenome", help="build the pangenome blockset")
    sp.add_argument("-w", "--workdir", default="npge-work")
    sp.add_argument(
        "--device", default="cuda",
        help="device for the build: cuda (default; fails without a GPU) "
             "or cpu",
    )
    sp.add_argument("--config", help="JSON config file")
    sp.add_argument(
        "-o", "--opt", action="append",
        help="override a global option, e.g. -o MIN_LENGTH=100",
    )
    sp.add_argument("--verbose", action="store_true")
    sp.add_argument("--timing", action="store_true",
                    help="print per-stage wall times")
    sp.set_defaults(fn=cmd_make_pangenome)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
