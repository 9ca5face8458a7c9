"""npge_tpu_torch CLI — every verb of ``npge_tpu.cli`` on an explicit device.

    python -m npge_tpu_torch.cli prepare --fasta a.fa b.fa [--genomes G.tsv] -w WORK
    python -m npge_tpu_torch.cli examine -w WORK
    python -m npge_tpu_torch.cli make-pangenome -w WORK [--device cuda|cpu]
        [--devices N] [-o KEY=VALUE ...] [--config C.json] [--timing]
    python -m npge_tpu_torch.cli check -w WORK [--deep] [--device cuda|cpu]
    python -m npge_tpu_torch.cli post-processing|info|hash|report -w WORK
    python -m npge_tpu_torch.cli run NAME|script.py -w WORK [--stage-name S]
    python -m npge_tpu_torch.cli processors|shell|warmup ...

The options are the reference's, except that ``--platform`` is
``--device``: ``cuda`` (the default) or ``cpu``. A verb that computes on
the device exits non-zero when that device is unavailable; nothing falls
back to the CPU unless ``--device cpu`` asks for it. The host verbs
(``prepare``, ``examine``, ``info``, ``hash``, ``post-processing``,
``report``) are copies of the reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from npge_tpu_torch.config import Config, default_config
from npge_tpu_torch.model.blocks import BlockSet
from npge_tpu_torch.model.hashing import blockset_hash


# mirrors npge_tpu/cli.py:_load_cfg
def _load_cfg(args) -> Config:
    cfg = default_config()
    if getattr(args, "config", None):
        with open(args.config) as fh:
            cfg = cfg.replace(**json.load(fh))
    for kv in getattr(args, "opt", None) or []:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)  # raises on unknown knob
        if k == "MIN_IDENTITY":
            cfg = cfg.replace(**{k: v})
        elif isinstance(cur, bool):
            cfg = cfg.replace(**{k: v.lower() in ("1", "true", "yes")})
        else:
            cfg = cfg.replace(**{k: int(v)})
    return cfg


# mirrors npge_tpu/cli.py:_load_input
def _load_input(workdir: str, stage: str | None = None) -> BlockSet:
    from npge_tpu_torch.io.checkpoint import load_stage

    stages = [stage] if stage else ["pangenome", "input"]
    for st in stages:
        bs = load_stage(workdir, st)
        if bs is not None:
            return bs
    raise SystemExit(
        f"no {'/'.join(stages)}.bs under {workdir}; run prepare first"
    )


def _device(args):
    """The torch device of ``--device``; exits non-zero when it is not
    available."""
    from npge_tpu_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{args.cmd}: {e}")


def _mesh(args, dev):
    """The mesh of ``--devices N``: N shards on the host with ``--device
    cpu``, the first N cards with ``--device cuda``; exits non-zero when
    fewer cards are visible or ``--device`` is not the first of them."""
    from npge_tpu_torch.parallel.mesh import DeviceMesh, make_mesh

    if dev.type == "cpu":
        return DeviceMesh([dev] * args.devices)
    try:
        mesh = make_mesh(args.devices, "cuda")
    except ValueError as e:
        raise SystemExit(f"{args.cmd}: --devices {args.devices}: {e}")
    if mesh.devices[0] != dev:
        raise SystemExit(
            f"{args.cmd}: --devices {args.devices} starts at {mesh.devices[0]}, "
            f"not at --device {dev}"
        )
    return mesh


# mirrors npge_tpu/cli.py:cmd_prepare
def cmd_prepare(args) -> None:
    from npge_tpu_torch.io.checkpoint import save_stage
    from npge_tpu_torch.io.fasta import arena_from_fasta_files, read_genomes_tsv

    rename = {}
    fasta = list(args.fasta or [])
    if args.genomes:
        table = read_genomes_tsv(args.genomes)
        rename = dict(table)
        if not fasta:
            # GetData parity: accessions resolve against local --data-dir
            # files first; with --download, missing ones are fetched over
            # HTTP (io/getdata — ENA by default, NPGE_FASTA_URL override)
            data_dir = args.data_dir or "."
            if getattr(args, "download", False):
                import urllib.error

                from npge_tpu_torch.io.getdata import fetch_missing

                try:
                    fetch_missing([acc for acc, _ in table], data_dir)
                except urllib.error.URLError as e:
                    raise SystemExit(f"download failed: {e}")
                except OSError as e:
                    raise SystemExit(f"download failed: {e}")
            missing = []
            for acc, _name in table:
                for ext in (".fa", ".fasta", ".fa.gz", ".fasta.gz"):
                    p = os.path.join(data_dir, acc + ext)
                    if os.path.exists(p):
                        fasta.append(p)
                        break
                else:
                    missing.append(acc)
            if missing:
                raise SystemExit(
                    f"accessions without local FASTA under {data_dir}: "
                    f"{', '.join(missing)} (pass --download to fetch over "
                    "HTTP, or place <accession>.fa files in --data-dir)"
                )
    if not fasta:
        raise SystemExit("prepare needs --fasta files or --genomes with --data-dir")
    arena = arena_from_fasta_files(fasta, rename)
    bs = BlockSet(arena, [])
    path = save_stage(args.workdir, "input", bs)
    print(f"prepared {arena.n_seqs} sequences, {arena.total_length} bp -> {path}")


# mirrors npge_tpu/cli.py:cmd_examine
def cmd_examine(args) -> None:
    from npge_tpu_torch.algo.reports import info_text

    bs = _load_input(args.workdir, getattr(args, 'stage', None))
    print(info_text(bs))


# mirrors npge_tpu/cli.py:cmd_post_processing
def cmd_post_processing(args) -> None:
    from npge_tpu_torch.algo.bsa import exact_stem_bsa, find_bsa
    from npge_tpu_torch.algo.mutations import mutations_tsv
    from npge_tpu_torch.algo.reports import block_info_tsv, info_text, per_genome_table
    from npge_tpu_torch.algo.trees import consensus_tree, distances_tsv

    from npge_tpu_torch.util.streams import write_text

    bs = _load_input(args.workdir, getattr(args, 'stage', None))
    out = args.workdir
    # targets go through the named-stream resolver (util/streams): a test
    # or script can repoint any of them at :stdout / a :named memory
    # stream by overriding --target NAME=STREAM
    targets = {
        "blocks.tsv": lambda: block_info_tsv(bs),
        "mutations.tsv": lambda: mutations_tsv(bs),
        "distances.tsv": lambda: distances_tsv(bs),
        # bsa.tsv is the order-aligned (rearrangement) view
        "bsa.tsv": lambda: find_bsa(bs).tsv(),
        "bsa_scaffold.tsv": lambda: exact_stem_bsa(bs).tsv(),
        "info.txt": lambda: info_text(bs) + "\n",
        "genomes_stats.tsv": lambda: per_genome_table(bs),
    }
    tree, n_used = consensus_tree(bs)
    targets["consensus_tree.nwk"] = (
        lambda: tree.newick(with_support=True) + "\n"
    )
    overrides = {}
    for kv in getattr(args, "target", None) or []:
        if "=" not in kv:
            raise SystemExit(
                f"--target expects FILE=STREAM, got {kv!r}"
            )
        fname, stream = kv.split("=", 1)
        if fname not in targets:
            raise SystemExit(
                f"--target: unknown output {fname!r} "
                f"(known: {', '.join(sorted(targets))})"
            )
        overrides[fname] = stream
    for fname, render in targets.items():
        dest = overrides.get(fname, os.path.join(out, fname))
        write_text(dest, render())
    print(
        f"post-processing written to {out}: blocks.tsv mutations.tsv "
        f"distances.tsv bsa.tsv consensus_tree.nwk (over {n_used} stem trees) info.txt"
    )


# mirrors npge_tpu/cli.py:cmd_info
def cmd_info(args) -> None:
    from npge_tpu_torch.algo.reports import info_text

    print(info_text(_load_input(args.workdir, getattr(args, 'stage', None))))


# mirrors npge_tpu/cli.py:cmd_hash
def cmd_hash(args) -> None:
    print(f"{blockset_hash(_load_input(args.workdir, getattr(args, 'stage', None))):016x}")


# mirrors npge_tpu/cli.py:cmd_report
def cmd_report(args) -> None:
    from npge_tpu_torch.io.html_report import write_report

    bs = _load_input(args.workdir, getattr(args, 'stage', None))
    out = os.path.join(args.workdir, "report.html")
    write_report(bs, out, _load_cfg(args))
    print(f"wrote {out}")


# mirrors npge_tpu/cli.py:cmd_make_pangenome
def cmd_make_pangenome(args) -> None:
    from npge_tpu_torch.algo.reports import json_line
    from npge_tpu_torch.io.checkpoint import load_stage, save_stage
    from npge_tpu_torch.algo.is_pangenome import check_is_pangenome
    from npge_tpu_torch.algo.pangenome import build_pangenome

    dev = _device(args)
    mesh = _mesh(args, dev) if args.devices else None
    cfg = _load_cfg(args)
    src = load_stage(args.workdir, "input")
    if src is None:
        raise SystemExit(f"no input.bs under {args.workdir}; run prepare first")
    bs, timings = build_pangenome(
        src.arena, cfg, dev, verbose=args.verbose, mesh=mesh
    )
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


# mirrors npge_tpu/cli.py:cmd_check
def cmd_check(args) -> None:
    from npge_tpu_torch.algo.is_pangenome import check_is_pangenome

    deep = args.deep
    dev = _device(args) if deep else None
    cfg = _load_cfg(args)
    bs = _load_input(args.workdir, args.stage)
    if deep:
        # the deep probe is a pure function of (blockset, cfg): reuse the
        # verdict the construction loop proved at build time when the
        # loaded blockset hash and config match the recorded memo
        memo = None
        meta_path = os.path.join(args.workdir, f"{args.stage or 'pangenome'}.json")
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                memo = json.load(fh).get("deep_probe")
        if (
            memo
            and memo.get("ok")
            and memo.get("cfg") == cfg.to_json()
            and memo.get("blockset_hash") == f"{blockset_hash(bs):016x}"
        ):
            deep = False
            print(
                "deep probe: reusing build-time proof "
                "(blockset hash and config unchanged)",
                file=sys.stderr,
            )
    rep = check_is_pangenome(bs, cfg, deep=deep, device=dev)
    print("OK" if rep.ok else "FAIL")
    for m in rep.messages:
        print(" -", m)
    sys.exit(0 if rep.ok else 1)


# mirrors npge_tpu/cli.py:cmd_run
def cmd_run(args) -> None:
    """Run a named processor/pipe or a Python script with
    meta/bs/cfg/device in scope."""
    from npge_tpu_torch.io.checkpoint import save_stage
    from npge_tpu_torch import meta

    dev = _device(args)
    cfg = _load_cfg(args)
    bs = _load_input(args.workdir, args.stage)
    if args.name.endswith(".py"):
        bs = meta.run_script(args.name, bs, cfg, dev)
    else:
        bs = meta.get(args.name)(bs, cfg, dev)
    path = save_stage(args.workdir, args.stage_name, bs)
    print(f"{args.name} -> {len(bs.blocks)} blocks -> {path}")


def cmd_processors(args) -> None:
    from npge_tpu_torch import meta

    for n in meta.names():
        print(n)


# mirrors npge_tpu/cli.py:cmd_shell
def cmd_shell(args) -> None:
    """Interactive console with meta/bs/cfg/device in scope."""
    import code

    from npge_tpu_torch import meta

    dev = _device(args)
    cfg = _load_cfg(args)
    bs = _load_input(args.workdir, args.stage)
    banner = (
        f"npge-tpu-torch shell — bs: {len(bs.blocks)} blocks over "
        f"{bs.arena.n_seqs} sequences on {dev}; objects: meta, bs, cfg, "
        f"device\nprocessors: {', '.join(meta.names())}"
    )
    code.interact(
        banner=banner,
        local={"meta": meta, "bs": bs, "cfg": cfg, "device": dev},
    )


def cmd_warmup(args) -> None:
    """Build both of the port's libraries (the C++ host library with g++,
    and on a GPU the CUDA kernel library with nvcc, each once per checkout)
    and run one synthetic build of the intended size on the device, so the
    first real run starts with both built and the CUDA context warm."""
    import time

    from npge_tpu_torch import native
    from npge_tpu_torch.algo.pangenome import build_pangenome
    from npge_tpu_torch.util.synthetic import synthetic_arena

    dev = _device(args)
    host = (
        f"host library {native.library_path()}" if native.have_native()
        else "host library did not build (NumPy fallbacks)"
    )
    lib = "no kernel library on the CPU (plain torch versions)"
    if dev.type == "cuda":
        from npge_tpu_torch.ops import _build

        _build.load_library()
        lib = f"kernel library {_build.library_path()}"
    per = max(1000, args.size // max(1, args.n))
    arena = synthetic_arena(
        n_genomes=args.n, length=per, seed=0,
        sub_rate=0.002, indel_rate=0.0001,
    )
    t0 = time.perf_counter()
    bs, _ = build_pangenome(arena, _load_cfg(args), dev)
    print(
        f"warmup: {args.n}x{per} bp built on {dev} in "
        f"{time.perf_counter() - t0:.1f}s ({len(bs.blocks)} blocks); "
        f"{host}; {lib}"
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="npge-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, cfg_opts=True):
        sp.add_argument("-w", "--workdir", default="npge-work")
        sp.add_argument("--stage", help="load this stage's .bs instead of pangenome/input")
        sp.add_argument(
            "--device", default="cuda",
            help="device for compute verbs: cuda (default; fails without a "
                 "GPU) or cpu",
        )
        if cfg_opts:
            sp.add_argument("--config", help="JSON config file")
            sp.add_argument(
                "-o", "--opt", action="append",
                help="override a global option, e.g. -o MIN_LENGTH=100",
            )

    sp = sub.add_parser("prepare", help="ingest FASTA genomes (GetData+Prepare)")
    sp.add_argument("--fasta", nargs="+")
    sp.add_argument("--genomes", help="genomes.tsv accession renaming table")
    sp.add_argument("--data-dir", help="directory with <accession>.fa files")
    sp.add_argument(
        "--download", action="store_true",
        help="fetch missing accessions over HTTP into --data-dir "
             "(GetData; ENA by default, NPGE_FASTA_URL template override)",
    )
    common(sp, cfg_opts=False)
    sp.set_defaults(fn=cmd_prepare)

    for name, fn in [
        ("examine", cmd_examine),
        ("make-pangenome", cmd_make_pangenome),
        ("post-processing", cmd_post_processing),
        ("info", cmd_info),
        ("check", cmd_check),
        ("hash", cmd_hash),
    ]:
        sp = sub.add_parser(name)
        common(sp)
        if name == "make-pangenome":
            sp.add_argument("--verbose", action="store_true")
            sp.add_argument("--timing", action="store_true",
                            help="print per-stage wall times")
            sp.add_argument(
                "--devices", type=int, default=0,
                help="shard the scan and the extension over N devices of "
                     "--device's kind: the first N cards, or N shards on "
                     "the CPU",
            )
        if name == "check":
            sp.add_argument("--deep", action="store_true",
                            help="also verify re-seeding finds no new hits")
        if name == "post-processing":
            sp.add_argument(
                "--target", action="append", metavar="FILE=STREAM",
                help="repoint an output, e.g. info.txt=:stdout or "
                     "blocks.tsv=:mybuf (named in-memory stream)",
            )
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("run", help="run a named processor/pipe or script")
    sp.add_argument("name", help="processor name or .py script path")
    sp.add_argument("--stage-name", default="stage")
    common(sp)
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("processors", help="list registered processors")
    common(sp, cfg_opts=False)
    sp.set_defaults(fn=cmd_processors)

    sp = sub.add_parser("report", help="write a self-contained HTML report")
    common(sp)
    sp.set_defaults(fn=cmd_report)

    sp = sub.add_parser("shell", help="interactive console (meta/bs/cfg/device)")
    common(sp)
    sp.set_defaults(fn=cmd_shell)

    sp = sub.add_parser(
        "warmup",
        help="build the host and kernel libraries and run one synthetic "
             "build of the intended size on the device",
    )
    sp.add_argument("--size", type=int, default=3_000_000,
                    help="total bp of the intended real runs")
    sp.add_argument("-n", type=int, default=3,
                    help="genome count of the intended real runs")
    common(sp)
    sp.set_defaults(fn=cmd_warmup)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
