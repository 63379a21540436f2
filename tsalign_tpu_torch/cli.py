"""Command-line interface: align / preprocess / show.

Mirrors the reference CLI surface (tsalign/src/main.rs:18-33 and
tsalign/src/align.rs:57-223): subcommands, the config-directory convention
(`<dir>/config.tsa`), alphabets, skip characters, rq-ranges, cost limits and
the alignment-method selector.  Methods:

  * a-star-template-switch (default): the dense TSM engine;
  * a-star-gap-affine:  gap-affine only (no TSM layers);
  * matrix:             dense Needleman-Wunsch, cost only;
  * a-star-chain-ts:    long-sequence chained mode (anchors + chain DP).

Run as `python -m tsalign_tpu_torch.cli ...` (or the `tsalign-tpu-torch`
script).

This is the port's copy of ``tsalign_tpu/cli.py``.  It differs in these
points only:

  * `align --device` (default `cuda`) is where the engine runs; it goes to
    `Aligner(device=...)` and `chain_align(device=...)`.  A CUDA device on a
    machine without one fails before any work, naming CUDA: nothing falls
    back to the CPU unless `--device cpu` asks for it;
  * `align --engine` takes `auto | device | numpy`: `auto` and `device` run
    the device engine on `--device`, `numpy` the numpy engine of the facade
    (`chain_align(engine="numpy")` in chained mode); no value picks the
    engine by sequence length;
  * `align --profile DIR` records a `torch.profiler` trace (CPU, and CUDA on
    a CUDA device) and writes it into DIR as a Chrome trace;
  * the matrix method's prefix scan is the port's `ops/primary_sweep`, and
    `preprocess` runs on the port's `chain/plan.py` and `chain/anchors.py`;
  * the program is named `tsalign-tpu-torch`.
"""

from __future__ import annotations

import argparse
import re
import sys

from .alphabet import get_alphabet
from .config import TemplateSwitchConfig
from .fasta import load_pair
from .geometry import AlignmentRange


def _parse_rq_ranges(text: str) -> dict:
    """Parse `--rq-ranges`: one or both of `R<a>..<b>` / `Q<c>..<d>`, each at
    most once, whitespace tolerated after the letter (align.rs:520-573).
    Returns {'R': (a, b)} / {'Q': (c, d)} for the parts present."""
    out = {}
    pos, s = 0, text.strip()
    while pos < len(s):
        m = re.match(r"([RQ])\s*(\d+)\.\.(\d+)", s[pos:])
        if not m:
            raise ValueError(
                f"Malformed rq-ranges {text!r}; expected R<a>..<b> and/or Q<c>..<d>"
            )
        key, a, b = m.group(1), int(m.group(2)), int(m.group(3))
        if key in out:
            raise ValueError(f"Duplicate {key} range in rq-ranges {text!r}")
        out[key] = (a, b)
        pos += m.end()
    return out


def _combine_ranges(args, embedded, n_ref: int, n_qry: int):
    """Combine the embedded range, --rq-ranges, and the per-sequence
    offset/limit flags into one AlignmentRange (or None for no-range mode),
    mirroring parse_range (align.rs:516-599): a per-sequence flag may not be
    combined with an --rq-ranges range for the same sequence, and embedded
    ranges may not be combined with either (align.rs:341-344)."""
    flags = (
        args.reference_offset,
        args.query_offset,
        args.reference_limit,
        args.query_limit,
    )
    if embedded is not None:
        if args.rq_ranges or any(f is not None for f in flags):
            raise SystemExit(
                "--use-embedded-rq-ranges conflicts with --rq-ranges and the "
                "per-sequence offset/limit flags"
            )
        return embedded
    if not args.rq_ranges and all(f is None for f in flags):
        return None
    rq = _parse_rq_ranges(args.rq_ranges) if args.rq_ranges else {}
    if "R" in rq and (
        args.reference_offset is not None or args.reference_limit is not None
    ):
        raise SystemExit(
            "--reference-offset/--reference-limit conflict with a reference "
            "range given via --rq-ranges"
        )
    if "Q" in rq and (args.query_offset is not None or args.query_limit is not None):
        raise SystemExit(
            "--query-offset/--query-limit conflict with a query range given "
            "via --rq-ranges"
        )
    r_lo, r_hi = rq.get("R", (0, n_ref))
    q_lo, q_hi = rq.get("Q", (0, n_qry))
    return AlignmentRange(
        args.reference_offset if args.reference_offset is not None else r_lo,
        args.query_offset if args.query_offset is not None else q_lo,
        args.reference_limit if args.reference_limit is not None else r_hi,
        args.query_limit if args.query_limit is not None else q_hi,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tsalign-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    a = sub.add_parser("align", help="align a pair of sequences")
    a.add_argument("-l", "--log-level", default="info")
    a.add_argument("-p", "--pair-fasta")
    a.add_argument("-r", "--reference-fasta")
    a.add_argument("-q", "--query-fasta")
    a.add_argument("-o", "--output")
    a.add_argument("-c", "--configuration-directory", default=None)
    a.add_argument(
        "-a",
        "--alphabet",
        default="dna-n",
        choices=["dna", "dna-n", "rna", "rna-n", "dna-iupac", "rna-iupac"],
    )
    a.add_argument("--skip-characters", default="")
    a.add_argument(
        "--alignment-method",
        default="a-star-template-switch",
        choices=[
            "matrix",
            "a-star-gap-affine",
            "a-star-template-switch",
            "a-star-chain-ts",
        ],
    )
    a.add_argument("--no-ts", action="store_true")
    a.add_argument("--cost-limit", type=int, default=None)
    a.add_argument("--memory-limit", type=int, default=None)
    a.add_argument("--max-template-switches", type=int, default=None)
    a.add_argument("--rq-ranges", default=None)
    a.add_argument("--use-embedded-rq-ranges", action="store_true")
    # per-sequence range flags (align.rs:180-201); combined with --rq-ranges
    # exactly as parse_range (align.rs:516-599): a flag may not be given for a
    # sequence whose range was already set via --rq-ranges
    a.add_argument("--reference-offset", type=int, default=None)
    a.add_argument("--query-offset", type=int, default=None)
    a.add_argument("--reference-limit", type=int, default=None)
    a.add_argument("--query-limit", type=int, default=None)
    a.add_argument("--prune-range", action="store_true")
    a.add_argument("--dont-extend-beyond-range", action="store_true")
    # Strategy selectors: validated against the reference's clap enums
    # (align.rs:57-223, template_switch_distance_type_selectors.rs:47-81,
    # chain_align/performance_parameters.rs:26-40) so unknown values exit 2
    # like the reference.  The dense engine computes the same optimum
    # without the A* pruning strategies, so all choices are accepted and
    # (except total-length/descendant) subsumed by the exact dense search.
    a.add_argument("--ts-node-ord-strategy", default="anti-diagonal",
                   choices=["anti-diagonal"])  # node expansion order; the
    # dense engine has no expansion order (align.rs:105)
    a.add_argument(
        "--ts-min-length-strategy",
        default="lookahead",
        choices=["none", "lookahead", "preprocess-price",
                 "preprocess-filter", "preprocess-lookahead"],
    )  # all subsumed: the min-length seed feasibility is exact in the
    # dense module seeds (ops/tsm_modules.py)
    a.add_argument(
        "--ts-chaining-strategy", default="none",
        choices=["none", "lower-bound"],
    )  # subsumed: lower_bounds.py applies the admissible TSLB bound always
    a.add_argument(
        "--ts-total-length-strategy", default="maximise",
        choices=["none", "maximise"],
    )
    a.add_argument(
        "--ts-descendant-strategy", default="allow-any",
        # internal short names kept as aliases of the reference's clap names
        choices=["allow-any", "allow-only-all-equal", "any", "only-equal"],
    )
    a.add_argument("--force-label-correcting", action="store_true")
    # subsumed: the dense fixpoint is label-correcting by construction
    a.add_argument("--engine", default="auto", choices=["auto", "device", "numpy"])
    a.add_argument("--device", default="cuda",
                   help="torch device of the device engine (default: cuda)")
    a.add_argument("-k", "--kmer-length", type=int, default=None)
    a.add_argument("--max-chaining-successors", type=int, default=None)
    # accepted, subsumed: the chain DP explores its window exhaustively
    a.add_argument("--max-exact-cost-function-cost", type=int, default=None)
    # accepted, subsumed: segment costs are exact (chain/driver.py)
    a.add_argument("--chaining-open-list", default="linear-heap",
                   choices=["std-heap", "linear-heap"])
    # accepted, subsumed: the windowed chain DP is dense (chain/chain.py)
    a.add_argument("--chaining-closed-list", default="special",
                   choices=["fx-hash-map", "special"])
    # accepted, subsumed: dense DP needs no closed list
    a.add_argument("--cache-directory", default=None)
    a.add_argument("--force-no-preprocessing", action="store_true")
    a.add_argument("--force-label-correcting-all", dest="_flc2", action="store_true",
                   help=argparse.SUPPRESS)
    a.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="write a torch.profiler Chrome trace of the alignment to DIR "
        "(GPU counterpart of the reference's DEBUG_ASTAR tracing)",
    )

    pre = sub.add_parser("preprocess", help="precompute chained-mode caches")
    pre.add_argument("-c", "--configuration-directory", required=True)
    pre.add_argument("--cache-directory", default=".")
    pre.add_argument("-k", type=int, default=None)
    pre.add_argument("--max-n", type=int, default=None)

    s = sub.add_parser("show", help="render an alignment TOML")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("-n", "--no-ts-input", default=None)
    s.add_argument("-s", "--svg-output", default=None)
    s.add_argument("-p", "--png-output", default=None)
    s.add_argument("--png-zoom", type=float, default=2.0)
    s.add_argument("-z", "--context", type=int, default=None)
    s.add_argument("-a", "--arrows", action="store_true")
    s.add_argument("-c", "--complements", action="store_true")
    s.add_argument("-e", "--equal-cost-ranges", action="store_true")
    s.add_argument("-r", "--render-error-svg", action="store_true")
    return p


def _engine(args) -> str:
    """The facade's and chained mode's engine for `--engine`."""
    return "numpy" if args.engine == "numpy" else "device"


def _require_device(device: str) -> None:
    """Fail before any work when `device` is a CUDA device and this machine
    has none; the CLI never carries on on the CPU in its place."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {device}: CUDA is not available on this machine "
            "(pass --device cpu to align on the CPU)"
        )


def cmd_align(args) -> int:
    import logging

    if _engine(args) == "device" and args.alignment_method != "matrix":
        _require_device(args.device)

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from .aligner import Aligner

    al = get_alphabet(args.alphabet)
    if args.configuration_directory:
        config = TemplateSwitchConfig.from_path(
            f"{args.configuration_directory}/config.tsa", al
        )
    else:
        config = TemplateSwitchConfig.default(al)

    ref_rec, qry_rec, embedded = load_pair(
        pair_path=args.pair_fasta,
        reference_path=args.reference_fasta,
        query_path=args.query_fasta,
        skip_characters=args.skip_characters,
        use_embedded_rq_ranges=args.use_embedded_rq_ranges,
    )
    rng = _combine_ranges(args, embedded, len(ref_rec.sequence), len(qry_rec.sequence))

    if args.alignment_method == "a-star-chain-ts":
        return _cmd_align_chain(args, config, ref_rec, qry_rec, rng)
    if args.alignment_method == "matrix":
        return _cmd_align_matrix(args, config, ref_rec, qry_rec)
    if args.alignment_method == "a-star-gap-affine":
        return _cmd_align_gap_affine(args, config, ref_rec, qry_rec)

    aligner = Aligner(
        costs=config,
        alphabet=args.alphabet,
        template_switch_total_length_strategy=args.ts_total_length_strategy,
        template_switch_descendant_strategy={
            "allow-any": "any", "allow-only-all-equal": "only-equal"
        }.get(args.ts_descendant_strategy, args.ts_descendant_strategy),
        no_ts=args.no_ts,
        engine=_engine(args),
        device=args.device,
    )
    import contextlib

    prof: contextlib.AbstractContextManager = contextlib.nullcontext()
    if args.profile:
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(
            activities=activities, on_trace_ready=tensorboard_trace_handler(args.profile)
        )
    with prof:
        result = aligner.align(
            ref_rec.sequence,
            qry_rec.sequence,
            reference_name=ref_rec.display_name,
            query_name=qry_rec.display_name,
            range_=rng,
            cost_limit=args.cost_limit,
            memory_limit=args.memory_limit,
            max_template_switches=args.max_template_switches,
            prune_range=args.prune_range,
            # The reference passes !cli.dont_extend_beyond_range into the
            # aligner (template_switch_distance_type_selectors.rs:437).
            extend_beyond_range=not args.dont_extend_beyond_range,
        )
    toml = result.to_toml()
    if args.output:
        with open(args.output, "w") as f:
            f.write(toml)
    stats = result.stats()
    print(f"cost: {int(stats['cost'])}")
    if result.has_target():
        print(f"cigar: {result.cigar()}")
    print(f"duration_seconds: {stats['duration_seconds']:.3f}")
    return 0


def _cmd_align_chain(args, config, ref_rec, qry_rec, rng=None) -> int:
    """Long-sequence chained mode (lib_ts_chainalign counterpart)."""
    from .chain import chain_align
    from .result import AlignmentResult, AStarResultInfo

    from .chain.plan import PlanCacheError

    al = config.alphabet
    ref = al.encode(ref_rec.sequence)
    qry = al.encode(qry_rec.sequence)
    try:
        res = chain_align(
            config,
            ref,
            qry,
            k=args.kmer_length,
            max_template_switches=args.max_template_switches,
            engine=_engine(args),
            progress=args.log_level in ("debug", "trace"),
            range_=rng,
            cache_directory=args.cache_directory,
            force_no_preprocessing=args.force_no_preprocessing,
            device=args.device,
        )
    except PlanCacheError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.cost_limit is not None and res.cost > args.cost_limit:
        info = AStarResultInfo(type="ExceededCostLimit", cost_limit=args.cost_limit)
        alignment = None
    else:
        info = AStarResultInfo(type="FoundTarget", cost=res.cost)
        alignment = res.alignment
    out = AlignmentResult.new(
        alignment=alignment,
        reference=ref_rec.sequence,
        query=qry_rec.sequence,
        reference_rc=al.reverse_complement_str(ref_rec.sequence),
        query_rc=al.reverse_complement_str(qry_rec.sequence),
        reference_name=ref_rec.display_name,
        query_name=qry_rec.display_name,
        reference_offset=rng.reference_offset if rng else 0,
        query_offset=rng.query_offset if rng else 0,
        result=info,
        duration_seconds=res.duration_seconds,
        opened_nodes=res.anchors,
        closed_nodes=res.segments,
        suboptimal_opened_nodes=0,
    )
    if args.output:
        with open(args.output, "w") as f:
            f.write(out.to_toml())
    if alignment is not None:
        print(f"cost: {res.cost}")
        print(f"segments: {res.segments}  anchors: {res.anchors}")
    else:
        print(f"cost limit {args.cost_limit} exceeded (cost {res.cost})")
    print(f"duration_seconds: {res.duration_seconds:.3f}")
    return 0


def _cmd_align_matrix(args, config, ref_rec, qry_rec) -> int:
    """Dense Needleman-Wunsch cost (reference `--alignment-method matrix`,
    alignment_matrix.rs:40-78): costs come from `<dir>/matrix.toml`
    (match_cost, substitution_cost, indel_cost — align.rs:446-471), output
    is the cost only, and -o is rejected like the reference."""
    import tomllib

    import numpy as np

    if args.output:
        print(
            "Outputting statistics not supported by matrix alignment",
            file=sys.stderr,
        )
        return 2
    mc, sc, ic = 0, 2, 3
    if args.configuration_directory:
        try:
            with open(f"{args.configuration_directory}/matrix.toml", "rb") as f:
                m = tomllib.load(f)
            mc, sc, ic = m["match_cost"], m["substitution_cost"], m["indel_cost"]
        except FileNotFoundError:
            pass
    al = config.alphabet
    ref = al.encode(ref_rec.sequence)
    qry = al.encode(qry_rec.sequence)
    n, m = len(ref), len(qry)
    row = np.arange(m + 1, dtype=np.int64) * ic
    for i in range(1, n + 1):
        diag = row.copy()
        row[0] = i * ic
        match_line = np.where(ref[i - 1] == qry, mc, sc) + diag[:m]
        cur = row
        prev = diag
        # vectorized: row[j] = min(diag[j-1]+sub, row[j]+ic prefix recurrence)
        up = prev[1:] + ic
        cand = np.minimum(match_line, up)
        # left-dependency solved with a prefix scan
        from .ops.primary_sweep import min_plus_scan

        ext = np.full(m, ic, dtype=np.int64)
        chained = min_plus_scan(
            np.concatenate([[row[0]], cand]), np.concatenate([[0], ext])
        )
        row[1:] = np.minimum(cand, chained[1:])
        row[0] = i * ic
    print(f"Cost: {row[m]}")
    return 0


def _cmd_align_gap_affine(args, config, ref_rec, qry_rec) -> int:
    """Standalone gap-affine method (reference --alignment-method
    a-star-gap-affine, align.rs:473-514): base-agnostic costs from
    `<dir>/a_star_gap_affine.toml`, full TOML output supported."""
    import tomllib

    from .aligner import Aligner
    from .costs import GapAffineCostTable

    cfg = config
    if args.configuration_directory:
        try:
            with open(
                f"{args.configuration_directory}/a_star_gap_affine.toml", "rb"
            ) as f:
                g = tomllib.load(f)
            from dataclasses import replace

            table = GapAffineCostTable.base_agnostic(
                "Primary Edit Costs",
                config.alphabet,
                g["match_cost"],
                g["substitution_cost"],
                g["gap_open_cost"],
                g["gap_extend_cost"],
            )
            cfg = replace(config, primary_edit_costs=table)
        except FileNotFoundError:
            pass
    aligner = Aligner(
        costs=cfg, alphabet=args.alphabet, no_ts=True, engine=_engine(args), device=args.device
    )
    result = aligner.align(
        ref_rec.sequence,
        qry_rec.sequence,
        reference_name=ref_rec.display_name,
        query_name=qry_rec.display_name,
        cost_limit=args.cost_limit,
    )
    if args.output:
        with open(args.output, "w") as f:
            f.write(result.to_toml())
    print(f"cost: {int(result.stats()['cost'])}")
    if result.has_target():
        print(f"cigar: {result.cigar()}")
    return 0


def cmd_show(args) -> int:
    from .result import AlignmentResult
    from .show.plain_text import show_template_switches

    with open(args.input) as f:
        result = AlignmentResult.from_toml(f.read())
    no_ts = None
    if args.no_ts_input:
        with open(args.no_ts_input) as f:
            no_ts = AlignmentResult.from_toml(f.read())
    show_template_switches(sys.stdout, result, no_ts)
    if args.svg_output:
        from .show.svg import create_ts_svg

        svg = create_ts_svg(
            result,
            no_ts,
            arrows=args.arrows,
            context=args.context,
            complements=args.complements,
            equal_cost_ranges=args.equal_cost_ranges,
        )
        with open(args.svg_output, "w") as f:
            f.write(svg)
    if args.png_output:
        # show.rs -p renders the SVG to PNG via resvg (lib_tsshow/src/lib.rs:8);
        # here the shared render plan is rasterized directly.
        from .show.png import render_png
        from .show.svg import build_plan, create_error_svg

        if not result.has_target:
            print("alignment has no target; no PNG written", file=sys.stderr)
            return 2
        try:
            plan = build_plan(
                result,
                no_ts,
                arrows=args.arrows,
                context=args.context,
                complements=args.complements,
                equal_cost_ranges=args.equal_cost_ranges,
            )
            render_png(plan, args.png_output, zoom=args.png_zoom)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 2
    return 0


def cmd_preprocess(args) -> int:
    """Precompute and cache chained-mode planning for a config.

    Counterpart of `tsalign preprocess` (tsalign/src/preprocess.rs:94-158):
    walks the max_n ladder (halving from the largest bucket), computes the
    per-(k, max_n) chain plan and stores it in sha1-keyed `.tsc.json` files
    that `align --alignment-method a-star-chain-ts` loads back
    (tsalign/src/util.rs:46-66 cache naming; chain/plan.py)."""
    import os as _os

    from .chain.anchors import choose_k
    from .chain.plan import compute_plan, infer_max_n, plan_cache_path

    al = get_alphabet("dna-n")
    config = TemplateSwitchConfig.from_path(
        f"{args.configuration_directory}/config.tsa", al
    )
    _os.makedirs(args.cache_directory, exist_ok=True)
    max_length = args.max_n or (1 << 18)
    n = infer_max_n(max_length, max_length)
    wrote = 0
    while n >= 64:
        k = args.k or choose_k(2 * n)
        plan = compute_plan(config, k, n)
        path = plan_cache_path(args.cache_directory, plan.config_sha1, k, n)
        with open(path, "w") as f:
            f.write(plan.to_json())
        wrote += 1
        n //= 2
    print(
        f"wrote {wrote} plan files to {args.cache_directory} "
        f"(radius {plan.window_radius})"
    )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "align":
        return cmd_align(args)
    if args.command == "show":
        return cmd_show(args)
    if args.command == "preprocess":
        return cmd_preprocess(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
