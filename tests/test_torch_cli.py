"""The port's command line (``tsalign_tpu_torch.cli``) against the JAX
package's (``tsalign_tpu.cli``) on the CPU, with exact equality.

  * FASTA: ``parse_fasta_text``, ``extract_embedded_range``,
    ``strip_skip_characters`` and ``load_pair`` (pair file and ``-r``/``-q``
    files, skip characters, embedded ranges, display names) give equal
    records, ranges and errors;
  * ranges: the cases of tests/test_cli_ranges.py over both packages'
    ``_parse_rq_ranges`` and ``_combine_ranges``;
  * ``align``: the 60 bp pairs of the flankless and the flanked fixtures
    (the flanked config reaches the command line as ``display()`` text in a
    ``config.tsa``), each as default, with ``--no-ts``, with ``--rq-ranges``
    and with ``--cost-limit`` below the optimum, the port with ``--device
    cpu`` against the JAX package's default engine; the TOML records (all
    but their wall-time lines) and the printed ``cost:`` / ``cigar:`` lines
    must be equal.  Also the numpy engine, the ``matrix`` and
    ``a-star-gap-affine`` methods, and chained mode (``a-star-chain-ts``,
    with a ``preprocess`` cache) against the JAX package's numpy engine;
  * ``preprocess`` writes byte-equal ``.tsc.json`` files;
  * without ``--device`` the port's ``align`` runs on CUDA, and with no card
    it fails before any work and names CUDA;
  * ``--profile DIR`` writes a ``torch.profiler`` Chrome trace into DIR.
"""

import argparse
import json
import os
import shutil
import sys

import pytest

from tsalign_tpu import cli as jax_cli
from tsalign_tpu import fasta as jax_fasta
from tsalign_tpu.geometry import AlignmentRange as JaxRange
from tsalign_tpu_torch import cli as port_cli
from tsalign_tpu_torch import fasta as port_fasta
from tsalign_tpu_torch.alphabet import get_alphabet
from tsalign_tpu_torch.config import TemplateSwitchConfig
from tsalign_tpu_torch.geometry import AlignmentRange as PortRange

from torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
sys.path.insert(0, ROOT)
from chip_smoke import chain_construction, flanked_default  # noqa: E402

PACKAGES = {"jax": (jax_cli, jax_fasta, JaxRange), "port": (port_cli, port_fasta, PortRange)}


def _outcome(fn, *args, **kwargs):
    """What a call gives, comparable across the two packages: its value as
    plain data, or the type and message of what it raised."""
    try:
        return "value", _plain(fn(*args, **kwargs))
    except (ValueError, SystemExit) as e:
        return type(e).__name__, str(e)


def _plain(value):
    if isinstance(value, (list, tuple)):
        return tuple(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if hasattr(value, "sequence"):  # a FastaRecord
        return ("record", value.id, value.comment, value.sequence, value.display_name)
    if hasattr(value, "query_limit"):  # an AlignmentRange
        return ("range", value.reference_offset, value.query_offset,
                value.reference_limit, value.query_limit)
    return value


# ---------------------------------------------------------------- FASTA

FASTA_TEXTS = [
    ">reference\nACACA|CCCAAC|GCGGG\n>query\nACAAA|CGTGTC|GCGCG\n",
    "\n\n>a first record\nACG\nTTA\n\n>b\tsecond\nGG\n",
    ">only\n  acgtn  \n",
    ">x y z\n\n",
    "ACGT\n>late\nAC\n",
    "",
    "\n  \n",
]


@pytest.mark.parametrize("text", FASTA_TEXTS)
def test_parse_fasta_text(text):
    assert _outcome(port_fasta.parse_fasta_text, text) == _outcome(
        jax_fasta.parse_fasta_text, text)


@pytest.mark.parametrize("sequence", [
    "ACACA|CCCAAC|GCGGG", "|ACGT|", "AC||GT", "ACGT", "AC|GT", "A|C|G|T"])
def test_extract_embedded_range(sequence):
    assert _outcome(port_fasta.extract_embedded_range, sequence, "reference") == _outcome(
        jax_fasta.extract_embedded_range, sequence, "reference")


@pytest.mark.parametrize("sequence,skip", [
    ("AC-GT.N-", "-."), ("ACGT", ""), ("A C G", " "), ("----", "-")])
def test_strip_skip_characters(sequence, skip):
    assert port_fasta.strip_skip_characters(sequence, skip) == \
        jax_fasta.strip_skip_characters(sequence, skip)


LOAD_CASES = {
    "pair": (dict(pair="pair.fa"), {}),
    "files": (dict(reference="ref.fa", query="qry.fa"), {}),
    "skip": (dict(pair="pair.fa"), dict(skip_characters="-")),
    "embedded": (dict(pair="pair.fa"), dict(skip_characters="-", use_embedded_rq_ranges=True)),
    "embedded_files": (dict(reference="ref.fa", query="qry.fa"),
                       dict(use_embedded_rq_ranges=True)),
    "skip_bar": (dict(pair="pair.fa"), dict(skip_characters="|", use_embedded_rq_ranges=True)),
    "three_records": (dict(pair="three.fa"), {}),
    "two_in_reference": (dict(reference="pair.fa", query="qry.fa"), {}),
    "no_file": ({}, {}),
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_pair(case, tmp_path):
    (tmp_path / "pair.fa").write_text(
        ">ref first sample\nac-aca|CCC\nAAC|gcggg\n>qry\tsecond\nACAAA|CG-TGTC|GCGCG\n")
    (tmp_path / "ref.fa").write_text(">r\nAC|GTAC|GT\n")
    (tmp_path / "qry.fa").write_text(">q note\nACG|TTA|CGT\n")
    (tmp_path / "three.fa").write_text(">a\nA\n>b\nC\n>c\nG\n")
    files, kwargs = LOAD_CASES[case]
    paths = {f"{k}_path": str(tmp_path / v) for k, v in files.items()}
    got = _outcome(port_fasta.load_pair, **paths, **kwargs)
    want = _outcome(jax_fasta.load_pair, **paths, **kwargs)
    assert got == want


# ---------------------------------------------------------------- ranges

def _args(**kw):
    base = dict(rq_ranges=None, reference_offset=None, query_offset=None,
                reference_limit=None, query_limit=None)
    base.update(kw)
    return argparse.Namespace(**base)


# (function, its arguments with "RANGE" standing for the package's
# AlignmentRange(1, 1, 5, 5), the expected outcome)
RANGE_CASES = {
    "parse_full": ("parse", ("R1..5Q2..7",), ("value", {"R": (1, 5), "Q": (2, 7)})),
    "parse_query_only": ("parse", ("Q2..7",), ("value", {"Q": (2, 7)})),
    "parse_space_after_letter": ("parse", ("R 1..5Q 2..7",),
                                 ("value", {"R": (1, 5), "Q": (2, 7)})),
    "parse_duplicate": ("parse", ("R1..5R2..3",), "ValueError"),
    "parse_bad_letter": ("parse", ("X1..5",), "ValueError"),
    "combine_nothing": ("combine", (_args(), None, 10, 12), ("value", None)),
    "combine_flags_fill": ("combine", (_args(rq_ranges="Q2..7", reference_offset=1,
                                             reference_limit=9), None, 10, 12),
                           ("value", ("range", 1, 2, 9, 7))),
    "combine_reference_conflict": ("combine", (_args(rq_ranges="R0..10", reference_offset=2),
                                               None, 10, 12), "SystemExit"),
    "combine_query_conflict": ("combine", (_args(rq_ranges="Q0..12", query_limit=5),
                                           None, 10, 12), "SystemExit"),
    "combine_embedded_passthrough": ("combine", (_args(), "RANGE", 10, 12),
                                     ("value", ("range", 1, 1, 5, 5))),
    "combine_embedded_and_rq": ("combine", (_args(rq_ranges="R1..5"), "RANGE", 10, 12),
                                "SystemExit"),
    "combine_embedded_and_flag": ("combine", (_args(query_offset=3), "RANGE", 10, 12),
                                  "SystemExit"),
}


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_cli_ranges(case):
    kind, args, want = RANGE_CASES[case]
    outcomes = []
    for cli, _, rng_type in PACKAGES.values():
        fn = cli._parse_rq_ranges if kind == "parse" else cli._combine_ranges
        outcomes.append(_outcome(fn, *[rng_type(1, 1, 5, 5) if a == "RANGE" else a
                                       for a in args]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == want or outcomes[0][0] == want


# ---------------------------------------------------------------- align

def _pair(fixture):
    with open(os.path.join(FIXTURES, fixture)) as f:
        return json.load(f)["pairs"][0]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """FASTA files of the fixtures' 60 bp pairs and the config directories."""
    d = tmp_path_factory.mktemp("cli")
    for name, fixture in (("plain", "torch_port_pairs.json"),
                          ("flanked", "torch_port_flanked_pairs.json")):
        p = _pair(fixture)
        assert len(p["reference"]) == 60
        (d / f"{name}.fa").write_text(f">ref a\n{p['reference']}\n>qry b\n{p['query']}\n")
    (d / "flanked_cfg").mkdir()
    (d / "flanked_cfg" / "config.tsa").write_text(flanked_default(get_alphabet("dna-n")).display())
    default = TemplateSwitchConfig.default(get_alphabet("dna-n")).display()
    for name in ("matrix_cfg", "gap_cfg"):
        (d / name).mkdir()
        (d / name / "config.tsa").write_text(default)
    (d / "matrix_cfg" / "matrix.toml").write_text(
        "match_cost = 0\nsubstitution_cost = 3\nindel_cost = 2\n")
    (d / "gap_cfg" / "a_star_gap_affine.toml").write_text(
        "match_cost = 0\nsubstitution_cost = 2\ngap_open_cost = 3\ngap_extend_cost = 1\n")
    (d / "chain_cfg").mkdir()
    shutil.copy(os.path.join(FIXTURES, "torch_port_chain_cfg.tsa"), d / "chain_cfg" / "config.tsa")
    return d


def _run(cli, argv, capsys):
    """(exit code, printed lines without the wall-time line, TOML record
    without its wall-time lines or None)."""
    capsys.readouterr()
    rc = cli.main(argv)
    printed = [line for line in capsys.readouterr().out.splitlines()
               if not line.startswith("duration_seconds")]
    record = None
    if "-o" in argv and os.path.exists(argv[argv.index("-o") + 1]):
        with open(argv[argv.index("-o") + 1]) as f:
            record = [line for line in f.read().splitlines()
                      if not line.startswith(("duration_seconds", "runtime"))]
    return rc, printed, record


def _both(inputs, capsys, argv, port_extra=("--device", "cpu"), jax_extra=()):
    out = {}
    for name, cli, extra in (("port", port_cli, port_extra), ("jax", jax_cli, jax_extra)):
        full = [a.replace("@", str(inputs)) for a in argv]
        if "-o" in full:
            full[full.index("-o") + 1] += f".{name}"
        out[name] = _run(cli, full + list(extra), capsys)
    return out["port"], out["jax"]


ALIGN_CASES = {
    "default": [],
    "no_ts": ["--no-ts"],
    "rq_ranges": ["--rq-ranges", "R5..50Q5..49"],
    "cost_limit": ["--cost-limit", "COST-1"],
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
@pytest.mark.parametrize("pair", ["plain", "flanked"])
def test_align_matches_the_jax_cli(pair, case, inputs, capsys):
    fixture = "torch_port_pairs.json" if pair == "plain" else "torch_port_flanked_pairs.json"
    cost = _pair(fixture)["cost"]
    extra = [str(cost - 1) if a == "COST-1" else a for a in ALIGN_CASES[case]]
    argv = ["align", "-p", f"@/{pair}.fa", "-o", f"@/{pair}_{case}.toml"] + extra
    if pair == "flanked":
        argv += ["-c", "@/flanked_cfg"]
    got, want = _both(inputs, capsys, argv)
    assert got == want
    rc, printed, record = got
    assert rc == 0 and record
    if case == "cost_limit":
        assert len(printed) == 1 and printed[0].startswith("cost: ")  # no CIGAR
        assert any("ExceededCostLimit" in line for line in record)
    elif case == "default":
        assert printed == [f"cost: {cost}", f"cigar: {_pair(fixture)['cigar']}"]


def test_numpy_engine_matches_the_jax_cli(inputs, capsys):
    argv = ["align", "-p", "@/plain.fa", "-o", "@/numpy.toml", "--engine", "numpy",
            "--rq-ranges", "R5..50Q5..49"]
    got, want = _both(inputs, capsys, argv, port_extra=())
    assert got == want and got[2]


@pytest.mark.parametrize("config", [None, "matrix_cfg"])
def test_matrix_method_matches_the_jax_cli(config, inputs, capsys):
    argv = ["align", "-p", "@/plain.fa", "--alignment-method", "matrix"]
    if config:
        argv += ["-c", f"@/{config}"]
    got, want = _both(inputs, capsys, argv)
    assert got == want
    assert got[1][0].startswith("Cost: ")
    # -o is refused, as in the reference
    got, want = _both(inputs, capsys, argv + ["-o", "@/matrix.toml"])
    assert got == want and got[0] == 2


@pytest.mark.parametrize("config", [None, "gap_cfg"])
def test_gap_affine_method_matches_the_jax_cli(config, inputs, capsys):
    argv = ["align", "-p", "@/plain.fa", "--alignment-method", "a-star-gap-affine",
            "-o", f"@/gap_{config}.toml"]
    if config:
        argv += ["-c", f"@/{config}"]
    got, want = _both(inputs, capsys, argv)
    assert got == want and got[2]


def test_preprocess_writes_equal_plan_files(inputs, capsys):
    caches = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        cache = inputs / f"plans_{name}"
        assert cli.main(["preprocess", "-c", str(inputs / "chain_cfg"),
                         "--cache-directory", str(cache), "--max-n", "1024"]) == 0
        caches[name] = {p.name: p.read_bytes() for p in sorted(cache.iterdir())}
    assert caches["port"] == caches["jax"]
    assert len(caches["port"]) == 5 and all(n.endswith(".tsc.json") for n in caches["port"])


def test_chained_mode_matches_the_jax_cli(inputs, capsys):
    """Chained mode on the 160 bp pair of the chain fixture (its own config),
    then a 200 bp construction under the narrow config with the cache that
    ``preprocess`` wrote; the JAX package runs its numpy engine."""
    p = json.load(open(os.path.join(FIXTURES, "torch_port_chain_pairs.json")))["pairs"][2]
    assert p["name"] == "random_160"
    (inputs / "random_cfg").mkdir()
    (inputs / "random_cfg" / "config.tsa").write_text(p["config"])
    (inputs / "r160.fa").write_text(f">r\n{p['reference']}\n")
    (inputs / "q160.fa").write_text(f">q\n{p['query']}\n")
    argv = ["align", "-r", "@/r160.fa", "-q", "@/q160.fa", "-c", "@/random_cfg", "-a", "dna",
            "--alignment-method", "a-star-chain-ts", "-o", "@/chain160.toml"]
    got, want = _both(inputs, capsys, argv, jax_extra=("--engine", "numpy"))
    assert got == want
    assert got[1][:2] == [f"cost: {p['cost']}",
                          f"segments: {p['segments']}  anchors: {p['anchors']}"]

    al = get_alphabet("dna-n")
    ref, qry, expected, _ = chain_construction(200, 5)
    (inputs / "r200.fa").write_text(f">r\n{al.decode(ref)}\n")
    (inputs / "q200.fa").write_text(f">q\n{al.decode(qry)}\n")
    cache = inputs / "plans_200"
    assert port_cli.main(["preprocess", "-c", str(inputs / "chain_cfg"),
                          "--cache-directory", str(cache), "--max-n", "512"]) == 0
    argv = ["align", "-r", "@/r200.fa", "-q", "@/q200.fa", "-c", "@/chain_cfg",
            "--alignment-method", "a-star-chain-ts", "--cache-directory", str(cache),
            "--force-no-preprocessing", "-o", "@/chain200.toml"]
    got, want = _both(inputs, capsys, argv, jax_extra=("--engine", "numpy"))
    assert got == want
    assert got[1][0] == f"cost: {expected}"


# ---------------------------------------------------------------- the device

@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_align_without_a_card_fails_before_any_work(device, inputs, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = inputs / f"nocard_{device}.toml"
    argv = ["align", "-p", str(inputs / "plain.fa"), "-o", str(out)]
    if device:
        argv += ["--device", device]
    with pytest.raises(SystemExit) as e:
        port_cli.main(argv)
    assert e.value.code != 0 and "CUDA" in str(e.value.code)
    assert not out.exists()
    assert capsys.readouterr().out == ""


def test_cli_defaults_to_cuda_and_the_device_engine():
    args = port_cli.build_parser().parse_args(["align", "-p", "x.fa"])
    assert (args.device, args.engine) == ("cuda", "auto")
    assert port_cli._engine(args) == "device"
    with pytest.raises(SystemExit):
        port_cli.build_parser().parse_args(["align", "-p", "x.fa", "--engine", "jax"])


def test_profile_writes_a_chrome_trace(inputs, capsys):
    prof = inputs / "profile"
    rc, printed, _ = _run(port_cli, ["align", "-p", str(inputs / "plain.fa"), "--no-ts",
                                     "--device", "cpu", "--profile", str(prof)], capsys)
    assert rc == 0 and printed[0].startswith("cost: ")
    traces = [p for p in prof.iterdir() if p.name.endswith(".pt.trace.json")]
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
