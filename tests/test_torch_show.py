"""The port's ``show/`` package against the JAX package's on the CPU, with
exact equality.

Records with template switches: the JAX numpy engine's 30 bp record of
tests/test_show.py and the port's CPU record of the 60 bp fixture pair
(``tests/fixtures/torch_port_pairs.json``), each with a no-TS record of the
same pair, and a record without a target.  Each record's TOML is read by both
packages' ``AlignmentResult.from_toml`` and rendered by both: the parsed
template switches, ``show_template_switches`` with and without the no-TS
record, ``create_ts_svg`` for each combination of ``arrows``, ``context``,
``complements`` and ``equal_cost_ranges``, ``build_plan``,
``create_error_svg``, the PNG bytes of ``render_png`` (with Pillow), and the
command line's ``show``.  The port's ``viz_template_switches()`` prints what
the JAX facade's prints.
"""

import io
import itertools
import json
import os
import xml.dom.minidom

import numpy as np
import pytest

import tsalign_tpu
import tsalign_tpu_torch
from tsalign_tpu import cli as jax_cli
from tsalign_tpu import result as jax_result
from tsalign_tpu.aligner import Aligner as JaxFacade
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu.show import parse_template_switches as jax_parse
from tsalign_tpu.show import plain_text as jax_text
from tsalign_tpu.show import svg as jax_svg
from tsalign_tpu_torch import cli as port_cli
from tsalign_tpu_torch import result as port_result
from tsalign_tpu_torch.show import parse_template_switches as port_parse
from tsalign_tpu_torch.show import plain_text as port_text
from tsalign_tpu_torch.show import svg as port_svg

from torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = ["jax_numpy_30", "port_cpu_60"]


def _pair_30():
    """The 30 bp pair of tests/test_show.py: one reverse template switch."""
    al = get_alphabet("dna-n")
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, size=30).astype(np.int8)
    qry = ref.copy()
    comp = al.complement_array()
    qry[10:20] = [comp[c] for c in qry[10:20]][::-1]
    return al.decode(ref), al.decode(qry)


@pytest.fixture(scope="module")
def records():
    """name -> (TOML of the record, TOML of the no-TS record of its pair)."""
    cfg = TemplateSwitchConfig.default(get_alphabet("dna-n"))
    r30, q30 = _pair_30()
    with open(os.path.join(ROOT, "tests", "fixtures", "torch_port_pairs.json")) as f:
        p = json.load(f)["pairs"][0]
    assert len(p["reference"]) == 60
    out = {
        "jax_numpy_30": (JaxFacade(costs=cfg, engine="numpy").align(r30, q30),
                         JaxFacade(costs=cfg, engine="numpy", no_ts=True).align(r30, q30)),
        "port_cpu_60": (tsalign_tpu_torch.align(p["reference"], p["query"], device="cpu"),
                        tsalign_tpu_torch.align(p["reference"], p["query"], device="cpu",
                                                no_ts=True)),
        "no_target": (JaxFacade(costs=cfg, engine="numpy").align(r30, q30, cost_limit=1), None),
    }
    for name in RECORDS:
        assert out[name][0].stats()["template_switch_amount"] >= 1, name
    assert not out["no_target"][0].has_target()
    return {k: (a.to_toml(), b.to_toml() if b else None) for k, (a, b) in out.items()}


def _read(records, name, with_no_ts=False):
    """The record (and its no-TS record or None) as each package reads it:
    {"jax": (result, no_ts), "port": (result, no_ts)}."""
    text, no_ts = records[name]
    out = {}
    for pkg, mod in (("jax", jax_result), ("port", port_result)):
        nt = mod.AlignmentResult.from_toml(no_ts) if with_no_ts and no_ts else None
        out[pkg] = (mod.AlignmentResult.from_toml(text), nt)
    return out


@pytest.mark.parametrize("name", RECORDS)
def test_parsed_template_switches_are_equal(name, records):
    r = _read(records, name)
    got, want = port_parse.parse(r["port"][0]), jax_parse.parse(r["jax"][0])
    assert len(got) >= 1
    assert repr(got) == repr(want)


@pytest.mark.parametrize("with_no_ts", [False, True])
@pytest.mark.parametrize("name", RECORDS + ["no_target"])
def test_plain_text_is_equal(name, with_no_ts, records):
    r = _read(records, name, with_no_ts)
    texts = []
    for pkg, mod in (("port", port_text), ("jax", jax_text)):
        out = io.StringIO()
        mod.show_template_switches(out, *r[pkg])
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    if name != "no_target":
        assert "Showing template switch 1" in texts[0]
        assert ("No-ts CIGAR" in texts[0]) == with_no_ts


FLAGS = list(itertools.product([False, True], [None, 3], [False, True], [False, True]))


@pytest.mark.parametrize("arrows,context,complements,equal_cost_ranges", FLAGS)
@pytest.mark.parametrize("name", RECORDS)
def test_svg_is_equal(name, arrows, context, complements, equal_cost_ranges, records):
    r = _read(records, name)
    kw = dict(arrows=arrows, context=context, complements=complements,
              equal_cost_ranges=equal_cost_ranges)
    got = port_svg.create_ts_svg(r["port"][0], **kw)
    assert got == jax_svg.create_ts_svg(r["jax"][0], **kw)
    assert xml.dom.minidom.parseString(got).documentElement.tagName == "svg"


@pytest.mark.parametrize("name", RECORDS + ["no_target"])
def test_svg_with_the_no_ts_record_is_equal(name, records):
    r = _read(records, name, with_no_ts=True)
    kw = dict(arrows=True, complements=True, equal_cost_ranges=True)
    got = port_svg.create_ts_svg(*r["port"], **kw)
    assert got == jax_svg.create_ts_svg(*r["jax"], **kw)
    xml.dom.minidom.parseString(got)


@pytest.mark.parametrize("kw", [{}, dict(arrows=False, context=2, complements=True,
                                         equal_cost_ranges=True)])
@pytest.mark.parametrize("name", RECORDS)
def test_render_plan_is_equal(name, kw, records):
    r = _read(records, name, with_no_ts=True)
    got, want = port_svg.build_plan(*r["port"], **kw), jax_svg.build_plan(*r["jax"], **kw)
    assert got.runs and repr(got) == repr(want)


@pytest.mark.parametrize("message", ["boom & <bust>", "alignment has no target", ""])
def test_error_svg_is_equal(message):
    got = port_svg.create_error_svg(message)
    assert got == jax_svg.create_error_svg(message)
    xml.dom.minidom.parseString(got)


@pytest.mark.parametrize("zoom", [1.0, 2.0])
@pytest.mark.parametrize("name", RECORDS)
def test_png_is_equal(name, zoom, records, tmp_path):
    pytest.importorskip("PIL")
    from tsalign_tpu.show.png import render_png as jax_png
    from tsalign_tpu_torch.show.png import render_png as port_png

    r = _read(records, name, with_no_ts=True)
    kw = dict(arrows=True, complements=True, equal_cost_ranges=True)
    port_png(port_svg.build_plan(*r["port"], **kw), str(tmp_path / "port.png"), zoom=zoom)
    jax_png(jax_svg.build_plan(*r["jax"], **kw), str(tmp_path / "jax.png"), zoom=zoom)
    got = (tmp_path / "port.png").read_bytes()
    assert got.startswith(b"\x89PNG") and got == (tmp_path / "jax.png").read_bytes()


def _show(cli, argv, capsys):
    capsys.readouterr()
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("png", [False, True])
@pytest.mark.parametrize("name", RECORDS)
def test_show_command_is_equal(name, png, records, tmp_path, capsys):
    if png:
        pytest.importorskip("PIL")
    text, no_ts = records[name]
    (tmp_path / "rec.toml").write_text(text)
    (tmp_path / "nots.toml").write_text(no_ts)
    outputs = {}
    for pkg, cli in (("port", port_cli), ("jax", jax_cli)):
        argv = ["show", "-i", str(tmp_path / "rec.toml"), "-n", str(tmp_path / "nots.toml"),
                "-s", str(tmp_path / f"{pkg}.svg"), "-a", "-c", "-e", "-z", "4"]
        if png:
            argv += ["-p", str(tmp_path / f"{pkg}.png"), "--png-zoom", "1.5"]
        rc, printed = _show(cli, argv, capsys)
        files = [(tmp_path / f"{pkg}.{ext}").read_bytes() for ext in ("svg", "png")[:1 + png]]
        outputs[pkg] = (rc, printed, files)
    assert outputs["port"] == outputs["jax"]
    assert outputs["port"][0] == 0 and "Showing template switch 1" in outputs["port"][1]


def test_viz_template_switches_prints_what_the_jax_facade_prints(capsys):
    r, q = _pair_30()
    tsalign_tpu_torch.align(r, q, device="cpu").viz_template_switches()
    got = capsys.readouterr().out
    tsalign_tpu.align(r, q, engine="numpy").viz_template_switches()
    assert got == capsys.readouterr().out
    assert "Showing template switch 1" in got
