"""The port stands on its own: no import of the JAX package or of JAX.

  * no module of ``tsalign_tpu_torch``, not ``chip_smoke.py`` and not the
    cases it shares with the tests (``tests/torch_cases.py``) imports
    ``tsalign_tpu`` or ``jax`` (walked with ``ast``);
  * the port's root has every name of ``tsalign_tpu.__all__`` and
    ``TSPairwiseAlignment``, from its own modules, without importing torch;
  * in a subprocess where both imports fail, the port aligns under the
    default and the flanked default configuration, aligns a batch, and runs
    chained mode with its anchors from the port's own ``csrc/anchors.cpp``,
    and its command line aligns a pair on the CPU and renders the record
    with ``show``;
  * ``convert.config_from_reference`` carries every table, cost function,
    base cost and flank length across, also under the K-scaled tie-break;
  * a config whose magnitudes overflow the int32 algebra aligns through the
    port's numpy engine and equals the JAX facade's record;
  * the port's copies of the oracle, the pricing and the remaining-cost bound
    give the JAX package's values.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import tsalign_tpu_torch
from tsalign_tpu import lower_bounds as ref_lower_bounds
from tsalign_tpu import oracle as ref_oracle
from tsalign_tpu import pricing as ref_pricing
from tsalign_tpu.aligner import Aligner as JaxFacade
from tsalign_tpu.alphabet import get_alphabet
from tsalign_tpu.config import TemplateSwitchConfig
from tsalign_tpu_torch import lower_bounds, oracle, pricing
from tsalign_tpu_torch.convert import config_from_reference, range_from_reference
from tsalign_tpu_torch.engine import TorchAligner
from tsalign_tpu_torch.result import AlignmentResult

from torch_util import cost_and_ts_length, one_torch_thread, reference_optimum  # noqa: F401
from util import random_config, random_pair, related_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tsalign_tpu_torch")
TABLES = ("primary_edit_costs", "secondary_forward_edit_costs", "secondary_reverse_edit_costs",
          "left_flank_edit_costs", "right_flank_edit_costs")
FUNCTIONS = ("rq_qr_offset_costs", "rr_qq_offset_costs", "length_costs",
             "length_difference_costs", "forward_anti_primary_gap_costs",
             "reverse_anti_primary_gap_costs")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "torch_port_chain_probe.py"),
           os.path.join(ROOT, "tests", "torch_cases.py")]
    for folder, _, names in os.walk(PORT):
        out += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    """Top-level names of every absolute import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_are_found():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {"chip_smoke.py", "tsalign_tpu_torch/aligner.py", "tsalign_tpu_torch/ops/sweep.py",
            "tsalign_tpu_torch/numpy_engine.py", "tsalign_tpu_torch/oracle.py",
            "tsalign_tpu_torch/parallel/__init__.py",
            "tsalign_tpu_torch/parallel/batch_ts.py",
            "tsalign_tpu_torch/parallel/fused_rounds.py",
            "tsalign_tpu_torch/parallel/mesh.py",
            "tsalign_tpu_torch/parallel/batch.py",
            "tsalign_tpu_torch/parallel/sp_sweep.py",
            "tsalign_tpu_torch/parallel/sp_reentry.py",
            "scripts/torch_port_chain_probe.py", "tests/torch_cases.py"} | {
                f"tsalign_tpu_torch/chain/{m}.py"
                for m in ("__init__", "plan", "anchors", "native", "chain", "driver")} | {
                f"tsalign_tpu_torch/show/{m}.py"
                for m in ("__init__", "renderer", "parse_template_switches", "plain_text",
                          "arrangement", "svg", "png")} | {
                "tsalign_tpu_torch/cli.py", "tsalign_tpu_torch/fasta.py"} <= names


def test_root_has_the_jax_packages_public_names_with_both_packages_blocked():
    """Every name of ``tsalign_tpu.__all__`` and ``TSPairwiseAlignment``
    resolves on the port's root, from the port's own modules, and importing
    the root imports no torch."""
    import tsalign_tpu

    names = list(tsalign_tpu.__all__) + ["TSPairwiseAlignment"]
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tsalign_tpu'] = None\n"
        "import tsalign_tpu_torch\n"
        "assert 'torch' not in sys.modules\n"
        f"for name in {names!r}:\n"
        "    obj = getattr(tsalign_tpu_torch, name)\n"
        "    mod = getattr(obj, '__module__', None) or 'tsalign_tpu_torch'\n"
        "    assert mod.startswith('tsalign_tpu_torch'), (name, mod)\n"
        "assert set(tsalign_tpu_torch.__all__) >= set(" + repr(list(tsalign_tpu.__all__)) + ")\n"
        "print(tsalign_tpu_torch.INF)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == tsalign_tpu.INF


def test_batched_engine_runs_with_both_packages_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tsalign_tpu'] = None\n"
        "import tsalign_tpu_torch\n"
        "from tsalign_tpu_torch.alphabet import get_alphabet\n"
        "from tsalign_tpu_torch.config import TemplateSwitchConfig\n"
        "cfg = TemplateSwitchConfig.default(get_alphabet('dna-n'))\n"
        "recs = tsalign_tpu_torch.align_pairs(cfg, [('ACGTTGCAAGCTTGACCATGGCA', "
        "'ACGTTGCATTGCAAGTTGACCATGGCA'), ('ACGTACGTTTGCA', 'ACGTACGATTGCA')], device='cpu')\n"
        "assert all(r.has_target for r in recs)\n"
        "assert not any(m.split('.')[0] in ('jax', 'tsalign_tpu') for m, v in "
        "sys.modules.items() if v is not None)\n"
        "print(*[r.result.cost for r in recs])\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert all(float(c) >= 0 for c in out.stdout.split())


def test_fused_rounds_loop_runs_with_both_packages_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tsalign_tpu'] = None\n"
        "from tsalign_tpu_torch.alphabet import get_alphabet\n"
        "from tsalign_tpu_torch.config import TemplateSwitchConfig\n"
        "from tsalign_tpu_torch.engine import TorchAligner\n"
        "from tsalign_tpu_torch import tracing\n"
        "al = get_alphabet('dna-n')\n"
        "cfg = TemplateSwitchConfig.default(al)\n"
        "eng = TorchAligner(cfg, al.encode('ACGTTGCAAGCTTGACCATGGCA'), "
        "al.encode('ACGTTGCATTGCAAGTTGACCATGGCA'), device='cpu', fused=True)\n"
        "tracing.enable()\n"
        "cost, aln = eng.align_with_traceback()\n"
        "spans, _ = tracing.take()\n"
        "assert eng.loop == 'fused' and any(s[0] == 'device.read' and 'round' in s[5] "
        "for s in spans)\n"
        "assert not any(m.split('.')[0] in ('jax', 'tsalign_tpu') for m, v in "
        "sys.modules.items() if v is not None)\n"
        "print(cost)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 0


def test_mesh_paths_run_with_both_packages_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tsalign_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import tsalign_tpu_torch\n"
        "from tsalign_tpu_torch.alphabet import get_alphabet\n"
        "from tsalign_tpu_torch.config import TemplateSwitchConfig\n"
        "from tsalign_tpu_torch.ops.primary import PrimarySweep\n"
        "from tsalign_tpu_torch.parallel.batch import BatchedGapAffine, encode_batch\n"
        "from tsalign_tpu_torch.parallel.mesh import Mesh\n"
        "from tsalign_tpu_torch.parallel.sp_sweep import sp_sweep_flankless\n"
        "al = get_alphabet('dna-n')\n"
        "cfg = TemplateSwitchConfig.default(al)\n"
        "r, q = 'ACGTTGCAAGCTTGACCATGGCA', 'ACGTTGCATTGCAAGTTGACCATGGCA'\n"
        "mesh = Mesh(['cpu'] * 2, ('data',))\n"
        "costs, mean = BatchedGapAffine(cfg, device='cpu').sharded_step(\n"
        "    mesh, encode_batch(al, [r, q]), encode_batch(al, [q, r]))\n"
        "sweep = PrimarySweep(cfg, al.encode(r), al.encode(q))\n"
        "seeds = torch.full((1, 3, len(r) + 1, len(q) + 1), 2**30 - 1, dtype=torch.int32)\n"
        "seeds[0, 0, 0, 0] = 0\n"
        "M = sp_sweep_flankless(sweep, seeds[0], Mesh(['cpu'] * 3, ('sp',)))\n"
        "assert torch.equal(M, sweep.sweep(seeds)[0])\n"
        "recs = tsalign_tpu_torch.align_pairs(cfg, [(r, q), (q, r)], device='cpu', mesh=mesh)\n"
        "assert not any(m.split('.')[0] in ('jax', 'tsalign_tpu') for m, v in "
        "sys.modules.items() if v is not None)\n"
        "print(*[int(c) for c in costs], *[x.result.cost for x in recs])\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    gap_affine, ts = map(list, np.split(np.array(out.stdout.split(), dtype=int), 2))
    assert gap_affine[0] == gap_affine[1] and ts[0] <= gap_affine[0]


def test_chained_mode_runs_with_both_packages_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tsalign_tpu'] = None\n"
        "import tsalign_tpu_torch\n"
        "from chip_smoke import chain_config, chain_construction\n"
        "from tsalign_tpu_torch.chain import native\n"
        "ref, qry, expected, planted = chain_construction(400, 5)\n"
        "res = tsalign_tpu_torch.chain_align(chain_config(), ref, qry, target_segment=128, "
        "device='cpu')\n"
        "assert res.anchors_native and res.numpy_fallbacks == 0\n"
        "lib = native._build_and_load()._name\n"
        "assert '/tsalign_tpu_torch/_build/libtsanchors-' in lib, lib\n"
        "assert not any(m.split('.')[0] in ('jax', 'tsalign_tpu') for m, v in "
        "sys.modules.items() if v is not None)\n"
        "print(res.cost, expected)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    cost, expected = map(int, out.stdout.split())
    assert cost == expected


def test_command_line_runs_with_both_packages_blocked(tmp_path):
    (tmp_path / "pair.fa").write_text(
        ">ref\nACGTTGCAAGCTTGACCATGGCA\n>qry\nACGTTGCATTGCAAGTTGACCATGGCA\n")
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tsalign_tpu'] = None\n"
        "from tsalign_tpu_torch.cli import main\n"
        "assert main(['align', '-p', 'pair.fa', '-o', 'rec.toml', '--device', 'cpu']) == 0\n"
        "assert main(['show', '-i', 'rec.toml', '-s', 'rec.svg', '-a', '-c', '-e']) == 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'tsalign_tpu') for m, v in "
        "sys.modules.items() if v is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("cost: 4\ncigar: 8=[TS")
    assert "Showing template switch 1" in out.stdout
    rec = AlignmentResult.from_toml((tmp_path / "rec.toml").read_text())
    ref, qry = "ACGTTGCAAGCTTGACCATGGCA", "ACGTTGCATTGCAAGTTGACCATGGCA"
    assert (rec.cost, rec.alignment.ts_total_length()) == reference_optimum(ref, qry) == (4, 12)
    assert (tmp_path / "rec.svg").read_text().startswith("<svg")


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT) for p in _port_sources()])
def test_port_module_imports_neither_package(path):
    assert not _imported_roots(os.path.join(ROOT, path)) & {"tsalign_tpu", "jax", "jaxlib"}


def test_port_aligns_with_both_packages_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tsalign_tpu'] = None\n"
        "import tsalign_tpu_torch\n"
        "from chip_smoke import flanked_default\n"
        "from tsalign_tpu_torch.alphabet import get_alphabet\n"
        "r, q = 'ACGTTGCAAGCTTGACCATGGCA', 'ACGTTGCATTGCAAGTTGACCATGGCA'\n"
        "res = tsalign_tpu_torch.align(r, q, device='cpu')\n"
        "cfg = flanked_default(get_alphabet('dna-n'))\n"
        "flanked = tsalign_tpu_torch.Aligner(costs=cfg, device='cpu').align(r, q)\n"
        "assert res.has_target() and flanked.has_target()\n"
        "assert not any(m.split('.')[0] in ('jax', 'tsalign_tpu') for m, v in "
        "sys.modules.items() if v is not None)\n"
        "print(res.stats()['cost'], flanked.stats()['cost'])\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    plain, flanked = map(float, out.stdout.strip().splitlines()[-1].split())
    assert 0 <= flanked <= plain  # the flank tables are the cheaper ones


def _assert_same_config(got, want):
    assert type(got).__module__.startswith("tsalign_tpu_torch.")
    assert got.alphabet.name == want.alphabet.name
    assert got.alphabet.letters == want.alphabet.letters
    assert tuple(got.alphabet.complement) == tuple(want.alphabet.complement)
    assert got.left_flank_length == want.left_flank_length
    assert got.right_flank_length == want.right_flank_length
    assert got.base_cost == want.base_cost
    assert got.secondary_length_bonus == want.secondary_length_bonus
    for name in TABLES:
        a, b = getattr(got, name), getattr(want, name)
        assert a.name == b.name
        for part in ("substitution", "gap_open", "gap_extend"):
            np.testing.assert_array_equal(getattr(a, part), getattr(b, part), err_msg=name)
    for name in FUNCTIONS:
        assert getattr(got, name).points == getattr(want, name).points, name
    assert got.display() == want.display()


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3, 4])
def test_config_from_reference_round_trip(seed):
    if seed is None:
        want = TemplateSwitchConfig.default(get_alphabet("dna-n"))
    else:
        want = random_config(np.random.default_rng(4100 + seed), get_alphabet("dna"), flanks=True)
    got = config_from_reference(want)
    _assert_same_config(got, want)
    _assert_same_config(got.scaled_for_length_tiebreak(64), want.scaled_for_length_tiebreak(64))
    # a copy, not a view of the source's arrays
    got.primary_edit_costs.gap_open[0] += 1
    assert got.primary_edit_costs.gap_open[0] == want.primary_edit_costs.gap_open[0] + 1


def test_range_from_reference():
    from tsalign_tpu.geometry import AlignmentRange

    got = range_from_reference(AlignmentRange(1, 2, 7, 9))
    assert type(got).__module__ == "tsalign_tpu_torch.geometry"
    assert (got.reference_offset, got.query_offset, got.reference_limit, got.query_limit) == (
        1, 2, 7, 9)
    assert range_from_reference(None) is None


def _record(res):
    return "\n".join(
        line for line in res.to_toml().splitlines()
        if not line.startswith(("duration_seconds", "runtime"))
    )


def test_overflow_falls_back_to_the_numpy_engine():
    """The device engine refuses the config; the facade's record is then the
    port's numpy engine's, with the plain reference's cost and total
    template-switch length (an rrf switch costing 2^28 is never taken).  The
    JAX package's record stops at one switch (its rounds loop stops at round
    2), so its cost alone is compared."""
    al = get_alphabet("dna-n")
    cfg = TemplateSwitchConfig.default(al)
    cfg.base_cost["rrf"] = 2**28
    r, q = "ACGTTGCAAGCTTGACCATGGCA", "ACGTTGCATTGCAAGTTGACCATGGCA"
    port_cfg = config_from_reference(cfg)
    with pytest.raises(OverflowError):
        TorchAligner(port_cfg, al.encode(r), al.encode(q), device="cpu")
    want = JaxFacade(costs=cfg, engine="jax").align(r, q)
    got = tsalign_tpu_torch.Aligner(costs=port_cfg, device="cpu").align(r, q)
    numpy = tsalign_tpu_torch.Aligner(costs=port_cfg, engine="numpy").align(r, q)
    assert got.has_target()
    assert _record(got) == _record(numpy)
    assert cost_and_ts_length(got) == reference_optimum(r, q, {"rrf": 2**28})
    assert got.stats()["cost"] == want.stats()["cost"]


def _small_case(seed, flanks):
    rng = np.random.default_rng(4200 + seed)
    al = get_alphabet("dna")
    cfg = random_config(rng, al, flanks=flanks)
    ref, qry = random_pair(rng, al, max_len=7, min_len=2)
    return cfg, config_from_reference(cfg), ref, qry


@pytest.mark.parametrize("seed", range(5))
def test_oracle_copy_matches(seed):
    cfg, port_cfg, ref, qry = _small_case(seed, flanks=seed % 2 == 1)
    want_cost, want_al = ref_oracle.OracleAligner(cfg, ref, qry).align()
    got_cost, got_al = oracle.OracleAligner(port_cfg, ref, qry).align()
    assert got_cost == want_cost
    assert got_al.cigar() == want_al.cigar()


@pytest.mark.parametrize("seed", range(5))
def test_pricing_copy_matches(seed):
    cfg, port_cfg, ref, qry = _small_case(10 + seed, flanks=seed % 2 == 0)
    cost, ref_alignment = ref_oracle.OracleAligner(cfg, ref, qry).align()
    _, port_alignment = oracle.OracleAligner(port_cfg, ref, qry).align()
    want = ref_pricing.price_alignment(cfg, ref, qry, ref_alignment)
    got = pricing.price_alignment(port_cfg, ref, qry, port_alignment)
    assert got == want == cost


@pytest.mark.parametrize("seed", range(5))
def test_lower_bounds_copy_matches(seed):
    rng = np.random.default_rng(4300 + seed)
    al = get_alphabet("dna")
    cfg = random_config(rng, al).scaled_for_length_tiebreak(64)
    ref, qry = related_pair(rng, al, max_len=14)
    want = ref_lower_bounds.compute_remaining_bound(cfg, ref, qry, len(ref), len(qry))
    got = lower_bounds.compute_remaining_bound(
        config_from_reference(cfg), ref, qry, len(ref), len(qry))
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got.B, want.B)
        np.testing.assert_array_equal(got.S, want.S)
