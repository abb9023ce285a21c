"""The port's static-analysis subsystem (``repro_torch.analysis``): each lint
rule's positive and negative cases (the reference's ``tests/test_analysis.py``
with torch idioms), parse errors, fingerprints, the baseline's
justification and staleness, the round-entry auditor against a synthetic
violation of each invariant and a clean function, every program cell clean
on the CPU and at its checked-in ``@cpu`` budget row, each cell's fetch
leaves against the reference's ``programs.expected_counts`` (from
``jax.eval_shape``), the CLI gate's exit code, and the port's tree linting
clean against its baseline."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from _torch_threads import one_thread  # noqa: F401
from torch import nn

from repro_torch.analysis.findings import Baseline, Report, assign_fingerprints, make_finding
from repro_torch.analysis.lints import lint_file, run_lints
from repro_torch.analysis.program_audit import audit_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# lint-rule fixtures
# ---------------------------------------------------------------------------

def lint_source(tmp_path, source, relpath="src/repro_torch/somefile.py"):
    """Write ``source`` at ``relpath`` under a synthetic repo root and lint
    that one file."""
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return lint_file(str(tmp_path), str(path))


def rules_of(findings):
    return sorted(f.rule for f in findings)


def test_hidden_host_sync_positive(tmp_path):
    findings = lint_source(tmp_path, """
        import numpy as np

        def f(x):
            a = float(x)
            b = x.item()
            c = np.asarray(x)
            d = x.cpu()
            e = x.tolist()
            g = int(x.sum())
            return a, b, c, d, e, g
        """, relpath="src/repro_torch/core/engine.py")
    assert rules_of(findings) == ["hidden-host-sync"] * 6


def test_hidden_host_sync_negative(tmp_path):
    # the whitelisted unpack helper and the fetched values are host values;
    # tensor metadata is too; other files are out of the rule's scope
    source = """
        import numpy as np
        from repro_torch.selection import unpack_fetch

        def f(stacked, x):
            vec = unpack_fetch(stacked.cpu().numpy(), 2)
            n = int(x.shape[0]) + x.numel()
            return [float(v) for v in vec], n
        """
    in_scope = lint_source(tmp_path, source, relpath="src/repro_torch/core/runner.py")
    # the .cpu() fetch itself is flagged (baseline territory), once
    assert rules_of(in_scope) == ["hidden-host-sync"]
    assert ".cpu()" in in_scope[0].message
    out_of_scope = lint_source(tmp_path, """
        def f(x):
            return float(x), x.item()
        """, relpath="src/repro_torch/launch/other.py")
    assert out_of_scope == []


def test_hidden_host_sync_follows_fetched_values(tmp_path):
    findings = lint_source(tmp_path, """
        import torch

        def f(vl, sels):
            fetched = torch.cat([vl, sels]).cpu().numpy()
            sels = fetched[2:].reshape(3).astype(int)
            return [int(s) for s in sels], sels.tolist()
        """, relpath="src/repro_torch/core/engine.py")
    assert len(findings) == 1 and findings[0].line == 5


def test_wall_clock_positive_and_exemption(tmp_path):
    source = """
        import time

        def f():
            return time.time()
        """
    assert rules_of(lint_source(tmp_path, source)) == ["wall-clock"]
    assert lint_source(tmp_path, source,
                       relpath="src/repro_torch/telemetry/provenance.py") == []


def test_wall_clock_negative_perf_counter(tmp_path):
    assert lint_source(tmp_path, """
        import time

        def f():
            return time.perf_counter()
        """) == []


def test_unseeded_np_random_positive(tmp_path):
    findings = lint_source(tmp_path, """
        import numpy as np

        NOISE = np.random.randn(4)
        """)
    assert rules_of(findings) == ["unseeded-np-random"]


def test_unseeded_np_random_negative(tmp_path):
    assert lint_source(tmp_path, """
        import numpy as np

        rng = np.random.default_rng(0)
        NOISE = rng.normal(size=4)

        def f():
            return np.random.rand()  # function scope: not a module-load draw
        """) == []


def test_unseeded_torch_random_positive(tmp_path):
    findings = lint_source(tmp_path, """
        import torch
        from torch import nn

        def f(x, w):
            a = torch.randn(3)
            b = torch.rand(2, 2, device=x.device)
            c = torch.randperm(5)
            d = torch.bernoulli(x)
            x.normal_()
            nn.init.normal_(w)
            return a, b, c, d, torch.randint(0, 4, (2,))
        """)
    assert rules_of(findings) == ["unseeded-torch-random"] * 7


def test_unseeded_torch_random_negative(tmp_path):
    assert lint_source(tmp_path, """
        import torch
        from torch import nn

        def f(x, w, gen):
            a = torch.randn(3, generator=gen)
            b = torch.randperm(5, generator=gen)
            x.normal_(generator=gen)
            nn.init.normal_(w, generator=gen)
            gain = nn.init.calculate_gain("relu")
            return a, b, torch.zeros(3), gain, torch.manual_seed
        """) == []


def test_mutable_default_arg_positive(tmp_path):
    findings = lint_source(tmp_path, """
        def f(x, acc=[]):
            acc.append(x)
            return acc

        def g(x, table={}):
            return table
        """)
    assert rules_of(findings) == ["mutable-default-arg"] * 2


def test_mutable_default_arg_negative(tmp_path):
    assert lint_source(tmp_path, """
        def f(x, acc=None, n=3, name="x"):
            acc = [] if acc is None else acc
            return acc
        """) == []


def test_parse_error_is_a_finding(tmp_path):
    assert rules_of(lint_source(tmp_path, "def broken(:\n")) == ["parse-error"]


# ---------------------------------------------------------------------------
# findings engine: fingerprints + baseline
# ---------------------------------------------------------------------------

def test_fingerprint_survives_line_shift(tmp_path):
    body = """
        import time

        def f():
            return time.time()
        """
    a = lint_source(tmp_path, body, relpath="src/repro_torch/a.py")
    shifted = "# one\n# two\n# three\n" + textwrap.dedent(body)
    b = lint_source(tmp_path, shifted, relpath="src/repro_torch/a.py")
    a, b = assign_fingerprints(a), assign_fingerprints(b)
    assert a[0].line != b[0].line
    assert a[0].fingerprint == b[0].fingerprint


def test_duplicate_context_lines_get_distinct_fingerprints(tmp_path):
    findings = assign_fingerprints(lint_source(tmp_path, """
        import time

        def f():
            return time.time()

        def g():
            return time.time()
        """))
    assert len(findings) == 2
    assert findings[0].fingerprint != findings[1].fingerprint


def test_baseline_roundtrip_and_justification_enforcement(tmp_path):
    f1 = make_finding("wall-clock", "error", "src/repro_torch/a.py", 4, "msg",
                      context="return time.time()")
    f2 = make_finding("wall-clock", "error", "src/repro_torch/b.py", 9, "msg",
                      context="return time.time()")
    path = str(tmp_path / "lint_baseline.json")
    base = Baseline(path=path)
    base.add(f1, "intentional: wall-clock stamp for the run manifest")
    base.save()
    loaded = Baseline.load(path)
    assert loaded.suppresses(f1) and not loaded.suppresses(f2)
    report = Report(findings=[f1, f2], baseline=loaded)
    assert [f.fingerprint for f in report.open_findings] == [f2.fingerprint]
    # stripping the justification turns the suppression itself into a finding
    doc = json.load(open(path))
    doc["suppressions"][0]["justification"] = ""
    json.dump(doc, open(path, "w"))
    report = Report(findings=[f1, f2], baseline=Baseline.load(path))
    assert sorted(f.rule for f in report.open_findings) == ["unjustified-suppression",
                                                            "wall-clock"]


def test_baseline_stale_detection(tmp_path):
    f1 = make_finding("wall-clock", "error", "src/repro_torch/gone.py", 1, "msg",
                      context="time.time()")
    base = Baseline(path=str(tmp_path / "b.json"))
    base.add(f1, "why")
    assert base.stale([]) and base.stale([f1]) == []


def test_port_tree_lints_clean():
    """The port's tree against its checked-in baseline: no open finding, no
    stale suppression, every suppression justified."""
    from repro_torch.analysis.cli import LINT_BASELINE
    findings = run_lints(ROOT)
    report = Report(findings=findings, baseline=Baseline.load(os.path.join(ROOT, LINT_BASELINE)))
    assert report.open_findings == []
    assert report.to_dict()["stale_suppressions"] == []
    assert all(f.path.startswith("src/repro_torch/") for f in findings)


# ---------------------------------------------------------------------------
# the auditor: synthetic violations of each invariant
# ---------------------------------------------------------------------------

def _carry():
    return (nn.Linear(3, 2), nn.Linear(2, 1))


def test_audit_clean_function_passes():
    def clean(theta, x):
        with torch.no_grad():
            for p in theta[0].parameters():
                p.add_(x.mean())
        return theta, torch.stack([x.sum(), x.max()])

    audit = audit_fn(clean, (_carry(), torch.arange(4.0)), name="t/clean",
                     carry_argnums=(0,), expected_fetch_leaves=1)
    assert audit.findings == []
    assert audit.carry_leaves == audit.carried_in_place == 4
    assert audit.fetch_leaves == 1 and audit.transfers == {}


def test_audit_flags_float64():
    def leaky(x):
        return x + torch.arange(x.shape[0], dtype=torch.float64)

    audit = audit_fn(leaky, (torch.arange(4.0),), name="t/f64", expected_fetch_leaves=1)
    assert [f.rule for f in audit.findings] == ["f64-in-program"]


@pytest.mark.parametrize("read", ["item", "float", "tolist", "cpu", "nonzero", "bool_index"])
def test_audit_flags_host_read(read):
    def chatty(x):
        if read == "item":
            return x * x.sum().item()
        if read == "float":
            return x * float(x.max())
        if read == "tolist":
            return x + len(x.tolist())
        if read == "cpu":
            return x * x.sum().cpu()
        if read == "nonzero":
            return torch.nonzero(x > 1)
        return x[x > 1]

    audit = audit_fn(chatty, (torch.arange(4.0),), name=f"t/{read}", expected_fetch_leaves=1)
    assert [f.rule for f in audit.findings] == ["host-transfer-in-program"], audit.findings
    assert sum(audit.transfers.values()) == 1


def test_audit_flags_carry_returned_as_copy():
    def copied(theta, x):
        out = tuple(nn.Linear(m.in_features, m.out_features) for m in theta)
        return out, x.sum()

    audit = audit_fn(copied, (_carry(), torch.arange(4.0)), name="t/copy",
                     carry_argnums=(0,), expected_fetch_leaves=1)
    assert [f.rule for f in audit.findings] == ["carry-not-in-place"]
    assert audit.carried_in_place == 0


def test_audit_flags_extra_fetch():
    def update(theta, x):
        # two non-carry outputs where the contract pins one
        return theta, x.sum(), x.max()

    audit = audit_fn(update, (_carry(), torch.arange(4.0)), name="t/extra",
                     carry_argnums=(0,), expected_fetch_leaves=1)
    assert [f.rule for f in audit.findings] == ["fetch-contract"]
    assert audit.fetch_leaves == 2


# ---------------------------------------------------------------------------
# the program cells
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_ctx():
    from repro_torch.analysis.programs import build_context
    return build_context("cpu")


@pytest.fixture(scope="module")
def pinned_programs():
    from repro_torch.analysis.budgets import PROGRAMS_FILE, budget_path, load_budget
    return load_budget(budget_path(ROOT, PROGRAMS_FILE))


def _cell_names():
    from repro_torch.analysis.programs import CELLS
    return [c.name for c in CELLS]


@pytest.mark.parametrize("name", _cell_names())
def test_program_cell_audits_clean_on_cpu(port_ctx, pinned_programs, name):
    from repro_torch.analysis.budgets import cell_key, compare_budget, measure_program_budgets
    from repro_torch.analysis.budgets import PROGRAMS_FILE, budget_path
    from repro_torch.analysis.programs import select_cells
    rows, findings = measure_program_budgets(port_ctx, select_cells(names=(name,)))
    assert findings == []
    row = rows[cell_key(name, "cpu")]
    assert row["host_transfers"] == 0 and row["carried_in_place"] == row["carry_leaves"]
    assert pinned_programs["meta"]["cpu"]["torch"]
    fs, _ = compare_budget(budget_path(ROOT, PROGRAMS_FILE), rows, "program-budget", "cpu")
    assert [f.message for f in fs if f.severity == "error"] == []


def test_sharded_cells_over_two_ranks_match_their_pinned_rows():
    """The sharded cells audited over two spawned gloo ranks (keyed
    ``@d2``, the reference's device-count suffix) audit clean, hold each
    rank's half of the clusters, and equal their pinned CPU rows, beside
    the ``@d1`` rows of a group of one."""
    from repro_torch.analysis.budgets import (PROGRAMS_FILE, budget_path, cell_key,
                                              compare_budget, load_budget,
                                              measure_sharded_ranks)
    from repro_torch.analysis.programs import SHARDED_CELLS
    rows, findings = measure_sharded_ranks(list(SHARDED_CELLS), "cpu", 2)
    assert findings == []
    assert set(rows) == {cell_key(n, "cpu", 2) for n in SHARDED_CELLS}
    assert all(k.endswith("@d2@cpu") for k in rows)
    pinned = load_budget(budget_path(ROOT, PROGRAMS_FILE))["cells"]
    for name in SHARDED_CELLS:
        assert cell_key(name, "cpu") == f"{name}@d1@cpu" and cell_key(name, "cpu") in pinned
        assert rows[cell_key(name, "cpu", 2)]["host_transfers"] == 0
    fs, _ = compare_budget(budget_path(ROOT, PROGRAMS_FILE), rows, "program-budget", "cpu")
    assert [f.message for f in fs if f.severity == "error"] == []


@pytest.fixture(scope="module")
def reference_ctx():
    """The reference's tiny context with its arrays abstract
    (``jax.eval_shape`` of ``build_context``): ``expected_counts`` reads
    only shapes, and nothing compiles."""
    import jax

    from repro.analysis import programs as rp
    static_fields = ("module", "data", "pcfg", "tm")
    static = {}

    def arrays():
        ctx = rp.build_context()
        static.update({f: getattr(ctx, f) for f in static_fields})
        return {f.name: getattr(ctx, f.name) for f in dataclasses.fields(rp.TinyContext)
                if f.name not in static_fields}

    shapes = jax.eval_shape(arrays)
    # the trace filled the reference's AttackVec memo with tracers: drop
    # them, or a later reference run in this process (another test file on
    # the same worker) reads a leaked tracer
    from repro.adversary.registry import _attack_vec_grid_cached
    _attack_vec_grid_cached.cache_clear()
    return rp, rp.TinyContext(**static, **shapes)


@pytest.mark.parametrize("name", _cell_names())
def test_fetch_leaves_match_reference(port_ctx, reference_ctx, name):
    from repro_torch.analysis.programs import CELLS, REFERENCE_NAMES
    rp, rctx = reference_ctx
    ref_cell = next(c for c in rp.CELLS if c.name == REFERENCE_NAMES[name])
    _, (fn, args, donate) = ref_cell.realize(rctx)
    _, want = rp.expected_counts(fn, args, donate)
    cell = next(c for c in CELLS if c.name == name)
    assert cell.fetch_leaves(port_ctx) == want


def test_sharded_cells_name_their_slice():
    """The reference's sharded cells are the port's, real cells each (run
    in-process as a group of one rank, audited above)."""
    from repro.analysis import programs as rp

    from repro_torch.analysis.programs import CELLS, SHARDED_CELLS
    assert set(SHARDED_CELLS) == {c.name for c in rp.CELLS if c.placement == "sharded"}
    assert set(SHARDED_CELLS) == {c.name for c in CELLS if c.placement == "sharded"}


# ---------------------------------------------------------------------------
# budget baselines and the CLI gate
# ---------------------------------------------------------------------------

def test_budget_roundtrip_mismatch_and_version(tmp_path):
    from repro_torch.analysis.budgets import compare_budget, load_budget, merge_budget
    path = str(tmp_path / "programs.json")
    measured = {"pigeon/accept@batched@cpu": {"aten_ops": 100, "fetch_leaves": 1}}
    findings, _ = compare_budget(path, measured, "program-budget", "cpu")
    assert [f.rule for f in findings] == ["program-budget-baseline-missing"]
    merge_budget(path, measured, "cpu")
    findings, notes = compare_budget(path, measured, "program-budget", "cpu")
    assert findings == [] and notes == []
    drifted = {"pigeon/accept@batched@cpu": {"aten_ops": 100, "fetch_leaves": 2}}
    findings, _ = compare_budget(path, drifted, "program-budget", "cpu")
    assert [f.rule for f in findings] == ["program-budget-mismatch"]
    assert findings[0].severity == "error" and "fetch_leaves: 1 -> 2" in findings[0].message
    # another device's rows survive a merge
    merge_budget(path, {"pigeon/accept@batched@cuda": {"aten_ops": 9}}, "cpu")
    assert set(load_budget(path)["cells"]) == {"pigeon/accept@batched@cpu",
                                               "pigeon/accept@batched@cuda"}
    doc = json.load(open(path))
    doc["meta"]["cpu"]["torch"] = "0.0.0"
    json.dump(doc, open(path, "w"))
    findings, notes = compare_budget(path, drifted, "program-budget", "cpu")
    assert findings and findings[0].severity == "warning" and "0.0.0" in notes[0]


def test_checked_in_budgets_cover_every_cell():
    from repro_torch.analysis.budgets import (COMPILES_FILE, DRIVER_CELLS, PROGRAMS_FILE,
                                              budget_path, cell_key, load_budget)
    compiles = load_budget(budget_path(ROOT, COMPILES_FILE))["cells"]
    for name, _ in DRIVER_CELLS:
        row = compiles[f"{name}@cpu"]
        if name.endswith("-again"):
            assert row["library_builds"] == 0
    programs = load_budget(budget_path(ROOT, PROGRAMS_FILE))["cells"]
    for name in _cell_names():
        assert programs[cell_key(name, "cpu")]["host_transfers"] == 0


def test_cli_check_exits_zero_on_cpu(tmp_path):
    out = tmp_path / "findings.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--check", "--device",
                        "cpu", "--json", str(out)], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.load(open(out))
    assert doc["open"] == [] and doc["provenance"]["tool"] == "repro_torch.analysis"
    assert "0 open finding(s)" in r.stdout
