"""torchlint (hpc_patterns_tpu_torch.analysis): golden fixture findings,
suppression and engine semantics, the CLI and its gate over the live
port, the live tree's shared-memory rows and kernel ledgers, and the
runtime helpers on the CPU.

The corpus under ``tests/fixtures/analysis_torch/`` is the rule
catalog's executable form: one known-bad and one known-clean file per
rule (``.py`` for the Python families, ``.cu`` for the kernel family),
with expected findings marked line-exact by ``EXPECT: <rule>`` comments.
The live-tree pass runs once for the module, at one intra-op thread.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hpc_patterns_tpu_torch.analysis import __main__ as cli
from hpc_patterns_tpu_torch.analysis import (
    core,
    csource,
    cuda_rules,
    dispatch_critical,
    runtime,
    smem,
)
from hpc_patterns_tpu_torch.analysis.core import AnalysisConfig, ModuleInfo
from hpc_patterns_tpu_torch.harness import report as reportlib

FIXTURES = Path(__file__).parent / "fixtures" / "analysis_torch"
REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "hpc_patterns_tpu_torch"
CSRC = PACKAGE / "csrc"

_EXPECT_RE = re.compile(r"EXPECT:\s*([a-z\-]+(?:\s*,\s*[a-z\-]+)*)")

PORT_RULES = {
    # torchlint
    "inplace-alias", "host-sync-in-dispatch", "rebuild-hazard",
    "generator-reuse", "autograd-leak",
    # shardlint
    "collective-divergence", "collective-order", "unchecked-permutation",
    "spec-mismatch",
    # cudalint
    "mbar-balance", "ring-slot-reuse", "flag-balance", "smem-budget",
    # contractlint
    "gate-key-orphan", "record-kind-drift", "wire-field-compat",
    "track-band-collision", "chaos-site-drift",
}


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def live(one_thread):
    """The CLI's --ci over the live port, once: (exit code, stdout)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--ci"])
    return rc, buf.getvalue()


def _corpus_files():
    return sorted(p for p in FIXTURES.iterdir()
                  if p.suffix in (".py", ".cu"))


def _expected() -> dict[tuple[str, int], set[str]]:
    out: dict[tuple[str, int], set[str]] = {}
    for f in _corpus_files():
        for lineno, line in enumerate(f.read_text().splitlines(), 1):
            m = _EXPECT_RE.search(line)
            if m:
                out[(f.name, lineno)] = {r.strip()
                                         for r in m.group(1).split(",")}
    return out


@pytest.fixture(scope="module")
def corpus(one_thread):
    report = core.run_paths([FIXTURES])
    actual: dict[tuple[str, int], set[str]] = {}
    for f in report.findings:
        actual.setdefault((Path(f.path).name, f.line), set()).add(f.rule)
    return report, actual


class TestGoldenFixtures:
    def test_findings_match_expect_markers_exactly(self, corpus):
        _, actual = corpus
        expected = _expected()
        assert expected, "the corpus lost its EXPECT markers"
        missing = {k: v for k, v in expected.items() if k not in actual}
        extra = {k: v for k, v in actual.items() if k not in expected}
        assert not missing and not extra, f"missing={missing} extra={extra}"
        for key in expected:
            assert actual[key] == expected[key], key

    def test_every_port_rule_demonstrated_by_a_caught_fixture(self, corpus):
        _, actual = corpus
        caught = {r for rules in actual.values() for r in rules}
        assert PORT_RULES <= caught
        assert set(core.registered_rules()) == PORT_RULES

    @pytest.mark.parametrize("rule", sorted(PORT_RULES))
    def test_every_rule_has_a_bad_and_a_clean_twin(self, rule):
        stem = {"host-sync-in-dispatch": "host_sync",
                "rebuild-hazard": "rebuild"}.get(rule, rule.replace("-", "_"))
        names = {p.name for p in _corpus_files()}
        assert any(n.startswith(f"bad_{stem}.") for n in names), rule
        assert any(n.startswith(f"clean_{stem}.") for n in names), rule

    def test_clean_fixtures_stay_clean(self):
        for f in _corpus_files():
            if not f.name.startswith("clean_"):
                continue
            live, suppressed = core.analyze_file(f)
            assert not live, f"{f.name}: {[x.format() for x in live]}"
            assert not suppressed

    def test_poisoned_cache_replica_is_caught_at_the_view_line(self):
        live, _ = core.analyze_file(FIXTURES / "bad_inplace_alias.py")
        first = min(f.line for f in live if f.rule == "inplace-alias")
        src = (FIXTURES / "bad_inplace_alias.py").read_text().splitlines()
        assert "self.pos.cpu().numpy()" in src[first - 1]

    def test_findings_carry_location_and_hint(self):
        live, _ = core.analyze_file(FIXTURES / "bad_rebuild.py")
        f = live[0]
        assert f.line > 0 and f.path.endswith("bad_rebuild.py")
        assert f.hint and f"{f.path}:{f.line}" in f.format()


class TestSuppression:
    def test_named_suppressions_silence_and_are_counted(self):
        live, suppressed = core.analyze_file(FIXTURES / "suppressed.py")
        assert {f.rule for f in suppressed} == {
            "rebuild-hazard", "host-sync-in-dispatch"}
        assert len(suppressed) == 2

    def test_bare_and_unknown_disable_are_findings(self):
        live, _ = core.analyze_file(FIXTURES / "suppressed.py")
        assert sum(f.rule == "bad-suppression" for f in live) == 2
        assert sum(f.rule == "rebuild-hazard" for f in live) == 2

    def test_bad_suppression_is_not_itself_suppressible(self, tmp_path):
        f = tmp_path / "m.py"
        f.write_text("x = 1  # torchlint: disable  # torchlint: disable\n")
        live, _ = core.analyze_file(f)
        assert any(x.rule == "bad-suppression" for x in live)

    def test_cuda_sources_take_line_comment_suppressions(self, tmp_path):
        src = (FIXTURES / "bad_flag_balance.cu").read_text().replace(
            "  // EXPECT: flag-balance",
            "  // torchlint: disable=flag-balance — fixture: a reason", 1)
        f = tmp_path / "k.cu"
        f.write_text(src)
        live, suppressed = core.analyze_file(f)
        assert [x.rule for x in suppressed] == ["flag-balance"]
        assert [x.rule for x in live] == ["flag-balance"]
        f.write_text(src.replace("disable=flag-balance", "disable=no-such"))
        live, _ = core.analyze_file(f)
        assert "bad-suppression" in {x.rule for x in live}


class TestEngine:
    def test_syntax_error_is_a_finding_not_a_crash(self, tmp_path):
        f = tmp_path / "broken.py"
        f.write_text("def f(:\n")
        live, _ = core.analyze_file(f)
        assert [x.rule for x in live] == ["parse-error"]

    def test_alias_resolution_sees_through_import_spellings(self):
        mod = ModuleInfo.parse(
            "m.py", "import torch.distributed as dist\n"
                    "dist.all_reduce(x)\n")
        call = mod.tree.body[1].value
        assert mod.resolve(call.func) == "torch.distributed.all_reduce"

    def test_select_runs_only_named_rules(self, corpus):
        cfg = AnalysisConfig(select=frozenset({"generator-reuse"}))
        report = core.run_paths([FIXTURES], cfg)
        assert set(report.by_rule()) == {"generator-reuse"}

    def test_nested_function_hazard_reported_once(self, tmp_path):
        f = tmp_path / "nested.py"
        f.write_text(
            "def outer(eng):\n"
            "    def _dispatch_chunk(x):\n"
            "        return x.item()\n"
            "    return _dispatch_chunk\n")
        live, _ = core.analyze_file(f)
        assert [x.rule for x in live] == ["host-sync-in-dispatch"]

    def test_qualified_dispatch_names_match_their_method_only(self, tmp_path):
        f = tmp_path / "cmd.py"
        f.write_text(
            "class Command:\n"
            "    def submit(self):\n"
            "        self.x.item()\n"
            "class Engine:\n"
            "    def submit(self):\n"
            "        self.x.item()\n")
        live, _ = core.analyze_file(f)
        assert [x.line for x in live] == [3]

    @pytest.mark.parametrize("body,caught", [
        ("order = np.asarray(self.queue_list, np.int32)", False),
        ("order = np.asarray(req.prompt, np.int32)", False),
        ("n = int(bundle.pos)", False),
        ("t = float(self.temps[slot])", True),
        ("k = np.asarray(self.keys)", True),
        ("k = np.asarray(self.keys[slot].tolist(), np.uint32)", True),
        ("n = int(self.step_count)", False),
        ("n = int(self.pos.max())", True),
    ])
    def test_host_sync_judges_copies_and_casts_on_tensor_values(
            self, tmp_path, body, caught):
        # np.asarray/np.array and int/float read a device value only when
        # handed one: a host list packed into an array is not a finding
        f = tmp_path / "eng.py"
        f.write_text(
            "import numpy as np\nimport torch\n"
            "class Engine:\n"
            "    def __init__(self):\n"
            "        self.temps = torch.ones(4)\n"
            "        self.keys = torch.zeros((4, 2), dtype=torch.int64)\n"
            "        self.pos = torch.zeros(4, dtype=torch.int32)\n"
            "        self.step_count = 0\n"
            "        self.queue_list = []\n"
            "    def _admit(self, req, bundle, slot):\n"
            f"        {body}\n")
        live, _ = core.analyze_file(
            f, AnalysisConfig(select=frozenset({"host-sync-in-dispatch"})))
        assert [x.line for x in live] == ([11] if caught else [])

    @pytest.mark.parametrize("body,caught", [
        # the checking Python entries run _dst_table on the list
        ("fused.fused_permute(x, [(0, 1), (1, 0)])", False),
        ("fused.fused_permute_reference(x, [(0, 1), (1, 0)])", False),
        # the raw C entry: its table from nowhere checked
        ("lib.fused_permute(x.data_ptr(), out.data_ptr(), "
         "s['dst'].data_ptr())", True),
        ("dst = fused._dst_table(perm, g)\n        "
         "lib.fused_permute(x.data_ptr(), out.data_ptr(), "
         "s['dst'].data_ptr())", False),
        ("ring.check_permutation(perm, 4)\n        "
         "lib.fused_permute(x.data_ptr(), out.data_ptr(), "
         "s['dst'].data_ptr())", False),
    ])
    def test_unchecked_permutation_knows_the_checking_entries(
            self, tmp_path, body, caught):
        f = tmp_path / "perm.py"
        f.write_text(
            "from hpc_patterns_tpu_torch.comm import fused, ring\n"
            "def permute(lib, x, out, s, perm, g):\n"
            f"        {body}\n")
        live, _ = core.analyze_file(
            f, AnalysisConfig(select=frozenset({"unchecked-permutation"})))
        assert bool(live) == caught

    def test_relative_paths_are_judged_against_the_live_tables(
            self, monkeypatch):
        # the regression gate's five JAX-only serving rows carry their
        # suppressions; a relative path must meet the same sites
        monkeypatch.chdir(REPO)
        for path in ("hpc_patterns_tpu_torch/harness/regress.py",
                     str(PACKAGE / "harness" / "regress.py")):
            live, suppressed = core.analyze_file(path)
            assert not live
            assert [f.rule for f in suppressed] == ["gate-key-orphan"] * 5

    def test_baseline_roundtrip_tolerates_known_findings(self, corpus,
                                                         tmp_path):
        report, _ = corpus
        base = tmp_path / "baseline.json"
        core.write_baseline(base, report.findings)
        again = core.run_paths([FIXTURES],
                               baseline=core.load_baseline(base))
        assert not again.findings
        assert len(again.baselined) == len(report.findings)
        assert json.loads(base.read_text())["findings"]


class TestCLI:
    def test_ci_exits_nonzero_on_fixture_corpus(self, capsys):
        assert cli.main([str(FIXTURES), "--ci"]) == 1
        out = capsys.readouterr().out
        assert "inplace-alias" in out and "torchlint:" in out

    def test_ci_exits_zero_on_live_port(self, live):
        rc, out = live
        assert rc == 0, out
        assert "0 finding(s)" in out
        assert not (REPO / "torchlint_baseline.json").exists()

    def test_default_paths_cover_the_package_and_its_csrc(self, live):
        n = int(re.search(r"across (\d+) file", live[1]).group(1))
        py = len(list(PACKAGE.rglob("*.py")))
        cu = len(list(CSRC.glob("*.cu*")))
        assert n == py + cu and cu >= 11

    def test_non_ci_mode_reports_but_exits_zero(self, capsys):
        assert cli.main([str(FIXTURES / "bad_rebuild.py")]) == 0

    def test_select_and_baseline_errors_exit_two(self, capsys, tmp_path):
        assert cli.main([str(FIXTURES), "--ci", "--select",
                         "inplace_alias"]) == 2
        assert "unknown rule(s)" in capsys.readouterr().err
        bad = tmp_path / "b.json"
        bad.write_text("{not json")
        assert cli.main([str(FIXTURES), "--baseline", str(bad)]) == 2

    def test_log_appends_a_record_the_report_renders(self, tmp_path, capsys):
        log = tmp_path / "run.jsonl"
        log.write_text('{"kind": "result", "success": true}\n')
        cli.main([str(FIXTURES), "--log", str(log)])
        records = [json.loads(ln) for ln in log.read_text().splitlines()]
        assert records[0]["kind"] == "result"  # appended, not truncated
        rec = records[-1]
        assert rec["kind"] == "analysis" and rec["tool"] == "torchlint"
        assert rec["ok"] is False and rec["suppressed"] == 2
        assert rec["by_rule"]["inplace-alias"] == 3
        assert rec["smem"]["kernels"] >= 4 and rec["smem"]["over_limit"] == 1
        text = reportlib.format_report(reportlib.aggregate(records))
        assert "(torchlint)" in text and "smem:" in text
        assert "1 over the opt-in limit" in text

    def test_list_rules_groups_by_family(self, capsys):
        assert cli.main(["--list-rules"]) == 0
        lines = capsys.readouterr().out.splitlines()
        families = {}
        current = None
        for ln in lines:
            if not ln.startswith("  "):
                current = ln.rstrip(":")
                families[current] = set()
            else:
                families[current].add(ln.split()[0])
        assert list(families) == ["torchlint", "shardlint", "cudalint",
                                  "contractlint"]
        assert families["cudalint"] == {"mbar-balance", "ring-slot-reuse",
                                        "flag-balance", "smem-budget"}
        assert set().union(*families.values()) == PORT_RULES

    def test_smem_and_contract_reports_render(self, capsys):
        assert cli.main([str(FIXTURES / "bad_smem_budget.cu"),
                         "--smem-report"]) == 0
        out = capsys.readouterr().out
        assert "big_kernel" in out and "393216" in out and "OVER" in out
        assert cli.main([str(FIXTURES / "bad_gate_key_orphan.py"),
                         "--contract-report"]) == 0
        out = capsys.readouterr().out
        for section in ("gate keys", "RunLog record kinds", "chaos contract"):
            assert section in out


class TestLiveTree:
    """Pins on the port's own CUDA sources (no compiler needed)."""

    def test_every_kernel_has_a_numeric_static_row(self):
        rows = smem.estimate_paths([CSRC])
        files = {Path(r.path).name for r in rows}
        assert {f"{n}.cu" for n in ("flash_prefill", "fused_mlp",
                                    "fused_ring", "overlap_pipeline",
                                    "migration_dma", "busy_wait",
                                    "alias_inplace")} <= files
        assert len(rows) > 200
        assert all(isinstance(r.static_bytes, int) for r in rows)

    def test_constexpr_rows_the_sources_name(self):
        rows = {(Path(r.path).name, r.key): r
                for r in smem.estimate_paths([CSRC])}
        assert rows[("fused_ring.cu",
                     "allgather_matmul_kernel<F32,true>")].dynamic_bytes \
            == 106496  # AG_SMEM, fused_ring.cu
        assert rows[("flash_prefill.cu", "flash_fwd_kernel<128,2>")] \
            .dynamic_bytes == 164936  # Cfg<128, 2>::bytes
        gda = rows[("fused_mlp.cu", "gda_kernel")]
        assert gda.dynamic_bytes == 198656  # H_SMEM
        mlp = rows[("fused_mlp.cu", "mlp_kernel<256,false>")]
        assert mlp.dynamic_bytes is None and any(
            "P.smem" in u for u in mlp.dynamic_unbound)
        for r in rows.values():
            assert r.total_bytes is None or r.total_bytes <= smem.SMEM_LIMIT

    def test_protocol_kernels_are_analyzed_not_abstained(self):
        leds = cuda_rules.kernel_report([CSRC])
        status = {led.kernel.split("<")[0]: set() for led in leds}
        for led in leds:
            status[led.kernel.split("<")[0]].add(led.status)
        named = {"flash_fwd_kernel", "dkv_kernel", "dq_kernel",
                 "mlp_kernel", "gda_kernel", "gemm_kernel",
                 "fused_allreduce_kernel", "allgather_matmul_kernel",
                 "fused_permute_kernel", "migration_exchange_kernel",
                 "pipeline_kernel"}
        assert named <= set(status)
        assert all(status[k] == {"analyzed"} for k in named), status
        assert all(not led.findings for led in leds)

    def test_kernel_ledgers_see_each_protocol(self):
        kinds = {}
        for led in cuda_rules.kernel_report([CSRC]):
            kinds.setdefault(led.kernel.split("<")[0], set()).update(
                e.kind for e in led.events)
        assert {"init", "expect", "copy", "wait", "arrive"} <= kinds[
            "flash_fwd_kernel"]
        assert "rarrive" in kinds["mlp_kernel"]
        assert {"release", "acquire", "fifo", "credit"} <= kinds[
            "fused_allreduce_kernel"]
        assert {"stage", "release", "acquire"} <= kinds[
            "allgather_matmul_kernel"]
        assert {"release", "acquire"} <= kinds["migration_exchange_kernel"]

    def test_front_end_evaluates_the_sources_constexprs(self):
        u = csource.parse_unit(CSRC / "flash_attention_bwd.cu")
        ev = lambda s, ns: csource.evaluate(csource._lex(s, "x"),  # noqa
                                            csource.Env(u, ns))
        assert ev("Cfg<128, true>::bytes", "dkv") == 198696
        assert ev("Cfg<128>::bytes", "dq") == 164920
        with pytest.raises(csource.Unbound):
            ev("Cfg<128>::no_such_member", "dq")


class TestRuntime:
    def test_poison_breaks_stale_host_views(self):
        def step(pos):
            return pos + 1

        wrapped = runtime.poison_consumed(step, (0,))
        pos = torch.arange(4, dtype=torch.int32)
        view = pos.numpy()  # the stale view the poison must expose
        new = wrapped(pos)
        assert new.tolist() == [1, 2, 3, 4]
        assert wrapped.poison_count == 1
        assert (view == np.int32(-1414812757)).all()

    def test_poison_skips_storage_an_output_shares(self):
        wrapped = runtime.poison_consumed(lambda t: t[1:], (0,))
        t = torch.ones(4)
        out = wrapped(t)
        assert wrapped.poison_count == 0 and out.eq(1).all()

    def test_serving_poison_engages_and_the_engine_equals_standalone(
            self, one_thread):
        from hpc_patterns_tpu_torch.models import serving as tsrv
        from hpc_patterns_tpu_torch.models import transformer as ttf
        from hpc_patterns_tpu_torch.models.decode import paged_generate

        cfg = ttf.TransformerConfig(vocab=128, d_model=32, n_heads=2,
                                    n_layers=1, d_ff=64, max_seq=64,
                                    dtype="float32", decode_attn="flash")
        params = ttf.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(3)
        reqs = [(rng.integers(0, 128, int(n), np.int32), b)
                for n, b in ((5, 9), (11, 6), (3, 12))]
        uninstall = runtime.install_serving_poison()
        try:
            eng = tsrv.ContinuousBatcher(
                params, cfg, slots=2, pool_pages=8, pages_per_seq=4,
                page_size=8, chunk=4, prompt_buckets=(16,), device="cpu")
            ids = [eng.submit(p, b) for p, b in reqs]
            got = eng.run()
            count = (tsrv._chunk_step.poison_count
                     + tsrv._chunk_step_rows.poison_count)
        finally:
            uninstall()
        assert count > 0
        assert not hasattr(tsrv._chunk_step, "poison_count")
        for sid, (p, b) in zip(ids, reqs):
            want = paged_generate(params, torch.from_numpy(p)[None], cfg, b,
                                  page_size=8, device="cpu")[0].numpy()
            np.testing.assert_array_equal(got[sid], want)

    def test_strict_dispatch_judges_and_guards_the_dispatch_paths(self):
        from hpc_patterns_tpu_torch.concurrency import commands

        judged = runtime.judged_functions()
        cmd = judged["hpc_patterns_tpu_torch.concurrency.commands"]
        assert cmd["Command.submit"] and cmd["ComputeCommand._enqueue"]
        srv = judged["hpc_patterns_tpu_torch.models.serving"]
        assert srv["EngineCore._dispatch_chunk"]
        assert not srv["EngineCore._preempt"]  # deliberate, suppressed
        # host-list packing is no finding: the row install stays guarded
        assert srv["EngineCore._attach_row"]
        original = commands.Command.submit
        with runtime.strict_dispatch(
                ["hpc_patterns_tpu_torch.concurrency.commands"]) as guard:
            assert commands.Command.submit is not original
            c = commands.make_command("M2D", device="cpu",
                                      copy_elements=64)
            for _ in range(3):
                c.submit()
        assert commands.Command.submit is original
        assert guard.guarded_calls >= 6 and not guard.raised

    def test_dispatch_critical_is_a_noop_marker(self):
        def f(x):
            return x + 1
        assert dispatch_critical(f) is f

    def test_schedule_verifier_is_the_trace_modules(self):
        from hpc_patterns_tpu_torch.harness import trace

        assert runtime.CollectiveSchedule is trace.CollectiveSchedule
        assert runtime.record_collective is trace.record_collective
