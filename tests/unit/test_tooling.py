"""Tests for config / logging / timing / analysis / validation tooling."""

import json

import numpy as np
import pytest

import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
from mixed_precision_multigrid_solvers_for_pdes_tpu import analysis
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
    MultigridConfig,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.utils import (
    FrameworkConfig,
    PerformanceProfiler,
    Timer,
    benchmark_function,
    create_accuracy_config,
    create_performance_config,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.validation import (
    MMSValidator,
    TheoreticalAnalyzer,
    measure_two_grid_factor,
)

CFG = MultigridConfig(smoother="rbgs", omega=1.0)


class TestConfig:
    def test_roundtrip_yaml(self, tmp_path):
        cfg = create_accuracy_config()
        p = tmp_path / "cfg.yaml"
        cfg.save(p)
        cfg2 = FrameworkConfig.load(p)
        assert cfg2.solver.cycle == "W"
        assert cfg2.precision.mode == "fp64"

    def test_roundtrip_json(self, tmp_path):
        cfg = create_performance_config()
        p = tmp_path / "cfg.json"
        cfg.save(p)
        cfg2 = FrameworkConfig.load(p)
        assert cfg2.precision.mode == "mixed"
        assert cfg2.solver.pre_sweeps == 1

    def test_validation_rejects_bad(self):
        cfg = FrameworkConfig()
        cfg.solver.omega = 2.5
        with pytest.raises(ValueError):
            cfg.validate()
        cfg = FrameworkConfig()
        cfg.grid.nx = 2
        with pytest.raises(ValueError):
            cfg.validate()

    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError):
            FrameworkConfig.from_dict({"solver": {"no_such_key": 1}})

    def test_build_mg_config(self):
        cfg = FrameworkConfig()
        mgc = cfg.solver.build()
        assert isinstance(mgc, MultigridConfig)
        assert mgc.smoother == cfg.solver.smoother


class TestTiming:
    def test_timer(self):
        with Timer("x") as t:
            sum(range(1000))
        assert t.elapsed > 0

    def test_profiler_summary(self):
        prof = PerformanceProfiler()
        with prof.region("op"):
            sum(range(1000))
        with prof.region("op"):
            sum(range(1000))
        s = prof.summary()
        assert s["op"]["count"] == 2
        assert s["op"]["total_s"] > 0

    def test_benchmark_function(self):
        import jax.numpy as jnp

        stats = benchmark_function(lambda: jnp.ones(16).sum(), warmup=1, runs=3)
        assert stats["min_s"] > 0 and stats["runs"] == 3


class TestConvergenceAnalysis:
    def test_rates_and_asymptotics(self):
        a = analysis.ConvergenceAnalyzer()
        rep = a.analyze([1.0, 0.1, 0.01, 0.001])
        assert rep.asymptotic_rate == pytest.approx(0.1)
        assert rep.reduction == pytest.approx(1000.0)
        assert not rep.stagnated and not rep.diverged

    def test_stagnation_detection(self):
        a = analysis.ConvergenceAnalyzer(window=3)
        h = [1.0, 0.5, 0.25] + [0.25 * 0.999**k for k in range(10)]
        rep = a.analyze(h)
        assert rep.stagnated

    def test_divergence_detection(self):
        a = analysis.ConvergenceAnalyzer()
        assert a.detect_divergence([1.0, 0.1, 0.05, 1.0])

    def test_monitor_events_and_recommendations(self):
        mon = analysis.ConvergenceMonitor(check_every=2)
        events = []
        mon.add_callback(lambda kind, ev: events.append(kind))
        for r in [1.0, 0.5, 0.49, 0.488, 0.4875, 0.4874, 0.48738]:
            mon.record(r)
        assert "stagnation" in events
        assert any("stagnat" in r for r in mon.recommendations())


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.utils import (
            CheckpointManager,
        )

        mgr = CheckpointManager(tmp_path / "ck", keep_last=2)
        u = np.arange(12.0).reshape(3, 4)
        for step in (10, 20, 30):
            mgr.save(step, {"u": u * step, "t": np.float64(step * 0.1)},
                     {"scheme": "cn"})
        assert mgr.all_steps() == [20, 30]  # keep_last=2 evicted step 10
        arrays, meta = mgr.restore()
        np.testing.assert_array_equal(arrays["u"], u * 30)
        assert meta["step"] == 30 and meta["scheme"] == "cn"
        arrays20, _ = mgr.restore(20)
        np.testing.assert_array_equal(arrays20["u"], u * 20)

    def test_restore_empty_raises(self, tmp_path):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.utils import (
            CheckpointManager,
        )

        with pytest.raises(FileNotFoundError):
            CheckpointManager(tmp_path / "none").restore()


class TestTheory:
    def test_lfa_textbook_values(self):
        ta = TheoreticalAnalyzer()
        assert ta.jacobi_smoothing_factor(0.8) == pytest.approx(0.6, abs=0.01)
        assert ta.gs_lex_smoothing_factor() == pytest.approx(0.5, abs=0.01)

    def test_measured_factor_beats_prediction(self):
        prob = P.poisson_mms_sinsin(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        r = measure_two_grid_factor(levels, CFG)
        ta = TheoreticalAnalyzer()
        # V(2,2) RB-GS should meet the smoothing-only bound mu^4 ~ 0.0625...
        # allow it to be close; and well below the reference's rho<=0.15 target
        assert r["rho"] < 0.15, r["rho"]


class TestBenchmarking:
    def test_suite_runs_and_reports(self, tmp_path):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.benchmarking import (
            BenchmarkSuite,
        )

        # fp32 relative-residual floor at these sizes is ~1e-5; stay above it
        suite = BenchmarkSuite(P.poisson_mms_sinsin,
                               CFG.replace(tol=1e-4, max_iterations=30))
        suite.run(sizes=(17, 33), precisions=("fp32",), runs=1)
        rep = suite.report()
        assert len(rep["records"]) == 2
        assert all(r["converged"] for r in rep["records"])
        exp = rep["scaling_exponents"]["fp32"]
        assert np.isfinite(exp)
        md = suite.report_markdown()
        assert "measured" in md
        suite.save(tmp_path / "b.json")
        assert (tmp_path / "b.json").exists()

    def test_multigrid_profiler(self, tmp_path):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.benchmarking import (
            MultigridProfiler,
        )

        prob = P.poisson_mms_sinsin(33)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                    cfg=CFG)
        prof = MultigridProfiler(levels, CFG)
        rec = prof.profile_level(0, runs=2)
        assert "smooth" in rec and rec["smooth"]["min_s"] > 0
        prof.profile_level(1, runs=2)
        b = prof.bottlenecks()
        assert b["cycle_estimate_s"] > 0 and b["dominant"]
        prof.export(tmp_path / "prof.json")
        assert (tmp_path / "prof.json").exists()


class TestMMSValidator:
    def test_steady_validation_passes(self):
        v = MMSValidator(cfg=CFG)
        # polynomial: bi-quadratic is EXACT under the 5-point stencil -> the
        # validator must recognize the round-off floor and pass it
        res = v.validate_steady(P.poisson_mms_polynomial, sizes=(17, 33, 65))
        assert res.passed, res
        assert max(res.l2_errors) < 1e-9
        # trig: genuine O(h^2) truncation error
        res = v.validate_steady(P.poisson_mms_sinsin, sizes=(17, 33, 65))
        assert res.passed, res
        assert abs(res.observed_order - 2.0) < 0.3

    def test_report_and_save(self, tmp_path):
        v = MMSValidator(cfg=CFG)
        v.validate_steady(P.poisson_mms_sinsin, sizes=(17, 33))
        md = v.report_markdown()
        assert "poisson_sinsin" in md
        p = tmp_path / "mms.json"
        v.save(p)
        d = json.loads(p.read_text())
        assert d["total"] == 1


class TestHeadlineBench:
    def test_bench_batch_protocol(self):
        """bench.py's batched sustained-throughput protocol runs end to end
        (K solves in one scan, convergence checked per batch). Printing the
        JSON line needs a GPU; test_entry_points covers the refusal."""
        import runpy
        from pathlib import Path

        root = Path(__file__).resolve().parents[2]
        bench = runpy.run_path(str(root / "bench.py"))
        out = bench["measure"](65, 2)
        assert set(out) == {"seconds_per_solve", "first_call_s", "dofs"}
        assert out["seconds_per_solve"] > 0 and out["dofs"] == 63 ** 2
