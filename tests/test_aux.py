"""Auxiliary subsystem tests: checkpoint/resume, timing, hybrid marginals,
GP CSV exports."""
import os

import numpy as np
import pytest

from bito_tpu.api.gp import gp_instance
from bito_tpu.api.instances import unrooted_instance
from bito_tpu.utils import checkpoint, timing


class TestCheckpoint:
    def test_instance_roundtrip(self, data_dir, tmp_path):
        inst = unrooted_instance("a")
        inst.read_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        inst.process_loaded_trees()
        inst.train_simple_average()
        path = str(tmp_path / "ckpt.json")
        checkpoint.checkpoint_instance(inst, path, extra={"step": 7})
        inst2 = unrooted_instance("b")
        inst2.read_newick_file(str(data_dir / "five_taxon_unrooted.nwk"))
        inst2.process_loaded_trees()
        extra = checkpoint.restore_instance(inst2, path)
        assert extra["step"] == 7
        np.testing.assert_allclose(inst2.sbn_parameters, inst.sbn_parameters)

    def test_gp_roundtrip(self, data_dir, tmp_path):
        inst = gp_instance()
        inst.read_fasta_file(str(data_dir / "hello.fasta"))
        inst.read_newick_file(str(data_dir / "hello_rooted.nwk"))
        inst.make_gp_engine()
        inst.estimate_branch_lengths(1e-3, 10)
        path = str(tmp_path / "gp.json")
        checkpoint.checkpoint_gp(inst, path)
        inst2 = gp_instance()
        inst2.read_fasta_file(str(data_dir / "hello.fasta"))
        inst2.read_newick_file(str(data_dir / "hello_rooted.nwk"))
        inst2.make_gp_engine()
        checkpoint.restore_gp(inst2, path)
        np.testing.assert_allclose(inst2.get_branch_lengths(),
                                   inst.get_branch_lengths())
        np.testing.assert_allclose(inst2.get_sbn_parameters(),
                                   inst.get_sbn_parameters())

    def test_burrito_roundtrip(self, tmp_path):
        from bito_tpu.models.phylo_model import PhyloModelSpecification
        from bito_tpu.vi.burrito import Burrito

        burro = Burrito(
            mcmc_nexus_path="/root/reference/data/hello_out.t",
            burn_in_fraction=0,
            fasta_path="/root/reference/data/hello.fasta",
            phylo_model_specification=PhyloModelSpecification(clock="strict"),
            branch_model_name="split", scalar_model_name="lognormal",
            optimizer_name="simple", particle_count=4,
        )
        burro.gradient_step()
        path = str(tmp_path / "burrito.json")
        checkpoint.checkpoint_burrito(burro, path, step=1)
        q_before = burro.branch_model.scalar_model.q_params.copy()
        burro.gradient_step()  # mutate
        step = checkpoint.restore_burrito(burro, path)
        assert step == 1
        np.testing.assert_allclose(
            burro.branch_model.scalar_model.q_params, q_before
        )


class TestTiming:
    def test_stopwatch_and_phases(self):
        sw = timing.Stopwatch()
        lap = sw.lap()
        assert lap >= 0 and sw.total() >= lap
        pt = timing.PhaseTimer()
        with pt.phase("a"):
            pass
        with pt.phase("a"):
            pass
        with pt.phase("b"):
            pass
        assert pt.counts["a"] == 2 and pt.counts["b"] == 1
        assert "Timing Report" in pt.report()

    def test_progress_bar(self):
        """Reference src/ProgressBar.hpp:9-66 semantics: ticks, in-place
        redraw, percent + elapsed."""
        import io

        bar = timing.ProgressBar(4, width=8)
        bar.next()
        bar += 1
        out = io.StringIO()
        bar.display(stream=out)
        text = out.getvalue()
        assert text.endswith("\r") and "50%" in text
        assert text.count("=") == 4  # half of width 8
        bar.next()
        bar.next()
        out2 = io.StringIO()
        bar.done(stream=out2)
        assert "100%" in out2.getvalue()
        assert out2.getvalue().endswith("\n")
        assert bar.seconds_elapsed() >= 0.0


class TestHybridMarginals:
    def test_hybrid_equals_per_edge_without_rootward_uncertainty(
        self, data_dir
    ):
        """On paths whose rootward prior is 1, the quartet hybrid marginal
        coincides with the per-edge GP likelihood (validated against the
        exact marginal in test_gp.py); elsewhere it is finite and a
        consistent conditional estimate."""
        inst = gp_instance()
        inst.read_fasta_file(str(data_dir / "7-taxon-slice-of-ds1.fasta"))
        inst.read_newick_file(
            str(data_dir / "simplest-hybrid-marginal.nwk")
        )
        inst.make_gp_engine()
        rng = np.random.RandomState(7)
        inst.set_branch_lengths(
            np.round(rng.uniform(1e-6, 0.1, inst.get_dag().edge_count()), 3)
        )
        inst.populate_plvs()
        inst.compute_likelihoods()
        inst.calculate_hybrid_marginals()
        inst.compute_likelihoods()
        h = inst.get_hybrid_marginals()
        pe = inst.get_per_gpcsp_log_likelihoods()
        eng = inst.get_gp_engine()
        dag = inst.get_dag()
        formed = np.isfinite(h)
        assert formed.any(), "no fully formed hybrid requests"
        # Where the rhat path carries no sub-unit prior mass, the hybrid
        # estimate reduces exactly to the per-edge GP likelihood; elsewhere
        # it differs by accumulated per-site prior factors.  At least some
        # edges of this fixture are in the exact-agreement regime.
        diffs = np.abs(h[formed] - pe[formed])
        assert (diffs < 1e-6).sum() > 0, (h[formed], pe[formed])
        assert np.isfinite(h[formed]).all()

    def test_sbn_update_prefers_hybrids(self, data_dir):
        inst = gp_instance()
        inst.read_fasta_file(str(data_dir / "7-taxon-slice-of-ds1.fasta"))
        inst.read_newick_file(
            str(data_dir / "simplest-hybrid-marginal.nwk")
        )
        inst.make_gp_engine()
        inst.populate_plvs()
        inst.compute_likelihoods()
        inst.calculate_hybrid_marginals()
        inst.compute_likelihoods()
        inst.get_gp_engine().update_sbn_probabilities()
        q = inst.get_sbn_parameters()
        assert np.all(q >= 0) and np.all(q <= 1 + 1e-12)


class TestGPExports:
    def test_csv_exports(self, data_dir, tmp_path):
        inst = gp_instance()
        inst.read_fasta_file(str(data_dir / "hello.fasta"))
        inst.read_newick_file(str(data_dir / "hello_rooted.nwk"))
        inst.make_gp_engine()
        inst.populate_plvs()
        inst.compute_likelihoods()
        for fn, name in (
            (inst.branch_lengths_to_csv, "bl.csv"),
            (inst.per_gpcsp_log_likelihoods_to_csv, "ll.csv"),
            (inst.sbn_parameters_to_csv, "q.csv"),
        ):
            p = str(tmp_path / name)
            fn(p)
            lines = open(p).read().strip().split("\n")
            assert len(lines) == inst.get_dag().edge_count()
        tree_path = str(tmp_path / "trees.nwk")
        inst.export_trees_with_gp_branch_lengths(tree_path)
        assert open(tree_path).read().count(";") == inst.tree_count()


class TestCompileCache:
    @pytest.mark.parametrize("env_set", [True, False])
    def test_cache_directory_rule(self, tmp_path, env_set):
        """A set JAX_COMPILATION_CACHE_DIR wins and the package sets no
        other; otherwise the cache is the fixed `.jax_cache` of the
        checkout."""
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        if env_set:
            env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
        out = subprocess.run(
            [sys.executable, "-c",
             "import bito_tpu, jax; "
             "print(jax.config.jax_compilation_cache_dir)"],
            env=env, capture_output=True, text=True, timeout=120,
            cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        expected = (str(tmp_path / "cache") if env_set
                    else os.path.join(repo, ".jax_cache"))
        assert out.stdout.strip() == expected
