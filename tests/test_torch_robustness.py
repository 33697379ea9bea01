"""The port's robustness layer on the CPU, held against the JAX package's
(``tests/test_robustness.py``'s ``TestFaultPlan``, ``TestRetryPolicy``,
``TestInjectedRecovery`` and ``TestQuarantine``, as port-vs-JAX cases):
the same plan and seed fire at the same visits, the same backoff series,
the error taxonomy (CUDA OOMs split, sticky CUDA errors are permanent),
the kernel wrappers' workspace dropped after a failed launch, and the CLI:
retries recover every I/O site, an OOM splits a chunk with the bytes
unchanged, the watchdog breaks a hang, a chunk that outlives its retries
reaches ``--on-error`` and never leaves the device path, and malformed
records go to the same quarantine file as the JAX CLI's, eager and
streamed.

The run summary's ``robustness`` dict is held to the JAX journal's
``run_end.robustness`` for the same flags, except ``retry_wait_s``: the
backoff of a retry depends on its attempt number, and which pack worker's
attempt meets a fault depends on the threads, in both packages; and
``degrade_reroutes``, which the JAX package reports as 0 beside a split
and the port leaves out (it has no reroute)."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from specpride_tpu import cli as jcli
from specpride_tpu.robustness import errors as jerrors
from specpride_tpu.robustness import faults as jfaults
from specpride_tpu.robustness.retry import RetryPolicy as JRetryPolicy
from specpride_tpu_torch import cli
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.io import mgf
from specpride_tpu_torch.ops import kernels
from specpride_tpu_torch.robustness import errors, faults
from specpride_tpu_torch.robustness.faults import FaultPlan
from specpride_tpu_torch.robustness.retry import RetryPolicy
from specpride_tpu_torch.robustness.watchdog import Watchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _workload(n=8, seed=21):
    rng = np.random.default_rng(seed)
    clusters = []
    for i in range(n):
        skeleton = np.sort(rng.uniform(120.0, 1500.0, 25))
        clusters.append(Cluster(f"cluster-{i}", [
            Spectrum(
                mz=np.sort(skeleton + rng.normal(0.0, 0.004, 25)),
                intensity=rng.uniform(10.0, 1e4, 25),
                precursor_mz=500.0 + i, precursor_charge=2, rt=float(m),
                title=f"cluster-{i};mzspec:PXD000001:run1:scan:"
                      f"{100 * i + m}",
            )
            for m in range(3)
        ]))
    return clusters


def _write(tmp_path, clusters, name="clustered.mgf"):
    path = tmp_path / name
    mgf.write_mgf([s for c in clusters for s in c.members], path)
    return path


def _port(clustered, out, *extra, command="consensus", ck=None):
    argv = [command, str(clustered), str(out), "--device", "cpu",
            *extra]
    if ck is not None:
        argv += ["--checkpoint", str(ck), "--checkpoint-every", "2"]
    return cli.main(argv)


def _jax(clustered, out, *extra, command="consensus", ck=None, journal):
    argv = [command, str(clustered), str(out), *extra, "--journal",
            str(journal)]
    if ck is not None:
        argv += ["--checkpoint", str(ck), "--checkpoint-every", "2"]
    return jcli.main(argv)


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().err.strip().splitlines()[-1])


def _jax_robustness(journal) -> dict | None:
    events = [json.loads(line) for line in open(journal)]
    return [e for e in events if e["event"] == "run_end"][-1].get(
        "robustness")


def _comparable(rb: dict | None) -> dict | None:
    """A robustness dict without the fields the module docstring names."""
    if rb is None:
        return None
    out = {k: v for k, v in rb.items() if k != "retry_wait_s"}
    if out.get("degrade_reroutes") == 0:
        del out["degrade_reroutes"]
    return out


# -- the fault plan ---------------------------------------------------------


class TestFaultPlan:
    def test_spec_parsing_matches_jax(self):
        text = "dispatch:oom:0.5:2:3, write:io:1"
        got = FaultPlan.parse(text, seed=7)
        want = jfaults.FaultPlan.parse(text, seed=7)
        assert got.summary() == want.summary()
        s0, s1 = got.specs
        assert (s0.site, s0.kind, s0.rate, s0.after, s0.max_fires) == (
            "dispatch", "oom", 0.5, 2, 3)
        assert (s1.site, s1.kind, s1.rate, s1.after, s1.max_fires) == (
            "write", "io", 1.0, 0, 1)

    @pytest.mark.parametrize("bad", [
        "nope:io:1", "dispatch:nope:1", "dispatch:io:2", "dispatch:io", "",
        "dispatch:io:1:-1", "cas:nope:1", "dispatch:rank_kill:2",
    ])
    def test_bad_specs_rejected(self, bad):
        """The JAX package's refusals, the elastic site and kinds
        included."""
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)
        with pytest.raises(ValueError):
            jfaults.FaultPlan.parse(bad)

    @pytest.mark.parametrize("text", [
        "cas:io:1", "dispatch:rank_kill:1", "write:rank_kill:1:3",
        "dispatch:rank_slow:1:0:9999", "cas:cas_conflict:0.5:1:4",
    ])
    def test_elastic_site_and_kinds_parse_like_jax(self, text):
        got = FaultPlan.parse(text, seed=3)
        assert got.summary() == jfaults.FaultPlan.parse(text,
                                                        seed=3).summary()

    @pytest.mark.parametrize("seed", [0, 11, 12])
    @pytest.mark.parametrize("text", [
        "dispatch:io:0.3:0:1000", "write:io:0.5:3:4",
        "dispatch:oom:0.2:1:5,dispatch:io:0.4:0:3,qc:malformed:0.7:2:9",
    ])
    def test_fires_at_the_jax_visits(self, text, seed):
        def fired(plan_cls, classify):
            plan = plan_cls.parse(text, seed=seed)
            out = []
            for visit in range(60):
                for site in ("dispatch", "write", "qc"):
                    try:
                        plan.check(site)
                    except Exception as e:  # noqa: BLE001 - recorded
                        out.append((site, visit, classify(e)))
            return out, plan.fired_by_site

        got, got_sites = fired(FaultPlan, errors.classify)
        want, want_sites = fired(jfaults.FaultPlan, jerrors.classify)
        assert got == want and got_sites == want_sites
        assert got  # some fire

    def test_after_and_max_fires(self):
        plan = FaultPlan.parse("write:io:1:3:2")
        outcomes = []
        for _ in range(8):
            try:
                plan.check("write")
                outcomes.append("ok")
            except OSError:
                outcomes.append("fault")
        assert outcomes == ["ok"] * 3 + ["fault", "fault"] + ["ok"] * 3
        assert plan.fired_by_site == {"write": 2}

    def test_error_shapes_match_taxonomy(self):
        for kind, pred in (("io", errors.is_transient),
                           ("oom", errors.is_oom)):
            plan = FaultPlan.parse(f"dispatch:{kind}:1")
            with pytest.raises(Exception) as exc_info:
                plan.check("dispatch")
            assert pred(exc_info.value)
        plan = FaultPlan.parse("dispatch:malformed:1")
        with pytest.raises(ValueError) as exc_info:
            plan.check("dispatch")
        assert errors.classify(exc_info.value) == "permanent"

    def test_env_arming(self, monkeypatch):
        monkeypatch.setenv("SPECPRIDE_FAULTS", "qc:io:1:1")
        monkeypatch.setenv("SPECPRIDE_FAULT_SEED", "5")
        plan = FaultPlan.from_env()
        assert plan.seed == 5
        assert [(s.site, s.kind) for s in plan.specs] == [("qc", "io")]
        assert plan.summary() == jfaults.FaultPlan.from_env().summary()
        monkeypatch.delenv("SPECPRIDE_FAULTS")
        assert FaultPlan.from_env() is None

    def test_install_check_and_suppressed(self):
        prev = faults.install(FaultPlan.parse("pack:io:1:0:5"))
        try:
            with faults.suppressed():
                faults.check("pack")  # no fire on this thread
            with pytest.raises(OSError):
                faults.check("pack")
            assert faults.active_plan().fired_by_site == {"pack": 1}
        finally:
            faults.install(prev)
        assert faults.active_plan() is prev
        faults.check("pack")  # disarmed: nothing fires

    def test_cancel_hangs_breaks_a_hang(self):
        plan = FaultPlan.parse("dispatch:hang:1")
        plan.cancel_hangs()
        with pytest.raises(TimeoutError) as exc_info:
            plan.check("dispatch")
        assert errors.classify(exc_info.value) == "transient"


# -- the error taxonomy and the kernel wrappers' repair ---------------------


class TestErrors:
    def test_cuda_ooms_split(self):
        for exc in (
            torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                   "2.00 GiB"),
            RuntimeError("seg_scan kernel launch failed: cudaError 2"),
            RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating"),
        ):
            assert errors.classify(exc) == "oom"
            assert errors.is_transient(exc)

    @pytest.mark.parametrize("code", sorted(errors.STICKY_CUDA_ERRORS))
    def test_sticky_cuda_errors_are_permanent(self, code):
        by_code = RuntimeError(f"seg_mean kernel launch failed: cudaError "
                               f"{code}")
        by_text = RuntimeError(
            f"CUDA error: {errors.STICKY_CUDA_ERRORS[code]}\nCUDA kernel "
            "errors might be asynchronously reported")
        for exc in (by_code, by_text):
            assert errors.is_sticky(exc)
            assert errors.classify(exc) == "permanent"
            assert not errors.is_transient(exc) and not errors.is_oom(exc)

    def test_other_errors_match_jax(self):
        for exc in (OSError("disk"), TimeoutError("hang"),
                    ValueError("malformed"), RuntimeError("plain"),
                    RuntimeError("DEADLINE_EXCEEDED: slow"),
                    RuntimeError("RESOURCE_EXHAUSTED: x")):
            assert errors.classify(exc) == jerrors.classify(exc), exc

    @pytest.mark.parametrize("rc", [2, 700])
    def test_failed_launch_drops_its_workspace(self, rc, monkeypatch):
        """A launch whose entry returns non-zero may leave the device's
        ticket counter past ``base``: the workspace is dropped, the error
        raised, nothing counted; the next launch on that stream gets a
        zeroed workspace at base 0."""
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: SimpleNamespace(
                                cuda_stream=7))
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        monkeypatch.setattr(kernels, "launches",
                            dict.fromkeys(kernels.launches, 0))
        monkeypatch.setattr(kernels, "workspaces", {})
        lib = SimpleNamespace(tile=8, record_bytes=32)
        runs = torch.ones(20, dtype=torch.bool)
        x = torch.zeros(20, dtype=torch.float32)
        calls = []

        def entry(*args):
            calls.append(args[-3])  # the base handed to the kernel
            return 0 if len(calls) != 2 else rc

        kernels._launch("seg_scan", entry, lib, runs, [x], [x], 1)
        first = kernels.workspaces[(None, 7)]
        assert first.base == 3 and kernels.launches["seg_scan"] == 1
        with pytest.raises(RuntimeError) as exc_info:
            kernels._launch("seg_scan", entry, lib, runs, [x], [x], 1)
        assert (None, 7) not in kernels.workspaces
        assert kernels.launches["seg_scan"] == 1
        assert errors.classify(exc_info.value) == (
            "oom" if rc == 2 else "permanent")
        kernels._launch("seg_scan", entry, lib, runs, [x], [x], 1)
        fresh = kernels.workspaces[(None, 7)]
        assert fresh is not first and calls == [0, 3, 0]
        assert fresh.base == 3 and not fresh.buf.any()


# -- the retry policy and the watchdog --------------------------------------


class TestRetryPolicy:
    @pytest.mark.parametrize("seed", [0, 4, 99])
    def test_backoff_series_match_jax(self, seed):
        for site in faults.SITES:
            got = RetryPolicy(retries=5, backoff=0.1, seed=seed)
            want = JRetryPolicy(retries=5, backoff=0.1, seed=seed)
            assert [got.backoff_s(site, i) for i in range(6)] == \
                [want.backoff_s(site, i) for i in range(6)]
        waits = [RetryPolicy(backoff=0.1, seed=seed).backoff_s("dispatch", i)
                 for i in range(3)]
        assert 0.1 <= waits[0] < 0.125 and 0.2 <= waits[1] < 0.25
        assert 0.4 <= waits[2] < 0.5

    def test_transient_retried_then_succeeds(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "done"

        policy = RetryPolicy(retries=3, backoff=0.0)
        assert policy.call("write", flaky) == "done"
        assert len(calls) == 3
        assert policy.summary()["retries_by_site"] == {"write": 2}

    def test_permanent_and_sticky_never_retried(self):
        for exc in (ValueError("malformed"),
                    RuntimeError("seg_scan kernel launch failed: cudaError "
                                 "700")):
            calls = []

            def bad(exc=exc, calls=calls):
                calls.append(1)
                raise exc

            policy = RetryPolicy(retries=5, backoff=0.0)
            with pytest.raises(type(exc)):
                policy.call("dispatch", bad)
            assert len(calls) == 1 and policy.summary()["retries"] == 0

    def test_budget_exhaustion_reraises_and_hook_runs(self):
        undone = []
        policy = RetryPolicy(retries=2, backoff=0.0)
        with pytest.raises(OSError):
            policy.call("write", lambda: (_ for _ in ()).throw(OSError("x")),
                        before_retry=lambda: undone.append(1))
        assert policy.summary()["retries"] == 2 and undone == [1, 1]


def test_watchdog_counts_a_stall_and_calls_on_stall():
    stalls = []
    wd = Watchdog(0.05, on_stall=lambda: stalls.append(1))
    try:
        with wd.section("dispatch"):
            deadline = 2.0
            while not stalls and deadline > 0:
                import time
                time.sleep(0.01)
                deadline -= 0.01
        with wd.section("write"):
            pass  # a short section is no stall
    finally:
        wd.stop()
    assert wd.stall_count == 1 and stalls == [1]
    idle = Watchdog(0.0)
    assert not idle.enabled and idle._thread is None
    with idle.section("pack"):
        pass


# -- injected faults through the CLI -----------------------------------------


@pytest.fixture
def golden(tmp_path):
    """The fault-free serial run's bytes."""
    def make(clustered, *extra, command="consensus", name="golden"):
        out, ck = tmp_path / f"{name}.mgf", tmp_path / f"{name}.ck.json"
        assert _port(clustered, out, "--prefetch", "0", *extra,
                     command=command, ck=ck) == 0
        return out.read_bytes(), ck.read_bytes()
    return make


class TestInjectedRecovery:
    def test_retry_recovers_every_io_site(self, tmp_path, golden, capsys):
        clustered = _write(tmp_path, _workload())
        want = golden(clustered)
        flags = ("--prefetch", "4", "--pack-workers", "2", "--async-write",
                 "on", "--retries", "3", "--retry-backoff", "0.01",
                 "--inject-faults",
                 "parse:io:1,pack:io:1:1,prepare:io:1:1,dispatch:io:1:1,"
                 "d2h:io:1:1,write:io:1:2,checkpoint_write:io:1:3")
        capsys.readouterr()
        out, ck = tmp_path / "chaos.mgf", tmp_path / "c.ck.json"
        assert _port(clustered, out, *flags, ck=ck) == 0
        rb = _summary(capsys)["robustness"]
        assert (out.read_bytes(), ck.read_bytes()) == want
        fired = set(rb["faults"]["fired_by_site"])
        assert fired == {"parse", "pack", "prepare", "dispatch", "d2h",
                         "write", "checkpoint_write"}
        assert rb["retries"] >= len(fired)
        assert rb["faults"]["fired_total"] == len(fired)
        assert "degrade_splits" not in rb and "degrade_reroutes" not in rb
        # the JAX CLI's journal with the same flags but the d2h fault (its
        # host route on the CPU fetches nothing from a device)
        jflags = tuple(f.replace("d2h:io:1:1,", "") for f in flags)
        jr = tmp_path / "chaos.jsonl"
        assert _jax(clustered, tmp_path / "j.mgf", *jflags,
                    ck=tmp_path / "j.ck.json", journal=jr) == 0
        want_rb = _comparable(_jax_robustness(jr))
        got_rb = _comparable(rb)
        got_rb["faults"]["plan"] = [p for p in got_rb["faults"]["plan"]
                                    if p["site"] != "d2h"]
        got_rb["faults"]["fired_by_site"].pop("d2h")
        got_rb["faults"]["fired_total"] -= 1
        got_rb["retries"] -= 1
        got_rb["retries_by_site"]["dispatch"] -= 1
        assert got_rb == want_rb

    def test_oom_splits_chunk_and_preserves_bytes(self, tmp_path, golden,
                                                  capsys):
        clustered = _write(tmp_path, _workload())
        want = golden(clustered, "--qc-report", str(tmp_path / "g.qc"))
        flags = ("--prefetch", "2", "--retry-backoff", "0.01",
                 "--inject-faults", "dispatch:oom:1:1")
        capsys.readouterr()
        out, ck = tmp_path / "oom.mgf", tmp_path / "o.ck.json"
        assert _port(clustered, out, *flags, "--qc-report",
                     str(tmp_path / "o.qc"), ck=ck) == 0
        rb = _summary(capsys)["robustness"]
        assert (out.read_bytes(), ck.read_bytes()) == want
        assert (tmp_path / "o.qc").read_bytes() == \
            (tmp_path / "g.qc").read_bytes()
        assert rb["degrade_splits"] == 1 and "degrade_reroutes" not in rb
        jr = tmp_path / "oom.jsonl"
        assert _jax(clustered, tmp_path / "j.mgf", *flags,
                    ck=tmp_path / "j.ck.json", journal=jr) == 0
        assert _comparable(rb) == _comparable(_jax_robustness(jr))

    def test_no_degrade_disables_the_split(self, tmp_path):
        clustered = _write(tmp_path, _workload(n=4))
        with pytest.raises(RuntimeError, match="out of memory"):
            _port(clustered, tmp_path / "nd.mgf", "--prefetch", "2",
                  "--no-degrade", "--retries", "1", "--retry-backoff", "0.0",
                  "--inject-faults", "dispatch:oom:1:0:9",
                  ck=tmp_path / "nd.ck.json")
        assert faults.active_plan() is None

    @pytest.mark.parametrize("policy", ["abort", "skip"])
    def test_repeated_device_failure_reaches_on_error(self, policy,
                                                      tmp_path, capsys):
        """The port's counterpart of the JAX package's
        ``test_repeated_device_failure_reroutes_to_numpy``: the port never
        reroutes a chunk off the card.  A chunk that outlives its retries
        goes to ``--on-error``: ``abort`` stops the run; ``skip`` runs its
        clusters one by one (each a one-shot dispatch that fails here too),
        records them in the manifest and the summary, and writes none."""
        clustered = _write(tmp_path, _workload(n=4))
        out, ck = tmp_path / "re.mgf", tmp_path / "re.ck.json"
        flags = ("--prefetch", "2", "--retries", "1", "--retry-backoff",
                 "0.0", "--inject-faults", "dispatch:io:1:0:9",
                 "--on-error", policy)
        capsys.readouterr()
        if policy == "abort":
            with pytest.raises(OSError, match="injected io fault"):
                _port(clustered, out, *flags, ck=ck)
            return
        assert _port(clustered, out, *flags, ck=ck) == 0
        summary = _summary(capsys)
        ids = [f"cluster-{i}" for i in range(4)]
        assert summary["skipped_cluster_ids"] == ids
        assert json.loads(ck.read_text())["failed"] == ids
        assert mgf.read_mgf(out) == []
        rb = summary["robustness"]
        assert rb["faults"]["fired_total"] == 8
        assert rb["retries_by_site"] == {"dispatch": 2}
        assert "degrade_splits" not in rb and "degrade_reroutes" not in rb

    def test_sticky_cuda_error_aborts_even_under_skip(self, tmp_path,
                                                      monkeypatch):
        """A sticky CUDA error is never retried, never split and never
        skipped past: the context is dead."""
        clustered = _write(tmp_path, _workload(n=4))
        calls = []

        def dead(self, prepared):
            calls.append(len(prepared.clusters))
            raise RuntimeError("seg_mean kernel launch failed: cudaError 700")

        monkeypatch.setattr(cli.TorchBackend, "run_prepared", dead)
        with pytest.raises(RuntimeError, match="cudaError 700"):
            _port(clustered, tmp_path / "s.mgf", "--prefetch", "2",
                  "--retries", "3", "--retry-backoff", "0", "--on-error",
                  "skip", ck=tmp_path / "s.ck.json")
        assert calls == [2]

    def test_qc_fault_retries_and_report_matches(self, tmp_path, capsys):
        clustered = _write(tmp_path, _workload(n=6))
        reports = {}
        for tag, extra in (
            ("clean", []),
            ("faulty", ["--retries", "2", "--retry-backoff", "0.01",
                        "--inject-faults", "qc:io:1:1"]),
        ):
            qc = tmp_path / f"qc_{tag}.json"
            assert _port(clustered, tmp_path / f"qc_{tag}.mgf", "--method",
                         "medoid", "--prefetch", "2", "--qc-report", str(qc),
                         *extra, command="select",
                         ck=tmp_path / f"qc_{tag}.ck.json") == 0
            reports[tag] = (qc.read_bytes(), _summary(capsys))
        assert reports["clean"][0] == reports["faulty"][0]
        assert "robustness" not in reports["clean"][1]
        rb = reports["faulty"][1]["robustness"]
        assert rb["faults"]["fired_by_site"] == {"qc": 1}
        assert rb["retries_by_site"] == {"qc": 1}
        jr = tmp_path / "qc.jsonl"
        assert _jax(clustered, tmp_path / "j.mgf", "--method", "medoid",
                    "--prefetch", "2", "--qc-report", str(tmp_path / "j.qc"),
                    "--retries", "2", "--retry-backoff", "0.01",
                    "--inject-faults", "qc:io:1:1", command="select",
                    ck=tmp_path / "j.ck.json", journal=jr) == 0
        assert _comparable(rb) == _comparable(_jax_robustness(jr))

    def test_hang_broken_by_watchdog_and_retried(self, tmp_path, golden,
                                                 capsys):
        clustered = _write(tmp_path, _workload(n=6))
        want = golden(clustered)
        capsys.readouterr()
        out, ck = tmp_path / "hang.mgf", tmp_path / "h.ck.json"
        assert _port(clustered, out, "--prefetch", "2", "--retries", "2",
                     "--retry-backoff", "0.01", "--watchdog-timeout", "0.2",
                     "--inject-faults", "dispatch:hang:1:1", ck=ck) == 0
        assert (out.read_bytes(), ck.read_bytes()) == want
        rb = _summary(capsys)["robustness"]
        assert rb["watchdog_stalls"] >= 1
        assert rb["retries_by_site"] == {"dispatch": 1}

    def test_env_var_arms_subprocess(self, tmp_path):
        clustered = _write(tmp_path, _workload(n=4))
        res = subprocess.run(
            [sys.executable, "-m", "specpride_tpu_torch", "consensus",
             str(clustered), str(tmp_path / "env.mgf"), "--device", "cpu",
             "--prefetch", "2", "--retries", "2", "--retry-backoff", "0.01"],
            capture_output=True, text=True, cwd=REPO,
            env={**os.environ, "SPECPRIDE_FAULTS": "write:io:1",
                 "SPECPRIDE_FAULT_SEED": "3"},
        )
        assert res.returncode == 0, res.stderr
        rb = json.loads(res.stderr.strip().splitlines()[-1])["robustness"]
        assert rb["faults"]["fired_by_site"] == {"write": 1}
        assert rb["faults"]["seed"] == 3 and rb["retries_by_site"] == {
            "write": 1}

    def test_exhausted_io_fault_follows_on_error_skip(self, tmp_path):
        clustered = _write(tmp_path, _workload(n=6))
        out = tmp_path / "skip.mgf"
        assert _port(clustered, out, "--on-error", "skip", "--prefetch", "2",
                     "--retries", "0", "--no-degrade", "--inject-faults",
                     "pack:io:1:0:99", ck=tmp_path / "s.ck.json") == 0
        assert sorted(s.cluster_id for s in mgf.read_mgf(out)) == [
            f"cluster-{i}" for i in range(6)]

    def test_plan_never_leaks_across_runs(self, tmp_path, capsys):
        clustered = _write(tmp_path, _workload(n=4))
        assert _port(clustered, tmp_path / "a.mgf", "--prefetch", "2",
                     "--retries", "2", "--retry-backoff", "0.01",
                     "--inject-faults", "write:io:1:1") == 0
        assert faults.active_plan() is None
        with pytest.raises(OSError):  # an aborted run disarms its plan too
            _port(clustered, tmp_path / "b.mgf", "--retries", "0",
                  "--inject-faults", "write:io:1")
        assert faults.active_plan() is None
        capsys.readouterr()
        assert _port(clustered, tmp_path / "c.mgf", "--prefetch", "2") == 0
        assert "robustness" not in _summary(capsys)


# -- the quarantine ----------------------------------------------------------


def _dirty_file(tmp_path, n=6):
    clustered = _write(tmp_path, _workload(n=n))
    blocks = clustered.read_text().split("\n\n")
    blocks.insert(4, "BEGIN IONS\nTITLE=cluster-trunc;mzspec:PXD000001:run1:"
                     "scan:9999\nPEPMASS=500.0\n123.4 10.0")
    blocks.insert(7, "BEGIN IONS\nTITLE=cluster-bad;mzspec:PXD000001:run1:"
                     "scan:9\nPEPMASS=500.0\n123.4 banana\nEND IONS")
    dirty = tmp_path / "dirty.mgf"
    dirty.write_text("\n\n".join(blocks))
    return dirty


class TestQuarantine:
    @pytest.mark.parametrize("stream", ["off", "2"])
    def test_damaged_blocks_quarantined_like_jax(self, tmp_path, stream,
                                                 capsys):
        """A truncated and an unparseable block under ``--on-error skip``:
        both in the quarantine file, the JAX CLI's bytes with the same
        flags; every intact cluster written; the summary's count equal to
        the JAX journal's."""
        dirty = _dirty_file(tmp_path)
        out = tmp_path / f"q_{stream}.mgf"
        flags = ("--on-error", "skip", "--stream-clusters", stream,
                 "--prefetch", "2")
        capsys.readouterr()
        assert _port(dirty, out, *flags) == 0
        rb = _summary(capsys)["robustness"]
        qfile = tmp_path / f"q_{stream}.mgf.quarantine.mgf"
        jr = tmp_path / f"j_{stream}.jsonl"
        assert _jax(dirty, tmp_path / f"j_{stream}.mgf", *flags,
                    journal=jr) == 0
        jq = tmp_path / f"j_{stream}.mgf.quarantine.mgf"
        assert qfile.read_bytes() == jq.read_bytes()
        text = qfile.read_text()
        assert "cluster-trunc" in text and "banana" in text
        assert rb == {"quarantined": 2} == _jax_robustness(jr)
        assert sorted(s.cluster_id for s in mgf.read_mgf(out)) == [
            f"cluster-{i}" for i in range(6)]

    def test_streamed_and_eager_quarantine_the_same(self, tmp_path):
        dirty = _dirty_file(tmp_path)
        got = {}
        for stream in ("off", "1", "512"):
            out = tmp_path / f"s_{stream}.mgf"
            assert _port(dirty, out, "--on-error", "skip",
                         "--stream-clusters", stream, "--prefetch", "2",
                         "--pack-workers", "3") == 0
            got[stream] = (out.read_bytes(), (tmp_path / (
                f"s_{stream}.mgf.quarantine.mgf")).read_bytes())
        assert got["1"] == got["off"] and got["512"] == got["off"]

    def test_quarantine_file_is_fresh_per_run(self, tmp_path):
        dirty = _dirty_file(tmp_path)
        out = tmp_path / "q.mgf"
        qfile = tmp_path / "q.mgf.quarantine.mgf"
        qfile.write_text("BEGIN IONS\nTITLE=stale-from-last-run\nEND IONS\n")
        for _ in range(2):
            assert _port(dirty, out, "--on-error", "skip",
                         "--prefetch", "2") == 0
        text = qfile.read_text()
        assert "stale-from-last-run" not in text
        assert text.count("cluster-trunc") == 1

    @pytest.mark.parametrize("stream", ["off", "2"])
    def test_abort_policy_raises_and_leaves_no_quarantine(self, tmp_path,
                                                          stream):
        """Under the default ``--on-error abort`` a damaged record stops the
        run and no quarantine file is made.  The JAX package's
        ``test_abort_policy_keeps_fail_fast`` expects a ``ValueError``, the
        Python parser's, and is red because that package's C++ parser
        raises a ``RuntimeError`` (``line 68: bad peak intensity``); the
        port's parser is the C++ one too, so this asserts the raise and its
        message, not a type."""
        clustered = _write(tmp_path, _workload(n=3))
        blocks = clustered.read_text().split("\n\n")
        blocks.insert(2, "BEGIN IONS\nTITLE=cluster-bad;mzspec:PXD000001:"
                         "run1:scan:9\nPEPMASS=500.0\n123.4 banana\nEND IONS")
        dirty = tmp_path / "dirty.mgf"
        dirty.write_text("\n\n".join(blocks))
        with pytest.raises(RuntimeError, match="bad peak intensity"):
            _port(dirty, tmp_path / "abort.mgf", "--prefetch", "0",
                  "--stream-clusters", stream)
        assert not (tmp_path / "abort.mgf.quarantine.mgf").exists()
        assert faults.active_plan() is None
