"""Run one cell of ``BENCHMARK.json`` on the card::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up: a child process writes the cell's input MGF from the seed (the
traffic file's law, ``benchmark.generate``) into a file held in memory
(``memory_file``; every job's output is held so too) while this process
imports torch and the port and loads its kernels from the compile cache in
``build/``; then one warm-up job on the input's first clusters.  The
window: ``specpride_tpu_torch.cli.main`` runs the configuration's argv on
the input, one whole job after another (one client, a closed loop), and
ends with the first job that finishes after ``--seconds``.  Then the
plain reference (``benchmark/reference/``) checks every job's output.
With ``--trace 1`` the window runs under ``torch.profiler`` and the jobs
journal their spans; the per-layer readers (``benchmark/metrics/``) take
their numbers from the run.  The last line of standard output is the
result's JSON line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import contextlib  # noqa: E402
import hashlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import check, devtrace, generate, spec  # noqa: E402

COMMAND_ARGS = ("--workload", "--seed", "--seconds", "--trace")
# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "specpride_tpu")
GIB = float(1 << 30)


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def command_args(argv: list[str]) -> dict:
    """The command's four ``--name value`` arguments, nothing else."""
    pairs = dict(zip(argv[0::2], argv[1::2]))
    if len(argv) % 2 or sorted(pairs) != sorted(COMMAND_ARGS):
        raise SystemExit("usage: python3 -m benchmark.run --workload CELL "
                         "--seed N --seconds S --trace 0|1")
    return {"workload": pairs["--workload"], "seed": int(pairs["--seed"]),
            "seconds": float(pairs["--seconds"]),
            "trace": int(pairs["--trace"]) != 0}


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own ``build/torch_kernels`` is fixed in its code)."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(root, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, "build", "torch_extensions"))


def job_argv(cell: spec.Cell, src: str, out: str, qc: str,
             device: str) -> list[str]:
    """The configuration's argv on ``src``, writing ``out`` (and ``qc``)."""
    argv = [a.format(input=src, output=out, qc=qc)
            for a in cell.config["argv"]]
    if device != "cuda":
        argv += ["--device", device]
    return argv


def run_job(cli, argv: list[str]) -> dict | None:
    """One job through ``cli.main`` in this process; its run summary (the
    JSON line it prints on standard error), None if it failed."""
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    except (Exception, SystemExit):  # a failed job is counted, not fatal
        traceback.print_exc()
        return None
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("{")]
    if rc != 0 or not lines:
        sys.stderr.write(err.getvalue()[-2000:])
        return None
    return json.loads(lines[-1])


def forbidden_loaded() -> None:
    """Raise if this process holds JAX or the JAX package, by whole
    top-level module names."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise RuntimeError("loaded in the benchmark's process: "
                           + ", ".join(found))


def memory_file(name: str) -> tuple[int, str]:
    """A file held in memory (``memfd_create``) and the path that opens
    it, ``/proc/self/fd/<fd>``, in this process and in a child handed the
    fd.  The run's input and every job's output live so: a file the host
    has just written, in its page cache, as on a lab's machine, and
    nothing of the run goes to disk."""
    fd = os.memfd_create(name)
    return fd, f"/proc/self/fd/{fd}"


def file_digest(*paths: str) -> str:
    h = hashlib.sha256()
    for path in paths:
        if path and os.path.exists(path):
            with open(path, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 22), b""):
                    h.update(block)
        h.update(b"\0")
    return h.hexdigest()


def process_cpu() -> dict:
    """This process's CPU seconds so far, user and system: read around
    the window, they say whether a slow window did more work or the same
    work on a slower host."""
    u = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": u.ru_utime, "system_s": u.ru_stime}


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


class Run:
    """One run of a cell: set-up, window, check and metrics."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, device: str = "cuda", t_start: float = None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.t_start = T_START if t_start is None else t_start
        self.work = tempfile.mkdtemp(prefix="specpride-bench-")
        self.fds: list[int] = []
        self.src = self.memory_file("input.mgf")
        self.warm = self.memory_file("warmup.mgf")
        self.child = None
        self.info: dict = {}

    def memory_file(self, name: str) -> str:
        fd, path = memory_file(name)
        self.fds.append(fd)
        return path

    # -- set-up ------------------------------------------------------------

    def start_input(self) -> None:
        self.child = subprocess.Popen(
            [sys.executable, "-m", "benchmark.generate",
             self.cell.traffic_path,
             str(self.seed), self.src, self.warm],
            cwd=self.cell.root, stdout=subprocess.PIPE, text=True,
            pass_fds=self.fds[:2])

    def _child_line(self) -> dict:
        line = self.child.stdout.readline()
        if not line:
            self.child.wait()
            raise RuntimeError(f"input generator failed "
                               f"(exit {self.child.returncode})")
        return json.loads(line)

    def import_port(self):
        """torch, the port and its kernels; raises ``NoDevice`` without
        the cards the cell asks for."""
        t0 = time.perf_counter()
        import torch

        if self.device == "cuda":
            if not torch.cuda.is_available():
                raise NoDevice("torch.cuda.is_available() is false")
            if torch.cuda.device_count() < self.cell.chips:
                raise NoDevice(f"{torch.cuda.device_count()} card(s), the "
                               f"cell asks for {self.cell.chips}")
        from specpride_tpu_torch import cli
        from specpride_tpu_torch.ops import _build

        if self.device == "cuda":
            _build.load()
        _build.load_host()
        self.info["import_s"] = time.perf_counter() - t0
        return torch, cli

    def setup(self):
        self.start_input()
        torch, cli = self.import_port()
        warm = self._child_line()
        t0 = time.perf_counter()
        argv = job_argv(self.cell, self.warm,
                        self.memory_file("warmup.out.mgf"),
                        self.memory_file("warmup.qc.json"), self.device)
        if run_job(cli, argv) is None:
            raise RuntimeError("the warm-up job failed")
        self.info["warmup_s"] = time.perf_counter() - t0
        self.info["warmup_spectra"] = warm["warmup_spectra"]
        self.info.update(self._child_line())
        self.child.wait()
        self.info["setup_s"] = time.perf_counter() - self.t_start
        print("setup: " + json.dumps(self.info), file=sys.stderr, flush=True)
        return torch, cli

    # -- the window ----------------------------------------------------------

    def window(self, torch, cli) -> dict:
        """Jobs back to back until one finishes after ``seconds``."""
        jobs, starts, outputs, journals = [], [], [], []
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        failed = 0
        with_qc = "{qc}" in self.cell.config["argv"]
        cpu0 = process_cpu()
        t0 = time.perf_counter()
        while True:
            k = len(starts)
            out = self.memory_file(f"out.{k}.mgf")
            qc = self.memory_file(f"qc.{k}.json") if with_qc else ""
            argv = job_argv(self.cell, self.src, out, qc, self.device)
            if self.trace:
                journal = os.path.join(self.work, f"job.{k}.jsonl")
                argv += ["--journal", journal, "--chrome-trace",
                         os.path.join(self.work, f"job.{k}.trace.json")]
                journals.append(journal)
            starts.append(time.perf_counter())
            with (record_function(devtrace.JOB_RANGE) if self.trace
                  else contextlib.nullcontext()):
                summary = run_job(cli, argv)
            if summary is None:
                failed += 1
            else:
                jobs.append(summary)
            outputs.append((out, qc if with_qc else None))
            t1 = time.perf_counter()
            if t1 - t0 >= self.seconds:
                break
        if self.device == "cuda":
            torch.cuda.synchronize()
        print("jobs_s: " + json.dumps(np.diff(starts + [t1]).tolist()),
              file=sys.stderr, flush=True)
        cpu1 = process_cpu()
        print("window_cpu: " + json.dumps(
            {k: cpu1[k] - cpu0[k] for k in cpu1}), file=sys.stderr,
            flush=True)
        # the window's rate, for the record: no cell bounds it (the host
        # paces it), a traced run reports it as ``traced_spectra_per_s``
        print("window: " + json.dumps(
            {"jobs": len(jobs), "seconds": t1 - t0, "spectra_per_s":
             len(jobs) * self.info["spectra"] / (t1 - t0)}),
            file=sys.stderr, flush=True)
        win = {"t0": t0, "t1": t1, "starts": starts, "jobs": jobs,
               "failed": failed, "outputs": outputs, "journals": journals,
               "rss_bytes": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss * 1024}
        if self.device == "cuda":
            win["device_peak_bytes"] = torch.cuda.max_memory_allocated()
        if prof is not None:
            prof.stop()
            path = os.path.join(self.work, "profile.json")
            prof.export_chrome_trace(path)
            del prof
            win["trace_path"] = path
        return win

    # -- the check -----------------------------------------------------------

    def verify(self, win: dict) -> tuple[dict, dict]:
        """The numbers compared, over every job's output (each distinct
        output read back once), and the reference's problem sizes."""
        w = generate.make_workload(self.cell.traffic, self.seed)
        ref = self.cell.reference().run(w, self.cell.config)
        n_members = np.diff(w.member_offsets)
        seen: dict[str, dict] = {}
        numbers: dict = {}
        for out, qc in win["outputs"]:
            if not os.path.exists(out):
                continue
            key = file_digest(out, qc)
            if key not in seen:
                try:
                    seen[key] = check.compare(check.read_mgf(out),
                                              check.read_qc(qc), ref,
                                              w.cluster_ids, n_members)
                except (ValueError, KeyError, UnicodeDecodeError):
                    # an output that cannot be read matches no cluster
                    seen[key] = {"mismatched_reps": w.n_clusters}
            for name, value in seen[key].items():
                numbers[name] = max(numbers.get(name, value), value)
        return numbers, ref.sizes

    # -- metrics -------------------------------------------------------------

    def record(self, win: dict, sizes: dict, dev: dict | None) -> dict:
        """What the per-layer readers read."""
        return {
            "config": self.cell.config,
            "jobs": win["jobs"], "spectra": self.info["spectra"],
            "window_s": win["t1"] - win["t0"], "import_s":
            self.info["import_s"], "setup": dict(self.info),
            "sizes": sizes, "device": dev,
            "work": self.cell.work_model()(sizes,
                                           self.cell.config["precision"]),
        }

    def end_to_end(self, win: dict) -> dict:
        done = len(win["jobs"])
        values = {
            "spectra_per_s": done * self.info["spectra"]
            / (win["t1"] - win["t0"]),
            "peak_rss_gib": win["rss_bytes"] / GIB,
            "setup_s": self.info["setup_s"],
        }
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in self.cell.end_to_end}

    def per_layer(self, rec: dict) -> dict:
        out = {}
        for m in self.cell.per_layer:
            value = self.cell.reader(m["name"])(rec)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def execute(self) -> dict:
        """The whole run; the result's fields."""
        try:
            torch, cli = self.setup()
            win = self.window(torch, cli)
            del cli
            forbidden_loaded()
            if self.device == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            numbers, sizes = self.verify(win)
            print(f"verify: {time.perf_counter() - t0:.3f} s, "
                  f"{len(win['outputs'])} job outputs", file=sys.stderr,
                  flush=True)
            limits = self.cell.config["check"]["limits"]
            correct = (win["failed"] == 0 and bool(win["jobs"])
                       and check.judge(numbers, limits))
            device = {"platform": "gpu" if self.device == "cuda"
                      else self.device,
                      "kind": (torch.cuda.get_device_name(0)
                               if self.device == "cuda" else self.device),
                      "count": self.cell.chips,
                      "memory_peak_bytes": win.get("device_peak_bytes", 0)}
            result = {"correct": correct,
                      "attempted": len(win["starts"]),
                      "failed": win["failed"]}
            if self.trace:
                dev = (devtrace.summarize(win["trace_path"],
                                          win["journals"], win["starts"],
                                          win["t0"], win["t1"])
                       if self.device == "cuda" else None)
                if dev is not None:
                    device["busy_s"] = dev["busy_s"]
                    device["window_s"] = dev["window_s"]
                result["metrics"] = self.per_layer(
                    self.record(win, sizes, dev))
                result["device"] = device
                if dev is not None:
                    result["breakdown"] = dev["breakdown"]
            else:
                result["metrics"] = self.end_to_end(win)
                result["device"] = device
            if self.device == "cuda":
                device["power_limit"] = power_limit()
            result["check"] = {name: {"value": numbers.get(name),
                                      "limit": limit}
                               for name, limit in limits.items()}
            # the reference, the readers, the work model and the trace's
            # reader were loaded after the window: none may bring JAX in
            forbidden_loaded()
            return result
        finally:
            if self.child is not None and self.child.poll() is None:
                self.child.kill()
                self.child.wait()
            shutil.rmtree(self.work, ignore_errors=True)
            for fd in self.fds:
                os.close(fd)
            self.fds = []


def report(result: dict) -> None:
    """The result's line, last on standard output; each number compared
    beside its limit, last on standard error."""
    print(json.dumps(result), flush=True)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def main(argv: list[str]) -> int:
    args = command_args(argv)
    root = spec.ROOT
    cache_dirs(root)
    cell = spec.Cell(args["workload"], root)
    run = Run(cell, args["seed"], args["seconds"], args["trace"])
    try:
        result = run.execute()
    except NoDevice as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    except RuntimeError as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
