"""``host_cpu_ms_per_kspectra``: the process's CPU milliseconds, user
and system, per 1,000 spectra over the window's jobs (each run summary's
``cpu_s``, from the run's start to its summary: every lane, the window
parse's native threads and torch's).  Nothing where a run summary lacks
it."""


def read(run: dict):
    jobs = run["jobs"]
    if not jobs or any("cpu_s" not in j for j in jobs):
        return None
    cpu = sum(j["cpu_s"]["user"] + j["cpu_s"]["sys"] for j in jobs)
    return cpu * 1e3 / (len(jobs) * run["spectra"] / 1e3)
