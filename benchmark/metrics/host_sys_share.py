"""``host_sys_share``: the system share of the process's CPU over the
window's jobs, Σ ``cpu_s.sys`` / Σ (``cpu_s.user`` + ``cpu_s.sys``) of
the run summaries.  Nothing where a run summary lacks ``cpu_s`` or no CPU
was counted."""


def read(run: dict):
    jobs = run["jobs"]
    if not jobs or any("cpu_s" not in j for j in jobs):
        return None
    sys_ = sum(j["cpu_s"]["sys"] for j in jobs)
    total = sum(j["cpu_s"]["user"] for j in jobs) + sys_
    return sys_ / total if total > 0 else None
