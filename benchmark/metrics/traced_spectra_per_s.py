"""``traced_spectra_per_s``: the member spectra of every job finished in
the traced window over the window's wall, from the first job's start to
the last job's end (the harness's clock; the jobs journal their spans and
run under the profiler).  The host paces every job, so the rate swings
with the shared host's speed; it is read here, without a bound.  Nothing
where no job finished."""


def read(run: dict):
    if not run["jobs"] or run["window_s"] <= 0:
        return None
    return len(run["jobs"]) * run["spectra"] / run["window_s"]
